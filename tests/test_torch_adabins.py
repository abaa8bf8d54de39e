"""AdaBins in the port (``models/adabins.py``, ``nn/vit.py``) against the
plain reference of the benchmark (``perfbench/reference/adabins.py``), on
the CPU in float32.

One model and one reference are built for the module, at the configuration's
``tiny`` size (the least that runs: 6 x 22 = 132 tokens, and the model needs
a regressor token and 128 queries), seeded as the benchmark seeds it
(``weights.make_weights`` with the configuration's pins, then its
standardised conv, ``drivers/images.py::standardise``), and run on one of
its seeded images. The JAX package has no AdaBins, so the reference is the
benchmark's, written from the published code."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from magnet_tpu_torch import test_adabins
from magnet_tpu_torch.models.adabins import AdaBins
from magnet_tpu_torch.models.dnet import DNet
from magnet_tpu_torch.utils.profiling import StageTimes
from perfbench import inputs, judge, weights
from perfbench.drivers import images
from perfbench.reference import adabins as ref_adabins

from test_torch_kernels import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CFG = json.loads((ROOT / "perfbench" / "configs" / "adabins_kitti.json")
                 .read_text())
TINY = CFG["tiny"]
SEED = 2147483713
# float32 against float32 in another order (NHWC and channels-last
# convolutions, the kernels' plain versions, batch-first attention): the
# depth agrees to 3.4e-5 of its spread over the image (rms diff over the
# reference's standard deviation, 2.05 m here) and the edges to 3e-7 of
# their range at this size; 1e-4 holds them with room and is far below
# what bfloat16 rounding moves (a few 1e-2 of the spread)
TOL = 1e-4
SPANS = ("AdaBins trunk", "AdaBins decoder", "mViT", "bins head")

# the published checkpoint's keys (models/unet_adaptive_bins.py) outside
# the encoder, with their shapes at 256 bins
LAYER = {"self_attn.in_proj_weight": (384, 128),
         "self_attn.in_proj_bias": (384,),
         "self_attn.out_proj.weight": (128, 128),
         "self_attn.out_proj.bias": (128,),
         "linear1.weight": (1024, 128), "linear1.bias": (1024,),
         "linear2.weight": (128, 1024), "linear2.bias": (128,),
         "norm1.weight": (128,), "norm1.bias": (128,),
         "norm2.weight": (128,), "norm2.bias": (128,)}
PUBLISHED = {
    "adaptive_bins_layer.patch_transformer.positional_encodings": (500, 128),
    **{f"adaptive_bins_layer.patch_transformer.transformer_encoder.layers."
       f"{i}.{k}": s for i in range(4) for k, s in LAYER.items()},
    "adaptive_bins_layer.patch_transformer.embedding_convPxP.weight":
        (128, 128, 16, 16),
    "adaptive_bins_layer.patch_transformer.embedding_convPxP.bias": (128,),
    "adaptive_bins_layer.conv3x3.weight": (128, 128, 3, 3),
    "adaptive_bins_layer.conv3x3.bias": (128,),
    "adaptive_bins_layer.regressor.0.weight": (256, 128),
    "adaptive_bins_layer.regressor.0.bias": (256,),
    "adaptive_bins_layer.regressor.2.weight": (256, 256),
    "adaptive_bins_layer.regressor.2.bias": (256,),
    "adaptive_bins_layer.regressor.4.weight": (256, 256),
    "adaptive_bins_layer.regressor.4.bias": (256,),
    "decoder.conv2.weight": (2048, 2048, 1, 1), "decoder.conv2.bias": (2048,),
    **{f"decoder.up{i}._net.{j}.{k}": (c,) if j in (1, 4) or k == "bias"
       else (c, cin if j == 0 else c, 3, 3)
       for i, cin, c in ((1, 2224, 1024), (2, 1088, 512), (3, 552, 256),
                         (4, 280, 128))
       for j in (0, 1, 3, 4)
       for k in (("weight", "bias") if j in (0, 3) else
                 ("weight", "bias", "running_mean", "running_var"))},
    "decoder.conv3.weight": (128, 128, 3, 3), "decoder.conv3.bias": (128,),
    "conv_out.0.weight": (256, 128, 1, 1), "conv_out.0.bias": (256,)}


@pytest.fixture(scope="module")
def run():
    """The port's outputs under a ``StageTimes``, the reference's, and the
    model."""
    with torch.device("meta"):
        layout = ref_adabins.AdaBins()
    x = inputs.images(torch.Generator().manual_seed(SEED), 1, TINY["H"],
                      TINY["W"], "cpu")
    sd = weights.make_weights(layout, SEED, "cpu", "eval", CFG["pins"])
    sd = images.standardise(sd, layout, CFG["standardise"],
                            x.permute(0, 3, 1, 2))
    model = AdaBins().eval()
    model.load_state_dict(sd)
    ref = ref_adabins.AdaBins().eval()
    ref.load_state_dict(sd)
    with torch.inference_mode():
        with StageTimes() as st:
            out = model(x)
        ref_out = ref(x.permute(0, 3, 1, 2))
    return model, out, ref_out, st


def test_forward_matches_the_reference(run):
    _, (edges, depth), (ref_edges, ref_depth), _ = run
    ref_depth = ref_depth[:, 0]
    assert depth.shape == (1, TINY["H"] // 2, TINY["W"] // 2)
    assert edges.shape == (1, 257) and edges.dtype == torch.float32
    # the seeded map varies by metres over the image
    assert float(ref_depth.std()) > 1.0
    assert judge.spread_rel(depth, ref_depth) < TOL
    assert float((edges - ref_edges).abs().max()
                 / (ref_edges.max() - ref_edges.min())) < TOL
    # the edges run from min to max depth
    assert torch.allclose(edges[:, 0], torch.tensor(1e-3))
    assert torch.allclose(edges[:, -1], torch.tensor(80.0))


def test_state_dict_keys_are_the_published_ones(run):
    model = run[0]
    sd = model.state_dict()
    own = {k: tuple(v.shape) for k, v in sd.items()
           if not k.startswith("encoder.")
           and not k.endswith("num_batches_tracked")}
    assert own == PUBLISHED
    # the encoder's: those AdaBins_fix loads into MaGNet's D-Net from the
    # AdaBins KITTI file (compat/encoder.py)
    with torch.device("meta"):
        dnet = DNet()
    assert ({k for k in sd if k.startswith("encoder.")}
            == {k[len("d_net."):] for k in dnet.state_dict()
                if k.startswith("d_net.encoder.")})


def test_more_than_500_positions_raise(run):
    vit = run[0].adaptive_bins_layer
    # 16 x 501 patches: the shape alone decides, before any work
    u = torch.empty(1, 16, 16 * 501, 128, device="meta")
    with pytest.raises(ValueError, match="501 patches"):
        vit(u)
    with pytest.raises(ValueError, match="makes 128 tokens"):
        vit(torch.empty(1, 16, 16 * 129 - 1, 128, device="meta"))


def test_stage_times_records_the_five_spans_nested(run):
    st = run[3]
    assert set(st.host) == {"AdaBins forward", *SPANS}
    assert [h.parent for h in st.host["AdaBins forward"]] == [None]
    for name in SPANS:
        assert [h.parent for h in st.host[name]] == ["AdaBins forward"]
    assert st.events == {}


def test_entry_point_synthetic_cpu(run, tmp_path):
    # a checkpoint as the published training saves it: the state dict of
    # a DataParallel model under "model"; strict loading proves its layout
    ckpt = tmp_path / "AdaBins_kitti.pt"
    torch.save({"model": {"module." + k: v
                          for k, v in run[0].state_dict().items()},
                "optimizer": None, "epoch": 0}, ckpt)
    m = test_adabins.main([
        "--exp_name", "t", "--exp_dir", str(tmp_path),
        "--dataset_name", "synthetic", "--dataset_path", "none",
        "--input_height", str(TINY["H"]), "--input_width", str(TINY["W"]),
        "--max_depth", "10", "--ADABINS_ckpt", str(ckpt),
        "--synthetic_length", "1", "--compute_dtype", "float32",
        "--device", "cpu"])
    assert len(m) == 12 and all(np.isfinite(v) for v in m.values())
    lines = (tmp_path / "t" / "log" / "test_acc.txt").read_text().split("\n")
    assert len(lines[2].split()) == 12
