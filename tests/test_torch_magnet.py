"""The port's F-Net and whole MaGNet forward (magnet_tpu_torch) against the
JAX package, on the CPU, at a tiny shape (64x96, 2 source views).

One set of seeded random variables, shaped by the JAX modules with
``eval_shape`` and filled with numpy, goes through both packages in f32: the
JAX model as it stands on the CPU (its XLA paths; the decoder switches set to
0 as in tests/test_torch_dnet.py), the port after ``compat.from_jax``.

Tolerance: ``1e-4 * max|ref|`` for PSM-Net and for each iteration's
(mu, sigma) map of the whole forward (f32 sums in another order; 7e-7 was
seen on the whole forward). A sample that sits on the cost volume's
consistency threshold may flip and move its pixel by a G-Net update, so up
to 1 % of the whole forward's pixels may exceed it.
"""

import os
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from magnet_tpu.compat import torch_loader
from magnet_tpu.models.fnet import FNet as JFNet
from magnet_tpu.models.magnet import Magnet as JMagnet
from magnet_tpu_torch import test_magnet
from magnet_tpu_torch.compat.from_jax import (fnet_state_dict,
                                              magnet_state_dict)
from magnet_tpu_torch.core import config
from magnet_tpu_torch.data.synthetic import SyntheticMultiView
from magnet_tpu_torch.models import build
from magnet_tpu_torch.models.fnet import FNet
from magnet_tpu_torch.models.magnet import Magnet

from magnet_tpu_torch import train_fnet
from magnet_tpu_torch.models.dnet import DNet
from magnet_tpu_torch.train import checkpoint
from test_torch_dnet import _random_variables
from test_torch_train import ENTRY_FLAGS

H, W, V = 64, 96, 2
SCANNET_FLAGS = str(Path(__file__).resolve().parents[1] / "test_scripts"
                    / "magnet" / "scannet.txt")
SMALL = ["--input_height", str(H), "--input_width", str(W),
         "--dpv_height", str(H // 4), "--dpv_width", str(W // 4),
         "--MAGNET_num_source_views", str(V), "--dataset_name", "synthetic",
         "--DNET_ckpt", "", "--FNET_ckpt", "", "--MAGNET_ckpt", "",
         "--device", "cpu", "--compute_dtype", "float32"]


def _args(extra=()):
    return config.parse_args(config.build_test_magnet_parser(),
                             ["@" + SCANNET_FLAGS] + SMALL + list(extra))


def _assert_trees_equal(a, b):
    flat_a = jax.tree_util.tree_leaves_with_path(a)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(b))
    assert len(flat_a) == len(flat_b)
    for path, x in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), x)


@pytest.fixture(autouse=True)
def xla_paths(monkeypatch):
    """The JAX package on its XLA paths, as its parity tests run it on the
    CPU."""
    for k in ("UP", "UP2", "HEADS", "GNET", "CV", "PSM"):
        monkeypatch.setenv(f"MAGNET_TPU_PALLAS_{k}", "0")


@pytest.fixture(scope="module")
def batch():
    """One synthetic multi-view sample, batched."""
    item = SyntheticMultiView(_args(["--synthetic_length", "1"])).get(0)
    return {k: v[None] for k, v in item.items() if isinstance(v, np.ndarray)}


@pytest.fixture(scope="module")
def magnet_case(batch):
    jm = JMagnet()
    order = ("ref_img", "src_imgs", "R", "t", "is_valid", "intM", "rays2d")
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0),
        *[jax.ShapeDtypeStruct(batch[k].shape, jnp.float32) for k in order])
    variables = jax.tree.map(np.asarray, _random_variables(shapes, seed=1))
    # the depth regime of a trained network (bench.py::realistic_depth_init)
    p = variables["params"]
    head = p["d_net"]["d_net"]["depth_head"]["conv2"]["conv"]
    head["kernel"] = np.zeros_like(head["kernel"])
    head["bias"] = np.array([2.0, -3.0], np.float32)
    # Matching features and G-Net residuals of O(1) and smaller: random
    # weights otherwise give costs of 1e5, and the first update collapses
    # sigma to nothing, after which no step moves anything.
    proj = p["f_net"]["f_net"]["lastconv1"]
    proj["kernel"] = proj["kernel"] / 500.0
    last = p["g_net"]["conv3"]["conv"]
    last["kernel"] = last["kernel"] * 0.05
    return jm, variables, [batch[k] for k in order]


def test_psmnet_matches_jax():
    x = np.random.RandomState(0).rand(2, H, W, 3).astype(np.float32)
    jm = JFNet()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct(x.shape, jnp.float32))
    variables = jax.tree.map(np.asarray, _random_variables(shapes, seed=2))
    ref = np.asarray(jm.apply(variables, x))
    model = FNet().eval()
    model.load_state_dict(fnet_state_dict(variables))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, H // 4, W // 4, 64)
    np.testing.assert_allclose(out, ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()))
    # and back through the JAX package's own converter, bit for bit
    back = torch_loader.convert_fnet(
        {k: v.numpy() for k, v in model.state_dict().items()}, variables)
    _assert_trees_equal(variables, back)


def _load(variables):
    model = Magnet().eval()
    res = model.load_state_dict(magnet_state_dict(variables), strict=False)
    assert not res.unexpected_keys
    assert all(k.startswith("d_net.d_net.decoder.mask_head.")
               for k in res.missing_keys)
    return model


def test_magnet_forward_matches_jax(magnet_case):
    jm, variables, inputs = magnet_case
    refs = [np.asarray(r) for r in jm.apply(variables, *inputs)]
    model = _load(variables)
    with torch.no_grad():
        outs = model(*[torch.from_numpy(a) for a in inputs])
    assert len(outs) == len(refs) == 3
    moved = np.abs(refs[-1] - refs[0]).max()
    assert moved > 1e-3, "the refinement steps changed nothing"
    assert refs[-1][..., 1].min() > 1e-3, "sigma collapsed"
    for out, ref in zip(outs, refs):
        assert out.shape == ref.shape == (1, H, W, 2)
        err = np.abs(out.numpy() - ref)
        lim = 1e-4 * float(np.abs(ref).max())
        assert (err > lim).mean() < 0.01, (err.max(), lim)


def test_magnet_weights_round_trip_is_exact(magnet_case):
    """port state_dict -> the JAX package's own converter -> the original
    variables, bit for bit."""
    _, variables, _ = magnet_case
    model = _load(variables)
    assert model.g_net.gnet[0].weight.shape == (128, 261, 3, 3)
    back = torch_loader.convert_magnet(
        {k: v.numpy() for k, v in model.state_dict().items()}, variables)
    _assert_trees_equal(variables, back)


def test_checkpoints_load_in_stages(tmp_path, magnet_case):
    """D-Net, F-Net, then the MAGNET overlay, from files in the reference
    layout ('model' wrapper, DDP 'module.' prefixes)."""
    _, variables, _ = magnet_case
    src = _load(variables)
    sd = src.state_dict()

    def save(name, prefix, keep=lambda k: True):
        path = tmp_path / name
        torch.save({"model": {"module." + k[len(prefix):]: v
                              for k, v in sd.items()
                              if k.startswith(prefix) and keep(k)}}, path)
        return str(path)

    args = _args([
        "--DNET_ckpt", save("d.pt", "d_net."),
        "--FNET_ckpt", save("f.pt", "f_net."),
        "--MAGNET_ckpt", save("m.pt", "",
                              lambda k: "decoder.mask_head" not in k)])
    model = build.load_magnet_checkpoints(build.build_magnet(args), args)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    bad = _args(["--MAGNET_ckpt", save("g.pt", "g_net.")])
    with pytest.raises(KeyError):
        build.load_magnet_checkpoints(build.build_magnet(bad), bad)


@pytest.fixture(scope="module")
def fnet_run(tmp_path_factory):
    """One F-Net training step of ``train_fnet`` at a tiny shape, saved by
    the entry point as ``<exp>/models/<step>/state.pt``."""
    out = train_fnet.main(ENTRY_FLAGS + [
        "--exp_dir", str(tmp_path_factory.mktemp("fnet")), "--device",
        "cpu", "--synthetic_length", "2"])
    assert len(out["losses"]) == 1
    return out


def _ckpt_path(step_dir: str, form: str) -> str:
    return {"parent": os.path.dirname(step_dir), "step": step_dir,
            "state.pt": os.path.join(step_dir, checkpoint.STATE_FILE)}[form]


@pytest.mark.parametrize("form", ["parent", "step", "state.pt"])
def test_fnet_training_checkpoint_loads(fnet_run, form):
    """``--FNET_ckpt`` takes the checkpoint of the port's own ``train_fnet``
    (``MagnetF``'s keys, ``f_net.f_net.*``) in each of its three forms;
    every F-Net tensor is the trained one, bit for bit."""
    args = _args(["--FNET_feature_dim", "16", "--FNET_ckpt",
                  _ckpt_path(fnet_run["ckpt"], form)])
    model = build.load_magnet_checkpoints(build.build_magnet(args), args)
    trained = fnet_run["state"].model.f_net.state_dict()
    loaded = model.f_net.state_dict()
    assert loaded.keys() == trained.keys()
    for k, v in trained.items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0)


def test_entry_point_loads_a_training_checkpoint(tmp_path, fnet_run):
    """``test_magnet`` evaluates with the F-Net of a ``train_fnet`` run."""
    m = test_magnet.main(
        ["--exp_name", "t", "--exp_dir", str(tmp_path), "--dataset_path",
         "none", "--synthetic_length", "1"] + SMALL +
        ["--FNET_feature_dim", "16", "--FNET_ckpt",
         os.path.dirname(fnet_run["ckpt"])])
    assert len(m) == 12 and all(np.isfinite(v) for v in m.values())


@pytest.mark.parametrize("form", ["parent", "step", "state.pt"])
def test_dnet_training_checkpoint_loads(tmp_path, form):
    """``--DNET_ckpt`` and ``load_dnet_checkpoint`` take a training
    checkpoint whose model is the D-Net's own state dict."""
    dnet = build.init_weights_(DNet(), seed=7)
    state = types.SimpleNamespace(
        step=3, model=dnet, generator=torch.Generator(),
        optimizer=torch.optim.SGD(dnet.parameters(), lr=0.1))
    path = _ckpt_path(checkpoint.save(str(tmp_path), state), form)
    args = _args(["--DNET_ckpt", path])
    model = build.load_magnet_checkpoints(build.build_magnet(args), args)
    alone = build.load_dnet_checkpoint(build.init_weights_(DNet(), 0), path)
    for got in (model.d_net.state_dict(), alone.state_dict()):
        assert got.keys() == dnet.state_dict().keys()
        for k, v in dnet.state_dict().items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)


def test_realistic_depth_init():
    model = build.realistic_depth_init_(build.build_magnet(_args()))
    x = torch.from_numpy(np.random.RandomState(0).rand(1, H, W, 3)
                         .astype(np.float32))
    with torch.no_grad():
        gauss, _ = model.d_net(x)
    torch.testing.assert_close(gauss[..., 0], torch.full_like(gauss[..., 0],
                                                              2.0))
    sigma = float(np.sqrt(np.expm1(-3.0) + 1.0 + 1e-10))
    torch.testing.assert_close(gauss[..., 1],
                               torch.full_like(gauss[..., 1], sigma))
    assert model.g_net.gnet[6].weight.abs().max() == 0


def test_reference_flag_file_parses():
    args = config.parse_args(config.build_test_magnet_parser(),
                             [SCANNET_FLAGS])
    assert (args.input_height, args.input_width) == (480, 640)
    assert (args.dpv_height, args.dpv_width) == (120, 160)
    assert args.MAGNET_num_source_views == 4 and args.MAGNET_num_samples == 5
    assert args.MAGNET_num_test_iter == 3 and args.device == "cuda"
    assert args.MAGNET_ckpt.endswith("MAGNET_scannet.pt")


def test_entry_point_synthetic_cpu(tmp_path):
    m = test_magnet.main(
        ["--exp_name", "t", "--exp_dir", str(tmp_path), "--dataset_path",
         "none", "--synthetic_length", "2"] + SMALL)
    assert len(m) == 12 and all(np.isfinite(v) for v in m.values())
    lines = (tmp_path / "t" / "log" / "test_acc.txt").read_text().split("\n")
    assert len(lines[2].split()) == 12
