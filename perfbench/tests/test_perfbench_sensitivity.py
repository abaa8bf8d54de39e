"""Under the benchmark's seeded weights every layer reaches the compared
maps: a small change to the B5 trunk, the F-Net, the cost volume's input
(a source camera) or G-Net moves them, well above float32's rounding. The
pins put the heads in a trained network's regime without zeroing any
layer's share."""

import json
from pathlib import Path

import pytest
import torch

from perfbench import inputs, weights
from perfbench.reference import magnet, nets

ROOT = Path(__file__).resolve().parents[2]
CFG = json.loads((ROOT / "perfbench/configs/magnet_scannet.json").read_text())
H, W = 64, 96
# one float32 rounding is 2**-23 (1.2e-7) of a value: a move ten times
# that is the layer's, not rounding's
MOVED = 1.2e-6


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(0)
    s = dict(CFG["shape"], H=H, W=W, h=H // 4, w=W // 4)
    cam = {k: v * (W / 640 if k in ("fx", "cx") else H / 480)
           for k, v in CFG["camera"].items()}
    g = torch.Generator().manual_seed(5)
    fs = inputs.frame_set(g, 1, s["V"], s, cam, CFG["motion"], "cpu")
    with torch.device("meta"):
        layout = nets.Magnet()
    w = weights.make_weights(layout, 11, "cpu", "eval", CFG["pins"])
    return s, fs, w


def maps(s, fs, w, perturb=None):
    model = nets.Magnet().eval()
    model.load_state_dict(w)
    fs = dict(fs)
    if perturb is not None:
        perturb(model, fs)
    k_list = magnet.sampling_offsets(s["sampling_range"], s["n_samples"])
    return magnet.forward(model, fs["ref_img"], fs["src_imgs"], fs["R"],
                          fs["t"], fs["is_valid"], fs["intM"], fs["rays2d"],
                          s["n_iters"], s["kappa"], k_list, s["k"])


def scale(name, factor=1.02):
    def perturb(model, fs):
        with torch.no_grad():
            dict(model.named_parameters())[name].mul_(factor)
    return perturb


def shift_camera(model, fs):
    fs["t"] = fs["t"] + torch.tensor([0.01, 0.0, 0.0])


@pytest.mark.parametrize("what,perturb", [
    ("trunk", scale("d_net.d_net.encoder.original_model.blocks.3.0."
                    "conv_pwl.weight")),
    ("F-Net", scale("f_net.f_net.layer2.3.conv1.0.0.weight")),
    ("cost volume input", shift_camera),
    ("G-Net", scale("g_net.gnet.2.weight")),
    ("mask head", scale("mask_head.4.weight"))])
def test_each_layer_moves_the_maps(setup, what, perturb):
    s, fs, w = setup
    base = maps(s, fs, w)
    moved = maps(s, fs, w, perturb)
    for b, m in zip(base, moved):
        rel = (m - b).abs().mean() / b.abs().mean()
        assert rel > MOVED, (what, float(rel))


def test_the_maps_are_in_a_trained_regime(setup):
    s, fs, w = setup
    last = maps(s, fs, w)[-1]
    assert 0.5 < float(last[..., 0].min()) and float(last[..., 0].max()) < 10
    assert 0.01 < float(last[..., 1].min())
