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

Also here: the streaming forward against the port's monolithic one (the
latter is held to JAX above), and the stage-3 training path (``fuse`` in
train mode, its loss and the G-Net and mask-head gradients against JAX's
``value_and_grad``; one port step moves only those two).
"""

import copy
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
from magnet_tpu_torch.eval import streaming
from magnet_tpu_torch.models import build
from magnet_tpu_torch.models.fnet import FNet
from magnet_tpu_torch.models.magnet import Magnet

from magnet_tpu_torch.models.dnet import DNet
from magnet_tpu_torch.train import checkpoint
from test_torch_dnet import _random_variables
from test_torch_kernels import torch_threads  # noqa: F401

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


@pytest.fixture(scope="module")
def port_model(magnet_case):
    """The port's Magnet with ``magnet_case``'s weights, in eval mode; tests
    that train copy it."""
    return _load(magnet_case[1])


@pytest.fixture(scope="module")
def monolithic(port_model, magnet_case):
    """The port's monolithic forward of ``magnet_case``'s sample."""
    with torch.no_grad():
        return port_model(*[torch.from_numpy(a) for a in magnet_case[2]])


def test_magnet_forward_matches_jax(magnet_case, monolithic):
    jm, variables, inputs = magnet_case
    refs = [np.asarray(r) for r in jm.apply(variables, *inputs)]
    outs = monolithic
    assert len(outs) == len(refs) == 3
    moved = np.abs(refs[-1] - refs[0]).max()
    assert moved > 1e-3, "the refinement steps changed nothing"
    assert refs[-1][..., 1].min() > 1e-3, "sigma collapsed"
    for out, ref in zip(outs, refs):
        assert out.shape == ref.shape == (1, H, W, 2)
        err = np.abs(out.numpy() - ref)
        lim = 1e-4 * float(np.abs(ref).max())
        assert (err > lim).mean() < 0.01, (err.max(), lim)


def test_magnet_weights_round_trip_is_exact(magnet_case, port_model):
    """port state_dict -> the JAX package's own converter -> the original
    variables, bit for bit."""
    _, variables, _ = magnet_case
    model = port_model
    assert model.g_net.gnet[0].weight.shape == (128, 261, 3, 3)
    back = torch_loader.convert_magnet(
        {k: v.numpy() for k, v in model.state_dict().items()}, variables)
    _assert_trees_equal(variables, back)


def test_checkpoints_load_in_stages(tmp_path, port_model):
    """D-Net, F-Net, then the MAGNET overlay, from files in the reference
    layout ('model' wrapper, DDP 'module.' prefixes)."""
    sd = port_model.state_dict()

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
    with pytest.raises(KeyError):                # into the same built model
        build.load_magnet_checkpoints(model, bad)


def _ckpt_path(step_dir: str, form: str) -> str:
    return {"parent": os.path.dirname(step_dir), "step": step_dir,
            "state.pt": os.path.join(step_dir, checkpoint.STATE_FILE)}[form]


@pytest.fixture(scope="module")
def dnet_training_case(tmp_path_factory):
    """A training checkpoint whose model is a D-Net's own state dict, and
    the two models the forms load into (``build_magnet``'s and a D-Net
    alone), made once."""
    dnet = build.init_weights_(DNet(), seed=7)
    state = types.SimpleNamespace(
        step=3, model=dnet, generator=torch.Generator(),
        optimizer=torch.optim.SGD(dnet.parameters(), lr=0.1))
    step_dir = checkpoint.save(str(tmp_path_factory.mktemp("dnet")), state)
    return (dnet, step_dir, build.build_magnet(_args()),
            build.init_weights_(DNet(), 0))


@pytest.mark.parametrize("form", ["parent", "step", "state.pt"])
def test_dnet_training_checkpoint_loads(dnet_training_case, form):
    """``--DNET_ckpt`` and ``load_dnet_checkpoint`` take a training
    checkpoint whose model is the D-Net's own state dict (the models are
    zeroed before each form loads)."""
    dnet, step_dir, magnet, alone = dnet_training_case
    path = _ckpt_path(step_dir, form)
    args = _args(["--DNET_ckpt", path])
    with torch.no_grad():
        for v in [*magnet.d_net.state_dict().values(),
                  *alone.state_dict().values()]:
            v.zero_()
    model = build.load_magnet_checkpoints(magnet, args)
    alone = build.load_dnet_checkpoint(alone, path)
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


# ---- streaming inference (eval/streaming.py) -----------------------------

def test_streaming_matches_monolithic(magnet_case, port_model, monolithic):
    """Each frame encoded alone (batch 1) and fused once: the monolithic
    forward's last map to rtol 1e-5, atol 1e-5 * max|ref| (the CPU's convs
    may sum a batch of 1 and of 3 in another order); a second window of the
    same frames hits the cache for all three and gives the same map bit for
    bit."""
    _, _, inputs = magnet_case
    batch = dict(zip(("ref_img", "src_imgs", "R", "t", "is_valid", "intM",
                      "rays2d"), inputs), view_ids=[["s/0", "s/1", "s/2"]])
    forward, cache = streaming.make_streaming_forward(
        port_model, torch.float32, torch.device("cpu"), n_iters=3)
    out = forward(batch)
    ref = monolithic[-1].numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    assert (cache.hits, cache.misses) == (0, 3)
    np.testing.assert_array_equal(forward(batch), out)
    assert (cache.hits, cache.misses, len(cache)) == (3, 3, 3)


class _StubMagnet:
    """encode: a frame -> (its mean as the Gaussian, ...); fuse: the
    reference Gaussian plus the sum of the sources'."""

    def encode(self, img):
        v = img.mean().reshape(1, 1, 1, 1)
        return v.expand(1, 2, 2, 2), v.expand(1, 2, 2, 3), v.expand(1, 2, 2, 4)

    def fuse(self, ref_gauss, x_d3, ref_feat, src_gauss, src_feat, *geo,
             n_iters):
        assert src_gauss.shape == (1, 2, 2, 2, 2)
        assert src_feat.shape == (1, 2, 2, 2, 4)
        return [ref_gauss + src_gauss.sum(1)]


def test_streaming_cache_reuse_eviction_and_bad_ids():
    """The LRU: a hit refreshes an entry, the least recent goes first, the
    counters and hit rate; a sliding window misses once in steady state;
    wrong id counts and batches above 1 are refused."""
    seen = []
    cache = streaming.FrameEncodingCache(lambda img: seen.append(img) or img,
                                         max_frames=2)
    for fid in ("a", "b", "a", "c", "b"):
        cache.get(fid, fid)
    assert seen == ["a", "b", "c", "b"]          # b was evicted by c
    assert (cache.hits, cache.misses, len(cache)) == (1, 4, 2)
    assert cache.hit_rate == 0.2

    frames = np.arange(6, dtype=np.float32)
    forward, cache = streaming.make_streaming_forward(
        _StubMagnet(), torch.float32, torch.device("cpu"), n_iters=1,
        max_frames=4)

    def window(ids, batch=1):
        return {"ref_img": np.full((batch, 2, 2, 3), frames[ids[0]]),
                "src_imgs": np.stack([np.full((batch, 2, 2, 3), frames[i])
                                      for i in ids[1:]], 1),
                "R": np.zeros((batch, 2, 3, 3)), "t": np.zeros((batch, 2, 3)),
                "is_valid": np.ones((batch, 2)), "intM": np.eye(3)[None],
                "rays2d": np.zeros((batch, 3, 4)),
                "view_ids": [[f"v/{i}" for i in ids]] * batch}

    for r in range(1, 5):                        # reference r, sources r +- 1
        out = forward(window([r, r - 1, r + 1]))
        assert out.shape == (1, 2, 2, 2) and np.all(out == 3 * r)
    assert (cache.hits, cache.misses) == (6, 6)  # one miss a window after two
    with pytest.raises(ValueError, match="view_ids"):
        forward(dict(window([1, 0, 2]), view_ids=[["v/1", "v/0"]]))
    with pytest.raises(ValueError, match="batch size 1"):
        forward(window([1, 0, 2], batch=2))


def test_synthetic_view_ids_match_jax():
    """The port's synthetic loader gives the JAX package's view ids for the
    same flags, carries them through ``collate``, and the entry point's
    ``batch_to_device`` leaves them out."""
    from magnet_tpu.data import make_multiview_loader as jax_loader
    from magnet_tpu_torch.data.synthetic import make_multiview_loader

    args = _args(["--synthetic_length", "2", "--MAGNET_num_source_views",
                  "4"])
    mine = [b["view_ids"] for b in make_multiview_loader(args)]
    theirs = [b["view_ids"] for b in jax_loader(args, "test")]
    assert mine == theirs == [[["synthetic/0_2", "synthetic/0_0",
                                "synthetic/0_1", "synthetic/0_3",
                                "synthetic/0_4"]],
                              [["synthetic/1_2", "synthetic/1_0",
                                "synthetic/1_1", "synthetic/1_3",
                                "synthetic/1_4"]]]
    batch = next(iter(make_multiview_loader(args)))
    assert len(test_magnet.batch_to_device(batch, torch.float32,
                                           torch.device("cpu"))) == 7


# ---- MaGNet training (stage 3) --------------------------------------------

def _fuse_inputs(B=2, V=2, h=8, w=8, F=64, k=4, seed=11):
    """Encoded inputs of ``fuse`` made with numpy: Gaussians in a trained
    network's regime, small camera motion, and a ground truth at k x the
    map with a few pixels past the maximum depth."""
    rng = np.random.RandomState(seed)

    def gauss(*lead):
        return np.stack([rng.uniform(2.0, 3.0, lead + (h, w)),
                         rng.uniform(0.2, 0.4, lead + (h, w))], -1)
    K = np.array([[0.9 * w, 0, w / 2], [0, 0.9 * w, h / 2], [0, 0, 1]])
    grid = np.ones((h, w, 3))
    grid[..., 0] = (np.arange(w)[None] + 0.5 - K[0, 2]) / K[0, 0]
    grid[..., 1] = (np.arange(h)[:, None] + 0.5 - K[1, 2]) / K[1, 1]
    depth = rng.uniform(1.5, 3.5, (B, h * k, w * k))
    depth[:, :2, :3] = 12.0
    enc = [gauss(B), rng.randn(B, h, w, 256) * 0.5, rng.randn(B, h, w, F),
           gauss(B, V), rng.randn(B, V, h, w, F),
           np.tile(np.eye(3), (B, V, 1, 1)), rng.randn(B, V, 3) * 0.05,
           np.ones((B, V)), np.tile(K, (B, 1, 1)),
           np.tile(grid.transpose(2, 0, 1).reshape(3, -1), (B, 1, 1))]
    return [a.astype(np.float32) for a in enc], depth.astype(np.float32)


def test_fuse_train_loss_and_grads_match_jax(magnet_case, port_model):
    """Stage 3 at the fuse level: ``fuse`` in train mode (G-Net and the mask
    head as plain convs, the previous prediction detached), one iteration at
    an 8x8 map, V = 2, B = 2, from numpy encodings, the gamma-weighted NLL
    of the clamped ground truth (``steps.magnet_preds_loss``), against the
    JAX package's ``value_and_grad`` of that loss of ``fuse`` in train mode.
    f32: the loss to rtol 1e-5, every G-Net and mask-head gradient to 1e-4
    * max|g| of its tensor (f32 sums in another order), as the F-Net step
    is held."""
    from magnet_tpu.train import losses as jlosses
    from magnet_tpu_torch.compat.from_jax import gnet_state_dict
    from magnet_tpu_torch.compat.from_jax import _chain_state_dict
    from magnet_tpu_torch.train import steps

    jm, variables, _ = magnet_case
    enc, depth = _fuse_inputs()
    params = {k: variables["params"][k] for k in ("g_net", "mask_head")}

    def jloss(p):
        preds = jm.apply({"params": p}, *enc, train=True, n_iters=1,
                         method="fuse")
        gt = jnp.where(depth > 10.0, 0.0, depth)
        return jlosses.magnet_loss(preds, gt, gt > 1e-3, 0.8)

    want_loss, jg = jax.jit(jax.value_and_grad(jloss))(params)
    jg = jax.tree.map(np.asarray, jg)
    want = {"g_net." + k: v for k, v in gnet_state_dict(jg["g_net"]).items()}
    want.update(_chain_state_dict(jg["mask_head"], "mask_head"))

    model = port_model.train()
    try:
        assert not model.d_net.training and not model.f_net.training
        preds = model.fuse(*[torch.from_numpy(a) for a in enc], n_iters=1)
        loss = steps.magnet_preds_loss(preds, torch.from_numpy(depth), 0.8,
                                       10.0, 1e-3)
        loss.backward()
        loss = float(loss.detach())
        got = {k: p.grad for k, p in model.named_parameters()
               if p.grad is not None}
    finally:
        model.eval()
        model.zero_grad(set_to_none=True)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    assert got.keys() == want.keys() and len(got) == 16
    for k, g in got.items():
        ref = want[k].numpy()
        err = np.abs(g.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (k, err)


def test_magnet_train_step_moves_only_gnet_and_mask_head(port_model, batch):
    """One port step (``make_magnet_train_step`` with
    ``make_magnet_optimizer``) from ``magnet_case``'s weights: finite loss,
    every G-Net and mask-head parameter moved, every D-Net and F-Net tensor
    (BatchNorm buffers included) as it was; the backbones stay in eval
    mode (the JAX package's tests/test_train.py:86)."""
    from magnet_tpu_torch.train import optim, steps

    model = copy.deepcopy(port_model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = steps.TrainState(model, optim.make_magnet_optimizer(
        model, lr=1e-3, total_steps=10))
    step = steps.make_magnet_train_step(0.8, 10.0, 1e-3, n_iters=1)
    state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert np.isfinite(float(m["loss"])) and state.step == 1
    assert not model.d_net.training and not model.f_net.training
    for k, v in model.state_dict().items():
        trained = k.split(".")[0] in ("g_net", "mask_head")
        assert torch.equal(v, before[k]) != trained, k
