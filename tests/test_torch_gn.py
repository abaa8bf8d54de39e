"""The port's GroupNorm decoder (DenseDepth_GN) against the JAX package, on
the CPU.

Weight-standardised convs and GroupNorm (f32 and bf16, atol 1e-5), one
``UpSampleGN`` stage (atol 2e-5, tests/test_gn_variant.py's) and its
train-mode gradients (1e-4 of the largest), the GN decoder and heads at
downsample ratios 2, 4 and 8 fed seeded skip features (atol 2e-4,
tests/test_torch_dnet.py's: the trunk is held there), one whole GN D-Net at
32x32, the weights' round trip for a GN D-Net and a MaGNet built on one,
and ``cast_for_inference`` (tests/test_torch_data.py runs the four entry
points with ``--DNET_architecture DenseDepth_GN`` on a ScanNet tree). The
JAX decoder runs on its XLA
paths (``MAGNET_TPU_PALLAS_UP=0``, ``MAGNET_TPU_PALLAS_UP2=0``, as the
existing harness sets them).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

import magnet_tpu.nn.densedepth as jdd
import magnet_tpu_torch.nn.densedepth as tdd
from magnet_tpu.compat import torch_loader
from magnet_tpu.models.dnet import DNet as JDNet
from magnet_tpu.models.magnet import Magnet as JMagnet
from magnet_tpu.nn.layers import GroupNorm as JGroupNorm
from magnet_tpu.nn.layers import WSConv as JWSConv
from magnet_tpu_torch.compat.from_jax import (dnet_state_dict,
                                              magnet_state_dict)
from magnet_tpu_torch.models import build
from magnet_tpu_torch.models.dnet import DNet
from magnet_tpu_torch.models.magnet import Magnet
from magnet_tpu_torch.nn.densedepth import UpSampleGN
from magnet_tpu_torch.nn.layers import WSConv2d, group_norm

from test_torch_kernels import torch_threads  # noqa: F401

DNET_ATOL = 2e-4
DNET_SHAPE = (1, 32, 32, 3)
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def xla_decoder(monkeypatch):
    monkeypatch.setenv("MAGNET_TPU_PALLAS_UP", "0")
    monkeypatch.setenv("MAGNET_TPU_PALLAS_UP2", "0")


def _random_variables(shapes, seed=0):
    """numpy variables for a JAX tree of shapes: fan-in scaled conv kernels
    (activations stay O(1) through the trunk), small biases, GroupNorm and
    BatchNorm scales in [0.5, 1.5], positive BatchNorm statistics (the
    recipe of tests/test_torch_dnet.py, drawn in f32 from a
    ``default_rng``, which is several times faster at the decoder's 40M
    weights)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        names = [getattr(p, "key", str(p)) for p in path]
        leaf, shape = names[-1], s.shape
        if leaf == "kernel":
            v = rng.standard_normal(shape, np.float32)
            v *= np.float32(np.prod(shape[:3]) ** -0.5)
        elif leaf == "scale":
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == "mean":
            v = rng.standard_normal(shape) * 0.5
        elif leaf == "var":
            v = rng.uniform(0.5, 2.0, shape)
        else:                                   # conv and norm biases
            v = rng.standard_normal(shape) * (
                0.1 if names[-2] in ("bn", "gn") else 0.02)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _nchw(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(a).to(dtype).permute(0, 3, 1, 2)


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_wsconv_matches_jax(dt):
    """The kernel standardised in f32, then cast; the bias added in the
    activation dtype."""
    tdt, jdt = DTYPES[dt]
    rng = np.random.RandomState(0)
    x = rng.randn(2, 10, 12, 6).astype(np.float32)
    kernel = (rng.randn(3, 3, 6, 8) * 0.3 + 0.1).astype(np.float32)
    bias = (rng.randn(8) * 0.1).astype(np.float32)
    want = JWSConv(8, 3, padding=1).apply(
        {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x, jdt))
    conv = WSConv2d(6, 8, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.from_numpy(bias))
        got = conv(_nchw(x, tdt))
    assert got.dtype == tdt and conv.weight.dtype == torch.float32
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(),
                               _f32(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_group_norm_matches_jax(dt):
    """8 groups, eps 1e-5, f32 statistics and affine, x's dtype out."""
    tdt, jdt = DTYPES[dt]
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 6, 7, 32) * 2 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    shift = (rng.randn(32) * 0.1).astype(np.float32)
    want = JGroupNorm(8).apply(
        {"params": {"gn": {"scale": scale, "bias": shift}}},
        jnp.asarray(x, jdt))
    gn = torch.nn.GroupNorm(8, 32)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(shift))
        got = group_norm(_nchw(x, tdt), gn)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(),
                               _f32(want), rtol=0, atol=1e-5)


def _stage_case(seed=4):
    rng = np.random.RandomState(9)
    x = rng.randn(2, 4, 5, 24).astype(np.float32)
    skip = rng.randn(2, 8, 10, 8).astype(np.float32)
    jm = jdd.UpSampleGN(features=32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, skip)
    variables = jax.tree.map(np.asarray, _random_variables(shapes, seed))
    return x, skip, jm, variables


def _stage_keys(tree) -> dict:
    """A JAX UpSampleGN tree -> the port stage's state-dict keys."""
    return {k[len("d_net.decoder.up1."):]: v for k, v in dnet_state_dict(
        {c: {"d_net": {"up1": t}} for c, t in tree.items()}).items()}


def test_upsample_gn_matches_jax():
    x, skip, jm, variables = _stage_case()
    want = jm.apply(variables, x, skip)
    stage = UpSampleGN(24 + 8, 32).eval()
    stage.load_state_dict(_stage_keys(variables))
    with torch.no_grad():
        got = stage(torch.from_numpy(x), torch.from_numpy(skip))
    assert got.shape == (2, 8, 10, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_upsample_gn_grads_match_jax():
    """A GN stage in train mode: the output and every parameter's gradient
    (through the standardisation) against ``jax.grad``, to 1e-4 of the
    largest gradient."""
    x, skip, jm, variables = _stage_case(seed=5)
    cot = np.random.RandomState(3).randn(2, 8, 10, 32).astype(np.float32)

    def loss(p):
        y = jm.apply({"params": p}, x, skip, train=True)
        return jnp.sum(y * cot), y

    (_, jy), jg = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    stage = UpSampleGN(24 + 8, 32).train()
    stage.load_state_dict(_stage_keys(variables))
    y = stage(torch.from_numpy(x), torch.from_numpy(skip))
    (y * torch.from_numpy(cot)).sum().backward()
    want = _stage_keys({"params": jax.tree.map(np.asarray, jg)})
    grads = dict(stage.named_parameters())
    assert grads.keys() == want.keys() and len(grads) == 8
    g_max = max(np.abs(g.numpy()).max() for g in want.values())
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=2e-5)
    for k, p in grads.items():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-4 * g_max, err_msg=k)


class _JSkips(fnn.Module):
    """Stands in for the JAX trunk: the seeded skip features of
    ``_SKIPS``, whatever the input."""
    remat: bool = False

    @fnn.compact
    def __call__(self, x, train=False):
        return tuple(jnp.asarray(s) for s in _SKIPS)


class _TSkips(torch.nn.Module):
    """The same for the port's trunk (NCHW out)."""

    def __init__(self, *args):
        super().__init__()

    def forward(self, x, generator=None):
        return [torch.from_numpy(s).permute(0, 3, 1, 2) for s in _SKIPS]


# f4, f5, f6, f8, f11 of a 64x96 frame: (1/2, 24), (1/4, 40), (1/8, 64),
# (1/16, 176), (1/32, 2048)
_SKIPS = [np.random.RandomState(10 + i).randn(1, 64 >> s, 96 >> s, c)
          .astype(np.float32) for i, (s, c) in enumerate(
              ((1, 24), (2, 40), (3, 64), (4, 176), (5, 2048)))]


@pytest.mark.parametrize("ratio", [2, 4, 8])
def test_gn_decoder_and_heads_match_jax(ratio, monkeypatch):
    """The GN decoder, both heads and the convex upsampling (DenseDepth
    with ``as_dnet``, raw output) against JAX ``DenseDepth(use_bn=False)``,
    both trunks replaced by the same seeded skip features."""
    monkeypatch.setattr(jdd, "EfficientNetB5Features", _JSkips)
    monkeypatch.setattr(tdd, "Encoder", _TSkips)
    jm = jdd.DenseDepth(use_bn=False, downsample_ratio=ratio)
    x = np.zeros((1, 64, 96, 3), np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    variables = jax.tree.map(np.asarray, _random_variables(shapes, ratio))
    want = np.asarray(jax.jit(jm.apply)(variables, x))
    model = tdd.DenseDepth(use_bn=False, downsample_ratio=ratio).eval()
    model.load_state_dict({k[len("d_net."):]: v for k, v in dnet_state_dict(
        {c: {"d_net": t} for c, t in variables.items()}).items()})
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 64, 96, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=DNET_ATOL)


@pytest.fixture(scope="module")
def gn_case():
    x = np.random.RandomState(0).rand(*DNET_SHAPE).astype(np.float32)
    shapes = jax.eval_shape(JDNet(use_bn=False).init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct(DNET_SHAPE, jnp.float32))
    variables = jax.tree.map(np.asarray, _random_variables(shapes))
    model = DNet(use_bn=False).eval()
    model.load_state_dict(dnet_state_dict(variables))
    return x, variables, model


def test_gn_dnet_matches_jax(gn_case):
    x, variables, model = gn_case
    want = np.asarray(jax.jit(JDNet(use_bn=False).apply)(variables, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == DNET_SHAPE[:3] + (2,)
    np.testing.assert_allclose(got, want, atol=DNET_ATOL)


def _assert_trees_equal(a, b):
    flat_a = jax.tree_util.tree_leaves_with_path(a)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(b))
    assert len(flat_a) == len(flat_b)
    for path, x in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), x)


def test_gn_weights_round_trip_is_exact(gn_case):
    """JAX variables -> ``from_jax`` -> the port -> the JAX package's
    ``convert_dnet`` / ``convert_magnet`` -> the same variables, bit for
    bit, for a GN D-Net and a MaGNet built on one (no running statistics
    in the GN stages)."""
    _, variables, model = gn_case
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert not any("up1._net.1.running" in k for k in sd)
    _assert_trees_equal(variables, torch_loader.convert_dnet(sd, variables))

    S, V = (1, 32, 32, 3), 2
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in (
        S, (1, V) + S[1:], (1, V, 3, 3), (1, V, 3), (1, V), (1, 3, 3),
        (1, 3, 64))]
    shapes = jax.eval_shape(JMagnet(use_bn=False).init,
                            jax.random.PRNGKey(0), *args)
    mvars = jax.tree.map(np.asarray, _random_variables(shapes, seed=2))
    magnet = Magnet(use_bn=False)
    res = magnet.load_state_dict(magnet_state_dict(mvars), strict=False)
    assert not res.unexpected_keys and all(
        k.startswith("d_net.d_net.decoder.mask_head.")
        for k in res.missing_keys)
    _assert_trees_equal(mvars, torch_loader.convert_magnet(
        {k: v.numpy() for k, v in magnet.state_dict().items()}, mvars))


def test_cast_for_inference_keeps_wsconv_f32(gn_case):
    """bf16 inference casts every plain conv and leaves the
    weight-standardised convs (and the GroupNorms) in f32: the bf16 GN
    stage then equals its f32 weights' stage run in bf16 through the same
    standardisation, bit for bit."""
    import copy
    _, _, model = gn_case
    up = copy.deepcopy(model.d_net.decoder.up3)
    cast = build.cast_for_inference(copy.deepcopy(model), torch.bfloat16)
    dec = cast.d_net.decoder
    ws = [m for m in dec.modules() if isinstance(m, WSConv2d)]
    assert len(ws) == 6 and all(
        m.weight.dtype == m.bias.dtype == torch.float32 for m in ws)
    assert all(m.weight.dtype == torch.float32 for m in dec.modules()
               if isinstance(m, torch.nn.GroupNorm))
    assert dec.conv2.weight.dtype == dec.depth_head[0].weight.dtype \
        == torch.bfloat16
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(1, 2, 3, 512).astype(np.float32))
    skip = torch.from_numpy(rng.randn(1, 4, 6, 40).astype(np.float32))
    with torch.no_grad():
        got = dec.up3(x.bfloat16(), skip.bfloat16())
        want = up(x.bfloat16(), skip.bfloat16())
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_gn_reference_checkpoint_loads(gn_case, tmp_path):
    """A GN D-Net checkpoint in the reference layout (no running
    statistics; 'model' wrapper, DDP 'module.' prefixes) loads through
    ``load_dnet_checkpoint`` into ``build_dnet``'s GN model, exactly."""
    from magnet_tpu_torch.core import config
    _, _, model = gn_case
    sd = model.state_dict()
    torch.save({"model": {"module." + k: v for k, v in sd.items()}},
               tmp_path / "gn.pt")
    args = config.parse_args(config.build_test_dnet_parser(), [
        "--exp_name", "t", "--exp_dir", str(tmp_path), "--output_dim", "2",
        "--output_type", "G", "--DNET_architecture", "DenseDepth_GN",
        "--dataset_name", "synthetic", "--dataset_path", "none",
        "--ckpt_path", "", "--device", "cpu"])
    got = build.load_dnet_checkpoint(build.build_dnet(args),
                                     str(tmp_path / "gn.pt")).state_dict()
    assert got.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("use_bn", [True, False], ids=["bn", "gn"])
def test_decoder_remat_matches(use_bn, monkeypatch):
    """``remat`` recomputes the decoder's stages in the backward, as the
    JAX package's ``nn.remat`` does for both decoders: the same output and
    gradients, bit for bit, and each BatchNorm's running statistics updated
    once."""
    monkeypatch.setattr(tdd, "Encoder", _TSkips)
    x = torch.zeros(1, 64, 96, 3)
    grads, outs, stats = [], [], []
    for remat in (False, True):
        model = tdd.DenseDepth(downsample_ratio=8, use_bn=use_bn,
                               remat=remat)
        build.init_flax_weights_(model, seed=1)
        model.train()
        y = model(x)
        (y * y).sum().backward()
        outs.append(y.detach())
        grads.append({k: p.grad for k, p in model.named_parameters()})
        stats.append({k: v.clone() for k, v in model.state_dict().items()
                      if "running" in k})
    assert torch.equal(outs[0], outs[1])
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) > 10
    for k, g in grads[0].items():
        assert torch.equal(g, grads[1][k]), k
    assert (len(stats[0]) > 0) == use_bn
    for k, v in stats[0].items():
        assert torch.equal(v, stats[1][k]), k
