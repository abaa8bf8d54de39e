"""The port's EfficientNet trunk kernels (kernels/dw_conv.py,
kernels/mbconv_chain.py, nn/efficientnet.py's switches) against the JAX
package.

CPU: each plain version is held against the Pallas kernel it replaces, run
in interpret mode as the JAX package's own tests run it, on the same seeded
numpy inputs: the depthwise conv directly, the MBConv chain on operands that
the port folds from its modules against the JAX kernel on operands that the
JAX module's own ``_fused_chain`` stacks. The whole trunk with both switches
on is held against the JAX trunk on its module path
(``MAGNET_TPU_PALLAS_MB=0``, ``MAGNET_TPU_PALLAS_DW=0``). f32, rtol 1e-4 and
atol 1e-4 * max|ref| (both accumulate in f32 and differ in the order of the
sums); bf16 at 2e-2 * max|ref| (one rounding of the output).

CUDA (marker ``cuda``, skipped without a card): each kernel against its
plain version on the card, f32 at 1e-4 * max|ref| and bf16 at 2e-2 *
max|ref|, at map sizes that are not tile multiples; the launch counts; the
rule that a CUDA tensor never reaches a plain version; what the wrappers
refuse. These import no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_trunk.py``.
"""

import numpy as np
import pytest
import torch

from magnet_tpu_torch.kernels import dw_conv as dk
from magnet_tpu_torch.kernels import mbconv_chain as mk
from magnet_tpu_torch.nn import efficientnet, layers
from magnet_tpu_torch.nn.efficientnet import (EfficientNetB5Features,
                                              InvertedResidual,
                                              fold_mbconv_chain)

RTOL = 1e-4
_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _close(out, ref, tol=1e-4, rtol=RTOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(out, np.float32), ref, rtol=rtol,
                               atol=tol * float(np.abs(ref).max()))


def dw_inputs(N=2, H=12, W=16, C=24, K=3, seed=0):
    """numpy x (N, H, W, C) and taps (K, K, C)."""
    rng = np.random.RandomState(seed)
    return (rng.randn(N, H, W, C).astype(np.float32),
            (rng.randn(K, K, C) / K).astype(np.float32))


def _block_cfg(C, M, K):
    return dict(btype="ir", kernel=K, stride=1, expand=M // C, in_ch=C,
                out_ch=C)


def chain_blocks(C=16, M=96, K=3, nb=2, seed=0):
    """nb equal-shaped stride-1 InvertedResidual blocks with seeded random
    weights and BatchNorm statistics (SE width max(1, C // 4))."""
    g = torch.Generator().manual_seed(seed)
    blocks = [InvertedResidual(_block_cfg(C, M, K)).eval() for _ in range(nb)]
    with torch.no_grad():
        for b in blocks:
            for m in b.modules():
                if isinstance(m, torch.nn.Conv2d):
                    m.weight.normal_(0, m.weight[0].numel() ** -0.5,
                                     generator=g)
                    if m.bias is not None:
                        m.bias.normal_(0, 0.1, generator=g)
                elif isinstance(m, torch.nn.BatchNorm2d):
                    m.weight.uniform_(0.5, 1.5, generator=g)
                    m.bias.normal_(0, 0.1, generator=g)
                    m.running_mean.normal_(0, 0.5, generator=g)
                    m.running_var.uniform_(0.5, 2.0, generator=g)
    return blocks


def chain_x(N=2, H=8, W=8, C=16, seed=1):
    return np.random.RandomState(seed).randn(N, H, W, C).astype(np.float32)


# ---- the plain versions against the JAX kernels ----------------------------

@pytest.mark.parametrize("K,C", [(3, 24), (5, 48)])
def test_dw_conv_ref_matches_jax_kernel(K, C):
    import jax.numpy as jnp
    from magnet_tpu.kernels.dwconv_pallas import dw_conv_pallas
    x, w = dw_inputs(C=C, K=K)
    p = (K - 1) // 2
    ref = dw_conv_pallas(jnp.asarray(x), jnp.asarray(w)[:, :, None],
                         ((p, K - 1 - p), (p, K - 1 - p)), interpret=True)
    _close(dk.dw_conv(torch.from_numpy(x), torch.from_numpy(w)).numpy(), ref)


def test_dw_conv_ref_matches_jax_kernel_bf16():
    """bf16 x and taps: both sides take exact products in f32 and round the
    sum once."""
    import jax.numpy as jnp
    from magnet_tpu.kernels.dwconv_pallas import dw_conv_pallas
    x, w = dw_inputs(C=48, K=5, seed=2)
    ref = dw_conv_pallas(jnp.asarray(x, jnp.bfloat16),
                         jnp.asarray(w, jnp.bfloat16)[:, :, None],
                         ((2, 2), (2, 2)), interpret=True)
    bf = torch.bfloat16
    out = dk.dw_conv(torch.from_numpy(x).to(bf), torch.from_numpy(w).to(bf))
    assert out.dtype == bf
    _close(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), 2e-2,
           rtol=0)


def _jax_block_variables(block: InvertedResidual) -> tuple:
    """The port block's parameters as the JAX InvertedResidual's ``params``
    and ``batch_stats`` trees (HWIO kernels)."""
    def conv(m):
        d = {"kernel": m.weight.detach().permute(2, 3, 1, 0).numpy()}
        if m.bias is not None:
            d["bias"] = m.bias.detach().numpy()
        return {"conv": d}

    def bn(m):
        return ({"bn": {"scale": m.weight.detach().numpy(),
                        "bias": m.bias.detach().numpy()}},
                {"bn": {"mean": m.running_mean.numpy(),
                        "var": m.running_var.numpy()}})

    params, stats = {}, {}
    for name in ("conv_pw", "conv_dw", "conv_pwl"):
        params[name] = conv(getattr(block, name))
    for name in ("bn1", "bn2", "bn3"):
        params[name], stats[name] = bn(getattr(block, name))
    params["se"] = {"conv_reduce": conv(block.se.conv_reduce),
                    "conv_expand": conv(block.se.conv_expand)}
    return params, stats


@pytest.mark.parametrize("K", [3, 5])
def test_mbconv_chain_ref_matches_jax_kernel(K):
    """2 blocks, 8x8 map, C 16, M 96, R 4, randomised BatchNorm statistics:
    the port's plain chain on the operands it folds from its modules against
    the JAX kernel on the operands the JAX module's ``_fused_chain`` stacks
    from the same parameters."""
    import jax.numpy as jnp
    from magnet_tpu.nn.efficientnet import EfficientNetB5Features as JTrunk
    blocks = chain_blocks(K=K)
    x = chain_x()
    si = 1
    params, stats = {}, {}
    for j, b in enumerate(blocks):
        params[f"blocks_{si}_{j + 1}"], stats[f"blocks_{si}_{j + 1}"] = \
            _jax_block_variables(b)
    chain = [_block_cfg(16, 96, K)] * len(blocks)
    ref = JTrunk().apply({"params": params, "batch_stats": stats},
                         jnp.asarray(x), si, chain,
                         method=JTrunk._fused_chain)
    ops = fold_mbconv_chain(blocks, torch.float32)
    assert ops[4].shape == (2, 96, 4)                       # wse1: R = 4
    out = mk.mbconv_chain(torch.from_numpy(x), *ops, K)
    _close(out.numpy(), ref)


def test_mbconv_chain_ref_equals_the_blocks():
    """The plain chain against the port's own modules run one after the
    other (eval BatchNorm unfolded, the SE gate in f32)."""
    blocks = chain_blocks(C=24, M=144, K=5, nb=3, seed=3)
    x = torch.from_numpy(chain_x(H=7, W=9, C=24))
    with torch.no_grad():
        ref = layers.nchw(x)
        for b in blocks:
            ref = b(ref)
        out = mk.mbconv_chain(x, *fold_mbconv_chain(blocks, torch.float32), 5)
    _close(out.numpy(), layers.nhwc(ref).numpy())


def _jax_trunk_variables(model, rng):
    """Seeded numpy variables in the JAX trunk's layout, shaped from the
    port's modules (``blocks.{si}.{bi}.x`` is JAX's ``blocks_{si}_{bi}/x``):
    fan-in scaled HWIO kernels, small biases, well-conditioned BatchNorm
    statistics (mean ~0, var ~1, as tests/test_mbchain_pallas.py has them):
    through 39 blocks a random network amplifies the order of f32 sums."""
    params, stats = {}, {}
    for name, m in model.named_modules():
        parts = name.split(".")
        if parts[0] == "blocks" and len(parts) > 3:
            parts = [f"blocks_{parts[1]}_{parts[2]}"] + parts[3:]
        if isinstance(m, torch.nn.Conv2d):
            shape = tuple(m.weight.permute(2, 3, 1, 0).shape)
            leaf = {"kernel": (rng.randn(*shape) * np.prod(shape[:3]) ** -0.5
                               ).astype(np.float32)}
            if m.bias is not None:
                leaf["bias"] = (0.05 * rng.randn(*m.bias.shape)).astype(
                    np.float32)
            tree, leaf = params, {"conv": leaf}
        elif isinstance(m, torch.nn.BatchNorm2d):
            c = m.num_features
            leaf = {"bn": {"scale": np.ones(c, np.float32),
                           "bias": (0.05 * rng.randn(c)).astype(np.float32)}}
            node = stats
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = {"bn": {
                "mean": (0.05 * rng.randn(c)).astype(np.float32),
                "var": (np.abs(0.05 * rng.randn(c)) + 1.0).astype(
                    np.float32)}}
            tree = params
        else:
            continue
        for p in parts[:-1]:
            tree = tree.setdefault(p, {})
        tree[parts[-1]] = leaf
    return {"params": params, "batch_stats": stats}


def test_trunk_with_its_kernels_matches_jax_module_path(monkeypatch):
    """The port's trunk with the chain and the depthwise kernel on (their
    plain versions on the CPU) against the JAX trunk on its module path, at
    32x64; the port's weights come from the JAX variables through
    compat/from_jax.py."""
    import jax
    from magnet_tpu.nn.efficientnet import EfficientNetB5Features as JTrunk
    from magnet_tpu_torch.compat.from_jax import dnet_state_dict
    monkeypatch.setenv("MAGNET_TPU_PALLAS_MB", "0")
    monkeypatch.setenv("MAGNET_TPU_PALLAS_DW", "0")
    rng = np.random.RandomState(0)
    x = (rng.randn(1, 32, 64, 3) * 0.5).astype(np.float32)
    model = EfficientNetB5Features(mbconv_chain="all", dw_kernel=True).eval()
    variables = _jax_trunk_variables(model, rng)
    ref = jax.jit(JTrunk().apply)(variables, x)
    pre = "d_net.encoder.original_model."
    sd = dnet_state_dict({c: {"d_net": {"encoder": v}}
                          for c, v in variables.items()})
    model.load_state_dict({k[len(pre):]: v for k, v in sd.items()})
    with torch.no_grad():
        out = model(layers.nchw(torch.from_numpy(x)))
    for o, r in zip(out, ref):
        _close(layers.nhwc(o).numpy(), r)


def _counting(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(x, *a, **k):
        calls.append(x.shape[-1])
        return fn(x, *a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("chain,dw,n_chain,dw_channels", [
    ("all", True, 6, [48, 24, 24, 768, 1824]),
    ("all", False, 6, []),
    (None, True, 0, None),
    (None, False, 0, []),
    ((3, 5), False, 2, []),
], ids=["both", "chain", "dw", "off", "stages_3_5"])
def test_trunk_dispatch(monkeypatch, chain, dw, n_chain, dw_channels):
    """Per trunk pass: with both switches on, 6 chain calls (the tails of
    stages 1-6) and 5 depthwise kernel calls (the 3 blocks of stage 0 and
    block 0 of stages 4 and 6, the stride-1 conv_dw left outside the
    chains); with the chain alone no depthwise call; with the depthwise
    kernel alone all 35 stride-1 conv_dw; off, none."""
    chains = _counting(monkeypatch, efficientnet, "mbconv_chain")
    dws = _counting(monkeypatch, layers, "dw_conv")
    model = EfficientNetB5Features(chain, dw).eval()
    with torch.no_grad():
        model(torch.zeros(1, 3, 32, 32))
    assert len(chains) == n_chain
    if dw_channels is None:
        assert len(dws) == 35
    else:
        assert dws == dw_channels
    model.train()                      # the switches act in eval mode only
    model(torch.zeros(2, 3, 32, 32))
    assert len(chains) == n_chain and len(dws) == (35 if dw_channels is None
                                                   else len(dw_channels))


def test_chain_operands_refold_when_a_parameter_changes():
    model = EfficientNetB5Features("all").eval()
    a = model.chain_operands(6, torch.float32)
    assert model.chain_operands(6, torch.float32) is a
    with torch.no_grad():
        model.blocks[6][1].bn3.bias.add_(1.0)
    b = model.chain_operands(6, torch.float32)
    assert b is not a and torch.equal(b[-1][0], a[-1][0] + 1.0)
    assert torch.equal(b[-1][1], a[-1][1])


def test_dw_taps_refold_when_the_weight_changes():
    """The depthwise route keeps its (K, K, C) taps on the conv until the
    weight changes, and computes what the conv module does."""
    g = torch.Generator().manual_seed(5)
    conv = torch.nn.Conv2d(16, 16, 3, groups=16, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g))
    x = torch.randn(1, 16, 6, 8, generator=g).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        y = layers.conv2d_same(x, conv, dw_kernel=True)
        taps = conv._folded["dw_taps"][1]
        layers.conv2d_same(x, conv, dw_kernel=True)
        assert conv._folded["dw_taps"][1] is taps
        conv.weight.mul_(2.0)
        y2 = layers.conv2d_same(x, conv, dw_kernel=True)
        assert conv._folded["dw_taps"][1] is not taps
        ref = layers.conv2d_same(x, conv)
    np.testing.assert_allclose(y2.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    np.testing.assert_allclose(y2.numpy(), 2.0 * y.numpy(), rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))


def _dw_tile_walk(x, w, th=16, tw=16, cb=16, R=8):
    """The bf16 kernel's walk in plain PyTorch, f32, on tiles of th x tw
    pixels and cb channels: for each tile the box of its input with the
    halo, from (y0 - pt, x0 - pl), zero outside the map and past C (the
    tensor map's fill); each thread's column of R outputs adds input row
    i's K vectors into output rows i - K + 1 .. i; outputs outside the map
    are dropped. A depthwise conv gives the same result under any tiling,
    so one tile shape stands for the kernel's."""
    N, H, W, C = x.shape
    K = w.shape[0]
    pt = (K - 1) // 2
    xp = torch.nn.functional.pad(x.float(), (0, cb, pt, tw + K, pt, th + K))
    wp = torch.nn.functional.pad(w.float(), (0, cb))
    out = torch.zeros(N, H + th, W + tw, C + cb)
    for y0 in range(0, H, th):
        for x0 in range(0, W, tw):
            for c0 in range(0, C, cb):
                box = xp[:, y0:y0 + th + K - 1, x0:x0 + tw + K - 1, c0:c0 + cb]
                taps = wp[:, :, c0:c0 + cb]
                for r0 in range(0, th, R):
                    acc = torch.zeros(N, R, tw, cb)
                    for i in range(R + K - 1):
                        for j in range(max(0, i - K + 1), min(i + 1, R)):
                            for d in range(K):
                                acc[:, j] += (box[:, r0 + i, d:d + tw]
                                              * taps[i - j, d])
                    out[:, y0 + r0:y0 + r0 + R, x0:x0 + tw,
                        c0:c0 + cb] = acc
    return out[:, :H, :W, :C].to(x.dtype)


@pytest.mark.parametrize("K,C", [(3, 24), (3, 48), (5, 24), (5, 48)])
def test_dw_tile_walk_matches_plain(K, C):
    """The kernel's tiles and sliding window at a map that is no tile
    multiple (21 x 35, two images), with a last channel block that is part
    empty, equal the plain version."""
    x, w = (torch.from_numpy(a) for a in dw_inputs(N=2, H=21, W=35, C=C,
                                                    K=K, seed=K + C))
    _close(_dw_tile_walk(x, w).numpy(), dk.dw_conv_ref(x, w).numpy(),
           tol=1e-5)


def test_chain_stages_and_flag():
    from magnet_tpu_torch.core import config
    assert efficientnet.chain_stages("all") == frozenset(range(1, 7))
    assert efficientnet.chain_stages((0, 2)) == frozenset({2})
    with pytest.raises(ValueError):
        efficientnet.chain_stages((7,))
    assert config.parse_mbconv_chain("none") is None
    assert config.parse_mbconv_chain("3,5") == (3, 5)
    with pytest.raises(ValueError):
        config.parse_mbconv_chain("x")


# the six path-A stage tails at 480x640: (N, H, W, C, M, K)
PATH_A = [(1, 120, 160, 40, 240, 3), (1, 60, 80, 64, 384, 5),
          (1, 30, 40, 128, 768, 3), (1, 30, 40, 176, 1056, 5),
          (1, 15, 20, 304, 1824, 5), (1, 15, 20, 512, 3072, 3)]


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("N", [1, 5])
@pytest.mark.parametrize("site", range(6))
def test_mbconv_plan_fits_and_covers(site, N, elem):
    """Every path-A stage tail, one frame and five, both types: the expand
    tiles cover the map with a halo at most the tile (or are the map), the
    K ranges cover M in multiples of 64, both kernels' shared-memory
    layouts are in order, aligned as the kernels take them and fit, and in
    bf16 at one frame each kernel puts a block on most SMs."""
    _, H, W, C, M, K = PATH_A[site]
    R = C // 4
    p = mk.plan(N, H, W, C, M, R, K, elem)
    th, tw = p["th"], p["tw"]
    assert p["tiles"] == -(-H // th) * -(-W // tw) and th <= H and tw <= W
    assert min(th, tw) >= K - 1 or (th, tw) == (H, W)
    ring, e, red, ex_bytes = p["ex_layout"]
    assert (ring, e, red, ex_bytes) == mk.expand_layout(th, tw, C, K, elem)
    assert 0 < ring < e < red < ex_bytes <= mk.SMEM_MAX
    assert ring % 1024 == 0 and e % 16 == 0 and red % 16 == 0
    assert red - e >= (th + K - 1) * (tw + K - 1) * 64 * elem
    assert p["kc"] % 64 == 0 and p["kc"] <= mk.KC_MAX
    assert p["splits"] * p["kc"] >= M > (p["splits"] - 1) * p["kc"]
    a, gate, r, pr_bytes = p["pr_layout"]
    assert 0 < a < gate < r < pr_bytes <= mk.SMEM_MAX
    assert a % 1024 == 0 and gate % 16 == 0 and r - gate >= 4 * p["kc"]
    assert p["slices"] == -(-M // 64) and p["tpf"] == -(-H * W // 64)
    if N == 1 and elem == 2:
        assert N * p["tiles"] * p["slices"] >= 0.85 * mk.SMS
        assert N * p["tpf"] * p["ctiles"] * p["splits"] >= 0.85 * mk.SMS


def test_mbconv_plan_whole_map_and_split_k():
    """The choice the plan makes: the 15x20 map at five frames is one tile
    (no halo recomputed) and fills the card; at one frame it is cut into
    tiles to fill the SMs; stage 1's 120x160 map never runs whole; the
    late stages split K at one frame (at least 3 partials to sum), stage 1
    at five frames does not; the block is two launches."""
    big = mk.plan(5, 15, 20, 512, 3072, 128, 3, 2)
    assert (big["th"], big["tw"], big["tiles"]) == (15, 20, 1)
    small = mk.plan(1, 15, 20, 512, 3072, 128, 3, 2)
    assert small["tiles"] > 1 and small["splits"] >= 3
    assert mk.plan(1, 15, 20, 304, 1824, 76, 5, 2)["splits"] >= 3
    wide = mk.plan(5, 120, 160, 40, 240, 10, 3, 2)
    assert wide["tiles"] > 1 and wide["splits"] == 1
    assert mk.LAUNCHES_PER_BLOCK == 2
    with pytest.raises(ValueError):           # no tile fits beside the weights
        mk.plan(1, 8, 8, 4096, 512, 16, 3, 4)


def test_cpu_tensors_take_the_plain_versions():
    before = (dk.dw_conv.launches, mk.mbconv_chain.launches)
    x, w = (torch.from_numpy(a) for a in dw_inputs(H=5, W=7))
    _close(dk.dw_conv(x, w).numpy(), dk.dw_conv_ref(x, w).numpy())
    blocks = chain_blocks()
    ops = fold_mbconv_chain(blocks, torch.float32)
    x = torch.from_numpy(chain_x())
    _close(mk.mbconv_chain(x, *ops, 3).numpy(),
           mk.mbconv_chain_ref(x, *ops, 3).numpy())
    assert (dk.dw_conv.launches, mk.mbconv_chain.launches) == before


# ---- on the card -------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close_cuda(out, ref, dtype):
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= _TOL[dtype] * ref.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [
    dict(N=1, H=240, W=320, C=48, K=3), dict(N=2, H=13, W=19, C=24, K=3),
    dict(N=1, H=30, W=40, C=768, K=5), dict(N=3, H=15, W=20, C=1824, K=3),
    dict(N=1, H=9, W=33, C=40, K=5)],
    ids=["stage0", "ragged", "stage4", "stage6", "ragged_k5"])
def test_dw_conv_kernel_matches_plain(cuda, dtype, case):
    x, w = (torch.from_numpy(a).to(cuda, dtype) for a in dw_inputs(**case))
    before = dk.dw_conv.launches
    out = dk.dw_conv(x, w)
    assert dk.dw_conv.launches == before + 1
    _close_cuda(out, dk.dw_conv_ref(x, w), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 5])
@pytest.mark.parametrize("H,W,C,K", [(240, 320, 48, 3), (240, 320, 24, 3),
                                     (30, 40, 768, 5), (15, 20, 1824, 3)],
                         ids=["c48", "c24", "c768_k5", "c1824"])
def test_dw_conv_kernel_path_a_sites(cuda, N, H, W, C, K):
    """Every stride-1 depthwise site of path A at 480x640, one frame and
    five, bf16."""
    x, w = (torch.from_numpy(a).to(cuda, torch.bfloat16)
            for a in dw_inputs(N=N, H=H, W=W, C=C, K=K))
    _close_cuda(dk.dw_conv(x, w), dk.dw_conv_ref(x, w), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [3, 5])
@pytest.mark.parametrize("C", [8, 16, 24, 32, 40, 48, 56, 64])
def test_dw_conv_kernel_every_narrow_width(cuda, K, C):
    """Each tile shape below 64 channels (all of a pixel's channels in a
    tile) and the first of 64, at a map that is no tile multiple, bf16."""
    x, w = (torch.from_numpy(a).to(cuda, torch.bfloat16)
            for a in dw_inputs(N=2, H=37, W=101, C=C, K=K, seed=C + K))
    _close_cuda(dk.dw_conv(x, w), dk.dw_conv_ref(x, w), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("tap", ["first", "centre", "last"])
@pytest.mark.parametrize("K,C", [(3, 24), (3, 48), (3, 64), (5, 24),
                                 (5, 48)])
def test_dw_conv_kernel_one_hot_taps(cuda, K, C, tap):
    """One nonzero tap: the output is the input shifted, zero where the
    shift leaves the map (the tensor map's fill), bit for bit."""
    x, _ = (torch.from_numpy(a).to(cuda, torch.bfloat16)
            for a in dw_inputs(N=2, H=19, W=37, C=C, K=K))
    w = torch.zeros(K, K, C, device=cuda, dtype=torch.bfloat16)
    t = {"first": 0, "centre": K * K // 2, "last": K * K - 1}[tap]
    w[t // K, t % K] = 1.0
    out = dk.dw_conv(x, w)
    assert torch.equal(out, dk.dw_conv_ref(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(N=2, H=17, W=33, C=24, K=3), dict(N=3, H=19, W=21, C=48, K=3),
    dict(N=1, H=3, W=2, C=8, K=5), dict(N=2, H=31, W=9, C=136, K=3),
    dict(N=1, H=41, W=17, C=72, K=5)],
    ids=["c24", "c48", "smaller_than_the_window", "ragged_channels",
         "ragged_k5"])
def test_dw_conv_kernel_ragged_maps(cuda, case):
    """Maps that are no tile multiple, a map smaller than the window, and
    channel counts that leave a tile's channel block part empty, bf16."""
    x, w = (torch.from_numpy(a).to(cuda, torch.bfloat16)
            for a in dw_inputs(**case))
    before = dk.dw_conv.launches
    out = dk.dw_conv(x, w)
    assert dk.dw_conv.launches == before + 1
    _close_cuda(out, dk.dw_conv_ref(x, w), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [
    dict(C=40, M=240, K=3, nb=2, N=1, H=23, W=31),
    dict(C=16, M=96, K=5, nb=2, N=2, H=7, W=13),
    dict(C=64, M=384, K=5, nb=2, N=1, H=15, W=20),
    dict(C=304, M=1824, K=5, nb=1, N=2, H=15, W=20),
    dict(C=512, M=3072, K=3, nb=1, N=1, H=15, W=20)],
    ids=["stage1_ragged", "small_k5", "stage2", "stage5", "stage6"])
def test_mbconv_chain_kernel_matches_plain(cuda, dtype, case):
    case = dict(case)
    nb, N, H, W = case.pop("nb"), case.pop("N"), case.pop("H"), case.pop("W")
    blocks = chain_blocks(nb=nb, **case)
    x = torch.from_numpy(chain_x(N, H, W, case["C"])).to(cuda, dtype)
    ops = [t.to(cuda) for t in fold_mbconv_chain(blocks, dtype)]
    before = mk.mbconv_chain.launches
    out = mk.mbconv_chain(x, *ops, case["K"])
    assert mk.mbconv_chain.launches == before + mk.LAUNCHES_PER_BLOCK * nb
    _close_cuda(out, mk.mbconv_chain_ref(x, *ops, case["K"]), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("N", [1, 5])
@pytest.mark.parametrize("site", range(6))
def test_mbconv_chain_kernel_path_a_sites(cuda, site, N, dtype):
    """Each path-A stage tail at its 480x640 map and widths (two blocks),
    one frame and five: the plans of both types, banded or whole-map, split
    K or not."""
    _, H, W, C, M, K = PATH_A[site]
    blocks = chain_blocks(C=C, M=M, K=K, nb=2, seed=site)
    x = torch.from_numpy(chain_x(N, H, W, C, seed=site)).to(cuda, dtype)
    ops = [t.to(cuda) for t in fold_mbconv_chain(blocks, dtype)]
    _close_cuda(mk.mbconv_chain(x, *ops, K),
                mk.mbconv_chain_ref(x, *ops, K), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [
    dict(C=24, M=144, K=3, nb=1, N=1, H=17, W=23),
    dict(C=24, M=144, K=5, nb=2, N=3, H=7, W=9),
    dict(C=40, M=240, K=5, nb=2, N=2, H=17, W=23),
    dict(C=512, M=3072, K=3, nb=1, N=1, H=7, W=9),
    dict(C=304, M=1824, K=5, nb=2, N=1, H=15, W=20)],
    ids=["one_block_r6", "ragged_7x9_r6", "ragged_17x23_r10",
         "r128_ragged", "split_k"])
def test_mbconv_chain_kernel_edge_cases(cuda, dtype, case):
    """A one-block chain, ragged maps (17x23, 7x9), SE widths 6, 10 and
    128, and a projection whose fix-up sums at least 3 partials."""
    case = dict(case)
    nb, N, H, W = case.pop("nb"), case.pop("N"), case.pop("H"), case.pop("W")
    if case["C"] == 304:
        assert mk.plan(N, H, W, 304, 1824, 76, 5,
                       torch.tensor([], dtype=dtype).element_size()
                       )["splits"] >= 3
    blocks = chain_blocks(nb=nb, seed=nb + H, **case)
    x = torch.from_numpy(chain_x(N, H, W, case["C"])).to(cuda, dtype)
    ops = [t.to(cuda) for t in fold_mbconv_chain(blocks, dtype)]
    before = mk.mbconv_chain.launches
    out = mk.mbconv_chain(x, *ops, case["K"])
    assert mk.mbconv_chain.launches == before + mk.LAUNCHES_PER_BLOCK * nb
    _close_cuda(out, mk.mbconv_chain_ref(x, *ops, case["K"]), dtype)
    again = mk.mbconv_chain(x, *ops, case["K"])        # counters back at 0
    torch.cuda.synchronize()
    assert torch.equal(out, again)


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_versions(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(dk, "dw_conv_ref", refuse)
    monkeypatch.setattr(mk, "mbconv_chain_ref", refuse)
    bf = torch.bfloat16
    dk.dw_conv(*(torch.from_numpy(a).to(cuda, bf) for a in dw_inputs()))
    ops = [t.to(cuda) for t in fold_mbconv_chain(chain_blocks(), bf)]
    mk.mbconv_chain(torch.from_numpy(chain_x()).to(cuda, bf), *ops, 3)
    model = EfficientNetB5Features("all", True).eval().to(cuda, bf)
    with torch.no_grad():
        model(torch.zeros(1, 3, 64, 64, device=cuda, dtype=bf).contiguous(
            memory_format=torch.channels_last))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    bf = torch.bfloat16
    x, w = (torch.from_numpy(a).to(cuda, bf) for a in dw_inputs())
    with pytest.raises(ValueError):                            # mixed dtype
        dk.dw_conv(x, w.float())
    with pytest.raises(ValueError):             # NCHW memory: not NHWC view
        dk.dw_conv(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), w)
    x7, w7 = (torch.from_numpy(a).to(cuda, bf) for a in dw_inputs(K=7))
    with pytest.raises(ValueError):                            # window 7
        dk.dw_conv(x7, w7)
    x12, w12 = (torch.from_numpy(a).to(cuda, bf) for a in dw_inputs(C=12))
    with pytest.raises(ValueError):                  # C not 16 bytes wide
        dk.dw_conv(x12, w12)
    ops = [t.to(cuda) for t in fold_mbconv_chain(chain_blocks(), bf)]
    xc = torch.from_numpy(chain_x()).to(cuda, bf)
    with pytest.raises(ValueError):                   # shift in bf16
        mk.mbconv_chain(xc, ops[0], ops[1].to(bf), *ops[2:], 3)
    with pytest.raises(ValueError):                   # strided x
        mk.mbconv_chain(xc.transpose(1, 2), *ops, 3)
    with pytest.raises(ValueError):                   # f32 x, bf16 weights
        mk.mbconv_chain(xc.float(), *ops, 3)
