"""The port's PSM-Net kernels (kernels/psm_blocks.py, kernels/spp_tail.py)
against the JAX package.

CPU: each wrapper's plain version is held against the Pallas kernel it
replaces, run in interpret mode as the JAX package's own tests run it, on the
same seeded numpy inputs in f32. Tolerance rtol 1e-4, atol 1e-4 * max|ref|:
both sides accumulate in f32 and differ in the order of the sums. The whole
PSM-Net goes through the JAX module with its kernels forced on
(``MAGNET_TPU_PALLAS_PSM=1``, interpret mode) at a shape where every one of
them engages.

CUDA (marker ``cuda``, skipped without a card): each kernel against its
plain version on the card, f32 at 1e-4 * max|ref| and bf16 at 2e-2 *
max|ref| (one rounding of every intermediate map), the launch counts, and
the rule that a CUDA tensor never reaches a plain version. These import no
JAX: ``python -m pytest --noconftest -m cuda tests/test_torch_psm.py``.
"""

import numpy as np
import pytest
import torch

from magnet_tpu_torch.kernels import psm_blocks as pb
from magnet_tpu_torch.kernels import spp_tail as st
from test_torch_kernels import torch_threads  # noqa: F401

RTOL = 1e-4
_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _close(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=RTOL,
                               atol=1e-4 * float(np.abs(ref).max()))


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# positions of the maps and conv weights (the folded BN stays f32)
STAGE, TRANSITION, TAIL = (0, 1), (0, 1, 4, 7), (0, 1, 2, 3, 6)


def _on(arrays, device, dtype, typed):
    """The arrays as tensors on ``device``, those at ``typed`` in ``dtype``."""
    return [_t(a, device).to(dtype) if i in typed else _t(a, device)
            for i, a in enumerate(arrays)]


def _bn(rng, n, c):
    return (rng.rand(n, c).astype(np.float32) + 0.5,
            rng.randn(n, c).astype(np.float32) * 0.1)


def stage_inputs(C=64, n_blocks=2, N=2, H=16, W=20, seed=0):
    """numpy (x, weights (2n, 3, 3, C, C), scales, shifts)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(N, H, W, C).astype(np.float32) * 0.5
    w = rng.randn(2 * n_blocks, 3, 3, C, C).astype(np.float32) * (9 * C) ** -.5
    return (x, w) + _bn(rng, 2 * n_blocks, C)


def transition_inputs(ci=32, co=64, N=2, H=32, W=24, seed=0):
    """numpy (x, w1, s1, t1, w2, s2, t2, wp, sp, tp)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(N, H, W, ci).astype(np.float32) * 0.5
    out = [x]
    for k, cin in ((3, ci), (3, co), (1, ci)):
        s, t = _bn(rng, 1, co)
        out += [rng.randn(k, k, cin, co).astype(np.float32)
                * (k * k * cin) ** -0.5, s[0], t[0]]
    return tuple(out)


def tail_inputs(N=2, H=32, W=24, cout=64, seed=0):
    """numpy (raw, skip, br, w0, s0, t0, w1)."""
    rng = np.random.RandomState(seed)
    maps = [rng.randn(N, H, W, c).astype(np.float32) * 0.5
            for c in (64, 128, 128)]
    w0 = rng.randn(3, 3, 320, 128).astype(np.float32) * 2880 ** -0.5
    s, t = _bn(rng, 1, 128)
    w1 = rng.randn(128, cout).astype(np.float32) * 128 ** -0.5
    return (*maps, w0, s[0], t[0], w1)


@pytest.mark.parametrize("C,mode,d,hw,nb", [
    (32, "quad", 1, (16, 24), 2), (64, "paired", 1, (16, 20), 3),
    (128, "natural", 1, (16, 24), 2), (128, "natural", 2, (16, 24), 2)],
    ids=["layer1", "layer2", "layer3", "layer4_dilated"])
def test_residual_stage_matches_jax_kernel(C, mode, d, hw, nb):
    import jax.numpy as jnp
    from magnet_tpu.kernels import psmstage_pallas as psp
    x, w, s, t = stage_inputs(C, nb, H=hw[0], W=hw[1])
    pack = {"quad": psp.pack_conv_quad, "paired": psp.pack_conv_paired,
            "natural": psp.pack_conv_natural}[mode]
    ref = psp.fused_residual_stage(
        jnp.asarray(x), jnp.stack([pack(jnp.asarray(k)) for k in w]),
        jnp.asarray(s), jnp.asarray(t), d, mode, interpret=True)
    out = pb.fused_residual_stage(_t(x), _t(w), _t(s), _t(t), d)
    _close(out.numpy(), ref)


def test_stem_chain_matches_jax_kernel():
    """residual=False: the stem's conv-BN-ReLU pair."""
    import jax.numpy as jnp
    from magnet_tpu.kernels import psmstage_pallas as psp
    x, w, s, t = stage_inputs(32, 1, H=16, W=24, seed=3)
    ref = psp.fused_residual_stage(
        jnp.asarray(x),
        jnp.stack([psp.pack_conv_quad(jnp.asarray(k)) for k in w]),
        jnp.asarray(s), jnp.asarray(t), 1, "quad", residual=False,
        interpret=True)
    out = pb.fused_residual_stage(_t(x), _t(w), _t(s), _t(t), 1,
                                  residual=False)
    _close(out.numpy(), ref)


@pytest.mark.parametrize("hw", [(32, 24), (64, 40)], ids=["standard", "w40"])
def test_downsample_block_matches_jax_kernel(hw):
    from magnet_tpu.kernels.psmtrans_pallas import downsample_block
    a = transition_inputs(32, 64, H=hw[0], W=hw[1], N=1)
    ref = downsample_block(*a, interpret=True)
    _close(pb.downsample_block(*[_t(v) for v in a]).numpy(), ref)


def test_expand_block_matches_jax_kernel():
    from magnet_tpu.kernels.psmtrans2_pallas import expand_block
    a = transition_inputs(64, 128, H=16, W=32)
    ref = expand_block(*a, interpret=True)
    _close(pb.expand_block(*[_t(v) for v in a]).numpy(), ref)


@pytest.mark.parametrize("hw", [(32, 24), (32, 20)], ids=["standard", "w20"])
def test_spp_tail_matches_jax_kernel(hw):
    from magnet_tpu.kernels.spptail_pallas import spp_tail_fused
    a = tail_inputs(H=hw[0], W=hw[1], N=1)
    ref = spp_tail_fused(*a, interpret=True)
    _close(st.spp_tail(*[_t(v) for v in a]).numpy(), ref)


def test_psmnet_matches_jax_with_its_kernels_on(monkeypatch):
    """The whole PSM-Net against the JAX module with its four Pallas
    kernels forced on (interpret mode), at 96x128: every kernel's shape gate
    passes there, so the JAX side runs stem chain, layer chains, both
    transition blocks and the fused tail."""
    import jax
    from magnet_tpu.kernels import (psmstage_pallas, psmtrans2_pallas,
                                    psmtrans_pallas, spptail_pallas)
    from magnet_tpu.nn.psmnet import PSMNet as JPSMNet
    from magnet_tpu_torch.compat.from_jax import fnet_state_dict
    from magnet_tpu_torch.nn.psmnet import PSMNet
    assert psmstage_pallas.supported((1, 48, 64, 32), 1, 1, 4)
    assert psmtrans_pallas.supported((1, 48, 64, 32), 4)
    assert psmtrans2_pallas.supported((1, 24, 32, 64), 4)
    assert spptail_pallas.supported((1, 24, 32, 128), 64, 4)
    rng = np.random.RandomState(5)
    x = rng.rand(1, 96, 128, 3).astype(np.float32)
    jm = JPSMNet(feature_dim=64)
    v = jm.init(jax.random.PRNGKey(5), x)
    v = jax.device_get({"params": v["params"], "batch_stats": jax.tree.map(
        lambda a: np.asarray(rng.rand(*a.shape), np.float32) * 0.5 + 0.3,
        v["batch_stats"])})
    monkeypatch.setenv("MAGNET_TPU_PALLAS_PSM", "1")
    ref = jm.apply(v, x)
    tree = {c: {"f_net": v[c]} for c in v}
    sd = {k[len("f_net."):]: t for k, t in fnet_state_dict(tree).items()}
    pm = PSMNet(64).eval()
    pm.load_state_dict(sd)
    with torch.no_grad():
        out = pm(torch.from_numpy(x))
    _close(out.numpy(), ref)


def test_cpu_tensors_take_the_plain_versions():
    wrappers = (pb.fused_residual_stage, pb.downsample_block, pb.expand_block,
                st.spp_tail)
    before = [w.launches for w in wrappers]
    a = [_t(v) for v in stage_inputs(32, 1, H=6, W=5)]
    _close(pb.fused_residual_stage(*a, 2).numpy(),
           pb.fused_residual_stage_ref(*a, 2).numpy())
    a = [_t(v) for v in transition_inputs(8, 16, H=6, W=8)]
    _close(pb.downsample_block(*a).numpy(),
           pb.downsample_block_ref(*a).numpy())
    _close(pb.expand_block(*a).numpy(), pb.expand_block_ref(*a).numpy())
    assert pb.downsample_block(*a).shape == (2, 3, 4, 16)
    a = [_t(v) for v in tail_inputs(H=5, W=4)]
    _close(st.spp_tail(*a).numpy(), st.spp_tail_ref(*a).numpy())
    assert [w.launches for w in wrappers] == before


def test_a_chain_takes_its_convs_in_pairs():
    x, w, s, t = (_t(v) for v in stage_inputs(32, 1, H=4, W=4))
    with pytest.raises(ValueError):
        pb.fused_residual_stage(x, w[:1], s[:1], t[:1], 1)


# ---- the bf16 kernel's operand layouts --------------------------------

@pytest.mark.parametrize("k,ci,co", [(3, 32, 32), (3, 32, 64), (1, 32, 64),
                                     (3, 64, 64), (3, 64, 128), (1, 64, 128),
                                     (3, 128, 128), (3, 136, 136), (1, 8, 24)])
def test_pack_weights_round_trips_to_hwio(k, ci, co):
    """C = 32 in 32-channel K blocks (64-byte swizzle), wider inputs in
    64-channel ones (128-byte swizzle), outputs padded to 32, 64 or blocks
    of 128; everything else is zero padding."""
    w = torch.randn(k, k, ci, co, generator=torch.Generator().manual_seed(1))
    packed = pb.pack_weights(w)
    assert tuple(packed.shape) == pb.packed_shape(k, ci, co)
    assert packed.shape[-1] == (32 if ci <= 32 else 64)
    assert torch.equal(pb.unpack_weights(packed, k, ci, co), w)
    assert int(torch.count_nonzero(packed)) == w.numel()


@pytest.mark.parametrize("kb", [32, 64])
def test_swizzle_rows_moves_chunks_by_row(kb):
    """Chunk c of row r lands at c ^ (r % 8) (kb 64) or c ^ (r // 2 % 4)
    (kb 32): the 128- and 64-byte swizzle patterns of rows of 2 kb bytes."""
    rows = torch.arange(16 * kb, dtype=torch.float32).reshape(16, kb)
    out = pb.swizzle_rows(rows)
    for r in range(16):
        phase = r % 8 if kb == 64 else (r // 2) % 4
        for c in range(kb // 8):
            assert torch.equal(out[r, 8 * (c ^ phase):8 * (c ^ phase) + 8],
                               rows[r, 8 * c:8 * c + 8])
    assert torch.equal(pb.swizzle_rows(out), rows)


def _halo_rows(stride, dil, taps, mt):
    """The halo layout of csrc/hopper_conv.cuh for a patch of 8 x 16 mt
    outputs: (phases, rows, columns) and each halo row's input pixel
    (dy, dx) from the halo's origin (the patch's first output times the
    stride, less the padding)."""
    pad = dil if taps == 9 else 0
    if stride == 1:
        nph, hp, hw = 1, 8 + 2 * pad, 16 * mt + 2 * pad
    elif taps == 9:
        nph, hp, hw = 4, 9, 16 * mt + 1
    else:
        nph, hp, hw = 1, 8, 16 * mt
    q = torch.arange(nph * hp * hw)
    ph, ly, lx = q // (hp * hw), q % (hp * hw) // hw, q % hw
    return (nph, hp, hw), stride * ly + ph // 2, stride * lx + ph % 2


def _window(shape, stride, dil, tap):
    """The first halo row of tap `tap`'s descriptor window."""
    nph, hp, hw = shape
    ky, kx = divmod(tap, 3)
    if nph == 4:
        return ((ky % 2) * 2 + kx % 2) * hp * hw + (ky // 2) * hw + kx // 2
    return ky * dil * hw + kx * dil


def _conv_from_packed(x, packed, scale, shift, stride, dil, taps, co,
                      relu, res):
    """One conv as the bf16 kernel reads its operands: each 8 x 16 mt patch's
    halo staged row by row from the row table (zeros outside the image and
    past the channels), each tap's 8 x 16 mt outputs read as the window
    rows (window + 8 mt wg + 8 m) + hw y + x of the halo, times the slab of
    ``packed`` read back from its swizzled places; the epilogue in f32."""
    n, h, w, ci = x.shape
    nkb, _, npad, kb = packed.shape
    bn = pb.n_block(co)
    mt = 128 // bn
    shape, dy, dx = _halo_rows(stride, dil, taps, mt)
    pad = dil if taps == 9 else 0
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    slabs = pb.swizzle_rows(packed).float()            # (nkb, taps, npad, kb)
    xp = torch.nn.functional.pad(x.float(), (0, nkb * kb - ci))
    acc = torch.zeros(n, ho, wo, npad)
    pw = 16 * mt
    for img in range(n):
        for y0 in range(0, ho, 8):
            for x0 in range(0, wo, pw):
                iy, ix = y0 * stride - pad + dy, x0 * stride - pad + dx
                ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                halo = torch.zeros(len(dy), nkb * kb)
                halo[ok] = xp[img, iy[ok], ix[ok]]
                oy, ox = torch.meshgrid(torch.arange(8), torch.arange(pw),
                                        indexing="ij")
                for tap in range(taps):
                    rows = _window(shape, stride, dil, tap) + oy * shape[2] + ox
                    a = halo[rows.reshape(-1)]
                    wt = slabs[:, tap].permute(0, 2, 1).reshape(nkb * kb, npad)
                    out = (a @ wt).reshape(8, pw, npad)
                    yy, xx = min(8, ho - y0), min(pw, wo - x0)
                    acc[img, y0:y0 + yy, x0:x0 + xx] += out[:yy, :xx]
    y = acc[..., :co] * scale + shift
    if res is not None:
        y = y + res.float()
    return torch.relu(y) if relu else y


@pytest.mark.parametrize("case", [
    dict(N=1, H=9, W=7, ci=32, co=32, k=3, stride=1, dil=1, relu=True),
    dict(N=2, H=10, W=20, ci=64, co=64, k=3, stride=1, dil=1, res=True),
    dict(N=1, H=9, W=18, ci=128, co=128, k=3, stride=1, dil=2, res=True),
    dict(N=1, H=17, W=35, ci=32, co=64, k=3, stride=2, dil=1, relu=True),
    dict(N=1, H=17, W=35, ci=32, co=64, k=1, stride=2, dil=1),
    dict(N=1, H=9, W=19, ci=64, co=128, k=1, stride=1, dil=1),
    dict(N=1, H=9, W=18, ci=64, co=136, k=3, stride=1, dil=4, res=True),
], ids=["stem_odd", "layer2", "layer4_dil2", "down_stride2", "down_proj",
        "expand_proj", "ragged_dil4"])
def test_conv_over_packed_operands_matches_plain(case):
    """The kernel's halo layout (stride 2 as four phases, dilation as a wider
    halo), descriptor windows and packed weights give ``_conv_ref``'s conv."""
    g = torch.Generator().manual_seed(3)
    n, h, w, ci, co, k = (case[c] for c in ("N", "H", "W", "ci", "co", "k"))
    stride, dil = case["stride"], case["dil"]
    x = torch.randn(n, h, w, ci, generator=g)
    wt = torch.randn(k, k, ci, co, generator=g) * (k * k * ci) ** -0.5
    scale, shift = torch.rand(co, generator=g) + 0.5, torch.randn(co, generator=g)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    res = torch.randn(n, ho, wo, co, generator=g) if case.get("res") else None
    relu = case.get("relu", False)
    out = _conv_from_packed(x, pb.pack_weights(wt), scale, shift, stride, dil,
                            k * k, co, relu, res)
    ref = pb._conv_ref(x, wt, scale, shift, stride, dil, relu, res)
    _close(out.numpy(), ref.numpy())


TAIL_WIDTHS = {"maps": (64, 128, 128), "padded": (16, 48, 32)}


@pytest.mark.parametrize("widths", TAIL_WIDTHS.values(), ids=TAIL_WIDTHS)
def test_tail_operands_round_trip_to_hwio(widths):
    """The tail's 3x3 in 64-channel K blocks per map, a map narrower than a
    K block padded with zeros to its own (no K block mixes two maps); the
    1x1 as two K blocks, its columns padded to 128."""
    g = torch.Generator().manual_seed(4)
    w0 = torch.randn(3, 3, sum(widths), 128, generator=g)
    w1 = torch.randn(128, 48, generator=g)
    p0, p1 = st.tail_operands(w0, w1, widths)
    nkb = [-(-c // 64) for c in widths]
    assert tuple(p0.shape) == (sum(nkb), 9, 128, 64)
    assert tuple(p1.shape) == (2, 1, 128, 64)
    kb = off = 0
    for c, n in zip(widths, nkb):
        assert torch.equal(pb.unpack_weights(p0[kb:kb + n], 3, c, 128),
                           w0[:, :, off:off + c])
        kb, off = kb + n, off + c
    assert int(torch.count_nonzero(p0)) == w0.numel()
    assert torch.equal(pb.unpack_weights(p1, 1, 128, 48)[0, 0], w1)
    with pytest.raises(ValueError):
        st.tail_operands(w0, w1, widths[:2])


@pytest.mark.parametrize("widths,cout", [((64, 128, 128), 64),
                                         ((16, 48, 32), 144)],
                         ids=["maps", "padded_wide"])
def test_tail_over_packed_operands_matches_plain(widths, cout):
    """The bf16 kernel's view of the tail: each map zero padded to its own
    64-channel K blocks (the halo table of ``stage_halos_src``), the 3x3
    through the halo windows and packed slabs, BN and ReLU, then the 1x1
    over the packed projection in 128-column chunks, equals
    ``spp_tail_ref``."""
    g = torch.Generator().manual_seed(5)
    maps = [torch.randn(1, 9, 19, c, generator=g) for c in widths]
    w0 = torch.randn(3, 3, sum(widths), 128, generator=g) * sum(widths) ** -.5
    s0, t0 = torch.rand(128, generator=g) + 0.5, torch.randn(128, generator=g)
    w1 = torch.randn(128, cout, generator=g) * 128 ** -0.5
    p0, p1 = st.tail_operands(w0, w1, widths)
    blocks = torch.cat([torch.nn.functional.pad(m, (0, -c % 64))
                        for m, c in zip(maps, widths)], -1)
    hidden = _conv_from_packed(blocks, p0, s0, t0, 1, 1, 9, 128, True, None)
    proj = pb.swizzle_rows(p1).float()[:, 0]            # (2, cpad, 64)
    out = hidden @ proj.permute(0, 2, 1).reshape(128, -1)[:, :cout]
    _close(out.numpy(), st.spp_tail_ref(*maps, w0, s0, t0, w1).numpy())


def test_psmnet_operands_are_kept_until_a_weight_changes():
    """PSMNet folds each chain's, transition block's and the tail's operands
    once and reuses them on the next forward; an in-place update of a weight
    or a BatchNorm buffer, or an optimizer step (which updates every weight
    in place and, through the train forward, the running statistics), makes
    them anew, and the output is the one a fresh model gives."""
    from magnet_tpu_torch.models.build import init_weights_
    from magnet_tpu_torch.nn.psmnet import PSMNet

    def kept(m):
        return {(id(mod), name): entry[1] for mod in m.modules()
                for name, entry in mod.__dict__.get("_folded", {}).items()}

    m = init_weights_(PSMNet(16), seed=2).eval()
    x = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        m(x)
        first = kept(m)
        assert len(first) == 8   # stem, layers 1-4, 2 transitions, tail
        m(x)
        assert all(kept(m)[k] is v for k, v in first.items())
        m.layer3[1].conv2[1].running_var.add_(0.5)
        m(x)
    changed = [k for k, v in kept(m).items() if v is not first[k]]
    assert changed == [(id(m.layer3), "chain")]
    opt = torch.optim.SGD(m.parameters(), lr=0.1)
    m.train()
    m(x).square().mean().backward()
    opt.step()
    m.eval()
    with torch.no_grad():
        before = kept(m)
        out = m(x)
        assert all(v is not before[k] for k, v in kept(m).items())
        fresh = PSMNet(16).eval()
        fresh.load_state_dict(m.state_dict())
        ref = fresh(x)
    assert torch.equal(out, ref)


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
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= _TOL[dtype] * ref.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case,dil,residual", [
    (dict(C=32, n_blocks=3, H=24, W=32), 1, True),
    (dict(C=32, n_blocks=1, H=17, W=9), 1, False),        # stem, ragged M
    (dict(C=64, n_blocks=4, H=15, W=20), 1, True),
    (dict(C=128, n_blocks=2, H=12, W=16), 1, True),
    (dict(C=128, n_blocks=3, H=12, W=16), 2, True),
    (dict(C=136, n_blocks=1, H=5, W=7), 4, True),         # ragged N and K
], ids=["layer1", "stem", "layer2", "layer3", "layer4", "ragged"])
def test_residual_stage_kernel_matches_plain(cuda, dtype, case, dil,
                                             residual):
    a = _on(stage_inputs(**case), cuda, dtype, STAGE)
    before = pb.fused_residual_stage.launches
    out = pb.fused_residual_stage(*a, dil, residual)
    assert pb.fused_residual_stage.launches == before + 2 * case["n_blocks"]
    _close_cuda(out, pb.fused_residual_stage_ref(*a, dil, residual), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name,case", [
    ("downsample_block", dict(ci=32, co=64)),
    ("downsample_block", dict(ci=32, co=64, H=9, W=7)),   # odd map
    ("expand_block", dict(ci=64, co=128, H=12, W=16)),
    ("expand_block", dict(ci=8, co=24, H=5, W=3)),
], ids=["down", "down_odd", "expand", "expand_ragged"])
def test_transition_kernel_matches_plain(cuda, dtype, name, case):
    fn, ref = getattr(pb, name), getattr(pb, name + "_ref")
    a = _on(transition_inputs(**case), cuda, dtype, TRANSITION)
    before = fn.launches
    out = fn(*a)
    assert fn.launches == before + 3
    _close_cuda(out, ref(*a), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [dict(), dict(N=1, H=9, W=7, cout=32),
                                  dict(N=1, H=30, W=40, cout=256)],
                         ids=["standard", "ragged", "wide"])
def test_spp_tail_kernel_matches_plain(cuda, dtype, case):
    a = _on(tail_inputs(**case), cuda, dtype, TAIL)
    before = st.spp_tail.launches
    out = st.spp_tail(*a)
    assert st.spp_tail.launches == before + 1
    _close_cuda(out, st.spp_tail_ref(*a), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("widths", TAIL_WIDTHS.values(), ids=TAIL_WIDTHS)
@pytest.mark.parametrize("source", range(3), ids=["raw", "skip", "br"])
@pytest.mark.parametrize("tap", range(9))
def test_spp_tail_kernel_single_tap_and_channel(cuda, widths, source, tap):
    """A 3x3 weight that is non-zero at one tap and one input channel, in
    the last K block of one map: a K block read from the wrong map or at
    the wrong channel offset, or a wrong window, cannot hide behind the
    other taps and channels."""
    bf = torch.bfloat16
    g = torch.Generator().manual_seed(tap)
    maps = [torch.randn(2, 19, 37, c, generator=g).to(cuda, bf) for c in widths]
    ch = sum(widths[:source]) + widths[source] - 3
    w0 = torch.zeros(3, 3, sum(widths), 128)
    w0[tap // 3, tap % 3, ch] = torch.randn(128, generator=g)
    s0 = (torch.rand(128, generator=g) + 0.5).to(cuda)
    t0 = (torch.randn(128, generator=g) * 0.1).to(cuda)
    w1 = (torch.randn(128, 64, generator=g) * 128 ** -0.5).to(cuda, bf)
    a = (*maps, w0.to(cuda, bf), s0, t0, w1)
    _close_cuda(st.spp_tail(*a), st.spp_tail_ref(*a), bf)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [dict(N=3, H=88, W=304), dict(N=5, H=120, W=160)],
                         ids=["kitti", "scannet"])
def test_spp_tail_kernel_at_the_frame_shapes(cuda, case):
    """The main path's tail sites (maps that are not patch multiples at the
    KITTI shape) on operands packed once, as PSMNet keeps them."""
    bf = torch.bfloat16
    a = _on(tail_inputs(**case), cuda, bf, TAIL)
    packed = st.tail_operands(a[3], a[6], (64, 128, 128))
    before = st.spp_tail.launches
    out = st.spp_tail(*a, packed=packed)
    assert st.spp_tail.launches == before + 1
    _close_cuda(out, st.spp_tail_ref(*a), bf)


def _conv_case(dev, N, H, W, ci, co, k=3, stride=1, dil=1, epi="res",
               tap=None, seed=0):
    """One conv's operands on ``dev`` in bf16 (weight one-hot at ``tap``
    when given, shift 0), its packed weights and a launch counter."""
    import types
    g = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16
    x = torch.randn(N, H, W, ci, generator=g).to(dev, bf)
    w = torch.randn(k, k, ci, co, generator=g) * (k * k * ci) ** -0.5
    if tap is not None:
        only = torch.zeros(3, 3, 1, 1)
        only[tap // 3, tap % 3] = 1
        w = w * only
    w = w.to(dev, bf)
    scale = (torch.rand(co, generator=g) + 0.5).to(dev)
    shift = (torch.randn(co, generator=g) * (tap is None)).to(dev)
    ho, wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    res = (torch.randn(N, ho, wo, co, generator=g).to(dev, bf)
           if "res" in epi else None)
    args = (x, w, scale, shift, stride, dil, "relu" in epi, res)
    return args, pb.pack_weights(w), types.SimpleNamespace(launches=0)


def _check_conv(cuda, **case):
    args, packed, counter = _conv_case(cuda, **case)
    out = pb._conv_cuda(*args, counter, packed)
    assert counter.launches == 1
    _close_cuda(out, pb._conv_ref(*args), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["stride2", "dilation2", "c32", "c64",
                                  "c128"])
@pytest.mark.parametrize("tap", range(9))
def test_conv_kernel_single_tap(cuda, mode, tap):
    """A weight that is non-zero at one tap only: a wrong descriptor window
    (a stride-2 phase, a dilated offset, a 64-byte swizzle start) cannot
    hide behind the other eight taps."""
    case = dict(stride2=dict(ci=32, co=64, stride=2),
                dilation2=dict(ci=128, co=128, dil=2),
                c32=dict(ci=32, co=32), c64=dict(ci=64, co=64),
                c128=dict(ci=128, co=128))[mode]
    _check_conv(cuda, N=2, H=19, W=37, epi="none", tap=tap, **case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(N=1, H=9, W=7, ci=32, co=32),
    dict(N=3, H=176, W=608, ci=32, co=32),              # KITTI stem, layer1
    dict(N=3, H=176, W=608, ci=32, co=64, stride=2, epi="relu"),
    dict(N=3, H=88, W=304, ci=64, co=64),               # KITTI layer2
    dict(N=3, H=88, W=304, ci=128, co=128, dil=2),      # KITTI layer4
    dict(N=5, H=120, W=160, ci=64, co=128, epi="relu"),  # layer3_0 conv1
    dict(N=5, H=9, W=7, ci=128, co=128),
    dict(N=1, H=33, W=17, ci=64, co=64, dil=2),
    dict(N=2, H=7, W=9, ci=136, co=136, dil=4),         # two output blocks
], ids=["odd32", "kitti_stem", "kitti_down", "kitti_layer2", "kitti_layer4",
        "expand_conv1", "odd128_n5", "odd64_dil2", "ragged_two_blocks"])
def test_conv_kernel_maps_and_batches(cuda, case):
    """Maps that are not patch multiples, batches of 1, 3 and 5 whose patches
    meet at image boundaries, C = 32, 64, 128 and wider, bf16."""
    _check_conv(cuda, **case)


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("ci,co", [(32, 64), (64, 128), (8, 24)])
def test_projection_kernel_alone(cuda, stride, ci, co):
    """The transition blocks' 1x1 projection: one tap, no halo."""
    _check_conv(cuda, N=3, H=23, W=41, ci=ci, co=co, k=1, stride=stride,
                epi="none")


@pytest.mark.cuda
@pytest.mark.parametrize("epi", ["none", "relu", "res", "res_relu"])
@pytest.mark.parametrize("co", [32, 64, 128])
def test_conv_kernel_epilogues(cuda, epi, co):
    """acc * scale + shift, then the residual add and / or the ReLU, rounded
    once, at every output width."""
    _check_conv(cuda, N=2, H=17, W=21, ci=co, co=co, epi=epi)


@pytest.mark.cuda
def test_chains_launch_once_a_conv_on_packed_operands(cuda):
    """A chain and a transition block on operands packed once, as PSMNet
    keeps them: one launch a conv, the plain result."""
    bf = torch.bfloat16
    a = _on(stage_inputs(64, 2, N=3, H=15, W=20), cuda, bf, STAGE)
    before = pb.fused_residual_stage.launches
    out = pb.fused_residual_stage(*a, 1, packed=pb.pack_chain(a[1]))
    assert pb.fused_residual_stage.launches == before + 4
    _close_cuda(out, pb.fused_residual_stage_ref(*a, 1), bf)
    a = _on(transition_inputs(H=18, W=22), cuda, bf, TRANSITION)
    before = pb.downsample_block.launches
    out = pb.downsample_block(*a, packed=pb.pack_chain((a[1], a[4], a[7])))
    assert pb.downsample_block.launches == before + 3
    _close_cuda(out, pb.downsample_block_ref(*a), bf)


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_versions(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(pb, "_conv_ref", refuse)
    monkeypatch.setattr(st, "spp_tail_ref", refuse)
    bf = torch.bfloat16
    pb.fused_residual_stage(*_on(stage_inputs(32, 1), cuda, bf, STAGE), 1)
    a = _on(transition_inputs(H=8, W=8), cuda, bf, TRANSITION)
    pb.downsample_block(*a)
    pb.expand_block(*a)
    st.spp_tail(*_on(tail_inputs(H=6, W=6), cuda, bf, TAIL))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    bf = torch.bfloat16
    x, w, s, t = _on(stage_inputs(32, 1, H=6, W=6), cuda, bf, STAGE)
    with pytest.raises(ValueError):                            # mixed dtype
        pb.fused_residual_stage(x.float(), w, s, t, 1)
    with pytest.raises(ValueError):                            # strided
        pb.fused_residual_stage(x.transpose(1, 2), w, s, t, 1)
    x, w, s, t = _on(stage_inputs(12, 1, H=6, W=6), cuda, bf, STAGE)
    with pytest.raises(ValueError):                  # C not 16 bytes wide
        pb.fused_residual_stage(x, w, s, t, 1)
    a = _on(tail_inputs(H=6, W=6, cout=24), cuda, bf, TAIL)
    with pytest.raises(ValueError):                  # Cout not 16 wide
        st.spp_tail(*a)
    a = _on(tail_inputs(H=6, W=6), cuda, bf, TAIL)
    with pytest.raises(ValueError):                  # scale in bf16
        st.spp_tail(*a[:4], a[4].to(bf), *a[5:])
    p0, p1 = st.tail_operands(a[3], a[6], (64, 128, 128))
    with pytest.raises(ValueError):                  # packed for other maps
        st.spp_tail(*a, packed=(p0[1:], p1))
    with pytest.raises(ValueError):                  # packed w1 unpadded
        st.spp_tail(*a, packed=(p0, p1[:, :, :64]))
