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
