"""The port's kernels (magnet_tpu_torch/kernels) against the JAX package.

CPU: each kernel's plain version, through the port's module or wrapper, is
held against the JAX function it replaces, with the JAX side run both ways
its own tests run it: the XLA module path (its env switch at 0), and the
Pallas kernel itself in interpret mode, called as the module calls it.
Same seeded numpy inputs and weights, f32, rtol 1e-4 and
atol 1e-4 * max|ref| (as tests/test_upstage_pallas.py).

CUDA (marker ``cuda``, skipped without a card): each kernel against its
plain version on the card, and the dispatch rule that a CUDA tensor reaches
the kernel and never the plain version. These tests import no JAX, so they
also run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from magnet_tpu_torch.compat.from_jax import dnet_state_dict
from magnet_tpu_torch.kernels import conv3x3_bnact as cb
from magnet_tpu_torch.kernels import cost_volume_cw as cvk
from magnet_tpu_torch.kernels import gnet_update as gk
from magnet_tpu_torch.kernels import head_chain as hc
from magnet_tpu_torch.kernels import upsample_mask as uk
from magnet_tpu_torch.nn.densedepth import UpSampleBN

RTOL = 1e-4


def _close(out, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=RTOL,
                               atol=1e-4 * float(np.abs(ref).max()))


def _jax_upstage(features, x, skip):
    """JAX UpSampleBN with random batch stats (as its own tests make it);
    returns (module, variables). JAX is imported here so that the CUDA tests
    of this file run without it."""
    import jax
    import jax.numpy as jnp
    from magnet_tpu.nn.densedepth import UpSampleBN as JUp
    rng = np.random.RandomState(0)
    m = JUp(features=features)
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(skip))
    v = {"params": v["params"],
         "batch_stats": jax.tree.map(
             lambda a: jnp.asarray(
                 rng.rand(*a.shape).astype(np.float32)) * 0.5 + 0.3,
             v["batch_stats"])}
    return m, jax.device_get(v)


def _jax_upstage_ref(jm, v, x, skip, features, jax_kernel):
    """The JAX stage's output: the XLA module path, or the stage's Pallas
    kernel (upstage_fused for up3, up2_fused for up2) in interpret mode with
    the folding the module does before calling it."""
    if not jax_kernel:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MAGNET_TPU_PALLAS_UP", "0")
            mp.setenv("MAGNET_TPU_PALLAS_UP2", "0")
            return jm.apply(v, x, skip)
    from magnet_tpu.kernels.convstream_pallas import up2_fused
    from magnet_tpu.kernels.psmstage_pallas import fold_bn
    from magnet_tpu.kernels.upstage_pallas import upstage_fused
    from magnet_tpu.ops.resample import resize_bilinear_align_corners
    p, st = v["params"], v["batch_stats"]
    sa, ta = fold_bn(p["bn_a"]["bn"]["scale"], p["bn_a"]["bn"]["bias"],
                     st["bn_a"]["bn"]["mean"], st["bn_a"]["bn"]["var"])
    sb, tb = fold_bn(p["bn_b"]["bn"]["scale"], p["bn_b"]["bn"]["bias"],
                     st["bn_b"]["bn"]["mean"], st["bn_b"]["bn"]["var"])
    args = (p["conv_a_up"]["conv"]["kernel"], p["conv_a_up"]["conv"]["bias"],
            p["conv_a_skip"]["conv"]["kernel"], sa, ta,
            p["conv_b"]["conv"]["kernel"], p["conv_b"]["conv"]["bias"], sb, tb)
    if features == 256:
        return upstage_fused(x, skip, *args, interpret=True)
    up = resize_bilinear_align_corners(x, skip.shape[1], skip.shape[2])
    return up2_fused(up, skip, *args, interpret=True)


def _port_upstage(variables, cx, cs, features):
    """The port's UpSampleBN loaded with the JAX stage's variables."""
    tree = {c: {"d_net": {"up9": variables[c]}} for c in variables}
    prefix = "d_net.decoder.up9."
    sd = {k[len(prefix):]: t for k, t in dnet_state_dict(tree).items()}
    m = UpSampleBN(cx + cs, features).eval()
    m.load_state_dict(sd)
    return m


def _upstage_inputs(Hs, Ws, cx, cs):
    rng = np.random.RandomState(0)
    x = rng.randn(1, Hs, Ws, cx).astype(np.float32) * 0.3
    skip = rng.randn(1, 2 * Hs, 2 * Ws, cs).astype(np.float32) * 0.3
    return x, skip


@pytest.mark.parametrize("jax_kernel", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("Hs,Ws", [(16, 16), (20, 12)],
                         ids=["standard", "edge_rows"])
def test_up3_matches_jax(jax_kernel, Hs, Ws):
    """up3: upsample 512 ch, skip 40 ch, 256 features (upstage_fused)."""
    x, skip = _upstage_inputs(Hs, Ws, 512, 40)
    jm, v = _jax_upstage(256, x, skip)
    ref = _jax_upstage_ref(jm, v, x, skip, 256, jax_kernel)
    pm = _port_upstage(v, 512, 40, 256)
    with torch.no_grad():
        out = pm(torch.from_numpy(x), torch.from_numpy(skip))
    _close(out.numpy(), ref)


@pytest.mark.parametrize("jax_kernel", [False, True], ids=["xla", "pallas"])
def test_up2_matches_jax(jax_kernel):
    """up2: upsample 1024 ch, skip 64 ch, 512 features (up2_fused)."""
    x, skip = _upstage_inputs(8, 8, 1024, 64)
    jm, v = _jax_upstage(512, x, skip)
    ref = _jax_upstage_ref(jm, v, x, skip, 512, jax_kernel)
    pm = _port_upstage(v, 1024, 64, 512)
    with torch.no_grad():
        out = pm(torch.from_numpy(x), torch.from_numpy(skip))
    _close(out.numpy(), ref)


def _head_case(kind):
    """(JAX module, its conv names with ReLU flags, input shape)."""
    from magnet_tpu.models.magnet import MagnetMaskHead
    from magnet_tpu.nn.densedepth import _Head
    three = (("conv0", True), ("conv1", True), ("conv2", False))
    if kind == "depth_head":
        return _Head(out_ch=2), three, (2, 24, 20, 256)
    if kind == "dnet_mask_head":
        return _Head(out_ch=144), three, (1, 24, 16, 256)
    return (MagnetMaskHead(out_ch=144), three[:2] + (("conv2", True),
                                                     ("conv3", False)),
            (1, 40, 24, 256))


@pytest.mark.parametrize("jax_kernel", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("kind", ["depth_head", "dnet_mask_head",
                                  "magnet_mask_head"])
def test_head_chain_matches_jax(monkeypatch, jax_kernel, kind):
    """3- and 4-conv chains, c_out 2 and 144 (head_chain_pallas)."""
    import jax
    from magnet_tpu.kernels.headchain_pallas import head_chain_pallas
    jm, names, shape = _head_case(kind)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32) * 0.5
    v = jax.device_get(jm.init(jax.random.PRNGKey(1), x))
    p = v["params"]
    convs = [(np.array(p[n]["conv"]["kernel"]), np.array(p[n]["conv"]["bias"]),
              r) for n, r in names]
    if jax_kernel:
        ref = head_chain_pallas(x, convs, interpret=True)
    else:
        monkeypatch.setenv("MAGNET_TPU_PALLAS_HEADS", "0")
        ref = jm.apply(v, x)
    out = hc.head_chain(torch.from_numpy(x),
                        [(torch.from_numpy(k), torch.from_numpy(b), r)
                         for k, b, r in convs])
    _close(out.numpy(), ref)


@pytest.mark.parametrize("jax_kernel", [False, True], ids=["xla", "pallas"])
def test_single_conv_chain_matches_jax(jax_kernel):
    """G-Net conv0_feat shape: one 3x3, bias, no ReLU."""
    import jax
    from magnet_tpu.kernels.headchain_pallas import head_chain_pallas
    rng = np.random.RandomState(3)
    x = rng.randn(1, 24, 20, 256).astype(np.float32) * 0.5
    w = rng.randn(3, 3, 256, 128).astype(np.float32) * 0.05
    b = rng.randn(128).astype(np.float32)
    if jax_kernel:
        ref = head_chain_pallas(x, [(w, b, False)], interpret=True)
    else:
        ref = jax.lax.conv_general_dilated(
            x, w, (1, 1), ((1, 1), (1, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    out = hc.head_chain(torch.from_numpy(x), [(torch.from_numpy(w),
                                               torch.from_numpy(b), False)])
    _close(out.numpy(), ref)


# ---- dispatch ----------------------------------------------------------

def _conv_args(device, dtype, Hs=6, Ws=5, cx=32, cs=16, cout=32,
               upsample=True, seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).to(device)

    H, W = (2 * Hs, 2 * Ws) if upsample else (Hs, Ws)
    return dict(
        x=r(1, Hs, Ws, cx).to(dtype),
        w=r(3, 3, cx, cout, scale=(9 * (cx + cs)) ** -0.5).to(dtype),
        scale=r(cout).abs() + 0.5, shift=r(cout),
        skip=r(1, H, W, cs).to(dtype) if cs else None,
        w_skip=r(3, 3, cs, cout, scale=(9 * (cx + cs)) ** -0.5).to(dtype)
        if cs else None,
        upsample=upsample)


def _head_args(device, dtype, n_convs, c_out, H=10, W=7, c0=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, H, W, c0, generator=g).to(device, dtype)
    convs, cin = [], c0
    for i in range(n_convs):
        ks = 3 if i == 0 else 1
        co = c_out if (i == n_convs - 1 and i > 0) else 128
        w = torch.randn(ks, ks, cin, co, generator=g) * (ks * ks * cin) ** -0.5
        b = torch.randn(co, generator=g) * 0.1
        convs.append((w.to(device, dtype), b.to(device), i < n_convs - 1))
        cin = co
    return x, convs


def cv_inputs(B=1, V=2, H=24, W=32, C=8, D=5, seed=0, motion=0.03,
              roll=0.0, shift=0.0, invalid_last=True):
    """numpy inputs of the cost volume, made as
    tests/test_costvolume_pallas.py makes them: small in-plane rotations and
    translations, plus ``roll`` radians about the optical axis for every
    view and ``shift`` added to every translation."""
    rng = np.random.RandomState(seed)
    ref = rng.randn(B, H, W, C).astype(np.float32)
    src = rng.randn(B, V, H, W, C).astype(np.float32)
    mu = rng.uniform(1, 5, (B, V, H, W)).astype(np.float32)
    sig = rng.uniform(0.1, 1.0, (B, V, H, W)).astype(np.float32)

    def rot(ang):
        c, s = np.cos(ang), np.sin(ang)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)

    R = np.stack([np.stack([rot(roll + rng.uniform(-motion, motion))
                            for _ in range(V)]) for _ in range(B)])
    t = rng.uniform(-motion, motion, (B, V, 3)).astype(np.float32) + shift
    valid = np.ones((B, V), np.float32)
    if invalid_last:
        valid[-1, -1] = 0.0
    fx = 0.9 * W
    K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1.0]], np.float32)
    grid = np.ones((H, W, 3), np.float32)
    grid[:, :, 0] = (np.arange(W)[None] + 0.5 - K[0, 2]) / K[0, 0]
    grid[:, :, 1] = (np.arange(H)[:, None] + 0.5 - K[1, 2]) / K[1, 1]
    rays = np.tile(grid.transpose(2, 0, 1).reshape(1, 3, -1), (B, 1, 1))
    dvol = rng.uniform(1, 5, (B, H, W, D)).astype(np.float32)
    return (dvol, ref, src, mu, sig, R, t.astype(np.float32), valid,
            np.tile(K, (B, 1, 1)), rays.astype(np.float32))


def gnet_inputs(B=1, H=10, W=12, D=5, seed=0):
    """numpy (cv, feat_contrib, prev) and the four (HWIO kernel, bias)
    layers of the G-Net update."""
    rng = np.random.RandomState(seed)
    cv = rng.randn(B, H, W, D).astype(np.float32)
    feat = rng.randn(B, H, W, 128).astype(np.float32) * 0.5
    prev = np.stack([rng.uniform(1, 5, (B, H, W)),
                     rng.uniform(0.1, 1, (B, H, W))], -1).astype(np.float32)
    convs = [(rng.randn(3, 3, D, 128).astype(np.float32) * (9 * D) ** -0.5,
              None)]
    for co in (128, 128, 2):
        convs.append((rng.randn(1, 1, 128, co).astype(np.float32) * 128 ** -.5,
                      rng.randn(co).astype(np.float32) * 0.1))
    return cv, feat, prev, convs


def upsample_inputs(B=1, H=8, W=12, C=2, k=4, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, W, C).astype(np.float32),
            rng.randn(B, H, W, 9 * k * k).astype(np.float32) * 2.0)


def _t(a, device="cpu", dtype=None):
    if a is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t if dtype is None else t.to(dtype)


def _gnet_t(device, dtype, **kw):
    cv, feat, prev, convs = gnet_inputs(**kw)
    return (_t(cv, device, dtype), _t(feat, device, dtype),
            _t(prev, device, dtype),
            [(_t(k, device, dtype), _t(b, device)) for k, b in convs])


def _cv_t(device, dtype, **kw):
    a = cv_inputs(**kw)
    return ([_t(a[0], device)] + [_t(x, device, dtype) for x in a[1:3]]
            + [_t(x, device) for x in a[3:]])


def test_cpu_tensors_take_the_plain_version():
    wrappers = (cb.conv3x3_bnact, hc.head_chain, cvk.cost_volume_cw,
                gk.gnet_update, uk.upsample_mask)
    before = [w.launches for w in wrappers]
    a = _conv_args("cpu", torch.float32)
    _close(cb.conv3x3_bnact(**a).numpy(), cb.conv3x3_bnact_ref(**a).numpy())
    x, convs = _head_args("cpu", torch.float32, 3, 144)
    _close(hc.head_chain(x, convs).numpy(), hc.head_chain_ref(x, convs).numpy())
    a = _cv_t("cpu", torch.float32)
    _close(cvk.cost_volume_cw(*a, 5.0).numpy(),
           cvk.cost_volume_cw_ref(*a, 5.0).numpy())
    a = _gnet_t("cpu", torch.float32)
    _close(gk.gnet_update(*a).numpy(), gk.gnet_update_ref(*a).numpy())
    d, m = (_t(x) for x in upsample_inputs())
    _close(uk.upsample_mask(d, m, 4).numpy(),
           uk.upsample_mask_ref(d, m, 4).numpy())
    assert [w.launches for w in wrappers] == before


def test_gnet_update_refuses_what_the_kernel_does_not_take():
    """D > 16 and hidden != 128 raise on any device: there is no other
    path."""
    cv, feat, prev, convs = _gnet_t("cpu", torch.float32, D=17)
    with pytest.raises(ValueError):
        gk.gnet_update(cv, feat, prev, convs)
    cv, feat, prev, convs = _gnet_t("cpu", torch.float32)
    narrow = [(convs[0][0][..., :64], None)] + convs[1:]
    with pytest.raises(ValueError):
        gk.gnet_update(cv, feat, prev, narrow)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# f32: kernel and plain both accumulate in full f32 (no TF32); bf16: one
# rounding of the inputs/upsampled taps and of the output.
_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _close_cuda(out, ref, dtype):
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= _TOL[dtype] * ref.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [
    dict(upsample=True),                                 # up-stage conv_a
    dict(upsample=True, cs=40, Hs=9, Ws=13),             # ragged K, odd size
    dict(upsample=False, cs=0, cx=64, cout=136),         # conv_b, ragged N
    dict(upsample=False, cs=24, Hs=33, Ws=70),           # M over many tiles
], ids=["ups", "ups_ragged", "no_skip", "wide"])
def test_conv_kernel_matches_plain(cuda, dtype, case):
    a = _conv_args(cuda, dtype, **case)
    before = cb.conv3x3_bnact.launches
    out = cb.conv3x3_bnact(**a)
    assert cb.conv3x3_bnact.launches == before + 1
    _close_cuda(out, cb.conv3x3_bnact_ref(**a), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_convs,c_out", [(1, 128), (2, 2), (3, 144),
                                           (4, 256)])
def test_head_kernel_matches_plain(cuda, dtype, n_convs, c_out):
    x, convs = _head_args(cuda, dtype, n_convs, c_out)
    before = hc.head_chain.launches
    out = hc.head_chain(x, convs)
    assert hc.head_chain.launches == before + 1
    _close_cuda(out, hc.head_chain_ref(x, convs), dtype)


# The cost volume's f32 and bf16 paths both accumulate exact products in
# f32, so both are held to the f32 tolerance, on the elements that do not
# sit on the consistency threshold (kernels/cost_volume_cw.py::compare).
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [
    dict(B=2, V=3),                                       # an invalid view
    dict(roll=0.9, V=2, H=40, W=64, invalid_last=False),  # large roll
    dict(shift=0.6, C=64),                    # samples that leave the image
    dict(shift=100.0),                                    # all outside
    dict(H=120, W=160, C=64, V=4, invalid_last=False),    # the eval shape
    dict(C=128, D=3), dict(C=24, D=1),
], ids=["invalid_view", "roll", "leaving", "outside", "eval_shape", "c128",
        "c24"])
def test_cost_volume_kernel_matches_plain(cuda, dtype, case):
    a = _cv_t(cuda, dtype, **case)
    before = cvk.cost_volume_cw.launches
    out = cvk.cost_volume_cw(*a, 5.0)
    assert cvk.cost_volume_cw.launches == before + 1
    torch.cuda.synchronize()
    ref, margin = cvk.cost_volume_cw_ref(*a, 5.0, return_margin=True)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    cvk.compare(out, ref, margin, _TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [dict(), dict(B=2, H=9, W=7, D=1),
                                  dict(H=120, W=160), dict(D=16, H=5)],
                         ids=["small", "ragged", "eval_shape", "d16"])
def test_gnet_kernel_matches_plain(cuda, dtype, case):
    a = _gnet_t(cuda, dtype, **case)
    before = gk.gnet_update.launches
    out = gk.gnet_update(*a)
    assert gk.gnet_update.launches == before + 1
    _close_cuda(out, gk.gnet_update_ref(*a), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [dict(), dict(B=2, H=5, W=3, C=1, k=2),
                                  dict(H=120, W=160), dict(C=3, k=8)],
                         ids=["small", "ragged", "eval_shape", "k8"])
def test_upsample_kernel_matches_plain(cuda, dtype, case):
    d, m = (_t(x, cuda, dtype) for x in upsample_inputs(**case))
    k = case.get("k", 4)
    before = uk.upsample_mask.launches
    out = uk.upsample_mask(d, m, k)
    assert uk.upsample_mask.launches == before + 1
    _close_cuda(out, uk.upsample_mask_ref(d, m, k), dtype)


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_version(cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(cb, "conv3x3_bnact_ref", refuse)
    monkeypatch.setattr(hc, "head_chain_ref", refuse)
    monkeypatch.setattr(cvk, "cost_volume_cw_ref", refuse)
    monkeypatch.setattr(gk, "gnet_update_ref", refuse)
    monkeypatch.setattr(uk, "upsample_mask_ref", refuse)
    cb.conv3x3_bnact(**_conv_args(cuda, torch.bfloat16))
    x, convs = _head_args(cuda, torch.bfloat16, 3, 2)
    hc.head_chain(x, convs)
    cvk.cost_volume_cw(*_cv_t(cuda, torch.bfloat16), 5.0)
    gk.gnet_update(*_gnet_t(cuda, torch.bfloat16))
    d, m = (_t(x, cuda, torch.bfloat16) for x in upsample_inputs())
    uk.upsample_mask(d, m, 4)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernel_does_not_take(cuda):
    a = _conv_args(cuda, torch.bfloat16)
    with pytest.raises(ValueError):
        cb.conv3x3_bnact(**dict(a, x=a["x"].transpose(1, 2)))   # strided
    with pytest.raises(ValueError):
        cb.conv3x3_bnact(**dict(a, scale=a["scale"].half()))    # dtype
    x, convs = _head_args(cuda, torch.bfloat16, 3, 300)         # c_out > 256
    with pytest.raises(ValueError):
        hc.head_chain(x, convs)
    x, convs = _head_args(cuda, torch.bfloat16, 2, 2)
    with pytest.raises(ValueError):                             # host bias
        hc.head_chain(x, [convs[0], (convs[1][0], convs[1][1].cpu(), False)])
    a = _cv_t(cuda, torch.bfloat16, C=12)            # C not 16 bytes wide
    with pytest.raises(ValueError):
        cvk.cost_volume_cw(*a, 5.0)
    cv, feat, prev, convs = _gnet_t(cuda, torch.bfloat16)
    with pytest.raises(ValueError):                             # mixed dtype
        gk.gnet_update(cv.float(), feat, prev, convs)
    d, m = (_t(x, cuda, torch.bfloat16) for x in upsample_inputs())
    with pytest.raises(ValueError):                             # strided
        uk.upsample_mask(d, m.transpose(1, 2), 4)
