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

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """PyTorch's CPU threads for a test module: one share of the cores a
    worker. pytest-xdist runs several workers at once, and eager PyTorch
    with a thread a core in each of them spends its time waiting on its own
    threads (three D-Net train steps at 32x32 took 400 s in each of 6
    processes on 8 cores, 8.5 s with one thread each). The other port test
    modules import this fixture."""
    prev = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(prev)


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
               upsample=True, seed=0, n=1, size=None):
    """The conv's arguments; in upsample mode x (Hs, Ws) is resized to the
    skip's ``size``, by default (2 Hs, 2 Ws)."""
    g = torch.Generator().manual_seed(seed)

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).to(device)

    H, W = (size or (2 * Hs, 2 * Ws)) if upsample else (Hs, Ws)
    return dict(
        x=r(n, Hs, Ws, cx).to(dtype),
        w=r(3, 3, cx, cout, scale=(9 * (cx + cs)) ** -0.5).to(dtype),
        scale=r(cout).abs() + 0.5, shift=r(cout),
        skip=r(n, H, W, cs).to(dtype) if cs else None,
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


# ---- the cost volume's plan; maps that share an upsampling mask ------------

def _plan_boxes(x0, y0, hit, H, W):
    """Per sample the in-image corner range (xlo, xhi, ylo, yhi)."""
    return (x0.clamp(min=0), (x0 + 1).clamp(max=W - 1), y0.clamp(min=0),
            (y0 + 1).clamp(max=H - 1), hit)


def _check_plan(a):
    """Hold ``cost_volume_cw_plan`` to its rule: every sample with an
    in-image corner of a valid view is in exactly one job; a staged job's
    corners lie in its window, which fits, and its run of candidates is the
    largest aligned one that fits; a global job is a maximal run, within an
    aligned ``CHUNK``, of candidates whose own boxes do not fit. Returns the
    plan."""
    plan = cvk.cost_volume_cw_plan(*a, 5.0)
    d, src, R, t, valid, K, rays = a[0], a[2], a[5], a[6], a[7], a[8], a[9]
    B, H, W, D = d.shape
    V, T = R.shape[1], cvk.TILE
    bpp = (src.shape[-1] + 2) * src.element_size()
    pos = {(b, v): _plan_boxes(*cvk.kernel_positions(
        K[b], R[b, v], t[b, v], rays[b], d[b].reshape(H * W, D), H, W),
        H, W) for b in range(B) for v in range(V)}

    def box(b, v, i, j, d0, d1):
        xl, xh, yl, yh, hit = (x.reshape(H, W, D)[i * T:i * T + T,
                                                  j * T:j * T + T, d0:d1]
                               for x in pos[b, v])
        if not hit.any():
            return None
        return (int(xl[hit].min()), int(xh[hit].max()), int(yl[hit].min()),
                int(yh[hit].max()))

    def fits(bx):
        return bx is None or ((bx[1] - bx[0] + 1) * (bx[3] - bx[2] + 1)
                              * bpp <= cvk.WINDOW_BYTES)

    seen = torch.zeros(B, V, H, W, D, dtype=torch.long)
    for b, i, j, v, d0, nd, st, xlo, ylo, ww, wh in plan["jobs"].tolist():
        seen[b, v, i * T:i * T + T, j * T:j * T + T, d0:d0 + nd] += 1
        bx = box(b, v, i, j, d0, d0 + nd)
        assert bx is not None
        if st:
            assert (xlo <= bx[0] and bx[1] < xlo + ww and ylo <= bx[2]
                    and bx[3] < ylo + wh and ww * wh * bpp <= cvk.WINDOW_BYTES)
            size = 1 << (nd - 1).bit_length()
            assert d0 % size == 0 and size <= cvk.CHUNK
            if d0 + nd < D and size < cvk.CHUNK:   # a run that D does not cut
                assert size == nd                  # is the largest that fits
                p0 = d0 // (2 * size) * 2 * size
                assert not fits(box(b, v, i, j, p0, min(p0 + 2 * size, D)))
        else:                  # a run of lone candidates that fit no window
            assert d0 // cvk.CHUNK == (d0 + nd - 1) // cvk.CHUNK
            alone = [box(b, v, i, j, c, c + 1) for c in range(d0, d0 + nd)]
            assert all(x is not None and not fits(x) for x in alone)
            for c in (d0 - 1, d0 + nd):      # the run is maximal
                if 0 <= c < D and c // cvk.CHUNK == d0 // cvk.CHUNK:
                    x = box(b, v, i, j, c, c + 1)
                    assert x is None or fits(x)
    for b in range(B):
        for v in range(V):
            hit = pos[b, v][4].reshape(H, W, D)
            if valid[b, v] == 0:
                assert not seen[b, v].any()
            else:
                assert (seen[b, v][hit] == 1).all()
    assert seen.max() <= 1
    assert plan["corners"] == plan["staged_corners"] + plan["global_corners"]
    return plan


@pytest.mark.parametrize("case,dtype", [
    (dict(), torch.float32),
    (dict(V=3, D=20, motion=0.3, C=32, H=32, W=40), torch.float32),
    (dict(C=64, D=37, roll=0.5, shift=0.2, H=30, W=44), torch.bfloat16),
], ids=["small_motion", "split_runs", "roll_d37"])
def test_cost_volume_plan_covers_every_corner_once(case, dtype):
    a = _cv_t("cpu", dtype, **case)
    _check_plan(a)
    # the kernel's roundings land on the plain projection's corners
    d, R, t, K, rays = a[0], a[5], a[6], a[8], a[9]
    H, W, D = d.shape[1:]
    x, y, _ = cvk.project(K[0], R[0, 0], t[0, 0], rays[0],
                          d[0].reshape(H * W, D), H, W)
    x0, y0, hit = cvk.kernel_positions(K[0], R[0, 0], t[0, 0], rays[0],
                                       d[0].reshape(H * W, D), H, W)
    same = (x0 == torch.floor(x)) & (y0 == torch.floor(y))
    assert hit.any() and same[hit].float().mean() > 0.999


def test_cost_volume_plan_sends_wide_footprints_global():
    """A 0.9 rad roll with a large translation spreads a tile's samples of
    one candidate over more than a window: those go to the global branch,
    the rest stay staged."""
    plan = _check_plan(_cv_t("cpu", torch.bfloat16, C=64, H=48, W=64,
                             roll=0.9, shift=0.6, invalid_last=False))
    assert plan["global_jobs"] > 0 and plan["global_corners"] > 0
    assert plan["staged_jobs"] > 0 and plan["staged_corners"] > 0


def test_cost_volume_plan_constants_stand_in_the_kernel():
    import pathlib
    src = (pathlib.Path(cvk.__file__).parent / "csrc"
           / "cost_volume_cw.cu").read_text()
    for text in (f"CV_TILE_H = {cvk.TILE}, CV_TILE_W = {cvk.TILE};",
                 f"CV_CHUNK = {cvk.CHUNK};",
                 f"CV_WINDOW_BYTES = {cvk.WINDOW_BYTES};",
                 f"CV_MAX_C = {cvk.MAX_C};", f"CV_MAX_D = {cvk.MAX_D};"):
        assert text in src


def test_upsample_maps_equal_one_map_calls():
    """Maps that share a mask: each output equals the one-map call's, bit
    for bit, through the plain version and the CPU wrapper."""
    m = _t(upsample_inputs(B=2, H=5, W=7, C=3, seed=1)[1])
    maps = [_t(upsample_inputs(B=2, H=5, W=7, C=3, seed=s)[0])
            for s in (1, 2, 3)]
    for fn in (uk.upsample_mask_ref, uk.upsample_mask):
        outs = fn(maps, m, 4)
        assert isinstance(outs, list) and len(outs) == 3
        for d, o in zip(maps, outs):
            assert torch.equal(o, uk.upsample_mask_ref(d, m, 4))


def _upsample_bwd_walk(gouts, maps, mask, k, seg):
    """``csrc/upsample_mask.cu``'s backward walk in numpy f32, block by block
    (a segment of ``seg`` coarse pixels of one row): the softmax of the
    staged rows h - 1 .. h + 1, then the mask's gradient a fine pixel and the
    maps' gradients a coarse pixel, as gathers over the staged tiles."""
    B, H, W, C = maps[0].shape
    n, kk = len(maps), k * k
    gm = np.zeros((B, H, W, 9 * kk), np.float32)
    gd = [np.zeros_like(m) for m in maps]
    cols = seg + 2
    for b, h, w0 in np.ndindex(B, H, -(-W // seg)):
        w0 *= seg
        segw = min(seg, W - w0)
        P = np.zeros((3, cols, 9 * kk), np.float32)
        G = np.zeros((n, 3 * k, cols * k, C), np.float32)
        NB = np.zeros((n, 3, cols, C), np.float32)
        for r, col in np.ndindex(3, cols):
            y, x = h - 1 + r, w0 - 1 + col
            if 0 <= y < H and 0 <= x < W:
                e = np.exp(mask[b, y, x].reshape(9, kk)
                           - mask[b, y, x].reshape(9, kk).max(0))
                P[r, col] = (e / e.sum(0)).reshape(-1)
                for m in range(n):
                    NB[m, r, col] = maps[m][b, y, x]
                    G[m, r * k:(r + 1) * k, col * k:(col + 1) * k] = gouts[m][
                        b, y * k:(y + 1) * k, x * k:(x + 1) * k]
        for ki, wl, kj in np.ndindex(k, segw, k):
            q = P[1, wl + 1, ki * k + kj::kk]
            dp = np.array([sum((G[m, k + ki, (wl + 1) * k + kj]
                                * NB[m, j // 3, wl + j % 3]).sum()
                               for m in range(n)) for j in range(9)])
            gm[b, h, w0 + wl, ki * k + kj::kk] = q * (dp - (q * dp).sum())
        for wl, m in np.ndindex(segw, n):
            gd[m][b, h, w0 + wl] = sum(
                P[2 - ky, wl + 2 - kx, (ky * 3 + kx) * kk + ki * k + kj]
                * G[m, (2 - ky) * k + ki, (wl + 2 - kx) * k + kj]
                for ky, kx, ki, kj in np.ndindex(3, 3, k, k))
    return gd, gm


def test_upsample_bwd_walk_matches_autograd():
    """The backward kernel's gather order (emulated) against autograd
    through the plain version, with segments that split the row; and
    autograd through the CPU wrapper is the plain version's, with no
    launch."""
    B, H, W, C, k = 1, 4, 5, 2, 2
    m = upsample_inputs(B, H, W, C, k, seed=3)[1]
    maps = [upsample_inputs(B, H, W, C, k, seed=s)[0] for s in (4, 5)]
    rng = np.random.RandomState(6)
    gouts = [rng.randn(B, H * k, W * k, C).astype(np.float32)
             for _ in maps]
    want_d, want_m = uk.upsample_mask_bwd_ref(
        [_t(g) for g in gouts], [_t(d) for d in maps], _t(m), k)
    gd, gm = _upsample_bwd_walk(gouts, maps, m, k, seg=2)
    for got, want in zip(gd + [gm], want_d + [want_m]):
        _close(got, want.numpy())
    before = (uk.upsample_mask.launches, uk.upsample_mask_bwd.launches)
    ts = [_t(d).requires_grad_() for d in maps] + [_t(m).requires_grad_()]
    outs = uk.upsample_mask(ts[:-1], ts[-1], k)
    torch.autograd.backward(outs, [_t(g) for g in gouts])
    for t, want in zip(ts, want_d + [want_m]):
        assert torch.equal(t.grad, want)
    assert (uk.upsample_mask.launches,
            uk.upsample_mask_bwd.launches) == before


# ---- the bf16 conv kernel's operands ---------------------------------------

@pytest.mark.parametrize("cx,cs,cout", [(32, 16, 32), (1024, 64, 512),
                                        (512, 40, 256), (64, 0, 136)],
                         ids=["small", "up2", "up3", "ragged_cout"])
def test_pack_weights_round_trips_to_hwio(cx, cs, cout):
    g = torch.Generator().manual_seed(2)
    w = torch.randn(3, 3, cx, cout, generator=g)
    w_skip = torch.randn(3, 3, cs, cout, generator=g) if cs else None
    packed = cb.pack_weights(w, w_skip)
    assert tuple(packed.shape) == cb.packed_shape(cx, cs, cout)
    w2, ws2 = cb.unpack_weights(packed, cx, cs, cout)
    assert torch.equal(w2, w)
    assert (ws2 is None) if not cs else torch.equal(ws2, w_skip)
    # everything else is zero padding
    assert int(torch.count_nonzero(packed)) == w.numel() + (
        w_skip.numel() if cs else 0)


def _conv_from_packed(x, packed, scale, shift, skip=None, upsample=False,
                      act=True):
    """The conv as the bf16 kernel reads its operands: for each 64-channel
    block and tap, the block's channels of the (upsampled) input, shifted by
    the tap with zeros outside the image and past the last channel, times
    the block's (Cout, 64) slab of ``packed``, each row's 16-byte chunks
    read back from their swizzled places (chunk c of row n at c ^ n % 8)."""
    from magnet_tpu_torch.ops.resample import resize_bilinear_align_corners
    xf = x.float()
    if upsample:
        xf = resize_bilinear_align_corners(xf, skip.shape[1], skip.shape[2])
    n, h, w = xf.shape[:3]
    cout = scale.shape[0]
    rows = torch.arange(packed.shape[2])[:, None]
    chunk = (torch.arange(cb.KC) // 8)[None] ^ (rows % 8)
    unswizzle = chunk * 8 + torch.arange(cb.KC)[None] % 8     # (Cout_pad, 64)
    acc = torch.zeros(n, h, w, packed.shape[2])
    b = 0
    for t in (xf, skip):
        if t is None:
            continue
        c = t.shape[-1]
        t = torch.nn.functional.pad(t.float(), (0, -c % cb.KC, 1, 1, 1, 1))
        for kb in range(t.shape[-1] // cb.KC):
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                a = t[:, dy:dy + h, dx:dx + w, kb * cb.KC:(kb + 1) * cb.KC]
                slab = torch.gather(packed[b, tap].float(), 1, unswizzle)
                acc += a @ slab.T
            b += 1
    y = acc[..., :cout] * scale + shift
    return torch.nn.functional.leaky_relu(y, 0.01) if act else y


@pytest.mark.parametrize("case", [
    dict(upsample=True, cs=40, Hs=5, Ws=7, cout=136, n=2),
    dict(upsample=False, cs=0, cx=72, cout=32),
    dict(upsample=False, cs=24, cx=16, cout=256),
], ids=["ups_skip40", "no_skip", "same_skip24"])
def test_conv_over_packed_operands_matches_plain(case):
    a = _conv_args("cpu", torch.float32, **case)
    packed = cb.pack_weights(a["w"], a["w_skip"])
    out = _conv_from_packed(a["x"], packed, a["scale"], a["shift"], a["skip"],
                            a["upsample"])
    _close(out.numpy(), cb.conv3x3_bnact_ref(**a).numpy())


# ---- the bf16 head chain's operands ----------------------------------------

@pytest.mark.parametrize("c_out", [2, 128, 144])
def test_pack_head_slabs(c_out):
    """The head's weights as the kernel reads them: the 3x3 in 64-channel K
    blocks of 128 outputs, each 1x1 in two K blocks of 64 rows, the last
    layer's c_out zero padded to whole 128-column chunks; biases f32, zero
    padded to the same widths. Each unpacks to its HWIO weight."""
    from magnet_tpu_torch.kernels import psm_blocks as pb
    x, convs = _head_args("cpu", torch.bfloat16, 3, c_out, c0=256)
    packed = hc.pack_head(convs)
    cpad = -(-c_out // 128) * 128
    assert [tuple(p_.shape) for p_ in packed] == [
        (4, 9, 128, 64), (2, 1, 128, 64), (2, 1, cpad, 64)]
    for (k, _, _), p_ in zip(convs, packed):
        assert p_.dtype == torch.bfloat16
        assert torch.equal(pb.unpack_weights(p_, *k.shape[1:]), k)
    ws, bs = hc.head_operands(convs)
    assert all(torch.equal(a_, b_) for a_, b_ in zip(ws, packed))
    assert [tuple(b_.shape) for b_ in bs] == [(128,), (128,), (cpad,)]
    assert torch.equal(bs[-1][:c_out], convs[-1][1].float())
    assert not bs[-1][c_out:].any()


@pytest.mark.parametrize("n_convs,c_out", [(1, 128), (3, 2), (4, 144)])
def test_head_chain_over_packed_operands_matches_plain(n_convs, c_out):
    """The chain on the weights unpacked from the kernel's slabs equals the
    plain chain bit for bit (bf16, hidden layers rounded between layers)."""
    from magnet_tpu_torch.kernels import psm_blocks as pb
    x, convs = _head_args("cpu", torch.bfloat16, n_convs, c_out, c0=72)
    ws, _ = hc.head_operands(convs)
    unpacked = [(pb.unpack_weights(w_, *k.shape[1:]), b, r)
                for w_, (k, b, r) in zip(ws, convs)]
    assert torch.equal(hc.head_chain_ref(x, unpacked),
                       hc.head_chain_ref(x, convs))


def test_head_operands_are_kept_until_a_weight_changes():
    """run_head (the D-Net and MaGNet heads) and G-Net's feature term
    prepare the chain's weights once, reuse them, and prepare them anew
    after an in-place update of a weight or an optimizer step (in eval
    mode: in train mode they run plain convs)."""
    from magnet_tpu_torch.nn.densedepth import _head, run_head
    from magnet_tpu_torch.nn.gnet import GNet
    g = torch.Generator().manual_seed(5)
    head, gnet = _head(16, 2).eval(), GNet(n_samples=5, feature_dim=16).eval()
    x = torch.randn(1, 4, 6, 16, generator=g)
    with torch.no_grad():
        y0 = run_head(head, x)
        kept = head._folded["head_chain"][1]
        f0 = gnet.precompute_feature(x)
        kept_g = gnet._folded["feature_term"][1]
        assert torch.equal(run_head(head, x), y0)
        assert head._folded["head_chain"][1] is kept
        gnet.precompute_feature(x)
        assert gnet._folded["feature_term"][1] is kept_g
        head[2].weight.mul_(2.0)
        y1 = run_head(head, x)
    assert head._folded["head_chain"][1] is not kept
    assert not torch.equal(y1, y0)
    for p_ in gnet.gnet[0].parameters():
        p_.grad = torch.ones_like(p_)
    torch.optim.SGD(gnet.gnet[0].parameters(), lr=0.5).step()
    with torch.no_grad():
        f1 = gnet.precompute_feature(x)
    assert gnet._folded["feature_term"][1] is not kept_g
    assert not torch.equal(f1, f0)


@pytest.mark.parametrize("D", [1, 5, 16])
def test_gnet_operands_round_trip_to_hwio(D):
    """The bf16 update's packed weights unpack to the HWIO layers (w0 as a
    1x1 over the tap-major 9 D im2col columns); everything else is zero
    padding."""
    from magnet_tpu_torch.kernels import psm_blocks as pb
    _, _, _, convs = _gnet_t("cpu", torch.bfloat16, H=2, W=3, D=D)
    ws, bs = gk.gnet_operands(convs)
    assert ([tuple(w.shape) for w in ws]
            == [tuple(s) for s in gk.operand_shapes(D, torch.bfloat16)])
    w0 = pb.unpack_weights(ws[0], 1, 9 * D, 128).reshape(3, 3, D, 128)
    assert torch.equal(w0, convs[0][0])
    for w, (k, _) in zip(ws[1:3], convs[1:3]):
        assert torch.equal(pb.unpack_weights(w, 1, 128, 128), k)
    assert torch.equal(ws[3], convs[3][0].reshape(128, 2).float())
    assert int(torch.count_nonzero(ws[0])) == convs[0][0].numel()
    assert all(torch.equal(b, k[1].float()) and b.dtype == torch.float32
               for b, k in zip(bs, convs[1:]))


def _gnet_tile_walk(cv, feat, prev, operands):
    """The bf16 update as the kernel walks it, in plain PyTorch: tiles of 64
    consecutive pixels of the flat map, the last one cut short; a tile's
    im2col matrix (a pixel's 3x3 neighbourhood, tap-major, zero outside the
    image and past 9 D up to the packed K, 64 columns a K block) times w0
    unpacked from its slabs, + the feature term, ReLU, bf16; layers 1 and 2
    on their unpacked slabs; layer 3 and the update in f32."""
    from magnet_tpu_torch.kernels import psm_blocks as pb
    f32, bf = torch.float32, torch.bfloat16
    (w0p, w1p, w2p, w3), (b1, b2, b3) = operands
    B, H, W, D = cv.shape
    kp = w0p.shape[0] * 64
    w0 = pb.unpack_weights(w0p, 1, kp, 128)[0, 0].float()
    w1, w2 = (pb.unpack_weights(w, 1, 128, 128)[0, 0].float()
              for w in (w1p, w2p))
    cvp = F.pad(cv.float(), (0, 0, 1, 1, 1, 1))
    cols = torch.cat([cvp[:, ky:ky + H, kx:kx + W] for ky in range(3)
                      for kx in range(3)], -1).reshape(B * H * W, 9 * D)
    cols = F.pad(cols, (0, kp - 9 * D))
    feat, prev = feat.reshape(-1, 128).float(), prev.reshape(-1, 2).float()
    out = []
    for m0 in range(0, B * H * W, 64):
        rows = slice(m0, m0 + 64)
        y = F.relu(cols[rows] @ w0 + feat[rows]).to(bf).float()
        y = F.relu(y @ w1 + b1).to(bf).float()
        y = F.relu(y @ w2 + b2).to(bf).float()
        y = y @ w3 + b3
        mu0, sigma0 = prev[rows, :1], prev[rows, 1:]
        out.append(torch.cat([mu0 + y[:, :1] * sigma0,
                              (F.elu(y[:, 1:]) + 1.0 + 1e-10) * sigma0], -1))
    return torch.cat(out).reshape(B, H, W, 2).to(bf)


def _update_err(out, ref, prev):
    """max |(out - prev) - (ref - prev)| and its limit: 2e-2 of the largest
    update, or one bf16 ulp of the largest output where that is more (mu
    passes through from prev and dominates max|out|)."""
    upd, upd_ref = out.float() - prev.float(), ref.float() - prev.float()
    ulp = 2.0 ** (np.floor(np.log2(ref.float().abs().max().item())) - 7)
    return ((upd - upd_ref).abs().max().item(),
            max(2e-2 * upd_ref.abs().max().item(), ulp))


@pytest.mark.parametrize("D", [5, 16])
def test_gnet_tile_walk_matches_plain(D):
    """The kernel's tiles over packed operands at a map whose last tile is
    cut (182 pixels, two images) equal the plain version."""
    cv, feat, prev, convs = _gnet_t("cpu", torch.bfloat16, B=2, H=7, W=13,
                                    D=D)
    out = _gnet_tile_walk(cv, feat, prev, gk.gnet_operands(convs))
    err, lim = _update_err(out, gk.gnet_update_ref(cv, feat, prev, convs),
                           prev)
    assert err <= lim, (err, lim)


def test_gnet_update_operands_refold_when_a_parameter_changes():
    """GNet.forward keeps the update's layers (and on a card the kernel's
    operands) on the module, and folds them anew after an in-place update
    of a parameter or an optimizer step (in eval mode: in train mode it runs
    plain convs)."""
    from magnet_tpu_torch.nn.gnet import GNet
    g = torch.Generator().manual_seed(6)
    gnet = GNet(n_samples=5, feature_dim=16).eval()
    cv = torch.randn(1, 4, 6, 5, generator=g)
    feat = torch.randn(1, 4, 6, 128, generator=g)
    prev = torch.stack([torch.rand(1, 4, 6, generator=g) + 1.0,
                        torch.rand(1, 4, 6, generator=g) + 0.1], -1)
    with torch.no_grad():
        y0 = gnet(cv, feat, prev)
        kept = gnet._folded["update"][1]
        assert torch.equal(gnet(cv, feat, prev), y0)
        assert gnet._folded["update"][1] is kept
        gnet.gnet[4].bias.add_(0.5)
        y1 = gnet(cv, feat, prev)
    assert gnet._folded["update"][1] is not kept
    assert not torch.equal(y1, y0)
    kept = gnet._folded["update"][1]
    for p_ in gnet.gnet[0].parameters():
        p_.grad = torch.ones_like(p_)
    torch.optim.SGD(gnet.gnet[0].parameters(), lr=0.5).step()
    with torch.no_grad():
        y2 = gnet(cv, feat, prev)
    assert gnet._folded["update"][1] is not kept
    assert not torch.equal(y2, y1)


def _upstage_plain(m, x, skip):
    """UpSampleBN's function in plain torch ops on NCHW, from its modules."""
    from magnet_tpu_torch.ops.resample import resize_bilinear_align_corners
    conv_a, bn_a, _, conv_b, bn_b, _ = m._net
    up = resize_bilinear_align_corners(x, skip.shape[1], skip.shape[2])
    y = torch.cat([up, skip], -1).permute(0, 3, 1, 2)
    y = torch.nn.functional.leaky_relu(bn_a(conv_a(y)), 0.01)
    y = torch.nn.functional.leaky_relu(bn_b(conv_b(y)), 0.01)
    return y.permute(0, 2, 3, 1)


def test_upstage_operands_are_kept_until_a_weight_changes():
    """UpSampleBN prepares the conv kernel's operands (split, folded, packed
    in bf16) once, reuses them on the next forward, and prepares them anew
    after an in-place update of a weight or a BatchNorm buffer."""
    g = torch.Generator().manual_seed(4)
    m = UpSampleBN(64 + 16, 256).eval()
    with torch.no_grad():
        for t in (*m._net.parameters(), *m._net.buffers()):
            if t.is_floating_point():
                t.copy_(torch.rand(t.shape, generator=g) * 0.5 + 0.3)
    x = torch.randn(1, 4, 5, 64, generator=g)
    skip = torch.randn(1, 8, 10, 16, generator=g)
    with torch.no_grad():
        m(x, skip)
        ops = m._folded["operands64"][1]
        m(x, skip)
        assert m._folded["operands64"][1] is ops
        m._net[0].weight.mul_(2.0)
        y = m(x, skip)
        assert m._folded["operands64"][1] is not ops
        ops = m._folded["operands64"][1]
        m._net[4].running_var.add_(0.5)
        y2 = m(x, skip)
        assert m._folded["operands64"][1] is not ops
        ref = _upstage_plain(m, x, skip)
        op_a, op_b = m.operands(torch.bfloat16, 64)
    _close(y2.numpy(), ref.numpy())
    assert not np.allclose(y.numpy(), y2.numpy())
    assert torch.equal(op_a["packed"],
                       cb.pack_weights(op_a["w"], op_a["w_skip"]))
    assert torch.equal(op_b["packed"], cb.pack_weights(op_b["w"]))


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
@pytest.mark.parametrize("size", ["small", "wide"])
@pytest.mark.parametrize("upsample", [True, False], ids=["ups", "same"])
@pytest.mark.parametrize("tap", range(9))
def test_conv_kernel_single_tap(cuda, tap, upsample, size):
    """A weight that is non-zero at one tap only: a wrong start address or
    stride of that tap's operand cannot hide behind the other eight. "small"
    runs the 8x8 patches; "wide" (512 outputs over 60x80) the 8x8 ones in
    upsample mode and the 16x16 ones without."""
    hs, ws, cout = (5, 7, 32) if size == "small" else (30, 40, 512)
    if not upsample:
        hs, ws = 2 * hs, 2 * ws
    a = _conv_args(cuda, torch.bfloat16, hs, ws, cx=64, cs=24, cout=cout,
                   upsample=upsample)
    only = torch.zeros(3, 3, 1, 1, device=cuda, dtype=torch.bfloat16)
    only[tap // 3, tap % 3] = 1
    a.update(w=a["w"] * only, w_skip=a["w_skip"] * only,
             shift=torch.zeros_like(a["shift"]), act=False)
    _close_cuda(cb.conv3x3_bnact(**a), cb.conv3x3_bnact_ref(**a),
                torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(n=3, Hs=22, Ws=76, cx=1024, cs=64, cout=512),          # KITTI up2.a
    dict(n=3, Hs=44, Ws=152, cx=512, cs=0, cout=512, upsample=False),
    dict(n=3, Hs=44, Ws=152, cx=512, cs=40, cout=256),          # KITTI up3.a
    dict(n=3, Hs=9, Ws=13, cx=64, cs=40, cout=136),
    dict(n=5, Hs=6, Ws=10, cx=128, cs=24, cout=256),
    dict(n=5, Hs=30, Ws=40, cx=256, cs=64, cout=512),
    dict(n=2, Hs=24, Ws=40, cx=128, cs=24, cout=136, size=(24, 40)),
    dict(n=2, Hs=7, Ws=9, cx=128, cs=24, cout=136, size=(21, 27)),
], ids=["kitti_up2", "kitti_up2_b", "kitti_up3", "batch3", "batch5",
        "batch5_wide", "resize_1x", "resize_3x"])
def test_conv_kernel_edges_and_batches(cuda, case):
    """Patches cut by the image edge (44 and 88 rows, 152 and 304 columns),
    batches whose patches meet at image boundaries, and resize factors whose
    source windows do (3x) and do not (1x) fit a staged tile, bf16."""
    a = _conv_args(cuda, torch.bfloat16, **case)
    _close_cuda(cb.conv3x3_bnact(**a), cb.conv3x3_bnact_ref(**a),
                torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("cout", [136, 256, 512])
@pytest.mark.parametrize("cs", [0, 24, 40, 64])
def test_conv_kernel_skip_and_output_widths(cuda, cs, cout):
    """Every skip width of the decoder (none, 24, 40, 64: a 64-channel block
    zero-filled past its width) against ragged and full output widths, bf16,
    with the packed weights passed in as the up-stage passes them."""
    a = _conv_args(cuda, torch.bfloat16, 12, 20, cx=64, cs=cs, cout=cout,
                   upsample=cs > 0)
    packed = cb.pack_weights(a["w"], a["w_skip"])
    _close_cuda(cb.conv3x3_bnact(**a, packed=packed),
                cb.conv3x3_bnact_ref(**a), torch.bfloat16)


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


@pytest.mark.cuda
@pytest.mark.parametrize("c_out", [2, 128, 144])
@pytest.mark.parametrize("n_convs", [2, 3, 4])
def test_head_kernel_chain_widths(cuda, n_convs, c_out):
    """Every chain length with the last widths of the heads (the depth
    head's 2, one 128-column chunk, the mask head's 144 in two), bf16, on
    operands made once as the call sites keep them: one launch a call."""
    x, convs = _head_args(cuda, torch.bfloat16, n_convs, c_out, c0=256)
    ops = hc.head_operands(convs)
    before = hc.head_chain.launches
    out = hc.head_chain(x, convs, ops)
    assert hc.head_chain.launches == before + 1
    _close_cuda(out, hc.head_chain_ref(x, convs), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W,n_convs,c_out", [
    (1, 9, 7, 3, 144), (3, 88, 304, 3, 2), (1, 88, 304, 1, 128),
    (5, 24, 40, 4, 144), (1, 120, 160, 1, 128)],
    ids=["odd", "kitti_depth", "kitti_gnet", "batch5_mask", "scannet_gnet"])
def test_head_kernel_maps_and_batches(cuda, N, H, W, n_convs, c_out):
    """Maps that are not patch multiples (9x7, 88x304), batches of 1, 3 and
    5 whose patches meet at image boundaries, and the G-Net feature term's
    single conv (150 patches over the SMs), bf16."""
    g = torch.Generator().manual_seed(7)
    x, convs = _head_args(cuda, torch.bfloat16, n_convs, c_out, H=H, W=W,
                          c0=256)
    x = torch.randn(N, H, W, 256, generator=g).to(cuda, torch.bfloat16)
    _close_cuda(hc.head_chain(x, convs), hc.head_chain_ref(x, convs),
                torch.bfloat16)


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


def _cv_cuda_check(a):
    out = cvk.cost_volume_cw(*a, 5.0)
    torch.cuda.synchronize()
    ref, margin = cvk.cost_volume_cw_ref(*a, 5.0, return_margin=True)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    cvk.compare(out, ref, margin, _TOL[torch.float32])
    return out


# Which branch the plan gives each case's corners: all staged, nearly all
# global (only tiles whose footprint the map's edge cuts fit a window), both.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("branch,case", [
    ("staged", dict(H=48, W=64, C=16, V=4, invalid_last=False)),
    ("global", dict(H=48, W=64, C=128, V=2, roll=0.9, shift=0.6)),
    ("mix", dict(H=48, W=64, C=64, V=3, roll=0.9, shift=0.3)),
], ids=["staged", "global", "mix"])
def test_cost_volume_kernel_branches(cuda, dtype, branch, case):
    a = _cv_t(cuda, dtype, **case)
    plan = cvk.cost_volume_cw_plan(*a)
    staged, glob = plan["staged_corners"], plan["global_corners"]
    assert {"staged": staged > 0 and glob == 0,
            "global": glob > 0.9 * plan["corners"],
            "mix": staged > 0 and glob > 0}[branch], (staged, glob)
    _cv_cuda_check(a)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("V", [1, 2, 3, 4])
@pytest.mark.parametrize("C", [16, 64, 128])
def test_cost_volume_kernel_widths_views_odd_map(cuda, dtype, V, C):
    """17x23 (no tile multiple), every width the port uses, one to four
    views, the last view of the last batch invalid where there are two."""
    _cv_cuda_check(_cv_t(cuda, dtype, B=2, V=V, H=17, W=23, C=C, D=7,
                         motion=0.1, invalid_last=V > 1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cost_volume_kernel_sweep_forward(cuda, dtype):
    """The sweep's forward (``ops.costvolume.sweep_forward_args``: 80 SID
    planes for every pixel, mu 0, sigma 1e30): no threshold to leave
    elements out for, so 1e-4 * max|ref| everywhere."""
    from magnet_tpu_torch.models.magnet import sid_depth_centers
    from magnet_tpu_torch.ops.costvolume import sweep_forward_args
    a = _cv_t(cuda, dtype, B=2, V=4, H=40, W=56, C=64, D=1, motion=0.1)
    d_center = torch.from_numpy(sid_depth_centers(1e-3, 10.0, 80)).to(cuda)
    args = sweep_forward_args(d_center, a[1], a[2], *a[5:])
    out = cvk.cost_volume_cw(*args)
    ref = cvk.cost_volume_cw_ref(*args)
    torch.cuda.synchronize()
    assert ref.abs().max() > 0.1
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("V,v_total", [(2, 4), (1, 3), (3, 3)])
def test_cost_volume_kernel_v_total(cuda, dtype, V, v_total):
    """A device's share of a view-sharded frame: the sum over its V views
    divided by the global ``v_total``, in the one launch, against the plain
    version with the same divisor; the launch at its own V rescaled."""
    a = _cv_t(cuda, dtype, B=2, V=V, H=40, W=56, C=64, D=5,
              invalid_last=False)
    before = cvk.cost_volume_cw.launches
    out = cvk.cost_volume_cw(*a, 5.0, v_total=v_total)
    assert cvk.cost_volume_cw.launches == before + 1
    torch.cuda.synchronize()
    ref, margin = cvk.cost_volume_cw_ref(*a, 5.0, return_margin=True,
                                         v_total=v_total)
    cvk.compare(out, ref, margin, _TOL[torch.float32])
    own = cvk.cost_volume_cw(*a, 5.0)
    torch.testing.assert_close(out * v_total, own * V, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cost_volume_kernel_calls_are_bit_equal(cuda, dtype):
    a = _cv_t(cuda, dtype, B=2, V=3, H=48, W=64, C=64, D=20, roll=0.9,
              shift=0.3)
    ops = cvk.cv_operands(a[3], a[4], dtype)
    first = cvk.cost_volume_cw(*a, 5.0, ops)
    assert torch.equal(first, cvk.cost_volume_cw(*a, 5.0, ops))
    assert torch.equal(first, cvk.cost_volume_cw(*a, 5.0))


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


def _gnet_cuda_close(a, dtype):
    before = gk.gnet_update.launches
    out = gk.gnet_update(*a)
    assert gk.gnet_update.launches == before + 1
    ref = gk.gnet_update_ref(*a)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and out.shape == ref.shape
    if dtype == torch.float32:
        _close_cuda(out, ref, dtype)
    else:
        err, lim = _update_err(out, ref, a[2])
        assert err <= lim, (err, lim)


@pytest.mark.cuda
@pytest.mark.parametrize("D", range(1, 17))
def test_gnet_kernel_every_d(cuda, D):
    """Every D the kernel takes (1 to 3 K blocks of im2col columns), on a
    map whose last tile is cut (135 pixels)."""
    _gnet_cuda_close(_gnet_t(cuda, torch.bfloat16, H=9, W=15, D=D),
                     torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("tap", range(9))
def test_gnet_kernel_one_hot_layer0(cuda, tap):
    """Layer 0 with one nonzero tap: a wrong im2col column or w0 slab
    offset shows at that tap, and the image border at its zero padding."""
    cv, feat, prev, convs = _gnet_t(cuda, torch.bfloat16, H=7, W=11, D=5)
    w0 = torch.zeros_like(convs[0][0])
    w0[tap // 3, tap % 3, tap % 5] = 1.0
    _gnet_cuda_close((cv, feat, prev, [(w0, None)] + convs[1:]),
                     torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,W", [(1, 120, 160), (1, 88, 304), (2, 7, 11),
                                   (3, 1, 1)],
                         ids=["scannet", "kitti", "batch_ragged", "3_pixels"])
def test_gnet_kernel_maps(cuda, dtype, B, H, W):
    """The ScanNet and KITTI cost-volume maps, tiles across two images, and
    fewer pixels than one tile."""
    a = _gnet_t(cuda, dtype, B=B, H=H, W=W)
    _gnet_cuda_close(a, dtype)
    if dtype == torch.bfloat16:     # the operands made once by the caller
        ops = gk.gnet_operands(a[3])
        assert torch.equal(gk.gnet_update(*a, ops), gk.gnet_update(*a))


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("case", [dict(H=17, W=23, C=2, k=4),
                                  dict(B=2, H=9, W=7, C=3, k=2),
                                  dict(H=120, W=160, C=2, k=4)],
                         ids=["17x23", "ragged", "eval_shape"])
def test_upsample_kernel_maps_equal_one_map_calls(cuda, dtype, n, case):
    """n maps through one mask: one launch for every four maps, each output
    bit-equal to the one-map call's and held to the plain version."""
    k = case["k"]
    m = _t(upsample_inputs(**case, seed=1)[1], cuda, dtype)
    maps = [_t(upsample_inputs(**case, seed=s)[0], cuda, dtype)
            for s in range(1, n + 1)]
    before = uk.upsample_mask.launches
    outs = uk.upsample_mask(maps, m, k)
    assert uk.upsample_mask.launches == before + -(-n // uk.MAX_MAPS)
    for d, o in zip(maps, outs):
        assert torch.equal(o, uk.upsample_mask(d, m, k))
        _close_cuda(o, uk.upsample_mask_ref(d, m, k), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 3, 4])
@pytest.mark.parametrize("case", [dict(), dict(B=2, H=5, W=3, C=1, k=2),
                                  dict(B=4, H=120, W=160), dict(C=3, k=8),
                                  dict(B=2, H=104, W=136)],
                         ids=["small", "ragged", "magnet_train", "k8",
                              "dnet_train"])
def test_upsample_bwd_kernel_matches_plain(cuda, dtype, n, case):
    """The backward kernel against autograd through the plain version: the
    maps' gradients and the mask's (the maps' terms summed), one launch,
    equal bit for bit on a second call; and autograd through
    ``upsample_mask`` on the card launches it."""
    k = case.get("k", 4)
    m = _t(upsample_inputs(**case, seed=1)[1], cuda, dtype)
    maps = [_t(upsample_inputs(**case, seed=s)[0], cuda, dtype)
            for s in range(2, n + 2)]
    g = torch.Generator().manual_seed(7)
    gouts = [torch.randn((*d.shape[:1], d.shape[1] * k, d.shape[2] * k,
                          d.shape[3]), generator=g).to(cuda, dtype)
             for d in maps]
    before = uk.upsample_mask_bwd.launches
    gd, gm = uk.upsample_mask_bwd(gouts, maps, m, k)
    assert uk.upsample_mask_bwd.launches == before + 1
    want_d, want_m = uk.upsample_mask_bwd_ref(gouts, maps, m, k)
    for got, want in zip(gd + [gm], want_d + [want_m]):
        assert got.dtype == want.dtype == dtype
        _close_cuda(got, want, dtype)
    gd2, gm2 = uk.upsample_mask_bwd(gouts, maps, m, k)
    assert all(torch.equal(a, b) for a, b in zip(gd + [gm], gd2 + [gm2]))
    ts = [d.clone().requires_grad_() for d in maps] + [
        m.clone().requires_grad_()]
    launches = (uk.upsample_mask.launches, uk.upsample_mask_bwd.launches)
    torch.autograd.backward(uk.upsample_mask(ts[:-1], ts[-1], k), gouts)
    assert (uk.upsample_mask.launches, uk.upsample_mask_bwd.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert all(torch.equal(t.grad, w) for t, w in zip(ts, gd + [gm]))


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
    with pytest.raises(ValueError):                             # two shapes
        uk.upsample_mask([d, d[:, :4]], m, 4)
