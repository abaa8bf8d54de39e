"""The port's F-Net training sweep (magnet_tpu_torch/ops/costvolume.py,
kernels/sweep_grad_src.py and kernels/sweep_grad_ref.py) against the JAX
package, on the CPU, in f32.

Inputs are made from a numpy seed as in tests/test_costvolume.py::_setup.
Tolerances are the JAX tests' own: the forward to atol 2e-4
(test_cost_volume_sweep_matches_oracle), the gradients to rtol 1e-4,
atol 1e-5 against JAX autodiff through the gather
(``MAGNET_TPU_SWEEP_BWD=xla``, test_sweep_bwd_matches_autodiff): both sum
exact f32 products in another order. At a large roll JAX's default
windowed backward loses the footprints taller than its window, and the port,
which has no window, must still equal autodiff.

The kernel's merged walk (``sweep_grad_src_walk``: flush a pixel when the
footprint leaves it, all pixels when a sample leaves the map or the
projection's denominator changes sign) equals the plain version at 1e-5 *
max|ref| (sums of the same f32 products in another order), at small
motion, a large roll, a large baseline and planes that cross behind the
source camera.

The reference features' gradient (``sweep_grad_ref``): CPU tensors take
its plain version and never reach the operator (whose fake
``tests/test_torch_serve.py`` holds with the others'); its card cases (``GRAD_REF_CASES``) are shown on the CPU to hold
what they name: staged windows, samples outside the map and behind the
source camera, and global jobs at every width and type the card tests run.

CUDA (marker ``cuda``, skipped without a card): each kernel against its
plain version. Row 10: f32 to 1e-4 * max|ref| of the output (atomic adds in
any order) and bf16 features to 2e-2 * max|ref| (the features rounded
once). The reference gradient to 1e-4 * max|ref| in both types: both sides
read the same feature values (bf16 widens exactly) and sum exact f32
products in another order; two of its calls are equal bit for bit (no
atomics), and a backward launches it once. A CUDA tensor never reaches a
plain version. These import no JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_sweep.py``.
"""

import numpy as np
import pytest
import torch

from magnet_tpu_torch.kernels import cost_volume_cw as cvk
from magnet_tpu_torch.kernels import sweep_grad_ref as sgr
from magnet_tpu_torch.kernels import sweep_grad_src as sgk
from magnet_tpu_torch.ops import costvolume as cv
from test_torch_kernels import torch_threads  # noqa: F401


def _rand_pose(rng, scale=0.08, roll=0.0):
    """Small random rotation and translation, then ``roll`` radians about
    the optical axis."""
    w = rng.randn(3) * scale
    theta = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    R = np.eye(3) + np.sin(theta) / max(theta, 1e-8) * K + \
        (1 - np.cos(theta)) / max(theta, 1e-8) ** 2 * (K @ K)
    c, s = np.cos(roll), np.sin(roll)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]]) @ R
    return R, rng.randn(3) * 0.1


def _setup(seed, B=2, V=2, D=8, H=16, W=16, C=8, roll=0.0):
    """f32 numpy inputs of the sweep: d_center, ref_feat, src_feat, R, t,
    is_valid, intM, rays2d (one view invalid), and an upstream cotangent
    (B, H, W, D)."""
    rng = np.random.RandomState(seed)
    fx, fy = W * 1.2, H * 1.6
    K = np.array([[fx, 0, W / 2], [0, fy, H / 2], [0, 0, 1.0]])
    xs, ys = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    rays = np.stack([(xs - K[0, 2]) / fx, (ys - K[1, 2]) / fy,
                     np.ones_like(xs)]).reshape(3, -1)
    poses = [_rand_pose(rng, roll=roll) for _ in range(B * V)]
    R = np.stack([p[0] for p in poses]).reshape(B, V, 3, 3)
    t = np.stack([p[1] for p in poses]).reshape(B, V, 3)
    valid = np.ones((B, V))
    valid[-1, -1] = 0.0
    f32 = np.float32
    return [np.linspace(1.0, 4.0, D).astype(f32),
            rng.randn(B, H, W, C).astype(f32),
            rng.randn(B, V, H, W, C).astype(f32),
            R.astype(f32), t.astype(f32), valid.astype(f32),
            np.broadcast_to(K, (B, 3, 3)).astype(f32),
            np.broadcast_to(rays, (B, 3, H * W)).astype(f32),
            rng.randn(B, H, W, D).astype(f32)]


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _jax_grads(case):
    """JAX's sweep forward and d(sum(cv * up))/d(ref, src)."""
    import jax
    import jax.numpy as jnp
    from magnet_tpu.ops import costvolume

    d, ref, src, *geo, up = [jnp.asarray(a) for a in case]

    @jax.jit
    def run(ref, src):
        def loss(ref, src):
            out = costvolume.cost_volume_sweep(d, ref, src, *geo)
            return jnp.sum(out * up), out
        (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(ref, src)
        return out, grads

    out, (g_ref, g_src) = run(ref, src)
    return np.asarray(out), np.asarray(g_ref), np.asarray(g_src)


def _port_grads(case):
    d, ref, src, *geo, up = [_t(a) for a in case]
    ref.requires_grad_(True)
    src.requires_grad_(True)
    out = cv.cost_volume_sweep(d, ref, src, *geo)
    (out * up).sum().backward()
    return out.detach().numpy(), ref.grad.numpy(), src.grad.numpy()


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("roll", [0.0, 0.9], ids=["small_motion", "roll"])
def test_sweep_matches_jax_autodiff(monkeypatch, roll):
    """Forward and both gradients against autodiff through the gather; at a
    0.9 rad roll on a 48-row map, JAX's windowed default backward is shown
    to differ from autodiff, and the port must not."""
    shape = dict(H=48, W=32) if roll else {}
    case = _setup(3, roll=roll, **shape)
    if roll:
        _, _, win_src = _jax_grads(case)        # JAX's default backward
    monkeypatch.setenv("MAGNET_TPU_SWEEP_BWD", "xla")
    want = _jax_grads(case)
    got = _port_grads(case)
    assert np.abs(want[2]).max() > 1e-4            # non-degenerate
    assert got[0].shape == want[0].shape == case[8].shape
    np.testing.assert_allclose(got[0], want[0], atol=2e-4)
    _close(got[1], want[1])
    _close(got[2], want[2])
    if roll:
        assert np.abs(win_src - want[2]).max() > 1e-2
    # the invalid view gets no gradient
    assert not got[2][-1, -1].any()


def test_out_of_image_projections_give_zero_gradient():
    case = _setup(4, B=1, D=4, C=4)
    case[4] = case[4] + 100.0
    _, g_ref, g_src = _port_grads(case)
    assert float(np.abs(g_src).max()) == 0.0
    assert float(np.abs(g_ref).max()) == 0.0


def test_forward_is_the_cost_volume_kernel_without_its_check():
    """The row-4 identity: the consistency-weighted volume at mu = 0,
    sigma = 1e30, times V, is JAX's pre-softmax sweep sum."""
    import jax.numpy as jnp
    from magnet_tpu.ops.costvolume import _sweep_pre_cost_impl
    d, ref, src, R, t, valid, K, rays, _ = _setup(7, B=1, D=5, W=32)
    B, V, H, W = src.shape[:4]
    want = np.asarray(_sweep_pre_cost_impl(
        *[jnp.asarray(a) for a in (d, ref, src, R, t, valid, K, rays)],
        allow_kernel=False))                               # (B, D, H, W)
    dvol = np.broadcast_to(d, (B, H, W, d.shape[0]))
    mu = np.zeros((B, V, H, W), np.float32)
    got = cvk.cost_volume_cw_ref(
        *[_t(a) for a in (dvol, ref, src, mu, mu + cv.NO_CHECK_SIGMA, R, t,
                          valid, K, rays)], 1.0).numpy() * V
    assert np.abs(want).max() > 0.01
    np.testing.assert_allclose(np.moveaxis(got, -1, 1), want, rtol=1e-4,
                               atol=5e-5)


def test_cpu_tensors_take_the_plain_version():
    case = _setup(5, B=1, D=3, H=8, W=8, C=4)
    d, ref, _, *geo, up = [_t(a) for a in case]
    sgk.sweep_grad_src.launches = 0
    out = sgk.sweep_grad_src(d, ref, up, *geo)
    np.testing.assert_array_equal(out.numpy(),
                                  sgk.sweep_grad_src_ref(d, ref, up,
                                                         *geo).numpy())
    assert sgk.sweep_grad_src.launches == 0


# The walks the merge must survive: small motion, a 0.9 rad roll, a large
# baseline on few planes (footprints jump pixels a plane), translations
# that put the near planes behind the source camera (the denominator
# changes sign).
WALKS = {"small_motion": {}, "roll": dict(roll=0.9),
         "large_baseline": dict(t_shift=(0.6, 0.0, 0.0), D=6),
         "behind_camera": dict(t_shift=(0.0, 0.0, -2.5))}


def _walk_case(seed, walk, cases=WALKS, **shape):
    kw = dict(shape, **cases[walk])
    t_shift = kw.pop("t_shift", (0.0, 0.0, 0.0))
    case = _setup(seed, **kw)
    case[4] = case[4] + np.asarray(t_shift, np.float32)
    return case


def _walk_stats(case):
    """(samples whose denominator has another sign than the previous
    plane's, in-map samples, samples outside the map, largest footprint step
    in pixels) over the valid views."""
    d, ref, _, R, t, valid, K, rays, _ = [_t(a) for a in case]
    flips = inside = outside = 0
    step = 0.0
    for b in range(R.shape[0]):
        for v in range(R.shape[1]):
            if valid[b, v] == 0:
                continue
            x, y, _ = cvk.project(K[b], R[b, v], t[b, v], rays[b],
                                  d.expand(rays.shape[-1], -1),
                                  ref.shape[1], ref.shape[2])
            denom = (K[b] @ t[b, v])[2] + (K[b] @ (R[b, v] @ rays[b]))[2][
                :, None] * d + cvk.EPS_DIV
            flips += int(((denom[:, 1:] > 0) != (denom[:, :-1] > 0)).sum())
            xf, yf = torch.floor(x), torch.floor(y)
            ok = ((xf >= -1) & (xf <= ref.shape[2] - 1) & (yf >= -1)
                  & (yf <= ref.shape[1] - 1))
            inside += int(ok.sum())
            outside += int((~ok).sum())
            both = ok[:, 1:] & ok[:, :-1]
            jump = torch.maximum((xf[:, 1:] - xf[:, :-1]).abs(),
                                 (yf[:, 1:] - yf[:, :-1]).abs())
            if both.any():
                step = max(step, float(jump[both].max()))
    return flips, inside, outside, step


@pytest.mark.parametrize("walk", list(WALKS))
def test_merged_walk_equals_plain(walk):
    """The kernel's order of summation, emulated, on 2 x 3 views of 12x20
    reference pixels at 24 planes, equals the plain version; each case
    exercises what it names, and the merge emits fewer reductions than
    there are in-image corners."""
    case = _walk_case(11, walk, B=2, V=3, D=24, H=12, W=20, C=8)
    d, ref, _, *geo, up = [_t(a) for a in case]
    out, reductions = sgk.sweep_grad_src_walk(d, ref, up, *geo)
    want = sgk.sweep_grad_src_ref(d, ref, up, *geo)
    assert float(want.abs().max()) > 0.1
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    assert not out[-1, -1].any()                  # the invalid view
    flips, inside, outside, step = _walk_stats(case)
    assert 0 < reductions < 4 * inside
    if walk == "small_motion":
        assert flips == 0 and reductions < inside
    if walk == "large_baseline":
        assert step >= 3 and outside > 0
    if walk == "behind_camera":
        assert flips > 0 and outside > 0


def test_merged_walk_counts_what_a_static_footprint_merges():
    """No motion at all: every plane of a pixel samples its own 2x2
    footprint (the identity pose, rays through pixel centres), so each
    reference pixel emits exactly its in-image footprint pixels once."""
    case = _setup(12, B=1, V=1, D=6, H=5, W=7, C=4)
    case[3] = np.eye(3, dtype=np.float32)[None, None]
    case[4] = np.zeros((1, 1, 3), np.float32)
    case[5] = np.ones((1, 1), np.float32)
    d, ref, _, *geo, up = [_t(a) for a in case]
    out, reductions = sgk.sweep_grad_src_walk(d, ref, up, *geo)
    want = sgk.sweep_grad_src_ref(d, ref, up, *geo)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    assert reductions <= 4 * 5 * 7


# The reference gradient's card cases: small motion (staged windows), a
# 0.9 rad roll with the near planes behind the source camera (samples
# outside the map, negative denominators), and a zoom (the source camera
# 0.9 closer: a tile's samples spread over more than a window holds, so
# global jobs), at a map larger than any window.
GRAD_REF_CASES = {"small_motion": {},
                  "roll_behind_camera": dict(roll=0.9,
                                             t_shift=(0.0, 0.0, -2.5)),
                  "zoom": dict(t_shift=(0.0, 0.0, -0.9))}
GRAD_REF_SHAPE = dict(B=2, V=3, D=40, H=48, W=64)
GRAD_REF_WIDTHS = [8, 64, 128]


def _grad_ref_jobs(case, C, dtype):
    """(staged, global) jobs of the kernel's plan for a card case at C
    channels of ``dtype``: the cost volume's plan with C channels a staged
    pixel."""
    d, _, src, R, t, valid, K, rays, _ = [_t(a) for a in case]
    B, V, H, W, _ = src.shape
    src = torch.zeros(B, V, H, W, C, dtype=dtype)
    dvol = d.expand(B, H, W, d.shape[0])
    plan = cvk.cost_volume_cw_plan(dvol, None, src, None, None, R, t, valid,
                                   K, rays, extra=0)
    return plan["staged_jobs"], plan["global_jobs"]


def test_grad_ref_cpu_tensors_take_the_plain_version(monkeypatch):
    class Boom:
        def __getattr__(self, name):
            raise AssertionError("a CPU tensor reached an operator")
    monkeypatch.setattr(sgr, "OPS", Boom())
    case = _setup(5, B=1, D=3, H=8, W=8, C=4)
    d, _, src, *geo, up = [_t(a) for a in case]
    sgr.sweep_grad_ref.launches = 0
    out = sgr.sweep_grad_ref(d, src, up, *geo)
    np.testing.assert_array_equal(out.numpy(),
                                  sgr.sweep_grad_ref_ref(d, src, up,
                                                         *geo).numpy())
    assert out.shape == (1, 8, 8, 4) and out.dtype == torch.float32
    assert sgr.sweep_grad_ref.launches == 0


@pytest.mark.parametrize("name", list(GRAD_REF_CASES))
def test_grad_ref_cases_hold_what_they_name(name):
    case = _walk_case(6, name, GRAD_REF_CASES, C=8, **GRAD_REF_SHAPE)
    flips, inside, outside, _ = _walk_stats(case)
    jobs = {(C, dt): _grad_ref_jobs(case, C, dt) for C in GRAD_REF_WIDTHS
            for dt in (torch.float32, torch.bfloat16)}
    assert inside > 0
    if name == "small_motion":
        assert flips == 0 and jobs[64, torch.bfloat16][0] > 0
    if name == "roll_behind_camera":
        assert flips > 0 and outside > 0
    if name == "zoom":
        assert all(g > 0 for _, g in jobs.values())
        assert jobs[8, torch.bfloat16][0] > 0


# ---- on the card -------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("walk", list(WALKS))
@pytest.mark.parametrize("C", [16, 64, 128, 10])
def test_kernel_matches_plain(cuda, dtype, walk, C):
    """Every walk of ``WALKS`` at C = 16, 64 and 128 (float4 reductions by
    8, 16 and 32 lanes) and 10 (scalar ones), one view invalid."""
    case = _walk_case(6, walk, B=2, V=3, D=40, H=24, W=40, C=C)
    d, ref, _, *geo, up = [_t(a, cuda) for a in case]
    ref = ref.to(dtype)
    before = sgk.sweep_grad_src.launches
    out = sgk.sweep_grad_src(d, ref, up, *geo)
    torch.cuda.synchronize()
    assert sgk.sweep_grad_src.launches == before + 1
    want = sgk.sweep_grad_src_ref(d, ref, up, *geo)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}[dtype]
    assert out.shape == want.shape and out.dtype == torch.float32
    assert (out - want).abs().max().item() <= tol * want.abs().max().item()
    assert not out[-1, -1].any()                  # the invalid view


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_version(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(sgk, "sweep_grad_src_ref", boom)
    case = _setup(8, B=1, D=4, H=8, W=8, C=16)
    d, ref, _, *geo, up = [_t(a, cuda) for a in case]
    sgk.sweep_grad_src(d, ref, up, *geo)
    torch.cuda.synchronize()
    with pytest.raises(ValueError):
        sgk.sweep_grad_src(d, torch.zeros(1, 8, 8, 130, device=cuda), up,
                           *geo)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(GRAD_REF_CASES))
@pytest.mark.parametrize("C", GRAD_REF_WIDTHS)
def test_grad_ref_kernel_matches_plain(cuda, dtype, name, C):
    case = _walk_case(6, name, GRAD_REF_CASES, C=C, **GRAD_REF_SHAPE)
    d, _, src, *geo, up = [_t(a, cuda) for a in case]
    src = src.to(dtype)
    before = sgr.sweep_grad_ref.launches
    out = sgr.sweep_grad_ref(d, src, up, *geo)
    torch.cuda.synchronize()
    assert sgr.sweep_grad_ref.launches == before + 1
    want = sgr.sweep_grad_ref_ref(d, src, up, *geo)
    assert out.shape == want.shape and out.dtype == torch.float32
    assert float(want.abs().max()) > 0.1
    assert (out - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.cuda
def test_grad_ref_calls_are_bit_identical(cuda):
    case = _walk_case(7, "zoom", GRAD_REF_CASES, C=64, **GRAD_REF_SHAPE)
    d, _, src, *geo, up = [_t(a, cuda) for a in case]
    src = src.to(torch.bfloat16)
    first = sgr.sweep_grad_ref(d, src, up, *geo)
    assert torch.equal(first, sgr.sweep_grad_ref(d, src, up, *geo))


@pytest.mark.cuda
def test_grad_ref_backward_launches_once_and_never_the_plain_version(
        cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(sgr, "sweep_grad_ref_ref", boom)
    case = _setup(8, B=1, D=4, H=8, W=8, C=16)
    d, ref, src, *geo, up = [_t(a, cuda) for a in case]
    ref.requires_grad_(True)
    src.requires_grad_(True)
    before = sgr.sweep_grad_ref.launches
    (cv.cost_volume_sweep(d, ref, src, *geo) * up).sum().backward()
    torch.cuda.synchronize()
    assert sgr.sweep_grad_ref.launches == before + 1
    assert ref.grad.dtype == ref.dtype and bool(ref.grad.abs().max() > 0)
    with pytest.raises(ValueError):
        sgr.sweep_grad_ref(d, torch.zeros(1, 2, 8, 8, 130, device=cuda), up,
                           *geo)
