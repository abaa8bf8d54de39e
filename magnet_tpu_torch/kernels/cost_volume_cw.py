"""Consistency-weighted plane-sweep cost volume, NHWC.

The port of ``magnet_tpu/kernels/costvolume_pallas.py::cost_volume_cw_pallas``
with the semantics of the exact path
``magnet_tpu/ops/costvolume.py::_cost_volume_cw_xla``, at any camera motion:
per (pixel, candidate depth, source view) the candidate is projected into
the view in f32, the view's feature, mu and sigma maps are sampled
bilinearly (zeros outside), the sampled feature is dotted with the
reference feature, the cost is zeroed where ``|z - mu_w| >= kappa *
sigma_w`` and weighted by the view's validity; the views are summed and
divided by ``v_total``: their number by default, the global view count
where each device holds a share of a frame's views and the partial cost
volumes are summed over the devices (``core/sharding_inference.py``; the
JAX package's psum over its view axis divides by the global count without
saying so).

The CUDA kernel (``csrc/cost_volume_cw.cu``) gives a block an 8 x 8 tile of
reference pixels and all their candidates, and cuts each view's candidates
into chunks whose samples' in-image corners fit a window of the source maps
in shared memory; a single candidate that does not fit is gathered from
global memory in the same kernel. ``cost_volume_cw_plan`` replays that rule
in plain PyTorch (the chunks, the corners each branch serves, the bytes
copied into shared memory); ``kernel_positions`` is the kernel's projection
with its roundings. ``cv_operands`` packs the (mu, sigma) pairs in the
features' type, once for every call on the same source maps.

The consistency test is a hard threshold: two correct f32 implementations
order their sums differently and a sample that sits on the threshold lands
on either side, where the cost jumps by a whole dot product. So
``cost_volume_cw_ref(..., return_margin=True)`` also returns, per element,
the least ``| |z - mu_w| - kappa * sigma_w |`` over the valid views, and
``compare`` holds only the elements whose margin exceeds a stated value to
the tolerance, requiring the excluded share to stay small.

``cost_volume_cw_ref`` is the plain PyTorch version. ``cost_volume_cw`` runs
it for tensors on the CPU and launches the kernel for tensors on a CUDA
device, or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from magnet_tpu_torch.kernels.ops import OPS
from magnet_tpu_torch.ops.resample import bilinear_gather

EPS_DIV = 1e-10
COORD_CLIP = 10.0
MAX_C = 128
MAX_D = 256
# the kernel's compile-time shapes (csrc/cost_volume_cw.cu: CV_TILE_H,
# CV_TILE_W, CV_CHUNK, CV_WINDOW_BYTES)
TILE = 8
CHUNK = 16
WINDOW_BYTES = 24576
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# ``compare``: elements closer than this to the consistency threshold (in
# depth units) are left out, and at most this share of them may be.
MARGIN = 1e-4
MAX_EXCLUDED = 0.01


def project(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
            rays: torch.Tensor, d: torch.Tensor, H: int, W: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K, R: (3, 3); t: (3,); rays: (3, N); d: (N, D) depths, all f32.
    Returns x, y (sample positions in index space, align_corners=False) and
    z (depth in the source camera), each (N, D)."""
    rr = R @ rays                                        # (3, N)
    a = K @ t                                            # (3,)
    b = K @ rr                                           # (3, N)
    p0 = a[0] + b[0][:, None] * d
    p1 = a[1] + b[1][:, None] * d
    p2 = a[2] + b[2][:, None] * d
    z = t[2] + rr[2][:, None] * d
    denom = p2 + EPS_DIV
    gx = ((p0 / denom - W / 2.0) / (W / 2.0)).clamp(-COORD_CLIP, COORD_CLIP)
    gy = ((p1 / denom - H / 2.0) / (H / 2.0)).clamp(-COORD_CLIP, COORD_CLIP)
    return ((gx + 1.0) * W - 1.0) * 0.5, ((gy + 1.0) * H - 1.0) * 0.5, z


def cost_volume_cw_ref(d_volume: torch.Tensor, ref_feat: torch.Tensor,
                       src_feat: torch.Tensor, src_mu: torch.Tensor,
                       src_sigma: torch.Tensor, R: torch.Tensor,
                       t: torch.Tensor, is_valid: torch.Tensor,
                       intM: torch.Tensor, rays2d: torch.Tensor,
                       kappa: float, return_margin: bool = False,
                       v_total: int = None):
    """Plain version. d_volume: (B, H, W, D); ref_feat: (B, H, W, C);
    src_feat: (B, V, H, W, C); src_mu, src_sigma: (B, V, H, W); R:
    (B, V, 3, 3); t: (B, V, 3); is_valid: (B, V); intM: (B, 3, 3); rays2d:
    (B, 3, H*W); ``v_total``, the divisor of the sum over the views
    (default V). Returns (B, H, W, D) f32; with ``return_margin`` also the
    (B, H, W, D) margin described in the module note.

    Features match in their own type (f32 accumulation); mu and sigma round
    to that type first; the geometry and the consistency test are f32."""
    f32 = torch.float32
    B, H, W, D = d_volume.shape
    V, C = src_feat.shape[1], src_feat.shape[-1]
    mdt = src_feat.dtype
    dvol = d_volume.to(f32).reshape(B, H * W, D)
    cost = torch.zeros((B, H * W, D), dtype=f32, device=d_volume.device)
    margin = torch.full_like(cost, float("inf"))
    for b in range(B):
        q = ref_feat[b].to(mdt).to(f32).reshape(H * W, 1, C)
        for v in range(V):
            x, y, z = project(intM[b].to(f32), R[b, v].to(f32),
                              t[b, v].to(f32), rays2d[b].to(f32), dvol[b],
                              H, W)
            packed = torch.cat(
                [src_feat[b, v], torch.stack([src_mu[b, v], src_sigma[b, v]],
                                             -1).to(mdt)], -1)
            s = bilinear_gather(packed, x, y)            # (N, D, C + 2)
            dot = (s[..., :C] * q).sum(-1)
            mu, sigma = s[..., C], s[..., C + 1]
            gap = (z - mu).abs() - sigma * kappa
            cost[b] += dot * (gap < 0) * is_valid[b, v].to(f32)
            if return_margin and bool(is_valid[b, v] != 0):
                margin[b] = torch.minimum(margin[b], gap.abs())
    cost = (cost / float(_divisor(v_total, V))).reshape(B, H, W, D)
    if return_margin:
        return cost, margin.reshape(B, H, W, D)
    return cost


def _divisor(v_total, V: int) -> int:
    """``v_total``, V where it is None; raises below 1."""
    v_total = V if v_total is None else int(v_total)
    if v_total < 1:
        raise ValueError(f"cost_volume_cw: v_total={v_total} must be at "
                         "least 1")
    return v_total


def compare(out: torch.Tensor, ref: torch.Tensor, margin: torch.Tensor,
            tol: float) -> Tuple[float, float, float]:
    """Hold ``out`` to ``ref`` within ``tol * max|ref|`` on the elements
    whose margin exceeds ``MARGIN``. Returns (largest error there, its
    limit, excluded share); raises if the error or the share is too large."""
    keep = margin > MARGIN
    excluded = 1.0 - keep.float().mean().item()
    if not torch.isfinite(out).all():
        raise ValueError("cost volume: non-finite values")
    err = ((out - ref).abs() * keep).max().item()
    limit = tol * ref.abs().max().item()
    if excluded > MAX_EXCLUDED:
        raise ValueError(f"cost volume: {excluded:.4f} of the elements sit "
                         f"within {MARGIN} of the consistency threshold")
    if not err <= limit:
        raise ValueError(f"cost volume: max_abs_err {err:.3e} over the "
                         f"limit {limit:.3e}")
    return err, limit, excluded


def cv_operands(src_mu: torch.Tensor, src_sigma: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """The (B, V, H, W, 2) (mu, sigma) pairs in the features' type, as the
    kernel reads them; make them once for every call on the same maps."""
    return torch.stack([src_mu, src_sigma], -1).to(dtype).contiguous()


def _fma(a, b, c):
    """f32 fused multiply-add: the exact product and sum in f64, rounded
    once more to f32 (equal to one rounding but where the f64 sum sits on an
    f32 tie, which the sample positions never were in the tests)."""
    return (a.double() * b.double() + c.double()).float()


def kernel_positions(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                     rays: torch.Tensor, d: torch.Tensor, H: int, W: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's projection (``cv_sample``), rounding for rounding: K, R
    (3, 3); t (3,); rays (3, N); d (N, D), all f32. Returns the top-left
    corner (x0, y0) of each sample, int64 (N, D), and whether it touches the
    map (``x0`` in [-1, W - 1] and ``y0`` in [-1, H - 1])."""
    f32 = torch.float32
    K, R, t, rays, d = (x.to(f32) for x in (K, R, t, rays, d))
    kt = [_fma(K[i, 2], t[2], _fma(K[i, 1], t[1], K[i, 0] * t[0]))
          for i in range(3)]
    rr = [_fma(R[i, 2], rays[2], _fma(R[i, 1], rays[1], R[i, 0] * rays[0]))
          for i in range(3)]
    p = [_fma(_fma(K[i, 2], rr[2], _fma(K[i, 1], rr[1], K[i, 0] * rr[0]))[:, None],
              d, kt[i]) for i in range(3)]
    denom = p[2] + torch.tensor(EPS_DIV, dtype=f32)
    hw, hh = torch.tensor(W * 0.5, dtype=f32), torch.tensor(H * 0.5, dtype=f32)
    gx = ((p[0] / denom - hw) / hw).clamp(-COORD_CLIP, COORD_CLIP)
    gy = ((p[1] / denom - hh) / hh).clamp(-COORD_CLIP, COORD_CLIP)
    xf = torch.floor(((gx + 1.0) * W - 1.0) * 0.5)
    yf = torch.floor(((gy + 1.0) * H - 1.0) * 0.5)
    hit = (xf >= -1) & (xf <= W - 1) & (yf >= -1) & (yf <= H - 1)
    return (torch.where(hit, xf, 0.0).long(), torch.where(hit, yf, 0.0).long(),
            hit)


def _union(x: torch.Tensor) -> torch.Tensor:
    """(..., n, 4) boxes (xlo, xhi, ylo, yhi) -> their (..., 4) union."""
    return torch.stack([x[..., 0].amin(-1), x[..., 1].amax(-1),
                        x[..., 2].amin(-1), x[..., 3].amax(-1)], -1)


def cost_volume_cw_plan(d_volume: torch.Tensor, ref_feat: torch.Tensor,
                        src_feat: torch.Tensor, src_mu, src_sigma,
                        R: torch.Tensor, t: torch.Tensor,
                        is_valid: torch.Tensor, intM: torch.Tensor,
                        rays2d: torch.Tensor, kappa=None,
                        extra: int = 2) -> dict:
    """The kernel's chunks for these inputs (the arguments of
    ``cost_volume_cw``; only the geometry, the shapes and the features' type
    are read), in plain PyTorch on the inputs' device. Per 8 x 8 tile and
    valid view the box of the in-image bilinear corners of each candidate's
    samples; a candidate's chunk is the largest aligned run of ``CHUNK``,
    ..., 2, 1 candidates whose boxes' union times C + ``extra`` channels
    fits ``WINDOW_BYTES`` (staged), or the candidate alone, and a run of
    such lone candidates within an aligned ``CHUNK`` is one global job.
    ``extra``: 2, the (mu, sigma) pair the cost volume stages beside the
    features; 0 for the sweep gradient (``sweep_grad_ref``), which stages
    the features alone.

    Returns ``jobs``, (n, 11) int64 rows (b, tile row, tile column, view,
    first candidate, candidates, staged, xlo, ylo, width, height), a tile's
    in the kernel's order (view, candidate); the in-image ``corners`` of
    all samples and those that staged and global jobs serve;
    ``staged_jobs``, ``global_jobs``; ``smem_bytes``, the bytes copied into
    shared memory."""
    B, H, W, D = d_volume.shape
    C, elem = src_feat.shape[-1], src_feat.element_size()
    dev, T = d_volume.device, TILE
    ty, tx = -(-H // T), -(-W // T)
    dp = -(-D // CHUNK) * CHUNK
    empty = torch.tensor([1 << 40, -(1 << 40)] * 2, device=dev)
    jobs, stats = [], dict(corners=0, staged_corners=0, global_corners=0,
                           staged_jobs=0, global_jobs=0, smem_bytes=0)
    for b in range(B):
        for v in range(R.shape[1]):
            if float(is_valid[b, v]) == 0.0:
                continue
            x0, y0, hit = kernel_positions(
                intM[b], R[b, v], t[b, v], rays2d[b],
                d_volume[b].reshape(H * W, D), H, W)
            lo = torch.stack([x0.clamp(min=0), (x0 + 1).clamp(max=W - 1),
                              y0.clamp(min=0), (y0 + 1).clamp(max=H - 1)], -1)
            # per (tile, candidate) the box of in-image corners and their count
            grid = empty.expand(ty * T, tx * T, dp, 4).clone()
            grid[:H, :W, :D] = torch.where(hit[..., None], lo,
                                           empty).reshape(H, W, D, 4)
            box = _union(grid.reshape(ty, T, tx, T, dp, 4).permute(
                0, 2, 4, 1, 3, 5).reshape(ty, tx, dp, T * T, 4))
            cnt = torch.zeros(ty * T, tx * T, dp, dtype=torch.int64,
                              device=dev)
            cnt[:H, :W, :D] = ((lo[..., 1] - lo[..., 0] + 1)
                               * (lo[..., 3] - lo[..., 2] + 1)
                               * hit).reshape(H, W, D)
            cnt = cnt.reshape(ty, T, tx, T, dp).sum((1, 3))
            # the largest aligned run that fits (fitting only shrinks as
            # runs grow)
            size = torch.ones(ty, tx, dp, dtype=torch.int64, device=dev)
            staged = torch.zeros(ty, tx, dp, dtype=torch.bool, device=dev)
            pick, level = box, 1
            while level <= CHUNK:
                u = _union(box.reshape(ty, tx, dp // level, level, 4)
                           ).repeat_interleave(level, -2)
                area = (u[..., 1] - u[..., 0] + 1) * (u[..., 3] - u[..., 2] + 1)
                fits = (u[..., 0] > u[..., 1]) | (area * (C + extra) * elem
                                                  <= WINDOW_BYTES)
                size = torch.where(fits, level, size)
                staged |= fits
                pick = torch.where(fits[..., None], u, pick)
                level *= 2
            d = torch.arange(dp, device=dev)
            any_ = (d < D) & (pick[..., 0] <= pick[..., 1])
            # runs of candidates that fit no window alone, within an
            # aligned CHUNK: one global job each
            glob = any_ & ~staged
            run = torch.zeros_like(size)
            for i in reversed(range(dp)):
                nxt = run[..., i + 1] if (i + 1) % CHUNK else 0
                run[..., i] = glob[..., i] * (1 + nxt)
            prev = torch.cat([torch.zeros_like(glob[..., :1]), glob[..., :-1]],
                             -1) & (d % CHUNK != 0)
            lead = any_ & torch.where(staged, d % size == 0, ~prev)
            size = torch.where(staged, torch.minimum(size, D - d), run)
            stats["corners"] += int(cnt.sum())
            stats["staged_corners"] += int((cnt * staged).sum())
            stats["global_corners"] += int((cnt * ~staged).sum())
            i, j, d = lead.nonzero().unbind(-1)
            pk, st = pick[i, j, d], staged[i, j, d]
            ww, wh = pk[:, 1] - pk[:, 0] + 1, pk[:, 3] - pk[:, 2] + 1
            stats["staged_jobs"] += int(st.sum())
            stats["global_jobs"] += int((~st).sum())
            stats["smem_bytes"] += (int((ww * wh * st).sum()) * (C + extra)
                                    * elem)
            jobs.append(torch.stack(
                [torch.full_like(i, b), i, j, torch.full_like(i, v), d,
                 size[i, j, d], st.long(), pk[:, 0], pk[:, 2], ww, wh], -1))
    stats["jobs"] = (torch.cat(jobs) if jobs else
                     torch.zeros(0, 11, dtype=torch.int64, device=dev))
    return stats


def _need(t: torch.Tensor, name: str, shape, dtype, device,
          what: str = "cost_volume_cw") -> torch.Tensor:
    """``t`` checked for shape and device (raises) and made a contiguous
    tensor of ``dtype``, for the launch of kernel ``what``."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} has shape "
                         f"{tuple(t.shape)}, want {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{what}: {name} is on {t.device}, "
                         f"want {device}")
    return t.to(dtype).contiguous()


def cost_volume_cw(d_volume: torch.Tensor, ref_feat: torch.Tensor,
                   src_feat: torch.Tensor, src_mu: torch.Tensor,
                   src_sigma: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                   is_valid: torch.Tensor, intM: torch.Tensor,
                   rays2d: torch.Tensor, kappa: float,
                   ops: torch.Tensor = None,
                   v_total: int = None) -> torch.Tensor:
    """The cost volume with the arguments of ``cost_volume_cw_ref``. CPU
    tensors take the plain version; CUDA tensors launch the kernel on the
    current stream: features f32 or bf16, C a multiple of 16 bytes and at
    most 128, D at most 256 (and V x D within the block's shared memory,
    else the launch raises). The geometry and the depths are passed in f32;
    ``ops``, the (mu, sigma) pairs of ``cv_operands``, is made here when it
    is not given. ``v_total`` divides the sum over the views (default V;
    the one launch divides by it). The launch goes through the operator
    ``kernels.ops.cost_volume_cw``."""
    if d_volume.device.type == "cpu":
        return cost_volume_cw_ref(d_volume, ref_feat, src_feat, src_mu,
                                  src_sigma, R, t, is_valid, intM, rays2d,
                                  kappa, v_total=v_total)
    if d_volume.device.type != "cuda":
        raise ValueError(f"cost_volume_cw: unsupported device "
                         f"{d_volume.device}")
    dev, mdt, f32 = d_volume.device, src_feat.dtype, torch.float32
    if mdt not in _DTYPES:
        raise ValueError(f"cost_volume_cw: unsupported dtype {mdt}")
    if d_volume.dim() != 4 or src_feat.dim() != 5:
        raise ValueError("cost_volume_cw: d_volume must be (B, H, W, D) and "
                         "src_feat (B, V, H, W, C)")
    B, H, W, D = d_volume.shape
    V, C = src_feat.shape[1], src_feat.shape[-1]
    if C % (16 // src_feat.element_size()) or C > MAX_C:
        raise ValueError(f"cost_volume_cw: C={C} must be a multiple of 16 "
                         f"bytes and at most {MAX_C}")
    if D > MAX_D:
        raise ValueError(f"cost_volume_cw: D={D} is over {MAX_D}")
    d = _need(d_volume, "d_volume", (B, H, W, D), f32, dev)
    ref = _need(ref_feat, "ref_feat", (B, H, W, C), mdt, dev)
    src = _need(src_feat, "src_feat", (B, V, H, W, C), mdt, dev)
    if ops is None:
        ops = cv_operands(_need(src_mu, "src_mu", (B, V, H, W), f32, dev),
                          _need(src_sigma, "src_sigma", (B, V, H, W), f32,
                                dev), mdt)
    if ops.dtype != mdt or not ops.is_contiguous():
        raise ValueError(f"cost_volume_cw: ops must be contiguous {mdt}")
    ms = _need(ops, "ops", (B, V, H, W, 2), mdt, dev)
    Rc = _need(R, "R", (B, V, 3, 3), f32, dev)
    tc = _need(t, "t", (B, V, 3), f32, dev)
    valid = _need(is_valid, "is_valid", (B, V), f32, dev)
    K = _need(intM, "intM", (B, 3, 3), f32, dev)
    rays = _need(rays2d, "rays2d", (B, 3, H * W), f32, dev)
    return OPS.cost_volume_cw(d, ref, src, ms, Rc, tc, valid, K, rays,
                              float(kappa), _divisor(v_total, V))


cost_volume_cw.launches = 0
