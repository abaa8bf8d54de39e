"""Consistency-weighted plane-sweep cost volume, NHWC.

The port of ``magnet_tpu/kernels/costvolume_pallas.py::cost_volume_cw_pallas``
with the semantics of the exact path
``magnet_tpu/ops/costvolume.py::_cost_volume_cw_xla``, at any camera motion:
per (pixel, candidate depth, source view) the candidate is projected into
the view in f32, the view's feature, mu and sigma maps are sampled
bilinearly (zeros outside), the sampled feature is dotted with the
reference feature, the cost is zeroed where ``|z - mu_w| >= kappa *
sigma_w`` and weighted by the view's validity; the views are summed and
divided by their number. The CUDA kernel (``csrc/cost_volume_cw.cu``) is a
gather kernel bounded by bytes; see the source note.

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

from magnet_tpu_torch.kernels import build
from magnet_tpu_torch.ops.resample import bilinear_gather

EPS_DIV = 1e-10
COORD_CLIP = 10.0
MAX_C = 128
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
                       kappa: float, return_margin: bool = False):
    """Plain version. d_volume: (B, H, W, D); ref_feat: (B, H, W, C);
    src_feat: (B, V, H, W, C); src_mu, src_sigma: (B, V, H, W); R:
    (B, V, 3, 3); t: (B, V, 3); is_valid: (B, V); intM: (B, 3, 3); rays2d:
    (B, 3, H*W). Returns (B, H, W, D) f32; with ``return_margin`` also the
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
    cost = (cost / float(V)).reshape(B, H, W, D)
    if return_margin:
        return cost, margin.reshape(B, H, W, D)
    return cost


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
                   rays2d: torch.Tensor, kappa: float) -> torch.Tensor:
    """The cost volume with the arguments of ``cost_volume_cw_ref``. CPU
    tensors take the plain version; CUDA tensors launch the kernel on the
    current stream: features f32 or bf16, C a multiple of 16 bytes and at
    most 128. The geometry and the depths are passed in f32; mu and sigma are
    packed as (mu, sigma) pairs in the features' type."""
    if d_volume.device.type == "cpu":
        return cost_volume_cw_ref(d_volume, ref_feat, src_feat, src_mu,
                                  src_sigma, R, t, is_valid, intM, rays2d,
                                  kappa)
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
    d = _need(d_volume, "d_volume", (B, H, W, D), f32, dev)
    ref = _need(ref_feat, "ref_feat", (B, H, W, C), mdt, dev)
    src = _need(src_feat, "src_feat", (B, V, H, W, C), mdt, dev)
    _need(src_mu, "src_mu", (B, V, H, W), f32, dev)
    _need(src_sigma, "src_sigma", (B, V, H, W), f32, dev)
    ms = torch.stack([src_mu, src_sigma], -1).to(mdt).contiguous()
    Rc = _need(R, "R", (B, V, 3, 3), f32, dev)
    tc = _need(t, "t", (B, V, 3), f32, dev)
    valid = _need(is_valid, "is_valid", (B, V), f32, dev)
    K = _need(intM, "intM", (B, 3, 3), f32, dev)
    rays = _need(rays2d, "rays2d", (B, 3, H * W), f32, dev)
    out = torch.empty((B, H, W, D), dtype=f32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.mt_cost_volume_cw(
            _DTYPES[mdt], d.data_ptr(), ref.data_ptr(), src.data_ptr(),
            ms.data_ptr(), Rc.data_ptr(), tc.data_ptr(), valid.data_ptr(),
            K.data_ptr(), rays.data_ptr(), out.data_ptr(), B, V, H, W, C, D,
            float(kappa), torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "cost_volume_cw")
    cost_volume_cw.launches += 1
    return out


cost_volume_cw.launches = 0
