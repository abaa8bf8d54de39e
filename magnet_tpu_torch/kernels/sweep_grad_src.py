"""Gradient of the plane-sweep cost with respect to the source features.

The port of ``magnet_tpu/kernels/sweepbwd_pallas.py::sweep_grad_src_pallas``,
the backward of the F-Net training sweep, with the semantics of autodiff
through the bilinear gather (the JAX package's ``MAGNET_TPU_SWEEP_BWD=xla``
path): for every reference pixel q, sweep depth d and source view v, the
candidate is projected into the view in f32 (``cost_volume_cw.project``) and
``gbar[b, q, d] * valid[b, v] * ref[b, q, :]`` is scattered into the four
corners of its bilinear footprint with their weights; corners outside the
map get nothing. It is exact at any camera motion: there is no row window,
as the TPU kernel had, and no rounding of the weights.

``sweep_grad_src_ref`` is the plain PyTorch version (``index_add_`` of the
corner contributions, chunked over D so that the transient stays bounded).
``sweep_grad_src`` runs it for tensors on the CPU and launches the CUDA
kernel (``csrc/sweep_grad_src.cu``) for tensors on a CUDA device, or raises.
The kernel walks each reference pixel's planes in depth order and keeps the
weight sum of each pixel of the current bilinear footprint; it adds a
pixel's ``weight_sum * ref`` to the output (one float4 atomic a lane) when
the footprint leaves that pixel, and flushes all of it when a sample leaves
the map or its projection's denominator changes sign.
``sweep_grad_src_walk`` is that walk in plain PyTorch, which also counts
the reductions it emits: it equals the plain version to the rounding of the
sums, at any motion. The kernel sums in no fixed order: two runs may differ
in the last bits.
"""

from __future__ import annotations

import torch

from magnet_tpu_torch.kernels import cost_volume_cw as cvk
from magnet_tpu_torch.kernels.ops import OPS

MAX_C = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# bound on the plain version's per-chunk transient (one corner's (pixels,
# planes, C) contributions)
CHUNK_BYTES = 1 << 28


def sweep_grad_src_ref(d_center: torch.Tensor, ref_feat: torch.Tensor,
                       gbar: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                       is_valid: torch.Tensor, intM: torch.Tensor,
                       rays2d: torch.Tensor) -> torch.Tensor:
    """Plain version. d_center: (D,) sweep depths; ref_feat: (B, H, W, C);
    gbar: (B, H, W, D), the cotangent of the pre-softmax cost summed over the
    views; R: (B, V, 3, 3); t: (B, V, 3); is_valid: (B, V); intM: (B, 3, 3);
    rays2d: (B, 3, H*W). Returns (B, V, H, W, C) f32."""
    f32 = torch.float32
    B, H, W, C = ref_feat.shape
    V, D, hw = R.shape[1], d_center.shape[0], H * W
    dev = ref_feat.device
    out = torch.zeros((B, V, hw, C), dtype=f32, device=dev)
    chunk = max(1, min(D, CHUNK_BYTES // (hw * C * 4)))
    for b in range(B):
        q = ref_feat[b].reshape(hw, 1, C).to(f32)
        g_b = gbar[b].reshape(hw, D).to(f32)
        for v in range(V):
            for d0 in range(0, D, chunk):
                dc = d_center[d0:d0 + chunk].to(f32)
                x, y, _ = cvk.project(intM[b].to(f32), R[b, v].to(f32),
                                      t[b, v].to(f32), rays2d[b].to(f32),
                                      dc.expand(hw, -1), H, W)
                g = g_b[:, d0:d0 + chunk] * is_valid[b, v].to(f32)
                x0, y0 = torch.floor(x), torch.floor(y)
                wx1, wy1 = x - x0, y - y0
                for cy in (0, 1):
                    for cx in (0, 1):
                        xi, yi = x0 + cx, y0 + cy
                        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
                        w = ((wy1 if cy else 1.0 - wy1)
                             * (wx1 if cx else 1.0 - wx1) * g * inb)
                        at = torch.where(inb, yi * W + xi, 0.0).long()
                        out[b, v].index_add_(0, at.reshape(-1),
                                             (w[..., None] * q).reshape(-1, C))
    return out.reshape(B, V, H, W, C)


def sweep_grad_src_walk(d_center: torch.Tensor, ref_feat: torch.Tensor,
                        gbar: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                        is_valid: torch.Tensor, intM: torch.Tensor,
                        rays2d: torch.Tensor) -> tuple:
    """The kernel's merged walk, vectorised over the reference pixels, with
    the arguments of ``sweep_grad_src_ref``. Returns the gradient (B, V, H,
    W, C) f32 and the number of C-wide reductions emitted (pending pixels
    with a nonzero weight sum, flushed)."""
    f32 = torch.float32
    B, H, W, C = ref_feat.shape
    V, D, hw = R.shape[1], d_center.shape[0], H * W
    dev = ref_feat.device
    out = torch.zeros((B, V, hw, C), dtype=f32, device=dev)
    none = torch.full((hw,), -(1 << 30), dtype=torch.long, device=dev)
    reductions = 0
    for b in range(B):
        q = ref_feat[b].reshape(hw, C).to(f32)
        for v in range(V):
            Kb, Rv, tv = intM[b].to(f32), R[b, v].to(f32), t[b, v].to(f32)
            x, y, _ = cvk.project(Kb, Rv, tv, rays2d[b].to(f32),
                                  d_center.to(f32).expand(hw, -1), H, W)
            denom = ((Kb @ tv)[2] + (Kb @ (Rv @ rays2d[b].to(f32)))[2][:, None]
                     * d_center.to(f32) + cvk.EPS_DIV)
            g = gbar[b].reshape(hw, D).to(f32) * is_valid[b, v].to(f32)
            o = out[b, v]
            fx, fy = none.clone(), none.clone()
            fpos = torch.ones(hw, dtype=torch.bool, device=dev)
            w = torch.zeros((hw, 4), dtype=f32, device=dev)

            def flush(mask, s):
                nonlocal reductions
                m = mask & (w[:, s] != 0)
                at = (fy[m] + s // 2) * W + fx[m] + s % 2
                o.index_add_(0, at, w[m, s, None] * q[m])
                reductions += int(m.sum())
                w[mask, s] = 0.0

            for d in range(D):
                live = g[:, d] != 0
                xf, yf = torch.floor(x[:, d]), torch.floor(y[:, d])
                in_map = live & (xf >= -1) & (xf <= W - 1) & (yf >= -1) & (
                    yf <= H - 1)
                pos = denom[:, d] > 0
                reset = live & (~in_map | (pos != fpos))
                for s in range(4):
                    flush(reset, s)
                fx[reset], fy[reset] = none[reset], none[reset]
                fpos = torch.where(reset, pos, fpos)
                x0, y0 = xf.long(), yf.long()
                move = in_map & ((x0 != fx) | (y0 != fy))
                dx, dy = x0 - fx, y0 - fy
                nw = torch.zeros_like(w)
                for s in range(4):
                    sx, sy = s % 2 + dx, s // 2 + dy
                    ok = (sx >= 0) & (sx <= 1) & (sy >= 0) & (sy <= 1)
                    src = (sy.clamp(0, 1) * 2 + sx.clamp(0, 1))[:, None]
                    nw[:, s] = torch.where(ok, w.gather(1, src)[:, 0], 0.0)
                for s in range(4):
                    nx, ny = s % 2 - dx, s // 2 - dy
                    flush(move & ((nx < 0) | (nx > 1) | (ny < 0) | (ny > 1)),
                          s)
                w = torch.where(move[:, None], nw, w)
                fx, fy = torch.where(move, x0, fx), torch.where(move, y0, fy)
                wx1, wy1 = x[:, d] - xf, y[:, d] - yf
                for s in range(4):
                    cx, cy = s % 2, s // 2
                    xi, yi = x0 + cx, y0 + cy
                    inb = in_map & (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
                    ws = ((wy1 if cy else 1.0 - wy1)
                          * (wx1 if cx else 1.0 - wx1) * g[:, d])
                    w[:, s] += torch.where(inb, ws, 0.0)
            for s in range(4):
                flush(torch.ones(hw, dtype=torch.bool, device=dev), s)
    return out.reshape(B, V, H, W, C), reductions


def sweep_grad_src(d_center: torch.Tensor, ref_feat: torch.Tensor,
                   gbar: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                   is_valid: torch.Tensor, intM: torch.Tensor,
                   rays2d: torch.Tensor) -> torch.Tensor:
    """The gradient with the arguments of ``sweep_grad_src_ref``. CPU tensors
    take the plain version; CUDA tensors launch the kernel on the current
    stream through ``ops.sweep_grad_src``: ``ref_feat`` f32 or bf16 with
    at most 128 channels; the depths, the cotangent and the geometry are
    passed in f32."""
    if ref_feat.device.type == "cpu":
        return sweep_grad_src_ref(d_center, ref_feat, gbar, R, t, is_valid,
                                  intM, rays2d)
    if ref_feat.device.type != "cuda":
        raise ValueError(f"sweep_grad_src: unsupported device "
                         f"{ref_feat.device}")
    dev, mdt, f32 = ref_feat.device, ref_feat.dtype, torch.float32
    if mdt not in _DTYPES:
        raise ValueError(f"sweep_grad_src: unsupported dtype {mdt}")
    if ref_feat.dim() != 4 or R.dim() != 4 or d_center.dim() != 1:
        raise ValueError("sweep_grad_src: ref_feat must be (B, H, W, C), R "
                         "(B, V, 3, 3) and d_center (D,)")
    B, H, W, C = ref_feat.shape
    V, D = R.shape[1], d_center.shape[0]
    if C > MAX_C:
        raise ValueError(f"sweep_grad_src: C={C} is over {MAX_C}")

    def need(x, name, shape):
        return cvk._need(x, name, shape, f32, dev, "sweep_grad_src")

    depth = need(d_center, "d_center", (D,))
    ref = ref_feat.contiguous()
    g = need(gbar, "gbar", (B, H, W, D))
    Rc = need(R, "R", (B, V, 3, 3))
    tc = need(t, "t", (B, V, 3))
    valid = need(is_valid, "is_valid", (B, V))
    K = need(intM, "intM", (B, 3, 3))
    rays = need(rays2d, "rays2d", (B, 3, H * W))
    return OPS.sweep_grad_src(depth, ref, g, Rc, tc, valid, K, rays)


sweep_grad_src.launches = 0
