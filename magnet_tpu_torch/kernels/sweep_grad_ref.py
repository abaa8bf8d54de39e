"""Gradient of the plane-sweep cost with respect to the reference features.

The backward of the F-Net training sweep that the JAX package leaves to XLA
(the custom VJP of ``magnet_tpu/ops/costvolume.py::cost_volume_sweep``
re-gathers the source features; no TPU kernel computes it): for every
reference pixel q,

    grad_ref[b, q, :] = sum over v and d of
        gbar[b, q, d] * valid[b, v] * bilinear(src[b, v], proj(q, d)),

the candidate at sweep depth d projected into view v in f32
(``cost_volume_cw.project``), the view's feature sampled bilinearly with
zeros outside the map.

``sweep_grad_ref_ref`` is the plain PyTorch version (the re-gather, chunked
over D so that its transient stays bounded). ``sweep_grad_ref`` runs it for
tensors on the CPU and launches the CUDA kernel (``mt_sweep_grad_ref``, the
second entry point of ``csrc/cost_volume_cw.cu``) for tensors on a CUDA
device, or raises. The kernel runs on the cost volume kernel's 8 x 8 tiles,
plan and staged source windows, so it sees the forward's samples and
corners; the plan stages C channels a pixel (``cost_volume_cw_plan`` with
``extra=0`` replays it). Each reference pixel's sums stay in its lanes'
registers, in a fixed order: two calls are equal bit for bit.
"""

from __future__ import annotations

import torch

from magnet_tpu_torch.kernels import cost_volume_cw as cvk
from magnet_tpu_torch.kernels.ops import OPS
from magnet_tpu_torch.ops.resample import bilinear_gather

# bound on the plain version's per-chunk transient (the four sampled
# corners and their blend for one (batch, view) pair)
CHUNK_BYTES = 1 << 30


def sweep_grad_ref_ref(d_center: torch.Tensor, src_feat: torch.Tensor,
                       gbar: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                       is_valid: torch.Tensor, intM: torch.Tensor,
                       rays2d: torch.Tensor) -> torch.Tensor:
    """Plain version. d_center: (D,) sweep depths; src_feat: (B, V, H, W,
    C); gbar: (B, H, W, D), the cotangent of the pre-softmax cost summed
    over the views; R: (B, V, 3, 3); t: (B, V, 3); is_valid: (B, V); intM:
    (B, 3, 3); rays2d: (B, 3, H*W). Returns (B, H, W, C) f32."""
    f32 = torch.float32
    B, V, H, W, C = src_feat.shape
    D, hw = d_center.shape[0], H * W
    chunk = max(1, min(D, CHUNK_BYTES // (6 * hw * C * 4)))
    out = torch.zeros((B, hw, C), dtype=f32, device=src_feat.device)
    for b in range(B):
        g_b = gbar[b].reshape(hw, D).to(f32)
        for v in range(V):
            for d0 in range(0, D, chunk):
                dc = d_center[d0:d0 + chunk].to(f32)
                x, y, _ = cvk.project(intM[b].to(f32), R[b, v].to(f32),
                                      t[b, v].to(f32), rays2d[b].to(f32),
                                      dc.expand(hw, -1), H, W)
                sampled = bilinear_gather(src_feat[b, v], x, y)  # (hw, d, C)
                g = g_b[:, d0:d0 + chunk] * is_valid[b, v].to(f32)
                out[b] += torch.bmm(g[:, None, :], sampled)[:, 0]
    return out.reshape(B, H, W, C)


def sweep_grad_ref(d_center: torch.Tensor, src_feat: torch.Tensor,
                   gbar: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                   is_valid: torch.Tensor, intM: torch.Tensor,
                   rays2d: torch.Tensor) -> torch.Tensor:
    """The gradient with the arguments of ``sweep_grad_ref_ref``. CPU
    tensors take the plain version; CUDA tensors launch the kernel on the
    current stream through ``ops.sweep_grad_ref``: ``src_feat`` f32 or bf16
    with C a multiple of 16 bytes and at most 128, D at most 256 (and V x D
    within the block's shared memory, else the launch raises); the depths,
    the cotangent and the geometry are passed in f32."""
    if src_feat.device.type == "cpu":
        return sweep_grad_ref_ref(d_center, src_feat, gbar, R, t, is_valid,
                                  intM, rays2d)
    if src_feat.device.type != "cuda":
        raise ValueError(f"sweep_grad_ref: unsupported device "
                         f"{src_feat.device}")
    dev, mdt, f32 = src_feat.device, src_feat.dtype, torch.float32
    if mdt not in cvk._DTYPES:
        raise ValueError(f"sweep_grad_ref: unsupported dtype {mdt}")
    if src_feat.dim() != 5 or d_center.dim() != 1:
        raise ValueError("sweep_grad_ref: src_feat must be (B, V, H, W, C) "
                         "and d_center (D,)")
    B, V, H, W, C = src_feat.shape
    D = d_center.shape[0]
    if C % (16 // src_feat.element_size()) or C > cvk.MAX_C:
        raise ValueError(f"sweep_grad_ref: C={C} must be a multiple of 16 "
                         f"bytes and at most {cvk.MAX_C}")
    if D > cvk.MAX_D:
        raise ValueError(f"sweep_grad_ref: D={D} is over {cvk.MAX_D}")

    def need(x, name, shape):
        return cvk._need(x, name, shape, f32, dev, "sweep_grad_ref")

    return OPS.sweep_grad_ref(
        need(d_center, "d_center", (D,)), src_feat.contiguous(),
        need(gbar, "gbar", (B, H, W, D)), need(R, "R", (B, V, 3, 3)),
        need(t, "t", (B, V, 3)), need(is_valid, "is_valid", (B, V)),
        need(intM, "intM", (B, 3, 3)), need(rays2d, "rays2d", (B, 3, H * W)))


sweep_grad_ref.launches = 0
