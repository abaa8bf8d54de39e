"""PSM-Net residual blocks with folded eval BatchNorm, NHWC.

The port of three TPU kernels of the F-Net:

* ``magnet_tpu/kernels/psmstage_pallas.py::fused_residual_stage``: a chain
  of stride-1 BasicBlocks (conv3x3-BN-ReLU, conv3x3-BN, + input; no
  activation after the sum), or with ``residual=False`` the stem's chain of
  conv3x3-BN-ReLU layers;
* ``magnet_tpu/kernels/psmtrans_pallas.py::downsample_block``: a BasicBlock
  whose first conv has stride 2 and whose shortcut is a stride-2 1x1
  conv-BN projection (layer2's first block, 32 -> 64 channels);
* ``magnet_tpu/kernels/psmtrans2_pallas.py::expand_block``: the same at
  stride 1 (layer3's first block, 64 -> 128 channels).

One CUDA kernel (``csrc/psm_conv.cu``) serves the three: an implicit GEMM
for one conv (3x3 with a stride and a dilation, or the 1x1 projection) whose
epilogue applies ``acc * scale + shift`` in f32 and then the ReLU or the
residual add, rounding once. A chain of n convs is n launches, a transition
block three (first conv, projection, second conv + projection); the maps in
between go through device memory. Where the TPU transition kernels add the
projection in f32, here it rounds to the compute type first, as the
reference's unfused form does. Bounded by tensor-core operations on an H100;
see the source note.

Each wrapper runs its plain version (``*_ref``) for tensors on the CPU and
launches the kernel for tensors on a CUDA device, or raises. Each counts its
own launches.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from magnet_tpu_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _conv_ref(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
              shift: torch.Tensor, stride: int, dil: int, relu: bool,
              res: Optional[torch.Tensor], counter=None) -> torch.Tensor:
    """Plain version of one conv. x: (N, H, W, Ci); w: (k, k, Ci, Co) HWIO,
    k = 3 (padding = dil) or 1; scale, shift: (Co,) f32; res: (N, Ho, Wo,
    Co) or None. Computes in f32 and returns x.dtype."""
    f32 = torch.float32
    k = w.shape[0]
    acc = F.conv2d(x.permute(0, 3, 1, 2).to(f32),
                   w.permute(3, 2, 0, 1).to(f32), stride=stride,
                   padding=dil if k == 3 else 0, dilation=dil)
    y = acc * scale.to(f32)[:, None, None] + shift.to(f32)[:, None, None]
    if res is not None:
        y = y + res.permute(0, 3, 1, 2).to(f32)
    if relu:
        y = F.relu(y)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want "
                         f"{tuple(shape)}")
    if t.dtype != dtype or t.device != device:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, "
                         f"want {dtype} on {device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def _conv_cuda(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               shift: torch.Tensor, stride: int, dil: int, relu: bool,
               res: Optional[torch.Tensor], counter) -> torch.Tensor:
    """One launch of the conv kernel with the arguments of ``_conv_ref``;
    adds one to ``counter.launches``."""
    dt, dev = x.dtype, x.device
    if dt not in _DTYPES:
        raise ValueError(f"psm conv: unsupported dtype {dt}")
    N, H, W, Ci = x.shape
    k, Co = w.shape[0], w.shape[-1]
    vec = 16 // x.element_size()
    if k not in (1, 3) or stride not in (1, 2) or dil < 1:
        raise ValueError(f"psm conv: window {k}, stride {stride}, "
                         f"dilation {dil}")
    if Ci % vec or Co % vec:
        raise ValueError(f"psm conv: channels ({Ci}, {Co}) must be multiples "
                         f"of {vec}")
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    _check(x, "x", (N, H, W, Ci), dt, dev)
    _check(w, "w", (k, k, Ci, Co), dt, dev)
    _check(scale, "scale", (Co,), torch.float32, dev)
    _check(shift, "shift", (Co,), torch.float32, dev)
    if res is not None:
        _check(res, "res", (N, Ho, Wo, Co), dt, dev)
    out = torch.empty((N, Ho, Wo, Co), dtype=dt, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.mt_psm_conv(
            _DTYPES[dt], x.data_ptr(), None, None, w.data_ptr(),
            scale.data_ptr(), shift.data_ptr(),
            res.data_ptr() if res is not None else None, out.data_ptr(),
            N, H, W, Ci, 0, 0, Co, k * k, stride, dil, int(relu),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "psm conv")
    counter.launches += 1
    return out


def _conv_for(x: torch.Tensor, what: str) -> Callable:
    if x.device.type == "cpu":
        return _conv_ref
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return _conv_cuda


def _stage(conv, counter, x, weights, scales, shifts, dilation, residual):
    n = weights.shape[0]
    if n % 2:
        raise ValueError("fused_residual_stage: the convs come in pairs")
    for i in range(0, n, 2):
        mid = conv(x, weights[i], scales[i], shifts[i], 1, dilation, True,
                   None, counter)
        x = conv(mid, weights[i + 1], scales[i + 1], shifts[i + 1], 1,
                 dilation, not residual, x if residual else None, counter)
    return x


def _transition(conv, counter, stride, x, w1, s1, t1, w2, s2, t2, wp, sp,
                tp):
    mid = conv(x, w1, s1, t1, stride, 1, True, None, counter)
    short = conv(x, wp, sp, tp, stride, 1, False, None, counter)
    return conv(mid, w2, s2, t2, 1, 1, False, short, counter)


def fused_residual_stage_ref(x: torch.Tensor, weights: torch.Tensor,
                             scales: torch.Tensor, shifts: torch.Tensor,
                             dilation: int = 1,
                             residual: bool = True) -> torch.Tensor:
    """Plain version. x: (N, H, W, C); weights: (n_convs, 3, 3, C, C) HWIO;
    scales, shifts: (n_convs, C) f32 folded BN. Convs 2i and 2i+1 are one
    BasicBlock: relu(bn(conv(x))), then bn(conv(.)) + x. residual=False:
    every conv is conv-BN-ReLU. Activations round to x.dtype after each
    conv's epilogue, which is computed in f32."""
    return _stage(_conv_ref, None, x, weights, scales, shifts, dilation,
                  residual)


def fused_residual_stage(x: torch.Tensor, weights: torch.Tensor,
                         scales: torch.Tensor, shifts: torch.Tensor,
                         dilation: int = 1,
                         residual: bool = True) -> torch.Tensor:
    """The chain with the arguments of ``fused_residual_stage_ref``: one
    kernel launch per conv on a CUDA tensor (f32 or bf16, C a multiple of
    16 bytes)."""
    return _stage(_conv_for(x, "fused_residual_stage"), fused_residual_stage,
                  x, weights, scales, shifts, dilation, residual)


def downsample_block_ref(x, w1, s1, t1, w2, s2, t2, wp, sp, tp):
    """Plain version. x: (N, H, W, Ci); w1: (3, 3, Ci, Co), stride 2; w2:
    (3, 3, Co, Co); wp: (1, 1, Ci, Co), stride 2; s*, t*: (Co,) f32 folded
    BN. Returns bn(conv2(relu(bn(conv1(x))))) + bn(proj(x)), (N, H/2, W/2,
    Co); the projection rounds to x.dtype before the sum."""
    return _transition(_conv_ref, None, 2, x, w1, s1, t1, w2, s2, t2, wp,
                       sp, tp)


def downsample_block(x, w1, s1, t1, w2, s2, t2, wp, sp, tp):
    """The stride-2 transition block with the arguments of
    ``downsample_block_ref``: three kernel launches on a CUDA tensor."""
    return _transition(_conv_for(x, "downsample_block"), downsample_block, 2,
                       x, w1, s1, t1, w2, s2, t2, wp, sp, tp)


def expand_block_ref(x, w1, s1, t1, w2, s2, t2, wp, sp, tp):
    """Plain version: ``downsample_block_ref`` at stride 1, (N, H, W, Co)."""
    return _transition(_conv_ref, None, 1, x, w1, s1, t1, w2, s2, t2, wp,
                       sp, tp)


def expand_block(x, w1, s1, t1, w2, s2, t2, wp, sp, tp):
    """The stride-1 transition block with the arguments of
    ``expand_block_ref``: three kernel launches on a CUDA tensor."""
    return _transition(_conv_for(x, "expand_block"), expand_block, 1, x, w1,
                       s1, t1, w2, s2, t2, wp, sp, tp)


fused_residual_stage.launches = 0
downsample_block.launches = 0
expand_block.launches = 0
