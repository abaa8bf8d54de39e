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

One CUDA kernel (``csrc/psm_conv.cu``) serves the three: one conv (3x3
with a stride and a dilation, or the 1x1 projection) whose epilogue applies
``acc * scale + shift`` in f32 and then the ReLU or the residual add,
rounding once. A chain of n convs is n launches, a transition block three
(first conv, projection, second conv + projection); the maps in between go
through device memory. Where the TPU transition kernels add the projection
in f32, here it rounds to the compute type first, as the reference's
unfused form does. Bounded by tensor-core operations on an H100; see the
source note.

bf16 runs the Hopper kernel (``csrc/hopper_conv.cuh``), which reads each
conv's weights in the layout of ``pack_weights``: K blocks of ``k_block``
input channels, the output channels padded to ``n_block``. Callers that run
a conv more than once (``nn.psmnet.PSMNet``) pack once and pass ``packed``;
else each call packs. f32 runs an FMA implicit GEMM on HWIO weights.

Each wrapper runs its plain version (``*_ref``) for tensors on the CPU and
launches the kernel for tensors on a CUDA device, or raises. Each counts its
own launches.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from magnet_tpu_torch.kernels.ops import OPS

N_BLOCKS = (32, 64, 128)   # the bf16 kernel's output widths (wgmma N)


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def k_block(ci: int) -> int:
    """Input channels per K block of the bf16 kernel: 32-channel inputs in
    the 64-byte swizzle layout rather than 64 with 32 zeros, which would
    double the MMA work of the convs near the ridge; 64 otherwise."""
    return 32 if ci <= 32 else 64


def n_block(co: int) -> int:
    """The bf16 kernel's output width (wgmma N) for Co output channels; it
    runs blocks of 128 where Co is wider."""
    return next((n for n in N_BLOCKS if co <= n), N_BLOCKS[-1])


def packed_shape(k: int, ci: int, co: int, kb: Optional[int] = None,
                 n_pad: Optional[int] = None) -> tuple:
    """Shape of ``pack_weights``' result for a (k, k, ci, co) weight."""
    kb = kb or k_block(ci)
    return (_ceil(ci, kb) // kb, k * k, n_pad or _ceil(co, n_block(co)), kb)


def swizzle_rows(t: torch.Tensor) -> torch.Tensor:
    """t (..., R, kb), R a multiple of 8, kb 64 or 32, with the 16-byte chunk
    c of row r moved to chunk c ^ (r % 8) (kb 64: the 128-byte swizzle) or
    c ^ ((r // 2) % 4) (kb 32: the 64-byte swizzle); its own inverse."""
    kb = t.shape[-1]
    j = torch.arange(kb)
    phase = [r % 8 if kb == 64 else (r // 2) % 4 for r in range(8)]
    idx = torch.stack([((j // 8) ^ p) * 8 + j % 8 for p in phase])
    idx = idx.repeat(t.shape[-2] // 8, 1).to(t.device)
    return torch.gather(t, -1, idx.expand(t.shape))


def pack_weights(w: torch.Tensor, kb: Optional[int] = None,
                 n_pad: Optional[int] = None) -> torch.Tensor:
    """HWIO weights (k, k, Ci, Co) in the layout the bf16 kernel reads:
    (K blocks, k * k taps, Co padded to ``n_pad`` (default: a multiple of
    ``n_block``), ``kb`` (default ``k_block``)). Slab [b, t] holds, for
    every output n (a row of 2 kb bytes), the weights of input channels
    [kb b, kb b + kb) at tap t = k kh + kw, its 16-byte chunks swizzled
    (``swizzle_rows``), so that each slab is one wgmma B operand. Padding
    is zero."""
    k, _, ci, co = w.shape
    nkb, taps, npad, kb = packed_shape(k, ci, co, kb, n_pad)
    t = F.pad(w, (0, npad - co, 0, nkb * kb - ci))
    t = t.reshape(taps, nkb, kb, npad).permute(1, 0, 3, 2)
    return swizzle_rows(t).contiguous()


def unpack_weights(packed: torch.Tensor, k: int, ci: int,
                   co: int) -> torch.Tensor:
    """The HWIO (k, k, ci, co) weight that ``pack_weights`` packed."""
    nkb, taps, npad, kb = packed.shape
    t = swizzle_rows(packed).permute(1, 0, 3, 2).reshape(k, k, nkb * kb, npad)
    return t[:, :, :ci, :co].contiguous()


def _conv_ref(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
              shift: torch.Tensor, stride: int, dil: int, relu: bool,
              res: Optional[torch.Tensor], counter=None,
              packed=None) -> torch.Tensor:
    """Plain version of one conv. x: (N, H, W, Ci); w: (k, k, Ci, Co) HWIO,
    k = 3 (padding = dil) or 1; scale, shift: (Co,) f32; res: (N, Ho, Wo,
    Co) or None. Computes in f32 and returns x.dtype. ``counter`` and
    ``packed`` are the kernel's."""
    def f32(t):
        # no cast where there is none to make: a traced program
        # (serve/export.py) would record one
        return t if t.dtype == torch.float32 else t.float()
    k = w.shape[0]
    acc = F.conv2d(f32(x.permute(0, 3, 1, 2)), f32(w.permute(3, 2, 0, 1)),
                   stride=stride, padding=dil if k == 3 else 0, dilation=dil)
    y = acc * f32(scale)[:, None, None] + f32(shift)[:, None, None]
    if res is not None:
        y = y + f32(res.permute(0, 3, 1, 2))
    if relu:
        y = F.relu(y)
    y = y.permute(0, 2, 3, 1)
    return (y if x.dtype == torch.float32 else y.to(x.dtype)).contiguous()


def _conv_cuda(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               shift: torch.Tensor, stride: int, dil: int, relu: bool,
               res: Optional[torch.Tensor], counter: str,
               packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the conv kernel (``ops.psm_conv``) with the arguments
    of ``_conv_ref``; adds one to the ``launches`` of the wrapper named
    ``counter`` (``fused_residual_stage``, ``downsample_block`` or
    ``expand_block``). bf16 reads ``packed`` (``pack_weights(w)``; packed
    here when None)."""
    wk = w
    if x.dtype == torch.bfloat16:
        wk = pack_weights(w) if packed is None else packed
    return OPS.psm_conv(x, wk, scale, shift, res, w.shape[0], stride, dil,
                        relu, counter)


def _conv_for(x: torch.Tensor, what: str) -> Callable:
    if x.device.type == "cpu":
        return _conv_ref
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return _conv_cuda


def _stage(conv, counter, x, weights, scales, shifts, dilation, residual,
           packed=None):
    n = weights.shape[0]
    if n % 2:
        raise ValueError("fused_residual_stage: the convs come in pairs")
    p = list(packed) if packed is not None else [None] * n
    if len(p) != n:
        raise ValueError(f"fused_residual_stage: {len(p)} packed weights "
                         f"for {n} convs")
    for i in range(0, n, 2):
        mid = conv(x, weights[i], scales[i], shifts[i], 1, dilation, True,
                   None, counter, p[i])
        x = conv(mid, weights[i + 1], scales[i + 1], shifts[i + 1], 1,
                 dilation, not residual, x if residual else None, counter,
                 p[i + 1])
    return x


def _transition(conv, counter, stride, x, w1, s1, t1, w2, s2, t2, wp, sp,
                tp, packed=None):
    p1, p2, pp = packed if packed is not None else (None,) * 3
    mid = conv(x, w1, s1, t1, stride, 1, True, None, counter, p1)
    short = conv(x, wp, sp, tp, stride, 1, False, None, counter, pp)
    return conv(mid, w2, s2, t2, 1, 1, False, short, counter, p2)


def pack_chain(weights: Sequence[torch.Tensor]) -> list:
    """``pack_weights`` of each conv of a chain (the ``packed`` of
    ``fused_residual_stage``) or of a transition block's (w1, w2, wp)."""
    return [pack_weights(w) for w in weights]


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
                         dilation: int = 1, residual: bool = True,
                         packed: Optional[Sequence[torch.Tensor]] = None
                         ) -> torch.Tensor:
    """The chain with the arguments of ``fused_residual_stage_ref``: one
    kernel launch per conv on a CUDA tensor (f32 or bf16, C a multiple of
    16 bytes). ``packed``: ``pack_chain(weights)``, made once by the caller
    (read in bf16 on a CUDA device; packed here when None)."""
    return _stage(_conv_for(x, "fused_residual_stage"),
                  "fused_residual_stage", x, weights, scales, shifts,
                  dilation, residual, packed)


def downsample_block_ref(x, w1, s1, t1, w2, s2, t2, wp, sp, tp):
    """Plain version. x: (N, H, W, Ci); w1: (3, 3, Ci, Co), stride 2; w2:
    (3, 3, Co, Co); wp: (1, 1, Ci, Co), stride 2; s*, t*: (Co,) f32 folded
    BN. Returns bn(conv2(relu(bn(conv1(x))))) + bn(proj(x)), (N, H/2, W/2,
    Co); the projection rounds to x.dtype before the sum."""
    return _transition(_conv_ref, None, 2, x, w1, s1, t1, w2, s2, t2, wp,
                       sp, tp)


def downsample_block(x, w1, s1, t1, w2, s2, t2, wp, sp, tp, packed=None):
    """The stride-2 transition block with the arguments of
    ``downsample_block_ref``: three kernel launches on a CUDA tensor.
    ``packed``: ``pack_chain((w1, w2, wp))`` or None."""
    return _transition(_conv_for(x, "downsample_block"), "downsample_block",
                       2, x, w1, s1, t1, w2, s2, t2, wp, sp, tp, packed)


def expand_block_ref(x, w1, s1, t1, w2, s2, t2, wp, sp, tp):
    """Plain version: ``downsample_block_ref`` at stride 1, (N, H, W, Co)."""
    return _transition(_conv_ref, None, 1, x, w1, s1, t1, w2, s2, t2, wp,
                       sp, tp)


def expand_block(x, w1, s1, t1, w2, s2, t2, wp, sp, tp, packed=None):
    """The stride-1 transition block with the arguments of
    ``expand_block_ref``: three kernel launches on a CUDA tensor.
    ``packed``: ``pack_chain((w1, w2, wp))`` or None."""
    return _transition(_conv_for(x, "expand_block"), "expand_block", 1, x, w1,
                       s1, t1, w2, s2, t2, wp, sp, tp, packed)


fused_residual_stage.launches = 0
downsample_block.launches = 0
expand_block.launches = 0
