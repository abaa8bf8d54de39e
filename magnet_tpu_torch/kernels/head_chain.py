"""Fused prediction-head chain: one SAME 3x3 conv C0 -> 128, then 1x1 convs,
each with a bias and an optional ReLU, NHWC.

The port of ``magnet_tpu/kernels/headchain_pallas.py::head_chain_pallas``:
the D-Net depth and mask heads, the 4-conv MaGNet mask head and G-Net's
``conv0_feat`` (one conv). The CUDA kernel (``csrc/head_chain.cu``) keeps
the hidden 128-channel tiles on chip, as the TPU kernel kept them in VMEM,
and writes only the last layer's channels. Bounded by tensor-core
operations on an H100 (the 3x3 conv dominates); see the source note.

The kernel reads the weights and biases that ``head_operands`` prepares:
in bf16 packed (``pack_head``: the 3x3 in 64-channel K blocks, each 1x1 in
two, the last one's columns padded to 128), in f32 as (K, N) matrices.
Callers that run a head more than once keep them (``nn.densedepth.
run_head``, ``nn.gnet.GNet``) and pass ``operands``; else each call makes
them.

``head_chain_ref`` is the plain PyTorch version. ``head_chain`` runs it for
tensors on the CPU and launches the kernel for tensors on a CUDA device, or
raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from magnet_tpu_torch.kernels.ops import OPS
from magnet_tpu_torch.kernels.psm_blocks import (pack_weights,
                                                 packed_shape)

HIDDEN = 128
MAX_OUT = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# (kernel HWIO (kh, kw, ci, co), bias (co,) or None, relu)
Layer = Tuple[torch.Tensor, Optional[torch.Tensor], bool]


def head_chain_ref(x: torch.Tensor, convs: Sequence[Layer]) -> torch.Tensor:
    """Plain version. x: (N, H, W, C0); the first conv is 3x3 (padding 1),
    the rest 1x1. The hidden activations round to x.dtype between layers,
    as the kernel's do; each conv accumulates in f32."""
    f32 = torch.float32
    y = x.permute(0, 3, 1, 2)
    for i, (k, b, relu) in enumerate(convs):
        y = F.conv2d(y.to(f32), k.permute(3, 2, 0, 1).to(f32),
                     None if b is None else b.to(f32),
                     padding=1 if i == 0 else 0)
        if relu:
            y = F.relu(y)
        y = y.to(x.dtype)
    return y.permute(0, 2, 3, 1).contiguous()


def _pad_cols(t: torch.Tensor, n: int) -> torch.Tensor:
    if t.shape[-1] == n:
        return t.contiguous()
    return F.pad(t, (0, n - t.shape[-1])).contiguous()


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def pack_head(convs: Sequence[Layer]) -> list:
    """The bf16 kernel's weights of a chain (``psm_blocks.pack_weights``
    with 64-channel K blocks): the 3x3 (K blocks of C0, 9, 128, 64), each
    hidden 1x1 (2, 1, 128, 64), the last 1x1 (2, 1, c_out padded to 128,
    64), which the kernel reads in column chunks of 128."""
    return [pack_weights(k, kb=64, n_pad=_ceil(k.shape[-1], HIDDEN))
            for k, _, _ in convs]


def _check_convs(convs: Sequence[Layer], c0: int, dt, dev) -> None:
    n = len(convs)
    if not 1 <= n <= 4:
        raise ValueError(f"head_chain: {n} convs, the kernel takes 1 to 4")
    for i, (k, b, _) in enumerate(convs):
        ksz, cin = (3, c0) if i == 0 else (1, HIDDEN)
        co = k.shape[-1]
        bad_width = co > MAX_OUT if 0 < i == n - 1 else co != HIDDEN
        if tuple(k.shape[:3]) != (ksz, ksz, cin) or bad_width:
            raise ValueError(f"head_chain: conv {i} has shape "
                             f"{tuple(k.shape)}")
        if k.dtype != dt or k.device != dev:
            raise ValueError(f"head_chain: conv {i} is {k.dtype} on "
                             f"{k.device}, want {dt} on {dev}")
        if b is not None and (tuple(b.shape) != (co,) or b.device != dev):
            raise ValueError(f"head_chain: bias {i} must be ({co},) on {dev}")


def head_operands(convs: Sequence[Layer]) -> Tuple[list, list]:
    """(weights, biases) of the chain as the kernel reads them, in the
    weights' dtype: bf16 weights ``pack_head``'s, biases f32 zero padded to
    the packed widths; f32 weights (9 C0, 128) and (128, pad16(width)),
    biases padded to pad16(width)."""
    bf16 = convs[0][0].dtype == torch.bfloat16
    ws = pack_head(convs) if bf16 else []
    bs = []
    for k, b, _ in convs:
        co = k.shape[-1]
        pad = _ceil(co, HIDDEN if bf16 else 16)
        if not bf16:
            ws.append(_pad_cols(k.reshape(-1, co), pad))
        bias = (torch.zeros(co, dtype=torch.float32, device=k.device)
                if b is None else b.to(torch.float32))
        bs.append(_pad_cols(bias, pad))
    return ws, bs


def head_chain(x: torch.Tensor, convs: Sequence[Layer],
               operands: Optional[Tuple[list, list]] = None) -> torch.Tensor:
    """The head chain with the arguments of ``head_chain_ref``. CPU tensors
    take the plain version; CUDA tensors (f32 or bf16) launch the kernel on
    the current stream through ``ops.head_chain``. The kernel takes 1 to 4
    convs: 3x3 C0 -> 128, then 1x1 128 -> 128, the last 1x1 128 -> c_out <=
    256. ``operands``:
    ``head_operands(convs)``, made once by the caller (made here when
    None)."""
    if x.device.type == "cpu":
        return head_chain_ref(x, convs)
    if x.device.type != "cuda":
        raise ValueError(f"head_chain: unsupported device {x.device}")
    dt, dev = x.dtype, x.device
    if dt not in _DTYPES:
        raise ValueError(f"head_chain: unsupported dtype {dt}")
    if x.dim() != 4:
        raise ValueError("head_chain: x must be (N, H, W, C)")
    N, H, W, C0 = x.shape
    if C0 % (16 // x.element_size()):
        raise ValueError(f"head_chain: C0={C0} not a multiple of 16 bytes")
    _check_convs(convs, C0, dt, dev)
    ws, bs = head_operands(convs) if operands is None else operands
    for (k, _, _), w, bias in zip(convs, ws, bs):
        want = (packed_shape(k.shape[0], k.shape[2], k.shape[3], 64,
                             _ceil(k.shape[3], HIDDEN))
                if dt == torch.bfloat16 else
                (k[..., 0].numel(), _ceil(k.shape[3], 16)))
        if (tuple(w.shape) != want or w.dtype != dt or w.device != dev
                or not w.is_contiguous() or bias.dtype != torch.float32
                or tuple(bias.shape) != (want[2] if len(want) == 4
                                         else want[1],)):
            raise ValueError(f"head_chain: operands {tuple(w.shape)} "
                             f"{w.dtype}, want {want} {dt}")
    relu_mask = sum(int(bool(r)) << i for i, (_, _, r) in enumerate(convs))
    return OPS.head_chain(x, ws, bs, convs[-1][0].shape[-1], relu_mask)


head_chain.launches = 0
