"""G-Net update in one launch, NHWC.

The port of ``magnet_tpu/kernels/gnet_pallas.py::gnet_update_pallas``: a SAME
3x3 conv over the D-channel cost volume into 128 channels plus the
precomputed feature term, ReLU; two 1x1 convs 128 -> 128 with bias and ReLU;
a 1x1 conv to 2; then ``mu = mu0 + mu1 * sigma0`` and
``sigma = (elu(sigma1) + 1 + 1e-10) * sigma0`` in f32. The CUDA kernel
(``csrc/gnet_update.cu``) keeps the hidden tiles on the chip and writes only
the 2 output channels. In bf16 it runs layers 0-2 on the tensor cores from
weights resident in shared memory, packed once by ``gnet_operands``
(the caller keeps them); it gathers the cost volume with 2-byte loads, so D
need not be a multiple of 16 bytes and nothing is padded. Bounded by bytes
on an H100; see the source note.

``gnet_update_ref`` is the plain PyTorch version. ``gnet_update`` runs it for
tensors on the CPU and launches the kernel for tensors on a CUDA device, or
raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from magnet_tpu_torch.kernels.ops import OPS
from magnet_tpu_torch.kernels.psm_blocks import pack_weights, packed_shape

HIDDEN = 128
MAX_D = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# (kernel HWIO, bias (co,) or None): conv0_cv (3, 3, D, 128) without bias,
# conv1 and conv2 (1, 1, 128, 128), conv3 (1, 1, 128, 2).
Layer = Tuple[torch.Tensor, Optional[torch.Tensor]]
# (weights [w0, w1, w2, w3], f32 biases [b1, b2, b3]) as the kernel reads
# them: ``gnet_operands``
Operands = Tuple[list, list]


def gnet_update_ref(cv: torch.Tensor, feat_contrib: torch.Tensor,
                    prev: torch.Tensor, convs: Sequence[Layer]
                    ) -> torch.Tensor:
    """Plain version. cv: (B, H, W, D); feat_contrib: (B, H, W, 128); prev:
    (B, H, W, 2) = (mu0, sigma0), all of one dtype; returns (B, H, W, 2) in
    that dtype. Each conv accumulates in f32; the hidden activations round
    to the dtype between layers, as the kernel's do; the last layer's output
    and the update stay f32."""
    f32, dt = torch.float32, feat_contrib.dtype
    (w0, _), (w1, b1), (w2, b2), (w3, b3) = convs

    def conv(x, w, b, pad):
        return F.conv2d(x.to(f32), w.permute(3, 2, 0, 1).to(f32),
                        None if b is None else b.to(f32), padding=pad)

    y = conv(cv.to(dt).permute(0, 3, 1, 2), w0, None, 1)
    y = F.relu(y + feat_contrib.permute(0, 3, 1, 2).to(f32)).to(dt)
    y = F.relu(conv(y, w1, b1, 0)).to(dt)
    y = F.relu(conv(y, w2, b2, 0)).to(dt)
    y = conv(y, w3, b3, 0).permute(0, 2, 3, 1)
    mu0, sigma0 = prev[..., 0:1].to(f32), prev[..., 1:2].to(f32)
    mu = mu0 + y[..., 0:1] * sigma0
    sigma = (F.elu(y[..., 1:2]) + 1.0 + 1e-10) * sigma0
    return torch.cat([mu, sigma], -1).to(prev.dtype)


def cudnn_gnet(cv: torch.Tensor, feat_contrib: torch.Tensor,
               prev: torch.Tensor, convs: Sequence[Layer]):
    """A yardstick, called by the profilers and never by the port: a call
    that runs the update (``gnet_update_ref``'s arguments, bf16) as bf16
    library convs and elementwise ops, channels-last."""
    bf = torch.bfloat16
    oihw = [k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            for k, _ in convs]
    bias = [None] + [b.to(bf) for _, b in convs[1:]]
    xin, fin, pin = (t.permute(0, 3, 1, 2) for t in (cv, feat_contrib, prev))

    def chain():
        y = F.relu(F.conv2d(xin, oihw[0], None, 1, 1) + fin)
        for i in (1, 2):
            y = F.relu(F.conv2d(y, oihw[i], bias[i]))
        y = F.conv2d(y, oihw[3], bias[3])
        mu = pin[:, :1] + y[:, :1] * pin[:, 1:]
        return torch.cat([mu, (F.elu(y[:, 1:]) + 1.0) * pin[:, 1:]], 1)
    return chain


def _shapes(D: int) -> tuple:
    return ((3, 3, D, HIDDEN), (1, 1, HIDDEN, HIDDEN),
            (1, 1, HIDDEN, HIDDEN), (1, 1, HIDDEN, 2))


def operand_shapes(D: int, dtype: torch.dtype) -> list:
    """The shapes of ``gnet_operands``' weights at D candidates."""
    if dtype == torch.bfloat16:
        return [packed_shape(1, 9 * D, HIDDEN, 64, HIDDEN),
                *[packed_shape(1, HIDDEN, HIDDEN, 64, HIDDEN)] * 2,
                (HIDDEN, 2)]
    return [(9 * D, HIDDEN), (HIDDEN, HIDDEN), (HIDDEN, HIDDEN), (HIDDEN, 2)]


def gnet_operands(convs: Sequence[Layer]) -> Operands:
    """The kernel's operands of the four layers, in the weights' dtype,
    made once by the caller. bf16: w0 as a 1x1 over the 9 D im2col columns
    (tap-major, as HWIO reshapes), w1 and w2, each ``pack_weights``' K
    blocks of 64 (128-byte swizzle; w0 zero past 9 D); w3 (128, 2) in f32.
    f32: w0 (9 D, 128), w1, w2 (128, 128), w3 (128, 2). The biases b1, b2,
    b3 in f32."""
    (w0, _), (w1, b1), (w2, b2), (w3, b3) = convs
    D = w0.shape[2]
    if w0.dtype == torch.bfloat16:
        ws = [pack_weights(w0.reshape(1, 1, 9 * D, HIDDEN), 64, HIDDEN),
              pack_weights(w1, 64, HIDDEN), pack_weights(w2, 64, HIDDEN),
              w3.reshape(HIDDEN, 2).float().contiguous()]
    else:
        ws = [k.reshape(-1, k.shape[-1]).contiguous()
              for k in (w0, w1, w2, w3)]
    return ws, [b.to(torch.float32).contiguous() for b in (b1, b2, b3)]


def gnet_update(cv: torch.Tensor, feat_contrib: torch.Tensor,
                prev: torch.Tensor, convs: Sequence[Layer],
                operands: Optional[Operands] = None) -> torch.Tensor:
    """The update with the arguments of ``gnet_update_ref``. CPU tensors take
    the plain version; CUDA tensors (f32 or bf16, D <= 16, hidden 128, 2
    outputs) launch the kernel on the current stream through
    ``ops.gnet_update``. ``operands``: ``gnet_operands(convs)``, made once
    by the caller (made here when None)."""
    B, H, W, D = cv.shape
    hidden = convs[0][0].shape[-1]
    if D > MAX_D or hidden != HIDDEN:
        raise ValueError(f"gnet_update: D={D} (at most {MAX_D}) and hidden="
                         f"{hidden} (must be {HIDDEN}) are not supported")
    if cv.device.type == "cpu":
        return gnet_update_ref(cv, feat_contrib, prev, convs)
    if cv.device.type != "cuda":
        raise ValueError(f"gnet_update: unsupported device {cv.device}")
    dt, dev = feat_contrib.dtype, cv.device
    if dt not in _DTYPES:
        raise ValueError(f"gnet_update: unsupported dtype {dt}")
    if len(convs) != 4:
        raise ValueError(f"gnet_update: {len(convs)} convs, want 4")
    for i, ((k, b), shape) in enumerate(zip(convs, _shapes(D))):
        if tuple(k.shape) != shape or k.dtype != dt or k.device != dev:
            raise ValueError(f"gnet_update: conv {i} must be {shape} {dt} "
                             f"on {dev}, got {tuple(k.shape)} {k.dtype}")
        if i and (b is None or tuple(b.shape) != shape[-1:]
                  or b.device != dev):
            raise ValueError(f"gnet_update: bias {i} must be {shape[-1:]} "
                             f"on {dev}")
    ws, bs = gnet_operands(convs) if operands is None else operands
    return OPS.gnet_update(cv, feat_contrib, prev, ws, bs)


gnet_update.launches = 0
