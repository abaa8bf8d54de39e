"""A chain of stride-1 MBConv blocks (an EfficientNet stage's tail), NHWC.

The port of ``magnet_tpu/kernels/mbchain_pallas.py::mbchain_fused``. Per
block, with eval BatchNorm folded (bn1's scale into ``wpw``, bn2's into the
depthwise taps ``wdw``, bn3's into ``wpwl``):

    e = swish(x @ wpw + s1)                        rounded to x's dtype
    d = swish(depthwise_KxK(e) + s2)               TF-SAME, rounded
    g = sigmoid(swish(mean_HW(d) @ wse1 + bse1) @ wse2 + bse2)   f32
    y = (d * g) @ wpwl + s3                        d * g rounded
    x = round(y) + x                               in x's dtype

On a CUDA device each block is three kernel launches (``csrc/mbconv_chain.
cu``): expand + depthwise with the channel sums of d, the SE MLP, the
projection with the gate and the residual; see the source note for why the
TPU's one resident map per chain does not carry over. The TPU version's
VMEM gate (``supported``) has no counterpart: every stage runs.

``mbconv_chain_ref`` is the plain PyTorch version, computed in f32 with the
roundings above. ``mbconv_chain`` runs it for tensors on the CPU and the
kernels for tensors on a CUDA device, or raises; it adds 3 to its
``launches`` per block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from magnet_tpu_torch.kernels import build
from magnet_tpu_torch.kernels.psm_blocks import _DTYPES, _check

LAUNCHES_PER_BLOCK = 3


def mbconv_chain_ref(x: torch.Tensor, wpw, s1, wdw, s2, wse1, bse1, wse2,
                     bse2, wpwl, s3, kernel_size: int) -> torch.Tensor:
    """Plain version. x: (N, H, W, C). Stacked per-block operands (nb
    leading): wpw (nb, C, M), wdw (nb, K*K, M), wpwl (nb, M, C) in x's dtype;
    s1, s2, bse2 (nb, M), wse1 (nb, M, R), bse1 (nb, R), wse2 (nb, R, M),
    s3 (nb, C) f32. Returns (N, H, W, C) in x's dtype."""
    dt, f32 = x.dtype, torch.float32
    K = kernel_size
    pt = (K - 1) // 2
    for b in range(wpw.shape[0]):
        M = wpw.shape[-1]
        e = F.silu(x.to(f32) @ wpw[b].to(f32) + s1[b]).to(dt)
        taps = wdw[b].to(f32).t().reshape(M, 1, K, K)
        acc = F.conv2d(F.pad(e.permute(0, 3, 1, 2).to(f32),
                             (pt, K - 1 - pt, pt, K - 1 - pt)), taps, groups=M)
        d = F.silu(acc.permute(0, 2, 3, 1) + s2[b]).to(dt)
        pool = d.to(f32).mean((1, 2))
        g = torch.sigmoid(F.silu(pool @ wse1[b] + bse1[b]) @ wse2[b] + bse2[b])
        a = (d.to(f32) * g[:, None, None, :]).to(dt)
        y = (a.to(f32) @ wpwl[b].to(f32) + s3[b]).to(dt)
        x = (y.to(f32) + x.to(f32)).to(dt)
    return x


def mbconv_chain(x: torch.Tensor, wpw, s1, wdw, s2, wse1, bse1, wse2, bse2,
                 wpwl, s3, kernel_size: int) -> torch.Tensor:
    """The chain with the arguments of ``mbconv_chain_ref``. CUDA tensors
    (f32 or bf16, C and M multiples of 16 bytes, K 3 or 5) launch three
    kernels per block on the current stream."""
    if x.device.type == "cpu":
        return mbconv_chain_ref(x, wpw, s1, wdw, s2, wse1, bse1, wse2, bse2,
                                wpwl, s3, kernel_size)
    if x.device.type != "cuda":
        raise ValueError(f"mbconv_chain: unsupported device {x.device}")
    dt, dev, f32 = x.dtype, x.device, torch.float32
    if dt not in _DTYPES:
        raise ValueError(f"mbconv_chain: unsupported dtype {dt}")
    if x.dim() != 4:
        raise ValueError("mbconv_chain: x must be (N, H, W, C)")
    N, H, W, C = x.shape
    nb, _, M = wpw.shape
    R = wse1.shape[-1]
    K = kernel_size
    vec = 16 // x.element_size()
    if K not in (3, 5) or C % vec or M % vec:
        raise ValueError(f"mbconv_chain: window {K}, channels ({C}, {M})")
    for t, name, shape, tdt in (
            (x, "x", (N, H, W, C), dt), (wpw, "wpw", (nb, C, M), dt),
            (s1, "s1", (nb, M), f32), (wdw, "wdw", (nb, K * K, M), dt),
            (s2, "s2", (nb, M), f32), (wse1, "wse1", (nb, M, R), f32),
            (bse1, "bse1", (nb, R), f32), (wse2, "wse2", (nb, R, M), f32),
            (bse2, "bse2", (nb, M), f32), (wpwl, "wpwl", (nb, M, C), dt),
            (s3, "s3", (nb, C), f32)):
        _check(t, name, shape, tdt, dev)
    d = torch.empty((N, H, W, M), dtype=dt, device=dev)
    pool = torch.zeros((nb, N, M), dtype=f32, device=dev)
    gate = torch.empty((N, M), dtype=f32, device=dev)
    bufs = [torch.empty_like(x), torch.empty_like(x)]
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for b in range(nb):
            out = bufs[b % 2]
            err = lib.mt_mbconv_block(
                _DTYPES[dt], x.data_ptr(), wpw[b].data_ptr(),
                s1[b].data_ptr(), wdw[b].data_ptr(), s2[b].data_ptr(),
                wse1[b].data_ptr(), bse1[b].data_ptr(), wse2[b].data_ptr(),
                bse2[b].data_ptr(), wpwl[b].data_ptr(), s3[b].data_ptr(),
                d.data_ptr(), pool[b].data_ptr(), gate.data_ptr(),
                out.data_ptr(), N, H, W, C, M, R, K, stream)
            build.check(err, "mbconv_chain")
            mbconv_chain.launches += LAUNCHES_PER_BLOCK
            x = out
    return x


mbconv_chain.launches = 0
