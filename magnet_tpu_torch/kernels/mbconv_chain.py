"""A chain of stride-1 MBConv blocks (an EfficientNet stage's tail), NHWC.

The port of ``magnet_tpu/kernels/mbchain_pallas.py::mbchain_fused``. Per
block, with eval BatchNorm folded (bn1's scale into ``wpw``, bn2's into the
depthwise taps ``wdw``, bn3's into ``wpwl``):

    e = swish(x @ wpw + s1)                        rounded to x's dtype
    d = swish(depthwise_KxK(e) + s2)               TF-SAME, rounded
    g = sigmoid(swish(mean_HW(d) @ wse1 + bse1) @ wse2 + bse2)   f32
    y = (d * g) @ wpwl + s3                        d * g rounded
    x = round(y) + x                               in x's dtype

On a CUDA device each block is two kernel launches (``csrc/mbconv_chain.
cu``): expand + depthwise over tiles of the map, with the channel sums of d and
the squeeze-excitation's first layer; then the SE's second layer, the gate
and the projection with the residual, K split across blocks where the tiles
leave SMs idle. ``plan`` chooses the tiles and the K split from the shapes;
see the source note for why the TPU's one resident map per chain does not
carry over. The TPU version's VMEM gate (``supported``) has no counterpart:
every stage runs.

``mbconv_chain_ref`` is the plain PyTorch version, computed in f32 with the
roundings above. ``mbconv_chain`` runs it for tensors on the CPU and the
kernels for tensors on a CUDA device, or raises; it adds
``LAUNCHES_PER_BLOCK`` to its ``launches`` per block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from magnet_tpu_torch.kernels.ops import OPS

LAUNCHES_PER_BLOCK = 2
# H100 SXM: streaming multiprocessors, shared memory a block may use and an
# SM holds (each block also reserves 1 KB)
SMS = 132
SMEM_MAX, SMEM_SM = 232448, 233472
# the kernels' tiles (csrc/mbconv_chain.cu): expanded channels a slice,
# pixels an m-tile, output channels a projection block, bytes a tile row of
# a K block, stages of each of an expand block's two rings of x, threads of
# a projection block; floats of mb_expand's scratch (8 x 64 sums, the mean,
# s1, s2, a flag) and the largest K range a projection block takes (two
# blocks an SM)
SLICE, TM, PN, KROW, EX_STAGES, PR_THREADS = 64, 64, 128, 128, 2, 256
RED_FLOATS, KC_MAX = 11 * 64 + 4, 256
# expand blocks an SM runs at once at most (registers: 256 threads of up to
# 128), and the fixed cost of an expand block in halo pixels
EX_PER_SM, EX_OVERHEAD = 2, 256


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def expand_layout(th: int, tw: int, C: int, K: int, elem: int) -> tuple:
    """Shared memory of an expand block over th x tw output pixels, as the
    kernel takes it: the byte offsets of the x rings (after the weight
    slice's K blocks of 64 rows), of e (the tile with its halo and one spare
    pixel) and of the scratch, then the bytes in all (1024 of them to align
    the base)."""
    ring = _cdiv(C * elem, KROW) * TM * KROW
    e = ring + 2 * EX_STAGES * TM * KROW
    red = e + ((th + K - 1) * (tw + K - 1) + 1) * SLICE * elem
    return ring, e, red, red + RED_FLOATS * 4 + 1024


def project_layout(kc: int, R: int, elem: int) -> tuple:
    """Shared memory of a projection block over ``kc`` expanded channels:
    the byte offsets of A (after B's K blocks of 128 rows), of the gate
    (after A's K blocks of 64 rows or the staged f32 product, whichever is
    larger) and of r (after the gate's kc floats or the 4 x PR_THREADS
    partial sums of the SE's second layer), then the bytes in all."""
    kb = _cdiv(kc * elem, KROW)
    a = kb * PN * KROW
    gate = a + max(kb * TM * KROW, TM * (PN + 4) * 4)
    r = gate + max(kc, 4 * PR_THREADS) * 4
    return a, gate, r, r + (R + 4) * 4 + 1024


def expand_tile(N: int, H: int, W: int, C: int, M: int, K: int, elem: int,
                sms: int = SMS) -> tuple:
    """The expand kernel's output tile (th, tw): of the tiles whose shared
    memory fits and whose halo is at most the tile in each direction (or
    that span the map), the one with the least estimated time, waves of
    blocks times each block's halo pixels plus a fixed cost. The whole map
    wins where it fits and its blocks fill the card."""
    best = None
    for th in sorted({_cdiv(H, k) for k in range(1, H + 1)}, reverse=True):
        for tw in sorted({_cdiv(W, k) for k in range(1, W + 1)},
                         reverse=True):
            if min(th, tw) < K - 1 and (th, tw) != (H, W):
                continue
            smem = expand_layout(th, tw, C, K, elem)[-1]
            if smem > SMEM_MAX:
                continue
            per_sm = min(EX_PER_SM, SMEM_SM // (smem + 1024))
            blocks = N * _cdiv(H, th) * _cdiv(W, tw) * _cdiv(M, SLICE)
            cost = (_cdiv(blocks, sms * per_sm)
                    * ((th + K - 1) * (tw + K - 1) + EX_OVERHEAD))
            if best is None or cost < best[0]:
                best = (cost, th, tw)
    if best is None:
        raise ValueError(f"mbconv_chain: no tile of a {H}x{W} map fits")
    return best[1:]


def plan(N: int, H: int, W: int, C: int, M: int, R: int, K: int, elem: int,
         sms: int = SMS) -> dict:
    """The launch geometry of one block. Expand: output tiles of ``th`` x
    ``tw`` pixels (``expand_tile``), ``tiles`` a frame, ``slices`` of 64
    expanded channels, shared memory ``ex_layout`` (``expand_layout``).
    Projection: ``tpf`` 64-pixel tiles a frame, ``ctiles`` of 128 output
    channels, ``splits`` K ranges of ``kc`` channels (a multiple of 64; more
    splits where the tiles leave SMs idle, at most ``KC_MAX`` channels a
    range), shared memory ``pr_layout`` (``project_layout``)."""
    th, tw = expand_tile(N, H, W, C, M, K, elem, sms)
    tpf, ctiles = _cdiv(H * W, TM), _cdiv(C, PN)
    splits = max(_cdiv(M, KC_MAX),
                 min(_cdiv(sms, N * tpf * ctiles), _cdiv(M, 64)))
    kc = 64 * _cdiv(_cdiv(M, splits), 64)
    pr_layout = project_layout(kc, R, elem)
    if R > 8 * SLICE or pr_layout[-1] > SMEM_MAX:
        raise ValueError(f"mbconv_chain: SE width {R} is too large")
    return dict(th=th, tw=tw, tiles=_cdiv(H, th) * _cdiv(W, tw),
                slices=_cdiv(M, SLICE), tpf=tpf, ctiles=ctiles, kc=kc,
                splits=_cdiv(M, kc),
                ex_layout=expand_layout(th, tw, C, K, elem),
                pr_layout=pr_layout)


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
    (f32 or bf16, C and M multiples of 16 bytes, K 3 or 5) launch two
    kernels per block on the current stream, the blocks in one call of
    ``ops.mbconv_block``."""
    if x.device.type == "cpu":
        return mbconv_chain_ref(x, wpw, s1, wdw, s2, wse1, bse1, wse2, bse2,
                                wpwl, s3, kernel_size)
    if x.device.type != "cuda":
        raise ValueError(f"mbconv_chain: unsupported device {x.device}")
    return OPS.mbconv_block(x, wpw, s1, wdw, s2, wse1, bse1, wse2, bse2,
                            wpwl, s3, kernel_size)


mbconv_chain.launches = 0
