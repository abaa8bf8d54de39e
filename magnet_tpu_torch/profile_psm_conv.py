"""Where the F-Net conv kernel (``kernels/csrc/psm_conv.cu``, TPU kernel rows
6-8), the head chain (``kernels/csrc/head_chain.cu``, row 3), the SPP tail
(``kernels/csrc/spp_tail.cu``, row 9), the one-launch BasicBlock
(``kernels/csrc/res_block.cu``, row 14), the G-Net update
(``kernels/csrc/gnet_update.cu``, row 5), the depthwise conv
(``kernels/csrc/dw_conv.cu``, row 13), the MBConv chain
(``kernels/csrc/mbconv_chain.cu``, row 12), the sweep backward
(``kernels/csrc/sweep_grad_src.cu``, row 10), the cost volume
(``kernels/csrc/cost_volume_cw.cu``, row 4) and convex upsampling
(``kernels/csrc/upsample_mask.cu``, row 11) spend their time on the GPU,
bf16. The first four run on ``kernels/csrc/hopper_conv.cuh``.

    python -m magnet_tpu_torch.profile_psm_conv [--ablate [NAME,...]]
        [--sites TEXT,...] [--parent DIR] [--out p.json]

Times each kernel (calls captured in a CUDA graph, the replay timed with
events) and cuDNN over the same convolutions at the sites of ``sites``: one
conv of each kind the F-Net runs on the 5 frames of a MaGNet sample at
480x640 (stem and layer1 at 240x320 with 32 channels, layer2 64, layers 3-4
128, layer4's dilation 2, both transition blocks' convs and projections),
the three heads (the depth head at N = 5, G-Net's feature term and MaGNet's
mask head at N = 1), the SPP tail at N = 5, and the BasicBlock at the
KITTI layer2, layer3 and layer4 sites (3 frames, 88x304; row 6's chain of
the same block beside cuDNN), the G-Net update at the ScanNet and KITTI
cost-volume maps (cuDNN's layer-0 3x3 conv alone, and the whole chain in
bf16 cuDNN convs and elementwise ops beside it), the depthwise conv at
its four path-A sites on 5 frames (cuDNN's grouped conv), the MBConv chain
at the six path-A stage tails (1 and 5 frames; no library call) and the
sweep backward at the F-Net training shape (small motion, a 0.9 rad roll,
one view invalid; bf16 features), the cost volume at the MaGNet sites of
``profile_magnet.cv_case`` (ScanNet: small motion, a 0.9 rad roll, one
view invalid; the KITTI cost volume) on (mu, sigma) pairs packed once and
at the sweep forward's three cases, and convex upsampling of the 3 maps of
a MaGNet frame (one launch) and of the D-Net's one map; each output is held
against the plain version (2e-2 * max|ref|; the cost volume within 1e-4 *
max|ref| off its consistency threshold, ``cost_volume_cw.compare``). ``--sites`` keeps the sites whose name holds one of the
comma-separated TEXT. With
``--ablate`` it also builds copies of the package under
``build/profile_psm_conv/`` with one part of the kernels switched off (all
of ``ABLATIONS``, or the names given) and times them the same way, a
process each:
  * ``no_halo``: the halo warps publish halo stages without staging them;
  * ``no_weights``: the weight ring loads its first slabs only, and the
    consumers reuse them (no change where the weights stay resident);
  * ``mma_only``: both;
  * ``no_mma``: the consumers run no wgmma for the 3x3 convs (the head's
    and the tail's 1x1 layers still run);
  * ``no_1x1``: the head's 1x1 layers run no wgmma;
  * ``kb64``: 32-channel inputs in 64-channel K blocks, 32 of them zeros,
    in place of the 64-byte swizzle's 32-channel blocks;
  * ``conv1_only`` / ``conv2_only``: the BasicBlock runs the wgmma of one
    of its two convs only;
  * ``c128_n64``: the BasicBlock at C = 128 and dilation 1 runs conv1 in
    two rounds of 64 output channels in place of one of 128 (two m64n128
    tiles a warpgroup); ``d2_n128``: at dilation 2 in one round of 128
    (three tiles, 192 accumulators a thread) in place of two of 64.
  * ``gnet_no_feat``: the G-Net update's producer streams no feature term;
    ``gnet_no_im2col``: its gather warps publish im2col tiles without
    filling them;
    ``gnet_layer0``: no wgmma in its 128 -> 128 layers (layer 0 and the
    last layer only); ``gnet_no_mma``: no wgmma at all;
    ``gnet_three_wg``: three consumer warpgroups a block in place of two,
    with registers moved from the copy warpgroup (setmaxnreg): the
    control for the update's serial cost a tile (PERF.md §7);
  * ``dw_no_tma``: the depthwise conv's ring publishes its stages without
    loading them; ``dw_no_window``: its threads skip the column walk
    (shared-memory reads, FMAs, stores);
  * ``mb_no_expand``, ``mb_no_project``: the MBConv block skips its expand
    + depthwise launch or its projection launch; ``mb_no_se``: both skip
    the squeeze-excitation's products (the gate is left unset);
  * ``sg_no_red``: the sweep backward emits no reductions (the walk, the
    ballots and shuffles stay); ``sg_scalar_red``: it emits them as four
    scalar atomics a lane in place of one float4;
  * ``cv_global``: the cost volume's plan stages no window, every sample
    is gathered from global memory (the time the windows save);
    ``cv_no_match``: it matches no sample; ``cv_no_stage``: it copies no
    window (the match reads stale windows);
  * ``up_no_compute``, ``up_no_store``, ``up_no_load``: the upsampling
    computes no fine pixel, stores no fine row, or loads neither the mask
    nor the coarse rows;
  * ``parent_cv``, ``parent_up``: the cost volume's (``parent_cv``) or
    convex upsampling's (``parent_up``, with the cost volume's) kernel and
    wrapper, with that commit's ``build.py`` and ``ops.py`` (so a commit
    that has ``ops.py``), taken from the checkout of an earlier commit at
    ``--parent`` (default ``build/parent``, e.g. ``mkdir -p build/parent
    && git archive <commit> magnet_tpu_torch | tar -x -C build/parent``),
    called as that commit's code calls them: the cost volume packing its
    (mu, sigma) pairs at every call, one upsampling launch a map.
Their outputs are wrong by design (all but ``kb64``, ``c128_n64``,
``d2_n128``, ``gnet_three_wg``, ``sg_scalar_red``, ``cv_global`` and the
parent variants); the times split a kernel's between its parts (MMA, halo
staging, weight stream, the SE, the reductions, the windows, the match).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from magnet_tpu_torch.kernels import cost_volume_cw as cvk
from magnet_tpu_torch.kernels import dw_conv as dwk
from magnet_tpu_torch.kernels import gnet_update as gk
from magnet_tpu_torch.kernels import head_chain as hc
from magnet_tpu_torch.kernels import mbconv_chain as mbk
from magnet_tpu_torch.kernels import psm_blocks as pb
from magnet_tpu_torch.kernels import res_block as rbk
from magnet_tpu_torch.kernels import spp_tail as st
from magnet_tpu_torch.kernels import sweep_grad_src as sgk
from magnet_tpu_torch.kernels import upsample_mask as uk
from magnet_tpu_torch.nn.efficientnet import CHAIN_OPERANDS, fold_mbconv_chain
from magnet_tpu_torch.ops.costvolume import sweep_forward_args
from magnet_tpu_torch.profile_conv import PEAK_BF16_FLOPS, ROOT, edited_copy
from magnet_tpu_torch.profile_dnet import graph_ms, random_chain, trunk_tail_sites
from magnet_tpu_torch.profile_fnet_train import (SWEEP_B, SWEEP_C, SWEEP_V,
                                                 sweep_case)
from magnet_tpu_torch.profile_magnet import cv_case

ABLATE_DIR = ROOT / "build" / "profile_psm_conv"
CONV = "magnet_tpu_torch/kernels/csrc/hopper_conv.cuh"
HEAD = "magnet_tpu_torch/kernels/csrc/head_chain.cu"
BLOCK = "magnet_tpu_torch/kernels/csrc/res_block.cu"
GNET = "magnet_tpu_torch/kernels/csrc/gnet_update.cu"
DW = "magnet_tpu_torch/kernels/csrc/dw_conv.cu"
MB = "magnet_tpu_torch/kernels/csrc/mbconv_chain.cu"
SG = "magnet_tpu_torch/kernels/csrc/sweep_grad_src.cu"
CV = "magnet_tpu_torch/kernels/csrc/cost_volume_cw.cu"
UP = "magnet_tpu_torch/kernels/csrc/upsample_mask.cu"
# variant -> the files it takes from the earlier commit at --parent
# (each takes that commit's ``build.py`` and ``ops.py``: the C signatures
# and the operators go with the kernels; the cost volume's changed with its
# ``v_total``, so ``parent_up`` takes that commit's cost volume too)
_BINDING = ("magnet_tpu_torch/kernels/build.py",
            "magnet_tpu_torch/kernels/ops.py")
_PARENT_CV = (CV, "magnet_tpu_torch/kernels/cost_volume_cw.py")
PARENTS = {
    "parent_cv": _PARENT_CV + _BINDING,
    "parent_up": ("magnet_tpu_torch/kernels/csrc/upsample_mask.cu",
                  "magnet_tpu_torch/kernels/upsample_mask.py")
                 + _PARENT_CV + _BINDING,
}
# the kinds of site whose calls differ at the earlier commit
PARENT_KINDS = ("cv", "up")
_NO_HALO = ((CONV, "for (int r = r0; r < g.rows; r += rstep) {",
             "for (int r = r0; r < 0; r += rstep) {"),
            (CONV, "for (int row = r0; row < g.rows; row += rstep) {",
             "for (int row = r0; row < 0; row += rstep) {"))
_RING_WAIT = ("if (it >= g.stages) hp::mbar_wait(&b.wempty[s], (it / g.stages - 1) & 1);",
              "if (it >= g.stages) break;")
_NO_WEIGHTS = (
    (CONV, "hp::mbar_wait(&b.wfull[s], (it / g.stages) & 1);",
     "if (it < g.stages) hp::mbar_wait(&b.wfull[s], 0);"),
    (CONV, *_RING_WAIT), (BLOCK, *_RING_WAIT))
_BOTH_MMA = "CONV1_MMA = true, CONV2_MMA = true"
_GNET_NO_1X1 = (GNET, "hp::wgmma_rs<128>(acc, frag[kk]", "if (kk < 0) hp::wgmma_rs<128>(acc, frag[kk]")
# variant -> (file, text in it, its replacement) edits
ABLATIONS = {
    "no_halo": _NO_HALO,
    "no_weights": _NO_WEIGHTS,
    "mma_only": _NO_HALO + _NO_WEIGHTS,
    "no_mma": ((CONV, "hp::wgmma_ss<BN>(acc[m], desc<KB>(a + 8 * m * RB",
                "if (k < 0) hp::wgmma_ss<BN>(acc[m], desc<KB>(a + 8 * m * RB"),
               (CONV, "if (MMA)", "if (MMA && k < 0)")),
    "no_1x1": ((HEAD, "hp::wgmma_rs<128>(acc, frag", "if (k < 0) hp::wgmma_rs<128>(acc, frag"),),
    "kb64": (("magnet_tpu_torch/kernels/psm_blocks.py",
              "return 32 if ci <= 32 else 64", "return 64"),),
    "conv1_only": ((BLOCK, _BOTH_MMA, "CONV1_MMA = true, CONV2_MMA = false"),),
    "conv2_only": ((BLOCK, _BOTH_MMA, "CONV1_MMA = false, CONV2_MMA = true"),),
    "c128_n64": ((BLOCK, "launch_block<RbShape<128, 64, 1, 1, 1>>",
                  "launch_block<RbShape<128, 64, 1, 2, 1>>"),),
    "d2_n128": ((BLOCK, "launch_block<RbShape<128, 64, 1, 2, 2>>",
                 "launch_block<RbShape<128, 64, 1, 1, 2>>"),),
    "gnet_no_feat": ((GNET, "hp::mbar_arrive_expect_tx(&ffull[st], rows * 256);",
                      "hp::mbar_arrive(&ffull[st]);"),
                     (GNET, "for (int r = 0; r < rows; ++r)", "for (int r = 0; r < 0; ++r)")),
    "gnet_no_im2col": ((GNET, "for (int i = bt; i < TM * 9; i += GATHERERS) {",
                        "for (int i = bt; i < 0; i += GATHERERS) {"),),
    "gnet_layer0": (_GNET_NO_1X1,),
    "gnet_three_wg": ((GNET, "constexpr int CONSUMERS = 256;", "constexpr int CONSUMERS = 384;"),
                      (GNET, "  if (tid >= CONSUMERS) {\n",
                       "  if (tid >= CONSUMERS) {\n    hp::reg_release<56>();\n"),
                      (GNET, "  const int wg = tid / 128, wt = tid % 128;",
                       "  hp::reg_claim<152>();\n  const int wg = tid / 128, wt = tid % 128;")),
    "gnet_no_mma": (_GNET_NO_1X1,
                    (GNET, "hp::wgmma_ss<128>(acc, hp::desc_sw128(A +",
                     "if (k < 0) hp::wgmma_ss<128>(acc, hp::desc_sw128(A +")),
    "dw_no_tma": ((DW, "hp::mbar_arrive_expect_tx(full, S::BOX);", "hp::mbar_arrive(full);"),
                  (DW, "hp::tma_load_4d(stage, map,", "if (t < 0) hp::tma_load_4d(stage, map,")),
    "dw_no_window": ((DW, "for (int i = 0; i < R + K - 1; ++i) {",
                      "for (int i = 0; i < 0; ++i) {"),),
    "mb_no_expand": ((MB, "  k1<<<dim3(", "  if (ex.N < 0) k1<<<dim3("),),
    "mb_no_se": ((MB, "for (int it = tid; it < a.R * parts; it += EX_THREADS) {",
                  "for (int it = tid; it < 0; it += EX_THREADS) {"),
                 (MB, "for (int it = tid; it < a.R * sp; it += PR_THREADS) {",
                  "for (int it = tid; it < 0; it += PR_THREADS) {"),
                 (MB, "for (int j = part; j < a.R; j += parts) {",
                  "for (int j = part; j < 0; j += parts) {")),
    "mb_no_project": ((MB, "  mb_project<T><<<grid,", "  if (pr.N < 0) mb_project<T><<<grid,"),),
    "sg_no_red": ((SG, "    if (c >= C) continue;\n    float v[VEC];",
                   "    if (c >= 0) continue;\n    float v[VEC];"),),
    "sg_scalar_red": ((SG, """      atomicAdd(reinterpret_cast<float4*>(o + c),
                make_float4(w * v[0], w * v[1], w * v[2], w * v[3]));""",
                       """      for (int e = 0; e < 4; ++e) atomicAdd(o + c + e, w * v[e]);"""),),
    "cv_global": ((CV, "bpp <= (long long)CV_WINDOW_BYTES;", "bpp < 0;"),),
    "cv_no_match": ((CV, """    if (job.w)
      cv_match<T, NCH, true>(a, b * a.V + v, valid, job, cur, geom, acc, q, off, g, l);
    else
      cv_match<T, NCH, false>(a, b * a.V + v, valid, job, cur, geom, acc, q, off, g, l);""",
                     "    (void)valid;"),),
    "cv_no_stage": ((CV, "hp::cp_async16(win + (size_t)i * 16, src + r * pitch + (size_t)e * 16, true);",
                     ";"),
                    (CV, "cv_cp_async<MSB>(wms + i * MSB, ms + ((size_t)r * a.W + c) * MSB);", ";")),
    "up_no_compute": ((UP, "for (int f = tid; f < k * fw; f += UP_THREADS) {",
                       "for (int f = tid; f < 0; f += UP_THREADS) {"),),
    "up_no_store": ((UP, "for (int i = threadIdx.x; i < a.n * a.k * nv; i += UP_THREADS) {",
                     "for (int i = threadIdx.x; i < 0; i += UP_THREADS) {"),),
    "up_no_load": ((UP, "for (int i = threadIdx.x; i < bytes / VB; i += UP_THREADS) {",
                    "for (int i = threadIdx.x; i < 0; i += UP_THREADS) {"),
                   (UP, "for (int i = tid; i < a.n * per; i += UP_THREADS) {",
                    "for (int i = tid; i < 0; i += UP_THREADS) {")),
}


def sites(h: int = 480, w: int = 640, frames: int = 5) -> list:
    """(site, kind, spec) at the ScanNet eval shape and two KITTI sites:
    "conv" specs are (N, H, W, Ci, Co, k, stride, dilation, epilogue) of one
    F-Net conv, "head" specs (N, H, W, C0, widths after the 3x3), "tail"
    specs (N, H, W, map widths, Cout), "block" specs (N, H, W, C,
    dilation), "gnet" specs (B, H, W, D) of the cost volume, "dw" specs
    (N, H, W, C, K), "cv" specs the keywords of ``cv_case``, "cv_sweep" and
    "sweep" specs (roll, one view invalid), "up" specs (H, W, maps)."""
    hh, wh, hc_, wc = h // 2, w // 2, h // 4, w // 4
    n = frames
    return [
        ("stem conv (32)", "conv", (n, hh, wh, 32, 32, 3, 1, 1, "relu")),
        ("layer1 conv (32, + res)", "conv", (n, hh, wh, 32, 32, 3, 1, 1, "res")),
        ("layer2_0 conv1 (32->64, stride 2)", "conv",
         (n, hh, wh, 32, 64, 3, 2, 1, "relu")),
        ("layer2_0 projection (1x1, stride 2)", "conv",
         (n, hh, wh, 32, 64, 1, 2, 1, "none")),
        ("layer2 conv (64, + res)", "conv", (n, hc_, wc, 64, 64, 3, 1, 1, "res")),
        ("layer3_0 conv1 (64->128)", "conv", (n, hc_, wc, 64, 128, 3, 1, 1, "relu")),
        ("layer3_0 projection (1x1)", "conv", (n, hc_, wc, 64, 128, 1, 1, 1, "none")),
        ("layer3 conv (128, + res)", "conv", (n, hc_, wc, 128, 128, 3, 1, 1, "res")),
        ("layer4 conv (128, dilation 2, + res)", "conv",
         (n, hc_, wc, 128, 128, 3, 1, 2, "res")),
        ("depth head N=5", "head", (n, hc_, wc, 256, (128, 128, 2))),
        ("gnet feature term N=1", "head", (1, hc_, wc, 256, (128,))),
        ("magnet mask head N=1", "head", (1, hc_, wc, 256, (128, 128, 128, 144))),
        ("spp tail N=5", "tail", (n, hc_, wc, (64, 128, 128), 64)),
        ("res_block KITTI layer2 (64)", "block", (3, 88, 304, 64, 1)),
        ("res_block KITTI layer3 (128)", "block", (3, 88, 304, 128, 1)),
        ("res_block KITTI layer4 (128, dilation 2)", "block", (3, 88, 304, 128, 2)),
        ("gnet_update 120x160 D=5", "gnet", (1, hc_, wc, 5)),
        ("gnet_update KITTI 88x304 D=5", "gnet", (1, 88, 304, 5)),
        # the update's time against its tile count (64 pixels a tile, 132
        # blocks): one tile, one a block, then one more a block each
        *[(f"gnet_update {t} tiles", "gnet", (1, 1, 64 * t, 5))
          for t in (1, 132, 264, 396, 528)],
        ("dw_conv 240x320 C=48 K=3 N=5", "dw", (n, hh, wh, 48, 3)),
        ("dw_conv 240x320 C=24 K=3 N=5", "dw", (n, hh, wh, 24, 3)),
        ("dw_conv 30x40 C=768 K=5 N=5", "dw", (n, h // 16, w // 16, 768, 5)),
        ("dw_conv 15x20 C=1824 K=3 N=5", "dw", (n, h // 32, w // 32, 1824, 3)),
        *[(f"mbconv_chain stage {si} ({nb} blocks, {hw[0]}x{hw[1]}, C={c}, "
           f"M={m}, K={k}) N={f}", "mbchain", (f, *hw, c, m, k, nb, si))
          for si, nb, hw, c, m, k in trunk_tail_sites(h, w) for f in (1, n)],
        ("sweep_grad_src main path", "sweep", (0.0, False)),
        ("sweep_grad_src roll 0.9 rad", "sweep", (0.9, False)),
        ("sweep_grad_src one view invalid", "sweep", (0.0, True)),
        ("cost_volume_cw main path", "cv", dict()),
        ("cost_volume_cw roll 0.9 rad", "cv", dict(roll=0.9)),
        ("cost_volume_cw one view invalid", "cv", dict(invalid=True)),
        ("cost_volume_cw KITTI 88x304 V=2", "cv",
         dict(hc=88, wc=304, views=2)),
        ("cost_volume_cw sweep forward", "cv_sweep", (0.0, False)),
        ("cost_volume_cw sweep forward roll 0.9 rad", "cv_sweep", (0.9, False)),
        ("cost_volume_cw sweep forward one view invalid", "cv_sweep",
         (0.0, True)),
        ("upsample_mask 3 maps (MaGNet)", "up", (hc_, wc, 3)),
        ("upsample_mask 1 map (D-Net)", "up", (hc_, wc, 1)),
    ]


def _r(g, *shape, scale=1.0):
    return (torch.randn(*shape, generator=g) * scale).cuda()


def conv_case(spec, g):
    """(kernel call, plain call, cuDNN call, flops) of one F-Net conv."""
    n, h, w, ci, co, k, stride, dil, epi = spec
    bf = torch.bfloat16
    x = _r(g, n, h, w, ci, scale=0.5).to(bf)
    wt = _r(g, k, k, ci, co, scale=(k * k * ci) ** -0.5).to(bf)
    scale, shift = _r(g, co).abs() + 0.5, _r(g, co, scale=0.1)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    res = _r(g, n, ho, wo, co).to(bf) if epi == "res" else None
    args = (x, wt, scale, shift, stride, dil, epi == "relu", res)
    packed = pb.pack_weights(wt)
    counter = "fused_residual_stage"
    xin = x.permute(0, 3, 1, 2)
    wl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    pad = dil if k == 3 else 0
    return (lambda: pb._conv_cuda(*args, counter, packed),
            lambda: pb._conv_ref(*args),
            lambda: F.conv2d(xin, wl, None, stride, pad, dil),
            2.0 * n * ho * wo * co * k * k * ci)


def head_case(spec, g):
    """(kernel call, plain call, cuDNN call over the 3x3, flops) of a head."""
    n, h, w, c0, widths = spec
    bf = torch.bfloat16
    convs, cin = [], c0
    for i, co in enumerate(widths):
        ks = 3 if i == 0 else 1
        convs.append((_r(g, ks, ks, cin, co, scale=(ks * ks * cin) ** -0.5).to(bf),
                      _r(g, co, scale=0.1), i < len(widths) - 1))
        cin = co
    x = _r(g, n, h, w, c0, scale=0.5).to(bf)
    ops = hc.head_operands(convs)
    xin = x.permute(0, 3, 1, 2)
    w0 = convs[0][0].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    flops = 2.0 * n * h * w * (9 * c0 * widths[0] + sum(
        a * b for a, b in zip(widths[:-1], widths[1:])))
    return (lambda: hc.head_chain(x, convs, ops),
            lambda: hc.head_chain_ref(x, convs),
            lambda: F.conv2d(xin, w0, None, 1, 1),
            flops)


def tail_case(spec, g):
    """(kernel call, plain call, cuDNN call over the 3x3, flops) of the SPP
    tail on operands packed once."""
    n, h, w, widths, cout = spec
    bf = torch.bfloat16
    maps = [_r(g, n, h, w, c, scale=0.5).to(bf) for c in widths]
    k = sum(widths)
    w0 = _r(g, 3, 3, k, 128, scale=(9 * k) ** -0.5).to(bf)
    s0, t0 = _r(g, 128).abs() + 0.5, _r(g, 128, scale=0.1)
    w1 = _r(g, 128, cout, scale=128 ** -0.5).to(bf)
    args = (*maps, w0, s0, t0, w1)
    packed = st.tail_operands(w0, w1, widths)
    xin = torch.cat(maps, -1).permute(0, 3, 1, 2)
    wl = w0.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return (lambda: st.spp_tail(*args, packed=packed),
            lambda: st.spp_tail_ref(*args),
            lambda: F.conv2d(xin, wl, None, 1, 1),
            2.0 * n * h * w * 128 * (9 * k + cout))


def block_case(spec, g):
    """(kernel call, plain call, cuDNN's two convs, flops) of one BasicBlock
    on operands packed once; the fifth item times row 6's chain of the same
    block."""
    n, h, w, c, dil = spec
    bf = torch.bfloat16
    x = _r(g, n, h, w, c, scale=0.5).to(bf)
    ws = [_r(g, 3, 3, c, c, scale=(9 * c) ** -0.5).to(bf) for _ in range(2)]
    bn = [(_r(g, c).abs() + 0.5, _r(g, c, scale=0.1)) for _ in range(2)]
    args = (x, ws[0], *bn[0], ws[1], *bn[1], dil)
    packed = pb.pack_chain(ws)
    chain = (torch.stack(ws), torch.stack([b[0] for b in bn]),
             torch.stack([b[1] for b in bn]))
    xin = x.permute(0, 3, 1, 2)
    wl = [k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
          for k in ws]
    return (lambda: rbk.res_block(*args, packed),
            lambda: rbk.res_block_ref(*args),
            lambda: [F.conv2d(xin, k, None, 1, dil, dil) for k in wl],
            2.0 * 2 * n * h * w * 9 * c * c,
            lambda: pb.fused_residual_stage(x, *chain, dil, packed=packed))


def gnet_case(spec, g):
    """(kernel call, plain call, cuDNN's layer-0 3x3 conv, flops) of one
    G-Net update on operands packed once; the fifth item runs the whole
    update in cuDNN (``gnet_update.cudnn_gnet``)."""
    b, h, w, d = spec
    bf = torch.bfloat16
    cv = _r(g, b, h, w, d).to(bf)
    feat = _r(g, b, h, w, 128, scale=0.5).to(bf)
    prev = torch.stack([2.0 + 0.3 * _r(g, b, h, w),
                        0.1 + 0.3 * _r(g, b, h, w).abs()], -1).to(bf)
    convs = [(_r(g, 3, 3, d, 128, scale=(9 * d) ** -0.5).to(bf), None)]
    for co in (128, 128, 2):
        convs.append((_r(g, 1, 1, 128, co, scale=128 ** -0.5).to(bf),
                      _r(g, co, scale=0.1)))
    ops = gk.gnet_operands(convs)
    w0 = convs[0][0].permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    xin = cv.permute(0, 3, 1, 2)
    return (lambda: gk.gnet_update(cv, feat, prev, convs, ops),
            lambda: gk.gnet_update_ref(cv, feat, prev, convs),
            lambda: F.conv2d(xin, w0, None, 1, 1),
            2.0 * b * h * w * 128 * (9 * d + 2 * 128 + 2),
            gk.cudnn_gnet(cv, feat, prev, convs))


def dw_case(spec, g):
    """(kernel call, plain call, cuDNN's grouped conv, flops) of one
    depthwise conv."""
    n, h, w, c, k = spec
    bf = torch.bfloat16
    x = _r(g, n, h, w, c).to(bf)
    taps = _r(g, k, k, c, scale=1.0 / k).to(bf)
    xin = x.permute(0, 3, 1, 2)
    wl = taps.permute(2, 0, 1)[:, None].contiguous()
    return (lambda: dwk.dw_conv(x, taps),
            lambda: dwk.dw_conv_ref(x, taps),
            lambda: F.conv2d(xin, wl, None, 1, k // 2, 1, c),
            2.0 * n * h * w * c * k * k)


def mbchain_case(spec, g):
    """(kernel call, plain call, None, flops) of one stage tail's chain of
    MBConv blocks (seeded random blocks, ``random_chain``), bf16; flops
    count the two 1x1 GEMMs."""
    n, h, w, c, m, k, nb, si = spec
    bf = torch.bfloat16
    blocks = random_chain(nb, c, m, k, 100 * si)
    ops = [t.to(bf) if name in ("wpw", "wdw", "wpwl") else t
           for name, t in zip(CHAIN_OPERANDS,
                              fold_mbconv_chain(blocks, torch.float32))]
    ops = [t.cuda() for t in ops]
    x = _r(g, n, h, w, c, scale=0.5).to(bf)
    return (lambda: mbk.mbconv_chain(x, *ops, k),
            lambda: mbk.mbconv_chain_ref(x, *ops, k), None,
            2.0 * nb * n * h * w * c * m * 2)


def sweep_grad_case(spec, g):
    """(kernel call, plain call, None, 0) of row 10 at the F-Net training
    shape (``profile_fnet_train.sweep_case``), bf16 features."""
    roll, invalid = spec
    a = [t.cuda() for t in sweep_case(roll=roll, invalid=invalid)]
    a[1] = a[1].to(torch.bfloat16)
    return (lambda: sgk.sweep_grad_src(*a),
            lambda: sgk.sweep_grad_src_ref(*a), None, 0.0)


def cost_volume_case(spec, g, parent=False):
    """(kernel call, plain call, None, 0) of row 4 at a MaGNet site, bf16
    features; the plain call gives the plain values off the consistency
    threshold and the kernel's on it (``cost_volume_cw.compare``'s
    elements), or the plain values everywhere if more than its share of
    the elements sit on the threshold. With ``parent`` the call is the
    earlier commit's, which packs the (mu, sigma) pairs at every call."""
    a = [x.cuda() for x in cv_case(g, **spec)]
    a[1], a[2] = a[1].to(torch.bfloat16), a[2].to(torch.bfloat16)
    if parent:
        def call():
            return cvk.cost_volume_cw(*a, 5.0)
    else:
        ops = cvk.cv_operands(a[3], a[4], torch.bfloat16)

        def call():
            return cvk.cost_volume_cw(*a, 5.0, ops)

    def plain():
        ref, margin = cvk.cost_volume_cw_ref(*a, 5.0, return_margin=True)
        keep = margin > cvk.MARGIN
        if keep.float().mean() < 1.0 - cvk.MAX_EXCLUDED:
            return ref
        return torch.where(keep, ref, call())
    return call, plain, None, 0.0


def cost_volume_sweep_case(spec, g):
    """(kernel call, plain call, None, 0) of row 4 as the F-Net training
    sweep's forward calls it (``sweep_forward_args``, 80 SID planes), bf16
    features."""
    roll, invalid = spec
    case = [x.cuda() for x in sweep_case(roll=roll, invalid=invalid)]
    src = _r(g, SWEEP_B, SWEEP_V, *case[1].shape[1:3], SWEEP_C)
    a = sweep_forward_args(case[0], case[1].to(torch.bfloat16),
                           src.to(torch.bfloat16), *case[3:])
    return (lambda: cvk.cost_volume_cw(*a),
            lambda: cvk.cost_volume_cw_ref(*a), None, 0.0)


def upsample_case(spec, g, parent=False):
    """(kernel call, plain call, None, 0) of row 11: ``n`` (H, W, 2) maps
    through one (H, W, 144) mask, by 4, bf16; one launch for them all (with
    ``parent``, one a map, as the earlier commit called it)."""
    h, w, n = spec
    mask = _r(g, 1, h, w, 144, scale=2.0).to(torch.bfloat16)
    maps = [_r(g, 1, h, w, 2).to(torch.bfloat16) for _ in range(n)]
    if parent:
        def call():
            return [uk.upsample_mask(d, mask, 4) for d in maps]
    else:
        def call():
            return uk.upsample_mask(maps, mask, 4)
    return (call, lambda: [uk.upsample_mask_ref(d, mask, 4) for d in maps],
            None, 0.0)


CASES = {"conv": conv_case, "head": head_case, "tail": tail_case,
         "block": block_case, "gnet": gnet_case, "dw": dw_case,
         "mbchain": mbchain_case, "sweep": sweep_grad_case,
         "cv": cost_volume_case, "cv_sweep": cost_volume_sweep_case,
         "up": upsample_case}


def _flat(out) -> torch.Tensor:
    """A call's output (a tensor or a list of them) as one f32 vector."""
    if isinstance(out, (list, tuple)):
        return torch.cat([o.float().reshape(-1) for o in out])
    return out.float()


def parent_copy(root: Path, files, parent: Path) -> Path:
    """A copy of the package under ``root`` with ``files`` taken from the
    checkout of an earlier commit at ``parent``."""
    edited_copy(root, ())
    for f in files:
        if not (parent / f).exists():
            raise RuntimeError(f"{parent / f} is missing: unpack the commit "
                               f"to compare with under {parent}")
        shutil.copyfile(parent / f, root / f)
    return root


def time_sites(library: bool, tolerate: bool = False, only: str = "",
               parent: bool = False) -> list:
    """The kernels (and cuDNN) at every site; with ``tolerate`` a site whose
    launch raises (an ablated kernel's shared memory too large) is recorded
    with ``ms`` None; with ``parent`` the ``PARENT_KINDS`` sites call their
    wrappers as the earlier commit did."""
    g = torch.Generator().manual_seed(0)
    rows = []
    for site, kind, spec in sites():
        if not any(text in site for text in only.split(",")):
            continue
        kw = {"parent": parent} if kind in PARENT_KINDS else {}
        call, plain, lib, flops, *chain = CASES[kind](spec, g, **kw)
        try:
            out = _flat(call())
        except RuntimeError as e:
            if not tolerate:
                raise
            rows.append(dict(site=site, kind=kind, ms=None, error=str(e)))
            continue
        ref = _flat(plain())
        torch.cuda.synchronize()
        ms = graph_ms(call)
        rows.append(dict(
            site=site, kind=kind, ms=ms, gflop=flops / 1e9,
            max_abs_err=(out - ref).abs().max().item(),
            limit=2e-2 * ref.abs().max().item(),
            peak_share=flops / PEAK_BF16_FLOPS / (ms * 1e-3),
            library_ms=graph_ms(lib) if library and lib else None,
            chain_ms=graph_ms(chain[0]) if library and chain else None))
    return rows


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ablate", nargs="?", const=",".join(ABLATIONS),
                   default="", metavar="NAME,...",
                   help="also time the ablated copies of the kernels (all "
                        "of ABLATIONS, or the variants named, parent_* ones "
                        "too)")
    p.add_argument("--sites", default="",
                   help="only the sites whose name holds one of these "
                        "comma-separated texts")
    p.add_argument("--parent", default=str(ROOT / "build" / "parent"),
                   help="the checkout of the earlier commit that the parent_* "
                        "variants take their files from")
    p.add_argument("--sites-only", action="store_true",
                   help=argparse.SUPPRESS)   # one ablated copy's process
    p.add_argument("--parent-calls", action="store_true",
                   help=argparse.SUPPRESS)   # a parent_* copy's process
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_psm_conv needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    if a.sites_only:
        print(json.dumps(time_sites(library=False, tolerate=True,
                                    only=a.sites, parent=a.parent_calls)))
        return {}
    res = dict(device=torch.cuda.get_device_name(0),
               kernel=time_sites(library=True, only=a.sites), ablations={})
    for name in filter(None, a.ablate.split(",")):
        if name in PARENTS:
            root = parent_copy(ABLATE_DIR / name, PARENTS[name],
                               Path(a.parent))
        else:
            root = edited_copy(ABLATE_DIR / name, ABLATIONS[name])
        env = dict(os.environ, PYTHONPATH=str(root))
        done = subprocess.run(
            [sys.executable, "-m", "magnet_tpu_torch.profile_psm_conv",
             "--sites-only", "--sites", a.sites,
             *(["--parent-calls"] if name in PARENTS else [])], cwd=root,
            env=env, capture_output=True, text=True, check=True)
        res["ablations"][name] = json.loads(done.stdout.splitlines()[-1])
    for i, r in enumerate(res["kernel"]):
        ablated = "".join(f", {name} {rows[i]['ms'] or float('nan'):.4f}"
                          for name, rows in res["ablations"].items())
        label = "cuDNN's chain" if r["kind"] == "gnet" else "row 6's chain"
        chain = ("" if r["chain_ms"] is None
                 else f", {label} {r['chain_ms']:.4f} ms")
        share = (f" ({100 * r['peak_share']:.1f} % of bf16 peak)"
                 if r["gflop"] else "")
        lib = ("" if r["library_ms"] is None
               else f", cuDNN {r['library_ms']:.4f} ms")
        print(f"{r['site']:38s} kernel {r['ms']:.4f} ms{share}{lib}{chain}, "
              f"err {r['max_abs_err']:.3e} (limit {r['limit']:.3e}){ablated}")
    bad = [r["site"] for r in res["kernel"]
           if not r["max_abs_err"] <= r["limit"]]
    if bad:
        raise RuntimeError(f"kernels disagree with their plain versions at "
                           f"{bad}")
    if a.out:
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
