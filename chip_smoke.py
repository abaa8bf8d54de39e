#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (magnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases, each of which raises on failure (non-zero exit, no result line):
  1. device: the card's name and power limit from nvidia-smi;
  2. build: the CUDA kernels of magnet_tpu_torch/kernels/csrc with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes the main paths give it at 480x640 (ScanNet eval; coarse map
     120x160, batch 1 on the D-Net path and 5 frames on the MaGNet path), in
     f32 (TF32 off, tolerance 1e-4 * max|ref|) and bf16 (2e-2 * max|ref|;
     the G-Net update in bf16 on out - prev, the update itself);
     each kernel's time, its plain version's, one cuDNN convolution over the
     same contraction where there is one (device times: calls captured in a
     CUDA graph, the replay timed with events, so the host's time to enqueue
     is left out), and the least time the card could take (bound). The cost
     volume is held to 1e-4 * max|ref| in both types (both accumulate exact
     products in f32) on the elements that do not sit within 1e-4 of its
     consistency threshold (at most 1 % may), also at a roll of 0.9 rad
     about the optical axis, with one view invalid and at the KITTI cost
     volume (88x304, 2 views) and as one rank of a view-sharded frame
     computes it (2 of the 4 views divided by the global v_total = 4; the
     launch at its own V equals it doubled, bit for bit), each site with
     the kernel's plan replayed in plain PyTorch (the share of corners
     served from staged windows, the bytes copied into shared memory, the
     bytes a plain gather requests).
     Convex upsampling runs as MaGNet calls it (the 3 maps of a frame in one
     launch, each bit-equal to its one-map call) and as the D-Net does (one
     map); its backward (the port's own kernel) at the two training sites
     (MaGNet: batch 4, 3 maps, 120x160; the D-Net: batch 16, one map,
     104x136) against autograd through the plain version, two calls equal
     bit for bit. The F-Net's kernels
     run at the shapes of its one pass over the 5 frames: every chain of the
     residual stages, both transition blocks, the tail. The plane-sweep
     backward (row 10) runs at the F-Net training shape (B = 2, V = 4,
     D = 80, 120x160, C = 64, SID planes, synthetic poses), also at a 0.9
     rad roll and with one view invalid, f32 to 1e-4 * max|ref| and bf16
     features to 2e-2 * max|ref| (atomic adds in any order); its library
     time is ATen's grid_sampler_2d_backward over the same samples. The
     reference features' gradient (sweep_grad_ref, the port's own kernel)
     at the same three sites against the plain re-gather, f32 and bf16
     features to 1e-4 * max|ref|, two calls equal bit for bit, with the
     plain version's launches a call;
  4. D-Net path: D-Net inference through the entry point's code path
     (magnet_tpu_torch.test_dnet) at 480x640, bf16, seeded random weights,
     on synthetic frames; every kernel's launch count must rise as the
     path predicts; outputs finite with variance > 0; frames/s;
  5. D-Net reference: one f32 forward on the card against the same forward
     on the CPU (the kernels' plain versions), tolerance 1e-5 * max|ref|
     (f32 on both sides, TF32 off: only the order of the sums differs);
  6. MaGNet main path: the whole pipeline through the entry point's code
     path (magnet_tpu_torch.test_magnet) at 480x640, cost volume 120x160, 4
     source views, 5 candidates, 3 iterations, bf16, seeded random weights
     in a trained network's depth regime, on synthetic samples; launch
     counts as predicted (one upsampling launch a frame for the 3
     iterations' maps); outputs finite with sigma > 0; a cost volume that
     is not all zero; ms per frame;
  7. MaGNet reference: one f32 forward on the card against the same forward
     on the CPU, each iteration's map held to 1e-4 * max|ref| on all but at
     most 1 % of the pixels (a sample on the consistency threshold may flip
     and move its pixel by a G-Net update); then the bf16 forward on the
     card, on the same weights (whose fusion does move the map), against
     that f32 reference: iteration i to i bf16 ulp of the map plus 2e-2 of
     the reference map's range, on all but at most 1 % of the pixels;
  8. F-Net training path: the entry point's own loop
     (magnet_tpu_torch.train_fnet) at the protocol of
     train_scripts/fnet/scannet.txt (480x640, batch 2, 4 source views, 80
     SID planes, cost volume 120x160, bf16, f32 master weights, seeded
     initialisation) on synthetic samples: 4 steps and a validation pass;
     finite losses, every parameter and BatchNorm buffer moved, the
     checkpoint restores step and tensors, launches as predicted (row 10
     and sweep_grad_ref once per step, the cost volume once per step and
     per validation
     sample, rows 6-9 in the validation forward); ms per step, peak memory,
     a stage account of one step and the profiler over two;
  9. the training step on the card against the CPU, f32 at a reduced shape
     (128x160, cost volume 32x40, D = 16, V = 2, B = 2), from the same
     weights and batch: loss to 1e-5 relative, every gradient to
     1e-3 * max|g| of its tensor, the BatchNorm running buffers to 1e-5;
 10. path A, the D-Net trunk's kernels (rows 12 and 13, --mbconv_chain all
     --dw_kernel): the D-Net and MaGNet paths of phases 4 and 6 with them
     on, their launches as predicted (row 12 two per block of the 30
     stage-tail blocks, row 13 at the 5 stride-1 conv_dw outside the
     chains, per D-Net pass); f32 on the card with them on against off (the
     D-Net's trunk taps and output to 1e-5 * max|ref|, MaGNet at phase 7's
     f32 limits), the bf16 MaGNet with them on against that f32 one at phase
     7's bf16 limits; the trunk alone at N = 1 and 5, on against off by
     events and by the profiler (launches, idle share);
 11. path B, MaGNet at the KITTI eval configuration
     (test_scripts/magnet/kitti_eigen.txt: 352x1216, cost volume 88x304, 2
     source views, 5 candidates, 3 iterations, bf16) with --stream_blocks
     (row 14) through the entry point's code on synthetic samples: launches
     as predicted (row 14 23 times per F-Net pass, the stem chain of row 6),
     outputs finite, sigma > 0, no cost volume all zero, ms per frame, peak
     memory, the stage split; the F-Net's f32 output with row 14 against
     the chains of row 6 on the card to 1e-5 * max|ref|. No CPU reference
     at this shape: phase 7 holds every shared kernel to the CPU already;
 12. D-Net training (stage 1): the entry point's own loop
     (magnet_tpu_torch.train_dnet) at train_scripts/dnet/scannet.txt (the
     416x544 crop, given as the input size: synthetic items are drawn at
     the input size and not augmented, as in the JAX package; batch 16 or
     the largest half of it that fits, bf16, f32
     master weights), started by --resume_ckpt from a state whose depth
     head is in a trained network's regime: 3 steps and a validation pass;
     finite losses, launches as predicted (per step the upsampling and its
     backward), ms per step by events, peak memory, a checkpoint that
     restores;
 13. MaGNet training (stage 3): the entry point's own loop
     (magnet_tpu_torch.train_magnet) at train_scripts/magnet/scannet.txt
     (480x640, batch 4, 4 source views, 5 candidates, 3 iterations, bf16)
     from phase 12's D-Net and phase 8's F-Net: 3 steps and a validation
     pass; only g_net.* and mask_head.* change, launches per step as
     predicted, ms per step by events; then one step's loss and gradients
     against the same step with f32 weights and the plain encode (the D-Net
     and F-Net on the CPU): the f32 step's all of them, the bf16 step's
     loss and G-Net gradients; the bf16 step's mask head in three parts:
     its mask logits' gradient against the f32 mask head's on the bf16
     step's decoder feature and coarse maps, each conv's output against
     its exactly rounded bf16 result on the step's own input, its
     gradients against the f64 backward through the step's own conv
     outputs from its own logits' gradient (its gradients against the f32
     mask head's and the f32 step's printed beside, not gated); the f32
     encode of the 20 frames and row 4 at batch 4 held to their plain
     versions on the way;
 14. streaming: test_magnet --cache_features (its streaming forward and
     the harness) at the ScanNet eval shape, bf16, on a 12-frame sliding
     window built here (a reference and its 4 neighbours, one frame a
     step): one miss a window in steady state, launches as predicted, ms
     per window against the monolithic forward by events, the largest
     difference between the two, and which stage of the encode depends on
     the batch (N = 1 against N = 5);
 15. the GroupNorm D-Net decoder (--DNET_architecture DenseDepth_GN): the
     D-Net path of phase 4 with it (per frame 2 head-chain launches, 1
     upsampling, no conv kernel: its stages are plain PyTorch, as the JAX
     package runs them in XLA), ms by events, the profiler; the f32 GN
     D-Net on the card against the CPU at 128x160 (phase 5's limit); the
     bf16 frame against the f32 one on the card at 480x640 (phase 7's
     limits for one map); the BN and GN D-Nets' stage split by events; the
     MaGNet path of phase 6 on it; 2 stage-1 steps of phase 12 with it
     (the batch that fits, ms per step, peak memory);
 16. the on-disk datasets: small ScanNet (scans_test: colour JPEG
     1296x968, depth PNG 640x480, poses, intrinsics), 7-Scenes (640x480
     PNGs with 65535 holes, poses) and KITTI (colour PNG 1242x375, sparse
     ground-truth PNGs, calibration, OXTS) trees written under build/,
     named after the first entries of the repository's split files; the
     first 4 test batches of each through the port's dispatch
     (magnet_tpu_torch.data) held to what was written (depth = uint16 /
     1000 or / 256 in the kb-crop, 65535 as 0, finite poses and
     intrinsics, every view valid), host ms per sample; the MaGNet forward
     on each (bf16, the flag file's shape: 480x640 with 4 views, KITTI
     352x1216 with 2 views and --stream_blocks) with finite maps and the
     harness's metric line; the KITTI eigen_train single-view loader with
     its augmentations at batch 16 and the 352x704 crop, host ms per batch
     at --workers 1 and 4, beside phase 12's step;
 17. the kernels as PyTorch operators (kernels/ops.py): torch.library.opcheck
     (schema, autograd registration, fake tensor, AOT dispatch with dynamic
     shapes) of each of the thirteen operators on the arguments of its first
     phase-3 call; one small operator's host time a call through the
     operator and as a plain function; phase 6's frame by CUDA events and
     on the host clock, through the operators and with the CUDA
     implementations called directly, in turns, as the process stands and
     with the garbage collector's objects frozen: the dispatcher's cost per
     frame;
 18. training across processes: train_fnet at the protocol of phase 8 for
     2 steps from the seeded initialisation, undistributed twice (the
     sweep's backward and cuDNN's sum in any order: the spread between the
     two) and in a process group of one over NCCL (its first loss equal bit
     for bit; one step's update from the same gradients through the
     group's path equal to the undistributed update bit for bit), and in
     two processes over gloo, both on this card with the kernels on (the
     ranks equal bit for bit, every parameter moved, the losses within
     phase 9's bf16 loss limit of the undistributed run);
     one f32 step at phase 9's reduced shape over two processes against
     one process on the card at phase 9's f32 limits; dryrun_multichip(1)
     over NCCL;
 19. --profile_dir on a 4-step train_fnet run: the Chrome trace of its
     window exists and names the sweep's operators and kernels
     (cost_volume_cw, sweep_grad_src, sweep_grad_ref);
 20. serving export (serve/export.py) at the ScanNet eval shape in bf16:
     the monolithic forward and the encode/fuse pair exported with the f32
     state dict as an argument, saved to bytes, loaded and run; each graph
     holds each operator as often as phase 6 launches its kernel per frame,
     the loaded program launches them so, and its output (and encode +
     fuse's) equals the eager bf16 forward bit for bit, else at phase 7's
     bf16 limits; ms per frame of the loaded program against eager;
 21. one stream per card (serve/streams.py) over every card: each stream's
     map equal bit for bit to the single-stream forward; ms per frame;
 22. view-sharded single-stream inference (core/sharding_inference.py) at
     the ScanNet eval shape from phase 17's model, bf16 and f32: W = 1 over
     NCCL equal to the monolithic forward bit for bit; W = 2 over gloo,
     both ranks on this card (each encodes the reference and 2 of the 4
     views, the cost volume summed over the ranks): the ranks equal bit for
     bit, f32 at phase 7's f32 limits of the monolithic forward, bf16
     within 2e-2 of its max|map|; ms a frame by events on each rank and
     the all-reduce's share;
 23. training dumps (utils/visualize.py): the three dumps from maps the card
     computed, each file a 640x480 JPEG; host ms a dump.
Phase 3 also holds rows 12 and 13 at their path-A sites (N = 1 and 5),
row 14 at the four KITTI layer shapes (3 frames; row 6's chain over the
same blocks timed beside it), rows 1 and 2 at the KITTI decoder's four
conv shapes (3 frames, maps 44x152 and 88x304), rows 6-8 at the F-Net's
chains and transition blocks on the 3 frames of a KITTI sample (maps
176x608 and 88x304), row 9 at the KITTI tail (88x304) and row 3 at the
KITTI heads (88x304), f32 and bf16 (timed, in no frame's sum). The bf16
F-Net convs, blocks, tail and heads are timed on packed operands made once,
as the modules keep them.
Then a {"kernels": [...]} line (16 rows: the 14 TPU kernels, the
upsampling's backward and the sweep's reference gradient), the nvidia-smi
line, and as the last line
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from magnet_tpu_torch import (dryrun, profile_conv, test_dnet, test_magnet,
                              train_dnet, train_fnet, train_magnet)
from magnet_tpu_torch.core import config, distributed, mesh
from magnet_tpu_torch.core.sharding_inference import (shard_magnet_inference,
                                                      view_mesh)
from magnet_tpu_torch.data import base
from magnet_tpu_torch.data.synthetic import (SyntheticMultiView,
                                             SyntheticSingleView)
from magnet_tpu_torch.eval import harness
from magnet_tpu_torch.kernels import build
from magnet_tpu_torch.kernels import conv3x3_bnact as cb
from magnet_tpu_torch.kernels import cost_volume_cw as cvk
from magnet_tpu_torch.kernels import dw_conv as dwk
from magnet_tpu_torch.kernels import gnet_update as gk
from magnet_tpu_torch.kernels import head_chain as hc
from magnet_tpu_torch.kernels import mbconv_chain as mbk
from magnet_tpu_torch.kernels import ops
from magnet_tpu_torch.kernels import psm_blocks as pb
from magnet_tpu_torch.kernels import res_block as rbk
from magnet_tpu_torch.kernels import spp_tail as st
from magnet_tpu_torch.kernels import sweep_grad_ref as sgr
from magnet_tpu_torch.kernels import sweep_grad_src as sgk
from magnet_tpu_torch.kernels import upsample_mask as uk
from magnet_tpu_torch.models import magnet as magnet_module
from magnet_tpu_torch.models.build import (build_dnet, build_dnet_train,
                                           build_fnet, build_magnet,
                                           build_magnet_f,
                                           build_magnet_train,
                                           cast_for_inference,
                                           init_weights_,
                                           realistic_depth_init_)
from magnet_tpu_torch.models.dnet import DNet
from magnet_tpu_torch.models.magnet import sid_depth_centers
from magnet_tpu_torch.nn import psmnet
from magnet_tpu_torch.nn.densedepth import run_head
from magnet_tpu_torch.nn.efficientnet import (CHAIN_OPERANDS,
                                              b5_stage_config, chain_stages,
                                              fold_mbconv_chain)
from magnet_tpu_torch.nn.layers import BN_MOMENTUM, conv2d, nchw, nhwc
from magnet_tpu_torch.ops.costvolume import sweep_forward_args
from magnet_tpu_torch.ops.upsample import upsample_via_mask
from magnet_tpu_torch.profile_dnet import (cuda_ms, graph_ms, kernel_profile,
                                           random_chain, trunk_tail_sites)
from magnet_tpu_torch.profile_dnet import stage_times as dnet_stage_times
from magnet_tpu_torch.profile_fnet_train import (protocol_args, step_account,
                                                 sweep_case, sweep_grids,
                                                 sweep_samples)
from magnet_tpu_torch.profile_magnet import cv_case, eval_args, stage_times
from magnet_tpu_torch.serve import export as serve_export
from magnet_tpu_torch.serve import streams
from magnet_tpu_torch.train import checkpoint, optim, steps
from magnet_tpu_torch.train import losses as train_losses
from magnet_tpu_torch.utils import visualize

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 outside the
# tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FORWARD_TOL = 1e-5
MAGNET_TOL = 1e-4          # per iteration map, all but MAGNET_FLIPS of it
MAGNET_FLIPS = 0.01
BF16_FORWARD_TOL = 2e-2    # of the f32 map's range, on top of the rounding
H, W = 480, 640
HC, WC = H // 4, W // 4    # the coarse map of the heads and the fusion
VIEWS, SAMPLES, ITERS, FEAT = 4, 5, 3, 64
DNET_FRAMES = 2
MAGNET_FRAMES = 3
# F-Net training at the protocol of train_scripts/fnet/scannet.txt
TRAIN_B, TRAIN_D, TRAIN_STEPS = 2, 80, 4
# the card-vs-CPU training step: a reduced shape, the CPU side being slow
SMALL_TRAIN = dict(H=128, W=160, D=16, V=2, B=2)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_STATS_TOL = 1e-5, 1e-3, 1e-5
# the bf16 step against the f32 one, bf16 rounding through 33 layers: loss
# relative, gradients of max|g| per tensor (the worst and the median tensor),
# running buffers of |v| + 1. On the CPU at SMALL_TRAIN the bf16 step reads
# 9.6e-5, 0.13, 0.017, 3.2e-3 and the control (BatchNorm statistics in
# bf16) 1.2e-4, 0.40, 0.050, 1.8e-2.
BF16_TRAIN_TOL = dict(loss=2e-3, grad=0.3, grad_median=0.035, stats=8e-3)
KINK_MARGIN = 1e-5
# D-Net training at train_scripts/dnet/scannet.txt (batch 16 where it fits)
DNET_TRAIN_B, DNET_CROP, DNET_TRAIN_STEPS = 16, (416, 544), 3
# MaGNet training at train_scripts/magnet/scannet.txt
MAGNET_TRAIN_B, MAGNET_TRAIN_STEPS = 4, 3
# the stage-3 step with the encode's f32 kernels against the plain encode:
# the encode's f32 sums in another order through B5 and PSM-Net (phase 7
# holds those maps to 1e-4 * max|ref|), and a cost-volume sample on its
# consistency threshold may flip
MAGNET_TRAIN_F32_TOL = dict(loss=1e-4, grad=1e-3, grad_median=1e-3)
# the bf16 stage-3 step against the f32 one: the (mu, sigma) maps of the
# loss are bf16 (8 bits: 0.4 % of a value), so the NLL moves by about 1 %
# (1.35e-2 on the CPU at 96x128, B = 4, V = 4, 3 iterations, with gradients
# 0.043 worst and 0.015 median of their tensor's max); the loss and G-Net's
# gradients are held to the f32 step
MAGNET_TRAIN_BF16_TOL = dict(loss=5e-2, grad=0.3, grad_median=0.05)
# the bf16 step's mask head, held in the three parts that the chain rule
# composes into its gradients: the upstream (its mask logits' gradient
# against the f32 head's, ``mask_head_reference``, of max|ref|); each
# conv's output against the exactly rounded bf16 result on the step's own
# input (of max|ref|, phase 3's bf16 kernel limit); the mask-head gradients
# against the f64 backward through the step's own conv outputs from its own
# logits' gradient (worst and median tensor of their tensor's max). The
# gradients against the f32 head are printed, not gated: they rest on a few
# hundred fine pixels whose ReLU pattern any bf16 forward decides, and read
# 0.3 to 0.55 of max|g| in some trained states (ROADMAP, fault 4)
MASK_HEAD_UPSTREAM_TOL = 3e-2
MASK_HEAD_FORWARD_TOL = KERNEL_TOL[torch.bfloat16]
MASK_HEAD_BACKWARD_TOL = dict(grad=0.03, grad_median=0.01)
# phase 3: row 4 as one rank of a view-sharded frame computes it
SHARD_SITE = "a rank's 2 of 4 views, v_total 4"
# phase 22: frames timed
SHARD_FRAMES = 10
# streaming against the monolithic forward, of the largest |map|: the
# encode at batch 1 may take other kernel plans (and cuDNN algorithms) than
# at batch 5, each rounding its bf16 output once more or less
STREAM_FRAMES, STREAM_TOL = 12, 2e-2
REPO = Path(__file__).resolve().parent
WRAPPERS = {"conv3x3_bnact": cb.conv3x3_bnact, "head_chain": hc.head_chain,
            "cost_volume_cw": cvk.cost_volume_cw,
            "gnet_update": gk.gnet_update, "upsample_mask": uk.upsample_mask,
            "upsample_mask_bwd": uk.upsample_mask_bwd,
            "fused_residual_stage": pb.fused_residual_stage,
            "downsample_block": pb.downsample_block,
            "expand_block": pb.expand_block, "spp_tail": st.spp_tail,
            "sweep_grad_src": sgk.sweep_grad_src,
            "sweep_grad_ref": sgr.sweep_grad_ref, "dw_conv": dwk.dw_conv,
            "mbconv_chain": mbk.mbconv_chain, "res_block": rbk.res_block}
# launches per MaGNet frame of the F-Net's kernels (one pass over the 5
# frames): chains of 2 (stem), 6 (layer1), 30 (layer2 after its first
# block), 4 (layer3 after its first block) and 6 (layer4) convs; three convs
# in each transition block; one tail
FNET_LAUNCHES = dict(fused_residual_stage=2 + 6 + 30 + 4 + 6,
                     downsample_block=3, expand_block=3, spp_tail=1)
# path A, the D-Net trunk with both switches of its kernels on: per D-Net
# pass two launches for each of the 30 blocks of the six stage tails, one
# depthwise kernel at each of the 5 stride-1 conv_dw outside the chains
TRUNK_FLAGS = ["--mbconv_chain", "all", "--dw_kernel"]
TRUNK_LAUNCHES = dict(mbconv_chain=mbk.LAUNCHES_PER_BLOCK * 30, dw_conv=5)
# path B, MaGNet at the KITTI eval configuration (test_scripts/magnet/
# kitti_eigen.txt) with --stream_blocks
KITTI_H, KITTI_W, KITTI_HC, KITTI_WC, KITTI_VIEWS = 352, 1216, 88, 304, 2
KITTI_FRAMES = 3
# per KITTI F-Net pass: the stem's chain of 2 convs, one res_block for each
# stride-1 BasicBlock of layer1-4 (3 + 15 + 2 + 3), the transitions, the tail
KITTI_FNET_LAUNCHES = dict(fused_residual_stage=2, res_block=23,
                           downsample_block=3, expand_block=3, spp_tail=1)
# per D-Net pass of the BN decoder: conv_a and conv_b in up2 and in up3
BN_CONV = dict(conv3x3_bnact=4, up2=2, up3=2)
# per D-Net frame: those, the depth and the mask head, one upsampling; the
# GN decoder runs no conv kernel (its stages are plain PyTorch, as the JAX
# package runs UpSampleGN in XLA)
BN_DECODER = dict(BN_CONV, head_chain=2, upsample_mask=1)
GN_DECODER = dict(head_chain=2, upsample_mask=1)
GN_FLAGS = ["--DNET_architecture", "DenseDepth_GN"]
# the GN D-Net card vs CPU in f32 (the BN D-Net's limit, phase 5), at a
# reduced shape: the CPU side is slow
GN_F32_H, GN_F32_W = 128, 160
# phase 17: frames a turn of the operators' A/B; phases 18-19: train_fnet
# steps across processes and under --profile_dir
OP_AB_FRAMES, DIST_STEPS, PROFILE_STEPS = 20, 2, 4
# GN D-Net training: steps through train_dnet at DNET_CROP
GN_TRAIN_STEPS = 2
# phase 16: batches taken of each dataset's test split; entries of KITTI
# eigen_train written for its training loader (four batches)
ONDISK_BATCHES = 4
ONDISK_KITTI_TRAIN = 64


def reset_counts() -> None:
    for w in WRAPPERS.values():
        w.launches = 0


def read_counts() -> dict:
    return {name: w.launches for name, w in WRAPPERS.items()}


def log(msg: str) -> None:
    print(msg, flush=True)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound_ms(n_bytes: int, flops: float,
             peak_flops: float = PEAK_BF16_FLOPS,
             f32_flops: float = 0.0) -> tuple:
    """The least time for the work: its bytes at the memory rate or its
    operations at their units' peak rates (``flops`` at ``peak_flops``,
    ``f32_flops`` outside the tensor cores, two units that run side by
    side, so the longer of the two), whichever is longer."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = max(flops / peak_flops, f32_flops / PEAK_F32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def plain_time(fn) -> float:
    """A plain version's time: fewer repeats, it is no yardstick of speed."""
    return graph_ms(fn, iters=5, warmup=1)


def check_close(name: str, out: torch.Tensor, ref: torch.Tensor,
                dtype) -> float:
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise RuntimeError(f"{name}: bad output {tuple(out.shape)}")
    err = (out.float() - ref.float()).abs().max().item()
    lim = KERNEL_TOL[dtype] * ref.float().abs().max().item()
    log(f"  {name} {str(dtype)[6:]}: max_abs_err {err:.3e} (limit {lim:.3e})")
    if not err <= lim:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return err


# ---- phase 3: kernels against their plain versions -------------------------

def conv_sites():
    """The conv kernel's sites (``profile_conv.conv_sites``) at this
    script's shapes; the KITTI ones are held and timed but in no frame's
    sum."""
    return profile_conv.conv_sites((H, W), 1 + VIEWS, (KITTI_H, KITTI_W),
                                   KITTI_FRAMES)


def head_sites():
    """(site, path, x shape, widths after the 3x3)."""
    return [("depth_head N=1", "dnet", (1, HC, WC, 256), (128, 128, 2)),
            ("mask_head N=1", "dnet", (1, HC, WC, 256), (128, 128, 144)),
            ("depth_head N=5", "magnet", (1 + VIEWS, HC, WC, 256),
             (128, 128, 2)),
            ("gnet_feature_term", "magnet", (1, HC, WC, 256), (128,)),
            ("magnet_mask_head", "magnet", (1, HC, WC, 256),
             (128, 128, 128, 144)),
            (f"depth_head KITTI N={KITTI_FRAMES}", "kitti",
             (KITTI_FRAMES, KITTI_HC, KITTI_WC, 256), (128, 128, 2)),
            ("gnet_feature_term KITTI", "kitti", (1, KITTI_HC, KITTI_WC, 256),
             (128,)),
            ("magnet_mask_head KITTI", "kitti", (1, KITTI_HC, KITTI_WC, 256),
             (128, 128, 128, 144))]


def _randn(g, *shape, scale=1.0):
    return torch.randn(*shape, generator=g) * scale


def check_conv_kernel(dev):
    g = torch.Generator().manual_seed(0)
    rows = []
    for site, path, xs, cs, cout, ups in conv_sites():
        n, hs, ws, cx = xs
        h, w = (2 * hs, 2 * ws) if ups else (hs, ws)
        a32 = profile_conv.site_args(xs, cs, cout, ups, g, dev, torch.float32)
        err32 = check_close(site, cb.conv3x3_bnact(**a32),
                            cb.conv3x3_bnact_ref(**a32), torch.float32)
        a16 = {k_: (v.to(torch.bfloat16) if k_ in ("x", "w", "skip", "w_skip")
                    else v) if torch.is_tensor(v) else v
               for k_, v in a32.items()}
        # the weights packed once, as the up-stage keeps them
        packed = cb.pack_weights(a16["w"], a16["w_skip"])
        out = cb.conv3x3_bnact(**a16, packed=packed)
        err16 = check_close(site, out, cb.conv3x3_bnact_ref(**a16),
                            torch.bfloat16)
        flops = 2.0 * n * h * w * cout * 9 * (cx + cs)
        bms, by = bound_ms(nbytes(a16["x"], a16["skip"], a16["w"],
                                  a16["w_skip"], a16["scale"], a16["shift"],
                                  out), flops)
        rows.append(dict(
            site=site, path=path, frame=path == "magnet", err_f32=err32,
            err_bf16=err16,
            ms=graph_ms(lambda: cb.conv3x3_bnact(**a16, packed=packed)),
            plain_ms=plain_time(lambda: cb.conv3x3_bnact_ref(**a16)),
            # cuDNN over the same contraction: one conv over [up | skip]
            library_ms=graph_ms(profile_conv.library_conv(a16)),
            bound_ms=bms, bound_by=by, gflop=flops / 1e9))
    return rows


def check_head_kernel(dev):
    g = torch.Generator().manual_seed(1)
    rows = []
    for site, path, xs, widths in head_sites():
        n, h, w, c0 = xs
        convs, cin = [], c0
        for i, co in enumerate(widths):
            ks = 3 if i == 0 else 1
            convs.append((_randn(g, ks, ks, cin, co,
                                 scale=(ks * ks * cin) ** -0.5).to(dev),
                          (_randn(g, co) * 0.1).to(dev), i < len(widths) - 1))
            cin = co
        x = _randn(g, *xs).to(dev)
        err32 = check_close(site, hc.head_chain(x, convs),
                            hc.head_chain_ref(x, convs), torch.float32)
        x16 = x.to(torch.bfloat16)
        c16 = [(k.to(torch.bfloat16), b, r) for k, b, r in convs]
        ops = hc.head_operands(c16)   # kept on the module, as run_head does
        out = hc.head_chain(x16, c16, ops)
        err16 = check_close(site, out, hc.head_chain_ref(x16, c16),
                            torch.bfloat16)
        xin = x16.permute(0, 3, 1, 2)
        w0 = c16[0][0].permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        m = n * h * w
        flops = 2.0 * m * (9 * c0 * widths[0] + sum(
            a * b for a, b in zip(widths[:-1], widths[1:])))
        bms, by = bound_ms(nbytes(x16, out, *[k for k, _, _ in c16],
                                  *[b for _, b, _ in c16]), flops)
        rows.append(dict(
            site=site, path=path, frame=path == "magnet", err_f32=err32,
            err_bf16=err16, ms=graph_ms(lambda: hc.head_chain(x16, c16, ops)),
            plain_ms=plain_time(lambda: hc.head_chain_ref(x16, c16)),
            library_ms=graph_ms(lambda: F.conv2d(xin, w0, padding=1)),
            bound_ms=bms, bound_by=by, gflop=flops / 1e9))
    return rows


def plan_stats(a: list) -> dict:
    """The kernel's plan for these inputs (``cost_volume_cw_plan``, run on
    their device): the share of in-image corners that staged windows serve,
    the bytes copied into shared memory, and the bytes a plain gather
    requests (every in-image corner of every valid view's sample reads C
    features and the (mu, sigma) pair)."""
    p = cvk.cost_volume_cw_plan(*a[:10])
    src = a[2]
    return dict(staged_share=p["staged_corners"] / max(p["corners"], 1),
                staged_jobs=p["staged_jobs"], global_jobs=p["global_jobs"],
                smem_mb=p["smem_bytes"] / 1e6, corners=p["corners"],
                gather_mb=p["corners"] * (src.shape[-1] + 2)
                * src.element_size() / 1e6)


def check_cost_volume_kernel(dev):
    """Row 4 at the MaGNet main path (ScanNet: 120x160, V = 4), at a 0.9 rad
    roll, with one view invalid, at the KITTI cost volume (88x304, V = 2)
    and as one rank of a view-sharded frame computes it (at the main path's
    shape, the first 2 of 4 views divided by the global ``v_total`` = 4);
    the last four timed, in no frame's sum; timed on (mu, sigma) pairs
    packed once, as ``Magnet.fuse`` keeps them."""
    g = torch.Generator().manual_seed(2)
    rows = []
    kitti = dict(hc=KITTI_HC, wc=KITTI_WC, views=KITTI_VIEWS)
    for site, path, kw in (("main path", "magnet", {}),
                           ("roll 0.9 rad", "magnet", dict(roll=0.9)),
                           ("one view invalid", "magnet", dict(invalid=True)),
                           ("KITTI", "kitti", kitti),
                           (SHARD_SITE, "magnet", {})):
        a32 = [t.to(dev) for t in cv_case(g, **kw)]
        v_total = None
        if site == SHARD_SITE:
            # a rank's contiguous half of the views: src, mu, sigma, R, t,
            # is_valid
            v_total = a32[2].shape[1]
            a32 = [t[:, :v_total // 2] if 2 <= i <= 7 else t
                   for i, t in enumerate(a32)]
        views = a32[2].shape[1]
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            a = a32[:1] + [t.to(dtype) for t in a32[1:3]] + a32[3:]
            out = cvk.cost_volume_cw(*a, 5.0, v_total=v_total)
            torch.cuda.synchronize()
            ref, margin = cvk.cost_volume_cw_ref(*a, 5.0, return_margin=True,
                                                 v_total=v_total)
            err, lim, excluded = cvk.compare(out, ref, margin,
                                             KERNEL_TOL[torch.float32])
            if not ref.abs().max() > 0.1:
                raise RuntimeError("cost volume: degenerate inputs")
            log(f"  cost_volume_cw ({site}) {str(dtype)[6:]}: max_abs_err "
                f"{err:.3e} (limit {lim:.3e}), {excluded:.5f} of the "
                f"elements within {cvk.MARGIN} of the threshold left out")
            errs[dtype] = err
        n_valid = int(a[7].sum())
        # each input once, the output once; an invalid view's maps are not
        # needed; mu and sigma are read packed in the features' type
        ops = cvk.cv_operands(a[3], a[4], a[2].dtype)
        need = (nbytes(a[0], a[1], *a[5:], out)
                + (nbytes(a[2]) + nbytes(ops)) * n_valid // views)
        samples = a[0].numel() * n_valid
        flops = samples * (2.0 * 4 * (FEAT + 2) + 60)
        bms, by = bound_ms(need, flops)
        rows.append(dict(
            site=f"cost_volume_cw ({site})", path=path,
            frame=site == "main path", err_f32=errs[torch.float32],
            err_bf16=errs[torch.bfloat16],
            ms=graph_ms(lambda: cvk.cost_volume_cw(*a, 5.0, ops, v_total)),
            plain_ms=plain_time(lambda: cvk.cost_volume_cw_ref(
                *a, 5.0, v_total=v_total)),
            library_ms=None, bound_ms=bms, bound_by=by, gflop=flops / 1e9,
            compulsory_mb=need / 1e6, **plan_stats(a)))
        if v_total is not None:
            # the same launch divided by its own V: the divisor is all that
            # differs, and both are powers of two
            own = cvk.cost_volume_cw(*a, 5.0)
            exact = torch.equal(own, out * (v_total / views))
            log(f"  cost_volume_cw ({site}): the launch at v_total = "
                f"{v_total} times {v_total // views} equals the launch at "
                f"V = {views} bit for bit {exact}")
            if not exact:
                raise RuntimeError("cost_volume_cw: v_total is not the "
                                   "divisor")
    return rows


def check_gnet_kernel(dev):
    """Row 5 at the ScanNet and the KITTI cost-volume maps, on operands
    packed once (as ``GNet`` keeps them). The library time is cuDNN's
    layer-0 3x3 conv alone; ``chain_ms`` beside it is the whole update in
    bf16 cuDNN convs and elementwise ops."""
    g = torch.Generator().manual_seed(3)
    rows = []
    for site, path, (hc, wc) in (("gnet_update", "magnet", (HC, WC)),
                                 ("gnet_update KITTI", "kitti",
                                  (KITTI_HC, KITTI_WC))):
        cv = _randn(g, 1, hc, wc, SAMPLES).to(dev)
        feat = _randn(g, 1, hc, wc, 128, scale=0.5).to(dev)
        prev = torch.stack([2.0 + 0.3 * _randn(g, 1, hc, wc),
                            0.1 + 0.3 * torch.rand(1, hc, wc, generator=g)],
                           -1).to(dev)
        convs = [(_randn(g, 3, 3, SAMPLES, 128,
                         scale=(9 * SAMPLES) ** -0.5).to(dev), None)]
        for co in (128, 128, 2):
            convs.append((_randn(g, 1, 1, 128, co,
                                 scale=128 ** -0.5).to(dev),
                          _randn(g, co, scale=0.1).to(dev)))
        err32 = check_close(site, gk.gnet_update(cv, feat, prev, convs),
                            gk.gnet_update_ref(cv, feat, prev, convs),
                            torch.float32)
        bf = torch.bfloat16
        a = (cv.to(bf), feat.to(bf), prev.to(bf),
             [(k.to(bf), b) for k, b in convs])
        ops = gk.gnet_operands(a[3])
        out = gk.gnet_update(*a, ops)
        # mu passes through from prev and dominates max|out|, so in bf16 the
        # update out - prev is what is held to the plain version's: to 2e-2
        # of the largest update, or to one bf16 ulp of the largest output
        # where that is more (the output itself is rounded to bf16, and two
        # correct programs may round a value on the boundary either way).
        ref = gk.gnet_update_ref(*a)
        torch.cuda.synchronize()
        upd, upd_ref = out.float() - a[2].float(), ref.float() - a[2].float()
        err16 = (upd - upd_ref).abs().max().item()
        ulp = 2.0 ** (np.floor(np.log2(ref.float().abs().max().item())) - 7)
        lim = max(KERNEL_TOL[bf] * upd_ref.abs().max().item(), ulp)
        log(f"  {site} bfloat16, the update out - prev: max_abs_err "
            f"{err16:.3e} (limit {lim:.3e}; largest update "
            f"{upd_ref.abs().max().item():.3e}, output ulp {ulp:.3e})")
        if not torch.isfinite(out).all() or not err16 <= lim:
            raise RuntimeError(f"{site}: the bf16 update disagrees with its "
                               "plain version")
        m = hc * wc
        flops = 2.0 * m * (9 * SAMPLES * 128 + 2 * 128 * 128 + 128 * 2)
        bms, by = bound_ms(nbytes(*a[:3], out, *[k for k, _ in a[3]],
                                  *[b for _, b in a[3]]), flops)
        xin = a[0].permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        w0 = a[3][0][0].permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        rows.append(dict(
            site=site, path=path, frame=path == "magnet", err_f32=err32,
            err_bf16=err16, ms=graph_ms(lambda: gk.gnet_update(*a, ops)),
            plain_ms=plain_time(lambda: gk.gnet_update_ref(*a)),
            library_ms=graph_ms(lambda: F.conv2d(xin, w0, padding=1)),
            chain_ms=graph_ms(gk.cudnn_gnet(*a)),
            bound_ms=bms, bound_by=by, gflop=flops / 1e9))
    return rows


def check_upsample_kernel(dev):
    """Row 11 as MaGNet calls it (the ITERS maps of a frame through one
    mask, one launch) and as the D-Net does (one map); each map of the
    MaGNet call must equal its one-map call bit for bit."""
    g = torch.Generator().manual_seed(4)
    mask = _randn(g, 1, HC, WC, 9 * 16, scale=2.0).to(dev)
    maps = [_randn(g, 1, HC, WC, 2).to(dev) for _ in range(ITERS)]
    rows = []
    for site, path, n in ((f"upsample_mask, {ITERS} maps", "magnet", ITERS),
                          ("upsample_mask, 1 map", "dnet", 1)):
        d32 = maps[:n]
        err32 = max(check_close(f"{site}", o, r, torch.float32) for o, r in zip(
            uk.upsample_mask(d32, mask, 4), uk.upsample_mask_ref(d32, mask, 4)))
        d16, m16 = [d.to(torch.bfloat16) for d in d32], mask.to(torch.bfloat16)
        outs = uk.upsample_mask(d16, m16, 4)
        err16 = max(check_close(f"{site}", o, r, torch.bfloat16) for o, r in
                    zip(outs, uk.upsample_mask_ref(d16, m16, 4)))
        if not all(torch.equal(o, uk.upsample_mask(d, m16, 4))
                   for d, o in zip(d16, outs)):
            raise RuntimeError(f"{site}: a map differs from its one-map call")
        flops = n * HC * WC * 16 * (9 * 3.0 + 9 * 2 * 2)
        bms, by = bound_ms(nbytes(*d16, m16, *outs), flops)
        rows.append(dict(
            site=site, path=path, frame=path == "magnet", err_f32=err32,
            err_bf16=err16, ms=graph_ms(lambda: uk.upsample_mask(d16, m16, 4)),
            plain_ms=plain_time(lambda: uk.upsample_mask_ref(d16, m16, 4)),
            library_ms=None, bound_ms=bms, bound_by=by, gflop=flops / 1e9))
    return rows


def check_upsample_bwd_kernel(dev):
    """The convex upsampling's backward (port-only) against autograd through
    the plain version, at the two training sites: MaGNet (batch
    MAGNET_TRAIN_B, the ITERS maps of a step through one mask, 120x160 ->
    480x640) and the D-Net (batch DNET_TRAIN_B, one map, 104x136 -> the
    416x544 crop), f32 and bf16 at KERNEL_TOL of each gradient's largest
    element; two calls equal bit for bit (no atomics)."""
    g = torch.Generator().manual_seed(8)
    rows = []
    for site, path, B, h, w, n in (
            (f"upsample_mask_bwd, {ITERS} maps (MaGNet train)",
             "magnet_train", MAGNET_TRAIN_B, HC, WC, ITERS),
            ("upsample_mask_bwd, 1 map (D-Net train)", "dnet_train",
             DNET_TRAIN_B, DNET_CROP[0] // 4, DNET_CROP[1] // 4, 1)):
        mask32 = _randn(g, B, h, w, 9 * 16, scale=2.0).to(dev)
        maps32 = [_randn(g, B, h, w, 2).to(dev) for _ in range(n)]
        gouts32 = [_randn(g, B, 4 * h, 4 * w, 2).to(dev) for _ in range(n)]
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            mask, maps = mask32.to(dt), [d.to(dt) for d in maps32]
            gouts = [x.to(dt) for x in gouts32]
            got = uk.upsample_mask_bwd(gouts, maps, mask, 4)
            want = uk.upsample_mask_bwd_ref(gouts, maps, mask, 4)
            errs[dt] = max(check_close(f"{site}, {name}", a, b, dt)
                           for name, a, b in zip(
                               ["grad map"] * n + ["grad mask"],
                               got[0] + [got[1]], want[0] + [want[1]]))
            again = uk.upsample_mask_bwd(gouts, maps, mask, 4)
            if not all(torch.equal(a, b) for a, b in
                       zip(got[0] + [got[1]], again[0] + [again[1]])):
                raise RuntimeError(f"{site}: two calls differ")
        kk, fine = 16, B * h * w * 16
        # per fine pixel the softmax (9 exp, 9 sub, 9 mul, 9 add) and the
        # mask's gradient (9 n C FMAs, 9 FMAs, 9 mul); per coarse pixel, map
        # and channel 9 kk FMAs
        flops = fine * (36 + 2 * 9 * n * 2 + 27) + 2 * B * h * w * n * 2 * 9 * kk
        bms, by = bound_ms(nbytes(*gouts, *maps, mask, *got[0], got[1]), 0.0,
                           f32_flops=flops)
        rows.append(dict(
            site=site, path=path, frame=True, err_f32=errs[torch.float32],
            err_bf16=errs[torch.bfloat16],
            ms=graph_ms(lambda: uk.upsample_mask_bwd(gouts, maps, mask, 4)),
            plain_ms=cuda_ms(lambda: uk.upsample_mask_bwd_ref(
                gouts, maps, mask, 4), iters=3, warmup=1),
            library_ms=None, bound_ms=bms, bound_by=by, gflop=flops / 1e9))
    return rows


def _bn_pair(g, n, c, dev):
    """Folded BN (scale, shift), each (n, c) f32 on the card."""
    return ((torch.rand(n, c, generator=g) * 0.5 + 0.5).to(dev),
            _randn(g, n, c, scale=0.1).to(dev))


def _nchw_cl(x):
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _oihw_cl(w):
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def _psm_row(site, name, fn, ref, a32, typed, convs, n_bytes_of, flops,
             path="magnet", pack=None):
    """Check ``fn`` against ``ref`` in f32 and bf16 on the operands ``a32``
    (those at ``typed`` take the compute type) and time it in bf16.
    ``convs``: (x NHWC, w HWIO, stride, padding, dilation) of the cuDNN
    calls over the same contractions, built from the bf16 operands.
    ``pack``: the bf16 operands' packed weights, made once as the module
    keeps them and passed as ``packed``. Rows off the MaGNet path (KITTI)
    are held and timed but in no frame's sum."""
    err32 = check_close(site, fn(*a32), ref(*a32), torch.float32)
    a16 = [t.to(torch.bfloat16) if i in typed else t
           for i, t in enumerate(a32)]
    kw = {"packed": pack(a16)} if pack else {}
    out = fn(*a16, **kw)
    err16 = check_close(site, out, ref(*a16), torch.bfloat16)
    lib = [(_nchw_cl(x), _oihw_cl(w), s, p, d) for x, w, s, p, d in convs(a16)]
    bms, by = bound_ms(n_bytes_of(a16, out), flops)
    return dict(
        site=site, kernel=name, path=path, frame=path == "magnet",
        err_f32=err32, err_bf16=err16, ms=graph_ms(lambda: fn(*a16, **kw)),
        plain_ms=plain_time(lambda: ref(*a16)),
        library_ms=graph_ms(lambda: [F.conv2d(x, w, None, s, p, d)
                                     for x, w, s, p, d in lib]),
        bound_ms=bms, bound_by=by, gflop=flops / 1e9)


def check_psm_kernels(dev):
    """The F-Net's four kernels at the shapes one pass over the 5 frames of
    a MaGNet sample gives them, and rows 6-8 at those of the 3 frames of a
    KITTI sample (352x1216: maps of 176x608 and 88x304). The library time is
    cuDNN's over the same convs alone (no BN, ReLU or sum), each on an input
    of the right shape."""
    g = torch.Generator().manual_seed(6)
    rows = []
    for tag, path, n, (h, w) in (("", "magnet", 1 + VIEWS, (H, W)),
                                 (" KITTI", "kitti", KITTI_FRAMES,
                                  (KITTI_H, KITTI_W))):
        half, quarter = (h // 2, w // 2), (h // 4, w // 4)
        # (site, channels, blocks, map, dilation, residual)
        for site, c, blocks, hw, dil, residual in (
                ("stem convs 2-3", 32, 1, half, 1, False),
                ("layer1", 32, 3, half, 1, True),
                ("layer2 blocks 1-15", 64, 15, quarter, 1, True),
                ("layer3 blocks 1-2", 128, 2, quarter, 1, True),
                ("layer4 (dilation 2)", 128, 3, quarter, 2, True)):
            nc = 2 * blocks
            a32 = [_randn(g, n, *hw, c, scale=0.5).to(dev),
                   _randn(g, nc, 3, 3, c, c, scale=(9 * c) ** -0.5).to(dev),
                   *_bn_pair(g, nc, c, dev)]
            rows.append(_psm_row(
                f"fused_residual_stage ({site}){tag}", "fused_residual_stage",
                lambda *a, d=dil, r=residual, packed=None:
                    pb.fused_residual_stage(*a, d, r, packed=packed),
                lambda *a, d=dil, r=residual: pb.fused_residual_stage_ref(
                    *a, d, r),
                a32, (0, 1),
                lambda a, d=dil: [(a[0], w_, 1, d, d) for w_ in a[1]],
                lambda a, out: nbytes(*a, out),
                2.0 * n * hw[0] * hw[1] * c * 9 * c * nc, path,
                lambda a: pb.pack_chain(a[1])))
        for name, ci, co, hw, stride in (
                ("downsample_block", 32, 64, half, 2),
                ("expand_block", 64, 128, quarter, 1)):
            a32 = [_randn(g, n, *hw, ci, scale=0.5).to(dev)]
            for k, cin in ((3, ci), (3, co), (1, ci)):
                s_, t_ = _bn_pair(g, 1, co, dev)
                a32 += [_randn(g, k, k, cin, co,
                               scale=(k * k * cin) ** -0.5).to(dev), s_[0],
                        t_[0]]
            ho, wo = (hw[0] - 1) // stride + 1, (hw[1] - 1) // stride + 1
            mid = torch.zeros(n, ho, wo, co, device=dev, dtype=torch.bfloat16)
            rows.append(_psm_row(
                name + tag, name, getattr(pb, name), getattr(pb, name + "_ref"),
                a32, (0, 1, 4, 7),
                lambda a, s=stride, m=mid: [(a[0], a[1], s, 1, 1),
                                            (m, a[4], 1, 1, 1),
                                            (a[0], a[7], s, 0, 1)],
                lambda a, out: nbytes(*a, out),
                2.0 * n * ho * wo * co * (9 * ci + 9 * co + ci), path,
                lambda a: pb.pack_chain((a[1], a[4], a[7]))))
    widths = (64, 128, 128)
    for tag, path, n, (hc, wc) in (("", "magnet", 1 + VIEWS, (HC, WC)),
                                   (" KITTI", "kitti", KITTI_FRAMES,
                                    (KITTI_HC, KITTI_WC))):
        a32 = [_randn(g, n, hc, wc, c, scale=0.5).to(dev) for c in widths]
        s_, t_ = _bn_pair(g, 1, 128, dev)
        a32 += [_randn(g, 3, 3, 320, 128, scale=2880 ** -0.5).to(dev), s_[0],
                t_[0], _randn(g, 128, FEAT, scale=128 ** -0.5).to(dev)]
        rows.append(_psm_row(
            "spp_tail" + tag, "spp_tail", st.spp_tail, st.spp_tail_ref, a32,
            (0, 1, 2, 3, 6),
            lambda a: [(torch.cat(a[:3], -1), a[3], 1, 1, 1)],
            lambda a, out: nbytes(*a, out),
            2.0 * n * hc * wc * 128 * (9 * 320 + FEAT), path,
            lambda a: st.tail_operands(a[3], a[6], widths)))
    return rows


def sweep_work(a: list, out: torch.Tensor) -> tuple:
    """Bytes and f32 operations the gradient needs for these inputs: each
    input read once and the output written once; per in-image corner of a
    valid view's sample a multiply-add per channel, per sample the
    projection (about 30 operations); and the count of in-image corners
    and of the C-wide reductions of the merged walk as its plain PyTorch
    emulation ``sweep_grad_src_walk`` emits them (run on the same device;
    the kernel does not count its own)."""
    corners, samples = sweep_samples(a)
    walk = sgk.sweep_grad_src_walk(*a)[1]
    return (nbytes(*a, out), 2.0 * FEAT * corners + 30.0 * samples, corners,
            walk)


def check_sweep_forward(dev):
    """The cost volume kernel as the sweep's forward calls it
    (``ops.costvolume.sweep_forward_args``: every pixel's candidates the 80
    SID planes, mu 0, sigma 1e30 packed in the features' type, kappa 1) at
    the F-Net training shape, f32 and bf16 features, at small motion, at a
    0.9 rad roll and with one view invalid. There is no consistency
    threshold to leave elements out for: both sides take exact products of
    the same values and sum them in f32, so 1e-4 * max|ref| in both types."""
    rows = []
    for site, kw in (("sweep forward", {}),
                     ("sweep forward, roll 0.9 rad", dict(roll=0.9)),
                     ("sweep forward, one view invalid", dict(invalid=True))):
        case = sweep_case(**kw)
        g = torch.Generator().manual_seed(10)
        src32 = _randn(g, TRAIN_B, VIEWS, HC, WC, FEAT).to(dev)
        geo = [x.to(dev) for x in case[3:]]
        d_center, ref32 = case[0].to(dev), case[1].to(dev)
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            a = sweep_forward_args(d_center, ref32.to(dtype),
                                   src32.to(dtype), *geo)
            out = cvk.cost_volume_cw(*a)
            ref = cvk.cost_volume_cw_ref(*a)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            lim = KERNEL_TOL[torch.float32] * ref.abs().max().item()
            log(f"  cost_volume_cw ({site}) {str(dtype)[6:]}: max_abs_err "
                f"{err:.3e} (limit {lim:.3e})")
            if (out.shape != ref.shape or not torch.isfinite(out).all()
                    or not err <= lim or not ref.abs().max() > 0.1):
                raise RuntimeError("cost_volume_cw disagrees with its plain "
                                   "version at the sweep forward")
            errs[dtype] = err
        corners, samples = sweep_samples(case)
        n_valid = int(case[5].sum())
        # the sweep's own inputs once (the depths as D planes, a view's
        # features only where it is valid) and the output once; per
        # in-image corner a multiply-add per channel, per sample the dot
        # over C and the projection
        need = (nbytes(d_center, a[1], out, *geo)
                + nbytes(a[2]) * n_valid // (TRAIN_B * VIEWS))
        flops = 2.0 * FEAT * corners + (2.0 * FEAT + 30.0) * samples
        bms, by = bound_ms(need, flops, PEAK_F32_FLOPS)
        rows.append(dict(
            site=f"cost_volume_cw ({site})", path="fnet_train",
            frame=site == "sweep forward", err_f32=errs[torch.float32],
            err_bf16=errs[torch.bfloat16],
            ms=graph_ms(lambda: cvk.cost_volume_cw(*a)),
            plain_ms=plain_time(lambda: cvk.cost_volume_cw_ref(*a)),
            library_ms=None, bound_ms=bms, bound_by=by, gflop=flops / 1e9,
            compulsory_mb=need / 1e6, **plan_stats(a)))
    return rows


def check_sweep_kernel(dev):
    """Row 10 at the F-Net training shape (B = 2, V = 4, D = 80, 120x160,
    C = 64): f32 and bf16 features against the plain version, at small
    motion, at a 0.9 rad roll and with one view invalid. The library time is
    ATen's bilinear transpose (``grid_sampler_2d_backward``, zeros padding,
    align_corners=False) over the same samples, the planes along the grid's
    width, ``gbar * valid * ref`` as its incoming gradient, in f32."""
    rows = []
    for site, kw in (("main path", {}), ("roll 0.9 rad", dict(roll=0.9)),
                     ("one view invalid", dict(invalid=True))):
        a32 = [x.to(dev) for x in sweep_case(**kw)]
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            a = a32[:1] + [a32[1].to(dtype)] + a32[2:]
            out = sgk.sweep_grad_src(*a)
            errs[dtype] = check_close(f"sweep_grad_src ({site})", out,
                                      sgk.sweep_grad_src_ref(*a), dtype)
            if int(a[5].sum()) < a[5].numel() and out[0, 1].any():
                raise RuntimeError("sweep_grad_src: an invalid view got a "
                                   "gradient")
        n_bytes, flops, corners, walk = sweep_work(a, out)
        bms, by = bound_ms(n_bytes, flops, PEAK_F32_FLOPS)
        library = None
        if site == "main path":
            d, ref, gbar, R, t, valid, K, rays = a32
            B, V = R.shape[:2]
            grid = sweep_grids(a32)
            grad_out = (ref.reshape(B, 1, HC * WC, FEAT, 1)
                        * gbar.reshape(B, 1, HC * WC, 1, TRAIN_D)
                        * valid.reshape(B, V, 1, 1, 1)).permute(
                0, 1, 3, 2, 4).reshape(B * V, FEAT, HC * WC, TRAIN_D)
            inp = torch.empty(B * V, FEAT, HC, WC, device=dev)
            library = graph_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
                grad_out, inp, grid, 0, 0, False, [True, False]), iters=5)
            del grad_out
        rows.append(dict(
            site=f"sweep_grad_src ({site})", path="fnet_train",
            frame=site == "main path", err_f32=errs[torch.float32],
            err_bf16=errs[torch.bfloat16],
            ms=graph_ms(lambda: sgk.sweep_grad_src(*a)),
            ms_f32=graph_ms(lambda: sgk.sweep_grad_src(*a32)),
            plain_ms=plain_time(lambda: sgk.sweep_grad_src_ref(*a)),
            library_ms=library, bound_ms=bms, bound_by=by,
            gflop=flops / 1e9, compulsory_mb=n_bytes / 1e6,
            corners=corners, walk_reductions=walk))
    return rows


def launch_calls(fn) -> int:
    """The kernel launches one call of ``fn`` issues, from the profiler's
    host launch calls."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if "LaunchKernel" in e.name)


def check_sweep_ref_kernel(dev):
    """The sweep's reference gradient (``sweep_grad_ref``, the port's own
    kernel; the JAX package leaves it to XLA) at the F-Net training shape
    (B = 2, V = 4, D = 80, 120x160, C = 64) and row 10's three sites:
    f32 and bf16 source features against the plain re-gather, both to
    1e-4 * max|ref| (the same feature values, exact f32 products summed in
    another order), two calls equal bit for bit (no atomics). The work
    counts every corner (``perfbench/counts/ops/sweep_grad_ref.py``); the
    plain version's launches a call beside its time."""
    rows = []
    for site, kw in (("main path", {}), ("roll 0.9 rad", dict(roll=0.9)),
                     ("one view invalid", dict(invalid=True))):
        case = [x.to(dev) for x in sweep_case(**kw)]
        g = torch.Generator().manual_seed(10)
        src32 = _randn(g, TRAIN_B, VIEWS, HC, WC, FEAT).to(dev)
        a32 = [case[0], src32, *case[2:]]
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            a = a32[:1] + [src32.to(dtype)] + a32[2:]
            out = sgr.sweep_grad_ref(*a)
            ref = sgr.sweep_grad_ref_ref(*a)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            lim = KERNEL_TOL[torch.float32] * ref.abs().max().item()
            log(f"  sweep_grad_ref ({site}) {str(dtype)[6:]}: max_abs_err "
                f"{err:.3e} (limit {lim:.3e})")
            if (out.shape != ref.shape or not torch.isfinite(out).all()
                    or not err <= lim or not ref.abs().max() > 0.1):
                raise RuntimeError("sweep_grad_ref disagrees with its plain "
                                   "version")
            if not torch.equal(out, sgr.sweep_grad_ref(*a)):
                raise RuntimeError("sweep_grad_ref: two calls differ")
            errs[dtype] = err
        samples = TRAIN_B * VIEWS * HC * WC * TRAIN_D
        n_bytes = nbytes(*a, out)
        flops = (2.0 * 4 * FEAT + 30.0) * samples
        bms, by = bound_ms(n_bytes, flops, PEAK_F32_FLOPS)
        rows.append(dict(
            site=f"sweep_grad_ref ({site})", path="fnet_train",
            frame=site == "main path", err_f32=errs[torch.float32],
            err_bf16=errs[torch.bfloat16],
            ms=graph_ms(lambda: sgr.sweep_grad_ref(*a)),
            ms_f32=graph_ms(lambda: sgr.sweep_grad_ref(*a32)),
            plain_ms=plain_time(lambda: sgr.sweep_grad_ref_ref(*a)),
            plain_launches=launch_calls(lambda: sgr.sweep_grad_ref_ref(*a)),
            library_ms=None, bound_ms=bms, bound_by=by, gflop=flops / 1e9,
            compulsory_mb=n_bytes / 1e6))
    return rows


def dw_sites() -> dict:
    """{(map, channels, K): count} of the stride-1 conv_dw that stay outside
    the chains at 480x640 with both switches on."""
    sites, hw = {}, (H // 2, W // 2)
    tails = chain_stages("all")
    for si, stage in enumerate(b5_stage_config()):
        for bi, c in enumerate(stage):
            if c["stride"] != 1:
                hw = (-(-hw[0] // c["stride"]), -(-hw[1] // c["stride"]))
            elif not (si in tails and bi > 0):
                ch = c["in_ch"] * (c["expand"] if c["btype"] == "ir" else 1)
                key = (hw, ch, c["kernel"])
                sites[key] = sites.get(key, 0) + 1
    return sites


def check_dw_kernel(dev):
    """Row 13 at its path-A sites, one frame (D-Net) and 5 (MaGNet). The
    library time is cuDNN's grouped conv on the same bf16 channels-last
    input; the bound counts the taps' multiply-adds at the f32 rate (they
    run outside the tensor cores)."""
    g = torch.Generator().manual_seed(11)
    rows = []
    bf = torch.bfloat16
    for n, path in ((1, "dnet_trunk"), (1 + VIEWS, "magnet_trunk")):
        for (hw, c, k), count in dw_sites().items():
            site = f"dw_conv {hw[0]}x{hw[1]} C={c} K={k} N={n}"
            x = _randn(g, n, *hw, c).to(dev)
            w = _randn(g, k, k, c, scale=1.0 / k).to(dev)
            err32 = check_close(site, dwk.dw_conv(x, w),
                                dwk.dw_conv_ref(x, w), torch.float32)
            x16, w16 = x.to(bf), w.to(bf)
            out = dwk.dw_conv(x16, w16)
            err16 = check_close(site, out, dwk.dw_conv_ref(x16, w16), bf)
            xin = x16.permute(0, 3, 1, 2)
            wlib = w16.permute(2, 0, 1)[:, None].contiguous()
            flops = 2.0 * n * hw[0] * hw[1] * c * k * k
            bms, by = bound_ms(nbytes(x16, w16, out), 0.0, f32_flops=flops)
            rows.append(dict(
                site=site, path=path, frame=True, count=count, err_f32=err32,
                err_bf16=err16, ms=graph_ms(lambda: dwk.dw_conv(x16, w16)),
                plain_ms=plain_time(lambda: dwk.dw_conv_ref(x16, w16)),
                library_ms=graph_ms(lambda: F.conv2d(xin, wlib, None, 1,
                                                     k // 2, 1, c)),
                bound_ms=bms, bound_by=by, gflop=flops / 1e9))
    return rows


def check_mbchain_kernel(dev):
    """Row 12 at the six stage tails of a 480x640 trunk pass, one frame
    (D-Net) and 5 (MaGNet). Bound, per site: the two 1x1 GEMMs at the bf16
    tensor-core rate or the depthwise taps and the SE layers at the f32
    rate, whichever is longer (the units overlap), or each input (x, the
    stacked operands) read once and the output written once."""
    rows = []
    bf = torch.bfloat16
    for si, nb, hw, c, m, k in trunk_tail_sites():
        blocks = random_chain(nb, c, m, k, 100 * si)
        ops32 = [t.to(dev) for t in fold_mbconv_chain(blocks, torch.float32)]
        ops16 = [t.to(bf) if k in ("wpw", "wdw", "wpwl") else t
                 for k, t in zip(CHAIN_OPERANDS, ops32)]
        r = ops32[CHAIN_OPERANDS.index("wse1")].shape[-1]
        for n, path in ((1, "dnet_trunk"), (1 + VIEWS, "magnet_trunk")):
            g = torch.Generator().manual_seed(12 + si)
            site = (f"mbconv_chain stage {si} ({nb} blocks, {hw[0]}x{hw[1]}, "
                    f"C={c}, M={m}, K={k}) N={n}")
            x = _randn(g, n, *hw, c, scale=0.5).to(dev)
            err32 = check_close(site, mbk.mbconv_chain(x, *ops32, k),
                                mbk.mbconv_chain_ref(x, *ops32, k),
                                torch.float32)
            x16 = x.to(bf)
            out = mbk.mbconv_chain(x16, *ops16, k)
            err16 = check_close(site, out, mbk.mbconv_chain_ref(x16, *ops16, k),
                                bf)
            pix = n * hw[0] * hw[1]
            gemm = 2.0 * nb * pix * c * m * 2
            other = 2.0 * nb * (pix * m * k * k + 2 * n * m * r)
            bms, by = bound_ms(nbytes(x16, out, *ops16), gemm, f32_flops=other)
            rows.append(dict(
                site=site, path=path, frame=True, err_f32=err32,
                err_bf16=err16,
                ms=graph_ms(lambda: mbk.mbconv_chain(x16, *ops16, k)),
                plain_ms=plain_time(
                    lambda: mbk.mbconv_chain_ref(x16, *ops16, k)),
                library_ms=None, bound_ms=bms, bound_by=by,
                gflop=(gemm + other) / 1e9,
                launches=nb * mbk.LAUNCHES_PER_BLOCK))
    return rows


def resblock_sites() -> list:
    """(site, map, C, dilation, blocks per F-Net pass) of row 14 at the
    KITTI shape."""
    half = (KITTI_H // 2, KITTI_W // 2)
    quarter = (KITTI_HC, KITTI_WC)
    return [("layer1", half, 32, 1, 3),
            ("layer2 blocks 1-15", quarter, 64, 1, 15),
            ("layer3 blocks 1-2", quarter, 128, 1, 2),
            ("layer4 (dilation 2)", quarter, 128, 2, 3)]


def check_resblock_kernel(dev):
    """Row 14 at the four layer shapes of one KITTI F-Net pass (3 frames),
    on operands packed once as ``PSMNet`` keeps them. Bound: both convs at
    the bf16 tensor-core rate, or x, the weights and the folded BN read
    once and the output written once. cuDNN's time for the block's two
    convs alone is kept beside it (no one library call computes the block),
    and row 6's chain over the site's blocks (the default path), timed as
    one chain of ``count`` blocks on the same operands."""
    g = torch.Generator().manual_seed(13)
    n = 1 + KITTI_VIEWS
    bf = torch.bfloat16
    rows = []
    for name, hw, c, dil, count in resblock_sites():
        site = f"res_block {name} ({hw[0]}x{hw[1]}, C={c}) N={n}"
        a32 = [_randn(g, n, *hw, c, scale=0.5).to(dev)]
        for _ in range(2):
            s_, t_ = _bn_pair(g, 1, c, dev)
            a32 += [_randn(g, 3, 3, c, c, scale=(9 * c) ** -0.5).to(dev),
                    s_[0], t_[0]]
        err32 = check_close(site, rbk.res_block(*a32, dil),
                            rbk.res_block_ref(*a32, dil), torch.float32)
        a16 = [t.to(bf) if i in (0, 1, 4) else t for i, t in enumerate(a32)]
        packed = pb.pack_chain((a16[1], a16[4]))
        out = rbk.res_block(*a16, dil, packed)
        err16 = check_close(site, out, rbk.res_block_ref(*a16, dil), bf)
        flops = 2.0 * 2 * n * hw[0] * hw[1] * 9 * c * c
        bms, by = bound_ms(nbytes(*a16, out), flops)
        xin, w1, w2 = _nchw_cl(a16[0]), _oihw_cl(a16[1]), _oihw_cl(a16[4])
        chain = [torch.stack([a16[i], a16[i + 3]] * count) for i in (1, 2, 3)]
        chain_packed = pb.pack_chain(chain[0])
        rows.append(dict(
            site=site, path="magnet_kitti", frame=True, count=count,
            err_f32=err32, err_bf16=err16,
            ms=graph_ms(lambda: rbk.res_block(*a16, dil, packed)),
            plain_ms=plain_time(lambda: rbk.res_block_ref(*a16, dil)),
            library_ms=None,
            cudnn_convs_ms=graph_ms(lambda: [
                F.conv2d(xin, w, None, 1, dil, dil) for w in (w1, w2)]),
            chain_ms=graph_ms(lambda: pb.fused_residual_stage(
                a16[0], *chain, dil, packed=chain_packed)),
            bound_ms=bms, bound_by=by, gflop=flops / 1e9))
    return rows


# ---- phases 4 and 5: the D-Net path ----------------------------------------

def dnet_args(device: str, dtype: str, frames: int, exp_dir: str,
              extra=()):
    return config.parse_args(config.build_test_dnet_parser(), [
        "--exp_name", "chip_smoke", "--exp_dir", exp_dir,
        "--output_dim", "2", "--output_type", "G", "--downsample_ratio", "4",
        "--DNET_architecture", "DenseDepth_BN", "--dataset_name", "synthetic",
        "--dataset_path", "none", "--input_height", str(H),
        "--input_width", str(W), "--ckpt_path", "", "--compute_dtype", dtype,
        "--synthetic_length", str(frames), "--device", device, *extra])


def count_by_stage(decoder):
    """The conv kernel serves two TPU kernels (up2, up3): forward hooks on
    the two decoder stages attribute its launches to each. Returns the
    running per-stage counts and the hooks to remove."""
    start, per_stage, hooks = {}, {"up2": 0, "up3": 0}, []
    for stage in per_stage:
        mod = getattr(decoder, stage)
        hooks.append(mod.register_forward_pre_hook(
            lambda m, i, s=stage: start.__setitem__(
                s, cb.conv3x3_bnact.launches)))
        hooks.append(mod.register_forward_hook(
            lambda m, i, o, s=stage: per_stage.__setitem__(
                s, per_stage[s] + cb.conv3x3_bnact.launches - start[s])))
    return per_stage, hooks


def check_counts(path: str, counts: dict, per_stage: dict, per_frame: dict,
                 frames: int) -> dict:
    """Launches found on a path against what its code predicts per frame;
    returns the counts with the conv kernel's split by decoder stage."""
    found = dict(counts, up2=per_stage["up2"], up3=per_stage["up3"])
    want = {k: v * frames for k, v in per_frame.items()}
    log(f"  launches over {frames} frames: found {found}, expected {want}")
    if found != want:
        raise RuntimeError(f"the {path} path did not run every kernel as "
                           "expected")
    return found


def run_dnet_path(frames: int, exp_dir: str, extra=(),
                  trunk: dict = None, decoder: dict = None) -> dict:
    """The D-Net through test_dnet's code with the flags ``extra``; ``trunk``
    holds the launches per frame of the trunk's kernels they predict,
    ``decoder`` those of the decoder and heads (default BN_DECODER)."""
    args = config.setup_exp_dirs(dnet_args("cuda", "bfloat16", frames,
                                           exp_dir, extra))
    model, forward = test_dnet.prepare(args)
    outs, secs = [], []

    def recorded(img):
        t = time.perf_counter()
        out = forward(img)                 # ends in a copy to the host
        secs.append(time.perf_counter() - t)
        outs.append(out)
        return out

    per_stage, hooks = count_by_stage(model.d_net.decoder)
    reset_counts()
    metrics = test_dnet.evaluate(args, recorded)
    counts = read_counts()
    for h in hooks:
        h.remove()
    # per frame: conv_a and conv_b in up2 and in up3, the depth and the mask
    # head, one convex upsampling; nothing of the fusion or the F-Net
    want = dict(dict.fromkeys(WRAPPERS, 0), up2=0, up3=0)
    want.update(decoder or BN_DECODER)
    want.update(trunk or {})
    launches = check_counts("D-Net", counts, per_stage, want, frames)
    for out in outs:
        if out.shape != (1, H, W, 2) or not np.isfinite(out).all():
            raise RuntimeError(f"bad D-Net output {out.shape}")
        if not (out[..., 1] > 0).all():
            raise RuntimeError("variance not positive")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"non-finite metrics {metrics}")

    # Steady state: the same frame, ten forwards back to back (CUDA events;
    # while the eager forward is host-bound they time the enqueue).
    img = SyntheticSingleView(args).get(0)["img"]
    x = torch.from_numpy(img[None]).to("cuda", torch.bfloat16)
    with torch.inference_mode():
        ev_ms = cuda_ms(lambda: model(x), iters=10, warmup=2)
        prof = profile_summary(lambda: model(x))
    host_ms = 1e3 * float(np.mean(secs[1:] or secs))
    log(f"  forward {host_ms:.3f} ms/frame host clock incl. copies "
        f"({1e3 / host_ms:.2f} frames/s); {ev_ms:.3f} ms/frame by CUDA "
        f"events over back-to-back forwards; bf16, batch 1")
    return dict(launches=launches, metrics=metrics, forward_ms=host_ms,
                fps=1e3 / host_ms, events_ms=ev_ms, profile=prof)


def profile_summary(forward, frames: int = 3) -> dict:
    """``kernel_profile`` over ``frames`` forwards, logged: busy time, idle
    share and launches per frame, the ported kernels' time."""
    prof = kernel_profile(forward, frames)
    log(f"  profiler over {frames} forwards: "
        f"{prof['device_busy_ms_per_frame']:.4f} ms busy per frame of "
        f"{prof['wall_ms_per_frame']:.4f}, idle share "
        f"{prof['device_idle_share']:.4f}, "
        f"{prof['kernel_launches_per_frame']:.1f} launches per frame, ported "
        f"kernels {prof['ported_kernels_ms_per_frame']:.4f} ms")
    for k in prof["top_kernels"][:6]:
        log(f"    {k['ms_per_frame']:8.4f} ms x{k['launches_per_frame']:6.1f}"
            f"  {k['name'][:90]}")
    return prof


def check_f32_forward(exp_dir: str) -> float:
    """One f32 forward on the card (kernels, TF32 off) against the same
    forward on the CPU (plain versions)."""
    args = dnet_args("cuda", "float32", 1, exp_dir)
    img = SyntheticSingleView(args).get(0)["img"][None]
    outs = {}
    for device in ("cuda", "cpu"):
        model = build_dnet(args, device)
        with torch.inference_mode():
            outs[device] = model(torch.from_numpy(img).to(device)).cpu()
    ref = outs["cpu"]
    err = (outs["cuda"] - ref).abs().max().item()
    lim = FORWARD_TOL * ref.abs().max().item()
    log(f"  f32 D-Net card vs CPU at {H}x{W}: max_abs_err {err:.3e} "
        f"(limit {lim:.3e})")
    if not err <= lim:
        raise RuntimeError("the f32 forward on the card disagrees with the "
                           "CPU")
    return err


# ---- phases 6 and 7: the MaGNet main path ----------------------------------

def magnet_args(device: str, dtype: str, frames: int, exp_dir: str,
                extra=()):
    """The flags of test_scripts/magnet/scannet.txt on the synthetic
    dataset, without checkpoints, then ``extra``."""
    args = eval_args(dtype, device, "scannet", extra)
    args.exp_name, args.exp_dir = "chip_smoke_magnet", exp_dir
    args.synthetic_length = frames
    if ((args.input_height, args.input_width, args.dpv_height,
         args.dpv_width) != (H, W, HC, WC)
            or (args.MAGNET_num_source_views, args.MAGNET_num_samples,
                args.MAGNET_num_test_iter, args.FNET_feature_dim)
            != (VIEWS, SAMPLES, ITERS, FEAT)):
        raise RuntimeError("the flags' defaults are not the ScanNet eval "
                           "shape")
    return args


def kitti_args(device: str, dtype: str, frames: int, exp_dir: str,
               extra=("--stream_blocks",)):
    """The flags of test_scripts/magnet/kitti_eigen.txt on the synthetic
    dataset, without checkpoints, then ``extra``."""
    args = eval_args(dtype, device, "kitti", extra)
    args.exp_name, args.exp_dir = "chip_smoke_kitti", exp_dir
    args.synthetic_length = frames
    if ((args.input_height, args.input_width, args.dpv_height,
         args.dpv_width, args.MAGNET_num_source_views,
         args.MAGNET_num_samples, args.MAGNET_num_test_iter,
         args.max_depth, args.garg_crop)
            != (KITTI_H, KITTI_W, KITTI_HC, KITTI_WC, KITTI_VIEWS, SAMPLES,
                ITERS, 80.0, True)):
        raise RuntimeError("the flag file is not the KITTI eval "
                           "configuration")
    return args


def run_magnet_path(frames: int, exp_dir: str, args=None,
                    fnet: dict = FNET_LAUNCHES, trunk: dict = None,
                    stages: bool = False, decoder: dict = None) -> dict:
    """MaGNet through test_magnet's code (bf16; ``args`` default the ScanNet
    eval flags); ``fnet``, ``trunk`` and ``decoder`` hold the launches per
    frame of the F-Net's, the trunk's and the D-Net decoder's kernels
    (default the BN decoder's conv kernel) that the flags predict. With
    ``stages`` also ``profile_magnet.stage_times`` (CUDA events per
    stage)."""
    if args is None:
        args = magnet_args("cuda", "bfloat16", frames, exp_dir)
    args = config.setup_exp_dirs(args)
    shape = (1, args.input_height, args.input_width, 2)
    model, forward = test_magnet.prepare(args)
    realistic_depth_init_(model)
    outs, secs, cv_peaks = [], [], []

    def recorded(batch):
        t = time.perf_counter()
        out = forward(batch)               # ends in a copy to the host
        secs.append(time.perf_counter() - t)
        outs.append(out)
        return out

    per_stage, hooks = count_by_stage(model.d_net.d_net.decoder)
    hooks.append(model.g_net.register_forward_pre_hook(
        lambda m, inputs: cv_peaks.append(inputs[0].abs().max())))
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    metrics = test_magnet.evaluate(args, recorded)
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for h in hooks:
        h.remove()
    # per frame: one batched D-Net pass over the 5 frames (conv_a and conv_b
    # in up2 and in up3; the depth head; no D-Net mask head), G-Net's
    # feature term and MaGNet's mask head through the head chain; per
    # iteration one cost volume and one G-Net update; one upsampling launch
    # for the ITERS predictions; one F-Net pass over the 5 frames
    want = dict(dict.fromkeys(WRAPPERS, 0), up2=0, up3=0, head_chain=3,
                cost_volume_cw=ITERS, gnet_update=ITERS, upsample_mask=1)
    want.update(fnet)
    want.update(trunk or {})
    want.update(BN_CONV if decoder is None else decoder)
    launches = check_counts("MaGNet", counts, per_stage, want, frames)
    for out in outs:
        if out.shape != shape or not np.isfinite(out).all():
            raise RuntimeError(f"bad MaGNet output {out.shape}")
        if not (out[..., 1] > 0).all():
            raise RuntimeError("sigma not positive")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise RuntimeError(f"non-finite metrics {metrics}")
    peaks = [float(p) for p in cv_peaks]
    log(f"  cost volume max|cv| per launch: least {min(peaks):.3e}, most "
        f"{max(peaks):.3e}")
    if len(peaks) != ITERS * frames or not min(peaks) > 0:
        raise RuntimeError("a cost volume of the main path was all zero")

    batch = {k: v[None] for k, v in SyntheticMultiView(args).get(0).items()
             if isinstance(v, np.ndarray)}
    inputs = test_magnet.batch_to_device(batch, torch.bfloat16,
                                         torch.device("cuda"))
    with torch.inference_mode():
        ev_ms = cuda_ms(lambda: model(*inputs), iters=5, warmup=1)
        prof = profile_summary(lambda: model(*inputs))
        split = stage_times(model, inputs) if stages else {}
    for name, ms in split.items():
        log(f"    {name:44s} {ms:9.4f} ms")
    host_ms = 1e3 * float(np.mean(secs[1:] or secs))
    log(f"  forward {host_ms:.3f} ms/frame host clock incl. copies "
        f"({1e3 / host_ms:.2f} frames/s); {ev_ms:.3f} ms/frame by CUDA "
        f"events over back-to-back forwards; bf16, batch 1, "
        f"{args.MAGNET_num_source_views} source views; "
        f"max_memory_allocated {peak_gb:.3f} GiB")
    return dict(launches=launches, metrics=metrics, forward_ms=host_ms,
                fps=1e3 / host_ms, events_ms=ev_ms, cv_peak_min=min(peaks),
                cv_peak_max=max(peaks), max_memory_allocated_gb=peak_gb,
                profile=prof, stages_ms=split)


def magnet_outputs(args, batch: dict, dtype, device: str) -> list:
    """Each iteration's (mu, sigma) map, f32 on the CPU, of one forward of
    the flags' MaGNet in ``dtype`` on ``device``. The seeded random weights
    are brought to costs and residuals of O(1) first: as they come, the
    costs are of order 1e5 and the first G-Net update collapses sigma, after
    which a comparison would see no fusion."""
    model = realistic_depth_init_(build_magnet(args, "cpu"))
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        model.f_net.f_net.lastconv[2].weight.mul_(1.0 / 500.0)
        model.g_net.gnet[6].weight.normal_(0.0, 0.05 * 128 ** -0.5,
                                           generator=g)
    cast_for_inference(model, dtype).to(device)
    inputs = test_magnet.batch_to_device(batch, dtype, torch.device(device))
    with torch.inference_mode():
        return [o.float().cpu() for o in model(*inputs)]


def compare_f32_maps(outs: list, refs: list, what: str) -> dict:
    """Each iteration's f32 map to MAGNET_TOL * max|ref| on all but
    MAGNET_FLIPS of the pixels."""
    worst = dict(err=0.0, over=0.0)
    for i, (out, ref) in enumerate(zip(outs, refs)):
        err = (out - ref).abs()
        lim = MAGNET_TOL * ref.abs().max().item()
        over = (err > lim).float().mean().item()
        log(f"  {what}, iteration {i}: max_abs_err {err.max().item():.3e} "
            f"(limit {lim:.3e}), {over:.5f} of the pixels over it (at most "
            f"{MAGNET_FLIPS})")
        if out.shape != ref.shape or not over <= MAGNET_FLIPS:
            raise RuntimeError(f"{what}: the f32 forwards disagree")
        worst.update(err=max(worst["err"], err.max().item()),
                     over=max(worst["over"], over))
    return worst


def compare_bf16_maps(outs: list, refs: list, what: str,
                      names=("mu", "sigma")) -> dict:
    """The bf16 forward rounds every iteration's (mu, sigma) map to bf16, so
    iteration i may be off by i ulp of the map's largest value before any
    error of the networks; on top of that it gets BF16_FORWARD_TOL of the
    reference map's range (max - min, per channel: the initial map is
    constant here, so the range is what the refinement did). At most
    MAGNET_FLIPS of the pixels may be over, as in f32."""
    worst = dict(bf16_err=0.0, bf16_over=0.0)
    for i, (out, ref) in enumerate(zip(outs, refs)):
        for c, name in enumerate(names):
            o, r = out[..., c], ref[..., c]
            err = (o - r).abs()
            ulp = 2.0 ** (np.floor(np.log2(r.abs().max().item())) - 7)
            lim = ((i + 1) * ulp
                   + BF16_FORWARD_TOL * (r.max() - r.min()).item())
            over = (err > lim).float().mean().item()
            log(f"  {what}, iteration {i}, {name}: median_abs_err "
                f"{err.median().item():.3e}, max_abs_err "
                f"{err.max().item():.3e} (limit {lim:.3e} = {i + 1} ulp of "
                f"{ulp:.3e} + {BF16_FORWARD_TOL} of the range "
                f"{(r.max() - r.min()).item():.3e}), {over:.5f} of the "
                f"pixels over it (at most {MAGNET_FLIPS})")
            if (out.shape != ref.shape or not torch.isfinite(o).all()
                    or not over <= MAGNET_FLIPS):
                raise RuntimeError(f"{what}: the bf16 forward disagrees "
                                   "with the f32 reference")
            worst.update(bf16_err=max(worst["bf16_err"], err.max().item()),
                         bf16_over=max(worst["bf16_over"], over))
    return worst


def check_f32_magnet(exp_dir: str) -> dict:
    """One f32 MaGNet forward on the card (kernels, TF32 off) against the
    same forward on the CPU (plain versions), at full width, and the bf16
    forward on the card against that f32 reference (``magnet_outputs``,
    ``compare_f32_maps``, ``compare_bf16_maps``). The refinement must move
    the map in both."""
    args = magnet_args("cuda", "float32", 1, exp_dir)
    batch = {k: v[None] for k, v in SyntheticMultiView(args).get(0).items()
             if isinstance(v, np.ndarray)}
    outs = {(device, dtype): magnet_outputs(args, batch, dtype, device)
            for device, dtype in (("cuda", torch.float32),
                                  ("cpu", torch.float32),
                                  ("cuda", torch.bfloat16))}
    refs = outs["cpu", torch.float32]
    moved = (refs[-1] - refs[0]).abs().max().item()
    if not moved > 1e-3 or not refs[-1][..., 1].min() > 1e-3:
        raise RuntimeError("the f32 reference run shows no refinement")
    worst = compare_f32_maps(outs["cuda", torch.float32], refs,
                             "f32 MaGNet card vs CPU")
    bf = outs["cuda", torch.bfloat16]
    worst.update(compare_bf16_maps(bf, refs, "bf16 MaGNet card vs f32 CPU"))
    bf_moved = (bf[-1] - bf[0]).abs().max().item()
    log(f"  the refinement moved the map by {moved:.3e} in f32 and "
        f"{bf_moved:.3e} in bf16 between its first and last iteration")
    if not bf_moved > 1e-3:
        raise RuntimeError("the bf16 run shows no refinement")
    return worst


# ---- phases 8 and 9: F-Net training ---------------------------------------

def run_train_path(exp_dir: str) -> dict:
    """F-Net training through the entry point's own code
    (``train_fnet.train``) at the protocol of train_scripts/fnet/
    scannet.txt: 480x640, batch 2, 4 source views, 80 SID planes, cost
    volume 120x160, 64 features, bf16 with f32 master weights, seeded
    initialisation, synthetic samples; TRAIN_STEPS optimizer steps, then one
    validation pass (f32 weights, eval mode, through rows 6-9) and a
    checkpoint."""
    n = TRAIN_STEPS * TRAIN_B
    args = config.setup_exp_dirs(protocol_args([
        "--exp_name", "chip_smoke_fnet", "--exp_dir", exp_dir,
        "--synthetic_length", str(n), "--n_epochs", "1",
        "--validate_every", "1000000", "--log_every", "1"]), kind="train")
    if ((args.input_height, args.input_width, args.dpv_height,
         args.dpv_width, args.MAGNET_num_source_views,
         args.FNET_num_depth_bins, args.batch_size, args.FNET_feature_dim,
         args.compute_dtype) != (H, W, HC, WC, VIEWS, TRAIN_D, TRAIN_B, FEAT,
                                 "bfloat16")):
        raise RuntimeError("the flag file is not the F-Net training "
                           "protocol")
    init = {k: v.clone() for k, v in
            build_magnet_f(args, "cuda").state_dict().items()}
    n_val = n                       # the validation split has as many
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    out = train_fnet.train(args)
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    state = out["state"]
    # per step the sweep forward and backward; per validation sample the
    # F-Net's inference kernels and the sweep forward
    per_val = dict(FNET_LAUNCHES, cost_volume_cw=1)
    want = {k: TRAIN_STEPS * int(k in ("cost_volume_cw", "sweep_grad_src",
                                       "sweep_grad_ref"))
            + n_val * per_val.get(k, 0) for k in WRAPPERS}
    log(f"  launches over {TRAIN_STEPS} steps and {n_val} validation "
        f"samples: found {counts}, expected {want}")
    if counts != want:
        raise RuntimeError("the F-Net training path did not run every kernel "
                           "as expected")
    losses = out["losses"]
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise RuntimeError(f"training losses {losses}")
    unmoved = [k for k, v in state.model.state_dict().items()
               if "num_batches" not in k and torch.equal(v, init[k])]
    if unmoved:
        raise RuntimeError(f"not moved by training: {unmoved[:5]}")
    if not all(np.isfinite(v) for v in out["metrics"].values()):
        raise RuntimeError(f"non-finite validation metrics {out['metrics']}")
    saved = checkpoint.restore(out["ckpt"])
    current = state.model.state_dict()
    if saved["step"] != state.step or state.step != TRAIN_STEPS or any(
            not torch.equal(v, current[k].cpu())
            for k, v in saved["model"].items()):
        raise RuntimeError("the checkpoint does not restore the state")
    host_ms = float(np.mean(out["step_ms"][1:]))
    ev_ms = float(np.mean(out["step_event_ms"][1:]))
    log(f"  losses {losses}; validation abs_rel "
        f"{out['metrics']['abs_rel']:.4f}; checkpoint {out['ckpt']} restores "
        f"step {saved['step']} and all {len(saved['model'])} tensors")
    log(f"  step {host_ms:.3f} ms host clock incl. the loss read, "
        f"{ev_ms:.3f} ms by CUDA events around the step (steps 2-"
        f"{TRAIN_STEPS}); first step {out['step_ms'][0]:.3f} ms; "
        f"max_memory_allocated {peak_gb:.3f} GiB")
    return dict(launches=counts,
                step_launches={k: v - n_val * per_val.get(k, 0)
                               for k, v in counts.items()},
                losses=losses, step_ms=host_ms,
                step_event_ms=ev_ms, first_step_ms=out["step_ms"][0],
                max_memory_allocated_gb=peak_gb, metrics=out["metrics"],
                ckpt=out["ckpt"], args=args, state=state)


def train_account(args, state) -> dict:
    """Where a training step's time goes: ``step_account`` (CUDA events
    around the spans of the entry point's step) on a protocol batch, then
    the profiler over two steps; both train ``state`` further."""
    dev = torch.device("cuda")
    d_center = torch.from_numpy(sid_depth_centers(
        args.min_depth, args.max_depth, TRAIN_D)).to(dev)
    batch = train_fnet.batch_to_device(
        base.collate([SyntheticMultiView(args).get(i)
                      for i in range(TRAIN_B)]), (HC, WC), dev)
    step_fn = steps.make_fnet_train_step(
        d_center, args.max_depth, args.min_depth,
        config.compute_dtype(args.compute_dtype))
    account = step_account(step_fn, state, batch)
    for name, ms in account.items():
        log(f"    {name:52s} {ms:9.4f} ms")
    prof = kernel_profile(lambda: step_fn(state, batch), 2)
    log(f"  profiler over 2 steps: {prof['device_busy_ms_per_frame']:.4f} ms "
        f"busy per step of {prof['wall_ms_per_frame']:.4f}, idle share "
        f"{prof['device_idle_share']:.4f}, "
        f"{prof['kernel_launches_per_frame']:.1f} launches per step")
    for k in prof["top_kernels"][:8]:
        log(f"    {k['ms_per_frame']:8.4f} ms x{k['launches_per_frame']:5.1f}"
            f"  {k['name']}")
    return dict(account_ms=account, profile=prof)


def condition_(model: torch.nn.Module) -> torch.nn.Module:
    """Seeded weights brought to a point where two f32 programs' gradients
    can be held to each other: every BatchNorm before a ReLU at bias 3 and
    scale 0.5 (ReLU inputs 6 standard deviations above the kink, where f32
    noise cannot flip one), zero-mean conv kernels (a conv after a ReLU then
    makes no channel mean far above its spread, which would turn the
    variance E[x^2] - E[x]^2 into a cancellation), the projection scaled by
    0.1 (matching costs of O(1), so that the softmax passes a gradient)."""
    psm = model.f_net.f_net
    bns = [psm.firstconv[i][1] for i in (0, 2, 4)]
    bns += [b.conv1[0][1] for li in range(1, 5)
            for b in getattr(psm, f"layer{li}")]
    bns += [getattr(psm, f"branch{i}")[1][1] for i in range(1, 5)]
    bns.append(psm.lastconv[0][1])
    with torch.no_grad():
        for bn in bns:
            bn.bias.fill_(3.0)
            bn.weight.fill_(0.5)
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight -= m.weight.mean(dim=(1, 2, 3), keepdim=True)
        psm.lastconv[2].weight.mul_(0.1)
    return model


def train_step_outputs(model, raw, args, d_np, device: str, dtype) -> tuple:
    """One training step of a copy of ``model`` on ``device`` in ``dtype``:
    the loss, every parameter's (clipped) gradient and the BatchNorm running
    buffers after the step, on the CPU."""
    dev = torch.device(device)
    m = copy.deepcopy(model).to(dev)
    opt = optim.make_fnet_optimizer(m.parameters(), args.lr, 10)
    step_fn = steps.make_fnet_train_step(torch.from_numpy(d_np).to(dev),
                                         args.max_depth, args.min_depth,
                                         dtype)
    _, out = step_fn(steps.TrainState(m, opt), train_fnet.batch_to_device(
        raw, (args.dpv_height, args.dpv_width), dev))
    return (float(out["loss"]),
            {k: p.grad.detach().cpu() for k, p in m.named_parameters()},
            {k: b.detach().cpu() for k, b in m.named_buffers()
             if "running" in k})


def step_errors(res: tuple, ref: tuple) -> dict:
    """A step's distance from a reference step: the loss relative, each
    gradient as max|diff| / max|g| of its tensor (the worst and the median
    tensor), the running buffers as |diff| / (|v| + 1)."""
    (loss, grads, stats), (loss_ref, grads_ref, stats_ref) = res, ref
    g = [(grads[k] - v).abs().max().item() / v.abs().max().item()
         for k, v in grads_ref.items()]
    return dict(loss=abs(loss - loss_ref) / abs(loss_ref), grad=max(g),
                grad_median=float(np.median(g)),
                stats=max(((stats[k] - v).abs() / (v.abs() + 1.0)).max().item()
                          for k, v in stats_ref.items()))


def batch_norm_bf16_statistics(x: torch.Tensor, bn) -> torch.Tensor:
    """The control of the bf16 step check: train-mode BatchNorm with its
    batch statistics taken in the activations' dtype, as casting the whole
    BatchNorm to the compute dtype would (the JAX package keeps them f32)."""
    mean = x.mean((0, 2, 3))
    var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
    with torch.no_grad():
        for buf, stat in ((bn.running_mean, mean), (bn.running_var, var)):
            buf.copy_(BN_MOMENTUM * buf + (1 - BN_MOMENTUM) * stat.float())
    mul = torch.rsqrt(var + bn.eps) * bn.weight.to(x.dtype)
    return ((x - mean[:, None, None]) * mul[:, None, None]
            + bn.bias.to(x.dtype)[:, None, None])


def check_train_step(exp_dir: str, device: str = "cuda") -> dict:
    """One f32 training step on the card (TF32 off) against the same step on
    the CPU (the plain versions), at a reduced shape, from the same weights
    and batch: the loss to TRAIN_LOSS_TOL relative, every parameter's
    (clipped) gradient to TRAIN_GRAD_TOL * max|g| of its tensor, the
    BatchNorm running buffers after the step to TRAIN_STATS_TOL; each frame
    gets a colour offset, so that the SPP BatchNorms, which see a few pooled
    values, are not a cancellation. Then the protocol's bf16 step on the
    card against that f32 step on the CPU, to BF16_TRAIN_TOL, and its
    control (BatchNorm statistics in bf16), which must exceed one of those
    limits."""
    c = SMALL_TRAIN
    args = protocol_args([
        "--exp_dir", exp_dir, "--input_height", str(c["H"]),
        "--input_width", str(c["W"]), "--dpv_height", str(c["H"] // 4),
        "--dpv_width", str(c["W"] // 4), "--FNET_num_depth_bins",
        str(c["D"]), "--MAGNET_num_source_views", str(c["V"]),
        "--batch_size", str(c["B"]), "--compute_dtype", "float32"])
    raw = base.collate([SyntheticMultiView(args).get(i)
                        for i in range(c["B"])])
    rng = np.random.RandomState(9)
    for k, n in (("ref_img", (c["B"],)), ("src_imgs", (c["B"], c["V"]))):
        raw[k] = raw[k] + (0.5 * rng.randn(*n, 1, 1, 3)).astype(np.float32)
    d_np = sid_depth_centers(args.min_depth, args.max_depth, c["D"])
    model = condition_(build_magnet_f(args, "cpu"))
    margin = []
    relu = F.relu

    def recorded(x, *a, **k):
        margin.append(x.detach().abs().min().item())
        return relu(x, *a, **k)

    F.relu = recorded
    try:
        ref = train_step_outputs(model, raw, args, d_np, "cpu",
                                 torch.float32)
    finally:
        F.relu = relu
    f32 = step_errors(train_step_outputs(model, raw, args, d_np, device,
                                         torch.float32), ref)
    bf16 = step_errors(train_step_outputs(model, raw, args, d_np, device,
                                          torch.bfloat16), ref)
    bn_train = psmnet.batch_norm_train
    psmnet.batch_norm_train = batch_norm_bf16_statistics
    try:
        control = step_errors(train_step_outputs(model, raw, args, d_np,
                                                 device, torch.bfloat16), ref)
    finally:
        psmnet.batch_norm_train = bn_train
    log(f"  f32 training step card vs CPU at {c['H']}x{c['W']}, cost volume "
        f"{c['H'] // 4}x{c['W'] // 4}, D={c['D']}, V={c['V']}, B={c['B']}: "
        f"loss {ref[0]:.7f}, rel err {f32['loss']:.2e} (limit "
        f"{TRAIN_LOSS_TOL}); worst gradient {f32['grad']:.2e} of its "
        f"tensor's max (limit {TRAIN_GRAD_TOL}); worst running statistic "
        f"{f32['stats']:.2e} (limit {TRAIN_STATS_TOL}); ReLU inputs at least "
        f"{min(margin):.2e} from the kink")
    for name, e in (("bf16 step on the card", bf16),
                    ("control, BatchNorm statistics in bf16", control)):
        log(f"  {name} vs the f32 step on the CPU: loss {e['loss']:.2e} "
            f"(limit {BF16_TRAIN_TOL['loss']}); gradients worst "
            f"{e['grad']:.2e} (limit {BF16_TRAIN_TOL['grad']}), median "
            f"{e['grad_median']:.2e} (limit {BF16_TRAIN_TOL['grad_median']}); "
            f"running statistics {e['stats']:.2e} (limit "
            f"{BF16_TRAIN_TOL['stats']})")
    if not min(ref[1]["f_net.f_net.firstconv.0.0.weight"].abs().max(),
               ref[0]) > 0:
        raise RuntimeError("the reference step has no gradient")
    if not (f32["loss"] <= TRAIN_LOSS_TOL and f32["grad"] <= TRAIN_GRAD_TOL
            and f32["stats"] <= TRAIN_STATS_TOL
            and min(margin) > KINK_MARGIN):
        raise RuntimeError("the training step on the card disagrees with "
                           "the CPU")
    if not all(bf16[k] <= v for k, v in BF16_TRAIN_TOL.items()):
        raise RuntimeError("the bf16 training step on the card disagrees "
                           "with the f32 step")
    if all(control[k] <= v for k, v in BF16_TRAIN_TOL.items()):
        raise RuntimeError("the bf16 step check does not see BatchNorm "
                           "statistics taken in bf16")
    return dict(loss_rel_err=f32["loss"], grad_err=f32["grad"],
                stats_err=f32["stats"], relu_margin=min(margin), bf16=bf16,
                bf16_control=control)


# ---- phase 10: path A, the D-Net trunk's kernels ---------------------------

def check_trunk_f32(exp_dir: str) -> dict:
    """Path A in f32 on the card (TF32 off), the same seeded weights with the
    trunk's kernels on and off: the D-Net's five trunk taps and its output to
    FORWARD_TOL * max|ref| each, as phase 5 holds the D-Net; MaGNet's maps
    with them on against off at phase 7's f32 limits; the bf16 MaGNet with
    them on against that f32 one at phase 7's bf16 limits."""
    img = SyntheticSingleView(dnet_args("cuda", "float32", 1, exp_dir)).get(
        0)["img"][None]
    x = torch.from_numpy(img).to("cuda")
    outs = {}
    for name, extra in (("off", []), ("on", TRUNK_FLAGS)):
        model = build_dnet(dnet_args("cuda", "float32", 1, exp_dir, extra),
                           "cuda")
        with torch.inference_mode():
            taps = model.d_net.encoder(nchw(x))
            outs[name] = [t.float().cpu() for t in taps] + [model(x).cpu()]
        del model
    dnet_err = 0.0
    for what, o, r in zip(("f4", "f5", "f6", "f8", "f11", "output"),
                          outs["on"], outs["off"]):
        err = (o - r).abs().max().item()
        lim = FORWARD_TOL * r.abs().max().item()
        log(f"  f32 D-Net {what}, trunk kernels on vs off: max_abs_err "
            f"{err:.3e} (limit {lim:.3e})")
        if o.shape != r.shape or not err <= lim:
            raise RuntimeError("the trunk's kernels change the f32 D-Net")
        dnet_err = max(dnet_err, err / r.abs().max().item())
    off = magnet_args("cuda", "float32", 1, exp_dir)
    on = magnet_args("cuda", "float32", 1, exp_dir, TRUNK_FLAGS)
    batch = {k: v[None] for k, v in SyntheticMultiView(off).get(0).items()
             if isinstance(v, np.ndarray)}
    f32_on = magnet_outputs(on, batch, torch.float32, "cuda")
    worst = compare_f32_maps(f32_on, magnet_outputs(off, batch, torch.float32,
                                                    "cuda"),
                             "f32 MaGNet, trunk kernels on vs off")
    worst.update(compare_bf16_maps(
        magnet_outputs(on, batch, torch.bfloat16, "cuda"), f32_on,
        "bf16 MaGNet vs f32, trunk kernels on"))
    return dict(dnet_rel_err=dnet_err, **worst)


def trunk_compare(exp_dir: str) -> dict:
    """The D-Net trunk alone (bf16, 480x640) at N = 1 and N = 5, its kernels
    off and on in turns (off, on, on, off): CUDA events per pass over 10
    back-to-back passes, and the profiler's busy time, idle share and
    launches per pass for each."""
    img = SyntheticSingleView(dnet_args("cuda", "float32", 1, exp_dir)).get(
        0)["img"]
    trunks = {}
    for name, extra in (("off", []), ("on", TRUNK_FLAGS)):
        model = build_dnet(dnet_args("cuda", "bfloat16", 1, exp_dir, extra),
                           "cuda")
        trunks[name] = cast_for_inference(model, torch.bfloat16).d_net.encoder
    res = {}
    for n in (1, 1 + VIEWS):
        x = nchw(torch.from_numpy(np.stack([img] * n)).to("cuda",
                                                           torch.bfloat16))
        ms = {"off": [], "on": []}
        with torch.inference_mode():
            for name in ("off", "on", "on", "off"):
                ms[name].append(cuda_ms(lambda: trunks[name](x), iters=10,
                                        warmup=2))
            prof = {}
            for name in ("off", "on"):
                log(f"  trunk N={n}, kernels {name}:")
                prof[name] = profile_summary(lambda: trunks[name](x))
        log(f"  trunk N={n}: {ms['off']} ms off, {ms['on']} ms on by events")
        drop = (prof["off"]["kernel_launches_per_frame"]
                - prof["on"]["kernel_launches_per_frame"])
        if not drop > 0:
            raise RuntimeError("the trunk's kernels did not replace its "
                               "eager launches")
        res[f"N={n}"] = dict(events_ms=ms, profile=prof, launches_gone=drop)
    return res


# ---- phase 11: path B, MaGNet at the KITTI configuration -------------------

def check_kitti_fnet(exp_dir: str) -> dict:
    """The F-Net at the KITTI shape on one sample's 3 frames, both on the
    card: f32 (TF32 off) with ``--stream_blocks`` (row 14) against without
    (the chains of row 6) to FORWARD_TOL * max|ref|; then both in bf16 timed
    by CUDA events, in turns (off, on, on, off)."""
    flags = {"off": (), "on": ("--stream_blocks",)}
    args = {k: kitti_args("cuda", "float32", 1, exp_dir, v)
            for k, v in flags.items()}
    item = SyntheticMultiView(args["on"]).get(0)
    x = torch.from_numpy(np.concatenate([item["ref_img"][None],
                                         item["src_imgs"]])).to("cuda")
    models, outs = {}, {}
    for name in ("off", "on"):
        models[name] = build_fnet(args[name], "cuda")
        with torch.inference_mode():
            outs[name] = models[name](x).cpu()
    err = (outs["on"] - outs["off"]).abs().max().item()
    lim = FORWARD_TOL * outs["off"].abs().max().item()
    log(f"  f32 F-Net at {KITTI_H}x{KITTI_W}, 3 frames, res_block vs the "
        f"chains: max_abs_err {err:.3e} (limit {lim:.3e})")
    if outs["on"].shape != (3, KITTI_HC, KITTI_WC, FEAT) or not err <= lim:
        raise RuntimeError("row 14 disagrees with row 6 in the F-Net")
    x16 = x.to(torch.bfloat16)
    ms = {"off": [], "on": []}
    with torch.inference_mode():
        for name in ("off", "on", "on", "off"):
            m = cast_for_inference(models[name], torch.bfloat16)
            ms[name].append(cuda_ms(lambda: m(x16), iters=5, warmup=1))
    log(f"  bf16 F-Net, 3 frames: {ms['off']} ms with the chains, "
        f"{ms['on']} ms with res_block, by events")
    return dict(err=err, limit=lim, events_ms=ms)


# ---- phase 12: D-Net training (stage 1) ------------------------------------

def dnet_train_args(exp_dir: str, batch: int,
                    n_steps: int = DNET_TRAIN_STEPS,
                    extra=()) -> argparse.Namespace:
    """The flags of train_scripts/dnet/scannet.txt on the synthetic dataset,
    then ``extra``, at ``batch``: ``n_steps`` steps and a validation pass
    over as many frames, bf16. The synthetic items are not augmented (they
    are drawn at the input size, as in the JAX package), so the input size
    is set to the flag file's 416x544 crop."""
    args = config.parse_args(config.build_train_dnet_parser(), [
        "@" + str(REPO / "train_scripts" / "dnet" / "scannet.txt"),
        "--dataset_name", "synthetic", "--dataset_path", "none",
        "--exp_name", "chip_smoke_dnet", "--exp_dir", exp_dir,
        "--input_height", str(DNET_CROP[0]),
        "--input_width", str(DNET_CROP[1]),
        "--batch_size", str(batch), "--n_epochs", "1",
        "--synthetic_length", str(batch * n_steps),
        "--validate_every", "1000000", "--log_every", "1", *extra])
    if ((args.crop_height, args.crop_width) != DNET_CROP
            or args.compute_dtype != "bfloat16"):
        raise RuntimeError("the flag file is not the D-Net training shape")
    return config.setup_exp_dirs(args, kind="train")


def dnet_start(args, n_steps: int = DNET_TRAIN_STEPS) -> steps.TrainState:
    """The state ``train_dnet`` starts from (its model, optimizer and
    generator), the depth head in a trained network's regime (last conv 0,
    bias (2, -3): mu 2 m, var 0.05), so that phase 13's cost volume sees
    depths a trained D-Net gives."""
    model = build_dnet_train(args, "cuda")
    head = model.d_net.decoder.depth_head[4]
    with torch.no_grad():
        head.weight.zero_()
        head.bias.copy_(torch.tensor([2.0, -3.0]))
    opt = optim.make_dnet_optimizer(
        model, lr=args.lr, total_steps=n_steps,
        weight_decay=args.weight_decay, grad_clip=args.grad_clip,
        same_lr=args.same_lr, div_factor=args.div_factor,
        final_div_factor=args.final_div_factor)
    return steps.TrainState(model, opt, seed=args.seed)


def dnet_batch_that_fits(exp_dir: str, extra=()) -> int:
    """The flag file's batch if one training step fits the card, else the
    largest half of it that does."""
    b = DNET_TRAIN_B
    while True:
        args = dnet_train_args(exp_dir, b, extra=extra)
        raw = base.collate([SyntheticSingleView(args).get(i)
                            for i in range(b)])
        try:
            state = dnet_start(args)
            step_fn = steps.make_dnet_train_step(
                args.max_depth, args.min_depth, torch.bfloat16)
            step_fn(state, train_dnet.batch_to_device(raw, "cuda"))
            torch.cuda.synchronize()
            return b
        except torch.cuda.OutOfMemoryError:
            log(f"  batch {b} does not fit the card")
            if b == 1:
                raise
            b //= 2
        finally:
            state = step_fn = None
            torch.cuda.empty_cache()


def run_dnet_train_path(exp_dir: str, n_steps: int = DNET_TRAIN_STEPS,
                        extra=(), per_val: dict = None) -> dict:
    """D-Net training through the entry point's own loop
    (``train_dnet.train``) at train_scripts/dnet/scannet.txt's shape with
    the flags ``extra``, ``n_steps`` steps, started from ``dnet_start`` by
    ``--resume_ckpt``: finite losses, the launches (per step the upsampling
    forward and its backward; per validation frame ``per_val``, default the
    BN D-Net's inference kernels), step ms by events, the peak memory, a
    checkpoint that restores."""
    b = dnet_batch_that_fits(exp_dir, extra)
    args = dnet_train_args(exp_dir, b, n_steps, extra)
    args.resume_ckpt = checkpoint.save(
        os.path.join(args.exp_dir, "start"), dnet_start(args, n_steps), 0)
    n_val = b * n_steps
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    out = train_dnet.train(args)
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = dict(upsample_mask=1, upsample_mask_bwd=1)
    per_val = per_val or BN_DECODER
    want = {k: n_steps * per_step.get(k, 0) + n_val * per_val.get(k, 0)
            for k in WRAPPERS}
    log(f"  launches over {n_steps} steps and {n_val} validation "
        f"frames: found {counts}, expected {want}")
    if counts != want:
        raise RuntimeError("the D-Net training path did not run its kernels "
                           "as expected")
    losses = out["losses"]
    if len(losses) != n_steps or not np.isfinite(losses).all():
        raise RuntimeError(f"D-Net training losses {losses}")
    if not all(np.isfinite(v) for v in out["metrics"].values()):
        raise RuntimeError(f"non-finite validation metrics {out['metrics']}")
    saved = checkpoint.restore(out["ckpt"])
    current = out["state"].model.state_dict()
    if saved["step"] != n_steps or any(
            not torch.equal(v, current[k].cpu())
            for k, v in saved["model"].items()):
        raise RuntimeError("the D-Net checkpoint does not restore the state")
    ev_ms = float(np.mean(out["step_event_ms"][1:]))
    log(f"  batch {b} (the flag file's {DNET_TRAIN_B}) at "
        f"{DNET_CROP[0]}x{DNET_CROP[1]}, bf16: losses {losses}; step "
        f"{ev_ms:.3f} ms by CUDA events (steps 2-{n_steps}; first "
        f"{out['step_event_ms'][0]:.3f}), host clock "
        f"{np.mean(out['step_ms'][1:]):.3f} ms; max_memory_allocated "
        f"{peak_gb:.3f} GiB; validation abs_rel "
        f"{out['metrics']['abs_rel']:.4f}; checkpoint {out['ckpt']}")
    return dict(batch=b, launches=counts, per_step=per_step, losses=losses,
                step_event_ms=ev_ms, step_ms=float(np.mean(out["step_ms"][1:])),
                first_step_event_ms=out["step_event_ms"][0],
                max_memory_allocated_gb=peak_gb, metrics=out["metrics"],
                ckpt=out["ckpt"])


# ---- phase 13: MaGNet training (stage 3) ------------------------------------

def magnet_train_args(exp_dir: str, dnet_ckpt: str,
                      fnet_ckpt: str) -> argparse.Namespace:
    """The flags of train_scripts/magnet/scannet.txt on the synthetic
    dataset with the given stage checkpoints: MAGNET_TRAIN_STEPS steps and a
    validation pass over as many samples."""
    args = config.parse_args(config.build_train_magnet_parser(), [
        "@" + str(REPO / "train_scripts" / "magnet" / "scannet.txt"),
        "--dataset_name", "synthetic", "--dataset_path", "none",
        "--exp_name", "chip_smoke_magnet_train", "--exp_dir", exp_dir,
        "--DNET_ckpt", dnet_ckpt, "--FNET_ckpt", fnet_ckpt, "--n_epochs",
        "1", "--synthetic_length", str(MAGNET_TRAIN_B * MAGNET_TRAIN_STEPS),
        "--validate_every", "1000000", "--log_every", "1"])
    if ((args.input_height, args.input_width, args.dpv_height,
         args.dpv_width, args.MAGNET_num_source_views,
         args.MAGNET_num_samples, args.MAGNET_num_train_iter,
         args.batch_size, args.loss_fn, args.compute_dtype)
            != (H, W, HC, WC, VIEWS, SAMPLES, ITERS, MAGNET_TRAIN_B,
                "gaussian", "bfloat16")):
        raise RuntimeError("the flag file is not the MaGNet training shape")
    return config.setup_exp_dirs(args, kind="train")


def run_magnet_train_path(args) -> dict:
    """MaGNet training through the entry point's own loop
    (``train_magnet.train``): finite losses, only ``g_net.*`` and
    ``mask_head.*`` changed (against the same model built and loaded
    alone), the launches of each kernel per step (the validation's, per
    sample as phase 6 counts them, taken off), step ms by events."""
    init = {k: v.clone() for k, v in
            build_magnet_train(args, "cuda").state_dict().items()}
    n_val = MAGNET_TRAIN_B * MAGNET_TRAIN_STEPS
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    out = train_magnet.train(args)
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    # per step: the frozen encode of B (V + 1) frames (the decoder's four
    # convs, the depth head, the F-Net's kernels), the batched cost volume
    # once an iteration, the upsampling of the iterations and its backward;
    # G-Net and the mask head train as plain convs
    per_step = dict(conv3x3_bnact=4, head_chain=1, cost_volume_cw=ITERS,
                    upsample_mask=1, upsample_mask_bwd=1, **FNET_LAUNCHES)
    per_val = dict(conv3x3_bnact=4, head_chain=3, cost_volume_cw=ITERS,
                   gnet_update=ITERS, upsample_mask=1, **FNET_LAUNCHES)
    want = {k: MAGNET_TRAIN_STEPS * per_step.get(k, 0)
            + n_val * per_val.get(k, 0) for k in WRAPPERS}
    log(f"  launches over {MAGNET_TRAIN_STEPS} steps and {n_val} validation "
        f"samples: found {counts}, expected {want}")
    if counts != want:
        raise RuntimeError("the MaGNet training path did not run its "
                           "kernels as expected")
    losses = out["losses"]
    if len(losses) != MAGNET_TRAIN_STEPS or not np.isfinite(losses).all():
        raise RuntimeError(f"MaGNet training losses {losses}")
    after = out["state"].model.state_dict()
    moved = sorted({k.split(".")[0] for k, v in after.items()
                    if not torch.equal(v, init[k])})
    unmoved = [k for k, v in after.items()
               if k.split(".")[0] in ("g_net", "mask_head")
               and torch.equal(v, init[k])]
    log(f"  modules whose tensors changed: {moved}")
    if moved != ["g_net", "mask_head"] or unmoved:
        raise RuntimeError(f"stage 3 changed {moved}; unchanged trained "
                           f"tensors {unmoved[:4]}")
    ev_ms = float(np.mean(out["step_event_ms"][1:]))
    log(f"  batch {MAGNET_TRAIN_B}, {VIEWS} source views, {ITERS} "
        f"iterations, bf16: losses {losses}; step {ev_ms:.3f} ms by CUDA "
        f"events (steps 2-{MAGNET_TRAIN_STEPS}; first "
        f"{out['step_event_ms'][0]:.3f}), host clock "
        f"{np.mean(out['step_ms'][1:]):.3f} ms; max_memory_allocated "
        f"{peak_gb:.3f} GiB; launches per step {per_step}")
    return dict(launches=counts, per_step=per_step, losses=losses,
                step_event_ms=ev_ms, step_ms=float(np.mean(out["step_ms"][1:])),
                first_step_event_ms=out["step_event_ms"][0],
                max_memory_allocated_gb=peak_gb, metrics=out["metrics"])


def magnet_step_grads(model, batch: dict, args, dtype, encodings=None):
    """The stage-3 loss and the G-Net and mask-head gradients of one step of
    ``model`` (train mode, no update): the whole forward in ``dtype``, or
    ``fuse`` from ``encodings``."""
    model.zero_grad(set_to_none=True)
    model.train()
    if encodings is None:
        loss = steps.magnet_batch_loss(model, batch, args.loss_gamma,
                                       args.max_depth, args.min_depth,
                                       ITERS, dtype)
    else:
        preds = model.fuse(*encodings, *[batch[k] for k in (
            "R", "t", "is_valid", "intM", "rays2d")], n_iters=ITERS)
        loss = steps.magnet_preds_loss(preds, batch["depth"], args.loss_gamma,
                                       args.max_depth, args.min_depth)
    loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def capture_bf16_step(model, batch: dict, args) -> dict:
    """The bf16 step of ``magnet_step_grads`` on ``model`` and ``batch``
    (its loss and gradients under ``step``) with what its mask head and
    upsampling saw, taken by forward hooks on ``g_net``, ``d_net`` and the
    head's ReLUs and by a wrapper of ``Magnet.fuse``'s upsampling: the
    coarse (mu, sigma) maps, the decoder feature ``x`` (NHWC), each conv's
    input ``ins`` and output ``outs`` (NCHW; the last output the mask
    logits), the logits' gradient ``dlogits`` (NHWC) and the upsampled
    maps' gradients ``upstream``. The hooks and the wrapper change no value
    of the step."""
    coarse, feat, logits, fine, ins, outs = [], [], [], [], [], []

    def upsample(maps, mask, k):
        mask.retain_grad()
        logits.append(mask)
        out = upsample_via_mask(maps, mask, k)
        for p in out:
            p.retain_grad()
        fine.extend(out)
        return out

    def relu(m, inputs, out):
        outs.append(inputs[0].detach())
        ins.append(out.detach())
    hooks = [model.g_net.register_forward_hook(
                 lambda m, inputs, out: coarse.append(out.detach())),
             model.d_net.register_forward_hook(
                 lambda m, inputs, out: feat.append(out[1].detach()))]
    hooks += [m.register_forward_hook(relu) for m in model.mask_head
              if isinstance(m, torch.nn.ReLU)]
    magnet_module.upsample_via_mask = upsample
    try:
        step = magnet_step_grads(model, batch, args, torch.bfloat16)
    finally:
        magnet_module.upsample_via_mask = upsample_via_mask
        for h in hooks:
            h.remove()
    if len(coarse) != ITERS or len(feat) != 1 or len(logits) != 1:
        raise RuntimeError(f"the bf16 step's G-Net gave {len(coarse)} maps, "
                           f"its D-Net {len(feat)} features, its mask head "
                           f"{len(logits)} masks")
    x = feat[0][:len(coarse[0])]
    return dict(step=step, coarse=coarse, x=x, ins=[nchw(x)] + ins,
                outs=outs + [nchw(logits[0].detach())],
                dlogits=logits[0].grad.detach(),
                upstream=[p.grad.detach() for p in fine])


def mask_head_reference(head, k: int, coarse: list, x_d3: torch.Tensor,
                        batch: dict, args) -> tuple:
    """The loss, the mask-head gradients and the mask logits' gradient
    (NHWC) of an f32 step (no update) whose upsampling takes another step's
    coarse (mu, sigma) maps ``coarse`` as they are: the f32 mask head
    ``head`` on ``x_d3``, ``upsample_via_mask`` by ``k`` and the stage-3
    loss."""
    head.zero_grad(set_to_none=True)
    y = nchw(x_d3)
    for m in head:
        y = conv2d(y, m) if isinstance(m, torch.nn.Conv2d) else m(y)
    logits = nhwc(y)
    logits.retain_grad()
    preds = upsample_via_mask([c.float() for c in coarse], logits, k)
    loss = steps.magnet_preds_loss(preds, batch["depth"], args.loss_gamma,
                                   args.max_depth, args.min_depth)
    loss.backward()
    grads = {f"mask_head.{n}": p.grad.detach().clone()
             for n, p in head.named_parameters()}
    head.zero_grad(set_to_none=True)
    return float(loss.detach()), grads, logits.grad.detach()


def r16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 in the forward, the identity in the backward."""
    return t + (t.to(torch.bfloat16).to(t.dtype) - t).detach()


def head64(head, x: torch.Tensor, head16: bool, actual=None,
           outs=None) -> tuple:
    """The mask head ``head`` in f64 on x (NHWC): its parameters as f64
    leaves (named as the model's) and the logits (NHWC). With ``head16``
    each weight, bias and conv output is rounded to bf16 as a bf16 step's
    convs give them. With ``actual`` (a step's conv outputs, NCHW) those
    are the forward values, the gradients flowing through the f64 convs.
    ``outs`` collects the conv outputs."""
    params, y = {}, nchw(x.double())
    actual = None if actual is None else list(actual)
    for i, m in enumerate(head):
        if isinstance(m, torch.nn.Conv2d):
            w = m.weight.detach().double().requires_grad_()
            b = m.bias.detach().double().requires_grad_()
            params[f"mask_head.{i}.weight"] = w
            params[f"mask_head.{i}.bias"] = b
            if head16:
                w, b = r16(w), r16(b)
            y = F.conv2d(y, w, b, m.stride, m.padding)
            if head16:
                y = r16(y)
            if actual is not None:
                y = actual.pop(0).double() + (y - y.detach())
            if outs is not None:
                outs.append(y.detach())
        else:
            y = m(y)
    return params, nhwc(y)


def conv_exact_bf16(m: torch.nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """The conv ``m`` on x (NCHW, bf16) with m's weight and bias cast to
    bf16, as a bf16 step casts them: f64 arithmetic (exact up to the sums'
    f64 rounding), then one rounding to bf16."""
    w, b = (t.detach().to(torch.bfloat16).double()
            for t in (m.weight, m.bias))
    return F.conv2d(x.double(), w, b, m.stride, m.padding).to(torch.bfloat16)


def forward_gaps(actual: list, ref: list) -> list:
    """Each conv output of a bf16 step against a reference (NCHW): the
    largest difference over max|ref|, the share of elements apart by more
    than a bf16 step (2^-7 of |ref|), and the elements whose sign differs,
    all and in the coarse map's outer ring of pixels."""
    out = []
    for a, e in zip(actual, ref):
        a, e = a.double(), e.double()
        d = (a - e).abs()
        flip = (a > 0) != (e > 0)
        ring = torch.ones_like(flip)
        ring[:, :, 1:-1, 1:-1] = False
        out.append(dict(rel_max=(d.max() / e.abs().max()).item(),
                        over_ulp=(d > 2 ** -7 * e.abs()).double()
                        .mean().item(),
                        sign_flips=int(flip.sum()),
                        ring_flips=int((flip & ring).sum())))
    return out


def mask_head_gates(head, k: int, cap: dict, batch: dict, args) -> dict:
    """The readings of phase 13's gates of a bf16 step's mask head ``head``
    from ``capture_bf16_step``'s ``cap``. ``upstream``: the mask logits'
    gradient against the f32 head's (``mask_head_reference`` on the step's
    decoder feature and coarse maps), the largest and the L2 difference over
    max|ref| and |ref|. ``forward``: each conv's output against
    ``conv_exact_bf16`` on the step's own input (``forward_gaps``).
    ``backward``: the mask-head gradients against the f64 backward through
    the step's own conv outputs (``head64`` with ``actual``) from the step's
    own logits' gradient (``grad_errors``). By the chain rule these three
    make up the gradients. Not gated, ``end_to_end``: the gradients against
    the f32 head's, with each tensor's relative L2 under ``rel_l2``."""
    mask = only(cap["step"], "mask_head.")
    loss, grads, dlogits = mask_head_reference(
        head, k, cap["coarse"], cap["x"].float(), batch, args)
    d, r = cap["dlogits"].double(), dlogits.double()
    upstream = dict(rel_max=((d - r).abs().max() / r.abs().max()).item(),
                    rel_l2=((d - r).norm() / r.norm()).item())
    convs = [m for m in head if isinstance(m, torch.nn.Conv2d)]
    forward = forward_gaps(cap["outs"], [conv_exact_bf16(m, x) for m, x
                                         in zip(convs, cap["ins"])])
    params, z = head64(head, cap["x"], True, actual=cap["outs"])
    z.backward(cap["dlogits"].double())
    backward = grad_errors(mask, (mask[0], {n: p.grad for n, p in
                                            params.items()}))
    end_to_end = dict(grad_errors(mask, (loss, grads)), rel_l2={
        n: ((mask[1][n] - g).norm() / g.norm()).item()
        for n, g in grads.items()})
    return dict(upstream=upstream, forward=forward, backward=backward,
                end_to_end=end_to_end)


def mask_head_failures(r: dict) -> list:
    """The gates of ``mask_head_gates``' readings ``r`` out of their
    limits, each with its reading."""
    u = r["upstream"]["rel_max"]
    failed = ([] if u <= MASK_HEAD_UPSTREAM_TOL else
              [f"mask-head upstream {u:.3e} (limit {MASK_HEAD_UPSTREAM_TOL})"])
    failed += [f"mask-head conv {i} forward {f['rel_max']:.3e} (limit "
               f"{MASK_HEAD_FORWARD_TOL})" for i, f in enumerate(r["forward"])
               if not f["rel_max"] <= MASK_HEAD_FORWARD_TOL]
    failed += [f"mask-head backward {k} {r['backward'][k]:.3e} (limit {v})"
               for k, v in MASK_HEAD_BACKWARD_TOL.items()
               if not r["backward"][k] <= v]
    return failed


def log_mask_head(r: dict) -> None:
    u, b, e = r["upstream"], r["backward"], r["end_to_end"]
    log(f"  bf16 step's mask-logit gradient vs the f32 mask head's on its own"
        f" decoder feature and coarse maps: rel max {u['rel_max']:.2e} "
        f"(limit {MASK_HEAD_UPSTREAM_TOL}), rel L2 {u['rel_l2']:.2e}")
    log(f"  bf16 step's mask-head convs vs their exactly rounded bf16 results"
        f" on its own inputs (rel max, limit {MASK_HEAD_FORWARD_TOL}; share "
        f"over a bf16 step; sign flips, of them in the outer ring): "
        + "; ".join(f"conv {i} {f['rel_max']:.2e}, {f['over_ulp']:.2e}, "
                    f"{f['sign_flips']}, {f['ring_flips']}"
                    for i, f in enumerate(r["forward"])))
    log(f"  bf16 step's {len(e['rel_l2'])} mask-head gradients vs the f64 "
        f"backward through its own conv outputs from its own mask-logit "
        f"gradient: worst {b['grad']:.2e} (limit "
        f"{MASK_HEAD_BACKWARD_TOL['grad']}; {b['worst']}), median "
        f"{b['grad_median']:.2e} (limit "
        f"{MASK_HEAD_BACKWARD_TOL['grad_median']}) of their tensor's max")
    log(f"  bf16 step's mask-head gradients vs the f32 mask head's (not "
        f"gated): worst {e['grad']:.2e} ({e['worst']}, max|g| "
        f"{e['worst_max']:.2e}), median {e['grad_median']:.2e} of their "
        f"tensor's max; rel L2 " + ", ".join(
            f"{n[len('mask_head.'):]} {v:.2e}"
            for n, v in e["rel_l2"].items()))


def only(res: tuple, prefix: str) -> tuple:
    """A step's (loss, gradients) with the gradients of ``prefix``'s
    tensors alone."""
    return res[0], {k: v for k, v in res[1].items() if k.startswith(prefix)}


def grad_errors(res: tuple, ref: tuple) -> dict:
    (loss, grads), (loss_ref, grads_ref) = res, ref
    if not grads or grads.keys() != grads_ref.keys():
        raise RuntimeError("the steps differ in what they train")
    g = [(grads[k] - v).abs().max().item() / v.abs().max().item()
         for k, v in grads_ref.items()]
    worst = list(grads_ref)[int(np.argmax(g))]
    return dict(loss=abs(loss - loss_ref) / abs(loss_ref), grad=max(g),
                grad_median=float(np.median(g)), worst=worst,
                worst_max=grads_ref[worst].abs().max().item())


def check_magnet_train_step(args, gate: bool = True,
                            keep: dict = None) -> dict:
    """One stage-3 step (loss and gradients, no update) from the phase's
    loaded model (G-Net's last conv scaled by 0.05: residuals of O(1), as a
    trained G-Net gives) on its first batch, against the same step with f32
    weights and the plain encode (D-Net and F-Net on the CPU, the fuse on
    the card): the f32 step with the encode's kernels to
    MAGNET_TRAIN_F32_TOL; the bf16 step's loss and G-Net gradients to
    MAGNET_TRAIN_BF16_TOL, its mask head to ``mask_head_gates``' three
    limits on what ``capture_bf16_step`` takes of it (the readings against
    the f32 mask head and the f32 step printed beside); on the way the f32
    encode of the B (V + 1) frames against the plain one and row 4 at batch
    B against its plain version. Without ``gate`` the readings come back
    with the gates out of their limits under ``failed``. A dict ``keep``
    receives the model, the batch and the captured bf16 step."""
    model = build_magnet_train(args, "cuda")
    with torch.no_grad():
        model.g_net.gnet[6].weight.mul_(0.05)
    raw = base.collate([SyntheticMultiView(args).get(i)
                        for i in range(MAGNET_TRAIN_B)])
    batch = train_magnet.batch_to_device(raw, "cuda")
    cap = capture_bf16_step(model, batch, args)
    bf16 = cap["step"]
    f32 = magnet_step_grads(model, batch, args, torch.float32)
    cpu = copy.deepcopy(model).cpu()
    B, V = MAGNET_TRAIN_B, VIEWS
    imgs = torch.cat([raw_t.reshape(-1, H, W, 3) for raw_t in (
        torch.from_numpy(raw["ref_img"]), torch.from_numpy(raw["src_imgs"]))])
    t = time.perf_counter()
    plain = [e.cuda() for e in cpu.encode(imgs)]
    cpu_s = time.perf_counter() - t
    # the encode's kernels at N = B (V + 1) frames against the plain encode,
    # f32, at the whole-forward limit of phase 7
    card = model.encode(imgs.cuda())
    enc_err = []
    for name, a, b in zip(("gauss", "decoder feature", "matching feature"),
                          card, plain):
        err = (a - b).abs().max().item()
        lim = MAGNET_TOL * b.abs().max().item()
        log(f"  encode of {imgs.shape[0]} frames, {name}, f32 card vs CPU: "
            f"max_abs_err {err:.3e} (limit {lim:.3e})")
        if not err <= lim:
            raise RuntimeError(f"the encode at N = {imgs.shape[0]} disagrees "
                               "with its plain version")
        enc_err.append(err / b.abs().max().item())
    gauss, feat_d, feat_m = plain
    encodings = (gauss[:B], feat_d[:B].contiguous(), feat_m[:B],
                 gauss[B:].reshape(B, V, *gauss.shape[1:]),
                 feat_m[B:].reshape(B, V, *feat_m.shape[1:]))
    # row 4 on the batch of B samples against its plain version
    geo = [batch[k] for k in ("R", "t", "is_valid", "intM", "rays2d")]
    d_volume = encodings[0][..., 0:1] + encodings[0][..., 1:2] * model.k_list
    cv_args = [d_volume, encodings[2], encodings[4], encodings[3][..., 0],
               encodings[3][..., 1], *geo]
    cv = cvk.cost_volume_cw(*cv_args, model.kappa)
    cv_ref, margin = cvk.cost_volume_cw_ref(*cv_args, model.kappa,
                                            return_margin=True)
    cv_err, cv_lim, excluded = cvk.compare(cv, cv_ref, margin,
                                           KERNEL_TOL[torch.float32])
    log(f"  cost_volume_cw at batch {B}, f32: max_abs_err {cv_err:.3e} "
        f"(limit {cv_lim:.3e}), {excluded:.5f} of the elements within "
        f"{cvk.MARGIN} of the threshold left out")
    ref = magnet_step_grads(model, batch, args, torch.float32, encodings)
    if not ref[0] > 0 or not all(g.abs().max() > 0
                                 for g in ref[1].values()):
        raise RuntimeError("the reference step has no gradient")
    mask = only(bf16, "mask_head.")
    errs = {"f32": grad_errors(f32, ref),
            "bf16": grad_errors(only(bf16, "g_net."), only(ref, "g_net.")),
            "bf16_mask_head_vs_f32_step": grad_errors(
                mask, only(ref, "mask_head."))}
    for name, what, n, tol in (
            ("f32", "G-Net and mask-head", len(ref[1]), MAGNET_TRAIN_F32_TOL),
            ("bf16", "G-Net", len(only(ref, "g_net.")[1]),
             MAGNET_TRAIN_BF16_TOL)):
        e = errs[name]
        log(f"  {name} step (the encode's kernels) vs the f32 step with the "
            f"plain encode (CPU, {cpu_s:.1f} s): loss {ref[0]:.6f}, rel err "
            f"{e['loss']:.2e} (limit {tol['loss']}); {n} {what} gradients "
            f"worst {e['grad']:.2e} (limit {tol['grad']}), median "
            f"{e['grad_median']:.2e} (limit {tol['grad_median']}) of their "
            f"tensor's max")
    heads = mask_head_gates(model.mask_head, model.downsample_ratio, cap,
                            batch, args)
    log_mask_head(heads)
    e = errs["bf16_mask_head_vs_f32_step"]
    log(f"  bf16 step's mask-head gradients vs the f32 step's (not a gate): "
        f"worst {e['grad']:.2e} ({e['worst']}, max|g| {e['worst_max']:.2e}),"
        f" median {e['grad_median']:.2e}")
    failed = [f"{name} step loss {errs[name]['loss']:.3e}, gradients worst "
              f"{errs[name]['grad']:.3e}, median "
              f"{errs[name]['grad_median']:.3e} (limits {tol})"
              for name, tol in (("f32", MAGNET_TRAIN_F32_TOL),
                                ("bf16", MAGNET_TRAIN_BF16_TOL))
              if not all(errs[name][k] <= v for k, v in tol.items())]
    failed += mask_head_failures(heads)
    if gate and failed:
        raise RuntimeError("the stage-3 step out of its limits: "
                           + "; ".join(failed))
    if keep is not None:
        keep.update(model=model, batch=batch, cap=cap)
    return dict(errs, mask_head=heads, encode_rel_err=max(enc_err),
                cv_err=cv_err, cv_excluded=excluded, cpu_encode_s=cpu_s,
                failed=failed)


# ---- phase 14: streaming inference ----------------------------------------

class SlidingWindows:
    """A synthetic video of ``n`` frames of one scene along a smooth path,
    and its windows: reference r with neighbours r - 2, r - 1, r + 1, r + 2,
    stepping one frame. A frame keeps its view id in every window."""

    def __init__(self, args, n: int):
        from magnet_tpu_torch.data import synthetic
        from magnet_tpu_torch.geometry import rays as rays_lib
        self.args, self.n = args, n
        h, w = args.input_height, args.input_width
        K = np.array([[0.9 * w, 0, w / 2], [0, 0.9 * w, h / 2], [0, 0, 1.0]])
        self.intM, self.rays2d = rays_lib.intrinsics_for_dpv(
            K, w, h, args.dpv_width, args.dpv_height)
        self.frames, self.depths, self.poses = [], [], []
        pose = np.eye(4)
        for i in range(n):
            rng = np.random.RandomState(100 + i)
            tex = np.stack([synthetic._smooth_noise(rng, h, w)
                            for _ in range(3)], -1)
            self.frames.append(base.normalize_image(
                np.clip(0.5 + 0.25 * tex, 0, 1).astype(np.float32)))
            self.depths.append(np.clip(
                2.5 + synthetic._smooth_noise(rng, h, w), 0.5, 9.5))
            self.poses.append(pose)
            pose = pose @ synthetic._small_pose(rng)

    def __len__(self) -> int:
        return self.n - 4

    def get(self, idx: int, rng=None) -> dict:
        from magnet_tpu_torch.data import scannet
        ids = list(range(idx, idx + 5))
        return scannet._pack_multiview(
            [self.frames[i] for i in ids], [self.poses[i] for i in ids],
            self.depths[idx + 2], 2, self.intM, self.rays2d, "video",
            str(idx + 2), frame_ids=[str(i) for i in ids])


def encode_batch_dependence(model, imgs: torch.Tensor) -> dict:
    """Max |difference| between encoding the window's frames together (N = 5)
    and one at a time (N = 1): ``encode``'s three outputs, and stage by
    stage, once with each stage given the same input at both N (the N = 5
    run's, sliced: "isolated") and once along each N's own path
    ("chained"): the D-Net trunk (eager cuDNN), the decoder's 1x1 conv2 and
    up1 (plain), up2 and up3 (rows 1-2), the head chain (row 3, on the
    D-Net's mask head: the depth head's last conv is 0 here), the F-Net
    (rows 6-9 with its plain stem conv and SPP branches)."""
    dd = model.d_net.d_net
    dec = dd.decoder

    def stages(x):
        """(name, fn, inputs, output) of each stage along x's own path."""
        taps = dd.encoder(nchw(x))
        f4, f5, f6, f8, f11 = taps
        out = [("trunk", None, None, taps)]
        fn = lambda t: nhwc(conv2d(t, dec.conv2))
        y = fn(f11)
        out.append(("conv2", fn, [f11], y))
        for i, skip in enumerate([f8, f6, f5, f4][:dec.n_ups]):
            up = getattr(dec, f"up{i + 1}")
            fn = lambda a, b, up=up: up(a, nhwc(b))
            nxt = fn(y, skip)
            out.append((f"up{i + 1}", fn, [y, skip], nxt))
            y = nxt
        fn = lambda a: run_head(dec.mask_head, a)
        out.append(("head chain", fn, [y], fn(y)))
        out.append(("F-Net", model.f_net, [x], model.f_net(x)))
        return out

    diff = {"encode": {}, "isolated": {}, "chained": {}}

    def note(kind, name, a, b):
        for ai, bi in (zip(a, b) if isinstance(a, (list, tuple))
                       else [(a, b)]):
            d = (ai.float() - bi.float()).abs().max().item()
            diff[kind][name] = max(diff[kind].get(name, 0.0), d)

    with torch.inference_mode():
        enc5 = model.encode(imgs)
        full = stages(imgs)
        for i in range(imgs.shape[0]):
            enc1 = model.encode(imgs[i:i + 1])
            for name, a, b in zip(("gauss", "decoder feature",
                                   "matching feature"), enc1, enc5):
                note("encode", name, a, b[i:i + 1])
            for (name, fn, ins, out5), (_, _, _, out1) in zip(
                    full, stages(imgs[i:i + 1])):
                sl = ([t[i:i + 1] for t in out5] if name == "trunk"
                      else out5[i:i + 1])
                note("chained", name, out1, sl)
                note("isolated", name, out1 if fn is None else
                     fn(*[t[i:i + 1] for t in ins]), sl)
    return diff


def fusion_regime_(model, seed: int = 5):
    """``realistic_depth_init_`` leaves G-Net's last conv at 0, so the fusion
    would not move the map and a difference of features would not show;
    give it weights at half the fan-in scale (residuals of O(0.5) sigma:
    the map moves by several bf16 ulps, where phase 7's 0.05 moves it by
    less than one) and bring the matching costs to O(1) (the F-Net's
    projection / 500, as phase 7 does)."""
    realistic_depth_init_(model)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        model.f_net.f_net.lastconv[2].weight.mul_(1.0 / 500.0)
        w = model.g_net.gnet[6].weight
        w.copy_(torch.randn(w.shape, generator=g) * (0.5 * 128 ** -0.5))
    return model


def run_streaming_path(exp_dir: str) -> dict:
    """``test_magnet --cache_features`` (its streaming forward, the
    harness) at test_scripts/magnet/scannet.txt's shape on a
    STREAM_FRAMES-frame sliding-window sequence, then the monolithic forward
    on the same windows: hits and misses (one miss a window in steady
    state), ms per window by CUDA events, the largest difference between
    the two, and which stage of the encode depends on the batch."""
    args = config.setup_exp_dirs(magnet_args(
        "cuda", "bfloat16", 1, exp_dir, ["--cache_features"]))
    model, forward = test_magnet.prepare(args)
    fusion_regime_(model)
    mono = test_magnet.make_forward(model, torch.bfloat16,
                                    torch.device("cuda"), ITERS)
    windows = base.Loader(SlidingWindows(args, STREAM_FRAMES), num_workers=1)
    res = {"stream": ([], []), "mono": ([], [])}

    def timed(fn, name):
        def call(batch):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(batch)                 # ends in a copy to the host
            ev[1].record()
            torch.cuda.synchronize()
            res[name][0].append(ev[0].elapsed_time(ev[1]))
            res[name][1].append(out)
            return out
        return call

    reset_counts()
    m_stream = harness.evaluate_magnet(timed(forward, "stream"), windows,
                                       args, progress=False)
    counts = read_counts()
    m_mono = harness.evaluate_magnet(timed(mono, "mono"), windows, args,
                                     progress=False)
    cache = forward.cache
    n_win = len(windows)
    log(f"  {STREAM_FRAMES} frames, {n_win} windows: cache {cache.hits} hits "
        f"/ {cache.misses} misses (hit rate {cache.hit_rate:.3f})")
    if (cache.misses, cache.hits) != (STREAM_FRAMES,
                                      n_win * (VIEWS + 1) - STREAM_FRAMES):
        raise RuntimeError("the streaming cache did not miss once a window "
                           "in steady state")
    want = dict.fromkeys(WRAPPERS, 0)
    want.update(conv3x3_bnact=4 * STREAM_FRAMES, head_chain=STREAM_FRAMES
                + 2 * n_win, cost_volume_cw=ITERS * n_win,
                gnet_update=ITERS * n_win, upsample_mask=n_win,
                **{k: v * STREAM_FRAMES for k, v in FNET_LAUNCHES.items()})
    log(f"  streaming launches: found {counts}, expected {want}")
    if counts != want:
        raise RuntimeError("the streaming path did not run its kernels as "
                           "expected")
    outs = {k: v[1] for k, v in res.items()}
    for o in outs["stream"]:
        if o.shape != (1, H, W, 2) or not np.isfinite(o).all() or not (
                o[..., 1] > 0).all():
            raise RuntimeError("bad streaming output")
    moved = max(float(np.abs(b[..., 0] - 2.0).max()) for b in outs["mono"])
    if not moved > 0.05:            # 3 bf16 ulps of the initial 2 m
        raise RuntimeError(f"the fusion moved the map by {moved:.3e} only: "
                           "a comparison would see no feature")
    diff = max(float(np.abs(a - b).max())
               for a, b in zip(outs["stream"], outs["mono"]))
    equal = all(np.array_equal(a, b)
                for a, b in zip(outs["stream"], outs["mono"]))
    scale = max(float(np.abs(b).max()) for b in outs["mono"])
    ms = {k: float(np.mean(v[0][1:])) for k, v in res.items()}
    log(f"  ms per window by CUDA events (windows 2-{n_win}, host copies "
        f"included): streaming {ms['stream']:.3f}, monolithic "
        f"{ms['mono']:.3f} (first window {res['stream'][0][0]:.3f} / "
        f"{res['mono'][0][0]:.3f}); largest |streaming - monolithic| "
        f"{diff:.4e} of max|map| {scale:.4e} (the fusion moved mu by up to "
        f"{moved:.4f} m), equal bit for bit: {equal}; "
        f"abs_rel {m_stream['abs_rel']:.5f} / {m_mono['abs_rel']:.5f}")
    if not diff <= STREAM_TOL * scale:
        raise RuntimeError("the streaming forward disagrees with the "
                           "monolithic one")
    batch = windows.dataset.get(0)
    imgs = torch.from_numpy(np.concatenate(
        [batch["ref_img"][None], batch["src_imgs"]])).to("cuda",
                                                         torch.bfloat16)
    dep = encode_batch_dependence(model, imgs)
    for kind, d in dep.items():
        log(f"  the encode at N = 1 against N = 5, max |diff|, {kind}: "
            + ", ".join(f"{k} {v:.3e}" for k, v in d.items()))
    return dict(hits=cache.hits, misses=cache.misses, windows=n_win,
                ms_per_window=ms, first_window_ms={k: v[0][0] for k, v in
                                                   res.items()},
                max_abs_diff=diff, equal=equal, max_abs_map=scale,
                fusion_moved=moved,
                launches=counts, batch_dependence=dep,
                abs_rel=dict(stream=m_stream["abs_rel"],
                             mono=m_mono["abs_rel"]))


# ---- phase 15: the GroupNorm D-Net decoder (DenseDepth_GN) ------------------

def gn_dnet_outputs(args, img: np.ndarray, dtype, device: str) -> torch.Tensor:
    """One forward of the flags' D-Net (seeded weights, ``dtype``) on
    ``device``; the output f32 on the CPU."""
    model = cast_for_inference(build_dnet(args, "cpu"), dtype).to(device)
    with torch.inference_mode():
        return model(torch.from_numpy(img).to(device, dtype)).float().cpu()


def dnet_splits() -> dict:
    """``profile_dnet.stage_times`` (CUDA events around each stage of the
    D-Net forward at 480x640, bf16, batch 1) of the BN and the GN D-Net,
    side by side."""
    x = torch.randn(1, H, W, 3, generator=torch.Generator().manual_seed(0))
    x = x.to("cuda", torch.bfloat16)
    out = {}
    for name, use_bn in (("BN", True), ("GN", False)):
        model = cast_for_inference(init_weights_(
            DNet(use_bn=use_bn), 0).eval().cuda(), torch.bfloat16)
        with torch.inference_mode():
            out[name] = dnet_stage_times(model, x)
    for (a, ms_bn), (b, ms_gn) in zip(out["BN"].items(), out["GN"].items()):
        log(f"    {a:34s} BN {ms_bn:9.4f} ms | {b:34s} GN {ms_gn:9.4f} ms")
    return out


def check_gn_dnet(exp_dir: str) -> dict:
    """The GN D-Net in f32 on the card against the CPU at GN_F32_HxGN_F32_W
    (FORWARD_TOL * max|ref|, phase 5's limit), and the bf16 frame on the
    card against the f32 one at 480x640 (``compare_bf16_maps``, phase 7's
    limits for one map: 1 bf16 ulp of the map plus BF16_FORWARD_TOL of its
    range, on all but MAGNET_FLIPS of the pixels)."""
    args = dnet_args("cuda", "float32", 1, exp_dir,
                     GN_FLAGS + ["--input_height", str(GN_F32_H),
                                 "--input_width", str(GN_F32_W)])
    img = SyntheticSingleView(args).get(0)["img"][None]
    ref = gn_dnet_outputs(args, img, torch.float32, "cpu")
    out = gn_dnet_outputs(args, img, torch.float32, "cuda")
    err = (out - ref).abs().max().item()
    lim = FORWARD_TOL * ref.abs().max().item()
    log(f"  f32 GN D-Net card vs CPU at {GN_F32_H}x{GN_F32_W}: max_abs_err "
        f"{err:.3e} (limit {lim:.3e})")
    if not err <= lim:
        raise RuntimeError("the f32 GN D-Net on the card disagrees with the "
                           "CPU")
    args = dnet_args("cuda", "float32", 1, exp_dir, GN_FLAGS)
    img = SyntheticSingleView(args).get(0)["img"][None]
    f32 = gn_dnet_outputs(args, img, torch.float32, "cuda")
    bf = gn_dnet_outputs(args, img, torch.bfloat16, "cuda")
    worst = compare_bf16_maps([bf], [f32], f"bf16 GN D-Net vs f32 at {H}x{W}",
                              names=("mu", "var"))
    return dict(f32_err=err, f32_limit=lim, **worst)


# ---- phase 16: the on-disk datasets -----------------------------------------

def _texture(rng, w: int, h: int):
    """A smooth random RGB frame (a coarse random image resized)."""
    from PIL import Image
    small = rng.randint(0, 255, (max(2, h // 16), max(2, w // 16), 3),
                        dtype=np.uint8)
    return Image.fromarray(small).resize((w, h), Image.BILINEAR)


def _depth_png(path: Path, d: np.ndarray) -> np.ndarray:
    from PIL import Image
    Image.fromarray(d.astype(np.uint16)).save(path, compress_level=1)
    return d.astype(np.uint16)


def _pose_txt(path: Path, i: int) -> None:
    """cam2world: a slow yaw and a step forward a frame."""
    a = 0.002 * i
    m = np.eye(4)
    m[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                 [-np.sin(a), 0, np.cos(a)]]
    m[:3, 3] = [0.01 * i, 0.0, 0.02 * i]
    np.savetxt(path, m)


def _split(name: str, n: int) -> list:
    return [ln.split() for ln in
            (REPO / "data_split" / name).read_text().split("\n")[:n]]


def write_ondisk_trees(root: Path) -> dict:
    """Small trees at the datasets' raw sizes, named after the first entries
    of the repository's split files: ScanNet scans_test (colour JPEG
    1296x968, depth PNG 640x480, poses, intrinsic_color.txt), 7-Scenes
    (colour and depth PNG 640x480 with 65535 holes, poses), KITTI
    (colour PNG 1242x375, proj_depth/groundtruth PNGs, calibration files,
    OXTS rows; the eigen_test windows and ONDISK_KITTI_TRAIN entries of
    eigen_train). Returns the depth written for each ground-truth file."""
    rng = np.random.RandomState(16)
    written = {}
    frames = range(0, 51, 5)   # every window frame and fallback of 0-30
    scene = _split("scannet_long_test.txt", 1)[0][0]
    sdir = root / "scannet" / "scans_test" / scene
    for sub in ("color", "depth", "pose", "intrinsic"):
        (sdir / sub).mkdir(parents=True, exist_ok=True)
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 1170.19, 1170.19, 647.75, 483.75
    np.savetxt(sdir / "intrinsic" / "intrinsic_color.txt", K)
    for i in frames:
        _texture(rng, 1296, 968).save(sdir / "color" / f"{i}.jpg",
                                      quality=90)
        written["scannet", i] = _depth_png(
            sdir / "depth" / f"{i}.png", rng.randint(300, 9000, (480, 640)))
        _pose_txt(sdir / "pose" / f"{i}.txt", i)
    chess, seq = _split("sevenscenes_long_test.txt", 1)[0][:2]
    qdir = root / "7scenes" / chess / ("seq-%02d" % int(seq))
    qdir.mkdir(parents=True, exist_ok=True)
    for i in frames:
        _texture(rng, 640, 480).save(qdir / ("frame-%06d.color.png" % i),
                                     compress_level=1)
        d = rng.randint(300, 5000, (480, 640))
        d[rng.rand(480, 640) < 0.05] = 65535
        written["7scenes", i] = _depth_png(
            qdir / ("frame-%06d.depth.png" % i), d)
        _pose_txt(qdir / ("frame-%06d.pose.txt" % i), i)
    kroot = root / "kitti"
    R9 = " ".join(map(str, np.eye(3).reshape(-1)))
    P = [721.5377, 0, 609.5593, 44.85728, 0, 721.5377, 172.854, 0.2163791,
         0, 0, 1, 0.002745884]
    test = _split("kitti_eigen_test.txt", ONDISK_BATCHES)
    train = _split("kitti_eigen_train.txt", ONDISK_KITTI_TRAIN)
    for date in {e[0] for e in test + train}:
        ddir = kroot / "rawdata" / date
        ddir.mkdir(parents=True, exist_ok=True)
        (ddir / "calib_imu_to_velo.txt").write_text(
            f"R: {R9}\nT: -0.8086759 0.3195559 -0.7997231\n")
        (ddir / "calib_velo_to_cam.txt").write_text(
            f"R: {R9}\nT: -0.004069766 -0.07631618 -0.2717806\n")
        (ddir / "calib_cam_to_cam.txt").write_text(
            f"R_rect_00: {R9}\nP_rect_02: " + " ".join(map(str, P)) + "\n")
    need = {}
    for date, drive, tok, idx in test:
        for j in range(int(idx) - 2, int(idx) + 3):    # window radius 2
            need[date, drive, tok, j] = j == int(idx)
    for date, drive, tok, idx in train:
        need[date, drive, tok, int(idx)] = True
    for (date, drive, tok, j), gt in need.items():
        sc = f"{date}_drive_{drive}_sync"
        raw = kroot / "rawdata" / date / sc
        for sub in ("image_02/data", "oxts/data"):
            (raw / sub).mkdir(parents=True, exist_ok=True)
        _texture(rng, 1242, 375).save(
            raw / "image_02" / "data" / ("%010d.png" % j), compress_level=1)
        (raw / "oxts" / "data" / ("%010d.txt" % j)).write_text(" ".join(
            map(str, [49.0 + 1e-5 * j, 8.43 + 2e-5 * j, 112.0, 0.01, 0.0,
                      1.2 + 1e-3 * j] + [0.0] * 24)))
        if gt:
            gdir = kroot / tok / sc / "proj_depth" / "groundtruth" / \
                "image_02"
            gdir.mkdir(parents=True, exist_ok=True)
            d = rng.randint(256, 80 * 256, (375, 1242))
            d[rng.rand(375, 1242) < 0.9] = 0          # sparse, as LiDAR is
            written["kitti", date, drive, j] = _depth_png(
                gdir / ("%010d.png" % j), d)
    return written


def ondisk_args(name: str, root: Path, exp_dir: str, extra=()):
    """The flags of test_scripts/magnet/<name>.txt on the tree under
    ``root``, without checkpoints, bf16 on the card."""
    sub = {"scannet": "scannet", "7scenes": "7scenes",
           "kitti_eigen": "kitti"}[name]
    args = config.parse_args(config.build_test_magnet_parser(), [
        "@" + str(REPO / "test_scripts" / "magnet" / f"{name}.txt"),
        "--exp_name", f"chip_smoke_{name}", "--exp_dir", exp_dir,
        "--dataset_path", str(root / sub), "--DNET_ckpt", "", "--FNET_ckpt",
        "", "--MAGNET_ckpt", "", "--device", "cuda", "--compute_dtype",
        "bfloat16", *extra])
    return config.setup_exp_dirs(args)


def check_ondisk_batch(name: str, batch: dict, written: dict) -> None:
    """The arrays of a batch against what was written: depth = uint16 /
    1000 (ScanNet; 7-Scenes with 65535 as 0) or / 256 inside the kb-crop
    (KITTI); finite R, t and intM; every view valid."""
    idx = int(batch["img_idx"][0])
    if name == "scannet":
        want = written["scannet", idx] / np.float32(1000.0)
    elif name == "7scenes":
        d = written["7scenes", idx]
        want = np.where(d == 65535, 0, d) / np.float32(1000.0)
        if not (batch["depth"][0] == 0).any():
            raise RuntimeError("7-Scenes: no hole read as 0")
    else:
        date, drive = batch["scene_name"][0].split("_drive_")
        d = written["kitti", date, drive[:4], idx]
        want = d[375 - 352:, (1242 - 1216) // 2:][:352, :1216] / \
            np.float32(256.0)
    if not np.array_equal(batch["depth"][0], want.astype(np.float32)):
        raise RuntimeError(f"{name}: the depth read is not the depth "
                           "written")
    for k in ("R", "t", "intM"):
        if not np.isfinite(batch[k]).all():
            raise RuntimeError(f"{name}: {k} not finite")
    if not batch["is_valid"].all():
        raise RuntimeError(f"{name}: a view is not valid")


def run_ondisk_path(exp_dir: str, dnet_step_ms: float) -> dict:
    """Phase 16: the trees of ``write_ondisk_trees`` through the port's
    dispatch (``data.make_multiview_loader`` at the entry point's split):
    the first ONDISK_BATCHES batches of each dataset held to what was
    written, host ms per sample; the MaGNet forward (test_magnet's, bf16,
    seeded weights in a trained network's regime) on each batch at the
    flag file's full shape, finite maps and the harness's metric line; the
    KITTI eigen_train single-view loader with augmentation at batch
    DNET_TRAIN_B and its 352x704 crop, host ms per batch at 1 and 4
    workers, beside the stage-1 step's time."""
    from magnet_tpu_torch.data import (TEST_MODES, make_multiview_loader,
                                       make_singleview_loader)
    from magnet_tpu_torch.eval import metrics as M
    root = REPO / "build" / "chip_smoke_data"
    t = time.perf_counter()
    written = write_ondisk_trees(root)
    log(f"  trees written under {root.relative_to(REPO)} in "
        f"{time.perf_counter() - t:.2f} s")
    out = {}
    for name, extra in (("scannet", ()), ("7scenes", ()),
                        ("kitti_eigen", ("--stream_blocks",))):
        args = ondisk_args(name, root, exp_dir, extra)
        loader = make_multiview_loader(args, TEST_MODES[name])
        t, batches = time.perf_counter(), []
        for b in loader:
            batches.append(b)
            if len(batches) == ONDISK_BATCHES:
                break
        host_ms = 1e3 * (time.perf_counter() - t) / ONDISK_BATCHES
        for b in batches:
            check_ondisk_batch(name, b, written)
        model, forward = test_magnet.prepare(args)
        realistic_depth_init_(model)
        shape = (1, args.input_height, args.input_width, 2)

        def checked(batch):
            o = forward(batch)
            if o.shape != shape or not np.isfinite(o).all() or \
                    not (o[..., 1] > 0).all():
                raise RuntimeError(f"{name}: bad MaGNet output {o.shape}")
            return o
        t = time.perf_counter()
        m = harness.evaluate_magnet(checked, batches, args, progress=False)
        fwd_ms = 1e3 * (time.perf_counter() - t) / len(batches)
        if not all(np.isfinite(v) for v in m.values()):
            raise RuntimeError(f"{name}: non-finite metrics {m}")
        M.log_metrics(args.test_acc_txt, m, f"dataset: {name} (phase 16 "
                      f"tree, {len(batches)} samples, seeded weights)")
        log(f"  {name}: {len(batches)} batches of {loader.__class__.__name__}"
            f" over {type(loader.dataset).__name__}, "
            f"{args.input_height}x{args.input_width}, "
            f"{args.MAGNET_num_source_views} source views: host "
            f"{host_ms:.3f} ms per sample to load; MaGNet forward incl. "
            f"copies {fwd_ms:.3f} ms per sample; depth, poses and "
            f"intrinsics as written")
        out[name] = dict(load_ms_per_sample=host_ms, forward_ms=fwd_ms,
                         metrics=m)
        del model, forward
        torch.cuda.empty_cache()
    targs = config.parse_args(config.build_train_dnet_parser(), [
        "@" + str(REPO / "train_scripts" / "dnet" / "kitti_eigen.txt"),
        "--dataset_path", str(root / "kitti"), "--exp_name",
        "chip_smoke_kitti_train", "--exp_dir", exp_dir, "--batch_size",
        str(DNET_TRAIN_B)])
    timing = {}
    for workers in (1, 4):
        targs.workers = workers
        loader = make_singleview_loader(targs, "eigen_train")
        # the first ONDISK_KITTI_TRAIN entries of the split: the files
        # written
        loader.dataset.entries = loader.dataset.entries[:ONDISK_KITTI_TRAIN]
        t, n = time.perf_counter(), 0
        for b in loader:
            n += 1
            if b["img"].shape != (DNET_TRAIN_B, 352, 704, 3) or \
                    not np.isfinite(b["depth"]).all():
                raise RuntimeError("bad KITTI training batch")
        ms = 1e3 * (time.perf_counter() - t) / n
        timing[workers] = ms
        log(f"  KITTI eigen_train single-view, augmented (rotate, flip, "
            f"crop 352x704, colour), batch {DNET_TRAIN_B}, --workers "
            f"{workers}: {ms:.3f} ms per batch over {n} batches (host)")
    log(f"  the stage-1 step at 416x544 (phase 12): {dnet_step_ms:.3f} ms; "
        f"the loader keeps up at --workers 1: {timing[1] <= dnet_step_ms}, "
        f"at --workers 4: {timing[4] <= dnet_step_ms}")
    out["kitti_train_loader_ms_per_batch"] = timing
    return out


# ---- phase 17: the kernels as PyTorch operators -----------------------------

def _clone(a):
    if torch.is_tensor(a):
        return a.detach().clone()
    if isinstance(a, (list, tuple)):
        return type(a)(_clone(x) for x in a)
    return a


@contextlib.contextmanager
def patched_ops(make):
    """Every ``kernels.ops`` operator, as the wrappers find it
    (``ops.OPS.<name>``), replaced by ``make(name, operator)`` until the
    block ends."""
    saved = {n: getattr(ops.OPS, n) for n in ops.op_names()}
    for n, op in saved.items():
        setattr(ops.OPS, n, make(n, op))
    try:
        yield
    finally:
        for n, op in saved.items():
            setattr(ops.OPS, n, op)


def first_calls(calls: dict):
    """``patched_ops`` that keeps a copy of each operator's first arguments
    outside a CUDA-graph capture in ``calls``."""
    def make(name, op):
        def call(*args):
            if (name not in calls
                    and not torch.cuda.is_current_stream_capturing()):
                calls[name] = _clone(args)
            return op(*args)
        return call
    return patched_ops(make)


def direct_impls():
    """The wrappers calling the CUDA implementations as plain functions,
    past the dispatcher: the launch path before the kernels were
    operators."""
    return patched_ops(lambda name, op: ops.IMPLS[name])


def check_operators(calls: dict) -> dict:
    """``torch.library.opcheck`` (schema, autograd registration, fake
    tensor, AOT dispatch with dynamic shapes) of each operator on its first
    phase-3 site's arguments."""
    out = {}
    for name in ops.op_names():
        if name not in calls:
            raise RuntimeError(f"operator {name} was not called in phase 3")
        t = time.perf_counter()
        res = torch.library.opcheck(getattr(ops.OPS, name), calls[name])
        shapes = [tuple(a.shape) for a in calls[name] if torch.is_tensor(a)]
        log(f"  opcheck {name} at {shapes[0]}: {res} "
            f"({time.perf_counter() - t:.1f} s)")
        if any(v != "SUCCESS" for v in res.values()):
            raise RuntimeError(f"opcheck failed for {name}: {res}")
        out[name] = res
    return out


def main_path_model(exp_dir: str):
    """Phase 6's model (the ScanNet eval flags, bf16, after
    ``realistic_depth_init_``) and its inputs for one synthetic sample: the
    images in bf16 and in f32."""
    args = config.setup_exp_dirs(magnet_args("cuda", "bfloat16", 1,
                                             exp_dir))
    model, _ = test_magnet.prepare(args)
    realistic_depth_init_(model)
    batch = {k: v[None] for k, v in SyntheticMultiView(args).get(0).items()
             if isinstance(v, np.ndarray)}
    dev = torch.device("cuda")
    return (model, test_magnet.batch_to_device(batch, torch.bfloat16, dev),
            test_magnet.batch_to_device(batch, torch.float32, dev))


def frame_ms(fn, frames: int = OP_AB_FRAMES) -> tuple:
    """(ms per frame by CUDA events over back-to-back forwards, ms per
    frame on the host clock to the end of the last)."""
    with torch.inference_mode():
        ev = cuda_ms(fn, iters=frames, warmup=2)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(frames):
            fn()
        torch.cuda.synchronize()
    return ev, 1e3 * (time.perf_counter() - t) / frames


def ab_turns(model, inputs) -> dict:
    """Phase 6's frame through the operators and with the implementations
    called directly, in turns (ops, direct, direct, ops, twice): the
    medians of each, by events and on the host clock."""
    res = {"ops": [], "direct": []}
    for mode in ("ops", "direct", "direct", "ops") * 2:
        with (direct_impls() if mode == "direct"
              else contextlib.nullcontext()):
            res[mode].append(frame_ms(lambda: model(*inputs)))
    return dict(
        events_ms={m: float(np.median([r[0] for r in v]))
                   for m, v in res.items()},
        host_ms={m: float(np.median([r[1] for r in v]))
                 for m, v in res.items()}, turns=res)


def call_us(fn, calls: int = 2000) -> float:
    """Host microseconds a call of ``fn``, the card synchronised at the
    end."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t) / calls


def operator_cost(model, inputs) -> dict:
    """The dispatcher's cost: one small operator's host time a call
    through the operator and as a plain function; phase 6's frame through
    the operators and past them (``ab_turns``), as the process stands and
    again with the garbage collector's objects frozen (a collection then
    skips the objects the earlier phases left alive); the Python threads
    alive."""
    x = torch.randn(1, 8, 8, 16, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(3, 3, 16, device="cuda", dtype=torch.bfloat16)
    with torch.inference_mode():
        op_us = call_us(lambda: ops.OPS.dw_conv(x, w))
        impl_us = call_us(lambda: ops.IMPLS["dw_conv"](x, w))
    res = dict(dw_conv_call_us=dict(op=op_us, impl=impl_us),
               threads=[t.name for t in threading.enumerate()],
               gc_objects=len(gc.get_objects()))
    log(f"  one dw_conv call at (1, 8, 8, 16): {op_us:.2f} us through the "
        f"operator, {impl_us:.2f} us as a plain function; Python threads "
        f"{res['threads']}; {res['gc_objects']} objects tracked by the "
        f"garbage collector")
    res["as_is"] = ab_turns(model, inputs)
    gc.collect()
    gc.freeze()
    try:
        res["gc_frozen"] = ab_turns(model, inputs)
    finally:
        gc.unfreeze()
    for key, what in (("as_is", "as the process stands"),
                      ("gc_frozen", "the collector's objects frozen")):
        ev, host = res[key]["events_ms"], res[key]["host_ms"]
        log(f"  MaGNet frame ({what}), kernels as operators: "
            f"{ev['ops']:.3f} ms by events, {host['ops']:.3f} ms host "
            f"clock; the implementations called directly: "
            f"{ev['direct']:.3f} / {host['direct']:.3f} ms (medians of 4 "
            f"turns of {OP_AB_FRAMES} frames); the operators cost "
            f"{ev['ops'] - ev['direct']:+.3f} ms per frame by events, "
            f"{host['ops'] - host['direct']:+.3f} ms host")
    return res


# ---- phase 18: training across processes -----------------------------------

@contextlib.contextmanager
def environ(**kw):
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def nccl_group_of_one() -> dict:
    """The environment of a process group of one over NCCL at a free port
    (``core/distributed.py``)."""
    return dict(MAGNET_TPU_DIST="1", MAGNET_TPU_NUM_PROCESSES="1",
                MAGNET_TPU_PROCESS_ID="0",
                MAGNET_TPU_COORDINATOR=distributed.free_port())


def dist_train_argv(exp_dir: str, name: str, steps_: int,
                    extra=()) -> list:
    """train_fnet's flags at the protocol of train_scripts/fnet/scannet.txt
    on ``steps_`` synthetic steps and a validation pass."""
    return ["@" + str(REPO / "train_scripts" / "fnet" / "scannet.txt"),
            "--dataset_name", "synthetic", "--dataset_path", "none",
            "--device", "cuda", "--exp_dir", exp_dir, "--exp_name", name,
            "--synthetic_length", str(steps_ * TRAIN_B), "--n_epochs", "1",
            "--validate_every", "1000000", "--log_every", "1", *extra]


def run_fnet(argv: list) -> dict:
    args = config.setup_exp_dirs(config.parse_args(
        config.build_train_fnet_parser(), argv), kind="train")
    reset_counts()
    out = train_fnet.train(args)
    out["launches"] = read_counts()
    out["state_cpu"] = {k: v.detach().cpu() for k, v in
                        out["state"].model.state_dict().items()}
    return out


def state_differences(a: dict, b: dict) -> dict:
    """Tensor name -> max |difference| of two runs' states, where not
    equal."""
    return {k: (v.double() - b["state_cpu"][k].double()).abs().max().item()
            for k, v in a["state_cpu"].items()
            if not torch.equal(v, b["state_cpu"][k])}


def check_distributed_training(exp_dir: str) -> dict:
    """Stage 2 through ``train_fnet`` at the protocol, DIST_STEPS steps from
    the seeded initialisation: undistributed twice (the sweep's backward,
    row 10, and cuDNN's backward sum in any order, so the runs' later
    steps need not repeat each other), then in a process group of one over
    NCCL: its first loss equal bit for bit, and one step's update from the
    same gradients through the group's path (the gradient all-reduce, the
    loss's mean over the ranks) equal to the undistributed update bit for
    bit; two processes over gloo, both on this card with the kernels on
    (the ranks equal bit for bit, every parameter moved, the losses within
    phase 9's bf16 loss limit of the undistributed run); one f32 step at
    phase 9's reduced shape over two processes against one process on the
    card at phase 9's f32 limits; ``dryrun_multichip`` over NCCL at one
    process."""
    one = run_fnet(dist_train_argv(exp_dir, "fnet_w0", DIST_STEPS))
    again = run_fnet(dist_train_argv(exp_dir, "fnet_w0b", DIST_STEPS))
    coordinator = nccl_group_of_one()
    with environ(**coordinator):
        nccl = run_fnet(dist_train_argv(exp_dir, "fnet_w1", DIST_STEPS))
    if torch.distributed.is_initialized():
        raise RuntimeError("train_fnet left its process group")
    spread, differ = state_differences(one, again), state_differences(
        one, nccl)
    log(f"  undistributed twice: losses {one['losses']}, {again['losses']};"
        f" {len(spread)} of {len(one['state_cpu'])} tensors differ, by at "
        f"most {max(spread.values(), default=0.0):.3e}")
    log(f"  W = 1 over NCCL: losses {nccl['losses']}; {len(differ)} tensors "
        f"differ from the first run, by at most "
        f"{max(differ.values(), default=0.0):.3e}; the same launches "
        f"{nccl['launches'] == one['launches']}")
    update = check_w1_update(exp_dir, coordinator)
    if (nccl["losses"][0] != one["losses"][0]
            or nccl["launches"] != one["launches"]
            or not np.isfinite(nccl["losses"]).all()):
        raise RuntimeError("the W = 1 NCCL run's first step is not the "
                           "undistributed one")

    out = str(Path(exp_dir) / "fnet_w2_rank{rank}.pt")
    t = time.perf_counter()
    distributed.spawn(dryrun.entry_worker, 2, (
        "train_fnet", dist_train_argv(exp_dir, "fnet_w2", DIST_STEPS), out),
        backend="gloo")
    spawn_s = time.perf_counter() - t
    ranks = [torch.load(out.format(rank=r), weights_only=False)
             for r in range(2)]
    diff = [k for k, v in ranks[0]["state"].items()
            if not torch.equal(v, ranks[1]["state"][k])]
    init = build_magnet_f(config.parse_args(
        config.build_train_fnet_parser(),
        dist_train_argv(exp_dir, "init", 1)), "cpu").state_dict()
    unmoved = [k for k, v in ranks[0]["state"].items()
               if "num_batches" not in k and torch.equal(v, init[k])]
    rel = [abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"],
                                              one["losses"])]
    per_rank = {k: v for k, v in ranks[0]["launches"].items() if v}
    log(f"  W = 2 over gloo on one card: losses {ranks[0]['losses']} "
        f"(rank 1 {ranks[1]['losses']}) against {one['losses']}: relative "
        f"{max(rel):.2e} (limit {BF16_TRAIN_TOL['loss']}); ranks differ in "
        f"{len(diff)} tensors, {len(unmoved)} unmoved; rank 0's launches "
        f"{per_rank}; step "
        f"{np.mean(ranks[0]['step_event_ms'][1:]):.3f} ms by events "
        f"(undistributed {np.mean(one['step_event_ms'][1:]):.3f}); "
        f"{spawn_s:.1f} s with the processes' start")
    if (diff or unmoved or not max(rel) <= BF16_TRAIN_TOL["loss"]
            or ranks[0]["losses"] != ranks[1]["losses"]
            or per_rank.get("sweep_grad_src") != DIST_STEPS):
        raise RuntimeError("the two-process F-Net run disagrees")

    step = check_two_process_step(exp_dir)
    t = time.perf_counter()
    dry = dryrun.dryrun_multichip(1, device="cuda")
    log(f"  dryrun_multichip(1) over NCCL on the card: rel "
        f"{dry['rel']:.3e} ({time.perf_counter() - t:.1f} s)")
    return dict(
        w1_nccl=dict(losses=nccl["losses"],
                     step_event_ms=nccl["step_event_ms"],
                     max_state_diff=max(differ.values(), default=0.0),
                     update=update),
        undistributed=dict(losses=[one["losses"], again["losses"]],
                           step_event_ms=one["step_event_ms"],
                           max_state_diff=max(spread.values(), default=0.0)),
        w2_gloo=dict(losses=[r["losses"] for r in ranks],
                     step_event_ms=[r["step_event_ms"] for r in ranks],
                     launches=per_rank, loss_rel=max(rel), spawn_s=spawn_s),
        f32_step=step, dryrun=dry)


def check_w1_update(exp_dir: str, coordinator: dict) -> dict:
    """One protocol step's gradients (one forward and backward), applied by
    the undistributed update and by the same update in a process group of
    one over NCCL (``mesh.average_gradients`` then the clip and AdamW; the
    loss through ``mesh.mean_over_ranks``): every tensor and the loss equal
    bit for bit."""
    args = config.parse_args(config.build_train_fnet_parser(),
                             dist_train_argv(exp_dir, "fnet_w1_step", 1))
    dev = torch.device("cuda")
    d_center = torch.from_numpy(sid_depth_centers(
        args.min_depth, args.max_depth, TRAIN_D)).to(dev)
    batch = train_fnet.batch_to_device(
        base.collate([SyntheticMultiView(args).get(i)
                      for i in range(TRAIN_B)]), (HC, WC), dev)
    models = [build_magnet_f(args, "cuda") for _ in range(2)]
    opts = [optim.make_fnet_optimizer(m.parameters(), args.lr, 10)
            for m in models]
    gt, mask = steps._clamped_gt(batch["depth_dpv"], args.max_depth,
                                 args.min_depth)
    cv = models[0](*[batch[k].to(torch.bfloat16) if "img" in k
                     else batch[k] for k in steps.MAGNET_INPUTS],
                   d_center)
    loss = train_losses.fnet_l1_loss(
        train_losses.soft_argmax_depth(cv, d_center), gt, mask)
    loss.backward()
    with torch.no_grad():
        for a, b in zip(models[0].parameters(), models[1].parameters()):
            b.grad = a.grad.clone()
        models[1].load_state_dict(models[0].state_dict())
    opts[0].step()
    with environ(**coordinator), distributed.session("cuda"):
        if torch.distributed.get_backend() != "nccl":
            raise RuntimeError("the group is not NCCL's")
        mesh.average_gradients(models[1].parameters())
        loss_w1 = mesh.mean_over_ranks(loss.detach())
        opts[1].step()
    differ = [k for k, v in models[0].state_dict().items()
              if not torch.equal(v, models[1].state_dict()[k])]
    log(f"  one step's update, undistributed and through the W = 1 NCCL "
        f"group: loss {loss.item():.9f} / {loss_w1.item():.9f}; "
        f"{len(differ)} tensors differ")
    if differ or not torch.equal(loss.detach(), loss_w1):
        raise RuntimeError(f"the W = 1 NCCL update is not the "
                           f"undistributed one bit for bit: {differ[:5]}")
    return dict(loss=loss.item(), tensors=len(models[0].state_dict()))


def check_two_process_step(exp_dir: str) -> dict:
    """One f32 F-Net step at SMALL_TRAIN from phase 9's conditioned weights
    and batch over two gloo processes on this card, against the same step
    in one process on the card: loss, clipped gradients and running
    buffers at phase 9's f32 limits."""
    c = SMALL_TRAIN
    args = protocol_args([
        "--exp_dir", exp_dir, "--input_height", str(c["H"]),
        "--input_width", str(c["W"]), "--dpv_height", str(c["H"] // 4),
        "--dpv_width", str(c["W"] // 4), "--FNET_num_depth_bins",
        str(c["D"]), "--MAGNET_num_source_views", str(c["V"]),
        "--batch_size", str(c["B"]), "--compute_dtype", "float32"])
    raw = base.collate([SyntheticMultiView(args).get(i)
                        for i in range(c["B"])])
    rng = np.random.RandomState(9)
    for k, n in (("ref_img", (c["B"],)), ("src_imgs", (c["B"], c["V"]))):
        raw[k] = raw[k] + (0.5 * rng.randn(*n, 1, 1, 3)).astype(np.float32)
    d_np = sid_depth_centers(args.min_depth, args.max_depth, c["D"])
    model = condition_(build_magnet_f(args, "cpu"))
    ref = train_step_outputs(model, raw, args, d_np, "cuda", torch.float32)
    case = Path(exp_dir) / "fnet_step_case.pt"
    batch = train_fnet.batch_to_device(raw, (args.dpv_height,
                                             args.dpv_width),
                                       torch.device("cpu"))
    torch.save(dict(state=model.state_dict(), feat=args.FNET_feature_dim,
                    batch={k: v.numpy() for k, v in batch.items()},
                    d_center=d_np, device="cuda", dtype=torch.float32,
                    lr=args.lr), case)
    out = str(Path(exp_dir) / "fnet_step_rank{rank}.pt")
    distributed.spawn(dryrun.fnet_step_worker, 2, (str(case), out),
                      backend="gloo")
    r = [torch.load(out.format(rank=i), weights_only=False)
         for i in range(2)]
    err = step_errors((r[0]["loss"], r[0]["grads"],
                       {k: v for k, v in r[0]["state"].items()
                        if "running" in k}), ref)
    equal = all(torch.equal(v, r[1]["state"][k])
                for k, v in r[0]["state"].items())
    log(f"  f32 step at {c['H']}x{c['W']} over two processes against one "
        f"on the card: loss {err['loss']:.2e} (limit {TRAIN_LOSS_TOL}), "
        f"gradients {err['grad']:.2e} (limit {TRAIN_GRAD_TOL}), running "
        f"statistics {err['stats']:.2e} (limit {TRAIN_STATS_TOL}); ranks "
        f"equal {equal}")
    if not (err["loss"] <= TRAIN_LOSS_TOL and err["grad"] <= TRAIN_GRAD_TOL
            and err["stats"] <= TRAIN_STATS_TOL and equal):
        raise RuntimeError("the two-process f32 step disagrees with one "
                           "process")
    return err


# ---- phase 19: --profile_dir ------------------------------------------------

def check_profile_dir(exp_dir: str) -> dict:
    """train_fnet at the protocol for PROFILE_STEPS steps with
    ``--profile_dir``: the Chrome trace of its window exists and names the
    sweep's operators and kernels."""
    trace_dir = Path(exp_dir) / "profile"
    out = run_fnet(dist_train_argv(exp_dir, "fnet_profile", PROFILE_STEPS,
                                   ["--profile_dir", str(trace_dir)]))
    path = out["profile_trace"]
    if not path or not os.path.exists(path):
        raise RuntimeError(f"no trace in {trace_dir}")
    # the profiler writes control characters into some names
    events = json.loads(open(path).read(), strict=False)["traceEvents"]
    names = {e.get("name", "") for e in events}
    want = ["magnet_tpu_torch::cost_volume_cw", "cost_volume_cw_kernel",
            "magnet_tpu_torch::sweep_grad_src", "sweep_grad_src_kernel",
            "magnet_tpu_torch::sweep_grad_ref", "sweep_grad_ref_kernel"]
    found = {w: any(w in n for n in names) for w in want}
    log(f"  trace {path} ({os.path.getsize(path) / 1e6:.1f} MB, "
        f"{len(names)} names): {found}")
    if not all(found.values()):
        raise RuntimeError("the trace does not name the sweep's kernels")
    return dict(path=path, mb=os.path.getsize(path) / 1e6, found=found)


# ---- phase 20: serving export ----------------------------------------------

# per MaGNet frame, the operators of each program at the ScanNet eval shape:
# phase 6's launches (the psm_conv operator serves the chains and both
# transition blocks)
FRAME_OPS = dict(conv3x3_bnact=4, head_chain=3, cost_volume_cw=ITERS,
                 gnet_update=ITERS, upsample_mask=1,
                 psm_conv=sum(FNET_LAUNCHES[k] for k in (
                     "fused_residual_stage", "downsample_block",
                     "expand_block")), spp_tail=1)
ENCODE_OPS = dict(conv3x3_bnact=4, head_chain=1,
                  psm_conv=FRAME_OPS["psm_conv"], spp_tail=1)
FUSE_OPS = dict(head_chain=2, cost_volume_cw=ITERS, gnet_update=ITERS,
                upsample_mask=1)


def check_export(model, inputs16, inputs32) -> dict:
    """``export_monolithic``, ``export_encode`` and ``export_fuse`` of phase
    6's model at the ScanNet eval shape in bf16: each saved to bytes,
    loaded and run on the card. Each graph holds each operator as often as
    phase 6 launches it per frame; the loaded monolithic program launches
    them so; its output and encode + fuse's match the eager forward bit for
    bit, or else at phase 7's bf16 limits; ms per frame of the loaded
    program against eager."""
    state = serve_export.f32_state(model)
    with torch.inference_mode():
        eager = model(*inputs16)
    res, programs = {}, {}
    for name, make, want in (
            ("monolithic", lambda: serve_export.export_monolithic(
                model, H, W, VIEWS, n_iters=ITERS,
                compute_dtype=torch.bfloat16), FRAME_OPS),
            ("encode", lambda: serve_export.export_encode(
                model, H, W, batch=VIEWS + 1,
                compute_dtype=torch.bfloat16), ENCODE_OPS),
            ("fuse", lambda: serve_export.export_fuse(
                model, H, W, VIEWS, n_iters=ITERS,
                compute_dtype=torch.bfloat16), FUSE_OPS)):
        t = time.perf_counter()
        blob = make()
        t_export = time.perf_counter() - t
        t = time.perf_counter()
        program = serve_export.load_exported(blob)
        t_load = time.perf_counter() - t
        counts = serve_export.op_counts(program)
        log(f"  {name}: {len(blob) / 1e6:.2f} MB, exported in "
            f"{t_export:.1f} s, loaded in {t_load:.1f} s; operators "
            f"{counts} (expected {want})")
        if counts != want:
            raise RuntimeError(f"the {name} program does not hold the "
                               "kernels as predicted")
        programs[name] = program
        res[name] = dict(mb=len(blob) / 1e6, export_s=t_export,
                         load_s=t_load, ops=counts)
    mono = programs["monolithic"]
    reset_counts()
    with torch.inference_mode():
        out = mono(state, *inputs32)
        torch.cuda.synchronize()
    launched = {k: v for k, v in read_counts().items() if v}
    want = dict(FNET_LAUNCHES, conv3x3_bnact=4, head_chain=3,
                cost_volume_cw=ITERS, gnet_update=ITERS, upsample_mask=1)
    log(f"  the loaded program launched {launched}")
    if launched != want:
        raise RuntimeError("the loaded program did not launch the kernels "
                           "as predicted")
    ref_img, src_imgs, *geometry = inputs32
    with torch.inference_mode():
        gauss, feat_d, feat_m = programs["encode"](state, torch.cat(
            [ref_img, src_imgs.reshape(VIEWS, H, W, 3)]))
        split = programs["fuse"](
            state, gauss[:1], feat_d[:1].contiguous(), feat_m[:1],
            gauss[1:][None], feat_m[1:][None], *geometry)
    for what, got in (("monolithic", out), ("encode + fuse", split)):
        exact = torch.equal(got, eager[-1])
        log(f"  {what} against the eager bf16 forward: equal bit for bit "
            f"{exact}")
        if not exact:
            res[what + "_err"] = compare_bf16_maps(
                [got.float().cpu()], [eager[-1].float().cpu()],
                f"exported {what}")
        res[what + "_exact"] = exact
    ev_prog, host_prog = frame_ms(lambda: mono(state, *inputs32))
    ev_eager, host_eager = frame_ms(lambda: model(*inputs16))
    log(f"  ms per frame: the loaded program {ev_prog:.3f} by events "
        f"({host_prog:.3f} host), eager {ev_eager:.3f} ({host_eager:.3f})")
    res.update(program_ms=ev_prog, program_host_ms=host_prog,
               eager_ms=ev_eager, eager_host_ms=host_eager)
    return res


# ---- phase 21: one stream per card ------------------------------------------

def check_multistream(model, inputs16) -> dict:
    """``make_multistream_forward`` over every card (S of them), one window
    a stream (the sample, then copies with moved translations), against
    the single-stream forward of each: bit for bit; ms per frame."""
    s = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(s)]
    windows = []
    for i in range(s):
        w = [a.clone() for a in inputs16]
        w[3] = w[3] * (1.0 + 0.5 * i)
        windows.append(w)
    batch = {k: torch.cat([w[j] for w in windows])
             for j, k in enumerate(streams.INPUTS)}
    forward = streams.make_multistream_forward(model, devices, ITERS,
                                               torch.bfloat16)
    with torch.inference_mode():
        out = forward(batch)
        singles = [model(*w)[-1] for w in windows]
    exact = all(torch.equal(out[i:i + 1], singles[i]) for i in range(s))
    ev, host = frame_ms(lambda: forward(batch))
    log(f"  {s} stream(s) on {s} card(s): equal to the single-stream "
        f"forwards bit for bit {exact}; {ev:.3f} ms per call by events "
        f"({ev / s:.3f} ms per frame), {host:.3f} ms host")
    if not exact:
        raise RuntimeError("the multi-stream forward disagrees with the "
                           "single-stream one")
    return dict(streams=s, exact=exact, call_ms=ev, frame_ms=ev / s,
                host_ms=host)


# ---- phase 22: view-sharded single-stream inference ------------------------

def check_view_sharded(model, inputs16, inputs32, exp_dir: str) -> dict:
    """``core/sharding_inference.py`` at the ScanNet eval shape from
    ``main_path_model``'s weights, in bf16 and in f32 (the same model with
    its convs cast back to f32): (a) W = 1 over NCCL in this process, its
    map equal to the monolithic forward's bit for bit; (b) W = 2 over gloo,
    both ranks on this card (``dryrun.view_sharded_worker``): the ranks'
    maps equal bit for bit, the f32 map within phase 7's gate of the
    monolithic forward, the bf16 one within STREAM_TOL of its largest
    |map| (each rank encodes 1 + V / 2 = 3 frames, which may take other
    plans than 5, as phase 14 found); ms a frame by CUDA events on each
    rank, beside the ms of one all-reduce of the cost volume."""
    model32 = cast_for_inference(copy.deepcopy(model), torch.float32)
    cases = {"bfloat16": (model, inputs16), "float32": (model32, inputs32)}
    with torch.inference_mode():
        mono = {k: m(*x)[-1] for k, (m, x) in cases.items()}
        mono_ms = cuda_ms(lambda: model(*inputs16)[-1], iters=SHARD_FRAMES)
    w1 = {}
    with environ(**nccl_group_of_one()), distributed.session("cuda"):
        if torch.distributed.get_backend() != "nccl":
            raise RuntimeError("the group is not NCCL's")
        mesh = view_mesh(1)
        for k, (m, x) in cases.items():
            run = shard_magnet_inference(m, mesh, ITERS)
            w1[k] = dict(exact=torch.equal(run(*x), mono[k]))
            if k == "bfloat16":
                w1[k]["frame_ms"] = cuda_ms(lambda: run(*x),
                                            iters=SHARD_FRAMES)
    if torch.distributed.is_initialized():
        raise RuntimeError("the W = 1 run left its process group")
    log(f"  W = 1 over NCCL: equal to the monolithic forward bit for bit: "
        f"bf16 {w1['bfloat16']['exact']}, f32 {w1['float32']['exact']}; "
        f"{w1['bfloat16']['frame_ms']:.3f} ms a frame by events (monolithic "
        f"{mono_ms:.3f})")
    if not all(v["exact"] for v in w1.values()):
        raise RuntimeError("the W = 1 view-sharded forward is not the "
                           "monolithic one")

    # the flags of ``magnet_args`` (the parser's defaults are the ScanNet
    # eval configuration), from which each rank builds its model
    argv = ["--exp_name", "chip_smoke_magnet", "--exp_dir", exp_dir,
            "--DNET_ckpt", "", "--FNET_ckpt", "", "--MAGNET_ckpt", "",
            "--dataset_name", "synthetic", "--dataset_path", "none",
            "--compute_dtype", "bfloat16", "--device", "cuda"]
    case = Path(exp_dir) / "view_sharded_case.pt"
    names = ("ref_img", "src_imgs", "R", "t", "is_valid", "intM", "rays2d")
    torch.save(dict(
        argv=argv, state={k: v.cpu() for k, v in
                               model.state_dict().items()},
        dtypes=[torch.float32, torch.bfloat16], device="cuda",
        inputs={k: v.float().cpu().numpy() for k, v in zip(names, inputs32)},
        n_iters=ITERS, meshes=[2], frames=SHARD_FRAMES), case)
    out = str(Path(exp_dir) / "view_sharded_rank{rank}.pt")
    t = time.perf_counter()
    distributed.spawn(dryrun.view_sharded_worker, 2, (str(case), out),
                      backend="gloo")
    spawn_s = time.perf_counter() - t
    ranks = [torch.load(out.format(rank=r), weights_only=False)
             for r in range(2)]
    res = dict(w1=w1, monolithic_ms=mono_ms, spawn_s=spawn_s)
    for k in cases:
        r0, r1 = ranks[0][k, 2], ranks[1][k, 2]
        same = torch.equal(r0["pred"], r1["pred"])
        ref = mono[k].float().cpu()
        if k == "float32":
            err = compare_f32_maps([r0["pred"]], [ref],
                                   "W = 2 f32 vs the monolithic forward")
            ok = True
        else:
            e = (r0["pred"] - ref).abs().max().item()
            lim = STREAM_TOL * ref.abs().max().item()
            err, ok = dict(err=e, limit=lim), e <= lim
        share = [ITERS * r[k, 2]["all_reduce_ms"] / r[k, 2]["frame_ms"]
                 for r in ranks]
        limit = "" if k == "float32" else f" (limit {err['limit']:.3e})"
        log(f"  W = 2 over gloo on one card, {k}: ranks equal bit for bit "
            f"{same}; max_abs_err against the monolithic forward "
            f"{err['err']:.3e}{limit}; ms a frame by events "
            f"{[round(r[k, 2]['frame_ms'], 3) for r in ranks]}, one "
            f"all-reduce {[round(r[k, 2]['all_reduce_ms'], 3) for r in ranks]}"
            f" ms, {ITERS} a frame: {[round(100 * x, 2) for x in share]} % "
            f"of the frame ({spawn_s:.1f} s with the processes' start)")
        if not (same and ok and torch.isfinite(r0["pred"]).all()):
            raise RuntimeError(f"the W = 2 view-sharded forward ({k}) "
                               "disagrees")
        res[k] = dict(err, ranks_equal=same,
                      frame_ms=[r[k, 2]["frame_ms"] for r in ranks],
                      all_reduce_ms=[r[k, 2]["all_reduce_ms"]
                                     for r in ranks], all_reduce_share=share)
    return res


# ---- phase 23: training dumps ----------------------------------------------

def check_dumps(model, inputs16, exp_dir: str) -> dict:
    """``utils/visualize.py``'s three dumps from maps the card computed at
    the ScanNet eval shape (the main-path model in bf16): MaGNet's 3
    iterations; the D-Net's (mu, var) as the last iteration's (mu,
    sigma^2); the F-Net's depth as the encode's coarse mu of the reference
    frame at 120x160. Each file exists and decodes as a 640x480 JPEG; host
    ms a dump, the copies from the card included."""
    from PIL import Image
    args = magnet_args("cuda", "bfloat16", 1, exp_dir)
    depth = SyntheticMultiView(args).get(0)["depth"][None]
    vis_dir = Path(exp_dir) / "vis"
    vis_dir.mkdir(exist_ok=True)
    dump_args = argparse.Namespace(dataset_name="scannet", min_depth=1e-3,
                                   max_depth=10.0, exp_vis_dir=str(vis_dir))
    with torch.inference_mode():
        preds = model(*inputs16)
        coarse = model.encode(inputs16[0])[0]
    dnet = torch.stack([preds[-1][..., 0], preds[-1][..., 1] ** 2], -1)
    img = inputs16[0]
    out = {}
    for name, call, n in (
            ("magnet", lambda i: visualize.visualize_magnet(
                dump_args, img, depth, preds, i), 2 + 3 * ITERS),
            ("dnet", lambda i: visualize.visualize_dnet(
                dump_args, img, depth, dnet, i), 5),
            ("fnet", lambda i: visualize.visualize_fnet(
                dump_args, img, depth, coarse[..., 0], i), 4)):
        torch.cuda.synchronize()
        ms = []
        for i in range(3):
            t = time.perf_counter()
            call(i)
            ms.append(1e3 * (time.perf_counter() - t))
            files = sorted(vis_dir.glob(f"{i:08d}_*.jpg"))
            for f in files:
                with Image.open(f) as im:
                    im.load()
                    if im.size != (W, H) or im.format != "JPEG":
                        raise RuntimeError(f"{f.name}: {im.format} "
                                           f"{im.size}")
                f.unlink()
            if len(files) != n:
                raise RuntimeError(f"visualize_{name} wrote {len(files)} "
                                   f"files, want {n}")
        out[name] = dict(files=n, host_ms=float(np.median(ms)))
        log(f"  visualize_{name}: {n} files of {W}x{H}, "
            f"{out[name]['host_ms']:.1f} ms a dump on the host (median of 3)")
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="", help="also write the results here")
    opts = p.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"[1] device: {smi}")

    t = time.perf_counter()
    so = build.build()
    build.library()
    log(f"[2] build: {so.name} in {time.perf_counter() - t:.2f} s")

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("[3] kernels against their plain versions (main-path shapes)")
    op_calls = {}    # each operator's first arguments, for phase 17
    with first_calls(op_calls):
        conv_rows = check_conv_kernel(dev)
        head_rows = check_head_kernel(dev)
        cv_rows = check_cost_volume_kernel(dev)
        gnet_rows = check_gnet_kernel(dev)
        up_rows = check_upsample_kernel(dev)
        upbwd_rows = check_upsample_bwd_kernel(dev)
        psm_rows = check_psm_kernels(dev)
        sweep_fwd_rows = check_sweep_forward(dev)
        sweep_rows = check_sweep_kernel(dev)
        sweep_ref_rows = check_sweep_ref_kernel(dev)
        mb_rows = check_mbchain_kernel(dev)
        dw_rows = check_dw_kernel(dev)
        rb_rows = check_resblock_kernel(dev)
    sites = (conv_rows + head_rows + cv_rows + sweep_fwd_rows + gnet_rows
             + up_rows + upbwd_rows + psm_rows + sweep_rows + sweep_ref_rows
             + mb_rows + dw_rows + rb_rows)
    for r in sites:
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        log(f"  {r['site']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library call {lib}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['gflop']:.3f} GFLOP")
    for r in cv_rows + sweep_fwd_rows:
        log(f"  {r['site']}: compulsory {r['compulsory_mb']:.1f} MB; the "
            f"plan stages {100 * r['staged_share']:.2f} % of the "
            f"{r['corners']} in-image corners in {r['staged_jobs']} windows "
            f"({r['global_jobs']} global jobs) and copies "
            f"{r['smem_mb']:.1f} MB into shared memory, where a plain "
            f"gather requests {r['gather_mb']:.1f} MB")
    for r in sweep_rows:
        log(f"  {r['site']}: f32 features {r['ms_f32']:.4f} ms; compulsory "
            f"{r['compulsory_mb']:.1f} MB, {r['corners']} in-image corners, "
            f"{r['walk_reductions']} reductions in the emulated walk "
            f"({r['corners'] / r['walk_reductions']:.2f}x fewer)")
    for r in sweep_ref_rows:
        log(f"  {r['site']}: f32 features {r['ms_f32']:.4f} ms; compulsory "
            f"{r['compulsory_mb']:.1f} MB; the plain version "
            f"{r['plain_launches']} launches a call")
    for r in gnet_rows:
        log(f"  {r['site']}: the whole update in bf16 cuDNN convs and "
            f"elementwise ops {r['chain_ms']:.4f} ms")
    for r in rb_rows:
        log(f"  {r['site']}: cuDNN's two convs alone "
            f"{r['cudnn_convs_ms']:.4f} ms; {r['count']} blocks: res_block "
            f"{r['count'] * r['ms']:.4f} ms, row 6's chain "
            f"{r['chain_ms']:.4f} ms")

    os.makedirs("exp", exist_ok=True)
    exp_dir = tempfile.mkdtemp(prefix="chip_smoke_", dir="exp")
    log(f"[4] D-Net path: {H}x{W} bf16, {DNET_FRAMES} synthetic frames")
    dnet_path = run_dnet_path(DNET_FRAMES, exp_dir)
    log("[5] f32 D-Net forward, card against CPU")
    fwd_err = check_f32_forward(exp_dir)
    log(f"[6] MaGNet main path: {H}x{W}, cost volume {HC}x{WC}, {VIEWS} "
        f"source views, {SAMPLES} candidates, {ITERS} iterations, bf16, "
        f"{MAGNET_FRAMES} synthetic samples")
    magnet_path = run_magnet_path(MAGNET_FRAMES, exp_dir)
    log("[7] f32 MaGNet forward, card against CPU; bf16 against that")
    magnet_err = check_f32_magnet(exp_dir)
    log(f"[8] F-Net training path: {H}x{W}, batch {TRAIN_B}, {VIEWS} source "
        f"views, {TRAIN_D} sweep planes, cost volume {HC}x{WC}, bf16, "
        f"{TRAIN_STEPS} steps and a validation pass")
    train_path = run_train_path(exp_dir)
    train_path.update(train_account(train_path.pop("args"),
                                    train_path.pop("state")))
    log("[9] f32 training step, card against CPU")
    train_err = check_train_step(exp_dir)
    log(f"[10] path A: the D-Net trunk's kernels (--mbconv_chain all "
        f"--dw_kernel), D-Net {H}x{W} bf16, {DNET_FRAMES} frames; MaGNet as "
        f"in phase 6, {MAGNET_FRAMES} samples")
    trunk_dnet = run_dnet_path(DNET_FRAMES, exp_dir, TRUNK_FLAGS,
                               TRUNK_LAUNCHES)
    trunk_magnet = run_magnet_path(
        MAGNET_FRAMES, exp_dir, magnet_args("cuda", "bfloat16", MAGNET_FRAMES,
                                            exp_dir, TRUNK_FLAGS),
        trunk=TRUNK_LAUNCHES, stages=True)
    trunk_err = check_trunk_f32(exp_dir)
    trunk_cmp = trunk_compare(exp_dir)
    log(f"[11] path B: MaGNet at the KITTI configuration with "
        f"--stream_blocks, {KITTI_H}x{KITTI_W}, cost volume "
        f"{KITTI_HC}x{KITTI_WC}, {KITTI_VIEWS} source views, {SAMPLES} "
        f"candidates, {ITERS} iterations, bf16, {KITTI_FRAMES} samples")
    kitti_path = run_magnet_path(
        KITTI_FRAMES, exp_dir, kitti_args("cuda", "bfloat16", KITTI_FRAMES,
                                          exp_dir),
        fnet=KITTI_FNET_LAUNCHES, stages=True)
    kitti_fnet = check_kitti_fnet(exp_dir)
    log(f"[12] D-Net training: train_dnet at {DNET_CROP[0]}x{DNET_CROP[1]}, "
        f"bf16, batch {DNET_TRAIN_B} where it fits, {DNET_TRAIN_STEPS} "
        f"steps and a validation pass")
    dnet_train = run_dnet_train_path(exp_dir)
    log(f"[13] MaGNet training: train_magnet at {H}x{W}, batch "
        f"{MAGNET_TRAIN_B}, {VIEWS} source views, {SAMPLES} candidates, "
        f"{ITERS} iterations, bf16, from phase 12's D-Net and phase 8's "
        f"F-Net, {MAGNET_TRAIN_STEPS} steps and a validation pass")
    margs = magnet_train_args(exp_dir, dnet_train["ckpt"], train_path["ckpt"])
    magnet_train = run_magnet_train_path(margs)
    magnet_train["step_check"] = check_magnet_train_step(margs)
    log(f"[14] streaming: test_magnet --cache_features at {H}x{W}, bf16, on "
        f"a {STREAM_FRAMES}-frame sliding window, against the monolithic "
        f"forward")
    stream = run_streaming_path(exp_dir)
    log(f"[15] the GroupNorm D-Net decoder (DenseDepth_GN): test_dnet at "
        f"{H}x{W}, bf16, {DNET_FRAMES} frames; f32 card vs CPU; bf16 vs f32; "
        f"MaGNet as in phase 6 on it; train_dnet {GN_TRAIN_STEPS} steps at "
        f"{DNET_CROP[0]}x{DNET_CROP[1]}")
    gn_dnet = run_dnet_path(DNET_FRAMES, exp_dir, GN_FLAGS,
                            decoder=GN_DECODER)
    gn_check = check_gn_dnet(exp_dir)
    gn_check["splits_ms"] = dnet_splits()
    gn_magnet = run_magnet_path(
        MAGNET_FRAMES, exp_dir, magnet_args("cuda", "bfloat16", MAGNET_FRAMES,
                                            exp_dir, GN_FLAGS),
        decoder={}, stages=True)
    gn_train = run_dnet_train_path(
        exp_dir, GN_TRAIN_STEPS, GN_FLAGS + [
            "--DNET_fix_encoder_weights", "None", "--exp_name",
            "chip_smoke_dnet_gn"], per_val=GN_DECODER)
    log(f"[16] on-disk datasets: ScanNet, 7-Scenes and KITTI trees at their "
        f"raw sizes, {ONDISK_BATCHES} test batches each through the port's "
        f"dispatch and the MaGNet forward; the KITTI training loader")
    ondisk = run_ondisk_path(exp_dir, dnet_train["step_event_ms"])
    log(f"  the GN stage-1 step at {DNET_CROP[0]}x{DNET_CROP[1]}: "
        f"{gn_train['step_event_ms']:.3f} ms (batch {gn_train['batch']})")
    log("[17] the kernels as PyTorch operators: opcheck of each at its "
        "first phase-3 site; phase 6's frame through the operators and "
        "past them")
    opcheck = check_operators(op_calls)
    del op_calls
    model, inputs16, inputs32 = main_path_model(exp_dir)
    op_cost = operator_cost(model, inputs16)
    op_cost["phase6_events_ms"] = magnet_path["events_ms"]
    log(f"[18] training across processes: train_fnet at the protocol, "
        f"{DIST_STEPS} steps, undistributed, W = 1 over NCCL, W = 2 over "
        f"gloo on this card; an f32 step over two processes; "
        f"dryrun_multichip(1) over NCCL")
    dist_train = check_distributed_training(exp_dir)
    log(f"[19] --profile_dir: train_fnet at the protocol, {PROFILE_STEPS} "
        f"steps")
    profile_dir = check_profile_dir(exp_dir)
    log(f"[20] serving export at {H}x{W}, {VIEWS} source views, bf16: "
        f"monolithic, encode and fuse, saved, loaded and run")
    export = check_export(model, inputs16, inputs32)
    log(f"[21] one stream per card: make_multistream_forward over "
        f"{torch.cuda.device_count()} card(s)")
    multistream = check_multistream(model, inputs16)
    log(f"[22] view-sharded inference at {H}x{W}, {VIEWS} source views: "
        f"W = 1 over NCCL, W = 2 over gloo on this card, bf16 and f32")
    view_sharded = check_view_sharded(model, inputs16, inputs32, exp_dir)
    log("[23] training dumps (utils/visualize.py) of maps the card computed")
    dumps = check_dumps(model, inputs16, exp_dir)
    del model

    runs = {"magnet": (magnet_path, MAGNET_FRAMES),
            "dnet_trunk": (trunk_dnet, DNET_FRAMES),
            "magnet_trunk": (trunk_magnet, MAGNET_FRAMES),
            "magnet_kitti": (kitti_path, KITTI_FRAMES)}

    def entry(name, source, replaces, rows, key, per_frame=1,
              path="magnet"):
        """One kernel of the line: its sites on a frame (a step on the
        training path) of its main path, summed (``per_frame`` launches of
        each site, ``count`` sites of a row)."""
        on = [r for r in rows if r["frame"] and r["path"] in (path, "both")]
        if path in runs:
            run, frames = runs[path]
            launches = run["launches"][key]
            per = {"launches_per_frame": launches / frames}
        else:
            launches = train_path["launches"][key]
            per = {"launches_per_step":
                   train_path["step_launches"][key] / TRAIN_STEPS}
        if launches < 1:
            raise RuntimeError(f"{name} was not launched on the main path")
        libs = [r["library_ms"] for r in on]

        def total(k):
            return per_frame * sum(r.get("count", 1) * r[k] for r in on)
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            path=path, launches=launches,
            max_abs_err=max(r["err_bf16"] for r in rows),
            max_abs_err_f32=max(r["err_f32"] for r in rows),
            ms=total("ms"), plain_ms=total("plain_ms"),
            bound_ms=total("bound_ms"),
            bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in on)
                      else "operations"),
            library_ms=None if None in libs else total("library_ms"),
            **per, **({"launches_dnet_path": dnet_path["launches"][key]}
                      if path == "magnet" else {}))

    csrc = "magnet_tpu_torch/kernels/csrc/"
    kernels = [
        entry("conv3x3_bnact (up2)", csrc + "conv3x3_bnact.cu",
              "magnet_tpu/kernels/convstream_pallas.py:213",
              [r for r in conv_rows if r["site"].startswith("up2")], "up2"),
        entry("conv3x3_bnact (up3)", csrc + "conv3x3_bnact.cu",
              "magnet_tpu/kernels/upstage_pallas.py:240",
              [r for r in conv_rows if r["site"].startswith("up3")], "up3"),
        entry("head_chain", csrc + "head_chain.cu",
              "magnet_tpu/kernels/headchain_pallas.py:121", head_rows,
              "head_chain"),
        entry("cost_volume_cw", csrc + "cost_volume_cw.cu",
              "magnet_tpu/kernels/costvolume_pallas.py:734",
              cv_rows + sweep_fwd_rows, "cost_volume_cw", ITERS),
        entry("gnet_update", csrc + "gnet_update.cu",
              "magnet_tpu/kernels/gnet_pallas.py:124", gnet_rows,
              "gnet_update", ITERS),
        entry("upsample_mask", csrc + "upsample_mask.cu",
              "magnet_tpu/kernels/upsample_pallas.py:79", up_rows,
              "upsample_mask"),
    ] + [
        entry(name, csrc + source, "magnet_tpu/kernels/" + replaces,
              [r for r in psm_rows if r["kernel"] == name], name)
        for name, source, replaces in (
            ("fused_residual_stage", "psm_conv.cu", "psmstage_pallas.py:236"),
            ("downsample_block", "psm_conv.cu", "psmtrans_pallas.py:137"),
            ("expand_block", "psm_conv.cu", "psmtrans2_pallas.py:220"),
            ("spp_tail", "spp_tail.cu", "spptail_pallas.py:111"))
    ] + [
        entry("sweep_grad_src", csrc + "sweep_grad_src.cu",
              "magnet_tpu/kernels/sweepbwd_pallas.py:166", sweep_rows,
              "sweep_grad_src", path="fnet_train"),
    ]
    # the GN D-Net runs rows 3 and 11 alone (its stages are plain PyTorch):
    # their launches on its path (phase 15) beside the BN D-Net's
    for row, key in ((kernels[2], "head_chain"),
                     (kernels[5], "upsample_mask")):
        row["launches_dnet_gn_path"] = gn_dnet["launches"][key]
        row["launches_magnet_gn_path"] = gn_magnet["launches"][key]
    # row 5's library call is cuDNN's layer-0 conv alone; the whole update
    # in cuDNN beside it
    kernels[4]["cudnn_chain_ms"] = ITERS * sum(
        r["chain_ms"] for r in gnet_rows if r["frame"])
    # row 4 also runs on the training path, as the sweep forward: its
    # sites there, with the launches of phase 8
    kernels[3]["fnet_train"] = entry(
        "cost_volume_cw (sweep forward)", csrc + "cost_volume_cw.cu",
        "magnet_tpu/kernels/costvolume_pallas.py:734", sweep_fwd_rows,
        "cost_volume_cw", path="fnet_train")
    # rows 12 and 13 on path A per MaGNet frame (the D-Net at N = 5), with
    # the D-Net alone (N = 1) beside; row 14 on path B per KITTI frame
    for name, source, replaces, rows in (
            ("mbconv_chain", "mbconv_chain.cu", "mbchain_pallas.py:164",
             mb_rows),
            ("dw_conv", "dw_conv.cu", "dwconv_pallas.py:83", dw_rows)):
        kernels.append(entry(name, csrc + source,
                             "magnet_tpu/kernels/" + replaces, rows, name,
                             path="magnet_trunk"))
        kernels[-1]["dnet_trunk"] = entry(
            name, csrc + source, "magnet_tpu/kernels/" + replaces, rows, name,
            path="dnet_trunk")
    kernels.append(entry("res_block", csrc + "res_block.cu",
                         "magnet_tpu/kernels/resstream_pallas.py:173",
                         rb_rows, "res_block", path="magnet_kitti"))
    # the port's own kernel: the convex upsampling's backward, per MaGNet
    # training step (phase 13; the D-Net's step of phase 12 beside)
    for path, run in (("magnet_train", magnet_train),
                      ("dnet_train", dnet_train)):
        r = next(r for r in upbwd_rows if r["path"] == path)
        row = dict(
            name="upsample_mask_bwd", route="cuda",
            source=csrc + "upsample_mask.cu",
            replaces="magnet_tpu/ops/upsample.py:31",
            note="port-only: the backward of convex upsampling, which the "
                 "JAX package takes by XLA autodiff (no TPU kernel)",
            path=path, launches=run["launches"]["upsample_mask_bwd"],
            launches_per_step=run["per_step"]["upsample_mask_bwd"],
            max_abs_err=max(x["err_bf16"] for x in upbwd_rows),
            max_abs_err_f32=max(x["err_f32"] for x in upbwd_rows),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None)
        if row["launches"] < 1:
            raise RuntimeError(f"upsample_mask_bwd was not launched on the "
                               f"{path} path")
        if path == "magnet_train":
            kernels.append(row)
        else:
            kernels[-1]["dnet_train"] = row
    # the port's own kernel: the sweep's reference gradient, per F-Net
    # training step (phase 8's launches)
    kernels.append(dict(
        entry("sweep_grad_ref", csrc + "cost_volume_cw.cu",
              "magnet_tpu/ops/costvolume.py:588",
              sweep_ref_rows, "sweep_grad_ref", path="fnet_train"),
        note="port-only: the reference features' gradient of the sweep, "
             "which the JAX package takes by XLA (no TPU kernel)",
        plain_launches=next(r["plain_launches"] for r in sweep_ref_rows
                            if r["frame"])))
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(dict(device=smi, kernels=kernels, sites=sites,
                           dnet_path=dnet_path, f32_dnet_err=fwd_err,
                           magnet_path=magnet_path, f32_magnet=magnet_err,
                           train_path=train_path, f32_train_step=train_err,
                           trunk_dnet_path=trunk_dnet,
                           trunk_magnet_path=trunk_magnet,
                           trunk_f32=trunk_err, trunk_compare=trunk_cmp,
                           kitti_path=kitti_path, kitti_fnet=kitti_fnet,
                           dnet_train=dnet_train, magnet_train=magnet_train,
                           streaming=stream, gn_dnet_path=gn_dnet,
                           gn_dnet_check=gn_check, gn_magnet_path=gn_magnet,
                           gn_dnet_train=gn_train, ondisk=ondisk,
                           opcheck=opcheck, operator_cost=op_cost,
                           distributed_training=dist_train,
                           profile_dir=profile_dir, export=export,
                           multistream=multistream,
                           view_sharded=view_sharded, dumps=dumps),
                      f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
