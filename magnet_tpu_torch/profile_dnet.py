"""Where the D-Net forward spends its time on the GPU.

    python -m magnet_tpu_torch.profile_dnet [--dtype bfloat16] [--out p.json]

Two readings of one model at 480x640 (seeded random weights, batch 1):
  * per stage, with CUDA events around each stage run alone on the inputs
    the whole forward gives it (trunk, conv2 + up1, up2, up3, the two
    heads, convex upsampling), and around the whole forward;
  * per kernel, with ``torch.profiler`` over five forwards: device
    time by kernel name, kernel launches per frame, and the device's idle
    share of the profiled wall time.
``trunk_tail_sites`` and ``random_chain`` give the trunk's six MBConv stage
tails and seeded chains of their blocks, where row 12 (``mbconv_chain``) is
measured (``chip_smoke.py`` phase 3, ``profile_psm_conv``). Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch

from magnet_tpu_torch.models.build import cast_for_inference, init_weights_
from magnet_tpu_torch.models.dnet import DNet, activation_gaussian
from magnet_tpu_torch.nn.densedepth import UpSampleBN, run_head
from magnet_tpu_torch.nn.efficientnet import (InvertedResidual, b5_stage_config,
                                              chain_stages)
from magnet_tpu_torch.nn.layers import conv2d, nchw, nhwc
from magnet_tpu_torch.ops.upsample import upsample_via_mask

# the port's kernels, by a part of their names that each of a kernel's
# versions (the f32 ``*_kernel`` and the bf16 ``*_hopper``) holds
OURS = ("conv3x3_bnact", "head_chain", "cost_volume_cw", "gnet_update",
        "upsample_mask", "psm_conv", "spp_tail", "sweep_grad_src", "dw_conv",
        "mb_expand", "mb_project", "res_block")
SHAPE = (1, 480, 640, 3)
FRAMES = 5


def trunk_tail_sites(h: int = 480, w: int = 640) -> list:
    """(stage, blocks, map, C, M, K) of the six stage tails that run as MBConv
    chains at h x w (blocks 1..n-1 of stages 1-6)."""
    sites, hw = [], (h // 2, w // 2)            # after the stride-2 stem
    for si, stage in enumerate(b5_stage_config()):
        s = stage[0]["stride"]
        hw = (-(-hw[0] // s), -(-hw[1] // s))
        if si in chain_stages("all"):
            c = stage[1]
            sites.append((si, len(stage) - 1, hw, c["in_ch"],
                          c["in_ch"] * c["expand"], c["kernel"]))
    return sites


def random_chain(nb: int, C: int, M: int, K: int, seed: int) -> list:
    """nb stride-1 InvertedResidual blocks with seeded random weights and
    BatchNorm statistics (``init_weights_``)."""
    cfg = dict(btype="ir", kernel=K, stride=1, expand=M // C, in_ch=C,
               out_ch=C)
    return [init_weights_(InvertedResidual(cfg), seed + i).eval()
            for i in range(nb)]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of fn() over iters back-to-back calls, from CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn(): ``iters`` calls captured into one CUDA
    graph, the replay timed with CUDA events. The host's time to enqueue
    (Python, the wrapper's checks) is outside the reading, which matters for
    kernels shorter than a wrapper call; the calls run back to back, so
    inputs that fit the L2 cache stay in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stage_times(model: DNet, x: torch.Tensor) -> dict:
    dd = model.d_net
    dec = dd.decoder
    xc = nchw(x)
    f4, f5, f6, f8, f11 = dd.encoder(xc)
    s8, s6, s5 = nhwc(f8), nhwc(f6), nhwc(f5)
    y1 = dec.up1(nhwc(conv2d(f11, dec.conv2)), s8)
    y2 = dec.up2(y1, s6)
    y3 = dec.up3(y2, s5)
    depth = run_head(dec.depth_head, y3)
    mask = run_head(dec.mask_head, y3)
    k = dd.downsample_ratio
    # the BN decoder's up2 and up3 run the conv kernel; the GN decoder's
    # stages are plain PyTorch (WSConv in cuDNN, GroupNorm in f32)
    how = ("conv kernel x2" if isinstance(dec.up2, UpSampleBN)
           else "plain GN")
    stages = {
        "trunk (EfficientNet-B5)": lambda: dd.encoder(xc),
        "conv2 + up1 (cuDNN)": lambda: dec.up1(nhwc(conv2d(f11, dec.conv2)),
                                               s8),
        f"up2 ({how})": lambda: dec.up2(y1, s6),
        f"up3 ({how})": lambda: dec.up3(y2, s5),
        "depth head (head kernel)": lambda: run_head(dec.depth_head, y3),
        "mask head (head kernel)": lambda: run_head(dec.mask_head, y3),
        "convex upsampling + activation": lambda: activation_gaussian(
            upsample_via_mask(depth, mask, k)),
        "whole forward": lambda: model(x),
    }
    return {name: cuda_ms(fn) for name, fn in stages.items()}


def kernel_profile(forward, frames: int) -> dict:
    """``torch.profiler`` over ``frames`` calls of ``forward()``: device time
    by kernel name, launches per frame, the device's idle share."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        forward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(frames):
            forward()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    by_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rec = by_name[e.name]
            rec[0] += e.time_range.elapsed_us()
            rec[1] += 1
    if not by_name:
        raise RuntimeError("the profiler recorded no device activity")
    busy_us = sum(v[0] for v in by_name.values())
    launches = sum(v[1] for v in by_name.values())
    ours = sum(v[0] for n, v in by_name.items()
               if any(o in n for o in OURS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return dict(
        wall_ms_per_frame=wall_us / frames / 1e3,
        device_busy_ms_per_frame=busy_us / frames / 1e3,
        device_idle_share=1.0 - busy_us / wall_us,
        kernel_launches_per_frame=launches / frames,
        ported_kernels_ms_per_frame=ours / frames / 1e3,
        ported_kernels=[dict(name=o, ms_per_frame=sum(
            v[0] for n, v in by_name.items() if o in n) / frames / 1e3,
            launches_per_frame=sum(
                v[1] for n, v in by_name.items() if o in n) / frames)
            for o in OURS],
        top_kernels=[dict(name=n[:120], ms_per_frame=v[0] / frames / 1e3,
                          launches_per_frame=v[1] / frames)
                     for n, v in top])


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_dnet needs a CUDA device")
    dtype = getattr(torch, a.dtype)
    model = init_weights_(DNet(), 0).eval().cuda()
    cast_for_inference(model, dtype)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(*SHAPE, generator=g).to("cuda", dtype)
    with torch.inference_mode():
        res = dict(device=torch.cuda.get_device_name(0), shape=list(SHAPE),
                   dtype=a.dtype, stages_ms=stage_times(model, x),
                   profile=kernel_profile(lambda: model(x), FRAMES))
    for name, ms in res["stages_ms"].items():
        print(f"{name:34s} {ms:9.4f} ms")
    prof = res["profile"]
    for k in ("wall_ms_per_frame", "device_busy_ms_per_frame",
              "device_idle_share", "kernel_launches_per_frame",
              "ported_kernels_ms_per_frame"):
        print(f"{k:34s} {prof[k]:9.4f}")
    for t in prof["top_kernels"]:
        print(f"  {t['ms_per_frame']:8.4f} ms  x{t['launches_per_frame']:5.1f}"
              f"  {t['name']}")
    if a.out:
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
