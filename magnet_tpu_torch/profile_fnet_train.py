"""Where an F-Net training step spends its time on the GPU.

``step_account`` runs the training step of ``train.steps`` as the entry
point runs it, with ``utils.profiling.StageTimes`` active: CUDA events around
each of the step's spans (the F-Net forward, the sweep forward and softmax,
soft-argmax and L1, the whole backward with its two sweep parts, clip and
AdamW), and the whole step by the host clock; the F-Net backward is the
backward less its sweep parts, the host gap the host-clock step less the
spans' sum. ``protocol_args`` are the flags of
``train_scripts/fnet/scannet.txt`` (480x640, batch 2, 4 source views, 80
sweep planes, cost volume 120x160, bf16 compute with f32 master weights) on
the synthetic dataset. ``chip_smoke.py`` phase 8 runs both at the protocol,
with ``profile_dnet.kernel_profile`` over two steps. Needs a CUDA device.
"""

from __future__ import annotations

import time

import torch

from magnet_tpu_torch.core import config
from magnet_tpu_torch.utils.profiling import StageTimes

FLAGS = "train_scripts/fnet/scannet.txt"
SWEEP_BACKWARD = ("sweep backward: grad_src (row-10 kernel)",
                  "sweep backward: grad_ref (plain re-gather)")


def step_account(step_fn, state, batch, iters: int = 3) -> dict:
    """ms per span of ``iters`` steps of ``step_fn`` on ``state`` (the first
    a warm-up, left out), and the step by the host clock."""
    host = []
    with StageTimes() as times:
        for _ in range(iters):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step_fn(state, batch)
            torch.cuda.synchronize()
            host.append(1e3 * (time.perf_counter() - t))
    ms = times.ms(skip=1)
    top = [n for n in ms if n != "backward" and n not in SWEEP_BACKWARD]
    ms["F-Net backward (backward less the sweep backward)"] = (
        ms["backward"] - sum(ms[n] for n in SWEEP_BACKWARD))
    ms["step, host clock"] = sum(host[1:]) / (len(host) - 1)
    ms["host gap (host clock less the spans)"] = (
        ms["step, host clock"] - ms["backward"] - sum(ms[n] for n in top))
    return ms


def protocol_args(extra=()):
    """The flags of the protocol on the synthetic dataset."""
    return config.parse_args(config.build_train_fnet_parser(), [
        "@" + FLAGS, "--dataset_name", "synthetic", "--dataset_path",
        "none", "--exp_dir", "exp", "--device", "cuda"] + list(extra))
