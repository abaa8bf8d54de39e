"""Profiling and step timing of the training loop.

The port's counterpart of ``magnet_tpu/utils/profiling.py``, on
``torch.profiler`` (CPU and CUDA activity) where the JAX package has
``jax.profiler``:

* ``trace(logdir)``: a Chrome trace of the enclosed block in ``logdir``;
* ``annotate(name)``: a named range in such a trace
  (``torch.profiler.record_function``);
* ``ProfileWindow(logdir, start, num)``: the trace of steps [start,
  start + num) of a training loop (``--profile_dir``), ticked once a step;
  nothing without a logdir;
* ``StepTimer``: a streaming steps-per-second estimate on the host clock,
  the first steps left out.

Under a process group only rank 0 traces. And ``stage``: a named span of
the training step (the F-Net forward, the sweep forward, the loss, the
backward and its two sweep parts, the gradient all-reduce, the update). It
does nothing unless a ``StageTimes`` is active, which then records CUDA
events around every span it sees; ``profile_fnet_train.step_account`` reads
them off the step as the entry point runs it.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

from magnet_tpu_torch.core.distributed import rank_world

TRACE_FILE = "trace_rank0_{}.json"


def _profiler() -> "torch.profiler.profile":
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _write(prof, logdir: str, name: str) -> str:
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, TRACE_FILE.format(name))
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str):
    """A Chrome trace of the enclosed block, written into ``logdir`` (rank
    0 only)."""
    if rank_world()[0] != 0:
        yield
        return
    prof = _profiler()
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        _write(prof, logdir, "block")


def annotate(name: str):
    """A named range that shows in the profiler's timeline."""
    return torch.profiler.record_function(name)


class ProfileWindow:
    """The trace of steps [start, start + num) when ``logdir`` is set, on
    rank 0; a no-op otherwise. Call ``tick()`` once a step, before it, and
    ``close()`` after the last (it stops a window the steps did not
    finish). The trace is ``logdir/trace_rank0_steps<start>-<end>.json``."""

    def __init__(self, logdir: str = "", start: int = 10, num: int = 3):
        self.logdir = logdir if rank_world()[0] == 0 else ""
        self.start = start
        self.stop = start + num
        self.count = 0
        self.prof = None
        self.path = ""

    def tick(self) -> None:
        if not self.logdir:
            return
        if self.count == self.start:
            self.prof = _profiler()
            self.prof.start()
        elif self.count == self.stop:
            self.close()
        self.count += 1

    def close(self) -> None:
        if self.prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        self.path = _write(self.prof, self.logdir,
                           f"steps{self.start}-{self.count}")
        self.prof = None
        print(f"profile trace written to {self.path}", flush=True)


class StepTimer:
    """Streaming steps/s with the first ``warmup`` steps left out."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.t0 = None

    def tick(self) -> float:
        """Call once per step; returns the steps/s so far (0 during the
        warmup)."""
        self.count += 1
        if self.count == self.warmup:
            self.t0 = time.perf_counter()
        if self.t0 is None or self.count <= self.warmup:
            return 0.0
        return (self.count - self.warmup) / (time.perf_counter() - self.t0)


class StageTimes:
    """While active (``with StageTimes() as st``), the CUDA events of every
    ``stage`` span on the current device; ``ms()`` their mean per name."""

    active: Optional["StageTimes"] = None

    def __init__(self):
        self.events = defaultdict(list)

    def __enter__(self) -> "StageTimes":
        StageTimes.active = self
        return self

    def __exit__(self, *exc) -> None:
        StageTimes.active = None

    def ms(self, skip: int = 0) -> Dict[str, float]:
        """Mean ms per span of each name, the first ``skip`` of each left
        out."""
        torch.cuda.synchronize()
        out = {}
        for name, evs in self.events.items():
            kept = evs[skip:] or evs
            out[name] = sum(s.elapsed_time(e) for s, e in kept) / len(kept)
        return out


@contextlib.contextmanager
def stage(name: str):
    """A named span of the training step; timed only under ``StageTimes``."""
    times = StageTimes.active
    if times is None:
        yield
        return
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    yield
    end.record()
    times.events[name].append((start, end))
