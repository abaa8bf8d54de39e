"""Step timing of the training loop.

The port's copy of ``magnet_tpu/utils/profiling.py::StepTimer``: a streaming
steps-per-second estimate on the host clock, the first steps left out. And
``stage``: a named span of the training step (the F-Net forward, the sweep
forward, the loss, the backward and its two sweep parts, the update). It
does nothing unless a ``StageTimes`` is active, which then records CUDA
events around every span it sees; ``profile_fnet_train.step_account`` reads
them off the step as the entry point runs it.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


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
