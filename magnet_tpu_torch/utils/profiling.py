"""Profiling, step timing and the program's spans.

The port's counterpart of ``magnet_tpu/utils/profiling.py``, on
``torch.profiler`` (CPU and CUDA activity) where the JAX package has
``jax.profiler``:

* ``ProfileWindow(logdir, start, num)``: the trace of steps [start,
  start + num) of a training loop (``--profile_dir``), ticked once a step;
  nothing without a logdir; under a process group only rank 0 traces;
* ``StepTimer``: a streaming steps-per-second estimate on the host clock,
  the first steps left out;
* ``stage(name)``: a named span of the program, at a layer boundary of the
  inference forward (``models/magnet.py``, ``nn/densedepth.py``) or of a
  training step (``train/steps.py``, ``ops/costvolume.py``). While a
  profiler runs, each span is a range ``magnet.<name>`` in its trace, on the
  clock of the launches and kernels. While a ``StageTimes`` is active it
  records, on any thread, each span's CUDA events (on a CUDA device, outside
  a graph capture), its host wall time, the process's CPU time (every
  thread's: autograd's device thread works while the caller waits in
  ``backward``) and the span that encloses it on its thread. With neither,
  a span costs a global read and one call.

``profile_fnet_train.step_account`` and the benchmark (``perfbench/``) read
the spans through ``StageTimes``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

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


RANGE_PREFIX = "magnet."


class HostSpan(NamedTuple):
    """A span's host times, in seconds, and the name of the span that
    enclosed it on its thread (None at the top)."""
    wall_s: float
    cpu_s: float
    parent: Optional[str]


class StageTimes:
    """While active (``with StageTimes() as st``), every ``stage`` span on
    any thread: ``events``, name -> (start, end) CUDA event pairs on the
    current stream; ``host``, name -> ``HostSpan``s. ``ms()``: the events'
    mean per name."""

    active: Optional["StageTimes"] = None

    def __init__(self):
        self.events = defaultdict(list)
        self.host = defaultdict(list)
        self.cuda = torch.cuda.is_available()
        self._open = threading.local()

    def __enter__(self) -> "StageTimes":
        StageTimes.active = self
        return self

    def __exit__(self, *exc) -> None:
        StageTimes.active = None

    def stack(self) -> List[str]:
        """The names of the spans open on the calling thread, outermost
        first."""
        names = getattr(self._open, "names", None)
        if names is None:
            names = self._open.names = []
        return names

    def ms(self, skip: int = 0) -> Dict[str, float]:
        """Mean ms per span of each name, the first ``skip`` of each left
        out."""
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for name, evs in self.events.items():
            kept = evs[skip:] or evs
            out[name] = sum(s.elapsed_time(e) for s, e in kept) / len(kept)
        return out


class _Span:
    """One ``stage`` span while a profiler runs or a ``StageTimes`` is
    active."""

    __slots__ = ("name", "times", "range", "parent", "start", "wall", "cpu")

    def __init__(self, name: str, times: Optional[StageTimes]):
        self.name, self.times = name, times

    def __enter__(self) -> None:
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(
                RANGE_PREFIX + self.name)
            self.range.__enter__()
        times = self.times
        if times is None:
            return
        stack = times.stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.start = None
        if times.cuda and not torch.cuda.is_current_stream_capturing():
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.wall, self.cpu = time.perf_counter(), time.process_time()

    def __exit__(self, *exc) -> None:
        times = self.times
        if times is not None:
            wall = time.perf_counter() - self.wall
            cpu = time.process_time() - self.cpu
            if self.start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                times.events[self.name].append((self.start, end))
            times.host[self.name].append(HostSpan(wall, cpu, self.parent))
            times.stack().pop()
        if self.range is not None:
            self.range.__exit__(*exc)


_OFF = contextlib.nullcontext()


def stage(name: str):
    """A named span of the program (the module's docstring); with no
    profiler running and no ``StageTimes`` active, a shared no-op."""
    times = StageTimes.active
    if times is None and not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, times)
