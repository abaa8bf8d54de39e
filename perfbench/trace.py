"""The device trace of a traced run's profiled sub-window.

``profiled(driver, n_units)`` runs ``n_units`` more units of the cell's
traffic under ``torch.profiler`` twice: with the device's activity alone,
then with the host's too and every kernel operator of the program
(``program.operators``) wrapped so that each call sits in a range
``perfbench::op#<i>`` and its bytes and operations are counted from its
arguments (``counts``). Each Chrome trace is written to a temporary file,
read back and deleted. ``Trace`` then holds:

* ``window_s``: the first sub-window's length on the host clock, from a
  synchronised device to the device finished;
* ``busy_s``: the union of the device's activity (kernels, copies, fills)
  in it, so overlapping kernels count once;
* ``device_ops``: device time by kernel name, the largest first;
* ``idle_gaps``: from the second sub-window, the time the device was idle
  inside the range ``perfbench::window``, by what the host was doing then
  (the innermost host range covering the gap's middle on the thread that
  drives the program);
* ``op_calls``: per operator call, its counted work and the device time of
  the kernels it launched (matched by the runtime launch's correlation id
  and the call's range).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from perfbench import counts, program

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "perfbench::window"
OP_PREFIX = "perfbench::op#"


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    device_ops: List = field(default_factory=list)
    idle_gaps: List = field(default_factory=list)
    op_calls: List[Dict] = field(default_factory=list)
    units: int = 0


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(intervals, lo, hi):
    """The idle (start, end) stretches of [lo, hi] outside the intervals."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


@contextlib.contextmanager
def wrapped_operators(calls: List[Dict]):
    """Every kernel operator timed in a range of its own and counted."""
    ns, names = program.operators()
    saved = {n: getattr(ns, n) for n in names}

    def make(name, op):
        def call(*args):
            i = len(calls)
            calls.append({"op": name, **counts.work(name, args)})
            with torch.profiler.record_function(f"{OP_PREFIX}{i}"):
                return op(*args)
        return call
    for n, op in saved.items():
        setattr(ns, n, make(n, op))
    try:
        yield
    finally:
        for n, op in saved.items():
            setattr(ns, n, op)


def _events(prof) -> List[Dict]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f, strict=False)["traceEvents"]
    finally:
        os.remove(path)


def profiled(driver, n_units: int) -> Trace:
    """Two sub-windows of ``n_units`` each: the first traces the device
    alone (the busy share, untouched by the host-side cost of tracing the
    host), the second the host too, with the operators wrapped (what the
    host did in each idle gap; each operator call's device time)."""
    cuda = driver.device.type == "cuda"
    cpu = torch.profiler.ProfilerActivity.CPU
    acts = [torch.profiler.ProfilerActivity.CUDA] if cuda else []
    with torch.profiler.profile(activities=acts or [cpu]) as prof:
        done, window_s = driver.run_units(n_units, keep=False)
    dev = [e for e in _events(prof) if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    tr = Trace(window_s=window_s,
               busy_s=union_length((e["ts"], e["ts"] + e["dur"])
                                   for e in dev) * 1e-6,
               units=driver.units_of(done))
    by_name = defaultdict(float)
    for e in dev:
        by_name[e["name"]] += e["dur"] * 1e-6
    tr.device_ops = sorted(([k, v] for k, v in by_name.items()),
                           key=lambda kv: -kv[1])[:10]
    calls: List[Dict] = []
    with wrapped_operators(calls), torch.profiler.profile(
            activities=[cpu] + acts) as prof:
        with torch.profiler.record_function(WINDOW):
            driver.run_units(n_units, keep=False)
    host = read(_events(prof), calls)
    tr.idle_gaps, tr.op_calls = host.idle_gaps, host.op_calls
    return tr


def read(events: List[Dict], calls: List[Dict]) -> Trace:
    spans = [e for e in events if e.get("ph") == "X"]
    # a range is also drawn on the device's timeline ("gpu_user_annotation");
    # the host's copy is the one whose clock the launches share
    win = [e for e in spans if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return Trace()
    lo = win[0]["ts"]
    hi = lo + win[0]["dur"]
    dev = [e for e in spans if e.get("cat") in DEVICE_CATS
           and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    iv = [(max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in dev]
    tr = Trace(window_s=(hi - lo) * 1e-6, busy_s=union_length(iv) * 1e-6)
    by_name = defaultdict(float)
    for e in dev:
        by_name[e["name"]] += e["dur"] * 1e-6
    tr.device_ops = sorted(([k, v] for k, v in by_name.items()),
                           key=lambda kv: -kv[1])[:10]
    # host ranges on the driving thread; they nest, so a stack swept in
    # time order holds the innermost one on top
    host = sorted((e for e in spans
                   if e.get("cat") in ("cpu_op", "user_annotation")
                   and e.get("tid") == win[0].get("tid")
                   and e["name"] != WINDOW),
                  key=lambda h: (h["ts"], -h["dur"]))
    idle, stack, k = defaultdict(float), [], 0
    for s, e in sorted(gaps(iv, lo, hi), key=lambda g: g[0] + g[1]):
        mid = (s + e) / 2
        while k < len(host) and host[k]["ts"] <= mid:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < host[k]["ts"]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < mid:
            stack.pop()
        label = stack[-1]["name"] if stack else "host between calls"
        if label.startswith(OP_PREFIX):
            label = "operator " + calls[int(label[len(OP_PREFIX):])]["op"]
        idle[label] += (e - s) * 1e-6
    tr.idle_gaps = sorted(([k, v] for k, v in idle.items()),
                          key=lambda kv: -kv[1])[:10]
    tr.op_calls = op_device_times(spans, calls)
    return tr


def op_device_times(spans: List[Dict], calls: List[Dict]) -> List[Dict]:
    """Each operator call with ``device_s``: its kernels' time."""
    ranges = [(e["ts"], e["ts"] + e["dur"], int(e["name"][len(OP_PREFIX):]))
              for e in spans if e.get("name", "").startswith(OP_PREFIX)
              and e.get("cat") == "user_annotation"]
    launches = {}
    for e in spans:
        if (e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "Launch" in e.get("name", "")):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = e["ts"]
    kernel_s = defaultdict(float)
    for e in spans:
        if e.get("cat") != "kernel":
            continue
        t = launches.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        for s, en, i in ranges:
            if s <= t <= en:
                kernel_s[i] += e["dur"] * 1e-6
                break
    out = []
    for i, c in enumerate(calls):
        if i in kernel_s:
            out.append({**c, "device_s": kernel_s[i]})
    return out
