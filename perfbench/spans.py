"""Spans the benchmark records from its own files, around calls into the
program's layers, in a traced run only.

``Spans`` keeps, per name, a list of (start, end) CUDA event pairs on the
current stream, or of host-clock durations; ``ms_sum(name)`` adds them up
once the device has finished. ``on_module(name, module)`` times a module's
forward with forward hooks; ``on_method(name, obj, attr)`` replaces a bound
method on the instance by a timed one; ``host(name, module)`` takes the host
clock from a module's call to its return, before any synchronisation.
``close()`` takes every hook and wrapper off again.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


class Spans:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.events = defaultdict(list)
        self.host_ms = defaultdict(list)
        self._undo = []

    def _start(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _stop(self, name, start):
        if not self.cuda:
            self.host_ms[name].append((time.perf_counter() - start) * 1e3)
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events[name].append((start, ev))

    def on_module(self, name, module):
        open_ = []
        pre = module.register_forward_pre_hook(
            lambda m, a: open_.append(self._start()))
        post = module.register_forward_hook(
            lambda m, a, out: self._stop(name, open_.pop()))
        self._undo += [pre.remove, post.remove]

    def on_method(self, name, obj, attr):
        inner = getattr(obj, attr)

        def timed(*args, **kwargs):
            start = self._start()
            out = inner(*args, **kwargs)
            self._stop(name, start)
            return out
        setattr(obj, attr, timed)
        self._undo.append(lambda: delattr(obj, attr))

    def host(self, name, module):
        open_ = []
        pre = module.register_forward_pre_hook(
            lambda m, a, *rest: open_.append(time.perf_counter()),
            with_kwargs=True)
        post = module.register_forward_hook(
            lambda m, a, *rest: self.host_ms[name].append(
                (time.perf_counter() - open_.pop()) * 1e3), with_kwargs=True)
        self._undo += [pre.remove, post.remove]

    def ms_sum(self, name):
        if name in self.host_ms:
            return sum(self.host_ms[name]), len(self.host_ms[name])
        pairs = self.events.get(name, [])
        if not pairs:
            return None, 0
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs), len(pairs)

    def close(self):
        for undo in reversed(self._undo):
            undo()
        self._undo = []
