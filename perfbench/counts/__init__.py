"""Bytes and operations each kernel operator call needs, and the least time
they take on one H100.

``work(op, args)`` finds ``counts/ops/<op>.py`` by the operator's name and
calls its ``work(*args)``, which reads only the arguments' shapes, dtypes
and scalar values: the count follows the operation and its shapes, never a
kernel's design, so a PR that fuses or replaces a kernel leaves the work
counted the same. A count is a dict of ``bytes`` (each input read once and
each output written once), ``mma_flops`` (products on the tensor cores:
the convolutions in bfloat16) and ``f32_flops`` (arithmetic outside them).
An operator with no file gives ``{"uncounted": True}``.

``least_s(count)``: the larger of the bytes at the memory rate and the
operations at their units' peak rates, the tensor cores and the CUDA cores
running side by side (the rule of ``chip_smoke.bound_ms``). Peaks are the
published ones of the H100 SXM at 700 W, dense: 989 TFLOP/s in bfloat16,
67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
OPS_DIR = Path(__file__).resolve().parent / "ops"
_loaded = {}


def nbytes(*ts) -> int:
    """Bytes of tensors and lists of tensors; None counts 0."""
    n = 0
    for t in ts:
        if isinstance(t, (list, tuple)):
            n += nbytes(*t)
        elif t is not None:
            n += t.numel() * t.element_size()
    return n


def products(x: torch.Tensor, flops: float) -> dict:
    """Convolution products: on the tensor cores in bfloat16, on the CUDA
    cores in float32."""
    if x.dtype == torch.bfloat16:
        return {"mma_flops": float(flops), "f32_flops": 0.0}
    return {"mma_flops": 0.0, "f32_flops": float(flops)}


def _module(op: str):
    if op not in _loaded:
        path = OPS_DIR / f"{op}.py"
        mod = None
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"perfbench.counts.ops.{op}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        _loaded[op] = mod
    return _loaded[op]


def work(op: str, args) -> dict:
    mod = _module(op)
    if mod is None:
        return {"uncounted": True}
    out = {"bytes": 0, "mma_flops": 0.0, "f32_flops": 0.0}
    out.update(mod.work(*args))
    return out


def least_s(count: dict) -> float:
    return max(count["bytes"] / PEAK_BYTES,
               count["mma_flops"] / PEAK_BF16_FLOPS,
               count["f32_flops"] / PEAK_F32_FLOPS)
