"""One run of one cell: set-up, the measured window, the traced sub-window,
the check against the reference, and the result line.

Everything is found by name from ``BENCHMARK.json``: the cell's entry names
its configuration (``configs`` gives the file) and its traffic mix
(``perfbench/traffic/<mix>.json``, whose ``driver`` names the general
driver in ``perfbench/drivers/``: it builds the model, runs the traffic,
counts the model's FLOPs a unit on its own plain reference and judges the
outputs); every metric, end-to-end or per-layer, is read by
``perfbench/metrics/<base>.py`` where ``<base>`` is the metric's name up to
its first dot; the limits of the check are ``perfbench/limits/<cell>.json``.
A later cell, metric or architecture is new files and new entries, with no
edit here.

With ``trace`` 0 the result carries the cell's end-to-end metrics; with 1
the benchmark's spans are on during the window and ``profiled_units`` more
units run under the profiler, and the result carries the per-layer
metrics, the device's busy and window seconds and the breakdown.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import torch

from perfbench import judge

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "magnet_tpu")


@dataclass
class Obs:
    """What the metric readers read."""
    units: int = 0
    window_s: float = 0.0
    setup_s: float = 0.0
    spans: object = None
    trace: object = None
    model_flops_per_unit: float = 0.0


class CellError(Exception):
    """The run cannot give a result (no card, a wrong name, a forbidden
    import); the message says why."""


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def find(bench: Dict, cell_name: str):
    """(cell, configuration, mix, limits) of a cell by its name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise CellError(f"no workload {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(ROOT / cfg_entry["file"])
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{cell_name}.json")["limits"]
    return cell, cfg, mix, limits


def cell_metrics(bench: Dict, cell_name: str, trace: bool) -> List[Dict]:
    """The metrics a run of the cell reports: its end-to-end ones, or with
    ``trace`` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", [cell_name])
            and m["moves"] in moved]


_readers = {}


def reader(metric_name: str):
    base = metric_name.split(".")[0]
    if base not in _readers:
        path = HERE / "metrics" / f"{base}.py"
        spec = importlib.util.spec_from_file_location(
            f"perfbench.metrics.{base}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _readers[base] = mod.read
    return _readers[base]


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is one of
    ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def driver_for(cfg, mix, seed, device):
    mod = importlib.import_module(f"perfbench.drivers.{mix['driver']}")
    return mod.Driver(cfg, mix, seed, device)


def check_device(cell) -> None:
    if not torch.cuda.is_available():
        raise CellError("no CUDA device: this benchmark measures the card")
    if torch.cuda.device_count() < cell["chips"]:
        raise CellError(f"{cell['name']} needs {cell['chips']} cards, "
                        f"{torch.cuda.device_count()} found")


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", override=None) -> Dict:
    """The result of one run. ``override(cfg, mix, limits)`` may change the
    loaded files (tests run tiny shapes on the CPU with it)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, cfg, mix, limits = find(bench, cell_name)
    if override is not None:
        override(cfg, mix, limits)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        check_device(cell)
        torch.cuda.reset_peak_memory_stats()
    t_driver = time.perf_counter()
    driver = driver_for(cfg, mix, seed, device)
    driver.setup()
    obs = Obs(setup_s=time.perf_counter() - t_start)
    print(f"set-up: {t_driver - t_start:.3f} s to the driver, then "
          + ", ".join(f"{k} at {v:.3f} s" for k, v in driver.setup_log),
          file=sys.stderr)
    if trace:
        obs.spans = driver.open_spans()
    n, obs.window_s = driver.run_units(seconds=seconds)
    obs.units = driver.units_of(n)
    if trace:
        driver.close_spans()
        from perfbench import trace as tracing
        obs.trace = tracing.profiled(driver, mix["profiled_units"])
        obs.model_flops_per_unit = driver.model_flops_per_unit()
    metrics = {}
    for m in cell_metrics(bench, cell_name, trace):
        value = reader(m["name"])(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    driver.release()
    checks = judge.checks(driver.numbers(), limits)
    correct = all(c.ok for c in checks)
    found = forbidden_modules()
    if found:
        raise CellError(f"forbidden modules loaded: {found}")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": obs.units,
              "failed": 0 if correct else driver.compared(),
              "metrics": metrics, "device": dev}
    if trace and obs.trace is not None:
        dev["busy_s"] = obs.trace.busy_s
        dev["window_s"] = obs.trace.window_s
        result["breakdown"] = {"device_ops": obs.trace.device_ops,
                               "idle_gaps": obs.trace.idle_gaps}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result
