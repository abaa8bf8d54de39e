"""CPU tests of the benchmark. The ``cuda`` marker (as in ``tests/``) marks
a test that needs the card; it skips where there is none."""

import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skipped where there is none")


@pytest.fixture(autouse=True, scope="session")
def torch_threads():
    import torch
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))


def shrink(dtype="float32", H=64, W=96):
    """An ``override`` for ``harness.run``: the cell's flags and shapes cut
    to H x W (cost volume H/4 x W/4) in ``dtype``, two frame sets and two
    reference frames a forward; on the CPU the program runs its plain
    versions."""
    def override(cfg, mix, limits):
        for flags in (cfg.get("test_flags", []), cfg.get("train_flags", [])):
            for key, value in (("--input_height", H), ("--input_width", W),
                               ("--dpv_height", H // 4),
                               ("--dpv_width", W // 4),
                               ("--compute_dtype", dtype)):
                if key in flags:
                    flags[flags.index(key) + 1] = str(value)
        sx, sy = W / cfg["shape"]["W"], H / cfg["shape"]["H"]
        cfg["shape"].update(H=H, W=W, h=H // 4, w=W // 4)
        cam = cfg["camera"]
        cam.update(fx=cam["fx"] * sx, cx=cam["cx"] * sx, fy=cam["fy"] * sy,
                   cy=cam["cy"] * sy)
        mix["distinct_batches"] = 3
        mix["profiled_units"] = 1
        if "batch" in mix:
            mix["batch"] = min(mix["batch"], 2)
            mix["checked_forwards"] = 1
    return override


@pytest.fixture
def tiny():
    return shrink
