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


def shrink(dtype="float32"):
    """An ``override`` for ``harness.run``: the configuration cut to its
    ``tiny`` size, H x W, in ``dtype``, on the CPU, where the program runs
    its plain versions. Only what the configuration has is touched: the
    flags' input size, cost-volume size (H/4 x W/4) and compute dtype, the
    shape's H and W and its cost volume's h and w, the camera scaled with
    the image. The mix runs at most three distinct inputs, one profiled
    unit, a batch of two and one checked forward."""
    def override(cfg, mix, limits):
        h, w = cfg["tiny"]["H"], cfg["tiny"]["W"]
        for flags in (cfg.get("test_flags", []), cfg.get("train_flags", [])):
            for key, value in (("--input_height", h), ("--input_width", w),
                               ("--dpv_height", h // 4),
                               ("--dpv_width", w // 4),
                               ("--compute_dtype", dtype)):
                if key in flags:
                    flags[flags.index(key) + 1] = str(value)
        shape = cfg["shape"]
        sx, sy = w / shape["W"], h / shape["H"]
        shape.update(H=h, W=w)
        if "h" in shape:
            shape.update(h=h // 4, w=w // 4)
        cam = cfg.get("camera")
        if cam is not None:
            cam.update(fx=cam["fx"] * sx, cx=cam["cx"] * sx,
                       fy=cam["fy"] * sy, cy=cam["cy"] * sy)
        for key, most in (("distinct_batches", 3), ("profiled_units", 1),
                          ("batch", 2), ("checked_forwards", 1)):
            if key in mix:
                mix[key] = min(mix[key], most)
    return override


@pytest.fixture
def tiny():
    return shrink


def fp8_control_checks(cfg, mix, limits):
    """The checks of the control, the reference computed in fp8 and put in
    the program's place (``driver.numbers("fp8")``), at the configuration's
    tiny size on the CPU, judged by ``limits``; every limited number has to
    be read, so that none fails for want of a reading."""
    from perfbench import harness, judge
    shrink("float32")(cfg, mix, limits)
    driver = harness.driver_for(cfg, mix, 2147483777, "cpu")
    driver.setup()
    driver.run_units(1)
    driver.release()
    numbers = driver.numbers("fp8")
    assert set(limits) <= set(numbers), sorted(set(limits) - set(numbers))
    return judge.checks(numbers, limits)


@pytest.fixture
def fp8_control():
    return fp8_control_checks
