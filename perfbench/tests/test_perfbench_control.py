"""The control comes out not correct: the reference computed in fp8 (one
precision below the configurations' bfloat16), put in the program's place
and judged by the committed limits, fails at least one of a cell's
numbers. Here at a tiny shape on the CPU; ``calibrate.py`` reads it on the
card at each cell's own size (PERF.md gives those readings)."""

import pytest

from perfbench import harness, judge

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_the_fp8_control_fails(cell, tiny):
    _, cfg, mix, limits = harness.find(BENCH, cell)
    H, W = (32, 128) if "kitti" in cell else (64, 96)
    tiny("float32", H, W)(cfg, mix, limits)
    driver = harness.driver_for(cfg, mix, 2147483777, "cpu")
    driver.setup()
    driver.run_units(1)
    driver.release()
    if driver.unit == "train":
        nums = judge.train_numbers(driver.reference_out("fp8"),
                                   driver.reference_out())
    else:
        nums = driver.numbers("fp8")
    checks = judge.checks(nums, limits)
    assert not all(c.ok for c in checks), checks
