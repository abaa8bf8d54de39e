"""The plain reference against the program's plain CPU path at a tiny
shape, in float32: the one place the two meet. Both run the same seeded
weights and inputs; what is left is float32 rounding in another order."""

import time

import pytest

from perfbench import harness

# float32 through a B5 trunk, a decoder and 3 fusion steps in another
# order of operations: relative gaps of a few 1e-6 (1e-5 holds them with
# room); the step's first gradient and three updates amplify them through
# Adam's normalisation of near-zero gradients (2e-3 observed).
TOL_FRAME = 1e-4
TOL_LOSS = 1e-4
TOL_CV = 1e-4


@pytest.mark.parametrize("cell", ["scannet.video_b4", "kitti.video_b4"])
def test_frames_agree_with_the_program_in_float32(cell, tiny):
    over = tiny("float32")
    r = harness.run(cell, 2147483659, 0.2, False, time.perf_counter(),
                    device="cpu", override=over)
    assert r["correct"]
    # every gap, the ones read but not limited too (the *_wit numbers are
    # ratios to the bfloat16 witness, not gaps)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    _, cfg, mix, limits = harness.find(bench, cell)
    over(cfg, mix, limits)
    driver = harness.driver_for(cfg, mix, 2147483659, "cpu")
    driver.setup()
    driver.run_units(1)
    driver.release()
    gaps = {k: v for k, v in driver.numbers().items() if k.endswith("_rel")}
    assert len(gaps) == 7
    for key, v in gaps.items():
        assert v < TOL_FRAME, (key, v)


def test_training_agrees_with_the_program_in_float32(tiny):
    r = harness.run("scannet.train_fnet", 2147483659, 0.2, False,
                    time.perf_counter(), device="cpu",
                    override=tiny("float32"))
    nums = r["checks"]
    assert nums["loss_gap"]["value"] < TOL_LOSS
    assert nums["cv_gap"]["value"] < TOL_CV
    assert r["correct"]
