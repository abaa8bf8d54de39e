"""The readings that the limits of ``correct`` are set from.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,... \\
        [--control 3] [--seconds 2] --out <file.json>

For each seed, in one process: the cell's set-up and a short window of its
own traffic, then the numbers of ``judge`` for what the timed path produced
against the float32 reference (the lower readings, the program's). For the
first ``--control`` seeds also the control's numbers: the reference
computed in fp8 put in the program's place and judged against the float32
reference (the upper readings); for a training cell also the reference with
half of each batch left out (a fault the check must catch) and, as a
witness of what bfloat16 rounding alone reads, the reference in bfloat16;
each for the first steps and for the window's drawn step. The benchmark's
runs do not run this; the limits in ``perfbench/limits/<cell>.json`` record
the readings they were set from.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
os.environ["OMP_NUM_THREADS"] = "2"

from perfbench import harness, judge  # noqa: E402


def _train_pair(driver, precision="float32", rows=None):
    out = judge.train_numbers(driver.reference_out(precision, rows),
                              driver.reference_out())
    win = judge.train_numbers(driver.reference_window(precision, rows),
                              driver.reference_window())
    out.update({"win_" + k: v for k, v in win.items()})
    return out


def control_numbers(driver):
    out = {"fp8": driver.numbers("fp8")}
    if driver.unit == "train":
        out["half_batch"] = _train_pair(driver,
                                        rows=driver.args.batch_size // 2)
        out["bf16"] = _train_pair(driver, "bfloat16")
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell, cfg, mix, _ = harness.find(bench, a.workload)
    harness.check_device(cell)
    rows = []
    for i, seed in enumerate(int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        driver = harness.driver_for(cfg, mix, seed, "cuda")
        driver.setup()
        n, secs = driver.run_units(seconds=a.seconds)
        driver.release()
        row = {"seed": seed, "units": driver.units_of(n),
               "program": driver.numbers()}
        if i < a.control:
            row.update(control_numbers(driver))
        row["seconds"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
        rows.append(row)
        del driver
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps({"workload": a.workload,
                                       "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
