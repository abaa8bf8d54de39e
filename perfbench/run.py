"""The benchmark of magnet_tpu_torch on one H100: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (and with ``--trace 1`` ``breakdown``), and last
``checks``, each number compared with its limit; the same numbers are the
last lines of standard error. Exits non-zero, printing no result, where
there is no CUDA device or too few, where a name is wrong, and where
``jax``, ``jaxlib``, ``flax`` or ``magnet_tpu`` is loaded once the window
has closed. Caches of compiled code stay at fixed paths under the
checkout's ``build/`` (the kernels' library is the program's own, in
``build/magnet_tpu_torch/``). The process keeps to two host threads.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "perfbench"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
# one process with few threads: host-side work steady from run to run
THREADS = 2
os.environ["OMP_NUM_THREADS"] = str(THREADS)
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    import torch
    torch.set_num_threads(THREADS)
    from perfbench import harness
    try:
        result = harness.run(a.workload, a.seed, a.seconds, bool(a.trace),
                             T_START)
    except harness.CellError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
