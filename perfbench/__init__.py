"""The benchmark of magnet_tpu_torch on one H100 (``run.py``), driven by
``BENCHMARK.json`` at the root of the checkout."""
