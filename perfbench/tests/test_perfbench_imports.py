"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads not even the program. Names are compared whole, by their top-level
part: ``magnet_tpu_torch`` is not ``magnet_tpu``."""

import subprocess
import sys
import types
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "magnet_tpu"}


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    return set(out.stdout.split())


def test_the_harness_loads_no_jax():
    top = loaded_after(
        "from perfbench import harness, calibrate, trace, program\n"
        "from perfbench.drivers import frames, train\n"
        "from perfbench import counts\n"
        "from perfbench.counts import model_flops\n"
        "import magnet_tpu_torch.test_magnet, magnet_tpu_torch.train_fnet\n"
        "import magnet_tpu_torch.kernels.ops")
    assert "magnet_tpu_torch" in top
    assert not top & FORBIDDEN


def test_the_reference_loads_neither_jax_nor_the_program():
    top = loaded_after("from perfbench.reference import magnet, nets, train"
                       ", precision")
    assert not top & (FORBIDDEN | {"magnet_tpu_torch"})


def test_the_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "magnet_tpu_torch_extra",
                        types.ModuleType("x"))
    assert "magnet_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "magnet_tpu.models",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == ["magnet_tpu"]


def test_no_result_without_a_card_or_outside_a_checkout(tmp_path):
    run = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"),
                          "--workload", "scannet.video_b4", "--seed",
                          "2147483659", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True)
    if run.returncode == 0:
        pytest.skip("a CUDA device is present")
    assert run.stdout.strip() == ""
