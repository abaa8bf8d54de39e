"""The metric arithmetic: a rate over the whole window, idle time as the
union of the device's intervals, and each operator call's device time from
a trace."""

import importlib.util
from pathlib import Path

import pytest

from perfbench import counts, harness, trace


def read(name, **obs):
    return harness.reader(name)(harness.Obs(**obs))


def test_rate_is_all_work_over_all_time():
    assert read("maps_per_s", units=400, window_s=5.0) == 80.0
    assert read("train_step_ms", units=40, window_s=8.0) == 200.0
    assert read("maps_per_s", units=0, window_s=5.0) is None


def test_union_counts_overlap_once():
    assert trace.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.union_length([(0, 10), (2, 3)]) == 10
    assert trace.gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_trace_reading():
    events = [
        _x(trace.WINDOW, "user_annotation", 0, 100),
        _x("aten::conv", "cpu_op", 5, 30),
        _x(trace.OP_PREFIX + "0", "user_annotation", 50, 10),
        # the device-timeline copy of a range is not the host's
        _x(trace.OP_PREFIX + "0", "gpu_user_annotation", 8, 10, tid=7),
        _x(trace.WINDOW, "gpu_user_annotation", 30, 20, tid=7),
        _x("cudaLaunchKernel", "cuda_runtime", 52, 2, correlation=7),
        _x("cudaLaunchKernel", "cuda_runtime", 10, 2, correlation=3),
        _x("k_conv", "kernel", 20, 30, tid=7, correlation=3),
        _x("k_op", "kernel", 40, 20, tid=7, correlation=7),
        _x("k_conv", "kernel", 70, 10, tid=7, correlation=9)]
    calls = [{"op": "cost_volume_cw", "bytes": 1, "mma_flops": 0.0,
              "f32_flops": 0.0}]
    tr = trace.read(events, calls)
    assert tr.window_s == pytest.approx(100e-6)
    # kernels cover 20-60 and 70-80: 50 of the 100 us
    assert tr.busy_s == pytest.approx(50e-6)
    assert tr.device_ops[0] == ["k_conv", pytest.approx(40e-6)]
    idle = dict(tr.idle_gaps)
    assert idle["aten::conv"] == pytest.approx(20e-6)
    assert idle["host between calls"] == pytest.approx(30e-6)
    assert [c["device_s"] for c in tr.op_calls] == [pytest.approx(20e-6)]


def test_roofline_share_is_least_time_over_device_time():
    call = {"bytes": 3.35e9, "mma_flops": 0.0, "f32_flops": 0.0}
    assert counts.least_s(call) == pytest.approx(1e-3)
    tr = trace.Trace(op_calls=[{**call, "device_s": 4e-3}])
    assert read("kernels_roofline_pct.maps", trace=tr) == pytest.approx(25.0)
    uncounted = trace.Trace(op_calls=[{"uncounted": True, "device_s": 1.0}])
    assert read("kernels_roofline_pct.maps", trace=uncounted) is None
    assert read("kernels_roofline_pct.maps", trace=trace.Trace()) is None


def test_idle_and_mfu():
    tr = trace.Trace(window_s=2.0, busy_s=1.5)
    assert read("idle_pct.maps", trace=tr) == pytest.approx(25.0)
    assert read("mfu_pct.maps", units=100, window_s=1.0,
                model_flops_per_unit=989e10) == pytest.approx(100.0)


def test_every_metric_file_has_a_reader():
    here = Path(harness.HERE) / "metrics"
    for path in here.glob("*.py"):
        if path.name == "__init__.py":
            continue
        spec = importlib.util.spec_from_file_location("m", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)


def test_a_traced_run_reports_its_layers(tiny):
    """On the CPU no kernel operator runs (the program takes its plain
    versions), so the roofline share is left out, as a reader that finds
    nothing leaves its metric out; the spans, the model's FLOPs and the
    profiled sub-windows are read."""
    import time
    r = harness.run("scannet.video_b4", 2147483659, 0.2, True,
                    time.perf_counter(), device="cpu",
                    override=tiny("float32"))
    got = set(r["metrics"])
    assert {"host_issue_ms.maps", "dnet_ms.maps", "fnet_ms.maps",
            "fuse_ms.maps", "mfu_pct.maps", "idle_pct.maps"} <= got
    assert "kernels_roofline_pct.maps" not in got
    assert "maps_per_s" not in got
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(r)[-1] == "checks"
