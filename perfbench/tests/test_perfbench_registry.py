"""BENCHMARK.json against the benchmark's contract, and every piece found
by its name."""

import json
import re
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source",
                   "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"}}


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_keys_and_names(section):
    for entry in BENCH[section]:
        assert set(entry) <= ENTRY_KEYS[section], entry["name"]
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))


def test_bounds_and_window():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the driver's 43200 s
    assert 2 + 14 * 24 * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_cell_reports_what_it_must():
    e2e = BENCH["end_to_end"]
    for cell in BENCH["workloads"]:
        name = cell["name"]
        assert cell["chips"] == 1
        ends = {m["name"] for m in harness.cell_metrics(BENCH, name, False)}
        assert "setup_s" in ends and len(ends) >= 2, name
        layers = harness.cell_metrics(BENCH, name, True)
        assert layers, name
        for m in layers:
            assert m["moves"] in ends, (name, m["name"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in e2e}
        for cell in m["workloads"]:
            assert m["moves"] in {
                e["name"] for e in harness.cell_metrics(BENCH, cell, False)}


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(len(x.split()) <= 4 for x in layers)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_pieces(cell):
    entry, cfg, mix, limits = harness.find(BENCH, cell)
    assert cfg["name"] == entry["config"]
    assert (ROOT / "perfbench" / "drivers" / f"{mix['driver']}.py").exists()
    assert limits and all(v > 0 for v in limits.values())
    for m in (harness.cell_metrics(BENCH, cell, False)
              + harness.cell_metrics(BENCH, cell, True)):
        assert callable(harness.reader(m["name"]))


def test_configs_state_their_cuts():
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert c["reduced"] == cfg["reduced"]
        for key in c["reduced"]:
            assert key in cfg


def test_a_wrong_name_is_refused():
    with pytest.raises(harness.CellError):
        harness.find(BENCH, "no.such_cell")
