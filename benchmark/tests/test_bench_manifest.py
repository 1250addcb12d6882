"""BENCHMARK.json against the benchmark's contract, and the harness finding
every cell's pieces by name: a new cell, traffic mix or metric takes only
new files and manifest entries."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark import harness

MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25 for m in MANIFEST["end_to_end"])
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_pieces_found_by_name(cell):
    c = harness.load_cell(cell)
    assert harness.load_driver(c.driver).run and harness.load_driver(c.driver).control
    assert any(m["name"] == "setup_s" for m in c.end_to_end) and len(c.end_to_end) >= 2
    assert c.per_layer and c.limits
    for m in c.per_layer:
        assert callable(harness.load_reader(m["name"]).read)
        # a per-layer metric's cells report the end-to-end metric it moves
        assert m["moves"] in {e["name"] for e in c.end_to_end}


def test_throwaway_cell_takes_only_new_files(tmp_path):
    """A cell, traffic mix and per-layer metric added in a copy by new files
    and manifest entries alone are found and read."""
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads(json.dumps(MANIFEST))
    bench = tmp_path / "benchmark"
    (bench / "traffic" / "search-q32.json").write_text(json.dumps(
        {**json.loads((bench / "traffic" / "search-q2048.json").read_text()), "batch": 32}))
    (bench / "workloads" / "proqa.search-q32.json").write_text(json.dumps(
        {"limits": {"score_gap": 1e-4}}))
    (bench / "metrics" / "calls.search.py").write_text(
        "def read(ctx):\n    return float(ctx['work']['calls'])\n")
    manifest["workloads"].append({"name": "proqa.search-q32", "config": "proqa-bert-base",
                                  "traffic": "search-q32", "chips": 1, "why": "throwaway"})
    for m in manifest["end_to_end"]:
        if m["name"] == "search_qps":
            m["workloads"].append("proqa.search-q32")
    manifest["per_layer"].append({"name": "calls.search", "unit": "calls", "better": "higher",
                                  "source": "program_counter", "layer": "search batch",
                                  "moves": "search_qps", "workloads": ["proqa.search-q32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = harness.load_cell("proqa.search-q32", tmp_path)
    assert cell.traffic["batch"] == 32 and cell.driver == "search"
    assert [m["name"] for m in cell.per_layer] == ["calls.search"]
    assert {m["name"] for m in cell.end_to_end} == {"search_qps", "setup_s"}
    outcome = harness.Outcome(attempted=64, failed=0, end_to_end={}, checks={},
                              memory_peak_bytes=0, work={"calls": 2})
    assert harness.per_layer_metrics(cell, outcome, tmp_path) == {
        "calls.search": {"value": 2.0, "unit": "calls"}}


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell("no.such-cell")
