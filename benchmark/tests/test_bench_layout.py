"""BENCHMARK.json keeps the contract's shape, and the harness finds every
configuration, cell and metric by its name alone."""

import json
import os
import re
import shutil

import pytest

from benchmark import harness
from benchmark.tests import tiny

SPEC = harness.Layout().spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_shape():
    assert set(SPEC) == KEYS
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_entries_keys_names_and_units():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = json.load(open(os.path.join(harness.ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_is_found_by_name_and_reports_enough(cell):
    layout = harness.Layout()
    w = layout.cell(cell)
    row = next(x for x in SPEC["workloads"] if x["name"] == cell)
    assert w["config"] == row["config"] and w["why"] == row["why"]
    assert w["chips"] == row["chips"]
    layout.config(w["config"])
    layout.driver(w["driver"])
    e2e = [m["name"] for m in SPEC["end_to_end"]
           if harness.applies(m, cell, SPEC["end_to_end"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = [m for m in SPEC["per_layer"]
           if harness.applies(m, cell, SPEC["end_to_end"])]
    assert per
    for m in per:  # each metric's moves is reported by the cell
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_every_reader_is_found_by_name_and_agrees(metric):
    mod = harness.Layout().metric(metric)
    row = next(x for x in SPEC["per_layer"] if x["name"] == metric)
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == \
        (row["layer"], row["unit"], row["source"], row["moves"])
    assert callable(mod.read)


def test_every_config_is_used_and_layers_are_named_alike():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    by_layer = {}
    for m in SPEC["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_a_new_cell_config_and_metric_take_new_files_only(tmp_path):
    """Add a configuration, a cell and a per-layer metric beside a copy of
    the benchmark without touching one of its files, and run it."""
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs/msmarco-passage-bm25.json")
                     .read_text())
    cfg.update(name="tiny-passages", docs=1000, word_types=4096)
    (bench / "configs/tiny-passages.json").write_text(json.dumps(cfg))
    cell = json.loads((bench / "workloads/marco-serve-saturated.json")
                      .read_text())
    cell.update(config="tiny-passages",
                traffic={**cell["traffic"], **tiny.TRAFFIC["serve_closed"]})
    (bench / "workloads/tiny-closed.json").write_text(json.dumps(cell))
    (bench / "metrics/serve.cache_hits.closed.py").write_text(
        'LAYER = "serve cache"\nUNIT = "queries"\n'
        'SOURCE = "program_counter"\nMOVES = "queries_per_s"\n\n\n'
        'def read(ctx):\n    return ctx.observed.counters.get("cache_hits")\n')
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "tiny-closed", "config":
                              "tiny-passages", "traffic": "tiny",
                              "chips": 1, "why": "a test's cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "queries_per_s":
            m["workloads"].append("tiny-closed")
    spec["per_layer"].append({"name": "serve.cache_hits.closed",
                              "unit": "queries", "better": "higher",
                              "source": "program_counter",
                              "layer": "serve cache",
                              "moves": "queries_per_s",
                              "workloads": ["tiny-closed"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    layout = harness.Layout(str(bench), str(tmp_path / "BENCHMARK.json"))
    after = {p: p.read_bytes() for p in before}
    assert after == before
    plain = tiny.run("tiny-closed", layout=layout)
    assert plain["correct"] and "queries_per_s" in plain["metrics"]
    traced = tiny.run("tiny-closed", trace=True, layout=layout)
    assert traced["metrics"]["serve.cache_hits.closed"]["value"] == 0
