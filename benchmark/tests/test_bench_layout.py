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


def check_top_level(spec):
    assert set(spec) == KEYS
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) < 64 * 1024


def test_top_level_shape():
    check_top_level(SPEC)


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def check_entries(spec, root):
    """Every entry's keys, names, units and lines; cells on 1 or 4 cards,
    at most a quarter of them (and always one) on 4."""
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        cfg = json.load(open(os.path.join(root, c["file"])))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    four = sum(w["chips"] == 4 for w in spec["workloads"])
    assert four <= max(1, len(spec["workloads"]) // 4)
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(set(names)) == len(names)


def test_entries_keys_names_and_units():
    check_entries(SPEC, harness.ROOT)


@pytest.mark.parametrize("chips,ok", [
    ([1, 1, 1, 1], True), ([4, 1, 1, 1], True), ([4, 4, 1, 1], False),
    ([4, 4] + [1] * 6, True), ([4, 4, 4] + [1] * 5, False),
    ([4], True), ([2, 1, 1, 1], False)])
def test_cells_take_one_or_four_cards_under_the_cap(chips, ok):
    spec = json.loads(json.dumps(SPEC))
    row = spec["workloads"][0]
    spec["workloads"] = [{**row, "name": f"cell-{i}", "chips": n}
                         for i, n in enumerate(chips)]
    if ok:
        check_entries(spec, harness.ROOT)
    else:
        with pytest.raises(AssertionError):
            check_entries(spec, harness.ROOT)


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


def _copy(tmp_path):
    """A copy of the benchmark, its tests with it, and its files' bytes."""
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return bench, {p: p.read_bytes() for p in bench.rglob("*")
                   if p.is_file()}


def test_a_new_cell_config_and_metric_take_new_files_only(tmp_path):
    """Add a configuration, a cell and a per-layer metric beside a copy of
    the benchmark without touching one of its files, and run it."""
    bench, before = _copy(tmp_path)
    cfg = json.loads((bench / "configs/msmarco-passage-bm25.json")
                     .read_text())
    cfg.update(name="tiny-passages", docs=1000, word_types=4096)
    (bench / "configs/tiny-passages.json").write_text(json.dumps(cfg))
    cell = json.loads((bench / "workloads/marco-serve-saturated.json")
                      .read_text())
    closed = tiny.kind(harness.Layout(), "marco-serve-saturated").TINY
    cell.update(config="tiny-passages",
                traffic={**cell["traffic"], **closed["traffic"]})
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


# What a new kind's driver appends to a renamed copy of ``ingest_passes``:
# a program on two cards reports each card's peak and capture.
TWO_CARDS = '''

CARD_PEAKS = [3 << 30, 5 << 30]
CARDS = [
    devtrace.Profile(window_s=2.0, busy_s=0.5, kernels=40,
                     op_seconds={"score_topk_kernel": 0.5},
                     idle_by_label={"main: pack_wait": 1.5},
                     launched=40, recorded=40),
    devtrace.Profile(window_s=2.5, busy_s=1.5, kernels=60,
                     op_seconds={"score_topk_kernel": 1.0, "sparse_df": 0.5},
                     idle_by_label={"main: pack_wait": 1.0},
                     launched=60, recorded=60)]
_one_card = measure


def measure(ctx, st):
    win = _one_card(ctx, st)
    ctx.observed.device_peaks = list(CARD_PEAKS)
    if ctx.trace:
        ctx.observed.profile = devtrace.merge(CARDS)
    return win
'''


def test_a_new_kind_and_a_four_card_cell_take_new_files_only(tmp_path,
                                                             monkeypatch):
    """Add a configuration, a driver kind with its test files, a cell on
    four cards and a per-layer metric beside a copy of the benchmark from
    new files alone; run the cell, its faults and its control."""
    from benchmark.tests import test_bench_kinds as kinds
    bench, before = _copy(tmp_path)
    cfg = json.loads((bench / "configs/wiki-100k-hashed.json").read_text())
    cfg.update(name="crawl-tiny")
    (bench / "configs/crawl-tiny.json").write_text(json.dumps(cfg))
    (bench / "traffic/sharded_passes.py").write_text(
        (bench / "traffic/ingest_passes.py").read_text() + TWO_CARDS)
    (bench / "tests/kinds/sharded_passes.py").write_bytes(
        (bench / "tests/kinds/ingest_passes.py").read_bytes())
    cell = json.loads((bench / "workloads/wiki-ingest.json").read_text())
    cell.update(config="crawl-tiny", driver="sharded_passes", chips=4,
                why="a test's cell on four cards")
    (bench / "workloads/crawl-tiny-4cards.json").write_text(json.dumps(cell))
    (bench / "metrics/device.busy.cards.py").write_text(
        'LAYER = "device"\nUNIT = "%"\nSOURCE = "device_trace"\n'
        'MOVES = "docs_per_s"\n\n\ndef read(ctx):\n'
        '    p = ctx.observed.profile\n'
        '    return None if p is None else 100 * p.busy_s / p.window_s\n')
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "crawl-tiny", "source": "a test",
                            "file": "benchmark/configs/crawl-tiny.json",
                            "reduced": [], "why": "a test's configuration"})
    spec["workloads"].append({"name": "crawl-tiny-4cards", "config":
                              "crawl-tiny", "traffic": "passes", "chips": 4,
                              "why": "a test's cell on four cards"})
    for m in spec["end_to_end"]:
        if m["name"] == "docs_per_s":
            m["workloads"].append("crawl-tiny-4cards")
    spec["per_layer"].append({"name": "device.busy.cards", "unit": "%",
                              "better": "higher", "source": "device_trace",
                              "layer": "device", "moves": "docs_per_s",
                              "workloads": ["crawl-tiny-4cards"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    layout = harness.Layout(str(bench), str(tmp_path / "BENCHMARK.json"))
    assert {p: p.read_bytes() for p in before} == before
    check_top_level(spec)
    check_entries(spec, str(tmp_path))
    kinds.check_control(layout, "sharded_passes")
    kinds.check_test_files(layout, "sharded_passes")

    plain = tiny.run("crawl-tiny-4cards", layout=layout)
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"docs_per_s", "setup_s"}
    assert plain["device"]["count"] == 4
    assert plain["device"]["memory_peak_bytes"] == 5 << 30
    traced = tiny.run("crawl-tiny-4cards", trace=True, layout=layout)
    assert traced["correct"], traced["checks"]
    assert (traced["device"]["busy_s"], traced["device"]["window_s"]) == \
        (2.0, 4.5)
    assert traced["metrics"]["device.busy.cards"]["value"] == \
        pytest.approx(100 * 2.0 / 4.5)
    assert traced["breakdown"] == {
        "device_ops": [["score_topk_kernel", 1.5], ["sparse_df", 0.5]],
        "idle_gaps": [["main: pack_wait", 2.5]]}

    test_files = tiny.kind(layout, "crawl-tiny-4cards")
    for name in tiny.FAULT_NAMES:
        with monkeypatch.context() as patch:
            test_files.FAULTS[name](patch)
            r = tiny.run("crawl-tiny-4cards", seed=31, layout=layout)
        assert not r["correct"], (name, r["checks"])
    numbers, correct = tiny.control("crawl-tiny-4cards", layout=layout)
    assert not correct, numbers
