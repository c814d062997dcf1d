"""The traced run reads no capture that dropped device records: the
program's own launch counts are held against the kernels recorded, a
second capture stands in for the first, and with none complete the
device metrics are left out."""

import pytest

from benchmark import devtrace, harness
from benchmark.tests import tiny

SPEC = harness.Layout().spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
DEVICE_METRICS = {m["name"] for m in SPEC["per_layer"]
                  if m["source"] == "device_trace"}


def _events(kernels: int) -> list:
    edge = {"ph": "X", "cat": "user_annotation", "name": "bench.window",
            "dur": 1}
    ops = [{"ph": "X", "cat": "kernel", "name": "tile_scores_kernel",
            "ts": 100 + 10 * i, "dur": 5} for i in range(kernels)]
    return [{**edge, "ts": 0}, *ops, {**edge, "ts": 10_000}]


@pytest.mark.parametrize("recorded,launched,complete", [
    (20, 20, True), (19, 20, True), (17, 20, False), (1, 300, False),
    (0, 0, True)])
def test_a_capture_is_complete_only_with_the_launches_counted(
        recorded, launched, complete):
    prof = devtrace.reduce_events(_events(recorded), [], {}, [],
                                  {"tile_scores_kernel": launched,
                                   "fused_score_topk_kernel": 0})
    assert (prof.recorded, prof.launched) == (recorded, launched)
    assert prof.complete is complete


def _dropping(monkeypatch, captures_lost: int):
    """The first ``captures_lost`` captures each see 1,000 launches of
    the program's kernels and record none."""
    state = {"calls": 0}

    def program_launches():
        state["calls"] += 1
        lost = (state["calls"] + 1) // 2 <= captures_lost
        at_exit = state["calls"] % 2 == 0
        return {"tile_scores_kernel": 1000 * at_exit * lost}

    monkeypatch.setattr(devtrace, "program_launches", program_launches)


@pytest.mark.parametrize("cell", CELLS)
def test_a_second_capture_stands_in_for_a_lossy_first(monkeypatch, cell):
    _dropping(monkeypatch, 1)
    r = tiny.run(cell, seed=21, trace=True)
    assert r["correct"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert "breakdown" in r


@pytest.mark.parametrize("cell", CELLS)
def test_with_no_complete_capture_the_device_metrics_are_left_out(
        monkeypatch, cell):
    _dropping(monkeypatch, 2)
    r = tiny.run(cell, seed=22, trace=True)
    assert r["correct"]
    assert not set(r["metrics"]) & DEVICE_METRICS
    assert "busy_s" not in r["device"] and "breakdown" not in r
