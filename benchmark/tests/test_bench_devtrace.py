"""The traced run reads no capture that dropped device records: the
program's own launch counts are held against the kernels recorded, a
second capture stands in for the first, and with none complete the
device metrics are left out. A capture that another process exported
is reduced with that process's marks, and the cards' profiles, one a
card, merge into one."""

import json
import os

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


def _capture(tmp_path, name, off_ns, window, kernels, spans, launched):
    """A capture as a rank's process exports it: its Chrome trace file,
    the marks it hands back through JSON (``Capture.marks``), and its
    spans on its host clock (trace microseconds * 1e3 + ``off_ns``).
    ``kernels``: (name, start, end) in trace microseconds, each launched
    from thread 7 ("main")."""
    def note(what, ts):
        return {"ph": "X", "cat": "user_annotation", "name": what, "ts": ts,
                "dur": 1}
    clock = [10.0, 20.0, 30.0, 40.0]
    events = [note("bench.clock", t) for t in clock]
    events += [note("bench.window", window[0]), note("bench.window",
                                                     window[1])]
    for i, (kernel, a, b) in enumerate(kernels):
        events.append({"ph": "X", "cat": "cuda_runtime", "tid": 7,
                       "name": "cudaLaunchKernel", "ts": a - 5, "dur": 2,
                       "args": {"correlation": i}})
        events.append({"ph": "X", "cat": "kernel", "name": kernel, "ts": a,
                       "dur": b - a, "args": {"correlation": i}})
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps({"traceEvents": events}))
    marks = json.loads(json.dumps({
        "clock_ns": [int(t * 1e3 + off_ns) for t in clock],
        "threads": {7: "main"}, "launched": launched}))
    host = [(span, "main", int(a * 1e3 + off_ns), int((b - a) * 1e3))
            for span, a, b in spans]
    return str(path), marks, host


# Card A: window 0..10,000 us; nine score kernels back to back over
# 1,000..2,800 and a DF kernel over 6,000..7,000: busy 2.8 ms. Idle:
# 0..1,000 ended by a launch inside pass_setup, 2,800..6,000 inside
# pack_wait, 7,000..10,000 ended by no launch. All 10 launches recorded.
CARD_A = dict(
    off_ns=5_000_000, window=(0.0, 10_000.0),
    kernels=[("score_topk_kernel", 1000 + 200 * i, 1200 + 200 * i)
             for i in range(9)] + [("sparse_df_kernel", 6000, 7000)],
    spans=[("pass_setup", -100, 1500), ("pack_wait", 2500, 6500)],
    launched={"score_topk_kernel": 9, "sparse_df_kernel": 1})
# Card B, another process's clock: window 5,000..13,000 us; one score
# kernel over 6,000..8,000: busy 2 ms; idle 5,000..6,000 inside
# pack_wait, 8,000..13,000 no launch. 1 of 2 launches recorded: lossy.
CARD_B = dict(
    off_ns=-70_000_000, window=(5000.0, 13_000.0),
    kernels=[("score_topk_kernel", 6000, 8000)],
    spans=[("pack_wait", 4000, 6100)], launched={"score_topk_kernel": 2})


def _reduced(tmp_path, name, card):
    path, marks, spans = _capture(tmp_path, name, **card)
    prof = devtrace.reduce_file(path, spans=spans, **marks)
    assert not os.path.exists(path)
    return prof


def test_a_capture_another_process_exported_is_reduced_with_its_marks(
        tmp_path):
    a = _reduced(tmp_path, "a", CARD_A)
    assert (a.window_s, a.busy_s, a.kernels) == pytest.approx(
        (0.010, 0.0028, 10))
    assert a.idle_by_label == pytest.approx(
        {"main: pass_setup": 0.001, "main: pack_wait": 0.0032,
         "host: no launch": 0.003})
    assert (a.recorded, a.launched, a.complete) == (10, 10, True)
    b = _reduced(tmp_path, "b", CARD_B)
    assert (b.window_s, b.busy_s) == pytest.approx((0.008, 0.002))
    assert b.idle_by_label == pytest.approx(
        {"main: pack_wait": 0.001, "host: no launch": 0.005})
    assert (b.recorded, b.launched, b.complete) == (1, 2, False)


def test_merged_cards_sum_and_are_complete_only_when_every_card_is(
        tmp_path):
    a = _reduced(tmp_path, "a", CARD_A)
    b = _reduced(tmp_path, "b", CARD_B)
    m = devtrace.merge([a, b])
    assert (m.window_s, m.busy_s, m.kernels) == pytest.approx(
        (0.018, 0.0048, 11))
    assert devtrace.idle_percent(m) == pytest.approx(
        100 * (1 - 0.0048 / 0.018))
    # 11 of 12 launches recorded would pass summed; card B is lossy
    assert (m.recorded, m.launched) == (11, 12)
    assert 11 >= devtrace.COMPLETE * 12 and not m.complete
    bd = m.breakdown()
    assert [n for n, _ in bd["device_ops"]] == ["score_topk_kernel",
                                                "sparse_df_kernel"]
    assert [s for _, s in bd["device_ops"]] == pytest.approx([0.0038, 0.001])
    assert [n for n, _ in bd["idle_gaps"]] == [
        "host: no launch", "main: pack_wait", "main: pass_setup"]
    assert [s for _, s in bd["idle_gaps"]] == pytest.approx(
        [0.008, 0.0042, 0.001])
    whole = devtrace.merge([a, _reduced(tmp_path, "a2", CARD_A)])
    assert whole.complete and (whole.recorded, whole.launched) == (20, 20)
    assert devtrace.idle_percent(whole) == pytest.approx(72.0)
    with pytest.raises(ValueError):
        devtrace.merge([])
