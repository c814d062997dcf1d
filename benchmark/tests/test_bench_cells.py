"""Every cell, run on the CPU through the harness's own driver code at a
tiny size: the plain reference agrees with the port, a traced run prints
per-layer metrics and its breakdown, an untraced one only the
end-to-end metrics."""

import json
import time

import pytest

from benchmark import harness
from benchmark.tests import tiny

SPEC = harness.Layout().spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def _e2e(cell):
    return {m["name"] for m in SPEC["end_to_end"]
            if harness.applies(m, cell, SPEC["end_to_end"])}


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port(cell):
    r = tiny.run(cell, seed=2**31 + 9)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == _e2e(cell)
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(r)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_per_layer_metrics(cell):
    r = tiny.run(cell, seed=5, trace=True)
    assert r["correct"]
    per = {m["name"] for m in SPEC["per_layer"]
           if harness.applies(m, cell, SPEC["end_to_end"])}
    # on the CPU only the host-side readers find something to read
    assert r["metrics"] and set(r["metrics"]) <= per
    assert not set(r["metrics"]) & _e2e(cell)
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_closed_loop_keeps_its_answers_across_row_blocks():
    layout = harness.Layout()
    cell = "marco-serve-saturated"
    driver = layout.driver("serve_closed")
    driver.ROWS = 8   # a new block of answer rows every 8 requests
    ov = tiny.overrides(layout, cell)
    ctx = harness.Context(cell, {**layout.cell(cell), "traffic": {
        **layout.cell(cell)["traffic"], **ov["traffic"]}},
        {**layout.config("msmarco-passage-bm25"), **ov["config"]}, 3, 1.0,
        False, "cpu", "")
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        ctx.workdir = d
        r = harness._execute(ctx, driver, SPEC, layout, time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["attempted"] > 3 * driver.ROWS and r["failed"] == 0
