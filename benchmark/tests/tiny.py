"""Tiny sizes of every cell, for runs of the harness on the CPU.

What a driver kind brings to its tests lives in ``tests/kinds/<kind>.py``
beside the layout's ``traffic/<kind>.py``, found by the kind's name:
``TINY`` (the configuration's and the traffic's overrides) and
``FAULTS`` (``state_unchanged``, ``half_batch`` and ``answer_altered``,
each ``fault(monkeypatch)``, planted where that kind's program can be
reached)."""

import os
import time

from benchmark import harness
from benchmark.reference.compare import verdict

FAULT_NAMES = ("state_unchanged", "half_batch", "answer_altered")


def kind_file(layout: harness.Layout, kind: str) -> str:
    return layout._file(os.path.join("tests", "kinds"), kind, ".py")


def kind(layout: harness.Layout, cell: str):
    """The test module of ``cell``'s driver kind."""
    name = layout.cell(cell)["driver"]
    return harness._load(kind_file(layout, name), "kind")


def overrides(layout: harness.Layout, cell: str) -> dict:
    return kind(layout, cell).TINY


def run(cell: str, seed: int = 11, seconds: float = 1.0, trace=False,
        layout=None, precision="float64") -> dict:
    layout = layout or harness.Layout()
    return harness.execute(cell, seed, seconds, trace, "cpu",
                           time.perf_counter(), layout,
                           overrides(layout, cell), precision)


def control(cell: str, seed: int = 3, layout=None):
    """The control at the tiny size, as the cell's kind declares it
    (``CONTROL``): its compared numbers and whether they pass."""
    layout = layout or harness.Layout()
    c = layout.cell(cell)
    driver = layout.driver(c["driver"])
    if driver.CONTROL == "program":
        r = run(cell, seed=seed, layout=layout, precision="bfloat16")
        return {k: v["value"] for k, v in r["checks"].items()}, r["correct"]
    ov = overrides(layout, cell)
    cfg = {**layout.config(c["config"]), **ov.get("config", {})}
    c = {**c, "traffic": {**c["traffic"], **ov.get("traffic", {})}}
    ctx = harness.Context(cell, c, cfg, seed, 1.0, False, "cpu", "",
                          "bfloat16")
    numbers = driver.reference_control(ctx)["checks"]
    limits = {k: float(v) for k, v in c["limits"].items()}
    return numbers, verdict(numbers, limits)
