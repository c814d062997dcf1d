"""The check fails what it must: each fault a cell can have, planted in
the timed path underneath the harness's own driver code, and the control
(the lower precision in the program's place) come out not correct. The
faults and the control are the cell's driver kind's (``tests/kinds/
<kind>.py``, ``CONTROL`` in ``traffic/<kind>.py``)."""

import numpy as np
import pytest

from benchmark import harness
from benchmark.tests import tiny

SPEC = harness.Layout().spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("fault", tiny.FAULT_NAMES)
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(monkeypatch, cell, fault):
    tiny.kind(harness.Layout(), cell).FAULTS[fault](monkeypatch)
    r = tiny.run(cell, seed=31)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    numbers, correct = tiny.control(cell)
    assert not correct, numbers
    assert np.isfinite(list(numbers.values())).all()
