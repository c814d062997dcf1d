"""On the card: each cell's command prints a result line of the
contract's shape, correct, on one chip. Skips without a CUDA device."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

SPEC = harness.Layout().spec()


@pytest.mark.chip
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_the_command_runs_a_cell_on_the_card(chip, cell):
    out = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH_DIR, "run.py"),
         "--workload", cell, "--seed", "2147483659", "--seconds", "3",
         "--trace", "0"], capture_output=True, text=True, timeout=1200,
        cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert list(r)[-1] == "checks"
