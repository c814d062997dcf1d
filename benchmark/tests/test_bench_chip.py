"""On the card: each cell's command prints a result line of the
contract's shape, correct, on as many cards as the cell asks for. Skips
without a CUDA device, and a cell that needs more cards than the machine
has."""

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
    import torch
    chips = next(w["chips"] for w in SPEC["workloads"] if w["name"] == cell)
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{cell} needs {chips} CUDA devices; this machine has "
                    f"{torch.cuda.device_count()}")
    out = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH_DIR, "run.py"),
         "--workload", cell, "--seed", "2147483659", "--seconds", "3",
         "--trace", "0"], capture_output=True, text=True, timeout=1200,
        cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
    assert r["device"]["count"] == chips
    assert list(r)[-1] == "checks"
