"""Every driver kind brings what the harness and its tests look up by the
kind's name: ``CONTROL`` in ``traffic/<kind>.py`` (with
``reference_control`` where it is ``"reference"``), and ``TINY`` and
the three ``FAULTS`` in ``tests/kinds/<kind>.py``. A kind that lacks one
fails here, by its name."""

import ast
import os

import pytest

from benchmark import harness
from benchmark.tests import tiny

CONTROLS = ("program", "reference")


def kinds(layout: harness.Layout) -> list:
    """The layout's driver kinds: the files of ``traffic/`` that define
    ``measure`` (the others, such as ``text`` and ``serving``, are what
    kinds share)."""
    folder = os.path.join(layout.bench_dir, "traffic")
    out = []
    for f in sorted(os.listdir(folder)):
        if f.endswith(".py"):
            with open(os.path.join(folder, f)) as src:
                tree = ast.parse(src.read(), f)
            if any(isinstance(n, ast.FunctionDef) and n.name == "measure"
                   for n in tree.body):
                out.append(f[:-3])
    return out


def used_kinds(layout: harness.Layout) -> list:
    return sorted({layout.cell(w["name"])["driver"]
                   for w in layout.spec()["workloads"]})


def check_control(layout: harness.Layout, kind: str) -> None:
    driver = layout.driver(kind)
    control = getattr(driver, "CONTROL", None)
    assert control in CONTROLS, \
        f"traffic/{kind}.py: CONTROL is {control!r}, not one of {CONTROLS}"
    if control == "reference":
        assert callable(getattr(driver, "reference_control", None)), \
            f"traffic/{kind}.py: CONTROL \"reference\" and no reference_control"


def check_test_files(layout: harness.Layout, kind: str) -> None:
    path = tiny.kind_file(layout, kind)
    assert os.path.isfile(path), f"kind {kind}: no tests/kinds/{kind}.py"
    mod = harness._load(path, "kind")
    sizes = getattr(mod, "TINY", None)
    assert isinstance(sizes, dict) and set(sizes) <= {"config", "traffic"}, \
        f"tests/kinds/{kind}.py: TINY is not a dict of config and traffic"
    faults = getattr(mod, "FAULTS", None) or {}
    missing = [f for f in tiny.FAULT_NAMES if not callable(faults.get(f))]
    assert not missing, f"tests/kinds/{kind}.py: FAULTS lacks {missing}"


@pytest.mark.parametrize("kind", kinds(harness.Layout()))
def test_every_kind_declares_a_valid_control(kind):
    check_control(harness.Layout(), kind)


@pytest.mark.parametrize("kind", used_kinds(harness.Layout()))
def test_every_kind_a_cell_uses_brings_its_tiny_sizes_and_faults(kind):
    check_test_files(harness.Layout(), kind)


def test_a_kind_without_its_files_fails_by_its_name(tmp_path):
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "orphan_passes.py").write_text(
        "def measure(ctx, st):\n    return None\n")
    layout = harness.Layout(str(tmp_path), str(tmp_path / "BENCHMARK.json"))
    assert kinds(layout) == ["orphan_passes"]
    for check in (check_control, check_test_files):
        with pytest.raises(AssertionError, match="orphan_passes"):
            check(layout, "orphan_passes")
