"""No module the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import os
import sys
import types

from benchmark import harness

BENCH = harness.BENCH_DIR
FORBIDDEN = {"jax", "jaxlib", "flax", "tfidf_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def _files(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_benchmark_module_imports_jax_or_the_jax_package():
    bad = [(p, m) for p in _files(BENCH) for m in _imports(p)
           if m in FORBIDDEN]
    assert not bad


def test_the_reference_imports_nothing_of_the_program():
    bad = [(p, m) for p in _files(os.path.join(BENCH, "reference"))
           for m in _imports(p) if m in FORBIDDEN | {"tfidf_tpu_torch"}]
    assert not bad


def test_the_run_guard_compares_whole_top_level_names(monkeypatch):
    import tfidf_tpu_torch  # noqa: F401  the port's name starts alike
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tfidf_tpu.ops",
                        types.ModuleType("tfidf_tpu.ops"))
    assert harness.forbidden_modules() == ["tfidf_tpu"]


def test_a_cpu_run_loads_no_forbidden_module():
    from benchmark.tests import tiny
    tiny.run("marco-serve-steady", seconds=0.5)
    assert harness.forbidden_modules() == []
