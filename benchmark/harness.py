"""One cell, run end to end: the layout the harness finds by name, the
run's context, and the result line.

Everything that belongs to one configuration, one cell or one per-layer
metric lives in a file of its own, found by the name ``BENCHMARK.json``
gives it:

* ``configs/<config>.json``: sizes, generator parameters, guarantees;
* ``workloads/<cell>.json``: the configuration, the driver kind, the
  traffic parameters and the limits of the correctness numbers;
* ``traffic/<kind>.py``: a driver kind (``setup``, ``measure``,
  ``release``, ``check``);
* ``metrics/<metric>.py``: a per-layer metric's reader (``read``).

A run: set-up (data from the seed, the program's index or warm-up
pass) -> the measured window -> the program's device state freed ->
the plain reference recomputes and the numbers are compared -> with
``--trace 1`` the per-layer readers -> the result line.

A program that runs in processes of its own, one card each, is read
through what its driver hands back: each card's bytes at peak
(``Observed.device_peaks``) and the cards' captures merged into one
profile (``devtrace.merge``).
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from benchmark.reference.compare import verdict

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
SPEC_PATH = os.path.join(ROOT, "BENCHMARK.json")
# Top-level module names no run may hold: JAX, its kin, the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "tfidf_tpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@dataclass
class Layout:
    """Where the spec and the per-name files live."""

    bench_dir: str = BENCH_DIR
    spec_path: str = SPEC_PATH

    def spec(self) -> dict:
        return read_json(self.spec_path)

    def _file(self, sub: str, name: str, ext: str) -> str:
        if not NAME.match(name):
            raise ValueError(f"bad name {name!r}")
        return os.path.join(self.bench_dir, sub, name + ext)

    def cell(self, name: str) -> dict:
        return read_json(self._file("workloads", name, ".json"))

    def config(self, name: str) -> dict:
        return read_json(self._file("configs", name, ".json"))

    def driver(self, kind: str):
        return _load(self._file("traffic", kind, ".py"), "traffic")

    def metric(self, name: str):
        return _load(self._file("metrics", name, ".py"), "metric")


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _load(path: str, what: str):
    """Import a file of the layout as a module of its own."""
    mod_name = f"benchmark_{what}_" + re.sub(r"\W", "_",
                                             os.path.basename(path)[:-3])
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def applies(entry: dict, cell: str, end_to_end: List[dict]) -> bool:
    """Whether a metric of BENCHMARK.json is reported by ``cell``: its
    ``workloads`` name it, or it has none and (per-layer) the
    end-to-end metric it moves is the cell's."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    if "moves" not in entry:
        return True
    moved = [m for m in end_to_end if m["name"] == entry["moves"]]
    return bool(moved) and applies(moved[0], cell, end_to_end)


def forbidden_modules() -> List[str]:
    """The forbidden top-level names in ``sys.modules``, compared whole
    (``tfidf_tpu_torch`` is not ``tfidf_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


@dataclass
class Observed:
    """What a traced run hands the per-layer readers."""

    spans: list = field(default_factory=list)   # (name, thread, t0_ns, dur_ns)
    counters: Dict[str, float] = field(default_factory=dict)
    profile: object = None                       # devtrace.Profile
    facts: Dict[str, float] = field(default_factory=dict)
    # Each card's bytes at peak, as a program in other processes reports
    # them; empty where the program runs in this process alone.
    device_peaks: List[int] = field(default_factory=list)


@dataclass
class Context:
    """One run: the cell's files, the seed, the window, the device."""

    cell_name: str
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    workdir: str
    precision: str = "float64"
    observed: Observed = field(default_factory=Observed)

    @property
    def cuda(self) -> bool:
        return self.device.startswith("cuda")

    def sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


@dataclass
class Window:
    """What a driver's window measured."""

    e2e: Dict[str, float]
    attempted: int
    failed: int


def tracer_spans(tracer) -> list:
    """A program tracer's spans as (name, thread name, t0_ns, dur_ns)."""
    names = dict(tracer._names)
    return [(name, names.get(tid, f"t{tid}"), t0, dur)
            for name, tid, t0, dur, _args in tracer.events()]


def device_info(ctx: Context, peak: int) -> dict:
    """The result's ``device``. ``memory_peak_bytes`` is the fullest
    card's: the larger of this process's peak and every card's the
    program reported; ``busy_s``/``window_s`` are the profile's, summed
    over the cards of a merged one."""
    if ctx.cuda:
        import torch
        kind = torch.cuda.get_device_name(0)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    info = {"platform": platform, "kind": kind,
            "count": int(ctx.cell.get("chips", 1)),
            "memory_peak_bytes": int(max([peak,
                                          *ctx.observed.device_peaks]))}
    prof = ctx.observed.profile
    if ctx.trace and prof is not None:
        info["busy_s"] = prof.busy_s
        info["window_s"] = prof.window_s
    return info


def execute(cell_name: str, seed: int, seconds: float, trace: bool,
            device: str, t_start: float, layout: Optional[Layout] = None,
            overrides: Optional[dict] = None,
            precision: str = "float64") -> dict:
    """Run one cell and return its result (the last line's object).

    ``overrides`` (``{"config": {...}, "traffic": {...}}``) replaces
    top-level keys of the configuration and of the cell's traffic: a
    test's small sizes. ``precision`` other than float64 runs the
    control in the program's place."""
    layout = layout or Layout()
    spec = layout.spec()
    cell = layout.cell(cell_name)
    config = layout.config(cell["config"])
    overrides = overrides or {}
    config = {**config, **overrides.get("config", {})}
    cell = {**cell, "traffic": {**cell.get("traffic", {}),
                                **overrides.get("traffic", {})}}
    driver = layout.driver(cell["driver"])
    tmp_root = os.environ.get("TMPDIR") or tempfile.gettempdir()
    workdir = tempfile.mkdtemp(prefix="bench-", dir=tmp_root)
    ctx = Context(cell_name, cell, config, int(seed), float(seconds),
                  bool(trace), device, workdir, precision)
    try:
        return _execute(ctx, driver, spec, layout, t_start)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _execute(ctx: Context, driver, spec: dict, layout: Layout,
             t_start: float) -> dict:
    if ctx.cuda:
        import torch
        torch.cuda.reset_peak_memory_stats()
    state = driver.setup(ctx)
    setup_s = time.perf_counter() - t_start
    ctx.log(f"setup_s {setup_s:.3f} " + " ".join(
        f"{k} {v:.3f}" for k, v in state.setup_split.items()))
    win = driver.measure(ctx, state)
    peak = 0
    if ctx.cuda:
        import torch
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    driver.release(ctx, state)
    numbers = driver.check(ctx, state)
    limits = {k: float(v) for k, v in ctx.cell["limits"].items()}
    correct = verdict(numbers, limits)
    e2e_spec = spec["end_to_end"]
    values = dict(win.e2e, setup_s=setup_s)
    metrics = {}
    if not ctx.trace:
        for m in e2e_spec:
            if applies(m, ctx.cell_name, e2e_spec):
                if m["name"] not in values:
                    raise RuntimeError(f"{ctx.cell_name} did not measure "
                                       f"{m['name']}")
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
    else:
        for m in spec["per_layer"]:
            if applies(m, ctx.cell_name, e2e_spec):
                v = layout.metric(m["name"]).read(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v),
                                          "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(win.attempted),
              "failed": int(win.failed), "metrics": metrics,
              "device": device_info(ctx, peak)}
    if ctx.trace and ctx.observed.profile is not None:
        result["breakdown"] = ctx.observed.profile.breakdown()
    result["checks"] = {name: {"value": float(v),
                               "limit": limits.get(name, float("nan"))}
                        for name, v in numbers.items()}
    return result
