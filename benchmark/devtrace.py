"""The traced run's device window: a torch.profiler capture, reduced to
what the per-layer metrics read.

The capture records host and device activity over a sub-window of the
measured window and is exported as Chrome trace JSON into the run's
scratch directory, then read back:

* device ops: kineto's ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
  events, clipped to the window;
* busy time: the union of their intervals; idle = the window less it;
* idle gaps: each stretch with no device op, labelled by what the host
  was doing: the innermost program span (``obs.tracer``) open at the
  gap's start on the thread that launched the op ending the gap (the
  kernel's CUDA runtime call, joined by its correlation id); the host
  and trace clocks are aligned by ``bench.clock`` markers;
* completeness: the program counts its own kernels' launches
  (``ops.kernels.LAUNCHES``); a capture that recorded fewer than
  ``COMPLETE`` of the launches counted over it lost device records (the
  profiler can drop them) and is not read.

A program that runs on several cards, one process each, captures each
process with :class:`Capture` there and hands the exported file and
:meth:`Capture.marks` back; :func:`reduce_file` reduces each card's
capture and :func:`merge` joins them into the run's one profile.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# The least share of the counted launches a capture must hold.
COMPLETE = 0.9
_CLOCK = "bench.clock"
_EDGE = "bench.window"


@dataclass
class Profile:
    """A reduced capture; times in seconds."""

    window_s: float
    busy_s: float
    kernels: int
    op_seconds: Dict[str, float]
    idle_by_label: Dict[str, float] = field(default_factory=dict)
    note: str = ""
    launched: int = 0     # the program's kernels launched over the window
    recorded: int = 0     # ... and recorded by the capture
    cards_complete: bool = True   # False: a merged card's capture was lossy

    @property
    def complete(self) -> bool:
        return self.cards_complete \
            and self.recorded >= COMPLETE * self.launched

    def seconds_of(self, fragment: str) -> float:
        """Device seconds of the ops whose name holds ``fragment``."""
        return sum(s for name, s in self.op_seconds.items()
                   if fragment in name)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.op_seconds.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_label.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n[:160], s] for n, s in gaps[:top]]}


def idle_percent(prof: Optional[Profile]) -> Optional[float]:
    """The window's share with no device op, or None without a capture
    that saw the device."""
    if prof is None or prof.window_s <= 0 or prof.busy_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)


def program_launches() -> Dict[str, int]:
    """The program's own count of its kernels' launches, by the name of
    the ``__global__`` function each launches."""
    from tfidf_tpu_torch.ops import kernels
    return {kernels.KERNEL_FUNCTIONS[name]: n
            for name, n in kernels.LAUNCHES.items()}


class Capture:
    """``with Capture(path, cuda) as cap: ...`` profiles the block;
    :meth:`reduce` then reads it. Host spans for the gap labels come
    from ``spans`` (name, thread name, start_ns, dur_ns on
    ``time.perf_counter_ns``), passed to :meth:`reduce`."""

    def __init__(self, path: str, cuda: bool):
        self.path = path
        self.cuda = cuda
        self._prof = None
        self._clock: List[int] = []
        self.threads: Dict[int, str] = {}
        self.launched: Dict[str, int] = {}

    @staticmethod
    def warm(cuda: bool) -> None:
        """Profile nothing once, so that the profiler's own start-up
        (CUPTI, kineto) falls in set-up and not in the window."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            pass

    def _sync(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def _marks(self, name: str) -> None:
        import torch
        for _ in range(4):
            self._clock.append(time.perf_counter_ns())
            with torch.profiler.record_function(name):
                pass

    def __enter__(self) -> "Capture":
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._sync()
        self._marks(_CLOCK)
        import torch
        with torch.profiler.record_function(_EDGE):
            pass
        self.launched = {k: -n for k, n in program_launches().items()}
        return self

    def __exit__(self, *exc) -> None:
        # Counted before the synchronize, every launch counted has run
        # by the closing edge.
        for k, n in program_launches().items():
            self.launched[k] = self.launched.get(k, 0) + n
        self._sync()
        import torch
        with torch.profiler.record_function(_EDGE):
            pass
        self._marks(_CLOCK)
        # kineto names the main thread by its kernel id and the others
        # by the low 32 bits of their pthread handle: know both.
        self.threads = {}
        for t in threading.enumerate():
            name = "main" if t is threading.main_thread() else t.name
            for key in (t.native_id, t.ident, (t.ident or 0) & 0xFFFFFFFF):
                if key is not None:
                    self.threads[key] = name
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._prof.export_chrome_trace(self.path)

    def marks(self) -> dict:
        """What :func:`reduce_file` needs beside the exported file, in a
        form JSON carries from another process: the clock marks, the
        thread names and the launches counted."""
        return {"clock_ns": list(self._clock), "threads": dict(self.threads),
                "launched": dict(self.launched)}

    def reduce(self, spans: Optional[list] = None) -> Profile:
        prof = reduce_file(self.path, spans=spans, **self.marks())
        print(f"capture: {prof.note}", file=sys.stderr, flush=True)
        return prof


def reduce_file(path: str, clock_ns: List[int], threads: Dict,
                spans: Optional[list] = None,
                launched: Optional[Dict[str, int]] = None) -> Profile:
    """Reduce the Chrome trace that a process exported to ``path``, this
    one or another (a rank's, on its own card), with that process's
    clock marks, thread names and launch counts (:meth:`Capture.marks`)
    and its spans; the file is removed."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    threads = {int(k): name for k, name in threads.items()}  # JSON: str keys
    return reduce_events(events, list(clock_ns), threads, spans or [],
                         launched)


def merge(profiles: List[Profile]) -> Profile:
    """One profile of several cards, one capture each: their windows,
    busy time, kernels, op and idle seconds by name, and launches counted
    and recorded, summed. So ``busy_s / window_s`` is the cards' mean
    busy share (each weighted by its window), and the merge is complete
    only when every card's capture is."""
    if not profiles:
        raise ValueError("no profile to merge")
    ops: Dict[str, float] = defaultdict(float)
    idle: Dict[str, float] = defaultdict(float)
    for p in profiles:
        for name, s in p.op_seconds.items():
            ops[name] += s
        for name, s in p.idle_by_label.items():
            idle[name] += s
    return Profile(
        window_s=sum(p.window_s for p in profiles),
        busy_s=sum(p.busy_s for p in profiles),
        kernels=sum(p.kernels for p in profiles), op_seconds=dict(ops),
        idle_by_label=dict(idle),
        note="; ".join(f"card {i}: {p.note}" for i, p in enumerate(profiles)),
        launched=sum(p.launched for p in profiles),
        recorded=sum(p.recorded for p in profiles),
        cards_complete=all(p.complete for p in profiles))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce_events(events: list, clock_ns: List[int], threads: Dict[int, str],
                  spans: list, launched: Optional[Dict[str, int]] = None
                  ) -> Profile:
    """Reduce a Chrome-trace event list (microsecond ``ts``/``dur``).
    ``launched`` is the program's count of launches over the window by
    kernel function name, held against the kernels recorded."""
    def host_marks(name):
        return sorted(e["ts"] for e in events
                      if e.get("ph") == "X" and e.get("name") == name
                      and e.get("cat") == "user_annotation")

    marks, edges = host_marks(_CLOCK), host_marks(_EDGE)
    if len(edges) < 2:
        raise RuntimeError("the capture lost its window markers")
    lo, hi = edges[0], edges[-1]
    # trace microseconds -> host perf_counter nanoseconds
    offset = None
    if len(marks) == len(clock_ns) and marks:
        diffs = sorted(m * 1e3 - c for m, c in zip(marks, clock_ns))
        offset = diffs[len(diffs) // 2]
    launch_tid: Dict[int, int] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime",
                                                   "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_tid[corr] = e.get("tid")
    tids = defaultdict(int)
    for t in launch_tid.values():
        tids[t] += 1
    ops, kernels = [], 0
    seconds: Dict[str, float] = defaultdict(float)
    nexts: List[Tuple[float, Optional[int]]] = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], lo), min(e["ts"] + e.get("dur", 0.0), hi)
        if b <= a:
            continue
        name = e.get("name", "?")
        ops.append((name, a / 1e6, (b - a) / 1e6))
        seconds[name] += (b - a) / 1e6
        kernels += e.get("cat") == "kernel"
        corr = (e.get("args") or {}).get("correlation")
        nexts.append((a, launch_tid.get(corr)))
    busy = _union([(s * 1e6, (s + d) * 1e6) for _, s, d in ops])
    busy_us = sum(b - a for a, b in busy)
    # Idle gaps and the thread that ended each.
    nexts.sort(key=lambda x: x[0])
    starts = [a for a, _ in nexts]
    idle: Dict[str, float] = defaultdict(float)
    cursor = lo
    by_thread = _spans_by_thread(spans)
    for a, b in busy + [(hi, hi)]:
        if a > cursor:
            i = bisect.bisect_left(starts, a)
            tid = nexts[i][1] if i < len(nexts) else None
            idle[_label(cursor, tid, threads, by_thread, offset)] += \
                (a - cursor) / 1e6
        cursor = max(cursor, b)
    joined = sum(1 for _, t in nexts if t is not None)
    launched = {k: n for k, n in (launched or {}).items() if n > 0}
    recorded = sum(1 for name, _, _ in ops for k in launched if k in name)
    n_launched = sum(launched.values())
    whole = "complete" if recorded >= COMPLETE * n_launched else "lossy"
    note = (f"program kernels recorded {recorded} of {n_launched} launched "
            f"({whole}); device ops {len(ops)} ({joined} joined to a launch); launch "
            f"threads {dict(sorted(tids.items(), key=lambda kv: -kv[1])[:4])}"
            f"; known threads {threads}; clock offset "
            f"{'found' if offset is not None else 'missing'}")
    return Profile(window_s=(hi - lo) / 1e6, busy_s=busy_us / 1e6,
                   kernels=kernels, op_seconds=dict(seconds),
                   idle_by_label=dict(idle), note=note,
                   launched=n_launched, recorded=recorded)


def _spans_by_thread(spans: list) -> Dict[str, tuple]:
    """Per thread name: the spans sorted by start, and their starts."""
    out: Dict[str, list] = defaultdict(list)
    for name, thread, t0, dur in spans:
        if dur >= 0:
            out[thread].append((t0, t0 + dur, name))
    return {t: (sorted(v), [a for a, _, _ in sorted(v)])
            for t, v in out.items()}


def _label(at_us: float, tid: Optional[int], threads: Dict[int, str],
           by_thread: Dict[str, tuple], offset: Optional[float]) -> str:
    """``<thread>: <innermost span open at at_us>``: among the spans that
    began before the instant, the latest-begun that is still open (the
    thread's spans nest)."""
    thread = threads.get(tid) if tid is not None else None
    if thread is None:
        return "host: no launch"
    if offset is None or thread not in by_thread:
        return f"{thread}: no span"
    at = at_us * 1e3 - offset
    spans, starts = by_thread[thread]
    i = bisect.bisect_right(starts, at)
    for a, b, name in reversed(spans[max(0, i - 64):i]):
        if b > at:
            return f"{thread}: {name}"
    return f"{thread}: no span"
