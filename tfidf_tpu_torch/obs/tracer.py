"""Span tracer: one timeline from submit to drain, exported as Chrome
trace-event JSON (port of ``tfidf_tpu/obs/tracer.py``).

Named spans on every participating thread, one ``pid`` (the host
process) and one ``tid`` lane per thread (``main``, ``packer``,
``drainer``, ...), which Perfetto or ``chrome://tracing`` opens
directly. The event schema is the JAX package's, so the same tools read
both packages' traces.

Design constraints, in priority order:

* **Near-zero overhead when disabled.** Product code calls the
  module-level :func:`span`/:func:`begin`/:func:`end` unconditionally;
  with no tracer configured they cost one global load, one ``is None``
  test and (for ``span``) a shared no-op context manager. No locks, no
  allocation.
* **Thread-safe when enabled.** Events append to a bounded ring buffer
  (``collections.deque(maxlen=...)`` — appends are atomic under the
  GIL, so the hot path takes no lock; only tid assignment and export
  do). When the ring overflows, the OLDEST spans drop.
* **Cross-thread spans.** ``with span(...)`` covers the same-thread
  case; :func:`begin`/:func:`end` pair across threads. The event lands
  on the lane of the thread that BEGAN it.
* **Device correlation.** :func:`device_span` additionally opens a
  ``torch.profiler.record_function`` range named ``<name> <id>`` (the
  span's ``batch`` or ``chunk`` arg, when it has one), so a concurrent
  torch.profiler capture holds the span on its own clock and kineto
  puts it on the device lane beside the ops it launched; and, while
  CUDA is initialised, an NVTX range of the span's name for Nsight. On
  the CPU no NVTX call is made.
* **Garbage collection.** While a tracer is armed (:func:`configure`,
  :func:`set_tracer`) one ``gc.callbacks`` hook records each full
  (generation 2) collection as a ``gc_full`` span on the lane of every
  thread still alive: the collector holds the interpreter lock, so a
  thread that runs Python stalls through it. A thread inside a call
  that released the lock (a CUDA synchronisation, a native file read)
  runs on; its lane shows the stall all the same. Younger generations
  record nothing. Disarming removes the hook.

Wire-up: ``--trace out.json`` on the CLI subcommands, or the
``TFIDF_TPU_TRACE`` env var (path), both through :func:`configure`;
ring capacity via ``TFIDF_TPU_TRACE_CAP`` (spans, default 2^16).
"""

from __future__ import annotations

import gc
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from tfidf_tpu_torch.obs.costmodel import span_gbps

__all__ = [
    "Tracer", "SpanHandle", "configure", "enabled", "export",
    "get_tracer", "set_tracer", "span", "begin", "end", "instant",
    "device_span", "name_thread", "span_totals", "trace_path",
    "set_export_meta", "load_chrome_trace", "device_op_table",
    "spans_by_thread", "steps",
]

_DEFAULT_CAP = 1 << 16


class _NullSpan:
    """The shared disabled-path context manager. Stateless, so one
    instance serves every caller; explicit 3-arg ``__exit__`` keeps it
    the cheapest pure-Python ``with`` target."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, et, ev, tb):
        return False


_NULL = _NullSpan()


class SpanHandle:
    """Open span returned by :meth:`Tracer.begin` — carries the start
    stamp, the beginning thread's lane, and the args dict that
    :meth:`Tracer.end` may extend (e.g. the request outcome, known
    only at resolution time)."""

    __slots__ = ("name", "t0", "tid", "args")

    def __init__(self, name: str, t0: int, tid: int,
                 args: Optional[Dict[str, Any]]):
        self.name = name
        self.t0 = t0
        self.tid = tid
        self.args = args


class _Span:
    """Same-thread ``with`` span (one allocation per enabled span)."""

    __slots__ = ("_tracer", "_name", "_args", "_t0", "_tid")

    def __init__(self, tracer: "Tracer", name: str,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._tid = self._tracer._tid()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, et, ev, tb):
        t = self._tracer
        t._events.append((self._name, self._tid, self._t0,
                          time.perf_counter_ns() - self._t0, self._args))
        return False


class _DeviceSpan:
    """Host span + a ``record_function`` range (and, while CUDA is
    initialised, an NVTX range) under one name, so the host lane and a
    device capture carry the same marker. A CPU run makes no NVTX call.
    """

    __slots__ = ("_span", "_nvtx", "_name", "_label", "_range")

    def __init__(self, tracer: "Tracer", name: str,
                 args: Optional[Dict[str, Any]]):
        self._span = _Span(tracer, name, args or None)
        self._name = name
        ident = args.get("batch", args.get("chunk")) if args else None
        self._label = name if ident is None else f"{name} {ident}"

    def __enter__(self):
        self._span.__enter__()
        import torch
        self._nvtx = torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self._name)
        self._range = torch.profiler.record_function(self._label)
        self._range.__enter__()
        return self

    def __exit__(self, et, ev, tb):
        self._range.__exit__(et, ev, tb)
        if self._nvtx:
            import torch
            torch.cuda.nvtx.range_pop()
        return self._span.__exit__(et, ev, tb)


class Tracer:
    """Thread-safe span recorder with a bounded ring buffer.

    Events are ``(name, tid, t0_ns, dur_ns, args)`` tuples relative to
    the tracer's construction instant; :meth:`chrome_events` converts
    to Chrome trace-event dicts (µs timestamps) and :meth:`export`
    writes the ``{"traceEvents": [...]}`` JSON Perfetto loads.
    """

    def __init__(self, capacity: int = _DEFAULT_CAP):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        self._t0 = time.perf_counter_ns()
        self._lock = threading.Lock()
        self._next_tid = 0
        self._names: Dict[int, str] = {}     # tid -> thread name
        # tid -> its thread, until a full collection finds it dead
        self._threads: Dict[int, threading.Thread] = {}
        self._labels: Dict[int, str] = {}    # tid -> explicit lane label
        self._local = threading.local()
        # Fleet-trace export metadata (round 23): process identity and
        # the clock-offset estimate tools/trace_merge.py aligns lanes
        # with. Written by set_export_meta, embedded under the
        # "disttrace" key of the exported doc — timestamps themselves
        # are NEVER rewritten (docs/OBSERVABILITY.md "fleet tracing").
        self.meta: Dict[str, Any] = {}
        self._gc_t0: Optional[int] = None   # an open full collection

    # --- recording ---
    def _tid(self) -> int:
        """Lane id of the calling thread (cached thread-locally; the
        lock is taken once per thread's lifetime). Lanes are NOT keyed
        on ``thread.ident`` — the OS reuses idents of dead threads
        (e.g. the pass-B packer after the pass-A packer exits), and a
        reused ident must not splice two threads onto one lane."""
        try:
            return self._local.tid
        except AttributeError:
            pass
        th = threading.current_thread()
        with self._lock:
            tid = self._next_tid
            self._next_tid += 1
            name = th.name
            if name == "MainThread":
                name = "main"
            self._names[tid] = name
            self._threads[tid] = th
        self._local.tid = tid
        return tid

    def name_thread(self, label: str) -> None:
        """Give the calling thread's lane an explicit label (``packer``,
        ``drainer``, ``batcher``...). Idempotent and cheap enough to
        call from a worker's per-item job."""
        tid = self._tid()
        if self._labels.get(tid) != label:
            with self._lock:
                self._labels[tid] = label

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args or None)

    def device_span(self, name: str, **args) -> _DeviceSpan:
        return _DeviceSpan(self, name, args or None)

    def begin(self, name: str, **args) -> SpanHandle:
        return SpanHandle(name, time.perf_counter_ns(), self._tid(),
                          args or None)

    def end(self, handle: SpanHandle, **args) -> None:
        dur = time.perf_counter_ns() - handle.t0
        merged = handle.args
        if args:
            merged = dict(merged or ()); merged.update(args)
        self._events.append((handle.name, handle.tid, handle.t0, dur,
                             merged))

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker on the calling thread's lane."""
        self._events.append((name, self._tid(),
                             time.perf_counter_ns(), -1, args or None))

    def steps(self, names: Tuple[str, ...], stamps: Tuple[int, ...]) -> None:
        """Consecutive spans on the calling thread's lane: ``names[i]``
        from ``stamps[i]`` to ``stamps[i + 1]`` (``perf_counter_ns``).
        For a hot loop's steps: no span object, no args, one clock read
        a step."""
        tid = self._tid()
        for name, t0, t1 in zip(names, stamps, stamps[1:]):
            self._events.append((name, tid, t0, t1 - t0, None))

    def span_on_live_lanes(self, name: str, t0: int, **args) -> None:
        """One span from ``t0`` (``perf_counter_ns``) to now on the lane
        of every thread still alive, for a stall no Python thread
        escapes; a dead thread's lane is dropped from the set for good.
        Takes no lock: the garbage collector's hook calls it, and a
        collection can start while this thread holds the tracer's
        lock."""
        dur = time.perf_counter_ns() - t0
        for tid, th in list(self._threads.items()):
            if th.is_alive():
                self._events.append((name, tid, t0, dur, args or None))
            else:
                self._threads.pop(tid, None)

    def _on_gc(self, phase: str, info: Dict[str, int]) -> None:
        if info["generation"] != 2:
            return
        if phase == "start":
            self._gc_t0 = time.perf_counter_ns()
        elif self._gc_t0 is not None:
            t0, self._gc_t0 = self._gc_t0, None
            self.span_on_live_lanes("gc_full", t0,
                                    collected=info["collected"],
                                    uncollectable=info["uncollectable"])

    # --- reading ---
    def events(self) -> List[Tuple]:
        """Snapshot of the raw ring (name, tid, t0_ns, dur_ns, args)."""
        return list(self._events)

    def span_totals(self) -> Dict[str, float]:
        """Total seconds per span name — the tracer-side twin of
        ``PhaseTimer.as_dict`` (bench cross-check; instants excluded)."""
        out: Dict[str, float] = {}
        for name, _tid, _t0, dur, _args in list(self._events):
            if dur >= 0:
                out[name] = out.get(name, 0.0) + dur / 1e9
        return out

    def thread_label(self, tid: int) -> str:
        return self._labels.get(tid) or self._names.get(tid, f"t{tid}")

    def chrome_events(self, pid: int = 1) -> List[dict]:
        """Chrome trace-event dicts: ``M`` metadata naming the process
        and each thread lane, then one ``X`` (complete) event per span
        (``ts``/``dur`` in microseconds) and ``i`` events for instants.
        """
        with self._lock:
            labels = {tid: self.thread_label(tid) for tid in self._names}
        events: List[dict] = [{
            "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": "tfidf_tpu_torch host"},
        }]
        for tid in sorted(labels):
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": labels[tid]}})
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_sort_index",
                           "args": {"sort_index": tid}})
        for name, tid, t0, dur, args in list(self._events):
            ev = {"ph": "X" if dur >= 0 else "i", "pid": pid, "tid": tid,
                  "name": name, "ts": (t0 - self._t0) / 1e3}
            if dur >= 0:
                ev["dur"] = dur / 1e3
            else:
                ev["s"] = "t"  # instant scope: thread
            if args:
                # Cost-annotated spans: a span stamped with the bytes it
                # moved exports its achieved bandwidth
                # (costmodel.span_gbps), so the Perfetto timeline reads
                # roofline fractions directly. Degenerate durations
                # export no gb_s (json.dump would emit bare Infinity,
                # which is not JSON). The ring's args dict is shared
                # with the recording thread — copy, never mutate.
                ev["args"] = args
                gbps = span_gbps(ev) if dur > 0 else None
                if gbps is not None:
                    ev["args"] = {**args, "gb_s": round(gbps, 4)}
            events.append(ev)
        return events

    def set_export_meta(self, **kv: Any) -> None:
        """Merge fleet-trace metadata into the export doc (process
        identity, clock offset — see module ``set_export_meta``)."""
        self.meta.update(kv)

    def export_meta(self) -> Dict[str, Any]:
        """The per-process ``disttrace`` metadata block: identity +
        the tracer's epoch (``t0_ns``, the perf_counter_ns instant
        Chrome ``ts`` values are relative to) + whatever
        :meth:`set_export_meta` recorded (clock offset/uncertainty)."""
        return {"process": self.meta.get("process", "host"),
                "os_pid": os.getpid(), "t0_ns": self._t0, **self.meta}

    def export(self, path: str) -> str:
        """Write the Chrome trace JSON; returns ``path``. Load it in
        Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.
        The doc carries a ``disttrace`` metadata key (Perfetto ignores
        unknown top-level keys) so ``tools/trace_merge.py`` can align
        this process's lanes against a peer's."""
        doc = {"traceEvents": self.chrome_events(),
               "displayTimeUnit": "ms",
               "disttrace": self.export_meta()}
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path

    def clear(self) -> None:
        self._events.clear()


# --- module-level global tracer -------------------------------------
#
# Product code traces through THESE functions so the disabled path is
# one global load + None test. ``_tracer is None`` == tracing off.

_tracer: Optional[Tracer] = None
_path: Optional[str] = None


def configure(path: Optional[str] = None,
              capacity: Optional[int] = None) -> Optional[str]:
    """Arm the global tracer. ``path`` is where :func:`export` will
    write (``None`` falls back to ``TFIDF_TPU_TRACE``; empty/absent
    leaves tracing OFF). Idempotent: re-configuring with the same or
    no path keeps the live tracer and its recorded spans — the entry
    points call this the way they call ``apply_compile_cache``."""
    global _path
    resolved = path or os.environ.get("TFIDF_TPU_TRACE")
    if not resolved:
        return _path
    if _tracer is not None and resolved == _path:
        return _path
    if capacity is None:
        capacity = int(os.environ.get("TFIDF_TPU_TRACE_CAP",
                                      str(_DEFAULT_CAP)))
    _path = resolved
    _arm(Tracer(capacity))
    return _path


def _gc_hook(phase: str, info: Dict[str, int]) -> None:
    """The one ``gc.callbacks`` entry, present while a tracer is armed."""
    t = _tracer
    if t is not None:
        t._on_gc(phase, info)


def _arm(tracer: Optional[Tracer]) -> None:
    global _tracer
    _tracer = tracer
    hooked = _gc_hook in gc.callbacks
    if tracer is not None and not hooked:
        gc.callbacks.append(_gc_hook)
    elif tracer is None and hooked:
        gc.callbacks.remove(_gc_hook)


def enabled() -> bool:
    return _tracer is not None


def get_tracer() -> Optional[Tracer]:
    return _tracer


def set_tracer(tracer: Optional[Tracer],
               path: Optional[str] = None) -> None:
    """Install (or, with ``None``, disarm) the global tracer — the
    test seam, and how embedders route spans into their own sink."""
    global _path
    _arm(tracer)
    _path = path


def trace_path() -> Optional[str]:
    """The armed export path, or None when tracing is off."""
    return _path if _tracer is not None else None


def export(path: Optional[str] = None) -> Optional[str]:
    """Write the global tracer's trace to ``path`` (default: the
    configured path). Returns the written path, or None when tracing
    is off — callers can report it unconditionally."""
    t = _tracer
    if t is None:
        return None
    resolved = path or _path
    if not resolved:
        return None
    return t.export(resolved)


def span(name: str, **args):
    """Context manager recording one span on the calling thread's lane
    (no-op when tracing is off)."""
    t = _tracer
    if t is None:
        return _NULL
    return _Span(t, name, args or None)


def device_span(name: str, **args):
    """Like :func:`span`, additionally wrapped in a ``record_function``
    range ``<name> <batch or chunk id>`` and an NVTX range of the same
    name (only while CUDA is initialised), so a concurrent device
    capture carries the marker."""
    t = _tracer
    if t is None:
        return _NULL
    return _DeviceSpan(t, name, args or None)


def begin(name: str, **args) -> Optional[SpanHandle]:
    """Open a cross-thread span; pair with :func:`end`. Returns None
    when tracing is off (``end(None)`` is a no-op)."""
    t = _tracer
    if t is None:
        return None
    return t.begin(name, **args)


def end(handle: Optional[SpanHandle], **args) -> None:
    t = _tracer
    if t is None or handle is None:
        return
    t.end(handle, **args)


def instant(name: str, **args) -> None:
    t = _tracer
    if t is not None:
        t.instant(name, **args)


def steps(names: Tuple[str, ...], stamps: Tuple[int, ...]) -> None:
    """Record a hot loop's consecutive steps (:meth:`Tracer.steps`);
    the caller reads the clock only while :func:`enabled`."""
    t = _tracer
    if t is not None:
        t.steps(names, stamps)


def name_thread(label: str) -> None:
    t = _tracer
    if t is not None:
        t.name_thread(label)


def span_totals() -> Dict[str, float]:
    t = _tracer
    return t.span_totals() if t is not None else {}


def set_export_meta(**kv) -> None:
    """Record fleet-trace metadata (``process`` identity, ``clock``
    offset estimate) on the global tracer for the next export; no-op
    when tracing is off."""
    t = _tracer
    if t is not None:
        t.set_export_meta(**kv)


# --- Chrome-trace reading (trace_capture, chip_smoke and the tests) ----

def load_chrome_trace(path: str) -> List[dict]:
    """Load a Chrome trace-event file (``.json`` or ``.json.gz``) and
    return its ``traceEvents`` list."""
    if path.endswith(".gz"):
        import gzip
        with gzip.open(path, "rt") as f:
            doc = json.load(f)
    else:
        with open(path) as f:
            doc = json.load(f)
    if isinstance(doc, list):  # bare event-array form is also legal
        return doc
    return doc.get("traceEvents", [])


def spans_by_thread(events: Iterable[dict]) -> Dict[str, List[dict]]:
    """Group ``X`` events by their lane's ``thread_name`` metadata
    (falling back to ``pid/tid``)."""
    names: Dict[Tuple[Any, Any], str] = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            names[(e.get("pid"), e.get("tid"))] = \
                e.get("args", {}).get("name", "")
    out: Dict[str, List[dict]] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        key = (e.get("pid"), e.get("tid"))
        label = names.get(key) or f"{key[0]}/{key[1]}"
        out.setdefault(label, []).append(e)
    return out


# Kineto's categories of device activity in a torch.profiler Chrome
# export: kernels, copies and memsets (its "gpu_user_annotation" ranges
# lie on the same lanes but are markers, not device work).
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_op_table(events: Iterable[dict], top: int = 25):
    """Aggregate device-lane op durations of a profiler capture:
    ``(rows, total_us)`` where rows are ``(name, total_us, calls)``
    sorted by total. Reads a torch.profiler Chrome export
    (``prof.export_chrome_trace``), whose device events carry a kineto
    device category (``cat`` ``kernel``, ``gpu_memcpy``, ``gpu_memset``)
    on pids labelled ``GPU n`` (torch 2.11 names them by the process,
    ``python3``, and labels them with ``process_labels``), and a
    ``jax.profiler`` capture, whose device lanes are pids with a
    ``process_name`` mentioning ``TPU``, ``/device`` or ``Device``."""
    import collections
    proc_names: Dict[Any, str] = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") in ("process_name",
                                                     "process_labels"):
            a = e.get("args") or {}
            proc_names[e.get("pid")] = (proc_names.get(e.get("pid"), "")
                                        + " " + str(a.get("name", "")
                                                    or a.get("labels", "")))
    dev_pids = {p for p, n in proc_names.items()
                if "TPU" in n or "GPU" in n or "/device" in n.lower()
                or "Device" in n}
    agg: Dict[str, float] = collections.defaultdict(float)
    cnt: Dict[str, int] = collections.defaultdict(int)
    total = 0.0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat not in _DEVICE_CATS and (e.get("pid") not in dev_pids
                                        or cat == "gpu_user_annotation"):
            continue
        name = e.get("name", "?")
        dur = float(e.get("dur", 0.0))  # microseconds
        agg[name] += dur
        cnt[name] += 1
        total += dur
    rows = [(name, us, cnt[name])
            for name, us in sorted(agg.items(), key=lambda kv: -kv[1])]
    return rows[:top], total
