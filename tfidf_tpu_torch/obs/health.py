"""Health surface: the watchdog that turns telemetry into a verdict
(port of ``tfidf_tpu/obs/health.py``; stdlib only, the JAX package's
code).

A :class:`HealthMonitor` folds worker liveness heartbeats and windowed
SLO rates into one typed status:

* ``ok`` — all signals inside thresholds;
* ``degraded`` — queue-depth saturation, shed rate, or deadline-miss
  rate past its threshold (or a registered signal's reason: memory
  pressure, an open breaker, recompiles, SLO burn); the admission bound
  SHRINKS (``admission_bound``) so the backlog drains instead of
  compounding;
* ``unhealthy`` — a worker with pending work has not heartbeat within
  ``stall_after_s``: the pipeline is wedged, readiness goes false.

Heartbeats come from the worker threads themselves (the serve batcher
through an explicit callback, other workers through the module-level
:func:`beat` hook, a no-op ``is None`` test unless a monitor is
installed). Rates come from successive
:class:`~tfidf_tpu_torch.serve.metrics.ServeMetrics` snapshots.

Exposure: ``healthz``/``readyz`` ops on the serve CLI, registry gauges
(``serve_health_state`` 0/1/2, ``serve_admission_bound``, per-signal
check gauges), and an optional background thread (``period_s``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

from tfidf_tpu_torch.obs import log as obs_log

__all__ = ["HealthThresholds", "HealthStatus", "HealthMonitor",
           "beat", "set_monitor", "get_monitor",
           "OK", "DEGRADED", "UNHEALTHY"]

OK, DEGRADED, UNHEALTHY = "ok", "degraded", "unhealthy"
_STATE_NO = {OK: 0, DEGRADED: 1, UNHEALTHY: 2}


@dataclasses.dataclass(frozen=True)
class HealthThresholds:
    """Degradation thresholds; defaults are the measured-sane knee for
    the bench serving shapes (docs/OBSERVABILITY.md)."""

    queue_saturation_degraded: float = 0.8   # inflight / queue_depth
    shed_rate_degraded: float = 0.05         # sheds / (requests+sheds)
    deadline_miss_rate_degraded: float = 0.05
    stall_after_s: float = 1.0               # busy worker, no beat
    degraded_admission_factor: float = 0.5   # bound shrink while !ok

    def __post_init__(self):
        if not 0 < self.queue_saturation_degraded <= 1:
            raise ValueError("queue_saturation_degraded must be in (0, 1]")
        if self.stall_after_s <= 0:
            raise ValueError("stall_after_s must be positive")
        if not 0 < self.degraded_admission_factor <= 1:
            raise ValueError("degraded_admission_factor must be in (0, 1]")


@dataclasses.dataclass
class HealthStatus:
    """One evaluation's verdict: the typed state, why, and the raw
    check values the verdict derived from (the ``healthz`` payload)."""

    state: str
    reasons: List[str]
    checks: Dict[str, object]

    @property
    def ok(self) -> bool:
        return self.state == OK

    def as_dict(self) -> dict:
        return {"status": self.state, "reasons": list(self.reasons),
                "checks": dict(self.checks)}


class _Worker:
    __slots__ = ("name", "busy_fn", "last_beat", "beats")

    def __init__(self, name: str, busy_fn=None):
        self.name = name
        self.busy_fn = busy_fn
        self.last_beat = time.monotonic()
        self.beats = 0


class HealthMonitor:
    """Derives ``ok | degraded | unhealthy`` from heartbeats + metrics.

    Args:
      snapshot_fn: zero-arg callable returning the ``ServeMetrics``
        snapshot dict (``requests``, ``shed``, ``queue`` keys); rates
        are windowed over successive calls. None = liveness-only.
      queue_bound: the configured admission bound (queries) saturation
        is measured against. None disables the saturation check.
      thresholds: :class:`HealthThresholds`.
      period_s: background watchdog cadence for :meth:`start`; also the
        default rate window. The monitor works without the thread —
        :meth:`evaluate` is on-demand (the ``healthz`` op calls it).
      registry: optional :class:`~tfidf_tpu_torch.obs.registry.
        MetricsRegistry` to publish the health gauges on.
    """

    def __init__(self, snapshot_fn: Optional[Callable[[], dict]] = None,
                 queue_bound: Optional[int] = None,
                 thresholds: Optional[HealthThresholds] = None,
                 period_s: float = 0.25,
                 registry=None) -> None:
        if period_s <= 0:
            raise ValueError("period_s must be positive")
        self.thresholds = thresholds or HealthThresholds()
        self.period_s = period_s
        self._snapshot_fn = snapshot_fn
        self._queue_bound = queue_bound
        self._workers: Dict[str, _Worker] = {}
        self._signals: Dict[str, Callable] = {}
        self._lock = threading.Lock()
        self._eval_lock = threading.Lock()  # healthz op vs watchdog
        self._status = HealthStatus(OK, [], {})
        self._prev: Optional[tuple] = None   # (t, requests, over, dead)
        self._rates = {"shed_rate": 0.0, "deadline_miss_rate": 0.0}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._g_state = self._g_bound = self._g_sat = self._g_shed = None
        if registry is not None:
            self._g_state = registry.gauge(
                "serve_health_state",
                "derived health: 0=ok, 1=degraded, 2=unhealthy")
            self._g_bound = registry.gauge(
                "serve_admission_bound",
                "effective admission bound (shrinks while degraded)")
            self._g_sat = registry.gauge(
                "serve_queue_saturation_milli",
                "queue depth / bound, in 1/1000")
            self._g_shed = registry.gauge(
                "serve_shed_rate_window_milli",
                "windowed shed rate, in 1/1000")

    # --- heartbeats ---
    def register(self, name: str, busy_fn: Optional[Callable[[], bool]]
                 = None) -> None:
        """Track a worker thread. ``busy_fn`` answers "does this worker
        have pending work right now?" — stall detection only arms for
        busy workers (an idle batcher legitimately never beats)."""
        with self._lock:
            w = self._workers.get(name)
            if w is None:
                self._workers[name] = _Worker(name, busy_fn)
            elif busy_fn is not None:
                w.busy_fn = busy_fn

    def heartbeat(self, name: str) -> None:
        w = self._workers.get(name)
        if w is None:
            self.register(name)
            w = self._workers[name]
        w.last_beat = time.monotonic()
        w.beats += 1

    # --- pluggable signals ---
    def add_signal(self, name: str,
                   fn: Callable[[], tuple]) -> None:
        """Register an external degradation signal: ``fn()`` returns
        ``(value, reason_or_None)``; the value lands in the status
        checks under ``name`` and a non-None reason marks the server
        ``degraded`` (never ``unhealthy`` — only a stalled worker is
        a wedge). How the device monitor's memory pressure and the
        compile watchdog's recompile window reach admission control
        without the health core knowing either exists."""
        with self._lock:
            self._signals[name] = fn

    def remove_signal(self, name: str) -> None:
        with self._lock:
            self._signals.pop(name, None)

    # --- evaluation ---
    def evaluate(self, now: Optional[float] = None) -> HealthStatus:
        """One watchdog pass: read heartbeat ages + a metrics snapshot,
        derive the typed status, publish gauges. Thread-safe; callable
        on demand (the ``healthz`` op) or by the background thread."""
        with self._eval_lock:
            return self._evaluate(
                time.monotonic() if now is None else now)

    def _evaluate(self, now: float) -> HealthStatus:
        reasons: List[str] = []
        checks: Dict[str, object] = {}
        thr = self.thresholds

        workers: Dict[str, dict] = {}
        stalled = []
        with self._lock:
            items = list(self._workers.values())
        for w in items:
            busy = bool(w.busy_fn()) if w.busy_fn is not None else False
            age = now - w.last_beat
            is_stalled = busy and age > thr.stall_after_s
            workers[w.name] = {"age_s": round(age, 3), "busy": busy,
                               "beats": w.beats, "stalled": is_stalled}
            if is_stalled:
                stalled.append(w.name)
                reasons.append(
                    f"worker {w.name!r} busy but silent for "
                    f"{age:.2f}s (> stall_after_s={thr.stall_after_s})")
        checks["workers"] = workers

        snap = self._snapshot_fn() if self._snapshot_fn else None
        saturation = 0.0
        if snap is not None and self._queue_bound:
            saturation = snap["queue"]["depth"] / self._queue_bound
            checks["queue_saturation"] = round(saturation, 4)
            if saturation >= thr.queue_saturation_degraded:
                reasons.append(
                    f"queue saturation {saturation:.2f} >= "
                    f"{thr.queue_saturation_degraded}")
        if snap is not None:
            served = snap["requests"]
            over = snap["shed"]["overload"]
            dead = snap["shed"]["deadline"]
            if self._prev is not None:
                pt, ps, po, pd = self._prev
                d_served = served - ps
                d_over, d_dead = over - po, dead - pd
                d_total = d_served + d_over + d_dead
                if now > pt and d_total > 0:
                    self._rates = {
                        "shed_rate": (d_over + d_dead) / d_total,
                        "deadline_miss_rate": d_dead / d_total,
                    }
                elif d_total == 0:
                    # No traffic in the window: rates decay to clean.
                    self._rates = {"shed_rate": 0.0,
                                   "deadline_miss_rate": 0.0}
            self._prev = (now, served, over, dead)
            checks.update({k: round(v, 4)
                           for k, v in self._rates.items()})
            if self._rates["shed_rate"] >= thr.shed_rate_degraded:
                reasons.append(
                    f"shed rate {self._rates['shed_rate']:.3f} >= "
                    f"{thr.shed_rate_degraded}")
            if (self._rates["deadline_miss_rate"]
                    >= thr.deadline_miss_rate_degraded):
                reasons.append(
                    f"deadline miss rate "
                    f"{self._rates['deadline_miss_rate']:.3f} >= "
                    f"{thr.deadline_miss_rate_degraded}")

        with self._lock:
            signals = list(self._signals.items())
        for name, fn in signals:
            try:
                value, reason = fn()
            except Exception:   # a broken signal must not wedge health
                continue
            if value is not None:
                checks[name] = (round(value, 4)
                                if isinstance(value, float) else value)
            if reason:
                reasons.append(reason)

        state = UNHEALTHY if stalled else (DEGRADED if reasons else OK)
        status = HealthStatus(state, reasons, checks)
        prev_state = self._status.state
        self._status = status
        if state != prev_state:
            obs_log.log_event(
                "warning" if state != OK else "info",
                "health_state_change",
                msg=f"health: {prev_state} -> {state}"
                    + (f" ({'; '.join(reasons)})" if reasons else ""),
                fr=prev_state, to=state)
        if self._g_state is not None:
            self._g_state.set(_STATE_NO[state])
            if self._queue_bound:
                self._g_bound.set(self.admission_bound(self._queue_bound))
            self._g_sat.set(int(saturation * 1000))
            self._g_shed.set(int(self._rates["shed_rate"] * 1000))
        return status

    def status(self) -> HealthStatus:
        """The LAST evaluated status (no re-evaluation — the watchdog
        thread or an explicit :meth:`evaluate` keeps it fresh)."""
        return self._status

    def admission_bound(self, configured: int) -> int:
        """The effective admission bound: ``configured`` while ok,
        shrunk by ``degraded_admission_factor`` while degraded or
        unhealthy — backpressure instead of falling over (never below
        1, so the server keeps making progress and can recover)."""
        if self._status.state == OK:
            return configured
        return max(1, int(configured
                          * self.thresholds.degraded_admission_factor))

    # --- background watchdog ---
    def start(self) -> "HealthMonitor":
        """Start the watchdog thread (idempotent): one
        :meth:`evaluate` per ``period_s`` — the detection latency
        bound (a stall or saturation shows up within one period)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def run():
            while not self._stop.wait(self.period_s):
                self.evaluate()

        self._thread = threading.Thread(
            target=run, daemon=True, name="tfidf-health-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None


# --- module-level hook ----------------------------------------------
#
# Ingest worker threads beat through here so one installed monitor
# sees the WHOLE process (serve batcher + any reindex's pack/drain
# workers) without plumbing a monitor through every constructor.
# Disabled cost: one global load + None test, tracer-style.

_monitor: Optional[HealthMonitor] = None


def set_monitor(monitor: Optional[HealthMonitor]) -> None:
    global _monitor
    _monitor = monitor


def get_monitor() -> Optional[HealthMonitor]:
    return _monitor


def beat(name: str) -> None:
    m = _monitor
    if m is not None:
        m.heartbeat(name)
