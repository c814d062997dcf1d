"""SLO burn gauges: windowed latency-objective compliance + burn rates
(port of ``tfidf_tpu/obs/slo.py``; stdlib only, the JAX package's code).

The objective is "``target`` fraction of requests complete within
``objective_ms``" (``TFIDF_TPU_SLO_MS`` / ``TFIDF_TPU_SLO_TARGET``, CLI
``--slo-ms`` / ``--slo-target``); the error budget is ``1 - target``,
and the burn rate over a window is::

    burn = (bad requests / total requests in window) / (1 - target)

The tracker keeps two windows (fast ~1 min, slow ~10 min by default)
over per-second buckets, publishes ``serve_slo_fast_burn_milli`` /
``serve_slo_slow_burn_milli`` / ``serve_slo_compliance_milli``, and
exposes :meth:`SloTracker.health_signal`: a fast burn past
``fast_burn_degraded`` (with enough samples) is a DEGRADED reason, so a
server blowing its latency objective sheds at the gate.

Thread-safe; the clock is injectable for tests.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional, Tuple

__all__ = ["SloTracker"]


class SloTracker:
    """Windowed latency-SLO compliance + fast/slow burn rates.

    Args:
      objective_ms: the latency objective (a request slower than this
        is "bad").
      target: fraction of requests that must meet the objective
        (0.99 = a 1% error budget).
      fast_window_s / slow_window_s: the two burn windows (fast = the
        paging signal, slow = the trend).
      fast_burn_degraded: fast-window burn rate at/past which
        :meth:`health_signal` reports a degraded reason.
      min_count: fewest fast-window requests before the signal may
        degrade — one slow request in an idle minute is not an
        incident.
      registry: optional :class:`~tfidf_tpu_torch.obs.registry.
        MetricsRegistry` for the three gauges.
      clock: monotonic-seconds source (test seam).
    """

    def __init__(self, objective_ms: float, target: float = 0.99,
                 fast_window_s: float = 60.0,
                 slow_window_s: float = 600.0,
                 fast_burn_degraded: float = 2.0,
                 min_count: int = 10,
                 registry=None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if objective_ms <= 0:
            raise ValueError("objective_ms must be positive")
        if not 0.0 < target < 1.0:
            raise ValueError("target must be in (0, 1)")
        if not 0 < fast_window_s <= slow_window_s:
            raise ValueError("need 0 < fast_window_s <= slow_window_s")
        if fast_burn_degraded <= 0:
            raise ValueError("fast_burn_degraded must be positive")
        self.objective_ms = objective_ms
        self.target = target
        self.fast_window_s = fast_window_s
        self.slow_window_s = slow_window_s
        self.fast_burn_degraded = fast_burn_degraded
        self.min_count = min_count
        self._clock = clock
        self._lock = threading.Lock()
        # Per-second buckets [sec, good, bad], trimmed to slow_window.
        self._buckets: deque = deque()
        self._good_total = 0
        self._bad_total = 0
        self._g_fast = self._g_slow = self._g_comp = None
        if registry is not None:
            self._g_fast = registry.gauge(
                "serve_slo_fast_burn_milli",
                "SLO error-budget burn rate over the fast window, "
                "in 1/1000 (1000 = sustainable)")
            self._g_slow = registry.gauge(
                "serve_slo_slow_burn_milli",
                "SLO error-budget burn rate over the slow window, "
                "in 1/1000")
            self._g_comp = registry.gauge(
                "serve_slo_compliance_milli",
                "fraction of slow-window requests inside the latency "
                "objective, in 1/1000")

    # --- recording ---
    def record(self, latency_s: float) -> bool:
        """Fold one completed request in; returns True when it met the
        objective."""
        ok = latency_s * 1e3 <= self.objective_ms
        sec = int(self._clock())
        with self._lock:
            if self._buckets and self._buckets[-1][0] == sec:
                b = self._buckets[-1]
            else:
                b = [sec, 0, 0]
                self._buckets.append(b)
            if ok:
                b[1] += 1
                self._good_total += 1
            else:
                b[2] += 1
                self._bad_total += 1
            self._trim(sec)
        return ok

    def _trim(self, now_sec: int) -> None:
        floor = now_sec - self.slow_window_s
        while self._buckets and self._buckets[0][0] < floor:
            self._buckets.popleft()

    # --- reading ---
    def _window(self, window_s: float,
                now: Optional[float] = None) -> Tuple[int, int]:
        """(good, bad) over the trailing window."""
        now_sec = int(self._clock() if now is None else now)
        floor = now_sec - window_s
        good = bad = 0
        with self._lock:
            self._trim(now_sec)
            for sec, g, b in self._buckets:
                if sec >= floor:
                    good += g
                    bad += b
        return good, bad

    def burn_rate(self, window_s: float) -> float:
        """Error-budget burn multiple over the window (0.0 when the
        window saw no traffic — an idle service burns nothing)."""
        good, bad = self._window(window_s)
        total = good + bad
        if not total:
            return 0.0
        return (bad / total) / (1.0 - self.target)

    def compliance(self, window_s: Optional[float] = None) -> float:
        """Fraction of windowed requests inside the objective (1.0
        when idle — no traffic is no violation)."""
        good, bad = self._window(window_s or self.slow_window_s)
        total = good + bad
        return good / total if total else 1.0

    def snapshot(self) -> dict:
        """The ``metrics`` op's ``slo`` object — the "SLO snapshot"
        the serve CLI docstring promises (tests pin the keys)."""
        good, bad = self._window(self.slow_window_s)
        fast = self.burn_rate(self.fast_window_s)
        slow = self.burn_rate(self.slow_window_s)
        total = good + bad
        comp = good / total if total else 1.0
        self._publish(fast, slow, comp)
        return {
            "configured": True,
            "objective_ms": self.objective_ms,
            "target": self.target,
            "good": good,
            "total": total,
            "compliance": round(comp, 6),
            "fast_burn": round(fast, 4),
            "slow_burn": round(slow, 4),
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
        }

    def _publish(self, fast: float, slow: float, comp: float) -> None:
        if self._g_fast is not None:
            self._g_fast.set(int(fast * 1000))
            self._g_slow.set(int(slow * 1000))
            self._g_comp.set(int(comp * 1000))

    # --- health feedback ---
    def health_signal(self) -> Tuple[object, Optional[str]]:
        """:meth:`~tfidf_tpu_torch.obs.health.HealthMonitor.add_signal`
        hook: (fast burn, degraded-reason-or-None). Degrades only when
        the fast window carries at least ``min_count`` requests AND
        burns the budget at/past ``fast_burn_degraded`` — and
        recovers by itself once the fast window rolls clean."""
        good, bad = self._window(self.fast_window_s)
        total = good + bad
        fast = ((bad / total) / (1.0 - self.target)) if total else 0.0
        self._publish(fast, self.burn_rate(self.slow_window_s),
                      self.compliance())
        if total >= self.min_count and fast >= self.fast_burn_degraded:
            return round(fast, 3), (
                f"SLO fast burn {fast:.1f}x budget "
                f"({bad}/{total} over {self.objective_ms:.0f} ms in "
                f"the last {self.fast_window_s:.0f}s, target "
                f"{self.target})")
        return round(fast, 3), None
