"""Supervised background compaction (port of
``tfidf_tpu/index/compactor.py``; no device code).

The compactor is a worker on a cadence: its crashes are contained by a
bounded restart budget (each one a ``worker_restart`` flight event,
``worker="compactor"``), and past the budget it declares itself dead
LOUDLY instead of silently leaving segments to pile up. A crash
mid-merge is harmless by construction: ``SegmentedIndex.compact``
installs nothing until after the ``swap`` fault seam, so the retry
starts from exactly the pre-crash state.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from tfidf_tpu_torch.obs import log as obs_log

__all__ = ["Compactor"]


class Compactor:
    """Periodic compaction driver over a tick callable.

    Args:
      tick: zero-arg callable doing one threshold-checked compaction
        pass (e.g. ``index.compact``, or a server's compact-and-install;
        a no-op below threshold).
      period_s: polling cadence.
      restart_budget: crashes tolerated before the compactor declares
        itself dead (``0`` = die on the first crash).
    """

    def __init__(self, tick: Callable[[], Optional[dict]],
                 period_s: float = 0.5,
                 restart_budget: int = 3) -> None:
        if period_s <= 0:
            raise ValueError("period_s must be positive")
        if restart_budget < 0:
            raise ValueError("restart_budget must be >= 0")
        self._tick = tick
        self.period_s = period_s
        self.restart_budget = restart_budget
        self._lock = threading.Lock()
        self._restarts = 0
        self._dead = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def restarts(self) -> int:
        with self._lock:
            return self._restarts

    @property
    def dead(self) -> bool:
        with self._lock:
            return self._dead

    def start(self) -> "Compactor":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="tfidf-compactor")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self._tick()
            except Exception as e:  # noqa: BLE001 — supervision point:
                # the crash is the evidence; the budget bounds it.
                with self._lock:
                    self._restarts += 1
                    n = self._restarts
                    dead = n > self.restart_budget
                    self._dead = dead
                obs_log.log_event(
                    "error" if dead else "warning", "worker_restart",
                    msg=f"compactor crashed ({e!r}); "
                        + ("restart budget exhausted — compactor dead"
                           if dead else
                           f"restart {n}/{self.restart_budget}"),
                    worker="compactor", error=repr(e), restarts=n)
                if dead:
                    return

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None
