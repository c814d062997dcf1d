"""Supervised execution: retry, circuit breaking, poison isolation (port
of ``tfidf_tpu/serve/supervisor.py``; the JAX package's code).

* :class:`RetryPolicy` + :meth:`SupervisedDispatch.run` — bounded retry
  with jittered exponential backoff for **transient** dispatch failures
  (typed :class:`~tfidf_tpu_torch.faults.TransientFault`, plus anything
  the caller's classifier deems retryable). Each retry is a
  ``dispatch_retry`` span nested in the batch's ``batched`` span, a
  flight event and a ``serve_dispatch_retries_total`` count.
* :class:`CircuitBreaker` — trips OPEN after N consecutive dispatch
  failures and reports a degraded reason through
  :meth:`CircuitBreaker.health_signal`, which shrinks the admission
  bound; after ``cooldown_s`` it is HALF-OPEN and the next success
  closes it.
* :meth:`SupervisedDispatch.run_batch` — a batch failing past its retry
  budget is **bisected** until the failure is pinned to single queries:
  those fail with the typed :class:`PoisonQuery` (and are quarantined by
  the server); every innocent co-batched query returns the rows a clean
  dispatch would have produced.

:class:`QuarantineList` is the bounded set of normalized poison-query
keys the server consults at admission.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from tfidf_tpu_torch import faults, obs
from tfidf_tpu_torch.obs import log as obs_log
from tfidf_tpu_torch.serve.batcher import PoisonQuery  # noqa: F401 re-export

__all__ = ["PoisonQuery", "RetryPolicy", "CircuitBreaker",
           "QuarantineList", "SupervisedDispatch"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with jittered exponential backoff.

    ``max_attempts`` counts dispatch attempts INCLUDING the first
    (1 = no retry). Backoff between attempts is
    ``base * mult^(n-1)`` capped at ``cap``, jittered +-``jitter``
    fraction from a ``random.Random(seed)`` — deterministic per
    policy instance, so chaos runs replay."""

    max_attempts: int = 3
    backoff_ms: float = 10.0
    backoff_mult: float = 2.0
    max_backoff_ms: float = 1000.0
    jitter: float = 0.5
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.backoff_ms < 0 or self.max_backoff_ms < 0:
            raise ValueError("backoff must be >= 0")


class CircuitBreaker:
    """Consecutive-failure breaker with a cooldown half-open state.

    ``closed`` (healthy) -> ``open`` after ``threshold`` consecutive
    failures -> ``half_open`` once ``cooldown_s`` elapses -> the next
    success closes it (a failure re-opens and restarts the cooldown).
    Thread-safe; publishes ``serve_breaker_open`` (0/1) and
    ``serve_breaker_trips_total`` when given a registry, and exposes
    the :meth:`health_signal` hook that turns an open breaker into a
    degraded admission bound."""

    def __init__(self, threshold: int = 5, cooldown_s: float = 1.0,
                 registry=None) -> None:
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        if cooldown_s <= 0:
            raise ValueError("cooldown_s must be positive")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._lock = threading.Lock()
        self._consecutive = 0
        self._open_since: Optional[float] = None
        self._g_open = self._c_trips = None
        if registry is not None:
            self._g_open = registry.gauge(
                "serve_breaker_open",
                "dispatch circuit breaker: 1 while open/half-open")
            self._c_trips = registry.counter(
                "serve_breaker_trips_total",
                "circuit breaker trips (N consecutive dispatch "
                "failures)")

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked(time.monotonic())

    def _state_locked(self, now: float) -> str:
        if self._open_since is None:
            return "closed"
        if now - self._open_since >= self.cooldown_s:
            return "half_open"
        return "open"

    @property
    def consecutive_failures(self) -> int:
        return self._consecutive

    def record_failure(self) -> bool:
        """Count one dispatch failure; returns True when this one
        tripped the breaker open."""
        now = time.monotonic()
        with self._lock:
            self._consecutive += 1
            if self._open_since is not None:
                # A half-open trial failed: restart the cooldown.
                self._open_since = now
                return False
            if self._consecutive < self.threshold:
                return False
            self._open_since = now
        if self._c_trips is not None:
            self._c_trips.inc()
        if self._g_open is not None:
            self._g_open.set(1)
        obs_log.log_event(
            "error", "breaker_trip",
            msg=f"circuit breaker OPEN after {self._consecutive} "
                f"consecutive dispatch failures "
                f"(cooldown {self.cooldown_s}s)",
            consecutive=self._consecutive)
        return True

    def record_success(self) -> None:
        with self._lock:
            was_open = self._open_since is not None
            self._consecutive = 0
            self._open_since = None
        if was_open:
            if self._g_open is not None:
                self._g_open.set(0)
            obs_log.log_event("info", "breaker_close",
                              msg="circuit breaker closed "
                                  "(dispatch succeeded)")

    def cooldown_remaining(self) -> float:
        """Seconds until the open breaker goes half-open (0 when
        closed or already half-open)."""
        with self._lock:
            if self._open_since is None:
                return 0.0
            return max(0.0, self.cooldown_s
                       - (time.monotonic() - self._open_since))

    def health_signal(self) -> Tuple[object, Optional[str]]:
        """:meth:`HealthMonitor.add_signal` hook: (state, reason).
        Any non-closed state is a degraded reason — the admission
        bound shrinks while the breaker is open, which is how a
        failing device sheds load at the gate instead of queueing
        doomed work."""
        state = self.state
        if state == "closed":
            return state, None
        return state, (f"dispatch circuit breaker {state} "
                       f"({self._consecutive} consecutive failures)")


class QuarantineList:
    """Bounded set of quarantined (poison) query keys.

    Keys are normalized-query cache keys (tokenization + k-independent
    — one bad query is bad at every k), capped FIFO so a pathological
    traffic pattern cannot grow it unboundedly."""

    def __init__(self, cap: int = 1024, registry=None) -> None:
        if cap < 1:
            raise ValueError("cap must be >= 1")
        self.cap = cap
        self._lock = threading.Lock()
        self._keys: dict = {}            # key -> repr (insertion order)
        self._c_total = self._g_size = None
        if registry is not None:
            self._c_total = registry.counter(
                "serve_quarantined_total",
                "queries quarantined as poison")
            self._g_size = registry.gauge(
                "serve_quarantine_size",
                "currently quarantined query keys")

    def add(self, key, query_repr: str = "") -> bool:
        """Quarantine one key; returns False when already present."""
        with self._lock:
            if key in self._keys:
                return False
            if len(self._keys) >= self.cap:
                oldest = next(iter(self._keys))
                del self._keys[oldest]
            self._keys[key] = query_repr
            size = len(self._keys)
        if self._c_total is not None:
            self._c_total.inc()
        if self._g_size is not None:
            self._g_size.set(size)
        obs_log.log_event(
            "error", "query_quarantined",
            msg=f"query quarantined as poison ({size} total); "
                f"subsequent submissions fail fast with PoisonQuery",
            size=size)
        return True

    def contains(self, key) -> bool:
        with self._lock:
            return key in self._keys

    def __len__(self) -> int:
        with self._lock:
            return len(self._keys)

    def snapshot(self) -> List[str]:
        with self._lock:
            return [r if r else repr(k) for k, r in self._keys.items()]

    def clear(self) -> None:
        with self._lock:
            self._keys.clear()
        if self._g_size is not None:
            self._g_size.set(0)


def _match_text(queries: Sequence) -> str:
    """The device_dispatch seam's match surface: the batch's queries,
    NUL-joined (a fault rule's ``match=`` selects poison queries by
    substring)."""
    return "\x00".join(
        q.decode("utf-8", "replace") if isinstance(q, (bytes, bytearray))
        else str(q) for q in queries)


class SupervisedDispatch:
    """Wraps the batch search fn with retry, breaker and bisection.

    Args:
      search_fn: ``(queries, k, group) -> (vals, ids)`` — the same
        callable the bare :class:`~tfidf_tpu_torch.serve.batcher.
        MicroBatcher` would call.
      policy: :class:`RetryPolicy` for transient failures.
      breaker: optional :class:`CircuitBreaker` recording every
        attempt outcome.
      metrics: optional :class:`~tfidf_tpu_torch.serve.metrics.ServeMetrics`
        for the retry counter.
      retryable: predicate deciding whether an exception is transient
        (default: :class:`~tfidf_tpu_torch.faults.TransientFault` only —
        real kernel errors are not blindly retried; widen it when a
        backend has known-transient error types).
    """

    def __init__(self, search_fn: Callable, policy: RetryPolicy,
                 breaker: Optional[CircuitBreaker] = None,
                 metrics=None,
                 retryable: Optional[Callable[[BaseException], bool]]
                 = None) -> None:
        self._search_fn = search_fn
        self.policy = policy
        self.breaker = breaker
        self._metrics = metrics
        self._retryable = retryable or (
            lambda e: isinstance(e, faults.TransientFault))
        self._rng = random.Random(policy.seed)

    # --- one dispatch with retry ---
    def run(self, queries: Sequence, k: int, group,
            batch_id: Optional[int] = None,
            rids: Optional[Sequence[str]] = None,
            first: Optional[Callable] = None
            ) -> Tuple[np.ndarray, np.ndarray]:
        """Dispatch with bounded retry on transient failures; raises
        the final error when the budget is exhausted or the failure is
        not retryable. The ``device_dispatch`` fault seam fires inside
        each attempt, so injected transients exercise this exact
        loop. ``rids`` (the batch's request ids) stamp the
        ``dispatch_retry`` spans and flight events so a retry's
        backoff is attributable to the requests that paid it.

        ``first`` is the pipelined drain stage's seam: a
        zero-arg callable standing in for the FIRST attempt only —
        materializing a batch whose dispatch was already issued
        asynchronously (or re-raising its captured dispatch-stage
        error). The fault seam still fires inside that attempt, so
        kill/poison plans strike at drain time, exactly where a real
        deferred device failure surfaces; every RETRY re-dispatches
        synchronously through ``search_fn``. Attempt accounting,
        breaker story and retry counts are identical to the
        unpipelined path."""
        attempt = 0
        text = _match_text(queries)
        while True:
            attempt += 1
            if self.breaker is not None:
                # An open breaker pauses the attempt until half-open:
                # queued batches become the recovery probes instead of
                # hammering a failing device.
                wait = self.breaker.cooldown_remaining()
                if wait > 0:
                    time.sleep(wait)
            try:
                faults.fire("device_dispatch", text=text,
                            queries=len(queries), batch=batch_id)
                if first is not None and attempt == 1:
                    out = first()
                else:
                    out = self._search_fn(queries, k, group)
            except BaseException as e:  # noqa: BLE001 — classified below
                if self.breaker is not None:
                    self.breaker.record_failure()
                if (not self._retryable(e)
                        or attempt >= self.policy.max_attempts):
                    raise
                delay = faults.backoff_s(
                    attempt, self.policy.backoff_ms,
                    self.policy.backoff_mult,
                    self.policy.max_backoff_ms, self.policy.jitter,
                    self._rng)
                if self._metrics is not None:
                    self._metrics.count("dispatch_retries")
                extra = {"rids": list(rids)} if rids else {}
                obs_log.log_event(
                    "warning", "dispatch_retry",
                    msg=f"dispatch attempt {attempt} failed "
                        f"({type(e).__name__}); retrying in "
                        f"{delay * 1e3:.1f} ms",
                    attempt=attempt, batch=batch_id,
                    error=type(e).__name__, **extra)
                with obs.span("dispatch_retry", attempt=attempt,
                              batch=batch_id, **extra):
                    time.sleep(delay)
                continue
            if self.breaker is not None:
                self.breaker.record_success()
            return out

    # --- batch-level: retry then bisect ---
    def run_batch(self, queries: Sequence, k: int, group,
                  batch_id: Optional[int] = None,
                  rids: Optional[Sequence[str]] = None,
                  first: Optional[Callable] = None
                  ) -> Tuple[Optional[np.ndarray],
                             Optional[np.ndarray], List[int]]:
        """Dispatch the whole batch; on persistent failure, bisect to
        isolate the poison queries. Returns ``(vals, ids, poison)``:
        poison is the sorted list of query indices whose dispatch
        fails alone; every other row is the bit-identical result a
        clean dispatch would have produced. ``vals``/``ids`` are None
        only when EVERY query is poison.

        Bisection engages only for NON-retryable failures: a
        transient fault that survives the whole retry budget is
        overload/weather, not a poison query — the batch fails with
        the transient error (clients back off and retry) rather than
        quarantining innocent queries. Raises too when the full batch
        fails but no subset does (a non-separable failure).

        ``first`` rides through to :meth:`run`'s first attempt only
        (the pipelined drain materialization); bisection halves always
        re-dispatch synchronously — a poison query isolated at drain
        time bisects exactly like one isolated at dispatch time."""
        try:
            vals, ids = self.run(queries, k, group, batch_id,
                                 rids=rids, first=first)
            return np.asarray(vals), np.asarray(ids), []
        except BaseException as root:  # noqa: BLE001 — bisect below
            if self._retryable(root):
                raise       # retry budget exhausted on a transient
            if len(queries) == 1:
                self._log_poison([0], batch_id, root)
                return None, None, [0]
            results: dict = {}
            poison: List[int] = []
            mid = len(queries) // 2
            self._bisect(list(range(mid)), queries, k, group,
                         batch_id, results, poison, rids)
            self._bisect(list(range(mid, len(queries))), queries, k,
                         group, batch_id, results, poison, rids)
            if not poison:
                # Every subset passed but the whole batch failed — a
                # batch-shape-dependent fault, not a poison query.
                # One last full try; its error is the batch's error.
                vals, ids = self.run(queries, k, group, batch_id,
                                     rids=rids)
                return np.asarray(vals), np.asarray(ids), []
            self._log_poison(poison, batch_id, root)
            if len(results) == 0:
                return None, None, sorted(poison)
            some_v, some_i = next(iter(results.values()))
            vals = np.zeros((len(queries),) + some_v.shape,
                            some_v.dtype)
            ids = np.full((len(queries),) + some_i.shape, -1,
                          some_i.dtype)
            for i, (v, d) in results.items():
                vals[i], ids[i] = v, d
            return vals, ids, sorted(poison)

    def _bisect(self, idxs: List[int], queries, k, group, batch_id,
                results: dict, poison: List[int],
                rids: Optional[Sequence[str]] = None) -> None:
        if not idxs:
            return
        sub = [queries[i] for i in idxs]
        try:
            vals, ids = self.run(sub, k, group, batch_id, rids=rids)
        except BaseException as e:  # noqa: BLE001 — recurse or isolate
            if self._retryable(e):
                raise   # a transient storm mid-bisect aborts cleanly
            if len(idxs) == 1:
                poison.append(idxs[0])
                return
            mid = len(idxs) // 2
            self._bisect(idxs[:mid], queries, k, group, batch_id,
                         results, poison, rids)
            self._bisect(idxs[mid:], queries, k, group, batch_id,
                         results, poison, rids)
            return
        vals, ids = np.asarray(vals), np.asarray(ids)
        for j, i in enumerate(idxs):
            results[i] = (vals[j], ids[j])

    def _log_poison(self, poison: List[int], batch_id,
                    root: BaseException) -> None:
        obs_log.log_event(
            "error", "poison_isolated",
            msg=f"bisection isolated {len(poison)} poison "
                f"quer{'y' if len(poison) == 1 else 'ies'} in batch "
                f"{batch_id} ({type(root).__name__}); innocent "
                f"co-batched queries were served",
            batch=batch_id, poison=poison, error=type(root).__name__)
