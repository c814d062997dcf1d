"""Phase timing, throughput counters, profiler regions and the latency
histogram (port of ``tfidf_tpu/utils/timing.py``).

On a CUDA device each phase is timed with a pair of CUDA events on the
current stream and ends with ``torch.cuda.synchronize()``, so a phase
measures completed device work, not the enqueue, and the next phase
starts on an idle device. Without a timer nothing is recorded and no
synchronisation is added.

A phase also records as a tracer span when the span tracer is armed
(:func:`phase_or_null`): the ``--timing`` report and the ``--trace``
timeline are one measurement. On CUDA the span encloses the event pair
and its synchronisation, so both sinks close after the phase's device
work has finished.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch


class PhaseTimer:
    """Accumulates seconds per named phase::

        timer = PhaseTimer()
        TfidfPipeline(cfg, timer=timer).run(corpus)
        timer.as_dict()  # {"pack": ..., "transfer": ..., ...}
    """

    def __init__(self) -> None:
        self._acc: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        """Fold a measured duration in."""
        self._acc[name] = self._acc.get(name, 0.0) + seconds

    def seconds(self, name: str) -> float:
        return self._acc.get(name, 0.0)

    def items(self) -> List[Tuple[str, float]]:
        """``(phase, seconds)`` in first-seen order."""
        return list(self._acc.items())

    def as_dict(self) -> Dict[str, float]:
        """Seconds per phase, in first-seen order."""
        return dict(self._acc)

    def reset(self) -> None:
        self._acc.clear()

    def report(self) -> str:
        """One line a phase: milliseconds and share of the total."""
        total = sum(self._acc.values()) or 1.0
        return "\n".join(f"{n:>12}: {s * 1e3:9.1f} ms ({100 * s / total:4.1f}%)"
                         for n, s in self._acc.items())


class Throughput:
    """docs/sec counter (the north-star metric)."""

    def __init__(self) -> None:
        self._docs = 0
        self._seconds = 0.0

    @contextlib.contextmanager
    def measure(self, num_docs: int) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(num_docs, time.perf_counter() - t0)

    def record(self, num_docs: int, seconds: float) -> None:
        """Fold an externally measured run in (the document count is
        known only when the run returns, e.g. the overlapped ingest's
        discovery)."""
        self._docs += num_docs
        self._seconds += seconds

    @property
    def docs_per_sec(self) -> float:
        return self._docs / self._seconds if self._seconds else 0.0

    @property
    def docs(self) -> int:
        return self._docs


@contextlib.contextmanager
def _cuda_phase(timer: PhaseTimer, name: str,
                device: torch.device) -> Iterator[None]:
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    try:
        yield
    finally:
        end.record(stream)
        torch.cuda.synchronize(device)
        timer.add(name, start.elapsed_time(end) / 1e3)


class _TimedSpan:
    """One context, two sinks: the phase's wall-clock accumulates into
    the :class:`PhaseTimer` AND the same interval records as a tracer
    span, so ``--timing`` phase reports and ``--trace`` timelines never
    drift apart. With ``inner`` (the CUDA event pair of a timed phase on
    a card) the span encloses that context, whose exit synchronises, and
    the timer takes the events' device time instead."""

    __slots__ = ("_timer", "_name", "_sp", "_inner", "_t0")

    def __init__(self, timer, name, sp, inner=None):
        self._timer = timer
        self._name = name
        self._sp = sp
        self._inner = inner

    def __enter__(self):
        self._sp.__enter__()
        if self._inner is not None:
            self._inner.__enter__()
        elif self._timer is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        try:
            if self._inner is not None:
                self._inner.__exit__(et, ev, tb)
            elif self._timer is not None:
                self._timer.add(self._name, time.perf_counter() - self._t0)
        finally:
            self._sp.__exit__(et, ev, tb)
        return False


def phase_or_null(timer: Optional[PhaseTimer], name: str,
                  device: Optional[torch.device] = None):
    """``timer.phase(name)`` when a timer is attached, a tracer span when
    the global tracer is armed (``obs.configure``), both when both, else
    a no-op. ``device``: a CUDA device times the phase with CUDA events
    and a synchronisation (only with a timer attached).

    With neither sink armed the only cost is one enabled-check and a
    shared no-op context; no synchronisation is added.
    """
    from tfidf_tpu_torch import obs
    inner = None
    if timer is not None and device is not None and device.type == "cuda":
        inner = _cuda_phase(timer, name, device)
    if obs.enabled():
        return _TimedSpan(timer, name, obs.span(name), inner)
    if inner is not None:
        return inner
    return timer.phase(name) if timer is not None \
        else contextlib.nullcontext()


class PhaseTimedMixin:
    """Phase plumbing for pipeline classes with a ``timer`` and a
    ``device``: ``_phase(name)`` times a phase on the attached
    :class:`PhaseTimer` and records it as a tracer span when tracing is
    on (:func:`phase_or_null`)."""

    timer: Optional[PhaseTimer] = None
    device: torch.device = torch.device("cpu")

    def _phase(self, name: str):
        return phase_or_null(self.timer, name, self.device)


@contextlib.contextmanager
def trace_region(name: str, enabled: bool = True) -> Iterator[None]:
    """A named range on the profiler timelines (no-op when disabled):
    a ``torch.profiler.record_function`` range, shown by a torch.profiler
    capture, plus an NVTX range while CUDA is initialised, shown by
    Nsight Systems."""
    if not enabled:
        yield
        return
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class LatencyHistogram:
    """Geometric-bucket latency histogram with percentile queries.

    Samples land in buckets whose bounds grow by ``1 + resolution``
    per step (default 2%), so ``percentile(p)`` is accurate to the
    bucket resolution over the whole [lo, hi) range at O(1) memory —
    the shape a long-running server needs (the serving layer records
    every request into one of these; ``serve/metrics.py``). Count,
    sum, min and max are tracked exactly; out-of-range samples clamp
    into the edge buckets but still carry exact min/max.

    Not thread-safe by itself; :class:`~tfidf_tpu_torch.serve.metrics.
    ServeMetrics` serializes access under its own lock.
    """

    def __init__(self, lo: float = 1e-6, hi: float = 1e3,
                 resolution: float = 0.02,
                 exemplars: bool = False) -> None:
        if not (0 < lo < hi):
            raise ValueError("need 0 < lo < hi")
        if resolution <= 0:
            raise ValueError("resolution must be positive")
        self._lo = lo
        self._hi = hi
        self._resolution = resolution
        self._log_step = math.log1p(resolution)
        n = int(math.ceil(math.log(hi / lo) / self._log_step)) + 1
        self._counts = [0] * (n + 1)  # +1: underflow bucket at index 0
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        # Exemplars: the LAST request id to land in each
        # bucket, kept as {bucket_idx: (exemplar, seconds)} — O(live
        # buckets) memory, and what links "p99 got worse" to one
        # replayable trace (OpenMetrics exemplar exposition in
        # obs/registry.py). None = feature off (zero cost).
        self._exemplars: Optional[Dict[int, Tuple[str, float]]] = (
            {} if exemplars else None)

    def record(self, seconds: float,
               exemplar: Optional[str] = None) -> None:
        if seconds < 0:
            seconds = 0.0
        self._count += 1
        self._sum += seconds
        self._min = min(self._min, seconds)
        self._max = max(self._max, seconds)
        if seconds < self._lo:
            idx = 0
        else:
            idx = 1 + int(math.log(seconds / self._lo) / self._log_step)
            idx = min(idx, len(self._counts) - 1)
        self._counts[idx] += 1
        if self._exemplars is not None and exemplar is not None:
            self._exemplars[idx] = (exemplar, seconds)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum_seconds(self) -> float:
        """Exact sum of every recorded sample (Prometheus ``_sum``)."""
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    @property
    def min(self) -> float:
        return self._min if self._count else 0.0

    @property
    def max(self) -> float:
        return self._max if self._count else 0.0

    def percentile(self, p: float) -> float:
        """Latency at percentile ``p`` in [0, 100] (nearest-rank over
        buckets; within-bucket values report the bucket's geometric
        midpoint, clamped to the exact observed min/max)."""
        if not 0 <= p <= 100:
            raise ValueError(f"percentile {p} outside [0, 100]")
        if not self._count:
            return 0.0
        rank = max(1, int(math.ceil(p / 100.0 * self._count)))
        # The extreme ranks are tracked exactly — no bucket rounding.
        if rank <= 1:
            return self._min
        if rank >= self._count:
            return self._max
        seen = 0
        for idx, c in enumerate(self._counts):
            seen += c
            if seen >= rank:
                if idx == 0:
                    mid = self._lo / 2
                else:
                    mid = self._lo * math.exp((idx - 0.5) * self._log_step)
                return min(max(mid, self._min), self._max)
        return self._max  # unreachable: ranks are <= count

    def cumulative(self, bounds: List[float]) -> List[int]:
        """Cumulative sample counts at each upper bound — the shape a
        Prometheus histogram exposition needs (``le`` buckets). A
        sample counts toward bound ``b`` when its geometric bucket's
        upper edge is <= ``b``, so counts are monotone in ``bounds``
        and accurate to the bucket resolution; the clamped top bucket
        (and the exact total) only ever land on ``+Inf``, which the
        caller appends itself (``obs.registry``)."""
        uppers = [self._lo * math.exp(i * self._log_step)
                  for i in range(len(self._counts) - 1)]
        out = []
        for b in bounds:
            out.append(sum(c for up, c in zip(uppers, self._counts)
                           if up <= b))
        return out

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold ``other``'s samples into this histogram in place — the
        aggregation primitive per-process metrics need (N server
        processes each keep their own histogram; a scraper merges them
        into one distribution). Exact for count/sum/min/max; bucket
        counts add elementwise, so percentiles of the merge are as
        accurate as either input's bucket resolution. Requires
        identical bucket geometry (same lo/resolution/range) — merging
        across geometries would need resampling, which silently loses
        resolution, so it raises instead. Returns ``self``."""
        if (self._lo != other._lo
                or self._log_step != other._log_step
                or len(self._counts) != len(other._counts)):
            raise ValueError(
                "cannot merge LatencyHistograms with different bucket "
                f"geometry (lo {self._lo} vs {other._lo}, step "
                f"{self._log_step:.6g} vs {other._log_step:.6g}, "
                f"buckets {len(self._counts)} vs {len(other._counts)})")
        for i, c in enumerate(other._counts):
            self._counts[i] += c
        self._count += other._count
        self._sum += other._sum
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)
        # Exemplars survive aggregation: the other side's (newer, in
        # the replica-poll sense) entries win per bucket — one
        # replayable rid per bucket is the contract, not a history.
        if self._exemplars is not None and other._exemplars:
            self._exemplars.update(other._exemplars)
        return self

    def exemplars(self) -> List[Tuple[float, str]]:
        """``(seconds, rid)`` per live exemplar bucket, ascending by
        latency — empty when the feature is off."""
        if not self._exemplars:
            return []
        return sorted((secs, rid)
                      for rid, secs in self._exemplars.values())

    def state_dict(self) -> Dict:
        """Wire-format state for cross-process aggregation (the
        ``obs_export`` bundle): geometry + sparse bucket counts +
        exact count/sum/min/max + exemplars. :meth:`from_state`
        rebuilds an identical histogram, so ``merge`` federates
        replicas without sharing memory."""
        state = {
            "lo": self._lo, "hi": self._hi,
            "resolution": self._resolution,
            "n_buckets": len(self._counts),
            "counts": {str(i): c for i, c in enumerate(self._counts)
                       if c},
            "count": self._count, "sum": self._sum,
        }
        if self._count:
            state["min"] = self._min
            state["max"] = self._max
        if self._exemplars:
            state["exemplars"] = {
                str(i): [rid, secs]
                for i, (rid, secs) in self._exemplars.items()}
        return state

    @classmethod
    def from_state(cls, state: Dict) -> "LatencyHistogram":
        h = cls(lo=state["lo"], hi=state["hi"],
                resolution=state["resolution"],
                exemplars="exemplars" in state)
        if len(h._counts) != state["n_buckets"]:
            raise ValueError(
                f"histogram state geometry mismatch: rebuilt "
                f"{len(h._counts)} buckets, state carries "
                f"{state['n_buckets']}")
        for i, c in state.get("counts", {}).items():
            h._counts[int(i)] = int(c)
        h._count = int(state["count"])
        h._sum = float(state["sum"])
        if h._count:
            h._min = float(state["min"])
            h._max = float(state["max"])
        for i, (rid, secs) in state.get("exemplars", {}).items():
            h._exemplars[int(i)] = (rid, float(secs))
        return h

    def as_dict(self, ndigits: int = 6) -> Dict[str, float]:
        """JSON-artifact form: count/mean/min/max plus p50/p95/p99."""
        return {
            "count": self._count,
            "mean": round(self.mean, ndigits),
            "min": round(self.min, ndigits),
            "max": round(self.max, ndigits),
            "p50": round(self.percentile(50), ndigits),
            "p95": round(self.percentile(95), ndigits),
            "p99": round(self.percentile(99), ndigits),
        }

    def reset(self) -> None:
        self._counts = [0] * len(self._counts)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        if self._exemplars is not None:
            self._exemplars.clear()
