"""Serving metrics: latency, occupancy, shed and cache counters (port
of ``tfidf_tpu/serve/metrics.py``; the JAX package's code and names).

The counters live on a :class:`~tfidf_tpu_torch.obs.registry.
MetricsRegistry`: Prometheus text exposition
(:meth:`ServeMetrics.render_prom`, the ``serve`` CLI's ``metrics_prom``
op, request-latency histogram buckets included) and resettable gauge
peaks (``snapshot(reset_peaks=True)``). One :class:`ServeMetrics` is
shared by the server, batcher and cache; instruments are individually
locked, so any thread can read a :meth:`snapshot` while traffic flows.
"""

from __future__ import annotations

import json
from typing import Optional

from tfidf_tpu_torch.obs.registry import MetricsRegistry

_COUNTERS = {
    "requests": ("serve_requests_total", "requests resolved"),
    "queries": ("serve_queries_total", "queries resolved"),
    "batches": ("serve_batches_total", "coalesced device batches"),
    "shed_overload": ("serve_shed_overload_total",
                      "requests shed at admission (queue_depth)"),
    "shed_deadline": ("serve_shed_deadline_total",
                      "requests shed on an expired deadline"),
    "cache_hits": ("serve_cache_hits_total", "result-cache hits"),
    "cache_misses": ("serve_cache_misses_total", "result-cache misses"),
    "slow_queries": ("serve_slow_queries_total",
                     "requests over the slow-query threshold "
                     "(TFIDF_TPU_SLOW_MS)"),
}


class ServeMetrics:
    """Counters + latency histogram on one metrics registry.

    Tracked: request/query/batch counts, request latency (submit to
    resolution — a geometric-bucket histogram, O(1) memory), batch
    occupancy (real queries / padded device-batch width — the
    coalescing efficiency), admission queue depth (current + a
    resettable peak), shed counters split by cause (overload vs
    deadline), and cache hit/miss counters. :meth:`snapshot` keeps the
    exact JSON schema the round-9 artifacts pinned;
    :meth:`render_prom` is the new Prometheus face of the same data.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None) -> None:
        self.registry = registry or MetricsRegistry()
        self._counters = {
            short: self.registry.counter(name, help)
            for short, (name, help) in _COUNTERS.items()}
        self._occupancy = self.registry.counter(
            "serve_batch_occupancy_sum",
            "sum of per-batch occupancy (real/padded)")
        self._queue = self.registry.gauge(
            "serve_queue_depth", "admitted, unresolved queries")
        # exemplars=True: each latency bucket retains the LAST request
        # id that landed in it, exposed as OpenMetrics exemplars on
        # the Prometheus buckets and in the JSON snapshot — the link
        # from "p99 got worse" to one replayable trace.
        self._latency = self.registry.histogram(
            "serve_request_latency_seconds",
            "request latency, submit to resolution",
            exemplars=True)

    # Kept for callers that poke the histogram directly (the round-9
    # attribute name); the instrument's inner LatencyHistogram.
    @property
    def latency(self):
        return self._latency._h

    def count(self, name: str, n: int = 1) -> None:
        c = self._counters.get(name)
        if c is None:  # unknown names get ad-hoc registry counters
            c = self.registry.counter(f"serve_{name}_total", name)
            self._counters[name] = c
        c.inc(n)

    def observe_request(self, seconds: float, queries: int,
                        rid: Optional[str] = None) -> None:
        self._counters["requests"].inc()
        self._counters["queries"].inc(queries)
        self._latency.observe(seconds, exemplar=rid)

    def observe_batch(self, real_queries: int, padded: int) -> None:
        self._counters["batches"].inc()
        self._occupancy.inc(real_queries / max(padded, 1))

    def set_queue_depth(self, depth: int) -> None:
        self._queue.set(depth)

    def snapshot(self, reset_peaks: bool = False) -> dict:
        """JSON-serializable point-in-time view (the artifact shape
        ``tools/serve_bench.py`` embeds and the CLI ``metrics`` op
        returns). ``reset_peaks=True`` restarts the queue-depth peak
        at its current value AFTER reading, so each snapshot's peak
        covers only its own window."""
        c = {short: inst.value for short, inst in self._counters.items()}
        batches = c["batches"]
        hits, misses = c["cache_hits"], c["cache_misses"]
        lookups = hits + misses
        shed = c["shed_overload"] + c["shed_deadline"]
        occupancy = self._occupancy.value
        snap = {
            "requests": c["requests"],
            "queries": c["queries"],
            "shed": {
                "overload": c["shed_overload"],
                "deadline": c["shed_deadline"],
                "rate": round(shed / max(c["requests"] + shed, 1), 6),
            },
            "cache": {
                "hits": hits,
                "misses": misses,
                "hit_rate": round(hits / lookups, 6) if lookups else 0.0,
            },
            "batch": {
                "count": batches,
                "mean_occupancy": round(
                    occupancy / batches, 6) if batches else 0.0,
            },
            "queue": {"depth": self._queue.value,
                      "peak": self._queue.peak},
            "latency_s": self._latency.snapshot_value(),
            "slow_queries": c["slow_queries"],
        }
        if reset_peaks:
            self._queue.reset_peak()
        return snap

    def render(self) -> str:
        """Human-readable text snapshot (stderr/ops form)."""
        s = self.snapshot()
        lat = s["latency_s"]
        return "\n".join([
            f"requests={s['requests']} queries={s['queries']} "
            f"shed={s['shed']['overload']}+{s['shed']['deadline']} "
            f"(rate {s['shed']['rate']:.3f})",
            f"latency p50={lat['p50'] * 1e3:.2f}ms "
            f"p95={lat['p95'] * 1e3:.2f}ms p99={lat['p99'] * 1e3:.2f}ms "
            f"mean={lat['mean'] * 1e3:.2f}ms n={lat['count']}",
            f"batches={s['batch']['count']} "
            f"occupancy={s['batch']['mean_occupancy']:.3f} "
            f"queue depth={s['queue']['depth']} peak={s['queue']['peak']}",
            f"cache hit_rate={s['cache']['hit_rate']:.3f} "
            f"({s['cache']['hits']}/{s['cache']['hits'] + s['cache']['misses']})",
        ])

    def render_prom(self) -> str:
        """Prometheus text exposition of every serve instrument —
        request-latency ``le`` buckets, counters, queue gauge + peak.
        The ``serve`` CLI's ``metrics_prom`` op returns this."""
        return self.registry.render_prom()

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)
