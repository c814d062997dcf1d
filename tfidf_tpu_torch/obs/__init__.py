"""Observability (port of ``tfidf_tpu/obs``): the span tracer and the
event log with its flight recorder.

* :mod:`~tfidf_tpu_torch.obs.tracer` — thread-safe, near-zero-overhead-
  when-disabled span tracer recording to a ring buffer and exporting
  Chrome trace-event JSON (one ``tid`` lane per thread). Armed by
  ``--trace out.json`` on the CLI subcommands or ``TFIDF_TPU_TRACE``.
  ``device_span`` also opens an NVTX range while CUDA is initialised;
  ``device_op_table`` aggregates a torch.profiler capture's device ops
  (``tfidf_tpu_torch/tools/trace_capture.py``).
* :mod:`~tfidf_tpu_torch.obs.log` — rate-limited structured event log +
  flight recorder: a bounded ring of leveled events and last-N request
  digests, dumped atomically as JSONL.

* :mod:`~tfidf_tpu_torch.obs.registry` — counter/gauge/histogram
  registry with Prometheus text exposition and JSON snapshot (the
  serving metrics live on one).
* :mod:`~tfidf_tpu_torch.obs.health` — the watchdog deriving ``ok |
  degraded | unhealthy`` from heartbeats and windowed rates, feeding
  back into serve admission; :mod:`~tfidf_tpu_torch.obs.slo` — SLO burn
  gauges.
* :mod:`~tfidf_tpu_torch.obs.devmon` — CUDA memory gauges, census and
  watermarks, and the build watchdog.
* :mod:`~tfidf_tpu_torch.obs.costmodel` — the card's peaks and each
  ingest stage's bytes (stdlib only): byte-stamped spans export achieved
  GB/s.
* :mod:`~tfidf_tpu_torch.obs.reqtrace` / :mod:`~tfidf_tpu_torch.obs.
  disttrace` — request ids and fleet trace contexts.

The registry, health, devmon and SLO members load lazily
(``obs.MetricsRegistry``, ``obs.HealthMonitor``, ...), as in the JAX
package.
"""

from tfidf_tpu_torch.obs.log import (EventLog, configure_flight, dump_flight,
                                     flight_path, get_log, log_event,
                                     record_digest, set_log)
from tfidf_tpu_torch.obs.tracer import (SpanHandle, Tracer, begin, configure,
                                        device_op_table, device_span,
                                        enabled, end, export, get_tracer,
                                        instant, load_chrome_trace,
                                        name_thread, set_export_meta,
                                        set_tracer, span, span_totals,
                                        spans_by_thread, steps, trace_path)

__all__ = [
    "Tracer", "SpanHandle", "configure", "enabled", "export",
    "get_tracer", "set_tracer", "span", "device_span", "begin", "end",
    "instant", "steps", "name_thread", "span_totals", "trace_path",
    "set_export_meta", "load_chrome_trace", "spans_by_thread",
    "device_op_table",
    "EventLog", "get_log", "set_log", "log_event", "record_digest",
    "configure_flight", "flight_path", "dump_flight",
    # lazy (obs.registry / obs.health / obs.devmon / obs.slo):
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "HealthMonitor", "HealthThresholds", "HealthStatus",
    "DeviceMonitor", "CompileWatch", "SloTracker",
]


def __getattr__(name):  # PEP 562: the serving-side members load on demand
    if name in ("MetricsRegistry", "Counter", "Gauge", "Histogram",
                "DEFAULT_BUCKETS"):
        from tfidf_tpu_torch.obs import registry
        return getattr(registry, name)
    if name in ("HealthMonitor", "HealthThresholds", "HealthStatus"):
        from tfidf_tpu_torch.obs import health
        return getattr(health, name)
    if name in ("DeviceMonitor", "CompileWatch"):
        from tfidf_tpu_torch.obs import devmon
        return getattr(devmon, name)
    if name == "SloTracker":
        from tfidf_tpu_torch.obs import slo
        return slo.SloTracker
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
