"""Observability (port of ``tfidf_tpu/obs``): the span tracer and the
event log with its flight recorder.

* :mod:`~tfidf_tpu_torch.obs.tracer` — thread-safe, near-zero-overhead-
  when-disabled span tracer recording to a ring buffer and exporting
  Chrome trace-event JSON (one ``tid`` lane per thread). Armed by
  ``--trace out.json`` on ``cli stream`` or ``TFIDF_TPU_TRACE``.
  ``device_span`` also opens an NVTX range while CUDA is initialised.
* :mod:`~tfidf_tpu_torch.obs.log` — rate-limited structured event log +
  flight recorder: a bounded ring of leveled events and last-N request
  digests, dumped atomically as JSONL.

The JAX package's registry, health, device-monitor and SLO modules
belong to the serving layer (ROADMAP A8); asking this package for one
of their members raises ``NotImplementedError`` naming that item.
"""

from tfidf_tpu_torch.obs.log import (EventLog, configure_flight, dump_flight,
                                     flight_path, get_log, log_event,
                                     record_digest, set_log)
from tfidf_tpu_torch.obs.tracer import (SpanHandle, Tracer, begin, configure,
                                        device_span, enabled, end, export,
                                        get_tracer, instant,
                                        load_chrome_trace, name_thread,
                                        set_export_meta, set_tracer, span,
                                        span_totals, spans_by_thread,
                                        trace_path)

__all__ = [
    "Tracer", "SpanHandle", "configure", "enabled", "export",
    "get_tracer", "set_tracer", "span", "device_span", "begin", "end",
    "instant", "name_thread", "span_totals", "trace_path",
    "set_export_meta", "load_chrome_trace", "spans_by_thread",
    "EventLog", "get_log", "set_log", "log_event", "record_digest",
    "configure_flight", "flight_path", "dump_flight",
]

# The JAX package's lazily loaded serving-side members (its registry,
# health, devmon and slo modules).
_SERVING_MEMBERS = ("MetricsRegistry", "Counter", "Gauge", "Histogram",
                    "DEFAULT_BUCKETS", "HealthMonitor", "HealthThresholds",
                    "HealthStatus", "DeviceMonitor", "CompileWatch",
                    "SloTracker")


def __getattr__(name):  # PEP 562
    if name in _SERVING_MEMBERS:
        raise NotImplementedError(
            f"obs.{name} (the serving layer's metrics, health, device "
            f"monitor and SLO modules) is not ported yet: ROADMAP A8")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
