"""Unified metrics registry: counters, gauges, histograms, one sink
(port of ``tfidf_tpu/obs/registry.py``; stdlib only, the JAX package's
code).

Product code creates named instruments once (get-or-create, so shared
components cannot collide) and every instrument renders two ways:

* :meth:`MetricsRegistry.snapshot` — the JSON form the CLI ``metrics``
  op embeds;
* :meth:`MetricsRegistry.render_prom` — Prometheus text exposition
  (``# TYPE``/``# HELP`` + samples, histogram ``le`` buckets included)
  for the ``serve`` CLI's ``metrics_prom`` op.

Instruments are individually lock-protected. Histograms reuse
:class:`~tfidf_tpu_torch.utils.timing.LatencyHistogram` (O(1) memory at
2% resolution) and expose a coarse fixed ``le`` ladder for Prometheus.
Gauges track a resettable PEAK next to the current value
(``snapshot(reset_peaks=True)``). :meth:`MetricsRegistry.export_state`
/ :meth:`MetricsRegistry.merge` carry the full instrument state across
processes, and the names, help strings and exposition format are the
JAX package's, so one scraper reads either server.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from tfidf_tpu_torch.utils.timing import LatencyHistogram

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_BUCKETS"]

# Prometheus ``le`` ladder for latency histograms: 100 µs to 10 s, the
# band online retrieval actually lives in; +Inf is appended at render.
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                   0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                   10.0)


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render bare, floats as repr."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int) or (isinstance(v, float) and v.is_integer()):
        return str(int(v))
    return repr(float(v))


class Counter:
    """Monotonically-increasing count (floats allowed — occupancy sums
    ride one too)."""

    __slots__ = ("name", "help", "_v", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n=1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._v += n

    @property
    def value(self):
        return self._v

    def prom_lines(self) -> List[str]:
        return [f"# HELP {self.name} {self.help}" if self.help else
                f"# HELP {self.name} {self.name}",
                f"# TYPE {self.name} counter",
                f"{self.name} {_fmt(self._v)}"]

    def snapshot_value(self):
        return self._v

    def merge(self, other: "Counter") -> None:
        """Fold another replica's count in (totals add)."""
        self.inc(other.value)

    def state_dict(self) -> dict:
        return {"kind": "counter", "help": self.help,
                "value": self._v}

    def load_state(self, state: dict) -> None:
        with self._lock:
            self._v = state["value"]

    def reset(self) -> None:
        with self._lock:
            self._v = 0


class Gauge:
    """Point-in-time value with a resettable high-water mark."""

    __slots__ = ("name", "help", "_v", "_peak", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._v = 0
        self._peak = 0
        self._lock = threading.Lock()

    def set(self, v) -> None:
        with self._lock:
            self._v = v
            if v > self._peak:
                self._peak = v

    def add(self, n) -> None:
        with self._lock:
            self._v += n
            if self._v > self._peak:
                self._peak = self._v

    @property
    def value(self):
        return self._v

    @property
    def peak(self):
        return self._peak

    def reset_peak(self) -> None:
        """Restart the high-water mark AT the current value — the next
        snapshot's peak reflects only what happened since this one."""
        with self._lock:
            self._peak = self._v

    def prom_lines(self) -> List[str]:
        h = self.help or self.name
        return [f"# HELP {self.name} {h}",
                f"# TYPE {self.name} gauge",
                f"{self.name} {_fmt(self._v)}",
                f"# HELP {self.name}_peak peak of {self.name} since "
                f"the last reset",
                f"# TYPE {self.name}_peak gauge",
                f"{self.name}_peak {_fmt(self._peak)}"]

    def snapshot_value(self):
        return {"value": self._v, "peak": self._peak}

    def merge(self, other: "Gauge") -> None:
        """Fold another replica's gauge in: values and peaks SUM (the
        aggregated queue depth across N replicas is the sum of theirs;
        the summed peak is an upper bound on the true peak of the sum —
        the per-replica peaks need not have coincided in time)."""
        with self._lock:
            self._v += other._v
            self._peak += other._peak
            if self._v > self._peak:
                self._peak = self._v

    def state_dict(self) -> dict:
        return {"kind": "gauge", "help": self.help,
                "value": self._v, "peak": self._peak}

    def load_state(self, state: dict) -> None:
        with self._lock:
            self._v = state["value"]
            self._peak = state["peak"]

    def reset(self) -> None:
        with self._lock:
            self._v = 0
            self._peak = 0


class Histogram:
    """Latency distribution: a locked :class:`LatencyHistogram` plus a
    fixed ``le`` ladder for Prometheus exposition."""

    __slots__ = ("name", "help", "_h", "_lock", "buckets", "_geometry")

    def __init__(self, name: str, help: str = "",
                 buckets=DEFAULT_BUCKETS, lo: float = 1e-6,
                 hi: float = 1e3, resolution: float = 0.02,
                 exemplars: bool = False):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        # Kept so a registry merge can create a compatible twin.
        self._geometry = {"lo": lo, "hi": hi, "resolution": resolution,
                          "exemplars": exemplars}
        self._h = LatencyHistogram(lo=lo, hi=hi, resolution=resolution,
                                   exemplars=exemplars)
        self._lock = threading.Lock()

    def observe(self, seconds: float,
                exemplar: Optional[str] = None) -> None:
        with self._lock:
            self._h.record(seconds, exemplar=exemplar)

    @property
    def count(self) -> int:
        return self._h.count

    def percentile(self, p: float) -> float:
        with self._lock:
            return self._h.percentile(p)

    def prom_lines(self) -> List[str]:
        h = self.help or self.name
        with self._lock:
            cum = self._h.cumulative(list(self.buckets))
            count, total = self._h.count, self._h.sum_seconds
            exemplars = self._h.exemplars()
        # OpenMetrics exemplar exposition: each ``le`` bucket line may
        # carry `# {rid="..."} value` naming the LAST request id that
        # landed under that bound — "p99 got worse" links straight to
        # one replayable trace (tools/doctor.py --request RID). An
        # exemplar attaches to the smallest ladder bound that covers
        # it, the bucket it is an example OF.
        by_le = {}
        for secs, rid in exemplars:
            for le in self.buckets:
                if secs <= le:
                    by_le[le] = (rid, secs)
                    break
            else:
                by_le[float("inf")] = (rid, secs)
        lines = [f"# HELP {self.name} {h}",
                 f"# TYPE {self.name} histogram"]
        for le, c in zip(self.buckets, cum):
            line = f'{self.name}_bucket{{le="{_fmt(le)}"}} {c}'
            if le in by_le:
                rid, secs = by_le[le]
                line += f' # {{rid="{rid}"}} {repr(float(secs))}'
            lines.append(line)
        inf_line = f'{self.name}_bucket{{le="+Inf"}} {count}'
        if float("inf") in by_le:
            rid, secs = by_le[float("inf")]
            inf_line += f' # {{rid="{rid}"}} {repr(float(secs))}'
        lines.append(inf_line)
        lines.append(f"{self.name}_sum {repr(float(total))}")
        lines.append(f"{self.name}_count {count}")
        return lines

    def snapshot_value(self):
        with self._lock:
            out = self._h.as_dict()
            exemplars = self._h.exemplars()
        if exemplars:
            out["exemplars"] = [{"rid": rid, "value": round(secs, 6)}
                                for secs, rid in exemplars]
        return out

    def merge(self, other: "Histogram") -> None:
        """Fold another replica's distribution in
        (:meth:`LatencyHistogram.merge` — identical geometry required,
        bucket counts add, count/sum/min/max exact; exemplars ride
        along per bucket)."""
        with self._lock, other._lock:
            self._h.merge(other._h)

    def state_dict(self) -> dict:
        with self._lock:
            return {"kind": "histogram", "help": self.help,
                    "buckets": list(self.buckets),
                    "state": self._h.state_dict()}

    def load_state(self, state: dict) -> None:
        with self._lock:
            self._h = LatencyHistogram.from_state(state["state"])

    def reset(self) -> None:
        with self._lock:
            self._h.reset()


class MetricsRegistry:
    """Named instruments behind one get-or-create map.

    Creation takes the registry lock; mutation takes only the
    instrument's own. Re-requesting a name returns the SAME instrument
    (shared components converge on one counter) — asking for an
    existing name as a different kind raises.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: "Dict[str, object]" = {}

    def _get(self, name: str, kind, factory):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = factory()
                self._instruments[name] = inst
            elif not isinstance(inst, kind):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {kind.__name__}")
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, lambda: Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, lambda: Gauge(name, help))

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS, **kw) -> Histogram:
        return self._get(name, Histogram,
                         lambda: Histogram(name, help, buckets, **kw))

    def get(self, name: str):
        return self._instruments.get(name)

    def snapshot(self, reset_peaks: bool = False) -> dict:
        """JSON-serializable view of every instrument, keyed by name.
        ``reset_peaks=True`` restarts every gauge's high-water mark at
        its current value AFTER reading — peaks become per-snapshot-
        window, the semantics a scraped dashboard expects."""
        with self._lock:
            items = list(self._instruments.items())
        out = {}
        for name, inst in items:
            out[name] = inst.snapshot_value()
            if reset_peaks and isinstance(inst, Gauge):
                inst.reset_peak()
        return out

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold another registry's instruments into this one by name —
        the per-replica aggregation ROADMAP item 5 needs (one front
        merging N worker registries into a fleet view) and what lets
        the perf gate pool multi-run samples. Counters add, gauges sum
        values and peaks, histograms merge bucket-wise; instruments
        missing here are created as same-kind twins first. A name
        registered as a DIFFERENT kind on the two sides raises (same
        contract as get-or-create). Returns ``self``."""
        with other._lock:
            items = list(other._instruments.items())
        for name, inst in items:
            if isinstance(inst, Counter):
                self.counter(name, inst.help).merge(inst)
            elif isinstance(inst, Gauge):
                self.gauge(name, inst.help).merge(inst)
            elif isinstance(inst, Histogram):
                self.histogram(name, inst.help, inst.buckets,
                               **inst._geometry).merge(inst)
        return self

    def export_state(self) -> dict:
        """Wire-format state of every instrument, keyed by name — the
        ``obs_export`` bundle's ``registry`` object. Unlike
        :meth:`snapshot` (lossy percentiles), this carries full
        histogram bucket state + exemplars, so a receiver can
        :meth:`import_state` an equivalent registry and :meth:`merge`
        it — the cross-process federation transport
        ``tools/obs_agg.py`` rides."""
        with self._lock:
            items = list(self._instruments.items())
        return {name: inst.state_dict() for name, inst in items}

    @classmethod
    def import_state(cls, state: dict) -> "MetricsRegistry":
        """Rebuild a registry from :meth:`export_state` output (e.g.
        parsed from another process's ``obs_export`` bundle)."""
        reg = cls()
        for name, s in state.items():
            kind = s.get("kind")
            if kind == "counter":
                reg.counter(name, s.get("help", "")).load_state(s)
            elif kind == "gauge":
                reg.gauge(name, s.get("help", "")).load_state(s)
            elif kind == "histogram":
                inner = s["state"]
                h = reg.histogram(
                    name, s.get("help", ""), s["buckets"],
                    lo=inner["lo"], hi=inner["hi"],
                    resolution=inner["resolution"],
                    exemplars="exemplars" in inner)
                h.load_state(s)
            else:
                raise ValueError(
                    f"unknown instrument kind {kind!r} for {name!r}")
        return reg

    def render_prom(self) -> str:
        """Prometheus text exposition format 0.0.4 of every
        instrument (ends with a newline, as scrapers expect)."""
        with self._lock:
            items = sorted(self._instruments.items())
        lines: List[str] = []
        for _name, inst in items:
            lines.extend(inst.prom_lines())
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            items = list(self._instruments.values())
        for inst in items:
            inst.reset()
