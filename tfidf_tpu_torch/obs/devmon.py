"""Device-truth telemetry: device-memory accounting + build watchdog
(the port's counterpart of ``tfidf_tpu/obs/devmon.py``, rewritten for
CUDA).

* :class:`DeviceMonitor` — reads each CUDA device's allocator through
  ``torch.cuda.memory_stats(i)`` (bytes allocated now, and their peak)
  and ``torch.cuda.mem_get_info(i)`` (the card's total memory, the
  limit) into the JAX package's gauges (``hbm_bytes_in_use_d*``,
  ``hbm_peak_bytes_d*``, ``hbm_bytes_limit_d*``), emits flight-recorder
  watermark events when pressure (in use / limit) crosses
  ``TFIDF_TPU_HBM_WATERMARKS``, and exposes :meth:`health_signal` so a
  :class:`~tfidf_tpu_torch.obs.health.HealthMonitor` degrades, and
  admission sheds, before the allocator runs out. Its census attributes
  the tensors of registered OWNERS (the resident index) by storage
  identity; PyTorch has no counterpart of ``jax.live_arrays()``, so the
  rest of ``torch.cuda.memory_allocated()`` is reported as ``other`` and
  the blocks the caching allocator keeps reserved past it as
  ``allocator_cache``: the census total is the process's reserved bytes
  on the card. :meth:`DeviceMonitor.log_census` records a census as the
  ``hbm_census`` flight event ``tools/doctor.py`` reads.
  Fed a mesh-sharded index's ``shard_stats`` (:meth:`DeviceMonitor.
  register_shards`), it publishes the per-shard index bytes
  (``shard_bytes_d*``, ``shard_imbalance_milli``, the ``shard_balance``
  flight event and the snapshot's ``shards``).
  A monitor of the CPU (no CUDA device, or ``device="cpu"``) returns the
  stats the JAX package returns on its CPU backend: one device entry
  with no memory keys, pressure 0.0, no gauges.
* :class:`CompileWatch` — the JAX package's compile watchdog, with its
  class, counter names (``xla_compiles_total``,
  ``xla_compile_seconds_total``, ``xla_recompiles_after_warm``) and
  health signal kept so that one dashboard reads either server. The
  port compiles no XLA programs: its only compile site is the build of
  its native libraries (``ops/_build.py`` ``build``: the CUDA kernels
  with nvcc; ``build_host``: the host loader with g++), which reports
  every build with its wall seconds through :func:`note_build`. So in
  this package ``xla_compiles_total`` counts those builds and
  ``xla_compile_seconds_total`` their seconds, and a build after
  :meth:`CompileWatch.mark_warm` is a recompile after warm-up (the flight
  event ``xla_recompile``, which ``tools/doctor.py``'s recompile budget
  counts). :func:`note_compile` is the JAX package's call-site hook for
  a program's identity, kept for callers of either package.

One global monitor, armed like the tracer: :func:`configure` reads
``TFIDF_TPU_DEVMON`` (any non-empty value) and
``TFIDF_TPU_DEVMON_PERIOD_MS`` (default 500 ms); ``cli run`` arms it and
takes a last sample and a census at its end.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from tfidf_tpu_torch.obs import log as obs_log

__all__ = [
    "DeviceMonitor", "CompileWatch", "configure", "get_monitor",
    "set_monitor", "get_watch", "set_watch", "note_compile", "note_build",
    "DEFAULT_WATERMARKS",
]

# Pressure fractions (in use / limit) at which the monitor emits flight
# watermark events and reports a degraded health reason: the first is
# the shed-early line, the second the near-OOM alarm. Env override:
# TFIDF_TPU_HBM_WATERMARKS="0.8,0.95".
DEFAULT_WATERMARKS = (0.80, 0.95)


def _env_watermarks() -> Tuple[float, ...]:
    raw = os.environ.get("TFIDF_TPU_HBM_WATERMARKS")
    if not raw:
        return DEFAULT_WATERMARKS
    marks = tuple(sorted(float(p) for p in raw.split(",") if p.strip()))
    for m in marks:
        if not 0 < m <= 1:
            raise ValueError(
                f"TFIDF_TPU_HBM_WATERMARKS fractions must be in (0, 1], "
                f"got {m}")
    return marks or DEFAULT_WATERMARKS


def _cuda_stats(index: int) -> dict:
    """One CUDA device's allocator truth under the JAX package's keys."""
    import torch
    stats = torch.cuda.memory_stats(index)
    _, total = torch.cuda.mem_get_info(index)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(total)}


class DeviceMonitor:
    """Samples device memory truth into gauges, events and a signal.

    Args:
      registry: optional :class:`~tfidf_tpu_torch.obs.registry.
        MetricsRegistry`; per-device gauges are created lazily, only for
        the stats keys a device reports (none on the CPU).
      period_s: background sampling cadence for :meth:`start`; the
        monitor also works purely on demand (:meth:`sample`).
      watermarks: ascending pressure fractions; crossing one upward
        emits an ``hbm_watermark`` flight event (``warning`` at the
        first rung, ``error`` past it) and arms the degraded health
        reason until pressure drops back below.
      stats_fn: test seam — ``stats_fn(index) -> Optional[dict]`` with
        the keys ``bytes_in_use`` / ``peak_bytes_in_use`` /
        ``bytes_limit`` replaces the CUDA allocator read.
      device: the device served: None = every CUDA device when one is
        available, else the CPU; a CPU device (``"cpu"``) selects the
        CPU path.
    """

    def __init__(self, registry=None, period_s: Optional[float] = None,
                 watermarks: Optional[Tuple[float, ...]] = None,
                 stats_fn: Optional[Callable] = None,
                 device=None) -> None:
        if period_s is not None and period_s <= 0:
            raise ValueError("period_s must be positive (None = manual)")
        self._registry = registry
        self.period_s = period_s
        self.watermarks = tuple(sorted(watermarks if watermarks is not None
                                       else _env_watermarks()))
        self._stats_fn = stats_fn
        self._device = device
        self._owners: Dict[str, Callable] = {}
        self._lock = threading.Lock()
        self._gauges: Dict[str, object] = {}
        self._pressure = 0.0            # last sampled max fraction
        self._peak_bytes = 0            # max peak bytes seen
        self._shards_fn: Optional[Callable] = None
        self._last_shard_bytes: Optional[Tuple[int, ...]] = None
        self._armed_mark: Optional[float] = None  # highest rung crossed
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._samples = 0

    # --- owners -------------------------------------------------------
    def register_owner(self, name: str, arrays_fn: Callable) -> None:
        """Attribute device tensors to a named owner. ``arrays_fn()``
        returns the owner's live tensors (None entries are skipped).
        Re-registering a name replaces its callable — the index owner
        survives a hot swap that way."""
        with self._lock:
            self._owners[name] = arrays_fn

    def unregister_owner(self, name: str) -> None:
        with self._lock:
            self._owners.pop(name, None)

    def register_shards(self, shards_fn: Optional[Callable]) -> None:
        """Attach a mesh-shard balance feed: ``shards_fn()`` returns the
        :meth:`~tfidf_tpu_torch.parallel.serving.MeshShardedRetriever.
        shard_stats` dict (``n_shards`` / ``shard_bytes`` /
        ``imbalance``), or None while the index is not sharded. Every
        :meth:`sample` then publishes the ``shard_bytes_d*`` gauges and
        ``shard_imbalance_milli`` and logs an edge-triggered
        ``shard_balance`` flight event when the per-shard bytes change
        (only an index install moves them)."""
        with self._lock:
            self._shards_fn = shards_fn
            self._last_shard_bytes = None

    # --- sampling -----------------------------------------------------
    def _cuda_indices(self) -> List[int]:
        """The CUDA device indices this monitor reads ([] = the CPU)."""
        import torch
        dev = self._device
        if dev is not None:
            dev = torch.device(dev)
            if dev.type != "cuda":
                return []
            return [dev.index if dev.index is not None
                    else torch.cuda.current_device()]
        if self._stats_fn is None and not torch.cuda.is_available():
            return []
        n = torch.cuda.device_count() if self._stats_fn is None else 1
        return list(range(n))

    def _device_stats(self, index: int):
        if self._stats_fn is not None:
            return self._stats_fn(index)
        try:
            return _cuda_stats(index)
        except Exception:   # a device that cannot report
            return None

    def sample(self) -> dict:
        """One monitor pass: read every device's memory stats, publish
        gauges for the keys present, update pressure + watermark state.
        Returns the snapshot dict (the ``devmon`` op payload). Never
        raises on missing or partial stats — that IS the CPU path.

        Serialized under ``self._lock``: the ``devmon`` op calls this
        from a protocol thread while the background monitor samples on
        its own cadence."""
        indices = self._cuda_indices()
        with self._lock:
            shards_fn = self._shards_fn
        shard_stats = None
        if shards_fn is not None:
            try:
                shard_stats = shards_fn()
            except Exception:   # a mid-swap index must not kill sampling
                shard_stats = None
        with self._lock:
            devices = []
            pressure = 0.0
            if not indices:
                devices.append({"device": 0, "kind": "cpu",
                                "platform": "cpu"})
            for i in indices:
                stats = self._device_stats(i) or {}
                in_use = stats.get("bytes_in_use")
                peak = stats.get("peak_bytes_in_use")
                limit = stats.get("bytes_limit")
                rec = {"device": i, "kind": self._kind(i),
                       "platform": "gpu"}
                if in_use is not None:
                    rec["bytes_in_use"] = int(in_use)
                    self._gauge(f"hbm_bytes_in_use_d{i}",
                                "live HBM bytes in use").set(int(in_use))
                if peak is not None:
                    rec["peak_bytes_in_use"] = int(peak)
                    self._peak_bytes = max(self._peak_bytes, int(peak))
                    self._gauge(f"hbm_peak_bytes_d{i}",
                                "allocator peak HBM bytes").set(int(peak))
                if limit is not None:
                    rec["bytes_limit"] = int(limit)
                    self._gauge(f"hbm_bytes_limit_d{i}",
                                "HBM capacity the allocator sees"
                                ).set(int(limit))
                if in_use is not None and limit:
                    frac = in_use / limit
                    rec["pressure"] = round(frac, 4)
                    pressure = max(pressure, frac)
                devices.append(rec)
            self._pressure = pressure
            self._samples += 1
            self._watermark_check(pressure)
            snap = {"devices": devices,
                    "memory_pressure": round(pressure, 4),
                    "peak_bytes": self._peak_bytes,
                    "samples": self._samples}
        if shard_stats:
            self._publish_shards(shard_stats)
            snap["shards"] = shard_stats
        return snap

    def _publish_shards(self, stats: dict) -> None:
        """Gauges and the edge-triggered flight event of one shard-balance
        reading (under the lock: the gauge map and the edge state are
        the same cross-thread read-modify-writes :meth:`sample`
        serializes)."""
        per = stats.get("shard_bytes") or []
        imbalance = stats.get("imbalance", 1.0)
        with self._lock:
            for i, b in enumerate(per):
                self._gauge(f"shard_bytes_d{i}",
                            "index bytes resident on this docs-shard"
                            ).set(int(b))
            self._gauge("shard_imbalance_milli",
                        "max/mean per-shard index bytes, in 1/1000"
                        ).set(int(round(imbalance * 1000)))
            key = tuple(int(b) for b in per)
            changed = key != self._last_shard_bytes
            self._last_shard_bytes = key
        if changed:
            obs_log.log_event(
                "info", "shard_balance",
                msg=f"index sharded {len(per)} ways: "
                    f"{[round(b / 1e6, 2) for b in per]} MB/shard, "
                    f"imbalance {imbalance:.3f}",
                n_shards=stats.get("n_shards", len(per)),
                shard_bytes=list(key), imbalance=imbalance)

    def _kind(self, index: int) -> str:
        if self._stats_fn is not None:
            return "cuda"
        import torch
        return torch.cuda.get_device_name(index)

    def _gauge(self, name: str, help: str):
        g = self._gauges.get(name)
        if g is None:
            if self._registry is None:
                class _Null:
                    def set(self, v):
                        pass
                g = _Null()
            else:
                g = self._registry.gauge(name, help)
            self._gauges[name] = g
        return g

    def _watermark_check(self, pressure: float) -> None:
        """Edge-triggered watermark events: crossing a rung upward logs
        once (warning at the first rung, error past it) and remembers
        the rung; dropping below the lowest rung logs the recovery."""
        crossed = [m for m in self.watermarks if pressure >= m]
        highest = crossed[-1] if crossed else None
        if highest is not None and highest != self._armed_mark:
            level = ("warning" if highest == self.watermarks[0]
                     else "error")
            obs_log.log_event(
                level, "hbm_watermark",
                msg=f"HBM pressure {pressure:.2f} crossed watermark "
                    f"{highest:.2f}",
                pressure=round(pressure, 4), watermark=highest)
            self._armed_mark = highest
        elif highest is None and self._armed_mark is not None:
            obs_log.log_event(
                "info", "hbm_watermark_clear",
                msg=f"HBM pressure {pressure:.2f} back below "
                    f"{self.watermarks[0]:.2f}",
                pressure=round(pressure, 4))
            self._armed_mark = None

    # --- census -------------------------------------------------------
    def census(self, top_shapes: int = 8) -> dict:
        """Where the device memory went: each registered owner's bytes,
        from ``untyped_storage().nbytes()`` of the tensors it returns
        (a storage shared by several tensors counts once, the first
        owner to name it claims it), and the rest of
        ``torch.cuda.memory_allocated()`` as ``other``; on CUDA the
        blocks the caching allocator holds past the allocated bytes are
        ``allocator_cache`` and ``total_bytes`` is the reserved bytes
        (``torch.cuda.memory_reserved()``: what the process holds on the
        card). On the CPU there is no allocator total: ``total_bytes`` is
        the owners' sum.
        ``top_shapes`` groups the owners' tensors by (dtype, shape).
        Owner callables that raise are skipped (a swapped-out retriever
        must not break the monitor)."""
        indices = self._cuda_indices() if self._stats_fn is None else []
        with self._lock:
            owners_fns = list(self._owners.items())
        seen = set()
        owners = {}
        by_shape: Dict[Tuple, int] = {}
        claimed = 0
        for name, fn in owners_fns:
            bytes_ = n = 0
            try:
                tensors = fn() or ()
            except Exception:
                continue
            for t in tensors:
                if t is None:
                    continue
                try:
                    storage = t.untyped_storage()
                    key = (str(t.device), storage.data_ptr())
                    nb = int(storage.nbytes())
                    shape = (str(t.dtype).replace("torch.", ""),
                             tuple(t.shape))
                except Exception:
                    continue
                n += 1
                if key in seen:
                    continue
                seen.add(key)
                bytes_ += nb
                claimed += nb
                by_shape[shape] = by_shape.get(shape, 0) + nb
            owners[name] = {"bytes": bytes_, "arrays": n}
        allocated = total = claimed
        if indices:
            import torch
            allocated = sum(int(torch.cuda.memory_allocated(i))
                            for i in indices)
            total = max(allocated, sum(int(torch.cuda.memory_reserved(i))
                                       for i in indices))
        owners["other"] = {"bytes": max(0, allocated - claimed), "arrays": 0}
        if indices:
            owners["allocator_cache"] = {"bytes": total - allocated,
                                         "arrays": 0}
        shapes = sorted(by_shape.items(), key=lambda kv: -kv[1])
        return {
            "total_bytes": total,
            "allocated_bytes": allocated,
            "buffers": len(seen),
            "owners": owners,
            "top_shapes": [
                {"dtype": d, "shape": list(s), "bytes": b}
                for (d, s), b in shapes[:top_shapes]],
        }

    def log_census(self) -> dict:
        """Take a census and record it as an ``hbm_census`` flight event,
        which is how a census reaches ``tools/doctor.py`` through a
        dump."""
        c = self.census()
        obs_log.log_event(
            "info", "hbm_census",
            msg=f"hbm census: {c['total_bytes'] / 1e6:.1f} MB across "
                f"{c['buffers']} buffers",
            total_bytes=c["total_bytes"], buffers=c["buffers"],
            owners=c["owners"], top_shapes=c["top_shapes"])
        return c

    # --- signals ------------------------------------------------------
    @property
    def memory_pressure(self) -> float:
        """Last sampled max in-use/limit fraction across devices (0.0
        when no device reports memory stats)."""
        return self._pressure

    @property
    def peak_bytes(self) -> int:
        """Highest allocator peak seen across all samples and devices."""
        return self._peak_bytes

    def health_signal(self) -> Tuple[float, Optional[str]]:
        """The :meth:`HealthMonitor.add_signal` hook: (pressure,
        degraded-reason-or-None). The reason arms past the FIRST
        watermark and clears as soon as a sample sees pressure below
        it."""
        p = self._pressure
        if self.watermarks and p >= self.watermarks[0]:
            return p, (f"memory pressure {p:.2f} >= watermark "
                       f"{self.watermarks[0]:.2f}")
        return p, None

    # --- background sampling ------------------------------------------
    def start(self) -> "DeviceMonitor":
        """Start the sampling thread (idempotent; needs ``period_s``)."""
        if self.period_s is None:
            raise ValueError("DeviceMonitor(period_s=...) required "
                             "for background sampling")
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def run():
            while not self._stop.wait(self.period_s):
                try:
                    self.sample()
                except Exception as e:  # monitor must never kill serve
                    obs_log.log_event("warning", "devmon_error",
                                      msg=f"devmon sample failed: {e!r}")

        self._thread = threading.Thread(
            target=run, daemon=True, name="tfidf-devmon")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None


class CompileWatch:
    """Counts the port's native builds; flags a build after warm-up.

    Two feeds, as in the JAX package:

    * :meth:`on_backend_compile` — one build with its wall seconds
      (``ops/_build.py`` reports every nvcc and g++ build through
      :func:`note_build`);
    * :meth:`note` — the build's identity (``program="kernels"`` or
      ``"host"`` with its library path).

    :meth:`mark_warm` draws the line: a noted build after it is a
    recompile (flight event ``xla_recompile``, counter
    ``xla_recompiles_after_warm``) and :meth:`health_signal` reports a
    degraded reason for ``recent_s`` after the last one.
    """

    def __init__(self, registry=None, recent_s: float = 30.0) -> None:
        self.recent_s = recent_s
        self._lock = threading.Lock()
        self._compiles = 0
        self._compile_s = 0.0
        self._warm = False
        self._recompiles: List[dict] = []
        self._last_recompile: Optional[float] = None
        self._c_total = self._c_seconds = self._c_recompiles = None
        if registry is not None:
            self._c_total = registry.counter(
                "xla_compiles_total",
                "native library builds (nvcc kernels, g++ host loader)")
            self._c_seconds = registry.counter(
                "xla_compile_seconds_total",
                "wall seconds spent in native library builds")
            self._c_recompiles = registry.counter(
                "xla_recompiles_after_warm",
                "native library builds after mark_warm()")

    # --- feeds ---
    def on_backend_compile(self, seconds: float) -> None:
        """One build and its wall seconds."""
        with self._lock:
            self._compiles += 1
            self._compile_s += seconds
        if self._c_total is not None:
            self._c_total.inc()
            self._c_seconds.inc(seconds)

    def note(self, program: str, **fingerprint) -> None:
        """A build's identity. Before warm-up a debug breadcrumb; after,
        a recompile: flight warning + counter + the degraded-reason
        window."""
        fp = {"program": program, **fingerprint}
        with self._lock:
            warm = self._warm
            if warm:
                self._recompiles.append(fp)
                self._last_recompile = time.monotonic()
        if warm:
            if self._c_recompiles is not None:
                self._c_recompiles.inc()
            obs_log.log_event(
                "warning", "xla_recompile",
                msg=f"native build after warm-up: {fp}", **fp)
        else:
            obs_log.log_event("debug", "xla_compile", **fp)

    # --- state ---
    def mark_warm(self) -> None:
        """Declare warm-up complete: every build from here on is a
        recompile after warm-up."""
        with self._lock:
            self._warm = True
        obs_log.log_event("info", "compile_warm",
                          msg=f"compile warm-up complete "
                              f"({self._compiles} builds, "
                              f"{self._compile_s:.2f}s)",
                          compiles=self._compiles,
                          compile_s=round(self._compile_s, 3))

    @property
    def warm(self) -> bool:
        return self._warm

    @property
    def compiles(self) -> int:
        return self._compiles

    @property
    def recompile_count(self) -> int:
        """Builds noted since :meth:`mark_warm`."""
        return len(self._recompiles)

    @property
    def compile_seconds(self) -> float:
        """Wall seconds of every build counted."""
        return self._compile_s

    def recompiles_after_warm(self) -> List[dict]:
        """The fingerprints noted since :meth:`mark_warm`."""
        with self._lock:
            return list(self._recompiles)

    def health_signal(self) -> Tuple[int, Optional[str]]:
        """(recompile count after warm, degraded-reason-or-None); the
        reason stays armed for ``recent_s`` after the newest one."""
        with self._lock:
            n = len(self._recompiles)
            last = self._last_recompile
        if last is not None and time.monotonic() - last < self.recent_s:
            return n, (f"{n} native build(s) after warm-up "
                       f"(last {time.monotonic() - last:.1f}s ago)")
        return n, None


# --- module-level seams -----------------------------------------------
#
# One global monitor and one global compile watch, tracer-style: the
# build site, the CLI and the serve batcher report through them, so the
# disabled path is a global load + None test.

_monitor: Optional[DeviceMonitor] = None
_watch: Optional[CompileWatch] = None


def set_watch(watch: Optional[CompileWatch]) -> None:
    """Install (or with None disarm) the process compile watch."""
    global _watch
    _watch = watch


def get_watch() -> Optional[CompileWatch]:
    return _watch


def note_build(program: str, seconds: float, **fingerprint) -> None:
    """``ops/_build.py``'s report of one finished build: counted with
    its seconds, then noted (a recompile once the watch is warm). No-op
    unless a watch is installed."""
    w = _watch
    if w is not None:
        w.on_backend_compile(seconds)
        w.note(program, seconds=round(seconds, 3), **fingerprint)


def note_compile(program: str, **fingerprint) -> None:
    """A call site's report of a program it just compiled (the JAX
    package's hook): noted on the watch, a recompile once it is warm.
    No-op unless a watch is installed."""
    w = _watch
    if w is not None:
        w.note(program, **fingerprint)


def set_monitor(monitor: Optional[DeviceMonitor]) -> None:
    """Install (or with None disarm) the process device monitor."""
    global _monitor
    _monitor = monitor


def get_monitor() -> Optional[DeviceMonitor]:
    return _monitor


def configure(period_ms: Optional[float] = None,
              registry=None) -> Optional[DeviceMonitor]:
    """Arm the global device monitor the way ``tracer.configure`` arms
    tracing: an explicit ``period_ms`` wins, else ``TFIDF_TPU_DEVMON``
    (any non-empty value, sampling every ``TFIDF_TPU_DEVMON_PERIOD_MS``,
    default 500 ms); unset leaves device monitoring off and returns None.
    Idempotent: an armed monitor is kept. The monitor samples on a
    daemon thread (``tfidf-devmon``)."""
    global _monitor
    if _monitor is not None:
        return _monitor
    if period_ms is None:
        if not os.environ.get("TFIDF_TPU_DEVMON"):
            return None
        period_ms = float(os.environ.get("TFIDF_TPU_DEVMON_PERIOD_MS",
                                         "500"))
    if period_ms <= 0:
        return None
    _monitor = DeviceMonitor(registry=registry,
                             period_s=period_ms / 1e3).start()
    return _monitor
