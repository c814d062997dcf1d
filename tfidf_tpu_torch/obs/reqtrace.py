"""Request identity + per-request forensics (port of
``tfidf_tpu/obs/reqtrace.py``; stdlib only, the JAX package's code).

Every request carries a compact process-unique **request id** (``rid``)
from admission to resolution, and the spans, flight events, digests and
JSONL responses all carry the same key.

* :func:`next_rid` — ids of the form ``r<pid16><t16>-<seq>``.
  ``TFIDF_TPU_REQTRACE=off`` disables minting; the disabled path is one
  module-global load + truthiness test.
* :class:`RequestContext` — the per-request carrier riding the request
  through batcher → cache → supervisor → device dispatch → drain.
  Phase durations are marked at the same code points that end the
  request's spans, so the resolved breakdown ``{queue_wait,
  batch_wait, device, drain, cache, total}`` (ms) reconciles with the
  trace. Anomalies that struck the request's batch (``dispatch_retry``
  deltas, ``recompile_in_batch``) are noted by the batcher; overlapping
  ``hbm_watermark`` flight events are folded in at resolution.
* :func:`finish` — the slow-query log: a request over
  ``TFIDF_TPU_SLOW_MS`` (``ServeConfig.slow_ms``), or every Nth
  resolved request under ``TFIDF_TPU_SLOW_SAMPLE``, emits a
  ``slow_query`` flight event with its breakdown, batch id,
  co-occupant count, epoch and anomalies.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional

from tfidf_tpu_torch.obs import log as obs_log

__all__ = ["RequestContext", "enabled", "configure", "next_rid",
           "start", "finish", "PHASES"]

#: Phase keys of a resolved breakdown, in lifecycle order. Values are
#: milliseconds; phases a request never entered report 0.0 (a cache
#: hit has no device phase; an admission shed has only total).
PHASES = ("cache", "queue_wait", "batch_wait", "device", "drain",
          "total")

_seq = itertools.count(1)        # rid counter (GIL-atomic)
_resolved = itertools.count(1)   # tail-sample counter
_prefix_lock = threading.Lock()
_PREFIX: Optional[str] = None
_enabled: Optional[bool] = None  # None = derive from env on next call


def _prefix() -> str:
    """Process-unique rid prefix: 16 pid bits + 16 boot-instant bits,
    hex. Two replicas (or a restart of the same pid slot) mint
    disjoint rid spaces, so federated evidence never aliases."""
    global _PREFIX
    if _PREFIX is None:
        with _prefix_lock:
            if _PREFIX is None:
                _PREFIX = (f"{os.getpid() & 0xffff:04x}"
                           f"{time.time_ns() & 0xffff:04x}")
    return _PREFIX


def next_rid() -> str:
    return f"r{_prefix()}-{next(_seq):x}"


def enabled() -> bool:
    """Request-identity minting on? Default ON; ``TFIDF_TPU_REQTRACE``
    set to ``off``/``0``/``false``/``no`` disables. The env read is
    cached — :func:`configure` is the runtime toggle."""
    e = _enabled
    if e is None:
        raw = os.environ.get("TFIDF_TPU_REQTRACE", "on").lower()
        e = raw not in ("off", "0", "false", "no", "")
        globals()["_enabled"] = e
    return e


def configure(enabled_: Optional[bool]) -> Optional[bool]:
    """Force request tracing on/off for this process (the serve_bench
    A/B seam); ``None`` resets to the env-derived default."""
    global _enabled
    _enabled = None if enabled_ is None else bool(enabled_)
    return _enabled


class RequestContext:
    """Per-request forensic carrier (one per admitted request when
    :func:`enabled`). Written by the submit thread, the batcher thread
    and the resolving callback in lifecycle order — each field has one
    writer at a time, so plain attribute writes are safe under the
    GIL (the same discipline as the tracer's ring)."""

    __slots__ = ("rid", "trace", "n", "k", "t0", "t0_wall", "epoch",
                 "batch", "co_occupants", "phases", "anomalies",
                 "_t_dev_end")

    def __init__(self, rid: str, n: int, k: int,
                 trace: Optional[str] = None) -> None:
        self.rid = rid
        # Fleet-global trace id: a front-routed request
        # arrives with the front-minted ``t<16hex>`` id and every
        # local span/digest/response carries it next to the rid, so
        # cross-process evidence joins on one key. None = locally
        # submitted (or disttrace off) — rid-only, exactly as before.
        self.trace = trace
        self.n = n
        self.k = k
        self.t0 = time.monotonic()
        self.t0_wall = time.time()
        self.epoch: Optional[int] = None
        self.batch: Optional[int] = None
        self.co_occupants = 0
        self.phases: Dict[str, float] = {}   # phase -> seconds
        self.anomalies: List[dict] = []
        self._t_dev_end: Optional[float] = None

    def mark(self, phase: str, seconds: float) -> None:
        """Fold one measured phase duration in (accumulating — a
        bisected batch may dispatch a request's queries twice)."""
        self.phases[phase] = self.phases.get(phase, 0.0) + seconds

    def mark_device_end(self, t: float) -> None:
        """The instant the request's device call returned — the drain
        phase (slice rows, fill cache, resolve the future) runs from
        here to resolution."""
        self._t_dev_end = t

    def note(self, kind: str, **fields: Any) -> None:
        """Record one anomaly that struck this request's batch."""
        self.anomalies.append({"kind": kind, **fields})

    def breakdown(self) -> Dict[str, float]:
        """The resolved phase breakdown in milliseconds, every
        :data:`PHASES` key present."""
        return {p: round(self.phases.get(p, 0.0) * 1e3, 3)
                for p in PHASES}


def start(n: int, k: int,
          trace: Optional[str] = None) -> Optional[RequestContext]:
    """Mint a request identity at admission; None when request tracing
    is off (every consumer takes ``ctx is None`` as the disabled
    path). ``trace`` adopts a front-minted fleet trace id onto the
    context (:mod:`tfidf_tpu_torch.obs.disttrace`)."""
    if not enabled():
        return None
    return RequestContext(next_rid(), n, k, trace=trace)


def _overlapping_watermarks(ctx: RequestContext) -> List[dict]:
    """``hbm_watermark`` flight events whose timestamp falls inside
    the request's lifetime — the "co-occupant pressure" evidence. Only
    scanned for requests already judged slow/sampled (bounded work)."""
    out: List[dict] = []
    for e in obs_log.get_log().events()[-256:]:
        if e.get("event") == "hbm_watermark" \
                and e.get("t", 0.0) >= ctx.t0_wall - 0.001:
            out.append({"kind": "hbm_watermark",
                        "pressure": e.get("pressure"),
                        "watermark": e.get("watermark")})
    return out


def finish(ctx: Optional[RequestContext], outcome: str,
           slow_ms: Optional[float] = None,
           sample_every: int = 0) -> Optional[str]:
    """Resolve one request's forensics: close the drain/total phases
    and emit a ``slow_query`` flight event when the request is over
    the ``slow_ms`` objective (level ``warning``) or hit the 1-in-N
    tail sample (level ``info``, ``sampled: true``). Returns
    ``"slow"`` / ``"sampled"`` / None — the server counts
    ``serve_slow_queries_total`` off the first."""
    if ctx is None:
        return None
    now = time.monotonic()
    total = now - ctx.t0
    ctx.phases["total"] = total
    if ctx._t_dev_end is not None:
        ctx.mark("drain", now - ctx._t_dev_end)
    total_ms = total * 1e3
    slow = slow_ms is not None and total_ms >= slow_ms
    sampled = (not slow and sample_every > 0
               and next(_resolved) % sample_every == 0)
    if not (slow or sampled):
        return None
    anomalies = list(ctx.anomalies) + _overlapping_watermarks(ctx)
    obs_log.log_event(
        "warning" if slow else "info", "slow_query",
        msg=(f"slow query {ctx.rid}: {total_ms:.1f} ms "
             f"({outcome}, batch {ctx.batch}, "
             f"{ctx.co_occupants} co-occupant queries)"
             if slow else
             f"sampled query {ctx.rid}: {total_ms:.1f} ms ({outcome})"),
        rid=ctx.rid, outcome=outcome, breakdown=ctx.breakdown(),
        batch=ctx.batch, co_occupants=ctx.co_occupants,
        epoch=ctx.epoch, queries=ctx.n, k=ctx.k,
        sampled=sampled, anomalies=anomalies,
        **({"trace": ctx.trace} if ctx.trace else {}))
    return "slow" if slow else "sampled"
