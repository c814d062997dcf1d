"""Fleet-wide trace identity (port of
``tfidf_tpu/obs/disttrace.py``; stdlib only, the JAX package's code).

* **Trace context** — :func:`mint` creates a fleet-global identity at a
  front's admission point: a trace id (``t<16hex>``, 64 random bits)
  plus the parent span id. :func:`to_wire` / :func:`from_wire`
  serialize it as the ``"trace"`` field of JSONL requests;
  ``from_wire`` degrades ANY malformed/missing value to ``None`` (the
  request then runs under its local rid), so propagation can never fail
  a request. The single-process server of this package adopts inbound
  contexts (``cli serve``); it mints none.
* **Kill switch** — ``TFIDF_TPU_DISTTRACE=off`` (default on):
  :func:`enabled` is one cached env read, :func:`configure` the runtime
  toggle (``ServeConfig.disttrace`` / ``--disttrace``).
* **Clock alignment** — :class:`ClockOffsetEstimator` turns request/
  reply round trips into a peer-clock offset (the minimum-RTT midpoint
  sample), recorded in trace-export metadata; captured timestamps are
  never rewritten.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

__all__ = ["TraceContext", "ClockOffsetEstimator", "enabled",
           "configure", "mint", "child", "to_wire", "from_wire",
           "is_trace_id"]

_enabled: Optional[bool] = None  # None = derive from env on next call


def enabled() -> bool:
    """Fleet-trace propagation on? Default ON; ``TFIDF_TPU_DISTTRACE``
    set to ``off``/``0``/``false``/``no`` disables. The env read is
    cached — :func:`configure` is the runtime toggle."""
    e = _enabled
    if e is None:
        raw = os.environ.get("TFIDF_TPU_DISTTRACE", "on").lower()
        e = raw not in ("off", "0", "false", "no", "")
        globals()["_enabled"] = e
    return e


def configure(enabled_: Optional[bool]) -> Optional[bool]:
    """Force fleet tracing on/off for this process (the serve_bench
    A/B seam); ``None`` resets to the env-derived default."""
    global _enabled
    _enabled = None if enabled_ is None else bool(enabled_)
    return _enabled


class TraceContext:
    """One fleet-global trace identity: the trace id every hop stamps
    on its spans, plus the span id of the hop that forwarded it (the
    causal parent — the front's ``route`` span for data-plane hops,
    the ``epoch_swap`` span for control-plane ops)."""

    __slots__ = ("trace", "parent")

    def __init__(self, trace: str, parent: str) -> None:
        self.trace = trace
        self.parent = parent

    def __repr__(self) -> str:  # forensics-friendly
        return f"TraceContext({self.trace}, parent={self.parent})"


def is_trace_id(s: Any) -> bool:
    """``t<16hex>``? The shape check ``doctor --request`` uses to tell
    a front-minted trace id from a replica-local rid."""
    if not isinstance(s, str) or len(s) != 17 or s[0] != "t":
        return False
    try:
        int(s[1:], 16)
    except ValueError:
        return False
    return True


def mint() -> Optional[TraceContext]:
    """Mint a fresh trace context at the admission point; None when
    fleet tracing is off (every consumer takes ``ctx is None`` as the
    disabled path). 64 random bits per id: collision across a tier's
    lifetime is negligible and minting stays allocation-cheap."""
    if not enabled():
        return None
    return TraceContext("t" + os.urandom(8).hex(),
                        "s" + os.urandom(4).hex())


def child(ctx: Optional[TraceContext],
          parent: str) -> Optional[TraceContext]:
    """The same trace id under a new causal parent — what a hop passes
    to the NEXT hop once it has opened its own span."""
    if ctx is None:
        return None
    return TraceContext(ctx.trace, parent)


def to_wire(ctx: Optional[TraceContext]) -> Optional[Dict[str, str]]:
    """The compact JSONL form of a context (the ``"trace"`` field on
    data-plane requests and ctrl ops); None when there is nothing to
    propagate."""
    if ctx is None:
        return None
    return {"id": ctx.trace, "parent": ctx.parent}


def from_wire(obj: Any) -> Optional[TraceContext]:
    """Parse a ``"trace"`` wire field back into a context.

    Degrades, never raises: a missing field, a non-dict, a non-string
    or malformed id — anything short of a well-formed context —
    returns ``None`` and the request proceeds under its local rid
    (pinned by tests/test_disttrace.py). A propagation bug must never
    be able to fail live traffic."""
    if not enabled():
        return None
    if not isinstance(obj, dict):
        return None
    trace = obj.get("id")
    if not is_trace_id(trace):
        return None
    parent = obj.get("parent")
    if not isinstance(parent, str) or not (1 <= len(parent) <= 64):
        parent = ""
    return TraceContext(trace, parent)


class ClockOffsetEstimator:
    """Peer-clock offset from request/reply round trips (min-RTT
    filtered RTT-midpoint — the NTP estimate).

    One estimator per (local, peer) clock pair, fed by
    :meth:`add_sample` with three ``perf_counter_ns`` readings: the
    local send instant, the peer's clock read while holding the
    request, and the local receive instant. Each sample estimates

        ``offset = t_peer - (t_send + t_recv) / 2``

    i.e. *peer minus local* at the RTT midpoint; the error is bounded
    by ±RTT/2 (worst-case asymmetric delay), so the estimator keeps
    the sample with the smallest RTT seen and reports that bound as
    :attr:`uncertainty_ns`. Offsets are *recorded in export metadata*
    and applied by ``tools/trace_merge.py`` — capture-side timestamps
    are never rewritten.
    """

    __slots__ = ("offset_ns", "uncertainty_ns", "rtt_ns", "n_samples")

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        """Discard all state — MUST be called when the peer process
        restarts (a new process is a new clock epoch; stale offsets
        would silently misalign every span it records)."""
        self.offset_ns: Optional[int] = None
        self.uncertainty_ns: Optional[int] = None
        self.rtt_ns: Optional[int] = None
        self.n_samples = 0

    def add_sample(self, t_send_ns: int, t_peer_ns: int,
                   t_recv_ns: int) -> None:
        """Fold one round trip in; keeps the minimum-RTT sample."""
        rtt = int(t_recv_ns) - int(t_send_ns)
        if rtt < 0:
            return  # a non-causal reading is instrumentation noise
        self.n_samples += 1
        if self.rtt_ns is not None and rtt >= self.rtt_ns:
            return
        self.rtt_ns = rtt
        self.offset_ns = int(t_peer_ns) - (int(t_send_ns)
                                           + int(t_recv_ns)) // 2
        self.uncertainty_ns = (rtt + 1) // 2

    def as_meta(self) -> Dict[str, Any]:
        """The export-metadata record ``trace_merge`` consumes."""
        return {"offset_ns": self.offset_ns,
                "uncertainty_ns": self.uncertainty_ns,
                "rtt_ns": self.rtt_ns,
                "samples": self.n_samples}
