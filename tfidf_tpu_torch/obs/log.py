"""Structured event log + flight recorder (port of
``tfidf_tpu/obs/log.py``; stdlib only).

The tracer (``obs/tracer.py``) answers "where did the time go"; this
module answers "what happened": discrete, leveled, structured events (a
segment seal, a compaction, an injected fault, a worker restart)
recorded into a bounded ring next to the last-N request digests, and
dumped ATOMICALLY to JSONL on demand (a crash, a close).

Design constraints:

* **Always recording, cheap.** The ring exists from first use (no
  arming step); one event is a dict append under the GIL plus a
  token-bucket check.
* **Rate-limited per event name.** A loop logging one event 10k
  times/sec keeps its budget (default 20/s, burst 40 —
  ``TFIDF_TPU_LOG_RATE``) and the ring keeps its window; suppressed
  counts surface on the next admitted event and in the dump header.
* **stderr echo.** Events at or above the echo level (default ``info``
  — ``TFIDF_TPU_LOG_ECHO``, ``off`` to silence) also write one human
  line to stderr.
* **Atomic dump.** :meth:`EventLog.dump` writes ``path + ".tmp"`` then
  ``os.replace`` — a reader never sees a torn file.

The dump format (header schema ``tfidf-flight/1``, one ``{"kind":
"event"|"digest", ...}`` line each) is the JAX package's. The dump path
comes from :func:`configure_flight` (or ``TFIDF_TPU_FLIGHT``), else
rides next to an armed trace as ``<trace>.flight.jsonl``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = [
    "EventLog", "get_log", "set_log", "log_event", "record_digest",
    "configure_flight", "flight_path", "dump_flight", "FLIGHT_SCHEMA",
]

FLIGHT_SCHEMA = "tfidf-flight/1"

_LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}
_DEFAULT_CAP = 4096
_DEFAULT_DIGESTS = 256
_DEFAULT_RATE = 20.0     # admitted events/sec per event name
_DEFAULT_BURST = 40.0


def _level_no(level: str) -> int:
    try:
        return _LEVELS[level]
    except KeyError:
        raise ValueError(f"unknown log level {level!r} "
                         f"(choose from {sorted(_LEVELS)})") from None


class EventLog:
    """Bounded ring of structured events + last-N request digests.

    Args:
      capacity: event-ring size (oldest drop past it).
      digests: request-digest ring size.
      rate_per_s / burst: per-event-name token bucket; events past the
        budget are counted as suppressed, not recorded.
      echo: minimum level echoed as one human line to stderr
        (``"off"`` disables echoing entirely).
    """

    def __init__(self, capacity: int = _DEFAULT_CAP,
                 digests: int = _DEFAULT_DIGESTS,
                 rate_per_s: float = _DEFAULT_RATE,
                 burst: float = _DEFAULT_BURST,
                 echo: str = "info") -> None:
        if capacity < 1 or digests < 1:
            raise ValueError("capacity/digests must be >= 1")
        if rate_per_s <= 0 or burst < 1:
            raise ValueError("need rate_per_s > 0 and burst >= 1")
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        self._digests: deque = deque(maxlen=digests)
        self._rate = rate_per_s
        self._burst = burst
        self._echo_no = (10**9 if echo == "off" else _level_no(echo))
        self._lock = threading.Lock()          # token buckets only
        self._buckets: Dict[str, List[float]] = {}  # name -> [tokens, t]
        self._suppressed: Dict[str, int] = {}

    # --- recording ---
    def log(self, level: str, event: str, msg: Optional[str] = None,
            **fields: Any) -> bool:
        """Record one structured event; returns False when the event's
        rate budget suppressed it. ``msg`` is the optional human form
        (used verbatim by the stderr echo); ``fields`` must be
        JSON-serializable."""
        no = _level_no(level)
        now = time.monotonic()
        with self._lock:
            bucket = self._buckets.get(event)
            if bucket is None:
                bucket = self._buckets[event] = [self._burst, now]
            tokens = min(self._burst,
                         bucket[0] + (now - bucket[1]) * self._rate)
            bucket[1] = now
            if tokens < 1.0:
                bucket[0] = tokens
                self._suppressed[event] = \
                    self._suppressed.get(event, 0) + 1
                return False
            bucket[0] = tokens - 1.0
            dropped = self._suppressed.pop(event, 0)
        rec = {"t": round(time.time(), 6), "level": level,
               "event": event}
        if msg is not None:
            rec["msg"] = msg
        if fields:
            # "kind" is RESERVED by the dump protocol (the
            # event/digest discriminator each JSONL line leads with);
            # a payload field with that name would clobber it and
            # tear the dump. Store it under "field_kind" instead of
            # silently corrupting the recorder.
            if "kind" in fields:
                fields = dict(fields)
                fields["field_kind"] = fields.pop("kind")
            rec.update(fields)
        if dropped:
            rec["suppressed"] = dropped  # events throttled since last
        self._events.append(rec)
        if no >= self._echo_no:
            text = msg if msg is not None else " ".join(
                [event] + [f"{k}={v}" for k, v in fields.items()])
            try:
                sys.stderr.write(f"{text}\n")
            except (OSError, ValueError):   # stderr gone (daemonized)
                pass
        return True

    def debug(self, event: str, msg: Optional[str] = None, **fields):
        return self.log("debug", event, msg, **fields)

    def info(self, event: str, msg: Optional[str] = None, **fields):
        return self.log("info", event, msg, **fields)

    def warning(self, event: str, msg: Optional[str] = None, **fields):
        return self.log("warning", event, msg, **fields)

    def error(self, event: str, msg: Optional[str] = None, **fields):
        return self.log("error", event, msg, **fields)

    def digest(self, **fields: Any) -> None:
        """Record one served-request digest (outcome, latency, sizes —
        never query text) into the last-N ring. Not rate-limited: one
        digest per request is already bounded by the serve rate, and a
        gappy digest ring would defeat its purpose."""
        rec = {"t": round(time.time(), 6)}
        if "kind" in fields:   # reserved by the dump protocol
            fields = dict(fields)
            fields["field_kind"] = fields.pop("kind")
        rec.update(fields)
        self._digests.append(rec)

    # --- reading ---
    def events(self) -> List[dict]:
        return list(self._events)

    def digests(self) -> List[dict]:
        return list(self._digests)

    def suppressed(self) -> Dict[str, int]:
        """Per-event counts throttled since their last admitted event."""
        with self._lock:
            return dict(self._suppressed)

    def clear(self) -> None:
        self._events.clear()
        self._digests.clear()
        with self._lock:
            self._buckets.clear()
            self._suppressed.clear()

    # --- dumping ---
    def dump(self, path: str) -> str:
        """Atomic JSONL dump: a schema header line, then every ring
        event as ``{"kind": "event", ...}``, then every digest as
        ``{"kind": "digest", ...}``. Written to ``path + ".tmp"`` and
        renamed into place, so a dump interrupted mid-write (the crash
        case) never corrupts an earlier complete dump."""
        events = list(self._events)
        digests = list(self._digests)
        header = {"schema": FLIGHT_SCHEMA, "pid": os.getpid(),
                  "dumped_at": round(time.time(), 6),
                  "events": len(events), "digests": len(digests),
                  "suppressed": self.suppressed()}
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps(header) + "\n")
            for rec in events:
                f.write(json.dumps({"kind": "event", **rec}) + "\n")
            for rec in digests:
                f.write(json.dumps({"kind": "digest", **rec}) + "\n")
        os.replace(tmp, path)
        return path


# --- module-level singleton -----------------------------------------
#
# Product code logs through these helpers; the singleton builds itself
# from the env on first use so a crash dump always has a ring to read.

_log: Optional[EventLog] = None
_log_lock = threading.Lock()
_flight: Optional[str] = None


def get_log() -> EventLog:
    global _log
    if _log is None:
        with _log_lock:
            if _log is None:
                _log = EventLog(
                    capacity=int(os.environ.get(
                        "TFIDF_TPU_LOG_CAP", str(_DEFAULT_CAP))),
                    rate_per_s=float(os.environ.get(
                        "TFIDF_TPU_LOG_RATE", str(_DEFAULT_RATE))),
                    echo=os.environ.get("TFIDF_TPU_LOG_ECHO", "info"))
    return _log


def set_log(log: Optional[EventLog]) -> None:
    """Install (or, with ``None``, reset to lazy-default) the global
    event log — the test seam."""
    global _log
    _log = log


def log_event(level: str, event: str, msg: Optional[str] = None,
              **fields: Any) -> bool:
    return get_log().log(level, event, msg, **fields)


def record_digest(**fields: Any) -> None:
    get_log().digest(**fields)


def configure_flight(path: Optional[str] = None) -> Optional[str]:
    """Arm the flight-recorder dump path (``None`` falls back to
    ``TFIDF_TPU_FLIGHT``; empty/absent leaves the explicit path unset —
    the dump may still derive one from an armed tracer, see
    :func:`flight_path`). Idempotent like ``tracer.configure``."""
    global _flight
    resolved = path or os.environ.get("TFIDF_TPU_FLIGHT")
    if resolved:
        _flight = resolved
    return _flight


def flight_path() -> Optional[str]:
    """Where a dump would land: the configured path, else — when the
    span tracer is armed — ``<trace>.flight.jsonl`` next to it (one
    incident, one directory of evidence). None when neither is armed."""
    if _flight:
        return _flight
    from tfidf_tpu_torch.obs import tracer
    tp = tracer.trace_path()
    return f"{tp}.flight.jsonl" if tp else None


def dump_flight(path: Optional[str] = None) -> Optional[str]:
    """Dump the global ring to ``path`` (default: :func:`flight_path`).
    Returns the written path, or None when no path is armed — callers
    (the CLI exit path, ``TfidfServer.close``, the SIGTERM handler)
    invoke it unconditionally."""
    resolved = path or flight_path()
    if not resolved:
        return None
    return get_log().dump(resolved)
