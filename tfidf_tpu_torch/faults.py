"""Deterministic fault injection: named seams, typed faults, one plan
(port of ``tfidf_tpu/faults.py``; stdlib only, the JAX package's code
with the event log taken from this package).

* **Seams** — named call sites that consult the registry before doing
  work. In this package ``SegmentedIndex.compact`` fires ``swap`` after
  the merge and before the install; the other names are the JAX
  package's (its serving and ingest seams) and parse the same. A seam
  check costs one global load + ``is None`` test when no plan is armed.
* **Typed faults** — :class:`TransientFault` (retryable) and
  :class:`FatalFault` (not retryable: restart budgets must contain
  it). Both subclass :class:`InjectedFault`; nothing outside a test or
  chaos run should ever catch the base class.
* **One plan, armed from a spec + seed** — ``TFIDF_TPU_FAULTS`` parses
  into :class:`FaultPlan` rules; randomness (``p=``) draws from a
  ``random.Random(seed)`` per rule, so a chaos run is replayable.

Spec grammar (rules joined by ``;``, fields by ``:``)::

    seam:kind[:key=val[:key=val...]]

    device_dispatch:transient:n=2      # first 2 checks raise, then pass
    device_dispatch:fatal:match=zzz    # every batch containing "zzz"
    pack_worker:transient:at=2         # fire on the 2nd check only
    batcher_loop:fatal:n=1             # kill the loop once
    swap:transient:p=0.5               # coin-flip (seeded)
    batcher_loop:sleep:s=0.4           # stall the seam, don't raise

Keys: ``n`` max fires (default 1; ``match`` rules default unlimited —
a poison query stays poison), ``at`` first firing check (1-based),
``p`` per-check probability, ``match`` substring the seam's text must
contain (the poison-query selector), ``s`` sleep seconds for the
``sleep`` kind. Every firing logs a ``fault_injected`` flight event
and counts in :meth:`FaultRegistry.snapshot`.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional

__all__ = [
    "InjectedFault", "TransientFault", "FatalFault",
    "FaultRule", "FaultPlan", "FaultRegistry",
    "get_registry", "arm", "disarm", "fire", "configure", "backoff_s",
    "SEAMS",
]

SEAMS = ("device_dispatch", "drain", "pack_worker", "batcher_loop",
         "swap", "replica_prepare")
_KINDS = ("transient", "fatal", "sleep")


class InjectedFault(RuntimeError):
    """Base class of registry-raised faults. Carries the seam name."""

    def __init__(self, msg: str, seam: str = "?"):
        super().__init__(msg)
        self.seam = seam


class TransientFault(InjectedFault):
    """A retryable injected failure — the supervisor's retry/backoff
    path is expected to absorb it."""


class FatalFault(InjectedFault):
    """A non-retryable injected failure — bisection / restart budgets
    must contain it, retries must not."""


class FaultRule:
    """One armed rule: fires at a seam under its trigger conditions.

    State (``checked``/``fired``) advances only on matching checks, so
    ``at=``/``n=`` count what the rule could have hit, which keeps a
    plan deterministic regardless of unrelated traffic at the seam.
    """

    __slots__ = ("seam", "kind", "n", "at", "p", "match", "sleep_s",
                 "checked", "fired", "_rng", "spec")

    def __init__(self, seam: str, kind: str, n: Optional[int] = None,
                 at: int = 1, p: float = 1.0,
                 match: Optional[str] = None, sleep_s: float = 0.0,
                 seed: int = 0, spec: str = ""):
        if seam not in SEAMS:
            raise ValueError(f"unknown fault seam {seam!r} "
                             f"(choose from {SEAMS})")
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(choose from {_KINDS})")
        if at < 1:
            raise ValueError("at= must be >= 1")
        if not 0.0 < p <= 1.0:
            raise ValueError("p= must be in (0, 1]")
        self.seam = seam
        self.kind = kind
        # match-rules model a poison input: poison stays poison, so
        # their fire budget defaults to unlimited (-1).
        self.n = (-1 if match is not None else 1) if n is None else n
        self.at = at
        self.p = p
        self.match = match
        self.sleep_s = sleep_s
        self.checked = 0
        self.fired = 0
        self._rng = random.Random(f"{seed}:{seam}:{kind}:{match}:{at}")
        self.spec = spec or f"{seam}:{kind}"

    def should_fire(self, text: Optional[str]) -> bool:
        if self.match is not None and (text is None
                                       or self.match not in text):
            return False
        self.checked += 1
        if self.checked < self.at:
            return False
        if self.n >= 0 and self.fired >= self.n:
            return False
        if self.p < 1.0 and self._rng.random() >= self.p:
            return False
        self.fired += 1
        return True


class FaultPlan:
    """A parsed set of :class:`FaultRule` — what one chaos run arms."""

    def __init__(self, rules: List[FaultRule], spec: str = "",
                 seed: int = 0):
        self.rules = rules
        self.spec = spec
        self.seed = seed

    @staticmethod
    def parse(spec: str, seed: int = 0) -> "FaultPlan":
        rules: List[FaultRule] = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            if len(fields) < 2:
                raise ValueError(
                    f"bad fault rule {part!r}: want seam:kind[:k=v...]")
            seam, kind = fields[0].strip(), fields[1].strip()
            kw: dict = {}
            for field in fields[2:]:
                key, sep, val = field.partition("=")
                if not sep:
                    raise ValueError(f"bad fault rule field {field!r} "
                                     f"in {part!r} (want key=value)")
                key = key.strip()
                val = val.strip()
                if key == "n":
                    kw["n"] = int(val)
                elif key == "at":
                    kw["at"] = int(val)
                elif key == "p":
                    kw["p"] = float(val)
                elif key == "match":
                    kw["match"] = val
                elif key == "s":
                    kw["sleep_s"] = float(val)
                else:
                    raise ValueError(
                        f"unknown fault rule key {key!r} in {part!r}")
            rules.append(FaultRule(seam, kind, seed=seed, spec=part,
                                   **kw))
        if not rules:
            raise ValueError(f"fault plan {spec!r} parsed to no rules")
        return FaultPlan(rules, spec=spec, seed=seed)

    def rules_for(self, seam: str) -> List[FaultRule]:
        return [r for r in self.rules if r.seam == seam]


class FaultRegistry:
    """Holds the armed plan and fires it at seam checks.

    One registry per process (module singleton below): the seams live
    in worker threads spread across ingest and serve, and a chaos run
    arms them all with one call.
    """

    def __init__(self) -> None:
        self._plan: Optional[FaultPlan] = None
        self._lock = threading.Lock()

    @property
    def armed(self) -> bool:
        return self._plan is not None

    @property
    def plan(self) -> Optional[FaultPlan]:
        return self._plan

    def arm(self, plan: FaultPlan) -> "FaultRegistry":
        self._plan = plan
        return self

    def disarm(self) -> None:
        self._plan = None

    def fire(self, seam: str, text: Optional[str] = None,
             **info) -> None:
        """The seam check: no-op unless an armed rule triggers, else
        raises the rule's typed fault (or sleeps, for ``sleep``
        rules). ``text`` is the seam's match surface — e.g. the
        coalesced batch's query text at ``device_dispatch``."""
        plan = self._plan
        if plan is None:
            return
        with self._lock:
            due = [r for r in plan.rules_for(seam)
                   if r.should_fire(text)]
        for rule in due:
            from tfidf_tpu_torch.obs import log as obs_log
            obs_log.log_event(
                "warning", "fault_injected",
                msg=f"fault injected at {seam}: {rule.spec} "
                    f"(firing {rule.fired})",
                # fault_kind, not "kind": the flight-dump protocol
                # reserves "kind" as its event/digest discriminator
                # (obs/log.py dump) — a payload field named "kind"
                # would clobber it and tear every dump that carries a
                # fault event.
                seam=seam, fault_kind=rule.kind, rule=rule.spec,
                firing=rule.fired, **info)
            if rule.kind == "sleep":
                time.sleep(rule.sleep_s)
                continue
            cls = TransientFault if rule.kind == "transient" else FatalFault
            raise cls(f"injected {rule.kind} fault at seam "
                      f"{seam!r} ({rule.spec}, firing {rule.fired})",
                      seam=seam)

    def snapshot(self) -> Dict[str, dict]:
        """Per-rule receipts: checks seen, faults fired."""
        plan = self._plan
        if plan is None:
            return {}
        with self._lock:
            return {r.spec: {"seam": r.seam, "kind": r.kind,
                             "checked": r.checked, "fired": r.fired}
                    for r in plan.rules}


# --- module-level singleton -----------------------------------------
#
# Product seams call faults.fire(...); disabled cost is one global
# load + None test (the same discipline as obs.health.beat).

_registry = FaultRegistry()


def get_registry() -> FaultRegistry:
    return _registry


def arm(plan: FaultPlan) -> FaultRegistry:
    return _registry.arm(plan)


def disarm() -> None:
    _registry.disarm()


def fire(seam: str, text: Optional[str] = None, **info) -> None:
    if _registry._plan is not None:
        _registry.fire(seam, text=text, **info)


def configure(spec: Optional[str] = None,
              seed: Optional[int] = None) -> Optional[FaultPlan]:
    """Arm from an explicit spec or the ``TFIDF_TPU_FAULTS`` /
    ``TFIDF_TPU_FAULT_SEED`` env mirrors; no-op (returns None) when
    neither names a plan."""
    import os
    resolved = spec or os.environ.get("TFIDF_TPU_FAULTS")
    if not resolved:
        return None
    if seed is None:
        seed = int(os.environ.get("TFIDF_TPU_FAULT_SEED", "0"))
    plan = FaultPlan.parse(resolved, seed=seed)
    _registry.arm(plan)
    return plan


def backoff_s(attempt: int, base_ms: float = 10.0, mult: float = 2.0,
              cap_ms: float = 1000.0, jitter: float = 0.5,
              rng: Optional[random.Random] = None) -> float:
    """Jittered exponential backoff: ``base * mult^(attempt-1)`` capped
    at ``cap``, +- ``jitter`` fraction drawn from ``rng`` (deterministic
    when the caller seeds it). Shared by the dispatch retry loop and
    the worker restart paths so every backoff in the system has the
    same shape."""
    if attempt < 1:
        attempt = 1
    delay = min(cap_ms, base_ms * (mult ** (attempt - 1))) / 1e3
    if jitter > 0.0:
        r = rng.random() if rng is not None else random.random()
        delay *= 1.0 + jitter * (2.0 * r - 1.0)
    return max(0.0, delay)
