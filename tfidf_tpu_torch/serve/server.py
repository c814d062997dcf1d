"""TfidfServer: the online query-serving front end over a retriever
(port of ``tfidf_tpu/serve/server.py``).

Composition::

    submit(queries, k, deadline) ── admission gate (queue_depth,
      Overloaded) ── per-query cache probe (epoch-keyed LRU) ── misses
      into the MicroBatcher ── coalesced search on the epoch's index
      (``search_async``: query entries staged, copied to the card and
      built into the query block there,
      B6 on every doc tile, result copied back into pinned memory) ──
      drain: rows sliced per request, cache filled, Future resolved.

The index is a flat :class:`~tfidf_tpu_torch.models.TfidfRetriever`, a
segmented :class:`~tfidf_tpu_torch.index.IndexView` or a doc-sharded
:class:`~tfidf_tpu_torch.parallel.MeshShardedRetriever`, taken by duck
type. With ``ServeConfig.mesh_shards`` set, the index is ONE logical
index doc-sharded over that many devices of the index's device type
(``parallel.serving.make_serving_plan``), and every install path — the
constructor, swaps, mutation views, compaction, a restored snapshot —
re-shards through ``shard_index`` before the flip.

Guarantees (the JAX package's, held the same way):

* **Parity** — every response row is exactly what a direct ``search`` of
  the same queries on the same index returns: batching, caching,
  pipelining and concurrency never change a bit.
* **Bounded backlog** — at most ``queue_depth`` queries are admitted and
  unresolved at once; past that ``submit`` raises :class:`Overloaded`.
* **Deadlines** — a request still queued past its deadline is shed with
  :class:`DeadlineExceeded` before touching the device.
* **Hot swap** — :meth:`swap_index` installs a new index, bumps the
  epoch (cache keys include it) and clears the cache; requests already
  in flight finish on the index they were admitted under.
* **Graceful shutdown** — :meth:`close` drains in-flight work by
  default; ``drain=False`` fails queued requests fast.
* **Survival** — device dispatch runs under a
  :class:`~tfidf_tpu_torch.serve.supervisor.SupervisedDispatch` (bounded
  retry, poison-query bisection + quarantine), a circuit breaker trips
  into degraded admission, the batcher loop restarts itself inside a
  budget, and :meth:`snapshot` / restore-on-start persist the resident
  index in the JAX package's snapshot format.

``ServeConfig.replicas`` is accepted and ignored here, as in the JAX
package: the replicated tier is :class:`~tfidf_tpu_torch.serve.front.
ReplicatedFront`, which runs N of these servers in replica processes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tfidf_tpu_torch import faults, obs
from tfidf_tpu_torch.config import ServeConfig
from tfidf_tpu_torch.models.retrieval import TfidfRetriever
from tfidf_tpu_torch.obs import devmon as obs_devmon
from tfidf_tpu_torch.obs import log as obs_log
from tfidf_tpu_torch.obs import reqtrace
from tfidf_tpu_torch.obs.health import HealthMonitor, HealthThresholds
from tfidf_tpu_torch.obs.slo import SloTracker
from tfidf_tpu_torch.serve.batcher import (DeadlineExceeded, MicroBatcher,
                                     Overloaded, PoisonQuery,
                                     ServeError, ServerClosed)
from tfidf_tpu_torch.scoring.family import (parse_scorer, scorer_key,
                                      spec_from_parts)
from tfidf_tpu_torch.scoring.filters import filter_key
from tfidf_tpu_torch.serve.cache import ResultCache, normalize_query
from tfidf_tpu_torch.serve.metrics import ServeMetrics
from tfidf_tpu_torch.serve.supervisor import (CircuitBreaker, QuarantineList,
                                        RetryPolicy, SupervisedDispatch)

__all__ = ["TfidfServer", "ServeError", "Overloaded", "DeadlineExceeded",
           "ServerClosed", "PoisonQuery"]


class TfidfServer:
    """Serve ranked retrieval online. See module docstring.

    Args:
      retriever: an INDEXED :class:`TfidfRetriever` (the server never
        indexes; build/ingest stays the offline path).
      config: :class:`~tfidf_tpu_torch.config.ServeConfig`; default reads
        the ``TFIDF_TPU_*`` env mirrors.
      metrics: optional shared :class:`ServeMetrics` sink.
    """

    def __init__(self, retriever: TfidfRetriever,
                 config: Optional[ServeConfig] = None,
                 metrics: Optional[ServeMetrics] = None,
                 initial_epoch: int = 0) -> None:
        if not retriever.indexed:
            raise ValueError("TfidfServer needs an indexed retriever; "
                             "call index()/index_dir() first")
        self.config = config or ServeConfig.from_env()
        self.metrics = metrics or ServeMetrics()
        # Mesh-sharded serving: every install path (this constructor,
        # swaps, mutation views) re-shards through the same transform, so
        # none can install a single-device index into a sharded server.
        self._mesh_plan = None
        self._index_transform = None
        if self.config.mesh_shards is not None:
            from tfidf_tpu_torch.parallel.serving import (make_serving_plan,
                                                          shard_index)
            plan = self._mesh_plan = make_serving_plan(
                self.config.mesh_shards, device=retriever.device)
            self._index_transform = lambda r: shard_index(r, plan)
            retriever = self._index_transform(retriever)
        self._apply_query_slab(retriever)
        self._retriever = retriever
        # initial_epoch: a snapshot-restored server resumes at the
        # epoch it snapshotted (cache keys and canary oracles stay
        # epoch-consistent across the restart).
        self._epoch = initial_epoch
        self._lock = threading.Lock()   # epoch/retriever swap + admission
        self._inflight = 0              # admitted, unresolved queries
        self._closed = False
        self._t0 = time.monotonic()     # uptime_s anchor
        self._swap_listeners: List[Callable] = []
        self._cache = ResultCache(self.config.cache_entries)
        # Default scorer: requests that name no scorer score
        # under this family member (--scorer / TFIDF_TPU_SCORER, with
        # --bm25-k1/--bm25-b fleshing out a bare "bm25"). Per-request
        # "scorer" fields override per batch group, never globally.
        self._default_scorer = spec_from_parts(
            self.config.scorer, self.config.bm25_k1, self.config.bm25_b)
        # Live mutation: an attached SegmentedIndex turns
        # add_docs/delete_docs on; every visibility change funnels
        # through _install_index (epoch bump + cache clear + listener
        # notify — the one path, so no mutation can leave a stale
        # cache row or an un-recaptured canary oracle behind).
        self._segments = None
        self._mutate_lock = threading.Lock()
        self._g_segments = self._g_delta_fill = self._g_tombstones = None
        # Fault plan: arming is the server's job when the
        # config names one (the chaos path — serve_bench --chaos /
        # TFIDF_TPU_FAULTS); disarmed again on close so an embedded
        # test server never leaks faults into the host process.
        self._armed_faults = None
        if self.config.faults:
            self._armed_faults = faults.arm(faults.FaultPlan.parse(
                self.config.faults, seed=self.config.fault_seed))
        # The health watchdog: batcher liveness + queue saturation +
        # windowed shed rates -> ok|degraded|unhealthy, with degraded
        # feeding back into admission (docstring of obs/health.py).
        # Always constructed (healthz/readyz evaluate on demand); the
        # background thread only runs when config.health_period_ms is
        # set (the serve CLI's default — library embedders opt in).
        self.health = HealthMonitor(
            snapshot_fn=self.metrics.snapshot,
            queue_bound=self.config.queue_depth,
            thresholds=HealthThresholds(
                stall_after_s=self.config.stall_after_ms / 1e3,
                degraded_admission_factor=(
                    self.config.degraded_admission_factor)),
            period_s=(self.config.health_period_ms / 1e3
                      if self.config.health_period_ms else 0.25),
            registry=self.metrics.registry)
        # Device truth: the compile watchdog ALWAYS watches — a native
        # build after mark_warm() (the kernels' first GPU use, or a
        # rebuild) is a flight event and a windowed degraded reason.
        # The device monitor runs when configured; its memory-pressure
        # signal sheds at the admission gate before the allocator runs
        # out. The watch is installed as THE process watch (latest
        # server wins) and uninstalled on close.
        self.compile_watch = obs_devmon.CompileWatch(
            registry=self.metrics.registry)
        obs_devmon.set_watch(self.compile_watch)
        self.health.add_signal("xla_recompiles_after_warm",
                               self.compile_watch.health_signal)
        self.devmon: Optional[obs_devmon.DeviceMonitor] = None
        if self.config.devmon_period_ms is not None:
            self.devmon = obs_devmon.DeviceMonitor(
                registry=self.metrics.registry,
                period_s=self.config.devmon_period_ms / 1e3,
                device=retriever.device)
            self.attach_device_monitor(self.devmon)
            self.devmon.start()
        # Supervised execution: retry/backoff + breaker +
        # poison bisection around the device call, and a supervised
        # (restartable) batcher loop. The breaker feeds health the
        # same way memory pressure does — open breaker -> degraded ->
        # admission bound shrinks at the gate.
        self.breaker = CircuitBreaker(
            threshold=self.config.breaker_threshold,
            cooldown_s=self.config.breaker_cooldown_ms / 1e3,
            registry=self.metrics.registry)
        self.health.add_signal("circuit_breaker",
                               self.breaker.health_signal)
        self.quarantine = QuarantineList(registry=self.metrics.registry)
        # Per-request forensics: slow-query threshold and
        # 1-in-N tail sample (obs/reqtrace.py), and the SLO burn
        # tracker (obs/slo.py) whose fast-burn signal degrades
        # admission exactly like memory pressure does — a server
        # blowing its latency objective sheds at the gate.
        self._slow_ms = self.config.slow_ms
        self._slow_sample = self.config.slow_sample
        self.slo: Optional[SloTracker] = None
        if self.config.slo_ms is not None:
            self.slo = SloTracker(
                objective_ms=self.config.slo_ms,
                target=self.config.slo_target,
                registry=self.metrics.registry)
            self.health.add_signal("slo_burn", self.slo.health_signal)
        self._dispatcher = SupervisedDispatch(
            self._run_batch,
            RetryPolicy(max_attempts=1 + self.config.dispatch_retries,
                        backoff_ms=self.config.retry_backoff_ms,
                        seed=self.config.fault_seed),
            breaker=self.breaker, metrics=self.metrics)
        self._batcher = MicroBatcher(
            self._run_batch, max_batch=self.config.max_batch,
            max_wait_ms=self.config.max_wait_ms, metrics=self.metrics,
            heartbeat=lambda: self.health.heartbeat("batcher"),
            supervisor=self._dispatcher,
            restart_budget=self.config.restart_budget,
            pipeline_depth=self.config.pipeline_depth,
            dispatch_fn=self._run_batch_async)
        self.health.register(
            "batcher",
            busy_fn=lambda: (self._batcher.queued_queries() > 0
                             or self._batcher.inflight_batches() > 0))
        if self.config.health_period_ms is not None:
            self.health.start()

    def _apply_query_slab(self, retriever) -> None:
        """Push the config's query-slab knob onto an (installable)
        index. Duck-typed: a retriever that exposes the attribute gets
        it (a segmented IndexView stages its own block). The pipeline
        depth rides along: with up to ``depth`` batches in
        flight, the slab pre-provisions that many slots per ring so
        the concurrent steady state stays allocation-free."""
        if (self.config.query_slab is not None
                and hasattr(retriever, "query_slab")):
            retriever.query_slab = self.config.query_slab
        if hasattr(retriever, "slab_depth"):
            retriever.slab_depth = self.config.pipeline_depth

    # --- the batch kernel the batcher drives ---
    def _run_batch(self, queries, k, group):
        epoch, retriever, skey, fkey = group
        if skey == "tfidf" and not fkey:
            # The bit-identical legacy call — also what keeps every
            # test-double retriever (2-arg search) working unchanged.
            return retriever.search(queries, k)
        return retriever.search(queries, k, scorer=skey,
                                filter=fkey or None)

    def _run_batch_async(self, queries, k, group):
        """Dispatch stage of the pipelined path: issue the device call
        and hand back a :class:`~tfidf_tpu_torch.models.retrieval.
        PendingSearch` the drain worker materializes. Duck-typed so a
        retriever without an async seam (a segmented IndexView, a test
        double) still pipelines: its search runs synchronously here and
        returns a resolved handle; ordering and recovery semantics are
        unchanged."""
        epoch, retriever, skey, fkey = group
        dispatch = getattr(retriever, "search_async", None)
        if dispatch is not None:
            if skey == "tfidf" and not fkey:
                return dispatch(queries, k)
            return dispatch(queries, k, scorer=skey,
                            filter=fkey or None)
        from tfidf_tpu_torch.models.retrieval import PendingSearch
        return PendingSearch.resolved(
            *self._run_batch(queries, k, group))

    # --- public API ---
    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def num_docs(self) -> int:
        return self._retriever._num_docs

    def doc_names(self):
        return self._retriever.names

    def submit(self, queries: Sequence[Union[str, bytes]], k: int = 10,
               deadline_ms: Optional[float] = None, *,
               use_cache: bool = True, scorer=None,
               filter=None, trace: Optional[str] = None) -> Future:
        """Admit one request; returns a Future resolving to ``(vals,
        ids)`` — the exact arrays a direct ``retriever.search(queries,
        k)`` returns. Raises :class:`Overloaded` when the admission
        queue is full; the Future fails with
        :class:`DeadlineExceeded` when the deadline expires first.
        ``use_cache=False`` bypasses the result cache on both probe
        and fill — the canary prober's lever: its parity check must
        exercise the device path, not a memoized row.

        ``scorer``/``filter`` select the scoring-family
        member and candidate filter for THIS request (any form
        ``tfidf_tpu_torch.scoring`` parses; None = the server's default
        scorer, unfiltered). They canonicalize into the batch group —
        the batcher never coalesces requests that would score
        differently — and into the cache key, so a bm25 row can never
        answer a tfidf probe.

        The returned Future carries the request id as ``.rid`` (None
        with ``TFIDF_TPU_REQTRACE=off``) — the key that joins the
        JSONL response, the request's spans, its flight digest and
        any ``slow_query`` event.

        ``trace`` adopts a front-minted fleet trace id
        (``t<16hex>``, :mod:`tfidf_tpu_torch.obs.disttrace`) onto the
        request: the ``request`` span, the flight digest and the
        returned Future (``.trace``) all carry it next to the rid, so
        the front's ``route`` span and this replica's lifecycle chain
        join across processes. None = locally submitted."""
        t0 = time.monotonic()
        queries = list(queries)
        n = len(queries)
        # Canonicalize up front: a malformed spec is the submitter's
        # synchronous error, never a failed batch.
        skey = (scorer_key(scorer) if scorer is not None
                else self._default_scorer.key())
        fkey = filter_key(filter)
        # Request identity: minted at admission, carried on
        # the request through batcher -> cache -> supervisor -> device
        # dispatch -> drain, stamped on every span it touches.
        ctx = reqtrace.start(n, k, trace=trace)
        rid = ctx.rid if ctx is not None else None
        # The request lifecycle span: begun on the submitting thread,
        # ended (cross-thread) wherever the request resolves, with the
        # outcome as an arg — every submitted request appears exactly
        # once in a trace as drained / cache_hit / shed_* / error
        # (the JAX package's tests/test_obs.py pins it there).
        span_kw = {}
        if rid is not None:
            span_kw["rid"] = rid
        if trace is not None:
            span_kw["trace"] = trace
        req = obs.begin("request", queries=n, k=k, **span_kw)
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        deadline = None if deadline_ms is None else t0 + deadline_ms / 1e3
        # The EFFECTIVE admission bound: the configured queue_depth
        # while healthy, shrunk while the watchdog says degraded /
        # unhealthy — shedding earlier at the gate is how a degraded
        # server drains its backlog instead of compounding it.
        # Quarantine gate: a query isolated as poison by an earlier
        # batch's bisection fails fast here — the typed 4xx — instead
        # of re-poisoning a batch. Zero cost while the list is empty.
        if len(self.quarantine):
            qcfg = self._retriever.config
            bad = [q for q in queries
                   if self.quarantine.contains(normalize_query(q, qcfg))]
            if bad:
                self.metrics.count("poisoned")
                obs.end(req, outcome="poisoned")
                self._resolve_forensics(ctx, "poisoned")
                self._digest(t0, n, k, "poisoned", rid=rid)
                err = PoisonQuery(
                    f"{len(bad)} of {n} queries are quarantined as "
                    f"poison", queries=bad)
                err.rid = rid
                raise err
        bound = self.health.admission_bound(self.config.queue_depth)
        with self._lock:
            if self._closed:
                obs.end(req, outcome="rejected")
                raise ServerClosed("server is closed")
            if self._inflight + n > bound:
                self.metrics.count("shed_overload")
                obs.end(req, outcome="shed_overload")
                self._resolve_forensics(ctx, "shed_overload")
                self._digest(t0, n, k, "shed_overload", rid=rid)
                err = Overloaded(
                    f"{self._inflight} queries in flight + {n} exceeds "
                    f"admission bound {bound} (configured queue_depth="
                    f"{self.config.queue_depth})")
                err.rid = rid
                raise err
            self._inflight += n
            self.metrics.set_queue_depth(self._inflight)
            retriever, epoch = self._retriever, self._epoch
        cfg = retriever.config
        if ctx is not None:
            ctx.epoch = epoch

        out: Future = Future()
        out.rid = rid
        out.trace = trace
        # The ADMITTED epoch rides the future: a response's epoch is
        # decided here, never by a swap that lands mid-flight — the
        # per-request half of the replicated tier's no-mixed-epochs
        # contract (the JSONL protocol echoes it on every response).
        out.epoch = epoch
        if n == 0:
            width = min(k, retriever._num_docs)
            out.set_result((np.zeros((0, width), np.float32),
                            np.zeros((0, width), np.int64)))
            self.metrics.observe_request(time.monotonic() - t0, 0,
                                         rid=rid)
            obs.end(req, outcome="empty")
            self._resolve_forensics(ctx, "empty")
            return out

        if use_cache:
            t_cache = time.monotonic()
            keys = [self._cache.key(normalize_query(q, cfg), k, epoch,
                                    skey, fkey)
                    for q in queries]
            rows = [self._cache.get(key) for key in keys]
            hits = sum(r is not None for r in rows)
            if ctx is not None:
                ctx.mark("cache", time.monotonic() - t_cache)
            self.metrics.count("cache_hits", hits)
            self.metrics.count("cache_misses", n - hits)
        else:  # canary probes neither read nor skew the cache
            keys, rows, hits = [], [None] * n, 0
        miss_pos = [i for i, r in enumerate(rows) if r is None]

        def resolve(vals: np.ndarray, ids: np.ndarray,
                    outcome: str) -> None:
            self._finish(n)
            latency = time.monotonic() - t0
            self.metrics.observe_request(latency, n, rid=rid)
            if self.slo is not None:
                self.slo.record(latency)
            obs.end(req, outcome=outcome, cache_hits=hits)
            self._resolve_forensics(ctx, outcome)
            self._digest(t0, n, k, outcome, epoch=epoch,
                         cache_hits=hits, rid=rid)
            out.set_result((vals, ids))

        if not miss_pos:
            resolve(np.stack([r[0] for r in rows]),
                    np.stack([r[1] for r in rows]), "cache_hit")
            return out

        inner = self._batcher.submit([queries[i] for i in miss_pos], k,
                                     group=(epoch, retriever, skey,
                                            fkey),
                                     deadline=deadline, ctx=ctx)

        def on_done(f: Future) -> None:
            err = f.exception()
            if err is not None:
                self._finish(n)
                if isinstance(err, PoisonQuery):
                    # Bisection isolated poison queries in this
                    # request: quarantine them (resubmissions fail
                    # fast at the gate) and fail the future typed.
                    for q in err.queries:
                        self.quarantine.add(
                            normalize_query(q, cfg),
                            query_repr=f"len={len(q)}")
                    self.metrics.count("poisoned")
                    outcome = "poisoned"
                else:
                    outcome = (
                        "shed_deadline"
                        if isinstance(err, DeadlineExceeded)
                        else "shed_overload"
                        if isinstance(err, Overloaded)
                        else "error")
                obs.end(req, outcome=outcome)
                self._resolve_forensics(ctx, outcome)
                self._digest(t0, n, k, outcome, epoch=epoch,
                             error=(None if outcome != "error"
                                    else repr(err)), rid=rid)
                out.set_exception(err)
                return
            mvals, mids = f.result()
            if use_cache:
                for j, i in enumerate(miss_pos):
                    self._cache.put(keys[i], mvals[j], mids[j])
            if len(miss_pos) == n:
                resolve(mvals, mids, "drained")
                return
            vals = np.empty((n,) + mvals.shape[1:], mvals.dtype)
            ids = np.empty((n,) + mids.shape[1:], mids.dtype)
            for i, r in enumerate(rows):
                if r is not None:
                    vals[i], ids[i] = r
            for j, i in enumerate(miss_pos):
                vals[i], ids[i] = mvals[j], mids[j]
            resolve(vals, ids, "drained")

        inner.add_done_callback(on_done)
        return out

    def search(self, queries: Sequence[Union[str, bytes]], k: int = 10,
               timeout: Optional[float] = None, *, scorer=None,
               filter=None) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking convenience wrapper over :meth:`submit`."""
        return self.submit(queries, k, scorer=scorer,
                           filter=filter).result(timeout=timeout)

    def default_scorer_key(self) -> str:
        """Canonical key of the scorer requests score under when they
        name none — what the canary prober captures its oracle with."""
        return self._default_scorer.key()

    def set_scorer(self, spec) -> int:
        """Change the server's DEFAULT scorer live (the ``set_scorer``
        JSONL op). Routed through :meth:`_install_index` — same
        retriever, but the epoch bumps, the result cache clears and
        the canary oracle re-captures under the new default, because a
        scorer change IS a visibility change: the same query now
        returns different bytes. Returns the new epoch."""
        parsed = parse_scorer(spec)
        with self._lock:
            retriever = self._retriever
            self._default_scorer = parsed
        return self._install_index(retriever, "scorer_change")

    def swap_index(self, retriever: TfidfRetriever) -> int:
        """Hot-swap the serving index: new submissions score against
        ``retriever`` immediately, in-flight requests finish on the
        index they were admitted under, and the result cache is
        invalidated (epoch bump + clear). Swap listeners (the canary
        prober's oracle re-capture) run synchronously BEFORE the epoch
        returns, so the swap is observable the instant it is live.
        Returns the new epoch.

        A swap racing :meth:`close` either completes or raises the
        typed :class:`ServerClosed` — never deadlocks (close never
        holds the admission lock while draining, and the snapshot /
        listeners here run outside it). With ``snapshot_dir``
        configured, the NEW epoch is snapshotted BEFORE the flip:
        a crash at any instant after the swap returns restores the
        index that was serving — the swap-then-crash hole is closed.
        """
        if not retriever.indexed:
            raise ValueError("swap_index needs an indexed retriever")
        faults.fire("swap", epoch=self._epoch + 1)
        if self.config.snapshot_dir:
            # Persist the incoming epoch first: if we crash between
            # here and the flip, the snapshot is merely ahead by one
            # swap that never went live — restoring it serves the
            # index the swap was installing, never a torn state.
            retriever.snapshot(self.config.snapshot_dir,
                               epoch=self._epoch + 1)
        # Swapping in an index that is NOT a view of the attached
        # segments detaches them: the full-rebuild fallback replaces
        # the segmented world wholesale, and further mutations must
        # say so instead of mutating a detached index nobody serves.
        with self._lock:
            if (self._segments is not None
                    and getattr(retriever, "owner", None)
                    is not self._segments):
                self._segments = None
                obs_log.log_event(
                    "warning", "index_swap",
                    msg="full-rebuild swap detached the segmented "
                        "index; add_docs/delete_docs now reject",
                    epoch=self._epoch + 1, reason="detach_segments")
        return self._install_index(retriever, "swap_index")

    def _install_index(self, retriever: TfidfRetriever,
                       reason: str) -> int:
        """THE visibility transition: atomically install ``retriever``
        (a plain retriever or a segmented :class:`~tfidf_tpu_torch.index.
        IndexView`), bump the epoch, clear the epoch-keyed result
        cache and run the swap listeners (canary oracle re-capture)
        synchronously — every path that changes what a query could
        observe (swap, add, delete, seal, compaction install) funnels
        here, which is the no-stale-cache / no-false-canary contract
        tests/test_index.py pins for the JAX package. Under
        ``mesh_shards`` the incoming index is re-sharded first, outside
        the admission lock (placement is slow; the flip stays atomic)."""
        if self._index_transform is not None:
            retriever = self._index_transform(retriever)
        self._apply_query_slab(retriever)
        with self._lock:
            if self._closed:
                raise ServerClosed("server is closed")
            self._retriever = retriever
            self._epoch += 1
            epoch = self._epoch
        self._cache.clear()
        if reason == "swap_index":
            obs_log.log_event(
                "info", "index_swap",
                msg=f"index swapped to epoch {epoch} "
                    f"({retriever._num_docs} docs)",
                epoch=epoch, docs=retriever._num_docs)
        else:
            obs_log.log_event(
                "info", "index_mutation",
                msg=f"index visibility -> epoch {epoch} "
                    f"({retriever._num_docs} docs, {reason})",
                epoch=epoch, docs=retriever._num_docs, reason=reason)
        for listener in list(self._swap_listeners):
            listener(epoch, retriever)
        return epoch

    # --- live mutation ---
    def attach_segments(self, segments) -> None:
        """Wire a :class:`~tfidf_tpu_torch.index.SegmentedIndex` into this
        server: :meth:`add_docs` / :meth:`delete_docs` /
        :meth:`compact_now` mutate it and install fresh views through
        :meth:`_install_index`, and the segment gauges
        (``serve_segment_count`` / ``serve_delta_fill_milli`` /
        ``serve_tombstones``) publish its shape."""
        reg = self.metrics.registry
        with self._lock:
            self._segments = segments
            if self._g_segments is None:
                self._g_segments = reg.gauge(
                    "serve_segment_count",
                    "segments serving (sealed + non-empty delta)")
                self._g_delta_fill = reg.gauge(
                    "serve_delta_fill_milli",
                    "delta-segment fill fraction in 1/1000")
                self._g_tombstones = reg.gauge(
                    "serve_tombstones",
                    "tombstoned (deleted/updated) rows awaiting "
                    "compaction")
        self._update_segment_gauges()

    def _segments_or_raise(self):
        with self._lock:
            segments = self._segments
        if segments is None:
            raise RuntimeError(
                "no segmented index attached (serve with --delta-docs, "
                "or TfidfServer.attach_segments)")
        return segments

    def _update_segment_gauges(self) -> None:
        with self._lock:
            segments, g_seg = self._segments, self._g_segments
        if segments is None or g_seg is None:
            return
        stats = segments.stats()
        g_seg.set(stats["segments"])
        self._g_delta_fill.set(int(round(stats["delta_fill"] * 1000)))
        self._g_tombstones.set(stats["tombstones"])

    def add_docs(self, names: Sequence[str],
                 docs: Sequence[Union[str, bytes]]) -> dict:
        """Add/update documents in the attached segmented index and
        make them visible: one mutation, one epoch bump, cache cleared,
        canary re-captured — all before this returns (visibility lag
        IS this call's latency; the mutate bench measures it)."""
        segments = self._segments_or_raise()
        with self._mutate_lock:
            summary = segments.add_docs(names, docs)
            epoch = self._install_index(segments.view(), "add_docs")
        self._update_segment_gauges()
        summary["epoch"] = epoch
        return summary

    def delete_docs(self, names: Sequence[str]) -> dict:
        """Tombstone documents by name. A delete that removed nothing
        installs nothing (no visibility change to publish)."""
        segments = self._segments_or_raise()
        with self._mutate_lock:
            summary = segments.delete_docs(names)
            if summary["deleted"]:
                summary["epoch"] = self._install_index(
                    segments.view(), "delete_docs")
            else:
                summary["epoch"] = self.epoch
        self._update_segment_gauges()
        return summary

    def compact_now(self, force: bool = False):
        """One threshold-checked compaction pass + view install — the
        :class:`~tfidf_tpu_torch.index.Compactor`'s tick, also callable
        directly (tests, ops). Returns the compaction summary dict
        (with the installed epoch) or None when below threshold or
        when no segmented index is attached (a detached compactor tick
        is a no-op, not a crash)."""
        with self._lock:
            segments = self._segments
            if segments is None or self._closed:
                return None
        with self._mutate_lock:
            summary = segments.compact(force=force)
            if summary is None:
                return None
            try:
                summary["epoch"] = self._install_index(
                    segments.view(), "compaction")
            except ServerClosed:
                return None   # close raced the tick; nothing serves it
            if self.config.snapshot_dir:
                # Compaction is a durability point: the merged state
                # commits atomically, so a SIGKILL at any later
                # instant restores at worst the last compaction (plus
                # the boot/explicit-snapshot commits) — the classic
                # LSM trade of an unfsynced memtable tail.
                segments.save(self.config.snapshot_dir,
                              epoch=summary["epoch"])
        self._update_segment_gauges()
        return summary

    def snapshot(self, snapshot_dir: Optional[str] = None) -> str:
        """Persist the CURRENT resident index (CSR arrays + IDF +
        names + epoch + config fingerprint, checksummed) under
        ``snapshot_dir`` (default ``config.snapshot_dir``) through
        ``checkpoint.py``'s seq+LATEST atomic protocol. A process
        killed at any instant leaves the previous committed snapshot
        restorable; the serve CLI's ``--snapshot-dir`` restores it on
        start so a restarted server serves in seconds instead of
        re-ingesting. Returns the snapshot directory."""
        d = snapshot_dir or self.config.snapshot_dir
        if not d:
            raise ValueError("no snapshot dir (pass one or set "
                             "ServeConfig.snapshot_dir)")
        with self._lock:
            epoch, retriever = self._epoch, self._retriever
        t0 = time.monotonic()
        retriever.snapshot(d, epoch=epoch)
        obs_log.log_event(
            "info", "index_snapshot",
            msg=f"index snapshot (epoch {epoch}, "
                f"{retriever._num_docs} docs) -> {d} "
                f"in {time.monotonic() - t0:.3f}s",
            epoch=epoch, docs=retriever._num_docs, dir=d)
        return d

    def attach_device_monitor(self, monitor) -> None:
        """Wire a :class:`~tfidf_tpu_torch.obs.devmon.DeviceMonitor` into
        this server: the resident index registers as a census owner
        (the registration reads ``self._retriever`` live, so a hot
        swap re-attributes automatically) and the monitor's memory
        pressure becomes a degraded health signal — high HBM shrinks
        the admission bound exactly like queue saturation does."""
        monitor.register_owner("resident_index", self._index_arrays)
        monitor.register_shards(self._shard_stats)
        self.health.add_signal("memory_pressure", monitor.health_signal)

    def _shard_stats(self):
        """Per-shard bytes of the CURRENT index (None when it is not
        mesh-sharded): the device monitor's ``shard_bytes_d*`` /
        ``shard_imbalance_milli`` feed."""
        fn = getattr(self._retriever, "shard_stats", None)
        return fn() if fn is not None else None

    def mark_warm(self) -> None:
        """Declare serve warm-up complete: the compile watchdog flags
        every later fingerprinted compile as a steady-state recompile
        (flight event + windowed degraded reason). The serve CLI and
        tools/serve_bench.py call this after touching every
        power-of-two query bucket."""
        self.compile_watch.mark_warm()

    def _index_arrays(self):
        r = self._retriever
        if hasattr(r, "index_arrays"):   # a retriever, view or sharded
            return r.index_arrays()
        return [r._ids, r._weights, r._head, r._idf]

    def add_swap_listener(self, fn: Callable) -> None:
        """Register ``fn(epoch, retriever)`` to run synchronously after
        every :meth:`swap_index` — how the canary prober re-captures
        its oracle at the only moment the new index is known-good."""
        self._swap_listeners.append(fn)

    def remove_swap_listener(self, fn: Callable) -> None:
        try:
            self._swap_listeners.remove(fn)
        except ValueError:
            pass

    def current_index(self) -> Tuple[int, TfidfRetriever]:
        """The (epoch, retriever) pair new submissions would score on."""
        with self._lock:
            return self._epoch, self._retriever

    def healthz(self) -> dict:
        """One watchdog evaluation, as the ``healthz`` op payload:
        typed status + reasons + raw checks + the effective admission
        bound (visibly below ``queue_depth`` while degraded)."""
        status = self.health.evaluate()
        out = status.as_dict()
        out["admission_bound"] = self.health.admission_bound(
            self.config.queue_depth)
        out["queue_depth"] = self.config.queue_depth
        out["uptime_s"] = round(time.monotonic() - self._t0, 3)
        return out

    def readyz(self) -> dict:
        """Readiness: serving is possible (indexed, not closed, not
        wedged). ``degraded`` stays ready — it still serves, just
        sheds earlier; ``unhealthy`` (a stalled worker) does not."""
        status = self.health.evaluate()
        ready = (not self._closed and self._retriever.indexed
                 and status.state != "unhealthy")
        return {"ready": ready, "status": status.state,
                "epoch": self._epoch}

    def fingerprint(self) -> dict:
        """Build/config identity for artifact provenance: a stable
        hash over the pipeline + serve configs plus corpus shape and
        backend — what makes a metrics snapshot self-describing in the
        perf ledger (two snapshots compare only if these match).
        ``backend`` is the index's device type, ``"cuda"`` or
        ``"cpu"``."""
        cfg = self._retriever.config
        ident = {
            "pipeline": {k: (v.value if hasattr(v, "value") else v)
                         for k, v in dataclasses.asdict(cfg).items()},
            "serve": dataclasses.asdict(self.config),
            "num_docs": self._retriever._num_docs,
            "backend": torch.device(self._retriever.device).type,
        }
        sha = hashlib.sha256(
            json.dumps(ident, sort_keys=True, default=str).encode()
        ).hexdigest()[:12]
        return {"config_sha": sha,
                "backend": ident["backend"],
                "num_docs": ident["num_docs"],
                "vocab_size": cfg.vocab_size}

    def metrics_snapshot(self, reset_peaks: bool = False) -> dict:
        """The ``metrics`` op / artifact snapshot: the pinned round-9
        ``ServeMetrics`` schema (tests assert a superset, guarding the
        ledger against silent renames) plus the self-describing keys —
        ``uptime_s``, current ``epoch`` and the build/config
        ``fingerprint`` — so a snapshot dropped into BENCH_LEDGER.jsonl
        still says what it measured."""
        snap = self.metrics.snapshot(reset_peaks=reset_peaks)
        snap["uptime_s"] = round(time.monotonic() - self._t0, 3)
        snap["epoch"] = self._epoch
        snap["fingerprint"] = self.fingerprint()
        # The SLO snapshot the serve CLI's ``metrics`` op promises:
        # windowed objective compliance + fast/slow burn rates when an
        # objective is configured (--slo-ms / TFIDF_TPU_SLO_MS), a
        # typed "not configured" marker otherwise — the key is always
        # present.
        snap["slo"] = (self.slo.snapshot() if self.slo is not None
                       else {"configured": False})
        return snap

    def metrics_prom(self) -> str:
        """Prometheus text exposition of the serve metrics (request
        latency histogram buckets included) — the ``metrics_prom``
        JSONL op and anything scraping a long-running server."""
        return self.metrics.render_prom()

    def obs_export(self) -> dict:
        """The cross-process federation bundle (``obs_export`` JSONL
        op): a versioned snapshot of this process's observability
        state — full registry instrument state (histogram buckets +
        exemplars, so :meth:`~tfidf_tpu_torch.obs.registry.MetricsRegistry.
        merge` works losslessly on the receiving side), the recent
        flight-event tail and request digests, plus identity. This is
        what ``tools/obs_agg.py`` polls from N replicas and renders as
        one merged Prometheus/JSON view."""
        if self.slo is not None:
            self.slo.snapshot()   # refresh the slo gauges pre-export
        log = obs_log.get_log()
        return {
            "schema": "tfidf-obs/1",
            "pid": os.getpid(),
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "epoch": self._epoch,
            "fingerprint": self.fingerprint(),
            "registry": self.metrics.registry.export_state(),
            "flight_tail": log.events()[-64:],
            "digest_tail": log.digests()[-32:],
        }

    def close(self, drain: bool = True) -> None:
        """Stop admitting; ``drain=True`` serves the queued backlog
        before returning, ``drain=False`` fails it fast. Stops the
        health watchdog and — when a flight path is armed (``--flight``
        / ``TFIDF_TPU_FLIGHT``, or derived from an armed tracer) —
        dumps the flight recorder, so a clean shutdown leaves the same
        evidence a crash does. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._batcher.close(drain=drain)
        self.health.stop()
        if self.devmon is not None:
            self.devmon.stop()
        if obs_devmon.get_watch() is self.compile_watch:
            obs_devmon.set_watch(None)
        if self._armed_faults is not None:
            faults.disarm()
        obs_log.dump_flight()  # no-op unless a dump path is armed

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "TfidfServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=True)

    # --- internals ---
    def _finish(self, n: int) -> None:
        with self._lock:
            self._inflight -= n
            self.metrics.set_queue_depth(self._inflight)

    def _resolve_forensics(self, ctx, outcome: str) -> None:
        """Close one request's forensic record (obs/reqtrace.py): the
        phase breakdown resolves, and a request over the slow-query
        threshold (or the 1-in-N tail sample) emits its ``slow_query``
        flight event and bumps ``serve_slow_queries_total``."""
        tag = reqtrace.finish(ctx, outcome, slow_ms=self._slow_ms,
                              sample_every=self._slow_sample)
        if tag == "slow":
            self.metrics.count("slow_queries")

    def _digest(self, t0: float, n: int, k: int, outcome: str,
                epoch: Optional[int] = None,
                cache_hits: Optional[int] = None,
                error: Optional[str] = None,
                rid: Optional[str] = None) -> None:
        """One request digest into the flight recorder's last-N ring —
        sizes, outcome and latency, never query text (the dump may
        leave the machine). Cheap enough to record unconditionally.
        ``rid`` joins the digest to the request's spans and its JSONL
        response."""
        rec = {"outcome": outcome, "queries": n, "k": k,
               "ms": round((time.monotonic() - t0) * 1e3, 3)}
        if rid is not None:
            rec["rid"] = rid
        if epoch is not None:
            rec["epoch"] = epoch
        if cache_hits:
            rec["cache_hits"] = cache_hits
        if error:
            rec["error"] = error
        obs_log.record_digest(**rec)
