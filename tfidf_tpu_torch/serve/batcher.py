"""Dynamic micro-batching: a thread-safe submit queue in front of the
batch search (port of ``tfidf_tpu/serve/batcher.py``; the JAX package's
code).

``submit`` enqueues a request and returns a
``concurrent.futures.Future``; a single worker thread drains the queue
into device batches, flushing when the coalesced batch reaches
``max_batch`` queries or when the OLDEST queued request has waited
``max_wait_ms``. Batches group by ``(k, group)`` (the server passes its
``(epoch, retriever, scorer, filter)`` snapshot as ``group``, so one
batch never mixes indexes across a hot swap). Query counts are
power-of-two bucketed inside ``TfidfRetriever.search``; the occupancy
metric divides by that bucket (:func:`_pow2`), as in the JAX package.

Requests stay atomic: one request's queries always score in one batch,
and per-query results are independent, so slicing a coalesced batch
back per request is exact.

The worker thread is SUPERVISED: an exception escaping the loop (a bug,
or an injected ``batcher_loop`` fault) restarts it with backoff inside
a restart budget; past the budget the batcher declares itself dead,
fails everything queued, and ``submit`` raises. With a
:class:`~tfidf_tpu_torch.serve.supervisor.SupervisedDispatch` attached,
the device call gets bounded retry and poison-query bisection.

Pipelined execution: with ``pipeline_depth >= 2`` the batcher thread is
a DISPATCH stage — it issues ``dispatch_fn(queries, k, group)``, which
returns a :class:`~tfidf_tpu_torch.models.retrieval.PendingSearch`
(the retriever's ``search_async``: the query entries' non-blocking H2D
copy and the block built on the device, the search launched on the stream, the result's non-blocking
D2H copy into pinned memory and a CUDA event) — and returns to
coalescing. A single ordered DRAIN worker materializes results FIFO
(waiting on the event), releases slab slots and resolves futures. The
in-flight window is bounded at ``pipeline_depth`` batches. A device
error surfaces when the drain stage waits on the result, so the
supervisor's retry/breaker/bisection runs at drain time
(``SupervisedDispatch.run_batch``'s ``first`` seam), re-dispatching
through the same ordered window. Responses are bit-identical to direct
search at every depth; ``pipeline_depth=1`` keeps the one-stage
``_execute`` path.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable, Deque, List, Optional, Sequence, Union

from collections import deque

import numpy as np

from tfidf_tpu_torch import faults, obs
from tfidf_tpu_torch.obs import devmon as obs_devmon
from tfidf_tpu_torch.obs import log as obs_log


class ServeError(RuntimeError):
    """Base class for typed serving-layer failures."""


class Overloaded(ServeError):
    """Admission control shed the request: the in-flight query backlog
    is at ``queue_depth``. Clients should back off and retry."""


class DeadlineExceeded(ServeError):
    """The request's deadline expired while it was still queued; it was
    shed without touching the device."""


class ServerClosed(ServeError):
    """The server (or batcher) is closed: the operation raced a
    shutdown and was refused, not lost — retry against a live
    replica. ``swap_index``/``submit`` raise this instead of
    deadlocking against a draining close."""


class PoisonQuery(ServeError):
    """The request contained a query isolated as poison (its dispatch
    fails deterministically) or already quarantined. The rest of its
    batch was unaffected; resubmitting the same query fails fast
    (the 4xx of this protocol)."""

    def __init__(self, msg: str, queries: Sequence = ()):
        super().__init__(msg)
        self.queries = list(queries)


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


class _Resolved:
    """Already-materialized stand-in for a ``PendingSearch`` — wraps a
    synchronous ``search_fn`` result so the pipelined machinery has
    one drain path whether or not the dispatch could defer."""

    __slots__ = ("_r",)

    def __init__(self, result):
        self._r = result

    def materialize(self):
        return self._r


class _InFlight:
    """One dispatched-but-undrained batch in the pipeline window."""

    __slots__ = ("bid", "live", "queries", "offsets", "rids", "pending",
                 "error", "t_formed", "t_dev0", "span", "dev")

    def __init__(self, bid, live, queries, offsets, rids):
        self.bid = bid
        self.live = live            # _Pending entries riding the batch
        self.queries = queries
        self.offsets = offsets
        self.rids = rids
        self.pending = None         # PendingSearch-shaped handle
        self.error = None           # dispatch-stage failure, deferred
        self.t_formed = 0.0
        self.t_dev0 = 0.0
        self.span = None            # open "batched" span handle
        self.dev = None             # open "device" span handle


class _Pending:
    __slots__ = ("queries", "k", "group", "future", "deadline",
                 "enqueued_at", "obs", "ctx")

    def __init__(self, queries, k, group, deadline, ctx=None):
        self.queries = queries
        self.k = k
        self.group = group
        self.future: Future = Future()
        self.deadline = deadline          # absolute monotonic, or None
        self.enqueued_at = time.monotonic()
        # Request forensics: the server's RequestContext
        # rides the pending entry so the batcher can stamp its rid on
        # the queued span and mark the queue/batch/device phases the
        # slow-query breakdown reports.
        self.ctx = ctx
        # Queue-wait span: opens at submit, closes when the batch forms
        # (batch-id attributed) or the request sheds — the "queued"
        # stage of the request lifecycle chain (docs/OBSERVABILITY.md).
        if ctx is not None:
            kw = {"queries": len(self.queries), "k": self.k,
                  "rid": ctx.rid}
            if getattr(ctx, "trace", None):
                kw["trace"] = ctx.trace   # fleet trace id
            self.obs = obs.begin("queued", **kw)
        else:
            self.obs = obs.begin("queued", queries=len(self.queries),
                                 k=self.k)


class MicroBatcher:
    """Coalesces concurrent submits into padded device batches.

    Args:
      search_fn: ``(queries, k, group) -> (vals, ids)`` — the batch
        kernel (the server binds this to the epoch-snapshotted
        retriever's ``search``).
      max_batch: flush threshold in queries.
      max_wait_ms: oldest-request wait bound before a partial flush.
      metrics: optional :class:`~tfidf_tpu_torch.serve.metrics.ServeMetrics`
        for batch-occupancy and deadline-shed counters.
      heartbeat: optional zero-arg liveness callback the worker thread
        invokes every loop wake and around every batch — the
        :class:`~tfidf_tpu_torch.obs.health.HealthMonitor` stall signal (a
        busy batcher that stops beating is a wedged pipeline).
      supervisor: optional :class:`~tfidf_tpu_torch.serve.supervisor.
        SupervisedDispatch` — the device call then gets bounded retry
        and poison bisection; None keeps the bare round-9 dispatch
        (one failure fails the whole batch).
      restart_budget: worker-loop crash restarts tolerated before the
        batcher declares itself dead (fails queued work, refuses
        submits). 0 disables supervision (a loop crash is fatal
        immediately).
      restart_backoff_ms: base of the jittered exponential backoff
        between loop restarts.
      pipeline_depth: bounded in-flight window — up to
        this many dispatched batches overlap with coalescing and
        with each other's drains. 1 (the default here; the server
        config defaults to 2) keeps the legacy single-stage path.
      dispatch_fn: ``(queries, k, group) -> PendingSearch`` — the
        async dispatch stage (the server binds
        ``TfidfRetriever.search_async``). Only consulted at
        ``pipeline_depth >= 2``; absent, the pipeline still runs its
        staged machinery over the synchronous ``search_fn`` (no
        device overlap, same ordering/recovery semantics — the
        duck-typed fallback for retrievers without a dispatch stage).
    """

    def __init__(self, search_fn: Callable, *, max_batch: int = 64,
                 max_wait_ms: float = 2.0, metrics=None,
                 heartbeat: Optional[Callable[[], None]] = None,
                 supervisor=None, restart_budget: int = 3,
                 restart_backoff_ms: float = 50.0,
                 pipeline_depth: int = 1,
                 dispatch_fn: Optional[Callable] = None,
                 thread_name: str = "tfidf-serve-batcher") -> None:
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        if restart_budget < 0:
            raise ValueError("restart_budget must be >= 0")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        self._search_fn = search_fn
        self._dispatch_fn = dispatch_fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.pipeline_depth = pipeline_depth
        self._metrics = metrics
        self._heartbeat = heartbeat
        self._supervisor = supervisor
        self._restart_budget = restart_budget
        self._restart_backoff_ms = restart_backoff_ms
        self.restarts = 0
        self._dead = False
        self._batch_seq = 0   # trace batch-id; worker thread only
        self._queue: Deque[_Pending] = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._drain_on_close = True
        # Pipelined window state, all under _icond: the in-flight ring
        # the dispatch stage appends to and the drain worker pops
        # FIFO. A separate condition from _cond so a full window never
        # contends with the submit path.
        self._icond = threading.Condition()
        self._inflight: Deque[_InFlight] = deque()
        self._drain_stop = False
        self._pipe_streak = False   # batcher thread only: bubble det.
        self._inflight_gauge = None
        self._drainer: Optional[threading.Thread] = None
        if pipeline_depth > 1:
            if metrics is not None:
                self._inflight_gauge = metrics.registry.gauge(
                    "serve_inflight_batches",
                    "dispatched batches not yet drained (the "
                    "pipelined execution window)")
            self._drainer = threading.Thread(
                target=self._drain_run, daemon=True,
                name=thread_name + "-drain")
            self._drainer.start()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name=thread_name)
        self._worker.start()

    # --- submit side ---
    def submit(self, queries: Sequence[Union[str, bytes]], k: int,
               group=None, deadline: Optional[float] = None,
               ctx=None) -> Future:
        """Enqueue one request; the Future resolves to the ``(vals,
        ids)`` pair for exactly these queries (rows in submit order).
        ``deadline`` is an absolute ``time.monotonic()`` instant; a
        request still queued past it fails with
        :class:`DeadlineExceeded`. ``ctx`` is the server's optional
        :class:`~tfidf_tpu_torch.obs.reqtrace.RequestContext` — the request
        identity stamped through the span chain."""
        p = _Pending(list(queries), int(k), group, deadline, ctx=ctx)
        with self._cond:
            if self._closed:
                raise ServerClosed("batcher is closed")
            if self._dead:
                raise ServeError(
                    f"batcher worker is dead (restart budget "
                    f"{self._restart_budget} exhausted)")
            self._queue.append(p)
            self._cond.notify_all()
        return p.future

    def queued_queries(self) -> int:
        with self._cond:
            return sum(len(p.queries) for p in self._queue)

    def inflight_batches(self) -> int:
        """Dispatched-but-undrained batches in the pipeline window
        (always 0 at depth 1 — execution is single-stage there)."""
        with self._icond:
            return len(self._inflight)

    # --- worker side ---
    def _take_batch(self) -> Optional[List[_Pending]]:
        """Block until a batch is due under the deadline policy, then
        pop it. Returns None only at close time with an empty queue."""
        with self._cond:
            while True:
                if self._heartbeat is not None:
                    self._heartbeat()
                if not self._queue:
                    if self._closed:
                        return None
                    # Going idle ends a pipelined burst: the next
                    # dispatch onto an empty window is a fresh start,
                    # not a bubble (batcher thread only).
                    self._pipe_streak = False
                    self._cond.wait()
                    continue
                head = self._queue[0]
                now = time.monotonic()
                flush_at = head.enqueued_at + self.max_wait
                if (self._ready_queries(head) >= self.max_batch
                        or now >= flush_at or self._closed):
                    return self._pop_batch(head)
                self._cond.wait(timeout=flush_at - now)

    def _ready_queries(self, head: _Pending) -> int:
        return sum(len(p.queries) for p in self._queue
                   if p.k == head.k and p.group == head.group)

    def _pop_batch(self, head: _Pending) -> List[_Pending]:
        """Pop the head plus every queued request with the same (k,
        group) until ``max_batch`` queries — FIFO within the key;
        other keys keep their queue positions."""
        batch: List[_Pending] = []
        taken = 0
        remaining: Deque[_Pending] = deque()
        for p in self._queue:
            compatible = p.k == head.k and p.group == head.group
            if (compatible
                    and (taken + len(p.queries) <= self.max_batch
                         or not batch)):
                batch.append(p)
                taken += len(p.queries)
            else:
                remaining.append(p)
        self._queue = remaining
        return batch

    def _run(self) -> None:
        """Supervision wrapper: restart the loop on a crash (with
        backoff, inside the restart budget) so an exception escaping
        the batching machinery — a bug, or an injected
        ``batcher_loop`` fault — never leaves a zombie server whose
        queue silently grows forever. Queued requests survive a
        restart untouched (the deque is shared state, not loop
        state); past the budget everything queued fails with a typed
        error and the batcher refuses new work."""
        while True:
            try:
                self._loop()
                return                  # clean exit: close() observed
            except BaseException as e:  # noqa: BLE001 — supervised
                self.restarts += 1
                if self._metrics is not None:
                    self._metrics.count("worker_restarts")
                over = self.restarts > self._restart_budget
                obs_log.log_event(
                    "error" if over else "warning",
                    "worker_restart",
                    msg=f"batcher loop crashed "
                        f"({type(e).__name__}: {e}); "
                        + ("restart budget exhausted — batcher is "
                           "dead" if over else
                           f"restart {self.restarts}/"
                           f"{self._restart_budget}"),
                    worker="batcher", restart=self.restarts,
                    error=type(e).__name__)
                obs.instant("worker_restart", worker="batcher",
                            restart=self.restarts)
                if over or self._closed:
                    self._die(e)
                    return
                time.sleep(faults.backoff_s(
                    self.restarts, self._restart_backoff_ms))

    def _die(self, err: BaseException) -> None:
        with self._cond:
            self._dead = True
            pending = list(self._queue)
            self._queue.clear()
            self._cond.notify_all()
        for p in pending:
            obs.end(p.obs, outcome="error")
            p.future.set_exception(ServeError(
                f"batcher worker died: {type(err).__name__}: {err}"))

    def _loop(self) -> None:
        while True:
            if self._heartbeat is not None:
                self._heartbeat()
            faults.fire("batcher_loop")
            with obs.span("take"):
                batch = self._take_batch()
            if batch is None:
                return
            if self.pipeline_depth > 1:
                self._dispatch(batch)
            else:
                self._execute(batch)
            if self._heartbeat is not None:
                self._heartbeat()

    def _screen(self, batch: List[_Pending]) -> List[_Pending]:
        """Shed entries a formed batch can no longer serve (closing
        without drain, expired deadline); returns the live rest."""
        now = time.monotonic()
        live: List[_Pending] = []
        for p in batch:
            if self._closed and not self._drain_on_close:
                obs.end(p.obs, outcome="rejected")
                p.future.set_exception(ServeError("server closed"))
            elif p.deadline is not None and now >= p.deadline:
                if self._metrics is not None:
                    self._metrics.count("shed_deadline")
                obs.end(p.obs, outcome="shed_deadline")
                p.future.set_exception(DeadlineExceeded(
                    f"deadline expired {now - p.deadline:.3f}s before "
                    f"the batch formed"))
            else:
                live.append(p)
        return live

    def _form(self, live: List[_Pending]):
        """Assign the batch id, close the queued spans, flatten the
        requests: -> (bid, t_formed, queries, offsets, rids)."""
        bid = self._batch_seq
        self._batch_seq += 1
        t_formed = time.monotonic()
        queries: List = []
        offsets = [0]
        for p in live:
            obs.end(p.obs, outcome="batched", batch=bid)
            if p.ctx is not None:
                # queue_wait measured at the same instant the queued
                # span ends — the breakdown and the trace record one
                # interval (the 5%+5ms reconciliation pin).
                p.ctx.mark("queue_wait", t_formed - p.enqueued_at)
            queries.extend(p.queries)
            offsets.append(len(queries))
        rids = [p.ctx.rid for p in live if p.ctx is not None]
        for p in live:
            if p.ctx is not None:
                p.ctx.batch = bid
                p.ctx.co_occupants = len(queries)
        return bid, t_formed, queries, offsets, rids

    @staticmethod
    def _span_extra(live, rids) -> dict:
        """rid + fleet-trace stamps for a batch's spans: ``rids`` is
        positional; ``traces`` is the deduped
        set of front-minted trace ids riding the batch, so a merged
        tier timeline joins batched/device/drain spans to the front's
        route spans without going through the rid table."""
        extra = {"rids": rids} if rids else {}
        traces = sorted({p.ctx.trace for p in live
                         if p.ctx is not None
                         and getattr(p.ctx, "trace", None)})
        if traces:
            extra["traces"] = traces
        return extra

    def _deliver(self, live, offsets, vals, ids, poison, bid) -> None:
        """Slice the batch result back per request and resolve the
        futures (poison rows fail typed, innocents get their rows)."""
        if not poison:
            vals, ids = np.asarray(vals), np.asarray(ids)
            for p, lo, hi in zip(live, offsets, offsets[1:]):
                p.future.set_result((vals[lo:hi], ids[lo:hi]))
            return
        # Poison isolation: requests carrying a poison query fail
        # with the typed error (naming THEIR poison queries);
        # every innocent request resolves from the bisection's
        # per-query rows — bit-identical to a clean dispatch.
        pset = set(poison)
        for p, lo, hi in zip(live, offsets, offsets[1:]):
            bad = [j - lo for j in range(lo, hi) if j in pset]
            if bad:
                p.future.set_exception(PoisonQuery(
                    f"{len(bad)} of {hi - lo} queries in this "
                    f"request poisoned batch {bid} and were "
                    f"quarantined",
                    queries=[p.queries[b] for b in bad]))
            else:
                p.future.set_result((vals[lo:hi], ids[lo:hi]))

    def _execute(self, batch: List[_Pending]) -> None:
        obs.name_thread("batcher")
        with obs.span("form"):
            live = self._screen(batch)
            if not live:
                return
            bid, t_formed, queries, offsets, rids = self._form(live)
            span_extra = self._span_extra(live, rids)
        # Recompile attribution: with a warm CompileWatch
        # armed, a recompile-count delta across THIS batch's device
        # call pins the offending batch on the trace timeline — the
        # flight event (obs/devmon.py) says which program, the
        # instant says when in the serve loop it struck.
        watch = obs_devmon.get_watch()
        pre_rc = (watch.recompile_count
                  if watch is not None and watch.warm else None)
        # Retry attribution: the counter delta across this
        # batch's supervised dispatch charges dispatch_retry backoffs
        # to the requests that rode the batch — a slow_query event
        # then SAYS its tail came from retries, not queueing.
        pre_retries = self._retry_count()
        with obs.span("batched", batch=bid, queries=len(queries),
                      requests=len(live), **span_extra):
            poison: List[int] = []
            try:
                # NVTX-wrapped (while CUDA is initialised): a device
                # capture carries the same batch id.
                t_dev0 = time.monotonic()
                with obs.device_span("device", batch=bid,
                                     queries=len(queries),
                                     **span_extra):
                    if self._supervisor is not None:
                        vals, ids, poison = self._supervisor.run_batch(
                            queries, live[0].k, live[0].group,
                            batch_id=bid, rids=rids or None)
                    else:
                        faults.fire("device_dispatch",
                                    queries=len(queries), batch=bid)
                        vals, ids = self._search_fn(queries, live[0].k,
                                                    live[0].group)
                t_dev1 = time.monotonic()
                for p in live:
                    if p.ctx is not None:
                        p.ctx.mark("batch_wait", t_dev0 - t_formed)
                        p.ctx.mark("device", t_dev1 - t_dev0)
                        p.ctx.mark_device_end(t_dev1)
            except BaseException as e:  # noqa: BLE001 — deliver
                for p in live:
                    p.future.set_exception(e)
                return
            retry_delta = self._retry_count() - pre_retries
            if retry_delta:
                for p in live:
                    if p.ctx is not None:
                        p.ctx.note("dispatch_retry", n=retry_delta)
            if (pre_rc is not None
                    and watch.recompile_count > pre_rc):
                obs.instant("recompile_in_batch", batch=bid,
                            queries=len(queries))
                for p in live:
                    if p.ctx is not None:
                        p.ctx.note("recompile_in_batch")
            if self._metrics is not None:
                self._metrics.observe_batch(len(queries),
                                            _pow2(len(queries)))
            self._deliver(live, offsets, vals, ids, poison, bid)

    # --- pipelined path: dispatch stage + drain worker ---
    def _dispatch(self, batch: List[_Pending]) -> None:
        """Stage 1 of the pipeline (batcher thread): screen, form,
        issue the async device call, park the in-flight entry for the
        drain worker. Blocks only while the window is full — never on
        device results — so the device always has the next batch
        queued behind the one it is crunching."""
        obs.name_thread("batcher")
        with obs.span("form"):
            live = self._screen(batch)
        if not live:
            return
        # Window admission BEFORE forming: batch ids and queued-span
        # outcomes are assigned in admission order, so the drain
        # worker's FIFO pop is batch-major by construction.
        # The drain worker outlives the dispatch worker (close() joins
        # it second), so this wait always makes progress — and the
        # window never exceeds depth, which is what lets the slab ring
        # pre-provision exactly ``depth`` slots per bucket.
        with self._icond:
            if len(self._inflight) >= self.pipeline_depth:
                # Opened only when the window is full: a batch that does
                # not wait records nothing.
                with obs.span("window_wait"):
                    while len(self._inflight) >= self.pipeline_depth:
                        if self._heartbeat is not None:
                            self._heartbeat()
                        self._icond.wait(0.05)
        was_empty = len(self._inflight) == 0
        bubble = was_empty and self._pipe_streak
        with obs.span("form"):
            live = self._screen(live)
            if not live:
                return
            bid, t_formed, queries, offsets, rids = self._form(live)
            span_extra = self._span_extra(live, rids)
        watch = obs_devmon.get_watch()
        pre_rc = (watch.recompile_count
                  if watch is not None and watch.warm else None)
        ent = _InFlight(bid, live, queries, offsets, rids)
        ent.t_formed = t_formed
        # The batched + device spans BEGIN here on the batcher lane
        # and END at drain — obs records a span on the thread that
        # began it, so the trace shape (device nested in batched on
        # the batcher lane, rids attached) is identical at any depth.
        ent.span = obs.begin("batched", batch=bid, queries=len(queries),
                             requests=len(live), **span_extra)
        ent.t_dev0 = time.monotonic()
        ent.dev = obs.begin("device", batch=bid, queries=len(queries),
                            **span_extra)
        try:
            # Async issue: the jitted call returns device futures; the
            # synchronous part (tracing/compile) still happens HERE,
            # which keeps recompile attribution on the dispatch side.
            with obs.device_span("issue", batch=bid):
                if self._dispatch_fn is not None:
                    ent.pending = self._dispatch_fn(queries, live[0].k,
                                                    live[0].group)
                else:
                    ent.pending = _Resolved(self._search_fn(
                        queries, live[0].k, live[0].group))
        except BaseException as e:  # noqa: BLE001 — fail at drain,
            ent.error = e          # in order, like any device error
        if (pre_rc is not None and watch.recompile_count > pre_rc):
            obs.instant("recompile_in_batch", batch=bid,
                        queries=len(queries))
            for p in live:
                if p.ctx is not None:
                    p.ctx.note("recompile_in_batch")
        with self._icond:
            self._inflight.append(ent)
            if self._inflight_gauge is not None:
                self._inflight_gauge.set(len(self._inflight))
            self._icond.notify_all()
        self._pipe_streak = True
        if bubble:
            # The device went idle between dispatches while work kept
            # arriving — the window drained to zero mid-streak.
            if self._metrics is not None:
                self._metrics.count("pipeline_bubbles")
            obs.instant("serve_pipeline_bubble", batch=bid)

    def _drain_run(self) -> None:
        """Drain worker: materialize in-flight batches strictly in
        dispatch order (one worker == batch-major resolution), release
        their futures, keep the heartbeat alive through long waits."""
        obs.name_thread("drain")
        while True:
            with self._icond:
                # No heartbeat on the IDLE wait: an empty window means
                # the dispatch worker owns liveness (it beats from
                # _take_batch and the window wait), and a wedged loop
                # with queued work must still starve the monitor into
                # the stall signal. The drain worker beats only while
                # it is actually draining — the in-flight waits that
                # used to starve the heartbeat.
                while not self._inflight and not self._drain_stop:
                    self._icond.wait(0.1)
                if not self._inflight and self._drain_stop:
                    return
                ent = self._inflight[0]   # peek; pop after resolution
            try:
                self._resolve(ent)
            except BaseException as e:  # noqa: BLE001 — never die
                for p in ent.live:
                    if not p.future.done():
                        p.future.set_exception(e)
            with self._icond:
                self._inflight.popleft()
                if self._inflight_gauge is not None:
                    self._inflight_gauge.set(len(self._inflight))
                self._icond.notify_all()
            if self._heartbeat is not None:
                self._heartbeat()

    def _resolve(self, ent: _InFlight) -> None:
        """Stage 2 (drain thread): wait for the device, run the
        supervision story (retry / breaker / poison bisection) exactly
        as the unpipelined path would, mark phases, deliver."""
        live, bid, queries = ent.live, ent.bid, ent.queries
        rids, offsets = ent.rids, ent.offsets
        span_extra = self._span_extra(live, rids)
        pre_retries = self._retry_count()
        err: Optional[BaseException] = None
        # The drain span closes BEFORE the batched span ends: the
        # whole resolution nests inside the batch's dispatch-to-
        # deliver lifetime (trace_check pins the containment).
        with obs.span("drain", batch=bid, queries=len(queries),
                      **span_extra):
            poison: List[int] = []
            try:
                # Attempt 1 consumes the already-dispatched pending
                # (or re-raises the captured dispatch error); retries
                # and bisection halves re-dispatch synchronously —
                # the fault seam, attempt accounting and breaker
                # story are the legacy path's, verbatim.
                def first(ent=ent):
                    if ent.error is not None:
                        raise ent.error
                    with obs.span("d2h_wait", batch=bid):
                        return ent.pending.materialize()
                if self._supervisor is not None:
                    # The supervisor fires the device_dispatch seam
                    # itself, once per attempt — same budget burn as
                    # the unpipelined path.
                    vals, ids, poison = self._supervisor.run_batch(
                        queries, live[0].k, live[0].group,
                        batch_id=bid, rids=rids or None, first=first)
                else:
                    faults.fire("device_dispatch",
                                queries=len(queries), batch=bid)
                    vals, ids = first()
                t_mat = time.monotonic()
                obs.end(ent.dev)
                ent.dev = None
                for p in live:
                    if p.ctx is not None:
                        p.ctx.mark("batch_wait", ent.t_dev0 - ent.t_formed)
                        p.ctx.mark("device", t_mat - ent.t_dev0)
                        p.ctx.mark_device_end(t_mat)
            except BaseException as e:  # noqa: BLE001 — deliver
                err = e
                if ent.dev is not None:
                    obs.end(ent.dev, outcome="error")
                    ent.dev = None
            else:
                retry_delta = self._retry_count() - pre_retries
                if retry_delta:
                    for p in live:
                        if p.ctx is not None:
                            p.ctx.note("dispatch_retry", n=retry_delta)
                if self._metrics is not None:
                    self._metrics.observe_batch(len(queries),
                                                _pow2(len(queries)))
                with obs.span("deliver", batch=bid):
                    self._deliver(live, offsets, vals, ids, poison, bid)
        if err is not None:
            obs.end(ent.span, outcome="error")
            ent.span = None
            for p in live:
                p.future.set_exception(err)
            return
        obs.end(ent.span)
        ent.span = None

    def _retry_count(self):
        """Current ``serve_dispatch_retries_total`` (0 without metrics
        or before the first retry created the counter)."""
        if self._metrics is None:
            return 0
        inst = self._metrics.registry.get("serve_dispatch_retries_total")
        return inst.value if inst is not None else 0

    # --- shutdown ---
    def close(self, drain: bool = True) -> None:
        """Stop accepting work and join the worker. ``drain=True``
        serves everything already queued first; ``drain=False`` fails
        queued requests with :class:`ServeError`."""
        with self._cond:
            if self._closed:
                self._cond.notify_all()
            self._closed = True
            self._drain_on_close = drain
            self._cond.notify_all()
        self._worker.join()
        if self._drainer is not None:
            # Worker joined => everything it will ever dispatch is in
            # the window; tell the drainer to exit once it's empty and
            # wait — close() returns with zero batches in flight.
            with self._icond:
                self._drain_stop = True
                self._icond.notify_all()
            self._drainer.join()

    @property
    def closed(self) -> bool:
        return self._closed
