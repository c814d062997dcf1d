"""Replicated serving tier: N replica processes behind one front (port
of ``tfidf_tpu/serve/front.py``).

One lightweight FRONT owns the client protocol and routes queries across
N worker processes, each a full
:class:`~tfidf_tpu_torch.serve.server.TfidfServer` on its own CUDA
context, spun up from the shared ``--snapshot-dir`` through the
``launch_rank`` star process model (``parallel/multihost.py``): the same
framed mpi_lite channels the sharded-ingest workers speak.

Two planes per replica:

* **data plane** — JSONL over the child's stdin/stdout, the exact
  ``tfidf serve`` protocol (``cli._serve_handle_line``): queries,
  health, obs_export, trace_export. Responses are matched by wire id, so
  the completion-order protocol survives the hop.
* **control plane** — framed mpi_lite messages (tags ``_CTRL`` /
  ``_CTRL_ACK``) carrying the two-phase epoch protocol. Control is
  strictly one-outstanding-per-replica (serialized under the front's
  swap lock), so the per-channel ordering the wire protocol pins is
  preserved by construction.

Routing is hash-by-normalized-query (shared-nothing result caches make
affinity the whole ballgame) with a least-loaded fallback when the
preferred replica is degraded (its own watchdog's ``healthz`` verdict,
polled by the front) or dead. On replica death the front re-routes that
replica's in-flight idempotent requests to survivors and respawns the
child from the shared snapshot under ``restart_budget``.

Index visibility changes (``swap_index``, ``add_docs`` /
``delete_docs``, compaction installs) are a **two-phase epoch bump**:

1. ``prepare`` on every live replica — stage the change (build the
   incoming index, validate the mutation), touching nothing visible;
2. a ``ping`` round — a replica that acked prepare and then died is
   caught HERE, before any replica has installed anything, and the
   transaction aborts with the tier still serving the old epoch
   everywhere;
3. the admission gate closes (new queries wait at the front), in-flight
   queries drain, ``commit`` fans out writer-first — the lowest live
   rank applies, snapshots the NEW epoch to the shared dir, then the
   rest apply — and the gate reopens.

Every response line echoes the epoch its request was admitted under, so
no response straddles a swap. A replica killed *during* the commit
fan-out may briefly disagree; the front heals it by restarting the
replica from the writer's snapshot and re-snapshotting from a live peer
until the epochs agree.

The device rides in each replica's spec: the front resolves the
caller's device once (``pipeline.resolve_device``, CUDA unless told
otherwise) before it spawns anything, and every replica builds its
index and server there, or fails its boot. N replicas on one card each
hold their own copy of the index and their own CUDA context.
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional

from tfidf_tpu_torch.obs import disttrace
from tfidf_tpu_torch.parallel.multihost import (MpiLiteComm, MpiLiteError,
                                          launch_rank)

__all__ = ["ReplicatedFront", "FrontError", "SwapAborted"]

# Control-plane tags: point-to-point tags are >= 0 in the mpi_lite
# protocol; these share the channel with nothing else (the front's
# swap lock serializes control traffic).
_CTRL = 11
_CTRL_ACK = 12

_OBS_SCHEMA = "tfidf-obs/1"
#: Fleet trace-export bundle schema: one entry per process
#: — its Chrome events verbatim plus the identity/clock metadata
#: tools/trace_merge.py aligns lanes with.
_TRACE_SCHEMA = "tfidf-trace/1"
#: Round trips per clock-offset handshake. Min-RTT filtering over 8
#: samples bounds the offset error by half the best observed pipe RTT
#: (tens of µs on a local socketpair) — far under any span we render.
_CLOCK_SAMPLES = 8

#: env the replicas must NOT inherit: trace/flight paths would have N
#: processes clobbering one file, and a leaked TFIDF_TPU_REPLICAS
#: must never make a replica try to spawn a tier of its own.
_STRIP_ENV = ("TFIDF_TPU_TRACE", "TFIDF_TPU_FLIGHT",
              "TFIDF_TPU_REPLICAS", "TFIDF_TPU_FAULTS")


class FrontError(RuntimeError):
    """The front could not complete a request (no live replicas, a
    replica unreachable past its timeout, a refused mutation)."""


class SwapAborted(FrontError):
    """A two-phase epoch transaction aborted before any replica
    installed it — the tier is still serving the OLD epoch everywhere
    (the invariant the chaos kill-mid-swap rehearsal pins)."""


class _Pending:
    """One forwarded request awaiting its response line."""

    __slots__ = ("req", "rank", "boot", "event", "response",
                 "retryable")

    def __init__(self, req: dict, retryable: bool):
        self.req = req
        self.rank = -1
        self.boot = -1
        self.event = threading.Event()
        self.response: Optional[dict] = None
        self.retryable = retryable


class _Replica:
    """Front-side handle for one replica process."""

    __slots__ = ("rank", "proc", "boot", "state", "epoch", "routed",
                 "inflight", "restarts", "health", "ready_evt",
                 "ready_info", "wlock", "num_docs", "pid")

    def __init__(self, rank: int):
        self.rank = rank
        self.proc: Optional[subprocess.Popen] = None
        self.boot = -1
        # down | starting | live | dead | failed | stopping
        self.state = "down"
        self.epoch = 0
        self.routed = 0
        self.inflight = 0
        self.restarts = 0
        self.health = "ok"
        self.ready_evt: Optional[threading.Event] = None
        self.ready_info: Optional[dict] = None
        self.wlock = threading.Lock()   # stdin line-atomicity
        self.num_docs = 0
        self.pid: Optional[int] = None


class ReplicatedFront:
    """The tier: spawn N replicas from a shared snapshot, route
    queries, supervise restarts, drive two-phase epoch swaps, and
    merge the fleet's observability into one view.

    ``serve_cfg.replicas`` is N and ``serve_cfg.snapshot_dir`` is the
    shared checkpoint root (both required). The pipeline config and
    ``input_dir`` are what replica 1 bootstraps the index from when
    the snapshot root is empty; every other boot restores. ``device``
    is where every replica serves (default CUDA; raises here, before
    any spawn, when CUDA is asked for and absent).
    """

    def __init__(self, input_dir: Optional[str], pipeline_cfg,
                 serve_cfg, *, k: int = 10, no_strict: bool = False,
                 doc_len: Optional[int] = None, device=None):
        if not serve_cfg.replicas:
            raise ValueError("ReplicatedFront needs "
                             "ServeConfig.replicas >= 1")
        from tfidf_tpu_torch.pipeline import resolve_device
        self._device = resolve_device(device)
        self._input_dir = input_dir
        self._pipeline_cfg = pipeline_cfg
        self._serve_cfg = serve_cfg
        self._n = int(serve_cfg.replicas)
        self._size = self._n + 1          # rank 0 = the front
        self._k = k
        self._no_strict = no_strict
        self._doc_len = doc_len
        self._comm = MpiLiteComm(0, self._size, [-1] * self._size)
        self._replicas: Dict[int, _Replica] = {
            r: _Replica(r) for r in range(1, self._size)}
        self._lock = threading.Lock()        # routing / pending state
        self._swap_lock = threading.Lock()   # mutations + restarts
        self._admission = threading.Event()  # closed during commits
        self._admission.set()
        self._pending: Dict[int, _Pending] = {}
        self._ids = itertools.count(1)
        self._txns = itertools.count(1)
        self._epoch = 0
        self._closed = False
        self._started = False
        self._t0 = time.monotonic()
        self._specs_dir = tempfile.mkdtemp(prefix="tfidf_front_")
        self._restart_q: "queue.Queue[Optional[int]]" = queue.Queue()
        # Fleet tracing: ServeConfig.disttrace overrides
        # the env default for this process AND (via the spec) every
        # replica; per-replica clock-offset estimators feed the
        # trace-export metadata tools/trace_merge.py aligns with.
        if serve_cfg.disttrace is not None:
            disttrace.configure(serve_cfg.disttrace)
        self._clocks: Dict[int, disttrace.ClockOffsetEstimator] = {
            r: disttrace.ClockOffsetEstimator()
            for r in range(1, self._size)}

        from tfidf_tpu_torch.obs.registry import MetricsRegistry
        self._registry = MetricsRegistry()
        self._m_routed = self._registry.counter(
            "serve_front_routed_total",
            "query requests the front routed to a replica")
        self._m_rerouted = self._registry.counter(
            "serve_front_rerouted_total",
            "in-flight requests re-routed off a dead replica")
        self._m_fallbacks = self._registry.counter(
            "serve_front_route_fallbacks_total",
            "routes that left the hash-preferred replica "
            "(degraded/dead) for the least-loaded one")
        self._m_restarts = self._registry.counter(
            "serve_front_replica_restarts_total",
            "replica processes respawned by the front")
        self._m_commits = self._registry.counter(
            "serve_front_epoch_commits_total",
            "two-phase epoch transactions committed tier-wide")
        self._m_aborts = self._registry.counter(
            "serve_front_epoch_aborts_total",
            "two-phase epoch transactions aborted (tier stayed on "
            "the old epoch)")
        self._m_live = self._registry.gauge(
            "serve_front_replicas_live", "replicas currently serving")

    # --- lifecycle ---------------------------------------------------

    def start(self) -> "ReplicatedFront":
        """Bootstrap the tier: replica 1 first (it builds + snapshots
        when the snapshot root is empty), then the rest restore from
        the snapshot concurrently."""
        if self._started:
            return self
        from tfidf_tpu_torch import obs
        obs.set_export_meta(process="front",
                            clock={"offset_ns": 0, "uncertainty_ns": 0,
                                   "rtt_ns": 0, "samples": 0})
        self._spawn(1, bootstrap=True)
        self._await_ready(1)
        self._sync_clock(1)
        for rank in range(2, self._size):
            self._spawn(rank, bootstrap=False)
        for rank in range(2, self._size):
            self._await_ready(rank)
            self._sync_clock(rank)
        with self._lock:
            epochs = {r: rep.epoch for r, rep in self._replicas.items()}
        if len(set(epochs.values())) != 1:
            self.close()
            raise FrontError(f"replicas booted on mixed epochs: "
                             f"{epochs}")
        self._epoch = epochs[1]
        threading.Thread(target=self._supervise, daemon=True,
                         name="front-supervisor").start()
        threading.Thread(target=self._health_loop, daemon=True,
                         name="front-health").start()
        self._started = True
        return self

    def _spec_for(self, rank: int, boot: int, bootstrap: bool) -> str:
        import dataclasses

        from tfidf_tpu_torch.parallel.multihost import _config_to_spec
        serve_kw = dataclasses.asdict(self._serve_cfg)
        # The replica's server must never snapshot on its own (swaps
        # would race N writers into one dir) and must never try to
        # build a tier of its own.
        serve_kw["snapshot_dir"] = None
        serve_kw["replicas"] = None
        spec = {
            "rank": rank, "boot": boot, "bootstrap": bool(bootstrap),
            # Front-resolved fleet-tracing verdict: a replica inherits
            # no TFIDF_TPU_TRACE (see _STRIP_ENV) — this flag arms its
            # IN-MEMORY span ring instead, pulled over the data plane
            # by the trace_export op.
            "disttrace": disttrace.enabled(),
            "snapshot_dir": self._serve_cfg.snapshot_dir,
            "input_dir": self._input_dir,
            "device": str(self._device),
            "k": self._k, "no_strict": self._no_strict,
            "doc_len": self._doc_len,
            "pipeline": _config_to_spec(self._pipeline_cfg),
            "serve": serve_kw,
        }
        path = os.path.join(self._specs_dir,
                            f"replica_{rank}_b{boot}.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        return path

    def _spawn(self, rank: int, bootstrap: bool) -> None:
        rep = self._replicas[rank]
        boot = rep.boot + 1
        spec_path = self._spec_for(rank, boot, bootstrap)
        env = dict(os.environ)
        for var in _STRIP_ENV:
            env.pop(var, None)
        # Replicas import this package by module path; make sure they
        # can even when the front was launched from elsewhere.
        import tfidf_tpu_torch
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(tfidf_tpu_torch.__file__)))
        parts = env.get("PYTHONPATH", "").split(os.pathsep)
        if pkg_root not in parts:
            env["PYTHONPATH"] = os.pathsep.join(
                [pkg_root] + [p for p in parts if p])
        # stderr inherited: replicas log there, and an undrained pipe
        # would wedge a chatty child on the 64 KiB pipe buffer.
        # -c, not -m: runpy would import the package (which imports
        # this module) and then execute this module AGAIN as __main__.
        fd, proc = launch_rank(
            rank, self._size,
            [sys.executable, "-c",
             "import sys\n"
             "from tfidf_tpu_torch.serve.front import _replica_main\n"
             "sys.exit(_replica_main(sys.argv[1]))", spec_path],
            env=env, stderr=None)
        with self._lock:
            rep.proc = proc
            rep.boot = boot
            rep.state = "starting"
            rep.ready_evt = threading.Event()
            rep.ready_info = None
        self._comm.wire(rank, fd)
        threading.Thread(target=self._reader, args=(rank, proc, boot),
                         daemon=True,
                         name=f"front-reader-r{rank}").start()

    def _await_ready(self, rank: int) -> None:
        rep = self._replicas[rank]
        evt = rep.ready_evt
        timeout = self._serve_cfg.replica_timeout_s
        if not evt.wait(timeout):
            self._kill(rank)
            raise FrontError(f"replica {rank} not ready within "
                             f"{timeout:.0f}s")
        with self._lock:
            info = rep.ready_info
            if info is None:     # died during boot
                raise FrontError(f"replica {rank} died during boot")
            rep.state = "live"
            rep.epoch = int(info.get("epoch", 0))
            rep.num_docs = int(info.get("num_docs", 0))
            rep.pid = info.get("pid")
            rep.health = "ok"
            live = sum(1 for r in self._replicas.values()
                       if r.state == "live")
        self._m_live.set(live)
        from tfidf_tpu_torch.obs import log as obs_log
        obs_log.log_event(
            "info", "replica_up",
            msg=f"replica {rank} up (boot {rep.boot}, epoch "
                f"{rep.epoch}, {rep.num_docs} docs, pid {rep.pid})",
            replica=rank, boot=rep.boot, epoch=rep.epoch,
            docs=rep.num_docs, pid=rep.pid)

    def _sync_clock(self, rank: int) -> None:
        """Clock-offset handshake with one replica over the ctrl plane
        (serialized like every ctrl op — called at boot, before the
        supervisor threads exist, and from _restart under the swap
        lock): N ``clock_sync`` round trips, RTT-midpoint estimate,
        min-RTT filter (obs/disttrace.py). The estimate lands in the
        trace-export METADATA — captured timestamps are never
        rewritten, so a bad estimate is re-appliable, not baked in.
        Always re-estimated from scratch: a restarted replica is a new
        process and a new ``perf_counter`` epoch."""
        if not disttrace.enabled():
            return
        est = self._clocks[rank]
        est.reset()
        for _ in range(_CLOCK_SAMPLES):
            t_send = time.perf_counter_ns()
            try:
                ack = self._ctrl_rpc(rank, {"op": "clock_sync"},
                                     timeout_s=10.0)
            except FrontError:
                return     # supervision handles the death; no estimate
            t_recv = time.perf_counter_ns()
            t_peer = ack.get("t_ns")
            if ack.get("ok") and isinstance(t_peer, int):
                est.add_sample(t_send, t_peer, t_recv)
        from tfidf_tpu_torch.obs import log as obs_log
        rep = self._replicas[rank]
        obs_log.log_event(
            "info", "clock_sync",
            msg=(f"replica {rank} clock offset "
                 f"{(est.offset_ns or 0) / 1e3:.1f} µs "
                 f"± {(est.uncertainty_ns or 0) / 1e3:.1f} µs "
                 f"({est.n_samples} samples, boot {rep.boot})"),
            replica=rank, boot=rep.boot, offset_ns=est.offset_ns,
            uncertainty_ns=est.uncertainty_ns, rtt_ns=est.rtt_ns,
            samples=est.n_samples)

    def _kill(self, rank: int) -> None:
        proc = self._replicas[rank].proc
        if proc is not None and proc.poll() is None:
            try:
                proc.kill()
            except OSError:
                pass

    def close(self) -> None:
        """Drain and stop every replica; emits the final per-replica
        ``replica_down`` accounting the doctor's routed-share view
        reads."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for rep in self._replicas.values():
                if rep.state in ("live", "starting"):
                    rep.state = "stopping"
        self._restart_q.put(None)
        # No mutation may be mid-commit while we pull stdin out from
        # under the replicas.
        with self._swap_lock:
            pass
        from tfidf_tpu_torch.obs import log as obs_log
        for rank, rep in sorted(self._replicas.items()):
            proc = rep.proc
            if proc is not None and proc.poll() is None:
                try:
                    with rep.wlock:
                        if proc.stdin is not None:
                            proc.stdin.close()
                except OSError:
                    pass
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    self._kill(rank)
                    try:
                        proc.wait(timeout=5)
                    except subprocess.TimeoutExpired:
                        pass
            obs_log.log_event(
                "info", "replica_down",
                msg=f"replica {rank} shut down ({rep.routed} requests "
                    f"routed, {rep.restarts} restarts)",
                replica=rank, boot=rep.boot, reason="shutdown",
                routed=rep.routed, restarts=rep.restarts)
        self._m_live.set(0)
        self._comm.close()
        shutil.rmtree(self._specs_dir, ignore_errors=True)

    def __enter__(self) -> "ReplicatedFront":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --- introspection -----------------------------------------------

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def n_replicas(self) -> int:
        return self._n

    def _live_ranks(self) -> List[int]:
        with self._lock:
            return sorted(r for r, rep in self._replicas.items()
                          if rep.state == "live")

    def describe(self) -> dict:
        """Per-replica liveness/routing/restart state — the front's
        half of ``healthz`` and the doctor's replicas section."""
        with self._lock:
            reps = {
                str(r): {
                    "state": rep.state, "health": rep.health,
                    "epoch": rep.epoch, "boot": rep.boot,
                    "routed": rep.routed, "inflight": rep.inflight,
                    "restarts": rep.restarts, "pid": rep.pid,
                }
                for r, rep in sorted(self._replicas.items())}
        live = sum(1 for r in reps.values() if r["state"] == "live")
        status = ("ok" if live == self._n
                  else "degraded" if live else "unhealthy")
        return {"status": status, "epoch": self._epoch,
                "replicas": reps, "n_replicas": self._n,
                "live": live,
                "admission_open": self._admission.is_set(),
                "uptime_s": round(time.monotonic() - self._t0, 3)}

    # --- data plane --------------------------------------------------

    def _reader(self, rank: int, proc: subprocess.Popen,
                boot: int) -> None:
        """One thread per replica process: pump its stdout, resolve
        pending requests by wire id, and on EOF declare the replica
        dead (re-route + restart)."""
        try:
            for raw in proc.stdout:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    obj = json.loads(raw)
                except ValueError:
                    continue      # stray non-protocol output
                if not isinstance(obj, dict):
                    continue
                if obj.get("ready"):
                    with self._lock:
                        rep = self._replicas[rank]
                        if rep.boot != boot:
                            continue
                        rep.ready_info = obj
                        evt = rep.ready_evt
                    evt.set()
                    continue
                wire_id = obj.get("id")
                pend = None
                with self._lock:
                    rep = self._replicas[rank]
                    if wire_id is not None:
                        pend = self._pending.pop(wire_id, None)
                    if rep.boot == boot and rep.inflight > 0:
                        rep.inflight -= 1
                if pend is not None:
                    pend.response = obj
                    pend.event.set()
        except (OSError, ValueError):
            pass
        self._on_replica_death(rank, boot)

    def _on_replica_death(self, rank: int, boot: int) -> None:
        with self._lock:
            rep = self._replicas[rank]
            if rep.boot != boot or rep.state in ("stopping", "down",
                                                 "dead", "failed"):
                if rep.state == "stopping":
                    rep.state = "down"
                return
            was_starting = rep.state == "starting"
            rep.state = "dead"
            rep.health = "unknown"
            rep.inflight = 0
            routed = rep.routed
            evt = rep.ready_evt
            mine = [(i, p) for i, p in self._pending.items()
                    if p.rank == rank and p.boot == boot]
            for i, _ in mine:
                self._pending.pop(i, None)
            live = sum(1 for r in self._replicas.values()
                       if r.state == "live")
            closed = self._closed
        self._comm.unwire(rank)
        self._m_live.set(live)
        if was_starting and evt is not None:
            evt.set()     # unblock _await_ready with ready_info=None
        from tfidf_tpu_torch.obs import log as obs_log
        obs_log.log_event(
            "warning", "replica_down",
            msg=f"replica {rank} died (boot {boot}, {routed} requests "
                f"routed, {len(mine)} in flight)",
            replica=rank, boot=boot, reason="died", routed=routed,
            inflight=len(mine))
        if not closed:
            for _, pend in mine:
                if pend.retryable:
                    try:
                        target = self._pick(self._norm_for(pend.req))
                        self._submit_to(target, pend.req, pend=pend)
                        self._m_rerouted.inc()
                        continue
                    except FrontError:
                        pass
                pend.response = {"error": f"replica {rank} died"}
                pend.event.set()
            self._restart_q.put(rank)
        else:
            for _, pend in mine:
                pend.response = {"error": "front is closing"}
                pend.event.set()

    def _norm_for(self, req: dict) -> bytes:
        from tfidf_tpu_torch.serve.cache import normalize_query
        queries = req.get("queries") or [""]
        q = queries[0] if isinstance(queries, list) and queries else ""
        try:
            # The cache key's own token tuple — routing affinity is
            # exactly cache-hit affinity.
            return b"\x00".join(normalize_query(q,
                                                self._pipeline_cfg))
        except (TypeError, ValueError, AttributeError):
            return str(q).encode("utf-8", "replace")

    def _pick(self, norm: bytes, forced: Optional[int] = None) -> int:
        """Routing: crc32-hash affinity over ALL configured ranks (so
        a replica's cache keeps its keyspace across restarts), falling
        back to the least-loaded healthy live replica when the
        preferred one is dead or degraded."""
        if forced is not None:
            with self._lock:
                if self._replicas[forced].state != "live":
                    raise FrontError(f"replica {forced} not live")
            return forced
        preferred = 1 + (zlib.crc32(norm) % self._n)
        with self._lock:
            rep = self._replicas[preferred]
            if rep.state == "live" and rep.health in ("ok", "unknown"):
                return preferred
            live = [r for r, rp in self._replicas.items()
                    if rp.state == "live"]
            if not live:
                raise FrontError("no live replicas")
            healthy = [r for r in live
                       if self._replicas[r].health
                       in ("ok", "unknown")] or live
            pick = min(healthy,
                       key=lambda r: self._replicas[r].inflight)
        self._m_fallbacks.inc()
        return pick

    def _submit_to(self, rank: int, req: dict,
                   pend: Optional[_Pending] = None,
                   retryable: bool = True,
                   count_routed: bool = False) -> _Pending:
        if pend is None:
            pend = _Pending(req, retryable)
        wire_id = next(self._ids)
        with self._lock:
            rep = self._replicas[rank]
            if rep.state != "live":
                raise FrontError(f"replica {rank} not live")
            pend.rank = rank
            pend.boot = rep.boot
            self._pending[wire_id] = pend
            rep.inflight += 1
            if count_routed:
                rep.routed += 1
        line = json.dumps({**req, "id": wire_id})
        try:
            with rep.wlock:
                rep.proc.stdin.write(line + "\n")
                rep.proc.stdin.flush()
        except (OSError, ValueError):
            with self._lock:
                self._pending.pop(wire_id, None)
                if rep.inflight > 0:
                    rep.inflight -= 1
            raise FrontError(f"replica {rank} unreachable")
        if count_routed:
            self._m_routed.inc()
        return pend

    def _await(self, pend: _Pending,
               timeout_s: Optional[float] = None) -> dict:
        timeout = timeout_s or self._serve_cfg.replica_timeout_s
        if not pend.event.wait(timeout):
            with self._lock:
                for i, p in list(self._pending.items()):
                    if p is pend:
                        self._pending.pop(i, None)
                        break
            return {"error": f"replica {pend.rank} timed out after "
                             f"{timeout:.0f}s"}
        resp = dict(pend.response or {"error": "no response"})
        return resp

    def _request_op(self, rank: int, req: dict,
                    timeout_s: Optional[float] = None,
                    retryable: bool = True) -> dict:
        pend = self._submit_to(rank, req, retryable=retryable)
        resp = self._await(pend, timeout_s)
        if "error" in resp and "timed out" in str(resp.get("error")):
            raise FrontError(resp["error"])
        return resp

    def handle_request(self, req: dict,
                       rank: Optional[int] = None,
                       timeout_s: Optional[float] = None) -> dict:
        """Route one QUERY request (the op-less protocol shape) to a
        replica and block for its response. ``rank`` forces the route
        (the bench's per-replica warm lever)."""
        from tfidf_tpu_torch import obs
        if not self._admission.wait(
                timeout=self._serve_cfg.replica_timeout_s):
            return {"error": "overloaded"}   # a wedged swap gate
        # Fleet trace context: minted HERE, at the tier's
        # admission point, and propagated as the request's "trace"
        # JSONL field — the replica adopts it onto its
        # RequestContext, so every span its rid machinery stamps
        # joins back to this route span across the process boundary.
        # The route span covers pick -> submit -> response: after
        # clock alignment it must CONTAIN the replica's request span
        # (the containment tools/trace_check.py --merged pins).
        tctx = disttrace.mint()
        tkw = {"trace": tctx.trace} if tctx is not None else {}
        h = obs.begin("route", **tkw)
        try:
            target = self._pick(self._norm_for(req), forced=rank)
        except FrontError as e:
            obs.end(h, outcome="error")
            return {"error": str(e)}
        if tctx is not None:
            req = {**req, "trace": disttrace.to_wire(tctx)}
        try:
            pend = self._submit_to(target, req, count_routed=True)
        except FrontError:
            # The pick raced a death; one least-loaded retry.
            try:
                target = self._pick(self._norm_for(req))
                pend = self._submit_to(target, req, count_routed=True)
            except FrontError as e:
                obs.end(h, outcome="error")
                return {"error": str(e)}
        resp = self._await(pend, timeout_s)
        # The replica's rid rides the route span's end args: the
        # cross-process join (trace id <-> rid) is recorded on BOTH
        # sides of the hop, so doctor --request can walk it from
        # either end.
        obs.end(h, replica=target, rid=resp.get("rid"))
        return resp

    def query(self, queries, k: Optional[int] = None,
              use_cache: bool = True, rank: Optional[int] = None,
              deadline_ms: Optional[float] = None,
              timeout_s: Optional[float] = None) -> dict:
        """Blocking convenience wrapper (the bench's client)."""
        req: dict = {"queries": list(queries), "k": k or self._k}
        if not use_cache:
            req["use_cache"] = False
        if deadline_ms is not None:
            req["deadline_ms"] = deadline_ms
        return self.handle_request(req, rank=rank, timeout_s=timeout_s)

    # --- health + supervision ---------------------------------------

    def _health_loop(self) -> None:
        period = (self._serve_cfg.health_period_ms or 500.0) / 1e3
        while not self._closed:
            time.sleep(period)
            if self._closed:
                return
            for rank in self._live_ranks():
                try:
                    resp = self._request_op(rank, {"op": "healthz"},
                                            timeout_s=10.0,
                                            retryable=False)
                    status = (resp.get("healthz") or {}).get(
                        "status", "unknown")
                except FrontError:
                    status = "unknown"
                with self._lock:
                    rep = self._replicas[rank]
                    if rep.state == "live":
                        rep.health = status

    def _supervise(self) -> None:
        while True:
            rank = self._restart_q.get()
            if rank is None:
                return
            if self._closed:
                continue
            with self._swap_lock:
                if not self._closed:
                    self._restart(rank)

    def _restart(self, rank: int) -> None:
        """Respawn a dead replica from the shared snapshot under the
        restart budget; when the snapshot's epoch disagrees with the
        tier's (a death raced a commit), refresh the snapshot from a
        live peer and boot once more until they agree."""
        from tfidf_tpu_torch.obs import log as obs_log
        rep = self._replicas[rank]
        budget = self._serve_cfg.restart_budget
        while True:
            with self._lock:
                if rep.state != "dead":
                    return
                if rep.restarts >= budget:
                    rep.state = "failed"
                    exhausted = True
                else:
                    rep.restarts += 1
                    exhausted = False
            if exhausted:
                obs_log.log_event(
                    "error", "replica_down",
                    msg=f"replica {rank} restart budget exhausted "
                        f"({budget}); serving without it",
                    replica=rank, boot=rep.boot,
                    reason="budget_exhausted", routed=rep.routed,
                    restarts=budget)
                return
            proc = rep.proc
            if proc is not None:
                try:
                    proc.wait(timeout=10)
                except (subprocess.TimeoutExpired, OSError):
                    self._kill(rank)
            self._spawn(rank, bootstrap=False)
            try:
                self._await_ready(rank)
            except FrontError:
                with self._lock:
                    if rep.state != "down":
                        rep.state = "dead"
                continue
            self._m_restarts.inc()
            # A respawned replica is a NEW clock epoch: re-estimate
            # its offset before any of its spans can be merged.
            self._sync_clock(rank)
            with self._lock:
                behind = rep.epoch != self._epoch
            if not behind:
                return
            # Epoch catch-up: re-snapshot from a live peer, then
            # bounce this replica once more off the fresh snapshot.
            peers = [r for r in self._live_ranks() if r != rank]
            if not peers:
                return    # nothing to catch up FROM; serve as-is
            try:
                self._ctrl_rpc(peers[0], {"op": "snapshot"})
            except FrontError:
                self._kill(peers[0])
            with self._lock:
                rep.state = "stopping"
            self._kill(rank)
            try:
                rep.proc.wait(timeout=10)
            except (subprocess.TimeoutExpired, OSError):
                pass
            with self._lock:
                rep.state = "dead"

    # --- control plane: the two-phase epoch protocol -----------------

    def _ctrl_rpc(self, rank: int, obj: dict,
                  timeout_s: Optional[float] = None) -> dict:
        timeout = timeout_s or self._serve_cfg.replica_timeout_s
        try:
            self._comm.send(rank, _CTRL, json.dumps(obj).encode())
            if not self._comm.poll(rank, timeout):
                raise FrontError(
                    f"replica {rank} ctrl timeout on "
                    f"{obj.get('op')!r} after {timeout:.0f}s")
            return json.loads(self._comm.recv(rank, _CTRL_ACK).decode())
        except (MpiLiteError, OSError, ValueError) as e:
            raise FrontError(
                f"replica {rank} ctrl channel failed on "
                f"{obj.get('op')!r}: {e}")

    def _two_phase(self, kind: str, payload: dict) -> dict:
        """prepare -> ping -> (gate) commit writer-first -> (ungate).
        Raises :class:`SwapAborted` when the transaction dies with the
        tier still on the old epoch, :class:`FrontError` when every
        replica deterministically refused the operation."""
        from tfidf_tpu_torch import obs
        from tfidf_tpu_torch.obs import log as obs_log
        with self._swap_lock:
            if self._closed:
                raise FrontError("front is closed")
            txn = next(self._txns)
            target = self._epoch + 1
            # Control-plane trace context: one id for the whole
            # transaction — every prepare/ping/commit/abort ctrl op
            # carries it and every participant's txn_phase span stamps
            # it, so a tier-wide swap merges into ONE visible tree.
            tctx = disttrace.mint()
            tkw = {"trace": tctx.trace} if tctx is not None else {}
            h = obs.begin("epoch_swap", kind=kind, txn=txn,
                          epoch=target, **tkw)
            try:
                result = self._two_phase_locked(
                    kind, payload, txn, target, obs_log, tctx)
            except SwapAborted:
                obs.end(h, epoch=self._epoch)
                raise
            obs.end(h, epoch=self._epoch)
            return result

    def _two_phase_locked(self, kind: str, payload: dict, txn: int,
                          target: int, obs_log,
                          tctx=None) -> dict:
        from tfidf_tpu_torch import obs
        live = self._live_ranks()
        if not live:
            raise FrontError("no live replicas")
        tkw = {"trace": tctx.trace} if tctx is not None else {}

        def abort_txn(prepared, skip, why_rank, why):
            for peer in prepared:
                if peer == why_rank:
                    continue
                try:
                    self._ctrl_rpc(peer, {"op": "abort", "txn": txn,
                                          **tkw})
                except FrontError:
                    self._kill(peer)
            self._m_aborts.inc()
            obs_log.log_event(
                "warning", "epoch_abort",
                msg=f"epoch {target} ({kind}) aborted — replica "
                    f"{why_rank}: {why}; tier stays on epoch "
                    f"{self._epoch}",
                epoch=target, txn=txn, kind=kind, replica=why_rank,
                reason=str(why)[:200])

        prepared: List[int] = []
        for rank in live:
            try:
                ack = self._ctrl_rpc(rank, {
                    "op": "prepare", "txn": txn, "kind": kind,
                    "epoch": target, **tkw, **payload})
            except FrontError as e:
                abort_txn(prepared, rank, rank, e)
                self._kill(rank)
                raise SwapAborted(f"epoch {target} ({kind}) aborted: "
                                  f"replica {rank}: {e}")
            if not ack.get("ok"):
                err = ack.get("error", "prepare refused")
                abort_txn(prepared + [rank], None, rank, err)
                raise FrontError(f"{kind} refused at prepare by "
                                 f"replica {rank}: {err}")
            prepared.append(rank)
        obs_log.log_event(
            "info", "epoch_prepare",
            msg=f"epoch {target} ({kind}) prepared on "
                f"{len(prepared)} replica(s) (txn {txn})",
            epoch=target, txn=txn, kind=kind, replicas=len(prepared))

        # Ping round: a replica that acked prepare and then died (the
        # SIGKILL-between-phases pin) is caught HERE — nothing has
        # installed yet, so the abort leaves the tier on the old
        # epoch everywhere.
        for rank in prepared:
            try:
                ack = self._ctrl_rpc(rank, {"op": "ping", "txn": txn,
                                            **tkw})
                if not ack.get("ok"):
                    raise FrontError(ack.get("error", "ping refused"))
            except FrontError as e:
                abort_txn(prepared, rank, rank, e)
                self._kill(rank)
                raise SwapAborted(f"epoch {target} ({kind}) aborted: "
                                  f"replica {rank} died between "
                                  f"prepare and commit: {e}")

        # Commit: gate admission so no query is admitted while
        # replicas disagree, writer first so the shared snapshot
        # carries the NEW epoch before anyone else flips.
        self._admission.clear()
        # Drain before anyone flips: a query admitted before the gate
        # closed but still sitting in a replica's queue would be
        # served against the NEW index if that replica committed
        # first — a client-visible mixed-epoch response. Nothing has
        # installed yet, so a drain that stalls aborts back to the
        # old epoch everywhere.
        drain_deadline = (time.monotonic()
                          + self._serve_cfg.replica_timeout_s)
        # The drain-to-zero gap as a first-class span: the txn tree's
        # measurable "where did the swap wait" segment — gate closed,
        # nothing installed, in-flight count bleeding to zero.
        dh = obs.begin("txn_phase", phase="drain", txn=txn,
                       epoch=target, **tkw)
        while True:
            with self._lock:
                inflight = sum(self._replicas[r].inflight
                               for r in prepared
                               if r in self._replicas)
            if inflight == 0:
                obs.end(dh, outcome="drained")
                break
            if time.monotonic() > drain_deadline:
                obs.end(dh, outcome="stalled", inflight=inflight)
                self._admission.set()
                abort_txn(prepared, None, None,
                          FrontError("in-flight drain stalled"))
                raise SwapAborted(
                    f"epoch {target} ({kind}) aborted: {inflight} "
                    f"request(s) still in flight after "
                    f"{self._serve_cfg.replica_timeout_s:.0f}s drain")
            time.sleep(0.002)
        committed: List[tuple] = []
        refused: Optional[str] = None
        try:
            writer = prepared[0]
            for rank in prepared:
                try:
                    ack = self._ctrl_rpc(rank, {
                        "op": "commit", "txn": txn,
                        "snapshot": rank == writer, **tkw})
                except FrontError as e:
                    if rank == writer and not committed:
                        # Writer state unknown; survivors are still
                        # uncommitted — abort them, tier stays old,
                        # the writer's restart heals off a re-made
                        # snapshot (epoch catch-up in _restart).
                        abort_txn([p for p in prepared
                                   if p != writer], None, rank, e)
                        self._kill(rank)
                        raise SwapAborted(
                            f"epoch {target} ({kind}) aborted: "
                            f"writer {rank} died mid-commit: {e}")
                    # Non-writer death after the writer committed:
                    # push forward — the snapshot already carries the
                    # new epoch and the restart catches it up.
                    self._kill(rank)
                    continue
                if not ack.get("ok"):
                    refused = ack.get("error", "commit failed")
                    continue
                committed.append((rank, ack))
            if committed:
                # The front's epoch advances BEFORE the admission
                # gate reopens: no query can be admitted, served on
                # the new index, and returned while the front still
                # reports the old epoch.
                new_epoch = int(committed[0][1].get("epoch", target))
                self._epoch = new_epoch
                with self._lock:
                    for rank, ack in committed:
                        self._replicas[rank].epoch = int(
                            ack.get("epoch", new_epoch))
        finally:
            self._admission.set()

        if not committed:
            # Deterministic refusal — identical state, identical op,
            # identical verdict on every replica; no epoch moved.
            raise FrontError(f"{kind} failed on every replica: "
                             f"{refused}")
        if refused is not None:
            obs_log.log_event(
                "error", "epoch_commit",
                msg=f"PARTIAL commit of epoch {target}: "
                    f"{len(committed)}/{len(prepared)} applied, "
                    f"last refusal: {refused}",
                epoch=target, txn=txn, kind=kind,
                replicas=len(committed), partial=1)
        self._m_commits.inc()
        obs_log.log_event(
            "info", "epoch_commit",
            msg=f"epoch {new_epoch} ({kind}) committed on "
                f"{len(committed)} replica(s) (txn {txn})",
            epoch=new_epoch, txn=txn, kind=kind,
            replicas=len(committed))
        writer_ack = committed[0][1]
        return {**{k: v for k, v in writer_ack.items()
                   if k not in ("ok", "rank", "txn")},
                "epoch": new_epoch, "replicas": len(committed)}

    def swap_index(self, input_dir: str) -> int:
        """Tier-wide hot swap: every replica builds the incoming index
        from ``input_dir`` at prepare, installs at commit. Returns the
        new epoch."""
        return int(self._two_phase("swap",
                                   {"input": input_dir})["epoch"])

    def add_docs(self, docs: List[dict]) -> dict:
        return self._two_phase("add", {"docs": docs})

    def delete_docs(self, names: List[str]) -> dict:
        return self._two_phase("delete", {"names": names})

    def compact_now(self) -> dict:
        return self._two_phase("compact", {})

    def snapshot(self) -> dict:
        """Explicit snapshot from the designated writer (lowest live
        rank) — the restart path's freshness lever."""
        with self._swap_lock:
            live = self._live_ranks()
            if not live:
                raise FrontError("no live replicas")
            ack = self._ctrl_rpc(live[0], {"op": "snapshot"})
            if not ack.get("ok"):
                raise FrontError(f"snapshot failed: "
                                 f"{ack.get('error')}")
            return {"snapshot": self._serve_cfg.snapshot_dir,
                    "epoch": int(ack.get("epoch", self._epoch))}

    # --- merged observability ---------------------------------------

    def _collect_bundles(self, timeout_s: float = 30.0) -> Dict[str,
                                                                dict]:
        bundles: Dict[str, dict] = {}
        for rank in self._live_ranks():
            try:
                resp = self._request_op(rank, {"op": "obs_export"},
                                        timeout_s=timeout_s)
            except FrontError:
                continue
            b = resp.get("obs_export")
            if (isinstance(b, dict) and b.get("schema") == _OBS_SCHEMA
                    and isinstance(b.get("registry"), dict)):
                bundles[f"r{rank}"] = b
        return bundles

    def _merge(self, bundles: Dict[str, dict]):
        from tfidf_tpu_torch.obs.registry import MetricsRegistry
        per = {label: MetricsRegistry.import_state(b["registry"])
               for label, b in bundles.items()}
        merged = MetricsRegistry()
        for reg in per.values():
            merged.merge(reg)
        # The front's own counters ride the fleet view too.
        merged.merge(self._registry)
        return merged, per

    def metrics_snapshot(self) -> dict:
        """The MERGED metrics view: counters summed, histograms merged
        bucket-wise across replicas (obs_agg semantics, in-process),
        with the per-replica snapshots and the front's routing state
        alongside."""
        bundles = self._collect_bundles()
        merged, per = self._merge(bundles)
        return {
            "merged": merged.snapshot(),
            "per_replica": {
                label: {"pid": b.get("pid"), "epoch": b.get("epoch"),
                        "uptime_s": b.get("uptime_s"),
                        "registry": per[label].snapshot()}
                for label, b in sorted(bundles.items())},
            "front": self.describe(),
        }

    def metrics_prom(self) -> str:
        """Merged Prometheus exposition + per-replica
        ``{process="rN"}`` labeled samples (the obs_agg render, served
        straight off the front)."""
        bundles = self._collect_bundles()
        merged, per = self._merge(bundles)

        def esc(v: str) -> str:
            return str(v).replace("\\", "\\\\").replace('"', '\\"')

        lines = [f"# front: {len(per)} replica(s) merged",
                 f"serve_front_processes {len(per)}"]
        lines.append(merged.render_prom().rstrip("\n"))
        for label, reg in sorted(per.items()):
            bundle = bundles[label]
            plabel = f'process="{esc(label)}"'
            lines.append(f"# process {label}: "
                         f"pid={bundle.get('pid')} "
                         f"epoch={bundle.get('epoch')} "
                         f"uptime_s={bundle.get('uptime_s')}")
            snap = reg.snapshot()
            for name, value in sorted(snap.items()):
                if isinstance(value, (int, float)):
                    lines.append(f"{name}{{{plabel}}} {value}")
                elif isinstance(value, dict) and "value" in value:
                    lines.append(f"{name}{{{plabel}}} "
                                 f"{value['value']}")
                elif isinstance(value, dict) and "count" in value:
                    lines.append(f"{name}_count{{{plabel}}} "
                                 f"{value['count']}")
        return "\n".join(lines) + "\n"

    def obs_export(self) -> dict:
        """The tier's federation bundle: merged registry state plus
        per-replica identity — same schema as a single server's, so
        ``tools/obs_agg.py`` can merge fronts of fronts."""
        from tfidf_tpu_torch.obs import log as obs_log
        bundles = self._collect_bundles()
        merged, _ = self._merge(bundles)
        log = obs_log.get_log()
        return {
            "schema": _OBS_SCHEMA,
            "pid": os.getpid(),
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "epoch": self._epoch,
            "fingerprint": {"front": True, "n_replicas": self._n,
                            "snapshot_dir":
                                self._serve_cfg.snapshot_dir},
            "registry": merged.export_state(),
            "flight_tail": log.events()[-64:],
            "digest_tail": log.digests()[-32:],
            "replicas": {
                label: {"pid": b.get("pid"), "epoch": b.get("epoch"),
                        "uptime_s": b.get("uptime_s")}
                for label, b in sorted(bundles.items())},
        }

    def trace_export(self) -> dict:
        """The fleet's span evidence in one pull (schema
        ``tfidf-trace/1``): the front's own ring plus every live
        replica's in-memory ring (pulled over the data plane — the
        same transport discipline as ``obs_export``), one entry per
        process carrying the identity + clock-offset metadata
        ``tools/trace_merge.py`` aligns lanes with. Offsets ride the
        METADATA; the Chrome events are each process's verbatim local
        timeline."""
        from tfidf_tpu_torch import obs
        processes: List[dict] = []
        t = obs.get_tracer()
        if t is not None:
            processes.append({**t.export_meta(),
                              "traceEvents": t.chrome_events()})
        for rank in self._live_ranks():
            try:
                resp = self._request_op(rank, {"op": "trace_export"},
                                        timeout_s=30.0)
            except FrontError:
                continue
            b = resp.get("trace_export")
            if not (isinstance(b, dict)
                    and b.get("schema") == _TRACE_SCHEMA):
                continue
            for entry in b.get("processes") or []:
                if not (isinstance(entry, dict)
                        and isinstance(entry.get("traceEvents"),
                                       list)):
                    continue
                entry = dict(entry)
                entry["process"] = f"r{rank}"
                # The front owns the estimator: offset_ns is REPLICA
                # minus FRONT clock, stamped here so every non-front
                # entry of the bundle is alignable.
                entry["clock"] = self._clocks[rank].as_meta()
                processes.append(entry)
        return {"schema": _TRACE_SCHEMA, "pid": os.getpid(),
                "epoch": self._epoch, "processes": processes}

    def replica_info(self) -> Dict[str, dict]:
        """Per-replica identity, the kernel libraries each replica
        loaded and its kernel launches since its warm-up, and its
        builds after the warm-up (the recompiles-after-warm audit)."""
        out: Dict[str, dict] = {}
        for rank in self._live_ranks():
            try:
                resp = self._request_op(rank, {"op": "replica_info"},
                                        timeout_s=30.0)
            except FrontError:
                continue
            info = resp.get("replica_info")
            if isinstance(info, dict):
                out[f"r{rank}"] = info
        return out

    # --- the JSONL protocol ------------------------------------------

    def handle_line(self, line: str, write: Callable[[dict], None]
                    ) -> bool:
        """One JSONL request -> one JSON response line; the front's
        counterpart of ``cli._serve_handle_line``. Returns False on
        shutdown."""
        line = line.strip()
        if not line:
            return True
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
        except ValueError as e:
            write({"error": f"bad request: {e}"})
            return True
        rid = req.get("id")
        op = req.get("op")
        if op == "shutdown":
            return False
        try:
            if op is None:
                queries = req.get("queries")
                if not isinstance(queries, list) or not all(
                        isinstance(q, str) for q in queries):
                    write({"id": rid, "error": "bad request: "
                           "'queries' must be a list of strings"})
                    return True
                resp = self.handle_request(
                    {k: v for k, v in req.items() if k != "id"})
                resp["id"] = rid
                write(resp)
            elif op == "metrics":
                write({"id": rid, "metrics": self.metrics_snapshot()})
            elif op == "metrics_prom":
                write({"id": rid, "metrics_prom": self.metrics_prom()})
            elif op == "obs_export":
                write({"id": rid, "obs_export": self.obs_export()})
            elif op == "trace_export":
                write({"id": rid, "trace_export": self.trace_export()})
            elif op in ("healthz", "readyz"):
                desc = self.describe()
                if op == "readyz":
                    write({"id": rid, "readyz": {
                        "ready": desc["live"] > 0,
                        "live": desc["live"],
                        "n_replicas": self._n}})
                else:
                    write({"id": rid, "healthz": desc})
            elif op == "replica_info":
                write({"id": rid, "replica_info": self.replica_info()})
            elif op == "swap_index":
                epoch = self.swap_index(req["input"])
                write({"id": rid, "swapped": True, "epoch": epoch})
            elif op == "add_docs":
                docs = req.get("docs")
                if (not isinstance(docs, list) or not docs
                        or not all(isinstance(d, dict)
                                   and isinstance(d.get("name"), str)
                                   and isinstance(d.get("text"), str)
                                   for d in docs)):
                    write({"id": rid, "error": "bad request: 'docs' "
                           "must be a non-empty list of "
                           "{\"name\": str, \"text\": str}"})
                    return True
                out = self.add_docs(docs)
                write({"id": rid, **out})
            elif op == "delete_docs":
                names = req.get("names")
                if (not isinstance(names, list) or not names
                        or not all(isinstance(n, str)
                                   for n in names)):
                    write({"id": rid, "error": "bad request: 'names' "
                           "must be a non-empty list of strings"})
                    return True
                out = self.delete_docs(names)
                write({"id": rid, **out})
            elif op == "compact":
                write({"id": rid, **self.compact_now()})
            elif op == "snapshot":
                write({"id": rid, **self.snapshot()})
            else:
                write({"id": rid, "error": f"unknown op {op!r}"})
        except SwapAborted as e:
            write({"id": rid, "error": f"swap aborted: {e}",
                   "epoch": self._epoch})
        except (FrontError, KeyError, ValueError, OSError) as e:
            write({"id": rid, "error": str(e)})
        return True


# --- the replica worker ----------------------------------------------


def _replica_main(spec_path: str) -> int:
    """One replica process: attach to the front's mpi_lite channel,
    restore (or bootstrap-build) the index from the shared snapshot on
    the spec's device, serve the stdin/stdout JSONL data plane with the
    SAME handler as ``tfidf serve``, and answer the two-phase control
    plane on a daemon thread. stdout carries ONLY protocol JSONL — the
    ready line is the first of it; logs go to stderr."""
    with open(spec_path) as f:
        spec = json.load(f)
    comm = MpiLiteComm.from_env()
    rank, boot = comm.rank, int(spec.get("boot", 0))

    def fail(msg: str) -> int:
        sys.stderr.write(f"replica {rank}: {msg}\n")
        return 3

    from tfidf_tpu_torch.pipeline import resolve_device
    try:
        device = resolve_device(spec["device"])  # no silent fallback
    except RuntimeError as e:
        return fail(str(e))

    from tfidf_tpu_torch import checkpoint as ckpt
    from tfidf_tpu_torch import faults
    from tfidf_tpu_torch.cli import _serve_handle_line
    from tfidf_tpu_torch.config import ServeConfig
    from tfidf_tpu_torch.io import fast_tokenizer
    from tfidf_tpu_torch.models import TfidfRetriever
    from tfidf_tpu_torch.ops import _build, kernels
    from tfidf_tpu_torch.parallel.multihost import _config_from_spec

    from tfidf_tpu_torch.serve.server import TfidfServer

    cfg = _config_from_spec(spec["pipeline"])
    serve_cfg = ServeConfig(**spec["serve"])
    if serve_cfg.disttrace is not None:
        disttrace.configure(serve_cfg.disttrace)
    if spec.get("disttrace"):
        # The replica inherits no TFIDF_TPU_TRACE (_STRIP_ENV): the
        # front's spec flag arms an IN-MEMORY span ring instead,
        # pulled on demand over the data plane by the trace_export
        # op. Identity rides the export metadata; the front stamps
        # the clock offset when it collects the bundle.
        from tfidf_tpu_torch import obs
        if obs.get_tracer() is None:
            obs.set_tracer(obs.Tracer(), None)
        obs.set_export_meta(process=f"r{rank}")
    strict = not spec.get("no_strict", False)
    snap_dir = spec["snapshot_dir"]
    bootstrap = bool(spec.get("bootstrap"))
    k = int(spec.get("k", 10))

    def build_retriever(input_dir: str) -> TfidfRetriever:
        return TfidfRetriever(cfg, device=device).index_dir(
            input_dir, strict=strict, doc_len=spec.get("doc_len"))

    retriever = None
    meta = None
    segments = None
    if serve_cfg.delta_docs:
        from tfidf_tpu_torch.index import SegmentedIndex
        if ckpt.exists(snap_dir):
            try:
                segments, meta = SegmentedIndex.restore(snap_dir, cfg,
                                                        device=device)
            except ckpt.SnapshotMismatch as e:
                if not bootstrap:
                    return fail(f"snapshot at {snap_dir} unusable "
                                f"({e})")
        if segments is None:
            if not bootstrap or not spec.get("input_dir"):
                return fail(f"no usable snapshot at {snap_dir}")
            segments = SegmentedIndex.from_dir(
                spec["input_dir"], cfg,
                delta_docs=serve_cfg.delta_docs,
                compact_at=serve_cfg.compact_at, strict=strict,
                device=device)
        retriever = segments.view()
    else:
        if ckpt.exists(snap_dir):
            try:
                retriever, meta = TfidfRetriever.restore(snap_dir, cfg,
                                                         device=device)
            except ckpt.SnapshotMismatch as e:
                if not bootstrap:
                    return fail(f"snapshot at {snap_dir} unusable "
                                f"({e})")
        if retriever is None:
            if not bootstrap or not spec.get("input_dir"):
                return fail(f"no usable snapshot at {snap_dir}")
            retriever = build_retriever(spec["input_dir"])

    server = TfidfServer(
        retriever, serve_cfg,
        initial_epoch=int(meta.get("epoch", 0)) if meta else 0)
    if segments is not None:
        server.attach_segments(segments)
    if bootstrap and meta is None:
        # First boot on an empty snapshot root: persist so ranks 2..N
        # (and every restart) spin up without touching the corpus.
        server.snapshot(snap_dir)

    # Warm-up, then the warm line: every power-of-two query bucket on
    # the installed index (and a sharded index's single-device source,
    # the canary's oracle), which loads the kernel library on the card,
    # and the native loader a swap's prepare indexes with. A build after
    # mark_warm() is a recompile after warm. Launch counts restart at
    # the warm line, so replica_info's counts are the served work's.
    _, installed = server.current_index()
    warm_targets = [installed]
    oracle = getattr(installed, "parity_oracle", lambda: None)()
    if oracle is not None:
        warm_targets.append(oracle)
    b = 1
    while b <= serve_cfg.max_batch:
        for target in warm_targets:
            target.search([""] * b, k=k)
        b *= 2
    fast_tokenizer.available()
    server.mark_warm()
    kernels.reset_launches()

    def loaded_libraries() -> List[str]:
        libs = []
        if _build.load.cache_info().currsize:
            libs.append(_build.library_path().name)
        if fast_tokenizer._lib is not None:
            libs.append(_build.host_library_path().name)
        return libs

    wlock = threading.Lock()

    def write(obj) -> None:
        with wlock:
            sys.stdout.write(json.dumps(obj) + "\n")
            sys.stdout.flush()

    staged: Dict[int, tuple] = {}

    def apply_commit(kind: str, prepared) -> dict:
        if kind == "swap":
            return {"epoch": server.swap_index(prepared)}
        if kind == "add":
            out = server.add_docs(prepared["names"],
                                  prepared["texts"])
            return {"epoch": out["epoch"], "added": out["added"],
                    "updated": out["updated"],
                    "sealed": out["sealed"]}
        if kind == "delete":
            out = server.delete_docs(prepared["names"])
            return {"epoch": out["epoch"], "deleted": out["deleted"],
                    "missing": out["missing"]}
        if kind == "compact":
            server.compact_now(force=True)
            return {"epoch": server.epoch}
        raise ValueError(f"unknown commit kind {kind!r}")

    def ctrl_loop() -> None:
        from tfidf_tpu_torch import obs
        while True:
            try:
                req = json.loads(comm.recv(0, _CTRL).decode())
            except (MpiLiteError, OSError, ValueError):
                os._exit(0)     # front gone — nothing left to serve
            op = req.get("op")
            txn = req.get("txn")
            # Participant half of the txn tree: each
            # two-phase op this replica executes is a txn_phase span
            # stamped with the transaction's fleet trace id, so a
            # tier-wide swap merges into one tree across processes.
            tid_wire = req.get("trace")
            ph = (obs.begin("txn_phase", phase=op, txn=txn,
                            **({"trace": tid_wire}
                               if isinstance(tid_wire, str) else {}))
                  if op in ("prepare", "ping", "commit", "abort")
                  else None)
            ack: dict = {"ok": True, "rank": rank, "txn": txn}
            fire_text = None
            try:
                if op == "prepare":
                    kind = req["kind"]
                    target = int(req["epoch"])
                    if kind == "swap":
                        staged[txn] = ("swap",
                                       build_retriever(req["input"]))
                    elif kind == "add":
                        names = [d["name"] for d in req["docs"]]
                        texts = [d["text"] for d in req["docs"]]
                        if not names:
                            raise ValueError("add: no docs")
                        staged[txn] = ("add", {"names": names,
                                               "texts": texts})
                    elif kind == "delete":
                        names = list(req["names"])
                        if not names:
                            raise ValueError("delete: no names")
                        staged[txn] = ("delete", {"names": names})
                    elif kind == "compact":
                        staged[txn] = ("compact", None)
                    else:
                        raise ValueError(
                            f"unknown prepare kind {kind!r}")
                    ack["epoch"] = server.epoch
                    fire_text = (f"replica={rank} boot={boot} "
                                 f"epoch={target}")
                elif op == "ping":
                    ack["epoch"] = server.epoch
                elif op == "commit":
                    kind, prepared = staged.pop(txn)
                    ack.update(apply_commit(kind, prepared))
                    if req.get("snapshot"):
                        server.snapshot(snap_dir)
                elif op == "abort":
                    staged.pop(txn, None)
                    ack["epoch"] = server.epoch
                elif op == "snapshot":
                    server.snapshot(snap_dir)
                    ack["epoch"] = server.epoch
                elif op == "clock_sync":
                    # The offset handshake's replica half: one local
                    # clock reading while holding the request — the
                    # front brackets it with its own send/recv stamps
                    # (RTT-midpoint estimate, obs/disttrace.py).
                    ack["t_ns"] = time.perf_counter_ns()
                else:
                    raise ValueError(f"unknown ctrl op {op!r}")
            except Exception as e:  # noqa: BLE001 — acked, not fatal
                ack = {"ok": False, "rank": rank, "txn": txn,
                       "error": str(e)}
            if ph is not None:
                obs.end(ph, ok=bool(ack.get("ok")),
                        epoch=ack.get("epoch"))
            try:
                comm.send(0, _CTRL_ACK, json.dumps(ack).encode())
            except (MpiLiteError, OSError):
                os._exit(0)
            if fire_text is not None and ack.get("ok"):
                try:
                    faults.fire("replica_prepare", text=fire_text,
                                replica=rank, boot=boot)
                except faults.InjectedFault:
                    # The chaos rehearsal's SIGKILL stand-in: die
                    # between prepare-ack and commit, no cleanup —
                    # the front's ping round must catch this.
                    os._exit(137)

    threading.Thread(target=ctrl_loop, daemon=True,
                     name=f"replica{rank}-ctrl").start()

    write({"ready": True, "rank": rank, "boot": boot,
           "epoch": server.epoch, "num_docs": server.num_docs,
           "pid": os.getpid()})
    try:
        for line in sys.stdin:
            sline = line.strip()
            if not sline:
                continue
            try:
                req = json.loads(sline)
            except ValueError as e:
                write({"error": f"bad request: {e}"})
                continue
            if (isinstance(req, dict)
                    and req.get("op") == "replica_info"):
                write({"id": req.get("id"), "replica_info": {
                    "rank": rank, "boot": boot, "pid": os.getpid(),
                    "epoch": server.epoch,
                    "num_docs": server.num_docs,
                    # The port compiles no XLA: its stand-in names
                    # the kernel libraries loaded and the launches
                    # since the warm-up.
                    "compiled_programs": {
                        "libraries": loaded_libraries(),
                        "launches": dict(kernels.LAUNCHES)},
                    "recompiles_after_warm":
                        server.compile_watch.recompile_count}})
                continue
            if not _serve_handle_line(server, sline, write, k,
                                      build_retriever, None):
                break
    finally:
        server.close(drain=True)
        comm.close()
    return 0


if __name__ == "__main__":
    sys.exit(_replica_main(sys.argv[1]))
