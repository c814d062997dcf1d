"""Multi-process bring-up and the sharded ingest (port of the jax-free
parts of ``tfidf_tpu/parallel/multihost.py``, copied, not imported).

Two process models, as in the JAX package:

* ``initialize`` — a process group over ``torch.distributed`` (gloo,
  ``tcp://`` rendezvous) for a mesh that spans processes: a
  ``MeshPlan`` built after it holds ``world_size`` x its local docs
  shards, and the mesh collectives cross the group as one host-tensor
  ``all_reduce``/``all_gather`` (``parallel.mesh``). Gloo on host
  tensors, because NCCL refuses two ranks on one GPU.
* ``MpiLiteComm`` + ``run_sharded_ingest`` — the reference's
  rank-partitioned document loop (``TFIDF.c:130``) over N OS processes,
  each driving its own host -> device link: the parent launches workers
  with the process model of ``native/mpirun_lite`` (pairwise AF_UNIX
  socketpairs inherited through ``MPILITE_RANK/SIZE/FDS``) and each
  worker ingests a contiguous document shard through the port's
  ``run_overlapped``. The only cross-worker traffic is the DF allreduce
  (``MPI_Reduce + MPI_Bcast`` of the DF table, ``TFIDF.c:215,220``), one
  [V] vector per worker per run. ``MpiLiteComm`` speaks the exact
  mpi_lite wire (``native/mpi_lite/mpi_lite.cc``: framed ``[i32 tag][u64
  bytes]`` messages, root-sequenced collectives, reserved negative
  tags), so a Python rank launched by the native ``mpirun_lite`` finds
  the channels a C rank would.

The merged index is bit-identical to a single-process ingest: a
document's row depends only on its own tokens and the global DF/IDF, DF
is an order-independent integer sum, and the shards concatenate in
global discovery order. Each worker runs on the parent's device (the
spec carries it) and fails when it cannot get it; a failed worker makes
``run_sharded_ingest`` raise.
"""

from __future__ import annotations

import dataclasses
import json
import os
import select
import socket
import struct
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# Reserved collective tags — the mpi_lite runtime's values
# (native/mpi_lite/mpi_lite.cc): point-to-point tags are >= 0, so the
# collectives can never collide with them.
_TAG_BCAST = -101
_TAG_BARRIER_IN = -102
_TAG_BARRIER_OUT = -103
# The allreduce's contribution tag (the C runtime sequences its
# reductions through Send/Recv with caller tags; this one is reserved so
# a concurrent point-to-point exchange cannot interleave).
_TAG_REDUCE = -105
# Clock-alignment handshake: rank 0 brackets each peer's perf_counter_ns
# reply and estimates the offset at the RTT midpoint, recorded as
# trace-export metadata and applied only when traces are merged.
_TAG_CLOCK = -106
_CLOCK_SAMPLES = 8

_FRAME_HDR = struct.Struct("<iQ")  # [i32 tag][u64 nbytes]

# The directory that holds the tfidf_tpu_torch package: workers run
# ``python -m tfidf_tpu_torch.parallel.multihost`` with it on their path.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class MpiLiteError(RuntimeError):
    """Protocol violation on an mpi_lite channel (tag mismatch, short
    read, peer gone): aborting loudly beats silently reordering."""


class MpiLiteComm:
    """The mpi_lite runtime subset in Python, over inherited fds.

    Wire protocol per (src, dst) channel: framed messages ``[i32
    tag][u64 bytes][payload]``, strictly ordered per channel; every send
    has exactly one program-ordered matching recv, and a frame whose tag
    differs from the one the receiver asked for raises
    :class:`MpiLiteError`. Collectives are root-sequenced (peers talk
    only to rank 0), the C runtime's deadlock discipline.
    """

    def __init__(self, rank: int, size: int, fds: Sequence[int]):
        if len(fds) != size:
            raise MpiLiteError(f"fds length {len(fds)} != size {size}")
        self.rank = rank
        self.size = size
        self._fds = list(fds)

    @classmethod
    def from_env(cls) -> "MpiLiteComm":
        """Attach to the channels ``mpirun_lite`` (or
        :func:`launch_ranks`) wired up: ``MPILITE_RANK``,
        ``MPILITE_SIZE``, ``MPILITE_FDS`` (own slot -1)."""
        try:
            rank = int(os.environ["MPILITE_RANK"])
            size = int(os.environ["MPILITE_SIZE"])
            raw = os.environ["MPILITE_FDS"]
        except KeyError as e:
            raise MpiLiteError(f"not under an mpi_lite launcher "
                               f"(missing {e.args[0]})")
        fds = []
        for part in raw.split(","):
            try:
                fds.append(int(part))
            except ValueError:
                raise MpiLiteError(
                    f"malformed MPILITE_FDS entry {part!r} in {raw!r}")
        return cls(rank, size, fds)

    # --- framed point-to-point ---
    def _write_all(self, fd: int, data: bytes) -> None:
        view = memoryview(data)
        while view:
            n = os.write(fd, view)
            view = view[n:]

    def _read_all(self, fd: int, n: int) -> bytes:
        parts = []
        while n:
            chunk = os.read(fd, min(n, 1 << 20))
            if not chunk:
                raise MpiLiteError("peer closed channel mid-message")
            parts.append(chunk)
            n -= len(chunk)
        return b"".join(parts)

    def send(self, peer: int, tag: int, payload: bytes) -> None:
        fd = self._fds[peer]
        if fd < 0:
            raise MpiLiteError(f"send to self/unwired peer {peer}")
        self._write_all(fd, _FRAME_HDR.pack(tag, len(payload)))
        self._write_all(fd, payload)

    def recv(self, peer: int, tag: int) -> bytes:
        fd = self._fds[peer]
        if fd < 0:
            raise MpiLiteError(f"recv from self/unwired peer {peer}")
        got_tag, nbytes = _FRAME_HDR.unpack(
            self._read_all(fd, _FRAME_HDR.size))
        if got_tag != tag:
            raise MpiLiteError(
                f"tag mismatch on channel {peer}->{self.rank}: "
                f"expected {tag}, got {got_tag} — per-channel ordering "
                f"is the protocol; this is a bug, not a race")
        return self._read_all(fd, nbytes)

    # --- root-sequenced collectives (rank 0 is root, like the C
    # runtime's MPI_COMM_WORLD collectives) ---
    def barrier(self) -> None:
        if self.rank == 0:
            for peer in range(1, self.size):
                self.recv(peer, _TAG_BARRIER_IN)
            for peer in range(1, self.size):
                self.send(peer, _TAG_BARRIER_OUT, b"")
        else:
            self.send(0, _TAG_BARRIER_IN, b"")
            self.recv(0, _TAG_BARRIER_OUT)

    def bcast_bytes(self, payload: Optional[bytes]) -> bytes:
        if self.rank == 0:
            assert payload is not None
            for peer in range(1, self.size):
                self.send(peer, _TAG_BCAST, payload)
            return payload
        return self.recv(0, _TAG_BCAST)

    def allreduce_sum(self, arr: np.ndarray) -> np.ndarray:
        """Exact elementwise sum of every rank's array, the DF
        reduction (integer sums are order-independent, so the merged DF
        equals a single-process fold bit for bit). Peers send to rank 0,
        which sums in rank order and broadcasts the result."""
        arr = np.ascontiguousarray(arr)
        if self.size == 1:
            return arr.copy()
        if self.rank == 0:
            acc = arr.copy()
            for peer in range(1, self.size):
                acc += np.frombuffer(self.recv(peer, _TAG_REDUCE),
                                     dtype=arr.dtype).reshape(arr.shape)
            self.bcast_bytes(acc.tobytes())
            return acc
        self.send(0, _TAG_REDUCE, arr.tobytes())
        out = np.frombuffer(self.bcast_bytes(None),
                            dtype=arr.dtype).reshape(arr.shape)
        return out.copy()

    def poll(self, peer: int, timeout_s: Optional[float] = None) -> bool:
        """True when a frame from ``peer`` is readable within
        ``timeout_s`` (None = block): a bounded wait that tells a wedged
        peer from a slow one."""
        fd = self._fds[peer]
        if fd < 0:
            raise MpiLiteError(f"poll on self/unwired peer {peer}")
        readable, _, _ = select.select([fd], [], [], timeout_s)
        return bool(readable)

    def wire(self, peer: int, fd: int) -> None:
        """Install (or replace) the channel to ``peer``: a respawned
        child's fresh socketpair (:func:`launch_rank`) takes the stale
        fd's slot, so the same comm keeps speaking to the replacement."""
        old = self._fds[peer]
        if old >= 0 and old != fd:
            try:
                os.close(old)
            except OSError:
                pass
        self._fds[peer] = fd

    def unwire(self, peer: int) -> None:
        """Close and forget the channel to ``peer`` (dead child)."""
        self.wire(peer, -1)

    def close(self) -> None:
        for fd in self._fds:
            if fd >= 0:
                try:
                    os.close(fd)
                except OSError:
                    pass
        self._fds = [-1] * self.size


def clock_handshake(comm: MpiLiteComm, samples: int = _CLOCK_SAMPLES) -> dict:
    """Every rank's clock offset against rank 0's. Rank 0 pings each
    peer ``samples`` times over ``_TAG_CLOCK``, the peer answers with its
    raw ``perf_counter_ns``, and rank 0 keeps the minimum-RTT estimate
    (``obs.disttrace.ClockOffsetEstimator``); each peer receives its own
    estimate and returns it, rank 0 the zero self-estimate. The dict is
    trace-export metadata (``offset_ns``, ``uncertainty_ns``, ``rtt_ns``,
    ``samples``), applied when traces are merged, never at capture."""
    from tfidf_tpu_torch.obs.disttrace import ClockOffsetEstimator

    if comm.size == 1:
        return ClockOffsetEstimator().as_meta()
    if comm.rank == 0:
        for peer in range(1, comm.size):
            est = ClockOffsetEstimator()
            for _ in range(samples):
                t_send = time.perf_counter_ns()
                comm.send(peer, _TAG_CLOCK, b"")
                t_peer = struct.unpack("<q", comm.recv(peer, _TAG_CLOCK))[0]
                est.add_sample(t_send, t_peer, time.perf_counter_ns())
            comm.send(peer, _TAG_CLOCK, json.dumps(est.as_meta()).encode())
        return ClockOffsetEstimator().as_meta()
    for _ in range(samples):
        comm.recv(0, _TAG_CLOCK)
        comm.send(0, _TAG_CLOCK, struct.pack("<q", time.perf_counter_ns()))
    return json.loads(comm.recv(0, _TAG_CLOCK).decode())


def launch_ranks(n: int, argv_for_rank: Callable[[int], List[str]],
                 env: Optional[dict] = None,
                 stderr=subprocess.PIPE) -> List[subprocess.Popen]:
    """The ``mpirun_lite`` process model: one AF_UNIX socketpair per
    rank pair, N children each inheriting its own row of fds through
    ``MPILITE_RANK/SIZE/FDS``, the same channel environment the native
    launcher gives."""
    pair_fd = [[-1] * n for _ in range(n)]
    socks = []  # the socket objects stay alive until the spawn
    for i in range(n):
        for j in range(i + 1, n):
            a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
            a.setblocking(True)
            b.setblocking(True)
            socks += [a, b]
            pair_fd[i][j] = a.fileno()
            pair_fd[j][i] = b.fileno()
    procs = []
    base_env = dict(os.environ if env is None else env)
    for r in range(n):
        fds = [pair_fd[r][j] for j in range(n)]
        child_env = dict(base_env,
                         MPILITE_RANK=str(r), MPILITE_SIZE=str(n),
                         MPILITE_FDS=",".join(str(f) for f in fds))
        procs.append(subprocess.Popen(
            argv_for_rank(r), env=child_env,
            pass_fds=[f for f in fds if f >= 0],
            stdout=subprocess.PIPE, stderr=stderr, text=True))
    for s in socks:  # the children hold their own copies
        s.close()
    return procs


def launch_rank(rank: int, size: int, argv: List[str],
                env: Optional[dict] = None, stderr=None,
                stdin=subprocess.PIPE) -> Tuple[int, subprocess.Popen]:
    """Spawn ONE child wired to the caller over a fresh socketpair (the
    star topology beside :func:`launch_ranks`): the caller plays rank
    0, the child attaches as ``rank`` of ``size`` with only its rank-0
    channel wired, so every exchange goes through the caller. Returns
    ``(parent_fd, Popen)``; install the fd with :meth:`MpiLiteComm.wire`.
    ``stderr=None`` inherits the caller's (an undrained pipe would
    block the child on a full buffer)."""
    if not 1 <= rank < size:
        raise ValueError(f"rank {rank} out of range for size {size}")
    a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
    a.setblocking(True)
    b.setblocking(True)
    fds = [-1] * size
    fds[0] = b.fileno()
    base_env = dict(os.environ if env is None else env)
    child_env = dict(base_env,
                     MPILITE_RANK=str(rank), MPILITE_SIZE=str(size),
                     MPILITE_FDS=",".join(str(f) for f in fds))
    proc = subprocess.Popen(argv, env=child_env, pass_fds=[b.fileno()],
                            stdin=stdin, stdout=subprocess.PIPE,
                            stderr=stderr, text=True)
    parent_fd = os.dup(a.fileno())
    a.close()
    b.close()
    return parent_fd, proc


def shard_bounds(num_docs: int, n_workers: int) -> List[Tuple[int, int]]:
    """Contiguous document shards in global discovery order, the
    reference's ``rank * docs / size`` partition (``TFIDF.c:130``); the
    last is ragged when ``num_docs % n_workers != 0``, and there are
    never more shards than documents."""
    if n_workers < 1:
        raise ValueError("n_workers must be >= 1")
    n_workers = min(n_workers, max(num_docs, 1))
    return [(r * num_docs // n_workers, (r + 1) * num_docs // n_workers)
            for r in range(n_workers)]


def _config_to_spec(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["vocab_mode"] = cfg.vocab_mode.value
    d["tokenizer"] = cfg.tokenizer.value
    d["ngram_range"] = list(cfg.ngram_range)
    return d


def _config_from_spec(d: dict):
    from tfidf_tpu_torch.config import (PipelineConfig, TokenizerKind,
                                        VocabMode)
    d = dict(d)
    d["vocab_mode"] = VocabMode(d["vocab_mode"])
    d["tokenizer"] = TokenizerKind(d["tokenizer"])
    d["ngram_range"] = tuple(d["ngram_range"])
    return PipelineConfig(**d)


def _worker_main(spec_path: str) -> int:
    """One ingest rank: attach to the mpi_lite channels, ingest the
    assigned contiguous shard through the same ``run_overlapped`` a
    single-process run takes (only the IDF's ``num_docs`` and the merged
    DF are global), and write the shard's rows for the parent."""
    with open(spec_path) as f:
        spec = json.load(f)
    comm = MpiLiteComm.from_env()
    from tfidf_tpu_torch import obs
    from tfidf_tpu_torch.ingest import run_overlapped
    from tfidf_tpu_torch.ops import kernels
    from tfidf_tpu_torch.pipeline import resolve_device

    device = resolve_device(spec["device"])  # no silent fallback
    cfg = _config_from_spec(spec["config"])
    lo, hi = spec["shards"][comm.rank]

    def df_merge(df_host: np.ndarray) -> np.ndarray:
        return comm.allreduce_sum(np.asarray(df_host, dtype=np.int32))

    walls = []
    result = None
    for _ in range(max(1, int(spec.get("repeat", 1)))):
        kernels.reset_launches()  # the last run's launches are reported
        # Every rank starts its ingest at the same barrier, so the
        # per-rank walls measure concurrent work.
        comm.barrier()
        t0 = time.perf_counter()
        result = run_overlapped(
            spec["input_dir"], cfg, chunk_docs=spec["chunk_docs"],
            doc_len=spec["doc_len"], strict=spec["strict"],
            spill=spec["spill"], shard=(lo, hi),
            total_docs=spec["total_docs"],
            df_merge=df_merge if comm.size > 1 else None, device=device)
        walls.append(time.perf_counter() - t0)
    # No rank tears its channels down while a peer is mid-allreduce.
    comm.barrier()
    card_bytes = _card_bytes_in_use(device)  # every rank is alive here
    # The channels are quiet here, so the ping RTTs are honest.
    clock = clock_handshake(comm)
    obs.set_export_meta(process=f"ingest{comm.rank}", clock=clock)
    out = spec["out_paths"][comm.rank]
    arrays = {"topk_vals": np.asarray(result.topk_vals),
              "topk_ids": np.asarray(result.topk_ids),
              "lengths": np.asarray(result.lengths)}
    if comm.rank == 0:
        arrays["df"] = np.asarray(result.df)
    np.savez(out, **arrays)
    meta = {"rank": comm.rank, "lo": lo, "hi": hi,
            "wall_s": walls[-1], "walls_s": walls,
            "phases": result.phases or {}, "path": result.path,
            "wire": result.wire, "finish": result.finish,
            "bytes_on_wire": result.bytes_on_wire,
            "df_occupied": result.df_occupied,
            "device_bytes": _device_bytes(device),
            "card_bytes_in_use": card_bytes,
            "launches": dict(kernels.LAUNCHES)}
    with open(out + ".meta.json", "w") as f:
        json.dump(meta, f)
    obs.export()  # no-op unless a trace is armed
    comm.close()
    print(f"OK {comm.rank}")
    return 0


def _device_bytes(device) -> int:
    """Bytes the worker's caching allocator reserves on its card (0 on
    the CPU)."""
    import torch
    if device.type != "cuda":
        return 0
    return int(torch.cuda.memory_reserved(device))


def _card_bytes_in_use(device) -> int:
    """Bytes in use on the worker's card, every process's (its CUDA
    context included; 0 on the CPU)."""
    import torch
    if device.type != "cuda":
        return 0
    free, total = torch.cuda.mem_get_info(device)
    return int(total - free)


def _upload_seconds(phases: Dict[str, float]) -> float:
    """The seconds a worker run spent driving its link: the resident
    path's ``put`` (upload + issue) or the streaming passes'."""
    if "put" in phases:
        return float(phases["put"])
    return float(phases.get("pass_a", 0.0)) + float(
        phases.get("pass_b", 0.0))


@dataclasses.dataclass
class ShardedIngestInfo:
    """Per-worker receipts of a :func:`run_sharded_ingest` run."""

    n_workers: int
    shards: List[Tuple[int, int]]
    wall_s: float               # max over workers (concurrent ranks)
    worker_walls_s: List[float]
    upload_s: float             # max over workers' link-driving time
    worker_upload_s: List[float]
    # Fraction of each worker's wall spent driving its own link.
    link_utilization: List[float]
    worker_phases: List[Dict[str, float]]
    path: str = ""
    wire: str = ""
    # Bytes each worker's allocator reserved on its card at its end, and
    # the card's bytes in use then (every process's, contexts included).
    worker_device_bytes: List[int] = dataclasses.field(default_factory=list)
    card_bytes_in_use: List[int] = dataclasses.field(default_factory=list)
    # Each worker's kernel launches in its last run (ops.kernels).
    worker_launches: List[Dict[str, int]] = dataclasses.field(
        default_factory=list)


def run_sharded_ingest(input_dir: str, config=None, n_workers: int = 2,
                       chunk_docs: int = 8192,
                       doc_len: Optional[int] = None, strict: bool = True,
                       spill: str = "auto", repeat: int = 1,
                       timeout_s: float = 600.0,
                       keep_dir: Optional[str] = None, device=None):
    """Ingest ``input_dir`` over ``n_workers`` OS processes, each packing
    and uploading its contiguous document shard concurrently; returns
    ``(IngestResult, ShardedIngestInfo)``.

    The merged result equals a single-process
    :func:`~tfidf_tpu_torch.ingest.run_overlapped` of the same corpus and
    config bit for bit (DF, scores, ids and their tie order, lengths,
    names). ``repeat`` re-runs the timed ingest inside each warm worker
    and reports the last run's walls. ``device`` (CUDA unless named; it
    raises without a GPU) is every worker's device: N workers on one
    card each hold their own CUDA context on it. A worker that exits
    non-zero (its device missing included) makes this raise.
    """
    from tfidf_tpu_torch.config import PipelineConfig, VocabMode
    from tfidf_tpu_torch.ingest import IngestResult
    from tfidf_tpu_torch.io.corpus import discover_names
    from tfidf_tpu_torch.pipeline import resolve_device

    dev = resolve_device(device)
    cfg = config or PipelineConfig(vocab_mode=VocabMode.HASHED, topk=16)
    names = discover_names(input_dir, strict)
    if not names:
        raise ValueError(f"no documents in {input_dir}")
    shards = shard_bounds(len(names), n_workers)
    n_workers = len(shards)

    tmp = keep_dir or tempfile.mkdtemp(prefix="tfidf_mh_")
    out_paths = [os.path.join(tmp, f"shard{r}.npz") for r in range(n_workers)]
    spec = {"input_dir": input_dir, "config": _config_to_spec(cfg),
            "chunk_docs": chunk_docs, "doc_len": doc_len, "strict": strict,
            "spill": spill, "repeat": repeat, "total_docs": len(names),
            "shards": [list(s) for s in shards], "out_paths": out_paths,
            "device": str(dev)}
    spec_path = os.path.join(tmp, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    procs = launch_ranks(
        n_workers,
        lambda r: [sys.executable, "-m", "tfidf_tpu_torch.parallel.multihost",
                   spec_path], env=env)
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(
                f"ingest worker {r} failed rc={p.returncode}\n"
                f"stdout: {out[-2000:]}\nstderr: {err[-2000:]}")

    parts, metas = [], []
    for path in out_paths:
        with np.load(path) as z:
            parts.append({key: z[key] for key in z.files})
        with open(path + ".meta.json") as f:
            metas.append(json.load(f))
    df = parts[0]["df"]
    walls = [m["wall_s"] for m in metas]
    uploads = [_upload_seconds(m["phases"]) for m in metas]
    info = ShardedIngestInfo(
        n_workers=n_workers, shards=shards,
        wall_s=max(walls), worker_walls_s=walls,
        upload_s=max(uploads), worker_upload_s=uploads,
        link_utilization=[round(min(1.0, u / w), 4) if w > 0 else 0.0
                          for u, w in zip(uploads, walls)],
        worker_phases=[m["phases"] for m in metas],
        path=metas[0]["path"], wire=metas[0]["wire"],
        worker_device_bytes=[m["device_bytes"] for m in metas],
        card_bytes_in_use=[m["card_bytes_in_use"] for m in metas],
        worker_launches=[m["launches"] for m in metas])
    result = IngestResult(
        df=df,
        topk_vals=np.concatenate([p["topk_vals"] for p in parts]),
        topk_ids=np.concatenate([p["topk_ids"] for p in parts]),
        lengths=np.concatenate([p["lengths"] for p in parts]),
        names=names, num_docs=len(names),
        df_occupied=int((df > 0).sum()),
        path=f"sharded-{n_workers}proc:{metas[0]['path']}",
        phases={"upload": info.upload_s, "wall": info.wall_s},
        wire=metas[0]["wire"],
        bytes_on_wire=sum(int(m["bytes_on_wire"] or 0) for m in metas))
    if keep_dir is None:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    return result, info


@dataclasses.dataclass(frozen=True)
class HostTopology:
    process_id: int
    num_processes: int
    local_devices: int
    global_devices: int


def _local_devices() -> int:
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> HostTopology:
    """Bring up the process group (idempotent, single-host safe).

    With a ``coordinator_address`` (``host:port`` or ``tcp://host:port``)
    it calls ``torch.distributed.init_process_group("gloo")`` with that
    rendezvous, ``num_processes`` and ``process_id``. With no arguments
    it does the same from the environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) when ``MASTER_ADDR`` is
    set, and otherwise nothing: it reports the local topology, so one
    program runs everywhere. A second call returns the same topology.
    """
    import torch.distributed as dist

    if not dist.is_initialized():
        if coordinator_address is not None or num_processes is not None:
            addr = coordinator_address or "localhost:29500"
            if "://" not in addr:
                addr = f"tcp://{addr}"
            dist.init_process_group("gloo", init_method=addr,
                                    world_size=num_processes or 1,
                                    rank=process_id or 0)
        elif os.environ.get("MASTER_ADDR"):
            dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = _local_devices()
    return HostTopology(process_id=rank, num_processes=world,
                        local_devices=local, global_devices=local * world)


if __name__ == "__main__":  # the ingest-worker entry launch_ranks spawns
    sys.exit(_worker_main(sys.argv[1]))
