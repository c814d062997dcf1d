"""Overlapped corpus ingest: host packing pipelined against device
compute (port of ``tfidf_tpu/ingest.py``'s ``run_overlapped``: one
device, a docs-sharded mesh, or one worker of a multi-process sharded
ingest).

The corpus streams through in chunks. One packer thread reads, packs and
(on the id wires) tokenizes and hashes chunk i+1 with the native loader
while the main thread uploads chunk i and issues its device work, so
host packing overlaps the device. Three upload wires:

* ``ragged`` (the default): one flat, granule-aligned uint16 id stream
  per chunk (bytes scale with real tokens), rebuilt into the padded
  [D, L] batch on the device by kernel B4 (``ops.kernels.ragged_rebuild``);
* ``bytes``: the chunk's raw document bytes; tokenize and hash run on
  the device (``ops.device_tokenize``, kernel B5), so the host only reads
  files and copies bytes;
* ``padded``: the [D, L] batch itself, the parity wire.

Per chunk the device sorts the rows into sparse triples
(``ops.sparse.sorted_term_counts``) and folds the chunk's DF into a [V]
accumulator. Two regimes, chosen by corpus size against
``TFIDF_TPU_RESIDENT_ELEMS``:

* **Resident**: the triples stay on the device. Once DF is final, phase
  B scores them (kernel B1) and packs the top-k into uint32 words
  (kernel B3): ``finish="scan"`` writes every chunk into one
  preallocated [n_chunks, chunk_docs, K] buffer drained by one copy;
  ``"chunked"`` drains each chunk's words while the next one scores.
  The pair result wire scores the concatenated triples in one step and
  ships (score, id) pairs as one byte buffer.
* **Streaming**: pass A folds DF and keeps only a byte-budgeted prefix of
  triples (``TFIDF_TPU_TRIPLE_CACHE_BYTES``); pass B scores the cached
  prefix, then re-derives the rest from chunks kept in host RAM
  (``spill="host"``) or re-read from disk (``spill="reread"``).

``wire_vals=False`` (the hashed exact-terms engine's fetch) ships only
the selected ids off the resident run: invalid slots read bucket 0 and
``topk_vals`` is None; the streaming regime ignores it and returns full
scores, as the JAX package's does. :func:`run_overlapped_exact` is the
device-exact engine: the native intern table gives every distinct word
a collision-free id as the chunks pack (ragged wire, B4 every chunk),
and the exact-ids wire ships each pick's (id, count) plus the [V] DF, so
the host rescores in float64 without re-reading the corpus
(``rerank.exact_topk_from_wire``). :func:`profile_resident` times the
resident run's phases one at a time, each fenced.

With a mesh ``plan`` the same two regimes run docs-sharded (``path
"resident-mesh"`` or ``"streaming-mesh"``, the padded wire): every chunk
splits into a block of rows per shard, each shard folds its own DF
partial, one psum joins them, and each shard scores its own rows (see
``_Run``). The ``shard``/``df_merge``/``total_docs`` hooks make a run one
worker of ``parallel.multihost.run_sharded_ingest``.

Differences from the JAX package: there is no jit, donation or
``lax.scan`` (PyTorch runs eagerly: the scan finish is a loop), the DF
accumulator is updated in place, the DF join is always the gather join
and every chunk folds its DF (the JAX package's own choice off the TPU),
and ``IngestResult.df`` is a host ndarray on every path. The lowering
selectors ``TFIDF_TPU_REBUILD``, ``TFIDF_TPU_SCORE``,
``TFIDF_TPU_DOWNLINK`` and ``TFIDF_TPU_DEVICE_TOKENIZE`` are validated
as in the JAX package but choose nothing: on CUDA every step runs its
kernel, on the CPU its plain version.
On one device the packer and drainer jobs run supervised, as in the JAX
package: each beats ``packer``/``drainer`` and fires the
``pack_worker``/``drain`` fault seam; a crash is retried with backoff up
to ``TFIDF_TPU_RESTART_BUDGET`` times (default 3), each retry a
``worker_restart`` event, and a ``FatalFault`` surfaces at once. A mesh
run's workers are unsupervised, as the JAX mesh ingest packs inline.

With the span tracer armed (``obs.configure``: ``--trace`` or
``TFIDF_TPU_TRACE``) a run records the JAX package's spans on the same
lanes: ``pack`` (and on the bytes wire ``slab``, with its bytes) on the
``packer`` lane; ``pack_wait``, ``dispatch`` (the uploaded wire's
bytes), ``device_tokenize`` (the slab's bytes), ``phase_b``,
``fetch_wait``, ``link_sync`` (the DF's bytes, a sharded worker's
merge) and ``fetch`` (the result wire's bytes) on ``main``; ``drain``
(the fetched words' bytes) on the ``drainer`` lane. ``phase_b`` is a
device span that closes once its device work has finished (it waits on
an event), so while tracing it is the scoring's time, not its enqueue;
no other span waits on the device, and the packer and drainer spans add
no synchronisation.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import dataclasses
import functools
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tfidf_tpu_torch import faults, obs
from tfidf_tpu_torch.config import PipelineConfig, TokenizerKind, VocabMode
from tfidf_tpu_torch.io import fast_tokenizer
from tfidf_tpu_torch.io.corpus import Corpus, discover_names, pack_corpus
from tfidf_tpu_torch.obs.health import beat as _health_beat
from tfidf_tpu_torch.ops.device_tokenize import (aligned_byte_lengths,
                                                 tokenize_hash_device,
                                                 tokenize_method)
from tfidf_tpu_torch.ops.downlink import (pair_slot_bytes,
                                          unpack_result_words,
                                          use_packed_result_wire)
from tfidf_tpu_torch.ops.kernels import pack_words, ragged_rebuild
from tfidf_tpu_torch.ops.scoring import canonical_score_dtype, idf_from_df
from tfidf_tpu_torch.ops.sparse import (score_topk, sorted_term_counts,
                                        sparse_df, sparse_topk_counts)
from tfidf_tpu_torch.pipeline import resolve_device

# spill="auto": keep packed chunks in host RAM up to this many bytes
# (TFIDF_TPU_SPILL_BYTES), re-read from disk beyond.
_DEFAULT_SPILL_BYTES = 1 << 30
# Host-ahead floor of the streaming loops; the bound itself is
# byte-budgeted (TFIDF_TPU_INFLIGHT_BYTES / chunk bytes).
_LOOKAHEAD = 2
# Streaming triple cache budget (TFIDF_TPU_TRIPLE_CACHE_BYTES): ids and
# counts int32 + head bool = 9 bytes per slot.
_TRIPLE_CACHE_BYTES = 4 << 30
# Largest corpus (doc slots x token length) the resident regime holds
# (TFIDF_TPU_RESIDENT_ELEMS); beyond it the streaming regime runs.
_RESIDENT_ELEMS = 1 << 28


def _pow2_env(name: str, default: int) -> int:
    value = int(os.environ.get(name, str(default)))
    if value <= 0 or value & (value - 1):
        raise ValueError(f"{name} must be a positive power of two, "
                         f"got {value}")
    return value


def flat_bucket() -> int:
    """Flat-stream padding granularity in ids (``TFIDF_TPU_FLAT_BUCKET``,
    default 2^17): every chunk's flat wire is a whole number of buckets,
    so a run sees a handful of wire shapes."""
    return _pow2_env("TFIDF_TPU_FLAT_BUCKET", 1 << 17)


def byte_bucket() -> int:
    """The bytes wire's slab padding granularity
    (``TFIDF_TPU_BYTE_BUCKET``, default :func:`flat_bucket` bytes)."""
    return _pow2_env("TFIDF_TPU_BYTE_BUCKET", flat_bucket())


def _wire_align() -> int:
    """The wire granule G (``TFIDF_TPU_WIRE_ALIGN``, default 16), read and
    validated at call time: each doc's ids start at a multiple of G. A
    power of two no larger than :func:`flat_bucket`, so the bucket pad
    is whole granules."""
    align = max(1, int(os.environ.get("TFIDF_TPU_WIRE_ALIGN", "16")))
    if align & (align - 1):
        raise ValueError(f"TFIDF_TPU_WIRE_ALIGN must be a power of two, "
                         f"got {align}")
    bucket = flat_bucket()
    if align > bucket:
        raise ValueError(
            f"TFIDF_TPU_WIRE_ALIGN ({align}) must not exceed the flat "
            f"wire bucket (TFIDF_TPU_FLAT_BUCKET = {bucket}): the "
            f"bucket-padded stream must hold a whole number of granules")
    return align


def _ragged_max_ids() -> int:
    """Largest aligned flat capacity of one chunk: int32 offsets, whole
    buckets. Past it the padded wire carries the run."""
    return (1 << 31) - flat_bucket()


def _bucket_pad_flat(flat: np.ndarray, total: int) -> np.ndarray:
    """Round a flat stream up to a :func:`flat_bucket` multiple with zero
    fill, at least one bucket; in place when the buffer has room."""
    bucket = flat_bucket()
    pad = max(total + (-total % bucket), bucket) - total
    if total + pad <= flat.size:
        flat[total:total + pad] = 0
        return flat[:total + pad]
    return np.pad(flat[:total], (0, pad))


def _bucket_cap_ids(chunk_docs: int, length: int, align: int) -> int:
    """Staging capacity (ids) of one chunk's flat wire: the worst-case
    aligned content rounded up to whole buckets (at least one)."""
    per_doc = -(-length // align) * align
    cap = max(chunk_docs * per_doc, 1)
    return cap + (-cap % flat_bucket())


def flatten_aligned(ids, lengths, align: Optional[int] = None,
                    dtype=np.uint16):
    """Host-side flat wire from a padded [D, L] id batch, in the layout
    the native flat packer emits: each doc's live ids back to back, zero
    fill up to the next ``align`` multiple, then bucket-padded. Returns
    ``(flat, total)``, ``total`` the live aligned id count."""
    if align is None:
        align = _wire_align()
    d, width = ids.shape
    mask = np.arange(width)[None, :] < lengths[:d, None]
    if align > 1:
        wc = -(-width // align) * align
        z = np.where(mask, ids, 0)
        if wc != width:
            z = np.pad(z, ((0, 0), (0, wc - width)))
        al = -(-np.maximum(lengths[:d], 0) // align) * align
        amask = np.arange(wc)[None, :] < al[:, None]
        flat = np.ascontiguousarray(z[amask].astype(dtype))
    else:
        flat = np.ascontiguousarray(ids[mask].astype(dtype))
    total = flat.size
    return _bucket_pad_flat(flat, total), total


def resolve_wire(cfg: PipelineConfig) -> str:
    """The run's ASKED wire: ``TFIDF_TPU_WIRE``, else ``config.wire``.
    What carries the run degrades bytes -> ragged -> padded
    (:func:`use_bytes_wire`, :func:`use_ragged_wire`)."""
    choice = os.environ.get("TFIDF_TPU_WIRE") or getattr(cfg, "wire",
                                                         "ragged")
    if choice not in ("ragged", "padded", "bytes"):
        raise ValueError(
            f"unknown wire {choice!r} (TFIDF_TPU_WIRE / --wire: choose "
            f"'ragged', 'padded' or 'bytes')")
    return choice


def use_bytes_wire(cfg: PipelineConfig, chunk_docs: int,
                   length: int) -> bool:
    """True when the run ships raw bytes and tokenizes on the device:
    asked for, vocab within 2^16 (the device fold's bound, kept so both
    packages pick the same wire), the whitespace tokenizer, and a chunk
    whose token slots fit int32."""
    if resolve_wire(cfg) != "bytes":
        return False
    if cfg.vocab_size > (1 << 16):
        return False
    if cfg.tokenizer is not TokenizerKind.WHITESPACE:
        return False
    return chunk_docs * length < (1 << 31)


def use_ragged_wire(cfg: PipelineConfig, chunk_docs: int,
                    length: int) -> bool:
    """True = the ragged flat uint16 stream, False = the padded batch.
    Not ``"padded"``, vocab within 2^16 (uint16 ids), and an aligned
    chunk capacity within :func:`_ragged_max_ids`."""
    if resolve_wire(cfg) == "padded":
        return False
    if cfg.vocab_size > (1 << 16):
        return False
    align = _wire_align()
    per_doc = -(-length // align) * align
    return chunk_docs * per_doc <= _ragged_max_ids()


def resolve_finish(cfg: PipelineConfig) -> str:
    """Phase-B finish structure: ``TFIDF_TPU_FINISH``, else
    ``config.finish`` (``"scan"`` or ``"chunked"``)."""
    choice = (os.environ.get("TFIDF_TPU_FINISH")
              or getattr(cfg, "finish", "scan"))
    if choice not in ("scan", "chunked"):
        raise ValueError(
            f"unknown finish {choice!r} (TFIDF_TPU_FINISH / --finish: "
            f"choose 'scan' or 'chunked')")
    return choice


def use_scan_finish(cfg: PipelineConfig, packed_wire: bool) -> bool:
    """True when phase B is the one-buffer scan finish: only the packed
    result wire has a per-chunk finish to collapse."""
    return packed_wire and resolve_finish(cfg) == "scan"


# Test hook: when set to a callable, the loops report ("event", chunk)
# tuples as work is issued — pack_submit, pack_done, upload, dispatch,
# drain_submit, drain_done, fetch_start, fetch_done — the ordering
# contract of the double-buffered pipeline.
_overlap_trace = None


def _trace(event: str, idx: int = -1) -> None:
    if _overlap_trace is not None:
        _overlap_trace((event, idx))


def _restart_budget() -> int:
    """Job restarts an ingest worker tolerates before its crash surfaces
    to the dispatch loop (``TFIDF_TPU_RESTART_BUDGET``, default 3; the
    serve batcher reads the same knob through ``ServeConfig``)."""
    return max(0, int(os.environ.get("TFIDF_TPU_RESTART_BUDGET", "3")))


def _supervised_job(worker: str, idx: int, body):
    """Run one packer or drainer job under restart supervision. Each
    attempt first fires the worker's seam (``pack_worker`` or ``drain``),
    then runs ``body``. A crash, injected or real, is retried with
    jittered backoff inside the restart budget, each retry a
    ``worker_restart`` flight event and trace instant; a ``FatalFault``
    or a crash past the budget propagates. A job is a pure function of
    its chunk, so re-running it is safe: a drain re-reads the same
    pinned buffer, which its closure keeps alive, and the exact path's
    intern table is append-only, so a re-packed chunk gets the same
    ids."""
    from tfidf_tpu_torch.obs import log as obs_log
    budget = _restart_budget()
    attempt = 0
    while True:
        try:
            faults.fire("pack_worker" if worker == "packer"
                        else "drain", chunk=idx)
            return body()
        except faults.FatalFault:
            raise
        except Exception as e:  # noqa: BLE001 — supervised restart
            attempt += 1
            if attempt > budget:
                raise
            obs_log.log_event(
                "warning", "worker_restart",
                msg=f"{worker} job for chunk {idx} crashed "
                    f"({type(e).__name__}: {e}); restart "
                    f"{attempt}/{budget}",
                worker=worker, chunk=idx, restart=attempt,
                error=type(e).__name__)
            obs.instant("worker_restart", worker=worker, chunk=idx,
                        restart=attempt)
            time.sleep(faults.backoff_s(attempt, 20.0))


# --- guards -----------------------------------------------------------

def _check_chunk_fits_int32(chunk_docs: int, length: int) -> None:
    """One chunk must hold < 2^31 token slots (int32 offsets and slot
    positions). Also revalidates ``TFIDF_TPU_WIRE_ALIGN`` by name."""
    _wire_align()
    if chunk_docs * length >= (1 << 31):
        raise ValueError(
            f"chunk of {chunk_docs} docs x {length} tokens overflows "
            f"int32 flat offsets; lower --chunk-docs or raise "
            f"TFIDF_TPU_MAX_CHUNKS")


def _check_total_slots_fit_int32(total_rows: int, length: int) -> None:
    """The resident corpus must hold < 2^31 token slots (the JAX
    package's finish-program bound, kept so both packages refuse the
    same runs)."""
    if total_rows * length >= (1 << 31):
        raise ValueError(
            f"resident corpus of {total_rows} doc slots x {length} tokens "
            f"overflows the finish program's int32 sort-join slot "
            f"indices; lower TFIDF_TPU_RESIDENT_ELEMS so the streaming "
            f"regime takes over, or reduce --doc-len")


def _check_slab_fits_int32(total: int) -> None:
    """One chunk's slab must stay under 2^31 bytes (int32 positions)."""
    if total >= (1 << 31):
        raise ValueError(
            f"bytes-wire chunk slab of {total} bytes overflows int32 "
            f"offsets; lower --chunk-docs")


# --- host <-> device --------------------------------------------------

def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host wire buffer on ``device`` (on the CPU the array itself)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t if device.type == "cpu" else t.to(device, non_blocking=True)


class _HostCopy:
    """A device tensor's copy to the host, started now: on CUDA a
    non-blocking copy into pinned memory followed by a recorded event;
    :meth:`result` waits on the event before reading (a pinned copy read
    early returns stale bytes). On the CPU the tensor is its own copy."""

    def __init__(self, t: torch.Tensor):
        self.nbytes = t.nbytes
        self._event = None
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        t = self._host
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16
            t = t.to(torch.float32)
        return t.numpy()


class _Mark:
    """A point in the work queues of ``devices``: :meth:`synchronize`
    returns once the work issued before it has finished on each (no-op
    on the CPU)."""

    def __init__(self, *devices: torch.device):
        self._events = []
        for dev in dict.fromkeys(devices):
            if dev.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
                self._events.append(event)

    def synchronize(self) -> None:
        for event in self._events:
            event.synchronize()


def _sync(*devices: torch.device) -> None:
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


@contextlib.contextmanager
def _device_phase(devices, name: str, **args):
    """``obs.device_span(name)`` that closes when the device work issued
    inside it has finished on ``devices`` (an event wait, while tracing
    only): a traced phase's span is its device time, not its enqueue. A
    no-op when tracing is off."""
    if not obs.enabled():
        yield
        return
    with obs.device_span(name, **args):
        yield
        _Mark(*devices).synchronize()


class _PackAhead:
    """Double-buffered host packing: ONE worker thread runs the chunk
    packer ahead of the dispatch loop, so chunk i+1's read+pack overlaps
    chunk i's upload and device work on the main thread (the native
    packers release the GIL). Depth ``TFIDF_TPU_PACK_AHEAD`` (default 2).
    The worker touches numpy and ctypes only, never CUDA. ``get(i)``
    blocks until chunk i is packed, then queues the next one; a packer
    exception surfaces there. A context manager: leaving it joins the
    worker and cancels queued packs.

    ``supervised``: each job beats ``packer`` and runs under
    :func:`_supervised_job`, as the JAX package's worker does. The mesh
    ingest and ``TfidfRetriever.index_dir`` pack unsupervised (no beat,
    no seam, no restart), as the JAX package's pack inline."""

    def __init__(self, fn, items, depth: Optional[int] = None, *,
                 supervised: bool):
        if depth is None:
            depth = max(1, int(os.environ.get("TFIDF_TPU_PACK_AHEAD", "2")))
        self._fn = fn
        self._supervised = supervised
        self._items = list(items)
        self._host_s = 0.0
        self._ex = cf.ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="tfidf-packer")
        self._futs = {}
        self._next = 0
        for _ in range(min(depth, len(self._items))):
            self._submit()

    def _submit(self) -> None:
        i = self._next
        if i >= len(self._items):
            return
        _trace("pack_submit", i)

        def body(item=self._items[i], i=i):
            t0 = time.perf_counter()
            with obs.span("pack", chunk=i):
                out = self._fn(item)
            self._host_s += time.perf_counter() - t0
            return out

        def job(i=i):
            obs.name_thread("packer")
            if not self._supervised:
                return body()
            _health_beat("packer")  # no-op unless a monitor is armed
            return _supervised_job("packer", i, body)

        self._futs[i] = self._ex.submit(job)
        self._next += 1

    def get(self, i: int):
        out = self._futs.pop(i).result()
        _trace("pack_done", i)
        self._submit()
        return out

    @property
    def host_seconds(self) -> float:
        """Wall the worker spent packing (overlaps the main thread)."""
        return self._host_s

    def close(self) -> None:
        self._ex.shutdown(wait=True, cancel_futures=True)

    def __enter__(self) -> "_PackAhead":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _DrainAhead:
    """Bounded asynchronous device->host result drain. ``put(i, words)``
    starts the words' copy to pinned host memory on the main thread
    (behind the device's scoring of the chunks after it) and queues the
    wait-and-unpack on ONE worker thread, which synchronizes on the
    copy's event before reading. At most ``TFIDF_TPU_FETCH_AHEAD``
    (default 2) drains are outstanding. ``results()`` returns the
    unpacked ``(vals, ids)`` chunk-major. ``supervised`` as in
    :class:`_PackAhead`, beating ``drainer`` and firing ``drain``."""

    def __init__(self, unpack, depth: Optional[int] = None, *,
                 supervised: bool = True):
        if depth is None:
            depth = int(os.environ.get("TFIDF_TPU_FETCH_AHEAD", "2"))
        if depth < 1:
            raise ValueError(
                f"TFIDF_TPU_FETCH_AHEAD must be >= 1, got {depth}")
        self._unpack = unpack
        self._depth = depth
        self._supervised = supervised
        self._ex = cf.ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="tfidf-drainer")
        self._futs: List = []
        self._waited = 0
        self._host_s = 0.0

    def put(self, idx: int, words: torch.Tensor) -> None:
        copy = _HostCopy(words)
        _trace("drain_submit", idx)

        def body():
            t0 = time.perf_counter()
            with obs.span("drain", chunk=idx, bytes=int(copy.nbytes)):
                out = self._unpack(copy.result())
            self._host_s += time.perf_counter() - t0
            return out

        def job():
            obs.name_thread("drainer")
            if self._supervised:
                _health_beat("drainer")  # no-op unless a monitor is armed
                out = _supervised_job("drainer", idx, body)
            else:
                out = body()
            _trace("drain_done", idx)
            return out

        self._futs.append(self._ex.submit(job))
        while len(self._futs) - self._waited > self._depth:
            self._futs[self._waited].result()
            self._waited += 1

    def results(self) -> List:
        """Block until every drain lands; chunk-major."""
        return [f.result() for f in self._futs]

    @property
    def host_seconds(self) -> float:
        """Wall the worker spent waiting on and unpacking words."""
        return self._host_s

    def close(self) -> None:
        self._ex.shutdown(wait=True, cancel_futures=True)

    def __enter__(self) -> "_DrainAhead":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _unpack_words_rows(words: np.ndarray, score_dtype):
    """Packed words of any leading shape -> row-major 2-D ``(vals,
    tids)``: the scan finish's [n_chunks, D, K] buffer flattens to the
    chunk-major rows the chunked drain produces."""
    vals, tids = unpack_result_words(words, score_dtype=score_dtype)
    return (vals.reshape(-1, vals.shape[-1]),
            tids.reshape(-1, tids.shape[-1]))


# --- chunk programs ---------------------------------------------------
#
# Plain functions on tensors: on CUDA each launches its kernels on the
# current stream and returns without waiting. The DF accumulator is
# updated in place (its previous value is dead once folded).

def _chunk_sort_fold(token_ids, lengths, df_acc, *, vocab_size: int):
    """Row-sort one chunk into sparse triples and fold its DF."""
    ids, counts, head = sorted_term_counts(token_ids, lengths)
    df_acc += sparse_df(ids, head, vocab_size)
    return ids, counts, head, df_acc


def rebuild_method(explicit: Optional[str] = None) -> str:
    """Validate the ``TFIDF_TPU_REBUILD`` knob (``"xla"`` or
    ``"pallas"``). The JAX package picks its ragged->padded rebuild
    lowering by it; the port has one, kernel B4, for both values."""
    if explicit is not None:
        return explicit
    method = os.environ.get("TFIDF_TPU_REBUILD") or "xla"
    if method not in ("xla", "pallas"):
        raise ValueError(f"unknown TFIDF_TPU_REBUILD method {method!r}")
    return method


def _rebuild(flat, lengths, *, length: int, align: int):
    rebuild_method()
    return ragged_rebuild(flat, lengths, length=length, align=align)


def _chunk_ragged(flat, lengths, df_acc, *, length: int, vocab_size: int,
                  align: int):
    tok = _rebuild(flat, lengths, length=length, align=align)
    return _chunk_sort_fold(tok, lengths, df_acc, vocab_size=vocab_size)


def _chunk_bytes(slab, blens, df_acc, *, length: int, vocab_size: int,
                 seed: int, truncate_at, align: int):
    """Bytes wire: tokenize+hash on the device, then sort+fold. Also
    returns the device-derived token lengths."""
    tok, lens = tokenize_hash_device(slab, blens, length=length,
                                     vocab_size=vocab_size, seed=seed,
                                     truncate_at=truncate_at, align=align)
    ids, counts, head, df_acc = _chunk_sort_fold(tok, lens, df_acc,
                                                 vocab_size=vocab_size)
    return ids, counts, head, df_acc, lens


def _chunk_step(wire, lens, df_acc, cfg: PipelineConfig, length: int,
                ragged: bool):
    """The per-chunk step of the id wires (resident regime and the
    streaming triple cache)."""
    if ragged:
        return _chunk_ragged(wire, lens, df_acc, length=length,
                             vocab_size=cfg.vocab_size, align=_wire_align())
    return _chunk_sort_fold(wire, lens, df_acc, vocab_size=cfg.vocab_size)


def _phase_a(token_ids, lengths, df_acc, *, vocab_size: int):
    """Fold one chunk's DF and keep nothing else."""
    ids, _, head = sorted_term_counts(token_ids, lengths)
    df_acc += sparse_df(ids, head, vocab_size)
    return df_acc


def _phase_a_ragged(flat, lengths, df_acc, *, length: int, vocab_size: int,
                    align: int):
    tok = _rebuild(flat, lengths, length=length, align=align)
    return _phase_a(tok, lengths, df_acc, vocab_size=vocab_size)


def _phase_a_bytes(slab, blens, df_acc, *, length: int, vocab_size: int,
                   seed: int, truncate_at, align: int):
    tok, lens = tokenize_hash_device(slab, blens, length=length,
                                     vocab_size=vocab_size, seed=seed,
                                     truncate_at=truncate_at, align=align)
    return _phase_a(tok, lens, df_acc, vocab_size=vocab_size), lens


def _phase_b(token_ids, lengths, idf, *, topk: int):
    """Score one chunk against the final IDF -> (vals, tids)."""
    ids, counts, head = sorted_term_counts(token_ids, lengths)
    return score_topk(ids, counts, head, lengths, idf, topk)


def _phase_b_cached(ids, counts, head, lengths, idf, *, topk: int):
    return score_topk(ids, counts, head, lengths, idf, topk)


def _phase_b_cached_packed(ids, counts, head, lengths, idf, *, topk: int):
    return pack_words(*score_topk(ids, counts, head, lengths, idf, topk))


def _phase_b_ragged(flat, lengths, idf, *, length: int, topk: int,
                    align: int):
    tok = _rebuild(flat, lengths, length=length, align=align)
    return _phase_b(tok, lengths, idf, topk=topk)


def _phase_b_ragged_packed(flat, lengths, idf, *, length: int, topk: int,
                           align: int):
    return pack_words(*_phase_b_ragged(flat, lengths, idf, length=length,
                                       topk=topk, align=align))


def _phase_b_padded_packed(token_ids, lengths, idf, *, topk: int):
    return pack_words(*_phase_b(token_ids, lengths, idf, topk=topk))


def _phase_b_bytes(slab, blens, idf, *, length: int, vocab_size: int,
                   seed: int, truncate_at, align: int, topk: int,
                   packed: bool = True):
    tok, lens = tokenize_hash_device(slab, blens, length=length,
                                     vocab_size=vocab_size, seed=seed,
                                     truncate_at=truncate_at, align=align)
    out = _phase_b(tok, lens, idf, topk=topk)
    return pack_words(*out) if packed else out


def _phase_b_scan_packed(ids_parts, cnt_parts, head_parts, lens_parts, idf,
                         *, topk: int) -> torch.Tensor:
    """The scan finish: score every resident chunk and pack its words
    into its slice of ONE [n_chunks, chunk_docs, K] uint32 buffer, which
    then leaves the device in one copy."""
    d, length = ids_parts[0].shape
    words = torch.empty((len(ids_parts), d, min(topk, length)),
                        dtype=torch.uint32, device=ids_parts[0].device)
    for i, parts in enumerate(zip(ids_parts, cnt_parts, head_parts,
                                  lens_parts)):
        pack_words(*score_topk(*parts, idf, topk), out=words[i])
    return words


def _final_idf(df_total, num_docs: int, *, score_dtype):
    return idf_from_df(df_total, num_docs, score_dtype)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8).reshape(-1)


def _u16_bytes(t: torch.Tensor) -> torch.Tensor:
    """Non-negative int32 values < 2^16 as little-endian uint16 bytes."""
    return torch.stack([t & 0xFF, (t >> 8) & 0xFF],
                       -1).to(torch.uint8).reshape(-1)


def _score_pack_wire(ids_parts, cnt_parts, head_parts, lens_parts, df,
                     num_docs: int, *, topk: int, score_dtype,
                     wide_ids: bool, include_vals: bool = True,
                     include_counts: bool = False,
                     keep_missing: bool = False):
    """The fused finish of the pair, ids-only and exact-ids result
    wires: score the concatenated triples against the IDF of ``df`` (the
    gather join) and pack the selection into ONE byte buffer. Returns
    ``(df, wire)``. Ids travel as uint16 (int32 for vocabs past 2^16).

    * pair: scores in the score dtype (-1 marks a missing pick), ids,
      and the occupied-DF-bucket count as a 4-byte tail;
    * ids-only (``include_vals=False``): ids (a missing pick reads
      bucket 0, harmless to the re-rank, which scores candidates exactly
      and drops words not in the doc; -1 with ``keep_missing``, the
      mesh's contract, on int32 ids), then the 4-byte tail;
    * exact-ids (``include_counts=True``, collision-free intern ids):
      ids, uint16 counts (0 marks a missing pick), then the full [V] DF
      as int32, everything the host needs to rescore in float64."""
    idf = idf_from_df(df, num_docs, score_dtype)
    cat = (torch.cat(ids_parts), torch.cat(cnt_parts), torch.cat(head_parts),
           torch.cat(lens_parts))

    def id_bytes(tids):
        safe = tids if keep_missing else tids.clamp_min(0)
        return _as_bytes(safe) if wide_ids else _u16_bytes(safe)

    if include_counts:
        if cat[0].shape[1] > (1 << 16) - 1:
            raise ValueError("exact-ids wire carries uint16 counts: "
                             "doc_len must be < 65536")
        _, tids, tcnt = sparse_topk_counts(*cat, idf, topk)
        return df, torch.cat([id_bytes(tids), _u16_bytes(tcnt),
                              _as_bytes(df.to(torch.int32))])
    vals, tids = score_topk(*cat, idf, topk)
    occ = _as_bytes((df > 0).sum(dtype=torch.int32).reshape(1))
    if not include_vals:
        return df, torch.cat([id_bytes(tids), occ])
    vals_wire = torch.where(tids >= 0, vals, -1)
    tid_wire = _as_bytes(tids) if wide_ids else id_bytes(tids)
    return df, torch.cat([_as_bytes(vals_wire), tid_wire, occ])


def _decode_wire_exact(buf: np.ndarray, d_padded: int, k: int,
                       wide_ids: bool):
    """Host decode of the exact-ids wire -> ``(tids, counts, df)``: int32
    [D, K] ids and counts (count 0 = no pick; its id is don't-care) and
    the [V] DF from the tail."""
    id_bytes = d_padded * k * (4 if wide_ids else 2)
    cnt_bytes = d_padded * k * 2
    tids = buf[:id_bytes].view("<i4" if wide_ids else "<u2") \
        .reshape(d_padded, k).astype(np.int32)
    cnt = buf[id_bytes:id_bytes + cnt_bytes].view("<u2") \
        .reshape(d_padded, k).astype(np.int32)
    return tids, cnt, buf[id_bytes + cnt_bytes:].view("<i4")


def _decode_wire(buf: np.ndarray, d_padded: int, k: int, wide_ids: bool,
                 score_dtype, include_vals: bool = True):
    """Host decode of :func:`_score_pack_wire`'s pair or ids-only buffer
    -> ``(vals, tids, occupied)``; on the pair wire missing picks decode
    to (0, -1) and bfloat16 scores widen to float32 (numpy has no
    bfloat16); the ids-only wire gives vals None and bucket 0 for a
    missing pick."""
    occupied = int(buf[-4:].view("<i4")[0])
    buf = buf[:-4]
    id_t = "<i4" if wide_ids else "<u2"
    if not include_vals:
        return None, buf.view(id_t).reshape(d_padded, k).astype(np.int32), \
            occupied
    sdt = canonical_score_dtype(score_dtype)
    s_bytes = d_padded * k * sdt.itemsize
    raw = buf[:s_bytes]
    if sdt == torch.bfloat16:
        vals = (raw.view("<u2").astype(np.uint32) << np.uint32(16)) \
            .view(np.float32)
    else:
        vals = raw.view("<f4" if sdt == torch.float32 else "<f2")
    vals = vals.reshape(d_padded, k).copy()
    tids = buf[s_bytes:].view(id_t).reshape(d_padded, k).astype(np.int32)
    bad = vals < 0
    vals[bad] = 0
    tids[bad] = -1
    return vals, tids, occupied


# --- host packers -----------------------------------------------------

def make_chunk_packer(input_dir: str, cfg: PipelineConfig, chunk_docs: int,
                      length: int):
    """The padded wire's packer: names -> (token_ids [chunk_docs, L],
    lengths). The native loader when it is available (uint16 ids within
    2^16), else the Python pack path (int32 ids)."""
    use_native = (cfg.tokenizer is TokenizerKind.WHITESPACE
                  and fast_tokenizer.loader_available())

    def pack_native(chunk_names: List[str]):
        packed = fast_tokenizer.load_pack_paths(
            [os.path.join(input_dir, n) for n in chunk_names],
            cfg.vocab_size, cfg.hash_seed, cfg.truncate_tokens_at,
            fixed_len=length, pad_docs_to=chunk_docs,
            n_threads=getattr(cfg, "pack_threads", None))
        assert packed is not None  # loader_available() checked above
        return packed

    def pack_python(chunk_names: List[str]):
        docs = []
        for n in chunk_names:
            with open(os.path.join(input_dir, n), "rb") as f:
                docs.append(f.read())
        batch = pack_corpus(Corpus(names=list(chunk_names), docs=docs),
                            cfg, pad_docs_to=chunk_docs, want_words=False)
        ids = batch.token_ids[:, :length]
        if ids.shape[1] < length:
            ids = np.pad(ids, ((0, 0), (0, length - ids.shape[1])))
        return (np.ascontiguousarray(ids),
                np.minimum(batch.lengths, length).astype(np.int32))

    return pack_native if use_native else pack_python


def make_flat_packer(input_dir: str, cfg: PipelineConfig, chunk_docs: int,
                     length: int):
    """The ragged wire's packer: names -> (flat ids, lengths, total),
    bucket-padded. The native single-pass flat packer when available,
    else the padded Python pack flattened (:func:`flatten_aligned`).
    Vocab must fit uint16."""
    use_native = (cfg.tokenizer is TokenizerKind.WHITESPACE
                  and fast_tokenizer.flat_available())
    padded = make_chunk_packer(input_dir, cfg, chunk_docs, length)
    align = _wire_align()  # once per packer: one layout per run
    cap = _bucket_cap_ids(chunk_docs, length, align)

    def pack_native(chunk_names: List[str]):
        out = fast_tokenizer.load_pack_flat(
            [os.path.join(input_dir, n) for n in chunk_names],
            cfg.vocab_size, cfg.hash_seed, cfg.truncate_tokens_at,
            max_per_doc=length, pad_docs_to=chunk_docs,
            n_threads=getattr(cfg, "pack_threads", None),
            align=align, cap_ids=cap)
        assert out is not None
        flat, lengths, total = out
        return _bucket_pad_flat(flat, total), lengths, total

    def pack_python(chunk_names: List[str]):
        ids, lengths = padded(chunk_names)
        flat, total = flatten_aligned(ids, lengths, align)
        return flat, lengths, total

    return pack_native if use_native else pack_python


def make_bytes_packer(input_dir: str, cfg: PipelineConfig,
                      chunk_docs: int, length: int,
                      stats: Optional[Dict[str, float]] = None):
    """The bytes wire's packer: names -> (slab, blens, total): raw
    document bytes at aligned offsets, 0x20 fill, capacity rounded to
    :func:`byte_bucket`. The host reads files and copies bytes, nothing
    more. ``stats`` accumulates the ``load`` (file reads) and ``slab``
    (assembly) seconds; the native path's one call is all ``slab``."""
    align = _wire_align()
    use_native = (cfg.tokenizer is TokenizerKind.WHITESPACE
                  and fast_tokenizer.slab_available())

    def add(key: str, secs: float) -> None:
        if stats is not None:
            stats[key] = stats.get(key, 0.0) + secs

    def pack_native(chunk_names: List[str]):
        t0 = time.perf_counter()
        # one native call reads and fills: its whole wall is the slab
        sp = obs.begin("slab")
        out = fast_tokenizer.load_slab_paths(
            [os.path.join(input_dir, n) for n in chunk_names],
            pad_docs_to=chunk_docs,
            n_threads=getattr(cfg, "pack_threads", None), align=align,
            cap_round=byte_bucket())
        assert out is not None  # slab_available() checked above
        obs.end(sp, bytes=int(out[0].nbytes))
        add("slab", time.perf_counter() - t0)
        _check_slab_fits_int32(out[2])
        return out

    def pack_python(chunk_names: List[str]):
        t0 = time.perf_counter()
        docs = []
        for n in chunk_names:
            with open(os.path.join(input_dir, n), "rb") as f:
                docs.append(f.read())
        add("load", time.perf_counter() - t0)
        t0 = time.perf_counter()
        sp = obs.begin("slab")
        blens = np.zeros((max(chunk_docs, len(docs)),), np.int32)
        blens[:len(docs)] = [len(d) for d in docs]
        albl = aligned_byte_lengths(blens[:len(docs)], align)
        total = int(albl.sum())
        _check_slab_fits_int32(total)
        bucket = byte_bucket()
        slab = np.full((max(total + (-total % bucket), bucket),), 0x20,
                       np.uint8)
        off = 0
        for doc, a in zip(docs, albl.tolist()):
            slab[off:off + len(doc)] = np.frombuffer(doc, np.uint8)
            off += int(a)
        obs.end(sp, bytes=int(slab.nbytes))
        add("slab", time.perf_counter() - t0)
        return slab, blens, total

    return pack_native if use_native else pack_python


def _resident_chunking(num_docs: int, chunk_docs: int):
    """Resident chunk rule: at most ``TFIDF_TPU_MAX_CHUNKS`` (default 32)
    chunks; past it the chunk grows (rounded up to 256 docs)."""
    cap = max(1, int(os.environ.get("TFIDF_TPU_MAX_CHUNKS", 32)))
    starts = list(range(0, num_docs, chunk_docs))
    if len(starts) > cap:
        chunk_docs = -(-num_docs // cap)
        chunk_docs += -chunk_docs % 256
        starts = list(range(0, num_docs, chunk_docs))
    return chunk_docs, starts


# --- the run ----------------------------------------------------------

@dataclasses.dataclass
class IngestResult:
    """Corpus-wide outputs of an overlapped ingest run (host arrays).

    ``df`` is a host ndarray on every path. The JAX package's pair-wire
    resident run returns its DF as a lazy device array instead; the
    values are the same, only the type differs (torch has no lazy device
    array). ``topk_vals`` are in the score dtype on the pair wire
    (bfloat16 widened to float32) and rounded to the 16-bit wire format
    on the packed wire; None after a resident ``wire_vals=False`` run,
    whose ``topk_ids`` read bucket 0 for a missing pick.
    """

    df: np.ndarray            # [V] corpus DF
    topk_vals: Optional[np.ndarray]  # [D, K] top-k TF-IDF scores
    topk_ids: np.ndarray      # [D, K] matching vocab ids (-1 = no term)
    lengths: np.ndarray       # [D] docSize per document
    names: List[str]
    num_docs: int
    df_occupied: Optional[int] = None  # DF buckets with df > 0
    path: str = ""            # "resident" | "streaming", "-mesh" added
    # Host wall seconds per phase; overlapped phases do not sum to the
    # wall. Resident: pack (stall on the packer), pack_host (the packer's
    # own wall), put (upload + issue), score_b, fetch (stall), fetch_host.
    # Streaming: pack_a/pack_b, pack_host, pass_a, pass_b, fetch,
    # fetch_host, triple_cached_chunks. Bytes-wire runs add
    # load_host/slab_host.
    phases: Optional[Dict[str, float]] = None
    wire: str = ""            # "ragged" | "padded" | "bytes"
    bytes_on_wire: Optional[int] = None          # host->device payload
    bytes_on_wire_padded: Optional[int] = None   # same run, padded wire
    result_wire: str = ""     # "packed" | "pair"
    bytes_off_wire: Optional[int] = None         # device->host results
    bytes_off_wire_pair: Optional[int] = None    # same picks as pairs
    finish: str = ""          # "scan" | "chunked" | "fused"
    n_finish_dispatches: Optional[int] = None


@dataclasses.dataclass
class _Run:
    """What both regimes share, resolved once per run.

    One run drives one or more shards. On one device there is one
    shard: the whole chunk. Under a docs-only mesh ``plan`` every chunk
    splits into a block of rows per docs shard, each block on its
    shard's device, and this process packs only its own shards' rows
    (the reference's per-rank document loop, ``TFIDF.c:130-138``). Each
    shard folds its own DF partial; :meth:`merged_df` is the run's one
    collective (the reference's Phase 2, ``TFIDF.c:215-220``). A mesh
    takes the padded wire, as the JAX package's does."""

    input_dir: str
    cfg: PipelineConfig
    names: List[str]
    length: int
    chunk_docs: int
    k: int
    score_dtype: torch.dtype
    itemsize: int
    spill: str
    device: torch.device
    wire_vals: bool = True
    total_docs: Optional[int] = None  # global document count when sharded
    df_merge: Optional[Callable] = None
    plan: Optional[object] = None     # a docs-only parallel.mesh.MeshPlan
    setup_span: Optional[obs.SpanHandle] = None  # ended at the first chunk

    @property
    def num_docs(self) -> int:
        return len(self.names)

    @property
    def num_docs_idf(self) -> int:
        """The IDF's document count: global under a sharded run."""
        return self.num_docs if self.total_docs is None else self.total_docs

    @property
    def devices(self) -> List[torch.device]:
        """The device of each shard this process runs."""
        if self.plan is None:
            return [self.device]
        return [self.plan.device(d) for d in range(self.plan.n_local_docs)]

    @property
    def budget_scale(self) -> int:
        """The cards that hold the run's shards: the resident budget and
        the triple cache are per card."""
        return 1 if self.plan is None else self.plan.n_cards

    def path_name(self, regime: str) -> str:
        return regime if self.plan is None else f"{regime}-mesh"

    def chunks(self, chunk_docs: int) -> Tuple[int, List[int]]:
        """(chunk size, chunk starts); a mesh rounds the chunk up to a
        docs-shard multiple so that its rows shard evenly."""
        if self.plan is not None:
            chunk_docs += -chunk_docs % self.plan.n_docs_shards
        _check_chunk_fits_int32(chunk_docs, self.length)
        return chunk_docs, list(range(0, self.num_docs, chunk_docs))

    def rows(self, chunk_docs: int) -> int:
        """This process's rows of one chunk."""
        if self.plan is None:
            return chunk_docs
        return self.plan.n_local_docs * (chunk_docs
                                         // self.plan.n_docs_shards)

    def wires(self, chunk_docs: int) -> Tuple[bool, bool]:
        """(bytes wire, ragged wire) at this chunk size; a mesh takes the
        padded wire."""
        if self.plan is not None:
            return False, False
        bwire = use_bytes_wire(self.cfg, chunk_docs, self.length)
        if bwire:
            tokenize_method()
        return bwire, (not bwire) and use_ragged_wire(self.cfg, chunk_docs,
                                                      self.length)

    def packer(self, chunk_docs: int, bwire: bool, ragged: bool,
               stats: Dict[str, float]) -> Callable:
        """names -> (wire array, lengths) of one chunk's rows in this
        process, padded to :meth:`rows` documents."""
        cfg, length = self.cfg, self.length
        if bwire:
            pack = make_bytes_packer(self.input_dir, cfg, chunk_docs, length,
                                     stats=stats)
        elif ragged:
            pack = make_flat_packer(self.input_dir, cfg, chunk_docs, length)
        else:
            rows = self.rows(chunk_docs)
            padded = make_chunk_packer(self.input_dir, cfg, rows, length)

            def pack(chunk_names: List[str]):
                if not chunk_names:  # a process past the corpus's last doc
                    return (np.zeros((rows, length), np.int32),
                            np.zeros((rows,), np.int32))
                return padded(chunk_names)
        return lambda chunk_names: tuple(pack(chunk_names)[:2])

    def chunk_names(self, starts, chunk_docs: int) -> List[List[str]]:
        """The names this process packs of each chunk."""
        if self.plan is None:
            return [self.names[s:s + chunk_docs] for s in starts]
        lo = self.plan.first_docs_shard * (chunk_docs
                                           // self.plan.n_docs_shards)
        rows = self.rows(chunk_docs)
        return [self.names[s + lo:min(s + lo + rows, s + chunk_docs)]
                for s in starts]

    def blocks(self, wire_arr: np.ndarray, lengths: np.ndarray):
        """One packed chunk -> (wire, lengths) of each shard, on its
        device: the whole chunk on one device, else a block of rows."""
        devs = self.devices
        if len(devs) == 1:
            lens = _upload(lengths, devs[0])
            return [(_upload(wire_arr, devs[0]), lens)]
        n = len(lengths) // len(devs)
        return [(_upload(wire_arr[i * n:(i + 1) * n], dev),
                 _upload(lengths[i * n:(i + 1) * n], dev))
                for i, dev in enumerate(devs)]

    def merged_df(self, df_parts: List[torch.Tensor]) -> torch.Tensor:
        """The DF the IDF uses, the one DF -> IDF boundary of both
        regimes: the shards' partials summed (a mesh's psum, across
        processes too), then ``df_merge`` of its host int32 copy (the
        cross-worker sum of a sharded ingest), back on the device."""
        df = df_parts[0] if self.plan is None else self.plan.psum(df_parts)
        if self.df_merge is None:
            return df
        with obs.span("link_sync", bytes=int(df.nbytes)):
            merged = self.df_merge(df.cpu().numpy().astype(np.int32))
            return torch.from_numpy(np.ascontiguousarray(
                merged, dtype=np.int32)).to(df.device)

    def gather(self, local: np.ndarray, n_chunks: int) -> np.ndarray:
        """This process's rows (chunk-major, each chunk its shards' rows
        in shard order) -> the corpus's first ``num_docs`` rows in
        document order. Across processes every process's rows of each
        chunk are gathered in rank order (one gloo gather of bytes)."""
        if self.plan is not None and self.plan.world > 1:
            tail = local.shape[1:]
            raw = torch.from_numpy(np.ascontiguousarray(local).reshape(
                n_chunks, -1).view(np.uint8))
            got = self.plan.all_gather([raw], dim=1, across_processes=True)
            local = got.numpy().view(local.dtype).reshape(-1, *tail)
        return local[:self.num_docs]

    def wire_name(self, bwire: bool, ragged: bool) -> str:
        return "bytes" if bwire else ("ragged" if ragged else "padded")

    def tokenize_kw(self, align: int) -> dict:
        cfg = self.cfg
        return dict(length=self.length, vocab_size=cfg.vocab_size,
                    seed=cfg.hash_seed, truncate_at=cfg.truncate_tokens_at,
                    align=align)


def _shard_rows(parts: List[np.ndarray], owners: List[int], n_shards: int,
                n_chunks: int) -> np.ndarray:
    """Result parts, each one shard's rows of one or more chunks in chunk
    order (``owners`` names the shard of each) -> this process's rows,
    chunk-major, each chunk its shards' rows in shard order."""
    per = []
    for d in range(n_shards):
        mine = [p for p, o in zip(parts, owners) if o == d]
        per.append(mine[0] if len(mine) == 1 else np.concatenate(mine))
    if n_shards == 1:
        return per[0]
    tail = per[0].shape[1:]
    return np.stack([p.reshape(n_chunks, -1, *tail) for p in per],
                    axis=1).reshape(-1, *tail)


def run_overlapped(input_dir: str, config: Optional[PipelineConfig] = None,
                   chunk_docs: int = 8192, doc_len: Optional[int] = None,
                   strict: bool = True, spill: str = "auto",
                   wire_vals: bool = True, plan=None, shard=None,
                   df_merge=None, total_docs: Optional[int] = None,
                   device=None) -> IngestResult:
    """Stream a directory through the overlapped chunked pipeline.

    ``doc_len`` fixes the token length L of every chunk (default
    ``config.max_doc_len``); longer documents are truncated to L tokens.
    ``spill`` says where chunks live between the streaming regime's two
    passes: ``"host"`` (RAM), ``"reread"`` (re-pack from disk) or
    ``"auto"`` (RAM up to ``TFIDF_TPU_SPILL_BYTES``). Requires a HASHED
    vocab and a top-k selection.

    ``wire_vals=False`` drops scores from the resident run's result
    wire (the hashed exact-terms engine reads only candidate buckets):
    ``topk_vals`` is None and a missing pick reads bucket 0 in
    ``topk_ids`` (-1 under a mesh, as in the JAX package). The streaming
    regime treats it as advisory and returns full scores with -1 for a
    missing pick, as the JAX package does.

    ``device``: CUDA unless the caller names another device; raises
    "no CUDA device available" without a GPU and no device named.
    ``device="cpu"`` runs every kernel's plain version.

    ``plan`` (a ``parallel.mesh.MeshPlan``, docs axis only; its devices
    replace ``device``) runs the ingest docs-sharded over the mesh: each
    shard sorts its own rows and folds its own DF partial, and one psum
    is the run's only collective. The resident budget and the triple
    cache scale with the cards that hold the shards (not with virtual
    shards); the paths read ``"resident-mesh"`` and
    ``"streaming-mesh"``. The mesh wire is the padded batch,
    ``chunk_docs`` rounded up to a shard multiple.

    ``shard``/``df_merge``/``total_docs`` are the multi-process ingest
    hooks (``parallel.multihost.run_sharded_ingest``): ``shard=(lo,
    hi)`` ingests that contiguous slice of the discovery order,
    ``df_merge`` (host int32 [V] DF -> merged DF, e.g.
    ``MpiLiteComm.allreduce_sum``) replaces the local DF at the DF -> IDF
    boundary, and ``total_docs`` is the global document count of the
    IDF. A shard's rows then equal the same rows of a single-process
    run bit for bit. Combined with ``plan`` they raise ``ValueError``:
    a mesh shards across the devices of one process.
    """
    cfg = config or PipelineConfig(vocab_mode=VocabMode.HASHED, topk=16)
    if cfg.vocab_mode is not VocabMode.HASHED:
        raise ValueError("overlapped ingest requires VocabMode.HASHED")
    if cfg.topk is None:
        raise ValueError("overlapped ingest requires a topk selection")
    if spill not in ("auto", "host", "reread"):
        raise ValueError(f"unknown spill policy {spill!r}")
    length = doc_len or cfg.max_doc_len
    if plan is not None:
        if shard is not None or df_merge is not None \
                or total_docs is not None:
            raise ValueError("shard/df_merge/total_docs are the "
                             "multi-PROCESS ingest hooks; a mesh plan "
                             "shards across devices of one process — "
                             "compose by giving each worker its own plan")
        if plan.n_seq_shards != 1 or plan.n_vocab_shards != 1:
            raise ValueError("mesh ingest shards the docs axis only; build "
                             "the MeshPlan with seq=1, vocab=1 "
                             "(sparse-engine doctrine)")
        dev = plan.device(0)
    else:
        dev = resolve_device(device)
    # The pass's set-up on the main thread: listing the directory, the
    # run's plan, then the regime's buffers and packer; the regime ends
    # the span at its first wait on a chunk.
    setup = obs.begin("pass_setup")
    names = discover_names(input_dir, strict)
    if shard is not None:
        lo, hi = shard
        if not (0 <= lo <= hi <= len(names)):
            raise ValueError(f"shard {shard} outside corpus "
                             f"[0, {len(names)}]")
        names = names[lo:hi]
    num_docs = len(names)
    if num_docs == 0:
        raise ValueError(f"no documents in {input_dir}"
                         + (f" shard {shard}" if shard else ""))

    use_native = (cfg.tokenizer is TokenizerKind.WHITESPACE
                  and fast_tokenizer.loader_available())
    # Wire bytes per token id: the native loader packs uint16 when the
    # vocab fits, else int32 (the spill estimate and in-flight budget).
    itemsize = 2 if (use_native and cfg.vocab_size <= (1 << 16)) else 4
    if spill == "auto":
        budget = int(os.environ.get("TFIDF_TPU_SPILL_BYTES",
                                    _DEFAULT_SPILL_BYTES))
        spill = "host" if num_docs * length * itemsize <= budget \
            else "reread"
    run = _Run(input_dir=input_dir, cfg=cfg, names=names, length=length,
               chunk_docs=chunk_docs, k=min(cfg.topk, length),
               score_dtype=canonical_score_dtype(cfg.score_dtype),
               itemsize=itemsize, spill=spill, device=dev,
               wire_vals=wire_vals, total_docs=total_docs,
               df_merge=df_merge, plan=plan, setup_span=setup)
    _check_chunk_fits_int32(chunk_docs, length)
    resident = int(os.environ.get("TFIDF_TPU_RESIDENT_ELEMS",
                                  _RESIDENT_ELEMS))
    if num_docs * length <= resident * run.budget_scale:
        return _run_resident(run)
    return _run_streaming(run)


def _run_resident(run: _Run) -> IngestResult:
    """The resident regime: every chunk's triples stay on the device."""
    cfg, length, k = run.cfg, run.length, run.k
    devs = run.devices
    num_docs = run.num_docs
    chunk_docs, starts = run.chunks(
        _resident_chunking(num_docs, run.chunk_docs)[0])
    n_chunks = len(starts)
    _check_total_slots_fit_int32(n_chunks * run.rows(chunk_docs) // len(devs),
                                 length)
    bwire, ragged = run.wires(chunk_docs)
    pack_stats: Dict[str, float] = {}
    chunk_pack = run.packer(chunk_docs, bwire, ragged, pack_stats)
    align = _wire_align()

    ph = {"pack": 0.0, "put": 0.0}
    padded_chunk_bytes = run.rows(chunk_docs) * length * run.itemsize
    bytes_wire = bytes_padded = 0
    df_parts = [torch.zeros(cfg.vocab_size, dtype=torch.int32, device=d)
                for d in devs]
    trips: List[List[Tuple[torch.Tensor, ...]]] = [[] for _ in devs]
    all_lengths: List = []
    # Chunk i+1 packs on the worker while chunk i uploads and its device
    # work is issued here.
    with _PackAhead(chunk_pack, run.chunk_names(starts, chunk_docs),
                    supervised=run.plan is None) \
            as packer:
        obs.end(run.setup_span)
        for ci in range(n_chunks):
            t0 = time.perf_counter()
            with obs.span("pack_wait", chunk=ci):
                wire_arr, lengths = packer.get(ci)
            ph["pack"] += time.perf_counter() - t0
            if not bwire:
                all_lengths.append(lengths)
            bytes_wire += wire_arr.nbytes + lengths.nbytes
            bytes_padded += padded_chunk_bytes + lengths.nbytes
            t0 = time.perf_counter()
            with obs.span("dispatch", chunk=ci,
                          bytes=int(wire_arr.nbytes + lengths.nbytes)):
                _trace("upload", ci)
                for d, (wire, lens) in enumerate(run.blocks(wire_arr,
                                                            lengths)):
                    if bwire:
                        # lengths here are BYTE lengths; the device
                        # derives the token lengths, whose copy to the
                        # host starts now.
                        with obs.span("device_tokenize", chunk=ci,
                                      bytes=int(wire.nbytes)):
                            i_, c_, h_, df_parts[d], lens = _chunk_bytes(
                                wire, lens, df_parts[d],
                                **run.tokenize_kw(align))
                        all_lengths.append(_HostCopy(lens))
                    else:
                        i_, c_, h_, df_parts[d] = _chunk_step(
                            wire, lens, df_parts[d], cfg, length, ragged)
                    trips[d].append((i_, c_, h_, lens))
                _trace("dispatch", ci)
            ph["put"] += time.perf_counter() - t0
    ph["pack_host"] = packer.host_seconds
    if bwire:
        all_lengths = [hc.result() for hc in all_lengths]
        for key, secs in pack_stats.items():
            ph[f"{key}_host"] = secs
    common = dict(lengths=run.gather(np.concatenate(all_lengths), n_chunks),
                  names=run.names, num_docs=num_docs,
                  path=run.path_name("resident"),
                  wire=run.wire_name(bwire, ragged),
                  bytes_on_wire=bytes_wire, bytes_on_wire_padded=bytes_padded,
                  bytes_off_wire_pair=n_chunks * chunk_docs * k
                  * pair_slot_bytes(run.score_dtype))
    shard_trips = [[list(p) for p in zip(*t)] for t in trips]

    t0 = time.perf_counter()
    df_acc = run.merged_df(df_parts)
    if run.wire_vals and use_packed_result_wire(cfg):
        scan_finish = use_scan_finish(cfg, True)
        idf = _final_idf(df_acc, run.num_docs_idf,
                         score_dtype=run.score_dtype)
        df_copy = _HostCopy(df_acc)  # rides behind the scoring
        bytes_off = 0
        owners: List[int] = []
        with _DrainAhead(functools.partial(
                _unpack_words_rows, score_dtype=run.score_dtype),
                supervised=run.plan is None) as drain:
            for d, dev in enumerate(devs):
                idf_d = idf.to(dev)
                if scan_finish:
                    steps = [(0, dict(finish="scan", chunks=n_chunks),
                              functools.partial(_phase_b_scan_packed,
                                                *shard_trips[d]))]
                else:
                    steps = [(ci, dict(chunk=ci), functools.partial(
                        _phase_b_cached_packed, *t))
                        for ci, t in enumerate(trips[d])]
                for ci, span_args, step in steps:
                    with _device_phase([dev], "phase_b", **span_args):
                        words = step(idf_d, topk=k)
                    bytes_off += words.nbytes
                    drain.put(ci, words)
                    owners.append(d)
            ph["score_b"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            _trace("fetch_start")
            with obs.span("fetch_wait"):
                parts = drain.results()  # in issue order
            _trace("fetch_done")
        df_host = df_copy.result()
        ph["fetch"] = time.perf_counter() - t0
        ph["fetch_host"] = drain.host_seconds
        with obs.span("gather"):
            vals, tids = (run.gather(_shard_rows([p[j] for p in parts],
                                                 owners, len(devs), n_chunks),
                                     n_chunks)
                          for j in (0, 1))
            return IngestResult(df=df_host, topk_vals=vals, topk_ids=tids,
                                df_occupied=int((df_host > 0).sum()),
                                phases=ph, result_wire="packed",
                                bytes_off_wire=bytes_off,
                                finish="scan" if scan_finish else "chunked",
                                n_finish_dispatches=len(owners), **common)

    # The fused finish: one byte wire per shard. Under a mesh the
    # ids-only wire keeps -1 in a missing pick, as int32 ids.
    keep_missing = run.plan is not None and not run.wire_vals
    wide = cfg.vocab_size > (1 << 16) or keep_missing
    rows = n_chunks * run.rows(chunk_docs) // len(devs)  # a shard's
    vals_parts, tid_parts, bytes_off = [], [], 0
    _trace("fetch_start")
    for d, dev in enumerate(devs):
        with _device_phase([dev], "phase_b", finish="fused"):
            _, wire = _score_pack_wire(*shard_trips[d], df_acc.to(dev),
                                       run.num_docs_idf, topk=k,
                                       score_dtype=run.score_dtype,
                                       wide_ids=wide,
                                       include_vals=run.wire_vals,
                                       keep_missing=keep_missing)
        with obs.span("fetch", bytes=int(wire.nbytes)):
            buf = wire.cpu().numpy()
        bytes_off += buf.nbytes
        vals, tids, occ = _decode_wire(buf, rows, k, wide, run.score_dtype,
                                       include_vals=run.wire_vals)
        vals_parts.append(vals)
        tid_parts.append(tids)
    df_host = df_acc.cpu().numpy()
    _trace("fetch_done")
    ph["fetch"] = time.perf_counter() - t0
    owners = list(range(len(devs)))
    with obs.span("gather"):
        vals = (run.gather(_shard_rows(vals_parts, owners, len(devs),
                                       n_chunks), n_chunks)
                if run.wire_vals else None)
        tids = run.gather(_shard_rows(tid_parts, owners, len(devs), n_chunks),
                          n_chunks)
        return IngestResult(df=df_host, topk_vals=vals, topk_ids=tids,
                            df_occupied=occ, phases=ph, result_wire="pair",
                            bytes_off_wire=bytes_off, finish="fused",
                            n_finish_dispatches=len(devs), **common)


def _run_streaming(run: _Run) -> IngestResult:
    """The streaming regime: pass A folds DF (keeping a byte-budgeted
    prefix of triples), pass B scores every chunk against the final IDF."""
    cfg, length, k = run.cfg, run.length, run.k
    devs = run.devices
    num_docs = run.num_docs
    spill = run.spill
    chunk_docs, starts = run.chunks(run.chunk_docs)
    n_chunks = len(starts)
    # In-flight bound: the dispatch loops run at most max_ahead chunks
    # ahead of the device, which bounds device memory.
    chunk_bytes = max(chunk_docs * length * run.itemsize, 1)
    max_ahead = max(_LOOKAHEAD,
                    int(os.environ.get("TFIDF_TPU_INFLIGHT_BYTES", 1 << 29))
                    // chunk_bytes)
    bwire, ragged = run.wires(chunk_docs)
    pack_stats: Dict[str, float] = {}
    pack_any = run.packer(chunk_docs, bwire, ragged, pack_stats)
    align = _wire_align()
    tok_kw = run.tokenize_kw(align)
    packed_wire = use_packed_result_wire(cfg)
    ph = {"pack_a": 0.0, "pack_b": 0.0}
    padded_chunk_bytes = run.rows(chunk_docs) * length * run.itemsize
    bytes_wire = bytes_padded = 0
    df_parts = [torch.zeros(cfg.vocab_size, dtype=torch.int32, device=d)
                for d in devs]
    cached: List[Optional[Tuple[np.ndarray, np.ndarray]]] = []
    all_lengths: List = []
    in_flight: List[_Mark] = []
    cache_budget = run.budget_scale * int(os.environ.get(
        "TFIDF_TPU_TRIPLE_CACHE_BYTES", _TRIPLE_CACHE_BYTES))
    trip_cache: Dict[int, List[Tuple[torch.Tensor, ...]]] = {}
    cache_bytes = 0
    chunk_cache_bytes = chunk_docs * length * 9 + chunk_docs * 4

    def phase_a_any(wire, lens, df_acc):
        if ragged:
            return _phase_a_ragged(wire, lens, df_acc, length=length,
                                   vocab_size=cfg.vocab_size, align=align)
        return _phase_a(wire, lens, df_acc, vocab_size=cfg.vocab_size)

    def phase_b_any(wire, lens, idf):
        if bwire:
            return _phase_b_bytes(wire, lens, idf, topk=k,
                                  packed=packed_wire, **tok_kw)
        if ragged:
            fn = _phase_b_ragged_packed if packed_wire else _phase_b_ragged
            return fn(wire, lens, idf, length=length, topk=k, align=align)
        fn = _phase_b_padded_packed if packed_wire else _phase_b
        return fn(wire, lens, idf, topk=k)

    t_pass = time.perf_counter()
    with _PackAhead(pack_any, run.chunk_names(starts, chunk_docs),
                    supervised=run.plan is None) as packer:
        obs.end(run.setup_span)
        for ci in range(n_chunks):
            t0 = time.perf_counter()
            with obs.span("pack_wait", chunk=ci):
                wire_arr, lengths = packer.get(ci)
            ph["pack_a"] += time.perf_counter() - t0  # stall only
            if not bwire:
                all_lengths.append(lengths)
            bytes_wire += wire_arr.nbytes + lengths.nbytes
            bytes_padded += padded_chunk_bytes + lengths.nbytes
            _trace("upload", ci)
            with obs.span("dispatch", chunk=ci,
                          bytes=int(wire_arr.nbytes + lengths.nbytes)):
                blocks = run.blocks(wire_arr, lengths)
                if cache_bytes + chunk_cache_bytes <= cache_budget:
                    # Sort once and keep the triples: pass B scores them
                    # directly, with no re-pack, re-upload or re-sort.
                    trip_cache[ci] = []
                    for d, (wire, lens_dev) in enumerate(blocks):
                        if bwire:
                            with obs.span("device_tokenize", chunk=ci,
                                          bytes=int(wire.nbytes)):
                                i_, c_, h_, df_parts[d], lens_dev = \
                                    _chunk_bytes(wire, lens_dev,
                                                 df_parts[d], **tok_kw)
                            all_lengths.append(_HostCopy(lens_dev))
                        else:
                            i_, c_, h_, df_parts[d] = _chunk_step(
                                wire, lens_dev, df_parts[d], cfg, length,
                                ragged)
                        trip_cache[ci].append((i_, c_, h_, lens_dev))
                    cache_bytes += chunk_cache_bytes
                    if spill == "host":
                        cached.append(None)  # pass B skips the host copy
                else:
                    if spill == "host":
                        cached.append((wire_arr, lengths))
                    for d, (wire, lens_dev) in enumerate(blocks):
                        if bwire:
                            with obs.span("device_tokenize", chunk=ci,
                                          bytes=int(wire.nbytes)):
                                df_parts[d], lens_dev = _phase_a_bytes(
                                    wire, lens_dev, df_parts[d], **tok_kw)
                            all_lengths.append(_HostCopy(lens_dev))
                        else:
                            df_parts[d] = phase_a_any(wire, lens_dev,
                                                      df_parts[d])
            _trace("dispatch", ci)
            in_flight.append(_Mark(*devs))
            if len(in_flight) > max_ahead:
                in_flight.pop(0).synchronize()
    ph["pack_host"] = packer.host_seconds
    _sync(*devs)
    ph["pass_a"] = time.perf_counter() - t_pass
    ph["triple_cached_chunks"] = float(len(trip_cache))

    df_acc = run.merged_df(df_parts)
    idf = _final_idf(df_acc, run.num_docs_idf, score_dtype=run.score_dtype)
    idfs = [idf.to(d) for d in devs]
    df_copy = _HostCopy(df_acc) if packed_wire else None
    # The scan finish scores the triple-cached chunks (a chunk-major
    # prefix: the cache budget only ever closes) into one buffer per
    # shard; the chunks past the cache keep their per-chunk steps.
    scan_finish = use_scan_finish(cfg, packed_wire)
    n_scanned = len(trip_cache) if scan_finish else 0
    outs: List = []      # words, or (vals, ids), in issue order
    owners: List[int] = []
    marks: List[_Mark] = []
    bytes_off = 0
    t_pass = time.perf_counter()
    reread = ([ci for ci in range(n_chunks) if ci not in trip_cache]
              if spill == "reread" else [])
    packer_b = (_PackAhead(pack_any, run.chunk_names(
        [starts[ci] for ci in reread], chunk_docs),
        supervised=run.plan is None) if reread else None)
    drain = (_DrainAhead(functools.partial(_unpack_words_rows,
                                           score_dtype=run.score_dtype),
                         supervised=run.plan is None)
             if packed_wire else None)
    bpos = 0

    def emit(d: int, out, ci: int) -> None:
        nonlocal bytes_off
        if packed_wire:
            bytes_off += out.nbytes
            drain.put(ci, out)  # its depth guard bounds the queue
        else:
            outs.append(out)
        owners.append(d)

    try:
        if n_scanned:
            cidx = sorted(trip_cache)
            assert cidx == list(range(n_scanned))  # prefix by construction
            trips = [trip_cache.pop(ci) for ci in cidx]
            for d in range(len(devs)):
                with _device_phase([devs[d]], "phase_b", finish="scan",
                                   chunks=n_scanned):
                    words = _phase_b_scan_packed(
                        *(list(p) for p in zip(*(t[d] for t in trips))),
                        idfs[d], topk=k)
                emit(d, words, n_scanned - 1)
        for ci in range(n_scanned, n_chunks):
            if ci in trip_cache:
                fn = _phase_b_cached_packed if packed_wire \
                    else _phase_b_cached
                for d, t in enumerate(trip_cache.pop(ci)):
                    with _device_phase([devs[d]], "phase_b", chunk=ci):
                        out = fn(*t, idfs[d], topk=k)
                    emit(d, out, ci)
            else:
                if spill == "host":
                    wire_arr, lengths = cached[ci]
                else:
                    t0 = time.perf_counter()
                    with obs.span("pack_wait", chunk=ci):
                        wire_arr, lengths = packer_b.get(bpos)
                    bpos += 1
                    ph["pack_b"] += time.perf_counter() - t0  # stall only
                bytes_wire += wire_arr.nbytes + lengths.nbytes
                bytes_padded += padded_chunk_bytes + lengths.nbytes
                with _device_phase(devs, "phase_b", chunk=ci):
                    scored = [phase_b_any(wire, lens_dev, idfs[d])
                              for d, (wire, lens_dev) in enumerate(
                                  run.blocks(wire_arr, lengths))]
                for d, out in enumerate(scored):
                    emit(d, out, ci)
            if not packed_wire:
                marks.append(_Mark(*devs))
                if ci >= max_ahead:  # the same lookahead bound as pass A
                    marks[ci - max_ahead].synchronize()
        if packed_wire:
            ph["pass_b"] = time.perf_counter() - t_pass
            t0 = time.perf_counter()
            _trace("fetch_start")
            with obs.span("fetch_wait"):
                parts = drain.results()  # in issue order
            _trace("fetch_done")
            df_host = df_copy.result()
            ph["fetch"] = time.perf_counter() - t0  # stall only
            ph["fetch_host"] = drain.host_seconds
    finally:
        if packer_b is not None:
            packer_b.close()
            ph["pack_host"] = ph.get("pack_host", 0.0) + packer_b.host_seconds
        if drain is not None:
            drain.close()
    if not packed_wire:
        _sync(*devs)
        ph["pass_b"] = time.perf_counter() - t_pass
        t0 = time.perf_counter()
        _trace("fetch_start")
        per = [[o for o, w in zip(outs, owners) if w == d]
               for d in range(len(devs))]
        cats = [(torch.cat([o[0] for o in p]), torch.cat([o[1] for o in p]))
                for p in per]
        bytes_off = sum(v.nbytes + t.nbytes for v, t in cats)
        with obs.span("fetch", bytes=int(df_acc.nbytes + bytes_off)):
            df_host = _HostCopy(df_acc).result()
            parts = [(_HostCopy(v).result(), _HostCopy(t).result())
                     for v, t in cats]
        _trace("fetch_done")
        ph["fetch"] = time.perf_counter() - t0
    n_dispatches = len(owners)
    if not packed_wire:  # one part per shard
        owners = list(range(len(devs)))
    with obs.span("gather"):
        vals, tids = (run.gather(_shard_rows([p[j] for p in parts], owners,
                                             len(devs), n_chunks), n_chunks)
                      for j in (0, 1))
        if bwire:
            all_lengths = [hc.result() for hc in all_lengths]
            for key, secs in pack_stats.items():
                ph[f"{key}_host"] = secs
        return IngestResult(
            df=df_host, topk_vals=vals, topk_ids=tids,
            lengths=run.gather(np.concatenate(all_lengths), n_chunks),
            names=run.names, num_docs=num_docs,
            df_occupied=int((df_host > 0).sum()),
            path=run.path_name("streaming"), phases=ph,
            wire=run.wire_name(bwire, ragged),
            bytes_on_wire=bytes_wire, bytes_on_wire_padded=bytes_padded,
            result_wire="packed" if packed_wire else "pair",
            bytes_off_wire=bytes_off,
            bytes_off_wire_pair=(n_chunks * chunk_docs * k
                                 * pair_slot_bytes(run.score_dtype)),
            # "scan" only when the scanned prefix ran
            finish="scan" if n_scanned else "chunked",
            n_finish_dispatches=n_dispatches)


@dataclasses.dataclass
class ExactIngest:
    """Device-exact ingest outputs on collision-free intern word ids.

    Every field is integer-exact: (count, df) per pick is all the host
    needs to reproduce the reference's float64 score
    (``rerank.exact_topk_from_wire``). A missing pick has count 0.
    """

    names: List[str]
    lengths: np.ndarray       # [D] truncated docSize
    topk_ids: np.ndarray      # [D, K'] exact word ids
    topk_counts: np.ndarray   # [D, K'] in-document term counts
    df: np.ndarray            # [V] exact corpus DF (from the wire tail)
    num_docs: int
    words: List[bytes]        # id -> word bytes (the intern dictionary)
    phases: Optional[Dict[str, float]] = None


def run_overlapped_exact(input_dir: str,
                         config: Optional[PipelineConfig] = None,
                         chunk_docs: int = 8192,
                         doc_len: Optional[int] = None,
                         strict: bool = True, session=None,
                         device=None) -> ExactIngest:
    """The exact-terms fast path: the overlapped resident ingest on
    exact word ids (``tfidf_tpu/ingest.py:2523``).

    The native intern table (``io.fast_tokenizer.InternSession``) gives
    every distinct token a dense corpus-global id in first-appearance
    order as the packer thread packs each chunk's ragged wire, so there
    are no hash collisions: each chunk is rebuilt on the device (B4),
    sorted and folded into DF, and one finish scores every chunk and
    ships each pick's (id, count) plus the [V] DF (the exact-ids wire;
    the selection is B1's). Chunks pack in order on the one packer
    thread, as the ids require.

    ``session``: an open :class:`InternSession` to use and leave open
    (the native exact-terms finish reads it afterwards); by default the
    run opens its own. ``device``: CUDA unless the caller names another.

    Raises ``ExactVocabOverflow`` when the corpus holds more distinct
    words than ``cfg.vocab_size``, RuntimeError without the native
    library, and ValueError past the resident budget: the caller's cue
    to take the hashed re-rank engine (``rerank.exact_terms``).
    """
    cfg = config or PipelineConfig(vocab_mode=VocabMode.HASHED, topk=16)
    if cfg.topk is None:
        raise ValueError("exact ingest requires a topk selection")
    if cfg.tokenizer is not TokenizerKind.WHITESPACE:
        raise ValueError("exact ingest serves the whitespace tokenizer")
    if cfg.vocab_size > (1 << 22):
        raise ValueError("exact ingest caps the vocab at 2^22 ids")
    dev = resolve_device(device)
    if not fast_tokenizer.intern_available():
        raise RuntimeError("native intern table unavailable: "
                           + (fast_tokenizer.load_error()
                              or "TFIDF_TPU_NO_NATIVE is set"))
    length = doc_len or cfg.max_doc_len
    names = discover_names(input_dir, strict)
    num_docs = len(names)
    if num_docs == 0:
        raise ValueError(f"no documents in {input_dir}")
    resident = int(os.environ.get("TFIDF_TPU_RESIDENT_ELEMS",
                                  _RESIDENT_ELEMS))
    if num_docs * length > resident:
        raise ValueError("exact ingest is resident-only; corpus exceeds "
                         "TFIDF_TPU_RESIDENT_ELEMS")
    score_dtype = canonical_score_dtype(cfg.score_dtype)
    k = min(cfg.topk, length)
    chunk_docs, starts = _resident_chunking(num_docs, chunk_docs)
    _check_chunk_fits_int32(chunk_docs, length)
    _check_total_slots_fit_int32(len(starts) * chunk_docs, length)
    align = _wire_align()
    cap = _bucket_cap_ids(chunk_docs, length, align)
    wide = cfg.vocab_size > (1 << 16)

    ph = {"pack": 0.0, "put": 0.0}
    ctx = (contextlib.nullcontext(session) if session is not None
           else fast_tokenizer.InternSession(cfg.vocab_size))
    with ctx as sess:
        def pack_exact(chunk_names):
            flat, lengths, total = sess.pack_flat(
                [os.path.join(input_dir, n) for n in chunk_names],
                cfg.truncate_tokens_at, length, pad_docs_to=chunk_docs,
                seed=cfg.hash_seed,
                n_threads=getattr(cfg, "pack_threads", None), align=align,
                cap_ids=cap)
            return _bucket_pad_flat(flat, total), lengths

        df_acc = torch.zeros(cfg.vocab_size, dtype=torch.int32, device=dev)
        trips: List[Tuple[torch.Tensor, ...]] = []
        all_lengths = []
        with _PackAhead(pack_exact, [names[s:s + chunk_docs]
                                     for s in starts],
                        supervised=True) as packer:
            for ci, start in enumerate(starts):
                t0 = time.perf_counter()
                with obs.span("pack_wait", chunk=ci):
                    flat, lengths = packer.get(ci)
                ph["pack"] += time.perf_counter() - t0  # stall only
                all_lengths.append(lengths[:len(names[start:start
                                                      + chunk_docs])])
                t0 = time.perf_counter()
                with obs.span("dispatch", chunk=ci,
                              bytes=int(flat.nbytes + lengths.nbytes)):
                    lens = _upload(lengths, dev)
                    i_, c_, h_, df_acc = _chunk_ragged(
                        _upload(flat, dev), lens, df_acc, length=length,
                        vocab_size=cfg.vocab_size, align=align)
                trips.append((i_, c_, h_, lens))
                ph["put"] += time.perf_counter() - t0
        ph["pack_host"] = packer.host_seconds
        t0 = time.perf_counter()
        with _device_phase([dev], "phase_b", finish="fused"):
            _, wire = _score_pack_wire(*(list(p) for p in zip(*trips)),
                                       df_acc, num_docs, topk=k,
                                       score_dtype=score_dtype,
                                       wide_ids=wide, include_vals=False,
                                       include_counts=True)
        with obs.span("fetch", bytes=int(wire.nbytes)):
            buf = _HostCopy(wire).result()
        ph["fetch"] = time.perf_counter() - t0
        words = sess.words()
    tids, cnt, df_vec = _decode_wire_exact(buf, len(starts) * chunk_docs, k,
                                           wide_ids=wide)
    return ExactIngest(names=names, lengths=np.concatenate(all_lengths),
                       topk_ids=tids[:num_docs], topk_counts=cnt[:num_docs],
                       df=df_vec, num_docs=num_docs, words=words, phases=ph)


def profile_resident(input_dir: str, config: Optional[PipelineConfig] = None,
                     chunk_docs: int = 8192, doc_len: Optional[int] = None,
                     strict: bool = True, device=None) -> Dict[str, float]:
    """Serialized phase profile of the resident run
    (``tfidf_tpu/ingest.py:2637``): every phase fenced with
    ``torch.cuda.synchronize`` so each is a true cost of its own. ``pack``
    (every chunk's host pack; the bytes wire adds ``pack_load`` and
    ``pack_slab``), ``upload`` (the host->device copies alone),
    ``compute`` (the chunk steps and the finish the resolved structure
    runs: the scan or the chunked finish on the packed result wire, the
    fused finish on the pair wire), ``compute_warm`` (the same again),
    ``compute_marginal`` (one more of 4 chained runs: the chain of 4
    less one warm run, over 3, at least a 16th of a warm run), ``fetch``
    and ``fetch_warm`` (the results' copy to the host, twice), the wire
    byte counts and ``n_phase_b_dispatches``. The fenced wall exceeds
    the overlapped run's by what the overlap hides."""
    cfg = config or PipelineConfig(vocab_mode=VocabMode.HASHED, topk=16)
    dev = resolve_device(device)
    length = doc_len or cfg.max_doc_len
    names = discover_names(input_dir, strict)
    num_docs = len(names)
    score_dtype = canonical_score_dtype(cfg.score_dtype)
    k = min(cfg.topk, length)
    chunk_docs, starts = _resident_chunking(num_docs, chunk_docs)
    bwire = use_bytes_wire(cfg, chunk_docs, length)
    ragged = (not bwire) and use_ragged_wire(cfg, chunk_docs, length)
    align = _wire_align()
    pack_stats: Dict[str, float] = {}
    if bwire:
        pack = make_bytes_packer(input_dir, cfg, chunk_docs, length,
                                 stats=pack_stats)
        tokenize_method()
    elif ragged:
        pack = make_flat_packer(input_dir, cfg, chunk_docs, length)
    else:
        pack = make_chunk_packer(input_dir, cfg, chunk_docs, length)

    ph: Dict[str, float] = {}
    t0 = time.perf_counter()
    packed = [pack(names[s:s + chunk_docs]) for s in starts]
    ph["pack"] = time.perf_counter() - t0
    for key, secs in pack_stats.items():
        ph[f"pack_{key}"] = secs  # bytes wire: pack = load + slab
    use_native = (cfg.tokenizer is TokenizerKind.WHITESPACE
                  and fast_tokenizer.loader_available())
    itemsize = 2 if (use_native and cfg.vocab_size <= (1 << 16)) else 4
    ph["bytes_on_wire"] = float(sum(p[0].nbytes + p[1].nbytes
                                    for p in packed))
    ph["bytes_on_wire_padded"] = float(
        len(packed) * chunk_docs * length * itemsize
        + sum(p[1].nbytes for p in packed))

    t0 = time.perf_counter()
    wire_parts = [_upload(p[0], dev) for p in packed]
    len_parts = [_upload(p[1], dev) for p in packed]
    _sync(dev)
    ph["upload"] = time.perf_counter() - t0

    packed_wire = use_packed_result_wire(cfg)
    scan_finish = use_scan_finish(cfg, packed_wire)
    ph["n_phase_b_dispatches"] = float(1 if (scan_finish or not packed_wire)
                                       else len(starts))

    def compute_once():
        df_acc = torch.zeros(cfg.vocab_size, dtype=torch.int32, device=dev)
        trips = []
        for wire, lens in zip(wire_parts, len_parts):
            if bwire:  # the finish reads the device-derived token lengths
                *trip, df_acc, lens = _chunk_bytes(
                    wire, lens, df_acc, length=length,
                    vocab_size=cfg.vocab_size, seed=cfg.hash_seed,
                    truncate_at=cfg.truncate_tokens_at, align=align)
            else:
                *trip, df_acc = _chunk_step(wire, lens, df_acc, cfg, length,
                                            ragged)
            trips.append((*trip, lens))
        parts = [list(p) for p in zip(*trips)]
        if packed_wire:
            idf = _final_idf(df_acc, num_docs, score_dtype=score_dtype)
            if scan_finish:
                return [_phase_b_scan_packed(*parts, idf, topk=k)]
            return [_phase_b_cached_packed(*trip, idf, topk=k)
                    for trip in trips]
        return [_score_pack_wire(*parts, df_acc, num_docs, topk=k,
                                 score_dtype=score_dtype,
                                 wide_ids=cfg.vocab_size > (1 << 16))[1]]

    t0 = time.perf_counter()
    out = compute_once()
    _sync(dev)
    ph["compute"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    compute_once()
    _sync(dev)
    warm = ph["compute_warm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(4):
        compute_once()
    _sync(dev)
    ph["compute_marginal"] = max((time.perf_counter() - t0 - warm) / 3,
                                 warm / 16)
    for key in ("fetch", "fetch_warm"):
        t0 = time.perf_counter()
        for t in out:
            _HostCopy(t).result()
        ph[key] = time.perf_counter() - t0
    ph["bytes_off_wire"] = float(sum(t.nbytes for t in out))
    ph["bytes_off_wire_pair"] = float(
        len(starts) * chunk_docs * k * pair_slot_bytes(score_dtype))
    return ph
