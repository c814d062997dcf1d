"""Overlapped corpus ingest on one device: host packing pipelined
against device compute (port of ``tfidf_tpu/ingest.py``'s single-device
``run_overlapped``).

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

Differences from the JAX package: there is no jit, donation or
``lax.scan`` (PyTorch runs eagerly: the scan finish is a loop), the DF
accumulator is updated in place, the DF join is always the gather join
and every chunk folds its DF (the JAX package's own choice off the TPU),
and ``IngestResult.df`` is a host ndarray on every path. The lowering
selectors ``TFIDF_TPU_REBUILD``, ``TFIDF_TPU_SCORE``,
``TFIDF_TPU_DOWNLINK`` and ``TFIDF_TPU_DEVICE_TOKENIZE`` are not read:
on CUDA every step runs its kernel, on the CPU its plain version.
Obs spans, fault injection and worker restart supervision are not
ported: a worker's exception surfaces at ``get()``/``results()``.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import functools
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tfidf_tpu_torch.config import PipelineConfig, TokenizerKind, VocabMode
from tfidf_tpu_torch.io import fast_tokenizer
from tfidf_tpu_torch.io.corpus import Corpus, discover_names, pack_corpus
from tfidf_tpu_torch.ops.device_tokenize import (aligned_byte_lengths,
                                                 tokenize_hash_device)
from tfidf_tpu_torch.ops.downlink import (pair_slot_bytes,
                                          unpack_result_words,
                                          use_packed_result_wire)
from tfidf_tpu_torch.ops.kernels import pack_words, ragged_rebuild
from tfidf_tpu_torch.ops.scoring import canonical_score_dtype, idf_from_df
from tfidf_tpu_torch.ops.sparse import (score_topk, sorted_term_counts,
                                        sparse_df)
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
    """A point in the device's work queue: :meth:`synchronize` returns
    once the work issued before it has finished (no-op on the CPU)."""

    def __init__(self, device: torch.device):
        self._event = None
        if device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))

    def synchronize(self) -> None:
        if self._event is not None:
            self._event.synchronize()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _PackAhead:
    """Double-buffered host packing: ONE worker thread runs the chunk
    packer ahead of the dispatch loop, so chunk i+1's read+pack overlaps
    chunk i's upload and device work on the main thread (the native
    packers release the GIL). Depth ``TFIDF_TPU_PACK_AHEAD`` (default 2).
    The worker touches numpy and ctypes only, never CUDA. ``get(i)``
    blocks until chunk i is packed, then queues the next one; a packer
    exception surfaces there. A context manager: leaving it joins the
    worker and cancels queued packs."""

    def __init__(self, fn, items, depth: Optional[int] = None):
        if depth is None:
            depth = max(1, int(os.environ.get("TFIDF_TPU_PACK_AHEAD", "2")))
        self._fn = fn
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

        def job(item=self._items[i]):
            t0 = time.perf_counter()
            out = self._fn(item)
            self._host_s += time.perf_counter() - t0
            return out

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
    unpacked ``(vals, ids)`` chunk-major."""

    def __init__(self, unpack, depth: Optional[int] = None):
        if depth is None:
            depth = int(os.environ.get("TFIDF_TPU_FETCH_AHEAD", "2"))
        if depth < 1:
            raise ValueError(
                f"TFIDF_TPU_FETCH_AHEAD must be >= 1, got {depth}")
        self._unpack = unpack
        self._depth = depth
        self._ex = cf.ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="tfidf-drainer")
        self._futs: List = []
        self._waited = 0
        self._host_s = 0.0

    def put(self, idx: int, words: torch.Tensor) -> None:
        copy = _HostCopy(words)
        _trace("drain_submit", idx)

        def job():
            t0 = time.perf_counter()
            out = self._unpack(copy.result())
            self._host_s += time.perf_counter() - t0
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


def _chunk_ragged(flat, lengths, df_acc, *, length: int, vocab_size: int,
                  align: int):
    tok = ragged_rebuild(flat, lengths, length=length, align=align)
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
    tok = ragged_rebuild(flat, lengths, length=length, align=align)
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
    tok = ragged_rebuild(flat, lengths, length=length, align=align)
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


def _score_pack_wire(ids_parts, cnt_parts, head_parts, lens_parts, df,
                     num_docs: int, *, topk: int, score_dtype,
                     wide_ids: bool):
    """The pair result wire's finish: score the concatenated triples
    against the IDF of ``df`` (the gather join) and pack the selection
    into ONE byte buffer: scores in the score dtype (-1 marks a missing
    pick), ids as uint16 (int32 for vocabs past 2^16), and the
    occupied-DF-bucket count as a 4-byte tail. Returns ``(df, wire)``."""
    idf = idf_from_df(df, num_docs, score_dtype)
    vals, tids = score_topk(torch.cat(ids_parts), torch.cat(cnt_parts),
                            torch.cat(head_parts), torch.cat(lens_parts),
                            idf, topk)
    ok = tids >= 0
    vals_wire = torch.where(ok, vals, -1)
    if wide_ids:
        tid_wire = _as_bytes(tids)
    else:  # little-endian uint16 bytes
        safe = tids.clamp_min(0)
        tid_wire = torch.stack([safe & 0xFF, (safe >> 8) & 0xFF],
                               -1).to(torch.uint8).reshape(-1)
    occ = (df > 0).sum(dtype=torch.int32).reshape(1)
    return df, torch.cat([_as_bytes(vals_wire), tid_wire, _as_bytes(occ)])


def _decode_wire(buf: np.ndarray, d_padded: int, k: int, wide_ids: bool,
                 score_dtype):
    """Host decode of :func:`_score_pack_wire`'s buffer -> ``(vals, tids,
    occupied)``; missing picks decode to (0, -1). bfloat16 scores widen
    to float32 (numpy has no bfloat16)."""
    occupied = int(buf[-4:].view("<i4")[0])
    buf = buf[:-4]
    sdt = canonical_score_dtype(score_dtype)
    s_bytes = d_padded * k * sdt.itemsize
    raw = buf[:s_bytes]
    if sdt == torch.bfloat16:
        vals = (raw.view("<u2").astype(np.uint32) << np.uint32(16)) \
            .view(np.float32)
    else:
        vals = raw.view("<f4" if sdt == torch.float32 else "<f2")
    vals = vals.reshape(d_padded, k).copy()
    tids = buf[s_bytes:].view("<i4" if wide_ids else "<u2") \
        .reshape(d_padded, k).astype(np.int32)
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
        out = fast_tokenizer.load_slab_paths(
            [os.path.join(input_dir, n) for n in chunk_names],
            pad_docs_to=chunk_docs,
            n_threads=getattr(cfg, "pack_threads", None), align=align,
            cap_round=byte_bucket())
        assert out is not None  # slab_available() checked above
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
    on the packed wire.
    """

    df: np.ndarray            # [V] corpus DF
    topk_vals: Optional[np.ndarray]  # [D, K] top-k TF-IDF scores
    topk_ids: np.ndarray      # [D, K] matching vocab ids (-1 = no term)
    lengths: np.ndarray       # [D] docSize per document
    names: List[str]
    num_docs: int
    df_occupied: Optional[int] = None  # DF buckets with df > 0
    path: str = ""            # regime: "resident" | "streaming"
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
    """What both regimes share, resolved once per run."""

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
    pack_chunk: Callable

    @property
    def num_docs(self) -> int:
        return len(self.names)

    def chunk_names(self, starts, chunk_docs: int):
        return [self.names[s:s + chunk_docs] for s in starts]

    def wire_name(self, bwire: bool, ragged: bool) -> str:
        return "bytes" if bwire else ("ragged" if ragged else "padded")

    def tokenize_kw(self, align: int) -> dict:
        cfg = self.cfg
        return dict(length=self.length, vocab_size=cfg.vocab_size,
                    seed=cfg.hash_seed, truncate_at=cfg.truncate_tokens_at,
                    align=align)


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

    ``device``: CUDA unless the caller names another device; raises
    "no CUDA device available" without a GPU and no device named.
    ``device="cpu"`` runs every kernel's plain version.

    Not ported yet (raise NotImplementedError): ``plan`` (mesh ingest)
    and the multi-process hooks ``shard``/``df_merge``/``total_docs``
    (ROADMAP A9); ``wire_vals=False``, the exact-terms fetch (ROADMAP
    A5).
    """
    cfg = config or PipelineConfig(vocab_mode=VocabMode.HASHED, topk=16)
    if cfg.vocab_mode is not VocabMode.HASHED:
        raise ValueError("overlapped ingest requires VocabMode.HASHED")
    if cfg.topk is None:
        raise ValueError("overlapped ingest requires a topk selection")
    if plan is not None:
        raise NotImplementedError(
            "run_overlapped(plan=...) (mesh ingest) is not ported yet: "
            "ROADMAP A9")
    if shard is not None or df_merge is not None or total_docs is not None:
        raise NotImplementedError(
            "run_overlapped's multi-process hooks (shard, df_merge, "
            "total_docs) are not ported yet: ROADMAP A9")
    if not wire_vals:
        raise NotImplementedError(
            "run_overlapped(wire_vals=False) (the exact-terms ingest) is "
            "not ported yet: ROADMAP A5")
    if spill not in ("auto", "host", "reread"):
        raise ValueError(f"unknown spill policy {spill!r}")
    dev = resolve_device(device)
    length = doc_len or cfg.max_doc_len
    names = discover_names(input_dir, strict)
    num_docs = len(names)
    if num_docs == 0:
        raise ValueError(f"no documents in {input_dir}")

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
    _check_chunk_fits_int32(chunk_docs, length)
    run = _Run(input_dir=input_dir, cfg=cfg, names=names, length=length,
               chunk_docs=chunk_docs, k=min(cfg.topk, length),
               score_dtype=canonical_score_dtype(cfg.score_dtype),
               itemsize=itemsize, spill=spill, device=dev,
               pack_chunk=make_chunk_packer(input_dir, cfg, chunk_docs,
                                            length))
    resident = int(os.environ.get("TFIDF_TPU_RESIDENT_ELEMS",
                                  _RESIDENT_ELEMS))
    if num_docs * length <= resident:
        return _run_resident(run)
    return _run_streaming(run)


def _run_resident(run: _Run) -> IngestResult:
    """The resident regime: every chunk's triples stay on the device."""
    cfg, dev, length, k = run.cfg, run.device, run.length, run.k
    num_docs = run.num_docs
    chunk_docs, starts = _resident_chunking(num_docs, run.chunk_docs)
    pack_chunk = (run.pack_chunk if chunk_docs == run.chunk_docs else
                  make_chunk_packer(run.input_dir, cfg, chunk_docs, length))
    _check_chunk_fits_int32(chunk_docs, length)
    _check_total_slots_fit_int32(len(starts) * chunk_docs, length)
    bwire = use_bytes_wire(cfg, chunk_docs, length)
    ragged = (not bwire) and use_ragged_wire(cfg, chunk_docs, length)
    pack_stats: Dict[str, float] = {}
    if bwire:
        chunk_pack = make_bytes_packer(run.input_dir, cfg, chunk_docs,
                                       length, stats=pack_stats)
    elif ragged:
        chunk_pack = make_flat_packer(run.input_dir, cfg, chunk_docs, length)
    else:
        chunk_pack = pack_chunk
    align = _wire_align()

    ph = {"pack": 0.0, "put": 0.0}
    padded_chunk_bytes = chunk_docs * length * run.itemsize
    bytes_wire = bytes_padded = 0
    df_acc = torch.zeros(cfg.vocab_size, dtype=torch.int32, device=dev)
    trips: List[Tuple[torch.Tensor, ...]] = []
    all_lengths: List = []
    # Chunk i+1 packs on the worker while chunk i uploads and its device
    # work is issued here.
    with _PackAhead(chunk_pack, run.chunk_names(starts, chunk_docs)) \
            as packer:
        for ci, start in enumerate(starts):
            n_chunk = len(run.names[start:start + chunk_docs])
            t0 = time.perf_counter()
            packed = packer.get(ci)
            ph["pack"] += time.perf_counter() - t0
            wire_arr, lengths = packed[0], packed[1]
            if not bwire:
                all_lengths.append(lengths[:n_chunk])
            bytes_wire += wire_arr.nbytes + lengths.nbytes
            bytes_padded += padded_chunk_bytes + lengths.nbytes
            t0 = time.perf_counter()
            lens = _upload(lengths, dev)
            _trace("upload", ci)
            wire = _upload(wire_arr, dev)
            if bwire:
                # lengths here are BYTE lengths; the device derives the
                # token lengths, whose copy to the host starts now.
                i_, c_, h_, df_acc, lens = _chunk_bytes(
                    wire, lens, df_acc, **run.tokenize_kw(align))
                all_lengths.append(_HostCopy(lens))
            else:
                i_, c_, h_, df_acc = _chunk_step(wire, lens, df_acc, cfg,
                                                 length, ragged)
            _trace("dispatch", ci)
            trips.append((i_, c_, h_, lens))
            ph["put"] += time.perf_counter() - t0
    ph["pack_host"] = packer.host_seconds
    if bwire:
        all_lengths = [hc.result()[:len(run.names[s:s + chunk_docs])]
                       for hc, s in zip(all_lengths, starts)]
        for key, secs in pack_stats.items():
            ph[f"{key}_host"] = secs
    d_padded = len(starts) * chunk_docs
    common = dict(lengths=np.concatenate(all_lengths), names=run.names,
                  num_docs=num_docs, path="resident",
                  wire=run.wire_name(bwire, ragged),
                  bytes_on_wire=bytes_wire, bytes_on_wire_padded=bytes_padded,
                  bytes_off_wire_pair=d_padded * k
                  * pair_slot_bytes(run.score_dtype))
    trip_i, trip_c, trip_h, len_parts = (list(p) for p in zip(*trips))

    if use_packed_result_wire(cfg):
        scan_finish = use_scan_finish(cfg, True)
        t0 = time.perf_counter()
        idf = _final_idf(df_acc, num_docs, score_dtype=run.score_dtype)
        df_copy = _HostCopy(df_acc)  # rides behind the scoring
        bytes_off = 0
        with _DrainAhead(functools.partial(
                _unpack_words_rows, score_dtype=run.score_dtype)) as drain:
            if scan_finish:
                words = _phase_b_scan_packed(trip_i, trip_c, trip_h,
                                             len_parts, idf, topk=k)
                bytes_off += words.nbytes
                drain.put(0, words)
            else:
                for ci in range(len(starts)):
                    words = _phase_b_cached_packed(
                        trip_i[ci], trip_c[ci], trip_h[ci], len_parts[ci],
                        idf, topk=k)
                    bytes_off += words.nbytes
                    drain.put(ci, words)
            ph["score_b"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            _trace("fetch_start")
            parts = drain.results()  # chunk-major by construction
            _trace("fetch_done")
        df_host = df_copy.result()
        ph["fetch"] = time.perf_counter() - t0
        ph["fetch_host"] = drain.host_seconds
        vals = np.concatenate([p[0] for p in parts])
        tids = np.concatenate([p[1] for p in parts])
        return IngestResult(df=df_host, topk_vals=vals[:num_docs],
                            topk_ids=tids[:num_docs],
                            df_occupied=int((df_host > 0).sum()),
                            phases=ph, result_wire="packed",
                            bytes_off_wire=bytes_off,
                            finish="scan" if scan_finish else "chunked",
                            n_finish_dispatches=(1 if scan_finish
                                                 else len(starts)),
                            **common)

    t0 = time.perf_counter()
    wide = cfg.vocab_size > (1 << 16)
    df_dev, wire = _score_pack_wire(trip_i, trip_c, trip_h, len_parts, df_acc,
                                    num_docs, topk=k,
                                    score_dtype=run.score_dtype,
                                    wide_ids=wide)
    _trace("fetch_start")
    buf = wire.cpu().numpy()
    df_host = df_dev.cpu().numpy()
    _trace("fetch_done")
    ph["fetch"] = time.perf_counter() - t0
    vals, tids, occ = _decode_wire(buf, d_padded, k, wide, run.score_dtype)
    return IngestResult(df=df_host, topk_vals=vals[:num_docs],
                        topk_ids=tids[:num_docs], df_occupied=occ,
                        phases=ph, result_wire="pair",
                        bytes_off_wire=buf.nbytes, finish="fused",
                        n_finish_dispatches=1, **common)


def _run_streaming(run: _Run) -> IngestResult:
    """The streaming regime: pass A folds DF (keeping a byte-budgeted
    prefix of triples), pass B scores every chunk against the final IDF."""
    cfg, dev, length, k = run.cfg, run.device, run.length, run.k
    chunk_docs, num_docs, names = run.chunk_docs, run.num_docs, run.names
    spill = run.spill
    starts = list(range(0, num_docs, chunk_docs))
    # In-flight bound: the dispatch loops run at most max_ahead chunks
    # ahead of the device, which bounds device memory.
    chunk_bytes = max(chunk_docs * length * run.itemsize, 1)
    max_ahead = max(_LOOKAHEAD,
                    int(os.environ.get("TFIDF_TPU_INFLIGHT_BYTES", 1 << 29))
                    // chunk_bytes)
    bwire = use_bytes_wire(cfg, chunk_docs, length)
    ragged = (not bwire) and use_ragged_wire(cfg, chunk_docs, length)
    pack_stats: Dict[str, float] = {}
    bytes_pack = (make_bytes_packer(run.input_dir, cfg, chunk_docs, length,
                                    stats=pack_stats) if bwire else None)
    flat_pack = (make_flat_packer(run.input_dir, cfg, chunk_docs, length)
                 if ragged else None)
    align = _wire_align()
    tok_kw = run.tokenize_kw(align)
    packed_wire = use_packed_result_wire(cfg)
    ph = {"pack_a": 0.0, "pack_b": 0.0}
    padded_chunk_bytes = chunk_docs * length * run.itemsize
    bytes_wire = bytes_padded = 0
    df_acc = torch.zeros(cfg.vocab_size, dtype=torch.int32, device=dev)
    cached: List[Optional[Tuple[np.ndarray, np.ndarray]]] = []
    all_lengths: List = []
    in_flight: List[_Mark] = []
    cache_budget = int(os.environ.get("TFIDF_TPU_TRIPLE_CACHE_BYTES",
                                      _TRIPLE_CACHE_BYTES))
    trip_cache: Dict[int, Tuple[torch.Tensor, ...]] = {}
    cache_bytes = 0
    chunk_cache_bytes = chunk_docs * length * 9 + chunk_docs * 4

    def pack_any(chunk_names):
        if bytes_pack is not None:
            slab, blens, _ = bytes_pack(chunk_names)
            return slab, blens
        if flat_pack is not None:
            flat, lengths, _ = flat_pack(chunk_names)
            return flat, lengths
        return run.pack_chunk(chunk_names)

    def phase_a_any(wire, lens, df_acc):
        if flat_pack is not None:
            return _phase_a_ragged(wire, lens, df_acc, length=length,
                                   vocab_size=cfg.vocab_size, align=align)
        return _phase_a(wire, lens, df_acc, vocab_size=cfg.vocab_size)

    def phase_b_any(wire, lens, idf):
        if bwire:
            return _phase_b_bytes(wire, lens, idf, topk=k,
                                  packed=packed_wire, **tok_kw)
        if flat_pack is not None:
            fn = _phase_b_ragged_packed if packed_wire else _phase_b_ragged
            return fn(wire, lens, idf, length=length, topk=k, align=align)
        fn = _phase_b_padded_packed if packed_wire else _phase_b
        return fn(wire, lens, idf, topk=k)

    t_pass = time.perf_counter()
    with _PackAhead(pack_any, run.chunk_names(starts, chunk_docs)) as packer:
        for ci, start in enumerate(starts):
            n_chunk = len(names[start:start + chunk_docs])
            t0 = time.perf_counter()
            wire_arr, lengths = packer.get(ci)
            ph["pack_a"] += time.perf_counter() - t0  # stall only
            if not bwire:
                all_lengths.append(lengths[:n_chunk])
            bytes_wire += wire_arr.nbytes + lengths.nbytes
            bytes_padded += padded_chunk_bytes + lengths.nbytes
            _trace("upload", ci)
            if cache_bytes + chunk_cache_bytes <= cache_budget:
                # Sort once and keep the triples: pass B scores them
                # directly, with no re-pack, re-upload or re-sort.
                lens_dev = _upload(lengths, dev)
                if bwire:
                    i_, c_, h_, df_acc, lens_dev = _chunk_bytes(
                        _upload(wire_arr, dev), lens_dev, df_acc, **tok_kw)
                    all_lengths.append(_HostCopy(lens_dev))
                else:
                    i_, c_, h_, df_acc = _chunk_step(
                        _upload(wire_arr, dev), lens_dev, df_acc, cfg,
                        length, ragged)
                trip_cache[ci] = (i_, c_, h_, lens_dev)
                cache_bytes += chunk_cache_bytes
                if spill == "host":
                    cached.append(None)  # pass B skips the host copy
            else:
                if spill == "host":
                    cached.append((wire_arr, lengths))
                if bwire:
                    df_acc, lens_dev = _phase_a_bytes(
                        _upload(wire_arr, dev), _upload(lengths, dev),
                        df_acc, **tok_kw)
                    all_lengths.append(_HostCopy(lens_dev))
                else:
                    df_acc = phase_a_any(_upload(wire_arr, dev),
                                         _upload(lengths, dev), df_acc)
            _trace("dispatch", ci)
            in_flight.append(_Mark(dev))
            if len(in_flight) > max_ahead:
                in_flight.pop(0).synchronize()
    ph["pack_host"] = packer.host_seconds
    _sync(dev)
    ph["pass_a"] = time.perf_counter() - t_pass
    ph["triple_cached_chunks"] = float(len(trip_cache))

    idf = _final_idf(df_acc, num_docs, score_dtype=run.score_dtype)
    df_copy = _HostCopy(df_acc) if packed_wire else None
    # The scan finish scores the triple-cached chunks (a chunk-major
    # prefix: the cache budget only ever closes) into one buffer; the
    # chunks past the cache keep their per-chunk re-upload steps.
    scan_finish = use_scan_finish(cfg, packed_wire)
    n_scanned = len(trip_cache) if scan_finish else 0
    n_dispatches = 0
    vals_parts: List[torch.Tensor] = []
    ids_parts: List[torch.Tensor] = []
    marks: List[_Mark] = []
    bytes_off = 0
    t_pass = time.perf_counter()
    reread = ([ci for ci in range(len(starts)) if ci not in trip_cache]
              if spill == "reread" else [])
    packer_b = (_PackAhead(pack_any, [names[starts[ci]:starts[ci]
                                            + chunk_docs] for ci in reread])
                if reread else None)
    drain = (_DrainAhead(functools.partial(_unpack_words_rows,
                                           score_dtype=run.score_dtype))
             if packed_wire else None)
    bpos = 0
    try:
        if n_scanned:
            cidx = sorted(trip_cache)
            assert cidx == list(range(n_scanned))  # prefix by construction
            trips = [trip_cache.pop(ci) for ci in cidx]
            words = _phase_b_scan_packed(*(list(p) for p in zip(*trips)),
                                         idf, topk=k)
            bytes_off += words.nbytes
            n_dispatches += 1
            drain.put(n_scanned - 1, words)
        for ci in range(len(starts)):
            if ci < n_scanned:
                continue  # scored by the scanned prefix
            if ci in trip_cache:
                i_, c_, h_, lens_dev = trip_cache.pop(ci)
                if packed_wire:
                    out = _phase_b_cached_packed(i_, c_, h_, lens_dev, idf,
                                                 topk=k)
                else:
                    out = _phase_b_cached(i_, c_, h_, lens_dev, idf, topk=k)
            else:
                if spill == "host":
                    wire_arr, lengths = cached[ci]
                else:
                    t0 = time.perf_counter()
                    wire_arr, lengths = packer_b.get(bpos)
                    bpos += 1
                    ph["pack_b"] += time.perf_counter() - t0  # stall only
                bytes_wire += wire_arr.nbytes + lengths.nbytes
                bytes_padded += padded_chunk_bytes + lengths.nbytes
                out = phase_b_any(_upload(wire_arr, dev),
                                  _upload(lengths, dev), idf)
            n_dispatches += 1
            if packed_wire:
                bytes_off += out.nbytes
                drain.put(ci, out)  # its depth guard bounds the queue
                continue
            vals_parts.append(out[0])
            ids_parts.append(out[1])
            marks.append(_Mark(dev))
            if ci >= max_ahead:  # the same lookahead bound as pass A
                marks[ci - max_ahead].synchronize()
        if packed_wire:
            ph["pass_b"] = time.perf_counter() - t_pass
            t0 = time.perf_counter()
            _trace("fetch_start")
            parts = drain.results()  # chunk-major by construction
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
    if packed_wire:
        vals = np.concatenate([p[0] for p in parts])
        tids = np.concatenate([p[1] for p in parts])
    else:
        _sync(dev)
        ph["pass_b"] = time.perf_counter() - t_pass
        t0 = time.perf_counter()
        _trace("fetch_start")
        cat_v, cat_t = torch.cat(vals_parts), torch.cat(ids_parts)
        bytes_off = cat_v.nbytes + cat_t.nbytes
        df_host = _HostCopy(df_acc).result()
        vals, tids = _HostCopy(cat_v).result(), _HostCopy(cat_t).result()
        _trace("fetch_done")
        ph["fetch"] = time.perf_counter() - t0
    if bwire:
        all_lengths = [hc.result()[:len(names[s:s + chunk_docs])]
                       for hc, s in zip(all_lengths, starts)]
        for key, secs in pack_stats.items():
            ph[f"{key}_host"] = secs
    return IngestResult(df=df_host, topk_vals=vals[:num_docs],
                        topk_ids=tids[:num_docs],
                        lengths=np.concatenate(all_lengths), names=names,
                        num_docs=num_docs,
                        df_occupied=int((df_host > 0).sum()),
                        path="streaming", phases=ph,
                        wire=run.wire_name(bwire, ragged),
                        bytes_on_wire=bytes_wire,
                        bytes_on_wire_padded=bytes_padded,
                        result_wire="packed" if packed_wire else "pair",
                        bytes_off_wire=bytes_off,
                        bytes_off_wire_pair=(len(starts) * chunk_docs * k
                                             * pair_slot_bytes(
                                                 run.score_dtype)),
                        # "scan" only when the scanned prefix ran
                        finish="scan" if n_scanned else "chunked",
                        n_finish_dispatches=n_dispatches)
