"""ctypes bindings for the native host loader (the port's copy of what
the chunk packers call from ``tfidf_tpu/io/fast_tokenizer.py``).

The library is the repository's native read+tokenize+hash code
(``native/{fast_tokenizer,loader,rerank,intern}.cc``), built by
``ops/_build.build_host`` with g++ into ``tfidf_tpu_torch/_build/`` at
the first call, on the CPU as on the card. ``TFIDF_TPU_NATIVE_LIB``
points the loader at an alternate build of the same sources instead
(a sanitizer build, or ``make -C native fast_tokenizer.so``), read at
the first load as in the JAX package. When the library cannot be built
or loaded, or ``TFIDF_TPU_NO_NATIVE`` is set, every function here
returns None (or False) and the packers run their contract-identical
Python path instead: host code either way, never a device fallback.

The exact-terms engines' bindings live here too (``tfidf_tpu/io/
fast_tokenizer.py``:517-752): the run-scoped intern table
(:class:`InternSession`: collision-free word ids at pack time and the
native exact-terms finish), the native re-rank of a hashed selection
(:func:`exact_rerank_paths`) and token spans (:func:`tokenize_spans`).
Without the library :func:`intern_available` and
:func:`rerank_available` are False and the callers take the JAX
package's other engine.

:data:`NATIVE_CALLS` counts the native packer calls, so a caller can
show which packer ran.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from tfidf_tpu_torch import obs

_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_load_error = ""

NATIVE_CALLS: Dict[str, int] = {"load_pack_paths": 0, "load_pack_flat": 0,
                                "load_slab_paths": 0}

_C = ctypes.c_char_p
_VP = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U64 = ctypes.c_uint64
_PI32 = ctypes.POINTER(ctypes.c_int32)
_PU16 = ctypes.POINTER(ctypes.c_uint16)
_PU8 = ctypes.POINTER(ctypes.c_uint8)
_PI64 = ctypes.POINTER(ctypes.c_int64)
_PF64 = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "tok_count": (_I64, [_C, _I64]),
    "tok_hash_ids": (_I64, [_C, _I64, _U64, _I64, _I64, _PI32, _I64]),
    "tok_spans": (_I64, [_C, _I64, _PI64, _PI64, _I64]),
    "loader_open2": (_VP, [_C, _I64, _I, _I]),
    "loader_error": (_I64, [_VP]),
    "loader_max_count": (_I64, [_VP]),
    "loader_fill": (None, [_VP, _U64, _I64, _I64, _PI32, _I64, _PI32, _I]),
    "loader_fill_u16": (None, [_VP, _U64, _I64, _I64, _PU16, _I64, _PI32,
                               _I]),
    "loader_close": (None, [_VP]),
    "loader_fill_flat_u16_v2": (_I64, [_VP, _U64, _I64, _I64, _I64, _PU16,
                                       _I64, _PI32, _I64]),
    "loader_fill_flat_u16_v3": (_I64, [_VP, _U64, _I64, _I64, _I64, _PU16,
                                       _I64, _PI32, _I64, _I]),
    "loader_slab_bytes": (_I64, [_VP, _I64]),
    "loader_fill_slab": (_I64, [_VP, _PU8, _I64, _PI32, _I64, _I]),
    "intern_open": (_VP, [_I64]),
    "intern_fill_flat_u16": (_I64, [_VP, _VP, _U64, _I64, _I64, _PU16,
                                    _PI32, _I64]),
    "intern_fill_flat_i32": (_I64, [_VP, _VP, _U64, _I64, _I64, _PI32,
                                    _PI32, _I64]),
    "intern_count": (_I64, [_VP]),
    "intern_blob_bytes": (_I64, [_VP]),
    "intern_dump": (None, [_VP, _PI64, _PI64, _C]),
    "intern_close": (None, [_VP]),
    "exact_emit_run": (_VP, [_VP, _C, _C, _PI32, _PI32, _I64, _I64, _PI32,
                             _I64, _PI32, _I64, _I64, _I64, _I64, _U64, _I,
                             _PI64]),
    "exact_emit_total": (_I64, [_VP]),
    "exact_emit_word_bytes": (_I64, [_VP]),
    "exact_emit_line_bytes": (_I64, [_VP]),
    "exact_emit_fill": (None, [_VP, _PI32, _PI64, _PI64, _PF64, _C, _C]),
    "exact_emit_free": (None, [_VP]),
    "rerank_run": (_VP, [_VP, _PI32, _I64, _I64, _U64, _I64, _I64, _I64,
                         _I64, _I]),
    "rerank_total": (_I64, [_VP]),
    "rerank_blob_bytes": (_I64, [_VP]),
    "rerank_fill": (None, [_VP, _PI32, _PI64, _PI64, _PF64, _C]),
    "rerank_free": (None, [_VP]),
}


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed, _load_error
    # The kill switch wins even over an already-loaded library.
    if os.environ.get("TFIDF_TPU_NO_NATIVE"):
        return None
    if _lib is not None or _load_failed:
        return _lib
    from tfidf_tpu_torch.ops import _build
    try:
        alt = os.environ.get("TFIDF_TPU_NATIVE_LIB")
        lib = ctypes.CDLL(alt) if alt else _build.load_host()
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
    except (OSError, RuntimeError, AttributeError) as e:
        _load_failed, _load_error = True, f"{type(e).__name__}: {e}"
        return None
    _lib = lib
    return _lib


def available() -> bool:
    """True when the native library is loadable (building it first)."""
    return _load() is not None


def load_error() -> str:
    """Why the library could not be built or loaded ('' when it was)."""
    return _load_error


# Every caller needs the whole symbol set, so the checks agree.
loader_available = flat_available = slab_available = available
intern_available = rerank_available = available


def tokenize_hash_ids(data: bytes, vocab_size: int, seed: int = 0,
                      truncate_at: Optional[int] = None
                      ) -> Optional[np.ndarray]:
    """Native tokenize+hash of one document: bytes -> int32 vocab ids
    (the ids ``ops.tokenize`` computes in Python). None when the native
    library is unavailable (the caller takes the Python path)."""
    lib = _load()
    if lib is None:
        return None
    n = lib.tok_count(data, len(data))
    out = np.empty(n, dtype=np.int32)
    wrote = lib.tok_hash_ids(data, len(data), seed, vocab_size,
                             truncate_at or 0,
                             out.ctypes.data_as(_PI32), n)
    assert wrote == n, f"tokenizer wrote {wrote} of {n} tokens"
    return out


def tokenize_hash_batch(datas: Sequence[bytes], vocab_size: int,
                        seed: int = 0, truncate_at: Optional[int] = None):
    """Native tokenize+hash of several documents in one pass over them
    joined by newlines, which no token crosses: ``(ids int32, counts
    int64)``, every token's vocab id with the documents end to end and
    each document's token count; None without the native library. Three
    native calls however many documents, so a serving thread releases
    the interpreter lock three times a batch, not twice a query."""
    lib = _load()
    if lib is None:
        return None
    blob = b"\n".join(datas)
    n = lib.tok_count(blob, len(blob))
    ids = np.empty(n, dtype=np.int32)
    offs = np.empty(n, dtype=np.int64)
    lens = np.empty(n, dtype=np.int64)
    wrote = lib.tok_hash_ids(blob, len(blob), seed, vocab_size,
                             truncate_at or 0, ids.ctypes.data_as(_PI32), n)
    spans = lib.tok_spans(blob, len(blob), offs.ctypes.data_as(_PI64),
                          lens.ctypes.data_as(_PI64), n)
    assert wrote == spans == n, f"tokenizer wrote {wrote}, {spans} of {n}"
    starts = np.cumsum([0] + [len(d) + 1 for d in datas[:-1]])
    doc = np.searchsorted(starts, offs, side="right") - 1
    return ids, np.bincount(doc, minlength=len(datas))


def resolve_pack_threads(explicit: Optional[int] = None) -> int:
    """Host packer thread count: explicit arg > ``--pack-threads`` /
    ``TFIDF_TPU_PACK_THREADS`` env > every core. Read at call time."""
    if explicit is not None:
        n = int(explicit)
    else:
        raw = os.environ.get("TFIDF_TPU_PACK_THREADS")
        n = int(raw) if raw else (os.cpu_count() or 1)
    if n < 1:
        raise ValueError(
            f"TFIDF_TPU_PACK_THREADS must be >= 1, got {n}")
    return n


def _open(lib, paths: List[str], n_threads: int, want_counts: int = 0):
    """Parallel read of every file (a token-count prepass only with
    ``want_counts``); raises FileNotFoundError on an unreadable one (the
    reference's hard exit, ``TFIDF.c:137``). The caller closes the
    handle."""
    blob = b"\0".join(p.encode() for p in paths) + b"\0"
    handle = lib.loader_open2(blob, len(paths), n_threads, want_counts)
    err = lib.loader_error(handle)
    if err >= 0:
        lib.loader_close(handle)
        raise FileNotFoundError(paths[err])
    return handle


def load_pack_paths(paths: List[str], vocab_size: int, seed: int = 0,
                    truncate_at: Optional[int] = None, *,
                    fixed_len: Optional[int] = None, min_len: int = 1,
                    chunk: int = 1, pad_docs_to: Optional[int] = None,
                    n_threads: Optional[int] = None):
    """Native read+tokenize+hash+pack into a padded ``[D, L]`` batch
    (uint16 ids for vocabs within 2^16, else int32) plus int32 lengths.
    ``fixed_len`` pins L (documents beyond it truncated); without it L is
    max(min_len, longest doc) rounded up to a ``chunk`` multiple, the
    shape rule of ``io.corpus.pack_corpus``, which costs a token-count
    pass. Returns ``(token_ids, lengths)``, or None without the native
    library."""
    lib = _load()
    if lib is None:
        return None
    n_threads = resolve_pack_threads(n_threads)
    # The packers' two traced steps: the parallel file read
    # (``pack_read``), then the tokenize, hash and wire fill
    # (``pack_tokenize``).
    with obs.span("pack_read", files=len(paths), threads=n_threads):
        handle = _open(lib, paths, n_threads,
                       want_counts=int(fixed_len is None))
    try:
        with obs.span("pack_tokenize"):
            if fixed_len is None:
                width = max(min_len, lib.loader_max_count(handle), 1)
                width = -(-width // chunk) * chunk
            else:
                width = fixed_len
            d_padded = max(pad_docs_to or len(paths), len(paths))
            lengths = np.zeros((d_padded,), dtype=np.int32)
            lens_ptr = lengths.ctypes.data_as(_PI32)
            if vocab_size <= (1 << 16):
                ids = np.zeros((d_padded, width), dtype=np.uint16)
                lib.loader_fill_u16(handle, _U64(seed), vocab_size,
                                    truncate_at or 0,
                                    ids.ctypes.data_as(_PU16), width,
                                    lens_ptr, n_threads)
            else:
                ids = np.zeros((d_padded, width), dtype=np.int32)
                lib.loader_fill(handle, _U64(seed), vocab_size,
                                truncate_at or 0, ids.ctypes.data_as(_PI32),
                                width, lens_ptr, n_threads)
        NATIVE_CALLS["load_pack_paths"] += 1
        return ids, lengths
    finally:
        lib.loader_close(handle)


def _flat_pack_scaffold(lib, paths: List[str], max_per_doc: int,
                        pad_docs_to: Optional[int], n_threads: int, fill,
                        align: int = 1, cap_ids: Optional[int] = None,
                        dtype=np.uint16):
    """Shared scaffolding of the flat packer: parallel read, buffer
    sizing (``cap_ids`` over-allocates to the bucket-rounded chunk
    capacity, so the wire leaves native ship-ready), close.
    ``fill(handle, flat, lengths)`` runs the per-token pass and returns
    the live aligned id count."""
    with obs.span("pack_read", files=len(paths), threads=n_threads):
        handle = _open(lib, paths, n_threads)
    try:
        with obs.span("pack_tokenize"):
            d_padded = max(pad_docs_to or len(paths), len(paths))
            per_doc_cap = max_per_doc if align <= 1 \
                else -(-max_per_doc // align) * align
            n_ids = max(len(paths) * per_doc_cap, cap_ids or 0)
            flat = np.empty((n_ids,), dtype=dtype)
            lengths = np.zeros((d_padded,), dtype=np.int32)
            total = fill(handle, flat, lengths)
        return flat, lengths, int(total)
    finally:
        lib.loader_close(handle)


def load_pack_flat(paths: List[str], vocab_size: int, seed: int = 0,
                   truncate_at: Optional[int] = None,
                   max_per_doc: int = 256,
                   pad_docs_to: Optional[int] = None,
                   n_threads: Optional[int] = None, align: int = 1,
                   cap_ids: Optional[int] = None):
    """Native ragged pack: read + tokenize + hash into a FLAT uint16
    stream (each doc at a multiple of ``align`` ids, zero fill between,
    zero tail up to ``cap_ids``) plus per-doc lengths. Requires
    vocab_size <= 2^16. Returns ``(flat_ids, lengths, total)``, or None
    without the native library."""
    lib = _load()
    if lib is None or vocab_size > (1 << 16):
        return None
    threads = resolve_pack_threads(n_threads)

    def fill(handle, flat, lens):
        # The threaded fill pays a count prepass; with one thread the
        # serial single-pass fill is faster (the JAX package's choice).
        args = (handle, _U64(seed), vocab_size, truncate_at or 0,
                max_per_doc, flat.ctypes.data_as(_PU16), _I64(flat.size),
                lens.ctypes.data_as(_PI32), _I64(align))
        if threads > 1:
            return lib.loader_fill_flat_u16_v3(*args, threads)
        return lib.loader_fill_flat_u16_v2(*args)

    out = _flat_pack_scaffold(lib, paths, max_per_doc, pad_docs_to, threads,
                              fill, align=align, cap_ids=cap_ids)
    NATIVE_CALLS["load_pack_flat"] += 1
    return out


def load_slab_paths(paths: List[str], pad_docs_to: Optional[int] = None,
                    n_threads: Optional[int] = None, align: int = 16,
                    cap_round: int = 1):
    """Native bytes-wire pack: parallel file read + byte-slab fill, no
    tokenize and no hash on the host. Returns ``(slab uint8 [cap], blens
    int32 [D_padded], total)``, ``cap`` the aligned total rounded up to a
    ``cap_round`` multiple and every non-document byte ``0x20``; or None
    without the native library."""
    lib = _load()
    if lib is None:
        return None
    threads = resolve_pack_threads(n_threads)
    with obs.span("pack_read", files=len(paths), threads=threads):
        handle = _open(lib, paths, threads)
    try:
        # the bytes wire's fill: no tokenize or hash, the slab only
        with obs.span("pack_tokenize"):
            total = int(lib.loader_slab_bytes(handle, align))
            cap = max(total + (-total % cap_round), cap_round)
            d_padded = max(pad_docs_to or len(paths), len(paths))
            slab = np.empty((cap,), dtype=np.uint8)
            blens = np.zeros((d_padded,), dtype=np.int32)
            wrote = lib.loader_fill_slab(handle, slab.ctypes.data_as(_PU8),
                                         cap, blens.ctypes.data_as(_PI32),
                                         align, threads)
        assert wrote == total, (wrote, total)
        NATIVE_CALLS["load_slab_paths"] += 1
        return slab, blens, total
    finally:
        lib.loader_close(handle)


def _paths_blob(items: List[str]) -> bytes:
    return b"\0".join(p.encode() for p in items) + b"\0"


def exact_rerank_paths(paths: List[str], topk_ids: np.ndarray,
                       num_docs_idf: int, vocab_size: int, seed: int = 0,
                       truncate_at: Optional[int] = None,
                       max_tokens: Optional[int] = None, k: int = 16,
                       n_threads: Optional[int] = None):
    """Native exact-string re-rank of a hashed selection
    (``native/rerank.cc``): ``paths[i]`` is the document whose device
    top-k margin selection is ``topk_ids[i]`` (bucket ids, negative =
    padding). Returns a list, in document order, of ``[(word, score),
    ...]``: exact float64 TF-IDF over the exact DF of the candidate set,
    score descending then word ascending, at most ``k`` entries, positive
    scores only. None without the native library (the caller runs the
    Python engine, the same semantics). The corpus is read into native
    memory for the passes."""
    lib = _load()
    if lib is None:
        return None
    n_docs = len(paths)
    topk_ids = np.ascontiguousarray(topk_ids, dtype=np.int32)
    if topk_ids.ndim != 2 or topk_ids.shape[0] != n_docs:
        raise ValueError(f"selection of shape {topk_ids.shape} for "
                         f"{n_docs} documents")
    n_threads = resolve_pack_threads(n_threads)
    handle = _open(lib, paths, n_threads)
    res = None
    try:
        res = lib.rerank_run(handle, topk_ids.ctypes.data_as(_PI32),
                             topk_ids.shape[1], num_docs_idf, _U64(seed),
                             vocab_size, truncate_at or 0, max_tokens or 0,
                             k, n_threads)
        total = lib.rerank_total(res)
        counts = np.zeros((n_docs,), dtype=np.int32)
        offs = np.zeros((total,), dtype=np.int64)
        lens = np.zeros((total,), dtype=np.int64)
        scores = np.zeros((total,), dtype=np.float64)
        blob = ctypes.create_string_buffer(
            max(int(lib.rerank_blob_bytes(res)), 1))
        lib.rerank_fill(res, counts.ctypes.data_as(_PI32),
                        offs.ctypes.data_as(_PI64),
                        lens.ctypes.data_as(_PI64),
                        scores.ctypes.data_as(_PF64), blob)
        raw = blob.raw
        off_l, len_l, sc_l = offs.tolist(), lens.tolist(), scores.tolist()
        out, pos = [], 0
        for c in counts.tolist():
            out.append([(raw[off_l[j]:off_l[j] + len_l[j]], sc_l[j])
                        for j in range(pos, pos + c)])
            pos += c
        return out
    finally:
        if res is not None:
            lib.rerank_free(res)
        lib.loader_close(handle)


class ExactVocabOverflow(Exception):
    """More distinct words than the configured vocab: the exact-id path
    cannot serve this corpus (the hashed re-rank engine can)."""


class InternSession:
    """A run-scoped exact word-id table (``native/intern.cc``), shared
    by every chunk of an exact ingest so ids are corpus-global, assigned
    in first-appearance order. ``words()`` dumps the id -> bytes
    dictionary. A context manager: the table is native memory."""

    def __init__(self, cap: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native intern table unavailable")
        self._lib = lib
        self._cap = cap
        self._h = lib.intern_open(cap)

    def __enter__(self) -> "InternSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._h is not None:
            self._lib.intern_close(self._h)
            self._h = None

    @property
    def count(self) -> int:
        return int(self._lib.intern_count(self._h))

    def pack_flat(self, paths: List[str], truncate_at: Optional[int],
                  max_per_doc: int, pad_docs_to: Optional[int] = None,
                  seed: int = 0, n_threads: Optional[int] = None,
                  align: int = 1, cap_ids: Optional[int] = None):
        """Exact-id twin of :func:`load_pack_flat` (the same return
        contract and ``cap_ids`` staging): uint16 ids up to a 2^16 cap,
        int32 past it. Raises :class:`ExactVocabOverflow` when the corpus
        holds more distinct words than the table's cap."""
        lib = self._lib
        wide = self._cap > (1 << 16)
        fill_fn = lib.intern_fill_flat_i32 if wide \
            else lib.intern_fill_flat_u16
        id_ptr = _PI32 if wide else _PU16

        def fill(handle, flat, lens):
            return fill_fn(handle, self._h, _U64(seed), truncate_at or 0,
                           max_per_doc, flat.ctypes.data_as(id_ptr),
                           lens.ctypes.data_as(_PI32), _I64(align))

        flat, lengths, total = _flat_pack_scaffold(
            lib, paths, max_per_doc, pad_docs_to,
            resolve_pack_threads(n_threads), fill, align=align,
            cap_ids=cap_ids, dtype=np.int32 if wide else np.uint16)
        if total < 0:
            raise ExactVocabOverflow(
                f"corpus exceeds {self.count} distinct words")
        return flat, lengths, total

    def emit(self, input_dir: str, names: List[str], topk_ids: np.ndarray,
             topk_counts: np.ndarray, df: np.ndarray, lengths: np.ndarray,
             num_docs: int, k: int, truncate_at: Optional[int],
             max_tokens: Optional[int], seed: int = 0,
             n_threads: Optional[int] = None):
        """The native exact-terms finish (``intern.cc`` ``exact_emit``):
        float64 rescore, per-doc (-score, word) order, reference-format
        lines in byte order, boundary-tie docs re-read and resolved
        against this table. Returns ``(lines, per_doc_counts, offs,
        lens, scores, word_blob)``, ``lines`` the sorted output bytes and
        the rest the doc-major (word, score) lists."""
        lib = self._lib
        n_docs = len(names)
        if topk_ids.ndim != 2 or topk_ids.shape[0] != n_docs:
            raise ValueError(f"selection of shape {topk_ids.shape} for "
                             f"{n_docs} documents")
        ids = np.ascontiguousarray(topk_ids, dtype=np.int32)
        cnt = np.ascontiguousarray(topk_counts, dtype=np.int32)
        dfv = np.ascontiguousarray(df, dtype=np.int32)
        lens_arr = np.ascontiguousarray(lengths[:n_docs], dtype=np.int32)
        failed = np.full((1,), -1, dtype=np.int64)
        res = lib.exact_emit_run(
            self._h, input_dir.encode(), _paths_blob(names),
            ids.ctypes.data_as(_PI32), cnt.ctypes.data_as(_PI32), n_docs,
            ids.shape[1], dfv.ctypes.data_as(_PI32), dfv.size,
            lens_arr.ctypes.data_as(_PI32), num_docs, k, truncate_at or 0,
            max_tokens or 0, _U64(seed), resolve_pack_threads(n_threads),
            failed.ctypes.data_as(_PI64))
        if not res:
            # A boundary-tie document vanished between pack and emit.
            raise FileNotFoundError(
                os.path.join(input_dir, names[int(failed[0])])
                if failed[0] >= 0 else input_dir)
        try:
            total = max(int(lib.exact_emit_total(res)), 1)
            per_doc = np.zeros((n_docs,), dtype=np.int32)
            offs = np.zeros((total,), dtype=np.int64)
            lens_out = np.zeros((total,), dtype=np.int64)
            scores = np.zeros((total,), dtype=np.float64)
            line_bytes = int(lib.exact_emit_line_bytes(res))
            wblob = ctypes.create_string_buffer(
                max(int(lib.exact_emit_word_bytes(res)), 1))
            lblob = ctypes.create_string_buffer(max(line_bytes, 1))
            lib.exact_emit_fill(res, per_doc.ctypes.data_as(_PI32),
                                offs.ctypes.data_as(_PI64),
                                lens_out.ctypes.data_as(_PI64),
                                scores.ctypes.data_as(_PF64), wblob, lblob)
            return (lblob.raw[:line_bytes], per_doc, offs, lens_out, scores,
                    wblob.raw)
        finally:
            lib.exact_emit_free(res)

    def words(self) -> List[bytes]:
        """The id -> word dictionary, index = exact id."""
        lib = self._lib
        n = self.count
        offs = np.zeros((max(n, 1),), dtype=np.int64)
        lens = np.zeros((max(n, 1),), dtype=np.int64)
        blob = ctypes.create_string_buffer(
            max(int(lib.intern_blob_bytes(self._h)), 1))
        lib.intern_dump(self._h, offs.ctypes.data_as(_PI64),
                        lens.ctypes.data_as(_PI64), blob)
        raw = blob.raw
        return [raw[offs[i]:offs[i] + lens[i]] for i in range(n)]


def tokenize_spans(data: bytes) -> Optional[List[bytes]]:
    """Native whitespace tokenization into token byte strings (no
    truncation), or None without the native library."""
    lib = _load()
    if lib is None:
        return None
    n = lib.tok_count(data, len(data))
    offs = np.empty(n, dtype=np.int64)
    lens = np.empty(n, dtype=np.int64)
    wrote = lib.tok_spans(data, len(data), offs.ctypes.data_as(_PI64),
                          lens.ctypes.data_as(_PI64), n)
    assert wrote == n
    return [data[o:o + l] for o, l in zip(offs.tolist(), lens.tolist())]
