"""ctypes bindings for the native host loader (the port's copy of what
the chunk packers call from ``tfidf_tpu/io/fast_tokenizer.py``).

The library is the repository's native read+tokenize+hash code
(``native/{fast_tokenizer,loader,rerank,intern}.cc``), built by
``ops/_build.build_host`` with g++ into ``tfidf_tpu_torch/_build/`` at
the first call, on the CPU as on the card. When it cannot be built or
loaded, or ``TFIDF_TPU_NO_NATIVE`` is set, every function here returns
None (or False) and the packers run their contract-identical Python
path instead: host code either way, never a device fallback.

:data:`NATIVE_CALLS` counts the native packer calls, so a caller can
show which packer ran.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional

import numpy as np

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
_SIGNATURES = {
    "loader_open2": (_VP, [_C, _I64, _I, _I]),
    "loader_error": (_I64, [_VP]),
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
        lib = _build.load_host()
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


# Every packer needs the whole symbol set, so the three checks agree.
loader_available = flat_available = slab_available = available


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


def _open(lib, paths: List[str], n_threads: int):
    """Parallel read of every file (no token-count prepass); raises
    FileNotFoundError on an unreadable one (the reference's hard exit,
    ``TFIDF.c:137``). The caller closes the handle."""
    blob = b"\0".join(p.encode() for p in paths) + b"\0"
    handle = lib.loader_open2(blob, len(paths), n_threads, 0)
    err = lib.loader_error(handle)
    if err >= 0:
        lib.loader_close(handle)
        raise FileNotFoundError(paths[err])
    return handle


def load_pack_paths(paths: List[str], vocab_size: int, seed: int = 0,
                    truncate_at: Optional[int] = None, *, fixed_len: int,
                    pad_docs_to: Optional[int] = None,
                    n_threads: Optional[int] = None):
    """Native read+tokenize+hash+pack into a padded ``[D, fixed_len]``
    batch (uint16 ids for vocabs within 2^16, else int32; documents
    beyond ``fixed_len`` tokens truncated) plus int32 lengths. Returns
    ``(token_ids, lengths)``, or None without the native library."""
    lib = _load()
    if lib is None:
        return None
    n_threads = resolve_pack_threads(n_threads)
    handle = _open(lib, paths, n_threads)
    try:
        d_padded = max(pad_docs_to or len(paths), len(paths))
        lengths = np.zeros((d_padded,), dtype=np.int32)
        lens_ptr = lengths.ctypes.data_as(_PI32)
        if vocab_size <= (1 << 16):
            ids = np.zeros((d_padded, fixed_len), dtype=np.uint16)
            lib.loader_fill_u16(handle, _U64(seed), vocab_size,
                                truncate_at or 0, ids.ctypes.data_as(_PU16),
                                fixed_len, lens_ptr, n_threads)
        else:
            ids = np.zeros((d_padded, fixed_len), dtype=np.int32)
            lib.loader_fill(handle, _U64(seed), vocab_size, truncate_at or 0,
                            ids.ctypes.data_as(_PI32), fixed_len, lens_ptr,
                            n_threads)
        NATIVE_CALLS["load_pack_paths"] += 1
        return ids, lengths
    finally:
        lib.loader_close(handle)


def _flat_pack_scaffold(lib, paths: List[str], max_per_doc: int,
                        pad_docs_to: Optional[int], n_threads: int, fill,
                        align: int = 1, cap_ids: Optional[int] = None):
    """Shared scaffolding of the flat packer: parallel read, buffer
    sizing (``cap_ids`` over-allocates to the bucket-rounded chunk
    capacity, so the wire leaves native ship-ready), close.
    ``fill(handle, flat, lengths)`` runs the per-token pass and returns
    the live aligned id count."""
    handle = _open(lib, paths, n_threads)
    try:
        d_padded = max(pad_docs_to or len(paths), len(paths))
        per_doc_cap = max_per_doc if align <= 1 \
            else -(-max_per_doc // align) * align
        n_ids = max(len(paths) * per_doc_cap, cap_ids or 0)
        flat = np.empty((n_ids,), dtype=np.uint16)
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
    handle = _open(lib, paths, threads)
    try:
        total = int(lib.loader_slab_bytes(handle, align))
        cap = max(total + (-total % cap_round), cap_round)
        d_padded = max(pad_docs_to or len(paths), len(paths))
        slab = np.empty((cap,), dtype=np.uint8)
        blens = np.zeros((d_padded,), dtype=np.int32)
        wrote = lib.loader_fill_slab(handle, slab.ctypes.data_as(_PU8), cap,
                                     blens.ctypes.data_as(_PI32), align,
                                     threads)
        assert wrote == total, (wrote, total)
        NATIVE_CALLS["load_slab_paths"] += 1
        return slab, blens, total
    finally:
        lib.loader_close(handle)
