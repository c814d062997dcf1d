"""Build and load the port's two native libraries.

* The CUDA kernels in ``tfidf_tpu_torch/csrc/*.cu`` have a plain C
  interface and are compiled with ``nvcc`` for Hopper (``sm_90a``) into
  one shared library, loaded with ``ctypes``. The build runs at the
  first CUDA use (:func:`load`), never at import: one ``nvcc -c`` per
  source, all started together, then one link. No ``--use_fast_math``:
  IEEE division and round-to-nearest conversions are part of the
  kernels' contract.
* The host loader library (:func:`load_host`): the repository's native
  read+tokenize+hash packers (``native/{fast_tokenizer,loader,rerank,
  intern}.cc``) compiled with ``g++`` (the flags of ``native/Makefile``'s
  ``fast_tokenizer.so`` rule), on the CPU as on the card, at the first
  packer call. The port never writes into ``native/``.

Both land in ``tfidf_tpu_torch/_build/`` under a name carrying the hash
of their sources and flags, so an edited source rebuilds and an
unchanged one loads the existing library. A build writes to a temporary
file and renames it into place under a file lock, so processes that
start together build once and never load a half-written library.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_STEM = "libtfidf_kernels"
HOST_SOURCE_DIR = _PKG.parent / "native"
HOST_SOURCES = ("fast_tokenizer.cc", "loader.cc", "rerank.cc", "intern.cc")
HOST_LIB_STEM = "libtfidf_host"
HOST_FLAGS = ["-O2", "-std=c++17", "-pthread", "-shared", "-fPIC"]

GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C signatures of the kernels' launchers (csrc/*.cu); each returns the
# launch's cudaGetLastError() as an int.
SIGNATURES = {
    # ids, counts, head, lengths, idf, idf_dtype, vals, tids, D, L, k, V,
    # stream
    "tfidf_fused_score_topk": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I,
                               _I, _P],
    # tokens, token_dtype, lengths, counts, df, D, L, V, id_offset, stream
    "tfidf_tf_df": [_P, _I, _P, _P, _P, _I, _I, _I, _LL, _P],
    # vals, val_dtype, tids, words, n, stream
    "tfidf_pack_words": [_P, _I, _P, _P, _LL, _P],
    # flat, flat_dtype, lengths, scratch, out, D, L, align, n_granules, then
    # the plan (ops/kernels.py ragged_rebuild_plan): group, warps; scan,
    # stream
    "tfidf_ragged_rebuild": [_P, _I, _P, _P, _P, _I, _I, _I, _LL, _I, _I,
                             _I, _P],
    # slab, slab_dtype, n, starts, lengths, ids, D, L, seed_state,
    # vocab_size, m32, magic, truncate_at, then the plan (ops/kernels.py
    # tokenize_hash_plan): warps, vec; stream
    "tfidf_tokenize_hash": [_P, _I, _LL, _P, _P, _P, _I, _I,
                            ctypes.c_uint64, _I, ctypes.c_uint,
                            ctypes.c_ulonglong, _I, _I, _I, _P],
    # data, cols, qmat, out, rows, L, Q, then the plan (ops/kernels.py
    # tile_scores_plan): g_log2, v, nv, passes, sv, warps, cap, blocks;
    # stream
    "tfidf_tile_scores": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _P],
}


def sources() -> List[Path]:
    return sorted(SOURCE_DIR.glob("*.cu"))


def _hashed_path(stem: str, flags: List[str], srcs) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in srcs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def library_path() -> Path:
    """Where the kernel library for the current sources and flags lives."""
    return _hashed_path(LIB_STEM, NVCC_FLAGS, sorted(SOURCE_DIR.glob("*.cu*")))


def host_sources() -> List[Path]:
    return [HOST_SOURCE_DIR / name for name in HOST_SOURCES]


def host_library_path() -> Path:
    """Where the host loader library for the current sources lives (the
    shared header ``tokenize_common.h`` is hashed too)."""
    return _hashed_path(HOST_LIB_STEM, HOST_FLAGS,
                        [*host_sources(),
                         HOST_SOURCE_DIR / "tokenize_common.h"])


@contextlib.contextmanager
def _build_lock(name: str):
    """An exclusive lock on ``_build/<name>.lock`` across processes."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def nvcc() -> str:
    """The nvcc binary: ``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda``,
    else the one on PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of tfidf_tpu_torch are built on first GPU use")
    return found


def build() -> dict:
    """Compile every kernel source in parallel and link the shared library.

    Returns ``{"path", "seconds", "log"}``; ``log`` holds nvcc's output,
    including ``-Xptxas -v``'s registers, shared memory and spills per
    kernel. Raises RuntimeError with that output when a step fails.
    """
    out = library_path()
    t0 = time.perf_counter()
    with _build_lock("kernels"), \
            tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        exe = nvcc()
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [exe, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        failed = []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        staged = Path(tmp) / out.name
        link = subprocess.run(
            [exe, *GENCODE, "-shared", *[str(o) for _, o, _ in procs],
             "-o", str(staged)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        os.replace(staged, out)
    return {"path": str(out), "seconds": time.perf_counter() - t0,
            "log": "\n".join(log)}


def build_host() -> dict:
    """Compile the host loader library: one ``g++ -c`` per source, all
    started together, then one link. Returns ``{"path", "seconds",
    "log"}``; raises RuntimeError with g++'s output when a step fails."""
    out = host_library_path()
    t0 = time.perf_counter()
    with _build_lock("host"), \
            tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        if out.exists():  # built by another process while we waited
            return {"path": str(out), "seconds": 0.0, "log": ""}
        cxx = os.environ.get("CXX") or "g++"
        procs = [(src, Path(tmp) / (src.stem + ".o"), subprocess.Popen(
            [cxx, *HOST_FLAGS, "-c", str(src), "-o",
             str(Path(tmp) / (src.stem + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in host_sources()]
        log = []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                raise RuntimeError(f"{cxx} failed on {src.name}:\n"
                                   + "\n".join(log))
        staged = Path(tmp) / out.name
        link = subprocess.run(
            [cxx, *HOST_FLAGS, *[str(o) for _, o, _ in procs], "-o",
             str(staged)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError(f"{cxx} link failed:\n" + "\n".join(log))
        os.replace(staged, out)
    return {"path": str(out), "seconds": time.perf_counter() - t0,
            "log": "\n".join(log)}


def load_host() -> ctypes.CDLL:
    """The loaded host loader library, built first when its sources
    changed. Raises (OSError, RuntimeError) when it cannot be built or
    loaded; the caller decides what that means."""
    path = host_library_path()
    if not path.exists():
        build_host()
    return ctypes.CDLL(str(path))


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded kernel library, built first when its sources changed."""
    path = library_path()
    if not path.exists():
        build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
