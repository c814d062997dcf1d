"""Build and load the port's CUDA kernels.

The kernels in ``tfidf_tpu_torch/csrc/*.cu`` have a plain C interface
and are compiled with ``nvcc`` for Hopper (``sm_90a``) into one shared
library, loaded with ``ctypes``. The build runs at the first CUDA use
(:func:`load`), never at import: one ``nvcc -c`` per source, all started
together, then one link. The library lands in ``tfidf_tpu_torch/_build/``
under a name carrying the hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the existing library.

No ``--use_fast_math``: IEEE division and round-to-nearest conversions
are part of the kernels' contract.
"""

from __future__ import annotations

import ctypes
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
}


def sources() -> List[Path]:
    return sorted(SOURCE_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SOURCE_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{LIB_STEM}-{h.hexdigest()[:16]}.so"


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
    """Compile every source in parallel and link the shared library.

    Returns ``{"path", "seconds", "log"}``; ``log`` holds nvcc's output,
    including ``-Xptxas -v``'s registers, shared memory and spills per
    kernel. Raises RuntimeError with that output when a step fails.
    """
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
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
