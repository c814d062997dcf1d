#!/usr/bin/env python3
"""Time the fused score+top-k kernel (csrc/score_topk.cu) against another
version of its source on one GPU, at the device chargram's shape and at
the main path's.

    python3 tfidf_tpu_torch/tools/score_topk_ab.py OTHER.cu

``OTHER.cu`` is another score_topk.cu (an earlier commit's, say); both
are built with nvcc into a temporary directory. Each is first held equal
to ``fused_score_topk_plain`` (ids exact, scores bit-equal) on: the
chargram rows of ``chip_smoke.path_chargram`` (char 3..5-grams of the
source files it reads, V 2^20, 12,288 slots a row, most rows past the
kernel's 2,048-slot list) at k 16 and 64; uniform rows of 16,384 slots
at k 16, 64 and 65; the Zipf batch of ``chip_smoke.py`` (L 256) and
Zipf rows of 1,024 slots at k 16. Then each is timed in turns, the
order reversed every round: the device span of one call, median of 20
after a warm-up, as ``chip_smoke.device_span_ms`` takes it, with the
plain version beside. Prints the card's name and power limit and one
JSON object of times in ms.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tfidf_tpu_torch.ops import _build  # noqa: E402
from tfidf_tpu_torch.ops import kernels as K  # noqa: E402

SOURCE = os.path.join(REPO, "tfidf_tpu_torch", "csrc", "score_topk.cu")
ROUNDS = 4


def build(sources: dict, tmp: str) -> dict:
    """Build every source at once (one nvcc each); name -> library."""
    procs = {}
    for name, path in sources.items():
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.GENCODE, "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v",
             "-I", os.path.dirname(SOURCE), path,
             "-o", os.path.join(tmp, f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"score_topk_ab: {name} did not build:\n{log}")
        print(name, [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                     if "registers" in ln], flush=True)
        lib = ctypes.CDLL(os.path.join(tmp, f"{name}.so"))
        fn = lib.tfidf_fused_score_topk
        fn.argtypes = _build.SIGNATURES["tfidf_fused_score_topk"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def launcher(fn, ids, counts, head, lens, idf, k: int):
    """One call of a build's launcher into fresh outputs."""
    d, length = ids.shape

    def go():
        vals = torch.empty((d, k), dtype=idf.dtype, device=ids.device)
        tids = torch.empty((d, k), dtype=torch.int32, device=ids.device)
        rc = fn(ids.data_ptr(), counts.data_ptr(), head.data_ptr(),
                lens.data_ptr(), idf.data_ptr(), K._SCORE_CODES[idf.dtype],
                vals.data_ptr(), tids.data_ptr(), d, length, k, idf.numel(),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"score_topk_ab: launch failed ({rc})")
        return vals, tids
    return go


def batches(dev):
    """name -> (ids, counts, head, lengths, idf) sorted triples."""
    import tfidf_tpu_torch as T
    from tfidf_tpu_torch.ops.scoring import idf_from_df
    from tfidf_tpu_torch.ops.sparse import sorted_term_counts, sparse_df
    out = {"chargram": cs.chargram_triples(cs.chargram_corpus(T.Corpus)[0])}
    rng = np.random.default_rng(cs.SEED)
    utoks = torch.from_numpy(rng.integers(0, cs.SPARSE_VOCAB, (64, 16384))
                             .astype(np.int32)).to(dev)
    ulens = torch.full((64,), 16384, dtype=torch.int32, device=dev)
    ulens[::2] = 3000
    uidf = idf_from_df(torch.from_numpy(rng.integers(
        1, 1000, cs.SPARSE_VOCAB).astype(np.int32)).to(dev), 1000,
        torch.float32)
    out["uniform"] = (*sorted_term_counts(utoks, ulens), ulens, uidf)
    for name, d, length in (("zipf", cs.N_DOCS, cs.DOC_LEN),
                            ("zipf1024", 4096, 1024)):
        toks, lens = cs.zipf_tokens(rng, d, length, cs.SPARSE_VOCAB)
        lens_d = torch.from_numpy(lens).to(dev)
        zi, zc, zh = sorted_term_counts(torch.from_numpy(toks).to(dev),
                                        lens_d)
        out[name] = (zi, zc, zh, lens_d,
                     idf_from_df(sparse_df(zi, zh, cs.SPARSE_VOCAB), d,
                                 torch.float32))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("score_topk_ab: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        libs = build({"this": SOURCE, "other": sys.argv[1]}, tmp)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        data = batches(dev)
        checks = [("chargram", 16), ("chargram", 64), ("uniform", 16),
                  ("uniform", 64), ("uniform", 65), ("zipf", 16),
                  ("zipf1024", 16)]
        for name, fn in libs.items():
            for batch, k in checks:
                vals, tids = launcher(fn, *data[batch], k)()
                pv, pt = K.fused_score_topk_plain(*data[batch], k=k)
                torch.cuda.synchronize()
                if not (torch.equal(tids, pt) and cs.same_bits(vals, pv)):
                    raise SystemExit(f"score_topk_ab: {name} differs from "
                                     f"plain on {batch} at k {k}")
        timed = [("chargram", 16), ("chargram", 64), ("uniform", 16),
                 ("zipf", 16), ("zipf1024", 16)]
        times = {(name, b, k): [] for name in libs for b, k in timed}
        order = list(times)
        for rnd in range(ROUNDS):
            for key in order[::-1] if rnd % 2 else order:
                name, b, k = key
                times[key].append(cs.device_span_ms(
                    launcher(libs[name], *data[b], k)))
        out = {f"{name}_{b}_k{k}": {"median_ms": statistics.median(t),
                                    "ms": t}
               for (name, b, k), t in times.items()}
        for b, k in timed:
            out[f"plain_{b}_k{k}_ms"] = cs.device_span_ms(
                lambda b=b, k=k: K.fused_score_topk_plain(*data[b], k=k))
        head = data["chargram"][2]
        out["chargram_shape"] = list(head.shape)
        out["chargram_rows_past_2048_head_slots"] = int(
            (head.sum(dim=1) > 2048).sum())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
