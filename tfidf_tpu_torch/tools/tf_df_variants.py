#!/usr/bin/env python3
"""Time the TF/DF kernel (csrc/tf_df.cu) against variants of itself on
one GPU, at the dense path's shape of ``chip_smoke.py``.

    python3 tfidf_tpu_torch/tools/tf_df_variants.py

Each variant is the checked-in source with one setting changed by text
substitution, built with nvcc into a temporary directory:

* threads a block: 128 (the source's), 256 or 512;
* df zeroed by the source's small kernel, of which the histogram is a
  programmatic dependent, or by ``df.zero_()`` before a plain launch.

Every variant is first held equal to ``tf_df_plain`` (counts and df,
into outputs filled with -1) at V 4,096, 4,095, 40,000 (D 512, five
vocab tiles) and with uint16 ids and an ``id_offset``. Then each is
timed in turns, the order reversed every round: the device span of one
call (df's zeroing included), median of 20 after a warm-up, as
``chip_smoke.device_span_ms`` takes it. Prints ptxas's register counts,
the card's name and power limit, and one JSON object of times in ms.
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

SOURCE = os.path.join(REPO, "tfidf_tpu_torch", "csrc", "tf_df.cu")
ROUNDS = 6


def variant_sources() -> dict:
    """name -> (source text, threads a block, df zeroed by torch)."""
    src = open(SOURCE).read()
    threads = "constexpr int kThreads = 128;"
    pdl = "cfg.numAttrs = df != nullptr ? 1 : 0;"
    a = src.index("  if (df != nullptr) {\n    const int zb")
    b = src.index("  const cudaError_t err =\n      token_dtype")
    if threads not in src or pdl not in src:
        raise SystemExit("tf_df_variants: tf_df.cu no longer has the lines "
                         "its variants change")
    torch_zero = src[:a] + src[b:]
    torch_zero = torch_zero.replace(pdl, "cfg.numAttrs = 0;")
    out = {}
    for n in (128, 256, 512):
        swap = f"constexpr int kThreads = {n};"
        out[f"t{n}"] = (src.replace(threads, swap), n, False)
        out[f"t{n}_torch_zero"] = (torch_zero.replace(threads, swap), n, True)
    return out


def build(variants: dict, tmp: str) -> dict:
    """Build every variant at once (one nvcc each); name -> library."""
    procs = {}
    for name, (text, _, _) in variants.items():
        cu = os.path.join(tmp, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.GENCODE, "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v",
             "-I", os.path.dirname(SOURCE), cu,
             "-o", os.path.join(tmp, f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"tf_df_variants: {name} did not build:\n{log}")
        print(name, [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                     if "registers" in ln], flush=True)
        lib = ctypes.CDLL(os.path.join(tmp, f"{name}.so"))
        lib.tfidf_tf_df.argtypes = _build.SIGNATURES["tfidf_tf_df"]
        lib.tfidf_tf_df.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launcher(lib, threads: int, torch_zero: bool, toks, lens, counts, df,
             vocab: int, id_offset: int = 0, sms: int = 132):
    """One call of a variant: ``tf_df_plan``'s tiles, its blocks per SM
    recounted for the variant's threads."""
    d, length = toks.shape
    p = K.tf_df_plan(d, length, vocab, with_df=df is not None, sms=sms)
    per_sm = min(2048 // threads, (228 * 1024) // (p["smem_bytes"] + 1024))
    blocks = max(1, min(d, -(-sms * per_sm // p["tiles"])))
    code = K._TOKEN_CODES[toks.dtype]

    def go():
        if torch_zero and df is not None:
            df.zero_()
        rc = lib.tfidf_tf_df(
            toks.data_ptr(), code, lens.data_ptr(), counts.data_ptr(),
            None if df is None else df.data_ptr(), d, length, vocab,
            id_offset, p["vt"], blocks,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"tf_df_variants: launch failed ({rc})")
    return go


def main() -> int:
    if not torch.cuda.is_available():
        print("tf_df_variants: no CUDA device", file=sys.stderr)
        return 2
    variants = variant_sources()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(variants, tmp)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
        rng = np.random.default_rng(cs.SEED)
        toks, lens = cs.zipf_tokens(rng, cs.N_DOCS, cs.DOC_LEN,
                                    cs.DENSE_VOCAB)
        toks_d = torch.from_numpy(toks).to(dev)
        lens_d = torch.from_numpy(lens).to(dev)
        wide_t, wide_l = cs.zipf_tokens(rng, 512, cs.DOC_LEN, 40000)
        checks = [(toks_d, lens_d, cs.DENSE_VOCAB, 0),
                  (toks_d, lens_d, 4095, 0),
                  (torch.from_numpy(wide_t).to(dev),
                   torch.from_numpy(wide_l).to(dev), 40000, 0),
                  (torch.from_numpy(toks.astype(np.uint16)).to(dev), lens_d,
                   cs.DENSE_VOCAB // 2, 1024)]
        for name, (_, threads, tz) in variants.items():
            for tk, ln, v, off in checks:
                for with_df in (True, False):
                    want_c, want_d = K.tf_df_plain(
                        tk.to(torch.int32), ln, vocab_size=v, id_offset=off,
                        with_df=with_df)
                    c = torch.full_like(want_c, -1)
                    d = torch.full_like(want_d, -1) if with_df else None
                    launcher(libs[name], threads, tz, tk, ln, c, d, v, off,
                             sms)()
                    torch.cuda.synchronize()
                    if not (torch.equal(c, want_c)
                            and (d is None or torch.equal(d, want_d))):
                        raise SystemExit(f"tf_df_variants: {name} differs "
                                         f"from plain at V {v}")
        counts = torch.empty((cs.N_DOCS, cs.DENSE_VOCAB), dtype=torch.int32,
                             device=dev)
        df = torch.empty(cs.DENSE_VOCAB, dtype=torch.int32, device=dev)
        calls = {name: launcher(libs[name], threads, tz, toks_d, lens_d,
                                counts, df, cs.DENSE_VOCAB, sms=sms)
                 for name, (_, threads, tz) in variants.items()}
        times = {name: [] for name in calls}
        names = list(calls)
        for rnd in range(ROUNDS):
            for name in names[::-1] if rnd % 2 else names:
                times[name].append(cs.device_span_ms(calls[name]))
        out = {name: {"median_ms": statistics.median(t), "ms": t}
               for name, t in times.items()}
        out["df_zero_alone_ms"] = cs.device_span_ms(df.zero_)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
