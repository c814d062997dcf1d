#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tfidf_tpu_torch``) on one GPU and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. ``env``: torch/CUDA versions, the card and its power limit; builds the
   CUDA kernels from ``tfidf_tpu_torch/csrc`` with nvcc (sm_90a).
2. ``kernel_cases``: every kernel at the main path's shapes, on the card,
   against its plain PyTorch version on the same inputs (float32,
   bfloat16 and float16 scores): ints, ids and words exact, scores
   bit-equal. Times are medians of 20 calls after a warm-up. ``ms``,
   ``plain_ms`` and ``library_ms`` are the device time of one call of
   the wrapper (its output fills included), of the plain version and of
   the one PyTorch call that computes the same function, where there is
   one: CUDA events around the call while a sleep kernel holds the
   stream, so the host's launch latency is not counted. ``kernel_ms``
   is the kernel alone, from torch.profiler. ``call_ms`` is the
   wrapper's latency with the host launch included. ``bound_ms`` is the
   least time for the bytes the function must move at this run's data;
   ``kernel_bound_ms`` the same for the bytes the kernel alone moves.
3. ``path_sparse_topk``: ``TfidfPipeline.run`` on 32,768 Zipf documents,
   hashed vocab 2^16, top-16 (the sparse engine), against the same run on
   the CPU; asserts the score+top-k and pack kernels launched; profiles
   the device time of one warm ``run_packed``.
4. ``path_dense_topk``: the same corpus on the dense engine, vocab 4,096,
   top-16; asserts the TF/DF and pack kernels launched.
5. ``path_golden``: a 64-doc corpus inside the reference's envelope on the
   golden EXACT config; ``output.txt`` bytes equal the golden oracle's
   and the CPU run's.

Then the ``kernels`` summary line, the card's name and power limit as
``nvidia-smi`` prints them, and last ``{"ok": true, "device": ...}``.
Any failed check raises: the script exits non-zero without the last
line. It needs a CUDA device and the repository beside it.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
SEED = 42
N_DOCS = 32768
DOC_LEN = 256
N_WORDS = 8192
TOPK = 16
SPARSE_VOCAB = 1 << 16
DENSE_VOCAB = 4096


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


# About 5 ms at the H100's boost clock: longer than any timed call
# takes to enqueue its operations.
SLEEP_CYCLES = 10_000_000


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of one ``fn()`` call, host launch included:
    one CUDA-event pair per call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_span_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device milliseconds of one ``fn()`` call, from its first
    device operation to the end of its last: a sleep kernel holds the
    stream while the host enqueues the start event, the call and the end
    event, so the host's launch latency is not counted."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_events(fn, reps: int = 1):
    """Device activity of ``reps`` calls of ``fn`` (after one warm-up
    call), from torch.profiler: ``(name, ms)`` per kernel, copy or
    memset, plus the wall milliseconds of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    check(bool(events), "the profiler recorded no device activity")
    return events, wall_ms


def kernel_ms(fn, kernel: str, reps: int = 20) -> float:
    """Median device milliseconds of the kernel named ``kernel`` over
    ``reps`` calls of ``fn``, each of which launches it once."""
    events, _ = device_events(fn, reps)
    picked = [ms for name, ms in events if kernel in name]
    check(len(picked) == reps,
          f"{len(picked)} launches of {kernel!r} in {reps} calls")
    return statistics.median(picked)


def kernel_times(kernel: str, call, plain, library=None) -> dict:
    """Device time of one wrapper call (``ms``) and of its kernel alone,
    the call's latency from the host, and the device time of the plain
    version and of the library call."""
    return {"ms": device_span_ms(call), "kernel_ms": kernel_ms(call, kernel),
            "call_ms": time_ms(call), "plain_ms": device_span_ms(plain),
            "library_ms": device_span_ms(library) if library else None}


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two same-dtype tensors."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return torch.equal(a.view(view[a.element_size()]),
                       b.view(view[b.element_size()]))


def zipf_tokens(rng, d: int, length: int, vocab: int):
    """Seeded [d, length] int32 ids: Zipf(1.3) word ranks over N_WORDS
    words, each word hashed to a random bucket of ``vocab``, and
    Zipf-shaped doc lengths (bench.py's corpus shape)."""
    buckets = rng.integers(0, vocab, N_WORDS)
    ranks = np.clip(rng.zipf(1.3, (d, length)), 1, N_WORDS) - 1
    lens = np.maximum(length // np.clip(rng.zipf(1.3, d), 1, length), 1)
    return buckets[ranks].astype(np.int32), lens.astype(np.int32)


def zipf_corpus(Corpus, rng):
    """The sparse/dense paths' corpus: N_DOCS docs of words w0..w8191,
    Zipf(1.3) word ranks and Zipf-shaped lengths up to DOC_LEN."""
    words = np.array([f"w{i}".encode() for i in range(N_WORDS)], dtype=object)
    ranks = np.clip(rng.zipf(1.3, N_DOCS * DOC_LEN), 1, N_WORDS) - 1
    lens = np.maximum(DOC_LEN // np.clip(rng.zipf(1.3, N_DOCS), 1, DOC_LEN), 1)
    offs = np.concatenate([[0], np.cumsum(lens)])
    docs = [b" ".join(words[ranks[offs[i]:offs[i + 1]]]) for i in range(N_DOCS)]
    return Corpus(names=[f"doc{i}" for i in range(1, N_DOCS + 1)], docs=docs)


def golden_corpus(Corpus, rng):
    """64 docs inside the reference's envelope: tokens under 16 bytes."""
    vocab = [f"t{i}".encode() for i in range(300)] + [b"common"]
    docs = []
    for _ in range(64):
        n = int(rng.integers(1, 200))
        toks = [vocab[i] for i in rng.integers(0, len(vocab), n)] + [b"common"]
        docs.append(b" ".join(toks) + b"\n")
    return Corpus(names=[f"doc{i}" for i in range(1, 65)], docs=docs)


def env_phase(build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"compute capability {cap} is not Hopper (9, 0)")
    built = build()
    sys.stderr.write(built["log"] + "\n")
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "capability": list(cap),
          "nvidia_smi": smi, "build_s": built["seconds"],
          "library": os.path.relpath(built["path"], REPO)})
    return smi


def kernel_phase(K):
    """Each kernel against its plain version at the main path's shapes."""
    from tfidf_tpu_torch.ops.scoring import idf_from_df
    from tfidf_tpu_torch.ops.sparse import sorted_term_counts, sparse_df

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    summary = {}

    # --- B1: fused score + top-k -------------------------------------
    toks, lens = zipf_tokens(rng, N_DOCS, DOC_LEN, SPARSE_VOCAB)
    toks_d = torch.from_numpy(toks).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    ids, counts, head = sorted_term_counts(toks_d, lens_d)
    df = sparse_df(ids, head, SPARSE_VOCAB)
    idf = idf_from_df(df, N_DOCS, torch.float32)
    cases = []

    def b1_case(label, ids, counts, head, lens_d, idf):
        kv, kt = K.fused_score_topk(ids, counts, head, lens_d, idf, k=TOPK)
        pv, pt = K.fused_score_topk_plain(ids, counts, head, lens_d, idf, k=TOPK)
        torch.cuda.synchronize()
        check(torch.equal(kt, pt), f"B1 {label}: ids differ from plain")
        check(same_bits(kv, pv), f"B1 {label}: scores not bit-equal to plain")
        err = (kv.float() - pv.float()).abs().max().item()
        cases.append({"kernel": "fused_score_topk", "case": label,
                      "shape": list(ids.shape), "k": TOPK, "ids_equal": True,
                      "scores_bit_equal": True, "max_abs_err": err})
        return kv, kt, err

    vals, tids, err = b1_case("float32", ids, counts, head, lens_d, idf)
    b1_case("bfloat16", ids, counts, head, lens_d, idf.to(torch.bfloat16))
    b1_case("float16", ids, counts, head, lens_d, idf.to(torch.float16))
    # Rows too long for shared memory take the kernel's rescoring path.
    ltoks, llens = zipf_tokens(rng, 64, 16384, SPARSE_VOCAB)
    lt, lc, lh = sorted_term_counts(torch.from_numpy(ltoks).to(dev),
                                    torch.from_numpy(llens).to(dev))
    b1_case("long_rows", lt, lc, lh, torch.from_numpy(llens).to(dev), idf)
    d, length = ids.shape
    # What this batch needs: lengths, head at every slot (it alone says
    # which slots score), ids and counts at head slots only, idf at the
    # distinct ids they name, and the picks written.
    n_head = int(head.sum())
    n_idf = int(torch.unique(ids[head]).numel())
    b1_bytes = (d * 4 + d * length + n_head * (4 + 4) + n_idf * 4
                + d * TOPK * (4 + 4))
    summary["fused_score_topk"] = {
        **kernel_times(
            "fused_score_topk_kernel",
            lambda: K.fused_score_topk(ids, counts, head, lens_d, idf, k=TOPK),
            lambda: K.fused_score_topk_plain(ids, counts, head, lens_d, idf,
                                             k=TOPK)),
        "bound_ms": bound_ms(b1_bytes), "kernel_bound_ms": bound_ms(b1_bytes),
        "max_abs_err": err, "shape": {"D": d, "L": length, "k": TOPK,
                                      "V": SPARSE_VOCAB,
                                      "head_slots": n_head}}

    # --- B2: dense TF + DF --------------------------------------------
    toks, lens = zipf_tokens(rng, N_DOCS, DOC_LEN, DENSE_VOCAB)
    toks_d = torch.from_numpy(toks).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    toks16 = torch.from_numpy(toks.astype(np.uint16)).to(dev)
    for label, kw, tk in (("with_df", {}, toks_d),
                          ("counts_only", {"with_df": False}, toks_d),
                          ("id_offset", {"id_offset": 1024}, toks_d),
                          ("uint16_ids", {}, toks16)):
        v = DENSE_VOCAB // 2 if label == "id_offset" else DENSE_VOCAB
        kc, kd = K.tf_df(tk, lens_d, vocab_size=v, **kw)
        pc, pd = K.tf_df_plain(toks_d, lens_d, vocab_size=v, **kw)
        torch.cuda.synchronize()
        check(torch.equal(kc, pc), f"B2 {label}: counts differ from plain")
        check((kd is None) == (pd is None) and (kd is None or torch.equal(kd, pd)),
              f"B2 {label}: df differs from plain")
        cases.append({"kernel": "tf_df", "case": label,
                      "shape": list(tk.shape), "V": v, "counts_equal": True,
                      "df_equal": True, "max_abs_err": 0})
    live = torch.arange(DOC_LEN, device=dev)[None, :] < lens_d[:, None]
    flat = (torch.arange(N_DOCS, device=dev, dtype=torch.int64)[:, None]
            * DENSE_VOCAB + toks_d)[live]
    # The function reads lengths and the live tokens and writes all of
    # counts [D, V] and df [V]; the kernel alone writes only the cells
    # and df entries this batch touches (the wrapper's fill does the rest).
    counts_ref, df_ref = K.tf_df_plain(toks_d, lens_d, vocab_size=DENSE_VOCAB)
    n_live = int(lens_d.clamp(max=DOC_LEN).sum())
    read_bytes = N_DOCS * 4 + n_live * 4
    b2_bytes = read_bytes + N_DOCS * DENSE_VOCAB * 4 + DENSE_VOCAB * 4
    b2_kernel_bytes = (read_bytes + int((counts_ref > 0).sum()) * 4
                       + int((df_ref > 0).sum()) * 4)
    summary["tf_df"] = {
        **kernel_times(
            "tf_df_kernel",
            lambda: K.tf_df(toks_d, lens_d, vocab_size=DENSE_VOCAB),
            lambda: K.tf_df_plain(toks_d, lens_d, vocab_size=DENSE_VOCAB),
            lambda: torch.bincount(flat, minlength=N_DOCS * DENSE_VOCAB)),
        "library_call": "torch.bincount(d*V + id, minlength=D*V) (counts only)",
        "bound_ms": bound_ms(b2_bytes),
        "kernel_bound_ms": bound_ms(b2_kernel_bytes), "max_abs_err": 0,
        "shape": {"D": N_DOCS, "L": DOC_LEN, "V": DENSE_VOCAB,
                  "live_tokens": n_live}}

    # --- B3: packed result words ---------------------------------------
    special_v = torch.tensor([[0.0, float("nan"), 70000.0, 65504.0, 1e-8, 2.5]],
                             device=dev)
    special_t = torch.tensor([[0, 7, 65535, 3, 9, -1]], dtype=torch.int32,
                             device=dev)
    for label, pv, pt in (("float32", vals, tids),
                          ("bfloat16", vals.to(torch.bfloat16), tids),
                          ("float16", vals.to(torch.float16), tids),
                          ("special_values", special_v, special_t)):
        kw_ = K.pack_words(pv, pt)
        pw_ = K.pack_words_plain(pv, pt)
        torch.cuda.synchronize()
        check(same_bits(kw_, pw_), f"B3 {label}: words differ from plain")
        cases.append({"kernel": "pack_words", "case": label,
                      "shape": list(pv.shape), "words_equal": True,
                      "max_abs_err": 0})
    summary["pack_words"] = {
        **kernel_times("pack_words_kernel",
                       lambda: K.pack_words(vals, tids),
                       lambda: K.pack_words_plain(vals, tids)),
        "bound_ms": bound_ms(vals.numel() * 12),
        "kernel_bound_ms": bound_ms(vals.numel() * 12), "max_abs_err": 0, "shape": {"D": N_DOCS, "K": TOPK}}
    emit({"phase": "kernel_cases", "cases": cases})
    return summary


def path_phase(name, T, K, corpus, cfg, expect, wire_dtype):
    """One main-path run on the card (timed, launches counted) and the
    same run on the CPU; returns the launch counts."""
    from tfidf_tpu_torch.parity import compare_topk
    from tfidf_tpu_torch.utils.timing import PhaseTimer

    timer = PhaseTimer()
    K.reset_launches()
    t0 = time.perf_counter()
    gpu = T.TfidfPipeline(cfg, timer=timer).run(corpus)
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    for kernel in expect:
        check(launches[kernel] > 0, f"{name}: {kernel} never launched")
    cpu = T.TfidfPipeline(cfg, device="cpu").run(corpus)
    check(np.array_equal(gpu.df, cpu.df), f"{name}: df differs from CPU run")
    batch = T.pack_corpus(corpus, cfg)
    cmp = compare_topk(gpu.topk_ids, gpu.topk_vals, cpu.topk_ids,
                       cpu.topk_vals, token_ids=batch.token_ids,
                       lengths=batch.lengths, df=cpu.df,
                       num_docs=batch.num_docs, wire_dtype=wire_dtype)
    check(cmp["ok"], f"{name}: top-k disagrees with CPU run: {cmp}")
    check(gpu.topk_vals.shape == (len(corpus), cfg.topk)
          and np.isfinite(gpu.topk_vals).all(), f"{name}: bad top-k values")
    # Where the device time of one warm run_packed goes (pack excluded).
    pipe = T.TfidfPipeline(cfg)
    events, wall_ms = device_events(lambda: pipe.run_packed(batch))
    by_name = {}
    for ev, ms in events:
        row = by_name.setdefault(ev, [0, 0.0])
        row[0] += 1
        row[1] += ms
    busy = sum(ms for _, ms in events)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    emit({"phase": name, "docs": len(corpus), "L": int(batch.token_ids.shape[1]),
          "vocab": cfg.vocab_size, "engine": cfg.engine, "topk": cfg.topk,
          "phases_s": timer.as_dict(), "wall_s": wall, "launches": launches,
          "vs_cpu": cmp,
          "device_profile": {"run_packed_wall_ms": wall_ms,
                             "device_busy_ms": busy,
                             "idle_share": 1 - busy / wall_ms,
                             "top": [{"name": n[:100], "count": c, "ms": ms}
                                     for n, (c, ms) in top]},
          "ok": True})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device\n")
        return 2
    sys.path.insert(0, REPO)
    import tfidf_tpu_torch as T
    from tfidf_tpu_torch.config import VocabMode
    from tfidf_tpu_torch.golden import golden_output
    from tfidf_tpu_torch.ops import _build, kernels as K

    smi = env_phase(_build.build)
    summary = kernel_phase(K)

    rng = np.random.default_rng(SEED)
    corpus = zipf_corpus(T.Corpus, rng)
    sparse_cfg = T.PipelineConfig(vocab_mode=VocabMode.HASHED,
                                  vocab_size=SPARSE_VOCAB, max_doc_len=DOC_LEN,
                                  doc_chunk=DOC_LEN, topk=TOPK)
    dense_cfg = T.PipelineConfig(vocab_mode=VocabMode.HASHED,
                                 vocab_size=DENSE_VOCAB, max_doc_len=DOC_LEN,
                                 doc_chunk=DOC_LEN, topk=TOPK, engine="dense")
    check(sparse_cfg.engine == "sparse", "hashed default engine is sparse")
    total = {name: 0 for name in K.LAUNCHES}
    for name, cfg, expect in (
            ("path_sparse_topk", sparse_cfg, ("fused_score_topk", "pack_words")),
            ("path_dense_topk", dense_cfg, ("tf_df", "pack_words"))):
        got = path_phase(name, T, K, corpus, cfg, expect, np.float16)
        for kernel, n in got.items():
            total[kernel] += n

    gold = golden_corpus(T.Corpus, rng)
    K.reset_launches()
    out = T.TfidfPipeline(T.PipelineConfig.golden()).run(gold).output_bytes()
    launches = dict(K.LAUNCHES)
    check(launches["tf_df"] > 0, "path_golden: tf_df never launched")
    for kernel, n in launches.items():
        total[kernel] += n
    want = golden_output(gold)
    check(out == want, "path_golden: output bytes differ from golden_output")
    cpu_out = T.TfidfPipeline(T.PipelineConfig.golden(),
                              device="cpu").run(gold).output_bytes()
    check(out == cpu_out, "path_golden: output bytes differ from CPU run")
    emit({"phase": "path_golden", "docs": len(gold), "lines": out.count(b"\n"),
          "bytes": len(out), "launches": launches, "golden_equal": True,
          "cpu_equal": True, "ok": True})

    sources = {"fused_score_topk": ("tfidf_tpu_torch/csrc/score_topk.cu",
                                    "tfidf_tpu/ops/pallas_kernels.py:465"),
               "tf_df": ("tfidf_tpu_torch/csrc/tf_df.cu",
                         "tfidf_tpu/ops/pallas_kernels.py:103"),
               "pack_words": ("tfidf_tpu_torch/csrc/pack_words.cu",
                              "tfidf_tpu/ops/pallas_kernels.py:281")}
    rows = []
    for kernel, (src, replaces) in sources.items():
        s = summary[kernel]
        rows.append({"name": kernel, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": total[kernel],
                     "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                     "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                     "bound_by": "bytes", "library_ms": s["library_ms"],
                     "kernel_ms": s["kernel_ms"],
                     "kernel_bound_ms": s["kernel_bound_ms"],
                     "call_ms": s["call_ms"], "shape": s["shape"]})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
