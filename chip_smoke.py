#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tfidf_tpu_torch``) on one GPU and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. ``env``: torch/CUDA versions, the card and its power limit; builds the
   CUDA kernels from ``tfidf_tpu_torch/csrc`` with nvcc (sm_90a).
2. ``kernel_cases``: every kernel at the main path's shapes, on the card,
   against its plain PyTorch version on the same inputs (float32,
   bfloat16 and float16 scores): ints, ids and words exact, scores
   bit-equal. B1 also runs k = 1 and 64, a tie-heavy batch (one idf for
   every term; rows whose head slots all score the same, rows with
   exactly k, k - 1 or 5 head slots, rows with none) and rows of 16,384
   slots (Zipf rows, and uniform rows with more head slots than a warp's
   shared-memory list, which take the rescoring path); its yardstick is
   ``torch.topk`` of a precomputed ``sparse_scores`` block (the selection
   half only). The ragged-rebuild (B4) and tokenize+hash (B5) cases run
   one 32,768-doc chunk of the Zipf corpus at L = 256: B4 on uint16 and
   int32 flat streams at granules 1, 2, 4, 8, 16 and 32, and at G 4 and
   16 with L = 250, rows of length 0 and below 0, D = 1 and a stream at
   an odd address (the scalar path); B5 on the uint8 slab and its int32
   upcast, with and without ``truncate_at``, a multi-byte UTF-8 slab
   with non-zero seeds, vocabularies 65,521 and 3, a slab that ends
   inside a 35-byte token (its length not a multiple of 16) and the slab
   at an odd address (the byte-at-a-time walk). Both equal their plain
   versions on the whole [D, L], and B5 equals the host packer's ids in
   every case. Beside B4, the torch chain of ``granule_offsets`` that
   its offset scan replaced and the rebuild launch alone; beside B5,
   ``token_starts``, the bytes wire's other device work.
   Times are medians of 20 calls after a warm-up, each the device span
   of one call: CUDA events around it while a sleep kernel holds the
   stream, so the host's launch latency is not counted. ``ms`` is one
   wrapper call (its output fills included), ``kernel_ms`` the kernel's
   launch alone (the same call where the wrapper does nothing else on
   the device), ``plain_ms`` the plain version and ``library_ms`` the
   one PyTorch call that computes the same function, where there is
   one. ``call_ms`` is the wrapper's latency with the host launch
   included. ``bound_ms`` is the least time for the bytes (or, for B5,
   the operations) the function needs at this run's data;
   ``kernel_bound_ms`` the same for the kernel alone.
3. ``path_sparse_topk``: ``TfidfPipeline.run`` on 32,768 Zipf documents,
   hashed vocab 2^16, top-16 (the sparse engine), against the same run on
   the CPU; asserts the score+top-k and pack kernels launched; profiles
   the device time of one warm ``run_packed`` (torch.profiler; a profile
   with no device activity fails the run).
4. ``path_dense_topk``: the same corpus on the dense engine, vocab 4,096,
   top-16; asserts the TF/DF and pack kernels launched.
5. ``path_golden``: a 64-doc corpus inside the reference's envelope on the
   golden EXACT config; ``output.txt`` bytes equal the golden oracle's
   and the CPU run's.
6. ``path_ragged_batch``: the 32,768-doc corpus as a ``RaggedBatch``
   through ``TfidfPipeline.run_packed``: B4 launches and the result
   equals the ``PackedBatch`` run's.
7. ``path_ingest_resident``: 131,072 Zipf documents written to a
   temporary directory, through ``ingest.run_overlapped`` at doc_len 256,
   4 chunks of 32,768, hashed 2^16, top-16, packed wire, scan finish,
   once per wire (ragged, bytes, padded): the native loader ran, B4 / B5 /
   B1 / B3 launched, the three wires give identical words, df and
   lengths, the ragged run equals the port's CPU run (``compare_topk``)
   and ``TfidfPipeline.run`` on the same documents. Prints warm wall,
   docs/s, phases and the result's fields per wire, and a device
   profile of one warm ragged run.
8. ``path_ingest_streaming``: the 32,768-doc corpus in the streaming
   regime (``TFIDF_TPU_RESIDENT_ELEMS`` below it, 4 chunks of 8,192, the
   triple cache sized for 2 of them), spill host and reread, ragged and
   bytes wires: words, df and lengths equal the resident run's.
9. ``path_retrieval``: ``TfidfRetriever(cfg).index_dir`` on the 131,072
   ingest documents (doc_len 256, 16 chunks of 8,192, ragged wire: B4),
   then searches of 256 Zipf queries at Q = 1, 64 and 256, k = 10, under
   tfidf, bm25, bm25:k1=1.5,b=0.6 and an id_range filter: B6 launches
   once per 4,096-row tile per search. Tiled = untiled and tile width
   1,024 = 4,096 bit for bit; the first 64 rows of a Q = 256 search
   equal the Q = 64 search; a snapshot restored on the CPU and an
   8,192-doc index built on both devices agree with the card
   (``compare_search``). Prints index seconds, warm search latency and
   qps, the host time of ``fill_query_matrix`` and a device profile of
   one warm Q = 64 search.
10. ``kernel_cases_b6``: B6 on real tiles of that index (4,096 rows,
   L = 256, V = 2^16) at Q = 1, 3, 16, 17, 32, 33, 64, 100, 128, 256,
   257 and 512 on the tfidf face and 64 and 256 on bm25, a ragged tile,
   all-dead rows and a row whose every slot is live, each bit-equal to
   the plain version over the whole output; its times (tfidf Q 64, 256,
   1 and 512, bm25 Q 64 and 256) against ``torch.sparse.mm`` of the tile
   as a CSR matrix (built outside the timed span).

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
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
# int32 multiply-adds per second: 64 INT32 lanes per SM (half the 128
# FP32 lanes behind the data sheet's 67 TFLOP/s) x 132 SMs x 1.98 GHz.
INT32_MAD_PER_S = 132 * 64 * 1.98e9
SEED = 42
N_DOCS = 32768
DOC_LEN = 256
N_WORDS = 8192
TOPK = 16
SPARSE_VOCAB = 1 << 16
DENSE_VOCAB = 4096
INGEST_DOCS = 4 * N_DOCS  # path_ingest_resident: 4 chunks of N_DOCS
STREAM_CHUNK = 8192       # path_ingest_streaming: 4 chunks of N_DOCS
RETR_CHUNK = 8192         # path_retrieval: 16 chunks of the ingest corpus
RETR_TILE = 4096          # the default doc tile (TFIDF_TPU_QUERY_BLOCK)
RETR_K = 10
RETR_QUERIES = 256
RETR_SMALL = 8192         # path_retrieval: the index built on both devices
# kernel_cases_b6: Q held bit-equal on the tfidf face, and Q timed per face
B6_CHECKED_Q = (1, 3, 16, 17, 32, 33, 64, 100, 128, 256, 257, 512)
B6_TIMED_Q = {"tfidf": (64, RETR_QUERIES, 1, 512), "bm25": (64, RETR_QUERIES)}
# FP32 fused multiply-adds per second: the data sheet's 67 TFLOP/s of
# float32 outside the tensor cores, two operations per FMA.
FP32_FMA_PER_S = 67e12 / 2


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


def device_span_ms(fn, reps: int = 20, warmup: int = 3, setup=None) -> float:
    """Median device milliseconds of one ``fn()`` call, from its first
    device operation to the end of its last: a sleep kernel holds the
    stream while the host enqueues the start event, the call and the end
    event, so the host's launch latency is not counted. ``setup()``, if
    given, runs before each call, outside the timed span."""
    for _ in range(warmup):
        if setup:
            setup()
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if setup:
            setup()
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_events(fn):
    """Device activity of one ``fn()`` call (after one warm-up call),
    from torch.profiler: ``(name, ms)`` per kernel, copy or memset, plus
    the wall milliseconds of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [(e.name, e.time_range.elapsed_us() / 1e3)
              for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(bool(events), "the profiler recorded no device activity")
    return events, wall_ms


def kernel_times(call, plain, library=None, kernel_only=None,
                 kernel_setup=None) -> dict:
    """Device time of one wrapper call (``ms``), of its kernel launch
    alone (``kernel_only``, after ``kernel_setup`` outside the span; by
    default the call itself, for wrappers whose only device work is the
    launch), of the plain version and of the library call, and the
    call's latency from the host."""
    ms = device_span_ms(call)
    k_ms = device_span_ms(kernel_only, setup=kernel_setup) if kernel_only else ms
    return {"ms": ms, "kernel_ms": k_ms,
            "call_ms": time_ms(call), "plain_ms": device_span_ms(plain),
            "library_ms": device_span_ms(library) if library else None}


def profile_summary(fn, top_n: int = 12) -> dict:
    """Where the device time of one warm ``fn()`` goes: top device
    operations and the idle share of the window."""
    events, wall_ms = device_events(fn)
    by_name = {}
    for ev, ms in events:
        row = by_name.setdefault(ev, [0, 0.0])
        row[0] += 1
        row[1] += ms
    busy = sum(ms for _, ms in events)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top_n]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms,
            "top": [{"name": n[:100], "count": c, "ms": ms}
                    for n, (c, ms) in top]}


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


def zipf_docs(rng, n_docs: int):
    """``n_docs`` docs of words w0..w8191: Zipf(1.3) word ranks and
    Zipf-shaped lengths up to DOC_LEN (bench.py's corpus shape)."""
    words = np.array([f"w{i}".encode() for i in range(N_WORDS)], dtype=object)
    ranks = np.clip(rng.zipf(1.3, n_docs * DOC_LEN), 1, N_WORDS) - 1
    lens = np.maximum(DOC_LEN // np.clip(rng.zipf(1.3, n_docs), 1, DOC_LEN), 1)
    offs = np.concatenate([[0], np.cumsum(lens)])
    return [b" ".join(words[ranks[offs[i]:offs[i + 1]]]) for i in range(n_docs)]


def zipf_corpus(Corpus, rng, n_docs: int = N_DOCS):
    """The paths' corpus: :func:`zipf_docs` named doc1..docN."""
    return Corpus(names=[f"doc{i}" for i in range(1, n_docs + 1)],
                  docs=zipf_docs(rng, n_docs))


def utf8_docs(rng, n_docs: int):
    """Docs of multi-byte UTF-8 and ASCII words with every separator
    byte of the whitespace set."""
    pool = ["héllo", "wörld", "中文", "éé", "naïve", "Ωmega", "日本語テキスト",
            "emoji😀", "a", "supercalifragilisticexpialidocious", "x1", "ß"]
    seps = [" ", "\t", "\n", "\r\n", "  ", "\x0b", "\x0c"]
    docs = []
    for _ in range(n_docs):
        n = int(rng.integers(0, 40))
        parts = []
        for w, s in zip(rng.integers(0, len(pool), n),
                        rng.integers(0, len(seps), n)):
            parts += [pool[w], seps[s]]
        docs.append("".join(parts).encode())
    return docs


def write_corpus(root: str, docs) -> str:
    """Write docs as doc1..docN under ``root`` (8 writer threads);
    returns ``root``."""
    import concurrent.futures as cf

    def write(i):
        with open(os.path.join(root, f"doc{i + 1}"), "wb") as f:
            f.write(docs[i])

    with cf.ThreadPoolExecutor(max_workers=8) as ex:
        list(ex.map(write, range(len(docs))))
    return root


def build_slab(docs, align: int, pad_to: int):
    """The bytes wire's slab (ops/device_tokenize.py's layout): doc bytes
    at aligned offsets, 0x20 fill, capacity a ``pad_to`` multiple."""
    from tfidf_tpu_torch.ops.device_tokenize import aligned_byte_lengths
    blens = np.array([len(d) for d in docs], np.int32)
    albl = aligned_byte_lengths(blens, align)
    total = int(albl.sum())
    slab = np.full(max(total + (-total % pad_to), pad_to), 0x20, np.uint8)
    offs = np.concatenate([[0], np.cumsum(albl)[:-1]])
    for doc, off in zip(docs, offs.tolist()):
        slab[off:off + len(doc)] = np.frombuffer(doc, np.uint8)
    return slab, blens


def golden_corpus(Corpus, rng):
    """64 docs inside the reference's envelope: tokens under 16 bytes."""
    vocab = [f"t{i}".encode() for i in range(300)] + [b"common"]
    docs = []
    for _ in range(64):
        n = int(rng.integers(1, 200))
        toks = [vocab[i] for i in rng.integers(0, len(vocab), n)] + [b"common"]
        docs.append(b" ".join(toks) + b"\n")
    return Corpus(names=[f"doc{i}" for i in range(1, 65)], docs=docs)


def env_phase(_build):
    """Builds the CUDA kernels (nvcc) and the host loader library (g++)
    at the same time."""
    import concurrent.futures as cf
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"compute capability {cap} is not Hopper (9, 0)")
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(max_workers=1) as ex:
        host = ex.submit(_build.build_host)
        built = _build.build()
        host_built = host.result()
    sys.stderr.write(built["log"] + "\n" + host_built["log"] + "\n")
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "capability": list(cap),
          "nvidia_smi": smi, "build_s": built["seconds"],
          "host_build_s": host_built["seconds"],
          "builds_wall_s": time.perf_counter() - t0,
          "library": os.path.relpath(built["path"], REPO),
          "host_library": os.path.relpath(host_built["path"], REPO)})
    return smi


def kernel_phase(K):
    """Each kernel against its plain version at the main path's shapes."""
    from tfidf_tpu_torch.ops.scoring import idf_from_df
    from tfidf_tpu_torch.ops.sparse import (sorted_term_counts, sparse_df,
                                            sparse_scores)

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

    def b1_case(label, ids, counts, head, lens_d, idf, k=TOPK):
        kv, kt = K.fused_score_topk(ids, counts, head, lens_d, idf, k=k)
        pv, pt = K.fused_score_topk_plain(ids, counts, head, lens_d, idf, k=k)
        torch.cuda.synchronize()
        check(torch.equal(kt, pt), f"B1 {label}: ids differ from plain")
        check(same_bits(kv, pv), f"B1 {label}: scores not bit-equal to plain")
        err = (kv.float() - pv.float()).abs().max().item()
        n_head = head.sum(dim=1)
        cases.append({"kernel": "fused_score_topk", "case": label,
                      "shape": list(ids.shape), "k": k, "ids_equal": True,
                      "scores_bit_equal": True, "max_abs_err": err,
                      "head_slots_per_row": {
                          "max": int(n_head.max()),
                          "rows_over_32": int((n_head > 32).sum()),
                          "rows_none": int((n_head == 0).sum())}})
        return kv, kt, err

    vals, tids, err = b1_case("float32", ids, counts, head, lens_d, idf)
    b1_case("bfloat16", ids, counts, head, lens_d, idf.to(torch.bfloat16))
    b1_case("float16", ids, counts, head, lens_d, idf.to(torch.float16))
    for k in (1, 64):
        b1_case(f"float32_k{k}", ids, counts, head, lens_d, idf, k=k)
    b1_case("bfloat16_k64", ids, counts, head, lens_d,
            idf.to(torch.bfloat16), k=64)
    # Ties: one idf for every term, and rows whose head slots all score
    # the same (every term twice), hold exactly k or k - 1 or 5 terms, or
    # none (length 0); the other rows keep their Zipf tokens.
    tt = toks_d[:4096].clone()
    tl = lens_d[:4096].clone()
    kinds = torch.arange(4096, device=dev) % 6
    pairs = torch.arange(DOC_LEN, device=dev, dtype=torch.int32) // 2
    for kind, n_terms in ((0, DOC_LEN // 2), (1, TOPK), (2, TOPK - 1),
                          (3, 5)):
        sel = kinds == kind
        tt[sel] = (pairs % n_terms)[None, :]
        tl[sel] = DOC_LEN if kind == 0 else 2 * n_terms
    tl[kinds == 4] = 0
    ti, tc, th = sorted_term_counts(tt, tl)
    flat_idf = torch.full((SPARSE_VOCAB,), 1.5, device=dev)
    for k in (1, TOPK, 64):
        b1_case(f"tie_heavy_k{k}", ti, tc, th, tl, flat_idf, k=k)
    b1_case("tie_heavy_float16", ti, tc, th, tl, flat_idf.half())
    # Rows too long for shared memory. Zipf rows mostly fit the warp's
    # list (2,048 slots); uniform ids over 2^16 give more head slots than
    # that, so those rows take the kernel's rescoring path.
    ltoks, llens = zipf_tokens(rng, 64, 16384, SPARSE_VOCAB)
    lt, lc, lh = sorted_term_counts(torch.from_numpy(ltoks).to(dev),
                                    torch.from_numpy(llens).to(dev))
    b1_case("long_rows", lt, lc, lh, torch.from_numpy(llens).to(dev), idf)
    utoks = torch.from_numpy(rng.integers(0, SPARSE_VOCAB, (64, 16384))
                             .astype(np.int32)).to(dev)
    ulens = torch.full((64,), 16384, dtype=torch.int32, device=dev)
    ulens[::2] = 3000
    ut, uc, uh = sorted_term_counts(utoks, ulens)
    b1_case("long_rows_uniform", ut, uc, uh, ulens, idf)
    d, length = ids.shape
    # What this batch needs: lengths, head at every slot (it alone says
    # which slots score), ids and counts at head slots only, idf at the
    # distinct ids they name, and the picks written.
    n_head = int(head.sum())
    n_idf = int(torch.unique(ids[head]).numel())
    b1_bytes = (d * 4 + d * length + n_head * (4 + 4) + n_idf * 4
                + d * TOPK * (4 + 4))
    block = sparse_scores(ids, counts, head, lens_d, idf)
    no_head = torch.zeros_like(head)
    # Where B1's time goes: fewer or more selection rounds, and the floor
    # of a batch with no head slot (reads head and lengths, writes picks).
    b1_parts = {f"kernel_ms_k{k}": device_span_ms(
        lambda k=k: K.fused_score_topk(ids, counts, head, lens_d, idf, k=k))
        for k in (1, 64)}
    b1_parts["kernel_ms_no_head_slots"] = device_span_ms(
        lambda: K.fused_score_topk(ids, counts, no_head, lens_d, idf, k=TOPK))
    summary["fused_score_topk"] = {
        **b1_parts, "rows_over_32_head_slots": int((head.sum(1) > 32).sum()),
        **kernel_times(
            lambda: K.fused_score_topk(ids, counts, head, lens_d, idf, k=TOPK),
            lambda: K.fused_score_topk_plain(ids, counts, head, lens_d, idf,
                                             k=TOPK)),
        "yardstick_ms": device_span_ms(lambda: torch.topk(block, TOPK, dim=1)),
        "yardstick_call": "torch.topk(sparse_scores block [D, L], 16, dim=1): "
                          "selection half only, not the same function",
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
    counts_buf = torch.zeros_like(counts_ref)
    df_buf = torch.zeros_like(df_ref)
    summary["tf_df"] = {
        **kernel_times(
            lambda: K.tf_df(toks_d, lens_d, vocab_size=DENSE_VOCAB),
            lambda: K.tf_df_plain(toks_d, lens_d, vocab_size=DENSE_VOCAB),
            lambda: torch.bincount(flat, minlength=N_DOCS * DENSE_VOCAB),
            # The kernel adds into zeroed outputs: a count it finds at 0
            # is a first occurrence and adds to df.
            kernel_only=lambda: K.tf_df_launch(toks_d, lens_d, counts_buf,
                                               df_buf),
            kernel_setup=lambda: (counts_buf.zero_(), df_buf.zero_())),
        "library_call": "torch.bincount(d*V + id, minlength=D*V) (counts only)",
        "bound_ms": bound_ms(b2_bytes),
        "kernel_bound_ms": bound_ms(b2_kernel_bytes), "max_abs_err": 0,
        "shape": {"D": N_DOCS, "L": DOC_LEN, "V": DENSE_VOCAB,
                  "live_tokens": n_live}}
    torch.cuda.synchronize()
    check(torch.equal(counts_buf, counts_ref) and torch.equal(df_buf, df_ref),
          "B2: the timed launch's output differs from plain")

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
        **kernel_times(lambda: K.pack_words(vals, tids),
                       lambda: K.pack_words_plain(vals, tids)),
        "bound_ms": bound_ms(vals.numel() * 12),
        "kernel_bound_ms": bound_ms(vals.numel() * 12), "max_abs_err": 0, "shape": {"D": N_DOCS, "K": TOPK}}
    ingest_kernel_cases(K, summary, cases)
    emit({"phase": "kernel_cases", "cases": cases})
    return summary


def ingest_kernel_cases(K, summary, cases):
    """B4 and B5 at the ingest path's shapes: one 32,768-doc chunk of
    the Zipf corpus at L = 256, G = 16 (the wire's default granule)."""
    import tfidf_tpu_torch as T
    from tfidf_tpu_torch.ingest import flatten_aligned
    from tfidf_tpu_torch.ops.device_tokenize import (aligned_byte_lengths,
                                                     token_starts)

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    docs = zipf_docs(rng, N_DOCS)
    cfg = T.PipelineConfig(vocab_mode=T.VocabMode.HASHED,
                           vocab_size=SPARSE_VOCAB, max_doc_len=DOC_LEN,
                           doc_chunk=DOC_LEN, topk=TOPK)
    batch = T.pack_corpus(T.Corpus(names=[""] * N_DOCS, docs=docs), cfg,
                          want_words=False)
    lens_d = torch.from_numpy(batch.lengths).to(dev)

    # --- B4: ragged rebuild -------------------------------------------
    live = torch.arange(DOC_LEN, device=dev)[None, :] < lens_d[:, None]

    def b4_case(label, flat_d, lens, length, align, packed=None):
        """The kernel equals its plain version over the whole [D, L]
        (padding slots included) and, given the packed batch, its live
        ids."""
        got = K.ragged_rebuild(flat_d, lens, length=length, align=align)
        want = K.ragged_rebuild_plain(flat_d, lens, length=length, align=align)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"B4 {label}: differs from plain")
        if packed is not None:
            check(torch.equal(torch.where(live, got, 0).cpu(), packed),
                  f"B4 {label}: live ids differ from the packed batch")
        p = K.ragged_rebuild_plan(got.shape[0], length, align,
                                  itemsize=flat_d.element_size(),
                                  flat_align=K._alignment(flat_d),
                                  out_align=K._alignment(got))
        cases.append({"kernel": "ragged_rebuild", "case": label,
                      "shape": list(got.shape), "flat_ids": flat_d.numel(),
                      "group": p["group"], "whole_output_equal": True,
                      "max_abs_err": 0})

    packed_ids = torch.from_numpy(batch.token_ids)
    flats = {}
    for dtype in (np.uint16, np.int32):
        for align in (1, 2, 4, 8, 16, 32):
            flat, total = flatten_aligned(batch.token_ids, batch.lengths,
                                          align, dtype=dtype)
            flat_d = torch.from_numpy(flat).to(dev)
            flats[dtype, align] = (flat_d, total)
            b4_case(f"{np.dtype(dtype).name}_G{align}", flat_d, lens_d,
                    DOC_LEN, align, packed_ids)
    # The edges: L not a multiple of 4 (the scalar path), rows of length
    # 0 and below 0, one row, and a stream that is not 8-byte aligned.
    edge_lens = lens_d.clone()
    edge_lens[::7] = 0
    edge_lens[3::7] = -5
    for dtype in (np.uint16, np.int32):
        name = np.dtype(dtype).name
        for align in (4, 16):
            flat_d, _ = flats[dtype, align]
            b4_case(f"{name}_G{align}_L250", flat_d, lens_d, 250, align)
            b4_case(f"{name}_G{align}_zero_and_negative_lengths", flat_d,
                    edge_lens, DOC_LEN, align)
            b4_case(f"{name}_G{align}_D1", flat_d, lens_d[:1].contiguous(),
                    DOC_LEN, align)
            shifted = torch.empty(flat_d.numel() + 1, dtype=flat_d.dtype,
                                  device=dev)[1:]
            shifted.copy_(flat_d)
            b4_case(f"{name}_G{align}_flat_at_odd_offset", shifted, lens_d,
                    DOC_LEN, align, packed_ids)
    flat16, total16 = flats[np.uint16, 16]
    flat32, _ = flats[np.int32, 16]
    gran = K.granule_offsets(lens_d, 16)[:, None] \
        + torch.arange(DOC_LEN, device=dev)[None, :] // 16
    index = (gran.clamp_max(flat32.numel() // 16 - 1) * 16
             + torch.arange(DOC_LEN, device=dev)[None, :] % 16).long()
    check(torch.equal(flat32[index],
                      K.ragged_rebuild(flat32, lens_d, length=DOC_LEN,
                                       align=16)),
          "B4: the library gather differs from the kernel")
    plan16 = K.ragged_rebuild_plan(N_DOCS, DOC_LEN, 16, itemsize=2)
    scratch16 = torch.empty(plan16["scratch"], dtype=torch.int32, device=dev)
    # the scan's scratch as the offsets of granule_offsets would fill it:
    # the whole offset per row, zero tile totals
    given16 = torch.zeros_like(scratch16)
    given16[:N_DOCS] = K.granule_offsets(lens_d, 16)
    out16 = torch.empty((N_DOCS, DOC_LEN), dtype=torch.int32, device=dev)
    # Read once: the live aligned ids and lengths; written: [D, L] int32.
    b4_bytes = total16 * 2 + N_DOCS * 4 + N_DOCS * DOC_LEN * 4
    summary["ragged_rebuild"] = {
        **kernel_times(
            lambda: K.ragged_rebuild(flat16, lens_d, length=DOC_LEN, align=16),
            lambda: K.ragged_rebuild_plain(flat16, lens_d, length=DOC_LEN,
                                           align=16),
            lambda: flat32[index],
            # every launch of the call: the offset scan, then the rebuild
            kernel_only=lambda: K.ragged_rebuild_launch(
                flat16, lens_d, out16, align=16, scratch=scratch16)),
        # the rebuild launch alone, from the offsets computed beforehand
        "rebuild_only_ms": device_span_ms(lambda: K.ragged_rebuild_launch(
            flat16, lens_d, out16, align=16, scratch=given16, scan=False)),
        # the ragged wire's other device work: the torch chain the offset
        # scan replaced (the plain version's helper)
        "granule_offsets_chain_ms": device_span_ms(
            lambda: K.granule_offsets(lens_d, 16)),
        "library_call": "flat[index] (advanced-indexing gather of the int32 "
                        "flat stream by a precomputed [D, L] int64 index; "
                        "the gather cannot widen uint16 in the same call)",
        "bound_ms": bound_ms(b4_bytes), "bound_by": "bytes",
        "kernel_bound_ms": bound_ms(b4_bytes), "max_abs_err": 0,
        "shape": {"D": N_DOCS, "L": DOC_LEN, "G": 16, "flat": "uint16",
                  "live_aligned_ids": total16}}
    torch.cuda.synchronize()
    want16 = K.ragged_rebuild_plain(flat16, lens_d, length=DOC_LEN, align=16)
    check(torch.equal(out16, want16),
          "B4: the timed launch's output differs from plain")

    # --- B5: tokenize + hash --------------------------------------------
    slab, blens = build_slab(docs, 16, 1 << 17)
    slab_d = torch.from_numpy(slab).to(dev)
    blens_d = torch.from_numpy(blens).to(dev)
    starts, _, t_lens, _ = token_starts(slab_d, blens_d, length=DOC_LEN,
                                        align=16)
    check(torch.equal(t_lens.cpu(), torch.from_numpy(batch.lengths)),
          "B5: device token lengths differ from the host packer's")
    u_docs = utf8_docs(rng, 2048)
    u_slab, u_blens = build_slab(u_docs, 16, 1 << 17)
    u_slab_d = torch.from_numpy(u_slab).to(dev)
    u_starts, _, u_lens, _ = token_starts(
        u_slab_d, torch.from_numpy(u_blens).to(dev), length=DOC_LEN, align=16)
    # A slab that ends inside its last token (a 34-byte one, longer than
    # two windows), its length not a multiple of 16.
    c_docs = u_docs[:511] + [("x " * 9 + "y" + "é" * 16 + "zz").encode()]
    c_slab, c_blens = build_slab(c_docs, 16, 16)
    c_n = int(aligned_byte_lengths(c_blens, 16)[:-1].sum()) + len(c_docs[-1])
    check(c_n % 16 != 0 and c_slab[c_n - 1] != 0x20,
          "B5: the cut slab does not end inside a token")
    c_slab_d = torch.from_numpy(c_slab[:c_n].copy()).to(dev)
    c_starts, _, c_lens, _ = token_starts(
        c_slab_d, torch.from_numpy(c_blens).to(dev), length=DOC_LEN, align=16)
    # The main slab at an odd address: the byte-at-a-time walk.
    odd = torch.empty(slab_d.numel() + 1, dtype=torch.uint8, device=dev)[1:]
    odd.copy_(slab_d)

    def host_ids(docs_, **cfg_kw):
        """The host packer's ids for ``docs_`` under ``cfg_kw``."""
        c = T.PipelineConfig(**{**dict(
            vocab_mode=T.VocabMode.HASHED, vocab_size=SPARSE_VOCAB,
            max_doc_len=DOC_LEN, doc_chunk=DOC_LEN, topk=TOPK), **cfg_kw})
        b = T.pack_corpus(T.Corpus(names=[""] * len(docs_), docs=docs_), c,
                          want_words=False)
        return torch.from_numpy(b.token_ids)

    main_ids = torch.from_numpy(batch.token_ids)
    # label: (slab, starts, lengths, vocab, seed, truncate_at, host ids)
    b5_inputs = {
        "uint8": (slab_d, starts, t_lens, SPARSE_VOCAB, 0, 0, main_ids),
        "int32_slab": (slab_d.to(torch.int32), starts, t_lens, SPARSE_VOCAB,
                       0, 0, main_ids),
        "truncate_3": (slab_d, starts, t_lens, SPARSE_VOCAB, 0, 3,
                       host_ids(docs, truncate_tokens_at=3)),
        "utf8_seed_truncate_16": (
            u_slab_d, u_starts, u_lens, SPARSE_VOCAB, 0xDEADBEEF12345678, 16,
            host_ids(u_docs, hash_seed=0xDEADBEEF12345678,
                     truncate_tokens_at=16)),
        "utf8_seed": (u_slab_d, u_starts, u_lens, SPARSE_VOCAB, 7, 0,
                      host_ids(u_docs, hash_seed=7)),
        "vocab_65521": (slab_d, starts, t_lens, 65521, 0, 0,
                        host_ids(docs, vocab_size=65521)),
        "vocab_3": (slab_d, starts, t_lens, 3, 0, 0,
                    host_ids(docs, vocab_size=3)),
        "slab_ends_in_token": (c_slab_d, c_starts, c_lens, SPARSE_VOCAB, 0, 0,
                               host_ids(c_docs)),
        "slab_at_odd_offset": (odd, starts, t_lens, SPARSE_VOCAB, 0, 0,
                               main_ids)}
    for label, (sl, st, ln, vocab, seed, trunc, host) in b5_inputs.items():
        got = K.tokenize_hash(sl, st, ln, vocab_size=vocab, seed=seed,
                              truncate_at=trunc)
        want = K.tokenize_hash_plain(sl, st, ln, vocab_size=vocab,
                                     seed=seed, truncate_at=trunc)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"B5 {label}: differs from plain")
        check(torch.equal(got.cpu(), host),
              f"B5 {label}: ids differ from the host packer's")
        p = K.tokenize_hash_plan(st.shape[0], st.shape[1],
                                 slab_align=K._alignment(sl))
        cases.append({"kernel": "tokenize_hash", "case": label,
                      "shape": list(st.shape), "slab_bytes": sl.numel(),
                      "vocab": vocab, "word_windows": p["vec"],
                      "whole_output_equal": True,
                      "host_packer_equal": True, "max_abs_err": 0})
    live_tokens = int(batch.lengths.sum())
    hashed_bytes = sum(sum(map(len, d.split()[:DOC_LEN])) for d in docs)
    # Read once: the slab, lengths and the starts of live slots only (a
    # dead slot's id is 0 from lengths alone); written: [D, L] int32.
    b5_bytes = slab.size + live_tokens * 4 + N_DOCS * 4 + N_DOCS * DOC_LEN * 4
    # Per hashed byte, one 64-bit multiply by the FNV prime: about three
    # 32-bit multiply-adds; per live token, the fold's 64-bit remainder,
    # counted as four.
    b5_mads = 3 * hashed_bytes + 4 * live_tokens
    b5_bytes_ms = bound_ms(b5_bytes)
    b5_ops_ms = b5_mads / INT32_MAD_PER_S * 1e3
    summary["tokenize_hash"] = {
        **kernel_times(
            lambda: K.tokenize_hash(slab_d, starts, t_lens,
                                    vocab_size=SPARSE_VOCAB),
            lambda: K.tokenize_hash_plain(slab_d, starts, t_lens,
                                          vocab_size=SPARSE_VOCAB)),
        # the bytes wire's other device work: the token starts B5 reads
        "token_starts_ms": device_span_ms(lambda: token_starts(
            slab_d, blens_d, length=DOC_LEN, align=16)),
        "library_call": None,
        "bound_ms": max(b5_bytes_ms, b5_ops_ms),
        "bound_by": "bytes" if b5_bytes_ms >= b5_ops_ms else "operations",
        "bytes_bound_ms": b5_bytes_ms, "operations_bound_ms": b5_ops_ms,
        "kernel_bound_ms": max(b5_bytes_ms, b5_ops_ms), "max_abs_err": 0,
        "shape": {"D": N_DOCS, "L": DOC_LEN, "slab_bytes": int(slab.size),
                  "live_tokens": live_tokens, "hashed_bytes": hashed_bytes,
                  "int32_mads": b5_mads}}


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
    prof = profile_summary(lambda: pipe.run_packed(batch))
    emit({"phase": name, "docs": len(corpus), "L": int(batch.token_ids.shape[1]),
          "vocab": cfg.vocab_size, "engine": cfg.engine, "topk": cfg.topk,
          "phases_s": timer.as_dict(), "wall_s": wall, "launches": launches,
          "vs_cpu": cmp, "device_profile": prof,
          "ok": True})
    return launches


def _result_fields(r) -> dict:
    return {f: getattr(r, f) for f in (
        "path", "wire", "result_wire", "finish", "n_finish_dispatches",
        "bytes_on_wire", "bytes_on_wire_padded", "bytes_off_wire",
        "bytes_off_wire_pair", "df_occupied", "num_docs")}


def _same_result(a, b) -> bool:
    """Identical words: ids and the 16-bit score bits, df and lengths."""
    return (np.array_equal(a.topk_ids, b.topk_ids)
            and np.array_equal(np.asarray(a.topk_vals, np.float16).view(np.uint16),
                               np.asarray(b.topk_vals, np.float16).view(np.uint16))
            and np.array_equal(a.df, b.df)
            and np.array_equal(a.lengths, b.lengths))


def _counted_run(K, FT, fn):
    """One main-path run with every kernel and native-packer count zeroed
    just before it; returns (result, wall seconds, kernel launches,
    native packer calls)."""
    K.reset_launches()
    for name in FT.NATIVE_CALLS:
        FT.NATIVE_CALLS[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return r, wall, dict(K.LAUNCHES), dict(FT.NATIVE_CALLS)


def path_ragged_batch(T, K, corpus, cfg, total):
    """A RaggedBatch through run_packed equals the PackedBatch run."""
    from tfidf_tpu_torch.io.corpus import pack_ragged
    pipe = T.TfidfPipeline(cfg)
    padded = pipe.run_packed(T.pack_corpus(corpus, cfg))
    rb = pack_ragged(corpus, cfg)
    K.reset_launches()
    ragged = pipe.run_packed(rb)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    for kernel, n in launches.items():
        total[kernel] += n
    check(launches["ragged_rebuild"] > 0, "path_ragged_batch: B4 never launched")
    check(np.array_equal(ragged.df, padded.df)
          and np.array_equal(ragged.topk_ids, padded.topk_ids)
          and np.array_equal(ragged.topk_vals, padded.topk_vals),
          "path_ragged_batch: RaggedBatch result differs from PackedBatch")
    emit({"phase": "path_ragged_batch", "docs": len(corpus),
          "flat_ids": int(rb.flat.size), "align": rb.align,
          "launches": launches, "equal_to_packed": True, "ok": True})


def path_ingest_resident(T, K, FT, ingest, root, corpus_docs, total):
    """run_overlapped on INGEST_DOCS documents, once per wire."""
    from tfidf_tpu_torch.parity import compare_topk
    n = len(corpus_docs)
    cfg = {w: T.PipelineConfig(vocab_mode=T.VocabMode.HASHED,
                               vocab_size=SPARSE_VOCAB, max_doc_len=DOC_LEN,
                               doc_chunk=DOC_LEN, topk=TOPK, wire=w)
           for w in ("ragged", "bytes", "padded")}
    expect = {"ragged": ("ragged_rebuild", "load_pack_flat"),
              "bytes": ("tokenize_hash", "load_slab_paths"),
              "padded": (None, "load_pack_paths")}
    run = {w: (lambda w=w: ingest.run_overlapped(
        root, cfg[w], chunk_docs=N_DOCS, doc_len=DOC_LEN)) for w in cfg}
    results, per_wire = {}, {}
    for w in cfg:
        run[w]()  # cold: the first run of each wire pays its set-up
        r, wall, launches, native = _counted_run(K, FT, run[w])
        for kernel, c in launches.items():
            total[kernel] += c
        kernel, packer = expect[w]
        check(native[packer] == INGEST_DOCS // N_DOCS,
              f"path_ingest_resident {w}: the native loader did not run "
              f"({native})")
        for k_ in ("fused_score_topk", "pack_words") + ((kernel,) if kernel else ()):
            check(launches[k_] > 0, f"path_ingest_resident {w}: {k_} never "
                  f"launched")
        check(r.wire == w and r.path == "resident" and r.finish == "scan"
              and r.n_finish_dispatches == 1 and r.result_wire == "packed",
              f"path_ingest_resident {w}: fields {_result_fields(r)}")
        check(r.topk_vals.shape == (n, TOPK) and np.isfinite(r.topk_vals).all(),
              f"path_ingest_resident {w}: bad top-k values")
        results[w] = r
        per_wire[w] = {"warm_wall_s": wall, "docs_per_s": n / wall,
                       "launches": launches, "native_calls": native,
                       "phases": r.phases, "fields": _result_fields(r)}
    for w in ("bytes", "padded"):
        check(_same_result(results[w], results["ragged"]),
              f"path_ingest_resident: the {w} wire's words differ from ragged")
    rg = results["ragged"]
    cpu = ingest.run_overlapped(root, cfg["ragged"], chunk_docs=N_DOCS,
                                doc_len=DOC_LEN, device="cpu")
    packer = ingest.make_chunk_packer(root, cfg["padded"], n, DOC_LEN)
    tok, lens = packer([f"doc{i}" for i in range(1, n + 1)])
    check(np.array_equal(rg.df, cpu.df) and np.array_equal(rg.lengths, cpu.lengths)
          and np.array_equal(rg.lengths, lens[:n]),
          "path_ingest_resident: df/lengths differ from the CPU run")
    vs_cpu = compare_topk(rg.topk_ids, rg.topk_vals, cpu.topk_ids, cpu.topk_vals,
                          token_ids=tok, lengths=lens, df=cpu.df, num_docs=n,
                          wire_dtype=np.float16)
    check(vs_cpu["ok"], f"path_ingest_resident: GPU vs CPU run: {vs_cpu}")
    corpus = T.Corpus(names=[f"doc{i}" for i in range(1, n + 1)],
                      docs=corpus_docs)
    batch = T.TfidfPipeline(cfg["ragged"]).run(corpus)
    check(np.array_equal(batch.df, rg.df),
          "path_ingest_resident: df differs from TfidfPipeline.run")
    vs_pipe = compare_topk(rg.topk_ids, rg.topk_vals, batch.topk_ids,
                           batch.topk_vals, token_ids=tok, lengths=lens,
                           df=rg.df, num_docs=n, wire_dtype=np.float16)
    check(vs_pipe["ok"], f"path_ingest_resident: vs TfidfPipeline.run: {vs_pipe}")
    prof = profile_summary(run["ragged"])
    emit({"phase": "path_ingest_resident", "docs": n, "chunk_docs": N_DOCS,
          "doc_len": DOC_LEN, "vocab": SPARSE_VOCAB, "topk": TOPK,
          "wires": per_wire, "wires_identical": True, "vs_cpu": vs_cpu,
          "vs_tfidf_pipeline": vs_pipe,
          "device_profile_ragged": prof, "ok": True})
    return rg


class env_vars:
    """Set environment variables for a block, then restore them."""

    def __init__(self, **kv):
        self.kv = kv
        self.saved = {}

    def __enter__(self):
        self.saved = {k_: os.environ.get(k_) for k_ in self.kv}
        os.environ.update(self.kv)

    def __exit__(self, *exc):
        for k_, v in self.saved.items():
            if v is None:
                os.environ.pop(k_, None)
            else:
                os.environ[k_] = v


def path_ingest_streaming(T, K, FT, ingest, root, total):
    """The streaming regime (2 of 4 chunks triple-cached) equals the
    resident run of the same corpus, on the ragged and bytes wires."""
    n = N_DOCS
    env = {"TFIDF_TPU_RESIDENT_ELEMS": str(n * DOC_LEN - 1),
           "TFIDF_TPU_TRIPLE_CACHE_BYTES": str(
               2 * (STREAM_CHUNK * DOC_LEN * 9 + STREAM_CHUNK * 4))}

    def cfg(w):
        return T.PipelineConfig(vocab_mode=T.VocabMode.HASHED,
                                vocab_size=SPARSE_VOCAB, max_doc_len=DOC_LEN,
                                doc_chunk=DOC_LEN, topk=TOPK, wire=w)

    resident = ingest.run_overlapped(root, cfg("ragged"),
                                     chunk_docs=STREAM_CHUNK, doc_len=DOC_LEN)
    check(resident.path == "resident", "path_ingest_streaming: reference "
          "run is not resident")
    runs = {}
    with env_vars(**env):
        for w in ("ragged", "bytes"):
            for spill in ("host", "reread"):
                fn = (lambda w=w, spill=spill: ingest.run_overlapped(
                    root, cfg(w), chunk_docs=STREAM_CHUNK, doc_len=DOC_LEN,
                    spill=spill))
                r, wall, launches, native = _counted_run(K, FT, fn)
                for kernel, c in launches.items():
                    total[kernel] += c
                label = f"{w}_{spill}"
                check(r.path == "streaming" and r.wire == w
                      and r.phases["triple_cached_chunks"] == 2
                      and r.finish == "scan" and r.n_finish_dispatches == 3,
                      f"path_ingest_streaming {label}: {_result_fields(r)}")
                check(launches["ragged_rebuild" if w == "ragged"
                               else "tokenize_hash"] > 0,
                      f"path_ingest_streaming {label}: wire kernel never "
                      f"launched")
                check(_same_result(r, resident),
                      f"path_ingest_streaming {label}: differs from the "
                      f"resident run")
                runs[label] = {"wall_s": wall, "docs_per_s": n / wall,
                               "launches": launches, "native_calls": native,
                               "phases": r.phases,
                               "fields": _result_fields(r)}
    emit({"phase": "path_ingest_streaming", "docs": n,
          "chunk_docs": STREAM_CHUNK, "env": env, "runs": runs,
          "equal_to_resident": True, "ok": True})


def retrieval_queries(rng, n: int = RETR_QUERIES):
    """``n`` queries of 2-6 words from the corpus's vocabulary, word
    ranks drawn Zipf(1.3) as the documents' are."""
    ranks = np.clip(rng.zipf(1.3, n * 6), 1, N_WORDS) - 1
    lens = rng.integers(2, 7, n)
    offs = np.concatenate([[0], np.cumsum(lens)])
    return [" ".join(f"w{r}" for r in ranks[offs[i]:offs[i + 1]])
            for i in range(n)]


def host_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median host milliseconds of one ``fn()`` that ends on the host
    (a search returns host arrays, so its device work is inside)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _same_search(a, b) -> bool:
    return (np.array_equal(a[1], b[1])
            and np.array_equal(np.asarray(a[0], np.float32).view(np.uint32),
                               np.asarray(b[0], np.float32).view(np.uint32)))


RETR_SETTINGS = {"tfidf": {}, "bm25": {"scorer": "bm25"},
                 "bm25:k1=1.5,b=0.6": {"scorer": "bm25:k1=1.5,b=0.6"},
                 "tfidf+id_range": {"filter": {"id_range": [0, 65536]}}}


def path_retrieval(T, K, root, corpus_docs, total):
    """TfidfRetriever on the ingest corpus: index_dir (B4), searches
    (B6), the within-port equalities and the card-vs-CPU agreement."""
    from tfidf_tpu_torch.models import retrieval as R
    from tfidf_tpu_torch.parity import compare_search

    n = len(corpus_docs)
    cfg = T.PipelineConfig(vocab_mode=T.VocabMode.HASHED,
                           vocab_size=SPARSE_VOCAB)
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = T.TfidfRetriever(cfg).index_dir(root, doc_len=DOC_LEN,
                                        chunk_docs=RETR_CHUNK)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    index_launches = dict(K.LAUNCHES)
    for kernel, c in index_launches.items():
        total[kernel] += c
    check(index_launches["ragged_rebuild"] == n // RETR_CHUNK,
          f"path_retrieval: index_dir launched B4 "
          f"{index_launches['ragged_rebuild']} times, not {n // RETR_CHUNK}")
    check(tuple(r._ids.shape) == (n, DOC_LEN) and r._num_docs == n,
          f"path_retrieval: index shape {tuple(r._ids.shape)}")
    index_mb = sum(t.nbytes for t in (r._ids, r._weights, r._head)) / 1e6
    queries = retrieval_queries(np.random.default_rng(SEED + 3))
    n_tiles = -(-n // RETR_TILE)
    results, latency, launches_per_search = {}, {}, {}
    for name, kw in RETR_SETTINGS.items():
        for q in (1, 64, RETR_QUERIES):
            qs = queries[:q]
            r.search(qs, k=RETR_K, **kw)  # warm: derives the scorer's face
            K.reset_launches()
            torch.cuda.synchronize()
            res = r.search(qs, k=RETR_K, **kw)
            launches = dict(K.LAUNCHES)
            for kernel, c in launches.items():
                total[kernel] += c
            check(launches["tile_scores"] == n_tiles,
                  f"path_retrieval {name} Q={q}: B6 launched "
                  f"{launches['tile_scores']} times, not once per tile "
                  f"({n_tiles})")
            vals, ids = res
            check(vals.shape == ids.shape == (q, RETR_K)
                  and np.isfinite(vals).all() and (vals >= 0).all()
                  and ((ids >= -1) & (ids < n)).all()
                  and ((ids >= 0) == (vals > 0)).all()
                  and (np.diff(vals, axis=1) <= 0).all(),
                  f"path_retrieval {name} Q={q}: malformed result")
            check((ids >= 0).sum() > q * RETR_K // 2,
                  f"path_retrieval {name} Q={q}: too few results")
            if "filter" in kw:
                check((ids < 65536).all(), "path_retrieval: the id_range "
                      "filter let a row past 65,536 through")
            results[name, q] = res
            launches_per_search[f"{name}/Q{q}"] = launches["tile_scores"]
            ms = host_ms(lambda: r.search(qs, k=RETR_K, **kw))
            latency[f"{name}/Q{q}"] = {"ms": ms, "qps": q / ms * 1e3}
    for name, kw in RETR_SETTINGS.items():
        big = results[name, RETR_QUERIES]
        check(_same_search((big[0][:64], big[1][:64]), results[name, 64]),
              f"path_retrieval {name}: the first 64 rows of the Q=256 "
              f"search differ from the Q=64 search")
        for q in (64, RETR_QUERIES):
            with env_vars(TFIDF_TPU_SCORE_TILING="off"):
                off = r.search(queries[:q], k=RETR_K, **kw)
            with env_vars(TFIDF_TPU_QUERY_BLOCK="1024"):
                narrow = r.search(queries[:q], k=RETR_K, **kw)
            check(_same_search(off, results[name, q]),
                  f"path_retrieval {name} Q={q}: untiled differs from tiled")
            check(_same_search(narrow, results[name, q]),
                  f"path_retrieval {name} Q={q}: tile 1,024 differs from "
                  f"4,096")
    fill = {}
    for q in (64, RETR_QUERIES):
        buf = np.empty((SPARSE_VOCAB, q), np.float32)
        fill[f"Q{q}"] = host_ms(lambda: R.fill_query_matrix(
            queries[:q], cfg, r._idf_host(), buf), reps=5, warmup=1)
    prof = profile_summary(lambda: r.search(queries[:64], k=RETR_K))

    # a snapshot taken on the card, searched on the CPU
    with tempfile.TemporaryDirectory(dir=os.path.dirname(root)) as snap:
        t0 = time.perf_counter()
        r.snapshot(snap)
        snap_s = time.perf_counter() - t0
        cpu_r, _ = T.TfidfRetriever.restore(snap, device="cpu")
    t0 = time.perf_counter()
    cpu_res = cpu_r.search(queries[:64], k=RETR_K)
    cpu_search_s = time.perf_counter() - t0
    vs_cpu = compare_search(*results["tfidf", 64], *cpu_res)
    check(vs_cpu["ok"], f"path_retrieval: card vs CPU restore: {vs_cpu}")
    del cpu_r
    # an 8,192-doc index built on both devices (the batch index path)
    small = T.Corpus(names=[f"doc{i}" for i in range(1, RETR_SMALL + 1)],
                     docs=corpus_docs[:RETR_SMALL])
    g = T.TfidfRetriever(cfg).index(small)
    c = T.TfidfRetriever(cfg, device="cpu").index(small)
    small_cmp = {"weights_bit_equal": same_bits(g._weights.cpu(), c._weights),
                 "idf_bit_equal": same_bits(g._idf.cpu(), c._idf)}
    for name, kw in RETR_SETTINGS.items():
        a = g.search(queries[:64], k=RETR_K, **kw)
        b = c.search(queries[:64], k=RETR_K, **kw)
        cmp = compare_search(*a, *b, val_ulps=4 if "bm25" in name else 0)
        check(cmp["ok"], f"path_retrieval: {RETR_SMALL}-doc index, card vs "
              f"CPU, {name}: {cmp}")
        small_cmp[name] = cmp
    emit({"phase": "path_retrieval", "docs": n, "doc_len": DOC_LEN,
          "chunk_docs": RETR_CHUNK, "vocab": SPARSE_VOCAB, "k": RETR_K,
          "tile": RETR_TILE, "n_tiles": n_tiles, "index_s": index_s,
          "index_mb": index_mb, "index_launches": index_launches,
          "search_launches_b6": launches_per_search,
          "search_latency": latency, "fill_query_matrix_ms": fill,
          "tiled_equals_untiled": True, "tile_1024_equals_4096": True,
          "q256_prefix_equals_q64": True, "snapshot_s": snap_s,
          "vs_cpu_restore": vs_cpu, "cpu_search_q64_s": cpu_search_s,
          "small_index_vs_cpu": small_cmp,
          "device_profile_q64": prof, "ok": True})
    return r, cfg, queries


def b6_bound(data, cols, q: int):
    """What one tile-scores call needs at this data: data at every slot,
    cols at live slots, the qmat rows of the distinct live columns (Q
    floats each), the output; and one FMA per live slot and query."""
    live = data != 0
    n_live = int(live.sum())
    n_distinct = int(torch.unique(cols[live]).numel())
    rows, length = data.shape
    nbytes = rows * length * 4 + n_live * 4 + n_distinct * q * 4 + rows * q * 4
    fmas = n_live * q
    bytes_ms = bound_ms(nbytes)
    ops_ms = fmas / FP32_FMA_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_bound_ms": bytes_ms, "operations_bound_ms": ops_ms,
            "live_slots": n_live, "distinct_columns": n_distinct,
            "bytes": nbytes, "fmas": fmas}


def b6_kernel_cases(K, R, r, cfg, queries, summary):
    """B6 against its plain version on real tiles of the retrieval
    index, and its times at Q = 64 (the kernels line) and Q = 256."""
    from tfidf_tpu_torch.scoring import parse_scorer

    dev = r.device
    cases = []
    faces = {"tfidf": r._scorer_face(parse_scorer("tfidf")),
             "bm25": r._scorer_face(parse_scorer("bm25"))}

    # Q 512 needs more queries than the searches use.
    queries = queries + retrieval_queries(np.random.default_rng(SEED + 4),
                                          max(B6_CHECKED_Q) - len(queries))

    def qmat_for(kind, q):
        mode = "counts" if kind == "bm25" else "cosine"
        return torch.from_numpy(R.query_matrix(
            queries[:q], cfg, r._idf_host(), mode=mode)).to(dev)

    def case(label, data, cols, qmat, dead_rows=0):
        got = K.tile_scores(data, cols, qmat)
        want = K.tile_scores_plain(data, cols, qmat)
        torch.cuda.synchronize()
        check(same_bits(got, want), f"B6 {label}: differs from plain")
        if dead_rows:
            check(bool((got[:dead_rows] == 0).all()),
                  f"B6 {label}: all-dead rows do not score 0")
        cases.append({"kernel": "tile_scores", "case": label,
                      "shape": [*data.shape, *qmat.shape],
                      "whole_output_bit_equal": True, "max_abs_err": 0.0})

    tiles = {}
    for kind, (data, cols) in faces.items():
        d_t, c_t = data[:RETR_TILE], cols[:RETR_TILE]
        for q in B6_TIMED_Q[kind]:
            qm = qmat_for(kind, q)
            tiles[kind, q] = (d_t, c_t, qm)
            case(f"{kind}_q{q}", d_t, c_t, qm)
    d_t, c_t = faces["tfidf"][0][:RETR_TILE], faces["tfidf"][1][:RETR_TILE]
    for q in B6_CHECKED_Q:
        if ("tfidf", q) not in tiles:
            case(f"tfidf_q{q}", d_t, c_t, qmat_for("tfidf", q))
    q64 = tiles["tfidf", 64][2]
    ragged = 3001
    case(f"ragged_{ragged}_rows_q64", faces["tfidf"][0][:ragged].contiguous(),
         faces["tfidf"][1][:ragged].contiguous(), q64)
    dead = d_t.clone()
    dead[:512] = 0
    case("dead_rows_0_512_q64", dead, c_t, q64, dead_rows=512)
    full = d_t.clone()
    full[7] = 0.5  # row 7: every one of its L slots live
    for q in (64, RETR_QUERIES):
        case(f"all_live_row_q{q}", full, c_t, tiles["tfidf", q][2])
    emit({"phase": "kernel_cases_b6", "cases": cases})

    def timed(kind, q):
        data, cols, qmat = tiles[kind, q]
        live = data != 0
        crow = torch.zeros(data.shape[0] + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(live.sum(dim=1), 0)
        csr = torch.sparse_csr_tensor(crow, cols[live].to(torch.int64),
                                      data[live],
                                      size=(data.shape[0], SPARSE_VOCAB),
                                      check_invariants=False)
        lib = torch.sparse.mm(csr, qmat)
        kern = K.tile_scores(data, cols, qmat)
        torch.cuda.synchronize()
        out = torch.empty_like(kern)
        times = kernel_times(
            lambda: K.tile_scores(data, cols, qmat),
            lambda: K.tile_scores_plain(data, cols, qmat),
            lambda: torch.sparse.mm(csr, qmat),
            kernel_only=lambda: K.tile_scores_launch(data, cols, qmat, out))
        torch.cuda.synchronize()
        check(same_bits(out, kern), f"B6 {kind} Q={q}: the timed launch's "
              f"output differs")
        bound = b6_bound(data, cols, q)
        return {**times, **bound, "kernel_bound_ms": bound["bound_ms"],
                "library_max_abs_err": (lib - kern).abs().max().item(),
                "max_abs_err": 0.0,
                "shape": {"rows": data.shape[0], "L": data.shape[1],
                          "V": SPARSE_VOCAB, "Q": q, "face": kind}}

    main = timed("tfidf", 64)
    main["library_call"] = ("torch.sparse.mm(tile as CSR [4096, V], qmat) "
                            "(CSR built outside the timed span)")
    main["other_shapes"] = {f"{kind}_q{q}": timed(kind, q)
                            for kind, qs in B6_TIMED_Q.items() for q in qs
                            if (kind, q) != ("tfidf", 64)}
    summary["tile_scores"] = main


def main() -> int:
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device\n")
        return 2
    sys.path.insert(0, REPO)
    import tfidf_tpu_torch as T
    from tfidf_tpu_torch import ingest
    from tfidf_tpu_torch.config import VocabMode
    from tfidf_tpu_torch.golden import golden_output
    from tfidf_tpu_torch.io import fast_tokenizer as FT
    from tfidf_tpu_torch.ops import _build, kernels as K

    smi = env_phase(_build)
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

    path_ragged_batch(T, K, corpus, sparse_cfg, total)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        big = os.path.join(tmp, "resident")
        small = os.path.join(tmp, "streaming")
        os.makedirs(big)
        os.makedirs(small)
        t0 = time.perf_counter()
        big_docs = zipf_docs(np.random.default_rng(SEED + 1), INGEST_DOCS)
        write_corpus(big, big_docs)
        write_corpus(small, corpus.docs)
        emit({"phase": "ingest_corpora", "docs": [INGEST_DOCS, N_DOCS],
              "bytes": [sum(map(len, big_docs)), sum(map(len, corpus.docs))],
              "write_s": time.perf_counter() - t0})
        path_ingest_resident(T, K, FT, ingest, big, big_docs, total)
        path_ingest_streaming(T, K, FT, ingest, small, total)
        r, rcfg, queries = path_retrieval(T, K, big, big_docs, total)
        from tfidf_tpu_torch.models import retrieval as R
        b6_kernel_cases(K, R, r, rcfg, queries, summary)
        del r

    sources = {"fused_score_topk": ("tfidf_tpu_torch/csrc/score_topk.cu",
                                    "tfidf_tpu/ops/pallas_kernels.py:466"),
               "tf_df": ("tfidf_tpu_torch/csrc/tf_df.cu",
                         "tfidf_tpu/ops/pallas_kernels.py:105"),
               "pack_words": ("tfidf_tpu_torch/csrc/pack_words.cu",
                              "tfidf_tpu/ops/pallas_kernels.py:282"),
               "ragged_rebuild": ("tfidf_tpu_torch/csrc/ragged_rebuild.cu",
                                  "tfidf_tpu/ops/pallas_kernels.py:210"),
               "tokenize_hash": ("tfidf_tpu_torch/csrc/tokenize_hash.cu",
                                 "tfidf_tpu/ops/pallas_kernels.py:388"),
               "tile_scores": ("tfidf_tpu_torch/csrc/tile_scores.cu",
                               "tfidf_tpu/ops/pallas_kernels.py:526")}
    rows = []
    for kernel, (src, replaces) in sources.items():
        s = summary[kernel]
        rows.append({"name": kernel, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": total[kernel],
                     "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                     "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                     "bound_by": s.get("bound_by", "bytes"),
                     "library_ms": s["library_ms"],
                     "kernel_ms": s["kernel_ms"],
                     "kernel_bound_ms": s["kernel_bound_ms"],
                     "call_ms": s["call_ms"], "shape": s["shape"],
                     **{key: s[key] for key in (
                         "library_call", "bytes_bound_ms",
                         "operations_bound_ms", "library_max_abs_err",
                         "yardstick_ms", "yardstick_call", "kernel_ms_k1",
                         "kernel_ms_k64", "kernel_ms_no_head_slots",
                         "rows_over_32_head_slots", "rebuild_only_ms",
                         "granule_offsets_chain_ms", "token_starts_ms",
                         "other_shapes") if key in s}})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
