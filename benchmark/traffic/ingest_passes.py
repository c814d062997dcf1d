"""Driver kind ``ingest_passes``: the reference's batch job, whole passes
back to back.

Set-up writes the corpus and runs one whole pass of
``tfidf_tpu_torch.ingest.run_overlapped`` (the kernels' build, the
loader library, the allocator's pools, the page cache). The window then
runs passes back to back until ``--seconds`` have passed, the last one
finishing. Reports ``docs_per_s``: the documents of all those passes
over their wall. Every pass's per-document top-k is checked.
"""

from __future__ import annotations

import gc
import math
import time
from dataclasses import dataclass, field

import numpy as np

from benchmark import devtrace
from benchmark.harness import Context, Window, tracer_spans
from benchmark.reference import compare, tfidf
from benchmark.reference.hashing import word_buckets
from benchmark.traffic import text

# The control: the program's own bfloat16 score path (``ctx.precision``).
CONTROL = "program"


@dataclass
class IngestState:
    setup_split: dict
    words: text.Words
    corpus: text.Corpus
    root: str
    pcfg: object
    results: list = field(default_factory=list)   # (vals, ids) a pass


def _config(ctx: Context):
    from tfidf_tpu_torch.config import PipelineConfig, VocabMode
    cfg = ctx.config
    # The control runs the program's own bfloat16 score path.
    dtype = "bfloat16" if ctx.precision == "bfloat16" else cfg["score_dtype"]
    return PipelineConfig(vocab_mode=VocabMode.HASHED,
                          vocab_size=int(cfg["vocab_size"]),
                          hash_seed=int(cfg["hash_seed"]),
                          max_doc_len=int(cfg["doc_len"]),
                          doc_chunk=int(cfg["doc_len"]),
                          topk=int(cfg["topk"]), wire=cfg["wire"],
                          score_dtype=dtype)


def _pass(ctx: Context, st: IngestState):
    from tfidf_tpu_torch.ingest import run_overlapped
    return run_overlapped(st.root, st.pcfg,
                          chunk_docs=int(ctx.config["chunk_docs"]),
                          doc_len=int(ctx.config["doc_len"]),
                          device=ctx.device)


def setup(ctx: Context) -> IngestState:
    cfg = ctx.config
    t0 = time.perf_counter()
    words = text.make_words(cfg)
    corpus = text.make_corpus(cfg, ctx.seed, words)
    root = f"{ctx.workdir}/corpus"
    nbytes = text.write_corpus(corpus, root)
    t1 = time.perf_counter()
    st = IngestState({}, words, corpus, root, _config(ctx))
    r = _pass(ctx, st)
    if ctx.trace:
        devtrace.Capture.warm(ctx.cuda)
    ctx.sync()
    t2 = time.perf_counter()
    st.setup_split = {"corpus_s": t1 - t0, "warm_s": t2 - t1}
    ctx.log(f"corpus {corpus.num_docs} docs {int(corpus.starts[-1])} tokens "
            f"{nbytes} bytes; warm pass {t2 - t1:.3f} s ({r.path}, "
            f"{r.wire} wire)")
    return st


def measure(ctx: Context, st: IngestState) -> Window:
    """Passes back to back. Traced, the first pass is captured, and the
    next one in its stead when the profiler dropped device records of
    the first (the traced run reports no end-to-end metric)."""
    from tfidf_tpu_torch import obs
    from tfidf_tpu_torch.obs.tracer import Tracer
    tracer = None
    if ctx.trace:
        tracer = Tracer(1 << 20)
        obs.set_tracer(tracer)
    walls = []
    captures = 0
    t0 = time.perf_counter()
    while not walls or time.perf_counter() - t0 < ctx.seconds \
            or (tracer is not None and ctx.observed.profile is None
                and captures < 2):
        cap = None
        if tracer is not None and ctx.observed.profile is None \
                and captures < 2:
            cap = devtrace.Capture(f"{ctx.workdir}/device_trace.json",
                                   ctx.cuda)
            captures += 1
            cap.__enter__()
        a = time.perf_counter()
        r = _pass(ctx, st)
        walls.append(time.perf_counter() - a)
        st.results.append((r.topk_vals, r.topk_ids))
        if cap is not None:
            cap.__exit__(None, None, None)
            prof = cap.reduce(tracer_spans(tracer))
            if prof.complete:
                ctx.observed.profile = prof
    wall = time.perf_counter() - t0
    n = st.corpus.num_docs
    ctx.log(f"{len(walls)} passes in {wall:.3f} s: " + " ".join(
        f"{w:.3f}" for w in walls))
    facts = ctx.observed.facts
    facts.update(passes_wall_s=sum(walls), docs=n,
                 chunks=math.ceil(n / int(ctx.config["chunk_docs"])))
    if tracer is not None:
        obs.set_tracer(None)
        ctx.observed.spans = tracer_spans(tracer)
        if ctx.observed.profile is None:
            ctx.log("capture: both captured passes dropped device records; "
                    "the device metrics are left out")
    return Window({"docs_per_s": len(walls) * n / wall},
                  attempted=len(walls) * n, failed=0)


def release(ctx: Context, st: IngestState) -> None:
    gc.collect()
    if ctx.cuda:
        import torch
        torch.cuda.empty_cache()


def check(ctx: Context, st: IngestState) -> dict:
    """Every pass's top-k of every document against the reference."""
    cfg = ctx.config
    v = int(cfg["vocab_size"])
    buckets = word_buckets(st.words.table, st.words.offsets, v,
                           int(cfg["hash_seed"]))
    ix = tfidf.build_index(buckets[st.corpus.ranks], st.corpus.starts, v,
                           int(cfg["doc_len"]))
    k = int(cfg["topk"])
    ref_v, _, ref_n, scores = tfidf.doc_topk(ix, k, "float64")
    keys = ix.key(ix.doc, ix.term)
    numbers = {"rank_gap": 0.0, "pick_gap": 0.0, "picks_off": 0}
    for vals, ids in st.results:
        numbers = merge(numbers, topk_against(ix, keys, scores, ref_v, ref_n,
                                              vals, ids))
    ctx.observed.facts["head_slots"] = len(ix.doc)
    ctx.log(f"checked {len(st.results)} passes of {ix.num_docs} documents")
    return numbers


def topk_against(ix, keys, scores, ref_v, ref_n, vals, ids) -> dict:
    n = ix.num_docs
    vals, ids = np.asarray(vals)[:n], np.asarray(ids)[:n].astype(np.int64)
    want = ix.key(np.arange(n)[:, None], np.maximum(ids, 0))
    pos = np.minimum(np.searchsorted(keys, want), len(keys) - 1)
    at = np.where((keys[pos] == want) & (ids >= 0), scores[pos], 0.0)
    return compare.topk_numbers(vals, ids, ref_v, ref_n, at)


def merge(a: dict, b: dict) -> dict:
    return {"rank_gap": max(a["rank_gap"], b["rank_gap"]),
            "pick_gap": max(a["pick_gap"], b["pick_gap"]),
            "picks_off": a["picks_off"] + b["picks_off"]}
