"""What the served cells share: the index built from files in set-up,
the server, the warm-up, the traced sub-window, and the check.

The program's side: ``TfidfRetriever.index_dir`` (the overlapped
ingest's chunk step: the native loader, B4, ``sorted_term_counts``,
``sparse_df``) builds the index from the generated files; a
``TfidfServer`` at the configuration's settings serves it; requests go
through ``TfidfServer.submit``. The check judges the index's document
face and a seeded sample of the answers against the plain reference.
"""

from __future__ import annotations

import functools
import gc
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from benchmark import devtrace
from benchmark.harness import Context, tracer_spans
from benchmark.reference import compare, tfidf
from benchmark.reference.hashing import word_buckets
from benchmark.traffic import text


def scorer_dict(key: str) -> dict:
    """``"bm25:b=0.68,k1=0.82"`` -> ``{"kind": "bm25", "b": .., "k1":
    ..}``; ``"tfidf"`` -> ``{"kind": "tfidf"}``."""
    kind, _, params = key.partition(":")
    out = {"kind": kind}
    for part in filter(None, params.split(",")):
        name, _, val = part.partition("=")
        out[name] = float(val)
    return out


@dataclass
class ServeState:
    setup_split: dict
    words: text.Words
    corpus: text.Corpus
    queries: "text.QueryStream"
    scorer: str
    k: int
    retriever: object = None
    server: object = None
    answers: Optional["Answers"] = None
    unanswered: int = 0
    face: Optional[tuple] = None


class Answers:
    """The answers as they come, kept in arrays: the client holds no
    future and no per-request object after its answer, so that what it
    keeps adds nothing to the garbage collector's work in the serving
    process. Row ``i`` is request ``base + i``: its values and picks,
    when the answer came (NaN until then) and whether it came without
    error; ``notify(base + i)``, if given, follows each answer."""

    def __init__(self, n: int, k: int, base: int = 0, notify=None):
        self.vals = np.zeros((n, k), np.float64)
        self.ids = np.full((n, k), -1, np.int64)
        self.done = np.full(n, np.nan)
        self.ok = np.zeros(n, bool)
        self.k, self.base, self.notify = k, base, notify

    def callback(self, i: int):
        """The done-callback of request ``i``'s future."""
        return functools.partial(self._finished, i)

    def _finished(self, i: int, fut) -> None:
        now = time.perf_counter()
        if fut.exception() is None:
            vals, ids = fut.result()
            m = min(self.k, np.shape(ids)[1])
            self.vals[i, :m] = np.asarray(vals)[0, :m]
            self.ids[i, :m] = np.asarray(ids)[0, :m]
            self.ok[i] = True
        self.done[i] = now
        if self.notify is not None:
            self.notify(self.base + i)

    @staticmethod
    def join(parts: list, n: int) -> "Answers":
        """The first ``n`` rows of ``parts`` laid end to end."""
        out = Answers(0, parts[0].k)
        for name in ("vals", "ids", "done", "ok"):
            setattr(out, name, np.concatenate(
                [getattr(p, name) for p in parts])[:n])
        return out

    def wait(self, sent: np.ndarray, deadline: float) -> int:
        """Wait until every request in ``sent`` came back or the
        deadline passed; returns how many never came."""
        while True:
            missing = int(np.isnan(self.done[sent]).sum())
            if missing == 0 or time.perf_counter() >= deadline:
                return missing
            time.sleep(0.005)


class GcWatch:
    """The garbage collector's pauses from construction to
    :meth:`close`: ``(generation, seconds)`` each. Every thread of the
    process stalls while one runs, the server's too."""

    def __init__(self):
        self.pauses: list = []
        self._began = None
        gc.callbacks.append(self._on)

    def _on(self, phase, info) -> None:
        if phase == "start":
            self._began = (info["generation"], time.perf_counter())
        elif self._began is not None:
            gen, t = self._began
            self.pauses.append((gen, time.perf_counter() - t))
            self._began = None

    def close(self, ctx: Context) -> dict:
        """Stop recording, log the window's collections and return
        their count, the full ones' count and the full ones' seconds."""
        gc.callbacks.remove(self._on)
        full = [d for g, d in self.pauses if g == 2]
        ctx.log(f"gc in the window: {len(self.pauses)} collections, "
                f"{sum(d for _, d in self.pauses) * 1e3:.1f} ms; full "
                f"{len(full)}, {sum(full) * 1e3:.1f} ms, longest "
                f"{max(full, default=0) * 1e3:.1f} ms")
        return {"collections": len(self.pauses), "full": len(full),
                "full_s": sum(full)}


def setup(ctx: Context, widest: int) -> ServeState:
    """Write the corpus, build the index through ``index_dir``, start
    the server and warm every batch width up to ``widest``, the widest
    batch the cell's traffic can form."""
    cfg, traffic = ctx.config, ctx.cell["traffic"]
    t0 = time.perf_counter()
    words = text.make_words(cfg)
    corpus = text.make_corpus(cfg, ctx.seed, words)
    root = f"{ctx.workdir}/corpus"
    nbytes = text.write_corpus(corpus, root)
    queries = text.QueryStream(traffic, cfg, words, ctx.seed)
    warm = text.make_queries(traffic, cfg, words, ctx.seed, widest, salt=1)
    t1 = time.perf_counter()
    from tfidf_tpu_torch.config import (PipelineConfig, ServeConfig,
                                        VocabMode)
    from tfidf_tpu_torch.models.retrieval import TfidfRetriever
    from tfidf_tpu_torch.serve.server import TfidfServer
    doc_len = int(cfg["doc_len"])
    pcfg = PipelineConfig(vocab_mode=VocabMode.HASHED,
                          vocab_size=int(cfg["vocab_size"]),
                          hash_seed=int(cfg["hash_seed"]),
                          max_doc_len=doc_len, doc_chunk=doc_len)
    retriever = TfidfRetriever(pcfg, device=ctx.device).index_dir(
        root, doc_len=doc_len)
    ctx.sync()
    t2 = time.perf_counter()
    server = TfidfServer(retriever, ServeConfig(**cfg["serve"]))
    scorer, k = traffic["scorer"], int(cfg["k"])
    width = 1
    while width <= widest:
        server.submit(warm[:width], k, scorer=scorer,
                      use_cache=False).result()
        width *= 2
    if ctx.trace:
        devtrace.Capture.warm(ctx.cuda)
    ctx.sync()
    t3 = time.perf_counter()
    ctx.log(f"corpus {corpus.num_docs} docs {int(corpus.starts[-1])} tokens "
            f"{nbytes} bytes; warm widths up to {widest}")
    return ServeState({"corpus_s": t1 - t0, "index_s": t2 - t1,
                       "warm_s": t3 - t2}, words, corpus, queries, scorer, k,
                      retriever, server)


def counters(server) -> dict:
    snap = server.metrics.snapshot()
    return {"queries": snap["queries"], "batches": snap["batch"]["count"],
            "cache_hits": snap["cache"]["hits"]}


class Profiled:
    """A traced sub-window: the program's tracer armed, its counters read
    at both ends, a device capture around it. It is the last
    ``traffic.profile_s`` of an offered stretch of ``seconds`` and
    closes after it, so that the profiler's stop stalls no request of
    the stretch."""

    def __init__(self, ctx: Context, server, seconds: float):
        self.ctx, self.server = ctx, server
        self.at = max(0.0, seconds
                      - float(ctx.cell["traffic"].get("profile_s", 2.0)))
        self.cap = None
        self.done = False

    def tick(self, elapsed: float) -> None:
        """Start the sub-window once the stretch's clock reaches it."""
        if self.cap is None and elapsed >= self.at:
            from tfidf_tpu_torch import obs
            from tfidf_tpu_torch.obs.tracer import Tracer
            self.tracer = Tracer(1 << 21)
            obs.set_tracer(self.tracer)
            self.before = counters(self.server)
            self.cap = devtrace.Capture(
                f"{self.ctx.workdir}/device_trace.json", self.ctx.cuda)
            self.cap.__enter__()

    def stop(self) -> None:
        from tfidf_tpu_torch import obs
        if self.done or self.cap is None:
            return
        self.done = True
        self.cap.__exit__(None, None, None)
        self.after = counters(self.server)
        obs.set_tracer(None)

    def read(self) -> bool:
        """Reduce the capture into the run's observations if it recorded
        its device ops in full; False when the profiler dropped them."""
        if self.cap is None:
            return False
        prof = self.cap.reduce(tracer_spans(self.tracer))
        self.tracer = None
        if not prof.complete:
            return False
        facts = self.ctx.observed.facts
        facts["profile_batches"] = self.after["batches"] \
            - self.before["batches"]
        facts["profile_queries"] = self.after["queries"] \
            - self.before["queries"]
        self.ctx.observed.profile = prof
        return True


# A traced run whose capture dropped device records offers this many
# seconds more (the backlog of the profiler's stop drained, then a
# second sub-window), answers unchecked, and reads that capture instead.
RETRY_S = 8.0


def read_profile(ctx: Context, st: ServeState, prof: Profiled,
                 offer) -> None:
    """Read ``prof``; if it lost records, ``offer(seconds, prof)`` the
    traffic again for ``RETRY_S`` under a new sub-window and read that.
    With neither complete the device metrics are left out."""
    if prof.read():
        return
    ctx.log(f"capture: dropped device records; offering {RETRY_S:g} s "
            f"more for a second capture")
    again = Profiled(ctx, st.server, RETRY_S)
    offer(RETRY_S, again)
    if not again.read():
        ctx.log("capture: both captures dropped device records; the "
                "device metrics are left out")


def release(ctx: Context, st: ServeState) -> None:
    """Read the served face, then free the program's device state."""
    rows = st.corpus.num_docs
    data, cols = st.retriever.scorer_face(st.scorer)
    st.face = compare.face_pairs(data, cols, rows)
    del data, cols
    st.server.close()
    st.server = st.retriever = None
    gc.collect()
    if ctx.cuda:
        import torch
        torch.cuda.empty_cache()


def reference_index(ctx: Context, st: ServeState) -> tfidf.Index:
    cfg = ctx.config
    buckets = word_buckets(st.words.table, st.words.offsets,
                           int(cfg["vocab_size"]), int(cfg["hash_seed"]))
    return tfidf.build_index(buckets[st.corpus.ranks], st.corpus.starts,
                             int(cfg["vocab_size"]), int(cfg["doc_len"]))


def check_sample(ctx: Context, queries, ok: np.ndarray) -> np.ndarray:
    """The requests checked: a seeded sample of the answered ones
    (``ok``), the longest queries always among them."""
    answered = np.flatnonzero(ok)
    if len(answered) == 0:
        return answered
    lens = np.array([len(queries[i].split()) for i in answered])
    longest = np.argsort(-lens, kind="stable")[:16]
    pick = text.sample_rows(ctx.seed, len(answered),
                            int(ctx.cell["check_requests"]), longest)
    return answered[pick]


def query_sizes(ctx: Context, st: ServeState, ix: tfidf.Index,
                n: int = 512):
    """Mean distinct terms and mean postings (documents holding one of
    them) of a query, over a seeded sample of the window's queries."""
    sent = len(st.answers.ok)
    rows = text.sample_rows(ctx.seed + 1, sent, min(n, sent), [])
    terms = [np.unique(tfidf.query_terms(st.queries[i], ix.vocab_size,
                                         int(ctx.config["hash_seed"])))
             for i in rows]
    return (float(np.mean([len(t) for t in terms])),
            float(np.mean([ix.df[t].sum() for t in terms])))


def check(ctx: Context, st: ServeState) -> dict:
    """The served face and a sample of answers against the reference."""
    cfg = ctx.config
    ix = reference_index(ctx, st)
    sc = scorer_dict(st.scorer)
    weights = tfidf.face(ix, sc, "float64")
    numbers = compare.face_numbers(*st.face, ix.doc, ix.term, weights,
                                   ix.vocab_size, ix.num_docs)
    ans = st.answers
    rows = check_sample(ctx, st.queries, ans.ok)
    texts = [st.queries[i] for i in rows]
    vals, ids = ans.vals[rows], ans.ids[rows]
    post = tfidf.invert(ix, weights)
    ref_v, _, ref_n, at = tfidf.search(ix, post, sc, texts, ids.shape[1],
                                       "float64", picks=ids,
                                       hash_seed=int(cfg["hash_seed"]))
    numbers.update(compare.topk_numbers(vals, ids, ref_v, ref_n, at))
    numbers["unanswered"] = st.unanswered
    facts = ctx.observed.facts
    facts["head_slots"] = len(ix.doc)
    tpq, ppq = query_sizes(ctx, st, ix)
    facts["terms_per_query"], facts["postings_per_query"] = tpq, ppq
    ctx.log(f"checked {len(rows)} answers and {len(ix.doc)} face slots")
    return numbers


def reference_control(ctx: Context) -> dict:
    """The control of a served kind (``CONTROL = "reference"``: the
    program has no lower-precision path of its own): the plain reference
    in bfloat16 in the program's place, its face and its answers to the
    sampled queries, judged as the program's are."""
    cfg, traffic = ctx.config, ctx.cell["traffic"]
    words = text.make_words(cfg)
    corpus = text.make_corpus(cfg, ctx.seed, words)
    n = len(text.arrivals(traffic, ctx.seconds)) if "rate" in traffic \
        else int(traffic["clients"]) * 64
    queries = text.make_queries(traffic, cfg, words, ctx.seed, n)
    st = ServeState({}, words, corpus, queries, traffic["scorer"],
                    int(cfg["k"]))
    ix = reference_index(ctx, st)
    sc = scorer_dict(st.scorer)
    ref_w = tfidf.face(ix, sc, "float64")
    low_w = tfidf.face(ix, sc, "bfloat16")
    numbers = compare.face_numbers(ix.doc, ix.term, low_w, ix.doc, ix.term,
                                   ref_w, ix.vocab_size, ix.num_docs)
    rows = check_sample(ctx, queries, np.ones(len(queries), bool))
    texts = [queries[i] for i in rows]
    hs = int(cfg["hash_seed"])
    vals, ids, _, _ = tfidf.search(ix, tfidf.invert(ix, low_w), sc, texts,
                                   st.k, "bfloat16", hash_seed=hs)
    ref_v, _, ref_n, at = tfidf.search(ix, tfidf.invert(ix, ref_w), sc,
                                       texts, st.k, "float64", picks=ids,
                                       hash_seed=hs)
    numbers.update(compare.topk_numbers(vals, ids, ref_v, ref_n, at))
    numbers["unanswered"] = 0
    return {"checks": numbers, "checked": len(rows)}
