"""The port's compact query staging (``models.retrieval.pack_queries`` and
``ops.queryslab``), on the CPU.

* ``pack_queries`` scattered into a zero [V, bucket] block equals the
  dense per-query fill, kept here as it was, bit for bit in both modes:
  seeded random queries, the empty query, repeated words, words no
  document holds, an 80-word query, ``truncate_tokens_at``, a dirty
  reused block and scratch. The native tokenize+hash and the Python one
  give the same ids.
* The slab stages a batch as compact entries: after warm-up no new
  allocation, one upload a batch, ``entries`` the batch's distinct
  terms, and the ``h2d`` span's ``bytes`` the entries' size, not the
  block's. An oversize bucket falls back to the dense block with the
  same answers, and eight threads searching at once get the answers one
  thread gets.
"""

import random
import threading

import numpy as np
import pytest

from tfidf_tpu_torch import obs
from tfidf_tpu_torch.config import PipelineConfig, VocabMode
from tfidf_tpu_torch.io import fast_tokenizer
from tfidf_tpu_torch.io.corpus import Corpus
from tfidf_tpu_torch.models import TfidfRetriever
from tfidf_tpu_torch.models import retrieval as tret
from tfidf_tpu_torch.ops.hashing import words_to_ids
from tfidf_tpu_torch.ops.queryslab import ENTRY_BYTES
from tfidf_tpu_torch.ops.tokenize import whitespace_tokenize

MODES = ("cosine", "counts")
WORDS = [f"w{i}" for i in range(300)] + ["ünïcode", "x" * 40, "a"]


def _cfg(vocab=1 << 12, **kw):
    return PipelineConfig(vocab_mode=VocabMode.HASHED, vocab_size=vocab,
                          hash_seed=kw.pop("hash_seed", 7), **kw)


def _idf(vocab, seed=0, docs=5000):
    """An index's idf: log(N/df) in float64 rounded to float32, 0 where
    no document holds the term."""
    rng = np.random.default_rng(seed)
    df = rng.integers(0, docs + 1, vocab)
    df[rng.random(vocab) < 0.2] = 0
    return np.where(df > 0, np.log(docs / np.maximum(df, 1)),
                    0.0).astype(np.float32)


def _dense_fill(queries, config, idf, out, scratch, mode):
    """The dense per-query fill the compact pack replaced."""
    out.fill(0.0)
    one = np.float32(1.0)
    for j, text in enumerate(queries):
        data = text.encode() if isinstance(text, str) else text
        words = whitespace_tokenize(data, config.truncate_tokens_at)
        if not words:
            continue
        ids = words_to_ids(words, config.vocab_size, config.hash_seed)
        col = out[:, j]
        np.add.at(col, ids, one)
        if mode == "counts":
            continue
        col /= len(words)
        col *= idf
        np.multiply(col, col, out=scratch)
        norm = float(np.sqrt(scratch.sum()))
        if norm > 0:
            col /= norm
        else:
            col.fill(0.0)
    return out


def _random_queries(rng, n, longest=80):
    seps = [" ", "  ", "\t", "\n", " \r\n "]
    out = []
    for _ in range(n):
        words = [rng.choice(WORDS) for _ in range(rng.randint(0, longest))]
        text = "".join(w + rng.choice(seps) for w in words)
        out.append(text.encode() if rng.random() < 0.3 else text)
    return out


EDGE = ["", "   \t\n", "w1 w1 w1", "never seen before", "zzz qqq w1 zzz",
        " ".join(f"w{i % 53}" for i in range(80)), "a", "x" * 40 + " a",
        "zzz zzz"]


def _assert_bits(a, b):
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def _scatter(cols, ids, weights, vocab, bucket):
    block = np.zeros((vocab, bucket), np.float32)
    block[ids, cols] = weights
    return block


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", range(6))
def test_pack_scatters_to_the_dense_fill(mode, seed):
    rng = random.Random(seed)
    cfg = _cfg(vocab=1 << 16 if seed == 0 else 1 << (9 + seed),
               truncate_tokens_at=[None, 3, 1][seed % 3])
    idf = _idf(cfg.vocab_size, seed)
    queries = _random_queries(rng, rng.choice([1, 5, 17, 64]))
    queries[rng.randrange(len(queries))] = ""
    bucket = 1 << max(0, len(queries) - 1).bit_length()
    want = _dense_fill(queries, cfg, idf,
                       np.empty((cfg.vocab_size, bucket), np.float32),
                       np.empty(cfg.vocab_size, np.float32), mode)
    cols, ids, weights = tret.pack_queries(queries, cfg, idf, mode)
    assert cols.dtype == ids.dtype == np.int32
    assert weights.dtype == np.float32
    # by column, then by term id, each (column, term) once
    key = cols.astype(np.int64) * cfg.vocab_size + ids
    assert np.all(np.diff(key) > 0)
    _assert_bits(_scatter(cols, ids, weights, cfg.vocab_size, bucket), want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("trunc", [None, 2])
def test_edge_queries_and_dirty_buffers(mode, trunc):
    cfg = _cfg(truncate_tokens_at=trunc)
    idf = _idf(cfg.vocab_size, 11)
    idf[words_to_ids([b"zzz"], cfg.vocab_size, cfg.hash_seed)] = 0.0
    rng = np.random.default_rng(3)
    dirty = rng.standard_normal((cfg.vocab_size, 16)).astype(np.float32)
    scratch = rng.standard_normal(cfg.vocab_size).astype(np.float32)
    got = tret.fill_query_matrix(EDGE, cfg, idf, dirty, scratch=scratch,
                                 mode=mode)
    want = _dense_fill(EDGE, cfg, idf, np.empty_like(dirty),
                       np.empty_like(scratch), mode)
    _assert_bits(got, want)
    _assert_bits(tret.query_matrix(EDGE, cfg, idf, pad_to=16, mode=mode),
                 want)
    # the empty queries hold no entry; a column of norm 0 is all zero
    cols, _, weights = tret.pack_queries(EDGE, cfg, idf, mode)
    assert not np.isin([0, 1], cols).any()
    assert not want[:, 1].any() and not want[:, 0].any()
    assert tret.pack_queries(["", " "], cfg, idf, mode)[0].size == 0
    assert tret.pack_queries([], cfg, idf, mode)[0].size == 0
    assert weights[cols == 2].tolist() == (
        [1.0] if mode == "cosine" else [3.0])
    # "zzz" has idf 0: its cosine column has norm 0 and keeps its entry
    assert weights[cols == 8].tolist() == (
        [0.0] if mode == "cosine" else [2.0])


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown query mode"):
        tret.pack_queries(["w1"], _cfg(), _idf(1 << 12), "bm42")


@pytest.mark.parametrize("trunc", [None, 1, 4])
def test_native_and_python_hashing_agree(trunc, monkeypatch):
    assert fast_tokenizer.available(), fast_tokenizer.load_error()
    cfg = _cfg(truncate_tokens_at=trunc)
    queries = _random_queries(random.Random(5), 40) + EDGE
    native = tret._query_term_ids(queries, cfg)
    packed = tret.pack_queries(queries, cfg, _idf(cfg.vocab_size), "cosine")
    monkeypatch.setenv("TFIDF_TPU_NO_NATIVE", "1")
    assert not fast_tokenizer.available()
    python = tret._query_term_ids(queries, cfg)
    for a, b in zip(native, python):
        assert np.array_equal(a, b)
    for a, b in zip(packed, tret.pack_queries(queries, cfg,
                                              _idf(cfg.vocab_size),
                                              "cosine")):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


# --- the slab ------------------------------------------------------------

SLAB_CFG = PipelineConfig(vocab_mode=VocabMode.HASHED, vocab_size=1 << 12,
                          max_doc_len=32, doc_chunk=32)


@pytest.fixture(scope="module")
def retriever():
    rng = random.Random(2)
    docs = [" ".join(rng.choice(WORDS[:120]) for _ in range(rng.randint(2, 30)))
            .encode() for _ in range(200)]
    return TfidfRetriever(SLAB_CFG, device="cpu").index(
        Corpus(names=[f"doc{i}" for i in range(200)], docs=docs))


def _batches(n, seed, widths=(3, 7, 8)):
    """``n`` batches of 3 to 8 queries (buckets 4 and 8), up to 60 words
    a query."""
    rng = random.Random(seed)
    return [[t.decode() if isinstance(t, bytes) else t
             for t in _random_queries(rng, rng.choice(widths), 60)]
            for _ in range(n)]


def _distinct_terms(batch):
    return sum(len(np.unique(words_to_ids(
        whitespace_tokenize(q.encode()), SLAB_CFG.vocab_size,
        SLAB_CFG.hash_seed))) for q in batch if q.split())


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(
            np.ascontiguousarray(x).view(np.uint8),
            np.ascontiguousarray(y).view(np.uint8))


def _fresh(r):
    r.query_slab, r._slab = True, None
    return r


@pytest.mark.parametrize("scorer", ["tfidf", "bm25"])
def test_warm_slab_allocates_nothing(retriever, scorer):
    r = _fresh(retriever)
    # warm-up: a batch of each bucket
    for b in _batches(1, seed=1, widths=[4]) + _batches(1, 1, widths=[8]):
        r.search(b, k=5, scorer=scorer)
    before = r._slab.stats()
    batches = _batches(12, seed=2)
    for b in batches:
        r.search(b, k=5, scorer=scorer)
    after = r._slab.stats()
    assert after["allocs"] == before["allocs"]
    assert after["packs"] - before["packs"] == len(batches)
    assert after["h2d_copies"] - before["h2d_copies"] == len(batches)
    entries = after["entries"] - before["entries"]
    assert entries == sum(_distinct_terms(b) for b in batches)
    assert after["bytes_h2d"] - before["bytes_h2d"] == ENTRY_BYTES * entries
    assert after["fallbacks"] == 0


def test_h2d_span_carries_the_compact_bytes(retriever):
    r = _fresh(retriever)
    batch = _batches(1, seed=3)[0]
    r.search(batch, k=3)
    obs.set_tracer(obs.Tracer())
    try:
        r.search(batch, k=3)
        events = obs.get_tracer().events()
    finally:
        obs.set_tracer(None)
    h2d = [e for e in events if e[0] == "h2d"]
    fill = [e for e in events if e[0] == "fill_query"]
    assert len(h2d) == len(fill) == 1
    entries = _distinct_terms(batch)
    assert h2d[0][4] == {"bytes": ENTRY_BYTES * entries, "entries": entries}
    bucket = 1 << (len(batch) - 1).bit_length()
    assert h2d[0][4]["bytes"] < SLAB_CFG.vocab_size * bucket * 4
    assert fill[0][4] == {"queries": bucket, "mode": "cosine"}


def test_a_batch_past_the_buffer_grows_it_once(retriever):
    r = _fresh(retriever)
    # bucket 8 starts with room for 1,024 entries; this batch has ~2,300
    wide = [" ".join(WORDS[i:] + WORDS[:i]) for i in range(0, 240, 30)]
    r.search(["w1"] * 8, k=3)
    first = r._slab.stats()["allocs"]
    want = r.search(wide, k=3)
    grown = r._slab.stats()["allocs"]
    assert grown == first + 1
    _same(r.search(wide, k=3), want)
    assert r._slab.stats()["allocs"] == grown
    r.query_slab = False
    _same(r.search(wide, k=3), want)


def test_oversize_bucket_falls_back_with_the_same_bits(retriever,
                                                       monkeypatch):
    r = _fresh(retriever)
    batch = _batches(1, seed=4)[0] + _batches(1, seed=5)[0]
    want = r.search(batch, k=6)
    assert r._slab.stats()["fallbacks"] == 0
    monkeypatch.setenv("TFIDF_TPU_MAX_BATCH", "4")
    r._slab = None
    for scorer in ("tfidf", "bm25"):
        got = r.search(batch, k=6, scorer=scorer)
        if scorer == "tfidf":
            _same(got, want)
    stats = r._slab.stats()
    assert stats["fallbacks"] == 2 and stats["packs"] == 0
    monkeypatch.setenv("TFIDF_TPU_QUERY_SLAB", "off")
    r.query_slab = None
    _same(r.search(batch, k=6), want)


def test_eight_threads_get_the_single_threaded_answers(retriever):
    r = _fresh(retriever)
    batches = _batches(24, seed=6)
    scorers = ["tfidf", "bm25"]
    want = {(i, s): r.search(b, k=4, scorer=s)
            for i, b in enumerate(batches) for s in scorers}
    got, errors = {}, []

    def worker(t):
        try:
            for rep in range(3):
                for i in range(t, len(batches), 3):
                    s = scorers[(i + rep + t) % 2]
                    got[(t, rep, i, s)] = r.search(batches[i], k=4,
                                                   scorer=s)
        except BaseException as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors and len(got) == sum(
        3 * len(range(t, len(batches), 3)) for t in range(8))
    for (_t, _rep, i, s), ans in got.items():
        _same(ans, want[(i, s)])
    stats = r._slab.stats()
    assert stats["h2d_copies"] == stats["packs"]
