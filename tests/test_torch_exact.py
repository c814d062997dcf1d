"""The port's exact-terms mode against the JAX package, on the CPU.

Both engines of ``rerank.exact_terms_lines`` (device-exact on the intern
wire, hashed re-rank on the ids-only wire) with the pieces under them:
the native bindings (``io.fast_tokenizer``), ``ops.sparse.
sparse_topk_counts``, the ids-only and exact-ids result wires,
``ingest.run_overlapped_exact``, ``ingest.profile_resident``,
``recall.py`` and the ``cli run`` flags of the mode. Tolerances: bytes,
ids, counts, DF and every integer exact; scores exact float64 (the host
rescores from integers); a score from the device's float32 selection
equal to the JAX package's bit for bit (both compute count/len * idf
from the same float32 idf).

The JAX side of every exact comparison is ``tfidf_tpu.golden`` or the
JAX package run with ``TFIDF_TPU_NO_NATIVE=1`` (its Python engines): no
test here reads ``native/fast_tokenizer.so``. The port's native host
library is built by ``ops/_build.py`` (g++), and a failed build fails.
"""

import dataclasses
import os
import random

import numpy as np
import pytest
import torch

import tfidf_tpu_torch as T
from tfidf_tpu import ingest as jing
from tfidf_tpu import recall as jrecall
from tfidf_tpu import rerank as jrerank
from tfidf_tpu.config import PipelineConfig as JConfig
from tfidf_tpu.config import VocabMode as JV
from tfidf_tpu.golden import golden_lines, golden_output
from tfidf_tpu.io.corpus import Corpus as JCorpus
from tfidf_tpu.io.corpus import discover_corpus as jax_discover
from tfidf_tpu.ops.tokenize import whitespace_tokenize
from tfidf_tpu_torch import ingest as ing
from tfidf_tpu_torch import recall, rerank
from tfidf_tpu_torch.io import fast_tokenizer as ft
from tfidf_tpu_torch.ops import _build
from tfidf_tpu_torch.ops.sparse import (pick_counts, sorted_term_counts,
                                        sparse_topk_counts)

DOC_LEN = 64
K = 5


@pytest.fixture(scope="module", autouse=True)
def native_built():
    """The port's host library must build (g++) and load here."""
    os.environ.pop("TFIDF_TPU_NO_NATIVE", None)
    _build.load_host()
    assert ft.intern_available() and ft.rerank_available(), ft.load_error()


@pytest.fixture
def jax_python(monkeypatch):
    """Run a JAX-package call on its Python engines (no native library),
    then restore the environment."""
    class _Ctx:
        def __enter__(self):
            monkeypatch.setenv("TFIDF_TPU_NO_NATIVE", "1")

        def __exit__(self, *exc):
            monkeypatch.delenv("TFIDF_TPU_NO_NATIVE", raising=False)
    return _Ctx()


def _write(root, docs):
    root.mkdir(exist_ok=True)
    for i, d in enumerate(docs, 1):
        (root / f"doc{i}").write_bytes(d)
    return str(root)


def _exact_docs():
    """70 docs over 300 words, lengths 0..100 (so some past DOC_LEN and
    many shorter), a doc of 40 corpus-hapax words (one tie group wider
    than any margin), two empty docs and a whitespace-only one."""
    rng = random.Random(5)
    words = [f"word{i}" for i in range(300)]
    docs = [" ".join(rng.choice(words) for _ in range(rng.randint(1, 100)))
            .encode() for _ in range(70)]
    docs[9] = b""
    docs[21] = b""
    docs[33] = b" \t\n "
    docs.append(b" ".join(b"hapax%d" % j for j in range(40)))
    return docs


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("exact"), _exact_docs())


def _cfg(vocab=1 << 12, topk=4 * K, **kw):
    return T.PipelineConfig(vocab_mode=T.VocabMode.HASHED, vocab_size=vocab,
                            topk=topk, engine="sparse", **kw)


def _jcfg(vocab=1 << 12, topk=4 * K, **kw):
    return JConfig(vocab_mode=JV.HASHED, vocab_size=vocab, topk=topk,
                   engine="sparse", **kw)


def _golden_topk_bytes(input_dir, k=K, doc_len=DOC_LEN):
    """The per-doc top-k (score desc, word asc, positive scores) of the
    JAX golden path's lines over the documents truncated to doc_len
    tokens, as sorted output bytes."""
    c = jax_discover(input_dir)
    trunc = JCorpus(names=c.names, docs=[b" ".join(
        whitespace_tokenize(d, None)[:doc_len]) for d in c.docs])
    per = {}
    for line in golden_lines(trunc):
        key, score = line.rsplit(b"\t", 1)
        doc, word = key.split(b"@", 1)
        if float(score) > 0:
            per.setdefault(doc, []).append((-float(score), word, line))
    out = sorted(line for rows in per.values()
                 for _, _, line in sorted(rows)[:k])
    return b"".join(line + b"\n" for line in out)


# --- native bindings ------------------------------------------------

@pytest.mark.parametrize("cap,align", [(1 << 10, 1), (1 << 10, 16),
                                       (1 << 17, 4)])
def test_intern_pack_round_trip(corpus_dir, cap, align):
    names = [f"doc{i}" for i in range(1, 72)]
    paths = [os.path.join(corpus_dir, n) for n in names]
    with ft.InternSession(cap) as sess:
        flat, lens, total = sess.pack_flat(paths, None, DOC_LEN,
                                           pad_docs_to=80, align=align)
        words = sess.words()
        assert sess.count == len(words) == len(set(words))
    assert flat.dtype == (np.int32 if cap > 1 << 16 else np.uint16)
    assert lens.shape == (80,) and not lens[71:].any()
    pos = 0
    for i, p in enumerate(paths):
        toks = whitespace_tokenize(open(p, "rb").read(), None)[:DOC_LEN]
        assert lens[i] == len(toks)
        assert [words[j] for j in flat[pos:pos + len(toks)]] == toks
        pos += -(-len(toks) // align) * align
    assert pos == total


def test_intern_overflow_and_kill_switch(corpus_dir, monkeypatch):
    paths = [os.path.join(corpus_dir, f"doc{i}") for i in range(1, 72)]
    with ft.InternSession(64) as sess:
        with pytest.raises(ft.ExactVocabOverflow):
            sess.pack_flat(paths, None, DOC_LEN)
    monkeypatch.setenv("TFIDF_TPU_NO_NATIVE", "1")
    assert not ft.intern_available() and not ft.rerank_available()
    with pytest.raises(RuntimeError, match="intern table unavailable"):
        ft.InternSession(64)
    assert ft.tokenize_spans(b"a b") is None
    assert ft.exact_rerank_paths(paths, np.zeros((71, 2), np.int32), 71,
                                 64) is None


@pytest.mark.parametrize("data", [b"", b"  ", b"a", b" a\tbb\n\x0bccc\x0c\r d ",
                                  "héllo wörld 中文".encode()])
def test_tokenize_spans(data):
    assert ft.tokenize_spans(data) == whitespace_tokenize(data, None)


# --- sparse_topk_counts ---------------------------------------------

def _tie_triples(seed=0, d=24, length=40):
    """Sorted triples of tie-heavy rows: few distinct ids, repeated
    counts, an idf with three values, empty rows and full rows."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 12, (d, length)).astype(np.int32)
    lens = rng.integers(0, length + 1, d).astype(np.int32)
    lens[:3] = [0, 1, length]
    ids, counts, head = sorted_term_counts(torch.from_numpy(toks),
                                           torch.from_numpy(lens))
    idf = torch.tensor([0.5, 1.25, 0.0] * 4, dtype=torch.float32)
    return ids, counts, head, torch.from_numpy(lens), idf


@pytest.mark.parametrize("k", [1, 4, 12, 50])
@pytest.mark.parametrize("seed", [0, 1])
def test_sparse_topk_counts_matches_jax(k, seed):
    import jax.numpy as jnp

    from tfidf_tpu.ops.sparse import sparse_scores as jscores
    from tfidf_tpu.ops.sparse import sparse_topk_counts as jtopk
    ids, counts, head, lens, idf = _tie_triples(seed)
    j = [jnp.asarray(t.numpy()) for t in (ids, counts, head, lens, idf)]
    want = jtopk(jscores(*j), j[0], j[1], j[2], k)
    got = sparse_topk_counts(ids, counts, head, lens, idf, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the CUDA route's count recovery, from the plain selection's ids
    assert torch.equal(pick_counts(ids, counts, got[1]), got[2])


# --- the ids-only and exact-ids wires --------------------------------

def _chunks(seed=3, n_chunks=2, d=16, length=24, vocab=1 << 10):
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(n_chunks):
        toks = rng.integers(0, vocab, (d, length)).astype(np.int32)
        toks[:, ::3] = rng.integers(0, 8, (d, -(-length // 3)))
        lens = rng.integers(0, length + 1, d).astype(np.int32)
        i_, c_, h_ = sorted_term_counts(torch.from_numpy(toks),
                                        torch.from_numpy(lens))
        parts.append((i_, c_, h_, torch.from_numpy(lens)))
    df = torch.zeros(vocab, dtype=torch.int32)
    for i_, _, h_, _ in parts:
        df.index_add_(0, i_[h_].long(), torch.ones(int(h_.sum()),
                                                   dtype=torch.int32))
    return [list(p) for p in zip(*parts)], df


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("wire", ["ids", "exact"])
def test_result_wires_match_jax(wire, wide):
    import jax.numpy as jnp
    (ids_p, cnt_p, head_p, lens_p), df = _chunks()
    n_docs, k = 30, 6
    kw = dict(include_vals=False, include_counts=wire == "exact")
    _, ours = ing._score_pack_wire(ids_p, cnt_p, head_p, lens_p, df, n_docs,
                                   topk=k, score_dtype=torch.float32,
                                   wide_ids=wide, **kw)
    js = lambda parts: tuple(jnp.asarray(p.numpy()) for p in parts)
    _, theirs = jing._score_pack_wire(
        js(ids_p), js(cnt_p), js(head_p), js(lens_p),
        jnp.asarray(df.numpy()), jnp.int32(n_docs), topk=k,
        score_dtype=jnp.float32, wide_ids=wide, join="gather", **kw)
    buf = ours.numpy()
    np.testing.assert_array_equal(buf, np.asarray(theirs))
    d_padded = 32
    if wire == "exact":
        got = ing._decode_wire_exact(buf, d_padded, k, wide)
        want = jing._decode_wire_exact(np.asarray(theirs), d_padded, k, wide)
        # round trip: the decode is the selection the device made
        from tfidf_tpu_torch.ops.scoring import idf_from_df
        _, tids, cnt = sparse_topk_counts(
            torch.cat(ids_p), torch.cat(cnt_p), torch.cat(head_p),
            torch.cat(lens_p), idf_from_df(df, n_docs, torch.float32), k)
        np.testing.assert_array_equal(got[1], cnt.numpy())
        ok = cnt.numpy() > 0
        np.testing.assert_array_equal(got[0][ok], tids.numpy()[ok])
        np.testing.assert_array_equal(got[2], df.numpy())
    else:
        got = ing._decode_wire(buf, d_padded, k, wide, torch.float32,
                               include_vals=False)
        want = jing._decode_wire(np.asarray(theirs), d_padded, k, wide,
                                 np.float32, include_vals=False)
        assert got[0] is None and want[0] is None
        assert got[2] == want[2] == int((df > 0).sum())
        got, want = got[1:], want[1:]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_exact_wire_refuses_wide_counts():
    (ids_p, cnt_p, head_p, lens_p), df = _chunks()
    big = [torch.zeros((1, 1 << 16), dtype=torch.int32)]
    with pytest.raises(ValueError, match="doc_len must be < 65536"):
        ing._score_pack_wire(big, big, [torch.zeros((1, 1 << 16),
                                                    dtype=torch.bool)],
                             [torch.zeros(1, dtype=torch.int32)], df, 1,
                             topk=2, score_dtype=torch.float32,
                             wide_ids=False, include_vals=False,
                             include_counts=True)


# --- the device-exact engine ----------------------------------------

def test_exact_ingest_integers(corpus_dir):
    ex = ing.run_overlapped_exact(corpus_dir, _cfg(topk=K + 8),
                                  chunk_docs=16, doc_len=DOC_LEN,
                                  device="cpu")
    assert ex.num_docs == 71 and ex.names == [f"doc{i}" for i in range(1, 72)]
    docs = [whitespace_tokenize(open(os.path.join(corpus_dir, n), "rb")
                                .read(), None)[:DOC_LEN] for n in ex.names]
    np.testing.assert_array_equal(ex.lengths, [len(t) for t in docs])
    df = {}
    for toks in docs:
        for w in set(toks):
            df[w] = df.get(w, 0) + 1
    assert {ex.words[i]: int(c) for i, c in enumerate(ex.df)
            if i < len(ex.words)} == df
    assert not ex.df[len(ex.words):].any()
    for d, toks in enumerate(docs):
        for wid, c in zip(ex.topk_ids[d], ex.topk_counts[d]):
            if c > 0:
                assert toks.count(ex.words[wid]) == c
    assert set(ex.phases) >= {"pack", "put", "pack_host", "fetch"}


def test_exact_topk_from_wire_matches_jax(corpus_dir, jax_python):
    ex = ing.run_overlapped_exact(corpus_dir, _cfg(topk=K + 8),
                                  chunk_docs=16, doc_len=DOC_LEN,
                                  device="cpu")
    ours = rerank.exact_topk_from_wire(ex, K, corpus_dir, _cfg(),
                                       max_tokens=DOC_LEN)
    jex = jing.ExactIngest(**{f.name: getattr(ex, f.name)
                              for f in dataclasses.fields(ex)})
    with jax_python:
        theirs = jrerank.exact_topk_from_wire(jex, K, corpus_dir, _jcfg(),
                                              max_tokens=DOC_LEN)
    assert ours == theirs
    # the hapax doc is a boundary tie, resolved word-ascending
    assert [w for w, _ in ours["doc71"]] == [b"hapax0", b"hapax1",
                                             b"hapax10", b"hapax11",
                                             b"hapax12"]


@pytest.mark.parametrize("chunk_docs", [16, 4096])
def test_device_exact_lines_equal_golden(corpus_dir, chunk_docs):
    lines, engine, sample = rerank.exact_terms_lines(
        corpus_dir, _cfg(), K, doc_len=DOC_LEN, chunk_docs=chunk_docs,
        device="cpu")
    assert engine == "device-exact"
    assert lines == _golden_topk_bytes(corpus_dir)
    per, engine2 = rerank.exact_terms(corpus_dir, _cfg(), K, doc_len=DOC_LEN,
                                      chunk_docs=chunk_docs, device="cpu")
    assert engine2 == "device-exact"
    assert sample(["doc1", "doc71", "doc10"]) == {
        n: per[n] for n in ("doc1", "doc71", "doc10")}
    assert sorted(b"%s@%s\t%.16f" % (n.encode(), w, s)
                  for n, terms in per.items() for w, s in terms) \
        == lines.splitlines()


def test_device_exact_lines_in_native_oracle(corpus_dir, tmp_path):
    """Every line is a line of the native bit-reference's output (built
    by ``ops/_build.py``), and the exact recall is 1.0 on every doc
    (the corpus fits DOC_LEN for the oracle: it does not truncate)."""
    import subprocess
    short = _write(tmp_path / "short", [
        b" ".join(whitespace_tokenize(open(os.path.join(
            corpus_dir, f"doc{i}"), "rb").read(), None)[:DOC_LEN])
        for i in range(1, 72)])
    lines, engine, sample = rerank.exact_terms_lines(
        short, _cfg(), K, doc_len=DOC_LEN, chunk_docs=16, device="cpu")
    assert engine == "device-exact"
    out = tmp_path / "oracle.txt"
    subprocess.run([str(_build.load_oracle()), short, str(out), "3"],
                   check=True, stdout=subprocess.DEVNULL)
    oracle = set(out.read_bytes().splitlines())
    got = lines.splitlines()
    assert len(got) > 200 and set(got) <= oracle
    ref = recall.parse_oracle_output(str(out))
    names = [f"doc{i}" for i in range(1, 72)]
    per = sample(names)
    rec = [recall.exact_doc_recall(ref.get(n, []), [w for w, _ in per[n]], K)
           for n in names]
    assert all(r == 1.0 for r in rec if r is not None)
    assert sum(r is not None for r in rec) > 60


def test_overflow_switches_to_hashed_rerank(corpus_dir, jax_python):
    """More distinct words than the vocab: ExactVocabOverflow takes the
    hashed re-rank engine (logged), whose lines (the port's native
    re-rank) equal the JAX package's Python re-rank's bytes."""
    from tfidf_tpu_torch.obs import log as obs_log
    log = obs_log.EventLog(echo="off")
    obs_log.set_log(log)
    try:
        lines, engine, _ = rerank.exact_terms_lines(
            corpus_dir, _cfg(vocab=256), K, doc_len=DOC_LEN, chunk_docs=16,
            device="cpu")
    finally:
        obs_log.set_log(None)
    assert engine == "hashed-rerank"
    events = [e for e in log.events() if e["event"] == "exact_engine_fallback"]
    assert len(events) == 1 and "distinct words" in events[0]["error"]
    with jax_python:
        want, jengine, _ = jrerank.exact_terms_lines(
            corpus_dir, _jcfg(vocab=256), K, doc_len=DOC_LEN, chunk_docs=16)
    assert jengine == "hashed-rerank" and lines == want


@pytest.mark.parametrize("vocab,regime", [(1 << 12, "resident"),
                                          (1 << 12, "streaming"),
                                          (70000, "resident")])
def test_no_native_rerank_lines_equal_jax(corpus_dir, monkeypatch, vocab,
                                          regime):
    monkeypatch.setenv("TFIDF_TPU_NO_NATIVE", "1")
    if regime == "streaming":
        monkeypatch.setenv("TFIDF_TPU_RESIDENT_ELEMS", "0")
    lines, engine, _ = rerank.exact_terms_lines(
        corpus_dir, _cfg(vocab=vocab), K, doc_len=DOC_LEN, chunk_docs=16,
        device="cpu")
    want, jengine, _ = jrerank.exact_terms_lines(
        corpus_dir, _jcfg(vocab=vocab), K, doc_len=DOC_LEN, chunk_docs=16)
    assert engine == jengine == "hashed-rerank"
    assert lines == want and lines


def test_exact_topk_native_equals_python(corpus_dir, jax_python):
    """exact_topk over a hashed selection: the port's native re-rank
    (every doc) equals the JAX package's Python passes, and the port's
    own Python passes (a doc subset) equal both."""
    r = T.run_overlapped(corpus_dir, _cfg(), chunk_docs=16, doc_len=DOC_LEN,
                         wire_vals=False, device="cpu")
    args = (corpus_dir, r.names, r.topk_ids, r.num_docs)
    ours = rerank.exact_topk(*args, _cfg(), k=K, max_tokens=DOC_LEN)
    sub = rerank.exact_topk(*args, _cfg(), k=K, max_tokens=DOC_LEN,
                            docs=r.names[:20])
    with jax_python:
        theirs = jrerank.exact_topk(*args, _jcfg(), k=K, max_tokens=DOC_LEN)
    assert ours == theirs and sub == {n: theirs[n] for n in r.names[:20]}


def test_margin_check_matches_jax():
    for df in (np.zeros(100), np.r_[np.ones(20), np.zeros(80)],
               np.r_[np.ones(60), np.zeros(40)]):
        for m in (2, 4, 8):
            assert rerank.margin_check(df, m) == jrerank.margin_check(df, m)
            occ = int((df > 0).sum())
            assert rerank.margin_check(None, m, occupied=occ,
                                       vocab_size=100) \
                == jrerank.margin_check(None, m, occupied=occ,
                                        vocab_size=100)


def test_device_cfg_matches_jax():
    for topk, k in ((None, 5), (20, 5), (6, 5), (5, 5), (100, 16)):
        got = rerank._device_cfg(_cfg(topk=topk), k).topk
        assert got == jrerank._device_cfg(_jcfg(topk=topk), k).topk


# --- run_overlapped(wire_vals=False) ---------------------------------

@pytest.mark.parametrize("env", [{}, {"TFIDF_TPU_RESIDENT_ELEMS": "0"},
                                 {"TFIDF_TPU_WIRE": "padded"}])
def test_ids_only_ingest_matches_jax(corpus_dir, monkeypatch, env):
    monkeypatch.setenv("TFIDF_TPU_NO_NATIVE", "1")
    for key, v in env.items():
        monkeypatch.setenv(key, v)
    r = T.run_overlapped(corpus_dir, _cfg(), chunk_docs=16, doc_len=DOC_LEN,
                         wire_vals=False, device="cpu")
    j = jing.run_overlapped(corpus_dir, _jcfg(), chunk_docs=16,
                            doc_len=DOC_LEN, wire_vals=False)
    np.testing.assert_array_equal(r.topk_ids, j.topk_ids)
    np.testing.assert_array_equal(r.df, np.asarray(j.df))
    np.testing.assert_array_equal(r.lengths, j.lengths)
    assert (r.path, r.result_wire, r.df_occupied, r.bytes_off_wire) \
        == (j.path, j.result_wire, j.df_occupied, j.bytes_off_wire)
    if r.path == "resident":
        assert r.topk_vals is None and j.topk_vals is None
        assert (r.topk_ids >= 0).all()  # a missing pick reads bucket 0
    else:  # advisory in the streaming regime: full scores
        np.testing.assert_array_equal(r.topk_vals, j.topk_vals)


# --- profile_resident -------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"finish": "chunked"},
                                {"result_wire": "pair"}, {"wire": "bytes"},
                                {"wire": "padded"}])
def test_profile_resident_matches_jax(corpus_dir, monkeypatch, kw):
    monkeypatch.setenv("TFIDF_TPU_NO_NATIVE", "1")
    ours = ing.profile_resident(corpus_dir, _cfg(topk=K, **kw),
                                chunk_docs=16, doc_len=DOC_LEN, device="cpu")
    theirs = jing.profile_resident(corpus_dir, _jcfg(topk=K, **kw),
                                   chunk_docs=16, doc_len=DOC_LEN)
    assert set(ours) == set(theirs)
    for key in ours:
        if key.startswith("bytes_") or key == "n_phase_b_dispatches":
            assert ours[key] == theirs[key], key
        else:
            assert ours[key] >= 0.0, key
    assert ours["compute_marginal"] >= ours["compute_warm"] / 16


# --- recall -----------------------------------------------------------

def test_recall_matches_jax(tmp_path):
    rng = np.random.default_rng(9)
    words = [b"w%d" % i for i in range(40)]
    ref = {f"doc{d}": [(w, float(s)) for w, s in zip(
        rng.choice(words, 12, replace=False),
        np.round(rng.random(12), 1))] for d in range(1, 9)}
    ref["doc8"] = [(b"w1", 0.0)]
    p = tmp_path / "o.txt"
    p.write_bytes(b"".join(b"%s@%s\t%.16f\n" % (n.encode(), w, s)
                           for n, t in ref.items() for w, s in t))
    for docs in (None, ["doc2", "doc5"]):
        assert recall.parse_oracle_output(str(p), docs) \
            == jrecall.parse_oracle_output(str(p), docs)
    names = list(ref)
    ids = rng.integers(-1, 1 << 10, (8, 6)).astype(np.int32)
    vals = rng.random((8, 6)).astype(np.float32)
    for k in (1, 3, 6):
        for n in names:
            d = names.index(n)
            assert recall.doc_recall(ref[n], ids[d], vals[d], k, 1 << 10) \
                == jrecall.doc_recall(ref[n], ids[d], vals[d], k, 1 << 10)
            got = [w for w, _ in ref[n][::2]]
            assert recall.exact_doc_recall(ref[n], got, k) \
                == jrecall.exact_doc_recall(ref[n], got, k)
        assert recall.corpus_recall(ref, names, ids, vals, k, 1 << 10) \
            == jrecall.corpus_recall(ref, names, ids, vals, k, 1 << 10)
        qa = rng.integers(-1, 20, (5, 8))
        qb = rng.integers(-1, 20, (5, 8))
        assert recall.retrieval_recall_at_k(qa, qb, k) \
            == jrecall.retrieval_recall_at_k(qa, qb, k)
        assert recall.scorer_overlap_at_k(qa, qb, k) \
            == jrecall.scorer_overlap_at_k(qa, qb, k)
    with pytest.raises(ValueError):
        recall.retrieval_recall_at_k(np.zeros((2, 3)), np.zeros((3, 3)), 2)


# --- cli run ----------------------------------------------------------

def _cli_pair(tmp_path, args, jax_python):
    """(port bytes, JAX bytes) of one ``run``: the JAX side on its Python
    engines, the port on the CPU."""
    from tfidf_tpu.cli import main as jax_main
    from tfidf_tpu_torch.cli import main as port_main
    ours, theirs = tmp_path / "ours.txt", tmp_path / "theirs.txt"
    assert port_main(["run", *args, "--output", str(ours),
                      "--device", "cpu"]) == 0
    with jax_python:
        assert jax_main(["run", *args, "--output", str(theirs)]) == 0
    return ours.read_bytes(), theirs.read_bytes()


def test_cli_exact_terms_overlapped(corpus_dir, tmp_path, jax_python,
                                    monkeypatch, capsys):
    args = ["--input", corpus_dir, "--vocab-mode", "hashed", "--topk",
            str(K), "--doc-len", str(DOC_LEN), "--exact-terms",
            "--chunk-docs", "16"]
    from tfidf_tpu_torch.cli import main as port_main
    out = tmp_path / "dev.txt"
    assert port_main(["run", *args, "--output", str(out), "--device", "cpu",
                      "--timing"]) == 0
    assert out.read_bytes() == _golden_topk_bytes(corpus_dir)
    assert "engine: device-exact" in capsys.readouterr().err
    monkeypatch.setenv("TFIDF_TPU_NO_NATIVE", "1")  # both: hashed re-rank
    ours, theirs = _cli_pair(tmp_path, args, jax_python)
    assert ours == theirs and ours


def test_cli_exact_terms_batch(corpus_dir, tmp_path, jax_python):
    ours, theirs = _cli_pair(tmp_path, ["--input", corpus_dir,
                                        "--vocab-mode", "hashed", "--topk",
                                        str(K), "--exact-terms"], jax_python)
    assert ours == theirs and ours


def test_cli_no_strict(tmp_path, jax_python):
    """A directory of files not named doc<i> runs with --no-strict in
    both CLIs and writes the same bytes (batch and overlapped routes)."""
    src = tmp_path / "in"
    src.mkdir()
    (src / "a.txt").write_bytes(b"alpha beta gamma alpha\n")
    (src / "b.txt").write_bytes(b"beta delta  eps\tbeta zeta\n")
    (src / "c.md").write_bytes(b"gamma gamma eps\n")
    for extra in ([], ["--vocab-mode", "hashed", "--topk", "2", "--doc-len",
                       "8"],
                  ["--vocab-mode", "hashed", "--topk", "2", "--doc-len",
                   "8", "--exact-terms"]):
        ours, theirs = _cli_pair(tmp_path, ["--input", str(src),
                                            "--no-strict", *extra],
                                 jax_python)
        assert ours == theirs and ours


def test_cli_inspect_stdout(toy_corpus_dir, tmp_path, capsys):
    from tfidf_tpu.cli import main as jax_main
    from tfidf_tpu_torch.cli import main as port_main
    out = str(tmp_path / "o.txt")
    assert port_main(["run", "--input", toy_corpus_dir, "--inspect",
                      "--output", out, "--device", "cpu"]) == 0
    ours = capsys.readouterr().out
    assert jax_main(["run", "--input", toy_corpus_dir, "--inspect",
                     "--output", out]) == 0
    assert ours == capsys.readouterr().out and "TF Job" in ours


@pytest.mark.parametrize("comm", ["thread", "process"])
def test_cli_backend_mpi(toy_corpus_dir, tmp_path, comm):
    """--backend mpi runs the native bit-reference (built into _build/):
    the JAX CLI's bytes (its golden path and the golden oracle)."""
    from tfidf_tpu.cli import main as jax_main
    from tfidf_tpu_torch.cli import main as port_main
    ours, theirs = tmp_path / "ours.txt", tmp_path / "theirs.txt"
    assert port_main(["run", "--input", toy_corpus_dir, "--backend", "mpi",
                      "--nranks", "3", "--comm", comm, "--output",
                      str(ours)]) == 0
    assert jax_main(["run", "--input", toy_corpus_dir, "--output",
                     str(theirs)]) == 0
    assert ours.read_bytes() == theirs.read_bytes() \
        == golden_output(jax_discover(toy_corpus_dir))


@pytest.mark.parametrize("args,code,text", [
    (["--exact-terms"], 2, "--exact-terms needs --topk"),
    (["--exact-terms", "--topk", "2", "--vocab-mode", "hashed",
      "--tokenizer", "chargram"], 2, "--exact-terms needs --topk"),
    (["--exact-terms", "--topk", "2", "--vocab-mode", "hashed",
      "--doc-len", "8", "--wire", "bytes"], 0, "--wire=bytes needs"),
    (["--exact-terms", "--topk", "2", "--vocab-mode", "hashed",
      "--doc-len", "8", "--finish", "scan"], 0,
     "--finish=scan needs the packed result wire"),
    (["--ingest-workers", "0"], 2, "--ingest-workers must be >= 1"),
])
def test_cli_gating_matches_jax(toy_corpus_dir, tmp_path, capsys, monkeypatch,
                                args, code, text):
    from tfidf_tpu.cli import main as jax_main
    from tfidf_tpu_torch.cli import main as port_main
    monkeypatch.setenv("TFIDF_TPU_NO_NATIVE", "1")
    base = ["run", "--input", toy_corpus_dir]
    assert port_main(base + ["--output", str(tmp_path / "a"), "--device",
                             "cpu"] + args) == code
    port_err = capsys.readouterr().err
    assert jax_main(base + ["--output", str(tmp_path / "b")] + args) == code
    jax_err = capsys.readouterr().err
    assert [l for l in port_err.splitlines() if text in l] \
        == [l for l in jax_err.splitlines() if text in l] != []


@pytest.mark.parametrize("flags", [["--mesh", "2,1,1"],
                                   ["--ingest-workers", "2"]])
def test_cli_multi_device_flags_name_a9(toy_corpus_dir, tmp_path, flags,
                                        capsys):
    # Ported now (ROADMAP A9a): a golden run over a 2-shard CPU mesh
    # writes the JAX CLI's bytes (its mesh spans the 8 test devices; the
    # golden bytes do not depend on the mesh), and --ingest-workers
    # without --doc-len warns and runs single-process, as the JAX CLI
    # does.
    from tfidf_tpu.cli import main as jax_main
    from tfidf_tpu_torch.cli import main as port_main
    base = ["run", "--input", toy_corpus_dir, "--output"]
    assert port_main(base + [str(tmp_path / "o"), "--device", "cpu",
                             *flags]) == 0
    port_err = capsys.readouterr().err
    jax_flags = ["--mesh", "8,1,1"] if flags[0] == "--mesh" else flags
    assert jax_main(base + [str(tmp_path / "j"), *jax_flags]) == 0
    jax_err = capsys.readouterr().err
    assert (tmp_path / "o").read_bytes() == (tmp_path / "j").read_bytes()
    warn = [l for l in port_err.splitlines() if "ingest-workers" in l]
    assert warn == [l for l in jax_err.splitlines() if "ingest-workers" in l]
    assert (warn != []) == (flags[0] == "--ingest-workers")
