"""Ranked retrieval in the port (tfidf_tpu_torch/models/retrieval.py and
its ops) against the JAX package, on the same seeded inputs.

Contracts, as the port states them:

* ``score_topk_tiled`` equals the JAX package's exactly on quantized
  triples (values, ids and tie order), for every tile width, k, query
  count and live mask; the port's tiled and untiled paths equal each
  other bit for bit.
* ``TfidfRetriever``: ids and head of the index exact; weights within
  2 float32 ulp of the JAX package's (the port takes the row norm in
  float64, the JAX package in float32); idf within 1 ulp. Searches
  agree under ``parity.compare_search``: ids exact but for near-ties,
  scores within 1e-6 — for the tfidf and bm25 scorers, every filter
  form and a fielded index. BM25 scores are not bounded by 1 (a field
  weight of 3 lifts them past 16, where one float32 ulp is 1.9e-6), so
  theirs is 1e-6 plus 4 ulp of the score: the faces differ by up to 2
  ulp and the two packages sum the slots in different orders.
* Within the port, bit for bit: tiled = untiled, any doc tile width =
  the default, slab on = slab off, ``search_async().materialize()`` =
  ``search()``.
* Snapshots restore across the packages in both directions, and
  ``config_fingerprint`` is the JAX package's.
"""

import dataclasses
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfidf_tpu import checkpoint as jckpt
from tfidf_tpu.config import PipelineConfig as JConfig
from tfidf_tpu.config import VocabMode as JVocab
from tfidf_tpu.io.corpus import Corpus as JCorpus
from tfidf_tpu.models import TfidfRetriever as JRetriever
from tfidf_tpu.models.retrieval import config_fingerprint as j_fingerprint
from tfidf_tpu.models.retrieval import query_matrix as j_query_matrix
from tfidf_tpu.ops import topk as jtopk
from tfidf_tpu.ops.sparse import score_method as j_score_method
from tfidf_tpu.ops.sparse import score_tile_rows as j_score_tile_rows
from tfidf_tpu.ops.sparse import score_tiling as j_score_tiling
from tfidf_tpu.ops.sparse import score_topk_tiled as j_score_topk_tiled
from tfidf_tpu.scoring import family as jfam
from tfidf_tpu.scoring import filters as jfil
from tfidf_tpu.scoring import oracle

import tfidf_tpu_torch as T
from tfidf_tpu_torch import checkpoint as tckpt
from tfidf_tpu_torch import cli as tcli
from tfidf_tpu_torch.interop import index_arrays_from_numpy
from tfidf_tpu_torch.models import retrieval as tret
from tfidf_tpu_torch.ops import sparse as tsp
from tfidf_tpu_torch.ops import topk as ttk
from tfidf_tpu_torch.parallel import MeshPlan as TMesh
from tfidf_tpu_torch.parity import compare_search
from tfidf_tpu_torch.scoring import family as tfam
from tfidf_tpu_torch.scoring import filters as tfil

SCORERS = ["tfidf", "bm25", "bm25:k1=1.5,b=0.6"]
FILTERS = [{"ids": [3, 17, 2, 40, 3]}, {"id_range": [5, 30]},
           {"prefix": "doc1"}]
# A wide word pool keeps distinct documents' scores apart by more than
# the few ulp the two packages' float32 weights differ by.
WIDE_WORDS = [f"term{i:02d}" for i in range(64)]
VOCAB = 512


def _t(a):
    return torch.from_numpy(np.array(a))


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max(initial=0))


def _docs(n, seed=0, prefix="doc"):
    rng = random.Random(seed)
    names = [f"{prefix}{i}" for i in range(n)]
    docs = [" ".join(rng.choice(WIDE_WORDS)
                     for _ in range(rng.randint(3, 20))).encode()
            for _ in range(n)]
    return names, docs


def _queries(n, seed=0):
    rng = random.Random(1000 + seed)
    return [" ".join(rng.choice(WIDE_WORDS) for _ in range(rng.randint(1, 4)))
            for _ in range(n)]


def _cfgs(**kw):
    base = dict(vocab_size=VOCAB, max_doc_len=32, doc_chunk=32, **kw)
    return (JConfig(vocab_mode=JVocab.HASHED, **base),
            T.PipelineConfig(vocab_mode=T.VocabMode.HASHED, **base))


NAMES, DOCS = _docs(48)


@pytest.fixture(scope="module")
def pair():
    """The JAX retriever and the port's (CPU) over the same corpus."""
    jc, tc = _cfgs()
    jr = JRetriever(jc).index(JCorpus(names=NAMES, docs=DOCS))
    tr = T.TfidfRetriever(tc, device="cpu").index(T.Corpus(names=NAMES,
                                                           docs=DOCS))
    return jr, tr


def _assert_agree(got, want, scorer="tfidf"):
    bm25 = tfam.parse_scorer(scorer).kind == "bm25"
    rep = compare_search(got[0], got[1], want[0], want[1], val_tol=1e-6,
                         tie_ulps=4, val_ulps=4 if bm25 else 0)
    assert rep["ok"], (scorer, rep)
    return rep


def _assert_same_bits(a, b):
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
    np.testing.assert_array_equal(np.asarray(a[0], np.float32).view(np.uint32),
                                  np.asarray(b[0], np.float32).view(np.uint32))


# --- the tiled score+top-k ---------------------------------------------

def random_triple(rng, d, length, vocab, quantize=True, live_p=None):
    """A random row-sparse block (numpy); quantized weights make exact
    score ties common, so tie order is really exercised."""
    cols = rng.integers(0, vocab, (d, length)).astype(np.int32)
    if quantize:
        data = (rng.integers(0, 4, (d, length)) * 0.5).astype(np.float32)
    else:
        data = rng.random((d, length)).astype(np.float32)
    live = None if live_p is None else rng.random(d) < live_p
    return data, cols, live


def random_queries(rng, vocab, q):
    return (rng.integers(0, 3, (vocab, q)) * 0.5).astype(np.float32)


def both_tiled(data, cols, live, qmat, k, tile, method=None):
    jv, ji = j_score_topk_tiled(
        jnp.asarray(data), jnp.asarray(cols),
        None if live is None else jnp.asarray(live), jnp.asarray(qmat), k,
        tile=tile, method=method or "xla")
    tv, ti = tsp.score_topk_tiled(_t(data), _t(cols),
                                  None if live is None else _t(live),
                                  _t(qmat), k, tile=tile, method=method)
    assert ti.dtype == torch.int32
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


def untiled(data, cols, live, qmat, k):
    live = np.ones(data.shape[0], bool) if live is None else live
    v, i = ttk.segment_score_topk(_t(data), _t(cols), _t(live), _t(qmat),
                                  min(k, data.shape[0]))
    return v.numpy(), i.numpy()


class TestTiledVsJax:
    """Port ``score_topk_tiled`` = JAX ``score_topk_tiled`` exactly, and =
    the port's untiled path (TestTiledBitParity's cases)."""

    @pytest.mark.parametrize("q", [1, 63, 64, 65, 256])
    def test_query_counts(self, q):
        rng = np.random.default_rng(q)
        data, cols, _ = random_triple(rng, 37, 8, 64)
        qmat = random_queries(rng, 64, q)
        want, got = both_tiled(data, cols, None, qmat, 5, 16)
        _assert_same_bits(got, want)
        _assert_same_bits(untiled(data, cols, None, qmat, 5), got)

    @pytest.mark.parametrize("tile", [1, 3, 7, 16, 37, 64, 4096])
    def test_tile_widths(self, tile):
        rng = np.random.default_rng(tile)
        data, cols, live = random_triple(rng, 37, 8, 64, live_p=0.7)
        qmat = random_queries(rng, 64, 13)
        want, got = both_tiled(data, cols, live, qmat, 6, tile)
        _assert_same_bits(got, want)
        _assert_same_bits(untiled(data, cols, live, qmat, 6), got)

    @pytest.mark.parametrize("k", [1, 5, 37, 100])
    @pytest.mark.parametrize("with_live", [False, True])
    def test_k(self, k, with_live):
        rng = np.random.default_rng(k)
        data, cols, live = random_triple(rng, 37, 8, 64,
                                         live_p=0.8 if with_live else None)
        qmat = random_queries(rng, 64, 9)
        want, got = both_tiled(data, cols, live, qmat, k, 8)
        assert got[1].shape == (9, min(k, 37))
        _assert_same_bits(got, want)
        _assert_same_bits(untiled(data, cols, live, qmat, k), got)

    @pytest.mark.parametrize("tile", [3, 4, 5, 8])
    def test_ties_straddling_tile_boundaries(self, tile):
        # identical rows on both sides of every boundary: the winners
        # are exactly rows 0..k-1, in order
        rng = np.random.default_rng(7)
        d, k, q = 24, 8, 5
        cols = np.tile(rng.integers(0, 16, (1, 4)).astype(np.int32), (d, 1))
        data = np.tile((rng.integers(1, 4, (1, 4)) * 0.5).astype(np.float32),
                       (d, 1))
        qmat = random_queries(rng, 16, q)
        want, got = both_tiled(data, cols, None, qmat, k, tile)
        _assert_same_bits(got, want)
        np.testing.assert_array_equal(got[1], np.tile(np.arange(k), (q, 1)))

    def test_all_tombstoned_tiles(self):
        rng = np.random.default_rng(11)
        data, cols, _ = random_triple(rng, 32, 6, 32)
        live = np.ones(32, bool)
        live[8:16] = False   # a dead tile in the middle
        live[24:32] = False  # and a dead last tile
        qmat = random_queries(rng, 32, 7)
        want, got = both_tiled(data, cols, live, qmat, 6, 8)
        _assert_same_bits(got, want)
        assert not np.isin(got[1], np.arange(8, 16)).any()

    def test_everything_tombstoned(self):
        rng = np.random.default_rng(13)
        data, cols, _ = random_triple(rng, 12, 4, 16)
        qmat = random_queries(rng, 16, 3)
        want, got = both_tiled(data, cols, np.zeros(12, bool), qmat, 4, 5)
        _assert_same_bits(got, want)
        assert (got[0] == ttk._DEAD).all()

    def test_pallas_knob_same_ids(self):
        # TFIDF_TPU_SCORE=pallas: the JAX package switches to its Pallas
        # kernel (interpret mode); the port runs B6 either way
        rng = np.random.default_rng(17)
        data, cols, _ = random_triple(rng, 37, 8, 64, quantize=False)
        qmat = rng.random((64, 9)).astype(np.float32)
        want, got = both_tiled(data, cols, None, qmat, 5, 16, method="pallas")
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)

    @pytest.mark.parametrize("raw", ["on", "1", "true", "yes", "", "off", "0",
                                     "false", "no", "maybe"])
    def test_tiling_knob(self, raw, monkeypatch):
        monkeypatch.setenv("TFIDF_TPU_SCORE_TILING", raw)
        if raw == "maybe":
            for fn in (tsp.score_tiling, j_score_tiling):
                with pytest.raises(ValueError):
                    fn()
        else:
            assert tsp.score_tiling() is j_score_tiling()

    @pytest.mark.parametrize("raw,d", [("", 10_000), ("", 100), ("7", 100),
                                       ("1", 5), ("9999", 12)])
    def test_tile_rows_knob(self, raw, d, monkeypatch):
        monkeypatch.setenv("TFIDF_TPU_QUERY_BLOCK", raw)
        assert tsp.score_tile_rows(d) == j_score_tile_rows(d)

    def test_score_knob_validated(self, monkeypatch):
        for raw in ("xla", "pallas"):
            monkeypatch.setenv("TFIDF_TPU_SCORE", raw)
            assert tsp.score_method() == j_score_method() == raw
        monkeypatch.setenv("TFIDF_TPU_SCORE", "bcoo")
        with pytest.raises(ValueError, match="TFIDF_TPU_SCORE"):
            tsp.score_method()


class TestTopkHelpers:
    """``masked_topk``, ``merge_topk``, ``segment_score_topk``: the JAX
    functions' values and ids (lax.top_k's tie order) exactly."""

    def test_masked_topk(self):
        rng = np.random.default_rng(3)
        scores = (rng.integers(0, 4, (6, 40)) * 0.25).astype(np.float32)
        live = rng.random(40) < 0.6
        jv, ji = jtopk.masked_topk(jnp.asarray(scores), jnp.asarray(live), 9)
        tv, ti = ttk.masked_topk(_t(scores), _t(live), 9)
        _assert_same_bits((tv.numpy(), ti.numpy()),
                          (np.asarray(jv), np.asarray(ji)))

    def test_merge_topk(self):
        rng = np.random.default_rng(4)
        vals = (rng.integers(0, 3, (5, 30)) * 0.5).astype(np.float32)
        ids = rng.permutation(300)[:150].reshape(5, 30).astype(np.int32)
        jv, ji = jtopk.merge_topk(jnp.asarray(vals), jnp.asarray(ids), 12)
        tv, ti = ttk.merge_topk(_t(vals), _t(ids), 12)
        _assert_same_bits((tv.numpy(), ti.numpy()),
                          (np.asarray(jv), np.asarray(ji)))

    @pytest.mark.parametrize("q", [1, 33])
    def test_segment_score_topk(self, q):
        rng = np.random.default_rng(q)
        data, cols, live = random_triple(rng, 29, 6, 48, live_p=0.75)
        qmat = random_queries(rng, 48, q)
        jv, ji = jtopk.segment_score_topk(jnp.asarray(data), jnp.asarray(cols),
                                          jnp.asarray(live),
                                          jnp.asarray(qmat), 7)
        tv, ti = ttk.segment_score_topk(_t(data), _t(cols), _t(live),
                                        _t(qmat), 7)
        _assert_same_bits((tv.numpy(), ti.numpy()),
                          (np.asarray(jv), np.asarray(ji)))

    def test_to_bcoo_is_the_dense_counts(self):
        rng = np.random.default_rng(5)
        toks = _t(rng.integers(0, 20, (6, 9)).astype(np.int32))
        lens = _t(np.array([9, 0, 3, 5, 9, 1], np.int32))
        ids, counts, head = tsp.sorted_term_counts(toks, lens)
        dense = tsp.to_bcoo(ids, counts, head, 20).to_dense()
        want = np.zeros((6, 20), np.int64)
        for d, n in enumerate(lens.tolist()):
            np.add.at(want[d], toks[d, :n].numpy(), 1)
        np.testing.assert_array_equal(dense.numpy(), want)


# --- scorer specs, filters, faces ---------------------------------------

class TestSpecs:
    """Scorer and filter keys are the JAX package's, byte for byte."""

    @pytest.mark.parametrize("spec", [
        None, "tfidf", "bm25", "bm25:k1=1.5,b=0.6", " BM25 : b=0.3 ",
        {"kind": "bm25", "k1": 2}, {"kind": "tfidf", "k1": 9.0},
        "bm25:k1=0.0,b=0.0", "bm25:k1=1e-3"])
    def test_scorer_keys(self, spec):
        t, j = tfam.parse_scorer(spec), jfam.parse_scorer(spec)
        assert t.key() == j.key() == tfam.scorer_key(spec)
        assert (t.kind, t.k1, t.b, t.is_default) == (j.kind, j.k1, j.b,
                                                     j.is_default)
        assert tfam.parse_scorer(t.key()) == t

    @pytest.mark.parametrize("bad", ["nope", "bm25:k9=1", "bm25:b=2",
                                     "bm25:k1=", {"kind": "bm25", "x": 1},
                                     "bm25:k1=-1", 7])
    def test_bad_scorers_raise(self, bad):
        with pytest.raises(ValueError):
            jfam.parse_scorer(bad)
        with pytest.raises(ValueError):
            tfam.parse_scorer(bad)

    @pytest.mark.parametrize("env", [
        {}, {"TFIDF_TPU_SCORER": "bm25"},
        {"TFIDF_TPU_SCORER": "bm25", "TFIDF_TPU_BM25_K1": "2",
         "TFIDF_TPU_BM25_B": "0.5"},
        {"TFIDF_TPU_SCORER": "bm25:k1=0.9", "TFIDF_TPU_BM25_K1": "2"}])
    def test_resolve_scorer_env(self, env, monkeypatch):
        for name in ("TFIDF_TPU_SCORER", "TFIDF_TPU_BM25_K1",
                     "TFIDF_TPU_BM25_B"):
            monkeypatch.delenv(name, raising=False)
        for name, val in env.items():
            monkeypatch.setenv(name, val)
        assert tfam.resolve_scorer().key() == jfam.resolve_scorer().key()
        assert tfam.resolve_scorer("bm25").key() == "bm25:b=0.75,k1=1.2"

    @pytest.mark.parametrize("parts", [(None, None, None), ("bm25", 2.0, None),
                                       ("bm25:k1=1.5", 9.0, 0.1),
                                       ("TFIDF", None, 0.3)])
    def test_spec_from_parts(self, parts):
        assert tfam.spec_from_parts(*parts).key() \
            == jfam.spec_from_parts(*parts).key()

    @pytest.mark.parametrize("filt", [
        None, "", {"ids": [5, 3, 3, 99]}, {"id_range": [4, 9]},
        {"id_range": [-3, 500]}, {"prefix": "doc1"}, '{"ids":[2]}',
        "null", {"prefix": ""}])
    def test_filter_keys_and_masks(self, filt):
        assert tfil.filter_key(filt) == jfil.filter_key(filt)
        t, j = tfil.parse_filter(filt), jfil.parse_filter(filt)
        assert (t is None) == (j is None)
        if t is not None:
            names = [f"doc{i}" for i in range(30)]
            np.testing.assert_array_equal(
                tfil.filter_mask(t, 30, names=names),
                jfil.filter_mask(j, 30, names=names))

    @pytest.mark.parametrize("bad", [{"ids": [1.5]}, {"id_range": [3, 1]},
                                     {"ids": [1], "prefix": "a"}, "not json",
                                     {"prefix": 3}, [1, 2]])
    def test_bad_filters_raise(self, bad):
        with pytest.raises(ValueError):
            jfil.parse_filter(bad)
        with pytest.raises(ValueError):
            tfil.parse_filter(bad)


class TestFaces:
    def test_bm25_idf_within_one_ulp(self):
        df = np.array([0, 1, 2, 3, 7, 24, 47, 48, 1000, 65535], np.int32)
        for n in (48, 1000, 131072):
            df = np.minimum(df, n)  # df never exceeds the docs counted
            want = np.asarray(jfam.bm25_idf_from_df(jnp.asarray(df), n))
            got = tfam.bm25_idf_from_df(_t(df), n).numpy()
            assert _ulps(got, want) <= 1
            assert (got[df > 0] > 0).all() and (got[df == 0] == 0).all()

    @pytest.mark.parametrize("spec", SCORERS)
    def test_face_vs_jax_and_oracle(self, pair, spec):
        jr, tr = pair
        t_data, t_cols = tr.scorer_face(spec)
        j_data, j_cols = jr.scorer_face(spec)
        np.testing.assert_array_equal(t_cols, j_cols)
        assert _ulps(t_data, j_data) <= 2
        # the numpy oracle's face from the stored index's integers
        ids, head = tr._ids.numpy(), tr._head.numpy()
        counts, lengths = oracle.counts_from_sorted(ids, head)
        n = tr._num_docs
        df = oracle.df_from_sorted(ids, head, VOCAB)
        s = tfam.parse_scorer(spec)
        if s.kind == "tfidf":
            o_data, o_cols = oracle.tfidf_face(ids, counts, head, lengths, df,
                                               n)
        else:
            avgdl = tfam.avgdl_f32(int(lengths[:n].sum()), n)
            o_data, o_cols = oracle.bm25_face(ids, counts, head, lengths, df,
                                              n, avgdl, s.k1, s.b)
        np.testing.assert_array_equal(t_cols, o_cols)
        assert _ulps(t_data, o_data) <= 2

    def test_k1_b_are_runtime_values(self, pair):
        # a tensor k1/b gives the same face as the float one
        _, tr = pair
        ids, head = tr._ids, tr._head
        a = tfam.bm25_face_trace(ids, head, 48, np.float32(9.5), 1.5, 0.6,
                                 vocab_size=VOCAB)
        b = tfam.bm25_face_trace(ids, head, 48, torch.tensor(9.5),
                                 torch.tensor(1.5), torch.tensor(0.6),
                                 vocab_size=VOCAB)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# --- the retriever against the JAX package -------------------------------

class TestRetrieverVsJax:
    def test_index_arrays(self, pair):
        jr, tr = pair
        np.testing.assert_array_equal(tr._ids.numpy(), np.asarray(jr._ids))
        np.testing.assert_array_equal(tr._head.numpy(), np.asarray(jr._head))
        assert _ulps(tr._weights.numpy(), np.asarray(jr._weights)) <= 2
        assert _ulps(tr._idf.numpy(), np.asarray(jr._idf)) <= 1
        assert tr.names == jr.names and tr._num_docs == jr._num_docs

    @pytest.mark.parametrize("q", [1, 63, 64, 65, 256])
    @pytest.mark.parametrize("scorer", SCORERS)
    def test_search(self, pair, q, scorer):
        jr, tr = pair
        queries = _queries(q, seed=q)
        got = tr.search(queries, k=10, scorer=scorer)
        assert got[0].shape == got[1].shape == (q, 10)
        assert got[0].dtype == np.float32 and got[1].dtype == np.int32
        _assert_agree(got, jr.search(queries, k=10, scorer=scorer), scorer)

    @pytest.mark.parametrize("filt", FILTERS)
    @pytest.mark.parametrize("scorer", SCORERS)
    def test_filters(self, pair, filt, scorer):
        jr, tr = pair
        queries = _queries(21, seed=3)
        got = tr.search(queries, k=8, scorer=scorer, filter=filt)
        _assert_agree(got, jr.search(queries, k=8, scorer=scorer,
                                     filter=filt), scorer)
        allowed = jfil.filter_mask(jfil.parse_filter(filt), 48, names=NAMES)
        assert allowed[got[1][got[1] >= 0]].all()

    @pytest.mark.parametrize("scorer", SCORERS)
    def test_matches_numpy_oracle(self, pair, scorer):
        # ids and tie order exactly the oracle's over the port's own face
        _, tr = pair
        queries = _queries(30, seed=9)
        spec = tfam.parse_scorer(scorer)
        data, cols = tr.scorer_face(spec)
        qmat = j_query_matrix(queries, _cfgs()[0], tr._idf.numpy(),
                              mode="counts" if spec.kind == "bm25"
                              else "cosine")
        wv, wi = oracle.oracle_topk(data, cols, None, qmat, 6)
        gv, gi = tr.search(queries, k=6, scorer=scorer)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("scorer", SCORERS)
    def test_fielded_index(self, scorer):
        names, titles = _docs(30, seed=4)
        _, bodies = _docs(30, seed=5)
        jc, tc = _cfgs()
        jr = JRetriever(jc).index_fields([
            ("title", JCorpus(names=names, docs=titles), 3.0),
            ("body", JCorpus(names=names, docs=bodies), 1.0)])
        tr = T.TfidfRetriever(tc, device="cpu").index_fields([
            ("title", T.Corpus(names=names, docs=titles), 3.0),
            ("body", T.Corpus(names=names, docs=bodies), 1.0)])
        assert tr._fields == jr._fields
        np.testing.assert_array_equal(tr._ids.numpy(), np.asarray(jr._ids))
        assert _ulps(tr._idf.numpy(), np.asarray(jr._idf)) <= 1
        queries = _queries(17, seed=6)
        _assert_agree(tr.search(queries, k=7, scorer=scorer),
                      jr.search(queries, k=7, scorer=scorer), scorer)

    def test_misaligned_fields_raise(self):
        names, docs = _docs(5)
        _, tc = _cfgs()
        r = T.TfidfRetriever(tc, device="cpu")
        with pytest.raises(ValueError, match="row-aligned"):
            r.index_fields([("a", T.Corpus(names=names, docs=docs), 1.0),
                            ("b", T.Corpus(names=names[:4], docs=docs[:4]),
                             1.0)])
        with pytest.raises(ValueError, match="at least one"):
            r.index_fields([])

    @pytest.mark.parametrize("chunk_docs", [16, 64])
    def test_index_dir_doc_len(self, tmp_path, chunk_docs):
        # the overlapped ingest's chunk step (ragged wire) builds the
        # same index, padding rows included
        for i, doc in enumerate(DOCS):
            (tmp_path / f"doc{i + 1}").write_bytes(doc)
        jc, tc = _cfgs()
        jr = JRetriever(jc).index_dir(str(tmp_path), doc_len=16,
                                      chunk_docs=chunk_docs)
        tr = T.TfidfRetriever(tc, device="cpu").index_dir(
            str(tmp_path), doc_len=16, chunk_docs=chunk_docs)
        assert tr._ids.shape[0] == np.asarray(jr._ids).shape[0] \
            == -(-48 // chunk_docs) * chunk_docs
        np.testing.assert_array_equal(tr._ids.numpy(), np.asarray(jr._ids))
        np.testing.assert_array_equal(tr._head.numpy(), np.asarray(jr._head))
        assert _ulps(tr._weights.numpy(), np.asarray(jr._weights)) <= 2
        assert _ulps(tr._idf.numpy(), np.asarray(jr._idf)) <= 1
        queries = _queries(9, seed=2)
        for scorer in SCORERS:
            _assert_agree(tr.search(queries, k=5, scorer=scorer),
                          jr.search(queries, k=5, scorer=scorer), scorer)

    def test_index_dir_batch_path(self, tmp_path):
        for i, doc in enumerate(DOCS[:10]):
            (tmp_path / f"doc{i + 1}").write_bytes(doc)
        _, tc = _cfgs()
        a = T.TfidfRetriever(tc, device="cpu").index_dir(str(tmp_path))
        b = T.TfidfRetriever(tc, device="cpu").index(
            T.Corpus(names=[f"doc{i}" for i in range(1, 11)], docs=DOCS[:10]))
        assert torch.equal(a._weights, b._weights) and a.names == b.names


# --- the docs-sharded retriever (plan=) -----------------------------------

def _plan(n):
    return TMesh.create(docs=n, device="cpu")


class TestPlanRetriever:
    """``TfidfRetriever(plan=)`` against the JAX package's
    (tests/test_retrieval.py::TestSharded) and, bit for bit, against the
    port's single-device retriever."""

    @pytest.mark.parametrize("shards", [1, 2, 3, 4])
    @pytest.mark.parametrize("n_docs", [5, 48])
    def test_matches_single_device_and_jax(self, shards, n_docs):
        from tfidf_tpu.parallel import MeshPlan as JMesh
        jc, tc = _cfgs()
        corpus = T.Corpus(names=NAMES[:n_docs], docs=DOCS[:n_docs])
        single = T.TfidfRetriever(tc, device="cpu").index(corpus)
        plan_r = T.TfidfRetriever(tc, plan=_plan(shards)).index(corpus)
        assert plan_r.device == torch.device("cpu")
        assert len(plan_r._blocks) == shards
        assert plan_r._blocks[0][0].shape[0] * shards \
            == -(-n_docs // shards) * shards
        jr = JRetriever(jc, plan=JMesh.create(
            docs=shards, devices=jax.devices()[:shards])).index(
            JCorpus(names=NAMES[:n_docs], docs=DOCS[:n_docs]))
        queries = _queries(7, seed=shards) + ["", "zzz unknown"]
        for k in (1, 4, n_docs + 3):
            got = plan_r.search(queries, k=k)
            # the caller-visible width is min(k, num_docs) on every path
            assert got[0].shape == (len(queries), min(k, n_docs))
            _assert_same_bits(got, single.search(queries, k=k))
            _assert_agree(got, jr.search(queries, k=k))
        # the index itself: row-local, so each shard holds the single
        # device's rows bit for bit
        ids = torch.cat([b[0] for b in plan_r._blocks])[:n_docs]
        w = torch.cat([b[1] for b in plan_r._blocks])[:n_docs]
        assert torch.equal(ids, single._ids)
        assert torch.equal(w, single._weights)
        assert torch.equal(plan_r._idf, single._idf)

    def test_async_and_untiled_paths(self, monkeypatch):
        _, tc = _cfgs()
        corpus = T.Corpus(names=NAMES, docs=DOCS)
        plan_r = T.TfidfRetriever(tc, plan=_plan(3)).index(corpus)
        queries = _queries(70, seed=9)
        want = plan_r.search(queries, k=6)
        _assert_same_bits(plan_r.search_async(queries, k=6).materialize(),
                          want)
        monkeypatch.setenv("TFIDF_TPU_SCORE_TILING", "off")
        _assert_same_bits(plan_r.search(queries, k=6), want)
        monkeypatch.setenv("TFIDF_TPU_SCORE_TILING", "on")
        monkeypatch.setenv("TFIDF_TPU_QUERY_BLOCK", "5")
        _assert_same_bits(plan_r.search(queries, k=6), want)

    def test_index_dir_takes_the_batch_packing(self, tmp_path):
        # under a plan index_dir ignores doc_len (no truncation, no
        # native loader), as the JAX package's does
        for i, doc in enumerate(DOCS[:12]):
            (tmp_path / f"doc{i + 1}").write_bytes(doc)
        _, tc = _cfgs()
        a = T.TfidfRetriever(tc, plan=_plan(2)).index_dir(str(tmp_path),
                                                          doc_len=2)
        b = T.TfidfRetriever(tc, device="cpu").index_dir(str(tmp_path))
        queries = _queries(5, seed=3)
        _assert_same_bits(a.search(queries, k=4), b.search(queries, k=4))

    def test_requires_docs_only_mesh(self):
        _, tc = _cfgs()
        for shape in ({"docs": 2, "vocab": 2}, {"docs": 2, "seq": 2}):
            with pytest.raises(ValueError, match="docs axis only"):
                T.TfidfRetriever(tc, plan=TMesh.create(
                    **shape, device="cpu"))

    @pytest.mark.parametrize("kw", [{"scorer": "bm25"},
                                    {"filter": {"id_range": [0, 5]}}])
    def test_default_scorer_only(self, kw, tmp_path):
        _, tc = _cfgs()
        plan_r = T.TfidfRetriever(tc, plan=_plan(2)).index(
            T.Corpus(names=NAMES, docs=DOCS))
        with pytest.raises(ValueError, match="default scorer only"):
            plan_r.search(["term01"], k=3, **kw)

    def test_single_device_only_operations(self, tmp_path):
        _, tc = _cfgs()
        corpus = T.Corpus(names=NAMES, docs=DOCS)
        plan_r = T.TfidfRetriever(tc, plan=_plan(2)).index(corpus)
        with pytest.raises(ValueError, match="single-device"):
            plan_r.snapshot(str(tmp_path / "snap"))
        with pytest.raises(ValueError, match="single-device"):
            T.TfidfRetriever(tc, plan=_plan(2)).index_fields(
                [("body", corpus, 1.0)])
        with pytest.raises(ValueError, match="default scorer only"):
            plan_r.scorer_face("bm25")
        # no query slab under a plan (tests/test_queryslab.py)
        plan_r.query_slab = True
        plan_r.search(["term01 term02"], k=3)
        assert plan_r._slab is None
        # the census sees every shard's block
        assert len(plan_r.index_arrays()) == 1 + 3 * 2


# --- within the port, bit for bit ----------------------------------------

class TestWithinPort:
    @pytest.mark.parametrize("q", [5, 130])
    @pytest.mark.parametrize("scorer", SCORERS)
    def test_tiled_equals_untiled(self, pair, q, scorer, monkeypatch):
        _, tr = pair
        queries = _queries(q, seed=q)
        monkeypatch.setenv("TFIDF_TPU_SCORE_TILING", "on")
        on = tr.search(queries, k=6, scorer=scorer)
        monkeypatch.setenv("TFIDF_TPU_SCORE_TILING", "off")
        _assert_same_bits(tr.search(queries, k=6, scorer=scorer), on)
        _assert_same_bits(tr.search(queries, k=6, scorer=scorer,
                                    filter={"id_range": [0, 48]}), on)

    @pytest.mark.parametrize("width", ["1", "5", "8", "64"])
    def test_tile_width_knob(self, pair, width, monkeypatch):
        _, tr = pair
        queries = _queries(9, seed=1)
        monkeypatch.delenv("TFIDF_TPU_QUERY_BLOCK", raising=False)
        base = [tr.search(queries, k=4, scorer=s) for s in SCORERS]
        monkeypatch.setenv("TFIDF_TPU_QUERY_BLOCK", width)
        for s, want in zip(SCORERS, base):
            _assert_same_bits(tr.search(queries, k=4, scorer=s), want)

    def test_slab_on_equals_off(self, monkeypatch):
        jc, tc = _cfgs()
        r = T.TfidfRetriever(tc, device="cpu").index(T.Corpus(names=NAMES,
                                                              docs=DOCS))
        batches = [_queries(n, seed=n) for n in (3, 4, 17, 3, 64, 2)]
        r.query_slab = False
        off = [r.search(b, k=5) for b in batches]
        assert r._slab is None
        r.query_slab = True
        on = [r.search(b, k=5) for b in batches]
        for a, b in zip(on, off):
            _assert_same_bits(a, b)
        warm = r._slab.stats()
        assert warm["h2d_copies"] == warm["packs"] == len(batches)
        for b in batches:
            r.search(b, k=5)
        after = r._slab.stats()
        assert after["allocs"] == warm["allocs"] == 4  # buckets 4, 32, 64, 2
        assert after["h2d_copies"] == after["packs"] == 2 * len(batches)
        monkeypatch.setenv("TFIDF_TPU_MAX_BATCH", "8")
        r._slab = None
        _assert_same_bits(r.search(batches[2], k=5), on[2])
        assert r._slab.stats()["fallbacks"] == 1

    def test_async_equals_sync(self, pair):
        _, tr = pair
        queries = _queries(11, seed=8)
        for scorer in SCORERS:
            pending = tr.search_async(queries, k=5, scorer=scorer)
            got = pending.materialize()
            assert pending.done and pending.materialize() is got
            _assert_same_bits(got, tr.search(queries, k=5, scorer=scorer))

    def test_failed_materialize_raises_again(self, monkeypatch):
        _, tc = _cfgs()
        r = T.TfidfRetriever(tc, device="cpu").index(T.Corpus(names=NAMES,
                                                              docs=DOCS))
        r.search(["term01"], k=3)  # warm the slab

        def fault(self):
            raise RuntimeError("device fault")

        monkeypatch.setattr(tret._HostCopy, "result", fault)
        pending = r.search_async(["term01 term02"], k=3)
        with pytest.raises(RuntimeError, match="device fault"):
            pending.materialize()
        with pytest.raises(RuntimeError, match="already failed"):
            pending.materialize()
        monkeypatch.undo()
        stats = r._slab.stats()
        r.search(["term03"], k=3)  # the slot was released: no new alloc
        assert r._slab.stats()["allocs"] == stats["allocs"]

    def test_caches_drop_on_install(self):
        _, tc = _cfgs()
        r = T.TfidfRetriever(tc, device="cpu").index(T.Corpus(names=NAMES,
                                                              docs=DOCS))
        r.search(["term05"], k=2, scorer="bm25", filter={"prefix": "doc2"})
        assert r._faces and r._filters
        r.index(T.Corpus(names=NAMES[:7], docs=DOCS[:7]))
        assert not r._faces and not r._filters
        assert r.search(["term05"], k=20)[1].shape == (1, 7)

    def test_search_before_index_raises(self):
        with pytest.raises(RuntimeError, match="index"):
            T.TfidfRetriever(_cfgs()[1], device="cpu").search(["a"])


# --- snapshots and state -------------------------------------------------

class TestSnapshots:
    def test_jax_snapshot_restores_in_port(self, pair, tmp_path):
        jr, _ = pair
        jr.snapshot(str(tmp_path), epoch=3)
        tr, meta = T.TfidfRetriever.restore(str(tmp_path), config=_cfgs()[1],
                                            device="cpu")
        assert meta["epoch"] == 3 and meta["num_docs"] == 48
        np.testing.assert_array_equal(tr._ids.numpy(), np.asarray(jr._ids))
        np.testing.assert_array_equal(tr._weights.numpy().view(np.uint32),
                                      np.asarray(jr._weights).view(np.uint32))
        assert tr.names == jr.names
        queries = _queries(40, seed=11)
        for scorer in SCORERS:
            _assert_agree(tr.search(queries, k=6, scorer=scorer),
                          jr.search(queries, k=6, scorer=scorer), scorer)

    def test_port_snapshot_restores_in_jax(self, pair, tmp_path):
        _, tr = pair
        tr.snapshot(str(tmp_path), epoch=1, extra_meta={"note": "x"})
        jr, meta = JRetriever.restore(str(tmp_path), config=_cfgs()[0])
        assert meta["note"] == "x"
        for name in ("_ids", "_weights", "_head", "_idf"):
            np.testing.assert_array_equal(np.asarray(getattr(jr, name)),
                                          getattr(tr, name).numpy())
        queries = _queries(40, seed=12)
        for scorer in SCORERS:
            _assert_agree(tr.search(queries, k=6, scorer=scorer),
                          jr.search(queries, k=6, scorer=scorer), scorer)

    def test_same_files_both_ways(self, pair, tmp_path):
        # the port's payload is the JAX package's byte for byte
        jr, tr = pair
        jr2 = JRetriever(_cfgs()[0])
        jr2._ids, jr2._weights = tr._ids.numpy(), tr._weights.numpy()
        jr2._head, jr2._idf = tr._head.numpy(), tr._idf.numpy()
        jr2.names, jr2._num_docs = list(tr.names), tr._num_docs
        jr2.snapshot(str(tmp_path / "j"))
        tr.snapshot(str(tmp_path / "t"))
        for f in ("meta.json", "index.npz"):
            a = (tmp_path / "j" / "ckpt-0" / f).read_bytes()
            b = (tmp_path / "t" / "ckpt-0" / f).read_bytes()
            if f == "meta.json":
                assert json.loads(a) == json.loads(b)
            else:
                assert np.load(tmp_path / "j" / "ckpt-0" / f).files \
                    == np.load(tmp_path / "t" / "ckpt-0" / f).files

    def test_scorer_and_fields_meta_cross(self, tmp_path):
        names, titles = _docs(12, seed=4)
        _, bodies = _docs(12, seed=5)
        jc, tc = _cfgs()
        tr = T.TfidfRetriever(tc, scorer="bm25:k1=1.5", device="cpu")
        tr.index_fields([("title", T.Corpus(names=names, docs=titles), 2.0),
                         ("body", T.Corpus(names=names, docs=bodies), 1.0)])
        tr.snapshot(str(tmp_path))
        jr, meta = JRetriever.restore(str(tmp_path), config=jc)
        assert meta["scorer"] == "bm25:b=0.75,k1=1.5"
        assert jr.scorer.key() == tr.scorer.key() and jr._fields == tr._fields
        back, _ = T.TfidfRetriever.restore(str(tmp_path), config=tc,
                                           device="cpu")
        assert back._fields == tr._fields and back.scorer == tr.scorer
        queries = _queries(10, seed=5)
        _assert_same_bits(back.search(queries, k=4), tr.search(queries, k=4))
        _assert_agree(back.search(queries, k=4), jr.search(queries, k=4),
                      tr.scorer)

    @pytest.mark.parametrize("kw", [
        {}, {"vocab_size": 512, "truncate_tokens_at": 8},
        {"hash_seed": 3, "max_doc_len": 64, "doc_chunk": 64},
        {"score_dtype": "float64", "ngram_range": (2, 4)},
        {"topk": 5, "wire": "padded"}])
    def test_fingerprint_is_the_jax_packages(self, kw):
        j = JConfig(vocab_mode=JVocab.HASHED, **kw)
        t = T.PipelineConfig(vocab_mode=T.VocabMode.HASHED, **kw)
        assert tret.config_fingerprint(t) == j_fingerprint(j)

    def test_mismatch_raises(self, pair, tmp_path):
        _, tr = pair
        tr.snapshot(str(tmp_path))
        other = T.PipelineConfig(vocab_mode=T.VocabMode.HASHED,
                                 vocab_size=VOCAB, hash_seed=1)
        with pytest.raises(tckpt.SnapshotMismatch, match="fingerprint"):
            T.TfidfRetriever.restore(str(tmp_path), config=other,
                                     device="cpu")
        with pytest.raises(jckpt.SnapshotMismatch, match="fingerprint"):
            JRetriever.restore(str(tmp_path))  # default max_doc_len 256

    def test_corrupt_payload_raises(self, pair, tmp_path):
        _, tr = pair
        tr.snapshot(str(tmp_path))
        tr.snapshot(str(tmp_path))  # second commit supersedes the first
        assert sorted(os.listdir(tmp_path)) == ["LATEST", "LOCK", "ckpt-1"]
        meta = tmp_path / "ckpt-1" / "meta.json"
        doc = json.loads(meta.read_text())
        doc["checksums"]["weights"] = "0" * 64
        meta.write_text(json.dumps(doc))
        with pytest.raises(tckpt.SnapshotMismatch, match="checksum"):
            tckpt.restore_index(str(tmp_path))
        with pytest.raises(FileNotFoundError):
            tckpt.restore_index(str(tmp_path / "nothing"))

    def test_interop_arrays(self, pair):
        jr, _ = pair
        r = index_arrays_from_numpy(
            np.asarray(jr._ids), np.asarray(jr._weights),
            np.asarray(jr._head), np.asarray(jr._idf), jr.names,
            jr._num_docs, dataclasses.asdict(jr.config), device="cpu")
        queries = _queries(70, seed=13)
        for scorer in SCORERS:
            _assert_agree(r.search(queries, k=9, scorer=scorer),
                          jr.search(queries, k=9, scorer=scorer), scorer)
        with pytest.raises(ValueError, match="names"):
            index_arrays_from_numpy(np.asarray(jr._ids),
                                    np.asarray(jr._weights),
                                    np.asarray(jr._head),
                                    np.asarray(jr._idf), jr.names[:3], 48,
                                    dataclasses.asdict(jr.config),
                                    device="cpu")


# --- entry points ----------------------------------------------------------

def _parse_query_output(text):
    out, cur = [], None
    for line in text.splitlines():
        if line.startswith("query: "):
            cur = (line[len("query: "):], [])
            out.append(cur)
        elif line.startswith("  "):
            name, score = line.strip().split("\t")
            cur[1].append((name, float(score)))
    return out


class TestCliQuery:
    @pytest.mark.parametrize("extra", [[], ["--doc-len", "16"],
                                       ["-k", "2", "--vocab-size", "1024"],
                                       ["--no-strict", "-k", "9"]])
    def test_same_results_as_jax_cli(self, tmp_path, capsys, extra):
        from tfidf_tpu.cli import main as jax_main
        for i, doc in enumerate(DOCS[:20]):
            (tmp_path / f"doc{i + 1}").write_bytes(doc)
        args = ["query", "--input", str(tmp_path)]
        for q in _queries(6, seed=21) + ["", "zzz unknown"]:
            args += ["--query", q]
        assert tcli.main(args + extra + ["--device", "cpu"]) == 0
        ours = _parse_query_output(capsys.readouterr().out)
        assert jax_main(args + extra) == 0
        theirs = _parse_query_output(capsys.readouterr().out)
        assert len(ours) == len(theirs) == 8
        assert sum(len(r) for _, r in ours) > 0
        for (qa, ra), (qb, rb) in zip(ours, theirs):
            assert qa == qb
            assert [n for n, _ in ra] == [n for n, _ in rb]
            assert all(abs(a - b) <= 1e-6 for (_, a), (_, b) in zip(ra, rb))

    def test_mesh_docs_names_a9(self, tmp_path, capsys):
        # Ported now (ROADMAP A9b): --mesh-docs N indexes block-sharded
        # over N shards (CPU shards here, the JAX package's first N
        # forced devices there) and prints the JAX CLI's results; the
        # unsharded CLI's bit for bit; --doc-len with a mesh exits 2.
        from tfidf_tpu.cli import main as jax_main
        for i, doc in enumerate(DOCS[:20]):
            (tmp_path / f"doc{i + 1}").write_bytes(doc)
        args = ["query", "--input", str(tmp_path), "-k", "4"]
        for q in _queries(6, seed=22) + ["", "zzz unknown"]:
            args += ["--query", q]
        assert tcli.main(args + ["--device", "cpu"]) == 0
        plain = capsys.readouterr().out
        for n in ("3", "0"):
            assert tcli.main(args + ["--mesh-docs", n, "--device", "cpu"]) \
                == 0
            assert capsys.readouterr().out == plain
        assert jax_main(args + ["--mesh-docs", "3"]) == 0
        theirs = _parse_query_output(capsys.readouterr().out)
        ours = _parse_query_output(plain)
        assert len(ours) == len(theirs) == 8
        for (qa, ra), (qb, rb) in zip(ours, theirs):
            assert qa == qb
            assert [n for n, _ in ra] == [n for n, _ in rb]
            assert all(abs(a - b) <= 1e-6 for (_, a), (_, b) in zip(ra, rb))
        assert tcli.main(args + ["--mesh-docs", "2", "--doc-len", "16",
                                 "--device", "cpu"]) == 2
        err = capsys.readouterr().err
        assert "single-device; drop --mesh-docs" in err
        assert jax_main(args + ["--mesh-docs", "2", "--doc-len", "16"]) == 2
        assert capsys.readouterr().err == err

    def test_plan_names_a9(self):
        # Ported now (ROADMAP A9b): TfidfRetriever(plan=) equals the JAX
        # package's plan retriever and the port's single device.
        from tfidf_tpu.parallel import MeshPlan as JMesh
        jc, tc = _cfgs()
        corpus = T.Corpus(names=NAMES, docs=DOCS)
        plan_r = T.TfidfRetriever(tc, plan=TMesh.create(
            docs=4, device="cpu")).index(corpus)
        jr = JRetriever(jc, plan=JMesh.create(
            docs=4, devices=jax.devices()[:4])).index(
            JCorpus(names=NAMES, docs=DOCS))
        queries = _queries(9, seed=4)
        got = plan_r.search(queries, k=5)
        _assert_agree(got, jr.search(queries, k=5))
        _assert_same_bits(got, T.TfidfRetriever(tc, device="cpu")
                          .index(corpus).search(queries, k=5))

    def test_exact_vocab_refused(self):
        with pytest.raises(ValueError, match="HASHED"):
            T.TfidfRetriever(T.PipelineConfig(), device="cpu")
