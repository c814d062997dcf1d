"""The port's plain ops (tfidf_tpu_torch/ops) against the JAX package's
on the same numpy inputs: sort+RLE triples, DF, IDF, histograms, top-k
tie order, the result-word decode and the host hashing.

Ints, ids and word decodes are exact. IDF is held to 1 float32 ulp:
``torch.log`` and ``jnp.log`` disagree by one ulp on some inputs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tfidf_tpu import PipelineConfig as JaxConfig
from tfidf_tpu.config import VocabMode as JaxVocabMode
from tfidf_tpu.ops import downlink as jax_downlink
from tfidf_tpu.ops import histogram as jax_histogram
from tfidf_tpu.ops import scoring as jax_scoring
from tfidf_tpu.ops import sparse as jax_sparse
from tfidf_tpu.ops.hashing import words_to_ids as jax_words_to_ids
from tfidf_tpu_torch import interop
from tfidf_tpu_torch.ops import (downlink, histogram, kernels, scoring, sparse,
                                  topk)
from tfidf_tpu_torch.ops.hashing import words_to_ids


def _batch(seed, d, length, vocab):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (d, length)).astype(np.int32)
    lens = rng.integers(0, length + 1, d).astype(np.int32)
    return toks, lens


BATCHES = [(0, 6, 16, 10), (1, 17, 33, 300), (2, 1, 1, 1), (3, 9, 64, 5)]


class TestSortedTermCounts:
    @pytest.mark.parametrize("seed,d,length,vocab", BATCHES)
    def test_matches_jax_and_host_mirror(self, seed, d, length, vocab):
        toks, lens = _batch(seed, d, length, vocab)
        ti, tc, th = sparse.sorted_term_counts(torch.from_numpy(toks),
                                               torch.from_numpy(lens))
        ji, jc, jh = jax_sparse.sorted_term_counts(jnp.asarray(toks),
                                                   jnp.asarray(lens))
        hi, hc, hh = jax_sparse.sorted_term_counts_host(toks, lens)
        assert ti.dtype == torch.int32 and tc.dtype == torch.int32
        for ours, theirs in ((ti, ji), (tc, jc), (th, jh),
                             (ti, hi), (tc, hc), (th, hh)):
            np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))

    def test_uint16_ids(self):
        toks, lens = _batch(4, 5, 20, 1 << 16)
        t16 = toks.astype(np.uint16)
        ti, tc, th = sparse.sorted_term_counts(torch.from_numpy(t16),
                                               torch.from_numpy(lens))
        ji, jc, jh = jax_sparse.sorted_term_counts(jnp.asarray(t16),
                                                   jnp.asarray(lens))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


@pytest.mark.parametrize("seed,d,length,vocab", BATCHES)
def test_sparse_df_matches_jax(seed, d, length, vocab):
    toks, lens = _batch(seed, d, length, vocab)
    ti, _, th = sparse.sorted_term_counts(torch.from_numpy(toks),
                                          torch.from_numpy(lens))
    ji, _, jh = jax_sparse.sorted_term_counts(jnp.asarray(toks),
                                              jnp.asarray(lens))
    ours = sparse.sparse_df(ti, th, vocab)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(jax_sparse.sparse_df(ji, jh, vocab,
                                                      method="scatter")))


class TestIdf:
    @pytest.mark.parametrize("num_docs", [1, 7, 1000, 32768])
    def test_within_one_ulp_of_jax(self, num_docs):
        rng = np.random.default_rng(num_docs)
        df = rng.integers(0, num_docs + 1, 4096).astype(np.int32)
        df[:3] = [0, 1, num_docs]
        ours = scoring.idf_from_df(torch.from_numpy(df), num_docs).numpy()
        theirs = np.asarray(jax_scoring.idf_from_df(jnp.asarray(df), num_docs))
        assert ours.dtype == np.float32
        assert ours[0] == 0.0 and ours[2] == 0.0  # df 0, df == N
        ulp = np.spacing(np.abs(theirs))
        assert (np.abs(ours - theirs) <= ulp).all()

    def test_float64_canonicalises_to_float32(self):
        df = torch.tensor([0, 1, 3], dtype=torch.int32)
        a = scoring.idf_from_df(df, 5, "float64")
        b = scoring.idf_from_df(df, 5, torch.float32)
        assert a.dtype == torch.float32 and torch.equal(a, b)
        assert scoring.canonical_score_dtype(np.float64) == torch.float32
        assert scoring.canonical_score_dtype("bfloat16") == torch.bfloat16
        with pytest.raises(ValueError):
            scoring.canonical_score_dtype("int8")

    def test_dense_scores_match_jax_with_shared_idf_inputs(self):
        toks, lens = _batch(5, 8, 32, 20)
        counts = histogram.tf_counts(torch.from_numpy(toks),
                                     torch.from_numpy(lens), 20)
        tf_ours = scoring.tf_matrix(counts, torch.from_numpy(lens)).numpy()
        tf_jax = np.asarray(jax_scoring.tf_matrix(jnp.asarray(counts.numpy()),
                                                  jnp.asarray(lens)))
        np.testing.assert_array_equal(tf_ours.view(np.uint32),
                                      tf_jax.view(np.uint32))


class TestHistogram:
    @pytest.mark.parametrize("seed,d,length,vocab", BATCHES)
    def test_tf_counts_and_df(self, seed, d, length, vocab):
        toks, lens = _batch(seed, d, length, vocab)
        ours = histogram.tf_counts(torch.from_numpy(toks),
                                   torch.from_numpy(lens), vocab)
        theirs = jax_histogram.tf_counts(jnp.asarray(toks), jnp.asarray(lens),
                                         vocab)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
        np.testing.assert_array_equal(
            histogram.df_from_counts(ours).numpy(),
            np.asarray(jax_histogram.df_from_counts(theirs)))

    @pytest.mark.parametrize("chunk", [4, 8, 32])
    def test_tf_counts_chunked(self, chunk):
        toks, lens = _batch(6, 7, 32, 12)
        ours = histogram.tf_counts_chunked(torch.from_numpy(toks),
                                           torch.from_numpy(lens), 12, chunk)
        theirs = jax_histogram.tf_counts_chunked(
            jnp.asarray(toks), jnp.asarray(lens), 12, chunk)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
        np.testing.assert_array_equal(
            ours.numpy(), histogram.tf_counts(torch.from_numpy(toks),
                                              torch.from_numpy(lens), 12).numpy())

    def test_chunked_rejects_ragged_axis(self):
        with pytest.raises(ValueError):
            histogram.tf_counts_chunked(torch.zeros((2, 10), dtype=torch.int32),
                                        torch.zeros(2, dtype=torch.int32), 4, 3)

    def test_masked_offset(self):
        toks, lens = _batch(7, 6, 40, 128)
        valid = np.arange(40)[None, :] < lens[:, None]
        ours = histogram.tf_counts_masked(torch.from_numpy(toks),
                                          torch.from_numpy(valid), 32, 64)
        theirs = jax_histogram.tf_counts_masked(
            jnp.asarray(toks), jnp.asarray(valid), 32, id_offset=64)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


class TestTopkPerDoc:
    def test_ties_break_toward_lower_index(self):
        scores = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
        vals, ids = topk.topk_per_doc(scores, 5)
        np.testing.assert_array_equal(ids.numpy(), [[1, 2, 4, 3, 0]])
        assert vals.is_contiguous()

    @pytest.mark.parametrize("k", [1, 4, 16])
    def test_matches_lax_top_k(self, k):
        # small integer-valued scores: ties everywhere
        rng = np.random.default_rng(k)
        scores = rng.integers(0, 4, (12, 40)).astype(np.float32)
        vals, ids = topk.topk_per_doc(torch.from_numpy(scores), k)
        jv, ji = lax.top_k(jnp.asarray(scores), k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


class TestResultWords:
    def test_unpack_matches_jax(self):
        rng = np.random.default_rng(5)
        words = rng.integers(0, 1 << 32, (30, 7), dtype=np.uint64).astype(np.uint32)
        words[0, :4] = [0x7E000005, 0xBC000000, 0x00000009, 0x7C00FFFF]
        for dt in ("float32", "float64", "float16"):
            tv, tt = downlink.unpack_result_words(words, score_dtype=dt)
            jv, jt = jax_downlink.unpack_result_words(words, score_dtype=dt)
            np.testing.assert_array_equal(tt, jt)
            assert tv.dtype == np.asarray(jv).dtype
            np.testing.assert_array_equal(tv, np.asarray(jv))
        tv, tt = downlink.unpack_result_words(words, score_dtype="bfloat16")
        jv, jt = jax_downlink.unpack_result_words(words,
                                                  score_dtype=jnp.bfloat16)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tv, np.asarray(jv).astype(np.float32))

    def test_round_trip(self):
        vals = torch.tensor([[0.0, 1.5, 2.0]])
        tids = torch.tensor([[65535, 0, -1]], dtype=torch.int32)
        v, t = downlink.unpack_result_words(
            kernels.pack_words(vals, tids).numpy())
        np.testing.assert_array_equal(t, [[65535, 0, -1]])
        np.testing.assert_array_equal(v, [[0.0, 1.5, 0.0]])

    @pytest.mark.parametrize("kw,vocab", [
        ({"topk": 5}, None),
        ({"topk": 5, "result_wire": "pair"}, None),
        ({"topk": None}, None),
        ({"topk": 5}, (1 << 16) + 1),
        ({"topk": 5}, 1 << 16),
        ({"topk": 5, "score_dtype": "float64"}, None),
        ({"topk": 5, "score_dtype": "bfloat16"}, None),
        ({"topk": 5, "score_dtype": "float16"}, None),
    ])
    def test_wire_selection_matches_jax(self, kw, vocab):
        jcfg = JaxConfig(vocab_mode=JaxVocabMode.HASHED, **kw)
        tcfg = interop.config_from_dict(dataclasses.asdict(jcfg))
        assert (downlink.use_packed_result_wire(tcfg, vocab_size=vocab)
                == jax_downlink.use_packed_result_wire(jcfg, vocab_size=vocab))
        assert downlink.wire16_dtype(tcfg.score_dtype) == (
            torch.bfloat16 if kw.get("score_dtype") == "bfloat16"
            else torch.float16)


def test_words_to_ids_matches_jax():
    words = [b"", b"a", b"quick", b"\xff\x00\x80", b"x" * 40, b"tfidf"]
    for vocab, seed in ((1 << 16, 0), (97, 3), (1 << 20, 12345)):
        np.testing.assert_array_equal(words_to_ids(words, vocab, seed),
                                      jax_words_to_ids(words, vocab, seed))


def test_config_from_dict_round_trip():
    jcfg = JaxConfig(vocab_mode=JaxVocabMode.HASHED, vocab_size=512, topk=3,
                     ngram_range=(2, 4), score_dtype="bfloat16")
    tcfg = interop.config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == {
        k: (v.value if hasattr(v, "value") else v)
        for k, v in dataclasses.asdict(jcfg).items()}
    assert tcfg.engine == "sparse"
    with pytest.raises(ValueError, match="unknown"):
        interop.config_from_dict({"bogus": 1})
