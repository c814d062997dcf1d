"""The port's kernels (tfidf_tpu_torch/ops/kernels.py) against the JAX
package's Pallas kernels, run in interpret mode on the same numpy inputs.

On the CPU each wrapper runs its kernel's plain PyTorch version, so this
pins the plain versions to the Pallas kernels' contracts: ids and ints
exact, scores and words bit-identical. Both sides get the same numpy idf
table, so no framework's ``log`` enters the comparison. The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfidf_tpu import ingest as jing
from tfidf_tpu.ops import device_tokenize as jdt
from tfidf_tpu.ops.pallas_kernels import (fused_score_topk_pallas,
                                          pack_words_pallas,
                                          ragged_rebuild_pallas,
                                          tf_df_pallas, tile_scores_pallas,
                                          tokenize_hash_pallas)
from tfidf_tpu.ops.sparse import sorted_term_counts as jax_sorted_term_counts
from tfidf_tpu_torch.ops import kernels as K


def _t(a):
    return torch.from_numpy(np.array(a))


def _triples(rng, d, length, vocab, zipf=False):
    """Sorted triples (numpy) of a random batch, and a numpy idf table
    with exact zeros and duplicated values (ties across terms)."""
    if zipf:
        toks = (np.clip(rng.zipf(1.3, (d, length)), 1, vocab) - 1)
    else:
        toks = rng.integers(0, vocab, (d, length))
    lens = rng.integers(0, length + 1, d).astype(np.int32)
    ids, cnt, head = jax_sorted_term_counts(jnp.asarray(toks.astype(np.int32)),
                                            jnp.asarray(lens))
    idf = rng.choice(np.array([0.0, 0.25, 0.5, 1.5, 2.75], np.float32), vocab)
    idf = (idf + (rng.random(vocab) < 0.5) * rng.random(vocab)).astype(np.float32)
    return (np.asarray(ids), np.asarray(cnt), np.asarray(head), lens, idf)


def _both_b1(ids, cnt, head, lens, idf, k):
    jv, jt = fused_score_topk_pallas(jnp.asarray(ids), jnp.asarray(cnt),
                                     jnp.asarray(head), jnp.asarray(lens),
                                     jnp.asarray(idf), k=k, interpret=True)
    tv, tt = K.fused_score_topk(_t(ids), _t(cnt), _t(head), _t(lens),
                                _t(idf), k=k)
    return np.asarray(jv), np.asarray(jt), tv.numpy(), tt.numpy()


class TestFusedScoreTopk:
    """B1: ids exactly equal (same selection, lax.top_k tie order),
    scores bit-equal."""

    @pytest.mark.parametrize("seed,d,length,vocab,k,zipf", [
        (0, 8, 16, 64, 4, False),
        (1, 13, 37, 311, 5, False),     # ragged rows, L not a multiple of 8
        (2, 24, 64, 50, 8, True),       # Zipf ids: many equal scores
        (3, 5, 6, 9, 9, False),         # k > L clips to L
        (4, 40, 128, 1000, 16, True),
        (5, 1, 1, 1, 3, False),         # degenerate
    ])
    def test_matches_pallas(self, seed, d, length, vocab, k, zipf):
        rng = np.random.default_rng(seed)
        ids, cnt, head, lens, idf = _triples(rng, d, length, vocab, zipf)
        jv, jt, tv, tt = _both_b1(ids, cnt, head, lens, idf, min(k, length))
        assert tt.dtype == np.int32 and tv.dtype == np.float32
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tv.view(np.uint32), jv.view(np.uint32))

    @pytest.mark.parametrize("seed,d,length,vocab,k", [
        (10, 24, 64, 50, 8),
        (11, 40, 128, 1000, 16),
    ])
    def test_float16_matches_pallas(self, seed, d, length, vocab, k):
        # float16 scores: each op rounds to float16 on both sides
        rng = np.random.default_rng(seed)
        ids, cnt, head, lens, idf = _triples(rng, d, length, vocab, zipf=True)
        jv, jt, tv, tt = _both_b1(ids, cnt, head, lens,
                                  (idf * 3).astype(np.float16), k)
        assert tv.dtype == np.float16 and jv.dtype == np.float16
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tv.view(np.uint16), jv.view(np.uint16))

    def test_k_beyond_length_is_clipped(self):
        rng = np.random.default_rng(6)
        ids, cnt, head, lens, idf = _triples(rng, 4, 5, 20)
        tv, tt = K.fused_score_topk(_t(ids), _t(cnt), _t(head), _t(lens),
                                    _t(idf), k=50)
        assert tuple(tv.shape) == (4, 5) and tuple(tt.shape) == (4, 5)
        _, jt, _, _ = _both_b1(ids, cnt, head, lens, idf, 5)
        np.testing.assert_array_equal(tt.numpy(), jt)

    def test_tie_breaks_toward_lower_slot(self):
        # two terms with equal counts and equal idf score EQUAL: the
        # lower sorted slot is picked first, as lax.top_k does
        toks = np.array([[5, 5, 9, 9, 3]], np.int32)
        lens = np.array([4], np.int32)
        ids, cnt, head = (np.asarray(a) for a in jax_sorted_term_counts(
            jnp.asarray(toks), jnp.asarray(lens)))
        idf = np.full(16, np.log(4.0), np.float32)
        jv, jt, tv, tt = _both_b1(ids, cnt, head, lens, idf, 3)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tt, [[5, 9, -1]])
        np.testing.assert_array_equal(tv.view(np.uint32), jv.view(np.uint32))

    def test_zero_score_beats_invalid_slot(self):
        # a word in every doc scores exactly 0.0 and is still a valid
        # pick; the missing third pick decodes to (0, -1)
        toks = np.array([[2, 7, 7, 0]], np.int32)
        lens = np.array([3], np.int32)
        ids, cnt, head = (np.asarray(a) for a in jax_sorted_term_counts(
            jnp.asarray(toks), jnp.asarray(lens)))
        idf = np.zeros(8, np.float32)
        jv, jt, tv, tt = _both_b1(ids, cnt, head, lens, idf, 3)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tt, [[2, 7, -1]])
        np.testing.assert_array_equal(tv, [[0.0, 0.0, 0.0]])

    def test_all_invalid_rows(self):
        toks = np.array([[7, 7, 7], [1, 2, 3]], np.int32)
        lens = np.array([0, 0], np.int32)
        ids, cnt, head = (np.asarray(a) for a in jax_sorted_term_counts(
            jnp.asarray(toks), jnp.asarray(lens)))
        idf = np.ones(8, np.float32)
        jv, jt, tv, tt = _both_b1(ids, cnt, head, lens, idf, 2)
        np.testing.assert_array_equal(tt, -1)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tv, 0)

    def test_int32_head_is_accepted(self):
        rng = np.random.default_rng(7)
        ids, cnt, head, lens, idf = _triples(rng, 6, 12, 30)
        a = K.fused_score_topk(_t(ids), _t(cnt), _t(head), _t(lens),
                               _t(idf), k=4)
        b = K.fused_score_topk(_t(ids), _t(cnt), _t(head.astype(np.int32)),
                               _t(lens), _t(idf), k=4)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


class TestTfDf:
    """B2: counts and df exactly equal to tf_df_pallas."""

    @staticmethod
    def _both(toks, lens, vocab, **kw):
        jc, jd = tf_df_pallas(jnp.asarray(toks), jnp.asarray(lens),
                              vocab_size=vocab, interpret=True, **kw)
        tc, td = K.tf_df(_t(toks), _t(lens), vocab_size=vocab, **kw)
        return jc, jd, tc, td

    @pytest.mark.parametrize("shape,vocab", [
        ((8, 128), 128),
        ((24, 256), 512),
        ((5, 100), 70),       # L not a multiple of 128, unaligned everything
        ((9, 300), 33),
        ((1, 128), 1),
    ])
    def test_matches_pallas(self, shape, vocab):
        rng = np.random.default_rng(42)
        toks = rng.integers(0, vocab, shape).astype(np.int32)
        lens = rng.integers(0, shape[1] + 1, shape[0]).astype(np.int32)
        jc, jd, tc, td = self._both(toks, lens, vocab)
        assert tc.dtype == torch.int32 and td.dtype == torch.int32
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))

    @pytest.mark.parametrize("offset,width", [(0, 64), (64, 64), (96, 32)])
    def test_id_offset(self, offset, width):
        rng = np.random.default_rng(7)
        toks = rng.integers(0, 128, (8, 128)).astype(np.int32)
        lens = rng.integers(0, 129, 8).astype(np.int32)
        jc, jd, tc, td = self._both(toks, lens, width, id_offset=offset)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))

    def test_counts_only(self):
        rng = np.random.default_rng(8)
        toks = rng.integers(0, 50, (6, 40)).astype(np.int32)
        lens = rng.integers(0, 41, 6).astype(np.int32)
        jc, jd, tc, td = self._both(toks, lens, 50, with_df=False)
        assert jd is None and td is None
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))

    def test_uint16_ids_do_not_wrap(self):
        # ids near 2^16 minus an offset must not wrap around
        rng = np.random.default_rng(9)
        toks = rng.integers(65000, 65536, (7, 130)).astype(np.uint16)
        lens = rng.integers(0, 131, 7).astype(np.int32)
        jc, jd, tc, td = self._both(toks, lens, 600, id_offset=65000)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert int(tc.sum()) == int(lens.sum())

    def test_all_padding_docs(self):
        toks = np.zeros((4, 128), np.int32)
        lens = np.zeros((4,), np.int32)
        jc, jd, tc, td = self._both(toks, lens, 64)
        assert int(tc.sum()) == 0 and int(td.sum()) == 0
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def _bf16_pair(bits: np.ndarray):
    """The same bfloat16 values as a jax array and a torch tensor."""
    j = jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16)
    t = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    return j, t


class TestPackWords:
    """B3: words bit-identical to pack_words_pallas."""

    def test_float32_random_with_invalid(self):
        rng = np.random.default_rng(8)
        vals = np.abs(rng.normal(size=(20, 5))).astype(np.float32)
        tids = rng.integers(-1, 1 << 16, (20, 5)).astype(np.int32)
        jw = np.asarray(pack_words_pallas(vals, tids, interpret=True))
        tw = K.pack_words(_t(vals), _t(tids))
        assert tw.dtype == torch.uint32
        np.testing.assert_array_equal(tw.numpy(), jw)

    def test_float32_special_values(self):
        # 0.0 stays valid, NaN passes through, past 65504 rounds to inf,
        # tiny values flush per round-to-nearest-even, -0.0 keeps its sign
        vals = np.array([[0.0, np.nan, 65504.0, 65520.0, 70000.0, 1e-8,
                          3e-8, 6e-8, -0.0, 1.0009765625, 1.00048828125, 2.0]],
                        np.float32)
        tids = np.array([[0, 7, 65535, 3, 9, 11, 12, 13, 14, 15, 16, -1]],
                        np.int32)
        jw = np.asarray(pack_words_pallas(vals, tids, interpret=True))
        tw = K.pack_words(_t(vals), _t(tids)).numpy()
        np.testing.assert_array_equal(tw, jw)
        assert tw[0, -1] == 0xBC000000  # invalid: score -1, id 0

    def test_bfloat16(self):
        rng = np.random.default_rng(6)
        f32 = np.abs(rng.normal(size=(6, 4))).astype(np.float32)
        bits = (f32.view(np.uint32) >> 16).astype(np.uint16)
        bits[0, :] = [0x0000, 0x7FC0, 0x7F80, 0x8000]  # 0, NaN, inf, -0
        jv, tv = _bf16_pair(bits)
        tids = rng.integers(-1, 1 << 16, (6, 4)).astype(np.int32)
        tids[0, :] = [1, 2, 3, 4]
        jw = np.asarray(pack_words_pallas(jv, tids, interpret=True))
        tw = K.pack_words(tv, _t(tids)).numpy()
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(tw[tids < 0] >> 16, 0xBF80)


    def test_float16(self):
        # float16 scores keep their bits; invalid slots pack 0xBC00
        rng = np.random.default_rng(9)
        vals = np.abs(rng.normal(size=(7, 5))).astype(np.float16)
        vals[0, :4] = [0.0, np.nan, np.inf, 65504.0]
        tids = rng.integers(-1, 1 << 16, (7, 5)).astype(np.int32)
        tids[0, :4] = [1, 2, 3, 4]
        jw = np.asarray(pack_words_pallas(vals, tids, interpret=True))
        tw = K.pack_words(_t(vals), _t(tids)).numpy()
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(tw[tids < 0] >> 16, 0xBC00)
        valid = tids >= 0
        np.testing.assert_array_equal((tw >> 16).astype(np.uint16)[valid],
                                      vals.view(np.uint16)[valid])


def test_cpu_calls_count_no_launches():
    K.reset_launches()
    rng = np.random.default_rng(1)
    ids, cnt, head, lens, idf = _triples(rng, 4, 8, 16)
    K.fused_score_topk(_t(ids), _t(cnt), _t(head), _t(lens), _t(idf), k=2)
    K.tf_df(_t(ids), _t(lens), vocab_size=16)
    K.pack_words(_t(idf[:4].reshape(2, 2)), _t(np.zeros((2, 2), np.int32)))
    K.ragged_rebuild(_t(np.zeros(16, np.uint16)), _t(lens), length=8, align=8)
    K.tokenize_hash(_t(np.full(8, 32, np.uint8)),
                    _t(np.zeros((4, 8), np.int32)), _t(lens), vocab_size=16)
    K.tile_scores(_t(np.ones((4, 8), np.float32)),
                  _t(np.zeros((4, 8), np.int32)),
                  _t(np.ones((16, 3), np.float32)))
    assert K.LAUNCHES == {"fused_score_topk": 0, "tf_df": 0, "pack_words": 0,
                          "ragged_rebuild": 0, "tokenize_hash": 0,
                          "tile_scores": 0}


def test_pack_words_into_out():
    rng = np.random.default_rng(2)
    vals = np.abs(rng.normal(size=(3, 4, 5))).astype(np.float32)
    tids = rng.integers(-1, 1 << 16, (3, 4, 5)).astype(np.int32)
    out = torch.zeros((3, 4, 5), dtype=torch.uint32)
    for i in range(3):
        got = K.pack_words(_t(vals[i]), _t(tids[i]), out=out[i])
        assert got.data_ptr() == out[i].data_ptr()
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(pack_words_pallas(vals.reshape(12, 5),
                                                  tids.reshape(12, 5),
                                                  interpret=True))
        .reshape(3, 4, 5))


def _flat_case(seed, d, length, align, dtype):
    """A padded batch with edge-case lengths, flattened by the JAX
    package's own wire layout."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, length + 1, d).astype(np.int32)
    lens[0], lens[-1] = 0, length
    ids = rng.integers(0, 60000 if dtype == np.uint16 else 1 << 20,
                       (d, length)).astype(np.int32)
    flat, _ = jing.flatten_aligned(ids, lens, align, dtype=dtype)
    return flat, lens


class TestRaggedRebuild:
    """B4: the whole [D, L] output (padding slots included) equals the
    Pallas kernel and the JAX package's XLA rebuild."""

    @pytest.mark.parametrize("align", [8, 16, 32])
    @pytest.mark.parametrize("dtype", [np.uint16, np.int32])
    @pytest.mark.parametrize("length", [64, 37])
    def test_matches_pallas(self, align, dtype, length):
        flat, lens = _flat_case(align, 11, length, align, dtype)
        want = np.asarray(ragged_rebuild_pallas(
            jnp.asarray(flat), jnp.asarray(lens), length=length, align=align,
            interpret=True))
        got = K.ragged_rebuild(_t(flat), _t(lens), length=length, align=align)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("align", [1, 2, 4, 8, 16])
    @pytest.mark.parametrize("dtype", [np.uint16, np.int32])
    def test_matches_xla_rebuild(self, align, dtype):
        flat, lens = _flat_case(100 + align, 13, 40, align, dtype)
        want = np.asarray(jing.rebuild_padded(jnp.asarray(flat),
                                              jnp.asarray(lens), length=40,
                                              align=align))
        got = K.ragged_rebuild(_t(flat), _t(lens), length=40, align=align)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_negative_lengths_count_as_zero(self):
        flat, lens = _flat_case(5, 6, 16, 8, np.uint16)
        neg = lens.copy()
        neg[2] = -5
        zero = lens.copy()
        zero[2] = 0
        a = K.ragged_rebuild(_t(flat), _t(neg), length=16, align=8)
        b = K.ragged_rebuild(_t(flat), _t(zero), length=16, align=8)
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    def test_rejects_bad_inputs(self):
        lens = _t(np.array([3], np.int32))
        with pytest.raises(ValueError, match="power of two"):
            K.ragged_rebuild(_t(np.zeros(24, np.uint16)), lens, length=4,
                             align=12)
        with pytest.raises(ValueError, match="granules"):
            K.ragged_rebuild(_t(np.zeros(20, np.uint16)), lens, length=4,
                             align=16)


def _slab_case(seed, align=16):
    """Random binary docs (multi-byte UTF-8 included) in the bytes wire's
    slab layout, with the JAX package's token starts."""
    rng = np.random.default_rng(seed)
    docs = [bytes(rng.integers(1, 256, rng.integers(0, 200)).astype(np.uint8))
            for _ in range(9)]
    docs[1] = "héllo wörld 中文 éé naïve".encode()
    docs[2] = b""
    blens = np.array([len(d) for d in docs], np.int32)
    albl = jdt.aligned_byte_lengths(blens, align)
    slab = np.full(1024 * (int(albl.sum()) // 1024 + 1), 0x20, np.uint8)
    offs = np.concatenate([[0], np.cumsum(albl)[:-1]])
    for doc, off in zip(docs, offs):
        slab[off:off + len(doc)] = np.frombuffer(doc, np.uint8)
    starts, valid, lens, b32 = jdt.token_starts(slab, blens, length=24,
                                                align=align)
    return (slab, np.asarray(b32), np.asarray(starts), np.asarray(valid),
            np.asarray(lens))


class TestTokenizeHash:
    """B5: ids equal the Pallas kernel and the XLA hash loop on the whole
    [D, L] (padding slots 0)."""

    @pytest.mark.parametrize("seed,vocab,hash_seed,trunc", [
        (0, 1 << 10, 0, 0), (1, 1 << 16, 7, 0), (2, 999, 0xDEADBEEF, 4),
        (3, 1, 3, 16), (4, 65535, 1, 1)])
    def test_matches_pallas_and_xla(self, seed, vocab, hash_seed, trunc):
        slab, b32, starts, valid, lens = _slab_case(seed)
        want = np.asarray(tokenize_hash_pallas(
            jnp.asarray(b32), jnp.asarray(starts), jnp.asarray(lens),
            vocab_size=vocab, seed=hash_seed, truncate_at=trunc,
            interpret=True))
        xla = np.asarray(jdt.hash_tokens_xla(
            jnp.asarray(b32), jnp.asarray(starts), jnp.asarray(valid),
            vocab_size=vocab, seed=hash_seed, truncate_at=trunc or None))
        np.testing.assert_array_equal(want, xla)
        for slab_in in (slab, b32):  # uint8 as shipped, and the upcast
            got = K.tokenize_hash(_t(slab_in), _t(starts), _t(lens),
                                  vocab_size=vocab, seed=hash_seed,
                                  truncate_at=trunc)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)

    def test_token_at_slab_end(self):
        # a token running to the last byte of the slab stops at its end
        slab = np.frombuffer(b"  abc", np.uint8).copy()
        starts = np.array([[2, 4]], np.int32)
        lens = np.array([1], np.int32)
        got = K.tokenize_hash(_t(slab), _t(starts), _t(lens), vocab_size=97)
        want = np.asarray(tokenize_hash_pallas(
            jnp.asarray(slab.astype(np.int32)), jnp.asarray(starts),
            jnp.asarray(lens), vocab_size=97, interpret=True))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.numpy()[0, 1] == 0

    def test_rejects_wide_vocab(self):
        slab, _, starts, _, lens = _slab_case(0)
        with pytest.raises(ValueError, match="2\\^16"):
            K.tokenize_hash(_t(slab), _t(starts), _t(lens),
                            vocab_size=(1 << 16) + 1)


def _tile_case(seed, rows, length, vocab, q, quantize=True, dead_rows=()):
    """A random row-sparse tile and query block (numpy). Quantized values
    (multiples of 0.5) make every sum exact, so any summation order gives
    the same bits; dead slots carry data 0 at a random column."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, vocab, (rows, length)).astype(np.int32)
    if quantize:
        data = (rng.integers(0, 4, (rows, length)) * 0.5).astype(np.float32)
        qmat = (rng.integers(0, 3, (vocab, q)) * 0.5).astype(np.float32)
    else:
        data = rng.random((rows, length)).astype(np.float32)
        data[rng.random((rows, length)) < 0.3] = 0.0
        qmat = rng.random((vocab, q)).astype(np.float32)
    data[list(dead_rows)] = 0.0
    return data, cols, qmat


class TestTileScores:
    """B6: the plain version against ``tile_scores_pallas`` in interpret
    mode — exact on quantized inputs, rtol 1e-6 (the JAX package's own
    contract for the kernel, tests/test_tiled_score.py) on continuous
    ones, where the two sum the L slots in possibly different roundings.
    The CUDA kernel equals the plain version bit for bit (chip_smoke.py)."""

    @pytest.mark.parametrize("q", [1, 3, 33, 64, 100, 257, 512])
    @pytest.mark.parametrize("rows,length,vocab", [(37, 8, 64), (13, 16, 512)])
    def test_quantized_exact(self, q, rows, length, vocab):
        data, cols, qmat = _tile_case(q + rows, rows, length, vocab, q,
                                      dead_rows=(0, rows - 1))
        want = np.asarray(tile_scores_pallas(
            jnp.asarray(data), jnp.asarray(cols), jnp.asarray(qmat),
            interpret=True))
        got = K.tile_scores(_t(data), _t(cols), _t(qmat))
        assert got.dtype == torch.float32 and tuple(got.shape) == (rows, q)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))
        assert (got.numpy()[[0, rows - 1]] == 0).all()  # all-dead rows

    @pytest.mark.parametrize("q", [1, 3, 33, 64, 100, 257, 512])
    def test_continuous_rtol(self, q):
        data, cols, qmat = _tile_case(100 + q, 29, 12, 300, q, quantize=False,
                                      dead_rows=(5,))
        want = np.asarray(tile_scores_pallas(
            jnp.asarray(data), jnp.asarray(cols), jnp.asarray(qmat),
            interpret=True))
        got = K.tile_scores(_t(data), _t(cols), _t(qmat)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
        # the plain version is a float32 multiply, then add, slot by slot
        ref = np.zeros((29, q), np.float32)
        for sl in range(12):
            ref = ref + data[:, sl, None] * qmat[cols[:, sl]]
        np.testing.assert_array_equal(got, ref)

    def test_out_buffer_and_zero_rows(self):
        data, cols, qmat = _tile_case(7, 10, 4, 32, 5)
        out = torch.full((10, 5), 123.0)
        got = K.tile_scores(_t(data), _t(cols), _t(qmat), out=out)
        assert got is out
        np.testing.assert_array_equal(
            out.numpy(), K.tile_scores_plain(_t(data), _t(cols), _t(qmat)).numpy())
        empty = K.tile_scores(_t(data[:0]), _t(cols[:0]), _t(qmat))
        assert tuple(empty.shape) == (0, 5)

    def test_weight_zero_slots_add_nothing(self):
        # a dead slot's column is read by the plain version and skipped
        # by the kernel: both give the live slots' sum exactly
        data = np.array([[0.5, 0.0, 1.5, 0.0]], np.float32)
        cols = np.array([[1, 2, 3, 0]], np.int32)
        qmat = np.arange(8, dtype=np.float32).reshape(4, 2)
        got = K.tile_scores(_t(data), _t(cols), _t(qmat)).numpy()
        np.testing.assert_array_equal(got, [[0.5 * 2 + 1.5 * 6,
                                             0.5 * 3 + 1.5 * 7]])
