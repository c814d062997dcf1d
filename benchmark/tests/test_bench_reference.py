"""The plain reference on hand-worked inputs."""

import math

import numpy as np
import pytest

from benchmark.reference import compare, hashing, tfidf


def test_fnv1a64_known_values():
    # FNV-1a 64 of "" is the offset basis, of "a" the published value
    h = hashing.fnv1a64([b"", b"a", b"foobar"])
    assert h[0] == 0xCBF29CE484222325
    assert h[1] == 0xAF63DC4C8601EC8C
    assert h[2] == 0x85944171F73967E8


def test_fold_and_word_buckets_agree():
    table = np.frombuffer(b"ab xyz q ", np.uint8)
    offsets = np.array([0, 3, 7, 9])
    got = hashing.word_buckets(table, offsets, 1 << 16, seed=5)
    want = hashing.fold(hashing.fnv1a64([b"ab", b"xyz", b"q"], 5), 1 << 16)
    assert np.array_equal(got, want)


def test_word_table_with_a_blank_inside_a_word_is_refused():
    table = np.frombuffer(b"a b ", np.uint8)
    with pytest.raises(ValueError):
        hashing.word_buckets(table, np.array([0, 4]), 16)


def _index():
    # docs: [1, 1, 2], [2, 3], [3]; V 4; doc_len 2 cuts doc 0 to [1, 1]
    terms = np.array([1, 1, 2, 2, 3, 3])
    starts = np.array([0, 3, 5, 6])
    return tfidf.build_index(terms, starts, 4, 2)


def test_index_counts_df_and_truncation():
    ix = _index()
    assert ix.dl.tolist() == [2, 2, 1]
    assert list(zip(ix.doc, ix.term, ix.count)) == [(0, 1, 2), (1, 2, 1),
                                                     (1, 3, 1), (2, 3, 1)]
    assert ix.df.tolist() == [0, 1, 1, 2]


def test_doc_topk_is_tf_times_log_idf():
    ix = _index()
    vals, terms, counts, _ = tfidf.doc_topk(ix, 2)
    assert counts.tolist() == [1, 2, 1]
    assert vals[0, 0] == pytest.approx(2 / 2 * math.log(3 / 1))
    assert terms[1].tolist() == [2, 3]          # log 3 > log 1.5
    assert vals[1].tolist() == pytest.approx([0.5 * math.log(3),
                                              0.5 * math.log(1.5)])
    assert terms[0, 1] == -1


def test_bm25_face_and_search():
    ix = _index()
    sc = {"kind": "bm25", "k1": 0.82, "b": 0.68}
    w = tfidf.face(ix, sc)
    avgdl = 5 / 3
    idf3 = math.log1p((3 - 2 + 0.5) / (2 + 0.5))
    want = idf3 * 1 * 1.82 / (1 + 0.82 * (1 - 0.68 + 0.68 * 1 / avgdl))
    assert w[3] == pytest.approx(want)
    # a bm25 query weighs each distinct term by its raw count
    terms, qw = tfidf.query_vector(ix, sc, np.array([3, 3]),
                                   tfidf.Arith("float64"))
    assert terms.tolist() == [3] and qw.tolist() == [2.0]
    post = tfidf.invert(ix, w)
    assert post.doc[post.starts[3]:post.starts[4]].tolist() == [1, 2]


def test_cosine_face_is_unit_norm():
    ix = _index()
    w = tfidf.face(ix, {"kind": "tfidf"})
    norms = np.sqrt(tfidf.row_sums(w * w, ix.starts, tfidf.Arith("float64")))
    assert norms.tolist() == pytest.approx([1.0, 1.0, 1.0])


def test_bf16_rounds_to_eight_bits():
    x = np.array([1.0, 1.0 + 2 ** -9, 1.0 + 3 * 2 ** -9, 3.14159])
    assert tfidf.bf16(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -7, 3.140625]


def test_topk_numbers_ignore_tie_order_and_catch_faults():
    ref_v = np.array([[3.0, 2.0, 2.0]])
    at = np.array([[3.0, 2.0, 2.0]])
    ok = compare.topk_numbers(np.array([[3.0, 2.0, 2.0]]),
                              np.array([[0, 5, 4]]), ref_v,
                              np.array([3]), at)
    assert ok == {"rank_gap": 0.0, "pick_gap": 0.0, "picks_off": 0}
    wrong_id = compare.topk_numbers(np.array([[3.0, 2.0, 2.0]]),
                                    np.array([[0, 5, 9]]), ref_v,
                                    np.array([3]), np.array([[3.0, 2.0, 0.]]))
    assert wrong_id["pick_gap"] == pytest.approx(2 / 3)
    dup = compare.topk_numbers(np.array([[3.0, 2.0, 2.0]]),
                               np.array([[0, 5, 5]]), ref_v, np.array([3]),
                               at)
    assert dup["picks_off"] == 1
    short = compare.topk_numbers(np.array([[3.0, 2.0, 0.0]]),
                                 np.array([[0, 5, -1]]), ref_v,
                                 np.array([3]), at)
    assert short["picks_off"] == 1 and short["rank_gap"] > 0.5


def test_face_numbers():
    d = np.array([0, 0, 1]); t = np.array([1, 2, 3])
    w = np.array([0.5, 1.0, 2.0])
    same = compare.face_numbers(d, t, w, d, t, w, 4, 2)
    assert same == {"face_gap": 0.0, "face_slots_off": 0}
    off = compare.face_numbers(d, np.array([1, 2, 2]), w, d, t, w, 4, 2)
    assert off["face_slots_off"] == 2
    data = np.array([[0.5, 1.0, 0.0], [2.0, 0.0, 0.0]], np.float32)
    cols = np.array([[1, 2, 0], [3, 0, 0]], np.int32)
    assert [a.tolist() for a in compare.face_pairs(data, cols, 2)] == \
        [[0, 0, 1], [1, 2, 3], [0.5, 1.0, 2.0]]


def test_verdict():
    assert compare.verdict({"a": 1.0}, {"a": 1.0})
    assert not compare.verdict({"a": 1.1}, {"a": 1.0})
    assert not compare.verdict({"a": float("nan")}, {"a": 1.0})
    assert not compare.verdict({"b": 0.0}, {"a": 1.0})
