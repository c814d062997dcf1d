"""The generators make the same data from the same seed, and the same
amount of work from every seed."""

import numpy as np
import pytest

from benchmark.traffic import text

SPEC = {"docs": 500, "word_types": 4096, "word_bytes": [2, 12],
        "zipf": 1.07,
        "length": {"kind": "lognormal", "median": 50, "sigma": 0.5,
                   "min": 1, "max": 256}}
Q6 = {"query": {"kind": "binomial", "n": 11, "p": 0.45, "min": 1,
                "max": 12}}


def test_words_are_distinct_single_tokens_and_seed_free():
    a, b = text.make_words(SPEC), text.make_words(SPEC)
    assert np.array_equal(a.table, b.table)
    words = [a.word(r) for r in range(len(a))]
    assert len(set(words)) == len(words) == 4096
    assert all(w.split() == [w] and 2 <= len(w) <= 12 for w in words)
    assert len(words[0]) <= len(words[-1])


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, -3])
def test_corpus_is_a_function_of_the_seed(seed):
    w = text.make_words(SPEC)
    a, b = text.make_corpus(SPEC, seed, w), text.make_corpus(SPEC, seed, w)
    assert np.array_equal(a.ranks, b.ranks)
    assert np.array_equal(a.starts, b.starts)
    other = text.make_corpus(SPEC, seed + 1, w)
    assert not np.array_equal(a.ranks[:100], other.ranks[:100])
    # the same lengths, in another order
    assert np.array_equal(np.sort(a.lengths()), np.sort(other.lengths()))


def test_rendered_text_tokenizes_to_its_words(tmp_path):
    w = text.make_words(SPEC)
    c = text.make_corpus(SPEC, 3, w)
    n = text.write_corpus(c, str(tmp_path))
    assert n == sum(len(c.text(d)) for d in range(c.num_docs))
    for d in (0, 17, c.num_docs - 1):
        got = (tmp_path / f"doc{d + 1}").read_bytes().split()
        want = [w.word(r) for r in c.ranks[c.starts[d]:c.starts[d + 1]]]
        assert got == want


def test_zipf_ranks_follow_the_law():
    g = text.rng(1, 1)
    r = text.zipf_ranks(g, 200_000, 1.07, 4096)
    assert r.min() >= 0 and r.max() < 4096
    counts = np.bincount(r, minlength=4096)
    # P(r) ~ r^-1.07: the 1st rank about 2^1.07 times the 2nd
    assert 1.8 < counts[0] / counts[1] < 2.4


def test_queries_distinct_deterministic_and_sized():
    w = text.make_words(SPEC)
    a = text.make_queries(Q6, SPEC, w, 9, 2000)
    assert a == text.make_queries(Q6, SPEC, w, 9, 2000)
    assert len(set(a)) == len(a) == 2000
    lens = [len(q.split()) for q in a]
    assert 1 <= min(lens) and max(lens) <= 12 and 5.0 < np.mean(lens) < 7.0
    assert a != text.make_queries(Q6, SPEC, w, 10, 2000)
    warm = text.make_queries(Q6, SPEC, w, 9, 64, salt=1)
    assert not set(warm) & set(a)


def test_passage_queries_take_the_corpus_lengths():
    w = text.make_words(SPEC)
    q = text.make_queries({"query": "like_docs"}, SPEC, w, 4, 300)
    assert 30 < np.mean([len(x.split()) for x in q]) < 80


def test_the_query_stream_is_the_same_however_it_is_taken():
    w = text.make_words(SPEC)
    whole = text.make_queries(Q6, SPEC, w, 4, 5000)
    stream = text.QueryStream(Q6, SPEC, w, 4)
    parts = stream.take(10) + stream.take(3000) + stream.take(1990)
    assert parts == whole
    again = text.QueryStream(Q6, SPEC, w, 4)
    assert [again[i] for i in (4999, 0, 2048)] == [whole[4999], whole[0],
                                                    whole[2048]]
    # every block is distinct from every other and sized alike per seed
    assert len(set(whole)) == 5000
    other = text.make_queries(Q6, SPEC, w, 5, 5000)
    assert sorted(map(len, (q.split() for q in whole[:2048]))) == \
        sorted(map(len, (q.split() for q in other[:2048])))


def test_arrivals_fill_the_window_the_same_for_every_seed():
    due = text.arrivals({"rate": 500}, 4.0)
    assert len(due) == 2000
    assert np.all(np.diff(due) >= 0) and due[-1] == pytest.approx(4.0)
    assert np.array_equal(due, text.arrivals({"rate": 500}, 4.0))


def test_sample_rows_keeps_the_required_rows():
    rows = text.sample_rows(5, 1000, 50, [3, 999])
    assert len(rows) == 50 and {3, 999} <= set(rows.tolist())
    assert np.array_equal(rows, text.sample_rows(5, 1000, 50, [3, 999]))
