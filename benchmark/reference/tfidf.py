"""TF-IDF and BM25 from their definitions, over hashed term ids.

Every formula runs in float64 (the reference) or, for the control, in
bfloat16: with ``precision="bfloat16"`` every elementwise result is
rounded to bfloat16 and sums accumulate in float32 before their own
rounding, as a bfloat16 kernel would compute them.

Definitions (TFIDF.c's TF-IDF; Lucene's BM25):

* ``df(t)``: documents holding term t; ``N`` documents.
* per-document TF-IDF: ``c / dl * log(N / df)``; ``dl`` the document's
  token count after truncation to ``doc_len``.
* cosine: document weights ``c / dl * log(N / df)`` scaled to unit L2
  norm, the query's ``qc / qlen * log(N / df)`` likewise; the score is
  their dot product. A term in no document weighs 0.
* BM25: ``idf = log(1 + (N - df + 0.5) / (df + 0.5))``, weight ``idf *
  c (k1 + 1) / (c + k1 (1 - b + b dl / avgdl))``, score = sum over the
  query's terms of its count times the weight; ``avgdl`` the mean
  ``dl``.
* Ranking: score descending, then document (or term) ascending; only
  positive scores rank in a search.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from benchmark.reference.hashing import fnv1a64, fold, tokenize

PRECISIONS = ("float64", "bfloat16")


def bf16(x) -> np.ndarray:
    """Round to the nearest bfloat16 (ties to even), returned as float64."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> np.uint64(16)) & np.uint64(1))) \
        & np.uint64(0xFFFF0000)
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


class Arith:
    """Elementwise rounding and summation of one precision."""

    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        self.low = precision == "bfloat16"

    def r(self, x):
        return bf16(x) if self.low else np.asarray(x, np.float64)

    def acc_dtype(self):
        return np.float32 if self.low else np.float64


@dataclass
class Index:
    """Term counts of a corpus: pairs sorted by (doc, term)."""

    num_docs: int
    vocab_size: int
    dl: np.ndarray         # int64 [D] tokens kept per document
    doc: np.ndarray        # int64 [P]
    term: np.ndarray       # int64 [P]
    count: np.ndarray      # int64 [P]
    df: np.ndarray         # int64 [V]
    starts: np.ndarray     # int64 [D + 1] each document's first pair

    def key(self, doc, term) -> np.ndarray:
        return np.asarray(doc, np.int64) * self.vocab_size + np.asarray(
            term, np.int64)


def build_index(token_terms: np.ndarray, doc_starts: np.ndarray,
                vocab_size: int, doc_len: Optional[int]) -> Index:
    """Count the terms of documents given as one flat term sequence
    (document d is ``token_terms[doc_starts[d]:doc_starts[d + 1]]``),
    each cut to its first ``doc_len`` tokens."""
    n = len(doc_starts) - 1
    lens = np.diff(doc_starts)
    dl = lens if doc_len is None else np.minimum(lens, doc_len)
    doc_of = np.repeat(np.arange(n, dtype=np.int64), lens)
    if doc_len is not None and (lens > doc_len).any():
        pos = np.arange(len(token_terms), dtype=np.int64) \
            - np.repeat(doc_starts[:-1], lens)
        keep = pos < doc_len
        doc_of, terms = doc_of[keep], token_terms[keep]
    else:
        terms = token_terms
    keys, count = np.unique(doc_of * vocab_size + terms.astype(np.int64),
                            return_counts=True)
    doc, term = np.divmod(keys, vocab_size)
    starts = np.searchsorted(doc, np.arange(n + 1))
    df = np.bincount(term, minlength=vocab_size).astype(np.int64)
    return Index(n, vocab_size, dl.astype(np.int64), doc, term,
                 count.astype(np.int64), df, starts)


def query_terms(text: str, vocab_size: int, seed: int = 0) -> np.ndarray:
    toks = tokenize(text.encode())
    if not toks:
        return np.zeros(0, np.int64)
    return fold(fnv1a64(toks, seed), vocab_size)


def tfidf_idf(ix: Index, a: Arith) -> np.ndarray:
    df = ix.df.astype(np.float64)
    with np.errstate(divide="ignore"):
        q = a.r(ix.num_docs / np.maximum(df, 1))
    return np.where(ix.df > 0, a.r(np.log(q)), 0.0)


def bm25_idf(ix: Index, a: Arith) -> np.ndarray:
    df = ix.df.astype(np.float64)
    q = a.r(a.r(ix.num_docs - df + 0.5) / a.r(df + 0.5))
    return np.where(ix.df > 0, a.r(np.log1p(q)), 0.0)


def row_sums(values: np.ndarray, starts: np.ndarray, a: Arith) -> np.ndarray:
    """Per-document sums of pair values, in the precision's accumulator
    (0 for a document with no pairs)."""
    v = values.astype(a.acc_dtype())
    if len(v) == 0:
        return np.zeros(len(starts) - 1)
    lo = np.minimum(starts[:-1], len(v) - 1)
    sums = np.add.reduceat(v, lo).astype(np.float64)
    return np.where(starts[1:] > starts[:-1], sums, 0.0)


def face(ix: Index, scorer: dict, precision: str = "float64") -> np.ndarray:
    """The per-pair document weights of a scorer (``{"kind": "bm25",
    "k1": .., "b": ..}`` or ``{"kind": "tfidf"}``, the cosine)."""
    a = Arith(precision)
    c = ix.count.astype(np.float64)
    dl = ix.dl[ix.doc].astype(np.float64)
    if scorer["kind"] == "bm25":
        k1, b = float(scorer["k1"]), float(scorer["b"])
        avgdl = a.r(ix.dl.sum() / ix.num_docs)
        norm = a.r(k1 * a.r(a.r(1.0 - b) + a.r(b * a.r(dl / avgdl))))
        sat = a.r(a.r(c * (k1 + 1.0)) / a.r(c + norm))
        return a.r(bm25_idf(ix, a)[ix.term] * sat)
    w = a.r(a.r(c / dl) * tfidf_idf(ix, a)[ix.term])
    norm = a.r(np.sqrt(row_sums(a.r(w * w), ix.starts, a)))
    n = norm[ix.doc]
    return np.where(n > 0, a.r(w / np.where(n > 0, n, 1.0)), 0.0)


@dataclass
class Postings:
    """A face inverted by term: term t's documents and weights lie in
    ``[starts[t], starts[t + 1])``."""

    doc: np.ndarray
    weight: np.ndarray
    starts: np.ndarray


def invert(ix: Index, weights: np.ndarray) -> Postings:
    order = np.argsort(ix.term, kind="stable")
    starts = np.searchsorted(ix.term[order], np.arange(ix.vocab_size + 1))
    return Postings(ix.doc[order], weights[order], starts)


def query_vector(ix: Index, scorer: dict, terms: np.ndarray,
                 a: Arith) -> Tuple[np.ndarray, np.ndarray]:
    """A query's distinct terms and their weights."""
    uniq, qc = np.unique(terms, return_counts=True)
    qc = qc.astype(np.float64)
    if scorer["kind"] == "bm25":
        return uniq, qc
    w = a.r(a.r(qc / len(terms)) * tfidf_idf(ix, a)[uniq])
    norm = float(a.r(np.sqrt(a.r(w * w).astype(a.acc_dtype()).sum())))
    return uniq, (a.r(w / norm) if norm > 0 else np.zeros_like(w))


def search(ix: Index, post: Postings, scorer: dict, queries: Sequence[str],
           k: int, precision: str = "float64",
           picks: Optional[np.ndarray] = None, hash_seed: int = 0):
    """Rank the documents for each query: ``(vals [Q, k], ids [Q, k],
    counts [Q], at_picks [Q, k'])``; missing slots read (0, -1),
    ``counts`` the positive-scoring documents (at most k), ``at_picks``
    this precision's scores of the documents ``picks`` names (0 for -1)."""
    a = Arith(precision)
    q = len(queries)
    vals = np.zeros((q, k))
    ids = np.full((q, k), -1, np.int64)
    counts = np.zeros(q, np.int64)
    at = None if picks is None else np.zeros(picks.shape)
    acc = np.zeros(ix.num_docs, a.acc_dtype())
    for i, text in enumerate(queries):
        acc[:] = 0
        terms, qw = query_vector(ix, scorer,
                                 query_terms(text, ix.vocab_size, hash_seed),
                                 a)
        for t, w in zip(terms.tolist(), qw.tolist()):
            s, e = post.starts[t], post.starts[t + 1]
            if e > s and w != 0.0:
                acc[post.doc[s:e]] += a.r(w * post.weight[s:e]).astype(
                    acc.dtype)
        scores = a.r(acc)
        pos = np.flatnonzero(scores > 0)
        top = pos[np.lexsort((pos, -scores[pos]))][:k]
        vals[i, :len(top)] = scores[top]
        ids[i, :len(top)] = top
        counts[i] = len(top)
        if at is not None:
            p = picks[i]
            at[i] = np.where(p >= 0, scores[np.maximum(p, 0)], 0.0)
    return vals, ids, counts, at


def doc_topk(ix: Index, k: int, precision: str = "float64"):
    """Each document's k highest-scoring terms by per-document TF-IDF:
    ``(vals [D, k], terms [D, k], counts [D], scores [P])``, missing
    slots (0, -1), ``counts`` the picks (every distinct term counts,
    also a zero-scoring one), ``scores`` every pair's score."""
    a = Arith(precision)
    dl = ix.dl[ix.doc].astype(np.float64)
    scores = a.r(a.r(ix.count / dl) * tfidf_idf(ix, a)[ix.term])
    order = np.lexsort((ix.term, -scores, ix.doc))
    n = ix.num_docs
    counts = np.minimum(np.diff(ix.starts), k)
    vals = np.zeros((n, k))
    terms = np.full((n, k), -1, np.int64)
    for j in range(k):
        rows = np.flatnonzero(counts > j)
        src = order[ix.starts[rows] + j]
        vals[rows, j] = scores[src]
        terms[rows, j] = ix.term[src]
    return vals, terms, counts, scores
