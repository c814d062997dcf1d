"""NumPy scoring oracle (port of ``tfidf_tpu/scoring/oracle.py``): the
reference every scorer variant is held against.

Pure numpy, no torch: independent float32 mirrors of the face math
(:func:`tfidf_face`, :func:`bm25_face`) plus a dense ranked search
(:func:`oracle_topk`) with the repo's exact result conventions:
scores descending, ties to the lowest row, dead rows masked by the
sub-zero sentinel, non-positive results masked to ``(0.0, -1)``. The
port keeps that tie order by construction: its top-k selections are
stable descending sorts (``ops.topk``), and the tiled search merges a
carry of lower rows before each tile's candidates.

Parity contract (``tests/test_torch_costmodel_oracle.py``, and
``chip_smoke.py``'s ``path_observe`` on the card): doc IDS and TIE ORDER
are asserted identical between ``TfidfRetriever.search`` and this
oracle; score values are asserted ``allclose``. Two float32 degrees of
freedom remain and are deliberately tolerated: accumulation order across
L slots (the tile-scores kernel sums a row's slots in its own order),
and FMA contraction in the derived weight arrays (within 1 ulp of the
numpy mirrors, not bit-equal). Neither can reorder documents whose score
gap exceeds that noise, which the tests' seeded corpora guarantee.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_DEAD = np.float32(-1.0)


def counts_from_sorted(ids: np.ndarray, head: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy mirror of the stored-index stats derivation: per-row
    ``(counts [D, L], lengths [D])`` from a SORTED row-sparse ``ids``
    (INT32_MAX padding sentinels) and its ``head`` mask — the same
    run-length trick ``ops.sparse._sorted_counts_core`` runs, in exact
    integer arithmetic."""
    ids = np.asarray(ids, np.int32)
    head = np.asarray(head, bool)
    d, length = ids.shape
    lengths = (ids != np.iinfo(np.int32).max).sum(axis=1).astype(
        np.int32)
    pos = np.arange(length, dtype=np.int32)[None, :]
    hpos = np.where(head, pos, length).astype(np.int32)
    suffix_min = np.minimum.accumulate(hpos[:, ::-1], axis=1)[:, ::-1]
    next_head = np.concatenate(
        [suffix_min[:, 1:], np.full((d, 1), length, np.int32)], axis=1)
    counts = (np.minimum(next_head, lengths[:, None]) - pos).astype(
        np.int32)
    return counts, lengths


def df_from_sorted(ids: np.ndarray, head: np.ndarray, vocab_size: int,
                   live: Optional[np.ndarray] = None) -> np.ndarray:
    """Exact-integer DF over (optionally live-masked) rows."""
    head = np.asarray(head, bool)
    if live is not None:
        head = head & np.asarray(live, bool)[:, None]
    terms = np.asarray(ids, np.int64)[head]
    return np.bincount(terms, minlength=vocab_size)[:vocab_size].astype(
        np.int64)


def tfidf_idf(df: np.ndarray, num_docs: int) -> np.ndarray:
    """float32 mirror of ``ops.scoring.idf_from_df``."""
    df = np.asarray(df)
    dff = df.astype(np.float32)
    n = np.float32(num_docs)
    with np.errstate(divide="ignore"):
        idf = np.log(n / np.maximum(dff, np.float32(1.0)))
    return np.where(df > 0, idf, np.float32(0.0)).astype(np.float32)


def bm25_idf(df: np.ndarray, num_docs: int) -> np.ndarray:
    """float32 mirror of ``scoring.family.bm25_idf_from_df``."""
    df = np.asarray(df)
    dff = df.astype(np.float32)
    n = np.float32(num_docs)
    half = np.float32(0.5)
    idf = np.log1p((n - dff + half) / (dff + half))
    return np.where(df > 0, idf, np.float32(0.0)).astype(np.float32)


def tfidf_face(ids, counts, head, lengths, df, num_docs
               ) -> Tuple[np.ndarray, np.ndarray]:
    """L2-normalized tf-idf doc face — ``_build_index``'s float
    sequence in numpy. Returns ``(data, cols)``."""
    head = np.asarray(head, bool)
    idf = tfidf_idf(df, num_docs)
    lens = np.maximum(np.asarray(lengths), 1).astype(np.float32)[:, None]
    safe = np.where(head, np.asarray(ids), 0)
    score = np.asarray(counts).astype(np.float32) / lens * idf[safe]
    score = np.where(head, score, np.float32(0.0))
    norm = np.sqrt((score * score).sum(axis=1, keepdims=True,
                                       dtype=np.float32))
    weights = score / np.maximum(norm, np.float32(1e-30))
    return (weights.astype(np.float32),
            safe.astype(np.int32))


def bm25_face(ids, counts, head, lengths, df, num_docs, avgdl, k1, b
              ) -> Tuple[np.ndarray, np.ndarray]:
    """BM25 doc face — ``scoring.family.bm25_weights`` in numpy.
    Returns ``(data, cols)``."""
    head = np.asarray(head, bool)
    idf = bm25_idf(df, num_docs)
    c = np.asarray(counts).astype(np.float32)
    dl = np.maximum(np.asarray(lengths), 1).astype(np.float32)[:, None]
    k1 = np.float32(k1)
    b = np.float32(b)
    one = np.float32(1.0)
    avgdl = np.float32(avgdl)
    # Padding slots (c == 0) divide 0/0 at k1 == 0; the where() below
    # masks them, so the transient NaN is expected, not an error.
    with np.errstate(invalid="ignore", divide="ignore"):
        sat = (c * (k1 + one)) / (c + k1 * (one - b + b * (dl / avgdl)))
    safe = np.where(head, np.asarray(ids), 0)
    data = np.where(head, idf[safe] * sat, np.float32(0.0))
    return data.astype(np.float32), safe.astype(np.int32)


def oracle_scores(data: np.ndarray, cols: np.ndarray,
                  qmat: np.ndarray) -> np.ndarray:
    """Dense ``[Q, D]`` float32 scores of a row-sparse face against a
    ``[V, Q]`` query block: ``score[q, d] = sum_l data[d, l] *
    qmat[cols[d, l], q]`` — the sparse dot, materialized."""
    data = np.asarray(data, np.float32)
    cols = np.asarray(cols)
    qmat = np.asarray(qmat, np.float32)
    q = qmat.shape[1]
    d = data.shape[0]
    out = np.empty((q, d), np.float32)
    for qi in range(q):
        contrib = data * qmat[:, qi][cols]
        out[qi] = contrib.sum(axis=1, dtype=np.float32)
    return out


def oracle_topk(data, cols, live, qmat, k: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Ranked reference search: ``(vals, ids)`` each ``[Q, min(k, D)]``
    with the repo's exact conventions — sort by (score desc, row asc),
    dead rows (``live`` false) can never surface, and non-positive
    survivors mask to ``(0.0, -1)``."""
    scores = oracle_scores(data, cols, qmat)          # [Q, D]
    if live is not None:
        scores = np.where(np.asarray(live, bool)[None, :], scores,
                          _DEAD)
    q, d = scores.shape
    kk = min(int(k), d)
    rows = np.arange(d)
    vals = np.empty((q, kk), np.float32)
    ids = np.empty((q, kk), np.int64)
    for qi in range(q):
        order = np.lexsort((rows, -scores[qi]))[:kk]
        vals[qi] = scores[qi][order]
        ids[qi] = order
    ok = vals > 0
    return (np.where(ok, vals, np.float32(0.0)),
            np.where(ok, ids, -1))
