"""Top-k term recall vs the exact-string oracle — the second half of the
north-star metric (BASELINE.md: "identical top-k terms"). The port's
copy of ``tfidf_tpu/recall.py`` (host-only code, the same functions).

The native bit-reference (``native/tfidf_ref.cc``) emits the reference's
exact per-(doc, word) score lines (``doc@word\\t%.16f``, ``TFIDF.c:245,
274-282``) with string-keyed exact vocabulary. The device path hashes words
into a fixed vocab (``ops.hashing``), so its top-k is a set of *bucket*
ids. Recall here is therefore computed collision-aware, in bucket space
(SURVEY §7 "hard parts"):

* the oracle's positive-score top-k words are mapped through the same
  FNV-1a + fold hash the device path used;
* ties at the k-th score are all *acceptable* (either side's ordering
  among equal scores is arbitrary — the reference itself breaks ties by
  insertion order, ``TFIDF.c:303-317``);
* two oracle words that collide into one bucket count once in the
  denominator — the device path cannot distinguish them by construction.

``exact_doc_recall == 1.0`` of the device-exact engine against the
native oracle is pinned by ``tests/test_torch_exact.py`` and
``chip_smoke.py``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from tfidf_tpu_torch.ops.hashing import words_to_ids

DocTerms = List[Tuple[bytes, float]]


def parse_oracle_output(path: str, docs: Optional[Iterable[str]] = None
                        ) -> Dict[str, DocTerms]:
    """Parse reference-format output into per-doc (word, score) lists.

    ``docs``: optional doc-name filter — with a 1M-doc corpus the file
    has one line per (doc, word) record, so recall is usually sampled on
    a subset without holding the full parse in memory.
    """
    want = set(docs) if docs is not None else None
    per: Dict[str, DocTerms] = {}
    with open(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\n")
            if not line:
                continue
            key, score = line.rsplit(b"\t", 1)
            doc, word = key.split(b"@", 1)  # strict names hold no '@'
            name = doc.decode()
            if want is not None and name not in want:
                continue
            per.setdefault(name, []).append((word, float(score)))
    return per


def doc_recall(ref_terms: DocTerms, got_ids: Sequence[int],
               got_vals: Sequence[float], k: int, vocab_size: int,
               seed: int = 0) -> Optional[float]:
    """Collision-aware recall@k of hashed top-k ids vs exact oracle terms.

    Returns None when the oracle has no positive-score terms for the doc
    (every term appears in all docs -> IDF 0; recall is undefined, and
    both sides agree nothing is informative).
    """
    pos = sorted((t for t in ref_terms if t[1] > 0.0), key=lambda t: -t[1])
    if not pos:
        return None
    kk = min(k, len(pos))
    thresh = pos[kk - 1][1]
    buckets = words_to_ids([w for w, _ in pos], vocab_size, seed)
    required = {int(b) for b in buckets[:kk]}
    # Buckets strictly above the k-th score are mandatory; buckets tied
    # AT the k-th score are interchangeable (either side's ordering among
    # equal scores is arbitrary — the reference itself breaks ties by
    # insertion order, TFIDF.c:303-317). A hit on a tied bucket may only
    # fill a tie slot, never substitute for a missed mandatory bucket.
    above = {int(b) for b, (_, s) in zip(buckets, pos) if s > thresh}
    tied = {int(b) for b, (_, s) in zip(buckets, pos) if s == thresh}
    got = {int(i) for i, v in zip(got_ids, got_vals) if i >= 0 and v > 0.0}
    tie_slots = len(required) - len(required & above)
    hit = len(got & above & required) + min(tie_slots, len(got & tied))
    return min(1.0, hit / len(required))


def exact_doc_recall(ref_terms: DocTerms, got_words: Sequence[bytes],
                     k: int) -> Optional[float]:
    """Recall@k of exact-string terms (rerank.exact_topk output) vs the
    oracle — same tie semantics as :func:`doc_recall`, no bucketing."""
    pos = sorted((t for t in ref_terms if t[1] > 0.0), key=lambda t: -t[1])
    if not pos:
        return None
    kk = min(k, len(pos))
    thresh = pos[kk - 1][1]
    required = {w for w, _ in pos[:kk]}
    above = {w for w, s in pos if s > thresh}
    tied = {w for w, s in pos if s == thresh}
    got = set(got_words)
    tie_slots = len(required) - len(required & above)
    hit = len(got & above & required) + min(tie_slots, len(got & tied))
    return min(1.0, hit / len(required))


def retrieval_recall_at_k(got_ids: np.ndarray, oracle_ids: np.ndarray,
                          k: int) -> float:
    """Mean per-query recall@k of RETRIEVED DOC ids vs an oracle
    ranking — the scoring-family suite's metric (round 23): each
    scorer's device top-k is recalled against ITS OWN NumPy-oracle
    top-k (``scoring.oracle.oracle_topk``), so 1.0 is the bit-parity
    expectation, not a vocabulary accident. ``-1`` slots (fewer than k
    positive-score docs) are empty on both sides and drop out of the
    denominator; a query where the oracle retrieves nothing is skipped
    (recall undefined — both sides agree nothing matches)."""
    got = np.asarray(got_ids)
    ora = np.asarray(oracle_ids)
    if got.shape[0] != ora.shape[0]:
        raise ValueError(f"query-count mismatch: {got.shape[0]} vs "
                         f"{ora.shape[0]}")
    scores = []
    for qi in range(ora.shape[0]):
        want = {int(d) for d in ora[qi][:k] if d >= 0}
        if not want:
            continue
        have = {int(d) for d in got[qi][:k] if d >= 0}
        scores.append(len(have & want) / len(want))
    if not scores:
        raise ValueError("no queries with defined recall")
    return float(np.mean(scores))


def scorer_overlap_at_k(ids_a: np.ndarray, ids_b: np.ndarray,
                        k: int) -> float:
    """Mean Jaccard overlap of two scorers' top-k doc sets over the
    same queries — how DIFFERENT two family members' rankings are
    (bm25 vs tfidf in the scoring artifact: well below 1.0 on a Zipf
    corpus, or the bm25 face derivation is secretly the tfidf one).
    Queries where both sides retrieve nothing are skipped."""
    a, b = np.asarray(ids_a), np.asarray(ids_b)
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"query-count mismatch: {a.shape[0]} vs "
                         f"{b.shape[0]}")
    scores = []
    for qi in range(a.shape[0]):
        sa = {int(d) for d in a[qi][:k] if d >= 0}
        sb = {int(d) for d in b[qi][:k] if d >= 0}
        if not sa and not sb:
            continue
        scores.append(len(sa & sb) / len(sa | sb))
    if not scores:
        raise ValueError("no queries with any retrieved docs")
    return float(np.mean(scores))


def corpus_recall(per_doc_ref: Dict[str, DocTerms], names: Sequence[str],
                  topk_ids: np.ndarray, topk_vals: np.ndarray, k: int,
                  vocab_size: int, seed: int = 0) -> float:
    """Mean doc_recall over every doc present in ``per_doc_ref``.

    ``names[d]`` aligns row d of ``topk_ids``/``topk_vals`` with its
    oracle terms; docs with undefined recall are excluded from the mean.
    """
    scores = []
    for d, name in enumerate(names):
        ref = per_doc_ref.get(name)
        if ref is None:
            continue
        r = doc_recall(ref, topk_ids[d], topk_vals[d], k, vocab_size, seed)
        if r is not None:
            scores.append(r)
    if not scores:
        raise ValueError("no overlapping docs with defined recall")
    return float(np.mean(scores))
