"""The numbers that decide ``correct``, each compared with its limit.

Ranked answers (a search's documents, a document's terms) are judged
without regard to the order of exact ties:

* ``rank_gap``: the widest gap between the answer's j-th score and the
  reference's j-th best, over the answer's top reference score;
* ``pick_gap``: the widest gap between a picked document's (or term's)
  answered score and the reference's score of that same pick, on the
  same scale, so a wrong id shows though its score be right;
* ``picks_off``: answers whose number of picks differs from the
  reference's, or that pick one id twice (exact: limit 0).

A served index's document face is judged pair by pair (``face_gap``
over each document's largest reference weight; ``face_slots_off`` the
(document, term) slots present on one side only).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def topk_numbers(vals: np.ndarray, ids: np.ndarray, ref_vals: np.ndarray,
                 ref_counts: np.ndarray, at_picks: np.ndarray
                 ) -> Dict[str, float]:
    """``vals``/``ids`` [R, K] the answers (id -1 = no pick),
    ``ref_vals`` [R, K] the reference's best scores (descending, 0
    past its picks), ``ref_counts`` [R] its picks, ``at_picks`` [R, K]
    the reference's scores of the answered ids."""
    vals = np.asarray(vals, np.float64)
    ids = np.asarray(ids, np.int64)
    valid = ids >= 0
    scale = np.where(ref_vals[:, :1] > 0, ref_vals[:, :1], 1.0)
    got = -np.sort(-np.where(valid, vals, 0.0), axis=1)
    rank_gap = np.abs(got - ref_vals) / scale
    pick_gap = np.where(valid, np.abs(vals - at_picks), 0.0) / scale
    s = np.sort(np.where(valid, ids, -1), axis=1)
    dup = ((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any(axis=1)
    off = (valid.sum(axis=1) != ref_counts) | dup
    return {"rank_gap": float(rank_gap.max(initial=0.0)),
            "pick_gap": float(pick_gap.max(initial=0.0)),
            "picks_off": int(off.sum())}


def face_pairs(data: np.ndarray, cols: np.ndarray, rows: int):
    """A served face ``data``/``cols`` [D', L] (rows past ``rows`` are
    padding) as its nonzero (doc, term, weight) triples, sorted by
    (doc, term)."""
    d, slot = np.nonzero(data[:rows])
    term = cols[d, slot].astype(np.int64)
    w = data[d, slot].astype(np.float64)
    order = np.lexsort((term, d))
    return d[order].astype(np.int64), term[order], w[order]


def face_numbers(got_doc: np.ndarray, got_term: np.ndarray,
                 got_w: np.ndarray, ref_doc: np.ndarray,
                 ref_term: np.ndarray, ref_w: np.ndarray,
                 vocab_size: int, rows: int) -> Dict[str, float]:
    """Document weights, pair by pair, against the reference's (both
    sorted by (doc, term); zero reference weights are absent)."""
    live = ref_w != 0
    ref_doc, ref_term, ref_w = ref_doc[live], ref_term[live], ref_w[live]
    got_key = got_doc * vocab_size + got_term
    ref_key = ref_doc * vocab_size + ref_term
    if np.array_equal(got_key, ref_key):
        gi = ri = slice(None)
        slots_off = 0
    else:
        both, gi, ri = np.intersect1d(got_key, ref_key, return_indices=True)
        slots_off = len(got_key) + len(ref_key) - 2 * len(both)
    starts = np.searchsorted(ref_doc, np.arange(rows + 1))
    filled = starts[1:] > starts[:-1]
    peak = np.ones(rows)
    if filled.any():
        peak[filled] = np.maximum.reduceat(np.abs(ref_w),
                                           starts[:-1][filled])
    gap = np.abs(got_w[gi] - ref_w[ri]) / peak[ref_doc[ri]]
    return {"face_gap": float(gap.max(initial=0.0)),
            "face_slots_off": int(slots_off)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number is within its limit (an absent limit, or
    a number that is not finite, fails)."""
    return all(name in limits and np.isfinite(v) and v <= limits[name]
               for name, v in numbers.items())
