"""Top-k agreement under the near-tie rule.

Two runs of the pipeline (the port on two devices, or the port and the
JAX package) compute float32 IDF with different ``log`` implementations,
which disagree by an ulp on some inputs. Two candidates whose scores lie
within a few ulp can then swap places in a top-k selection. The rule
used by ``chip_smoke.py`` and the tests:

* ids are equal at every position, except where both picks are real
  candidates whose exact scores (float64, from the integer counts and
  DF) lie within ``tie_ulps`` float32 ulp of each other;
* scores agree position by position within ``val_ulps`` ulp of the wire
  format (float32 on the pair wire, float16 on the packed wire).

Search results ([Q, k] doc ids and scores, :func:`compare_search`) follow
the same rule with the scores the results themselves carry: ids equal
but where the two candidates' scores lie within ``tie_ulps`` ulp, scores
within ``val_tol`` position by position.
"""

from __future__ import annotations

import math

import numpy as np


def exact_score(token_ids: np.ndarray, lengths: np.ndarray, df: np.ndarray,
                num_docs: int, doc: int, term: int) -> float:
    """count/docSize * log(N/DF) of one (doc, term) in float64."""
    n = int(lengths[doc])
    count = int(np.count_nonzero(token_ids[doc, :n] == term))
    return count / max(n, 1) * math.log(num_docs / max(int(df[term]), 1))


def compare_topk(ids_a, vals_a, ids_b, vals_b, *, token_ids, lengths, df,
                 num_docs: int, wire_dtype=np.float32, val_ulps: int = 1,
                 tie_ulps: int = 4) -> dict:
    """Compare two [D, K] top-k selections; returns a report whose
    ``ok`` is True when they agree under the near-tie rule."""
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    va = np.asarray(vals_a, np.float64)
    vb = np.asarray(vals_b, np.float64)
    mag = np.maximum(np.abs(va), np.abs(vb)).astype(wire_dtype)
    tol = val_ulps * np.spacing(mag).astype(np.float64)
    err = np.abs(va - vb)
    bad_vals = int(np.count_nonzero(~(err <= tol)))
    bad_picks = 0
    swaps = 0
    for d, j in np.argwhere(ids_a != ids_b):
        ta, tb = int(ids_a[d, j]), int(ids_b[d, j])
        if ta < 0 or tb < 0:
            bad_picks += 1
            continue
        sa = exact_score(token_ids, lengths, df, num_docs, int(d), ta)
        sb = exact_score(token_ids, lengths, df, num_docs, int(d), tb)
        if abs(sa - sb) <= tie_ulps * float(np.spacing(np.float32(max(sa, sb)))):
            swaps += 1
        else:
            bad_picks += 1
    return {"picks": int(ids_a.size), "near_tie_swaps": swaps,
            "bad_picks": bad_picks, "bad_vals": bad_vals,
            "max_abs_err": float(err.max(initial=0.0)),
            "ok": bad_picks == 0 and bad_vals == 0
            and ids_a.shape == ids_b.shape}


def compare_search(vals_a, ids_a, vals_b, ids_b, *, val_tol: float = 1e-6,
                   tie_ulps: int = 4, val_ulps: int = 0) -> dict:
    """Compare two [Q, k] search results (scores desc, -1 = no result).

    At a position where the ids differ, both must be real docs, and the
    candidate B picked must score (by A, or where A did not return it, by
    B) within ``tie_ulps`` float32 ulp of what A scored there: a near-tie
    swap. Scores agree position by position within ``val_tol`` plus
    ``val_ulps`` float32 ulp of their magnitude (scores that are not
    bounded by 1, as BM25's, need the relative part). Returns
    ``{"picks", "near_tie_swaps", "bad_picks", "bad_vals",
    "max_abs_err", "ok"}``."""
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    va = np.asarray(vals_a, np.float64)
    vb = np.asarray(vals_b, np.float64)
    shape_ok = ids_a.shape == ids_b.shape == va.shape == vb.shape
    if not shape_ok:
        return {"picks": int(ids_a.size), "near_tie_swaps": 0,
                "bad_picks": 0, "bad_vals": 0, "max_abs_err": float("inf"),
                "ok": False}
    err = np.abs(va - vb)
    mag = np.maximum(np.abs(va), np.abs(vb)).astype(np.float32)
    tol = val_tol + val_ulps * np.spacing(mag).astype(np.float64)
    bad_vals = int(np.count_nonzero(~(err <= tol)))
    swaps = bad_picks = 0
    for q, j in np.argwhere(ids_a != ids_b):
        da, db = int(ids_a[q, j]), int(ids_b[q, j])
        if da < 0 or db < 0:
            bad_picks += 1
            continue
        where_a = np.flatnonzero(ids_a[q] == db)
        other = va[q, where_a[0]] if where_a.size else vb[q, j]
        here = va[q, j]
        tie = tie_ulps * float(np.spacing(np.float32(max(abs(here),
                                                         abs(other)))))
        if abs(here - other) <= tie + (0.0 if where_a.size else val_tol):
            swaps += 1
        else:
            bad_picks += 1
    return {"picks": int(ids_a.size), "near_tie_swaps": swaps,
            "bad_picks": bad_picks, "bad_vals": bad_vals,
            "max_abs_err": float(err.max(initial=0.0)),
            "ok": bad_picks == 0 and bad_vals == 0}
