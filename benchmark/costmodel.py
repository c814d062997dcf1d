"""The yardstick of the roofline shares: frozen peaks of one H100 and the
least bytes and operations the kernels' inputs need.

Peaks are NVIDIA's H100 SXM5 data sheet (80 GB HBM3), dense rates, at
its full 700 W power limit; a run prints the card's own limit beside
them. The counts follow from the inputs alone: a document's head slots
(one a distinct term it holds), its length, a query's distinct terms and
their postings (the documents holding them); each input byte read once
and each output byte written once, whatever the kernel reads again, and
only the result the caller needs (the top-k) written. They do not change
when a kernel does: a later kernel is read against the same count. A
search over another index layout (an inverted index) would need a count
of its own.
"""

from __future__ import annotations

from typing import Dict

HBM_BYTES_PER_S = 3.35e12      # device memory bandwidth
FP32_FLOPS_PER_S = 67e12       # float32 outside the tensor cores
POWER_LIMIT_W = 700.0          # the power limit the peaks assume

# Bytes of one element as the kernels take them.
ID, COUNT, LENGTH, SCORE = 4, 4, 4, 4


def score_topk_bytes(docs: int, head_slots: int, vocab_size: int,
                     k: int) -> int:
    """B1 (``csrc/score_topk.cu``) over ``docs`` documents: in, the id
    and count of every head slot, each document's length and the [V]
    IDF; out, the [D, k] scores and ids."""
    return (head_slots * (ID + COUNT) + docs * LENGTH + vocab_size * SCORE
            + docs * k * (SCORE + ID))


def tile_scores_cost(head_slots: int, queries: float,
                     terms_per_query: float, postings_per_query: float,
                     k: int) -> Dict[str, float]:
    """B6 (``csrc/tile_scores.cu``) over one search of the whole index
    for ``queries`` queries: in, the weight and column of every head
    slot (the forward index the search takes) and each query's distinct
    terms with their weights; out, the [Q, k] scores and ids; one
    multiply-add per posting of each query's terms (a document holding
    the term)."""
    per = SCORE + ID
    nbytes = (head_slots * per + queries * terms_per_query * per
              + queries * k * per)
    return {"bytes": float(nbytes),
            "flops": 2.0 * queries * postings_per_query}


def least_seconds(nbytes: float, flops: float = 0.0) -> float:
    """The roofline: the larger of the bytes at the memory peak and the
    operations at the float32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
