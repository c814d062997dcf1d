"""Top-k selection (port of ``tfidf_tpu/ops/topk.py``'s ``topk_per_doc``
and its retrieval half: ``_DEAD``, ``masked_topk``, ``segment_score_topk``
and ``merge_topk``).

``lax.top_k`` breaks equal scores toward the LOWER index; ``torch.topk``
does not promise any order among ties. So every selection here is a
stable descending sort: among equal scores the lower index stays first.
"""

from __future__ import annotations

from typing import Tuple

import torch

# Below any cosine or BM25 score (>= 0): a masked row (a tombstone, a
# filtered-out doc) loses to every live one and surfaces only when fewer
# than k live candidates exist, then with a negative value that the
# retriever's ``vals > 0`` result mask drops.
_DEAD = -1.0


def topk_rows(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along dim 1 in ``lax.top_k``'s order: score descending, then
    the lower index. [N, M] -> ([N, k], int32 [N, k])."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32)


def topk_per_doc(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (value, vocab-id) per document. [D, V] -> ([D, K], [D, K]),
    ids int32, ties toward the lower id."""
    return topk_rows(scores, k)


def masked_topk(scores: torch.Tensor, live: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over [Q, D] scores with dead docs (``live`` [D] False)
    scoring ``_DEAD`` first."""
    return topk_rows(torch.where(live[None, :], scores, _DEAD), k)


def merge_topk(vals: torch.Tensor, ids: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k-of-top-k: candidate lists already concatenated along dim 1
    (in row order, ids global) -> the final [Q, k] selection; among
    equal scores the earlier position wins."""
    best, sel = topk_rows(vals, k)
    return best, torch.gather(ids, 1, sel.long())


def segment_score_topk(data: torch.Tensor, cols: torch.Tensor,
                       live: torch.Tensor, qmat: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The untiled score+select of one row block: one tile-scores launch
    over every row of the [D, L] face against the [V, Q] queries, dead
    rows (``live`` [D] False) masked, per-query top-k -> ([Q, k],
    [Q, k]) with block-local row ids."""
    from tfidf_tpu_torch.ops.kernels import tile_scores
    return masked_topk(tile_scores(data, cols, qmat).t(), live, k)
