"""Top-k selection (port of ``tfidf_tpu/ops/topk.py``: ``topk_per_doc``,
``topk_global`` with its two-stage lowering, ``topk_terms`` and the
retrieval half: ``_DEAD``, ``masked_topk``, ``segment_score_topk`` and
``merge_topk``).

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


# The JAX package's lax.top_k over a flattened [D*V] stream returns int32
# indices, which would wrap past 2^31 slots; topk_global switches there
# to a two-stage selection that never builds the D*V flat index. Torch
# indices are int64, but the port keeps the same two lowerings, so both
# packages select the same records at every shape.
_INT32_SLOTS = 1 << 31


def topk_global(scores: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Global top-k (value, doc-id, vocab-id) over all [D, V] records:
    within 2^31 records one selection over the flattened scores (ties to
    the lower flat index), past it :func:`_topk_global_two_stage`."""
    d, v = scores.shape
    k = min(k, d * v)
    if d * v < _INT32_SLOTS:
        vals, flat = topk_rows(scores.reshape(1, -1), k)
        flat = flat[0].to(torch.int64)
        return vals[0], (flat // v).to(torch.int32), (flat % v).to(torch.int32)
    return _topk_global_two_stage(scores, k)


def _topk_global_two_stage(scores: torch.Tensor, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The beyond-int32 lowering of :func:`topk_global`: a per-doc top-k
    (a document contributes at most k winners), then a global top-k
    over the [D, k'] survivors; doc ids come from the k'-wide flat index
    and vocab ids ride along. Values are identical to the flat
    lowering's; among EQUAL scores the order may differ (both are valid
    top-k sets). Raises, before touching the data, when even the
    survivors overflow 2^31 slots."""
    d, v = scores.shape
    kk = min(k, v)
    if d * kk >= _INT32_SLOTS:
        raise ValueError(
            f"topk_global over {d} x {v} records: even the per-doc "
            f"top-{kk} survivors ({d * kk} slots) overflow the int32 "
            f"flat selection index (>= 2^31); shard the docs axis "
            f"(parallel) or lower k")
    per_vals, per_ids = topk_rows(scores, kk)               # [D, kk]
    vals, flat = topk_rows(per_vals.reshape(1, -1), k)      # over D*kk
    flat = flat[0].to(torch.int64)
    return (vals[0], (flat // kk).to(torch.int32),
            per_ids.reshape(-1)[flat])


def topk_terms(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k *terms* by corpus-summed TF-IDF mass (the recall metric's
    term ranking): [D, V] -> ([k], int32 [k])."""
    vals, ids = topk_rows(scores.sum(dim=0)[None, :], k)
    return vals[0], ids[0]


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
