"""Row-sparse term-document scoring, main-path half (port of
``tfidf_tpu/ops/sparse.py`` :34-316 and ``sparse_forward`` :519).

Per document, a padded list of (term id, count) pairs is derived by sort
+ run-length encoding — the [D, V] matrix is never built. DF is a
scatter histogram of the head-masked ids and the DF->score join is a
gather from the [V] IDF table (the JAX package's off-TPU lowerings,
``sparse.py:137-181``). The top-k branch of :func:`sparse_forward` goes
through :func:`score_topk`, which on a CUDA tensor launches the fused
score+top-k kernel (``ops.kernels.fused_score_topk``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tfidf_tpu_torch.ops.histogram import valid_mask
from tfidf_tpu_torch.ops.scoring import idf_from_df

INT32_MAX = int(np.iinfo(np.int32).max)


def sorted_term_counts(token_ids: torch.Tensor, lengths: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-sparse term counts via sort + run-length encoding.

    Returns (ids, counts, head), each [D, L]: ``head[d, i]`` marks the
    first slot of each distinct term's run in the sorted row; there
    ``ids`` is the term (int32) and ``counts`` its in-document frequency
    (int32). Counts at non-head slots are garbage by contract; padding
    sorts to the row tail as ``INT32_MAX``.
    """
    token_ids = token_ids.to(torch.int32)
    d, length = token_ids.shape
    live = valid_mask(lengths, length)
    sorted_ids = torch.sort(
        torch.where(live, token_ids, INT32_MAX), dim=1).values
    prev = torch.cat([torch.full((d, 1), -1, dtype=torch.int32,
                                 device=token_ids.device),
                      sorted_ids[:, :-1]], dim=1)
    head = live & (sorted_ids != prev)
    pos = torch.arange(length, dtype=torch.int32, device=token_ids.device)
    # Run length at a head slot = next head position (clipped to the
    # live prefix) - own position: an exclusive suffix-min over head
    # positions.
    hpos = torch.where(head, pos[None, :], length)
    suffix_min = torch.cummin(hpos.flip(1), dim=1).values.flip(1)
    next_head = torch.cat([suffix_min[:, 1:],
                           torch.full((d, 1), length, dtype=torch.int32,
                                      device=token_ids.device)], dim=1)
    counts = torch.minimum(next_head, lengths.to(torch.int32)[:, None]) - pos
    return sorted_ids, counts.to(torch.int32), head


def sparse_df(ids: torch.Tensor, head: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Document-frequency vector from row-sparse terms: one scatter-add
    of the head-masked ids (heads are per-doc-distinct, the reference's
    ``currDoc`` dedup). int32 [V]."""
    safe = torch.where(head, ids, vocab_size).reshape(-1)
    df = torch.zeros(vocab_size + 1, dtype=torch.int32, device=ids.device)
    df.index_add_(0, safe, head.reshape(-1).to(torch.int32))
    return df[:vocab_size]


def sparse_scores(ids: torch.Tensor, counts: torch.Tensor, head: torch.Tensor,
                  lengths: torch.Tensor, idf: torch.Tensor) -> torch.Tensor:
    """``score[d, i] = counts[d, i] / docSize[d] * idf[ids[d, i]]`` at head
    slots, 0 elsewhere; [D, L] in idf's dtype."""
    dtype = idf.dtype
    lens = torch.clamp_min(lengths, 1).to(dtype)[:, None]
    safe = torch.where(head, ids, 0)
    idf_slot = idf.index_select(0, safe.reshape(-1)).reshape(safe.shape)
    score = counts.to(dtype) / lens * idf_slot
    return torch.where(head, score, torch.zeros((), dtype=dtype, device=ids.device))


def sparse_topk(scores: torch.Tensor, ids: torch.Tensor, head: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-doc top-k over the row-sparse axis (L candidates, not V).

    Off-head slots score ``finfo.min``; ties go to the lower slot (the
    order of ``lax.top_k``); a ``finfo.min`` survivor means the doc had
    fewer than k terms and decodes to (0, -1).
    """
    k = min(k, scores.shape[1])
    neg = torch.finfo(scores.dtype).min
    masked = torch.where(head, scores, neg)
    vals, sel = torch.sort(masked, dim=1, descending=True, stable=True)
    vals, sel = vals[:, :k], sel[:, :k]
    picked = torch.gather(ids, 1, sel)
    ok = vals > neg
    return (torch.where(ok, vals, torch.zeros((), dtype=vals.dtype,
                                              device=vals.device)),
            torch.where(ok, picked, -1).to(torch.int32))


def score_topk(ids: torch.Tensor, counts: torch.Tensor, head: torch.Tensor,
               lengths: torch.Tensor, idf: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The score+select step: sorted triples + IDF -> per-doc top-k
    ``(vals, tids)`` per the :func:`sparse_topk` contract. On a CUDA
    tensor this launches the fused kernel; on the CPU it runs the
    kernel's plain version, :func:`sparse_scores` + :func:`sparse_topk`."""
    from tfidf_tpu_torch.ops.kernels import fused_score_topk
    return fused_score_topk(ids, counts, head, lengths, idf, k=k)


def sparse_forward(token_ids: torch.Tensor, lengths: torch.Tensor, num_docs: int,
                   *, vocab_size: int, score_dtype, topk: Optional[int]):
    """Full sparse pipeline step: tokens -> (df, topk | row-sparse scores).

    Returns (df, vals, ids) with ``topk``, else (df, ids, counts, head,
    scores). Never builds [D, V].
    """
    ids, counts, head = sorted_term_counts(token_ids, lengths)
    df = sparse_df(ids, head, vocab_size)
    idf = idf_from_df(df, num_docs, score_dtype)
    if topk is not None:
        vals, out_ids = score_topk(ids, counts, head, lengths, idf, topk)
        return df, vals, out_ids
    scores = sparse_scores(ids, counts, head, lengths, idf)
    return df, ids, counts, head, scores
