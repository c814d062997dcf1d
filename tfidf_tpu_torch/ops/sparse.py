"""Row-sparse term-document scoring (port of ``tfidf_tpu/ops/sparse.py``
:34-316 with the host mirror ``sorted_term_counts_host`` :65, ``to_bcoo``
:336, the tiled retrieval half :374-509 and
``sparse_forward`` :519).

Per document, a padded list of (term id, count) pairs is derived by sort
+ run-length encoding — the [D, V] matrix is never built. DF is a
scatter histogram of the head-masked ids and the DF->score join is a
gather from the [V] IDF table (the JAX package's off-TPU lowerings,
``sparse.py:137-181``). The top-k branch of :func:`sparse_forward` goes
through :func:`score_topk`, which on a CUDA tensor launches the fused
score+top-k kernel (``ops.kernels.fused_score_topk``).

Retrieval scores a row-sparse face against a [V, Q] query block with the
tile-scores kernel (``ops.kernels.tile_scores``) in fixed doc tiles, and
keeps a running [Q, k] top-k across them (:func:`score_topk_tiled`).
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from tfidf_tpu_torch import obs
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
    return _sorted_counts_core(token_ids,
                               valid_mask(lengths, token_ids.shape[1]),
                               lengths.to(torch.int32))


def sorted_term_counts_masked(token_ids: torch.Tensor, valid: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`sorted_term_counts` for non-contiguous validity (``valid``
    [D, L] bool): the same triple; after the sort the live entries fill
    each row's prefix wherever the mask's holes were."""
    return _sorted_counts_core(token_ids.to(torch.int32), valid,
                               valid.sum(dim=1, dtype=torch.int32))


def sorted_term_counts_host(token_ids, lengths):
    """Numpy mirror of :func:`sorted_term_counts`, equal to it bit for
    bit (integer sort, compare and cumulative ops only). The segmented
    index derives each mutation's triples on the host with it."""
    token_ids = np.asarray(token_ids, np.int32)
    lengths = np.asarray(lengths, np.int32)
    d, length = token_ids.shape
    pos = np.arange(length, dtype=np.int32)[None, :]
    live = pos < lengths[:, None]
    sorted_ids = np.sort(
        np.where(live, token_ids, INT32_MAX), axis=1).astype(np.int32)
    prev = np.concatenate(
        [np.full((d, 1), -1, np.int32), sorted_ids[:, :-1]], axis=1)
    head = live & (sorted_ids != prev)
    hpos = np.where(head, pos, length).astype(np.int32)
    suffix_min = np.minimum.accumulate(hpos[:, ::-1], axis=1)[:, ::-1]
    next_head = np.concatenate(
        [suffix_min[:, 1:], np.full((d, 1), length, np.int32)], axis=1)
    counts = (np.minimum(next_head, lengths[:, None]) - pos).astype(
        np.int32)
    return sorted_ids, counts, head


def _sorted_counts_core(token_ids, valid, lengths):
    d, length = token_ids.shape
    sorted_ids = torch.sort(
        torch.where(valid, token_ids, INT32_MAX), dim=1).values
    # Post-sort validity: sentinels sort to the tail, so the first
    # lengths[d] (= live count) slots are exactly the live ones.
    live = valid_mask(lengths, length)
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
    counts = torch.minimum(next_head, lengths[:, None]) - pos
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


def sparse_topk_counts(ids: torch.Tensor, counts: torch.Tensor,
                       head: torch.Tensor, lengths: torch.Tensor,
                       idf: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`score_topk` that also returns the picked slots' integer
    counts (``tfidf_tpu/ops/sparse.py:318``; the exact-ids wire's
    payload): ``(vals, tids, cnt)``, invalid picks ``(0, -1, 0)``.

    On the CPU this is the plain version, a copy of the JAX function:
    score, stable sort, gather ids and counts. On CUDA the fused kernel
    selects (:func:`score_topk`, the same picks in the same order) and
    each pick's count is read back by :func:`pick_counts`."""
    if ids.device.type == "cpu":
        k = min(k, ids.shape[1])
        scores = sparse_scores(ids, counts, head, lengths, idf)
        neg = torch.finfo(scores.dtype).min
        vals, sel = torch.sort(torch.where(head, scores, neg), dim=1,
                               descending=True, stable=True)
        vals, sel = vals[:, :k], sel[:, :k]
        ok = vals > neg
        zero = torch.zeros((), dtype=vals.dtype)
        return (torch.where(ok, vals, zero),
                torch.where(ok, torch.gather(ids, 1, sel), -1).to(torch.int32),
                torch.where(ok, torch.gather(counts, 1, sel), 0)
                .to(torch.int32))
    vals, tids = score_topk(ids, counts, head, lengths, idf, k)
    return vals, tids, pick_counts(ids, counts, tids)


def pick_counts(ids: torch.Tensor, counts: torch.Tensor,
                tids: torch.Tensor) -> torch.Tensor:
    """In-document counts of picked term ids ``tids`` [D, k] (-1 = no
    pick, count 0) from sorted triples: each row of ``ids`` ascends with
    an ``INT32_MAX`` tail, so the first slot holding a term is its head
    slot, which holds its count; ``torch.searchsorted`` finds it."""
    pos = torch.searchsorted(ids.contiguous(), tids.contiguous())
    pos = pos.clamp_max(ids.shape[1] - 1)
    return torch.where(tids >= 0, torch.gather(counts, 1, pos),
                       0).to(torch.int32)


def sparse_forward(token_ids: torch.Tensor, lengths: torch.Tensor, num_docs: int,
                   *, vocab_size: int, score_dtype, topk: Optional[int]):
    """Full sparse pipeline step: tokens -> (df, topk | row-sparse scores).

    Returns (df, vals, ids) with ``topk``, else (df, ids, counts, head,
    scores). Never builds [D, V]. The mesh runs the same two halves,
    :func:`sorted_term_counts` + :func:`sparse_df` then
    :func:`sparse_finish`, with the docs-axis sum of DF between them
    (``parallel.collectives``).
    """
    ids, counts, head = sorted_term_counts(token_ids, lengths)
    df = sparse_df(ids, head, vocab_size)
    return sparse_finish(ids, counts, head, lengths, df, num_docs,
                         score_dtype=score_dtype, topk=topk)


def sparse_finish(ids: torch.Tensor, counts: torch.Tensor, head: torch.Tensor,
                  lengths: torch.Tensor, df: torch.Tensor, num_docs: int, *,
                  score_dtype, topk: Optional[int]):
    """The second half of :func:`sparse_forward`: IDF from the (reduced)
    ``df``, then (df, vals, ids) with ``topk`` through the fused kernel,
    else (df, ids, counts, head, scores)."""
    idf = idf_from_df(df, num_docs, score_dtype)
    if topk is not None:
        vals, out_ids = score_topk(ids, counts, head, lengths, idf, topk)
        return df, vals, out_ids
    scores = sparse_scores(ids, counts, head, lengths, idf)
    return df, ids, counts, head, scores


def to_bcoo(ids: torch.Tensor, counts: torch.Tensor, head: torch.Tensor,
            vocab_size: int) -> torch.Tensor:
    """Row-sparse counts as a ``torch.sparse_coo_tensor`` [D, V] (the
    JAX package's BCOO export, for interop; never on the search path).
    Dead slots become explicit zeros at column 0, uncoalesced, as in the
    BCOO form."""
    d, length = ids.shape
    rows = torch.arange(d, device=ids.device).repeat_interleave(length)
    cols = torch.where(head, ids, 0).reshape(-1).to(torch.int64)
    data = torch.where(head, counts, 0).reshape(-1)
    return torch.sparse_coo_tensor(torch.stack([rows, cols]), data,
                                   size=(d, vocab_size),
                                   check_invariants=False)


# --- tiled retrieval scoring -------------------------------------------
#
# The doc axis is scored in fixed tiles against the whole [V, Q] query
# block, and a running [Q, k] top-k folds across them. The result equals
# one untiled score + top-k bit for bit, ties included:
# * a row never splits across tiles, so its score is the same sum over
#   the same L slots;
# * tiles run in ascending row order and every merge puts the carry
#   (lower rows) BEFORE the tile's candidates, and the selections are
#   stable, so the lower position is the lower global row;
# * each tile keeps min(k, tile) rows, which holds every row that can
#   reach the global top-k;
# * the ragged last tile is padded to the full width with rows that
#   score 0 (or the _DEAD sentinel when masked) at the highest global
#   positions, as the JAX package pads it.

_TILE_DEFAULT = 4096


def score_method(explicit: Optional[str] = None) -> str:
    """Validate the ``TFIDF_TPU_SCORE`` knob (``"xla"`` or ``"pallas"``).
    The JAX package picks its BCOO dot or its Pallas kernel by it; the
    port has no BCOO lowering, so both values run the tile-scores kernel
    (as both run the fused score+top-k kernel in batch scoring)."""
    method = explicit if explicit is not None else (
        os.environ.get("TFIDF_TPU_SCORE") or "xla")
    if method not in ("xla", "pallas"):
        raise ValueError(f"unknown TFIDF_TPU_SCORE method {method!r}")
    return method


def score_tiling(explicit: Optional[str] = None) -> bool:
    """The tiled-scoring knob ``TFIDF_TPU_SCORE_TILING`` (default on),
    read at call time. ``off`` takes the untiled path, which the
    retriever splits into 64-query blocks as the JAX package does."""
    raw = (explicit if explicit is not None
           else os.environ.get("TFIDF_TPU_SCORE_TILING", "on"))
    val = str(raw).strip().lower()
    if val in ("on", "1", "true", "yes", ""):
        return True
    if val in ("off", "0", "false", "no"):
        return False
    raise ValueError(
        f"unknown TFIDF_TPU_SCORE_TILING value {raw!r} (on|off)")


def score_tile_rows(d: int, explicit: Optional[int] = None) -> int:
    """Rows per doc tile: ``TFIDF_TPU_QUERY_BLOCK`` (default 4,096),
    clamped to [1, d]."""
    if explicit is None:
        raw = os.environ.get("TFIDF_TPU_QUERY_BLOCK", "")
        explicit = int(raw) if raw.strip() else _TILE_DEFAULT
    return max(1, min(int(explicit), max(1, int(d))))


def _tile_scores(data_t: torch.Tensor, cols_t: torch.Tensor,
                 qmat: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """One tile's [rows, Q] similarities into ``out``: the tile-scores
    kernel on CUDA, its plain version on the CPU."""
    from tfidf_tpu_torch.ops.kernels import tile_scores
    return tile_scores(data_t, cols_t, qmat, out=out)


def score_topk_tiled_trace(data: torch.Tensor, cols: torch.Tensor,
                           live: Optional[torch.Tensor], qmat: torch.Tensor,
                           *, k: int, tile: int, masked: bool
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tiled score+top-k loop (see the section comment): [D, L] face
    x [V, Q] queries -> ([Q, k'], int32 [Q, k']), k' = min(k, D), in
    (score desc, row asc) order. ``live`` ([D] bool, ``masked=True``)
    scores dead rows ``_DEAD`` before selection. One [tile, Q] score
    buffer serves every tile; the loop issues its work without waiting
    on the device. Traced, each tile's three steps are spans
    (``tile_scores``, ``tile_topk``, ``tile_merge``) from four clock
    reads; untraced, the loop pays one ``enabled()`` check a call."""
    from tfidf_tpu_torch.ops.topk import _DEAD, merge_topk, topk_rows

    d = data.shape[0]
    k = min(k, d)
    tile = max(1, min(tile, d))
    kt = min(k, tile)
    q = qmat.shape[1]
    dev = qmat.device
    vals = torch.full((q, k), -float("inf"), dtype=qmat.dtype, device=dev)
    ids = torch.zeros((q, k), dtype=torch.int32, device=dev)
    buf = torch.empty((tile, q), dtype=torch.float32, device=dev)
    traced = obs.enabled()
    clock = time.perf_counter_ns
    for base in range(0, d, tile):
        n = min(tile, d - base)
        if traced:
            t0 = clock()
        if n < tile:
            buf[n:].zero_()  # the ragged last tile's zero padding rows
        _tile_scores(data[base:base + n], cols[base:base + n], qmat,
                     buf[:n])
        if traced:
            t1 = clock()
        sims = buf.t()                                    # [Q, tile]
        if masked:
            live_t = live[base:base + n]
            if n < tile:
                live_t = torch.cat([live_t, live_t.new_zeros(tile - n)])
            sims = torch.where(live_t[None, :], sims, _DEAD)
        v, i = topk_rows(sims, kt)
        if traced:
            t2 = clock()
        # Carry first: its rows precede this tile's, so the merge's
        # earlier-position tie-break is the lower global row.
        vals, ids = merge_topk(torch.cat([vals, v], dim=1),
                               torch.cat([ids, i + base], dim=1), k)
        if traced:
            obs.steps(("tile_scores", "tile_topk", "tile_merge"),
                      (t0, t1, t2, clock()))
    return vals, ids


def score_topk_tiled(data: torch.Tensor, cols: torch.Tensor,
                     live: Optional[torch.Tensor], qmat: torch.Tensor,
                     k: int, tile: Optional[int] = None,
                     method: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tiled score+top-k over a row-sparse face: resolves the tile width
    (:func:`score_tile_rows`) and validates the score knob
    (:func:`score_method`) at call time, then runs
    :func:`score_topk_tiled_trace`."""
    score_method(method)
    d = data.shape[0]
    return score_topk_tiled_trace(data.contiguous(), cols.contiguous(), live,
                                  qmat.contiguous(), k=min(int(k), d),
                                  tile=score_tile_rows(d, tile),
                                  masked=live is not None)
