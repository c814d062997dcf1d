"""The sharded TF-IDF compute: per-shard bodies and the mesh collectives
(port of ``tfidf_tpu/parallel/collectives.py``).

Collective mapping from the reference, as in the JAX package:

* ``MPI_Reduce(CustomReduce) + MPI_Bcast`` of the DF table
  (``TFIDF.c:215,220``) -> one docs-axis :meth:`MeshPlan.psum`;
* ``MPI_Bcast(numDocs)`` (``TFIDF.c:115``) -> a Python int every shard
  reads;
* the serial ``MPI_Send``/``Recv`` gather (``TFIDF.c:256-270``) -> a
  per-shard top-k and a K-wide :meth:`MeshPlan.all_gather` over the
  vocab axis;
* the barriers -> nothing; the loop's issue order is the fence.

Each body computes its own (docs x seq x vocab) block with no redundant
work: a vocab shard histograms only its own id range (the TF/DF kernel's
``id_offset``), a seq shard only its token chunk, a docs shard only its
documents. Where ``shard_map`` runs the bodies at once, the port runs
them one after another (``parallel.mesh``): a body that needs a
collective midway is split at it, and the halves are the single-device
functions (``ops.sparse.sparse_forward`` = ``sorted_term_counts`` +
``sparse_df``, then ``sparse_finish``; ``pipeline.CHARGRAM_STAGES``).

A forward returns the JAX outputs in the JAX order: a replicated output
(DF) is one tensor, a docs-sharded output is the list of this process's
shard blocks, in shard order; :func:`gather_rows` assembles it. The JAX
package's ``make_*`` functions return ``lru_cache``d jitted programs;
there is no trace to cache here, so each returns a closure.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tfidf_tpu_torch.ops.kernels import tf_df
from tfidf_tpu_torch.ops.scoring import canonical_score_dtype, tfidf_dense
from tfidf_tpu_torch.ops.sparse import (sorted_term_counts, sparse_df,
                                        sparse_finish)
from tfidf_tpu_torch.ops.topk import topk_rows
from tfidf_tpu_torch.parallel.mesh import MeshPlan

Shard = Tuple[int, int, int]  # (local docs, seq, vocab) shard index


@dataclasses.dataclass
class ShardedBatch:
    """A [D, L] batch placed on a mesh: ``tokens[(d, s, v)]`` is local
    docs shard d's rows, seq shard s's token columns, on ``plan.device(d,
    s, v)`` (replicated over vocab shards, uploaded once per device);
    ``lengths[(d, s, v)]`` the rows' lengths beside it."""

    tokens: Dict[Shard, torch.Tensor]
    lengths: Dict[Shard, torch.Tensor]


def place_batch(plan: MeshPlan, token_ids, lengths) -> ShardedBatch:
    """Upload a host batch (D a docs-shard multiple, L a seq-shard
    multiple; ``plan.pad_docs``/``pad_tokens``) block by block, each to
    its shard's device. Ids travel as int32, as on one device."""
    token_ids = np.asarray(token_ids)
    lengths = np.asarray(lengths, dtype=np.int32)
    d_all, length = token_ids.shape
    if d_all % plan.n_docs_shards or length % plan.n_seq_shards:
        raise ValueError(f"batch [{d_all}, {length}] does not split over "
                         f"mesh {plan.shape} (pad with plan.pad_docs/"
                         f"pad_tokens)")
    ll = length // plan.n_seq_shards
    row_toks = plan.row_blocks(token_ids)
    row_lens = plan.row_blocks(lengths)
    toks: Dict[Shard, torch.Tensor] = {}
    lens: Dict[Shard, torch.Tensor] = {}
    uploaded: Dict[tuple, torch.Tensor] = {}
    for d in range(plan.n_local_docs):
        for s in range(plan.n_seq_shards):
            for v in range(plan.n_vocab_shards):
                dev = plan.device(d, s, v)
                key = (d, s, dev)
                if key not in uploaded:
                    block = np.ascontiguousarray(
                        row_toks[d][:, s * ll:(s + 1) * ll], dtype=np.int32)
                    uploaded[key] = torch.from_numpy(block).to(dev)
                if (d, dev) not in uploaded:
                    uploaded[d, dev] = torch.from_numpy(
                        np.ascontiguousarray(row_lens[d])).to(dev)
                toks[d, s, v] = uploaded[key]
                lens[d, s, v] = uploaded[d, dev]
    return ShardedBatch(toks, lens)


def gather_rows(plan: MeshPlan, parts: List[torch.Tensor]) -> torch.Tensor:
    """A docs-sharded output's global rows, in global row order (every
    process's shards)."""
    return plan.all_gather(parts, dim=0, across_processes=True)


def sharded_counts(plan: MeshPlan, batch: ShardedBatch, vocab_size: int
                   ) -> Dict[Tuple[int, int], torch.Tensor]:
    """Each (local docs shard d, vocab shard v)'s dense [Dl, V / n_vocab]
    counts: per seq shard the TF/DF kernel histograms vocab shard v's id
    range of its token chunk (counts only: presence is taken after the
    seq psum, since a chunk's partial counts can undercount it), then the
    seq psum assembles each document's counts. ``vocab_size`` is the
    global (padded) V."""
    n_seq, n_vocab = plan.n_seq_shards, plan.n_vocab_shards
    v_shard = vocab_size // n_vocab
    counts: Dict[Tuple[int, int], torch.Tensor] = {}
    for d in range(plan.n_local_docs):
        for v in range(n_vocab):
            parts = []
            for s in range(n_seq):
                tok = batch.tokens[d, s, v]
                ll = tok.shape[1]
                # global positions [s * ll, (s + 1) * ll) of each doc:
                # the kernel masks by this chunk's remaining length
                rem = torch.clamp(batch.lengths[d, s, v] - s * ll, 0, ll)
                c, _ = tf_df(tok, rem, vocab_size=v_shard,
                             id_offset=v * v_shard, with_df=False)
                parts.append(c)
            counts[d, v] = plan.psum(parts, across_processes=False)
    return counts


def presence_df(plan: MeshPlan, counts: Dict[Tuple[int, int], torch.Tensor]
                ) -> List[torch.Tensor]:
    """Each vocab shard's DF: the docs psum of the documents' presence."""
    return [plan.psum([(counts[d, v] > 0).sum(dim=0, dtype=torch.int32)
                       for d in range(plan.n_local_docs)])
            for v in range(plan.n_vocab_shards)]


def vocab_rows(plan: MeshPlan, blocks: Dict[Tuple[int, int], torch.Tensor]
               ) -> List[torch.Tensor]:
    """Each local docs shard's [Dl, V] rows, its vocab shards in order."""
    return [plan.all_gather([blocks[d, v]
                             for v in range(plan.n_vocab_shards)], dim=1)
            for d in range(plan.n_local_docs)]


def select_topk(plan: MeshPlan, scores: Dict[Tuple[int, int], torch.Tensor],
                topk: int, v_shard: int
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Per local docs shard, the top-k of its dense rows across the vocab
    shards: each vocab shard keeps its own top k, the K-wide candidates
    gather in vocab-shard order (lower ids first) and are selected again,
    so ties go to the lower id as on one device."""
    k_local = min(topk, v_shard)
    vals, ids = [], []
    for d in range(plan.n_local_docs):
        cand_v, cand_i = [], []
        for v in range(plan.n_vocab_shards):
            tv, ti = topk_rows(scores[d, v], k_local)
            cand_v.append(tv)
            cand_i.append(ti + v * v_shard)
        vg = plan.all_gather(cand_v, dim=1)
        ig = plan.all_gather(cand_i, dim=1)
        vk, sel = topk_rows(vg, min(topk, vg.shape[1]))
        vals.append(vk)
        ids.append(torch.gather(ig, 1, sel.long()))
    return vals, ids


def make_sharded_forward(plan: MeshPlan, vocab_size: int, score_dtype,
                         topk: Optional[int]):
    """The dense sharded forward: f(batch: ShardedBatch, num_docs) ->
    (counts, df, scores), or (df, vals, ids) with ``topk``.

    ``vocab_size`` is the global (padded) V, a vocab-shard multiple;
    each vocab shard owns V / n_vocab_shards contiguous ids
    (:func:`sharded_counts`); DF is the docs psum of presence
    (:func:`presence_df`), then the IDF and the scores; in top-k mode
    :func:`select_topk`.
    """
    if vocab_size % plan.n_vocab_shards:
        raise ValueError(f"vocab_size {vocab_size} not divisible by "
                         f"{plan.n_vocab_shards} vocab shards")
    dtype = canonical_score_dtype(score_dtype)
    v_shard = vocab_size // plan.n_vocab_shards

    def forward(batch: ShardedBatch, num_docs: int):
        counts = sharded_counts(plan, batch, vocab_size)
        df = presence_df(plan, counts)
        scores = {(d, v): tfidf_dense(counts[d, v], batch.lengths[d, 0, v],
                                      df[v].to(counts[d, v].device),
                                      num_docs, dtype)
                  for (d, v) in counts}
        df_all = plan.all_gather(df, dim=0)
        if topk is None:
            return vocab_rows(plan, counts), df_all, vocab_rows(plan, scores)
        vals, ids = select_topk(plan, scores, topk, v_shard)
        return df_all, vals, ids

    return forward


def make_sparse_sharded_forward(plan: MeshPlan, vocab_size: int, score_dtype,
                                topk: Optional[int]):
    """The row-sparse sharded forward, docs axis only (sorting is
    row-local; the [V] DF is small enough to replicate): f(batch,
    num_docs) -> (df, vals, ids) with ``topk``, else (df, ids, counts,
    head, scores). Each shard runs ``sparse_forward``'s two halves with
    the docs psum of DF between them: the fused score+top-k kernel per
    shard."""
    if plan.n_seq_shards != 1 or plan.n_vocab_shards != 1:
        raise ValueError("sparse engine shards the docs axis only; build "
                         "the MeshPlan with seq=1, vocab=1")
    dtype = canonical_score_dtype(score_dtype)

    def forward(batch: ShardedBatch, num_docs: int):
        trips, dfs = [], []
        for d in range(plan.n_local_docs):
            toks, lens = batch.tokens[d, 0, 0], batch.lengths[d, 0, 0]
            ids, counts, head = sorted_term_counts(toks, lens)
            trips.append((ids, counts, head, lens))
            dfs.append(sparse_df(ids, head, vocab_size))
        df = plan.psum(dfs)
        outs = [sparse_finish(*t, df.to(t[0].device), num_docs,
                              score_dtype=dtype, topk=topk) for t in trips]
        return (df,) + tuple(list(col) for col in zip(*outs))[1:]

    return forward


def make_chargram_sharded_forward(plan: MeshPlan, vocab_size: int,
                                  ngram_lo: int, ngram_hi: int, seed: int,
                                  score_dtype, topk: int,
                                  engine: str = "dense"):
    """The docs-sharded device chargram: f(batch of bytes, num_docs) ->
    (df, docSize, vals, ids). Docs axis only: an n-gram window spans
    adjacent bytes, so a seq shard would need a halo exchange. Each
    shard runs the single-device chargram's halves
    (``pipeline.CHARGRAM_STAGES``) with the docs psum of DF between."""
    from tfidf_tpu_torch.pipeline import CHARGRAM_STAGES

    if plan.n_seq_shards != 1 or plan.n_vocab_shards != 1:
        raise ValueError("device chargram shards the docs axis only; "
                         "build the MeshPlan with seq=1, vocab=1")
    if topk is None:
        raise ValueError("sharded device chargram serves topk mode only")
    if engine not in CHARGRAM_STAGES:
        raise ValueError(f"unknown chargram engine {engine!r}")
    local, finish = CHARGRAM_STAGES[engine]
    dtype = canonical_score_dtype(score_dtype)

    def forward(batch: ShardedBatch, num_docs: int):
        states, dfs = [], []
        for d in range(plan.n_local_docs):
            state, df = local(batch.tokens[d, 0, 0], batch.lengths[d, 0, 0],
                              vocab_size=vocab_size, ngram_lo=ngram_lo,
                              ngram_hi=ngram_hi, seed=seed)
            states.append(state)
            dfs.append(df)
        df = plan.psum(dfs)
        outs = [finish(st, df.to(dfs[i].device), num_docs,
                       vocab_size=vocab_size, score_dtype=dtype, topk=topk)
                for i, st in enumerate(states)]
        return (df,) + tuple(list(col) for col in zip(*outs))[1:]

    return forward


def sharded_tf_df(plan: MeshPlan, tokens, lengths, vocab_size: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counts + global DF only (no scoring): the minimal DP+psum path.
    ``tokens`` [D, L] and ``lengths`` [D] are host arrays that split
    over the mesh; returns (counts [D, V], df [V])."""
    fwd = make_sharded_forward(plan, vocab_size, torch.float32, None)
    counts, df, _ = fwd(place_batch(plan, tokens, lengths), 1)
    return gather_rows(plan, counts), df
