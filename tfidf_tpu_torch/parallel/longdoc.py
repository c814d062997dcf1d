"""Long-document (sequence-parallel) histogram: one document across the
mesh (port of ``tfidf_tpu/parallel/longdoc.py``).

The reference streams a document token by token on one rank
(``TFIDF.c:147``). Here the token stream of ONE document is split into
equal chunks laid out over *every* shard of the mesh in (docs, seq,
vocab) order, each chunk is histogrammed on its shard's device (the
TF/DF kernel, counts only, masked by the chunk's remaining length), and
one psum over every shard assembles the document's TF vector. It is the
batch-of-one case of ``ShardedPipeline``'s seq sharding.
"""

from __future__ import annotations

import numpy as np
import torch

from tfidf_tpu_torch.ops.kernels import tf_df
from tfidf_tpu_torch.parallel.mesh import MeshPlan


def make_long_doc_histogram(plan: MeshPlan, vocab_size: int):
    """Build f(tokens [L], length) -> counts int32 [V] for one huge
    document. L must be a multiple of the mesh's total shard count (pad
    with any id and pass the true ``length``). The counts land on the
    first shard's device; across processes every process holds them."""
    n_all = plan.n_docs_shards * plan.n_seq_shards * plan.n_vocab_shards
    first = plan.first_docs_shard * plan.n_seq_shards * plan.n_vocab_shards

    def histogram(tokens, length) -> torch.Tensor:
        tokens = np.ascontiguousarray(np.asarray(tokens), dtype=np.int32)
        if tokens.shape[0] % n_all:
            raise ValueError(f"{tokens.shape[0]} tokens do not split over "
                             f"{n_all} shards")
        chunk = tokens.shape[0] // n_all
        parts = []
        for i, dev in enumerate(plan.devices):
            idx = first + i  # flat (docs, seq, vocab) index of this shard
            block = torch.from_numpy(
                tokens[None, idx * chunk:(idx + 1) * chunk]).to(dev)
            rem = torch.tensor([min(max(int(length) - idx * chunk, 0),
                                    chunk)], dtype=torch.int32, device=dev)
            counts, _ = tf_df(block, rem, vocab_size=vocab_size,
                              with_df=False)
            parts.append(counts[0])
        return plan.psum(parts)  # the one collective, over every axis

    return histogram


def long_doc_histogram(plan: MeshPlan, tokens, length,
                       vocab_size: int) -> torch.Tensor:
    """One-shot convenience wrapper over :func:`make_long_doc_histogram`."""
    return make_long_doc_histogram(plan, vocab_size)(tokens, length)
