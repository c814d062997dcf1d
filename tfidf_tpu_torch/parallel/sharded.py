"""Mesh-sharded end-to-end pipeline (port of
``tfidf_tpu/parallel/sharded.py``).

The host packs the batch, grows it to a mesh-divisible shape and uploads
each shard's block to its shard's device (``collectives.place_batch``);
the sharded forward (``parallel.collectives``) runs the per-shard bodies
and the collectives; the results come back to the host. The reference's
placement (rank r reads docs r, r + (size - 1), ..., ``TFIDF.c:130-138``)
becomes block-sharding the document axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from tfidf_tpu_torch.config import PipelineConfig, VocabMode
from tfidf_tpu_torch.io.corpus import Corpus, PackedBatch, pack_corpus
from tfidf_tpu_torch.ops.downlink import (unpack_result_words,
                                          use_packed_result_wire)
from tfidf_tpu_torch.ops.kernels import pack_words
from tfidf_tpu_torch.ops.scoring import canonical_score_dtype
from tfidf_tpu_torch.parallel.collectives import (gather_rows,
                                                  make_sharded_forward,
                                                  make_sparse_sharded_forward,
                                                  place_batch)
from tfidf_tpu_torch.parallel.mesh import MeshPlan
from tfidf_tpu_torch.pipeline import PipelineResult, _host
from tfidf_tpu_torch.utils.timing import PhaseTimedMixin


class ShardedPipeline(PhaseTimedMixin):
    """TF-IDF over a device mesh.

    EXACT vocab mode is supported but sized from the corpus; HASHED is
    the intended mode at scale (vocab padded to a shard multiple).
    Outputs keep the mesh's padding rows (length 0, name ''), as the JAX
    package's do; DF and counts are cut back to the batch's vocab.
    """

    def __init__(self, plan: MeshPlan, config: Optional[PipelineConfig] = None,
                 timer=None):
        self.plan = plan
        self.config = config or PipelineConfig(vocab_mode=VocabMode.HASHED)
        self.timer = timer  # PhaseTimer; see TfidfPipeline
        self.device = plan.devices[0]

    def pack(self, corpus: Corpus, want_words: bool = True) -> PackedBatch:
        # Doc and token axes must split evenly across the mesh;
        # _pad_to_mesh is the single place that knows how.
        with self._phase("pack"):
            return self._pad_to_mesh(
                pack_corpus(corpus, self.config, want_words=want_words))

    def _pad_to_mesh(self, batch: PackedBatch) -> PackedBatch:
        """Grow a batch to a mesh-divisible [D, L] (no-op when already
        so); padding docs are empty (length 0) and every histogram masks
        them out."""
        d, length = batch.token_ids.shape
        d_t, l_t = self.plan.pad_docs(d), self.plan.pad_tokens(length)
        if (d_t, l_t) == (d, length):
            return batch
        return dataclasses.replace(
            batch,
            token_ids=np.pad(batch.token_ids, ((0, d_t - d), (0, l_t - length))),
            lengths=np.pad(batch.lengths, (0, d_t - d)),
            names=list(batch.names) + [""] * (d_t - d))

    def run_packed(self, batch: PackedBatch) -> PipelineResult:
        cfg = self.config
        if cfg.mesh_shape:
            raise ValueError(
                "config.mesh_shape is ignored by ShardedPipeline — the "
                "MeshPlan passed to the constructor is authoritative "
                "(use TfidfPipeline for config-driven mesh dispatch)")
        batch = self._pad_to_mesh(batch)
        plan = self.plan
        engine = cfg.engine
        if (engine == "sparse" and getattr(cfg, "_engine_defaulted", False)
                and (plan.n_seq_shards != 1 or plan.n_vocab_shards != 1)):
            # The default picked sparse, but the sparse lowering shards
            # the docs axis only: vocab/seq meshes take the dense one.
            # An explicit engine="sparse" still raises (capability).
            engine = "dense"
        with self._phase("transfer"):
            placed = place_batch(plan, batch.token_ids, batch.lengths)
        if engine == "sparse":
            return self._run_sparse(batch, placed)
        fwd = make_sharded_forward(plan, plan.pad_vocab(batch.vocab_size),
                                   canonical_score_dtype(cfg.score_dtype),
                                   cfg.topk)
        with self._phase("compute"):
            out = fwd(placed, batch.num_docs)
        # top-k mode: the per-shard dense counts and scores never leave
        # their devices, only DF and the [D, K] selection do.
        v = batch.vocab_size
        with self._phase("fetch"):
            result = PipelineResult(
                counts=None, lengths=np.asarray(batch.lengths),
                df=None, num_docs=batch.num_docs, names=batch.names,
                id_to_word=batch.id_to_word or {})
            if cfg.topk is not None:
                result.df = _host(out[0])[:v]
                result.topk_vals = _host(gather_rows(plan, out[1]))
                result.topk_ids = _host(gather_rows(plan, out[2]))
            else:
                result.counts = _host(gather_rows(plan, out[0]))[:, :v]
                result.df = _host(out[1])[:v]
                result.scores = _host(gather_rows(plan, out[2]))[:, :v]
        return result

    def _run_sparse(self, batch: PackedBatch, placed) -> PipelineResult:
        cfg = self.config
        plan = self.plan
        fwd = make_sparse_sharded_forward(
            plan, batch.vocab_size, canonical_score_dtype(cfg.score_dtype),
            cfg.topk)
        with self._phase("compute"):
            out = fwd(placed, batch.num_docs)
        with self._phase("fetch"):
            result = PipelineResult(
                counts=None, lengths=np.asarray(batch.lengths),
                df=_host(out[0]), num_docs=batch.num_docs,
                names=batch.names, id_to_word=batch.id_to_word or {})
            if cfg.topk is not None:
                # The packed result wire, as on one device: each shard
                # packs its own [Dl, K] selection (the pack kernel per
                # shard) and only the words cross to the host.
                if use_packed_result_wire(cfg, vocab_size=batch.vocab_size):
                    words = _host(gather_rows(plan, [
                        pack_words(tv, ti) for tv, ti in zip(out[1], out[2])]))
                    result.topk_vals, result.topk_ids = unpack_result_words(
                        words, score_dtype=cfg.score_dtype)
                else:
                    result.topk_vals = _host(gather_rows(plan, out[1]))
                    result.topk_ids = _host(gather_rows(plan, out[2]))
            else:
                result.sparse_ids, result.sparse_counts, result.sparse_head = (
                    _host(gather_rows(plan, parts)) for parts in out[1:4])
        return result

    def run(self, corpus: Corpus) -> PipelineResult:
        return self.run_packed(self.pack(corpus))
