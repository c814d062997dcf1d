"""Streaming minibatched TF-IDF with incremental DF state (port of
``tfidf_tpu/streaming.py``'s single-device path).

DF is *state*: an int32 ``[V]`` tensor on the device, added into in
place per minibatch, so a corpus streams through in fixed-memory
minibatches. Two phases, as in classic out-of-core TF-IDF:

  1. ``update(batch)`` per minibatch folds DF and the document count;
  2. ``score(batch)`` scores any minibatch against the *current* DF
     (after a full pass: exact corpus-wide TF-IDF; mid-stream: the
     online approximation).

The engines are the pipeline's. Sparse (the HASHED default): sort+RLE
triples and ``sparse_df`` for the update; the fused score+top-k kernel
(``ops.kernels.fused_score_topk``) for a top-k score. Dense, and every
score without top-k: the TF/DF kernel (``ops.kernels.tf_df``), dense
tf*idf, then a stable-sort top-k when k is set. A :class:`RaggedBatch`
is rebuilt on the device by the ragged-rebuild kernel. Top-k results
cross to the host as packed words (``ops.kernels.pack_words``) when the
word can carry the run.

``state_dict`` holds the JAX package's keys, dtypes and shapes (``df``
int32 ``[V]``, ``docs_seen`` 0-d), so a state dict from either package
loads into the other; ``checkpoint.save_state`` persists it.

With a mesh ``plan`` every minibatch is cut into the plan's blocks
(``parallel.collectives.place_batch``) and the state grows to the padded
vocab (``plan.pad_vocab``), as in the JAX package:

* the sparse engine (docs-only meshes): each shard sorts its rows and
  takes its ``sparse_df``, and one ``MeshPlan.psum`` folds them into the
  state (BASELINE config 5's incremental psum); a top-k score runs the
  fused score+top-k kernel and the pack kernel on each shard;
* the dense engine (any docs x seq x vocab mesh, and every score without
  top-k): the TF/DF kernel at each vocab shard's id offset on each seq
  chunk (``collectives.sharded_counts``), presence after the seq psum,
  then the vocab shards' top-k merged in id order.

An explicit ``engine="sparse"`` on a seq or vocab mesh raises; a
defaulted one falls back to dense. A :class:`RaggedBatch` goes padded on
the host under a plan (the mesh wire stays padded), so the
ragged-rebuild kernel does not run on a mesh stream.

Runs on CUDA unless a device is named (under a plan, on the plan's
devices); with no GPU and no device named it raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from tfidf_tpu_torch import obs
from tfidf_tpu_torch.config import PipelineConfig, VocabMode
from tfidf_tpu_torch.io.corpus import (Batch, Corpus, PackedBatch,
                                       RaggedBatch, pack_corpus,
                                       ragged_from_packed)
from tfidf_tpu_torch.ops.downlink import (unpack_result_words,
                                          use_packed_result_wire)
from tfidf_tpu_torch.ops.kernels import pack_words, tf_df
from tfidf_tpu_torch.ops.scoring import (canonical_score_dtype, idf_from_df,
                                         tfidf_dense)
from tfidf_tpu_torch.ops.sparse import (score_topk, sorted_term_counts,
                                        sparse_df, sparse_finish)
from tfidf_tpu_torch.ops.topk import topk_per_doc
from tfidf_tpu_torch.parallel.collectives import (
    gather_rows, place_batch as place_batch_mesh, presence_df, select_topk,
    sharded_counts, vocab_rows)
from tfidf_tpu_torch.pipeline import _host, place_batch, resolve_device


def _as_host(x) -> np.ndarray:
    """A numpy copy of a state entry given as an array or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x, copy=True)


class StreamingTfidf:
    """Fixed-memory streaming TF-IDF over minibatches.

    Requires HASHED vocab (a fixed id space across batches — EXACT mode
    would renumber words per batch).
    """

    def __init__(self, config: Optional[PipelineConfig] = None,
                 plan=None, device=None):
        cfg = config or PipelineConfig(vocab_mode=VocabMode.HASHED)
        if cfg.vocab_mode is not VocabMode.HASHED:
            raise ValueError("streaming requires VocabMode.HASHED "
                             "(fixed vocab ids across minibatches)")
        self.config = cfg
        self.plan = plan
        self.device = (plan.devices[0] if plan is not None
                       else resolve_device(device))
        # The engine doctrine: sort+RLE is the default; the sparse
        # lowering shards the docs axis only, so a defaulted engine on a
        # seq or vocab mesh takes the dense one and an explicit one
        # raises (capability, not preference).
        self._engine = cfg.engine
        if (self._engine == "sparse" and plan is not None
                and (plan.n_seq_shards != 1 or plan.n_vocab_shards != 1)):
            if getattr(cfg, "_engine_defaulted", False):
                self._engine = "dense"
            else:
                raise ValueError("sparse streaming shards the docs axis "
                                 "only; build the MeshPlan with seq=1, "
                                 "vocab=1 or use engine='dense'")
        self._vocab = (plan.pad_vocab(cfg.vocab_size) if plan is not None
                       else cfg.vocab_size)
        self._df = torch.zeros(self._vocab, dtype=torch.int32,
                               device=self.device)
        self._docs_seen = 0

    # --- state ---
    @property
    def docs_seen(self) -> int:
        return self._docs_seen

    def df(self) -> np.ndarray:
        return self._df.cpu().numpy()[:self.config.vocab_size].copy()

    def state_dict(self) -> Dict[str, np.ndarray]:
        return {"df": self._df.cpu().numpy().copy(),
                "docs_seen": np.asarray(self._docs_seen)}

    def load_state(self, state: Dict[str, np.ndarray]) -> None:
        df = _as_host(state["df"])
        if df.shape != (self._vocab,):
            raise ValueError(f"df shape {df.shape} != ({self._vocab},)")
        self._df = torch.from_numpy(df.astype(np.int32)).to(self.device)
        self._docs_seen = int(_as_host(state["docs_seen"]))

    # --- packing ---
    def pack(self, corpus: Corpus,
             fixed_len: Optional[int] = None) -> PackedBatch:
        """Pack a minibatch. ``fixed_len`` pins the token axis to one L
        (truncating longer docs, zero-padding shorter batches), so every
        minibatch of a stream has one shape. Under a plan the rows grow
        to a docs-shard multiple."""
        pad = self.plan.pad_docs(len(corpus)) if self.plan is not None \
            else None
        batch = pack_corpus(corpus, self.config, pad_docs_to=pad,
                            want_words=False)
        if fixed_len is None or batch.token_ids.shape[1] == fixed_len:
            return batch
        ids = batch.token_ids[:, :fixed_len]
        if ids.shape[1] < fixed_len:
            ids = np.pad(ids, ((0, 0), (0, fixed_len - ids.shape[1])))
        return PackedBatch(
            token_ids=ids,
            lengths=np.minimum(batch.lengths, fixed_len).astype(np.int32),
            num_docs=batch.num_docs, names=batch.names,
            vocab_size=batch.vocab_size, id_to_word=batch.id_to_word)

    def pack_ragged(self, corpus: Corpus,
                    fixed_len: Optional[int] = None) -> RaggedBatch:
        """Pack a minibatch in the ragged wire format (one flat aligned
        id stream: host->device bytes scale with real tokens, not D x L;
        ``io.corpus.ragged_from_packed``). ``update``/``score`` take it
        directly and rebuild the padded batch on the device (under a
        plan: on the host)."""
        return ragged_from_packed(self.pack(corpus, fixed_len=fixed_len))

    # --- the two phases ---
    def update(self, batch: Batch) -> None:
        """Fold one minibatch into the DF state."""
        with obs.device_span("stream_update", docs=batch.num_docs):
            self._update(batch)

    def _place_mesh(self, batch: Batch):
        """A minibatch cut into the plan's blocks: a RaggedBatch padded on
        the host, rows and tokens grown to shard multiples."""
        plan = self.plan
        if isinstance(batch, RaggedBatch):
            batch = batch.to_padded()
        toks = np.asarray(batch.token_ids)
        lens = np.asarray(batch.lengths, dtype=np.int32)
        d, length = toks.shape
        d_t, l_t = plan.pad_docs(d), plan.pad_tokens(length)
        if (d_t, l_t) != (d, length):
            toks = np.pad(toks, ((0, d_t - d), (0, l_t - length)))
            lens = np.pad(lens, (0, d_t - d))
        return place_batch_mesh(plan, toks, lens)

    def _update(self, batch: Batch) -> None:
        if self.plan is not None:
            self._update_mesh(self._place_mesh(batch))
            self._docs_seen += batch.num_docs
            return
        toks, lens = place_batch(batch, self.device)
        if self._engine == "sparse":
            ids, _, head = sorted_term_counts(toks, lens)
            self._df += sparse_df(ids, head, self._vocab)
        else:
            _, df = tf_df(toks, lens, vocab_size=self._vocab)
            self._df += df
        self._docs_seen += batch.num_docs

    def score(self, batch: Batch):
        """Score a minibatch against the current DF snapshot.

        Sparse engine + topk: per-doc candidates are the L row slots
        (never a [batch, V] matrix); invalid slots come back (0, -1) and
        k clamps to L. topk=None always takes the dense lowering: the
        full [batch, V] score matrix (a tensor on the device) is the ask.

        Top-k selections come back as host numpy arrays over the packed
        result wire when it can carry the run (ids exact, scores within
        16-bit rounding), else as the full-precision pair of tensors on
        the device (``result_wire="pair"``, vocab past 2^16).
        """
        with obs.device_span("stream_score", docs=batch.num_docs):
            return self._score(batch)

    def _update_mesh(self, placed) -> None:
        plan = self.plan
        if self._engine == "sparse":
            dfs = []
            for d in range(plan.n_local_docs):
                ids, _, head = sorted_term_counts(placed.tokens[d, 0, 0],
                                                  placed.lengths[d, 0, 0])
                dfs.append(sparse_df(ids, head, self._vocab))
            df = plan.psum(dfs)
        else:
            df = plan.all_gather(presence_df(
                plan, sharded_counts(plan, placed, self._vocab)), dim=0)
        self._df += df.to(self._df.device)

    def _score_mesh(self, placed):
        """The sharded score: per docs shard its top-k selection (or its
        [Dl, V] score rows without top-k), the rows in global order."""
        plan = self.plan
        topk = self.config.topk
        score_dtype = canonical_score_dtype(self.config.score_dtype)
        if self._engine == "sparse" and topk is not None:
            vals, ids = [], []
            for d in range(plan.n_local_docs):
                toks, lens = placed.tokens[d, 0, 0], placed.lengths[d, 0, 0]
                t_ids, counts, head = sorted_term_counts(toks, lens)
                _, v, i = sparse_finish(
                    t_ids, counts, head, lens, self._df.to(toks.device),
                    self._docs_seen, score_dtype=score_dtype,
                    topk=min(topk, toks.shape[1]))
                vals.append(v)
                ids.append(i)
        else:
            v_shard = self._vocab // plan.n_vocab_shards
            counts = sharded_counts(plan, placed, self._vocab)
            scores = {}
            for (d, v), c in counts.items():
                df = self._df[v * v_shard:(v + 1) * v_shard].to(c.device)
                scores[d, v] = tfidf_dense(c, placed.lengths[d, 0, v], df,
                                           self._docs_seen, score_dtype)
            if topk is None:
                return gather_rows(plan, vocab_rows(plan, scores))
            vals, ids = select_topk(plan, scores, min(topk, self._vocab),
                                    v_shard)
        # The padded vocab is the id bound the wire must carry; each
        # shard packs its own words before the gathering fetch.
        if use_packed_result_wire(self.config, vocab_size=self._vocab):
            words = _host(gather_rows(plan, [pack_words(v, i)
                                             for v, i in zip(vals, ids)]))
            return unpack_result_words(words,
                                       score_dtype=self.config.score_dtype)
        return gather_rows(plan, vals), gather_rows(plan, ids)

    def _score(self, batch: Batch):
        if self.plan is not None:
            return self._score_mesh(self._place_mesh(batch))
        toks, lens = place_batch(batch, self.device)
        topk = self.config.topk
        score_dtype = canonical_score_dtype(self.config.score_dtype)
        if self._engine == "sparse" and topk is not None:
            ids, counts, head = sorted_term_counts(toks, lens)
            idf = idf_from_df(self._df, self._docs_seen, score_dtype)
            out = score_topk(ids, counts, head, lens, idf,
                             min(topk, toks.shape[1]))
        else:
            counts, _ = tf_df(toks, lens, vocab_size=self._vocab,
                              with_df=False)
            scores = tfidf_dense(counts, lens, self._df, self._docs_seen,
                                 score_dtype)
            if topk is None:
                return scores
            out = topk_per_doc(scores, min(topk, self._vocab))
        if use_packed_result_wire(self.config, vocab_size=self._vocab):
            words = _host(pack_words(*out))
            return unpack_result_words(words,
                                       score_dtype=self.config.score_dtype)
        return out
