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

Runs on CUDA unless a device is named; with no GPU and no device named
it raises. A mesh ``plan`` (the docs-sharded stream) is ROADMAP A9b.
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
from tfidf_tpu_torch.ops.sparse import score_topk, sorted_term_counts, sparse_df
from tfidf_tpu_torch.ops.topk import topk_per_doc
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
        if plan is not None:
            raise NotImplementedError(
                "StreamingTfidf(plan=...) (the docs-sharded stream) is not "
                "ported yet: ROADMAP A9b")
        cfg = config or PipelineConfig(vocab_mode=VocabMode.HASHED)
        if cfg.vocab_mode is not VocabMode.HASHED:
            raise ValueError("streaming requires VocabMode.HASHED "
                             "(fixed vocab ids across minibatches)")
        self.config = cfg
        self.device = resolve_device(device)
        self._engine = cfg.engine
        self._vocab = cfg.vocab_size
        self._df = torch.zeros(self._vocab, dtype=torch.int32,
                               device=self.device)
        self._docs_seen = 0

    # --- state ---
    @property
    def docs_seen(self) -> int:
        return self._docs_seen

    def df(self) -> np.ndarray:
        return self._df.cpu().numpy().copy()

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
        minibatch of a stream has one shape."""
        batch = pack_corpus(corpus, self.config, want_words=False)
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
        directly and rebuild the padded batch on the device."""
        return ragged_from_packed(self.pack(corpus, fixed_len=fixed_len))

    # --- the two phases ---
    def update(self, batch: Batch) -> None:
        """Fold one minibatch into the DF state."""
        with obs.device_span("stream_update", docs=batch.num_docs):
            self._update(batch)

    def _update(self, batch: Batch) -> None:
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

    def _score(self, batch: Batch):
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
