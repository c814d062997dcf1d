"""Fit/transform TF-IDF vectorizer (port of
``tfidf_tpu/models/vectorizer.py``).

Estimator semantics:

* ``fit(corpus)`` learns the DF table and document count — the global
  state the reference computes in its reduce+bcast phase
  (``TFIDF.c:215-220``) — streaming minibatches through the incremental
  DF accumulator (:class:`StreamingTfidf`), so corpora never need to fit
  in memory at once.
* ``transform(corpus)`` scores documents against the fitted DF: TF from
  each document, IDF from the fitted state, so out-of-corpus documents
  get consistent scores.
* ``fit_transform(corpus)`` is the reference's one-shot semantics: DF
  and scores from the same corpus.

Requires HASHED vocab. Runs on CUDA unless ``device`` names another;
with no GPU and no device named it raises. A mesh ``plan`` passes through
to the stream (the docs-sharded fit and transform of
:class:`StreamingTfidf`).
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple, Union

import numpy as np
import torch

from tfidf_tpu_torch.config import PipelineConfig, VocabMode
from tfidf_tpu_torch.io.corpus import Corpus
from tfidf_tpu_torch.pipeline import _host
from tfidf_tpu_torch.streaming import StreamingTfidf


def _numpy(x) -> np.ndarray:
    return _host(x) if isinstance(x, torch.Tensor) else np.asarray(x)


class TfidfVectorizer:
    """Scikit-style TF-IDF estimator on the port's engines.

    Args:
      config: pipeline config (must be HASHED vocab mode; default 2^16).
      plan: optional :class:`~tfidf_tpu_torch.parallel.MeshPlan` for the
        sharded fit and transform.
      batch_docs: minibatch size used when fitting from a corpus.
      device: CUDA unless named; passed on to :class:`StreamingTfidf`.
    """

    def __init__(self, config: Optional[PipelineConfig] = None,
                 plan=None, batch_docs: int = 1024, device=None):
        self.config = config or PipelineConfig(vocab_mode=VocabMode.HASHED)
        if self.config.vocab_mode is not VocabMode.HASHED:
            raise ValueError("TfidfVectorizer requires HASHED vocab")
        self.plan = plan
        self.batch_docs = batch_docs
        self.device = device
        self._stream = StreamingTfidf(self.config, plan, device=device)

    # --- estimator API ---
    @property
    def fitted(self) -> bool:
        return self._stream.docs_seen > 0

    @property
    def num_docs_(self) -> int:
        return self._stream.docs_seen

    @property
    def df_(self) -> np.ndarray:
        return self._stream.df()

    @property
    def idf_(self) -> np.ndarray:
        """Fitted IDF vector, float64 (natural log, unsmoothed —
        ``TFIDF.c:243``)."""
        df = self._stream.df().astype(np.float64)
        n = max(self._stream.docs_seen, 1)
        out = np.zeros_like(df)
        nz = df > 0
        out[nz] = np.log(n / df[nz])
        return out

    def fit(self, corpus: Union[Corpus, Iterable[Corpus]]) -> "TfidfVectorizer":
        """Learn DF state from scratch (a second fit REPLACES the
        previous state; use partial_fit to accumulate)."""
        self._stream = StreamingTfidf(self.config, self.plan,
                                      device=self.device)
        return self.partial_fit(corpus)

    def partial_fit(self, corpus: Union[Corpus, Iterable[Corpus]]
                    ) -> "TfidfVectorizer":
        """Fold more documents into the existing DF state (streaming)."""
        for batch in self._as_batches(corpus):
            self._stream.update(self._stream.pack(batch))
        return self

    def transform(self, corpus: Corpus
                  ) -> Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
        """Score documents against the fitted DF.

        Returns a dense [D, V] array, or — when ``config.topk`` is set —
        a ``(values [D, K], ids [D, K])`` tuple (host numpy arrays).
        """
        if not self.fitted:
            raise RuntimeError("transform before fit")
        out = self._stream.score(self._stream.pack(corpus))
        if self.config.topk is not None:
            vals, ids = out
            return _numpy(vals)[: len(corpus)], _numpy(ids)[: len(corpus)]
        return _numpy(out)[: len(corpus), : self.config.vocab_size]

    def fit_transform(self, corpus: Corpus):
        return self.fit(corpus).transform(corpus)

    # --- state ---
    def state_dict(self):
        return self._stream.state_dict()

    def load_state(self, state) -> "TfidfVectorizer":
        self._stream.load_state(state)
        return self

    def _as_batches(self, corpus) -> Iterable[Corpus]:
        if isinstance(corpus, Corpus):
            for i in range(0, len(corpus), self.batch_docs):
                yield Corpus(names=corpus.names[i:i + self.batch_docs],
                             docs=corpus.docs[i:i + self.batch_docs])
        else:
            yield from corpus
