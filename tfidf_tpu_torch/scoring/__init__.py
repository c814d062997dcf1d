"""The scorer family (port of ``tfidf_tpu/scoring``).

Every retrieval path scores documents through one sparse kernel: a
row-sparse ``(data, cols)`` doc face dotted against a dense ``[V, Q]``
query block (``ops.kernels.tile_scores``), masked by a live vector,
selected by a streaming top-k (``ops.sparse.score_topk_tiled``). The
scorer lives entirely in how the doc face and the query columns are
precomputed; a :class:`ScorerSpec` names that precomputation:

* ``tfidf`` (default): L2-normalized ``tf * log(N/df)`` doc rows x
  cosine query columns;
* ``bm25`` (k1, b): saturated term weights on the doc side
  (:func:`bm25_weights`), raw term counts on the query side.

Filters (:mod:`tfidf_tpu_torch.scoring.filters`) fold into the live
mask. Field weights are ``TfidfRetriever.index_fields``.

:mod:`tfidf_tpu_torch.scoring.oracle` is the NumPy reference every
variant is held against (ids and tie order identical, scores allclose).
"""

from tfidf_tpu_torch.scoring.family import (DEFAULT_B, DEFAULT_K1, ScorerSpec,
                                            bm25_face_trace, bm25_idf_from_df,
                                            bm25_weights, parse_scorer,
                                            resolve_scorer, scorer_key)
from tfidf_tpu_torch.scoring.filters import (FilterSpec, filter_key,
                                             filter_mask, parse_filter)

__all__ = [
    "ScorerSpec", "parse_scorer", "scorer_key", "resolve_scorer",
    "DEFAULT_K1", "DEFAULT_B",
    "bm25_idf_from_df", "bm25_weights", "bm25_face_trace",
    "FilterSpec", "parse_filter", "filter_key", "filter_mask",
]
