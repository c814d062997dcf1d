"""Model-level APIs built on the pipeline (port of ``tfidf_tpu/models``).

Ported so far: ranked retrieval over the indexed term-document matrix
(:class:`TfidfRetriever`). The estimator (``TfidfVectorizer``) comes with
``StreamingTfidf`` (ROADMAP A5b).
"""

from tfidf_tpu_torch.models.retrieval import TfidfRetriever

__all__ = ["TfidfRetriever"]
