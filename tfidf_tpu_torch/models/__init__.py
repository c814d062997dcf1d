"""Model-level APIs built on the pipeline (port of ``tfidf_tpu/models``):
ranked retrieval over the indexed term-document matrix
(:class:`TfidfRetriever`) and the fit/transform estimator
(:class:`TfidfVectorizer`, on ``StreamingTfidf``).
"""

from tfidf_tpu_torch.models.retrieval import TfidfRetriever
from tfidf_tpu_torch.models.vectorizer import TfidfVectorizer

__all__ = ["TfidfRetriever", "TfidfVectorizer"]
