"""tfidf_tpu_torch — the PyTorch/CUDA port of ``tfidf_tpu``.

A second package beside the JAX one: the same TF-IDF pipeline on one
NVIDIA Hopper GPU, with the JAX package's Pallas TPU kernels rewritten
by hand in CUDA C++ (``csrc/``, built by ``ops/_build.py`` at first GPU
use). It imports nothing of ``tfidf_tpu`` or JAX; the tests
(``tests/test_torch_*.py``) run both packages on the same inputs.

Entry points run on CUDA unless the caller names another device
(``TfidfPipeline(cfg, device="cpu")``, ``TfidfRetriever(cfg,
device="cpu")``, ``cli run|query --device cpu``); with no GPU and no
device named they raise.
"""

from tfidf_tpu_torch.config import (PipelineConfig, ServeConfig,
                                    TokenizerKind, VocabMode)
from tfidf_tpu_torch.ingest import (ExactIngest, IngestResult, run_overlapped,
                                    run_overlapped_exact)
from tfidf_tpu_torch.io.corpus import (Corpus, PackedBatch, RaggedBatch,
                                       discover_corpus, pack_corpus,
                                       pack_ragged)
from tfidf_tpu_torch.models import TfidfRetriever
from tfidf_tpu_torch.pipeline import PipelineResult, TfidfPipeline
from tfidf_tpu_torch.rerank import exact_terms, exact_terms_lines, exact_topk

__all__ = [
    "PipelineConfig",
    "ServeConfig",
    "VocabMode",
    "TokenizerKind",
    "TfidfPipeline",
    "PipelineResult",
    "TfidfRetriever",
    "Corpus",
    "PackedBatch",
    "RaggedBatch",
    "discover_corpus",
    "pack_corpus",
    "pack_ragged",
    "ExactIngest",
    "IngestResult",
    "run_overlapped",
    "run_overlapped_exact",
    "exact_terms",
    "exact_terms_lines",
    "exact_topk",
]
