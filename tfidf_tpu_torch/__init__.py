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

from tfidf_tpu_torch.config import PipelineConfig, TokenizerKind, VocabMode
from tfidf_tpu_torch.io.corpus import (Corpus, PackedBatch, discover_corpus,
                                       pack_corpus)
from tfidf_tpu_torch.models import TfidfRetriever
from tfidf_tpu_torch.pipeline import PipelineResult, TfidfPipeline

__all__ = [
    "PipelineConfig",
    "VocabMode",
    "TokenizerKind",
    "TfidfPipeline",
    "PipelineResult",
    "TfidfRetriever",
    "Corpus",
    "PackedBatch",
    "discover_corpus",
    "pack_corpus",
]
