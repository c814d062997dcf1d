"""Corpus discovery and packing."""

from tfidf_tpu_torch.io.corpus import (Corpus, PackedBatch, discover_corpus,
                                       pack_corpus)

__all__ = ["Corpus", "PackedBatch", "discover_corpus", "pack_corpus"]
