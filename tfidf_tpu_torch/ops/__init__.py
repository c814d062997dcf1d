"""Device ops of the port: plain PyTorch, plus the hand-written CUDA kernels
behind ``ops.kernels``."""

from tfidf_tpu_torch.ops.hashing import fnv1a_hash_words, hash_to_vocab
from tfidf_tpu_torch.ops.histogram import df_from_counts, presence, tf_counts
from tfidf_tpu_torch.ops.scoring import idf_from_df, tf_matrix, tfidf_dense
from tfidf_tpu_torch.ops.tokenize import char_ngrams, whitespace_tokenize

__all__ = [
    "tf_counts", "df_from_counts", "presence", "idf_from_df", "tfidf_dense",
    "tf_matrix", "fnv1a_hash_words", "hash_to_vocab", "whitespace_tokenize",
    "char_ngrams",
]
