"""Word -> vocabulary-id hashing, host half.

Copy of the host half of ``tfidf_tpu/ops/hashing.py`` (:30-68): seeded
FNV-1a-64 over byte-string tokens, xor-folded into ``[0, vocab_size)``.
The ids must stay bit-identical to the JAX package's (and to
``native/fast_tokenizer.cc``) so that one corpus packs to the same batch
in both packages. The device n-gram half arrives with the
device-chargram slice.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_FNV_OFFSET = np.uint64(14695981039346656037)
_FNV_PRIME = np.uint64(1099511628211)


def fnv1a_hash_words(words: Sequence[bytes], seed: int = 0) -> np.ndarray:
    """64-bit FNV-1a of each byte-string, vectorized across words.

    Words are packed into a padded [N, max_len] byte matrix and the hash
    state is updated column by column, masked by word length — O(max_len)
    NumPy steps regardless of N. ``seed`` perturbs the offset basis.
    """
    if len(words) == 0:
        return np.zeros((0,), dtype=np.uint64)
    lens = np.fromiter((len(w) for w in words), count=len(words), dtype=np.int64)
    max_len = int(lens.max(initial=0))
    mat = np.zeros((len(words), max_len), dtype=np.uint8)
    for i, w in enumerate(words):
        mat[i, : len(w)] = np.frombuffer(w, dtype=np.uint8)
    h = np.full(len(words), _FNV_OFFSET ^ np.uint64(seed), dtype=np.uint64)
    with np.errstate(over="ignore"):
        for j in range(max_len):
            live = j < lens
            hj = (h ^ mat[:, j].astype(np.uint64)) * _FNV_PRIME
            h = np.where(live, hj, h)
    return h


def hash_to_vocab(hashes: np.ndarray, vocab_size: int) -> np.ndarray:
    """Fold 64-bit hashes into [0, vocab_size) with an xor-fold (the
    high word keeps its entropy on power-of-two vocabs)."""
    folded = hashes ^ (hashes >> np.uint64(32))
    return (folded % np.uint64(vocab_size)).astype(np.int32)


def words_to_ids(words: Sequence[bytes], vocab_size: int, seed: int = 0) -> np.ndarray:
    """FNV-1a + fold, the hashed-vocab loader path."""
    return hash_to_vocab(fnv1a_hash_words(words, seed), vocab_size)
