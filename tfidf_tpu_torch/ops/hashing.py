"""Word -> vocabulary-id hashing (port of ``tfidf_tpu/ops/hashing.py``).

* Host half (:30-68): seeded FNV-1a-64 over byte-string tokens,
  xor-folded into ``[0, vocab_size)``. The ids must stay bit-identical
  to the JAX package's (and to ``native/fast_tokenizer.cc``) so that one
  corpus packs to the same batch in both packages.
* Device half (:80-141): char n-gram ids of raw document bytes by a
  polynomial rolling hash, one Horner sweep for every n in a range (the
  device chargram, ``pipeline.TfidfPipeline.run_bytes``). The JAX
  package carries the hash in uint32; torch has little uint32
  arithmetic, so here it is an int64 masked to 32 bits after every xor
  and multiply (the largest product, 0xFFFFFFFF x 0x01000193, fits), the
  same bits.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

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


# Multiplier of the polynomial rolling hash (the FNV-32 prime); odd, so
# invertible mod 2^32.
_POLY = 0x01000193
_MASK32 = 0xFFFFFFFF


def device_ngram_ids(doc_bytes: torch.Tensor, doc_len: torch.Tensor, n: int,
                     vocab_size: int, seed: int = 0):
    """Ids of every length-``n`` byte window of a [..., L] byte batch
    (uint8 or int32 bytes, zero-padded; ``doc_len`` the live counts):
    ``(ids int32 [..., L], valid bool [..., L])``, position i the window
    starting at i, valid when it lies inside the document."""
    return device_ngram_ids_multi(doc_bytes, doc_len, n, n, vocab_size,
                                  seed)[0]


def device_ngram_ids_multi(doc_bytes: torch.Tensor, doc_len: torch.Tensor,
                           lo: int, hi: int, vocab_size: int, seed: int = 0):
    """:func:`device_ngram_ids` for every n in [lo, hi] from one Horner
    sweep: the length-(n+1) window's state is the length-n one extended
    by ``h = (h ^ b[i + n]) * POLY``, and each n in range is emitted as
    ``(h ^ (h >> 16)) % vocab_size``. Windows read ``torch.roll``'s
    wrapped bytes past the row end, as ``jnp.roll`` does; they are masked
    invalid. Returns a list of ``(ids, valid)``, index 0 = n == lo."""
    b = doc_bytes.to(torch.int64)
    length = b.shape[-1]
    h = torch.full(b.shape, int(np.uint32(seed)) ^ 0x811C9DC5,
                   dtype=torch.int64, device=b.device)
    pos = torch.arange(length, device=b.device)
    dl = torch.as_tensor(doc_len, device=b.device)[..., None]
    out = []
    for j in range(hi):
        h = ((h ^ torch.roll(b, -j, dims=-1)) * _POLY) & _MASK32
        n = j + 1
        if n >= lo:
            f = h ^ (h >> 16)
            out.append(((f % vocab_size).to(torch.int32), pos + n <= dl))
    return out
