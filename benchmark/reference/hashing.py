"""Whitespace tokenization and the hashed vocabulary, written from their
definitions.

* A token is a maximal run of bytes outside the C locale's ``isspace``
  set (space, \\t, \\n, \\v, \\f, \\r): ``bytes.split()`` with no
  argument.
* A token's id is its 64-bit FNV-1a hash, offset basis xor the seed,
  folded as ``(h ^ (h >> 32)) % vocab_size``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

FNV_OFFSET = np.uint64(0xCBF29CE484222325)
FNV_PRIME = np.uint64(0x100000001B3)


def tokenize(data: bytes) -> List[bytes]:
    return data.split()


def fnv1a64(tokens: Sequence[bytes], seed: int = 0) -> np.ndarray:
    """FNV-1a-64 of each token, one byte column at a time."""
    lens = np.array([len(t) for t in tokens], np.int64)
    width = int(lens.max(initial=0))
    mat = np.zeros((len(tokens), width), np.uint8)
    for i, t in enumerate(tokens):
        mat[i, :len(t)] = np.frombuffer(t, np.uint8)
    return fnv1a64_matrix(mat, lens, seed)


def fnv1a64_matrix(mat: np.ndarray, lens: np.ndarray, seed: int = 0
                   ) -> np.ndarray:
    """FNV-1a-64 of the rows of a zero-padded byte matrix, row i's
    first ``lens[i]`` bytes."""
    h = np.full(mat.shape[0], FNV_OFFSET ^ np.uint64(seed), np.uint64)
    with np.errstate(over="ignore"):
        for j in range(mat.shape[1]):
            step = (h ^ mat[:, j].astype(np.uint64)) * FNV_PRIME
            h = np.where(j < lens, step, h)
    return h


def fold(h: np.ndarray, vocab_size: int) -> np.ndarray:
    return ((h ^ (h >> np.uint64(32))) % np.uint64(vocab_size)).astype(
        np.int64)


def word_buckets(table: np.ndarray, offsets: np.ndarray, vocab_size: int,
                 seed: int = 0) -> np.ndarray:
    """The bucket of every word of a word table (each word followed by
    one space, ``offsets`` [W + 1]). Raises unless every word is exactly
    one whitespace token, so a text of such words joined by spaces
    tokenizes into exactly its words."""
    lens = np.diff(offsets) - 1
    width = int(lens.max())
    mat = np.zeros((len(lens), width), np.uint8)
    for j in range(width):
        live = np.flatnonzero(lens > j)
        mat[live, j] = table[offsets[live] + j]
    blank = np.frombuffer(b" \t\n\v\f\r", np.uint8)
    inside = np.isin(mat, blank) & (np.arange(width)[None, :] < lens[:, None])
    if (lens < 1).any() or inside.any():
        raise ValueError("a word type is not exactly one whitespace token")
    return fold(fnv1a64_matrix(mat, lens, seed), vocab_size)
