"""Corpus discovery, loading, and static-shape packing.

The port's copy of the padded-batch and ragged-batch parts of
``tfidf_tpu/io/corpus.py``.
Discovery honours the reference contract: ``doc1..docN`` named by the
entry count of the input directory (``TFIDF.c:98-110,132-133``), a
missing file is a hard error (``TFIDF.c:137``); ``strict=False`` takes
every regular file, sorted by name.

Packing tokenizes on the host, maps words to ids (exact dictionary or
FNV-1a hash) and pads into an int32 ``[D, L]`` batch plus a ``lengths``
vector. Unlike the JAX packer, which hashes one document at a time, the
hashed path here hashes each DISTINCT word of the corpus once, in one
vectorised call, and scatters the ids back; the ids are identical
(pinned by tests/test_torch_pipeline.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from tfidf_tpu_torch.config import PipelineConfig, TokenizerKind, VocabMode
from tfidf_tpu_torch.ops.hashing import words_to_ids
from tfidf_tpu_torch.ops.tokenize import char_ngrams, whitespace_tokenize


@dataclasses.dataclass
class Corpus:
    """Raw documents: parallel lists of names and byte contents."""

    names: List[str]
    docs: List[bytes]

    def __len__(self) -> int:
        return len(self.docs)


@dataclasses.dataclass
class PackedBatch:
    """Static-shape device input (host numpy arrays).

    token_ids: int32 [D, L] vocab ids, zero past each doc's length.
    lengths: int32 [D] live token counts (the reference's ``docSize``).
    num_docs: real document count (D may exceed it with padding docs).
    names: D document names ('' for padding docs).
    vocab_size: V for this batch.
    id_to_word: id -> representative token bytes, for output formatting
      (EXACT: the inverse vocabulary; HASHED: first-seen token per
      bucket).
    """

    token_ids: np.ndarray
    lengths: np.ndarray
    num_docs: int
    names: List[str]
    vocab_size: int
    id_to_word: Optional[Dict[int, bytes]]


@dataclasses.dataclass
class RaggedBatch:
    """Ragged (CSR-style) device input — the minibatch twin of the
    overlapped ingest's flat chunk wire (``ingest.flatten_aligned``).

    Documents ship as ONE id stream with each doc starting at a multiple
    of ``align`` ids (zero fill between docs, bucket-padded tail), so
    host->device bytes scale with real tokens instead of ``D x L``. The
    padded batch is rebuilt on the device by kernel B4
    (``ops.kernels.ragged_rebuild``), or on the host by
    :func:`ragged_to_padded_host`.

    flat: [N] uint16/int32 granule-aligned flat id stream (N a
      ``FLAT_BUCKET`` multiple — the ingest wire contract).
    lengths: int32 [D] live token counts.
    length: static L of the rebuilt batch.
    align: wire granule (every doc's ids start at a multiple of it).
    total: live (pre-bucket-pad) aligned id count.
    """

    flat: np.ndarray
    lengths: np.ndarray
    length: int
    align: int
    total: int
    num_docs: int
    names: List[str]
    vocab_size: int
    id_to_word: Optional[Dict[int, bytes]]

    def to_padded(self) -> PackedBatch:
        """Host-side rebuild into the equivalent :class:`PackedBatch`
        (bit-identical to the padded packer's zero-padded layout)."""
        return PackedBatch(
            token_ids=ragged_to_padded_host(self.flat, self.lengths,
                                            self.length, self.align),
            lengths=self.lengths, num_docs=self.num_docs,
            names=self.names, vocab_size=self.vocab_size,
            id_to_word=self.id_to_word)


Batch = Union[PackedBatch, RaggedBatch]


def ragged_to_padded_host(flat: np.ndarray, lengths: np.ndarray,
                          length: int, align: int = 1) -> np.ndarray:
    """Numpy inverse of ``ingest.flatten_aligned``: rebuild the padded
    ``[D, L]`` int32 batch from a flat aligned id stream. Padding slots
    are zero-filled (the padded packers' layout), unlike the device
    rebuild's clamp-and-mask contract."""
    lens = np.maximum(lengths.astype(np.int64), 0)
    per_doc = -(-lens // align) * align
    off = np.concatenate([[0], np.cumsum(per_doc)[:-1]])
    idx = np.minimum(off[:, None] + np.arange(length)[None, :],
                     max(flat.size - 1, 0))
    out = flat[idx].astype(np.int32)
    return np.where(np.arange(length)[None, :] < lens[:, None], out, 0)


def ragged_from_packed(batch: PackedBatch,
                       align: Optional[int] = None) -> RaggedBatch:
    """Flatten a :class:`PackedBatch` into the ragged wire format via
    ``ingest.flatten_aligned``: uint16 ids for vocabs within 2^16, int32
    beyond (the native packers' rule). ``align`` defaults to the run's
    wire granule (``TFIDF_TPU_WIRE_ALIGN``)."""
    # Lazy import: ingest imports this module at load time.
    from tfidf_tpu_torch.ingest import _wire_align, flatten_aligned
    if align is None:
        align = _wire_align()
    dtype = np.uint16 if batch.vocab_size <= (1 << 16) else np.int32
    flat, total = flatten_aligned(batch.token_ids, batch.lengths, align,
                                  dtype=dtype)
    return RaggedBatch(flat=flat, lengths=batch.lengths,
                       length=batch.token_ids.shape[1], align=align,
                       total=total, num_docs=batch.num_docs,
                       names=batch.names, vocab_size=batch.vocab_size,
                       id_to_word=batch.id_to_word)


def pack_ragged(corpus: "Corpus", config: PipelineConfig,
                pad_docs_to: Optional[int] = None,
                want_words: bool = True,
                align: Optional[int] = None) -> RaggedBatch:
    """Tokenize + id-map into the ragged wire format: the padded batch of
    :func:`pack_corpus`, flattened, so a :class:`RaggedBatch` and a
    :class:`PackedBatch` of one corpus always rebuild equal."""
    return ragged_from_packed(
        pack_corpus(corpus, config, pad_docs_to=pad_docs_to,
                    want_words=want_words), align)


def discover_names(input_dir: str, strict: bool = True) -> List[str]:
    """The reference's discovery contract, names only: strict counts
    every directory entry (subdirectories included) and derives
    ``doc1..docN``; non-strict lists regular files sorted by name."""
    if strict:
        return [f"doc{i}" for i in range(1, len(os.listdir(input_dir)) + 1)]
    return sorted(e for e in os.listdir(input_dir)
                  if os.path.isfile(os.path.join(input_dir, e)))


def discover_corpus(input_dir: str, strict: bool = True) -> Corpus:
    """Enumerate and load a document directory; raises
    FileNotFoundError when a strict-mode ``doc<i>`` is missing."""
    names = discover_names(input_dir, strict)
    docs = []
    for name in names:
        with open(os.path.join(input_dir, name), "rb") as f:
            docs.append(f.read())
    return Corpus(names=names, docs=docs)


def _tokens_for(doc: bytes, config: PipelineConfig) -> List[bytes]:
    if config.tokenizer is TokenizerKind.WHITESPACE:
        return whitespace_tokenize(doc, config.truncate_tokens_at)
    lo, hi = config.ngram_range
    return char_ngrams(doc, lo, hi)


def build_exact_vocab(token_docs: Sequence[Sequence[bytes]]) -> Dict[bytes, int]:
    """String -> id over the corpus, first-appearance order."""
    vocab: Dict[bytes, int] = {}
    for toks in token_docs:
        for t in toks:
            if t not in vocab:
                vocab[t] = len(vocab)
    return vocab


def pack_corpus(corpus: Corpus, config: PipelineConfig,
                pad_docs_to: Optional[int] = None,
                want_words: bool = True) -> PackedBatch:
    """Tokenize + id-map + pad into a device-ready batch.

    ``want_words=False`` skips the id -> word map (results consumed by
    id). The static L is at least ``max_doc_len``, grown to the longest
    document and rounded up to a ``doc_chunk`` multiple, as in the JAX
    packer.
    """
    token_docs = [_tokens_for(doc, config) for doc in corpus.docs]
    lengths = np.array([len(t) for t in token_docs], dtype=np.int32)

    # Distinct words in first-appearance order; every token becomes an
    # index into them.
    vocab = build_exact_vocab(token_docs)
    word_index = np.fromiter((vocab[t] for toks in token_docs for t in toks),
                             dtype=np.int64, count=int(lengths.sum()))
    words = list(vocab)
    if config.vocab_mode is VocabMode.EXACT:
        vocab_size = max(len(vocab), 1)
        word_ids = np.arange(len(words), dtype=np.int32)
        id_to_word = dict(enumerate(words)) if want_words else {}
    else:
        vocab_size = config.vocab_size
        word_ids = words_to_ids(words, vocab_size, config.hash_seed)
        id_to_word = {}
        if want_words:
            # First-seen token per bucket: distinct words are already in
            # first-appearance order, so setdefault keeps the same
            # representative a token-by-token walk would.
            for w, i in zip(words, word_ids.tolist()):
                id_to_word.setdefault(i, w)

    max_len = int(lengths.max(initial=0))
    chunk = config.doc_chunk
    padded_len = max(config.max_doc_len, max_len, 1)
    padded_len = ((padded_len + chunk - 1) // chunk) * chunk

    d = len(corpus)
    d_padded = max(pad_docs_to or d, d)
    token_ids = np.zeros((d_padded, padded_len), dtype=np.int32)
    out_lengths = np.zeros((d_padded,), dtype=np.int32)
    out_lengths[:d] = lengths
    rows = np.repeat(np.arange(d), lengths)
    starts = np.cumsum(lengths, dtype=np.int64) - lengths
    cols = np.arange(rows.size) - np.repeat(starts, lengths)
    token_ids[rows, cols] = word_ids[word_index]

    names = list(corpus.names) + [""] * (d_padded - d)
    return PackedBatch(token_ids=token_ids, lengths=out_lengths, num_docs=d,
                       names=names, vocab_size=vocab_size,
                       id_to_word=id_to_word)
