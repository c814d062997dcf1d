"""Term-frequency and document-frequency histograms (port of
``tfidf_tpu/ops/histogram.py``).

These are the plain PyTorch versions of the dense path's TF/DF step:
a masked scatter-add over the vocab, with padding and out-of-range ids
routed to a sentinel bucket that is sliced off. The dense engine itself
runs the TF/DF kernel (``ops.kernels.tf_df``), whose plain version is
built from :func:`tf_counts_masked` and :func:`df_from_counts`.
"""

from __future__ import annotations

import torch


def tf_counts_masked(token_ids: torch.Tensor, valid: torch.Tensor,
                     vocab_size: int, id_offset: int = 0) -> torch.Tensor:
    """Histogram of ``token_ids - id_offset`` where ``valid``; ids outside
    ``[0, vocab_size)`` are dropped. int32 [D, V].

    Ids are widened to int64 before the offset is subtracted, so a
    uint16 id of 65535 minus an offset cannot wrap.
    """
    d = token_ids.shape[0]
    local = token_ids.to(torch.int64) - id_offset
    in_range = valid & (local >= 0) & (local < vocab_size)
    safe = torch.where(in_range, local, vocab_size)
    counts = torch.zeros((d, vocab_size + 1), dtype=torch.int32,
                         device=token_ids.device)
    counts.scatter_add_(1, safe, torch.ones_like(safe, dtype=torch.int32))
    return counts[:, :vocab_size]


def valid_mask(lengths: torch.Tensor, length: int) -> torch.Tensor:
    """bool [D, L]: slot ``pos`` of doc ``d`` is live when pos < lengths[d]."""
    pos = torch.arange(length, dtype=lengths.dtype, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def tf_counts(token_ids: torch.Tensor, lengths: torch.Tensor,
              vocab_size: int) -> torch.Tensor:
    """Per-document term-frequency histogram: int32 [D, V] with
    ``counts[d].sum() == lengths[d]`` (the reference's ``docSize``)."""
    return tf_counts_masked(token_ids, valid_mask(lengths, token_ids.shape[1]),
                            vocab_size)


def presence(counts: torch.Tensor) -> torch.Tensor:
    """int32 [D, V] 0/1 word-in-doc matrix."""
    return (counts > 0).to(torch.int32)


def df_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """int32 [D, V] -> int32 [V]: number of documents containing each word."""
    return presence(counts).sum(dim=0, dtype=torch.int32)


def tf_counts_chunked(token_ids: torch.Tensor, lengths: torch.Tensor,
                      vocab_size: int, chunk: int) -> torch.Tensor:
    """:func:`tf_counts` with the token axis folded into ``chunk``-wide
    slices whose histograms are summed (live memory [D, V] + [D, chunk])."""
    d, length = token_ids.shape
    if length % chunk != 0:
        raise ValueError(f"token axis {length} not divisible by chunk {chunk}")
    out = torch.zeros((d, vocab_size), dtype=torch.int32, device=token_ids.device)
    for off in range(0, length, chunk):
        rem = torch.clamp(lengths - off, 0, chunk)
        out += tf_counts(token_ids[:, off:off + chunk], rem, vocab_size)
    return out
