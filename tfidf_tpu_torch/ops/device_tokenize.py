"""On-device tokenize+hash: the device half of the bytes wire (port of
``tfidf_tpu/ops/device_tokenize.py``).

The bytes wire ships each chunk as ONE flat slab of raw document bytes;
this module turns the slab back into the SAME padded ``[D, L]`` id batch
the host packers emit, bit-identical by contract:

* whitespace is the fixed ASCII set (``native/tokenize_common.h
  IsSpace``, = ``bytes.split()``);
* the hash is seeded FNV-1a64 -> xor-fold -> mod vocab
  (``ops.hashing.words_to_ids``);
* per-token byte truncation (``truncate_tokens_at``) and the
  ``max_per_doc`` token cap apply as in the host packers.

Slab layout (``ingest.make_bytes_packer``, ``native/loader.cc
loader_fill_slab``): doc d's bytes start at ``offs[d] = sum_{e<d}
ceil((blen[e] + 1) / align) * align`` and every other byte of the slab
is ``0x20``, so the stream tokenizes globally with no doc-boundary case.

:func:`token_starts` derives each doc's token start positions with plain
torch ops (XLA code outside the kernel in the JAX package, too);
:func:`tokenize_hash_device` then hashes them through kernel B5
(``ops.kernels.tokenize_hash``), which on the CPU runs its plain
version. The JAX package's ``TFIDF_TPU_DEVICE_TOKENIZE`` lowering
selector is validated (:func:`tokenize_method`) but chooses nothing: the
port has one lowering.

The limb helpers (:func:`fnv1a_step`, :func:`fold_mod`) are the JAX
package's two-uint32-limb FNV emulation, held in int64 tensors masked to
32 bits so no product overflows; the plain version of B5 runs on them.
The fold keeps the JAX package's ``vocab_size <= 2^16`` bound, so both
packages pick the same wire (``ingest.use_bytes_wire``).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

__all__ = [
    "FNV_OFFSET", "FNV_PRIME", "is_space", "fnv1a_step", "fold_mod",
    "seed_state", "aligned_byte_lengths", "token_starts",
    "tokenize_hash_device", "tokenize_method",
]

FNV_OFFSET = 14695981039346656037  # tokenize_common.h kFnvOffset
FNV_PRIME = 1099511628211          # tokenize_common.h kFnvPrime
MASK32 = 0xFFFFFFFF

_PRIME_HI = FNV_PRIME >> 32          # 0x100
_PRIME_LO = FNV_PRIME & MASK32       # 0x1B3


def tokenize_method(explicit: Optional[str] = None) -> str:
    """Validate the ``TFIDF_TPU_DEVICE_TOKENIZE`` knob (``"xla"`` or
    ``"pallas"``). The JAX package picks its hash lowering by it; the
    port runs kernel B5 for both values."""
    if explicit is not None:
        return explicit
    method = os.environ.get("TFIDF_TPU_DEVICE_TOKENIZE") or "xla"
    if method not in ("xla", "pallas"):
        raise ValueError(
            f"unknown TFIDF_TPU_DEVICE_TOKENIZE method {method!r} "
            f"(choose 'xla' or 'pallas')")
    return method


def is_space(b: torch.Tensor) -> torch.Tensor:
    """The fixed ASCII whitespace set over integer byte values: space,
    \\t, \\n, \\v, \\f, \\r. Any integer dtype (uint8 included)."""
    return (b == 32) | ((b >= 9) & (b <= 13))


def _mul32(a: torch.Tensor, b: int):
    """a × b for values in [0, 2^32) -> the 64-bit product as (hi, lo)
    32-bit limbs, via 16-bit partial products."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    p00, p01, p10 = a0 * b0, a0 * b1, a1 * b0
    mid = (p00 >> 16) + (p01 & 0xFFFF) + (p10 & 0xFFFF)
    lo = (p00 & 0xFFFF) | ((mid & 0xFFFF) << 16)
    hi = (a1 * b1 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)) & MASK32
    return hi, lo


def fnv1a_step(hi: torch.Tensor, lo: torch.Tensor, byte: torch.Tensor):
    """One FNV-1a64 step on (hi, lo) limbs: ``h = (h ^ byte) * FNV_PRIME
    mod 2^64``. The ``hi * P_hi`` term falls off the top (× 2^64), so
    the product is three 32-bit multiplies plus one carry."""
    lo = lo ^ byte
    carry_hi, new_lo = _mul32(lo, _PRIME_LO)
    new_hi = (hi * _PRIME_LO + lo * _PRIME_HI + carry_hi) & MASK32
    return new_hi, new_lo


def check_vocab(vocab_size: int) -> None:
    """The device fold's bound: ``1 <= vocab_size <= 2^16``."""
    if not 1 <= vocab_size <= (1 << 16):
        raise ValueError(
            f"device fold-to-vocab carries 1 <= vocab_size <= 2^16, got "
            f"{vocab_size} (the bytes wire degrades to ragged there — "
            f"ingest.use_bytes_wire)")


def fold_mod(hi: torch.Tensor, lo: torch.Tensor, vocab_size: int):
    """xor-fold + mod vocab on limbs: ``f = h ^ (h >> 32); f % V`` as
    ``((f_hi mod V) * (2^32 mod V) + f_lo mod V) mod V`` (int32)."""
    check_vocab(vocab_size)
    m32 = (1 << 32) % vocab_size
    f_lo = lo ^ hi
    return (((hi % vocab_size) * m32 + (f_lo % vocab_size))
            % vocab_size).to(torch.int32)


def seed_state(seed: int) -> Tuple[int, int]:
    """Initial (hi, lo) limbs of ``FNV_OFFSET ^ seed``."""
    h = FNV_OFFSET ^ (int(seed) & 0xFFFFFFFFFFFFFFFF)
    return h >> 32, h & MASK32


def aligned_byte_lengths(blens, align: int):
    """Slab bytes each doc occupies: ``ceil((blen + 1) / align) * align``
    (the ``+ 1`` reserves the inter-doc space). numpy arrays and torch
    tensors both work."""
    if isinstance(blens, torch.Tensor):
        return torch.div(blens.clamp_min(0) + align, align,
                         rounding_mode="floor") * align
    import numpy as np
    return (np.maximum(blens, 0) + align) // align * align


def token_starts(slab: torch.Tensor, blens: torch.Tensor, *, length: int,
                 align: int):
    """Per doc, the slab positions of its first ``length`` tokens.

    Args:
      slab: uint8 (or int32) ``[N]`` byte slab (layout above).
      blens: int32 ``[D]`` raw byte length per doc.
      length: token cap L (``max_per_doc``).
      align: the slab granule (``ingest._wire_align``).

    Returns ``(starts, valid, lengths, slab)``: int32 ``[D, L]`` token
    starts (invalid slots point at the slab's last byte, a space), bool
    ``[D, L]`` validity, int32 ``[D]`` token counts capped at L, and the
    slab itself for the hash stage (no int32 copy is made: whitespace is
    tested on the bytes as shipped).

    The start positions are scattered into ``[D, L]``; a byte that is
    not one of its doc's first L token starts writes to its own slot of
    an ``[N]`` tail that is sliced off (the JAX package points them all
    at one sentinel slot; one slot each keeps the scatter free of
    same-address contention on the card).
    """
    n = slab.shape[0]
    d = blens.shape[0]
    dev = slab.device
    sp = is_space(slab)
    start = (~sp) & torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                               sp[:-1]])
    start_i = start.to(torch.int32)
    albl = aligned_byte_lengths(blens, align).to(torch.int32)
    offs_ext = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                          torch.cumsum(albl, 0, dtype=torch.int32)])
    cum = torch.cumsum(start_i, 0, dtype=torch.int32)        # inclusive [N]
    cum_ex = torch.cat([cum - start_i, cum[-1:]])            # [N + 1]
    base = cum_ex[offs_ext.clamp_max(n).long()]              # [D + 1]
    lengths = (base[1:] - base[:-1]).clamp_max(length)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    # Per-byte doc id (read only at start bytes); among equal offsets
    # (empty docs) the right-side search lands on the doc owning them.
    did = (torch.searchsorted(offs_ext[:-1].contiguous(), pos, right=True,
                              out_int32=True) - 1).clamp(0, max(d - 1, 0))
    k = cum - 1 - base[did.long()]    # 0-based token ordinal in its doc
    tgt = torch.where(start & (k < length),
                      did.long() * length + k,
                      d * length + pos.long())
    flat = torch.full((d * length + n,), n - 1, dtype=torch.int32,
                      device=dev)
    flat.scatter_(0, tgt, pos)
    starts = flat[:d * length].reshape(d, length)
    valid = torch.arange(length, dtype=torch.int32,
                         device=dev)[None, :] < lengths[:, None]
    return starts, valid, lengths.to(torch.int32), slab


def tokenize_hash_device(slab: torch.Tensor, blens: torch.Tensor, *,
                         length: int, vocab_size: int, seed: int = 0,
                         truncate_at=None, align: int = 16):
    """Raw byte slab -> the host packer's ``(token_ids [D, L] int32,
    lengths [D] int32)``, on the slab's device: :func:`token_starts`,
    then kernel B5 (``ops.kernels.tokenize_hash``)."""
    from tfidf_tpu_torch.ops.kernels import tokenize_hash
    starts, _, lengths, slab = token_starts(slab, blens, length=length,
                                            align=align)
    ids = tokenize_hash(slab, starts, lengths, vocab_size=vocab_size,
                        seed=seed, truncate_at=truncate_at or 0)
    return ids, lengths
