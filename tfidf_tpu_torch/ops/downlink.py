"""Compact device->host result wire: one uint32 word per top-k slot
(port of ``tfidf_tpu/ops/downlink.py``).

Word layout::

    bits 31..16   score as float16 (bfloat16 when the score dtype is
                  bfloat16 — then the bits are exactly the high half of
                  the float32 score)
    bits 15..0    vocab id as uint16

Valid scores are >= 0 (idf >= 0, tf > 0), so a set sign bit in the score
half marks an invalid slot (score -1, id 0) and decodes to the
``(0, -1)`` contract; a legitimate 0.0 survives and NaN passes through.
The pack runs on the device: the JAX package's ``pack_result_words``
is ``ops.kernels.pack_words`` here, which launches the kernel on a CUDA
tensor. The decode runs on the host in numpy.

Differences from the JAX package: the ``TFIDF_TPU_RESULT_WIRE`` and
``TFIDF_TPU_DOWNLINK`` environment overrides are not read (the config's
``result_wire`` decides), and bfloat16 scores decode to float32 numpy
arrays holding the same values, since numpy has no bfloat16.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tfidf_tpu_torch.ops.scoring import canonical_score_dtype


def wire16_dtype(score_dtype) -> torch.dtype:
    """The 16-bit score format of the packed word: bfloat16 for a
    bfloat16 score dtype, else float16."""
    if canonical_score_dtype(score_dtype) == torch.bfloat16:
        return torch.bfloat16
    return torch.float16


def pair_slot_bytes(score_dtype) -> int:
    """Bytes per slot of the (int32 id, score) pair wire — the
    ``bytes_off_wire_pair`` accounting denominator."""
    return 4 + canonical_score_dtype(score_dtype).itemsize


def use_packed_result_wire(cfg, vocab_size: Optional[int] = None) -> bool:
    """True = the packed uint32 word wire, False = the (id, score) pair
    wire. ``"packed"`` degrades to the pair wire when the word cannot
    carry the run: no top-k selection, or vocab past 2^16 (ids overflow
    the uint16 half). float64 scores canonicalise to float32 and pack.

    bfloat16 scores take the pair wire, as they do in the JAX package:
    there the check ``dtype.kind == "f"`` is False for ml_dtypes'
    bfloat16 (kind ``"V"``), so its packed bfloat16 word is never
    selected, and the port keeps the same choice.
    """
    if cfg.result_wire not in ("packed", "pair"):
        raise ValueError(f"unknown result wire {cfg.result_wire!r} "
                         f"(choose 'packed' or 'pair')")
    if cfg.result_wire == "pair" or cfg.topk is None:
        return False
    size = vocab_size if vocab_size is not None else cfg.vocab_size
    if size > (1 << 16):
        return False
    return canonical_score_dtype(cfg.score_dtype) in (torch.float32,
                                                      torch.float16)


def unpack_result_words(words: np.ndarray, *, score_dtype=np.float32):
    """Host-side decode: uint32 ``[..., K]`` -> ``(vals, tids)``, vals in
    the canonical score dtype (float32 for bfloat16 scores), tids int32.
    Invalid slots (sign bit set in the score half) decode to (0, -1)."""
    words = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    hi = (words >> np.uint32(16)).astype(np.uint16)
    if wire16_dtype(score_dtype) == torch.bfloat16:
        # bf16 bits ARE the float32 high half: widen by shifting back.
        vals = (hi.astype(np.uint32) << np.uint32(16)).view(np.float32)
    else:
        vals = hi.view(np.float16).astype(np.float32)
    tids = (words & np.uint32(0xFFFF)).astype(np.int32)
    bad = vals < 0  # sign-bit sentinel; NaN compares False and survives
    if canonical_score_dtype(score_dtype) == torch.float16:
        vals = vals.astype(np.float16)
    vals = vals.copy()
    vals[bad] = 0
    tids[bad] = -1
    return vals, tids
