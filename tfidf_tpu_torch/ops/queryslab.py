"""Zero-allocation query staging: a ring of pinned host buffers feeding
one non-blocking H2D copy per search batch (port of
``tfidf_tpu/ops/queryslab.py``).

Query counts are bucketed to powers of two, so a retriever sees only a
few [V, bucket] block shapes and their staging buffers are reusable.
:class:`QuerySlab` holds, per bucket, a FIFO ring of host slots: a
float32 [V, bucket] tensor (page-locked when the retriever runs on CUDA)
with a numpy view that ``models.retrieval.fill_query_matrix`` fills in
place, plus a [V] float32 norm scratch. A search checks a slot out,
fills it, uploads it with exactly ONE non-blocking copy on the current
stream, and releases the slot only when its result has materialized:
the copy and the search run on that stream ahead of the result's
event, so once the result is on the host the copy has consumed the
slot (the reuse guard).

When every slot of a bucket is checked out, a fresh one is allocated
and ``allocs`` ticks, so after warm-up ``allocs`` stays flat. Batches
wider than ``max_bucket`` take the allocating path (``fallbacks``).

Env knob ``TFIDF_TPU_QUERY_SLAB``: ``0``/``off``/``false``/``no``
disables, anything else (and unset) enables.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Dict, List, Tuple

import numpy as np
import torch


def use_query_slab(explicit=None) -> bool:
    """Resolve the slab knob: explicit setting > env > on."""
    if explicit is not None:
        return bool(explicit)
    raw = os.environ.get("TFIDF_TPU_QUERY_SLAB", "").strip().lower()
    return raw not in ("0", "off", "false", "no")


class QuerySlab:
    """Per-bucket host staging rings + the slab counters.

    Thread-safe: checkout/release take the slab lock; the fill and the
    upload happen outside it on the checked-out slot. ``pin`` allocates
    page-locked slots (needs CUDA), so the upload is a true asynchronous
    copy.
    """

    def __init__(self, vocab_size: int, max_bucket: int,
                 min_depth: int = 1, pin: bool = False):
        if max_bucket < 1:
            raise ValueError("max_bucket must be >= 1")
        if min_depth < 1:
            raise ValueError("min_depth must be >= 1")
        self.vocab_size = int(vocab_size)
        # Next pow2 at or above the bound, so every bucket the search
        # path can produce has a ring.
        self.max_bucket = 1 << max(0, int(max_bucket) - 1).bit_length()
        self.min_depth = int(min_depth)
        self.pin = bool(pin)
        self._lock = threading.Lock()
        self._free: Dict[int, collections.deque] = {}
        self._slots: Dict[int, List[Tuple[torch.Tensor, np.ndarray]]] = {}
        self.allocs = 0       # fresh staging-buffer allocations
        self.packs = 0        # checkouts = batches staged via the slab
        self.h2d_copies = 0   # uploads (must equal packs)
        self.bytes_h2d = 0
        self.fallbacks = 0    # oversize batches the caller routed away

    def checkout(self, bucket: int):
        """-> (buf float32 [V, bucket] tensor, scratch [V] float32 numpy,
        slot key). Reuses the oldest free slot of the bucket's ring (FIFO)
        or allocates a fresh one when every slot is in flight. ``buf``'s
        numpy view (``buf.numpy()``) shares its memory."""
        if bucket > self.max_bucket:
            raise ValueError(f"bucket {bucket} > max_bucket "
                             f"{self.max_bucket} — caller must take "
                             f"the legacy path (note_fallback)")
        with self._lock:
            free = self._free.setdefault(bucket, collections.deque())
            slots = self._slots.setdefault(bucket, [])
            if not slots:
                self._top_up(bucket, self.min_depth)
            if free:
                idx = free.popleft()
            else:
                self._top_up(bucket, len(slots) + 1)
                idx = free.popleft()
            self.packs += 1
            buf, scratch = slots[idx]
        return buf, scratch, (bucket, idx)

    def _top_up(self, bucket: int, depth: int) -> None:
        """Grow the bucket's ring to ``depth`` slots (lock held)."""
        free = self._free[bucket]
        slots = self._slots[bucket]
        while len(slots) < depth:
            slots.append((
                torch.zeros((self.vocab_size, bucket), dtype=torch.float32,
                            pin_memory=self.pin),
                np.zeros((self.vocab_size,), np.float32)))
            free.append(len(slots) - 1)
            self.allocs += 1

    def reserve(self, depth: int) -> None:
        """Raise :attr:`min_depth` to ``depth`` and top every touched
        ring up to it."""
        if depth < 1:
            raise ValueError("depth must be >= 1")
        with self._lock:
            self.min_depth = max(self.min_depth, int(depth))
            for bucket in self._slots:
                self._top_up(bucket, self.min_depth)

    def release(self, slot) -> None:
        bucket, idx = slot
        with self._lock:
            self._free[bucket].append(idx)

    def note_h2d(self, nbytes: int) -> None:
        with self._lock:
            self.h2d_copies += 1
            self.bytes_h2d += int(nbytes)

    def note_fallback(self) -> None:
        with self._lock:
            self.fallbacks += 1

    def ring_depth(self, bucket: int) -> int:
        with self._lock:
            return len(self._slots.get(bucket, ()))

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "allocs": self.allocs,
                "packs": self.packs,
                "h2d_copies": self.h2d_copies,
                "bytes_h2d": self.bytes_h2d,
                "fallbacks": self.fallbacks,
                "buffers": sum(len(s) for s in self._slots.values()),
            }
