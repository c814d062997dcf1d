"""Zero-allocation query staging: a batch's query entries in a reused
host buffer, ONE non-blocking H2D copy per search batch, and the
[V, bucket] query block built on the device (port of
``tfidf_tpu/ops/queryslab.py``).

Query counts are bucketed to powers of two, so a retriever sees only a
few [V, bucket] block shapes and their buffers are reusable.
:class:`QuerySlab` holds, per bucket, a FIFO ring of :class:`Slot`\\ s.
A slot holds a byte buffer for the batch's compact entries (page-locked
when the retriever runs on CUDA), its twin on the device, the device's
[V, bucket] float32 block and a [V] float32 norm scratch. A search
checks a slot out, lays the entries of
``models.retrieval.pack_queries`` into the buffer
(:meth:`QuerySlab.stage`: each entry's flat block index as int64, then
the float32 weights), uploads the bytes with exactly ONE non-blocking copy on the
current stream (:meth:`Slot.upload`), and builds the block there
with one zero and one scatter (:meth:`Slot.build`): a batch of 64
passage-length queries moves ~30 KB, not the block's 16.8 MB. The
slot is released only when the search's result has materialized: the
copy, the build and the search run on that stream ahead of the
result's event, so once the result is on the host the buffers and the
block are free to reuse (the reuse guard).

When every slot of a bucket is checked out, a fresh one is allocated,
and when a batch has more entries than its slot's buffer holds the
buffer and its twin grow to the next power of two; either ticks
``allocs``, so after warm-up ``allocs`` stays flat. Batches wider than
``max_bucket`` take the allocating dense path (``fallbacks``). On a
CPU retriever the same code runs, unpinned.

Env knob ``TFIDF_TPU_QUERY_SLAB``: ``0``/``off``/``false``/``no``
disables, anything else (and unset) enables.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import Dict, List

import numpy as np
import torch

# A slot's first buffer holds this many entries (distinct terms) a query
# of its bucket; a fuller batch grows it.
_ENTRIES_PER_QUERY = 64
# Bytes an entry takes in the buffer: its int64 flat block index and its
# float32 weight.
ENTRY_BYTES = 12


def use_query_slab(explicit=None) -> bool:
    """Resolve the slab knob: explicit setting > env > on."""
    if explicit is not None:
        return bool(explicit)
    raw = os.environ.get("TFIDF_TPU_QUERY_SLAB", "").strip().lower()
    return raw not in ("0", "off", "false", "no")


class Slot:
    """One staging slot of a bucket: the entries' host buffer (uint8,
    pinned on CUDA) and its device twin, the device [V, bucket] block,
    and the [V] float32 norm scratch ``pack_queries`` reuses."""

    __slots__ = ("bucket", "host", "stage", "block", "scratch")

    def __init__(self, vocab_size: int, bucket: int, device: torch.device):
        self.bucket = bucket
        self.block = torch.zeros((vocab_size, bucket), dtype=torch.float32,
                                 device=device)
        self.scratch = np.zeros((vocab_size,), np.float32)
        self.resize(max(1024, bucket * _ENTRIES_PER_QUERY))

    def resize(self, entries: int) -> None:
        """Fresh buffers for ``entries`` entries."""
        nbytes = ENTRY_BYTES * entries
        self.host = torch.empty(nbytes, dtype=torch.uint8,
                                pin_memory=self.block.is_cuda)
        self.stage = torch.empty(nbytes, dtype=torch.uint8,
                                 device=self.block.device)

    @property
    def capacity(self) -> int:
        """Entries the buffers hold."""
        return self.host.numel() // ENTRY_BYTES

    def upload(self, nbytes: int) -> None:
        """The staged bytes to the device twin: one copy, non-blocking
        from pinned memory, on the current stream."""
        self.stage[:nbytes].copy_(self.host[:nbytes], non_blocking=True)

    def build(self, entries: int) -> torch.Tensor:
        """The [V, bucket] block from the uploaded entries, on the
        current stream: zeroed, then the weights scattered (the flat
        indices are distinct, so no accumulation)."""
        self.block.zero_()
        if entries:
            flat = self.stage[:8 * entries].view(torch.int64)
            weights = self.stage[8 * entries:ENTRY_BYTES * entries].view(
                torch.float32)
            self.block.view(-1).index_put_((flat,), weights)
        return self.block


class QuerySlab:
    """Per-bucket staging rings + the slab counters.

    Thread-safe: checkout/release take the slab lock; the staging, the
    upload and the build happen outside it on the checked-out slot.
    ``device`` is the retriever's: on CUDA the host buffers are
    page-locked, so the upload is a true asynchronous copy.
    """

    def __init__(self, vocab_size: int, max_bucket: int,
                 min_depth: int = 1, device="cpu"):
        if max_bucket < 1:
            raise ValueError("max_bucket must be >= 1")
        if min_depth < 1:
            raise ValueError("min_depth must be >= 1")
        self.vocab_size = int(vocab_size)
        # Next pow2 at or above the bound, so every bucket the search
        # path can produce has a ring.
        self.max_bucket = 1 << max(0, int(max_bucket) - 1).bit_length()
        self.min_depth = int(min_depth)
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._free: Dict[int, collections.deque] = {}
        self._slots: Dict[int, List[Slot]] = {}
        self.allocs = 0       # fresh slots and buffer growths
        self.packs = 0        # checkouts = batches staged via the slab
        self.h2d_copies = 0   # uploads (must equal packs)
        self.bytes_h2d = 0
        self.entries = 0      # entries (a query's distinct terms) staged
        self.fallbacks = 0    # oversize batches the caller routed away

    def checkout(self, bucket: int):
        """-> (slot, slot key). Reuses the oldest free slot of the
        bucket's ring (FIFO) or allocates a fresh one when every slot is
        in flight."""
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
            slot = slots[idx]
        return slot, (bucket, idx)

    def _top_up(self, bucket: int, depth: int) -> None:
        """Grow the bucket's ring to ``depth`` slots (lock held)."""
        free = self._free[bucket]
        slots = self._slots[bucket]
        while len(slots) < depth:
            slots.append(Slot(self.vocab_size, bucket, self.device))
            free.append(len(slots) - 1)
            self.allocs += 1

    def stage(self, slot: Slot, cols: np.ndarray, ids: np.ndarray,
              weights: np.ndarray) -> int:
        """Lay the entries into the slot's host buffer: the flat block
        indices ``ids * bucket + cols`` (int64), then the weights
        (float32). A buffer too small for them grows, with its twin, to
        the next power of two. Returns the bytes to upload."""
        n = len(ids)
        if n > slot.capacity:
            slot.resize(1 << (n - 1).bit_length())
            with self._lock:
                self.allocs += 1
        host = slot.host.numpy()
        flat = host[:8 * n].view(np.int64)
        np.multiply(ids, slot.bucket, out=flat, dtype=np.int64)
        flat += cols
        host[8 * n:ENTRY_BYTES * n].view(np.float32)[:] = weights
        return ENTRY_BYTES * n

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

    def note_h2d(self, nbytes: int, entries: int) -> None:
        with self._lock:
            self.h2d_copies += 1
            self.bytes_h2d += int(nbytes)
            self.entries += int(entries)

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
                "entries": self.entries,
                "fallbacks": self.fallbacks,
                "buffers": sum(len(s) for s in self._slots.values()),
            }
