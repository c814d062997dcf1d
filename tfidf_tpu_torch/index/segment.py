"""One segment of the LSM-style index: a fixed-capacity slab of docs
(port of ``tfidf_tpu/index/segment.py``).

A segment is the unit everything else composes: the **delta** is a
segment still absorbing rows; **sealing** flips it immutable;
**compaction** copies live rows of many sealed segments into one fresh
segment; a **snapshot** is its arrays through ``checkpoint.save_index``.

Host-master representation. Each row holds one document's row-sparse
triple — ``(ids, counts, head)`` exactly as
``ops.sparse.sorted_term_counts`` would produce it (derived on the host
by the bit-identical numpy mirror ``sorted_term_counts_host``) — plus
its token count, name, and a live bit (tombstones). The per-segment DF
vector is kept *incrementally* in exact integer arithmetic: a row's
distinct-term histogram is added on insert and subtracted on tombstone,
so the global DF over live segments always equals what a from-scratch
rebuild of the live corpus would count.

Device state is derived, never authoritative: the int triple uploads
once per content revision (adds, seals, compaction) as torch tensors on
the index's device, and only the float weights — which depend on the
*global* IDF, i.e. on every mutation anywhere — are recomputed per
visibility change (``segmented._refresh_weights``). Capacities are
powers of two, so the stacked search block's shape cycles in a small set.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["Segment"]


class Segment:
    """A fixed-capacity document slab (see module docstring).

    Not thread-safe on its own: ``SegmentedIndex`` owns the lock.
    """

    def __init__(self, capacity: int, length: int, vocab_size: int,
                 seg_id: int = 0) -> None:
        if capacity < 1 or length < 1:
            raise ValueError("segment capacity/length must be >= 1")
        self.capacity = capacity
        self.length = length
        self.vocab_size = vocab_size
        self.seg_id = seg_id
        self.ids = np.zeros((capacity, length), np.int32)
        self.counts = np.zeros((capacity, length), np.int32)
        self.head = np.zeros((capacity, length), bool)
        self.lengths = np.zeros((capacity,), np.int32)
        self.live = np.zeros((capacity,), bool)
        self.names: List[Optional[str]] = [None] * capacity
        self.df = np.zeros((vocab_size,), np.int32)
        self.used = 0          # rows ever filled (append-only)
        self.sealed = False
        # content_rev: bumps on any change to the INT arrays (adds,
        # never tombstones — the live mask rides separately), the key
        # the device triple cache invalidates on.
        self.content_rev = 0
        self._dev: Optional[tuple] = None  # (rev, device, ids, counts, head, lens)

    # --- derived counts ---
    @property
    def live_docs(self) -> int:
        return int(self.live.sum())

    @property
    def tombstones(self) -> int:
        return self.used - self.live_docs

    @property
    def full(self) -> bool:
        return self.used >= self.capacity

    # --- mutation (delta only; SegmentedIndex holds the lock) ---
    def _row_df(self, row: int) -> np.ndarray:
        """One row's distinct-term histogram — its exact (integer) DF
        contribution, derived from the head-masked triple."""
        terms = self.ids[row][self.head[row]]
        return np.bincount(terms, minlength=self.vocab_size).astype(
            np.int32)

    def add_row(self, ids_row: np.ndarray, counts_row: np.ndarray,
                head_row: np.ndarray, length: int, name: str) -> int:
        """Append one document; returns its row. Caller checks
        :attr:`full` first and seals on overflow."""
        return self.add_rows(ids_row[None], counts_row[None], head_row[None],
                             np.asarray([length], np.int32), [name]).start

    def add_rows(self, ids: np.ndarray, counts: np.ndarray,
                 head: np.ndarray, lengths: np.ndarray,
                 names: Sequence[str]) -> range:
        """Append ``len(names)`` documents at once, with one histogram
        over their head slots for the DF; bumps the revision once per
        row. Returns their rows."""
        n = len(names)
        if self.sealed:
            raise RuntimeError("segment is sealed")
        if self.used + n > self.capacity:
            raise RuntimeError("segment is full")
        rows = range(self.used, self.used + n)
        sl = slice(rows.start, rows.stop)
        self.ids[sl] = ids
        self.counts[sl] = counts
        self.head[sl] = head
        self.lengths[sl] = lengths
        self.live[sl] = True
        self.names[sl] = list(names)
        self.df += np.bincount(self.ids[sl][self.head[sl]],
                               minlength=self.vocab_size).astype(np.int32)
        self.used += n
        self.content_rev += n
        return rows

    def tombstone(self, row: int) -> None:
        """Delete one document: flip its live bit and subtract its DF
        contribution — the mask half happens at search time, the
        scoring half here, so global IDF stays equal to a rebuild of the
        live corpus."""
        if not self.live[row]:
            return
        self.live[row] = False
        self.df -= self._row_df(row)

    def seal(self) -> None:
        self.sealed = True

    # --- device triple cache ---
    def device_triple(self, device: torch.device):
        """The int triple and lengths as tensors on ``device``, uploaded
        once per content revision (tombstones do NOT re-upload — the live
        mask is a separate small tensor the view ships per visibility
        change). Always copies, so later host writes to the delta never
        reach a published view, on the CPU either."""
        dev = self._dev
        if dev is None or dev[0] != self.content_rev or dev[1] != device:
            dev = (self.content_rev, device) + tuple(
                torch.from_numpy(a).to(device, copy=True)
                for a in (self.ids, self.counts, self.head, self.lengths))
            self._dev = dev
        return dev[2:]

    # --- persistence (checkpoint.save_index array dict) ---
    def to_arrays(self, prefix: str) -> Dict[str, np.ndarray]:
        blob = np.frombuffer(
            "\x00".join(n if n is not None else ""
                        for n in self.names).encode("utf-8"),
            dtype=np.uint8)
        return {
            f"{prefix}ids": self.ids,
            f"{prefix}counts": self.counts,
            f"{prefix}head": self.head,
            f"{prefix}lengths": self.lengths,
            f"{prefix}live": self.live,
            f"{prefix}names_blob": blob,
        }

    @classmethod
    def from_arrays(cls, prefix: str, arrays: Dict[str, np.ndarray],
                    meta: Dict, vocab_size: int) -> "Segment":
        ids = np.asarray(arrays[f"{prefix}ids"], np.int32)
        capacity, length = ids.shape
        seg = cls(capacity, length, vocab_size,
                  seg_id=int(meta.get("seg_id", 0)))
        seg.ids = ids
        seg.counts = np.asarray(arrays[f"{prefix}counts"], np.int32)
        seg.head = np.asarray(arrays[f"{prefix}head"], bool)
        seg.lengths = np.asarray(arrays[f"{prefix}lengths"], np.int32)
        seg.live = np.asarray(arrays[f"{prefix}live"], bool)
        blob = arrays[f"{prefix}names_blob"]
        names = (bytes(blob.tobytes()).decode("utf-8").split("\x00")
                 if blob.size else [""] * capacity)
        seg.names = [n if n else None for n in names]
        seg.used = int(meta["used"])
        seg.sealed = bool(meta.get("sealed", True))
        # DF is derived state: recompute it from the live triples rather
        # than trusting a stored vector to stay consistent with them.
        used = slice(0, seg.used)
        live_head = seg.head[used] & seg.live[used][:, None]
        seg.df = np.bincount(seg.ids[used][live_head],
                             minlength=vocab_size).astype(np.int32)
        seg.content_rev = 1
        return seg
