"""LRU result cache keyed on normalized query tokens + k + index epoch
(port of ``tfidf_tpu/serve/cache.py``; the JAX package's code).

Keys normalize through the same tokenizer the query matrix uses
(``ops.tokenize.whitespace_tokenize`` + the config's truncation), so two
spellings that score identically ("a  b" vs "a b") share one entry, and
the index epoch (plus the scorer and filter keys) is part of the key,
so an entry never aliases a fresh one across
:meth:`TfidfServer.swap_index` (the server also clears the cache on
every install).

Values are the per-query ``(vals_row, ids_row)`` numpy pair exactly as
:meth:`TfidfRetriever.search` returned them, so a hit is bit-identical
to recomputation (search is deterministic per query and independent of
batch composition).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from tfidf_tpu_torch.config import PipelineConfig
from tfidf_tpu_torch.ops.tokenize import whitespace_tokenize

Key = Tuple[Tuple[bytes, ...], int, int, str, str]
Row = Tuple[np.ndarray, np.ndarray]


def normalize_query(text: Union[str, bytes],
                    config: PipelineConfig) -> Tuple[bytes, ...]:
    """Canonical cache-key form of one query: its token tuple under the
    retriever's own tokenizer (truncation included), so key equality
    exactly matches scoring equality."""
    data = text.encode() if isinstance(text, str) else bytes(text)
    return tuple(whitespace_tokenize(data, config.truncate_tokens_at))


class ResultCache:
    """Thread-safe LRU over per-query result rows with hit/miss
    counters. ``entries == 0`` constructs a disabled cache (every
    lookup misses without counting; puts drop)."""

    def __init__(self, entries: int) -> None:
        if entries < 0:
            raise ValueError("entries must be >= 0")
        self.entries = entries
        self._lock = threading.Lock()
        self._rows: "OrderedDict[Key, Row]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    @property
    def enabled(self) -> bool:
        return self.entries > 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    @staticmethod
    def key(tokens: Sequence[bytes], k: int, epoch: int,
            scorer: str = "tfidf", filter: str = "") -> Key:
        """``scorer``/``filter`` are the CANONICAL keys
        (``scoring.scorer_key`` / ``scoring.filter_key``): two requests
        share an entry only when they would score identically — same
        tokens, same k, same epoch, same scorer-family member, same
        candidate set."""
        return (tuple(tokens), int(k), int(epoch), str(scorer),
                str(filter))

    def get(self, key: Key) -> Optional[Row]:
        if not self.enabled:
            return None
        with self._lock:
            row = self._rows.get(key)
            if row is None:
                self.misses += 1
                return None
            self._rows.move_to_end(key)
            self.hits += 1
            return row

    def put(self, key: Key, vals_row: np.ndarray,
            ids_row: np.ndarray) -> None:
        if not self.enabled:
            return
        # Own copies: the cached row outlives the batch arrays it was
        # sliced from, and callers must never be able to mutate it.
        row = (np.array(vals_row, copy=True), np.array(ids_row, copy=True))
        row[0].setflags(write=False)
        row[1].setflags(write=False)
        with self._lock:
            self._rows[key] = row
            self._rows.move_to_end(key)
            while len(self._rows) > self.entries:
                self._rows.popitem(last=False)

    def clear(self) -> None:
        """Drop every entry (hot-swap invalidation); counters survive —
        they are lifetime serving stats, not per-epoch ones."""
        with self._lock:
            self._rows.clear()
