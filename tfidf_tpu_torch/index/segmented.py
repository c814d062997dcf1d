"""SegmentedIndex: live add/update/delete without rebuilding the world
(port of ``tfidf_tpu/index/segmented.py``).

The LSM-tree / Lucene segment model:

* a **delta segment** absorbs ``add_docs`` / update / ``delete_docs``
  (packing rides ``StreamingTfidf.pack`` with its fixed-length pin; the
  per-doc sorted triple is derived on the host by the bit-identical
  numpy mirror ``ops.sparse.sorted_term_counts_host``);
* the delta **seals** into an immutable segment when full
  (``segment_seal`` flight event);
* deletes/updates are **tombstone mask bits** applied before top-k, with
  the doc's DF contribution subtracted in exact integer arithmetic;
* search scores every live segment against the **corrected global
  DF/IDF** over live segments: by default the segments stack into one
  row block for the tiled score+top-k (``ops.sparse.score_topk_tiled``,
  the tile-scores kernel on every tile); ``TFIDF_TPU_SCORE_TILING=off``
  scores each segment (``ops.topk.segment_score_topk``) and merges
  (``ops.topk.merge_topk``). Either way every response equals a
  from-scratch rebuild of the live corpus bit for bit
  (:meth:`SegmentedIndex.rebuild_retriever`);
* **compaction** merges sealed segments in one pass (``compaction``
  flight event, rehearsable mid-merge via the ``swap`` fault seam),
  dropping tombstones;
* **versioned visibility**: every mutation bumps :attr:`version` and
  drops the cached :class:`IndexView`; views are immutable snapshots
  that answer the ``TfidfRetriever`` search contract.

Persistence reuses ``checkpoint.save_index`` (seq+LATEST, per-array
sha256, typed ``SnapshotMismatch``) with the JAX package's meta and key
layout, so snapshots cross between the packages.

The weight refresh of :meth:`SegmentedIndex.view` runs the retriever
build's float sequence (``sparse_scores`` then
``models.retrieval._normalize_rows``; ``scoring.family.bm25_weights`` for
bm25), which is what makes a view equal ``rebuild_retriever()`` bit for
bit. The JAX package's ``index_compile_cache_size`` counts XLA programs;
this package compiles none, so it has no counterpart and no stand-in
(the serving layer's compile watch, ``obs.devmon.CompileWatch``, counts
the native library builds). Runs on CUDA unless a device is named; with
no GPU and no device named it raises.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tfidf_tpu_torch import faults, obs
from tfidf_tpu_torch.config import PipelineConfig, VocabMode
from tfidf_tpu_torch.index.segment import Segment
from tfidf_tpu_torch.io.corpus import Corpus, discover_corpus
from tfidf_tpu_torch.models.retrieval import (_LEGACY_QUERY_BLOCK,
                                              TfidfRetriever, _build_index,
                                              _normalize_rows,
                                              config_fingerprint, query_matrix)
from tfidf_tpu_torch.obs import log as obs_log
from tfidf_tpu_torch.ops.scoring import idf_from_df
from tfidf_tpu_torch.ops.sparse import (score_tile_rows, score_tiling,
                                        score_topk_tiled,
                                        sorted_term_counts_host, sparse_scores)
from tfidf_tpu_torch.ops.topk import merge_topk, segment_score_topk
from tfidf_tpu_torch.pipeline import resolve_device
from tfidf_tpu_torch.scoring.family import (ScorerSpec, avgdl_f32,
                                            bm25_idf_from_df, bm25_weights,
                                            parse_scorer)
from tfidf_tpu_torch.scoring.filters import (FilterSpec, filter_mask,
                                             parse_filter)
from tfidf_tpu_torch.streaming import StreamingTfidf

__all__ = ["SegmentedIndex", "IndexView"]


def _on_device(device: torch.device):
    """Make ``device`` this thread's current CUDA device for a block (a
    compactor or search thread starts on device 0); no-op on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _refresh_weights(ids, counts, head, lengths, idf):
    """One segment's tfidf face against the global IDF: the retriever
    build's float sequence (gather-scored rows, float64 L2 norm, guard)
    and its face's masking, so a row's weights equal a from-scratch
    rebuild of the same row bit for bit."""
    weights = _normalize_rows(sparse_scores(ids, counts, head, lengths, idf))
    return (torch.where(head, weights, 0.0),
            torch.where(head, ids, 0).to(torch.int32))


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` with zero (False) rows appended up to ``rows``."""
    pad = rows - t.shape[0]
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])


def _stack(parts: List[torch.Tensor]) -> torch.Tensor:
    """Parts concatenated along rows, padded with dead rows to the next
    power of two (the shape set of the stacked block stays log-small)."""
    t = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
    return _pad_rows(t, _next_pow2(t.shape[0]))


class _ViewPart:
    """One segment's device-resident face inside a view."""

    __slots__ = ("data", "cols", "live", "base", "rows")

    def __init__(self, data, cols, live, base: int, rows: int) -> None:
        self.data = data
        self.cols = cols
        self.live = live
        self.base = base
        self.rows = rows


class IndexView:
    """An immutable snapshot of the segmented index at one version.

    Answers the ``TfidfRetriever`` search contract (``search`` /
    ``names`` / ``config`` / ``indexed`` / ``_num_docs`` / ``snapshot``),
    so a holder of a retriever can hold a view instead: in-flight queries
    finish on the view they started under while mutations install newer
    views.

    ``names`` is positional over PADDED rows (tombstoned and unused rows
    hold ``""``); only live rows can surface in results.
    """

    def __init__(self, owner: "SegmentedIndex", version: int,
                 config: PipelineConfig, parts: List[_ViewPart],
                 names: List[str], idf: torch.Tensor, idf_np: np.ndarray,
                 num_live: int, triples: Optional[list] = None,
                 df_np: Optional[np.ndarray] = None,
                 total_len: int = 0) -> None:
        self.owner = owner
        self.device = owner.device
        self.version = version
        self.config = config
        self._parts = parts
        self.names = names
        self._idf = idf
        self._idf_np = idf_np
        self._num_docs = num_live
        # Lazily built and cached (a view never changes, so each derives
        # at most once; a racing double build is benign — same values):
        # the stacked face of every part, the per-scorer faces and the
        # per-filter live masks. The stored triples, the corrected global
        # DF and the exact live token total feed the bm25 face.
        self._stack: Optional[tuple] = None
        self._triples = triples or []
        self._df_np = df_np
        self._total_len = int(total_len)
        self._scorer_stacks: dict = {}
        self._filter_masks: dict = {}

    @property
    def indexed(self) -> bool:
        return True

    @property
    def num_segments(self) -> int:
        return len(self._parts)

    def index_arrays(self) -> list:
        """Live device tensors of this view (its IDF, every part's face
        and live mask, and the cached stacks and filter masks)."""
        out = [self._idf]
        for p in self._parts:
            out += [p.data, p.cols, p.live]
        if self._stack is not None:
            out += list(self._stack)
        for st in self._scorer_stacks.values():
            out += list(st)
        out += list(self._filter_masks.values())
        return out

    def _stacked(self):
        """The parts stacked into ONE row block (data, cols, live), built
        on first use. Rows pad to the next power of two with dead rows.
        Base offsets are cumulative part capacities, so stacked row order
        IS the positional row space ``names`` indexes and the lower-row
        tie-break reproduces the per-part merge exactly."""
        st = self._stack
        if st is None:
            parts = self._parts
            st = tuple(_stack([getattr(p, f) for p in parts])
                       for f in ("data", "cols", "live"))
            self._stack = st
        return st

    def snapshot(self, path: str, epoch: int = 0,
                 extra_meta: Optional[dict] = None) -> str:
        """Persist the owning index's CURRENT state (which may be a
        version or two ahead of this view — a snapshot is a restart
        artifact, not a historical one)."""
        return self.owner.save(path, epoch=epoch, extra_meta=extra_meta)

    def _merged_parts(self, qmat, k):
        """The untiled default search: each part scored on its own (one
        tile-scores launch over its rows, dead rows masked), then a
        top-k-of-top-k over the candidates in part order."""
        vals_parts, ids_parts = [], []
        for part in self._parts:
            v, i = segment_score_topk(part.data, part.cols, part.live, qmat,
                                      k=min(k, part.rows))
            vals_parts.append(v)
            ids_parts.append(i + part.base)
        vals = torch.cat(vals_parts, dim=1)
        return merge_topk(vals, torch.cat(ids_parts, dim=1),
                          k=min(k, vals.shape[1]))

    def search(self, queries: Sequence[Union[str, bytes]], k: int = 10,
               *, scorer=None, filter=None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Ranked retrieval over the live segments: (scores, doc
        positions), each [Q, k'] with k' = min(k, live docs). ``doc
        positions`` index :attr:`names`; -1 marks padding. ``scorer`` /
        ``filter`` select another scorer-family member (bm25 queries
        pack as raw counts) / restrict the candidates (filter doc ids
        are POSITIONS in this view's row space; name-prefix filters are
        the position-independent form).

        Tiled (the default): every segment stacks into ONE doc-tiled
        scan. ``TFIDF_TPU_SCORE_TILING=off`` scores each segment and
        merges (a non-default scorer or a filter: the stack as one
        block), in 64-query blocks; the results are the same bits."""
        spec = ScorerSpec() if scorer is None else parse_scorer(scorer)
        fspec = parse_filter(filter)
        nq = len(queries)
        tiled = score_tiling()
        if not tiled and nq > _LEGACY_QUERY_BLOCK:
            parts = [self.search(queries[s:s + _LEGACY_QUERY_BLOCK], k,
                                 scorer=spec, filter=fspec)
                     for s in range(0, nq, _LEGACY_QUERY_BLOCK)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        width = min(k, self._num_docs)
        if not self._parts or width == 0:
            return (np.zeros((nq, width), np.float32),
                    np.full((nq, width), -1, np.int64))
        bucket = 1 << max(0, nq - 1).bit_length()
        with _on_device(self.device):
            qmat = torch.from_numpy(query_matrix(
                queries, self.config, self._idf_np, pad_to=bucket,
                mode="counts" if spec.kind == "bm25" else "cosine")
            ).to(self.device)
            data, cols = self._face(spec)
            live = self._filter_live(fspec)
            if tiled:
                rows = int(data.shape[0])
                tile = score_tile_rows(rows)
                with obs.span("score_tile", tiles=-(-rows // tile),
                              rows=rows, segments=len(self._parts),
                              queries=int(bucket)):
                    vals, idx = score_topk_tiled(data, cols, live, qmat, k,
                                                 tile=tile)
            elif spec.is_default and fspec is None:
                vals, idx = self._merged_parts(qmat, k)
            else:
                vals, idx = segment_score_topk(
                    data, cols, live, qmat, k=min(k, int(data.shape[0])))
            vals = vals.cpu().numpy()[:nq, :width]
            idx = idx.cpu().numpy()[:nq, :width]
        ok = vals > 0
        return np.where(ok, vals, 0.0), np.where(ok, idx, -1)

    def _face(self, spec: ScorerSpec):
        """The stacked ``(data, cols)`` face of one scorer, cached per
        key. tfidf IS the default stacked face; bm25 refreshes every
        part's stored triple through ``scoring.family.bm25_weights``
        against this view's global DF and avgdl (the retriever's bm25
        face runs the same function), then stacks with the same pow2
        padding, so row order (and tie order) matches."""
        key = spec.key()
        st = self._scorer_stacks.get(key)
        if st is not None:
            return st
        if spec.kind == "tfidf":
            data, cols, _ = self._stacked()
            st = (data, cols)
        else:
            dev = self.device
            idf_b = bm25_idf_from_df(
                torch.from_numpy(self._df_np.astype(np.int32)).to(dev),
                self._num_docs)
            avgdl = avgdl_f32(self._total_len, self._num_docs)
            faces = [bm25_weights(ids_d, counts_d, head_d, lens_d, idf_b,
                                  avgdl, np.float32(spec.k1),
                                  np.float32(spec.b))
                     for ids_d, counts_d, head_d, lens_d in self._triples]
            st = (_stack([f[0] for f in faces]),
                  _stack([f[1] for f in faces]))
        self._scorer_stacks[key] = st
        return st

    def scorer_face(self, spec=None) -> Tuple[np.ndarray, np.ndarray]:
        """Host copy of a scorer's stacked ``(data, cols)`` face, trimmed
        to the concatenated part rows (the pow2 pad stripped)."""
        spec = ScorerSpec() if spec is None else parse_scorer(spec)
        with _on_device(self.device):
            data, cols = self._face(spec)
        total = sum(p.rows for p in self._parts)
        return data[:total].cpu().numpy(), cols[:total].cpu().numpy()

    def _filter_live(self, fspec: Optional[FilterSpec]):
        """The stacked live mask AND one filter's allow-mask, cached per
        canonical filter key; no filter returns the tombstone mask."""
        if fspec is None:
            return self._stacked()[2]
        key = fspec.key()
        live = self._filter_masks.get(key)
        if live is None:
            base = self._stacked()[2].cpu().numpy()
            npos = min(base.shape[0], len(self.names))
            mask = np.zeros((base.shape[0],), bool)
            mask[:npos] = filter_mask(fspec, npos, names=self.names)
            live = torch.from_numpy(base & mask).to(self.device)
            self._filter_masks[key] = live
        return live


def _next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


class SegmentedIndex:
    """The mutable LSM-style index (see module docstring).

    Thread-safe: every mutation and every :meth:`view` build runs under
    one re-entrant lock, and sets the index's CUDA device. Views
    themselves are immutable and lock-free to search.

    Args:
      config: HASHED-vocab pipeline config; ``max_doc_len`` pins the
        token axis of EVERY segment (the L the rebuild oracle packs at).
      delta_docs: delta-segment capacity; a full delta seals.
      compact_at: sealed-segment count at which :meth:`compact`
        actually merges (``force=True`` merges from 2).
      device: CUDA unless named; raises without a GPU and no device.
    """

    def __init__(self, config: Optional[PipelineConfig] = None,
                 delta_docs: int = 1024, compact_at: int = 4,
                 device=None) -> None:
        cfg = config or PipelineConfig(vocab_mode=VocabMode.HASHED)
        if cfg.vocab_mode is not VocabMode.HASHED:
            raise ValueError("SegmentedIndex requires HASHED vocab "
                             "(fixed id space across mutations)")
        if delta_docs < 1:
            raise ValueError("delta_docs must be >= 1")
        if compact_at < 2:
            raise ValueError("compact_at must be >= 2")
        self.config = cfg
        self.device = resolve_device(device)
        self.delta_docs = delta_docs
        self.compact_at = compact_at
        self._length = cfg.max_doc_len
        # Packing reuses the streaming machinery: fixed_len pins the
        # token axis so every mutation batch shares one shape.
        self._stream = StreamingTfidf(cfg, device=self.device)
        self._lock = threading.RLock()
        self._sealed: List[Segment] = []
        self._delta = Segment(delta_docs, self._length, cfg.vocab_size,
                              seg_id=0)
        self._next_seg_id = 1
        self._loc: Dict[str, Tuple[Segment, int]] = {}
        self._version = 1
        self._view: Optional[IndexView] = None
        self.compactions: List[dict] = []   # last-N summaries

    # --- construction -------------------------------------------------
    @classmethod
    def from_corpus(cls, corpus: Corpus,
                    config: Optional[PipelineConfig] = None,
                    delta_docs: int = 1024, compact_at: int = 4,
                    device=None) -> "SegmentedIndex":
        """Bulk-load a corpus as ONE sealed base segment (capacity the
        next power of two — compaction keeps that discipline), then open
        a fresh delta for mutations."""
        idx = cls(config, delta_docs=delta_docs, compact_at=compact_at,
                  device=device)
        if len(corpus):
            base = Segment(
                _next_pow2(max(len(corpus), delta_docs)),
                idx._length, idx.config.vocab_size, seg_id=0)
            ids, counts, head, lengths = idx._pack_rows(
                corpus.names, corpus.docs)
            with idx._lock:
                rows = base.add_rows(ids, counts, head, lengths,
                                     corpus.names)
                idx._loc.update(
                    (name, (base, row))
                    for name, row in zip(corpus.names, rows))
                base.seal()
                idx._sealed.append(base)
                idx._delta.seg_id = idx._next_seg_id
                idx._next_seg_id += 1
                idx._bump_locked()
        return idx

    @classmethod
    def from_dir(cls, input_dir: str,
                 config: Optional[PipelineConfig] = None,
                 delta_docs: int = 1024, compact_at: int = 4,
                 strict: bool = True, device=None) -> "SegmentedIndex":
        return cls.from_corpus(discover_corpus(input_dir, strict),
                               config, delta_docs=delta_docs,
                               compact_at=compact_at, device=device)

    # --- state --------------------------------------------------------
    @property
    def version(self) -> int:
        """Visibility version: bumps on EVERY change a query could
        observe (add, update, delete, seal, compaction install)."""
        with self._lock:
            return self._version

    @property
    def num_docs(self) -> int:
        with self._lock:
            return self._live_locked()

    @property
    def sealed_count(self) -> int:
        with self._lock:
            return len(self._sealed)

    def _segments_locked(self) -> List[Segment]:
        return self._sealed + ([self._delta] if self._delta.used else [])

    def stats(self) -> dict:
        """Gauge feed: segment/delta/tombstone counts."""
        with self._lock:
            segs = self._segments_locked()
            return {
                "segments": len(segs),
                "sealed": len(self._sealed),
                "delta_used": self._delta.used,
                "delta_capacity": self._delta.capacity,
                "delta_fill": self._delta.used / self._delta.capacity,
                "tombstones": sum(s.tombstones for s in segs),
                "live_docs": self._live_locked(),
                "version": self._version,
            }

    def _live_locked(self) -> int:
        total = sum(s.live_docs for s in self._sealed)
        return total + self._delta.live_docs

    def _bump_locked(self) -> None:
        self._version += 1
        self._view = None

    # --- mutation -----------------------------------------------------
    def _pack_rows(self, names: Sequence[str], docs: Sequence[bytes]):
        """Docs -> host row-sparse triples at the pinned L, through the
        streaming packer + the numpy sorted-counts mirror."""
        docs = [d.encode() if isinstance(d, str) else bytes(d)
                for d in docs]
        batch = self._stream.pack(Corpus(names=list(names), docs=docs),
                                  fixed_len=self._length)
        ids, counts, head = sorted_term_counts_host(
            batch.token_ids, batch.lengths)
        return ids, counts, head, batch.lengths

    def add_docs(self, names: Sequence[str],
                 docs: Sequence[Union[str, bytes]]) -> dict:
        """Add (or update — same name replaces) documents. Returns
        ``{"added", "updated", "sealed", "version"}``. One visibility
        bump per call, covering any seal it triggered."""
        if len(names) != len(docs):
            raise ValueError("names and docs must align")
        if not names:
            return {"added": 0, "updated": 0, "sealed": 0,
                    "version": self.version}
        ids, counts, head, lengths = self._pack_rows(names, docs)
        added = updated = sealed = 0
        with self._lock:
            for i, name in enumerate(names):
                old = self._loc.get(name)
                if old is not None:
                    old[0].tombstone(old[1])
                    updated += 1
                else:
                    added += 1
                if self._delta.full:
                    self._seal_locked()
                    sealed += 1
                row = self._delta.add_row(ids[i], counts[i], head[i],
                                          int(lengths[i]), name)
                self._loc[name] = (self._delta, row)
            self._bump_locked()
            version = self._version
        return {"added": added, "updated": updated, "sealed": sealed,
                "version": version}

    def delete_docs(self, names: Sequence[str]) -> dict:
        """Tombstone documents by name. Returns ``{"deleted",
        "missing", "version"}``; no visibility bump when nothing was
        actually deleted."""
        deleted = missing = 0
        with self._lock:
            for name in names:
                loc = self._loc.pop(name, None)
                if loc is None:
                    missing += 1
                    continue
                loc[0].tombstone(loc[1])
                deleted += 1
            if deleted:
                self._bump_locked()
            version = self._version
        return {"deleted": deleted, "missing": missing,
                "version": version}

    def _seal_locked(self) -> None:
        delta = self._delta
        delta.seal()
        self._sealed.append(delta)
        self._delta = Segment(self.delta_docs, self._length,
                              self.config.vocab_size,
                              seg_id=self._next_seg_id)
        self._next_seg_id += 1
        obs_log.log_event(
            "info", "segment_seal",
            msg=f"delta sealed: segment {delta.seg_id} "
                f"({delta.live_docs}/{delta.used} live), "
                f"{len(self._sealed)} sealed segment(s)",
            seg_id=delta.seg_id, docs=delta.used,
            live=delta.live_docs, sealed_segments=len(self._sealed))

    # --- compaction ---------------------------------------------------
    @property
    def needs_compaction(self) -> bool:
        with self._lock:
            return len(self._sealed) >= self.compact_at

    def compact(self, force: bool = False) -> Optional[dict]:
        """Merge the sealed segments into one, dropping tombstones and
        preserving insertion order. Runs under the index lock: mutations
        pause (the measured ``pause_s``), searches on existing views do
        not. The merged state installs AFTER the ``swap`` fault seam
        fires — a compactor killed mid-merge leaves the index exactly as
        it was. Returns the summary dict, or None below threshold."""
        t0 = time.monotonic()
        with self._lock:
            inputs = list(self._sealed)
            threshold = 2 if force else self.compact_at
            if len(inputs) < threshold:
                return None
            with obs.span("compact", segments=len(inputs)):
                live_total = sum(s.live_docs for s in inputs)
                dropped = sum(s.tombstones for s in inputs)
                merged = Segment(
                    _next_pow2(max(live_total, self.delta_docs)),
                    self._length, self.config.vocab_size,
                    seg_id=self._next_seg_id)
                # live rows of every input, in insertion order
                keep = [np.flatnonzero(s.live[:s.used]) for s in inputs]
                names = [s.names[r] for s, rows in zip(inputs, keep)
                         for r in rows]
                rows = merged.add_rows(
                    *(np.concatenate([getattr(s, f)[r]
                                      for s, r in zip(inputs, keep)])
                      for f in ("ids", "counts", "head", "lengths")),
                    names)
                merged.seal()
                # The rehearsable crash point: a fault here kills the
                # compactor AFTER the merge work, BEFORE any state
                # changed — the supervised restart retries cleanly.
                faults.fire("swap", op="compact", segments=len(inputs),
                            docs=live_total)
                self._next_seg_id += 1
                self._sealed = [merged]
                self._loc.update((name, (merged, row))
                                 for name, row in zip(names, rows))
                self._bump_locked()
                version = self._version
        pause_s = time.monotonic() - t0
        summary = {"segments_in": len(inputs), "docs": live_total,
                   "dropped_tombstones": dropped,
                   "capacity": merged.capacity,
                   "pause_s": round(pause_s, 6), "version": version}
        with self._lock:
            self.compactions.append(summary)
            del self.compactions[:-64]
        obs_log.log_event(
            "info", "compaction",
            msg=f"compacted {len(inputs)} segments -> {live_total} "
                f"live docs (dropped {dropped} tombstones) in "
                f"{pause_s * 1e3:.1f} ms",
            **summary)
        return summary

    # --- visibility ---------------------------------------------------
    def view(self) -> IndexView:
        """The current immutable snapshot (cached per version). Builds
        the corrected global DF/IDF over live segments and refreshes
        every segment's weights against it — the price of scores that
        equal a from-scratch rebuild of the live corpus bit for bit."""
        dev = self.device
        with self._lock, _on_device(dev):
            if self._view is not None:
                return self._view
            src = self._segments_locked()
            df = np.zeros((self.config.vocab_size,), np.int64)
            total_len = 0
            for seg in src:
                df += seg.df
                # Exact-integer live token total — the avgdl numerator
                # of the bm25 face.
                total_len += int((seg.lengths.astype(np.int64)
                                  * seg.live).sum())
            num_live = self._live_locked()
            idf = idf_from_df(torch.from_numpy(df.astype(np.int32)).to(dev),
                              num_live, torch.float32)
            idf_np = idf.cpu().numpy()
            parts: List[_ViewPart] = []
            triples: list = []
            names: List[str] = []
            base = 0
            for seg in src:
                triple = seg.device_triple(dev)
                data, cols = _refresh_weights(*triple, idf)
                parts.append(_ViewPart(
                    data, cols, torch.from_numpy(seg.live.copy()).to(dev),
                    base, seg.capacity))
                triples.append(triple)
                names += [n if n is not None else "" for n in seg.names]
                base += seg.capacity
            self._view = IndexView(self, self._version, self.config,
                                   parts, names, idf, idf_np, num_live,
                                   triples=triples, df_np=df,
                                   total_len=total_len)
            return self._view

    # --- oracle / fallback --------------------------------------------
    def live_rows(self):
        """(token_rows [D_live, L], lengths, names) of the live corpus
        in insertion order. The stored SORTED ids are a valid token
        sequence for a rebuild — sorting a sorted row is the identity,
        so the rebuilt triple equals the stored one bit for bit."""
        with self._lock:
            src = self._segments_locked()
            keep = [np.flatnonzero(s.live[:s.used]) for s in src]
            names = [s.names[r] for s, rows in zip(src, keep) for r in rows]
            if not names:
                return (np.zeros((0, self._length), np.int32),
                        np.zeros((0,), np.int32), [])
            toks = np.concatenate([s.ids[r] for s, r in zip(src, keep)])
            lens = np.concatenate([s.lengths[r] for s, r in zip(src, keep)])
        return toks.astype(np.int32), lens.astype(np.int32), names

    def rebuild_retriever(self) -> TfidfRetriever:
        """A FROM-SCRATCH ``TfidfRetriever`` over the live corpus —
        packed at the same pinned L, built through the retriever's own
        ``_build_index`` (fresh sort, fresh DF, fresh IDF, fresh
        weights): the oracle every view's search equals bit for bit, and
        the full-rebuild fallback."""
        toks, lens, names = self.live_rows()
        if not len(names):
            raise RuntimeError("rebuild_retriever needs >= 1 live doc")
        r = TfidfRetriever(self.config, device=self.device)
        with _on_device(self.device):
            ids, weights, head, idf = _build_index(
                r._to_device(toks), r._to_device(lens), len(names),
                vocab_size=self.config.vocab_size)
        return r._install(ids, weights, head, idf, names, len(names))

    # --- persistence --------------------------------------------------
    def save(self, path: str, epoch: int = 0,
             extra_meta: Optional[dict] = None) -> str:
        """Persist every segment (sealed + delta) as ONE
        ``checkpoint.save_index`` commit (the JAX package's layout). A
        process killed at any instant restores the previous committed
        state."""
        from tfidf_tpu_torch import checkpoint as ckpt
        with self._lock:
            segs = self._sealed + [self._delta]
            arrays: Dict[str, np.ndarray] = {}
            seg_meta = []
            for i, seg in enumerate(segs):
                arrays.update(seg.to_arrays(f"seg{i}_"))
                seg_meta.append({"used": seg.used,
                                 "sealed": seg.sealed,
                                 "seg_id": seg.seg_id})
            meta = {
                "num_docs": self._live_locked(),
                "epoch": int(epoch),
                "config_sha": config_fingerprint(self.config),
                "vocab_size": int(self.config.vocab_size),
                "segmented": {
                    "delta_docs": self.delta_docs,
                    "compact_at": self.compact_at,
                    "length": self._length,
                    "next_seg_id": self._next_seg_id,
                    "segments": seg_meta,
                },
            }
            if extra_meta:
                meta.update(extra_meta)
            return ckpt.save_index(path, arrays, meta)

    @classmethod
    def restore(cls, path: str, config: Optional[PipelineConfig] = None,
                device=None) -> Tuple["SegmentedIndex", dict]:
        """Rebuild a SegmentedIndex from a committed snapshot (either
        package's): ``(index, meta)``. Raises
        ``checkpoint.SnapshotMismatch`` on a config-fingerprint mismatch
        or a non-segmented snapshot."""
        from tfidf_tpu_torch import checkpoint as ckpt
        arrays, meta = ckpt.restore_index(path)
        seg_info = meta.get("segmented")
        if not isinstance(seg_info, dict):
            raise ckpt.SnapshotMismatch(
                "committed snapshot is not a segmented index "
                "(plain retriever snapshot? restore it with "
                "TfidfRetriever.restore)")
        if config is None:
            config = PipelineConfig(
                vocab_mode=VocabMode.HASHED,
                vocab_size=int(meta.get("vocab_size", 1 << 16)),
                max_doc_len=int(seg_info.get("length", 256)))
        want = config_fingerprint(config)
        if meta.get("config_sha") != want:
            raise ckpt.SnapshotMismatch(
                f"snapshot config fingerprint "
                f"{meta.get('config_sha')!r} != running config "
                f"{want!r} — rebuild instead of serving a mismatched "
                f"index")
        idx = cls(config, delta_docs=int(seg_info["delta_docs"]),
                  compact_at=int(seg_info["compact_at"]), device=device)
        segs = [Segment.from_arrays(f"seg{i}_", arrays, sm,
                                    config.vocab_size)
                for i, sm in enumerate(seg_info["segments"])]
        with idx._lock:
            idx._sealed = segs[:-1]
            idx._delta = segs[-1]
            idx._delta.sealed = False
            idx._next_seg_id = int(seg_info.get("next_seg_id",
                                                len(segs)))
            idx._loc = {}
            for seg in segs:
                for row in range(seg.used):
                    if seg.live[row] and seg.names[row] is not None:
                        idx._loc[seg.names[row]] = (seg, row)
            idx._bump_locked()
        return idx, meta
