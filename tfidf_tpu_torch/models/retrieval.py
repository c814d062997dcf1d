"""TF-IDF document retrieval on one device (port of
``tfidf_tpu/models/retrieval.py``'s single-device path).

The indexed corpus is a row-sparse TF-IDF matrix: per document, sorted
term ids, L2-normalized weights and a head mask, [D, L] each. A query
becomes a dense [V] column; a batch of Q queries a [V, Q] block, packed
on the host as compact (query, term, weight) entries (:func:`pack_queries`)
and, through the query slab, built on the device. Search is one sparse x
dense product: the tile-scores kernel
(``ops.kernels.tile_scores``, csrc/tile_scores.cu) scores fixed doc
tiles against the whole block, and a running top-k folds across them
(``ops.sparse.score_topk_tiled``). ``TFIDF_TPU_SCORE_TILING=off`` takes
the untiled path instead (one launch over every row, 64 queries at a
time); both give the same bits.

Scores are cosine similarities in [0, 1] under the default tfidf scorer;
``bm25`` derives its doc face from the stored ids on the device
(:mod:`tfidf_tpu_torch.scoring`). Filters fold into a live mask.

Entry points run on CUDA unless the caller names another device
(``TfidfRetriever(cfg, device="cpu")``, ``restore(path, device="cpu")``);
with no GPU and no device named they raise.

With a docs-only mesh ``plan`` the index lives block-sharded over the
plan's devices: the batch packing grows the corpus to a shard multiple,
each shard sorts and weighs its own rows with the single-device build's
halves (one ``MeshPlan.psum`` of DF between them), and a search runs
``parallel.serving.sharded_search``: per shard the tiled score + top-k
(B6 on every tile), the candidates gathered in shard order and merged.
The JAX package scores such an index with a chunked XLA gather-dot and
``lax.top_k`` per shard; the port scores it as it scores one device, so
a plan's answers equal the single-device search bit for bit. A plan
serves the default scorer only, has no query slab, no fielded index and
no snapshot, as in the JAX package.

Telemetry, as in the JAX package: a search opens a ``fill_query`` span
around the packing, an ``h2d`` span (byte-stamped) around the copy of the
query entries (or, off the slab, of the dense block) to the device and a
``score_tile`` span around the tiled search. The JAX package also reads
the process compile watch around the dispatch, to note a freshly
compiled search program; a search here compiles nothing (no search
shape has a program of its own), so it neither reads the watch nor
notes a compile. The kernel library's build at first GPU use is
reported to the watch by ``ops/_build.py`` itself.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tfidf_tpu_torch import obs
from tfidf_tpu_torch.config import PipelineConfig, VocabMode
from tfidf_tpu_torch.ingest import _HostCopy
from tfidf_tpu_torch.io.corpus import Corpus, discover_corpus, pack_corpus
from tfidf_tpu_torch.io.fast_tokenizer import tokenize_hash_batch
from tfidf_tpu_torch.ops.hashing import words_to_ids
from tfidf_tpu_torch.ops.scoring import idf_from_df
from tfidf_tpu_torch.ops.sparse import (score_tile_rows, score_tiling,
                                        score_topk_tiled, sorted_term_counts,
                                        sparse_df, sparse_scores)
from tfidf_tpu_torch.ops.tokenize import whitespace_tokenize
from tfidf_tpu_torch.ops.topk import segment_score_topk
from tfidf_tpu_torch.pipeline import resolve_device
from tfidf_tpu_torch.scoring.family import (ScorerSpec, avgdl_f32,
                                            bm25_face_trace, doc_lengths_host,
                                            parse_scorer, resolve_scorer)
from tfidf_tpu_torch.scoring.filters import (FilterSpec, filter_mask,
                                             parse_filter)


def _normalize_rows(scores: torch.Tensor) -> torch.Tensor:
    """``scores / max(||row||, 1e-30)``. The norm is taken in float64 and
    rounded once to float32, so the card and the CPU agree bit for bit
    (float32 sums in another order would not); against the JAX package's
    float32 norm the weights differ by at most a few ulp."""
    s64 = scores.to(torch.float64)
    norm = torch.sqrt((s64 * s64).sum(dim=1, keepdim=True)).to(scores.dtype)
    return scores / torch.clamp_min(norm, 1e-30)


def _build_index(token_ids: torch.Tensor, lengths: torch.Tensor,
                 num_docs: int, *, vocab_size: int):
    """Tokens -> (ids, weights, head, idf): L2-normalized row-sparse TF-IDF."""
    ids, counts, head = sorted_term_counts(token_ids, lengths)
    df = sparse_df(ids, head, vocab_size)
    idf = idf_from_df(df, num_docs, torch.float32)
    scores = sparse_scores(ids, counts, head, lengths, idf)
    return ids, _normalize_rows(scores), head, idf


def _build_index_sharded(plan, token_ids: np.ndarray, lengths: np.ndarray,
                         num_docs: int, *, vocab_size: int):
    """:func:`_build_index` over a docs-only mesh: each shard runs its
    halves on its own rows, with the docs psum of DF between them. ->
    ([(ids, weights, head)] per local shard, idf on the first device)."""
    from tfidf_tpu_torch.parallel.collectives import place_batch
    placed = place_batch(plan, token_ids, lengths)
    trips, dfs = [], []
    for d in range(plan.n_local_docs):
        toks, lens = placed.tokens[d, 0, 0], placed.lengths[d, 0, 0]
        ids, counts, head = sorted_term_counts(toks, lens)
        trips.append((ids, counts, head, lens))
        dfs.append(sparse_df(ids, head, vocab_size))
    idf = idf_from_df(plan.psum(dfs), num_docs, torch.float32)
    blocks = []
    for ids, counts, head, lens in trips:
        scores = sparse_scores(ids, counts, head, lens, idf.to(ids.device))
        blocks.append((ids, _normalize_rows(scores), head))
    return blocks, idf


def _finish_index(trip_i, trip_c, trip_h, len_parts, df_acc, num_docs: int):
    """Chunk-ingested triples (``ingest._chunk_step``, the overlapped
    ingest's own chunk step) -> (ids, weights, head, idf): one
    gather-scored normalization against the corpus-wide IDF."""
    ids, counts, head = (torch.cat(p, dim=0) for p in (trip_i, trip_c, trip_h))
    lengths = torch.cat(len_parts, dim=0)
    idf = idf_from_df(df_acc, num_docs, torch.float32)
    scores = sparse_scores(ids, counts, head, lengths, idf)
    return ids, _normalize_rows(scores), head, idf


# The TFIDF_TPU_SCORE_TILING=off path splits query batches at this width,
# as the JAX package's untiled fallback does.
_LEGACY_QUERY_BLOCK = 64

_PLAN_SCORERS = ("plan-sharded TfidfRetriever serves the default scorer "
                 "only — shard non-default scorers via "
                 "MeshShardedRetriever")


class PendingSearch:
    """A dispatched but not yet materialized search.

    :meth:`TfidfRetriever.search_async` has staged the query block,
    issued the search on the device and started the copy of the result
    to the host; :meth:`materialize` waits for it, releases the slab
    slot and applies the same trim/mask tail ``search`` applies, so
    ``search_async(q, k).materialize()`` equals ``search(q, k)`` by
    construction (it IS the synchronous path).

    Device failures surface at ``materialize()``. A handle materializes
    at most once: after a failure a second call raises.
    """

    __slots__ = ("_materialize", "_result")

    def __init__(self, materialize=None, result=None):
        self._materialize = materialize
        self._result = result

    @classmethod
    def resolved(cls, vals, ids) -> "PendingSearch":
        """An already-materialized handle (the legacy block split)."""
        return cls(result=(vals, ids))

    @property
    def done(self) -> bool:
        return self._result is not None

    def materialize(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._result is None:
            fn, self._materialize = self._materialize, None
            if fn is None:
                raise RuntimeError(
                    "PendingSearch already failed to materialize — "
                    "re-dispatch instead of re-reading")
            self._result = fn()
        return self._result


def _query_term_ids(queries: Sequence[Union[str, bytes]],
                    config: PipelineConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Every token's vocab id, the batch's queries end to end, and each
    query's token count: the native tokenize+hash over the whole batch
    when the library loads, else one :func:`words_to_ids` call over
    every word of the batch. Both give the same ids."""
    datas = [q.encode() if isinstance(q, str) else q for q in queries]
    trunc = config.truncate_tokens_at
    vocab, seed = config.vocab_size, config.hash_seed
    # The native clip is off at 0 and below, where a Python slice is not.
    if datas and (trunc is None or trunc > 0):
        native = tokenize_hash_batch(datas, vocab, seed, trunc)
        if native is not None:
            return native
    words = [whitespace_tokenize(d, trunc) for d in datas]
    lens = np.array([len(w) for w in words], np.int64)
    flat = [w for ws in words for w in ws]
    if not flat:
        return np.zeros(0, np.int32), lens
    return words_to_ids(flat, vocab, seed), lens


def pack_queries(queries: Sequence[Union[str, bytes]],
                 config: PipelineConfig, idf: np.ndarray,
                 mode: str = "cosine",
                 scratch: Optional[np.ndarray] = None
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The batch's query block as a compact list: ``(cols int32, ids
    int32, weights float32)``, one entry per distinct term of a query,
    by column and then by term id. Scattered into a zero [V, Q] block
    (``block[ids, cols] = weights``) it is the dense fill bit for bit.

    The one query-packing implementation: :func:`fill_query_matrix`
    scatters it on the host, the query slab on the device.
    ``mode="counts"`` (bm25): exact float32 term counts (``idf`` is
    ignored). ``mode="cosine"`` (tfidf): the counts ``/ len(words)``,
    ``* idf``, then ``/`` the column's L2 norm: the squares are laid in
    the zeroed ``[V]`` float32 ``scratch`` and summed whole, so the sum
    runs in the order a dense column's would (idf >= 0, as log(N/df)
    is). A column whose norm is 0 keeps its entries at weight 0; an
    empty query has none.
    """
    if mode not in ("cosine", "counts"):
        raise ValueError(f"unknown query mode {mode!r}")
    vocab = config.vocab_size
    ids, lens = _query_term_ids(queries, config)
    if not len(ids):
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.float32))
    col_of = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
    keys, counts = np.unique(col_of * vocab + ids, return_counts=True)
    cols = (keys // vocab).astype(np.int32)
    ids = (keys - cols.astype(np.int64) * vocab).astype(np.int32)
    # Integers < 2^24 are exact in float32.
    weights = counts.astype(np.float32)
    if mode == "counts":
        return cols, ids, weights
    weights /= lens[cols].astype(np.float32)
    weights *= np.asarray(idf)[ids]
    if scratch is None:
        scratch = np.zeros((vocab,), np.float32)
    else:
        scratch.fill(0.0)
    bounds = np.searchsorted(cols, np.arange(len(lens) + 1))
    for s, e in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        if s == e:
            continue
        w, at = weights[s:e], ids[s:e]
        scratch[at] = w * w
        norm = float(np.sqrt(scratch.sum()))
        scratch[at] = 0.0
        if norm > 0:
            w /= norm
        else:
            w.fill(0.0)
    return cols, ids, weights


def fill_query_matrix(queries: Sequence[Union[str, bytes]],
                      config: PipelineConfig, idf: np.ndarray,
                      out: np.ndarray,
                      scratch: Optional[np.ndarray] = None,
                      mode: str = "cosine") -> np.ndarray:
    """Pack queries into the [V, Q] query block ``out`` IN PLACE: the
    host scatter of :func:`pack_queries` (``mode`` as there). A zero
    column scores 0 against every document."""
    cols, ids, weights = pack_queries(queries, config, idf, mode, scratch)
    out.fill(0.0)
    out[ids, cols] = weights
    return out


def query_matrix(queries: Sequence[Union[str, bytes]],
                 config: PipelineConfig, idf: np.ndarray,
                 pad_to: Optional[int] = None,
                 mode: str = "cosine") -> np.ndarray:
    """Host packing of queries into a dense float32 [V, Q] block (cosine
    columns by default; ``mode="counts"`` for bm25). ``pad_to`` widens
    it with zero columns (query-count bucketing)."""
    q = np.empty((config.vocab_size, pad_to or len(queries)), np.float32)
    return fill_query_matrix(queries, config, idf, q, mode=mode)


def config_fingerprint(cfg: PipelineConfig) -> str:
    """Stable hash over the config fields that determine index bytes and
    query packing: the compatibility contract between a snapshot and the
    process restoring it. It equals the JAX package's for equal configs,
    so snapshots cross between the packages."""
    ident = {
        "vocab_mode": cfg.vocab_mode.value,
        "vocab_size": cfg.vocab_size,
        "hash_seed": cfg.hash_seed,
        "tokenizer": cfg.tokenizer.value,
        "ngram_range": list(cfg.ngram_range),
        "chargram_on_device": cfg.chargram_on_device,
        "truncate_tokens_at": cfg.truncate_tokens_at,
        "max_doc_len": cfg.max_doc_len,
        "doc_chunk": cfg.doc_chunk,
        "score_dtype": cfg.score_dtype,
    }
    return hashlib.sha256(
        json.dumps(ident, sort_keys=True).encode()).hexdigest()[:16]


class TfidfRetriever:
    """Index a corpus once, answer ranked queries from the device.

    Args:
      config: HASHED-vocab pipeline config (default 2^16 vocab).
      plan: optional docs-only :class:`~tfidf_tpu_torch.parallel.MeshPlan`;
        the index then lives block-sharded over its devices (see the
        module docstring).
      scorer: the index-default scorer (explicit > ``TFIDF_TPU_SCORER``
        > tfidf).
      device: CUDA unless named; raises without a GPU and no device.
        Under a plan, the plan's first device.
    """

    def __init__(self, config: Optional[PipelineConfig] = None,
                 plan=None, scorer=None, device=None):
        self.config = config or PipelineConfig(vocab_mode=VocabMode.HASHED)
        if self.config.vocab_mode is not VocabMode.HASHED:
            raise ValueError("TfidfRetriever requires HASHED vocab")
        if plan is not None and (plan.n_vocab_shards != 1
                                 or plan.n_seq_shards != 1):
            raise ValueError("retrieval shards the docs axis only")
        self.device = (plan.devices[0] if plan is not None
                       else resolve_device(device))
        self.plan = plan
        # Under a plan: [(ids, weights, head)] per local docs shard.
        self._blocks: Optional[list] = None
        self.scorer: ScorerSpec = resolve_scorer(scorer)
        # Per-scorer faces and per-filter live masks; both are dropped
        # on every index install.
        self._faces: dict = {}
        self._filters: dict = {}
        # [(name, weight, start, stop)] slot spans of a fielded index.
        self._fields: Optional[List[Tuple[str, float, int, int]]] = None
        self.names: List[str] = []
        self._idf: Optional[torch.Tensor] = None
        self._ids = self._weights = self._head = None
        self._num_docs = 0
        # The query slab: tri-state knob (None = env), the lazily built
        # slab, its ring depth, and the host IDF the slab fill reads.
        self.query_slab: Optional[bool] = None
        self.slab_depth: int = 1
        self._slab = None
        self._idf_np: Optional[np.ndarray] = None
        self._idf_src = None

    def _install(self, ids, weights, head, idf, names, num_docs: int,
                 fields=None, blocks=None) -> "TfidfRetriever":
        self._ids, self._weights, self._head = ids, weights, head
        self._blocks = blocks
        self._idf = idf
        self.names = list(names)
        self._num_docs = int(num_docs)
        self._faces.clear()
        self._filters.clear()
        self._fields = fields
        return self

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on this retriever's device (a read-only array,
        such as a JAX array's view, is copied first)."""
        arr = np.require(arr, requirements=["C", "W"])
        return torch.from_numpy(arr).to(self.device)

    # --- indexing ---
    def index(self, corpus: Corpus) -> "TfidfRetriever":
        cfg = self.config
        if self.plan is not None:
            batch = pack_corpus(corpus, cfg,
                                pad_docs_to=self.plan.pad_docs(len(corpus)),
                                want_words=False)
            blocks, idf = _build_index_sharded(
                self.plan, batch.token_ids, batch.lengths, len(corpus),
                vocab_size=cfg.vocab_size)
            return self._install(None, None, None, idf, corpus.names,
                                 len(corpus), blocks=blocks)
        batch = pack_corpus(corpus, cfg, want_words=False)
        toks = self._to_device(batch.token_ids.astype(np.int32, copy=False))
        lens = self._to_device(batch.lengths)
        ids, weights, head, idf = _build_index(
            toks, lens, len(corpus), vocab_size=cfg.vocab_size)
        return self._install(ids, weights, head, idf, corpus.names,
                             len(corpus))

    def index_dir(self, input_dir: str, strict: bool = True,
                  doc_len: Optional[int] = None,
                  chunk_docs: int = 8192) -> "TfidfRetriever":
        """Index a directory. ``doc_len`` opts into the overlapped
        ingest's chunk step (native loader, ragged uint16 wire rebuilt
        on the device by the ragged-rebuild kernel; the packer thread
        reads chunk i+1 while the device sorts chunk i); documents longer
        than ``doc_len`` tokens are truncated. Default (None) packs the
        whole corpus in one batch with L grown to the longest doc; a
        mesh plan always takes it (its placement is the batch's)."""
        if doc_len is None or self.plan is not None:
            return self.index(discover_corpus(input_dir, strict))
        from tfidf_tpu_torch.ingest import (_chunk_step, _PackAhead,
                                            _resident_chunking, _upload,
                                            make_chunk_packer,
                                            make_flat_packer)
        from tfidf_tpu_torch.io.corpus import discover_names

        cfg = self.config
        dev = self.device
        names = discover_names(input_dir, strict)
        if not names:
            raise ValueError(f"no documents in {input_dir}")
        num_docs = len(names)
        chunk_docs, starts = _resident_chunking(num_docs, chunk_docs)
        ragged = cfg.vocab_size <= (1 << 16)
        pack = (make_flat_packer(input_dir, cfg, chunk_docs, doc_len)
                if ragged
                else make_chunk_packer(input_dir, cfg, chunk_docs, doc_len))
        df_acc = torch.zeros(cfg.vocab_size, dtype=torch.int32, device=dev)
        trip_i, trip_c, trip_h, len_parts = [], [], [], []
        with _PackAhead(pack, [names[s:s + chunk_docs] for s in starts],
                        supervised=False) as packer:
            for ci in range(len(starts)):
                packed = packer.get(ci)
                lens = _upload(packed[1], dev)
                i_, c_, h_, df_acc = _chunk_step(
                    _upload(packed[0], dev), lens, df_acc, cfg, doc_len,
                    ragged=ragged)
                trip_i.append(i_)
                trip_c.append(c_)
                trip_h.append(h_)
                len_parts.append(lens)
        ids, weights, head, idf = _finish_index(
            trip_i, trip_c, trip_h, len_parts, df_acc, num_docs)
        # Only the last chunk carries padding rows; real docs occupy rows
        # [0, num_docs), so the tail-padding search guard holds.
        return self._install(ids, weights, head, idf, names, num_docs)

    def index_fields(self, fields) -> "TfidfRetriever":
        """Fielded indexing: ``fields`` is a sequence of ``(name, corpus,
        weight)``, the same documents tokenized per field, every corpus
        row-aligned (same length, same names). Each field builds its own
        sub-index and the sub-indexes stack along the slot axis, tfidf
        weights pre-scaled by the field weight, so one row's dot IS the
        weighted sum over fields. Query columns use the union IDF
        (N = n_fields * D). The bm25 face derives per field slice."""
        if self.plan is not None:
            raise ValueError("fielded indexes are single-device (wrap in "
                             "MeshShardedRetriever to shard)")
        fields = list(fields)
        if not fields:
            raise ValueError(
                "index_fields needs at least one (name, corpus, weight)")
        cfg = self.config
        names: Optional[List[str]] = None
        num_docs = 0
        spans: List[Tuple[str, float, int, int]] = []
        ids_parts, w_parts, h_parts = [], [], []
        df_total = None
        start = 0
        for fname, corpus, weight in fields:
            if names is None:
                num_docs = len(corpus)
                names = list(corpus.names)
            elif len(corpus) != num_docs or list(corpus.names) != names:
                raise ValueError(
                    f"field {fname!r} is not row-aligned with "
                    f"{fields[0][0]!r} (same docs, same order)")
            batch = pack_corpus(corpus, cfg, want_words=False)
            ids, weights, head, _ = _build_index(
                self._to_device(batch.token_ids.astype(np.int32, copy=False)),
                self._to_device(batch.lengths), num_docs,
                vocab_size=cfg.vocab_size)
            df_f = sparse_df(ids, head, cfg.vocab_size)
            df_total = df_f if df_total is None else df_total + df_f
            ids_parts.append(ids)
            w_parts.append(weights * torch.tensor(np.float32(weight),
                                                  device=self.device))
            h_parts.append(head)
            stop = start + int(ids.shape[1])
            spans.append((str(fname), float(weight), start, stop))
            start = stop
        idf = idf_from_df(df_total, len(fields) * num_docs, torch.float32)
        return self._install(torch.cat(ids_parts, dim=1),
                             torch.cat(w_parts, dim=1),
                             torch.cat(h_parts, dim=1), idf, names, num_docs,
                             fields=spans)

    @property
    def indexed(self) -> bool:
        return self._num_docs > 0

    def index_arrays(self) -> list:
        """The index's device tensors (every shard's under a plan), for
        the device monitor's census."""
        if self._blocks is not None:
            return [self._idf] + [t for b in self._blocks for t in b]
        return [self._ids, self._weights, self._head, self._idf]

    # --- snapshot / restore ---
    def snapshot(self, path: str, epoch: int = 0,
                 extra_meta: Optional[dict] = None) -> str:
        """Persist the built index (row-sparse triples + IDF + names)
        under the checkpoint root ``path`` (``checkpoint.save_index``,
        the JAX package's format): :meth:`restore` in either package
        rebuilds this retriever without the corpus."""
        from tfidf_tpu_torch import checkpoint as ckpt
        if not self.indexed:
            raise RuntimeError("index() a corpus before snapshot()")
        if self.plan is not None:
            raise ValueError("snapshot() supports single-device indexes "
                             "only")
        # Doc names ride as one NUL-joined uint8 blob (filenames cannot
        # contain NUL).
        blob = np.frombuffer(
            "\x00".join(self.names).encode("utf-8"), dtype=np.uint8)
        arrays = {
            "ids": self._ids.cpu().numpy(),
            "weights": self._weights.cpu().numpy(),
            "head": self._head.cpu().numpy(),
            "idf": self._idf.cpu().numpy(),
            "names_blob": blob,
        }
        meta = {
            "num_docs": int(self._num_docs),
            "epoch": int(epoch),
            "config_sha": config_fingerprint(self.config),
            "vocab_size": int(self.config.vocab_size),
        }
        # A non-default scorer and a fielded index's slot spans ride the
        # meta dict; the default tfidf index writes nothing extra.
        if not self.scorer.is_default:
            meta["scorer"] = self.scorer.key()
        if self._fields is not None:
            meta["fields"] = [[f, w, s, e] for f, w, s, e in self._fields]
        if extra_meta:
            meta.update(extra_meta)
        return ckpt.save_index(path, arrays, meta)

    @classmethod
    def restore(cls, path: str, config: Optional[PipelineConfig] = None,
                device=None) -> Tuple["TfidfRetriever", dict]:
        """Rebuild a retriever from a committed snapshot (either
        package's): ``(retriever, meta)``. The snapshot's config
        fingerprint must match ``config`` (default HASHED at the
        snapshot's vocab size), else ``checkpoint.SnapshotMismatch``."""
        from tfidf_tpu_torch import checkpoint as ckpt
        arrays, meta = ckpt.restore_index(path)
        if config is None:
            config = PipelineConfig(
                vocab_mode=VocabMode.HASHED,
                vocab_size=int(meta.get("vocab_size", 1 << 16)))
        want = config_fingerprint(config)
        got = meta.get("config_sha")
        if got != want:
            raise ckpt.SnapshotMismatch(
                f"snapshot config fingerprint {got!r} != running "
                f"config {want!r} — rebuild instead of serving a "
                f"mismatched index")
        r = cls(config, device=device)
        blob = arrays["names_blob"]
        names = (bytes(blob.tobytes()).decode("utf-8").split("\x00")
                 if blob.size else [])
        num_docs = int(meta["num_docs"])
        if len(names) != num_docs:
            raise ckpt.SnapshotMismatch(
                f"snapshot names ({len(names)}) != num_docs ({num_docs})")
        fields = meta.get("fields")
        r._install(r._to_device(arrays["ids"]),
                   r._to_device(arrays["weights"]),
                   r._to_device(arrays["head"]),
                   r._to_device(arrays["idf"]), names, num_docs,
                   fields=[(str(f), float(w), int(s), int(e))
                           for f, w, s, e in fields] if fields else None)
        r.scorer = parse_scorer(meta.get("scorer"))
        return r, meta

    # --- querying ---
    def _query_matrix(self, queries: Sequence[Union[str, bytes]],
                      pad_to: Optional[int] = None,
                      mode: str = "cosine") -> np.ndarray:
        """:func:`query_matrix` over this retriever's config and IDF."""
        with obs.span("fill_query", queries=pad_to or len(queries),
                      mode=mode):
            return query_matrix(queries, self.config, self._idf_host(),
                                pad_to=pad_to, mode=mode)

    def _idf_host(self) -> np.ndarray:
        """Host copy of the IDF vector, cached per installed index: the
        slab fill must not pay a device round trip per search."""
        idf = self._idf
        if self._idf_np is None or self._idf_src is not idf:
            self._idf_np = idf.cpu().numpy()
            self._idf_src = idf
        return self._idf_np

    def _resolve_slab(self):
        """The query slab serving this retriever, or None when it is off."""
        from tfidf_tpu_torch.ops.queryslab import QuerySlab, use_query_slab
        if not use_query_slab(self.query_slab):
            return None
        if (self._slab is None
                or self._slab.vocab_size != self.config.vocab_size):
            # Ring ceiling = the serve batch ceiling; rings allocate
            # lazily per bucket actually seen.
            cap = max(1, int(os.environ.get("TFIDF_TPU_MAX_BATCH",
                                            "256") or "256"))
            self._slab = QuerySlab(self.config.vocab_size, max_bucket=cap,
                                   min_depth=max(1, self.slab_depth),
                                   device=self.device)
        elif self._slab.min_depth < self.slab_depth:
            self._slab.reserve(self.slab_depth)
        return self._slab

    def search(self, queries: Sequence[Union[str, bytes]], k: int = 10,
               *, scorer=None, filter=None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Ranked retrieval: (scores, doc_indices), each [Q, k'] with
        k' = min(k, num_docs). ``doc_indices`` index into :attr:`names`;
        -1 marks padding when fewer than k documents score. ``scorer``
        selects a family member for this call (``"bm25"``,
        ``"bm25:k1=1.5,b=0.6"``, a dict, a :class:`ScorerSpec`) and
        ``filter`` restricts the candidates (:mod:`scoring.filters`).
        It is :meth:`search_async` plus an immediate materialization."""
        return self.search_async(queries, k, scorer=scorer,
                                 filter=filter).materialize()

    def _scorer_face(self, spec: ScorerSpec):
        """The ``(data, cols)`` doc face of one scorer, cached per
        :meth:`ScorerSpec.key` until the next index install: tfidf is
        the stored weights and ids where ``head`` (0 elsewhere); bm25 is
        re-derived on the device from ``(ids, head)``
        (``scoring.family.bm25_face_trace``), per field slice when the
        index is fielded."""
        if self.plan is not None:
            raise ValueError(_PLAN_SCORERS)
        key = spec.key()
        face = self._faces.get(key)
        if face is not None:
            return face
        vocab = self.config.vocab_size
        n = self._num_docs
        k1, b = np.float32(spec.k1), np.float32(spec.b)
        if spec.kind == "tfidf":
            face = (torch.where(self._head, self._weights, 0.0),
                    torch.where(self._head, self._ids, 0).to(torch.int32))
        elif self._fields is None:
            lens = doc_lengths_host(self._ids)
            avgdl = avgdl_f32(int(lens[:n].sum()), n)
            face = bm25_face_trace(self._ids, self._head, n, avgdl, k1, b,
                                   vocab_size=vocab)
        else:
            # per field slice: its own df and avgdl, scaled by its weight
            data_parts, cols_parts = [], []
            for _fname, weight, start, stop in self._fields:
                ids_f = self._ids[:, start:stop].contiguous()
                head_f = self._head[:, start:stop].contiguous()
                lens = doc_lengths_host(ids_f)
                avgdl = avgdl_f32(int(lens[:n].sum()), n)
                d, c = bm25_face_trace(ids_f, head_f, n, avgdl, k1, b,
                                       vocab_size=vocab)
                data_parts.append(d * torch.tensor(np.float32(weight),
                                                   device=d.device))
                cols_parts.append(c)
            face = (torch.cat(data_parts, dim=1), torch.cat(cols_parts, dim=1))
        self._faces[key] = face
        return face

    def scorer_face(self, spec=None) -> Tuple[np.ndarray, np.ndarray]:
        """Host copy of a scorer's ``(data, cols)`` face, derived by the
        same code the search consumes."""
        spec = self.scorer if spec is None else parse_scorer(spec)
        data, cols = self._scorer_face(spec)
        return data.cpu().numpy(), cols.cpu().numpy()

    def _filter_live(self, fspec: Optional[FilterSpec]):
        """Device live mask of one filter AND the real-rows guard, cached
        per canonical filter key; no filter -> None."""
        if fspec is None:
            return None
        key = fspec.key()
        live = self._filters.get(key)
        if live is None:
            host = np.zeros((int(self._ids.shape[0]),), bool)
            host[:self._num_docs] = filter_mask(
                fspec, self._num_docs, names=self.names)
            live = self._to_device(host)
            self._filters[key] = live
        return live

    def _shard_faces(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Under a plan: each shard's default ``(data, cols)`` face, the
        single-device tfidf face's two ops on its rows, cached until the
        next index install."""
        faces = self._faces.get("shards")
        if faces is None:
            faces = [(torch.where(head, weights, 0.0),
                      torch.where(head, ids, 0).to(torch.int32))
                     for ids, weights, head in self._blocks]
            self._faces["shards"] = faces
        return faces

    def _shard_live(self) -> List[torch.Tensor]:
        """Under a plan: each shard's rows that hold documents (the batch
        grows the corpus to a shard multiple with empty rows)."""
        live = self._filters.get("shards")
        if live is None:
            plan = self.plan
            live = []
            for d, (ids, _, _) in enumerate(self._blocks):
                rows = int(ids.shape[0])
                first = (plan.first_docs_shard + d) * rows
                live.append(torch.arange(first, first + rows,
                                         device=ids.device) < self._num_docs)
            self._filters["shards"] = live
        return live

    def _real_rows(self) -> torch.Tensor:
        """The live mask of the rows that hold documents (an ingested
        index pads its last chunk), cached under the empty filter key."""
        live = self._filters.get("")
        if live is None:
            live = self._to_device(
                np.arange(int(self._ids.shape[0])) < self._num_docs)
            self._filters[""] = live
        return live

    def _stage_queries(self, queries: Sequence[Union[str, bytes]],
                       bucket: int, mode: str):
        """The [V, bucket] query block on the device, and the callable
        that releases its staging slot. With the slab on, the batch is
        packed as compact entries into a reused (pinned, on CUDA) slot,
        uploaded by exactly one non-blocking copy on the current stream
        and built into the slot's device block there; the slot must be
        released only once the search's result is on the host. Past the
        slab's rings, or with it off, the dense block is allocated."""
        slab = self._resolve_slab()
        if slab is None or bucket > slab.max_bucket:
            if slab is not None:
                slab.note_fallback()
            qmat = self._query_matrix(queries, pad_to=bucket, mode=mode)
            return self._to_device(qmat), lambda: None
        slot, key = slab.checkout(bucket)
        try:
            with obs.span("fill_query", queries=bucket, mode=mode):
                cols, ids, weights = pack_queries(
                    queries, self.config, self._idf_host(), mode,
                    slot.scratch)
                nbytes = slab.stage(slot, cols, ids, weights)
            with obs.span("h2d", bytes=nbytes, entries=len(ids)):
                slot.upload(nbytes)
            qmat = slot.build(len(ids))
        except BaseException:
            slab.release(key)
            raise
        slab.note_h2d(nbytes, len(ids))
        return qmat, lambda: slab.release(key)

    def _dispatch(self, queries, k: int, spec: ScorerSpec,
                  fspec: Optional[FilterSpec], bucket: int, tiled: bool):
        """The single-device search's device stage: stage the query block,
        score (tiled, or untiled) and start the result's copy to the
        host. -> (vals copy, ids copy, release of the staging slot)."""
        kk = min(k, int(self._ids.shape[0]))
        data, cols = self._scorer_face(spec)
        live = self._filter_live(fspec)
        # The JAX package reads the compile watch here and notes a fresh
        # search program (note_compile). No search compiles a program,
        # so neither has a counterpart: a first-use build of the kernel
        # library is reported to the watch by ops/_build.py.
        qmat, release = self._stage_queries(
            queries, bucket, "counts" if spec.kind == "bm25" else "cosine")
        try:
            if tiled:
                rows = int(data.shape[0])
                with obs.span("score_tile",
                              tiles=-(-rows // score_tile_rows(rows)),
                              rows=rows, queries=int(bucket)):
                    vals, idx = score_topk_tiled(data, cols, live, qmat, kk)
            else:
                vals, idx = segment_score_topk(
                    data, cols, self._real_rows() if live is None else live,
                    qmat, kk)
            return _HostCopy(vals), _HostCopy(idx), release
        except BaseException:
            release()  # nothing in flight
            raise

    def search_async(self, queries: Sequence[Union[str, bytes]],
                     k: int = 10, *, scorer=None,
                     filter=None) -> "PendingSearch":
        """Dispatch stage of :meth:`search`: stage the query block, issue
        the search, start the copy of the result to the host, and return
        without waiting. ``materialize()`` on the returned
        :class:`PendingSearch` waits for it, releases the query slot
        (slot release stays keyed to the result: the reuse guard) and
        applies the trim/mask tail. Every scorer and filter takes this
        one body: the scorer picks the face and the query columns (raw
        counts for bm25), the filter the live mask. The legacy >64-query
        split of the untiled path returns an already-resolved handle."""
        if not self.indexed:
            raise RuntimeError("index() a corpus before search()")
        spec = self.scorer if scorer is None else parse_scorer(scorer)
        fspec = parse_filter(filter)
        if self.plan is not None and not (spec.is_default and fspec is None):
            raise ValueError(_PLAN_SCORERS)
        nq = len(queries)
        tiled = score_tiling()
        if not tiled and self.plan is None and nq > _LEGACY_QUERY_BLOCK:
            parts = [self.search(queries[s:s + _LEGACY_QUERY_BLOCK], k,
                                 scorer=spec, filter=fspec)
                     for s in range(0, nq, _LEGACY_QUERY_BLOCK)]
            return PendingSearch.resolved(
                np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))
        # Query-count bucketing: Q pads to the next power of two; the
        # zero columns score 0 everywhere and their rows are dropped.
        bucket = 1 << max(0, nq - 1).bit_length()
        if self.plan is not None:
            # No query slab under a plan (the JAX package's mesh search
            # packs a fresh block): one upload per shard device.
            from tfidf_tpu_torch.parallel.serving import sharded_search
            faces = self._shard_faces()
            vals, idx = sharded_search(
                self.plan, [f[0] for f in faces], [f[1] for f in faces],
                self._shard_live(), self._query_matrix(queries, pad_to=bucket),
                k)
            host_v, host_i, release = (_HostCopy(vals), _HostCopy(idx),
                                       lambda: None)
        else:
            host_v, host_i, release = self._dispatch(queries, k, spec, fspec,
                                                     bucket, tiled)
        # num_docs is read now, so an index install racing the
        # materialization cannot skew this batch's trim and mask.
        num_docs = self._num_docs
        width = min(k, num_docs)

        def materialize():
            try:
                v = host_v.result()[:nq, :width]
                i = host_i.result()[:nq, :width]
            finally:
                release()
            ok = (v > 0) & (i < num_docs)
            return np.where(ok, v, 0.0), np.where(ok, i, -1)

        return PendingSearch(materialize)
