"""End-to-end TF-IDF pipeline on one device (port of
``tfidf_tpu/pipeline.py``'s single-device path).

``TfidfPipeline(config).run(corpus)`` packs the corpus on the host,
places the [D, L] batch on the device and runs one of two engines:

* sparse (the hashed-vocab default): sort+RLE triples, DF, IDF, then
  per-doc score+top-k through the fused kernel (``ops.sparse``);
* dense (the golden EXACT engine): TF/DF histograms through the TF/DF
  kernel, dense tf*idf, optional top-k (:func:`_forward`).

Top-k selections leave the device as packed uint32 words (the pack
kernel) when the word can carry the run. Integer outputs (counts, DF,
lengths) come back exact, and the host formatter makes ``output.txt``
byte-identical to the reference.

``run_packed`` takes the padded :class:`PackedBatch` or the ragged
:class:`RaggedBatch`, whose flat id stream is rebuilt into the padded
batch on the device by the ragged-rebuild kernel.

``run_bytes`` is the device chargram (a CHARGRAM hashed top-k config's
route through ``run``): raw document bytes go to the device, which
hashes every n-gram window in one sweep (``ops.hashing``), then either
the dense engine (a masked scatter histogram, dense tf*idf, a stable
sort for the top-k) or the sparse one (sort+RLE triples of the masked
streams, the fused score+top-k kernel) runs, as the JAX package lowers
it.

The pipeline runs on CUDA unless the caller names another device; with
no GPU and no device named it raises instead of running on the CPU.
A ``config.mesh_shape`` dispatches the run onto a device mesh of that
device kind: ``parallel.sharded.ShardedPipeline`` for the packed paths,
the docs-sharded device chargram for ``run_bytes``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from tfidf_tpu_torch.config import PipelineConfig, TokenizerKind, VocabMode
from tfidf_tpu_torch.formatter import (format_records, format_sparse_records,
                                       to_output_bytes)
from tfidf_tpu_torch.io.corpus import (Batch, Corpus, PackedBatch,
                                       RaggedBatch, pack_bytes, pack_corpus)
from tfidf_tpu_torch.ops.downlink import (unpack_result_words,
                                          use_packed_result_wire)
from tfidf_tpu_torch.ops.hashing import device_ngram_ids_multi
from tfidf_tpu_torch.ops.histogram import df_from_counts, tf_counts_masked
from tfidf_tpu_torch.ops.kernels import pack_words, ragged_rebuild, tf_df
from tfidf_tpu_torch.ops.scoring import (canonical_score_dtype, idf_from_df,
                                         tfidf_dense)
from tfidf_tpu_torch.ops.sparse import (score_topk, sorted_term_counts_masked,
                                        sparse_df, sparse_forward)
from tfidf_tpu_torch.ops.topk import topk_per_doc
from tfidf_tpu_torch.utils.timing import PhaseTimedMixin, PhaseTimer


def resolve_device(device=None) -> torch.device:
    """The device a run uses: ``device`` when given, else CUDA. Raises
    when CUDA is asked for (explicitly or by default) and absent."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        hint = "" if device is not None else "; pass device='cpu' to run on the CPU"
        raise RuntimeError(f"no CUDA device available{hint}")
    return dev


@dataclasses.dataclass
class PipelineResult:
    """Integer-exact pipeline outputs (host numpy arrays).

    counts/lengths/df are exact ints — the inputs to byte-parity host
    formatting. scores is the dense float matrix (None for top-k runs
    and for the sparse engine); topk_vals/topk_ids hold the per-doc
    top-k when configured; sparse_ids/counts/head are the sparse
    engine's [D, L] triples on full-output runs.
    """

    counts: Optional[np.ndarray]
    lengths: np.ndarray
    df: np.ndarray
    num_docs: int
    names: List[str]
    id_to_word: Dict[int, bytes]
    scores: Optional[np.ndarray] = None
    topk_vals: Optional[np.ndarray] = None
    topk_ids: Optional[np.ndarray] = None
    sparse_ids: Optional[np.ndarray] = None
    sparse_counts: Optional[np.ndarray] = None
    sparse_head: Optional[np.ndarray] = None

    def output_lines(self) -> List[bytes]:
        """Reference-format lines (document@word\\t%.16f, strcmp order)."""
        if self.counts is not None:
            return format_records(self.counts, self.lengths, self.df,
                                  self.num_docs, self.names, self.id_to_word)
        if self.sparse_head is not None:
            return format_sparse_records(
                self.sparse_ids, self.sparse_counts, self.sparse_head,
                self.lengths, self.df, self.num_docs, self.names,
                self.id_to_word)
        raise ValueError(
            "full output lines need dense counts or row-sparse triples; "
            "this was a topk-only run (term data stays on device)")

    def output_bytes(self) -> bytes:
        return to_output_bytes(self.output_lines())


def place_batch(batch: Batch, device: torch.device):
    """Device placement of either wire -> (token_ids [D, L], lengths [D]).
    A PackedBatch ships the padded [D, L] ids; a RaggedBatch ships its
    flat aligned stream (bytes scale with real tokens) and the padded
    batch is rebuilt on the device (``ops.kernels.ragged_rebuild``)."""
    if not isinstance(batch, (PackedBatch, RaggedBatch)):
        raise TypeError(f"{type(batch).__name__} input: run_packed takes "
                        f"a PackedBatch or a RaggedBatch")
    lens = torch.from_numpy(
        np.asarray(batch.lengths, dtype=np.int32)).to(device)
    if isinstance(batch, RaggedBatch):
        flat = torch.from_numpy(np.ascontiguousarray(batch.flat))
        return ragged_rebuild(flat.to(device), lens, length=batch.length,
                              align=batch.align), lens
    # uint16 wire ids widen here; a sliced batch becomes contiguous
    toks = np.ascontiguousarray(batch.token_ids, dtype=np.int32)
    return torch.from_numpy(toks).to(device), lens


def _forward(token_ids: torch.Tensor, lengths: torch.Tensor, num_docs: int, *,
             vocab_size: int, score_dtype, topk: Optional[int]):
    """Dense engine: tokens -> (counts, df, scores), or (df, vals, ids)
    with ``topk``. The TF/DF kernel takes any L in one launch, so the
    JAX package's chunked-histogram branch has no counterpart here."""
    counts, df = tf_df(token_ids, lengths, vocab_size=vocab_size)
    scores = tfidf_dense(counts, lengths, df, num_docs, score_dtype)
    if topk is not None:
        tv, ti = topk_per_doc(scores, min(topk, vocab_size))
        return df, tv, ti
    return counts, df, scores


def _ngram_streams(byte_ids: torch.Tensor, byte_lengths: torch.Tensor, *,
                   vocab_size: int, ngram_lo: int, ngram_hi: int, seed: int):
    """Every n's window ids of one Horner sweep, concatenated along the
    token axis with their validity (windows never span documents, and
    DF, TF and top-k only count), and docSize, the total n-gram count
    ``sum_n max(len - (n - 1), 0)``."""
    streams = device_ngram_ids_multi(byte_ids, byte_lengths, ngram_lo,
                                     ngram_hi, vocab_size, seed)
    total_len = sum(torch.clamp_min(byte_lengths - (n - 1), 0)
                    for n in range(ngram_lo, ngram_hi + 1)).to(torch.int32)
    return (torch.cat([i for i, _ in streams], dim=1),
            torch.cat([v for _, v in streams], dim=1), total_len)


def _chargram_dense_local(byte_ids, byte_lengths, *, vocab_size: int,
                          ngram_lo: int, ngram_hi: int, seed: int):
    """The dense chargram's shard-local half: raw bytes -> ((counts,
    docSize), local df). The TF histogram is one masked scatter over
    every n's stream (the JAX package's XLA scatter, not the TF/DF
    kernel)."""
    ids, valid, total_len = _ngram_streams(
        byte_ids, byte_lengths, vocab_size=vocab_size, ngram_lo=ngram_lo,
        ngram_hi=ngram_hi, seed=seed)
    counts = tf_counts_masked(ids, valid, vocab_size)
    return (counts, total_len), df_from_counts(counts)


def _chargram_dense_finish(state, df, num_docs: int, *, vocab_size: int,
                           score_dtype, topk: Optional[int]):
    """The dense chargram's second half against the (reduced) ``df``:
    (df, docSize, vals, ids) with ``topk``, else (counts, df, docSize,
    scores)."""
    counts, total_len = state
    scores = tfidf_dense(counts, total_len, df, num_docs, score_dtype)
    if topk is not None:
        tv, ti = topk_per_doc(scores, min(topk, vocab_size))
        return df, total_len, tv, ti
    return counts, df, total_len, scores


def _chargram_sparse_local(byte_ids, byte_lengths, *, vocab_size: int,
                           ngram_lo: int, ngram_hi: int, seed: int):
    """The row-sparse chargram's shard-local half: sort+RLE triples of
    the masked streams -> ((ids, counts, head, docSize), local df)."""
    ids, valid, total_len = _ngram_streams(
        byte_ids, byte_lengths, vocab_size=vocab_size, ngram_lo=ngram_lo,
        ngram_hi=ngram_hi, seed=seed)
    s_ids, counts, head = sorted_term_counts_masked(ids, valid)
    return (s_ids, counts, head, total_len), sparse_df(s_ids, head,
                                                       vocab_size)


def _chargram_sparse_finish(state, df, num_docs: int, *, vocab_size: int,
                            score_dtype, topk: int):
    """The row-sparse chargram's second half: the fused score+top-k
    kernel against the (reduced) ``df`` -> (df, docSize, vals, ids)."""
    s_ids, counts, head, total_len = state
    idf = idf_from_df(df, num_docs, score_dtype)
    tv, ti = score_topk(s_ids, counts, head, total_len, idf, topk)
    return df, total_len, tv, ti


#: engine -> (shard-local half, finish): the single-device forwards
#: below and the docs-sharded chargram (``parallel.collectives``) run
#: the same two halves, the mesh with the docs-axis DF sum between.
CHARGRAM_STAGES = {"dense": (_chargram_dense_local, _chargram_dense_finish),
                   "sparse": (_chargram_sparse_local,
                              _chargram_sparse_finish)}


def _chargram_forward(byte_ids, byte_lengths, num_docs: int, *,
                      vocab_size: int, ngram_lo: int, ngram_hi: int,
                      seed: int, score_dtype, topk: Optional[int]):
    """The dense device chargram: raw bytes -> (df, docSize, vals, ids)
    with ``topk``, else (counts, df, docSize, scores)."""
    state, df = _chargram_dense_local(byte_ids, byte_lengths,
                                      vocab_size=vocab_size,
                                      ngram_lo=ngram_lo, ngram_hi=ngram_hi,
                                      seed=seed)
    return _chargram_dense_finish(state, df, num_docs, vocab_size=vocab_size,
                                  score_dtype=score_dtype, topk=topk)


def _chargram_sparse_forward(byte_ids, byte_lengths, num_docs: int, *,
                             vocab_size: int, ngram_lo: int, ngram_hi: int,
                             seed: int, score_dtype, topk: int):
    """The row-sparse device chargram, the wide-vocab lowering with no
    [D, V] matrix: sort+RLE triples of the masked streams, DF, then the
    fused score+top-k kernel. -> (df, docSize, vals, ids)."""
    state, df = _chargram_sparse_local(byte_ids, byte_lengths,
                                       vocab_size=vocab_size,
                                       ngram_lo=ngram_lo, ngram_hi=ngram_hi,
                                       seed=seed)
    return _chargram_sparse_finish(state, df, num_docs,
                                   vocab_size=vocab_size,
                                   score_dtype=score_dtype, topk=topk)


def _host(t: torch.Tensor) -> np.ndarray:
    """Device tensor -> host numpy (bfloat16 widens to float32: numpy
    has no bfloat16)."""
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


class TfidfPipeline(PhaseTimedMixin):
    """Configured TF-IDF runner: corpus in, scored records out.

    ``device``: where tensors and kernels run — CUDA by default (raises
    when absent), ``"cpu"`` for the kernels' plain versions. ``timer``
    (a :class:`PhaseTimer`) accumulates the pack / transfer / compute /
    fetch phases. ``plan`` (a ``parallel.mesh.MeshPlan`` of the shape
    ``config.mesh_shape`` names) places a mesh run on its devices, e.g.
    virtual shards of one card; by default a mesh run takes every
    visible card (``MeshPlan.create``).
    """

    def __init__(self, config: Optional[PipelineConfig] = None,
                 timer: Optional[PhaseTimer] = None, device=None, plan=None):
        self.config = config or PipelineConfig()
        self.timer = timer
        self.plan = plan
        self.device = (plan.devices[0] if plan is not None
                       else resolve_device(device))

    def pack(self, corpus: Corpus, pad_docs_to: Optional[int] = None) -> PackedBatch:
        with self._phase("pack"):
            return pack_corpus(corpus, self.config, pad_docs_to)

    def _mesh_plan(self):
        """The MeshPlan ``config.mesh_shape`` describes: missing axes
        default to docs = all remaining devices, seq 1, vocab 1, over
        this pipeline's device kind (``parallel.mesh``)."""
        from tfidf_tpu_torch.parallel.mesh import MeshPlan

        shape = dict(self.config.mesh_shape)
        unknown = set(shape) - {"docs", "seq", "vocab"}
        if unknown:
            raise ValueError(f"mesh_shape axes {sorted(unknown)} unknown; "
                             "valid axes: docs, seq, vocab")
        docs, seq, vocab = (shape.get("docs", 0), shape.get("seq", 1),
                            shape.get("vocab", 1))
        if self.plan is None:
            return MeshPlan.create(docs=docs, seq=seq, vocab=vocab,
                                   device=self.device)
        if (docs or self.plan.n_docs_shards, seq, vocab) != self.plan.shape:
            raise ValueError(f"plan {self.plan.shape} is not mesh_shape "
                             f"{shape}")
        return self.plan

    def _mesh_pipeline(self):
        """The ShardedPipeline ``config.mesh_shape`` describes. The
        handed-off config has ``mesh_shape`` cleared (the plan is
        authoritative from there down) and keeps the engine-defaulted
        flag, so ShardedPipeline can still apply its capability
        fallback."""
        from tfidf_tpu_torch.parallel.sharded import ShardedPipeline

        plan = self._mesh_plan()
        cfg = dataclasses.replace(self.config, mesh_shape={})
        object.__setattr__(cfg, "_engine_defaulted",
                           getattr(self.config, "_engine_defaulted", False))
        return ShardedPipeline(plan, cfg, timer=self.timer)

    def _fetch_topk(self, df, tv, ti, vocab_size: int):
        """Fetch (df, top-k): on the packed wire the [D, K] selection
        crosses as uint32 words packed on the device (ids exact, scores
        rounded to float16/bfloat16); else the full-precision pair."""
        if use_packed_result_wire(self.config, vocab_size=vocab_size):
            words = _host(pack_words(tv, ti))
            vals, ids = unpack_result_words(
                words, score_dtype=self.config.score_dtype)
            return _host(df), vals, ids
        return _host(df), _host(tv), _host(ti)

    def run_packed(self, batch: Batch) -> PipelineResult:
        cfg = self.config
        if cfg.mesh_shape:
            # The mesh wire stays padded (the shard bodies take [D, L]
            # rows): a ragged minibatch is rebuilt on the host.
            if isinstance(batch, RaggedBatch):
                batch = batch.to_padded()
            return self._mesh_pipeline().run_packed(batch)
        if cfg.engine == "sparse":
            return self._run_sparse(batch)
        with self._phase("transfer"):
            toks, lens = place_batch(batch, self.device)
        with self._phase("compute"):
            out = _forward(toks, lens, batch.num_docs,
                           vocab_size=batch.vocab_size,
                           score_dtype=canonical_score_dtype(cfg.score_dtype),
                           topk=cfg.topk)
        with self._phase("fetch"):
            if cfg.topk is not None:
                out = self._fetch_topk(*out, vocab_size=batch.vocab_size)
            else:
                out = tuple(_host(t) for t in out)
        result = PipelineResult(
            counts=None if cfg.topk is not None else out[0],
            lengths=np.asarray(batch.lengths),
            df=out[0 if cfg.topk is not None else 1],
            num_docs=batch.num_docs,
            names=batch.names,
            id_to_word=batch.id_to_word or {},
        )
        if cfg.topk is not None:
            result.topk_vals, result.topk_ids = out[1], out[2]
        else:
            result.scores = out[2]
        return result

    def _run_sparse(self, batch: Batch) -> PipelineResult:
        """Row-sparse engine: O(D x L) memory, no [D, V] matrix."""
        cfg = self.config
        with self._phase("transfer"):
            toks, lens = place_batch(batch, self.device)
        with self._phase("compute"):
            out = sparse_forward(
                toks, lens, batch.num_docs, vocab_size=batch.vocab_size,
                score_dtype=canonical_score_dtype(cfg.score_dtype),
                topk=cfg.topk)
        with self._phase("fetch"):
            if cfg.topk is not None:
                out = self._fetch_topk(*out, vocab_size=batch.vocab_size)
            else:
                out = tuple(_host(t) for t in out)
        result = PipelineResult(
            counts=None,
            lengths=np.asarray(batch.lengths),
            df=out[0],
            num_docs=batch.num_docs,
            names=batch.names,
            id_to_word=batch.id_to_word or {},
        )
        if cfg.topk is not None:
            result.topk_vals, result.topk_ids = out[1], out[2]
        else:
            result.sparse_ids, result.sparse_counts, result.sparse_head = out[1:4]
        return result

    def run_bytes(self, corpus: Corpus) -> PipelineResult:
        """The device chargram: raw bytes in, n-gram ids hashed on the
        device. An explicit ``engine="sparse"`` takes the row-sparse
        lowering; a defaulted engine keeps the dense histogram up to
        vocab 2^16 and goes sparse past it (the JAX package's rule).
        Top-k selections leave the device as packed words when the word
        can carry the run, else as the full-precision pair."""
        cfg = self.config
        if cfg.tokenizer is not TokenizerKind.CHARGRAM:
            raise ValueError("run_bytes is the chargram device path")
        if cfg.vocab_mode is not VocabMode.HASHED:
            raise ValueError("device chargram requires HASHED vocab "
                             "(EXACT needs host-side n-gram strings)")
        lo, hi = cfg.ngram_range
        use_sparse = (cfg.engine == "sparse"
                      and (not getattr(cfg, "_engine_defaulted", False)
                           or cfg.vocab_size > (1 << 16)))
        if use_sparse and cfg.topk is None:
            raise ValueError("the sparse device chargram serves top-k runs")
        if cfg.mesh_shape:
            return self._run_bytes_mesh(corpus, use_sparse)
        with self._phase("pack"):
            packed = pack_bytes(corpus)
        with self._phase("transfer"):
            byte_ids = torch.from_numpy(packed.byte_ids).to(self.device)
            byte_lens = torch.from_numpy(packed.byte_lengths).to(self.device)
        fwd = _chargram_sparse_forward if use_sparse else _chargram_forward
        with self._phase("compute"):
            out = fwd(byte_ids, byte_lens, packed.num_docs,
                      vocab_size=cfg.vocab_size, ngram_lo=lo, ngram_hi=hi,
                      seed=cfg.hash_seed,
                      score_dtype=canonical_score_dtype(cfg.score_dtype),
                      topk=cfg.topk)
        with self._phase("fetch"):
            if cfg.topk is not None:
                df, total_len, tv, ti = out
                df, vals, ids = self._fetch_topk(df, tv, ti, cfg.vocab_size)
                return PipelineResult(
                    counts=None, lengths=_host(total_len), df=df,
                    num_docs=packed.num_docs, names=packed.names,
                    id_to_word={}, topk_vals=vals, topk_ids=ids)
            counts, df, total_len, scores = (_host(t) for t in out)
        return PipelineResult(counts=counts, lengths=total_len, df=df,
                              num_docs=packed.num_docs, names=packed.names,
                              id_to_word={}, scores=scores)

    def _run_bytes_mesh(self, corpus: Corpus, use_sparse: bool
                        ) -> PipelineResult:
        """The docs-sharded device chargram (docs axis only: n-gram
        windows span adjacent bytes; vocab stays replicated as in the
        sparse engine), top-k runs only. Outputs keep the mesh's padding
        rows, as the JAX package's do; the selection leaves each shard
        as packed words when the word can carry the run, as on one
        device."""
        from tfidf_tpu_torch.parallel.collectives import (
            gather_rows, make_chargram_sharded_forward, place_batch)

        cfg = self.config
        shape = dict(cfg.mesh_shape)
        if shape.get("seq", 1) != 1 or shape.get("vocab", 1) != 1:
            raise ValueError("device chargram shards docs only; use "
                             "mesh_shape={'docs': N} (run() with the "
                             "host tokenizer covers other meshes)")
        plan = self._mesh_plan()
        lo, hi = cfg.ngram_range
        fwd = make_chargram_sharded_forward(
            plan, cfg.vocab_size, lo, hi, cfg.hash_seed,
            canonical_score_dtype(cfg.score_dtype), cfg.topk,
            engine="sparse" if use_sparse else "dense")
        with self._phase("pack"):
            packed = pack_bytes(corpus,
                                pad_docs_to=plan.pad_docs(len(corpus)))
        with self._phase("transfer"):
            placed = place_batch(plan, packed.byte_ids, packed.byte_lengths)
        with self._phase("compute"):
            df, total_len, tv, ti = fwd(placed, packed.num_docs)
        with self._phase("fetch"):
            if use_packed_result_wire(cfg, vocab_size=cfg.vocab_size):
                words = _host(gather_rows(plan, [pack_words(v, i)
                                                 for v, i in zip(tv, ti)]))
                vals, ids = unpack_result_words(
                    words, score_dtype=cfg.score_dtype)
            else:
                vals = _host(gather_rows(plan, tv))
                ids = _host(gather_rows(plan, ti))
            return PipelineResult(
                counts=None, lengths=_host(gather_rows(plan, total_len)),
                df=_host(df), num_docs=packed.num_docs, names=packed.names,
                id_to_word={}, topk_vals=vals, topk_ids=ids)

    def run(self, corpus: Corpus) -> PipelineResult:
        cfg = self.config
        chargram_device = (cfg.tokenizer is TokenizerKind.CHARGRAM
                           and cfg.vocab_mode is VocabMode.HASHED
                           and cfg.chargram_on_device
                           and cfg.topk is not None)
        if cfg.mesh_shape:
            # Docs-only meshes keep the device chargram (sharded);
            # seq/vocab meshes take the host tokenizer.
            shape = dict(cfg.mesh_shape)
            if (chargram_device and shape.get("seq", 1) == 1
                    and shape.get("vocab", 1) == 1):
                return self.run_bytes(corpus)
            return self._mesh_pipeline().run(corpus)
        if chargram_device:
            return self.run_bytes(corpus)
        return self.run_packed(self.pack(corpus))
