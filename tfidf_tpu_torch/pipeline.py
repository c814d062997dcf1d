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

The pipeline runs on CUDA unless the caller names another device; with
no GPU and no device named it raises instead of running on the CPU.
Mesh configs and the device-chargram path (``run_bytes``) are not
ported yet and raise ``NotImplementedError``.
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
                                       RaggedBatch, pack_corpus)
from tfidf_tpu_torch.ops.downlink import (unpack_result_words,
                                          use_packed_result_wire)
from tfidf_tpu_torch.ops.kernels import pack_words, ragged_rebuild, tf_df
from tfidf_tpu_torch.ops.scoring import canonical_score_dtype, tfidf_dense
from tfidf_tpu_torch.ops.sparse import sparse_forward
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
    fetch phases.
    """

    def __init__(self, config: Optional[PipelineConfig] = None,
                 timer: Optional[PhaseTimer] = None, device=None):
        self.config = config or PipelineConfig()
        self.timer = timer
        self.device = resolve_device(device)

    def pack(self, corpus: Corpus, pad_docs_to: Optional[int] = None) -> PackedBatch:
        with self._phase("pack"):
            return pack_corpus(corpus, self.config, pad_docs_to)

    def _check_single_device(self) -> None:
        if self.config.mesh_shape:
            raise NotImplementedError(
                "mesh_shape runs (the JAX package's ShardedPipeline) are "
                "not ported yet: ROADMAP A9")

    def _place(self, batch: Batch):
        """Device placement of either wire. A PackedBatch ships the padded
        [D, L] ids; a RaggedBatch ships its flat aligned stream (bytes
        scale with real tokens) and the padded batch is rebuilt on the
        device (``ops.kernels.ragged_rebuild``)."""
        if not isinstance(batch, (PackedBatch, RaggedBatch)):
            raise TypeError(f"{type(batch).__name__} input: run_packed takes "
                            f"a PackedBatch or a RaggedBatch")
        lens = torch.from_numpy(
            np.asarray(batch.lengths, dtype=np.int32)).to(self.device)
        if isinstance(batch, RaggedBatch):
            flat = torch.from_numpy(np.ascontiguousarray(batch.flat))
            return ragged_rebuild(flat.to(self.device), lens,
                                  length=batch.length,
                                  align=batch.align), lens
        toks = np.asarray(batch.token_ids)
        if toks.dtype != np.int32:
            toks = toks.astype(np.int32)  # uint16 wire ids widen here
        return torch.from_numpy(toks).to(self.device), lens

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
        self._check_single_device()
        cfg = self.config
        if cfg.engine == "sparse":
            return self._run_sparse(batch)
        with self._phase("transfer"):
            toks, lens = self._place(batch)
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
            toks, lens = self._place(batch)
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
        """The device-chargram path of the JAX package (raw bytes in,
        n-gram ids hashed on the device) — not ported yet."""
        raise NotImplementedError(
            "run_bytes (device chargram) is not ported yet: ROADMAP A5")

    def run(self, corpus: Corpus) -> PipelineResult:
        cfg = self.config
        self._check_single_device()
        if (cfg.tokenizer is TokenizerKind.CHARGRAM
                and cfg.vocab_mode is VocabMode.HASHED
                and cfg.chargram_on_device and cfg.topk is not None):
            return self.run_bytes(corpus)
        return self.run_packed(self.pack(corpus))
