"""Configuration for the PyTorch/CUDA TF-IDF pipeline.

Field-for-field copy of ``tfidf_tpu.config.PipelineConfig`` (and its two
enums), so that one config dict means the same run in both packages
(``interop.config_from_dict``). The engine default is the same measured
choice: HASHED vocab runs default to the row-sparse engine, EXACT
golden-parity runs to the dense one.

Fields that select machinery this port does not have yet (the chunked
ingest's ``wire``/``pack_threads``/``finish``, the XLA ``compile_cache``,
the span ``trace``) are carried and validated but not read; ``use_pallas``
only steers the engine default, exactly as in the JAX package, since the
port's dense engine always runs its TF/DF kernel.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class VocabMode(str, enum.Enum):
    """How words map to integer vocabulary ids.

    EXACT builds a host-side string->id dictionary over the corpus
    (collision-free, golden parity). HASHED maps words through FNV-1a
    into a fixed-size vocab (default 2^16).
    """

    EXACT = "exact"
    HASHED = "hashed"


class TokenizerKind(str, enum.Enum):
    """Tokenizer family: WHITESPACE (the reference's ``fscanf("%s")``)
    or CHARGRAM (char n-grams)."""

    WHITESPACE = "whitespace"
    CHARGRAM = "chargram"


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """All knobs for a TF-IDF run (see ``tfidf_tpu.config`` for the
    full description of each field).

    Attributes read by this port:
      vocab_mode, vocab_size, hash_seed, tokenizer, ngram_range,
      chargram_on_device, truncate_tokens_at: the host tokenize/hash
        front end.
      max_doc_len, doc_chunk: the packed token-axis length is at least
        ``max_doc_len``, grown to the longest doc, rounded up to a
        ``doc_chunk`` multiple.
      engine: "dense" ([D, V] histograms) or "sparse" (row-sparse
        sort+RLE); None picks by vocab mode.
      mesh_shape: must be empty (mesh runs are not ported yet).
      score_dtype: device score dtype; "float64" canonicalises to
        float32, as JAX does without x64.
      topk: per-document top-k selection; None = full output.
      result_wire: "packed" (uint32 words) or "pair" for top-k fetches.
    """

    vocab_mode: VocabMode = VocabMode.EXACT
    vocab_size: int = 1 << 16
    engine: Optional[str] = None
    hash_seed: int = 0
    tokenizer: TokenizerKind = TokenizerKind.WHITESPACE
    ngram_range: Tuple[int, int] = (3, 5)
    chargram_on_device: bool = True
    truncate_tokens_at: Optional[int] = None
    max_doc_len: int = 256
    doc_chunk: int = 256
    mesh_shape: dict = dataclasses.field(default_factory=dict)
    use_pallas: bool = False
    score_dtype: str = "float32"
    topk: Optional[int] = None
    wire: str = "ragged"
    pack_threads: Optional[int] = None
    result_wire: str = "packed"
    finish: str = "scan"
    compile_cache: Optional[str] = None
    trace: Optional[str] = None

    def __post_init__(self):
        if self.wire not in ("ragged", "padded", "bytes"):
            raise ValueError(f"unknown wire format {self.wire!r} "
                             f"(choose 'ragged', 'padded' or 'bytes')")
        if self.pack_threads is not None and self.pack_threads < 1:
            raise ValueError("pack_threads must be >= 1")
        if self.result_wire not in ("packed", "pair"):
            raise ValueError(f"unknown result wire {self.result_wire!r} "
                             f"(choose 'packed' or 'pair')")
        if self.finish not in ("scan", "chunked"):
            raise ValueError(f"unknown finish {self.finish!r} "
                             f"(choose 'scan' or 'chunked')")
        if self.vocab_size <= 0:
            raise ValueError("vocab_size must be positive")
        lo, hi = self.ngram_range
        if not (0 < lo <= hi):
            raise ValueError(f"bad ngram_range {self.ngram_range}")
        if self.max_doc_len <= 0 or self.doc_chunk <= 0:
            raise ValueError("max_doc_len/doc_chunk must be positive")
        object.__setattr__(self, "_engine_defaulted", self.engine is None)
        if self.engine is None:
            object.__setattr__(
                self, "engine",
                "sparse" if (self.vocab_mode is VocabMode.HASHED
                             and not self.use_pallas) else "dense")
        if self.engine not in ("dense", "sparse"):
            raise ValueError(f"unknown engine {self.engine!r}")

    @staticmethod
    def golden() -> "PipelineConfig":
        """Config whose output is byte-identical to the C reference
        (EXACT vocab, no truncation; tokens must stay under 16 bytes)."""
        return PipelineConfig(vocab_mode=VocabMode.EXACT)
