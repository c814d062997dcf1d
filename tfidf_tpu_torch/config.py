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

:class:`ServeConfig` is the serving layer's copy of the JAX package's.
The JAX module's ``apply_compile_cache`` (its persistent XLA compilation
cache) has no counterpart: the port compiles no XLA programs, so there
is nothing to cache and no knob takes its place.
"""

from __future__ import annotations

import dataclasses
import enum
import os
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
      mesh_shape: logical device mesh, e.g. ``{"docs": 8}`` or
        ``{"docs": 4, "vocab": 2}``. Empty = single device.
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


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs for the online serving layer (``tfidf_tpu_torch/serve``),
    field for field the JAX package's ``ServeConfig`` (same defaults,
    validation and ``TFIDF_TPU_*`` env mirrors), so one config means the
    same server in both packages.

    Attributes:
      max_batch: most queries one coalesced device batch carries; a
        single larger request stays atomic (one batch). CLI
        ``--max-batch`` / env ``TFIDF_TPU_MAX_BATCH``.
      max_wait_ms: the oldest queued request never waits longer than
        this for its batch to fill. ``--max-wait-ms`` /
        ``TFIDF_TPU_MAX_WAIT_MS``.
      queue_depth: admission bound in QUERIES across all in-flight
        requests; past it ``TfidfServer.submit`` sheds with the typed
        ``Overloaded``. ``--queue-depth`` / ``TFIDF_TPU_QUEUE_DEPTH``.
      cache_entries: LRU result-cache capacity in per-query rows (0
        disables). ``--cache-entries`` / ``TFIDF_TPU_CACHE_ENTRIES``.
      default_deadline_ms: per-request deadline when a submit names
        none; None = no deadline.
      health_period_ms: health watchdog cadence (None = no background
        thread; ``healthz`` still evaluates on demand).
        ``--health-period-ms`` (0 disables) /
        ``TFIDF_TPU_HEALTH_PERIOD_MS``.
      stall_after_ms: a worker with pending work silent this long marks
        the server ``unhealthy``. ``TFIDF_TPU_STALL_AFTER_MS``.
      degraded_admission_factor: while degraded the admission bound
        shrinks to ``queue_depth * factor`` (floor 1).
        ``TFIDF_TPU_DEGRADED_FACTOR``.
      devmon_period_ms: device-monitor cadence: every period
        ``obs.devmon.DeviceMonitor`` reads ``torch.cuda.memory_stats``
        and ``mem_get_info`` per device into gauges, checks the
        ``TFIDF_TPU_HBM_WATERMARKS`` and refreshes the
        ``memory_pressure`` health signal. None = no monitor thread (on
        the CPU the same path runs with the gauges absent).
        ``--devmon-period-ms`` (0 disables) /
        ``TFIDF_TPU_DEVMON_PERIOD_MS``.
      dispatch_retries: transient dispatch failures retried per batch.
        ``TFIDF_TPU_DISPATCH_RETRIES``.
      retry_backoff_ms: base of the jittered exponential retry backoff.
        ``TFIDF_TPU_RETRY_BACKOFF_MS``.
      breaker_threshold: consecutive dispatch failures that trip the
        circuit breaker. ``TFIDF_TPU_BREAKER_THRESHOLD``.
      breaker_cooldown_ms: how long an open breaker waits before its
        half-open probe. ``TFIDF_TPU_BREAKER_COOLDOWN_MS``.
      restart_budget: crashed batcher-loop restarts tolerated.
        ``TFIDF_TPU_RESTART_BUDGET``.
      snapshot_dir: checkpoint root of the resident-index snapshot
        (``TfidfServer.snapshot``, restore on start, ``swap_index``
        snapshots the incoming epoch before flipping). Either package's
        snapshot restores. ``--snapshot-dir`` /
        ``TFIDF_TPU_SNAPSHOT_DIR``.
      faults: fault-injection plan armed by the server, disarmed on
        close (``tfidf_tpu_torch/faults.py``). ``TFIDF_TPU_FAULTS``.
      fault_seed: seed of the plan's probabilistic rules and the retry
        jitter. ``TFIDF_TPU_FAULT_SEED``.
      slow_ms: slow-query threshold of the ``slow_query`` flight event
        (``obs/reqtrace.py``). ``--slow-ms`` / ``TFIDF_TPU_SLOW_MS``.
      slow_sample: 1-in-N tail sample of the same event (0 disables).
        ``TFIDF_TPU_SLOW_SAMPLE``.
      slo_ms: latency objective of the SLO burn gauges
        (``obs/slo.py``). ``--slo-ms`` / ``TFIDF_TPU_SLO_MS``.
      slo_target: fraction of requests that must meet ``slo_ms``.
        ``--slo-target`` / ``TFIDF_TPU_SLO_TARGET``.
      delta_docs: delta-segment capacity: serving with this set builds
        a :class:`~tfidf_tpu_torch.index.SegmentedIndex` and turns the
        ``add_docs`` / ``delete_docs`` ops on. ``--delta-docs`` /
        ``TFIDF_TPU_DELTA_DOCS``.
      compact_at: sealed-segment count at which the compactor merges.
        ``--compact-at`` / ``TFIDF_TPU_COMPACT_AT``.
      mesh_shards: serve ONE index doc-sharded over this many devices of
        the index's device type (0 = every device; on the CPU, one
        shard): every install path re-shards through
        ``parallel.serving.shard_index``. ``--mesh-shards`` /
        ``TFIDF_TPU_MESH_SHARDS``.
      query_slab: the query slab (a batch's compact query entries in
        reused pinned slots, one non-blocking H2D copy a batch, the
        block built on the device); None resolves
        ``TFIDF_TPU_QUERY_SLAB`` (default on), False fills and uploads
        a dense block each batch (the same bits). ``--query-slab``.
      pipeline_depth: batches in flight between the batcher's dispatch
        stage and its drain worker; 1 = dispatch and materialize one
        batch at a time. ``--serve-pipeline-depth`` /
        ``TFIDF_TPU_SERVE_PIPELINE``.
      replicas: N replica processes behind one
        :class:`~tfidf_tpu_torch.serve.front.ReplicatedFront` (needs
        ``snapshot_dir``, the shared snapshot every replica restores
        from); ``TfidfServer`` ignores it. ``--replicas`` /
        ``TFIDF_TPU_REPLICAS``.
      replica_timeout_s: the front's patience with one replica (boot,
        a request, a control op). ``--replica-timeout-s`` /
        ``TFIDF_TPU_REPLICA_TIMEOUT_S``.
      scorer, bm25_k1, bm25_b: the default scoring-family member for
        requests that name none. ``--scorer`` / ``--bm25-k1`` /
        ``--bm25-b``, ``TFIDF_TPU_SCORER`` / ``TFIDF_TPU_BM25_K1`` /
        ``TFIDF_TPU_BM25_B``.
      disttrace: adopt inbound fleet trace contexts (``"trace"`` JSONL
        field); None resolves ``TFIDF_TPU_DISTTRACE`` (default on).
        ``--disttrace``.
    """

    max_batch: int = 256
    max_wait_ms: float = 2.0
    queue_depth: int = 256
    cache_entries: int = 4096
    default_deadline_ms: Optional[float] = None
    health_period_ms: Optional[float] = None
    stall_after_ms: float = 1000.0
    degraded_admission_factor: float = 0.5
    devmon_period_ms: Optional[float] = None
    dispatch_retries: int = 2
    retry_backoff_ms: float = 10.0
    breaker_threshold: int = 5
    breaker_cooldown_ms: float = 1000.0
    restart_budget: int = 3
    snapshot_dir: Optional[str] = None
    faults: Optional[str] = None
    fault_seed: int = 0
    slow_ms: Optional[float] = None
    slow_sample: int = 0
    slo_ms: Optional[float] = None
    slo_target: float = 0.99
    delta_docs: Optional[int] = None
    compact_at: int = 4
    mesh_shards: Optional[int] = None
    query_slab: Optional[bool] = None
    pipeline_depth: int = 2
    replicas: Optional[int] = None
    replica_timeout_s: float = 120.0
    scorer: Optional[str] = None
    bm25_k1: Optional[float] = None
    bm25_b: Optional[float] = None
    disttrace: Optional[bool] = None

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        if self.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        if self.cache_entries < 0:
            raise ValueError("cache_entries must be >= 0")
        if (self.default_deadline_ms is not None
                and self.default_deadline_ms < 0):
            raise ValueError("default_deadline_ms must be >= 0")
        if (self.health_period_ms is not None
                and self.health_period_ms <= 0):
            raise ValueError("health_period_ms must be positive "
                             "(None disables the watchdog thread)")
        if (self.devmon_period_ms is not None
                and self.devmon_period_ms <= 0):
            raise ValueError("devmon_period_ms must be positive "
                             "(None disables the device monitor)")
        if self.stall_after_ms <= 0:
            raise ValueError("stall_after_ms must be positive")
        if not 0 < self.degraded_admission_factor <= 1:
            raise ValueError(
                "degraded_admission_factor must be in (0, 1]")
        if self.dispatch_retries < 0:
            raise ValueError("dispatch_retries must be >= 0")
        if self.retry_backoff_ms < 0:
            raise ValueError("retry_backoff_ms must be >= 0")
        if self.breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        if self.breaker_cooldown_ms <= 0:
            raise ValueError("breaker_cooldown_ms must be positive")
        if self.restart_budget < 0:
            raise ValueError("restart_budget must be >= 0")
        if self.slow_ms is not None and self.slow_ms < 0:
            raise ValueError("slow_ms must be >= 0")
        if self.slow_sample < 0:
            raise ValueError("slow_sample must be >= 0")
        if self.slo_ms is not None and self.slo_ms <= 0:
            raise ValueError("slo_ms must be positive")
        if not 0 < self.slo_target < 1:
            raise ValueError("slo_target must be in (0, 1)")
        if self.delta_docs is not None and self.delta_docs < 1:
            raise ValueError("delta_docs must be >= 1 "
                             "(None disables segmented serving)")
        if self.compact_at < 2:
            raise ValueError("compact_at must be >= 2")
        if self.mesh_shards is not None and self.mesh_shards < 0:
            raise ValueError("mesh_shards must be >= 0 (0 = all "
                             "devices; None disables mesh serving)")
        if self.pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1 "
                             "(1 = unpipelined legacy execution)")
        if self.replicas is not None and self.replicas < 1:
            raise ValueError("replicas must be >= 1 "
                             "(None disables the replicated front)")
        if self.replica_timeout_s <= 0:
            raise ValueError("replica_timeout_s must be positive")
        if self.replicas is not None and not self.snapshot_dir:
            raise ValueError("replicas requires snapshot_dir — the "
                             "replicas spin up from (and restart "
                             "from) the shared snapshot")
        if self.bm25_k1 is not None and self.bm25_k1 < 0:
            raise ValueError("bm25_k1 must be >= 0")
        if self.bm25_b is not None and not 0 <= self.bm25_b <= 1:
            raise ValueError("bm25_b must be in [0, 1]")
        if self.scorer is not None:
            # Validate eagerly: a typo'd --scorer fails at
            # config time, not at the first request.
            from tfidf_tpu_torch.scoring.family import spec_from_parts
            spec_from_parts(self.scorer, self.bm25_k1, self.bm25_b)

    @staticmethod
    def from_env(**overrides) -> "ServeConfig":
        """Defaults from the ``TFIDF_TPU_*`` env mirrors, keyword
        overrides winning — the CLI's resolution order (flag > env >
        default)."""
        def pick(key, env, cast):
            if key in overrides and overrides[key] is not None:
                return overrides[key]
            raw = os.environ.get(env)
            return cast(raw) if raw else None
        kw = {}
        for key, env, cast in (
                ("max_batch", "TFIDF_TPU_MAX_BATCH", int),
                ("max_wait_ms", "TFIDF_TPU_MAX_WAIT_MS", float),
                ("queue_depth", "TFIDF_TPU_QUEUE_DEPTH", int),
                ("cache_entries", "TFIDF_TPU_CACHE_ENTRIES", int),
                ("stall_after_ms", "TFIDF_TPU_STALL_AFTER_MS", float),
                ("degraded_admission_factor",
                 "TFIDF_TPU_DEGRADED_FACTOR", float),
                ("dispatch_retries", "TFIDF_TPU_DISPATCH_RETRIES", int),
                ("retry_backoff_ms", "TFIDF_TPU_RETRY_BACKOFF_MS",
                 float),
                ("breaker_threshold", "TFIDF_TPU_BREAKER_THRESHOLD",
                 int),
                ("breaker_cooldown_ms",
                 "TFIDF_TPU_BREAKER_COOLDOWN_MS", float),
                ("restart_budget", "TFIDF_TPU_RESTART_BUDGET", int),
                ("snapshot_dir", "TFIDF_TPU_SNAPSHOT_DIR", str),
                ("faults", "TFIDF_TPU_FAULTS", str),
                ("fault_seed", "TFIDF_TPU_FAULT_SEED", int),
                ("slow_ms", "TFIDF_TPU_SLOW_MS", float),
                ("slow_sample", "TFIDF_TPU_SLOW_SAMPLE", int),
                ("slo_ms", "TFIDF_TPU_SLO_MS", float),
                ("slo_target", "TFIDF_TPU_SLO_TARGET", float),
                ("delta_docs", "TFIDF_TPU_DELTA_DOCS", int),
                ("compact_at", "TFIDF_TPU_COMPACT_AT", int),
                ("mesh_shards", "TFIDF_TPU_MESH_SHARDS", int),
                ("pipeline_depth", "TFIDF_TPU_SERVE_PIPELINE", int),
                ("replicas", "TFIDF_TPU_REPLICAS", int),
                ("replica_timeout_s", "TFIDF_TPU_REPLICA_TIMEOUT_S",
                 float),
                ("scorer", "TFIDF_TPU_SCORER", str),
                ("bm25_k1", "TFIDF_TPU_BM25_K1", float),
                ("bm25_b", "TFIDF_TPU_BM25_B", float),
                ("query_slab", "TFIDF_TPU_QUERY_SLAB",
                 lambda raw: raw.strip().lower() not in
                 ("0", "off", "false", "no")),
                ("disttrace", "TFIDF_TPU_DISTTRACE",
                 lambda raw: raw.strip().lower() not in
                 ("0", "off", "false", "no"))):
            val = pick(key, env, cast)
            if val is not None:
                kw[key] = val
        if overrides.get("default_deadline_ms") is not None:
            kw["default_deadline_ms"] = overrides["default_deadline_ms"]
        # health/devmon periods: an explicit 0 means "thread off"
        # (None), distinct from "not set" (fall through to the env).
        for key, env in (("health_period_ms",
                          "TFIDF_TPU_HEALTH_PERIOD_MS"),
                         ("devmon_period_ms",
                          "TFIDF_TPU_DEVMON_PERIOD_MS")):
            val = overrides.get(key)
            if val is None:
                raw = os.environ.get(env)
                val = float(raw) if raw else None
            if val is not None:
                kw[key] = val if val > 0 else None
        return ServeConfig(**kw)
