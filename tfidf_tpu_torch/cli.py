"""Command line of the PyTorch/CUDA port: the ``run``, ``stream``,
``query`` and ``serve`` subcommands.

    python -m tfidf_tpu_torch.cli run --input DIR [--output output.txt]
        [--backend cuda|tpu|mpi [--nranks N] [--comm thread|process]]
        [--vocab-mode exact|hashed] [--vocab-size N] [--topk K]
        [--tokenizer whitespace|chargram] [--ngram LO,HI]
        [--engine dense|sparse] [--pallas] [--result-wire packed|pair]
        [--score-dtype float32|bfloat16|float16] [--device cuda|cpu]
        [--doc-len L [--chunk-docs N] [--spill auto|host|reread]
         [--wire ragged|padded|bytes] [--finish scan|chunked]
         [--pack-threads T]] [--exact-terms [--exact-margin M]]
        [--mesh D,S,V] [--ingest-workers N] [--compile-cache DIR]
        [--no-strict] [--inspect] [--timing] [--trace out.json]

Without ``--topk`` it writes the reference's ``output.txt`` (byte-
identical to the MPI reference on EXACT vocab); with ``--topk`` it
writes the top-k report in the JAX CLI's format. A hashed whitespace
top-k run with ``--doc-len`` goes through the overlapped chunked ingest
(``ingest.run_overlapped``; documents longer than L tokens are
truncated, terms print as ``id:N``), any other run through
``TfidfPipeline`` (a chargram hashed top-k run: the device chargram).
``--exact-terms`` (hashed whitespace top-k) emits exact words: with
``--doc-len`` through ``rerank.exact_terms_lines`` (the device-exact
engine, else the hashed re-rank engine), else ``rerank.exact_topk`` over
the batch run's margin selection. ``--backend mpi`` runs the native
bit-reference (``native/tfidf_ref.cc``, built with g++ into
``tfidf_tpu_torch/_build/`` at first use) instead. ``--mesh d,s,v`` runs
on a (docs, seq, vocab) device mesh (``parallel``): a ``--doc-len`` run
with a docs-only mesh through the mesh ingest over the first d*s*v
devices (``--device cpu``: that many CPU shards), any other through
``config.mesh_shape``. ``--ingest-workers N`` (or
``TFIDF_TPU_INGEST_WORKERS``) splits a single-device ``--doc-len`` run
over N worker processes (``parallel.multihost.run_sharded_ingest``).
``--pallas`` sets ``PipelineConfig.use_pallas`` as the JAX CLI does: the
hashed default engine becomes dense and a ``--doc-len`` run is refused
(exit 2); the port's kernels run either way, so the flag changes the
route, not the kernels. ``--backend tpu`` names the accelerator path,
which here is ``cuda``. The gating messages and exit codes are the JAX
CLI's.

    python -m tfidf_tpu_torch.cli stream --input DIR [--output output.txt]
        [--batch-docs N] [--doc-len L] [--vocab-size V] [--topk K]
        [--mesh-docs N] [--checkpoint CK [--resume]] [--no-strict]
        [--timing] [--trace out.json] [--device cuda|cpu]

streams the directory in minibatches of N documents (``StreamingTfidf``):
pass 1 folds DF, saving the state to ``--checkpoint`` after every
minibatch; pass 2 scores every minibatch against the final DF and writes
the top-k report. ``--resume`` restores the checkpoint and skips the
``docs_seen`` documents already folded, in discovery order, so a killed
and resumed run writes the same bytes as an uninterrupted one (and as
the JAX CLI's ``stream``). ``--mesh-docs N`` shards every minibatch over
N devices (0 = all; ``--batch-docs`` must be a multiple of N).

    python -m tfidf_tpu_torch.cli query --input DIR --query TEXT
        [--query TEXT ...] [-k K] [--vocab-size N] [--doc-len L]
        [--mesh-docs N] [--compile-cache DIR] [--no-strict]
        [--trace out.json] [--device cuda|cpu]

indexes the directory (``TfidfRetriever.index_dir``; ``--doc-len``
through the overlapped ingest's chunk step; ``--mesh-docs N``
block-sharded over N devices, 0 = all, which excludes ``--doc-len``) and
prints, per query, ``query: <text>`` then one ``  <name>\t<score>`` line
per result, as the JAX CLI's ``query`` does.

    python -m tfidf_tpu_torch.cli serve --input DIR [-k K] [--doc-len L]
        [--max-batch N] [--max-wait-ms MS] [--queue-depth N]
        [--serve-pipeline-depth D] [--delta-docs N] [--snapshot-dir DIR]
        [--mesh-shards N] [--replicas N [--replica-timeout-s S]]
        [--port P] [--device cuda|cpu] ...

indexes the directory (or restores ``--snapshot-dir``) and serves it
through ``serve.TfidfServer``: one JSON request per line on stdin (or on
TCP with ``--port``), one JSON response line each, in completion order —
the JAX CLI's ``serve`` protocol and ops (``--help`` lists them).
``--mesh-shards N`` serves the index doc-sharded over N devices (0 =
all; ``parallel.serving``). ``--replicas N`` (or ``TFIDF_TPU_REPLICAS``,
with ``--snapshot-dir``) makes this process the front of N replica
processes (``serve.ReplicatedFront``), each a full server on the device,
which is resolved before any replica is spawned.

``--compile-cache DIR`` (``run``, ``query``, ``serve``) is accepted so
that the JAX CLI's command lines run unchanged; the port compiles no
XLA, so it has no effect.

Each runs on CUDA unless ``--device cpu`` is given, and fails when no GPU
is present and no device was named.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional


# --help epilog of the serve subcommand: the JSONL wire protocol, the
# JAX package's.
_SERVE_EPILOG = """\
protocol (one JSON object per line):
  {"id": 1, "queries": ["apple pie"], "k": 5}
      -> {"id": 1, "results": [[["doc3", 0.81], ...]], "rid": "r..-1",
      "epoch": 0}
  {"id": 2, "queries": [...], "deadline_ms": 50}
      -> {"id": 2, "error": "deadline_exceeded"} when shed
  {"id": 3, "queries": [...], "scorer": "bm25:k1=1.5,b=0.6",
   "filter": {"id_range": [0, 100]}}
      -> per-request scoring-family member + candidate filter
  {"op": "set_scorer", "scorer": "bm25"} -> {"scorer": ..., "epoch": N}
  {"op": "metrics"}       -> {"metrics": {...}}
  {"op": "metrics_prom"}  -> {"metrics_prom": "..."}
  {"op": "obs_export"}    -> {"obs_export": {"schema": "tfidf-obs/1", ...}}
  {"op": "trace_export"}  -> {"trace_export": {"schema": "tfidf-trace/1",
      "processes": [...]}}  (the span rings; empty when no tracer is armed)
  {"op": "healthz"}       -> {"healthz": {"status": "ok", ...}}
  {"op": "readyz"}        -> {"readyz": {"ready": true, ...}}
  {"op": "canary"}        -> {"canary": {"parity": 1.0}}
  {"op": "devmon"}        -> {"devmon": {"devices": [...], "census": ...}}
  {"op": "swap_index", "input": DIR} -> {"swapped": true, "epoch": N}
  {"op": "snapshot"}      -> {"snapshot": DIR, "epoch": N}
  {"op": "add_docs", "docs": [{"name": N, "text": T}, ...]}
      -> {"added": 2, "updated": 1, "sealed": 0, "epoch": N}
  {"op": "delete_docs", "names": [N, ...]}
      -> {"deleted": 1, "missing": 0, "epoch": N}
  {"op": "shutdown"}      -> drains in-flight work and exits
with --replicas, the front also answers:
  {"op": "replica_info"}  -> {"replica_info": {"r1": {"epoch": N,
      "compiled_programs": {"libraries": [...], "launches": {...}},
      "recompiles_after_warm": 0, ...}, ...}}
  {"op": "compact"}       -> {"epoch": N, "replicas": N}
      (and every index change commits tier-wide as a two-phase epoch bump)
Responses come back in completion order; correlate by "id".
"""


_COMPILE_CACHE_HELP = ("accepted for the JAX CLI's command lines; the port "
                       "compiles no XLA, so it has no effect")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tfidf-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="run the TF-IDF pipeline")
    run.add_argument("--input", required=True, help="document directory")
    run.add_argument("--output", default="output.txt",
                     help="output file (reference format)")
    run.add_argument("--backend", choices=["cuda", "tpu", "mpi"],
                     default="cuda",
                     help="'cuda' (or 'tpu', the JAX CLI's name for the "
                          "accelerator path): the port, on --device; "
                          "'mpi': the native bit-reference, the oracle")
    run.add_argument("--nranks", type=int, default=4,
                     help="ranks for --backend=mpi")
    run.add_argument("--comm", choices=["thread", "process"],
                     default="thread",
                     help="--backend=mpi rank backend: threads in one "
                          "process, or fork+socketpair OS processes")
    run.add_argument("--vocab-mode", choices=["exact", "hashed"],
                     default="exact")
    run.add_argument("--vocab-size", type=int, default=1 << 16,
                     help="hashed vocabulary size")
    run.add_argument("--tokenizer", choices=["whitespace", "chargram"],
                     default="whitespace")
    run.add_argument("--ngram", type=str, default="3,5",
                     help="chargram n range, e.g. 3,5")
    run.add_argument("--topk", type=int, default=None,
                     help="emit only the top-k terms per document")
    run.add_argument("--engine", choices=["dense", "sparse"], default=None,
                     help="default: sparse for hashed vocab, dense for exact")
    run.add_argument("--pallas", action="store_true",
                     help="the JAX CLI's histogram-kernel route: the "
                          "default engine becomes dense and --doc-len runs "
                          "are refused (the port's kernels run either way)")
    run.add_argument("--result-wire", choices=["packed", "pair"],
                     default="packed",
                     help="top-k fetch: uint32 words (float16 scores) or "
                          "full-precision (id, score) pairs")
    run.add_argument("--score-dtype",
                     choices=["float32", "bfloat16", "float16"],
                     default="float32")
    run.add_argument("--device", default=None,
                     help="torch device (default: cuda; 'cpu' runs the "
                          "kernels' plain versions)")
    run.add_argument("--doc-len", type=int, default=None,
                     help="static tokens per document: opts hashed top-k "
                          "runs into the overlapped chunked ingest; longer "
                          "documents are truncated and terms print as id:N")
    run.add_argument("--chunk-docs", type=int, default=None,
                     help="documents per ingest chunk (--doc-len runs; "
                          "default 8192)")
    run.add_argument("--spill", choices=["auto", "host", "reread"],
                     default=None,
                     help="streaming regime (--doc-len runs only): keep "
                          "chunks in host RAM between passes, re-read them "
                          "from disk, or pick by byte budget (default auto)")
    run.add_argument("--wire", choices=["ragged", "padded", "bytes"],
                     default="ragged",
                     help="host->device chunk wire (--doc-len runs): "
                          "'ragged' ships one flat uint16 id stream per "
                          "chunk, rebuilt on the device; 'bytes' ships raw "
                          "document bytes, tokenized and hashed on the "
                          "device; 'padded' ships the [D, L] batch")
    run.add_argument("--finish", choices=["scan", "chunked"], default=None,
                     help="packed-wire phase-B finish (--doc-len runs): "
                          "'scan' (default) fills one result buffer for "
                          "all chunks, drained by one copy; 'chunked' "
                          "drains each chunk's words as it is scored")
    run.add_argument("--pack-threads", type=int, default=None,
                     help="host packer threads of the native loader "
                          "(default every core; env TFIDF_TPU_PACK_THREADS)")
    run.add_argument("--exact-terms", action="store_true",
                     help="hashed whitespace top-k: emit exact words with "
                          "exact scores instead of bucket ids (the "
                          "device-exact engine when the corpus fits the "
                          "vocab, else the hashed re-rank engine)")
    run.add_argument("--exact-margin", type=int, default=4,
                     help="candidate margin multiplier of --exact-terms' "
                          "hashed engine: the device keeps margin*k "
                          "buckets (the device-exact engine uses k+8)")
    run.add_argument("--mesh", type=str, default=None,
                     help="mesh shape docs,seq,vocab, e.g. 4,1,1 (the "
                          "first d*s*v devices; with --device cpu, that "
                          "many CPU shards)")
    run.add_argument("--ingest-workers", type=int, default=None,
                     help="multi-process sharded ingest: split a "
                          "single-device --doc-len run over N worker "
                          "processes (env TFIDF_TPU_INGEST_WORKERS)")
    run.add_argument("--compile-cache", metavar="DIR", default=None,
                     help=_COMPILE_CACHE_HELP)
    run.add_argument("--no-strict", action="store_true",
                     help="accept any filenames, not just doc<i>")
    run.add_argument("--inspect", action="store_true",
                     help="print the reference's TF Job / IDF Job tables "
                          "to stdout before running (toy corpora)")
    run.add_argument("--timing", action="store_true",
                     help="print per-phase wall-clock and docs/sec to "
                          "stderr")
    run.add_argument("--trace", default=None,
                    help="record spans and write them as Chrome trace "
                         "JSON to this path (or TFIDF_TPU_TRACE)")
    st = sub.add_parser(
        "stream",
        help="stream the corpus in minibatches with checkpoint/resume")
    st.add_argument("--input", required=True, help="document directory")
    st.add_argument("--output", default="output.txt",
                    help="top-k output file")
    st.add_argument("--batch-docs", type=int, default=256,
                    help="documents per minibatch")
    st.add_argument("--doc-len", type=int, default=256,
                    help="static tokens per document (longer docs are "
                         "truncated; one shape for the whole stream)")
    st.add_argument("--vocab-size", type=int, default=1 << 16)
    st.add_argument("--topk", type=int, default=8)
    st.add_argument("--mesh-docs", type=int, default=None,
                    help="shard each minibatch over this many devices "
                         "(0 = all); the DF update becomes the incremental "
                         "psum of BASELINE config 5")
    st.add_argument("--checkpoint", default=None,
                    help="checkpoint directory; state is saved after "
                         "every minibatch")
    st.add_argument("--resume", action="store_true",
                    help="restore from --checkpoint and skip the "
                         "documents already folded into the DF state")
    st.add_argument("--no-strict", action="store_true")
    st.add_argument("--timing", action="store_true",
                    help="print per-phase wall-clock (pass1/pass2/emit) "
                         "and docs/sec to stderr")
    st.add_argument("--trace", default=None,
                    help="record spans and write them as Chrome trace "
                         "JSON to this path (or TFIDF_TPU_TRACE)")
    st.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    q = sub.add_parser(
        "query", help="index a corpus and run ranked cosine retrieval")
    q.add_argument("--input", required=True, help="document directory")
    q.add_argument("--query", action="append", required=True,
                   help="query text (repeatable)")
    q.add_argument("-k", type=int, default=5, help="results per query")
    q.add_argument("--vocab-size", type=int, default=1 << 16)
    q.add_argument("--mesh-docs", type=int, default=None,
                   help="shard the index over this many devices (0 = all)")
    q.add_argument("--doc-len", type=int, default=None,
                   help="static tokens per document: index via the "
                        "overlapped ingest's chunk step (native loader; "
                        "longer docs truncated). Single-device only")
    q.add_argument("--compile-cache", metavar="DIR", default=None,
                   help=_COMPILE_CACHE_HELP)
    q.add_argument("--no-strict", action="store_true")
    q.add_argument("--trace", default=None,
                   help="record spans and write them as Chrome trace "
                        "JSON to this path (or TFIDF_TPU_TRACE)")
    q.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the "
                        "kernels' plain versions)")
    sv = sub.add_parser(
        "serve",
        help="index a corpus and serve ranked retrieval online (JSONL "
             "request loop over stdin or TCP)",
        epilog=_SERVE_EPILOG,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sv.add_argument("--input", required=True, help="document directory")
    sv.add_argument("--vocab-size", type=int, default=1 << 16)
    sv.add_argument("--doc-len", type=int, default=None,
                    help="static tokens per document: index via the "
                         "overlapped ingest's chunk step (native loader; "
                         "longer docs truncated); default whole-corpus "
                         "batch path")
    sv.add_argument("-k", type=int, default=10,
                    help="default results per query (requests may "
                         "override per line)")
    sv.add_argument("--max-batch", type=int, default=None,
                    help="most queries one coalesced device batch "
                         "carries (default 256; env TFIDF_TPU_MAX_BATCH)")
    sv.add_argument("--max-wait-ms", type=float, default=None,
                    help="micro-batching window: the oldest queued "
                         "request never waits longer than this for the "
                         "batch to fill (default 2; env "
                         "TFIDF_TPU_MAX_WAIT_MS)")
    sv.add_argument("--queue-depth", type=int, default=None,
                    help="admission bound in queries; past it requests "
                         "shed with an 'overloaded' error (default 256; "
                         "env TFIDF_TPU_QUEUE_DEPTH)")
    sv.add_argument("--cache-entries", type=int, default=None,
                    help="LRU result-cache capacity in per-query rows; 0 "
                         "disables (default 4096; env "
                         "TFIDF_TPU_CACHE_ENTRIES)")
    sv.add_argument("--deadline-ms", type=float, default=None,
                    help="default per-request deadline; requests still "
                         "queued past it shed with 'deadline_exceeded' "
                         "(default: no deadline)")
    sv.add_argument("--health-period-ms", type=float, default=250.0,
                    help="watchdog cadence (healthz/readyz ops; degraded "
                         "shrinks the admission bound). 0 disables the "
                         "background thread (default 250; env "
                         "TFIDF_TPU_HEALTH_PERIOD_MS)")
    sv.add_argument("--devmon-period-ms", type=float, default=1000.0,
                    help="device-monitor cadence: every period the server "
                         "reads torch.cuda.memory_stats/mem_get_info per "
                         "device into gauges, checks the watermarks "
                         "(TFIDF_TPU_HBM_WATERMARKS) and refreshes the "
                         "memory_pressure health signal. 0 disables the "
                         "thread (default 1000; env "
                         "TFIDF_TPU_DEVMON_PERIOD_MS). On the CPU the "
                         "same path runs with the gauges absent")
    sv.add_argument("--slow-ms", type=float, default=None,
                    help="slow-query threshold: a resolved request over "
                         "this total latency emits a slow_query flight "
                         "event with its per-phase breakdown (env "
                         "TFIDF_TPU_SLOW_MS; default: off)")
    sv.add_argument("--slo-ms", type=float, default=None,
                    help="latency objective of the SLO burn gauges; a "
                         "fast burn degrades health (env "
                         "TFIDF_TPU_SLO_MS; default: off)")
    sv.add_argument("--slo-target", type=float, default=None,
                    help="fraction of requests that must meet --slo-ms "
                         "(default 0.99; env TFIDF_TPU_SLO_TARGET)")
    sv.add_argument("--no-warm", action="store_true",
                    help="skip the power-of-two query-bucket warm-up "
                         "(and its mark_warm() line): the build watchdog "
                         "then never flags a build after warm-up")
    sv.add_argument("--canary-period-ms", type=float, default=5000.0,
                    help="canary parity-probe cadence: replay pinned "
                         "golden queries through the batched path and "
                         "bit-compare against the swap-time oracle. 0 "
                         "disables (default 5000)")
    sv.add_argument("--canary-queries", type=int, default=8,
                    help="pinned golden queries drawn from the corpus "
                         "(first tokens of the first N docs)")
    sv.add_argument("--snapshot-dir", metavar="DIR", default=None,
                    help="index snapshot root (also env "
                         "TFIDF_TPU_SNAPSHOT_DIR): on start a committed "
                         "snapshot (either package's) with a matching "
                         "config fingerprint restores instead of "
                         "re-indexing --input; after a fresh build, and "
                         "before every swap_index flip, the index is "
                         "snapshotted there")
    sv.add_argument("--mesh-shards", type=int, default=None,
                    help="serve one index doc-sharded over this many "
                         "devices (0 = all; env TFIDF_TPU_MESH_SHARDS): "
                         "every install path re-shards")
    sv.add_argument("--compile-cache", metavar="DIR", default=None,
                    help=_COMPILE_CACHE_HELP)
    sv.add_argument("--query-slab", choices=["on", "off"], default=None,
                    help="query slab: a batch's compact query entries "
                         "in pinned slots, one non-blocking H2D copy a "
                         "batch, the block built on the device; 'off' "
                         "fills and uploads a dense block each batch, "
                         "the same bits (default on; env "
                         "TFIDF_TPU_QUERY_SLAB)")
    sv.add_argument("--disttrace", choices=["on", "off"], default=None,
                    help="adopt inbound fleet trace contexts (the "
                         "\"trace\" JSONL field; default on; env "
                         "TFIDF_TPU_DISTTRACE)")
    sv.add_argument("--serve-pipeline-depth", type=int, default=None,
                    metavar="D",
                    help="pipelined serving: up to D dispatched batches in "
                         "flight while the batcher coalesces the next; an "
                         "ordered drain worker materializes them. 1 = "
                         "unpipelined, the same bits (default 2; env "
                         "TFIDF_TPU_SERVE_PIPELINE)")
    sv.add_argument("--score-tiling", choices=["on", "off"], default=None,
                    help="tiled scoring over 4,096-row doc tiles (env "
                         "TFIDF_TPU_QUERY_BLOCK) or 'off': one launch over "
                         "every row in 64-query blocks, the same bits "
                         "(default on; env TFIDF_TPU_SCORE_TILING)")
    sv.add_argument("--delta-docs", type=int, default=None,
                    help="serve a SEGMENTED index with a delta segment of "
                         "this capacity: the add_docs/delete_docs ops "
                         "mutate it live (default: off; env "
                         "TFIDF_TPU_DELTA_DOCS)")
    sv.add_argument("--compact-at", type=int, default=None,
                    help="sealed-segment count at which the background "
                         "compactor merges them (default 4; env "
                         "TFIDF_TPU_COMPACT_AT; needs --delta-docs)")
    sv.add_argument("--replicas", type=int, default=None, metavar="N",
                    help="replicated serving tier: N full server "
                         "processes on the device behind a front that "
                         "owns this protocol (hash-affinity routing, "
                         "two-phase epoch bumps, restarts from "
                         "--snapshot-dir, which it needs; env "
                         "TFIDF_TPU_REPLICAS)")
    sv.add_argument("--replica-timeout-s", type=float, default=None,
                    metavar="S",
                    help="front-side patience per replica: boot, "
                         "response and control round trip (default "
                         "120; env TFIDF_TPU_REPLICA_TIMEOUT_S)")
    sv.add_argument("--scorer", metavar="SPEC", default=None,
                    help="default scoring-family member for requests that "
                         "name none: 'tfidf', 'bm25' or "
                         "'bm25:k1=1.5,b=0.6' (env TFIDF_TPU_SCORER)")
    sv.add_argument("--bm25-k1", type=float, default=None, metavar="K1",
                    help="BM25 k1 of a bare --scorer bm25 (default 1.2; "
                         "env TFIDF_TPU_BM25_K1)")
    sv.add_argument("--bm25-b", type=float, default=None, metavar="B",
                    help="BM25 b of a bare --scorer bm25 (default 0.75; "
                         "env TFIDF_TPU_BM25_B)")
    sv.add_argument("--faults", metavar="PLAN", default=None,
                    help="arm a deterministic fault-injection plan (also "
                         "env TFIDF_TPU_FAULTS; grammar in "
                         "tfidf_tpu_torch/faults.py)")
    sv.add_argument("--fault-seed", type=int, default=None,
                    help="seed of the fault plan's probabilistic rules + "
                         "retry jitter (env TFIDF_TPU_FAULT_SEED)")
    sv.add_argument("--flight", metavar="OUT.jsonl", default=None,
                    help="flight-recorder dump path, written on shutdown "
                         "and SIGTERM (also env TFIDF_TPU_FLIGHT; with "
                         "--trace and no --flight it lands next to the "
                         "trace as <trace>.flight.jsonl)")
    sv.add_argument("--port", type=int, default=None,
                    help="serve JSONL over TCP on this port instead of "
                         "stdin/stdout")
    sv.add_argument("--no-strict", action="store_true")
    sv.add_argument("--trace", default=None,
                    help="record spans and write them as Chrome trace "
                         "JSON to this path (or TFIDF_TPU_TRACE)")
    sv.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    return p


def _run_query(args) -> int:
    """Index + search: ``<name>\t<score>`` per result line."""
    from tfidf_tpu_torch.config import PipelineConfig, VocabMode
    from tfidf_tpu_torch.models import TfidfRetriever

    cfg = PipelineConfig(vocab_mode=VocabMode.HASHED,
                         vocab_size=args.vocab_size)
    plan = None
    if args.mesh_docs is not None:
        plan = _cli_plan({"docs": args.mesh_docs}, args.device)
    if args.doc_len is not None and plan is not None:
        sys.stderr.write("error: query --doc-len (chunked indexing) is "
                         "single-device; drop --mesh-docs\n")
        return 2
    r = TfidfRetriever(cfg, plan=plan, device=args.device).index_dir(
        args.input, strict=not args.no_strict, doc_len=args.doc_len)
    vals, idx = r.search(args.query, k=args.k)
    for qi, text in enumerate(args.query):
        print(f"query: {text}")
        for v, d in zip(vals[qi], idx[qi]):
            if d < 0:
                continue
            print(f"  {r.names[int(d)]}\t{float(v):.6f}")
    return 0


def _serve_handle_line(server, line, write, default_k, build_retriever,
                       canary=None):
    """One JSONL request -> one JSON response line (written via
    ``write``, possibly from a batcher callback thread). Returns False
    when the line asked for shutdown."""
    import json

    from tfidf_tpu_torch.serve import (DeadlineExceeded, Overloaded,
                                       PoisonQuery, ServeError)

    line = line.strip()
    if not line:
        return True
    try:
        req = json.loads(line)
        if not isinstance(req, dict):
            raise ValueError("request must be a JSON object")
    except ValueError as e:
        write({"error": f"bad request: {e}"})
        return True
    op = req.get("op")
    if op == "shutdown":
        return False
    if op == "metrics":
        write({"id": req.get("id"), "metrics": server.metrics_snapshot()})
        return True
    if op == "metrics_prom":
        write({"id": req.get("id"),
               "metrics_prom": server.metrics_prom()})
        return True
    if op == "obs_export":
        write({"id": req.get("id"), "obs_export": server.obs_export()})
        return True
    if op == "trace_export":
        # The replica half of the fleet span pull: the front's
        # trace_export() collects this bundle over the SAME data plane
        # as obs_export and stamps identity + clock offset on each
        # entry. A process with no armed tracer answers an empty
        # bundle (never an error — the merge just has one fewer lane).
        from tfidf_tpu_torch import obs
        t = obs.get_tracer()
        procs = ([{**t.export_meta(), "traceEvents": t.chrome_events()}]
                 if t is not None else [])
        write({"id": req.get("id"),
               "trace_export": {"schema": "tfidf-trace/1",
                                "pid": os.getpid(),
                                "processes": procs}})
        return True
    if op == "healthz":
        write({"id": req.get("id"), "healthz": server.healthz()})
        return True
    if op == "readyz":
        write({"id": req.get("id"), "readyz": server.readyz()})
        return True
    if op == "devmon":
        if server.devmon is None:
            write({"id": req.get("id"),
                   "error": "device monitor disabled "
                            "(--devmon-period-ms 0)"})
        else:
            snap = server.devmon.sample()
            snap["census"] = server.devmon.census()
            write({"id": req.get("id"), "devmon": snap})
        return True
    if op == "canary":
        if canary is None:
            write({"id": req.get("id"),
                   "error": "canary prober disabled "
                            "(--canary-period-ms 0)"})
        else:
            parity = canary.probe()
            write({"id": req.get("id"), "canary": (
                {"skipped": True} if parity is None
                else {"parity": parity})})
        return True
    if op == "swap_index":
        try:
            epoch = server.swap_index(build_retriever(req["input"]))
            write({"id": req.get("id"), "swapped": True, "epoch": epoch})
        except (KeyError, ValueError, OSError) as e:
            write({"id": req.get("id"), "error": f"swap failed: {e}"})
        return True
    if op == "snapshot":
        try:
            path = server.snapshot()
            write({"id": req.get("id"), "snapshot": path,
                   "epoch": server.epoch})
        except (ValueError, OSError, RuntimeError) as e:
            write({"id": req.get("id"), "error": f"snapshot failed: {e}"})
        return True
    if op == "add_docs":
        docs = req.get("docs")
        if (not isinstance(docs, list) or not docs or not all(
                isinstance(d, dict) and isinstance(d.get("name"), str)
                and isinstance(d.get("text"), str) for d in docs)):
            write({"id": req.get("id"),
                   "error": "bad request: 'docs' must be a non-empty "
                            "list of {\"name\": str, \"text\": str}"})
            return True
        try:
            out = server.add_docs([d["name"] for d in docs],
                                  [d["text"] for d in docs])
            write({"id": req.get("id"), "added": out["added"],
                   "updated": out["updated"], "sealed": out["sealed"],
                   "epoch": out["epoch"]})
        except (RuntimeError, ValueError) as e:
            write({"id": req.get("id"), "error": f"add_docs failed: {e}"})
        return True
    if op == "delete_docs":
        names = req.get("names")
        if (not isinstance(names, list) or not names
                or not all(isinstance(n, str) for n in names)):
            write({"id": req.get("id"),
                   "error": "bad request: 'names' must be a non-empty "
                            "list of strings"})
            return True
        try:
            out = server.delete_docs(names)
            write({"id": req.get("id"), "deleted": out["deleted"],
                   "missing": out["missing"], "epoch": out["epoch"]})
        except (RuntimeError, ValueError) as e:
            write({"id": req.get("id"),
                   "error": f"delete_docs failed: {e}"})
        return True
    if op == "set_scorer":
        try:
            epoch = server.set_scorer(req.get("scorer"))
            write({"id": req.get("id"),
                   "scorer": server.default_scorer_key(),
                   "epoch": epoch})
        except (ValueError, TypeError) as e:
            write({"id": req.get("id"),
                   "error": f"set_scorer failed: {e}"})
        return True
    if op is not None:
        write({"id": req.get("id"), "error": f"unknown op {op!r}"})
        return True

    line_id = req.get("id")
    queries = req.get("queries")
    if not isinstance(queries, list) or not all(
            isinstance(q, str) for q in queries):
        write({"id": line_id, "error": "bad request: 'queries' must be a "
                                   "list of strings"})
        return True
    k = int(req.get("k", default_k))
    names = server.doc_names()
    # Fleet trace adoption: a front-routed request arrives
    # with a compact trace context; malformed/missing/disabled all
    # degrade to None — the request proceeds rid-only, never fails.
    from tfidf_tpu_torch.obs import disttrace
    tctx = disttrace.from_wire(req.get("trace"))

    def on_done(f):
        # The request id rides every response line — the
        # client-visible half of the forensic join: the same rid is
        # on the request's spans, its flight digest and any
        # slow_query event.
        extra = ({"rid": f.rid}
                 if getattr(f, "rid", None) is not None else {})
        if getattr(f, "trace", None) is not None:
            # The fleet trace id echoes next to the rid: the front
            # (and doctor --request) join this response to the spans
            # every process recorded under the same t<16hex> key.
            extra["trace"] = f.trace
        if getattr(f, "epoch", None) is not None:
            # The admitted epoch on every response line: the
            # replicated front's mixed-epoch audit (and any client's
            # consistency check) reads it straight off the protocol.
            extra["epoch"] = f.epoch
        err = f.exception()
        if isinstance(err, Overloaded):
            write({"id": line_id, "error": "overloaded", **extra})
        elif isinstance(err, DeadlineExceeded):
            write({"id": line_id, "error": "deadline_exceeded", **extra})
        elif isinstance(err, PoisonQuery):
            write({"id": line_id, "error": "poison_query",
                   "detail": str(err), **extra})
        elif err is not None:
            write({"id": line_id, "error": str(err), **extra})
        else:
            vals, idx = f.result()
            write({"id": line_id, "results": [
                [[names[int(d)], float(v)]
                 for v, d in zip(vrow, irow) if d >= 0]
                for vrow, irow in zip(vals, idx)], **extra})

    try:
        server.submit(queries, k,
                      deadline_ms=req.get("deadline_ms"),
                      use_cache=bool(req.get("use_cache", True)),
                      scorer=req.get("scorer"),
                      filter=req.get("filter"),
                      trace=(tctx.trace if tctx is not None else None)
                      ).add_done_callback(on_done)
    except (ValueError, TypeError) as e:  # malformed scorer/filter spec
        write({"id": line_id, "error": f"bad request: {e}"})
    except PoisonQuery as e:     # quarantined: the protocol's 4xx
        write({"id": line_id, "error": "poison_query", "detail": str(e),
               **({"rid": e.rid} if getattr(e, "rid", None) else {})})
    except (Overloaded, ServeError) as e:
        write({"id": line_id,
               "error": "overloaded" if isinstance(e, Overloaded)
               else str(e),
               **({"rid": e.rid} if getattr(e, "rid", None) else {})})
    return True


def _run_serve(args) -> int:
    """Online serving loop: JSONL requests over stdin/stdout (or TCP with
    --port) against a TfidfServer. Responses come back in COMPLETION
    order; clients correlate by "id"."""
    import json
    import threading
    import time

    from tfidf_tpu_torch import checkpoint as ckpt
    from tfidf_tpu_torch.config import PipelineConfig, ServeConfig, VocabMode
    from tfidf_tpu_torch.models import TfidfRetriever
    from tfidf_tpu_torch.obs import log as obs_log
    from tfidf_tpu_torch.pipeline import resolve_device
    from tfidf_tpu_torch.serve import TfidfServer

    # Fail before any work (and before any replica is spawned) when no
    # device was named and there is no GPU.
    device = resolve_device(args.device)
    if args.score_tiling is not None:
        # The knob is read at dispatch time, so the env var is the one
        # source of truth for every consumer (flat and segmented).
        os.environ["TFIDF_TPU_SCORE_TILING"] = args.score_tiling
    cfg = PipelineConfig(vocab_mode=VocabMode.HASHED,
                         vocab_size=args.vocab_size)

    def build_retriever(input_dir: str) -> TfidfRetriever:
        return TfidfRetriever(cfg, device=device).index_dir(
            input_dir, strict=not args.no_strict, doc_len=args.doc_len)

    serve_cfg = ServeConfig.from_env(
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        queue_depth=args.queue_depth, cache_entries=args.cache_entries,
        default_deadline_ms=args.deadline_ms,
        health_period_ms=args.health_period_ms,
        devmon_period_ms=args.devmon_period_ms,
        snapshot_dir=args.snapshot_dir, faults=args.faults,
        fault_seed=args.fault_seed, slow_ms=args.slow_ms,
        slo_ms=args.slo_ms, slo_target=args.slo_target,
        delta_docs=args.delta_docs, compact_at=args.compact_at,
        query_slab=(None if args.query_slab is None
                    else args.query_slab == "on"),
        disttrace=(None if args.disttrace is None
                   else args.disttrace == "on"),
        pipeline_depth=args.serve_pipeline_depth,
        mesh_shards=args.mesh_shards,
        replicas=args.replicas,
        replica_timeout_s=args.replica_timeout_s,
        scorer=args.scorer, bm25_k1=args.bm25_k1, bm25_b=args.bm25_b)
    if serve_cfg.disttrace is not None:
        from tfidf_tpu_torch.obs import disttrace
        disttrace.configure(serve_cfg.disttrace)

    if serve_cfg.replicas:
        # Replicated tier: this process becomes the FRONT. It owns the
        # protocol and the replicas own the indexes; nothing below
        # (restore, warm, canary, compactor) happens here.
        return _run_serve_front(args, cfg, serve_cfg, device)

    # A committed snapshot (either package's) with a matching config
    # fingerprint restores the resident index without reading the
    # corpus; a mismatched one falls back to the build, loudly.
    retriever = None
    restored_meta = None
    segments = None
    if serve_cfg.delta_docs:
        from tfidf_tpu_torch.index import SegmentedIndex
        if serve_cfg.snapshot_dir and ckpt.exists(serve_cfg.snapshot_dir):
            t0 = time.monotonic()
            try:
                segments, restored_meta = SegmentedIndex.restore(
                    serve_cfg.snapshot_dir, cfg, device=device)
            except ckpt.SnapshotMismatch as e:
                sys.stderr.write(
                    f"snapshot at {serve_cfg.snapshot_dir} unusable "
                    f"({e}); rebuilding from --input\n")
            else:
                obs_log.log_event(
                    "info", "index_restored",
                    msg=f"segmented index restored from "
                        f"{serve_cfg.snapshot_dir} "
                        f"(epoch {restored_meta.get('epoch', 0)}, "
                        f"{segments.num_docs} live docs) in "
                        f"{time.monotonic() - t0:.3f}s",
                    epoch=restored_meta.get("epoch", 0),
                    docs=segments.num_docs,
                    restore_s=round(time.monotonic() - t0, 4))
        if segments is None:
            segments = SegmentedIndex.from_dir(
                args.input, cfg, delta_docs=serve_cfg.delta_docs,
                compact_at=serve_cfg.compact_at,
                strict=not args.no_strict, device=device)
        retriever = segments.view()
    elif serve_cfg.snapshot_dir and ckpt.exists(serve_cfg.snapshot_dir):
        t0 = time.monotonic()
        try:
            retriever, restored_meta = TfidfRetriever.restore(
                serve_cfg.snapshot_dir, cfg, device=device)
        except ckpt.SnapshotMismatch as e:
            sys.stderr.write(f"snapshot at {serve_cfg.snapshot_dir} "
                             f"unusable ({e}); rebuilding from --input\n")
        else:
            obs_log.log_event(
                "info", "index_restored",
                msg=f"index restored from {serve_cfg.snapshot_dir} "
                    f"(epoch {restored_meta.get('epoch', 0)}, "
                    f"{retriever._num_docs} docs) in "
                    f"{time.monotonic() - t0:.3f}s — corpus not "
                    f"re-indexed",
                epoch=restored_meta.get("epoch", 0),
                docs=retriever._num_docs,
                restore_s=round(time.monotonic() - t0, 4))
    if retriever is None:
        retriever = build_retriever(args.input)
    server = TfidfServer(
        retriever, serve_cfg,
        initial_epoch=(int(restored_meta.get("epoch", 0))
                       if restored_meta else 0))
    compactor = None
    if segments is not None:
        from tfidf_tpu_torch.index import Compactor
        server.attach_segments(segments)
        compactor = Compactor(
            server.compact_now,
            restart_budget=serve_cfg.restart_budget).start()
    if serve_cfg.snapshot_dir and restored_meta is None:
        # First boot on this snapshot root: persist the fresh build so
        # the next start restores.
        server.snapshot()
    if not args.no_warm:
        # Search every power-of-two query bucket steady state can see
        # (empty queries stage the same blocks): on the card this builds
        # the kernels at first use and fills every query-slab ring, so
        # from mark_warm() on a native build is a recompile after warm.
        # Warm the INSTALLED index (the server may have sharded it) and a
        # sharded index's single-device source, the canary's oracle.
        _, installed = server.current_index()
        warm_targets = [installed]
        oracle = getattr(installed, "parity_oracle", lambda: None)()
        if oracle is not None:
            warm_targets.append(oracle)
        b = 1
        while b <= serve_cfg.max_batch:
            for target in warm_targets:
                target.search([""] * b, k=args.k)
            b *= 2
        server.mark_warm()
    # The serve process's monitor is THE process monitor: workers that
    # beat through the module hook land in the same health view.
    from tfidf_tpu_torch.obs import health as obs_health
    obs_health.set_monitor(server.health)
    canary = None
    if args.canary_period_ms and args.canary_period_ms > 0:
        from tfidf_tpu_torch.serve import (CanaryProber,
                                           pinned_queries_from_dir)
        try:
            pinned = pinned_queries_from_dir(args.input,
                                             n=args.canary_queries,
                                             strict=not args.no_strict)
        except (OSError, ValueError):
            # Snapshot-restored server without the corpus on disk: no
            # pinned queries to derive, so serve without the canary.
            pinned = []
        if pinned:
            canary = CanaryProber(
                server, pinned, k=args.k,
                period_s=args.canary_period_ms / 1e3).start()
    snap_state = ("restored" if restored_meta
                  else "on" if serve_cfg.snapshot_dir else "off")
    mesh = serve_cfg.mesh_shards
    sys.stderr.write(f"serving {server.num_docs} docs on {device} "
                     f"(max_batch={serve_cfg.max_batch}, "
                     f"max_wait_ms={serve_cfg.max_wait_ms}, "
                     f"queue_depth={serve_cfg.queue_depth}, "
                     f"cache_entries={serve_cfg.cache_entries}, "
                     f"pipeline_depth={serve_cfg.pipeline_depth}, "
                     f"health_period_ms={serve_cfg.health_period_ms}, "
                     f"canary={'on' if canary else 'off'}, "
                     f"snapshot={snap_state}, "
                     f"faults={'armed' if serve_cfg.faults else 'off'}, "
                     f"segments="
                     f"{'on' if segments is not None else 'off'}, "
                     f"mesh={'off' if mesh is None else mesh})\n")

    prev_term = _install_sigterm_dump()
    try:
        if args.port is not None:
            def handle(line, write):
                return _serve_handle_line(server, line, write, args.k,
                                          build_retriever, canary)

            def on_close():
                if canary is not None:
                    canary.close()
                server.close(drain=True)
            return _serve_tcp(handle, args.port, on_close)
        # Responses may be written from batcher callback threads while
        # the main thread blocks on the next stdin line: one lock keeps
        # the JSONL stream line-atomic.
        wlock = threading.Lock()

        def write(obj) -> None:
            with wlock:
                sys.stdout.write(json.dumps(obj) + "\n")
                sys.stdout.flush()

        try:
            for line in sys.stdin:
                if not _serve_handle_line(server, line, write, args.k,
                                          build_retriever, canary):
                    break
        finally:
            if canary is not None:
                canary.close()
            server.close(drain=True)
        return 0
    finally:
        if compactor is not None:
            compactor.stop()
        _restore_sigterm(prev_term)
        obs_health.set_monitor(None)


def _install_sigterm_dump():
    """SIGTERM must leave evidence: dump the flight recorder and the
    trace (atomic writes), then exit 143. Returns the previous handler
    (restored by the caller — in-process test runs must not leak a
    handler into the host process). No-op off the main thread or on
    platforms without signals."""
    import signal
    import threading as _threading

    if _threading.current_thread() is not _threading.main_thread():
        return None

    def _on_term(signum, frame):
        from tfidf_tpu_torch import obs
        obs.get_log().warning("sigterm",
                              msg="SIGTERM: dumping flight recorder "
                                  "and trace")
        obs.dump_flight()
        obs.export()
        os._exit(143)

    try:
        return signal.signal(signal.SIGTERM, _on_term)
    except (ValueError, OSError):  # non-main interpreter contexts
        return None


def _restore_sigterm(prev) -> None:
    if prev is None:
        return
    import signal
    try:
        signal.signal(signal.SIGTERM, prev)
    except (ValueError, OSError):
        pass


def _serve_tcp(handle_line, port, on_close) -> int:
    """--port mode: the same JSONL protocol over TCP, one thread per
    connection (socketserver), all feeding one shared backend —
    which is the point: their queries coalesce into shared batches.
    ``handle_line(line, write) -> bool`` is the protocol handler;
    ``on_close()`` tears the backend down after the listener stops."""
    import json
    import socketserver
    import threading

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            wlock = threading.Lock()

            def write(obj):
                with wlock:
                    try:
                        self.wfile.write((json.dumps(obj) + "\n").encode())
                        self.wfile.flush()
                    except OSError:
                        pass  # client went away; drop the response

            for raw in self.rfile:
                if not handle_line(raw.decode("utf-8", "replace"),
                                   write):
                    threading.Thread(target=srv.shutdown,
                                     daemon=True).start()
                    return

    class Srv(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    with Srv(("127.0.0.1", port), Handler) as srv:
        sys.stderr.write(f"listening on 127.0.0.1:{srv.server_address[1]}\n")
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            on_close()
    return 0


def _run_serve_front(args, cfg, serve_cfg, device) -> int:
    """--replicas mode: this process is the replicated tier's FRONT.
    It holds no index: it spawns N replica processes on ``device`` off
    --snapshot-dir, routes the JSONL protocol across them, and
    supervises restarts."""
    import json
    import threading

    from tfidf_tpu_torch.serve import FrontError, ReplicatedFront

    front = ReplicatedFront(args.input, cfg, serve_cfg, k=args.k,
                            no_strict=args.no_strict,
                            doc_len=args.doc_len, device=device)
    prev_term = _install_sigterm_dump()
    try:
        try:
            front.start()
        except FrontError as e:
            sys.stderr.write(f"front failed to start: {e}\n")
            front.close()
            return 3
        sys.stderr.write(
            f"front serving {front.n_replicas} replica(s) on {device} "
            f"(epoch={front.epoch}, "
            f"snapshot={serve_cfg.snapshot_dir}, "
            f"restart_budget={serve_cfg.restart_budget}, "
            f"timeout_s={serve_cfg.replica_timeout_s})\n")
        if args.port is not None:
            return _serve_tcp(front.handle_line, args.port,
                              front.close)
        wlock = threading.Lock()

        def write(obj) -> None:
            with wlock:
                sys.stdout.write(json.dumps(obj) + "\n")
                sys.stdout.flush()

        try:
            for line in sys.stdin:
                if not front.handle_line(line, write):
                    break
        finally:
            front.close()
        return 0
    finally:
        _restore_sigterm(prev_term)


def _write_topk(path: str, result) -> None:
    """Top-k report: doc@word\\tscore lines in raw-line strcmp order,
    the same format as the JAX CLI's ``run --topk``."""
    lines: List[bytes] = []
    for d in range(result.num_docs):
        name = result.names[d].encode()
        for v, s in zip(result.topk_ids[d], result.topk_vals[d]):
            if s <= 0:
                continue  # padding / sub-k docs
            word = result.id_to_word.get(int(v), b"id:%d" % int(v))
            lines.append(b"%s@%s\t%.16f" % (name, word, float(s)))
    lines.sort()
    with open(path, "wb") as f:
        f.write(b"".join(line + b"\n" for line in lines))


def _run_stream(args) -> int:
    """Two-pass streaming job: fold DF per minibatch (checkpointing as it
    goes), then score every minibatch against the corpus-wide DF.

    Resume contract: documents stream in the deterministic discovery
    order, so ``docs_seen`` from a restored checkpoint is the exact
    restart position.
    """
    import types

    import numpy as np

    from tfidf_tpu_torch import checkpoint as ckpt
    from tfidf_tpu_torch.config import PipelineConfig, VocabMode
    from tfidf_tpu_torch.ingest import make_chunk_packer
    from tfidf_tpu_torch.io.corpus import PackedBatch, discover_names
    from tfidf_tpu_torch.pipeline import _host
    from tfidf_tpu_torch.streaming import StreamingTfidf
    from tfidf_tpu_torch.utils.timing import PhaseTimer, phase_or_null

    cfg = PipelineConfig(vocab_mode=VocabMode.HASHED,
                         vocab_size=args.vocab_size, topk=args.topk,
                         max_doc_len=args.doc_len, doc_chunk=args.doc_len)
    plan = None
    if args.mesh_docs is not None:
        plan = _cli_plan({"docs": args.mesh_docs}, args.device)
        if args.batch_docs % plan.n_docs_shards:
            sys.stderr.write("error: --batch-docs must be a multiple of "
                             "--mesh-docs (rows block-shard evenly)\n")
            return 2
    stream = StreamingTfidf(cfg, plan, device=args.device)
    names = discover_names(args.input, strict=not args.no_strict)
    if not names:
        sys.stderr.write(f"error: no documents in {args.input}\n")
        return 1

    start = 0
    if args.resume and args.checkpoint and ckpt.exists(args.checkpoint):
        stream.load_state(ckpt.restore_state(args.checkpoint))
        start = stream.docs_seen
        print(f"resumed at doc {start} ({args.checkpoint})")

    # Minibatches come off the native parallel loader when it builds
    # (uint16 ids), else the Python pack path: the ingest's packer. Every
    # batch is padded to batch_docs x doc_len.
    packer = make_chunk_packer(args.input, cfg, args.batch_docs,
                               args.doc_len)

    def batches(from_doc: int):
        for lo in range(from_doc, len(names), args.batch_docs):
            batch_names = names[lo:lo + args.batch_docs]
            token_ids, lengths = packer(batch_names)
            # PackedBatch invariant: one name per row, '' for padding.
            padded = batch_names + [""] * (token_ids.shape[0]
                                           - len(batch_names))
            yield PackedBatch(
                token_ids=token_ids, lengths=lengths,
                num_docs=len(batch_names), names=padded,
                vocab_size=cfg.vocab_size, id_to_word=None)

    timer = PhaseTimer() if args.timing else None

    # Pass 1: fold DF, checkpoint after every minibatch.
    with phase_or_null(timer, "pass1_df"):
        for batch in batches(start):
            stream.update(batch)
            if args.checkpoint:
                ckpt.save_state(args.checkpoint, stream.state_dict())
    print(f"df folded over {stream.docs_seen} docs")

    # Pass 2: score all minibatches against the final DF snapshot.
    all_names: List[str] = []
    all_vals, all_ids = [], []
    with phase_or_null(timer, "pass2_score"):
        for batch in batches(0):
            vals, ids = stream.score(batch)
            if not isinstance(vals, np.ndarray):  # the pair wire
                vals, ids = _host(vals), _host(ids)
            all_names.extend(batch.names[:batch.num_docs])
            all_vals.append(vals[:batch.num_docs])
            all_ids.append(ids[:batch.num_docs])
    report = types.SimpleNamespace(
        num_docs=len(all_names), names=all_names,
        topk_vals=np.concatenate(all_vals), topk_ids=np.concatenate(all_ids),
        id_to_word={})
    with phase_or_null(timer, "emit"):
        _write_topk(args.output, report)  # same format as `run --topk`
    if timer is not None:
        total = sum(timer.as_dict().values()) or 1.0
        sys.stderr.write(timer.report() + f"\n{'docs/sec':>12}: "
                         f"{len(all_names) / total:9.1f}\n")
    print(f"wrote {args.output} ({stream.docs_seen} docs)")
    return 0


def _overlapped(args, cfg, exact_terms: bool) -> Optional[bool]:
    """The JAX CLI's gating of ``--doc-len`` runs: True to take the
    overlapped ingest, False for the batch pipeline, None after an error
    message (exit 2). Prints the same warnings as the JAX CLI."""
    from tfidf_tpu_torch.config import TokenizerKind, VocabMode
    from tfidf_tpu_torch.ingest import use_bytes_wire
    from tfidf_tpu_torch.ops.downlink import use_packed_result_wire

    if args.doc_len is not None and args.doc_len < 1:
        sys.stderr.write("error: --doc-len must be >= 1\n")
        return None
    if args.chunk_docs is not None and args.chunk_docs < 1:
        sys.stderr.write("error: --chunk-docs must be >= 1\n")
        return None
    if args.doc_len is None and (args.spill is not None
                                 or args.chunk_docs is not None):
        sys.stderr.write("error: --spill/--chunk-docs only apply to "
                         "--doc-len (overlapped ingest) runs\n")
        return None
    # --mesh composes with --doc-len for docs-only meshes (the mesh
    # ingest); seq/vocab meshes stay on the batch path.
    mesh_ok = (cfg.mesh_shape.get("seq", 1) == 1
               and cfg.mesh_shape.get("vocab", 1) == 1)
    overlapped = (args.doc_len is not None
                  and cfg.vocab_mode is VocabMode.HASHED
                  and cfg.topk is not None
                  and cfg.tokenizer is TokenizerKind.WHITESPACE
                  and mesh_ok and not args.pallas
                  and cfg.engine == "sparse")
    if args.finish == "scan" and overlapped \
            and (not use_packed_result_wire(cfg) or exact_terms):
        sys.stderr.write(
            "warning: --finish=scan needs the packed result wire; "
            "falling back to the chunked/fused finish (the pair "
            "and exact wires' fused finish program is already one "
            "dispatch)\n")
    if args.wire == "bytes" and (
            not overlapped or exact_terms or cfg.mesh_shape
            or not use_bytes_wire(cfg, args.chunk_docs or 8192,
                                  args.doc_len or cfg.max_doc_len)):
        sys.stderr.write(
            "warning: --wire=bytes needs a single-device hashed "
            "whitespace --doc-len run with vocab <= 2^16; falling "
            "back to the ragged/padded id wire\n")
    if args.doc_len is not None and not overlapped:
        sys.stderr.write("error: --doc-len (overlapped ingest) needs "
                         "--vocab-mode hashed, --topk, the whitespace "
                         "tokenizer, the sparse engine, no --pallas, "
                         "and a docs-only --mesh (seq=1, vocab=1) if "
                         "any\n")
        return None
    return overlapped


def _run_mpi(args) -> int:
    """The native bit-reference (the ``--backend=mpi`` oracle), built
    with g++ into ``tfidf_tpu_torch/_build/`` at first use."""
    import subprocess

    from tfidf_tpu_torch.ops import _build
    try:
        exe = _build.load_oracle()
    except (OSError, RuntimeError) as e:
        sys.stderr.write(f"error: native backend not built ({e})\n")
        return 1
    return subprocess.run([str(exe), args.input, args.output,
                           str(args.nranks), args.comm]).returncode


def _timing_report(timer, throughput, engine: Optional[str] = None) -> None:
    sys.stderr.write(timer.report() + "\n"
                     f"{'docs/sec':>12}: {throughput.docs_per_sec:9.1f}\n")
    if engine is not None:
        sys.stderr.write(f"{'engine':>12}: {engine}\n")


def _cli_plan(mesh_shape: dict, device):
    """The mesh ingest's plan for ``--mesh``: docs = N takes the first N
    devices (0 = all), so a sub-mesh runs on any host; None without a
    mesh."""
    if not mesh_shape:
        return None
    from tfidf_tpu_torch.parallel.mesh import MeshPlan, default_devices
    n = mesh_shape.get("docs", 0)
    devs = default_devices(device, n)
    return MeshPlan.create(docs=n, devices=devs[:n] if n else devs)


def _run(args) -> int:
    import time
    import types

    from tfidf_tpu_torch.config import PipelineConfig, TokenizerKind, VocabMode
    from tfidf_tpu_torch.formatter import write_output
    from tfidf_tpu_torch.io.corpus import discover_corpus, discover_names
    from tfidf_tpu_torch.obs import devmon
    from tfidf_tpu_torch.pipeline import TfidfPipeline
    from tfidf_tpu_torch.utils.timing import (PhaseTimer, Throughput,
                                              phase_or_null)

    mesh_shape = {}
    if args.mesh:
        docs, seq, vocab = (int(x) for x in args.mesh.split(","))
        mesh_shape = {"docs": docs, "seq": seq, "vocab": vocab}
    workers = args.ingest_workers
    if workers is None:
        workers = int(os.environ.get("TFIDF_TPU_INGEST_WORKERS", "1") or 1)
    if workers < 1:
        sys.stderr.write("error: --ingest-workers must be >= 1\n")
        return 2
    lo, hi = (int(x) for x in args.ngram.split(","))
    exact_terms = args.exact_terms
    if exact_terms and (args.topk is None or args.vocab_mode != "hashed"
                        or args.tokenizer != "whitespace"):
        sys.stderr.write("error: --exact-terms needs --topk, "
                         "--vocab-mode hashed, and the whitespace "
                         "tokenizer\n")
        return 2
    cfg = PipelineConfig(
        vocab_mode=VocabMode(args.vocab_mode), vocab_size=args.vocab_size,
        tokenizer=TokenizerKind(args.tokenizer), ngram_range=(lo, hi),
        # the hashed exact-terms engine keeps a margin of candidates
        topk=(max(2, args.exact_margin) * args.topk if exact_terms
              else args.topk),
        engine=args.engine, use_pallas=args.pallas, mesh_shape=mesh_shape,
        result_wire=args.result_wire, score_dtype=args.score_dtype,
        wire=args.wire, pack_threads=args.pack_threads,
        finish=args.finish or "scan", compile_cache=args.compile_cache)
    strict = not args.no_strict
    # Device memory sampling (TFIDF_TPU_DEVMON): when armed, a global
    # DeviceMonitor samples in the background and the run's epilog takes
    # a last sample and a census into the flight recorder's ring
    # (tools/doctor.py reads it from the dump).
    devmon.configure()
    timer = PhaseTimer() if args.timing else None
    throughput = Throughput()

    corpus = None
    if args.inspect:
        from tfidf_tpu_torch.golden import inspect_tables
        corpus = discover_corpus(args.input, strict=strict)
        if len(corpus) > 200:
            sys.stderr.write(f"warning: --inspect prints every record "
                             f"({len(corpus)} docs) — meant for toy "
                             f"corpora\n")
        sys.stdout.buffer.write(inspect_tables(corpus))
        sys.stdout.buffer.flush()
    overlapped = _overlapped(args, cfg, exact_terms)
    if overlapped is None:
        return 2
    if workers > 1 and (mesh_shape or exact_terms or not overlapped):
        sys.stderr.write(
            "warning: --ingest-workers needs a single-device hashed "
            "--doc-len run (no --mesh, no --exact-terms); running "
            "single-process\n")
        workers = 1
    if overlapped and exact_terms and not mesh_shape:
        from tfidf_tpu_torch.rerank import exact_terms_lines
        n_docs = (len(corpus) if corpus is not None
                  else len(discover_names(args.input, strict)))
        t0 = time.perf_counter()
        lines, engine, _ = exact_terms_lines(
            args.input, cfg, k=args.topk, doc_len=args.doc_len,
            chunk_docs=args.chunk_docs or 8192, strict=strict,
            spill=args.spill or "auto", device=args.device)
        throughput.record(n_docs, time.perf_counter() - t0)
        with phase_or_null(timer, "emit"):
            # already in the reference's strcmp order
            with open(args.output, "wb") as f:
                f.write(lines)
        _census()
        if timer is not None:
            _timing_report(timer, throughput, engine)
        print(f"wrote {args.output} ({n_docs} docs)")
        return 0
    t0 = time.perf_counter()
    if overlapped:
        from tfidf_tpu_torch.ingest import run_overlapped
        # Exact-terms runs (here: on a mesh) read only candidate
        # buckets, so they take the ids-only wire.
        kw = dict(doc_len=args.doc_len, chunk_docs=args.chunk_docs or 8192,
                  strict=strict, spill=args.spill or "auto")
        if workers > 1:
            from tfidf_tpu_torch.parallel.multihost import run_sharded_ingest
            r, info = run_sharded_ingest(args.input, cfg, n_workers=workers,
                                         device=args.device, **kw)
            sys.stderr.write(
                f"sharded ingest: {info.n_workers} workers, upload "
                f"{info.upload_s:.3f}s (max over links), utilization "
                f"{info.link_utilization}\n")
        else:
            r = run_overlapped(args.input, cfg, wire_vals=not exact_terms,
                               plan=_cli_plan(mesh_shape, args.device),
                               device=args.device, **kw)
        result = types.SimpleNamespace(
            num_docs=r.num_docs, names=r.names, topk_vals=r.topk_vals,
            topk_ids=r.topk_ids, id_to_word={}, df=r.df,
            df_occupied=r.df_occupied)
        if timer is not None:
            for name, secs in (r.phases or {}).items():
                timer.add(name, secs)
    else:
        if corpus is None:
            with phase_or_null(timer, "discover"):
                corpus = discover_corpus(args.input, strict=strict)
        pipe = TfidfPipeline(cfg, timer=timer, device=args.device)
        result = pipe.run(corpus)
    throughput.record(result.num_docs, time.perf_counter() - t0)
    with phase_or_null(timer, "emit"):
        if args.topk is None:
            write_output(args.output, result.output_lines())
        elif exact_terms:
            from tfidf_tpu_torch.rerank import exact_topk
            occ = getattr(result, "df_occupied", None)
            reranked = exact_topk(args.input, result.names, result.topk_ids,
                                  result.num_docs, cfg, k=args.topk,
                                  df=None if occ is not None else result.df,
                                  df_occupied=occ,
                                  max_tokens=args.doc_len if overlapped
                                  else None)
            lines = sorted(b"%s@%s\t%.16f" % (name.encode(), w, s)
                           for name in result.names if name
                           for w, s in reranked[name])
            with open(args.output, "wb") as f:
                f.write(b"".join(line + b"\n" for line in lines))
        else:
            _write_topk(args.output, result)
    _census()
    if timer is not None:
        _timing_report(timer, throughput)
    print(f"wrote {args.output} ({result.num_docs} docs)")
    return 0


def _census() -> None:
    """The run's epilog under ``TFIDF_TPU_DEVMON``: a last sample and a
    census into the flight recorder's ring (the ``hbm_census`` event)."""
    from tfidf_tpu_torch.obs import devmon
    mon = devmon.get_monitor()
    if mon is not None:
        mon.sample()
        mon.log_census()


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.cmd == "run" and args.backend == "mpi":
        return _run_mpi(args)
    # Arm the span tracer (--trace / TFIDF_TPU_TRACE; a no-op when neither
    # is set) and the flight recorder (--flight / TFIDF_TPU_FLIGHT, or next
    # to the trace as <trace>.flight.jsonl); export both on any exit, a
    # failed run's included: trace and flight are one incident's evidence.
    from tfidf_tpu_torch import obs
    obs.configure(args.trace)
    obs.configure_flight(getattr(args, "flight", None))
    try:
        if args.cmd == "serve":
            return _run_serve(args)
        if args.cmd == "run":
            return _run(args)
        if args.cmd == "query":
            return _run_query(args)
        return _run_stream(args)
    finally:
        path = obs.export()
        if path:
            sys.stderr.write(f"trace written to {path} (open in "
                             f"Perfetto; check: tools/trace_check.py)\n")
        fpath = obs.dump_flight()
        if fpath:
            sys.stderr.write(f"flight recorder dumped to {fpath} "
                             f"(check: tools/trace_check.py "
                             f"--flight)\n")


if __name__ == "__main__":
    sys.exit(main())
