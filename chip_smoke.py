#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tfidf_tpu_torch``) on one GPU and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON line (``at_s``: seconds since the script
started):

1. ``env``: torch/CUDA versions, the card and its power limit; builds the
   CUDA kernels from ``tfidf_tpu_torch/csrc`` with nvcc (sm_90a).
2. ``kernel_cases``: every kernel at the main path's shapes, on the card,
   against its plain PyTorch version on the same inputs (float32,
   bfloat16 and float16 scores): ints, ids and words exact, scores
   bit-equal. B1 also runs k = 1 and 64, a tie-heavy batch (one idf for
   every term; rows whose head slots all score the same, rows with
   exactly k, k - 1 or 5 head slots, rows with none) and rows of 16,384
   slots (Zipf rows, and uniform rows with more head slots than a warp's
   shared-memory list, which take the per-lane column path at k 16 and
   64 and the rescan path at k 65); its yardstick is
   ``torch.topk`` of a precomputed ``sparse_scores`` block (the selection
   half only). B2 (TF/DF) runs through the wrapper and as its launch
   alone into outputs filled with -1 first, on the dense batch with and
   without df, with ``id_offset``, uint16 ids, V 4,095 (rows off
   a 16-byte boundary), V 1, V 40,000 at D 512 (five vocab tiles), D 1,
   zero lengths, negative lengths and lengths past L, ids out of range
   and the golden path's exact vocab; its kernel time is the launch
   alone on buffers made beforehand. B3 (pack) runs every score dtype,
   special values, n 1, 3 and 4,099, inputs one word past an aligned
   address and an ``out`` at an odd word address; beside it,
   ``launch_floor_ms``, an empty kernel timed the same way. The
   ragged-rebuild (B4) and tokenize+hash (B5) cases run
   one 32,768-doc chunk of the Zipf corpus at L = 256: B4 on uint16 and
   int32 flat streams at granules 1, 2, 4, 8, 16 and 32, and at G 4 and
   16 with L = 250, rows of length 0 and below 0, D = 1 and a stream at
   an odd address (the scalar path); B5 on the uint8 slab and its int32
   upcast, with and without ``truncate_at``, a multi-byte UTF-8 slab
   with non-zero seeds, vocabularies 65,521 and 3, a slab that ends
   inside a 35-byte token (its length not a multiple of 16) and the slab
   at an odd address (the byte-at-a-time walk). Both equal their plain
   versions on the whole [D, L], and B5 equals the host packer's ids in
   every case. Beside B4, the torch chain of ``granule_offsets`` that
   its offset scan replaced and the rebuild launch alone; beside B5,
   ``token_starts``, the bytes wire's other device work.
   Times are medians of 20 calls after a warm-up, each the device span
   of one call: CUDA events around it while a sleep kernel holds the
   stream, so the host's launch latency is not counted. ``ms`` is one
   wrapper call (its output fills included), ``kernel_ms`` the kernel's
   launch alone (the same call where the wrapper does nothing else on
   the device), ``plain_ms`` the plain version and ``library_ms`` the
   one PyTorch call that computes the same function, where there is
   one. ``call_ms`` is the wrapper's latency with the host launch
   included. ``bound_ms`` is the least time for the bytes (or, for B5,
   the operations) the function needs at this run's data;
   ``kernel_bound_ms`` the same for the kernel alone.
3. ``path_sparse_topk``: ``TfidfPipeline.run`` on 32,768 Zipf documents,
   hashed vocab 2^16, top-16 (the sparse engine), against the same run on
   the CPU; asserts the score+top-k and pack kernels launched; profiles
   the device time of one warm ``run_packed`` (torch.profiler; a profile
   with no device activity fails the run).
4. ``path_dense_topk``: the same corpus on the dense engine, vocab 4,096,
   top-16; asserts the TF/DF and pack kernels launched.
5. ``path_golden``: a 64-doc corpus inside the reference's envelope on the
   golden EXACT config; ``output.txt`` bytes equal the golden oracle's
   and the CPU run's.
6. ``path_ragged_batch``: the 32,768-doc corpus as a ``RaggedBatch``
   through ``TfidfPipeline.run_packed``: B4 launches and the result
   equals the ``PackedBatch`` run's.
7. ``path_ingest_resident``: 131,072 Zipf documents written to a
   temporary directory, through ``ingest.run_overlapped`` at doc_len 256,
   4 chunks of 32,768, hashed 2^16, top-16, packed wire, scan finish,
   once per wire (ragged, bytes, padded): the native loader ran, B4 / B5 /
   B1 / B3 launched, the three wires give identical words, df and
   lengths, the ragged run equals the port's CPU run (``compare_topk``)
   and ``TfidfPipeline.run`` on the same documents. Prints the wall
   (after one cold ragged run over the 32,768-doc directory, one chunk
   of the same shape; each wire runs once), docs/s, phases and the
   result's fields per wire, and a device profile of one warm ragged
   run over the 32,768-doc directory (one chunk).
8. ``path_ingest_streaming``: the 32,768-doc corpus in the streaming
   regime (``TFIDF_TPU_RESIDENT_ELEMS`` below it, 4 chunks of 8,192, the
   triple cache sized for 2 of them), spill host and reread, ragged and
   bytes wires: words, df and lengths equal the resident run's.
9. ``path_retrieval``: ``TfidfRetriever(cfg).index_dir`` on the 131,072
   ingest documents (doc_len 256, 16 chunks of 8,192, ragged wire: B4),
   then searches of 256 Zipf queries at Q = 1, 64 and 256, k = 10, under
   tfidf, bm25, bm25:k1=1.5,b=0.6 and an id_range filter: B6 launches
   once per 4,096-row tile per search. Tiled = untiled and tile width
   1,024 = 4,096 bit for bit; the first 64 rows of a Q = 256 search
   equal the Q = 64 search; a snapshot restored on the CPU and an
   8,192-doc index built on both devices agree with the card
   (``compare_search``). Prints index seconds, warm search latency
   (medians of 3) and qps with the median host time of
   ``pack_queries`` inside those
   searches, that time alone, a device profile of one warm Q = 64
   search, B6's launches in such a search timed by CUDA events (a sleep
   kernel holds the stream around each), and unfiltered and id_range
   Q = 256 searches run in turns, the order reversed every round, each
   split into ``pack_queries``, device-busy and the rest.
10. ``kernel_cases_b6``: B6 on real tiles of that index (4,096 rows,
   L = 256, V = 2^16) at Q = 1, 3, 16, 17, 32, 33, 64, 100, 128, 256,
   257 and 512 on the tfidf face and 64 and 256 on bm25, a ragged tile,
   all-dead rows and a row whose every slot is live, each bit-equal to
   the plain version over the whole output; its times (tfidf Q 64, 256,
   1 and 512, bm25 Q 64 and 256) against ``torch.sparse.mm`` of the tile
   as a CSR matrix (built outside the timed span).
11. ``path_stream``: ``StreamingTfidf`` over the 131,072 documents in 16
   ``pack_ragged`` minibatches of 8,192 (L 256, V 2^16, top-16, packed
   wire): the updates (B4) and scores (B4, B1, B3) timed and counted, the
   DF equal to the resident ingest's, the words to the port's CPU run;
   a ``save_state`` after minibatch 7 that a fresh engine restores and
   finishes to the same DF and words; ``sparse_df``'s share of one
   update's device span; one dense minibatch at V 4,096 (B2) and
   ``TfidfVectorizer.fit_transform``'s [8,192, 4,096] matrix (B2), both
   equal to the CPU; ``cli stream`` over the 32,768-doc directory while
   a run in a subprocess is killed hard after its 2nd checkpoint, then
   resumed with ``--resume``: the same output bytes.
12. ``path_segmented``: ``SegmentedIndex.from_corpus`` over the 131,072
   documents (delta 1,024, compact_at 4), 96 mutation calls of 64 docs
   (4,096 adds, 1,024 updates, 1,024 deletes), a compaction whenever the
   index asks, a view and a Q 64 search every 8 calls (B6 every tile);
   the final searches at Q 1, 64, 256 under tfidf, bm25 and an id_range
   filter equal ``rebuild_retriever()`` bit for bit and the untiled path;
   ``save`` then ``restore`` gives the same bits; the same stream on an
   8,192-doc base gives the same searches on the card and the CPU.
   Prints mutated docs/s, view-build ms, search ms on a multi-segment
   view and after the compaction, the pause and B6's launches a search.
13. ``path_exact_terms``: ``rerank.exact_terms_lines`` (k 16, doc_len
   256, chunks of 32,768, the ``cli run --exact-terms`` config: V 2^16,
   a 4 x k margin) on the 131,072 ingest documents: the device-exact
   engine once with its launches counted (B4 every chunk of
   the intern wire, B1 in the exact-ids finish); on the 32,768-doc
   directory the hashed re-rank engine at V 4,096 (more words than
   buckets: the intern table overflows, the ids-only ingest runs with B4
   and B1), the card's lines equal to the CPU's byte for byte,
   every line is a line of the native bit-reference's output
   (``native/tfidf_ref.cc``, built by ``ops/_build.py``), the exact
   recall is 1.0 on every doc, and the hashed engine's recall is
   printed; ``ingest.profile_resident`` on the ragged wire; a device
   profile of one warm device-exact run; ``python -m tfidf_tpu_torch.cli
   run --exact-terms`` in a subprocess without ``--device`` writes the
   library's bytes on cuda. Prints docs/s, the ingest's phases and the
   native emit's seconds.
14. ``path_chargram``: BASELINE config 4 (char 3..5-grams) over 8,192
   source files already on the machine (the repository's, then the
   installed torch, numpy and scipy ``.py`` files, sorted paths, the
   first 4,096 bytes of each) through ``TfidfPipeline.run``: the sparse
   lowering at V 2^20 (explicit engine: B1, the pair wire) and the
   dense one at V 2^16 (defaulted engine: the scatter histogram, a
   stable sort, B3 on the packed wire); docSize is the n-gram count;
   each engine's run on the first 1,024 docs equals the CPU's bit for
   bit; docs/s, MB/s and a device profile of one warm run each; B1 at
   the chargram's row width (12,288 slots) against its plain version.
15. ``path_observe``: what a traced run records, on the card. Among the
   CLI runs of ``cli_commands`` (below), ``run --doc-len 256`` over the
   32,768 files runs traced with ``TFIDF_TPU_DEVMON=1`` beside an
   untraced twin, and the bytes wire's run and the golden batch run over
   the golden 64 docs (B2) run traced: the bytes the untraced run writes
   (``golden_output``'s for the golden run); the JAX ingest's
   span names on the ``main``, ``packer`` and ``drainer`` lanes (the
   golden run's pipeline phases on ``main``); a byte stamp on every
   ``dispatch``, ``fetch``, ``drain``, ``slab`` and ``device_tokenize``
   span and ``costmodel.span_gbps`` of each at most 1.05 x the card's
   peak; ``phase_b`` no shorter than the scoring kernel's device time;
   the flight dump beside the trace holding an ``hbm_census`` of more
   than 0 bytes. The traced and untraced walls side by side (the runs
   share the card and the host with the other CLI runs). A
   ``phase_b``-style device span around a sleep kernel closes after the
   kernel, not at its enqueue. ``tfidf_tpu_torch/tools/trace_capture.py``'s capture of
   one warm ``run_overlapped`` chunk (the 32,768 files, one chunk of
   the ingest's shape) on the ragged and bytes wires, each in a process
   of its own (this one has held many profiler sessions), the two at
   once beside the oracle check below: its device-op
   table names B4, B1, B3 (ragged) and B5 (bytes) with calls equal to
   ``kernels.LAUNCHES`` across the capture, and the top 12 rows.
   ``costmodel.hbm_peak_gbs`` of the card's name is not
   None (checked at the start: every ``bound_ms`` divides by it). The
   8,192-doc index of ``path_retrieval`` rebuilt: its searches at Q 1
   and 64 (tfidf, bm25, tfidf + id_range) give ``scoring.oracle.
   oracle_topk``'s ids in its tie order, scores allclose (rtol 1e-5,
   atol 1e-6), the oracle run on the index's arrays copied to the host.
16. ``path_mesh``: the mesh run paths on 4 virtual shards of the card
   (``MeshPlan.create(docs=4, devices=["cuda:0"] * 4)``), each held bit
   for bit against the port's single-device run on the card: before
   ``path_observe``, twelve ``python -m tfidf_tpu_torch.cli``
   subprocesses without ``--device`` over the 32,768 files at once
   (``cli_commands``: ``run --doc-len 256`` traced and untraced, traced
   on the bytes wire, the golden batch run traced, ``--mesh 1,1,1`` and
   ``--ingest-workers 4``;
   ``query`` and ``stream`` with ``--mesh-docs 1``; ``serve --doc-len
   256`` plain and ``--mesh-shards 1`` on one set of request lines;
   ``serve --delta-docs 1024`` with and without ``--replicas 2`` on
   path_replicas' script), each checked here or in the next four
   phases. ``ShardedPipeline.run_packed`` of the 32,768-doc
   batch, sparse at docs 4 (B1 and B3 once a shard) and dense at {docs
   2, vocab 2} (B2 a shard, at id offsets 0 and 2,048) and {docs 2, seq
   2}; the golden 64 docs at docs 4 (``golden_output``'s bytes); both
   device-chargram lowerings at docs 4 on ``path_chargram``'s files;
   ``run_overlapped(plan=)`` over the 131,072 files (``resident-mesh``,
   B1 and B3 once a shard a chunk; DF and words equal
   ``path_ingest_resident``'s), one warm run profiled for its device
   idle share; the streaming mesh over the 32,768 files (2 of 4 chunks'
   triples cached, the rest re-read) equal to the single-device
   streaming run.
17. ``path_multiprocess``: ``run_sharded_ingest`` over the 131,072 files
   with 2 and then 4 worker processes sharing the card, one run each:
   the merged result equal to ``path_ingest_resident``'s; B4, B1 and B3
   launched in every worker; each worker's walls, upload seconds,
   link utilization, reserved bytes and the card's bytes in use.
18. ``path_mesh_serve``: the search side of the mesh, each result held
   bit for bit against one device's. ``make_serving_plan(4)`` raises on
   one card; on ``make_serving_plan(4, devices=["cuda:0"] * 4)``,
   ``shard_index`` of the retrieval index searched at Q 1, 64 and 256,
   k 10, tfidf, bm25 and an id_range filter (B6 once a tile of each
   shard: 4 x 8), each search timed beside the single-device one; the
   shard stats and the card's bytes in use (``mem_get_info``) before and
   after; ``TfidfRetriever(plan=)`` over the 131,072 docs (the batch
   packing: no document is past 256 tokens, so its rows are the
   retrieval index's) against that index; ``path_segmented``'s compacted view
   sharded, against ``view.search``; path_serve's load (8 clients x 32
   requests, depth 1) on the index and on its 4 shards, every answer
   equal to a direct search; ``ServeConfig(mesh_shards=1)``: the
   constructor, ``swap_index`` to the 32,768-doc index and back (timed),
   a snapshot restored, ``add_docs``/``delete_docs`` on the segmented
   index each install a ``MeshShardedRetriever`` whose answers equal its
   source's, and the canary (its oracle the single-device source)
   probes 1.0; ``StreamingTfidf(plan=)`` over the 32,768 docs in 4
   minibatches, sparse at docs 4 (B1, B3 a shard) and dense at {docs 2,
   vocab 2} (B2 at each vocab offset), DF and words equal one device's;
   the CLI's ``--mesh-docs 1`` / ``--mesh-shards 1`` runs equal to the
   plain ones; and two gloo processes on the card (``MeshPlan.create(
   docs=2)``, world 2: the card once a rank) running the mesh ingest of
   the 32,768 files, each rank's DF, words, scores and lengths equal to
   the single-device run's.
19. ``path_replicas``: the replicated front on the card. Tier A: a
   snapshot of the retrieval index; ``ReplicatedFront`` of 2 replica
   processes on it (the device defaulted: cuda), spans on, an armed
   fault (``replica_prepare`` of replica 2 at boot 0); each replica's
   boot seconds and the card's bytes in use (``mem_get_info``) before
   and after; 64 queries one a request and in batches of 16, tfidf and
   bm25, each answer bit-equal to a direct search; path_serve's load (8
   clients x 32 requests) through ``handle_request`` beside the same
   load on one in-process ``TfidfServer`` (p50, p99, queries/s); the
   first ``swap_index`` to the 32,768-doc directory aborted with every
   replica on epoch 0 and answers still flowing; replica 2's restart
   from the snapshot; the retried swap committing epoch 1, each
   replica's answers then equal to a direct search of
   ``index_dir(small)``; ``trace_export`` with the front and both
   replicas (clock samples); ``replica_info``: no build after a
   warm-up, B6 in each replica, B4 in each at the swap. Tier B (run
   with the other CLI runs): ``cli serve --delta-docs 1024 --replicas
   2`` over the 32,768 files on a script of queries, ``add_docs``
   (1,120 docs), ``delete_docs``, ``compact``, the queries again,
   ``trace_export`` and ``replica_info``, every answer equal to the
   same script in one ``cli serve`` process. The kernels line counts
   the replicas' launches from their ``replica_info``.
20. ``path_serve``: ``serve.TfidfServer`` over the retrieval phase's
   131,072-doc index at ``ServeConfig`` defaults (max_batch 256), warmed
   over every query bucket, under 8 client threads of 32 requests each
   (1-4 of the Zipf queries, k 10, tfidf / bm25 / tfidf + id_range in
   turn), at pipeline depth 1 and then 2: every answer equals a direct
   ``search`` bit for bit, B6 launched on the served batches, no native
   build after the warm-up; prints request latency p50/p99, queries/s,
   batches, mean occupancy and cache hits per depth, and where a depth-1
   load's time goes: the load once more under torch.profiler with every
   thread's host ops recorded, the batcher's waits, its searches and in
   them the ``pack_queries`` calls, torch and runtime calls and
   device waits (it runs last of the script's profiles: after it, the
   profiler of the process loses records, which a probe reads). No
   ``tfidf-*`` thread outlives a server's ``close()``. A repeated
   request is a cache hit with the same bits; a submit past
   ``queue_depth`` raises ``Overloaded``; ``swap_index`` to the
   32,768-doc directory (indexed with B4) bumps the epoch and the next
   answers equal that index's search. A segmented server (delta 1,024)
   over the 32,768 docs takes 4 ``add_docs`` calls of 64 docs and one
   ``delete_docs``, each later answer equal to
   ``rebuild_retriever().search``; its launches are counted around the
   server's calls alone. ``DeviceMonitor``
   reads the card's allocator (bytes in use > 0) and its census finds
   the resident index's bytes exactly. ``python -m tfidf_tpu_torch.cli
   serve`` over the 32,768-doc directory in a subprocess, without
   ``--device`` (run with the other CLI runs before ``path_mesh``): 16
   query lines then ``healthz``, ``readyz``, ``metrics``, ``devmon`` and
   ``shutdown``; it exits 0, its names and scores equal the library's
   search and its backend is ``cuda``.
Then the run's seconds (``run_time``), the ``kernels`` summary line, the
card's name and power limit as ``nvidia-smi`` prints them, and last
``{"ok": true, "device": ...}``.
Any failed check raises: the script exits non-zero without the last
line. It needs a CUDA device and the repository beside it.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# The card's peaks: costmodel's (tfidf_tpu_torch/obs/costmodel.py), set
# by card_peaks() at the start of main() from the card's name.
HBM_BYTES_PER_S = INT32_MAD_PER_S = FP32_FMA_PER_S = None
SEED = 42
N_DOCS = 32768
DOC_LEN = 256
N_WORDS = 8192
TOPK = 16
SPARSE_VOCAB = 1 << 16
DENSE_VOCAB = 4096
INGEST_DOCS = 4 * N_DOCS  # path_ingest_resident: 4 chunks of N_DOCS
STREAM_CHUNK = 8192       # path_ingest_streaming: 4 chunks of N_DOCS
RETR_CHUNK = 8192         # path_retrieval: 16 chunks of the ingest corpus
RETR_TILE = 4096          # the default doc tile (TFIDF_TPU_QUERY_BLOCK)
RETR_K = 10
RETR_QUERIES = 256
RETR_REPS = 3             # path_retrieval: timed searches a median
RETR_SMALL = 8192         # path_retrieval: the index built on both devices
STREAM_BATCH = 8192       # path_stream: 16 minibatches of the ingest corpus
STREAM_SAVE_AT = 7        # path_stream: save_state after minibatch 7
STREAM_CLI_KILL = 2       # path_stream: cli stream killed after minibatch 2
SEG_DELTA = 1024          # path_segmented: delta_docs
SEG_COMPACT_AT = 4        # path_segmented: compact_at
SEG_CALL = 64             # path_segmented: docs per mutation call
SEG_ADDS, SEG_UPDATES, SEG_DELETES = 4096, 1024, 1024
SEG_VIEW_EVERY = 8        # path_segmented: a view and a search every 8 calls
# kernel_cases_b6: Q held bit-equal on the tfidf face, and Q timed per face
B6_CHECKED_Q = (1, 3, 16, 17, 32, 33, 64, 100, 128, 256, 257, 512)
B6_TIMED_Q = {"tfidf": (64, RETR_QUERIES, 1, 512), "bm25": (64, RETR_QUERIES)}


T_START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:  # when each phase line is printed, from the start
        obj = {**obj, "at_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


# About 5 ms at the H100's boost clock: longer than any timed call
# takes to enqueue its operations.
SLEEP_CYCLES = 10_000_000


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of one ``fn()`` call, host launch included:
    one CUDA-event pair per call, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_span_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device milliseconds of one ``fn()`` call, from its first
    device operation to the end of its last: a sleep kernel holds the
    stream while the host enqueues the start event, the call and the end
    event, so the host's launch latency is not counted."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled(fn, all_threads: bool = False):
    """``fn()`` under torch.profiler, CPU and CUDA activity: its events
    and the wall milliseconds of the window. The host ops recorded are
    the calling thread's, or with ``all_threads`` every thread's
    (``profile_all_threads``)."""
    from torch.profiler import ProfilerActivity, profile

    kw = {}
    if all_threads:
        from torch._C._profiler import _ExperimentalConfig
        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 **kw) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof.events(), wall_ms


def device_events(fn, warm_up: bool = True, all_threads: bool = False):
    """Device activity of one ``fn()`` call (after one warm-up call, or
    none), from torch.profiler: ``(name, ms)`` per kernel, copy or memset,
    the wall milliseconds of the window and every profiled event."""
    from torch.autograd import DeviceType

    if warm_up:
        fn()
    events, wall_ms = profiled(fn, all_threads)
    device = [(e.name, e.time_range.elapsed_us() / 1e3)
              for e in events if e.device_type == DeviceType.CUDA]
    check(bool(device), "the profiler recorded no device activity")
    return device, wall_ms, events


def kernel_times(call, plain, library=None, kernel_only=None) -> dict:
    """Device time of one wrapper call (``ms``), of its kernel launch
    alone (``kernel_only``; by default the call itself, for wrappers
    whose only device work is the launch), of the plain version and of
    the library call, and the call's latency from the host."""
    ms = device_span_ms(call)
    k_ms = device_span_ms(kernel_only) if kernel_only else ms
    return {"ms": ms, "kernel_ms": k_ms,
            "call_ms": time_ms(call), "plain_ms": device_span_ms(plain),
            "library_ms": device_span_ms(library) if library else None}


def profile_summary(fn, top_n: int = 12, warm_up: bool = True,
                    all_threads: bool = False) -> dict:
    """Where the device time of one warm ``fn()`` goes: top device
    operations and the idle share of the window. With ``all_threads``,
    also the host side of the thread with the most torch ops
    (``dispatch_thread``)."""
    events, wall_ms, every = device_events(fn, warm_up, all_threads)
    by_name = {}
    for ev, ms in events:
        row = by_name.setdefault(ev, [0, 0.0])
        row[0] += 1
        row[1] += ms
    busy = sum(ms for _, ms in events)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top_n]
    out = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": 1 - busy / wall_ms,
           "top": [{"name": n[:100], "count": c, "ms": ms}
                   for n, (c, ms) in top]}
    if all_threads:
        out["dispatch_thread"] = dispatch_thread_host(every)
    return out


def dispatch_thread_host(events) -> dict:
    """The host side of the thread with the most recorded torch ops
    among ``events`` (the batcher's, in a served load): its ms inside
    top-level torch ops (their nested runtime calls included), the ms of
    runtime calls made outside any op (the hand kernels' launches,
    event records and waits; the profiler files these under no thread
    of their own), the ms of those two spent waiting for the device
    (``cuda*Synchronize``), and the runtime calls by name (count, ms)."""
    from torch.autograd import DeviceType

    host = [e for e in events if e.device_type != DeviceType.CUDA]
    ops = {}
    for e in host:
        if not e.name.startswith("cuda"):
            ops.setdefault(e.thread, []).append(e)
    check(bool(ops), "the profiler recorded no host op")
    tid = max(ops, key=lambda t: len(ops[t]))
    top = [e for e in ops[tid] if e.cpu_parent is None]
    loose = [e for e in host
             if e.name.startswith("cuda") and e.cpu_parent is None]
    calls = {}
    for e in host:
        if e.name.startswith("cuda"):
            row = calls.setdefault(e.name, [0, 0.0])
            row[0] += 1
            row[1] += e.time_range.elapsed_us() / 1e3
    return {"threads_with_ops": len(ops), "top_level_ops": len(top),
            "top_level_ops_ms": sum(e.time_range.elapsed_us()
                                    for e in top) / 1e3,
            "runtime_calls_outside_ops": len(loose),
            "runtime_outside_ops_ms": sum(e.time_range.elapsed_us()
                                          for e in loose) / 1e3,
            "sync_ms": sum(ms for name, (_, ms) in calls.items()
                           if name.endswith("Synchronize")),
            "runtime_calls": {name: {"count": c, "ms": ms} for name, (c, ms)
                              in sorted(calls.items(),
                                        key=lambda kv: -kv[1][1])}}


def card_peaks() -> float:
    """Read the card's peaks from the package's cost model (one roofline
    for every bound): bytes/s from ``hbm_peak_gbs`` of the card's name,
    which must know it (no default), int32 MADs/s and float32 FMAs/s.
    Returns the peak in GB/s."""
    global HBM_BYTES_PER_S, INT32_MAD_PER_S, FP32_FMA_PER_S
    from tfidf_tpu_torch.obs import costmodel
    kind = torch.cuda.get_device_name(0)
    peak = costmodel.hbm_peak_gbs(kind)
    check(peak is not None, f"costmodel.hbm_peak_gbs knows no peak for "
          f"{kind!r}")
    HBM_BYTES_PER_S = peak * 1e9
    INT32_MAD_PER_S = costmodel.INT32_MAD_PER_S
    FP32_FMA_PER_S = costmodel.FP32_FMA_PER_S
    return peak


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two same-dtype tensors."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return torch.equal(a.view(view[a.element_size()]),
                       b.view(view[b.element_size()]))


def zipf_tokens(rng, d: int, length: int, vocab: int):
    """Seeded [d, length] int32 ids: Zipf(1.3) word ranks over N_WORDS
    words, each word hashed to a random bucket of ``vocab``, and
    Zipf-shaped doc lengths (bench.py's corpus shape)."""
    buckets = rng.integers(0, vocab, N_WORDS)
    ranks = np.clip(rng.zipf(1.3, (d, length)), 1, N_WORDS) - 1
    lens = np.maximum(length // np.clip(rng.zipf(1.3, d), 1, length), 1)
    return buckets[ranks].astype(np.int32), lens.astype(np.int32)


def zipf_docs(rng, n_docs: int):
    """``n_docs`` docs of words w0..w8191: Zipf(1.3) word ranks and
    Zipf-shaped lengths up to DOC_LEN (bench.py's corpus shape)."""
    words = np.array([f"w{i}".encode() for i in range(N_WORDS)], dtype=object)
    ranks = np.clip(rng.zipf(1.3, n_docs * DOC_LEN), 1, N_WORDS) - 1
    lens = np.maximum(DOC_LEN // np.clip(rng.zipf(1.3, n_docs), 1, DOC_LEN), 1)
    offs = np.concatenate([[0], np.cumsum(lens)])
    return [b" ".join(words[ranks[offs[i]:offs[i + 1]]]) for i in range(n_docs)]


def zipf_corpus(Corpus, rng, n_docs: int = N_DOCS):
    """The paths' corpus: :func:`zipf_docs` named doc1..docN."""
    return Corpus(names=[f"doc{i}" for i in range(1, n_docs + 1)],
                  docs=zipf_docs(rng, n_docs))


def utf8_docs(rng, n_docs: int):
    """Docs of multi-byte UTF-8 and ASCII words with every separator
    byte of the whitespace set."""
    pool = ["héllo", "wörld", "中文", "éé", "naïve", "Ωmega", "日本語テキスト",
            "emoji😀", "a", "supercalifragilisticexpialidocious", "x1", "ß"]
    seps = [" ", "\t", "\n", "\r\n", "  ", "\x0b", "\x0c"]
    docs = []
    for _ in range(n_docs):
        n = int(rng.integers(0, 40))
        parts = []
        for w, s in zip(rng.integers(0, len(pool), n),
                        rng.integers(0, len(seps), n)):
            parts += [pool[w], seps[s]]
        docs.append("".join(parts).encode())
    return docs


def write_corpus(root: str, docs) -> str:
    """Write docs as doc1..docN under ``root`` (8 writer threads);
    returns ``root``."""
    import concurrent.futures as cf

    def write(i):
        with open(os.path.join(root, f"doc{i + 1}"), "wb") as f:
            f.write(docs[i])

    with cf.ThreadPoolExecutor(max_workers=8) as ex:
        list(ex.map(write, range(len(docs))))
    return root


def build_slab(docs, align: int, pad_to: int):
    """The bytes wire's slab (ops/device_tokenize.py's layout): doc bytes
    at aligned offsets, 0x20 fill, capacity a ``pad_to`` multiple."""
    from tfidf_tpu_torch.ops.device_tokenize import aligned_byte_lengths
    blens = np.array([len(d) for d in docs], np.int32)
    albl = aligned_byte_lengths(blens, align)
    total = int(albl.sum())
    slab = np.full(max(total + (-total % pad_to), pad_to), 0x20, np.uint8)
    offs = np.concatenate([[0], np.cumsum(albl)[:-1]])
    for doc, off in zip(docs, offs.tolist()):
        slab[off:off + len(doc)] = np.frombuffer(doc, np.uint8)
    return slab, blens


def golden_corpus(Corpus, rng):
    """64 docs inside the reference's envelope: tokens under 16 bytes."""
    vocab = [f"t{i}".encode() for i in range(300)] + [b"common"]
    docs = []
    for _ in range(64):
        n = int(rng.integers(1, 200))
        toks = [vocab[i] for i in rng.integers(0, len(vocab), n)] + [b"common"]
        docs.append(b" ".join(toks) + b"\n")
    return Corpus(names=[f"doc{i}" for i in range(1, 65)], docs=docs)


def env_phase(_build):
    """Builds the CUDA kernels (nvcc) and the host loader library (g++)
    at the same time."""
    import concurrent.futures as cf
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"compute capability {cap} is not Hopper (9, 0)")
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(max_workers=1) as ex:
        host = ex.submit(_build.build_host)
        built = _build.build()
        host_built = host.result()
    sys.stderr.write(built["log"] + "\n" + host_built["log"] + "\n")
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "capability": list(cap),
          "nvidia_smi": smi, "build_s": built["seconds"],
          "host_build_s": host_built["seconds"],
          "builds_wall_s": time.perf_counter() - t0,
          "library": os.path.relpath(built["path"], REPO),
          "host_library": os.path.relpath(host_built["path"], REPO)})
    return smi


def b2_cases(K, rng, toks, toks_d, lens_d, cases):
    """B2 against its plain version: the wrapper's output, and the
    launch alone into counts and df filled with -1 (every cell must be
    written, df zeroed), over the main batch and its edges."""
    import tfidf_tpu_torch as T
    dev = toks_d.device

    def case(label, tk, ln, v, plain_tk=None, **kw):
        want_c, want_d = K.tf_df_plain(tk if plain_tk is None else plain_tk,
                                       ln, vocab_size=v, **kw)
        got = {"wrapper": K.tf_df(tk, ln, vocab_size=v, **kw)}
        filled = (torch.full_like(want_c, -1),
                  None if want_d is None else torch.full_like(want_d, -1))
        K.tf_df_launch(tk, ln, *filled, id_offset=kw.get("id_offset", 0))
        got["launch into -1"] = filled
        torch.cuda.synchronize()
        for way, (kc, kd) in got.items():
            check(torch.equal(kc, want_c),
                  f"B2 {label} ({way}): counts differ from plain")
            check((kd is None) == (want_d is None)
                  and (kd is None or torch.equal(kd, want_d)),
                  f"B2 {label} ({way}): df differs from plain")
        p = K.tf_df_plan(tk.shape[0], tk.shape[1], v,
                         with_df=want_d is not None)
        cases.append({"kernel": "tf_df", "case": label,
                      "shape": list(tk.shape), "V": v, "vt": p["vt"],
                      "tiles": p["tiles"], "blocks": p["blocks"],
                      "counts_equal": True, "df_equal": True,
                      "max_abs_err": 0})

    case("with_df", toks_d, lens_d, DENSE_VOCAB)
    case("counts_only", toks_d, lens_d, DENSE_VOCAB, with_df=False)
    case("id_offset", toks_d, lens_d, DENSE_VOCAB // 2, id_offset=1024)
    case("uint16_ids", torch.from_numpy(toks.astype(np.uint16)).to(dev),
         lens_d, DENSE_VOCAB, plain_tk=toks_d)
    # V % 4 != 0: rows start off a 16-byte boundary (and id 4095 drops)
    case("vocab_4095", toks_d, lens_d, 4095)
    case("vocab_1", toks_d, lens_d, 1)
    wide_t, wide_l = zipf_tokens(rng, 512, DOC_LEN, 40000)
    case("vocab_40000_D512", torch.from_numpy(wide_t).to(dev),
         torch.from_numpy(wide_l).to(dev), 40000)  # 5 vocab tiles
    case("D1", toks_d[:1], lens_d[:1], DENSE_VOCAB)
    case("zero_lengths", toks_d, torch.zeros_like(lens_d), DENSE_VOCAB)
    odd = lens_d.clone()
    odd[::3] = 1 << 30
    odd[1::3] = DOC_LEN + 1
    odd[2::7] = -4
    case("lengths_negative_and_above_L", toks_d, odd, DENSE_VOCAB)
    bad = toks_d.clone()
    bad[:, ::3] = -1 - bad[:, ::3]
    bad[:, 1::5] += 3 * DENSE_VOCAB
    case("ids_out_of_range", bad, lens_d, DENSE_VOCAB)
    case("ids_out_of_range_id_offset", bad, lens_d, 1000, id_offset=2000)
    gold = T.pack_corpus(golden_corpus(T.Corpus, np.random.default_rng(SEED)),
                         T.PipelineConfig.golden())
    case("golden_exact_vocab",
         torch.from_numpy(np.asarray(gold.token_ids, np.int32)).to(dev),
         torch.from_numpy(np.asarray(gold.lengths, np.int32)).to(dev),
         gold.vocab_size)


def b3_cases(K, vals, tids, cases):
    """B3 against its plain version: the main [D, K] batch in every score
    dtype, special values, and the edges of the plan: n 1, 3 and 4,099,
    inputs one word past an aligned address (a head of 3, then groups),
    and an out slice at an odd word address (every word alone)."""
    dev = vals.device
    special_v = torch.tensor([[0.0, float("nan"), 70000.0, 65504.0, 1e-8,
                               2.5]], device=dev)
    special_t = torch.tensor([[0, 7, 65535, 3, 9, -1]], dtype=torch.int32,
                             device=dev)
    fv, ft = vals.reshape(-1), tids.reshape(-1)

    def odd_out(n):
        return torch.empty(n + 1, dtype=torch.uint32, device=dev)[1:]

    inputs = {"float32": (vals, tids, None),
              "bfloat16": (vals.to(torch.bfloat16), tids, None),
              "float16": (vals.to(torch.float16), tids, None),
              "special_values": (special_v, special_t, None),
              "n1": (fv[:1], ft[:1], None),
              "n3": (fv[:3], ft[:3], None),
              "n4099": (fv[:4099], ft[:4099], None),
              "n4099_float16": (fv[:4099].half(), ft[:4099], None),
              "one_word_past_aligned": (fv[1:4100], ft[1:4100], odd_out(4099)),
              "out_at_odd_word": (fv[:4099], ft[:4099], odd_out(4099)),
              "out_at_odd_word_bfloat16": (fv[:4099].bfloat16(), ft[:4099],
                                           odd_out(4099))}
    for label, (pv, pt, out) in inputs.items():
        kw_ = K.pack_words(pv, pt, out=out)
        pw_ = K.pack_words_plain(pv, pt)
        torch.cuda.synchronize()
        check(same_bits(kw_, pw_), f"B3 {label}: words differ from plain")
        p = K.pack_words_plan(pv.numel(), itemsize=pv.element_size(),
                              vals_addr=pv.data_ptr(), tids_addr=pt.data_ptr(),
                              out_addr=kw_.data_ptr())
        cases.append({"kernel": "pack_words", "case": label,
                      "shape": list(pv.shape), "head": p["head"],
                      "groups": p["groups"], "tail": p["tail"],
                      "words_equal": True, "max_abs_err": 0})


def kernel_phase(K):
    """Each kernel against its plain version at the main path's shapes."""
    from tfidf_tpu_torch.ops.scoring import idf_from_df
    from tfidf_tpu_torch.ops.sparse import (sorted_term_counts, sparse_df,
                                            sparse_scores)

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    summary = {}

    # --- B1: fused score + top-k -------------------------------------
    toks, lens = zipf_tokens(rng, N_DOCS, DOC_LEN, SPARSE_VOCAB)
    toks_d = torch.from_numpy(toks).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    ids, counts, head = sorted_term_counts(toks_d, lens_d)
    df = sparse_df(ids, head, SPARSE_VOCAB)
    idf = idf_from_df(df, N_DOCS, torch.float32)
    cases = []

    def b1_case(label, ids, counts, head, lens_d, idf, k=TOPK):
        kv, kt = K.fused_score_topk(ids, counts, head, lens_d, idf, k=k)
        pv, pt = K.fused_score_topk_plain(ids, counts, head, lens_d, idf, k=k)
        torch.cuda.synchronize()
        check(torch.equal(kt, pt), f"B1 {label}: ids differ from plain")
        check(same_bits(kv, pv), f"B1 {label}: scores not bit-equal to plain")
        err = (kv.float() - pv.float()).abs().max().item()
        n_head = head.sum(dim=1)
        cases.append({"kernel": "fused_score_topk", "case": label,
                      "shape": list(ids.shape), "k": k, "ids_equal": True,
                      "scores_bit_equal": True, "max_abs_err": err,
                      "head_slots_per_row": {
                          "max": int(n_head.max()),
                          "rows_over_32": int((n_head > 32).sum()),
                          "rows_none": int((n_head == 0).sum())}})
        return kv, kt, err

    vals, tids, err = b1_case("float32", ids, counts, head, lens_d, idf)
    b1_case("bfloat16", ids, counts, head, lens_d, idf.to(torch.bfloat16))
    b1_case("float16", ids, counts, head, lens_d, idf.to(torch.float16))
    for k in (1, 64):
        b1_case(f"float32_k{k}", ids, counts, head, lens_d, idf, k=k)
    b1_case("bfloat16_k64", ids, counts, head, lens_d,
            idf.to(torch.bfloat16), k=64)
    # Ties: one idf for every term, and rows whose head slots all score
    # the same (every term twice), hold exactly k or k - 1 or 5 terms, or
    # none (length 0); the other rows keep their Zipf tokens.
    tt = toks_d[:4096].clone()
    tl = lens_d[:4096].clone()
    kinds = torch.arange(4096, device=dev) % 6
    pairs = torch.arange(DOC_LEN, device=dev, dtype=torch.int32) // 2
    for kind, n_terms in ((0, DOC_LEN // 2), (1, TOPK), (2, TOPK - 1),
                          (3, 5)):
        sel = kinds == kind
        tt[sel] = (pairs % n_terms)[None, :]
        tl[sel] = DOC_LEN if kind == 0 else 2 * n_terms
    tl[kinds == 4] = 0
    ti, tc, th = sorted_term_counts(tt, tl)
    flat_idf = torch.full((SPARSE_VOCAB,), 1.5, device=dev)
    for k in (1, TOPK, 64):
        b1_case(f"tie_heavy_k{k}", ti, tc, th, tl, flat_idf, k=k)
    b1_case("tie_heavy_float16", ti, tc, th, tl, flat_idf.half())
    # Rows too long for shared memory. Zipf rows mostly fit the warp's
    # list (2,048 slots); uniform ids over 2^16 give more head slots than
    # that, so those rows take its path for rows past the list.
    ltoks, llens = zipf_tokens(rng, 64, 16384, SPARSE_VOCAB)
    lt, lc, lh = sorted_term_counts(torch.from_numpy(ltoks).to(dev),
                                    torch.from_numpy(llens).to(dev))
    b1_case("long_rows", lt, lc, lh, torch.from_numpy(llens).to(dev), idf)
    utoks = torch.from_numpy(rng.integers(0, SPARSE_VOCAB, (64, 16384))
                             .astype(np.int32)).to(dev)
    ulens = torch.full((64,), 16384, dtype=torch.int32, device=dev)
    ulens[::2] = 3000
    ut, uc, uh = sorted_term_counts(utoks, ulens)
    b1_case("long_rows_uniform", ut, uc, uh, ulens, idf)
    # k 64: the lanes' columns fill the composite buffer; k 65: the
    # rescan path past it
    b1_case("long_rows_uniform_k64", ut, uc, uh, ulens, idf, k=64)
    b1_case("long_rows_uniform_k65", ut, uc, uh, ulens, idf, k=65)
    d, length = ids.shape
    # What this batch needs: lengths, head at every slot (it alone says
    # which slots score), ids and counts at head slots only, idf at the
    # distinct ids they name, and the picks written.
    n_head = int(head.sum())
    n_idf = int(torch.unique(ids[head]).numel())
    b1_bytes = (d * 4 + d * length + n_head * (4 + 4) + n_idf * 4
                + d * TOPK * (4 + 4))
    block = sparse_scores(ids, counts, head, lens_d, idf)
    no_head = torch.zeros_like(head)
    # Where B1's time goes: fewer or more selection rounds, and the floor
    # of a batch with no head slot (reads head and lengths, writes picks).
    b1_parts = {f"kernel_ms_k{k}": device_span_ms(
        lambda k=k: K.fused_score_topk(ids, counts, head, lens_d, idf, k=k))
        for k in (1, 64)}
    b1_parts["kernel_ms_no_head_slots"] = device_span_ms(
        lambda: K.fused_score_topk(ids, counts, no_head, lens_d, idf, k=TOPK))
    summary["fused_score_topk"] = {
        **b1_parts, "rows_over_32_head_slots": int((head.sum(1) > 32).sum()),
        **kernel_times(
            lambda: K.fused_score_topk(ids, counts, head, lens_d, idf, k=TOPK),
            lambda: K.fused_score_topk_plain(ids, counts, head, lens_d, idf,
                                             k=TOPK)),
        "yardstick_ms": device_span_ms(lambda: torch.topk(block, TOPK, dim=1)),
        "yardstick_call": "torch.topk(sparse_scores block [D, L], 16, dim=1): "
                          "selection half only, not the same function",
        "bound_ms": bound_ms(b1_bytes), "kernel_bound_ms": bound_ms(b1_bytes),
        "max_abs_err": err, "shape": {"D": d, "L": length, "k": TOPK,
                                      "V": SPARSE_VOCAB,
                                      "head_slots": n_head}}

    # --- B2: dense TF + DF --------------------------------------------
    toks, lens = zipf_tokens(rng, N_DOCS, DOC_LEN, DENSE_VOCAB)
    toks_d = torch.from_numpy(toks).to(dev)
    lens_d = torch.from_numpy(lens).to(dev)
    b2_cases(K, rng, toks, toks_d, lens_d, cases)
    live = torch.arange(DOC_LEN, device=dev)[None, :] < lens_d[:, None]
    flat = (torch.arange(N_DOCS, device=dev, dtype=torch.int64)[:, None]
            * DENSE_VOCAB + toks_d)[live]
    # The function (and the kernel: it writes every cell) reads lengths
    # and the live tokens and writes all of counts [D, V] and df [V].
    counts_ref, df_ref = K.tf_df_plain(toks_d, lens_d, vocab_size=DENSE_VOCAB)
    n_live = int(lens_d.clamp(max=DOC_LEN).sum())
    b2_bytes = (N_DOCS * 4 + n_live * 4 + N_DOCS * DENSE_VOCAB * 4
                + DENSE_VOCAB * 4)
    counts_buf = torch.full_like(counts_ref, -1)
    df_buf = torch.full_like(df_ref, -1)
    summary["tf_df"] = {
        **kernel_times(
            lambda: K.tf_df(toks_d, lens_d, vocab_size=DENSE_VOCAB),
            lambda: K.tf_df_plain(toks_d, lens_d, vocab_size=DENSE_VOCAB),
            lambda: torch.bincount(flat, minlength=N_DOCS * DENSE_VOCAB),
            # every launch of the call (df's zeroing, the histogram) on
            # buffers allocated beforehand; nothing to fill
            kernel_only=lambda: K.tf_df_launch(toks_d, lens_d, counts_buf,
                                               df_buf)),
        "library_call": "torch.bincount(d*V + id, minlength=D*V) (counts only)",
        "bound_ms": bound_ms(b2_bytes),
        "kernel_bound_ms": bound_ms(b2_bytes), "max_abs_err": 0,
        "shape": {"D": N_DOCS, "L": DOC_LEN, "V": DENSE_VOCAB,
                  "live_tokens": n_live}}
    torch.cuda.synchronize()
    check(torch.equal(counts_buf, counts_ref) and torch.equal(df_buf, df_ref),
          "B2: the timed launch's output differs from plain")

    # --- B3: packed result words ---------------------------------------
    b3_cases(K, vals, tids, cases)
    summary["pack_words"] = {
        **kernel_times(lambda: K.pack_words(vals, tids),
                       lambda: K.pack_words_plain(vals, tids)),
        # an empty kernel timed the same way: what no design removes
        "launch_floor_ms": device_span_ms(lambda: torch.cuda._sleep(0)),
        "bound_ms": bound_ms(vals.numel() * 12),
        "kernel_bound_ms": bound_ms(vals.numel() * 12), "max_abs_err": 0,
        "shape": {"D": N_DOCS, "K": TOPK}}
    ingest_kernel_cases(K, summary, cases)
    emit({"phase": "kernel_cases", "cases": cases})
    return summary


def ingest_kernel_cases(K, summary, cases):
    """B4 and B5 at the ingest path's shapes: one 32,768-doc chunk of
    the Zipf corpus at L = 256, G = 16 (the wire's default granule)."""
    import tfidf_tpu_torch as T
    from tfidf_tpu_torch.ingest import flatten_aligned
    from tfidf_tpu_torch.ops.device_tokenize import (aligned_byte_lengths,
                                                     token_starts)

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    docs = zipf_docs(rng, N_DOCS)
    cfg = T.PipelineConfig(vocab_mode=T.VocabMode.HASHED,
                           vocab_size=SPARSE_VOCAB, max_doc_len=DOC_LEN,
                           doc_chunk=DOC_LEN, topk=TOPK)
    batch = T.pack_corpus(T.Corpus(names=[""] * N_DOCS, docs=docs), cfg,
                          want_words=False)
    lens_d = torch.from_numpy(batch.lengths).to(dev)

    # --- B4: ragged rebuild -------------------------------------------
    live = torch.arange(DOC_LEN, device=dev)[None, :] < lens_d[:, None]

    def b4_case(label, flat_d, lens, length, align, packed=None):
        """The kernel equals its plain version over the whole [D, L]
        (padding slots included) and, given the packed batch, its live
        ids."""
        got = K.ragged_rebuild(flat_d, lens, length=length, align=align)
        want = K.ragged_rebuild_plain(flat_d, lens, length=length, align=align)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"B4 {label}: differs from plain")
        if packed is not None:
            check(torch.equal(torch.where(live, got, 0).cpu(), packed),
                  f"B4 {label}: live ids differ from the packed batch")
        p = K.ragged_rebuild_plan(got.shape[0], length, align,
                                  itemsize=flat_d.element_size(),
                                  flat_align=K._alignment(flat_d),
                                  out_align=K._alignment(got))
        cases.append({"kernel": "ragged_rebuild", "case": label,
                      "shape": list(got.shape), "flat_ids": flat_d.numel(),
                      "group": p["group"], "whole_output_equal": True,
                      "max_abs_err": 0})

    packed_ids = torch.from_numpy(batch.token_ids)
    flats = {}
    for dtype in (np.uint16, np.int32):
        for align in (1, 2, 4, 8, 16, 32):
            flat, total = flatten_aligned(batch.token_ids, batch.lengths,
                                          align, dtype=dtype)
            flat_d = torch.from_numpy(flat).to(dev)
            flats[dtype, align] = (flat_d, total)
            b4_case(f"{np.dtype(dtype).name}_G{align}", flat_d, lens_d,
                    DOC_LEN, align, packed_ids)
    # The edges: L not a multiple of 4 (the scalar path), rows of length
    # 0 and below 0, one row, and a stream that is not 8-byte aligned.
    edge_lens = lens_d.clone()
    edge_lens[::7] = 0
    edge_lens[3::7] = -5
    for dtype in (np.uint16, np.int32):
        name = np.dtype(dtype).name
        for align in (4, 16):
            flat_d, _ = flats[dtype, align]
            b4_case(f"{name}_G{align}_L250", flat_d, lens_d, 250, align)
            b4_case(f"{name}_G{align}_zero_and_negative_lengths", flat_d,
                    edge_lens, DOC_LEN, align)
            b4_case(f"{name}_G{align}_D1", flat_d, lens_d[:1].contiguous(),
                    DOC_LEN, align)
            shifted = torch.empty(flat_d.numel() + 1, dtype=flat_d.dtype,
                                  device=dev)[1:]
            shifted.copy_(flat_d)
            b4_case(f"{name}_G{align}_flat_at_odd_offset", shifted, lens_d,
                    DOC_LEN, align, packed_ids)
    flat16, total16 = flats[np.uint16, 16]
    flat32, _ = flats[np.int32, 16]
    gran = K.granule_offsets(lens_d, 16)[:, None] \
        + torch.arange(DOC_LEN, device=dev)[None, :] // 16
    index = (gran.clamp_max(flat32.numel() // 16 - 1) * 16
             + torch.arange(DOC_LEN, device=dev)[None, :] % 16).long()
    check(torch.equal(flat32[index],
                      K.ragged_rebuild(flat32, lens_d, length=DOC_LEN,
                                       align=16)),
          "B4: the library gather differs from the kernel")
    plan16 = K.ragged_rebuild_plan(N_DOCS, DOC_LEN, 16, itemsize=2)
    scratch16 = torch.empty(plan16["scratch"], dtype=torch.int32, device=dev)
    # the scan's scratch as the offsets of granule_offsets would fill it:
    # the whole offset per row, zero tile totals
    given16 = torch.zeros_like(scratch16)
    given16[:N_DOCS] = K.granule_offsets(lens_d, 16)
    out16 = torch.empty((N_DOCS, DOC_LEN), dtype=torch.int32, device=dev)
    # Read once: the live aligned ids and lengths; written: [D, L] int32.
    b4_bytes = total16 * 2 + N_DOCS * 4 + N_DOCS * DOC_LEN * 4
    summary["ragged_rebuild"] = {
        **kernel_times(
            lambda: K.ragged_rebuild(flat16, lens_d, length=DOC_LEN, align=16),
            lambda: K.ragged_rebuild_plain(flat16, lens_d, length=DOC_LEN,
                                           align=16),
            lambda: flat32[index],
            # every launch of the call: the offset scan, then the rebuild
            kernel_only=lambda: K.ragged_rebuild_launch(
                flat16, lens_d, out16, align=16, scratch=scratch16)),
        # the rebuild launch alone, from the offsets computed beforehand
        "rebuild_only_ms": device_span_ms(lambda: K.ragged_rebuild_launch(
            flat16, lens_d, out16, align=16, scratch=given16, scan=False)),
        # the ragged wire's other device work: the torch chain the offset
        # scan replaced (the plain version's helper)
        "granule_offsets_chain_ms": device_span_ms(
            lambda: K.granule_offsets(lens_d, 16)),
        "library_call": "flat[index] (advanced-indexing gather of the int32 "
                        "flat stream by a precomputed [D, L] int64 index; "
                        "the gather cannot widen uint16 in the same call)",
        "bound_ms": bound_ms(b4_bytes), "bound_by": "bytes",
        "kernel_bound_ms": bound_ms(b4_bytes), "max_abs_err": 0,
        "shape": {"D": N_DOCS, "L": DOC_LEN, "G": 16, "flat": "uint16",
                  "live_aligned_ids": total16}}
    torch.cuda.synchronize()
    want16 = K.ragged_rebuild_plain(flat16, lens_d, length=DOC_LEN, align=16)
    check(torch.equal(out16, want16),
          "B4: the timed launch's output differs from plain")

    # --- B5: tokenize + hash --------------------------------------------
    slab, blens = build_slab(docs, 16, 1 << 17)
    slab_d = torch.from_numpy(slab).to(dev)
    blens_d = torch.from_numpy(blens).to(dev)
    starts, _, t_lens, _ = token_starts(slab_d, blens_d, length=DOC_LEN,
                                        align=16)
    check(torch.equal(t_lens.cpu(), torch.from_numpy(batch.lengths)),
          "B5: device token lengths differ from the host packer's")
    u_docs = utf8_docs(rng, 2048)
    u_slab, u_blens = build_slab(u_docs, 16, 1 << 17)
    u_slab_d = torch.from_numpy(u_slab).to(dev)
    u_starts, _, u_lens, _ = token_starts(
        u_slab_d, torch.from_numpy(u_blens).to(dev), length=DOC_LEN, align=16)
    # A slab that ends inside its last token (a 34-byte one, longer than
    # two windows), its length not a multiple of 16.
    c_docs = u_docs[:511] + [("x " * 9 + "y" + "é" * 16 + "zz").encode()]
    c_slab, c_blens = build_slab(c_docs, 16, 16)
    c_n = int(aligned_byte_lengths(c_blens, 16)[:-1].sum()) + len(c_docs[-1])
    check(c_n % 16 != 0 and c_slab[c_n - 1] != 0x20,
          "B5: the cut slab does not end inside a token")
    c_slab_d = torch.from_numpy(c_slab[:c_n].copy()).to(dev)
    c_starts, _, c_lens, _ = token_starts(
        c_slab_d, torch.from_numpy(c_blens).to(dev), length=DOC_LEN, align=16)
    # The main slab at an odd address: the byte-at-a-time walk.
    odd = torch.empty(slab_d.numel() + 1, dtype=torch.uint8, device=dev)[1:]
    odd.copy_(slab_d)

    def host_ids(docs_, **cfg_kw):
        """The host packer's ids for ``docs_`` under ``cfg_kw``."""
        c = T.PipelineConfig(**{**dict(
            vocab_mode=T.VocabMode.HASHED, vocab_size=SPARSE_VOCAB,
            max_doc_len=DOC_LEN, doc_chunk=DOC_LEN, topk=TOPK), **cfg_kw})
        b = T.pack_corpus(T.Corpus(names=[""] * len(docs_), docs=docs_), c,
                          want_words=False)
        return torch.from_numpy(b.token_ids)

    main_ids = torch.from_numpy(batch.token_ids)
    # label: (slab, starts, lengths, vocab, seed, truncate_at, host ids)
    b5_inputs = {
        "uint8": (slab_d, starts, t_lens, SPARSE_VOCAB, 0, 0, main_ids),
        "int32_slab": (slab_d.to(torch.int32), starts, t_lens, SPARSE_VOCAB,
                       0, 0, main_ids),
        "truncate_3": (slab_d, starts, t_lens, SPARSE_VOCAB, 0, 3,
                       host_ids(docs, truncate_tokens_at=3)),
        "utf8_seed_truncate_16": (
            u_slab_d, u_starts, u_lens, SPARSE_VOCAB, 0xDEADBEEF12345678, 16,
            host_ids(u_docs, hash_seed=0xDEADBEEF12345678,
                     truncate_tokens_at=16)),
        "utf8_seed": (u_slab_d, u_starts, u_lens, SPARSE_VOCAB, 7, 0,
                      host_ids(u_docs, hash_seed=7)),
        "vocab_65521": (slab_d, starts, t_lens, 65521, 0, 0,
                        host_ids(docs, vocab_size=65521)),
        "vocab_3": (slab_d, starts, t_lens, 3, 0, 0,
                    host_ids(docs, vocab_size=3)),
        "slab_ends_in_token": (c_slab_d, c_starts, c_lens, SPARSE_VOCAB, 0, 0,
                               host_ids(c_docs)),
        "slab_at_odd_offset": (odd, starts, t_lens, SPARSE_VOCAB, 0, 0,
                               main_ids)}
    for label, (sl, st, ln, vocab, seed, trunc, host) in b5_inputs.items():
        got = K.tokenize_hash(sl, st, ln, vocab_size=vocab, seed=seed,
                              truncate_at=trunc)
        want = K.tokenize_hash_plain(sl, st, ln, vocab_size=vocab,
                                     seed=seed, truncate_at=trunc)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"B5 {label}: differs from plain")
        check(torch.equal(got.cpu(), host),
              f"B5 {label}: ids differ from the host packer's")
        p = K.tokenize_hash_plan(st.shape[0], st.shape[1],
                                 slab_align=K._alignment(sl))
        cases.append({"kernel": "tokenize_hash", "case": label,
                      "shape": list(st.shape), "slab_bytes": sl.numel(),
                      "vocab": vocab, "word_windows": p["vec"],
                      "whole_output_equal": True,
                      "host_packer_equal": True, "max_abs_err": 0})
    live_tokens = int(batch.lengths.sum())
    hashed_bytes = sum(sum(map(len, d.split()[:DOC_LEN])) for d in docs)
    # Read once: the slab, lengths and the starts of live slots only (a
    # dead slot's id is 0 from lengths alone); written: [D, L] int32.
    b5_bytes = slab.size + live_tokens * 4 + N_DOCS * 4 + N_DOCS * DOC_LEN * 4
    # Per hashed byte, one 64-bit multiply by the FNV prime: about three
    # 32-bit multiply-adds; per live token, the fold's 64-bit remainder,
    # counted as four.
    b5_mads = 3 * hashed_bytes + 4 * live_tokens
    b5_bytes_ms = bound_ms(b5_bytes)
    b5_ops_ms = b5_mads / INT32_MAD_PER_S * 1e3
    summary["tokenize_hash"] = {
        **kernel_times(
            lambda: K.tokenize_hash(slab_d, starts, t_lens,
                                    vocab_size=SPARSE_VOCAB),
            lambda: K.tokenize_hash_plain(slab_d, starts, t_lens,
                                          vocab_size=SPARSE_VOCAB)),
        # the bytes wire's other device work: the token starts B5 reads
        "token_starts_ms": device_span_ms(lambda: token_starts(
            slab_d, blens_d, length=DOC_LEN, align=16)),
        "library_call": None,
        "bound_ms": max(b5_bytes_ms, b5_ops_ms),
        "bound_by": "bytes" if b5_bytes_ms >= b5_ops_ms else "operations",
        "bytes_bound_ms": b5_bytes_ms, "operations_bound_ms": b5_ops_ms,
        "kernel_bound_ms": max(b5_bytes_ms, b5_ops_ms), "max_abs_err": 0,
        "shape": {"D": N_DOCS, "L": DOC_LEN, "slab_bytes": int(slab.size),
                  "live_tokens": live_tokens, "hashed_bytes": hashed_bytes,
                  "int32_mads": b5_mads}}


def path_phase(name, T, K, corpus, cfg, expect, wire_dtype):
    """One main-path run on the card (timed, launches counted) and the
    same run on the CPU; returns the launch counts."""
    from tfidf_tpu_torch.parity import compare_topk
    from tfidf_tpu_torch.utils.timing import PhaseTimer

    timer = PhaseTimer()
    K.reset_launches()
    t0 = time.perf_counter()
    gpu = T.TfidfPipeline(cfg, timer=timer).run(corpus)
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    for kernel in expect:
        check(launches[kernel] > 0, f"{name}: {kernel} never launched")
    cpu = T.TfidfPipeline(cfg, device="cpu").run(corpus)
    check(np.array_equal(gpu.df, cpu.df), f"{name}: df differs from CPU run")
    batch = T.pack_corpus(corpus, cfg)
    cmp = compare_topk(gpu.topk_ids, gpu.topk_vals, cpu.topk_ids,
                       cpu.topk_vals, token_ids=batch.token_ids,
                       lengths=batch.lengths, df=cpu.df,
                       num_docs=batch.num_docs, wire_dtype=wire_dtype)
    check(cmp["ok"], f"{name}: top-k disagrees with CPU run: {cmp}")
    check(gpu.topk_vals.shape == (len(corpus), cfg.topk)
          and np.isfinite(gpu.topk_vals).all(), f"{name}: bad top-k values")
    # Where the device time of one warm run_packed goes (pack excluded).
    pipe = T.TfidfPipeline(cfg)
    prof = profile_summary(lambda: pipe.run_packed(batch))
    emit({"phase": name, "docs": len(corpus), "L": int(batch.token_ids.shape[1]),
          "vocab": cfg.vocab_size, "engine": cfg.engine, "topk": cfg.topk,
          "phases_s": timer.as_dict(), "wall_s": wall, "launches": launches,
          "vs_cpu": cmp, "device_profile": prof,
          "ok": True})
    return launches


def _result_fields(r) -> dict:
    return {f: getattr(r, f) for f in (
        "path", "wire", "result_wire", "finish", "n_finish_dispatches",
        "bytes_on_wire", "bytes_on_wire_padded", "bytes_off_wire",
        "bytes_off_wire_pair", "df_occupied", "num_docs")}


def _same_result(a, b) -> bool:
    """Identical words: ids and the 16-bit score bits, df and lengths."""
    return (np.array_equal(a.topk_ids, b.topk_ids)
            and np.array_equal(np.asarray(a.topk_vals, np.float16).view(np.uint16),
                               np.asarray(b.topk_vals, np.float16).view(np.uint16))
            and np.array_equal(a.df, b.df)
            and np.array_equal(a.lengths, b.lengths))


def _counted_run(K, FT, fn):
    """One main-path run with every kernel and native-packer count zeroed
    just before it; returns (result, wall seconds, kernel launches,
    native packer calls)."""
    K.reset_launches()
    for name in FT.NATIVE_CALLS:
        FT.NATIVE_CALLS[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return r, wall, dict(K.LAUNCHES), dict(FT.NATIVE_CALLS)


def path_ragged_batch(T, K, corpus, cfg, total):
    """A RaggedBatch through run_packed equals the PackedBatch run."""
    from tfidf_tpu_torch.io.corpus import pack_ragged
    pipe = T.TfidfPipeline(cfg)
    padded = pipe.run_packed(T.pack_corpus(corpus, cfg))
    rb = pack_ragged(corpus, cfg)
    K.reset_launches()
    ragged = pipe.run_packed(rb)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    for kernel, n in launches.items():
        total[kernel] += n
    check(launches["ragged_rebuild"] > 0, "path_ragged_batch: B4 never launched")
    check(np.array_equal(ragged.df, padded.df)
          and np.array_equal(ragged.topk_ids, padded.topk_ids)
          and np.array_equal(ragged.topk_vals, padded.topk_vals),
          "path_ragged_batch: RaggedBatch result differs from PackedBatch")
    emit({"phase": "path_ragged_batch", "docs": len(corpus),
          "flat_ids": int(rb.flat.size), "align": rb.align,
          "launches": launches, "equal_to_packed": True, "ok": True})


def path_ingest_resident(T, K, FT, ingest, root, corpus_docs, total,
                         warm_root):
    """run_overlapped on INGEST_DOCS documents, once per wire, after one
    cold run over ``warm_root`` (one chunk of the same shape)."""
    from tfidf_tpu_torch.parity import compare_topk
    n = len(corpus_docs)
    cfg = {w: T.PipelineConfig(vocab_mode=T.VocabMode.HASHED,
                               vocab_size=SPARSE_VOCAB, max_doc_len=DOC_LEN,
                               doc_chunk=DOC_LEN, topk=TOPK, wire=w)
           for w in ("ragged", "bytes", "padded")}
    expect = {"ragged": ("ragged_rebuild", "load_pack_flat"),
              "bytes": ("tokenize_hash", "load_slab_paths"),
              "padded": (None, "load_pack_paths")}
    run = {w: (lambda w=w: ingest.run_overlapped(
        root, cfg[w], chunk_docs=N_DOCS, doc_len=DOC_LEN)) for w in cfg}
    results, per_wire = {}, {}
    for w in cfg:
        if w == "ragged":  # cold: the first ingest pays the set-up
            ingest.run_overlapped(warm_root, cfg[w], chunk_docs=N_DOCS,
                                  doc_len=DOC_LEN)
        r, wall, launches, native = _counted_run(K, FT, run[w])
        for kernel, c in launches.items():
            total[kernel] += c
        kernel, packer = expect[w]
        check(native[packer] == INGEST_DOCS // N_DOCS,
              f"path_ingest_resident {w}: the native loader did not run "
              f"({native})")
        for k_ in ("fused_score_topk", "pack_words") + ((kernel,) if kernel else ()):
            check(launches[k_] > 0, f"path_ingest_resident {w}: {k_} never "
                  f"launched")
        check(r.wire == w and r.path == "resident" and r.finish == "scan"
              and r.n_finish_dispatches == 1 and r.result_wire == "packed",
              f"path_ingest_resident {w}: fields {_result_fields(r)}")
        check(r.topk_vals.shape == (n, TOPK) and np.isfinite(r.topk_vals).all(),
              f"path_ingest_resident {w}: bad top-k values")
        results[w] = r
        per_wire[w] = {"warm_wall_s": wall, "docs_per_s": n / wall,
                       "launches": launches, "native_calls": native,
                       "phases": r.phases, "fields": _result_fields(r)}
    for w in ("bytes", "padded"):
        check(_same_result(results[w], results["ragged"]),
              f"path_ingest_resident: the {w} wire's words differ from ragged")
    rg = results["ragged"]
    cpu = ingest.run_overlapped(root, cfg["ragged"], chunk_docs=N_DOCS,
                                doc_len=DOC_LEN, device="cpu")
    packer = ingest.make_chunk_packer(root, cfg["padded"], n, DOC_LEN)
    tok, lens = packer([f"doc{i}" for i in range(1, n + 1)])
    check(np.array_equal(rg.df, cpu.df) and np.array_equal(rg.lengths, cpu.lengths)
          and np.array_equal(rg.lengths, lens[:n]),
          "path_ingest_resident: df/lengths differ from the CPU run")
    vs_cpu = compare_topk(rg.topk_ids, rg.topk_vals, cpu.topk_ids, cpu.topk_vals,
                          token_ids=tok, lengths=lens, df=cpu.df, num_docs=n,
                          wire_dtype=np.float16)
    check(vs_cpu["ok"], f"path_ingest_resident: GPU vs CPU run: {vs_cpu}")
    corpus = T.Corpus(names=[f"doc{i}" for i in range(1, n + 1)],
                      docs=corpus_docs)
    batch = T.TfidfPipeline(cfg["ragged"]).run(corpus)
    check(np.array_equal(batch.df, rg.df),
          "path_ingest_resident: df differs from TfidfPipeline.run")
    vs_pipe = compare_topk(rg.topk_ids, rg.topk_vals, batch.topk_ids,
                           batch.topk_vals, token_ids=tok, lengths=lens,
                           df=rg.df, num_docs=n, wire_dtype=np.float16)
    check(vs_pipe["ok"], f"path_ingest_resident: vs TfidfPipeline.run: {vs_pipe}")
    # one warm ragged run over one chunk (the 32,768-doc directory)
    prof = profile_summary(lambda: ingest.run_overlapped(
        warm_root, cfg["ragged"], chunk_docs=N_DOCS, doc_len=DOC_LEN),
        warm_up=False)
    emit({"phase": "path_ingest_resident", "docs": n, "chunk_docs": N_DOCS,
          "doc_len": DOC_LEN, "vocab": SPARSE_VOCAB, "topk": TOPK,
          "cold_runs": ["ragged, the 32,768-doc directory"],
          "wires": per_wire, "wires_identical": True, "vs_cpu": vs_cpu,
          "vs_tfidf_pipeline": vs_pipe,
          "device_profile_ragged_32768": prof, "ok": True})
    return rg


class env_vars:
    """Set environment variables for a block, then restore them."""

    def __init__(self, **kv):
        self.kv = kv
        self.saved = {}

    def __enter__(self):
        self.saved = {k_: os.environ.get(k_) for k_ in self.kv}
        os.environ.update(self.kv)

    def __exit__(self, *exc):
        for k_, v in self.saved.items():
            if v is None:
                os.environ.pop(k_, None)
            else:
                os.environ[k_] = v


def path_ingest_streaming(T, K, FT, ingest, root, total):
    """The streaming regime (2 of 4 chunks triple-cached) equals the
    resident run of the same corpus, on the ragged and bytes wires."""
    n = N_DOCS
    env = {"TFIDF_TPU_RESIDENT_ELEMS": str(n * DOC_LEN - 1),
           "TFIDF_TPU_TRIPLE_CACHE_BYTES": str(
               2 * (STREAM_CHUNK * DOC_LEN * 9 + STREAM_CHUNK * 4))}

    def cfg(w):
        return T.PipelineConfig(vocab_mode=T.VocabMode.HASHED,
                                vocab_size=SPARSE_VOCAB, max_doc_len=DOC_LEN,
                                doc_chunk=DOC_LEN, topk=TOPK, wire=w)

    resident = ingest.run_overlapped(root, cfg("ragged"),
                                     chunk_docs=STREAM_CHUNK, doc_len=DOC_LEN)
    check(resident.path == "resident", "path_ingest_streaming: reference "
          "run is not resident")
    runs, results = {}, {}
    with env_vars(**env):
        for w in ("ragged", "bytes"):
            for spill in ("host", "reread"):
                fn = (lambda w=w, spill=spill: ingest.run_overlapped(
                    root, cfg(w), chunk_docs=STREAM_CHUNK, doc_len=DOC_LEN,
                    spill=spill))
                r, wall, launches, native = _counted_run(K, FT, fn)
                for kernel, c in launches.items():
                    total[kernel] += c
                label = f"{w}_{spill}"
                check(r.path == "streaming" and r.wire == w
                      and r.phases["triple_cached_chunks"] == 2
                      and r.finish == "scan" and r.n_finish_dispatches == 3,
                      f"path_ingest_streaming {label}: {_result_fields(r)}")
                check(launches["ragged_rebuild" if w == "ragged"
                               else "tokenize_hash"] > 0,
                      f"path_ingest_streaming {label}: wire kernel never "
                      f"launched")
                check(_same_result(r, resident),
                      f"path_ingest_streaming {label}: differs from the "
                      f"resident run")
                results[label] = r
                runs[label] = {"wall_s": wall, "docs_per_s": n / wall,
                               "launches": launches, "native_calls": native,
                               "phases": r.phases,
                               "fields": _result_fields(r)}
    emit({"phase": "path_ingest_streaming", "docs": n,
          "chunk_docs": STREAM_CHUNK, "env": env, "runs": runs,
          "equal_to_resident": True, "ok": True})
    return results["ragged_reread"]


RECOVERY_PLAN = "pack_worker:transient:at=2;drain:transient:at=2"


def _same_exact(a, b) -> bool:
    return (a.names == b.names and a.words == b.words
            and all(np.array_equal(getattr(a, f), getattr(b, f))
                    for f in ("lengths", "topk_ids", "topk_counts", "df")))


def path_recovery(T, K, FT, ingest, big, small, rg, total):
    """Supervised ingest workers on the card. With ``RECOVERY_PLAN``
    armed (the second pack job and the second drain job each crash
    once), the ragged wire on the 131,072-doc directory equals
    ``path_ingest_resident``'s clean ``rg`` bit for bit, and on the
    32,768-doc directory the bytes wire, the streaming regime (pass B
    re-reading) and device-exact each equal their clean runs; a fatal
    pack fault and an exhausted restart budget each surface. The
    restarts come from a flight log, the backoff from ``faults.backoff_s``
    and the heartbeats from an armed ``HealthMonitor``."""
    from tfidf_tpu_torch import faults, obs
    from tfidf_tpu_torch.obs.health import HealthMonitor, set_monitor

    def cfg(w, **kw):
        return T.PipelineConfig(vocab_mode=T.VocabMode.HASHED,
                                vocab_size=SPARSE_VOCAB, max_doc_len=DOC_LEN,
                                doc_chunk=DOC_LEN, topk=TOPK, wire=w, **kw)

    t_phase = time.perf_counter()
    stream_env = {"TFIDF_TPU_RESIDENT_ELEMS": str(N_DOCS * DOC_LEN - 1),
                  "TFIDF_TPU_TRIPLE_CACHE_BYTES": str(
                      2 * (STREAM_CHUNK * DOC_LEN * 9 + STREAM_CHUNK * 4))}
    # label -> (run, the kernels it must launch, same-result test, env);
    # the chunked finish drains every chunk, so the drain seam's second
    # check comes in every run but device-exact's (no drainer)
    cases = {
        "ragged_131072": (lambda: ingest.run_overlapped(
            big, cfg("ragged", finish="chunked"), chunk_docs=N_DOCS,
            doc_len=DOC_LEN), ("ragged_rebuild", "fused_score_topk",
                               "pack_words"), _same_result, {}),
        "bytes_32768": (lambda: ingest.run_overlapped(
            small, cfg("bytes", finish="chunked"), chunk_docs=STREAM_CHUNK,
            doc_len=DOC_LEN), ("tokenize_hash", "fused_score_topk",
                               "pack_words"), _same_result, {}),
        "streaming_32768": (lambda: ingest.run_overlapped(
            small, cfg("ragged"), chunk_docs=STREAM_CHUNK, doc_len=DOC_LEN,
            spill="reread"), ("ragged_rebuild", "fused_score_topk",
                              "pack_words"), _same_result, stream_env),
        "exact_32768": (lambda: ingest.run_overlapped_exact(
            small, cfg("ragged"), chunk_docs=STREAM_CHUNK,
            doc_len=DOC_LEN), ("ragged_rebuild", "fused_score_topk"),
            _same_exact, {}),
    }
    # a re-run drain waits on the same event and reads the same pinned
    # buffer, which the job's closure keeps alive between attempts
    copy = ingest._HostCopy(torch.from_numpy(np.ascontiguousarray(
        rg.topk_ids)).view(torch.uint32).cuda())
    first, second = copy.result(), copy.result()
    check(copy._host.is_pinned() and np.shares_memory(first, second)
          and np.array_equal(first, second),
          "path_recovery: a second read of a drain's copy differs")
    prev_log = obs.get_log()
    monitor = HealthMonitor()
    runs = {}
    try:
        set_monitor(monitor)
        for label, (fn, kernels, same, env) in cases.items():
            with env_vars(**env):
                clean, clean_wall, clean_launches, _ = _counted_run(K, FT, fn)
                log = obs.EventLog(echo="off")
                obs.set_log(log)
                faults.arm(faults.FaultPlan.parse(RECOVERY_PLAN))
                with returned_calls(faults, "backoff_s") as backoffs:
                    got, wall, launches, _ = _counted_run(K, FT, fn)
                receipts = faults.get_registry().snapshot()
                faults.disarm()
            for kernel, c in launches.items():
                total[kernel] += c + clean_launches[kernel]
            for kernel in kernels:
                check(launches[kernel] > 0, f"path_recovery {label}: "
                      f"{kernel} never launched")
            check(launches == clean_launches, f"path_recovery {label}: "
                  f"a restart relaunched device work ({launches} against "
                  f"{clean_launches})")
            check(same(got, clean), f"path_recovery {label}: the faulted "
                  f"run differs from the clean run")
            if label == "ragged_131072":
                check(_same_result(got, rg), "path_recovery: the faulted "
                      "ragged run differs from path_ingest_resident's")
            restarts = [(e["worker"], e["chunk"], e["restart"])
                        for e in log.events()
                        if e["event"] == "worker_restart"]
            by_worker = {w: sum(1 for r in restarts if r[0] == w)
                         for w in ("packer", "drainer")}
            check(by_worker["packer"] == 1 and by_worker["drainer"]
                  == (0 if label == "exact_32768" else 1),
                  f"path_recovery {label}: restarts {restarts}")
            runs[label] = {"clean_wall_s": clean_wall, "faulted_wall_s": wall,
                           "clean_launches": clean_launches,
                           "faulted_less_clean_s": wall - clean_wall,
                           "backoff_s": sum(out for _, out in backoffs),
                           "restarts": restarts,
                           "restarts_by_worker": by_worker,
                           "seam_receipts": receipts, "launches": launches}
        beats = sorted(monitor._workers)
        check(beats == ["drainer", "packer"],
              f"path_recovery: heartbeats {beats}")
        # a fatal fault and an exhausted budget surface to the caller
        outcomes = {}
        for label, spec, budget, exc in (
                ("fatal", "pack_worker:fatal:n=1", "3", faults.FatalFault),
                ("budget", "pack_worker:transient:n=5", "1",
                 faults.TransientFault)):
            faults.arm(faults.FaultPlan.parse(spec))
            try:
                with env_vars(TFIDF_TPU_RESTART_BUDGET=budget):
                    ingest.run_overlapped(small, cfg("ragged"),
                                          chunk_docs=STREAM_CHUNK,
                                          doc_len=DOC_LEN)
                outcomes[label] = None
            except exc as e:
                outcomes[label] = type(e).__name__
            finally:
                faults.disarm()
            check(outcomes[label] == exc.__name__,
                  f"path_recovery {label}: {spec} did not raise "
                  f"{exc.__name__}")
    finally:
        faults.disarm()
        set_monitor(None)
        obs.set_log(prev_log)
    emit({"phase": "path_recovery", "plan": RECOVERY_PLAN,
          "restart_budget": ingest._restart_budget(), "runs": runs,
          "heartbeats": beats,
          "surfaced": outcomes, "equal_to_clean": True,
          "ragged_equal_to_resident": True,
          "seconds": time.perf_counter() - t_phase, "ok": True})


def retrieval_queries(rng, n: int = RETR_QUERIES):
    """``n`` queries of 2-6 words from the corpus's vocabulary, word
    ranks drawn Zipf(1.3) as the documents' are."""
    ranks = np.clip(rng.zipf(1.3, n * 6), 1, N_WORDS) - 1
    lens = rng.integers(2, 7, n)
    offs = np.concatenate([[0], np.cumsum(lens)])
    return [" ".join(f"w{r}" for r in ranks[offs[i]:offs[i + 1]])
            for i in range(n)]


def host_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median host milliseconds of one ``fn()`` that ends on the host
    (a search returns host arrays, so its device work is inside)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _same_search(a, b) -> bool:
    return (np.array_equal(a[1], b[1])
            and np.array_equal(np.asarray(a[0], np.float32).view(np.uint32),
                               np.asarray(b[0], np.float32).view(np.uint32)))


RETR_SETTINGS = {"tfidf": {}, "bm25": {"scorer": "bm25"},
                 "bm25:k1=1.5,b=0.6": {"scorer": "bm25:k1=1.5,b=0.6"},
                 "tfidf+id_range": {"filter": {"id_range": [0, 65536]}}}
# About 0.5 ms at the H100's boost clock: longer than the host takes to
# enqueue an event pair around one tile's launch.
TILE_SLEEP_CYCLES = 1_000_000


def b6_tile_times(K, r, queries) -> dict:
    """Device ms of every B6 launch in one warm search, from CUDA events:
    the wrapper is wrapped so that a sleep kernel holds the stream while
    the host enqueues the start event, the launch and the end event; the
    search's other work is unchanged."""
    real = K.tile_scores
    spans = []

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(TILE_SLEEP_CYCLES)
        start.record()
        out = real(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    K.tile_scores = timed
    try:
        r.search(queries, k=RETR_K)
    finally:
        K.tile_scores = real
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in spans]
    return {"launches": len(ms), "sum_ms": sum(ms),
            "median_ms": statistics.median(ms), "max_ms": max(ms)}


@contextlib.contextmanager
def timed_calls(owner, name: str):
    """Inside the block, every call of ``owner.<name>`` (a module's
    function or an object's method) appends its host ms to the yielded
    list."""
    real = getattr(owner, name)
    own = name in vars(owner)
    calls = []

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            calls.append((time.perf_counter() - t0) * 1e3)

    setattr(owner, name, timed)
    try:
        yield calls
    finally:
        if own:
            setattr(owner, name, real)
        else:
            delattr(owner, name)  # the class's method again


def search_split(R, r, queries, settings, rounds: int = 4) -> dict:
    """Warm searches of each setting in turns (one of each per round,
    the order reversed every other round), each split into the host ms
    of ``pack_queries`` (timed inside the search), the device-busy
    ms (torch.profiler over the next search of the same setting) and the
    rest of the host latency; medians over the rounds, every round's
    total and the setting's place in it (0 first), and the last round's
    top device operations."""
    rows = {name: [] for name in settings}
    tops = {}
    with timed_calls(R, "pack_queries") as fills:
        for rnd in range(rounds):
            order = list(settings.items())
            for place, (name, kw) in enumerate(order[::-1] if rnd % 2
                                               else order):
                fills.clear()
                t0 = time.perf_counter()
                r.search(queries, k=RETR_K, **kw)
                total = (time.perf_counter() - t0) * 1e3
                fill = sum(fills)
                prof = profile_summary(
                    lambda kw=kw: r.search(queries, k=RETR_K, **kw),
                    top_n=6, warm_up=False)
                busy = prof["device_busy_ms"]
                rows[name].append({"total_ms": total, "fill_ms": fill,
                                   "device_busy_ms": busy,
                                   "rest_ms": total - fill - busy,
                                   "place": place})
                tops[name] = prof["top"]
    return {name: {**{key: statistics.median(x[key] for x in got)
                      for key in ("total_ms", "fill_ms", "device_busy_ms",
                                  "rest_ms")},
                   "totals_ms": [x["total_ms"] for x in got],
                   "fills_ms": [x["fill_ms"] for x in got],
                   "places": [x["place"] for x in got],
                   "top": tops[name]}
            for name, got in rows.items()}


def path_retrieval(T, K, root, corpus_docs, total):
    """TfidfRetriever on the ingest corpus: index_dir (B4), searches
    (B6), the within-port equalities and the card-vs-CPU agreement."""
    from tfidf_tpu_torch.models import retrieval as R
    from tfidf_tpu_torch.parity import compare_search

    n = len(corpus_docs)
    cfg = T.PipelineConfig(vocab_mode=T.VocabMode.HASHED,
                           vocab_size=SPARSE_VOCAB)
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = T.TfidfRetriever(cfg).index_dir(root, doc_len=DOC_LEN,
                                        chunk_docs=RETR_CHUNK)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    index_launches = dict(K.LAUNCHES)
    for kernel, c in index_launches.items():
        total[kernel] += c
    check(index_launches["ragged_rebuild"] == n // RETR_CHUNK,
          f"path_retrieval: index_dir launched B4 "
          f"{index_launches['ragged_rebuild']} times, not {n // RETR_CHUNK}")
    check(tuple(r._ids.shape) == (n, DOC_LEN) and r._num_docs == n,
          f"path_retrieval: index shape {tuple(r._ids.shape)}")
    index_mb = sum(t.nbytes for t in (r._ids, r._weights, r._head)) / 1e6
    queries = retrieval_queries(np.random.default_rng(SEED + 3))
    n_tiles = -(-n // RETR_TILE)
    results, latency, launches_per_search = {}, {}, {}
    for name, kw in RETR_SETTINGS.items():
        for q in (1, 64, RETR_QUERIES):
            qs = queries[:q]
            r.search(qs, k=RETR_K, **kw)  # warm: derives the scorer's face
            K.reset_launches()
            torch.cuda.synchronize()
            res = r.search(qs, k=RETR_K, **kw)
            launches = dict(K.LAUNCHES)
            for kernel, c in launches.items():
                total[kernel] += c
            check(launches["tile_scores"] == n_tiles,
                  f"path_retrieval {name} Q={q}: B6 launched "
                  f"{launches['tile_scores']} times, not once per tile "
                  f"({n_tiles})")
            vals, ids = res
            check(vals.shape == ids.shape == (q, RETR_K)
                  and np.isfinite(vals).all() and (vals >= 0).all()
                  and ((ids >= -1) & (ids < n)).all()
                  and ((ids >= 0) == (vals > 0)).all()
                  and (np.diff(vals, axis=1) <= 0).all(),
                  f"path_retrieval {name} Q={q}: malformed result")
            check((ids >= 0).sum() > q * RETR_K // 2,
                  f"path_retrieval {name} Q={q}: too few results")
            if "filter" in kw:
                check((ids < 65536).all(), "path_retrieval: the id_range "
                      "filter let a row past 65,536 through")
            results[name, q] = res
            launches_per_search[f"{name}/Q{q}"] = launches["tile_scores"]
            with timed_calls(R, "pack_queries") as fills:
                ms = host_ms(lambda: r.search(qs, k=RETR_K, **kw),
                             reps=RETR_REPS, warmup=1)
            # one fill a search: the median of the loop's calls, warm-ups in
            latency[f"{name}/Q{q}"] = {"ms": ms, "qps": q / ms * 1e3,
                                       "fill_ms": statistics.median(fills)}
    for name, kw in RETR_SETTINGS.items():
        big = results[name, RETR_QUERIES]
        check(_same_search((big[0][:64], big[1][:64]), results[name, 64]),
              f"path_retrieval {name}: the first 64 rows of the Q=256 "
              f"search differ from the Q=64 search")
        for q in (64, RETR_QUERIES):
            with env_vars(TFIDF_TPU_SCORE_TILING="off"):
                off = r.search(queries[:q], k=RETR_K, **kw)
            with env_vars(TFIDF_TPU_QUERY_BLOCK="1024"):
                narrow = r.search(queries[:q], k=RETR_K, **kw)
            check(_same_search(off, results[name, q]),
                  f"path_retrieval {name} Q={q}: untiled differs from tiled")
            check(_same_search(narrow, results[name, q]),
                  f"path_retrieval {name} Q={q}: tile 1,024 differs from "
                  f"4,096")
    fill = {}
    for q in (64, RETR_QUERIES):
        fill[f"Q{q}"] = host_ms(lambda: R.pack_queries(
            queries[:q], cfg, r._idf_host()), reps=5, warmup=1)
    prof = profile_summary(lambda: r.search(queries[:64], k=RETR_K))
    # B6 in the same search from CUDA events (the profiler misses some of
    # its records), and the filtered Q 256 search beside the unfiltered.
    b6_events = b6_tile_times(K, r, queries[:64])
    check(b6_events["launches"] == n_tiles,
          f"path_retrieval: timed {b6_events['launches']} B6 launches, not "
          f"{n_tiles}")
    b6_profiled = [t for t in prof["top"] if "tile_scores" in t["name"]]
    q256_split = search_split(R, r, queries[:RETR_QUERIES], {
        name: RETR_SETTINGS[name] for name in ("tfidf", "tfidf+id_range")})

    # a snapshot taken on the card, searched on the CPU
    with tempfile.TemporaryDirectory(dir=os.path.dirname(root)) as snap:
        t0 = time.perf_counter()
        r.snapshot(snap)
        snap_s = time.perf_counter() - t0
        cpu_r, _ = T.TfidfRetriever.restore(snap, device="cpu")
    t0 = time.perf_counter()
    cpu_res = cpu_r.search(queries[:64], k=RETR_K)
    cpu_search_s = time.perf_counter() - t0
    vs_cpu = compare_search(*results["tfidf", 64], *cpu_res)
    check(vs_cpu["ok"], f"path_retrieval: card vs CPU restore: {vs_cpu}")
    del cpu_r
    # an 8,192-doc index built on both devices (the batch index path)
    small = T.Corpus(names=[f"doc{i}" for i in range(1, RETR_SMALL + 1)],
                     docs=corpus_docs[:RETR_SMALL])
    g = T.TfidfRetriever(cfg).index(small)
    c = T.TfidfRetriever(cfg, device="cpu").index(small)
    small_cmp = {"weights_bit_equal": same_bits(g._weights.cpu(), c._weights),
                 "idf_bit_equal": same_bits(g._idf.cpu(), c._idf)}
    for name, kw in RETR_SETTINGS.items():
        a = g.search(queries[:64], k=RETR_K, **kw)
        b = c.search(queries[:64], k=RETR_K, **kw)
        cmp = compare_search(*a, *b, val_ulps=4 if "bm25" in name else 0)
        check(cmp["ok"], f"path_retrieval: {RETR_SMALL}-doc index, card vs "
              f"CPU, {name}: {cmp}")
        small_cmp[name] = cmp
    emit({"phase": "path_retrieval", "docs": n, "doc_len": DOC_LEN,
          "chunk_docs": RETR_CHUNK, "vocab": SPARSE_VOCAB, "k": RETR_K,
          "tile": RETR_TILE, "n_tiles": n_tiles, "index_s": index_s,
          "index_mb": index_mb, "index_launches": index_launches,
          "search_launches_b6": launches_per_search,
          "search_latency": latency, "pack_queries_ms": fill,
          "tiled_equals_untiled": True, "tile_1024_equals_4096": True,
          "q256_prefix_equals_q64": True, "snapshot_s": snap_s,
          "vs_cpu_restore": vs_cpu, "cpu_search_q64_s": cpu_search_s,
          "small_index_vs_cpu": small_cmp,
          "device_profile_q64": prof, "b6_tile_events_q64": b6_events,
          "b6_profiled_q64": b6_profiled, "q256_split": q256_split,
          "ok": True})
    return r, cfg, queries


# --- path_stream: StreamingTfidf, its checkpoint, the vectorizer, cli stream

# Run as ``python -c KILL_AFTER_SAVES N args...``: the port's CLI, killed
# hard (exit 137, no clean-up) right after its N-th checkpoint commit.
KILL_AFTER_SAVES = """
import os, sys
sys.path.insert(0, os.getcwd())
from tfidf_tpu_torch import checkpoint, cli
real, stop, seen = checkpoint.save_state, int(sys.argv[1]), []
def save_then_die(*args, **kwargs):
    out = real(*args, **kwargs)
    seen.append(1)
    if len(seen) == stop:
        os._exit(137)
    return out
checkpoint.save_state = save_then_die
sys.exit(cli.main(sys.argv[2:]))
"""


def _same_words(a, b) -> bool:
    """Equal top-k words: ids, and the bits of the 16-bit scores."""
    return (np.array_equal(a[1], b[1])
            and np.array_equal(np.asarray(a[0], np.float16).view(np.uint16),
                               np.asarray(b[0], np.float16).view(np.uint16)))


def _quiet(fn, *args):
    """``fn(*args)`` with its standard output captured (the CLI prints
    progress lines)."""
    import io
    with contextlib.redirect_stdout(io.StringIO()) as out:
        result = fn(*args)
    return result, out.getvalue()


def _stream_cfg(T, vocab, **kw):
    return T.PipelineConfig(vocab_mode=T.VocabMode.HASHED, vocab_size=vocab,
                            max_doc_len=DOC_LEN, doc_chunk=DOC_LEN, **kw)


def path_stream(T, K, root, corpus_docs, ingest_df, total):
    """StreamingTfidf over the ingest corpus in minibatches through
    pack_ragged (B4 every update and score; B1 and B3 every score), held
    against the resident ingest's DF, the port's CPU run and a resume from
    a checkpoint; one dense minibatch (B2); the vectorizer's [D, V]
    transform (B2); cli stream killed after a minibatch and resumed.
    Returns the uninterrupted cli stream's bytes (path_mesh_serve holds
    ``stream --mesh-docs 1`` to them)."""
    from tfidf_tpu_torch import checkpoint as ckpt
    from tfidf_tpu_torch import cli
    from tfidf_tpu_torch.models import TfidfVectorizer
    from tfidf_tpu_torch.ops.sparse import sorted_term_counts, sparse_df
    from tfidf_tpu_torch.pipeline import place_batch
    from tfidf_tpu_torch.streaming import StreamingTfidf

    n = len(corpus_docs)
    bsz = STREAM_BATCH
    cfg = _stream_cfg(T, SPARSE_VOCAB, topk=TOPK)
    names = [f"doc{i}" for i in range(1, n + 1)]
    t0 = time.perf_counter()
    packer = StreamingTfidf(cfg)
    batches = [packer.pack_ragged(T.Corpus(names=names[s:s + bsz],
                                           docs=corpus_docs[s:s + bsz]),
                                  fixed_len=DOC_LEN)
               for s in range(0, n, bsz)]
    pack_s = time.perf_counter() - t0
    nb = len(batches)

    def counted(fn):
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        for kernel, c in launches.items():
            total[kernel] += c
        return out, wall, launches

    gpu = StreamingTfidf(cfg)
    _, update_s, upd_launches = counted(
        lambda: [gpu.update(b) for b in batches])
    check(upd_launches["ragged_rebuild"] == nb,
          f"path_stream: update launched B4 {upd_launches['ragged_rebuild']}"
          f" times, not {nb}")
    check(gpu.docs_seen == n
          and np.array_equal(gpu.df(), np.asarray(ingest_df)),
          "path_stream: streamed DF differs from the resident ingest's")
    words, score_s, score_launches = counted(
        lambda: [gpu.score(b) for b in batches])
    for kernel in ("ragged_rebuild", "fused_score_topk", "pack_words"):
        check(score_launches[kernel] == nb, f"path_stream: score launched "
              f"{kernel} {score_launches[kernel]} times, not {nb}")
    check(all(w[0].shape == (len(b.names), TOPK) and np.isfinite(w[0]).all()
              for w, b in zip(words, batches)), "path_stream: bad words")

    t0 = time.perf_counter()
    cpu = StreamingTfidf(cfg, device="cpu")
    for b in batches:
        cpu.update(b)
    cpu_words = [cpu.score(b) for b in batches]
    cpu_s = time.perf_counter() - t0
    check(np.array_equal(cpu.df(), gpu.df()), "path_stream: CPU DF differs")
    check(all(_same_words(a, b) for a, b in zip(words, cpu_words)),
          "path_stream: card words differ from the CPU run's")

    # a checkpoint after minibatch STREAM_SAVE_AT, a fresh engine resumes
    first = StreamingTfidf(cfg)
    for b in batches[:STREAM_SAVE_AT]:
        first.update(b)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(root)) as ck:
        ckpt.save_state(ck, first.state_dict())
        resumed = StreamingTfidf(cfg)
        resumed.load_state(ckpt.restore_state(ck))
    check(resumed.docs_seen == STREAM_SAVE_AT * bsz,
          f"path_stream: restored docs_seen {resumed.docs_seen}")
    (_, resume_s, resume_launches) = counted(
        lambda: [resumed.update(b) for b in batches[STREAM_SAVE_AT:]])
    check(resumed.docs_seen == n and np.array_equal(resumed.df(), gpu.df()),
          "path_stream: the resumed DF differs from the uninterrupted run's")
    check(all(_same_words(resumed.score(b), w)
              for b, w in zip(batches, words)),
          "path_stream: the resumed words differ")

    # sparse_df's share of one update's device time (upload included)
    scratch = StreamingTfidf(cfg)
    toks, lens = place_batch(batches[0], scratch.device)
    ids, _, head = sorted_term_counts(toks, lens)
    update_ms = device_span_ms(lambda: scratch.update(batches[0]))
    sparse_df_ms = device_span_ms(lambda: sparse_df(ids, head, SPARSE_VOCAB))
    update_prof = profile_summary(lambda: scratch.update(batches[0]), top_n=8)

    # the dense engine on one minibatch at vocab 4,096 (B2)
    dcfg = _stream_cfg(T, DENSE_VOCAB, topk=TOPK, engine="dense")
    dense_gpu = StreamingTfidf(dcfg)
    db = dense_gpu.pack_ragged(T.Corpus(names=names[:bsz],
                                        docs=corpus_docs[:bsz]),
                               fixed_len=DOC_LEN)
    (dense_words, dense_s, dense_launches) = counted(
        lambda: (dense_gpu.update(db), dense_gpu.score(db))[1])
    check(dense_launches["tf_df"] == 2 and dense_launches["pack_words"] == 1,
          f"path_stream: dense minibatch launches {dense_launches}")
    dense_cpu = StreamingTfidf(dcfg, device="cpu")
    dense_cpu.update(db)
    check(np.array_equal(dense_cpu.df(), dense_gpu.df())
          and _same_words(dense_cpu.score(db), dense_words),
          "path_stream: the dense minibatch differs from the CPU run")

    # the vectorizer's [D, V] transform (topk None: B2 in the transform)
    vcfg = _stream_cfg(T, DENSE_VOCAB)
    small = T.Corpus(names=names[:bsz], docs=corpus_docs[:bsz])
    (mat, vec_s, vec_launches) = counted(
        lambda: TfidfVectorizer(vcfg, batch_docs=bsz).fit_transform(small))
    check(vec_launches["tf_df"] == 1, f"path_stream: vectorizer launches "
          f"{vec_launches}")
    cmat = TfidfVectorizer(vcfg, batch_docs=bsz,
                           device="cpu").fit_transform(small)
    check(mat.shape == (bsz, DENSE_VOCAB) and np.isfinite(mat).all()
          and (mat > 0).any()
          and np.array_equal(mat.view(np.uint32), cmat.view(np.uint32)),
          "path_stream: the vectorizer's [D, V] differs from the CPU run")
    del mat, cmat

    # cli stream over the streaming-ingest directory: uninterrupted (in
    # process) while a subprocess is killed after minibatch
    # STREAM_CLI_KILL, then resumed
    args = ["stream", "--input", root, "--batch-docs", str(bsz),
            "--doc-len", str(DOC_LEN), "--vocab-size", str(SPARSE_VOCAB),
            "--topk", str(TOPK)]
    n_cli = len(os.listdir(root))
    with tempfile.TemporaryDirectory(dir=os.path.dirname(root)) as tmp:
        full, killed_out = (os.path.join(tmp, f) for f in ("a.txt", "b.txt"))
        ck = os.path.join(tmp, "ck")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-c", KILL_AFTER_SAVES, str(STREAM_CLI_KILL)]
            + args + ["--output", killed_out, "--checkpoint", ck],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        ((rc, _), cli_s, cli_launches) = counted(
            lambda: _quiet(cli.main, args + ["--output", full]))
        try:
            _, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
        killed = subprocess.CompletedProcess(proc.args, proc.returncode,
                                             None, err)
        killed_s = time.perf_counter() - t0
        check(rc == 0 and cli_launches["fused_score_topk"] > 0
              and cli_launches["pack_words"] > 0,
              f"path_stream: cli stream rc {rc}, launches {cli_launches}")
        check(killed.returncode == 137 and not os.path.exists(killed_out),
              f"path_stream: the killed run exited {killed.returncode}: "
              f"{killed.stderr[-2000:]}")
        check(int(ckpt.restore_state(ck)["docs_seen"])
              == STREAM_CLI_KILL * bsz, "path_stream: the killed run's "
              "checkpoint is not at its last committed minibatch")
        ((rc, said), resumed_s, resumed_launches) = counted(
            lambda: _quiet(cli.main, args + ["--output", killed_out,
                                             "--checkpoint", ck, "--resume"]))
        want = open(full, "rb").read()
        check(rc == 0 and f"resumed at doc {STREAM_CLI_KILL * bsz}" in said
              and want and open(killed_out, "rb").read() == want,
              "path_stream: cli stream killed and resumed differs from the "
              "uninterrupted run")
    emit({"phase": "path_stream", "docs": n, "batch_docs": bsz,
          "minibatches": nb, "doc_len": DOC_LEN, "vocab": SPARSE_VOCAB,
          "topk": TOPK, "pack_ragged_s": pack_s,
          "update_s": update_s, "update_docs_per_s": n / update_s,
          "score_s": score_s, "score_docs_per_s": n / score_s,
          "update_launches": upd_launches, "score_launches": score_launches,
          "df_equals_resident_ingest": True, "cpu_run_s": cpu_s,
          "words_equal_cpu": True,
          "resume": {"saved_after": STREAM_SAVE_AT, "rest_s": resume_s,
                     "launches": resume_launches, "df_equal": True,
                     "words_equal": True},
          "one_update_device_ms": update_ms, "sparse_df_device_ms": sparse_df_ms,
          "sparse_df_share_of_update": sparse_df_ms / update_ms,
          "update_device_profile": update_prof,
          "dense_minibatch": {"vocab": DENSE_VOCAB, "s": dense_s,
                              "launches": dense_launches, "equal_cpu": True},
          "vectorizer": {"docs": bsz, "vocab": DENSE_VOCAB, "s": vec_s,
                         "launches": vec_launches, "bit_equal_cpu": True},
          "cli": {"docs": n_cli, "uninterrupted_s": cli_s,
                  "launches": cli_launches, "killed_after": STREAM_CLI_KILL,
                  "killed_run_s": killed_s, "resumed_s": resumed_s,
                  "resumed_launches": resumed_launches,
                  "bytes_equal": True, "output_bytes": len(want)},
          "ok": True})
    return want


# --- path_segmented: SegmentedIndex, mutations, compaction, views --------

SEG_SETTINGS = {"tfidf": {}, "bm25": {"scorer": "bm25"},
                "tfidf+id_range": {"filter": {"id_range": [0, 65536]}}}


def mutation_stream(rng, n_base: int):
    """The mutation calls of SEG_CALL docs each: SEG_ADDS new docs,
    SEG_UPDATES of base docs and SEG_DELETES of others, interleaved
    four adds, an update, a delete."""
    new = zipf_docs(rng, SEG_ADDS + SEG_UPDATES)
    perm = rng.permutation(n_base) + 1
    upd = [f"doc{i}" for i in perm[:SEG_UPDATES]]
    dele = [f"doc{i}" for i in perm[SEG_UPDATES:SEG_UPDATES + SEG_DELETES]]
    calls, a, u, d = [], 0, 0, 0
    for i in range((SEG_ADDS + SEG_UPDATES + SEG_DELETES) // SEG_CALL):
        kind = i % 6
        if kind < 4:
            calls.append(("add", [f"new{j}" for j in range(a, a + SEG_CALL)],
                          new[a + u:a + u + SEG_CALL]))
            a += SEG_CALL
        elif kind == 4:
            calls.append(("add", upd[u:u + SEG_CALL],
                          new[a + u:a + u + SEG_CALL]))
            u += SEG_CALL
        else:
            calls.append(("delete", dele[d:d + SEG_CALL], None))
            d += SEG_CALL
    return calls


def _named(view, res):
    """A search result as (score bits, names): comparable across row
    spaces (a view and a rebuild) and devices."""
    vals, ids = res
    return (np.asarray(vals, np.float32).view(np.uint32).tolist(),
            [[view.names[i] if i >= 0 else None for i in row] for row in ids])


def replay(idx, calls, queries, measure: bool = False):
    """Apply the mutation calls, compacting whenever the index asks (the
    compactor's tick); every SEG_VIEW_EVERY calls build a view and run a
    Q 64 tfidf search. Returns the named results and what was measured."""
    out = {"mutate_s": 0.0, "view_ms": [], "search_q64_ms": [],
           "compactions": [], "seals": 0, "results": []}
    for i, (kind, names, docs) in enumerate(calls):
        t0 = time.perf_counter()
        got = (idx.add_docs(names, docs) if kind == "add"
               else idx.delete_docs(names))
        out["mutate_s"] += time.perf_counter() - t0
        out["seals"] += got.get("sealed", 0)
        if idx.needs_compaction and measure and "multi_segment" not in out:
            v = idx.view()
            out["multi_segment"] = {
                "segments": v.num_segments,
                "Q1_ms": host_ms(lambda: v.search(queries[:1], k=RETR_K),
                                 reps=5, warmup=1),
                "Q64_ms": host_ms(lambda: v.search(queries[:64], k=RETR_K),
                                  reps=5, warmup=1)}
        summary = idx.compact()
        if summary is not None:
            out["compactions"].append(summary)
        if (i + 1) % SEG_VIEW_EVERY == 0:
            t0 = time.perf_counter()
            v = idx.view()
            if idx.device.type == "cuda":
                torch.cuda.synchronize()
            out["view_ms"].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            res = v.search(queries[:64], k=RETR_K)
            out["search_q64_ms"].append((time.perf_counter() - t0) * 1e3)
            out["results"].append(_named(v, res))
    return out


def _oracle_kw(view, oracle, kw):
    """The rebuild's arguments for a view search: a positional filter
    picks view rows, so it becomes the rebuild positions of the same
    live docs."""
    flt = kw.get("filter")
    if flt is None:
        return kw
    lo, hi = flt["id_range"]
    live = view._stacked()[2].cpu().numpy()
    where = {name: i for i, name in enumerate(oracle.names)}
    ids = [where[view.names[p]] for p in range(lo, min(hi, len(view.names)))
           if live[p]]
    return {**kw, "filter": {"ids": ids}}


def path_segmented(T, K, corpus_docs, queries, total):
    """SegmentedIndex over the ingest corpus: a mutation stream with
    seals and a compaction, views and searches (B6 every tile), every
    final search equal to rebuild_retriever() bit for bit, tiled equal
    to untiled, save/restore, and the stream replayed on an 8,192-doc
    base on the card and the CPU with equal searches. Returns the
    compacted index (path_mesh_serve shards its view)."""
    from tfidf_tpu_torch.index import SegmentedIndex

    n = len(corpus_docs)
    cfg = _stream_cfg(T, SPARSE_VOCAB)
    corpus = T.Corpus(names=[f"doc{i}" for i in range(1, n + 1)],
                      docs=corpus_docs)
    calls = mutation_stream(np.random.default_rng(SEED + 5), n)
    K.reset_launches()
    t0 = time.perf_counter()
    idx = SegmentedIndex.from_corpus(corpus, cfg, delta_docs=SEG_DELTA,
                                     compact_at=SEG_COMPACT_AT)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.view()
    torch.cuda.synchronize()
    first_view_s = time.perf_counter() - t0
    run = replay(idx, calls, queries, measure=True)
    launches = dict(K.LAUNCHES)
    for kernel, c in launches.items():
        total[kernel] += c
    check(launches["tile_scores"] > 0, "path_segmented: B6 never launched")
    check(len(run["compactions"]) == 1 and run["seals"] >= 4,
          f"path_segmented: {run['seals']} seals, "
          f"{len(run['compactions'])} compactions")
    view = idx.view()
    check(idx.num_docs == n + SEG_ADDS - SEG_DELETES,
          f"path_segmented: {idx.num_docs} live docs")
    after = {"segments": view.num_segments,
             "Q1_ms": host_ms(lambda: view.search(queries[:1], k=RETR_K),
                              reps=5, warmup=1),
             "Q64_ms": host_ms(lambda: view.search(queries[:64], k=RETR_K),
                               reps=5, warmup=1)}
    K.reset_launches()
    view.search(queries[:64], k=RETR_K)
    b6_per_search = K.LAUNCHES["tile_scores"]
    total["tile_scores"] += b6_per_search
    rows = int(view._stacked()[0].shape[0])
    check(b6_per_search == -(-rows // RETR_TILE),
          f"path_segmented: {b6_per_search} B6 launches for {rows} rows")

    # every final search equals a from-scratch rebuild, tiled and untiled
    t0 = time.perf_counter()
    oracle = idx.rebuild_retriever()
    rebuild_s = time.perf_counter() - t0
    final = {}
    for name, kw in SEG_SETTINGS.items():
        okw = _oracle_kw(view, oracle, kw)
        for q in (1, 64, RETR_QUERIES):
            qs = queries[:q]
            got = view.search(qs, k=RETR_K, **kw)
            vals, ids = got
            check(vals.shape == (q, RETR_K) and np.isfinite(vals).all()
                  and (ids >= 0).sum() > q * RETR_K // 2,
                  f"path_segmented {name} Q={q}: malformed result")
            check(_named(view, got) == _named(oracle, oracle.search(
                qs, k=RETR_K, **okw)),
                f"path_segmented {name} Q={q}: differs from the rebuild")
            with env_vars(TFIDF_TPU_SCORE_TILING="off"):
                off = view.search(qs, k=RETR_K, **kw)
            check(_same_search(off, got),
                  f"path_segmented {name} Q={q}: untiled differs from tiled")
            final[f"{name}/Q{q}"] = True

    with tempfile.TemporaryDirectory() as snap:
        t0 = time.perf_counter()
        idx.save(snap, epoch=1)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, meta = SegmentedIndex.restore(snap, cfg)
        restore_s = time.perf_counter() - t0
    bview = back.view()
    for name, kw in SEG_SETTINGS.items():
        check(_same_search(bview.search(queries[:64], k=RETR_K, **kw),
                           view.search(queries[:64], k=RETR_K, **kw))
              and bview.names == view.names,
              f"path_segmented {name}: restored index differs")
    del back, bview, oracle, view

    # the same stream on an 8,192-doc base, on the card and on the CPU
    small = T.Corpus(names=corpus.names[:RETR_SMALL],
                     docs=corpus_docs[:RETR_SMALL])
    small_calls = mutation_stream(np.random.default_rng(SEED + 6), RETR_SMALL)
    K.reset_launches()
    g = SegmentedIndex.from_corpus(small, cfg, delta_docs=SEG_DELTA,
                                   compact_at=SEG_COMPACT_AT)
    grun = replay(g, small_calls, queries)
    for kernel, c in K.LAUNCHES.items():
        total[kernel] += c
    t0 = time.perf_counter()
    c = SegmentedIndex.from_corpus(small, cfg, delta_docs=SEG_DELTA,
                                   compact_at=SEG_COMPACT_AT, device="cpu")
    crun = replay(c, small_calls, queries)
    cpu_replay_s = time.perf_counter() - t0
    check(len(grun["results"]) == len(crun["results"]) > 0
          and grun["results"] == crun["results"],
          "path_segmented: card and CPU searches differ during the replay")
    for name, kw in SEG_SETTINGS.items():
        gv, cv = g.view(), c.view()
        check(_named(gv, gv.search(queries[:64], k=RETR_K, **kw))
              == _named(cv, cv.search(queries[:64], k=RETR_K, **kw)),
              f"path_segmented: card and CPU differ at the end ({name})")
    emit({"phase": "path_segmented", "docs": n, "doc_len": DOC_LEN,
          "vocab": SPARSE_VOCAB, "delta_docs": SEG_DELTA,
          "compact_at": SEG_COMPACT_AT, "calls": len(calls),
          "docs_per_call": SEG_CALL, "adds": SEG_ADDS,
          "updates": SEG_UPDATES, "deletes": SEG_DELETES,
          "from_corpus_s": build_s, "first_view_s": first_view_s,
          "mutate_s": run["mutate_s"],
          "mutations_per_s": (SEG_ADDS + SEG_UPDATES + SEG_DELETES)
          / run["mutate_s"],
          "seals": run["seals"], "compactions": run["compactions"],
          "compaction_pause_ms": [x["pause_s"] * 1e3
                                  for x in run["compactions"]],
          "view_build_ms": run["view_ms"],
          "view_build_ms_median": statistics.median(run["view_ms"]),
          "search_q64_ms_per_view": run["search_q64_ms"],
          "multi_segment_search": run.get("multi_segment"),
          "after_compaction_search": after, "launches": launches,
          "stacked_rows": rows, "b6_launches_per_search": b6_per_search,
          "rebuild_s": rebuild_s, "final_equal_rebuild": final,
          "tiled_equals_untiled": True, "save_s": save_s,
          "restore_s": restore_s, "restored_equal": True,
          "replay_small": {"base_docs": RETR_SMALL,
                           "views_compared": len(grun["results"]),
                           "seals": grun["seals"],
                           "compactions": len(grun["compactions"]),
                           "card_mutate_s": grun["mutate_s"],
                           "cpu_s": cpu_replay_s, "card_equals_cpu": True},
          "ok": True})
    return idx


# --- path_exact_terms: the exact-terms mode, both engines ---------------

EXACT_HASHED_VOCAB = 4096  # path_exact_terms: fewer buckets than words
CHARGRAM_FILES = 8192      # path_chargram: source files, sorted paths
CHARGRAM_BYTES = 4096      # path_chargram: bytes kept a file (chargram_bench)
CHARGRAM_CPU_DOCS = 1024   # path_chargram: docs held against the CPU run
CHARGRAM_SPARSE_VOCAB = 1 << 20


@contextlib.contextmanager
def returned_calls(owner, name: str):
    """Inside the block, every call of ``owner.<name>`` appends
    ``(host seconds, returned value)`` to the yielded list."""
    real = getattr(owner, name)
    calls = []

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        calls.append((time.perf_counter() - t0, out))
        return out

    setattr(owner, name, wrapped)
    try:
        yield calls
    finally:
        setattr(owner, name, real)


def _exact_cfg(T, vocab: int):
    """The hashed top-k config of ``cli run --exact-terms --topk 16``:
    a 4 x k margin selection (the device-exact engine uses k + 8)."""
    return T.PipelineConfig(vocab_mode=T.VocabMode.HASHED, vocab_size=vocab,
                            max_doc_len=DOC_LEN, doc_chunk=DOC_LEN,
                            topk=4 * TOPK, engine="sparse")


def path_exact_terms(T, K, FT, ingest, big, small, total):
    """``rerank.exact_terms_lines`` on the card: the device-exact engine
    on the 131,072-doc directory (its launches counted: B4 every chunk,
    B1 in the finish); on the 32,768-doc directory the hashed re-rank
    engine at V 4,096 (more words than buckets: the intern table
    overflows and the ids-only ingest runs, B4 and B1), the card's lines
    equal to the CPU's, every line
    in the native oracle's output, exact recall 1.0 on every doc, the
    hashed engine's recall, ``profile_resident`` on the ragged wire and
    ``cli run --exact-terms`` in a subprocess on cuda."""
    from tfidf_tpu_torch import rerank
    from tfidf_tpu_torch.ops import _build
    from tfidf_tpu_torch.recall import exact_doc_recall, parse_oracle_output

    t_phase = time.perf_counter()
    n = INGEST_DOCS
    cfg = _exact_cfg(T, SPARSE_VOCAB)

    def lines_of(root, c, **kw):
        return rerank.exact_terms_lines(root, c, TOPK, doc_len=DOC_LEN,
                                        chunk_docs=N_DOCS, **kw)

    with returned_calls(ingest, "run_overlapped_exact") as ingests, \
            returned_calls(FT.InternSession, "emit") as emits:
        (lines, engine, _), wall, launches, _ = _counted_run(
            K, FT, lambda: lines_of(big, cfg))
    for kernel, c in launches.items():
        total[kernel] += c
    check(engine == "device-exact", f"path_exact_terms: engine {engine}")
    for k_ in ("ragged_rebuild", "fused_score_topk"):
        check(launches[k_] > 0, f"path_exact_terms: {k_} never launched")
    exact = ingests[0][1]
    check(exact.num_docs == n and len(exact.words) <= N_WORDS,
          "path_exact_terms: device-exact ingest fields")
    device_exact = {"docs": n, "wall_s": wall,
                    "docs_per_s": n / wall, "launches": launches,
                    "ingest_s": ingests[0][0], "emit_s": emits[0][0],
                    "phases": exact.phases, "distinct_words":
                        len(exact.words), "lines": lines.count(b"\n"),
                    "bytes": len(lines)}

    # The hashed engine on the 32,768-doc directory (V 4,096: more words
    # than buckets); its lines feed the recall below.
    hcfg = _exact_cfg(T, EXACT_HASHED_VOCAB)
    with returned_calls(ingest, "run_overlapped") as ids_runs:
        (hlines, hengine, hsample), hwall, hlaunches, _ = _counted_run(
            K, FT, lambda: lines_of(small, hcfg))
    for kernel, c in hlaunches.items():
        total[kernel] += c
    check(hengine == "hashed-rerank", f"path_exact_terms: V "
          f"{EXACT_HASHED_VOCAB} took the {hengine} engine")
    r = ids_runs[0][1]
    check(r.topk_vals is None and r.result_wire == "pair"
          and r.path == "resident",
          f"path_exact_terms: the hashed engine's ingest {_result_fields(r)}")
    for k_ in ("ragged_rebuild", "fused_score_topk"):
        check(hlaunches[k_] > 0, f"path_exact_terms: hashed engine: {k_} "
              f"never launched")
    hashed = {"docs": N_DOCS, "vocab": EXACT_HASHED_VOCAB, "wall_s": hwall,
              "docs_per_s": N_DOCS / hwall, "launches": hlaunches,
              "ingest_s": ids_runs[0][0], "ids_only_fields": _result_fields(r),
              "lines": hlines.count(b"\n")}

    # 32,768 docs: card = CPU, the oracle, recall, the profiler, the CLI.
    # The card's run is profiled; then the native oracle and the CLI run
    # in subprocesses while the CPU run and the phase profile run here.
    names = [f"doc{i}" for i in range(1, N_DOCS + 1)]
    small_out = []
    K.reset_launches()
    device_profile = profile_summary(
        lambda: small_out.append(lines_of(small, cfg)), warm_up=False)
    slaunches = dict(K.LAUNCHES)
    for kernel, c in slaunches.items():
        total[kernel] += c
    lines_s, _, sample = small_out[0]
    prof_cfg = T.PipelineConfig(vocab_mode=T.VocabMode.HASHED,
                                vocab_size=SPARSE_VOCAB, max_doc_len=DOC_LEN,
                                doc_chunk=DOC_LEN, topk=TOPK)

    def timed_run(cmd, **kw):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, timeout=600, **kw)
        return proc, time.perf_counter() - t0

    import concurrent.futures as cf
    with tempfile.TemporaryDirectory() as tmp, \
            cf.ThreadPoolExecutor(max_workers=2) as ex:
        oracle_out = os.path.join(tmp, "oracle.txt")
        cli_out = os.path.join(tmp, "exact.txt")
        oracle_job = ex.submit(
            timed_run, [str(_build.load_oracle()), small, oracle_out, "8"],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        cli_job = ex.submit(
            timed_run, [sys.executable, "-m", "tfidf_tpu_torch.cli", "run",
                        "--input", small, "--output", cli_out,
                        "--vocab-mode", "hashed", "--topk", str(TOPK),
                        "--doc-len", str(DOC_LEN), "--exact-terms",
                        "--timing"],
            capture_output=True, text=True, cwd=REPO,
            env={**os.environ, "PYTHONPATH": REPO})
        t0 = time.perf_counter()
        cpu_lines, cpu_engine, _ = lines_of(small, cfg, device="cpu")
        cpu_s = time.perf_counter() - t0
        check(cpu_engine == "device-exact" and cpu_lines == lines_s,
              "path_exact_terms: the card's lines differ from the CPU's")
        K.reset_launches()
        resident_profile = ingest.profile_resident(small, prof_cfg,
                                                   chunk_docs=STREAM_CHUNK,
                                                   doc_len=DOC_LEN)
        for kernel, c in K.LAUNCHES.items():
            total[kernel] += c
        oracle, oracle_s = oracle_job.result()
        check(oracle.returncode == 0, f"path_exact_terms: the native oracle "
              f"exited {oracle.returncode}: {oracle.stderr[-2000:]}")
        with open(oracle_out, "rb") as f:
            oracle_lines = f.read().splitlines()
        ref = parse_oracle_output(oracle_out)
        proc, cli_s = cli_job.result()
        check(proc.returncode == 0, f"path_exact_terms: cli run exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        with open(cli_out, "rb") as f:
            check(f.read() == lines_s, "path_exact_terms: cli run "
                  "--exact-terms differs from the library's lines")
    got = lines_s.splitlines()
    check(len(got) > N_DOCS and set(got) <= set(oracle_lines),
          "path_exact_terms: a line is not in the native oracle's output")
    per = sample(names)
    rec = [exact_doc_recall(ref.get(nm, []), [w for w, _ in per[nm]], TOPK)
           for nm in names]
    defined = [x for x in rec if x is not None]
    check(len(defined) > N_DOCS // 2 and all(x == 1.0 for x in defined),
          f"path_exact_terms: exact recall below 1.0 "
          f"(min {min(defined, default=None)})")
    hper = hsample(names)
    hrec = [exact_doc_recall(ref.get(nm, []), [w for w, _ in hper[nm]], TOPK)
            for nm in names]
    hrec = [x for x in hrec if x is not None]
    check("engine: device-exact" in proc.stderr,
          f"path_exact_terms: cli engine: {proc.stderr[-400:]}")
    emit({"phase": "path_exact_terms", "k": TOPK, "doc_len": DOC_LEN,
          "chunk_docs": N_DOCS, "device_exact": device_exact,
          "hashed_rerank": hashed,
          "small": {"docs": N_DOCS, "launches": slaunches,
                    "cpu_s": cpu_s, "card_equals_cpu": True,
                    "oracle_s": oracle_s, "lines_in_oracle": True,
                    "exact_recall": 1.0, "recall_docs": len(defined),
                    "hashed_rerank_recall_mean": float(np.mean(hrec)),
                    "hashed_rerank_recall_min": float(np.min(hrec)),
                    "hashed_rerank_lines": hlines.count(b"\n"),
                    "profile_resident_ragged": resident_profile,
                    "device_profile_device_exact": device_profile},
          "cli": {"docs": N_DOCS, "seconds": cli_s, "bytes_equal": True,
                  "device": "cuda", "stderr_tail": proc.stderr[-400:]},
          "beside_the_oracle_and_cli": ["cpu run", "profile_resident"],
          "seconds": time.perf_counter() - t_phase, "ok": True})


# --- path_chargram: the device chargram on source files -----------------

def chargram_corpus(Corpus):
    """Up to CHARGRAM_FILES files in sorted path order (as many as the
    machine holds, if fewer), the first CHARGRAM_BYTES bytes of each: the
    repository's own *.py/*.cc/*.h/*.cu/*.md (no directory that
    .gitignore lists), then the .py files of the installed torch, numpy
    and scipy packages. Nothing is downloaded. Returns the corpus and
    where its files came from."""
    import importlib.util

    def walk(root, exts, skip=()):
        found = []
        for dirpath, dirnames, files in os.walk(root):
            dirnames[:] = [d for d in dirnames if d not in skip]
            found += [os.path.join(dirpath, f) for f in files
                      if f.endswith(exts)]
        return sorted(found)

    with open(os.path.join(REPO, ".gitignore")) as f:  # build outputs
        ignored = {ln.strip().rstrip("/").rsplit("/", 1)[-1] for ln in f
                   if ln.strip().endswith("/")}
    paths = walk(REPO, (".py", ".cc", ".h", ".cu", ".md"),
                 ignored | {".git"})
    sources = {"repo": len(paths)}
    for pkg in ("torch", "numpy", "scipy"):
        spec = importlib.util.find_spec(pkg)
        more = (walk(os.path.dirname(spec.origin), (".py",))
                if spec and spec.origin else [])
        sources[pkg] = len(more)
        paths += more
    paths = paths[:CHARGRAM_FILES]
    docs = []
    for p in paths:
        with open(p, "rb") as f:
            docs.append(f.read(CHARGRAM_BYTES))
    return Corpus(names=[f"doc{i}" for i in range(1, len(docs) + 1)],
                  docs=docs), sources


def chargram_triples(corpus):
    """The sparse chargram's sorted triples of ``corpus`` on the card at
    V 2^20 (3..5-grams): ``(ids, counts, head, docSize, idf)``, the
    inputs B1 gets on that path."""
    from tfidf_tpu_torch import pipeline as P
    from tfidf_tpu_torch.io.corpus import pack_bytes
    from tfidf_tpu_torch.ops.scoring import idf_from_df
    from tfidf_tpu_torch.ops.sparse import sorted_term_counts_masked, sparse_df

    dev = torch.device("cuda")
    packed = pack_bytes(corpus)
    ids, valid, tlen = P._ngram_streams(
        torch.from_numpy(packed.byte_ids).to(dev),
        torch.from_numpy(packed.byte_lengths).to(dev),
        vocab_size=CHARGRAM_SPARSE_VOCAB, ngram_lo=3, ngram_hi=5, seed=0)
    s_ids, counts, head = sorted_term_counts_masked(ids, valid)
    idf = idf_from_df(sparse_df(s_ids, head, CHARGRAM_SPARSE_VOCAB),
                      len(corpus), torch.float32)
    return s_ids, counts, head, tlen, idf


def chargram_cfgs(T, **extra):
    """path_chargram's two configs: the sparse lowering at V 2^20
    (explicit engine) and the dense one at V 2^16 (defaulted engine);
    ``extra`` fields (a mesh_shape) on both, each config made fresh so a
    defaulted engine stays defaulted."""
    return {"sparse": T.PipelineConfig(
                vocab_mode=T.VocabMode.HASHED, tokenizer=T.TokenizerKind.CHARGRAM,
                vocab_size=CHARGRAM_SPARSE_VOCAB, topk=TOPK, engine="sparse",
                **extra),
            "dense": T.PipelineConfig(
                vocab_mode=T.VocabMode.HASHED, tokenizer=T.TokenizerKind.CHARGRAM,
                vocab_size=SPARSE_VOCAB, topk=TOPK, **extra)}


def path_chargram(T, K, FT, total):
    """BASELINE config 4 on the card: char 3..5-gram TF-IDF over source
    files through ``TfidfPipeline.run`` (the device chargram): the sparse
    lowering at V 2^20 (explicit engine, B1, the pair wire) and the dense
    one at V 2^16 (defaulted engine, B3 on the packed wire); each held
    bit for bit against the CPU run on the first 1,024 docs; B1 timed at
    the chargram's row width; a device profile of one warm run each."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    corpus, sources = chargram_corpus(T.Corpus)
    read_s = time.perf_counter() - t0
    n = len(corpus)
    n_bytes = sum(map(len, corpus.docs))
    check(n >= CHARGRAM_CPU_DOCS, f"path_chargram: only {n} source files")
    cfgs = chargram_cfgs(T)
    expect = {"sparse": "fused_score_topk", "dense": "pack_words"}
    small = T.Corpus(names=corpus.names[:CHARGRAM_CPU_DOCS],
                     docs=corpus.docs[:CHARGRAM_CPU_DOCS])
    out = {}
    for name, cfg in cfgs.items():
        pipe = T.TfidfPipeline(cfg)
        pipe.run(corpus)  # cold
        r, wall, launches, _ = _counted_run(K, FT, lambda: pipe.run(corpus))
        for kernel, c in launches.items():
            total[kernel] += c
        check(launches[expect[name]] > 0,
              f"path_chargram {name}: {expect[name]} never launched")
        if name == "sparse":
            check(launches["pack_words"] == 0, "path_chargram sparse: the "
                  "pair wire was not used past 2^16")
        else:
            check(launches["tf_df"] == 0 and launches["fused_score_topk"] == 0,
                  f"path_chargram dense: not the dense lowering {launches}")
        check(r.topk_ids.shape == (n, TOPK) and np.isfinite(r.topk_vals).all()
              and (r.topk_vals >= 0).all() and r.df.shape == (cfg.vocab_size,),
              f"path_chargram {name}: bad result")
        want_len = sum(np.maximum(np.array([len(d) for d in corpus.docs])
                                  - (m - 1), 0) for m in (3, 4, 5))
        check(np.array_equal(r.lengths, want_len),
              f"path_chargram {name}: docSize is not the n-gram count")
        gpu_small = pipe.run(small)
        cpu_small = T.TfidfPipeline(cfg, device="cpu").run(small)
        check(np.array_equal(gpu_small.df, cpu_small.df)
              and np.array_equal(gpu_small.lengths, cpu_small.lengths)
              and np.array_equal(gpu_small.topk_ids, cpu_small.topk_ids)
              and np.array_equal(np.asarray(gpu_small.topk_vals).view(np.uint8),
                                 np.asarray(cpu_small.topk_vals).view(np.uint8)),
              f"path_chargram {name}: the card's run on {CHARGRAM_CPU_DOCS} "
              f"docs differs from the CPU's")
        out[name] = {"vocab": cfg.vocab_size, "warm_wall_s": wall,
                     "docs_per_s": n / wall, "mb_per_s": n_bytes / wall / 1e6,
                     "launches": launches,
                     "result_wire": "pair" if name == "sparse" else "packed",
                     "cpu_bit_equal_docs": CHARGRAM_CPU_DOCS,
                     "device_profile": profile_summary(
                         lambda: pipe.run(corpus), warm_up=False)}
    # B1 at the chargram's shape: the corpus's rows of 3 x 4,096 slots
    s_ids, counts, head, tlen, idf = chargram_triples(corpus)
    kv, kt = K.fused_score_topk(s_ids, counts, head, tlen, idf, k=TOPK)
    pv, pt = K.fused_score_topk_plain(s_ids, counts, head, tlen, idf, k=TOPK)
    check(torch.equal(kt, pt) and same_bits(kv, pv),
          "path_chargram: B1 at the chargram shape differs from plain")
    d, length = s_ids.shape
    n_head = int(head.sum())
    n_idf = int(torch.unique(s_ids[head]).numel())
    b1_bytes = (d * 4 + d * length + n_head * 8 + n_idf * 4
                + d * TOPK * 8)
    b1 = {"shape": [d, length], "k": TOPK, "head_slots": n_head,
          "ms": device_span_ms(lambda: K.fused_score_topk(
              s_ids, counts, head, tlen, idf, k=TOPK)),
          "plain_ms": device_span_ms(lambda: K.fused_score_topk_plain(
              s_ids, counts, head, tlen, idf, k=TOPK)),
          "bound_ms": bound_ms(b1_bytes), "bound_by": "bytes",
          "ids_equal": True, "scores_bit_equal": True}
    emit({"phase": "path_chargram", "docs": n, "bytes": n_bytes,
          "max_bytes": CHARGRAM_BYTES, "ngram": [3, 5], "topk": TOPK,
          "slots_per_row": length, "sources": sources, "read_s": read_s,
          "engines": out, "b1_at_chargram_shape": b1,
          "seconds": time.perf_counter() - t_phase, "ok": True})
    return corpus


# --- path_mesh and path_multiprocess: the parallel run paths ----------

MESH_SHARDS = 4           # path_mesh: virtual shards of the one card
MP_WORKERS = (2, 4)       # path_multiprocess: worker processes
MP_REPEAT = 1             # path_multiprocess: timed runs in each worker


def _same_topk(a, b, n: int) -> bool:
    """Equal DF, and the first ``n`` rows' ids and score bits (either
    wire: float16 words unpacked, or the float32 pair)."""
    va, vb = np.asarray(a.topk_vals)[:n], np.asarray(b.topk_vals)[:n]
    return (np.array_equal(a.df, b.df)
            and np.array_equal(a.topk_ids[:n], b.topk_ids[:n])
            and va.dtype == vb.dtype
            and np.array_equal(va.view(np.uint8), vb.view(np.uint8)))


def cli_runs(runs: dict) -> dict:
    """``python -m tfidf_tpu_torch.cli`` once per entry of ``runs`` (label
    -> (argv, stdin text or None[, extra environment])), all at once in
    subprocesses without ``--device`` (so on cuda); raises unless each
    exits 0. An argv item ``"{out}"`` becomes a file path whose bytes are
    returned; without one the bytes are stdout's. Returns label ->
    {"bytes", "seconds", "stderr", "concurrent"}."""
    import concurrent.futures as cf

    def one(label, argv, stdin, tmp, env=None):
        path = os.path.join(tmp, f"{label}.out")
        argv = [path if a == "{out}" else a for a in argv]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tfidf_tpu_torch.cli", *argv],
            input=stdin, capture_output=True, text=True, cwd=REPO,
            timeout=600, env={**os.environ, "PYTHONPATH": REPO,
                              **(env or {})})
        secs = time.perf_counter() - t0
        check(proc.returncode == 0, f"cli {label} exit {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        if path in argv:
            with open(path, "rb") as f:
                out = f.read()
        else:
            out = proc.stdout.encode()
        return {"bytes": out, "seconds": secs, "stderr": proc.stderr,
                "concurrent": len(runs)}

    with tempfile.TemporaryDirectory() as tmp, \
            cf.ThreadPoolExecutor(max_workers=len(runs)) as ex:
        jobs = {label: ex.submit(one, label, *run[:2], tmp, *run[2:])
                for label, run in runs.items()}
        return {label: job.result() for label, job in jobs.items()}


def query_args(small, queries) -> list:
    """``cli query`` over the 32,768 files with SERVE_CLI_QUERIES
    queries: the batch index (``--mesh-docs`` takes no ``--doc-len``)."""
    args = ["query", "--input", small, "-k", str(RETR_K)]
    for q in queries[:SERVE_CLI_QUERIES]:
        args += ["--query", q]
    return args


def cli_commands(small, queries, golden_dir, observe_dir) -> dict:
    """The CLI runs the observe, mesh, multi-process, mesh-serve,
    replicas and serve phases check, over the 32,768 files: ``run
    --doc-len 256`` traced (into ``observe_dir``, with
    ``TFIDF_TPU_DEVMON=1``) and untraced, with ``--mesh 1,1,1`` and with
    ``--ingest-workers 4``; traced, the bytes wire's run and the golden
    batch run over ``golden_dir``;
    ``query`` and ``stream`` with ``--mesh-docs 1`` (their plain runs are
    path_mesh_serve's and path_stream's, in process); ``serve --doc-len
    256`` plain and with ``--mesh-shards 1`` on the same request lines;
    ``serve --delta-docs 1024`` with ``--replicas 2`` (a front and two
    replica processes) and without, on path_replicas' script."""
    run = ["run", "--input", small, "--output", "{out}", "--vocab-mode",
           "hashed", "--topk", str(TOPK), "--doc-len", str(DOC_LEN)]
    # path_stream's cli stream arguments
    stream = ["stream", "--input", small, "--output", "{out}",
              "--batch-docs", str(STREAM_BATCH), "--doc-len", str(DOC_LEN),
              "--vocab-size", str(SPARSE_VOCAB), "--topk", str(TOPK)]
    serve = ["serve", "--input", small, "--doc-len", str(DOC_LEN), "-k",
             str(RETR_K), "--canary-period-ms", "0"]
    lines = [json.dumps({"id": i, "queries": [queries[i]], "k": RETR_K})
             for i in range(SERVE_CLI_QUERIES)]
    lines += [json.dumps({"id": f"op_{op}", "op": op})
              for op in ("healthz", "readyz", "metrics", "devmon")]
    lines.append(json.dumps({"op": "shutdown"}))
    lines = "\n".join(lines) + "\n"

    def traced(label):
        return ["--trace", os.path.join(observe_dir, f"{label}.json")]

    golden = ["run", "--input", golden_dir, "--output", "{out}"]
    return {"single": (run + traced("single"), None,
                       {"TFIDF_TPU_DEVMON": "1"}),
            "single_untraced": (run, None),
            "bytes": (run + ["--wire", "bytes"] + traced("bytes"), None),
            "golden": (golden + traced("golden"), None),
            "mesh_111": (run + ["--mesh", "1,1,1"], None),
            "workers_4": (run + ["--ingest-workers", "4"], None),
            "query_mesh_1": (query_args(small, queries)
                             + ["--mesh-docs", "1"], None),
            "stream_mesh_1": (stream + ["--mesh-docs", "1"], None),
            "serve_single": (serve, lines),
            "serve_mesh_1": (serve + ["--mesh-shards", "1"], lines),
            **replica_cli_commands(small, queries)}


# path_observe: the ingest's spans on their lanes, and the spans that must
# carry the bytes they move (tools/trace_check.py's ingest rules)
OBSERVE_LANES = {"main": {"pack_wait", "dispatch", "phase_b", "fetch_wait",
                          "emit"},
                 "packer": {"pack"}, "drainer": {"drain"}}
OBSERVE_STAMPED = ("dispatch", "fetch", "drain", "slab", "device_tokenize")
GOLDEN_PHASES = {"discover", "pack", "transfer", "compute", "fetch", "emit"}
OBSERVE_KERNELS = {"ragged": ("ragged_rebuild", "fused_score_topk",
                              "pack_words"),
                   "bytes": ("tokenize_hash", "fused_score_topk",
                             "pack_words")}
OBSERVE_Q = (1, 64)


def traced_run(T, label, cli, observe_dir, peak_gbs, lanes_want, want,
               must_stamp=OBSERVE_STAMPED):
    """One traced CLI run: the bytes ``want`` (what the run writes
    untraced), the span names on their lanes, a byte stamp on each span
    named in ``must_stamp``, every stamp's GB/s under the card's peak;
    returns its figures and its events."""
    from tfidf_tpu_torch import obs
    from tfidf_tpu_torch.obs import costmodel

    traced = cli[label]
    check(traced["bytes"] == want,
          f"path_observe {label}: traced bytes differ from untraced")
    path = os.path.join(observe_dir, f"{label}.json")
    events = obs.load_chrome_trace(path)
    lanes = obs.spans_by_thread(events)
    names = {lane: sorted({e["name"] for e in evs})
             for lane, evs in lanes.items()}
    for lane, want in lanes_want.items():
        check(want <= set(names.get(lane, ())),
              f"path_observe {label}: lane {lane} has {names.get(lane)}, "
              f"not {sorted(want)}")
    stamped, max_gbps = {}, {}
    for e in (e for evs in lanes.values() for e in evs):
        b = (e.get("args") or {}).get("bytes")
        if e["name"] in must_stamp:
            check(isinstance(b, (int, float)), f"path_observe {label}: "
                  f"{e['name']} span without bytes: {e.get('args')}")
        gbps = costmodel.span_gbps(e)
        if gbps is not None:
            check(gbps <= 1.05 * peak_gbs, f"path_observe {label}: "
                  f"{e['name']} at {gbps} GB/s, past 1.05 x {peak_gbs}")
            stamped[e["name"]] = stamped.get(e["name"], 0) + int(b)
            max_gbps[e["name"]] = max(max_gbps.get(e["name"], 0.0), gbps)
    flight = [json.loads(line) for line in open(path + ".flight.jsonl")]
    censuses = [e for e in flight[1:] if e.get("event") == "hbm_census"]
    out = {"wall_s": traced["seconds"], "bytes_equal": True, "spans": sum(map(len, lanes.values())),
           "lanes": names, "stamped_bytes": stamped,
           "max_gb_s": max_gbps, "trace_bytes": os.path.getsize(path),
           "flight_bytes": os.path.getsize(path + ".flight.jsonl"),
           "flight_events": flight[0]["events"]}
    if censuses:
        out["hbm_census_total_bytes"] = censuses[-1]["total_bytes"]
        out["hbm_census_owners"] = censuses[-1]["owners"]
    return out, lanes


def observe_oracle(T, big_docs, rcfg, queries) -> dict:
    """The RETR_SMALL index's searches against scoring.oracle.oracle_topk
    on the index's host arrays: the same ids in the same order, scores
    allclose."""
    from tfidf_tpu_torch.models.retrieval import query_matrix
    from tfidf_tpu_torch.scoring import oracle, parse_filter, parse_scorer
    from tfidf_tpu_torch.scoring.filters import filter_mask

    small = T.Corpus(names=[f"doc{i}" for i in range(1, RETR_SMALL + 1)],
                     docs=big_docs[:RETR_SMALL])
    r = T.TfidfRetriever(rcfg).index(small)
    out = {}
    for name in ("tfidf", "bm25", "tfidf+id_range"):
        kw = RETR_SETTINGS[name]
        spec = parse_scorer(kw.get("scorer"))
        data, cols = r.scorer_face(spec)
        live = np.zeros((data.shape[0],), bool)
        live[:r._num_docs] = True
        fspec = parse_filter(kw.get("filter"))
        if fspec is not None:
            live[:r._num_docs] &= filter_mask(fspec, r._num_docs,
                                              names=r.names)
        for q in OBSERVE_Q:
            vals, ids = r.search(queries[:q], k=RETR_K, **kw)
            qmat = query_matrix(queries[:q], rcfg, r._idf_host(),
                                mode="counts" if spec.kind == "bm25"
                                else "cosine")
            wv, wi = oracle.oracle_topk(data, cols, live, qmat, RETR_K)
            check(np.array_equal(ids, wi), f"path_observe oracle {name} "
                  f"Q={q}: ids or tie order differ from oracle_topk")
            check(np.allclose(vals, wv, rtol=1e-5, atol=1e-6),
                  f"path_observe oracle {name} Q={q}: scores not allclose")
            out[f"{name}/Q{q}"] = {
                "ids_equal": True, "results": int((ids >= 0).sum()),
                "max_abs_err": float(np.abs(vals - wv).max())}
    return out


def start_capture(small, observe_dir, wire):
    """tfidf_tpu_torch/tools/trace_capture.py of one warm chunk of the
    32,768 files on ``wire``, in a process of its own: this one has held
    many profiler sessions by now, and torch 2.11's profiler loses device
    records after a large one (PERF.md §6). Returns the process and
    its capture directory."""
    cap_dir = os.path.join(observe_dir, f"capture_{wire}")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tfidf_tpu_torch", "tools",
                                      "trace_capture.py"),
         "--input", small, "--len", str(DOC_LEN), "--wire", wire,
         "--out", cap_dir], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
    return proc, cap_dir


def path_observe(T, K, ingest, small, big_docs, rcfg, queries, total, cli,
                 observe_dir, gold_bytes):
    """Traced CLI runs, the device span's close, the device-op table of
    one warm ingest chunk, the cost model beside it and the search
    against the scoring oracle."""
    from tfidf_tpu_torch import obs
    from tfidf_tpu_torch.obs import costmodel

    t_phase = time.perf_counter()
    # the two captures run at once, beside this process's checks
    captures = {wire: start_capture(small, observe_dir, wire)
                for wire in OBSERVE_KERNELS}
    peak = costmodel.hbm_peak_gbs(torch.cuda.get_device_name(0))
    check(peak is not None, "path_observe: no HBM peak for the card")
    out = {"peak_gb_s": peak}
    runs, events = {}, {}
    plain = cli["single_untraced"]["bytes"]  # every wire writes these
    for label, lanes_want, want, must_stamp in (
            ("single", OBSERVE_LANES, plain, OBSERVE_STAMPED),
            ("bytes", {**OBSERVE_LANES, "packer": {"pack", "slab"},
                       "main": OBSERVE_LANES["main"] | {"device_tokenize"}},
             plain, OBSERVE_STAMPED),
            # the batch pipeline's phases carry no byte stamps (as in
            # the JAX package)
            ("golden", {"main": GOLDEN_PHASES}, gold_bytes, ())):
        runs[label], events[label] = traced_run(
            T, label, cli, observe_dir, peak, lanes_want, want, must_stamp)
    runs["single"]["untraced_wall_s"] = cli["single_untraced"]["seconds"]
    check(runs["single"].get("hbm_census_total_bytes", 0) > 0,
          f"path_observe: the traced run's flight dump holds no census of "
          f"more than 0 bytes: {runs['single'].get('hbm_census_owners')}")
    out["traced_runs"] = runs

    # A device span closes after its device work: a sleep kernel of
    # 4 x SLEEP_CYCLES (about 20 ms) inside the ingest's phase_b span.
    obs.set_tracer(obs.Tracer())
    try:
        torch.cuda.synchronize()
        with ingest._device_phase([torch.device("cuda")], "phase_b"):
            torch.cuda._sleep(4 * SLEEP_CYCLES)
        (span,) = [e for e in obs.get_tracer().chrome_events()
                   if e.get("ph") == "X"]
    finally:
        obs.set_tracer(None)
    sleep_ms = device_span_ms(lambda: torch.cuda._sleep(4 * SLEEP_CYCLES),
                              reps=3, warmup=1)
    check(span["dur"] / 1e3 >= 0.9 * sleep_ms,
          f"path_observe: phase_b closed after {span['dur'] / 1e3} ms, "
          f"before its {sleep_ms} ms sleep kernel ended")
    out["device_span_close"] = {"span_ms": span["dur"] / 1e3,
                                "sleep_kernel_ms": sleep_ms}

    out["oracle"] = observe_oracle(T, big_docs, rcfg, queries)

    # the device-op table of one warm chunk on each wire
    tables = {}
    for wire, kernels in OBSERVE_KERNELS.items():
        proc, cap_dir = captures[wire]
        stdout, stderr = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"path_observe trace_capture {wire}: "
              f"exit {proc.returncode}: {stderr[-2000:]}")
        cap = json.loads(stdout.strip().splitlines()[-1])
        every, total_us = obs.device_op_table(obs.load_chrome_trace(
            os.path.join(cap_dir, "device_trace.json")), top=1 << 30)
        check(total_us == cap["total_us"] and cap["wire"] == wire
              and cap["path"] == "resident",
              f"path_observe capture {wire}: {cap['wire']} {cap['path']}")
        calls, kernel_ms = {}, {}
        for kernel in kernels:
            fn = K.KERNEL_FUNCTIONS[kernel]
            rows = [row for row in every if fn in row[0]]
            calls[kernel] = sum(c for _, _, c in rows)
            kernel_ms[kernel] = sum(us for _, us, _ in rows) / 1e3
            check(rows and calls[kernel] == cap["launches"][kernel] > 0,
                  f"path_observe {wire}: the device-op table has "
                  f"{calls[kernel]} {fn} calls, LAUNCHES counted "
                  f"{cap['launches'][kernel]}")
        for kernel, n in cap["launches"].items():
            total[kernel] += n
        tables[wire] = {"device_ms": cap["total_us"] / 1e3,
                        "wall_ms": cap["wall_ms"], "calls": calls,
                        "kernel_ms": kernel_ms, "launches": cap["launches"],
                        "top": [{"name": name[:100], "ms": us / 1e3,
                                 "calls": c} for name, us, c in every[:12]]}
    out["device_op_tables"] = tables
    # phase_b of the traced single run: the scoring of its 32,768 rows,
    # at least the fused score+top-k kernel's device time in the capture
    b1_ms = tables["ragged"]["kernel_ms"]["fused_score_topk"]
    phase_b_ms = sum(e["dur"] for e in events["single"]["main"]
                     if e["name"] == "phase_b") / 1e3
    check(phase_b_ms >= b1_ms, f"path_observe: the traced run's phase_b "
          f"({phase_b_ms} ms) is shorter than B1's {b1_ms} ms")
    out["phase_b_ms"] = {"traced_single": phase_b_ms, "capture_b1": b1_ms}
    emit({"phase": "path_observe", **out,
          "seconds": time.perf_counter() - t_phase, "ok": True})


def path_mesh(T, K, ingest, corpus, gold, big, small, rg, streamed,
              chargram, total, cli):
    """The mesh run paths on MESH_SHARDS virtual shards of the card, each
    held bit for bit against the port's single-device run."""
    from tfidf_tpu_torch.golden import golden_output
    from tfidf_tpu_torch.parallel import MeshPlan, ShardedPipeline
    from tfidf_tpu_torch.parallel import collectives as C

    t_phase = time.perf_counter()
    cuda = torch.device("cuda")
    plan = MeshPlan.create(docs=MESH_SHARDS, devices=[cuda] * MESH_SHARDS)
    n = len(corpus)
    out = {}

    def walled(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    def counted(label, fn, expect):
        K.reset_launches()
        r, wall = walled(fn)
        launches = dict(K.LAUNCHES)
        for kernel in expect:
            check(launches[kernel] > 0,
                  f"path_mesh {label}: {kernel} never launched")
        for kernel, c in launches.items():
            total[kernel] += c
        out[label] = {"wall_s": wall, "launches": launches}
        return r, launches

    # ShardedPipeline, sparse at docs 4: B1 and B3 on every shard
    sparse_cfg = T.PipelineConfig(vocab_mode=T.VocabMode.HASHED,
                                  vocab_size=SPARSE_VOCAB, max_doc_len=DOC_LEN,
                                  doc_chunk=DOC_LEN, topk=TOPK)
    batch = T.pack_corpus(corpus, sparse_cfg)
    single, single_s = walled(
        lambda: T.TfidfPipeline(sparse_cfg).run_packed(batch))
    mesh, launches = counted(
        "sparse_docs4", lambda: ShardedPipeline(plan, sparse_cfg)
        .run_packed(batch), ("fused_score_topk", "pack_words"))
    check(launches["fused_score_topk"] == MESH_SHARDS
          and launches["pack_words"] == MESH_SHARDS,
          f"path_mesh sparse_docs4: launches {launches}")
    check(_same_topk(mesh, single, n), "path_mesh sparse_docs4: differs "
          "from the single-device run")
    out["sparse_docs4"]["single_wall_s"] = single_s

    # ShardedPipeline, dense at {docs 2, vocab 2} and {docs 2, seq 2}:
    # B2 per shard, at id offsets 0 and V / 2 on the vocab mesh
    dense_cfg = T.PipelineConfig(vocab_mode=T.VocabMode.HASHED,
                                 vocab_size=DENSE_VOCAB, max_doc_len=DOC_LEN,
                                 doc_chunk=DOC_LEN, topk=TOPK, engine="dense",
                                 result_wire="pair")
    dbatch = T.pack_corpus(corpus, dense_cfg)
    dsingle, dsingle_s = walled(
        lambda: T.TfidfPipeline(dense_cfg).run_packed(dbatch))
    offsets = []
    tf_df = C.tf_df

    def tf_df_spy(*args, **kwargs):
        offsets.append(kwargs.get("id_offset", 0))
        return tf_df(*args, **kwargs)

    C.tf_df = tf_df_spy
    try:
        for label, shape, want_offsets in (
                ("dense_docs2_vocab2", {"docs": 2, "vocab": 2},
                 [0, DENSE_VOCAB // 2]),
                ("dense_docs2_seq2", {"docs": 2, "seq": 2}, [0])):
            p = MeshPlan.create(**shape, devices=[cuda] * 4)
            offsets.clear()
            r, launches = counted(label, lambda p=p: ShardedPipeline(
                p, dense_cfg).run_packed(dbatch), ("tf_df",))
            check(launches["tf_df"] == 4 and sorted(set(offsets))
                  == want_offsets, f"path_mesh {label}: B2 launches "
                  f"{launches['tf_df']}, id offsets {sorted(set(offsets))}")
            check(_same_topk(r, dsingle, n), f"path_mesh {label}: differs "
                  f"from the single-device run")
            out[label].update(id_offsets=sorted(set(offsets)),
                              single_wall_s=dsingle_s)
    finally:
        C.tf_df = tf_df
    # the golden 64 docs at docs 4
    g, _ = counted("golden_docs4", lambda: T.TfidfPipeline(
        T.PipelineConfig(mesh_shape={"docs": MESH_SHARDS}),
        plan=plan).run(gold).output_bytes(), ("tf_df",))
    check(g == golden_output(gold), "path_mesh golden_docs4: bytes differ "
          "from golden_output")

    # the device chargram at docs 4, both lowerings, on path_chargram's
    # files
    cn = len(chargram)
    singles = chargram_cfgs(T)
    for name, mcfg in chargram_cfgs(
            T, mesh_shape={"docs": MESH_SHARDS}).items():
        want = T.TfidfPipeline(singles[name]).run(chargram)
        r, _ = counted(f"chargram_{name}_docs4", lambda mcfg=mcfg: T.TfidfPipeline(
            mcfg, plan=plan).run(chargram), (
            "fused_score_topk" if name == "sparse" else "pack_words",))
        check(_same_topk(r, want, cn)
              and np.array_equal(r.lengths[:cn], want.lengths),
              f"path_mesh chargram_{name}_docs4: differs from run_bytes")

    # run_overlapped(plan=docs 4) on the 131,072 files: one warm run
    # (kernels built and loaded by the paths before), profiled
    icfg = T.PipelineConfig(vocab_mode=T.VocabMode.HASHED,
                            vocab_size=SPARSE_VOCAB, max_doc_len=DOC_LEN,
                            doc_chunk=DOC_LEN, topk=TOPK)
    held = []
    K.reset_launches()
    events, wall_ms = profiled(lambda: held.append(ingest.run_overlapped(
        big, icfg, chunk_docs=N_DOCS, doc_len=DOC_LEN, plan=plan)))
    launches = dict(K.LAUNCHES)
    for kernel, c in launches.items():
        total[kernel] += c
    r = held[0]
    n_chunks = INGEST_DOCS // N_DOCS
    check(r.path == "resident-mesh" and r.result_wire == "packed"
          and launches["fused_score_topk"] == MESH_SHARDS * n_chunks
          and launches["pack_words"] == MESH_SHARDS * n_chunks,
          f"path_mesh ingest: {_result_fields(r)}, launches {launches}")
    check(_same_result(r, rg), "path_mesh ingest: DF or words differ from "
          "path_ingest_resident's")
    from torch.autograd import DeviceType
    dev_ms = [(e.name, e.time_range.elapsed_us() / 1e3) for e in events
              if e.device_type == DeviceType.CUDA]
    check(bool(dev_ms), "path_mesh ingest: the profiler recorded no device "
          "activity")
    busy = sum(ms for _, ms in dev_ms)
    by_name = {}
    for name, ms in dev_ms:
        row = by_name.setdefault(name[:100], [0, 0.0])
        row[0] += 1
        row[1] += ms
    out["ingest_resident_mesh"] = {
        "docs": INGEST_DOCS, "chunk_docs": N_DOCS, "wall_s": wall_ms / 1e3,
        "docs_per_s": INGEST_DOCS / (wall_ms / 1e3), "phases": r.phases,
        "launches": launches, "fields": _result_fields(r),
        "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
        "top": [{"name": k_, "count": c, "ms": ms} for k_, (c, ms) in
                sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]]}

    # the streaming mesh regime on the 32,768 files: the resident budget
    # below them, 2 of 4 chunks' triples cached, the rest re-read (both
    # budgets are the one card's: virtual shards share it)
    env = {"TFIDF_TPU_RESIDENT_ELEMS": str(N_DOCS * DOC_LEN - 1),
           "TFIDF_TPU_TRIPLE_CACHE_BYTES": str(
               2 * (STREAM_CHUNK * DOC_LEN * 9 + STREAM_CHUNK * 4))}
    with env_vars(**env):
        r, _ = counted("ingest_streaming_mesh", lambda: ingest.run_overlapped(
            small, icfg, chunk_docs=STREAM_CHUNK, doc_len=DOC_LEN, plan=plan,
            spill="reread"), ("fused_score_topk", "pack_words"))
    check(r.path == "streaming-mesh"
          and r.phases["triple_cached_chunks"] == 2,
          f"path_mesh ingest_streaming_mesh: {_result_fields(r)}")
    check(_same_result(r, streamed), "path_mesh ingest_streaming_mesh: "
          "differs from the single-device streaming run")
    out["ingest_streaming_mesh"].update(env=env, phases=r.phases)

    # cli run --mesh 1,1,1 --doc-len 256, no --device: the card
    check(cli["mesh_111"]["bytes"] == cli["single"]["bytes"],
          "path_mesh cli: --mesh 1,1,1 bytes differ from the single-device "
          "CLI's")
    out["cli_mesh_111"] = {"seconds": cli["mesh_111"]["seconds"],
                           "bytes_equal": True,
                           "single_seconds": cli["single"]["seconds"]}
    emit({"phase": "path_mesh", "shards": MESH_SHARDS,
          "devices": [str(d) for d in plan.devices], "docs": n,
          "runs": out, "seconds": time.perf_counter() - t_phase, "ok": True})


def path_multiprocess(T, K, _build, big, rg, total, cli):
    """run_sharded_ingest: MP_WORKERS processes sharing the one card, each
    ingesting a contiguous shard of the 131,072 files; the merged result
    bit-equal to path_ingest_resident's."""
    from tfidf_tpu_torch.parallel.multihost import run_sharded_ingest

    t_phase = time.perf_counter()
    _build.build()  # built once here; the workers find the libraries
    _build.build_host()
    icfg = T.PipelineConfig(vocab_mode=T.VocabMode.HASHED,
                            vocab_size=SPARSE_VOCAB, max_doc_len=DOC_LEN,
                            doc_chunk=DOC_LEN, topk=TOPK)
    out = {}
    for n in MP_WORKERS:
        t0 = time.perf_counter()
        r, info = run_sharded_ingest(big, icfg, n_workers=n,
                                     chunk_docs=N_DOCS, doc_len=DOC_LEN,
                                     repeat=MP_REPEAT, timeout_s=400)
        call_s = time.perf_counter() - t0
        check(r.path == f"sharded-{n}proc:resident",
              f"path_multiprocess {n}: path {r.path}")
        check(_same_result(r, rg), f"path_multiprocess {n}: the merged "
              f"result differs from path_ingest_resident's")
        for w, launches in enumerate(info.worker_launches):
            for kernel in ("fused_score_topk", "pack_words",
                           "ragged_rebuild"):
                check(launches[kernel] > 0, f"path_multiprocess {n}: worker "
                      f"{w} never launched {kernel}")
            for kernel, c in launches.items():
                total[kernel] += c
        out[f"workers_{n}"] = {
            "call_s": call_s, "wall_s": info.wall_s,
            "docs_per_s": INGEST_DOCS / info.wall_s,
            "worker_walls_s": info.worker_walls_s,
            "upload_s": info.upload_s,
            "worker_upload_s": info.worker_upload_s,
            "link_utilization": info.link_utilization,
            "worker_device_bytes": info.worker_device_bytes,
            "card_bytes_in_use": info.card_bytes_in_use,
            "worker_launches": info.worker_launches,
            "worker_phases": info.worker_phases, "shards": info.shards}
    workers = cli["workers_4"]
    check(workers["bytes"] == cli["single"]["bytes"], "path_multiprocess "
          "cli: --ingest-workers 4 bytes differ from the single-process CLI's")
    lines = [ln for ln in workers["stderr"].splitlines()
             if ln.startswith("sharded ingest: 4 workers")]
    check(len(lines) == 1, "path_multiprocess cli: no sharded ingest line")
    out["cli_workers_4"] = {"seconds": workers["seconds"],
                            "bytes_equal": True, "stderr_line": lines[0]}
    emit({"phase": "path_multiprocess", "docs": INGEST_DOCS,
          "repeat": MP_REPEAT, "runs": out,
          "seconds": time.perf_counter() - t_phase, "ok": True})


# --- path_mesh_serve: the search side of the mesh --------------------------

MESH_SERVE_SHARDS = 4     # path_mesh_serve: virtual shards of the one card
MESH_SERVE_SETTINGS = {"tfidf": {}, "bm25": {"scorer": "bm25"},
                       "tfidf+id_range": {"filter": {"id_range": [0, 65536]}}}
MESH_SERVE_CALLS = 2      # path_mesh_serve: add_docs calls (then a delete)
MESH_SERVE_REPS = 3       # path_mesh_serve: timed searches a median

# Run as ``python -c GLOO_RANK REPO ADDR RANK INPUT EXPECT``: one of two
# processes of a gloo mesh on the one card (MeshPlan.create(docs=2): the
# card once per rank, world 2), the mesh ingest of INPUT held bit for bit
# against the single-device run saved in EXPECT; prints one JSON line.
GLOO_RANK = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import tfidf_tpu_torch as T
from tfidf_tpu_torch.ingest import run_overlapped
from tfidf_tpu_torch.ops import kernels as K
from tfidf_tpu_torch.parallel import MeshPlan
from tfidf_tpu_torch.parallel.multihost import initialize

addr, rank, input_dir, expect = sys.argv[2], int(sys.argv[3]), sys.argv[4], \
    sys.argv[5]
topo = initialize(addr, 2, rank)
plan = MeshPlan.create(docs=2)
assert (plan.n_docs_shards, plan.n_local_docs, plan.first_docs_shard,
        plan.world, str(plan.devices[0])) == (2, 1, rank, 2, "cuda:0"), plan
cfg = T.PipelineConfig(vocab_mode=T.VocabMode.HASHED, vocab_size=%d,
                       max_doc_len=%d, doc_chunk=%d, topk=%d)
K.reset_launches()
t0 = time.perf_counter()
r = run_overlapped(input_dir, cfg, chunk_docs=%d, doc_len=%d, plan=plan)
wall = time.perf_counter() - t0
exp = np.load(expect)
host = lambda x: x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
same = {f: bool(host(getattr(r, f)).dtype == exp[f].dtype
                and np.array_equal(host(getattr(r, f)).view(np.uint8),
                                   exp[f].view(np.uint8)))
        for f in ("df", "topk_ids", "topk_vals", "lengths")}
print(json.dumps({"rank": rank, "path": r.path, "same": same,
                  "launches": dict(K.LAUNCHES), "wall_s": wall}))
""" % (SPARSE_VOCAB, DOC_LEN, DOC_LEN, TOPK, STREAM_CHUNK, DOC_LEN)


def gloo_ranks(T, ingest, small, total) -> dict:
    """Two gloo processes on the one card, each holding one shard of a
    2-shard docs mesh, ingest the 32,768 files (resident mesh regime);
    each rank's DF, words, scores and lengths equal the single-device
    run's bit for bit. The parent has built the kernels, so the ranks
    load them."""
    import socket

    icfg = T.PipelineConfig(vocab_mode=T.VocabMode.HASHED,
                            vocab_size=SPARSE_VOCAB, max_doc_len=DOC_LEN,
                            doc_chunk=DOC_LEN, topk=TOPK)
    ref = ingest.run_overlapped(small, icfg, chunk_docs=STREAM_CHUNK,
                                doc_len=DOC_LEN)

    def host(x):
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)

    with tempfile.TemporaryDirectory() as tmp:
        expect = os.path.join(tmp, "expect.npz")
        np.savez(expect, **{f: host(getattr(ref, f)) for f in
                            ("df", "topk_ids", "topk_vals", "lengths")})
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            addr = f"localhost:{sock.getsockname()[1]}"
        env = {key: v for key, v in os.environ.items()
               if key not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                              "RANK")}
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", GLOO_RANK, REPO, addr, str(rank), small,
             expect], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, cwd=REPO) for rank in range(2)]
        try:
            outs = [p.communicate(timeout=400) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
    ranks = []
    for p, (out, err) in zip(procs, outs):
        check(p.returncode == 0, f"path_mesh_serve gloo rank exit "
              f"{p.returncode}: {err[-2000:]}")
        rec = json.loads(out.strip().splitlines()[-1])
        check(rec["path"] == "resident-mesh" and all(rec["same"].values()),
              f"path_mesh_serve gloo rank {rec['rank']}: {rec}")
        for kernel in ("fused_score_topk", "pack_words"):
            check(rec["launches"][kernel] > 0, f"path_mesh_serve gloo rank "
                  f"{rec['rank']}: {kernel} never launched")
        for kernel, c in rec["launches"].items():
            total[kernel] += c
        ranks.append(rec)
    return {"world": 2, "backend": "gloo", "docs": N_DOCS,
            "single_path": ref.path, "wall_s": wall, "ranks": ranks,
            "bit_equal_to_single_device": True}


def path_mesh_serve(T, K, _build, ingest, r, cfg, queries, big_docs, seg_idx,
                    small, small_corpus, total, cli, stream_cli, load):
    """The search side of the mesh on MESH_SERVE_SHARDS virtual shards of
    the card: MeshShardedRetriever, TfidfRetriever(plan=), a sharded
    segmented view, a served load, the server's install paths under
    mesh_shards, the mesh stream, the CLI's --mesh-docs/--mesh-shards and
    two gloo ranks; each held bit for bit against one device's run."""
    from tfidf_tpu_torch.config import ServeConfig
    from tfidf_tpu_torch.parallel import (MeshPlan, MeshShardedRetriever,
                                          make_serving_plan, shard_index)
    from tfidf_tpu_torch.parallel.multihost import _card_bytes_in_use
    from tfidf_tpu_torch.serve import CanaryProber, TfidfServer
    from tfidf_tpu_torch.streaming import StreamingTfidf

    t_phase = time.perf_counter()
    cuda = torch.device("cuda")
    n = r._num_docs
    out = {}
    try:
        make_serving_plan(MESH_SERVE_SHARDS)
        refused = False
    except ValueError:
        refused = True
    check(refused == (torch.cuda.device_count() < MESH_SERVE_SHARDS),
          "path_mesh_serve: make_serving_plan past the cards did not raise")
    plan = make_serving_plan(MESH_SERVE_SHARDS,
                             devices=[cuda] * MESH_SERVE_SHARDS)

    def counted(fn):
        K.reset_launches()
        res = fn()
        launches = dict(K.LAUNCHES)
        for kernel, c in launches.items():
            total[kernel] += c
        return res, launches

    # 1. MeshShardedRetriever over the retrieval index, every setting
    torch.cuda.synchronize()
    before = _card_bytes_in_use(cuda)  # CUDA contexts included
    t0 = time.perf_counter()
    sharded = shard_index(r, plan)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    check(sharded.n_shards == MESH_SERVE_SHARDS
          and sharded.parity_oracle() is r and shard_index(sharded, plan)
          is sharded, "path_mesh_serve: shard_index contract")
    n_tiles = MESH_SERVE_SHARDS * -(-(n // MESH_SERVE_SHARDS) // RETR_TILE)
    searches = {}
    for name, kw in MESH_SERVE_SETTINGS.items():
        for q in (1, 64, RETR_QUERIES):
            qs = queries[:q]
            got, launches = counted(lambda: sharded.search(qs, k=RETR_K,
                                                           **kw))
            check(launches["tile_scores"] == n_tiles,
                  f"path_mesh_serve {name} Q={q}: B6 launched "
                  f"{launches['tile_scores']} times, not {n_tiles}")
            check(_same_search(got, r.search(qs, k=RETR_K, **kw)),
                  f"path_mesh_serve {name} Q={q}: sharded differs from "
                  f"the single-device search")
            # medians of MESH_SERVE_REPS, both warm (the calls above)
            single_ms = host_ms(lambda: r.search(qs, k=RETR_K, **kw),
                                reps=MESH_SERVE_REPS, warmup=0)
            sharded_ms = host_ms(lambda: sharded.search(qs, k=RETR_K, **kw),
                                 reps=MESH_SERVE_REPS, warmup=0)
            searches[f"{name}/Q{q}"] = {
                "single_ms": single_ms, "sharded_ms": sharded_ms,
                "ratio": sharded_ms / single_ms,
                "b6_launches": launches["tile_scores"]}
    torch.cuda.synchronize()
    out["sharded_retriever"] = {
        "shards": MESH_SERVE_SHARDS, "docs": n, "shard_s": shard_s,
        "b6_launches_per_search": n_tiles, "searches": searches,
        "shard_stats": sharded.shard_stats(),
        "card_bytes_in_use_before": before,
        "card_bytes_in_use_after": _card_bytes_in_use(cuda)}

    # 2. TfidfRetriever(plan=): the batch packing of the same documents
    # (their longest is DOC_LEN tokens, so its rows are the retrieval
    # index's), against the single-device index
    corpus = T.Corpus(names=[f"doc{i}" for i in range(1, n + 1)],
                      docs=big_docs)
    t0 = time.perf_counter()
    plan_r, launches = counted(
        lambda: T.TfidfRetriever(cfg, plan=plan).index(corpus))
    torch.cuda.synchronize()
    plan_index_s = time.perf_counter() - t0
    rows = int(plan_r._blocks[0][0].shape[0])
    plan_searches = {}
    for q in (1, 64, RETR_QUERIES):
        qs = queries[:q]
        got, launches = counted(lambda: plan_r.search(qs, k=RETR_K))
        check(launches["tile_scores"]
              == MESH_SERVE_SHARDS * -(-rows // RETR_TILE),
              f"path_mesh_serve plan Q={q}: B6 {launches['tile_scores']}")
        check(_same_search(got, r.search(qs, k=RETR_K)),
              f"path_mesh_serve plan Q={q}: TfidfRetriever(plan=) differs "
              f"from the single-device index")
        plan_searches[f"Q{q}"] = {"b6_launches": launches["tile_scores"]}
    plan_searches["Q64"].update(
        single_ms=searches["tfidf/Q64"]["single_ms"],
        plan_ms=host_ms(lambda: plan_r.search(queries[:64], k=RETR_K),
                        reps=MESH_SERVE_REPS, warmup=0))
    out["plan_retriever"] = {"plan_index_s": plan_index_s,
                             "rows_per_shard": rows,
                             "searches": plan_searches}
    del plan_r

    # 3. a sharded segmented view (the compacted index of path_segmented)
    view = seg_idx.view()
    sview = shard_index(view, plan)
    view_searches = {}
    for name, kw in MESH_SERVE_SETTINGS.items():
        for q in (1, 64, RETR_QUERIES):
            qs = queries[:q]
            got, launches = counted(lambda: sview.search(qs, k=RETR_K, **kw))
            check(launches["tile_scores"] > 0, f"path_mesh_serve view "
                  f"{name} Q={q}: B6 never launched")
            check(_same_search(got, view.search(qs, k=RETR_K, **kw)),
                  f"path_mesh_serve view {name} Q={q}: differs from "
                  f"view.search")
            view_searches[f"{name}/Q{q}"] = launches["tile_scores"]
    out["sharded_view"] = {
        "segments": view.num_segments, "live_docs": view._num_docs,
        "rows": sview._rows, "b6_launches": view_searches,
        "view_q64_ms": host_ms(lambda: view.search(queries[:64], k=RETR_K),
                               reps=MESH_SERVE_REPS, warmup=0),
        "sharded_q64_ms": host_ms(
            lambda: sview.search(queries[:64], k=RETR_K),
            reps=MESH_SERVE_REPS, warmup=0)}
    del sview

    # 4. path_serve's depth-1 load, once on the index and once on its 4
    # shards
    requests, direct = load
    n_requests = sum(len(x) for x in requests)
    n_queries = sum(len(qs) for reqs in requests for qs, _ in reqs)
    loads = {}
    for label, index in (("single", r), ("sharded", sharded)):
        srv = TfidfServer(index, ServeConfig(pipeline_depth=1))
        try:
            b = 1
            while b <= srv.config.max_batch:
                index.search([""] * b, k=RETR_K)
                b *= 2
            srv.mark_warm()
            torch.cuda.synchronize()
            (answers, lat_ms, wall), launches = counted(
                lambda: serve_load(srv, requests))
            check(launches["tile_scores"] > 0,
                  f"path_mesh_serve load {label}: B6 never launched")
            loads[label] = serve_figures(srv, lat_ms, wall, n_requests,
                                         n_queries, launches)
            check(srv.compile_watch.recompile_count == 0,
                  f"path_mesh_serve load {label}: builds after warm-up")
        finally:
            srv.close()
        check_serve_threads_gone(f"the {label} mesh-serve load")
        for t, reqs in enumerate(requests):
            for i in range(len(reqs)):
                check(_same_search(answers[t][i], direct[t][i]),
                      f"path_mesh_serve load {label}: request {t}/{i} "
                      f"differs from a direct search")
    out["served_load"] = loads

    # 5. the install paths under ServeConfig(mesh_shards=1): one card
    new = T.TfidfRetriever(cfg).index_dir(small, doc_len=DOC_LEN,
                                          chunk_docs=RETR_CHUNK)
    installs = {}
    srv = TfidfServer(r, ServeConfig(mesh_shards=1))
    try:
        _, installed = srv.current_index()
        check(isinstance(installed, MeshShardedRetriever)
              and installed.n_shards == 1 and installed.parity_oracle() is r,
              "path_mesh_serve: the constructor did not shard the index")
        canary = CanaryProber(srv, queries[:8], k=RETR_K, period_s=30)
        try:
            check(canary.probe() == 1.0, "path_mesh_serve: canary < 1.0")
            for label, index in (("to_32768", new), ("back_to_131072", r)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                epoch = srv.swap_index(index)
                torch.cuda.synchronize()
                installs[f"swap_{label}_s"] = time.perf_counter() - t0
                _, installed = srv.current_index()
                check(isinstance(installed, MeshShardedRetriever)
                      and installed.parity_oracle() is index,
                      f"path_mesh_serve: swap {label} installed "
                      f"{type(installed).__name__}")
                check(_same_search(srv.search(queries[:64], k=RETR_K,
                                              timeout=300),
                                   index.search(queries[:64], k=RETR_K)),
                      f"path_mesh_serve: after the swap {label}, answers "
                      f"differ from the index's search")
                check(canary.probe() == 1.0,
                      f"path_mesh_serve: canary < 1.0 after swap {label}")
                installs[f"swap_{label}_epoch"] = epoch
        finally:
            canary.close()
    finally:
        srv.close()
    # snapshot -> restore re-shards (the 32,768-doc index)
    with tempfile.TemporaryDirectory() as snap:
        srv = TfidfServer(new, ServeConfig(mesh_shards=1, snapshot_dir=snap))
        try:
            t0 = time.perf_counter()
            srv.snapshot()
            installs["snapshot_s"] = time.perf_counter() - t0
            want = srv.search(queries[:64], k=RETR_K, timeout=300)
        finally:
            srv.close()
        t0 = time.perf_counter()
        restored, _ = T.TfidfRetriever.restore(snap, cfg)
        srv = TfidfServer(restored, ServeConfig(mesh_shards=1))
        try:
            installs["restore_and_shard_s"] = time.perf_counter() - t0
            _, installed = srv.current_index()
            check(isinstance(installed, MeshShardedRetriever)
                  and installed.parity_oracle() is restored,
                  "path_mesh_serve: a restored index was not sharded")
            check(_same_search(srv.search(queries[:64], k=RETR_K,
                                          timeout=300), want),
                  "path_mesh_serve: the restored server's answers differ")
        finally:
            srv.close()
    # add_docs / delete_docs install sharded views
    srv = TfidfServer(seg_idx.view(), ServeConfig(mesh_shards=1))
    srv.attach_segments(seg_idx)
    rng = np.random.default_rng(SEED + 9)
    mutations = []
    try:
        calls = [("add", [f"meshserved{j}" for j in range(
            c * SEG_CALL, (c + 1) * SEG_CALL)],
            zipf_docs(rng, SEG_CALL)) for c in range(MESH_SERVE_CALLS)]
        calls.append(("delete", [f"doc{j}" for j in
                                 rng.permutation(n)[:SEG_CALL] + 1], None))
        for kind, names, docs in calls:
            t0 = time.perf_counter()
            got = (srv.add_docs(names, docs) if kind == "add"
                   else srv.delete_docs(names))
            secs = time.perf_counter() - t0
            _, installed = srv.current_index()
            check(isinstance(installed, MeshShardedRetriever)
                  and got["epoch"] == srv.epoch,
                  f"path_mesh_serve: {kind} installed "
                  f"{type(installed).__name__}")
            oracle = installed.parity_oracle()
            for kw in ({}, {"scorer": "bm25"}):
                check(_same_search(
                    srv.search(queries[:16], k=RETR_K, timeout=300, **kw),
                    oracle.search(queries[:16], k=RETR_K, **kw)),
                    f"path_mesh_serve: after {kind}, answers differ from "
                    f"the view's search ({kw})")
            mutations.append({"kind": kind, "docs": len(names),
                              "install_s": secs, "epoch": got["epoch"]})
    finally:
        srv.close()
    check_serve_threads_gone("the mesh_shards servers")
    installs["mutations"] = mutations
    out["installs_mesh_shards_1"] = installs
    del restored

    # 6. the mesh stream over the 32,768 docs: sparse at docs 4 (B1, B3 a
    # shard), dense at {docs 2, vocab 2} (B2 at each vocab offset)
    streams = {}
    batches = [T.Corpus(names=small_corpus.names[s:s + STREAM_CHUNK],
                        docs=small_corpus.docs[s:s + STREAM_CHUNK])
               for s in range(0, len(small_corpus), STREAM_CHUNK)]
    for label, vocab, mesh, expect in (
            ("sparse_docs4", SPARSE_VOCAB, {"docs": 4},
             ("fused_score_topk", "pack_words")),
            ("dense_docs2_vocab2", DENSE_VOCAB, {"docs": 2, "vocab": 2},
             ("tf_df", "pack_words"))):
        scfg = _stream_cfg(T, vocab, topk=TOPK,
                           engine="dense" if "dense" in label else None)
        mplan = MeshPlan.create(**mesh, devices=[cuda] * 4)
        single_s = StreamingTfidf(scfg)
        mesh_s = StreamingTfidf(scfg, mplan)
        packed = [single_s.pack_ragged(b, fixed_len=DOC_LEN)
                  for b in batches]
        t0 = time.perf_counter()
        for p in packed:
            single_s.update(p)
        want = [single_s.score(p) for p in packed]
        torch.cuda.synchronize()
        single_wall = time.perf_counter() - t0

        def run_mesh():
            for p in packed:
                mesh_s.update(p)
            return [mesh_s.score(p) for p in packed]

        t0 = time.perf_counter()
        got, launches = counted(run_mesh)
        torch.cuda.synchronize()
        mesh_wall = time.perf_counter() - t0
        for kernel in expect:
            check(launches[kernel] > 0, f"path_mesh_serve stream {label}: "
                  f"{kernel} never launched")
        check(launches["ragged_rebuild"] == 0, f"path_mesh_serve stream "
              f"{label}: B4 ran on the mesh wire")
        check(np.array_equal(mesh_s.df(), single_s.df()),
              f"path_mesh_serve stream {label}: DF differs")
        for (gv, gi), (wv, wi) in zip(got, want):
            check(np.array_equal(gi, wi) and gv.dtype == wv.dtype
                  and np.array_equal(gv.view(np.uint8), wv.view(np.uint8)),
                  f"path_mesh_serve stream {label}: words differ")
        streams[label] = {"vocab": vocab, "mesh": mesh,
                          "single_wall_s": single_wall,
                          "mesh_wall_s": mesh_wall, "launches": launches}
    out["stream"] = streams

    # 7. the CLI (cli_runs): --mesh-docs 1 / --mesh-shards 1 = unsharded
    # (the plain query in process, the plain stream path_stream's)
    from tfidf_tpu_torch import cli as tcli
    t0 = time.perf_counter()
    rc, plain_query = _quiet(tcli.main, query_args(small, queries))
    query_s = time.perf_counter() - t0
    check(rc == 0 and "query: " in plain_query, "path_mesh_serve cli: the "
          "plain query failed")
    for label, want in (("query_mesh_1", plain_query.encode()),
                        ("stream_mesh_1", stream_cli)):
        check(cli[label]["bytes"] == want and len(want) > 0,
              f"path_mesh_serve cli: {label} differs from the plain run")
    a, b = serve_lines(cli["serve_mesh_1"]), serve_lines(cli["serve_single"])
    for i in range(SERVE_CLI_QUERIES):
        check(a.get(i, {}).get("results") == b.get(i, {}).get("results")
              and a[i]["results"], f"path_mesh_serve cli: serve "
              f"--mesh-shards 1 line {i} differs")
    check("mesh=1" in cli["serve_mesh_1"]["stderr"]
          and a["op_devmon"]["devmon"]["shards"]["n_shards"] == 1,
          "path_mesh_serve cli: serve --mesh-shards 1 did not shard")
    out["cli"] = {label: {"seconds": cli[label]["seconds"],
                          "bytes": len(cli[label]["bytes"])}
                  for label in ("query_mesh_1", "stream_mesh_1",
                                "serve_single", "serve_mesh_1")}
    out["cli"].update(plain_query_in_process_s=query_s, equal=True)

    # 8. two gloo ranks on the one card
    _build.build()  # built already; the ranks load the libraries
    _build.build_host()
    out["gloo_ranks"] = gloo_ranks(T, ingest, small, total)
    del sharded
    emit({"phase": "path_mesh_serve", "shards": MESH_SERVE_SHARDS,
          "devices": [str(d) for d in plan.devices], "k": RETR_K, **out,
          "bit_equal": True, "seconds": time.perf_counter() - t_phase,
          "ok": True})
    return new


# --- path_serve: TfidfServer over the retrieval index, cli serve ------

SERVE_THREADS = 8         # path_serve: client threads
SERVE_REQUESTS = 32       # path_serve: requests per client thread
SERVE_MIX = ({}, {"scorer": "bm25"}, {"filter": {"id_range": [0, 65536]}})
SERVE_SEG_CALLS = 4       # path_serve: add_docs calls of SEG_CALL docs
SERVE_CLI_QUERIES = 16    # path_serve: query lines sent to cli serve


def serve_requests(rng, queries):
    """SERVE_THREADS x SERVE_REQUESTS requests: 1-4 of the Zipf queries
    each, the mix of SERVE_MIX in turn."""
    out = []
    for t in range(SERVE_THREADS):
        reqs = []
        for i in range(SERVE_REQUESTS):
            n = int(rng.integers(1, 5))
            qs = [queries[j] for j in rng.integers(0, len(queries), n)]
            reqs.append((qs, SERVE_MIX[(t + i) % len(SERVE_MIX)]))
        out.append(reqs)
    return out


def served_load_and_direct(r, queries):
    """path_serve's load (serve_requests at seed SEED + 7) and each
    request's direct search of ``r``: the answers path_mesh_serve,
    path_replicas and path_serve hold their served loads to."""
    requests = serve_requests(np.random.default_rng(SEED + 7), queries)
    direct = [[r.search(qs, k=RETR_K, **kw) for qs, kw in reqs]
              for reqs in requests]
    return requests, direct


def serve_load(srv, requests):
    """Every client thread submits its requests one after another and
    waits for each answer. Returns the answers, each request's host
    latency in ms and the wall seconds of the load."""
    answers = [[None] * len(reqs) for reqs in requests]
    lat_ms = []
    errors = []
    lock = threading.Lock()

    def client(t):
        try:
            for i, (qs, kw) in enumerate(requests[t]):
                t0 = time.perf_counter()
                answers[t][i] = srv.submit(qs, RETR_K, **kw).result(
                    timeout=300)
                with lock:
                    lat_ms.append((time.perf_counter() - t0) * 1e3)
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(len(requests))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not errors and not any(th.is_alive() for th in threads),
          f"path_serve: a client failed: {errors[:3]}")
    return answers, lat_ms, wall


def serve_figures(srv, lat_ms, wall, n_requests, n_queries, launches):
    snap = srv.metrics_snapshot()
    return {"requests": n_requests, "queries": n_queries, "wall_s": wall,
            "latency_ms_p50": float(np.percentile(lat_ms, 50)),
            "latency_ms_p99": float(np.percentile(lat_ms, 99)),
            "requests_per_s": n_requests / wall,
            "queries_per_s": n_queries / wall,
            "batches": snap["batch"]["count"],
            "mean_occupancy": snap["batch"]["mean_occupancy"],
            "cache_hits": snap["cache"]["hits"],
            "cache_misses": snap["cache"]["misses"],
            "server_latency_s": {key: v for key, v in
                                 snap["latency_s"].items()
                                 if key != "exemplars"},
            "b6_launches": launches["tile_scores"]}


def check_serve_threads_gone(what: str) -> None:
    """No thread of a closed server (batcher, drain, health watchdog,
    device monitor, canary, compactor: all named ``tfidf-*``) lives on."""
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("tfidf-")]
    check(not alive, f"path_serve: {what}: threads alive after close(): "
          f"{alive}")


def serve_breakdown(r, requests) -> dict:
    """Where a served load's time goes: the load once more at depth 1
    on a fresh server, under the profiler with every thread's host ops
    recorded. The batcher's thread spends the wall waiting for a batch
    to fall due (``_take_batch``: idle, or inside ``max_wait_ms``), in
    ``search`` (the query fill, torch calls and runtime calls, and
    their Python), or between the two (forming, delivering). Its first
    wait began with the server, before the profiler, and is left out
    (the few ms until the first batch falls due). The profiler's own
    cost per recorded op is inside these figures."""
    from tfidf_tpu_torch.config import ServeConfig
    from tfidf_tpu_torch.models import retrieval as R
    from tfidf_tpu_torch.serve import TfidfServer
    from tfidf_tpu_torch.serve.batcher import MicroBatcher

    with timed_calls(MicroBatcher, "_take_batch") as waits:
        srv = TfidfServer(r, ServeConfig(pipeline_depth=1))
        try:
            with timed_calls(R, "pack_queries") as fills, \
                    timed_calls(r, "search") as searches:
                prof = profile_summary(lambda: serve_load(srv, requests),
                                       top_n=6, warm_up=False,
                                       all_threads=True)
                calls = waits[1:]  # the first began before the window
            batches = srv.metrics_snapshot()["batch"]["count"]
        finally:
            srv.close()
    check_serve_threads_gone("the profiled server")
    # A probe after the load: how many of one small call's 3 device
    # records the profiler keeps. A reading, not a check: after a
    # session of this size every later session of the process loses a
    # few records (tools/serve_profile_probe.py shows it in a fresh
    # process), all of a call this small, so path_serve runs last.
    from torch.autograd import DeviceType
    probe = [e for e in profiled(
        lambda: torch.ones(1 << 20, device="cuda").sum())[0]
        if e.device_type == DeviceType.CUDA]
    host = prof["dispatch_thread"]
    calls_ms = host["top_level_ops_ms"] + host["runtime_outside_ops_ms"]
    wall = prof["wall_ms"]
    parts = {"batch_wait_ms": sum(calls),
             "search_ms": sum(searches),
             "fill_ms": sum(fills),
             "torch_and_runtime_calls_ms": calls_ms - host["sync_ms"],
             "device_wait_ms": host["sync_ms"]}
    parts["python_in_search_ms"] = (parts["search_ms"] - parts["fill_ms"]
                                    - calls_ms)
    parts["outside_wait_and_search_ms"] = (wall - parts["batch_wait_ms"]
                                           - parts["search_ms"])
    return {"wall_ms": wall, "batches": batches, "searches": len(searches),
            "batch_waits": len(calls), **parts,
            "shares": {key[:-3]: ms / wall for key, ms in parts.items()},
            "per_batch_ms": {key[:-3]: ms / max(batches, 1)
                             for key, ms in parts.items()},
            "device_busy_ms": prof["device_busy_ms"],
            "idle_share": prof["idle_share"], "top": prof["top"],
            "dispatch_thread": host,
            "probe_after_load_device_events": len(probe)}


def serve_lines(run) -> dict:
    """A ``cli serve`` run's response lines, by their "id"."""
    by_id = {}
    for line in run["bytes"].decode().splitlines():
        if line.strip():
            resp = json.loads(line)
            by_id[resp.get("id")] = resp
    return by_id


def path_serve(T, K, r, cfg, queries, small_dir, small_corpus, total, cli,
               load):
    """TfidfServer over the retrieval index under concurrent load at
    pipeline depth 1 and 2 (every answer equal to a direct search),
    the cache, admission and a swap to the 32,768-doc directory (B4), a
    segmented server under add_docs/delete_docs equal to a rebuild, the
    device monitor on the card, and cli serve in a subprocess."""
    from tfidf_tpu_torch.config import ServeConfig
    from tfidf_tpu_torch.index import SegmentedIndex
    from tfidf_tpu_torch.obs import devmon
    from tfidf_tpu_torch.parity import compare_search
    from tfidf_tpu_torch.serve import Overloaded, TfidfServer

    t_phase = time.perf_counter()
    n = r._num_docs
    requests, direct = load
    n_requests = sum(len(x) for x in requests)
    n_queries = sum(len(qs) for reqs in requests for qs, _ in reqs)
    out = {}
    answers_by_depth = {}
    for depth in (1, 2):
        srv = TfidfServer(r, ServeConfig(pipeline_depth=depth))
        try:
            if depth == 1:
                # the CLI's warm-up: every query bucket, then mark_warm
                b = 1
                while b <= srv.config.max_batch:
                    r.search([""] * b, k=RETR_K)
                    b *= 2
                srv.mark_warm()
            K.reset_launches()
            torch.cuda.synchronize()
            answers, lat_ms, wall = serve_load(srv, requests)
            launches = dict(K.LAUNCHES)
            for kernel, c in launches.items():
                total[kernel] += c
            check(launches["tile_scores"] > 0,
                  f"path_serve depth {depth}: B6 never launched")
            out[f"depth{depth}"] = serve_figures(
                srv, lat_ms, wall, n_requests, n_queries, launches)
            answers_by_depth[depth] = answers
            if depth == 1:
                watch = srv.compile_watch
                recompiles = watch.recompile_count
                out["builds_seen_by_watch"] = watch.compiles
                # step 3: the cache, then a device-memory read
                qs, kw = requests[0][0]
                hits0 = srv.metrics_snapshot()["cache"]["hits"]
                again = srv.submit(qs, RETR_K, **kw).result(timeout=300)
                check(srv.metrics_snapshot()["cache"]["hits"]
                      == hits0 + len(qs), "path_serve: a repeat missed "
                      "the cache")
                check(_same_search(again, answers[0][0]),
                      "path_serve: a cache hit differs from the first answer")
                mon = devmon.DeviceMonitor(registry=srv.metrics.registry,
                                           device=r.device)
                srv.attach_device_monitor(mon)
                dev = mon.sample()
                census = mon.census()
                mine = [r._ids, r._weights, r._head, r._idf]
                want_bytes = sum(t.untyped_storage().nbytes() for t in mine)
                check(dev["devices"][0].get("bytes_in_use", 0) > 0,
                      f"path_serve: devmon read no bytes in use: {dev}")
                check(census["owners"]["resident_index"]["bytes"]
                      == want_bytes, f"path_serve: census "
                      f"{census['owners']} != {want_bytes} index bytes")
                check(recompiles == 0 and watch.recompile_count == 0,
                      f"path_serve: {watch.recompile_count} builds after "
                      f"warm-up")
                out["devmon"] = {"sample": dev, "census": census,
                                 "index_bytes": want_bytes,
                                 "index_tensor_bytes": sum(
                                     t.nbytes for t in mine),
                                 "recompiles_after_warm": recompiles}
        finally:
            srv.close()
        check_serve_threads_gone(f"depth {depth}")
    out["breakdown_depth1"] = serve_breakdown(r, requests)
    # every served answer equals a direct search, at both depths
    for t, reqs in enumerate(requests):
        for i in range(len(reqs)):
            want = direct[t][i]
            for depth in (1, 2):
                check(_same_search(answers_by_depth[depth][t][i], want),
                      f"path_serve depth {depth}: request {t}/{i} differs "
                      f"from a direct search")

    # step 3: admission past queue_depth, then a swap (B4 at index_dir)
    tight = TfidfServer(r, ServeConfig(queue_depth=4, max_wait_ms=60_000,
                                       max_batch=1024, cache_entries=0))
    try:
        held = [tight.submit([q], RETR_K) for q in queries[:4]]
        try:
            tight.submit([queries[4]], RETR_K)
            shed = False
        except Overloaded:
            shed = True
        check(shed, "path_serve: a submit past queue_depth was admitted")
    finally:
        tight.close(drain=True)
    check_serve_threads_gone("the admission server")
    for q, f in zip(queries[:4], held):
        check(_same_search(f.result(timeout=300), r.search([q], k=RETR_K)),
              "path_serve: a held request differs after the drain")
    srv = TfidfServer(r, ServeConfig())
    try:
        before = srv.search(queries[:8], k=RETR_K, timeout=300)
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new = T.TfidfRetriever(cfg).index_dir(small_dir, doc_len=DOC_LEN,
                                              chunk_docs=RETR_CHUNK)
        epoch = srv.swap_index(new)
        after = srv.search(queries[:64], k=RETR_K, timeout=300)
        swap_s = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        for kernel, c in launches.items():
            total[kernel] += c
        n_chunks = -(-len(small_corpus) // RETR_CHUNK)
        check(launches["ragged_rebuild"] == n_chunks,
              f"path_serve: the swap's index_dir launched B4 "
              f"{launches['ragged_rebuild']} times, not {n_chunks}")
        check(epoch == 1 and srv.epoch == 1, "path_serve: swap epoch")
        check(_same_search(after, new.search(queries[:64], k=RETR_K)),
              "path_serve: after the swap, answers differ from the new "
              "index's search")
        check(_same_search(before, r.search(queries[:8], k=RETR_K)),
              "path_serve: before the swap, answers differ")
        out["swap"] = {"docs": new._num_docs, "index_and_swap_s": swap_s,
                       "launches": launches, "epoch": epoch}
    finally:
        srv.close()
    check_serve_threads_gone("the swapped server")

    # step 4: a segmented server under add_docs / delete_docs. Launches
    # are counted around the server's own calls only: the rebuild and
    # its searches, which launch B6 too, run outside the counted windows.
    t0 = time.perf_counter()
    idx = SegmentedIndex.from_corpus(small_corpus, cfg,
                                     delta_docs=SEG_DELTA,
                                     compact_at=SEG_COMPACT_AT)
    seg_build_s = time.perf_counter() - t0
    seg = TfidfServer(idx.view(), ServeConfig())
    seg.attach_segments(idx)
    rng = np.random.default_rng(SEED + 8)
    new_docs = zipf_docs(rng, SERVE_SEG_CALLS * SEG_CALL)
    seg_launches = {kernel: 0 for kernel in K.LAUNCHES}

    def served(fn):
        K.reset_launches()
        try:
            return fn()
        finally:
            for kernel, c in K.LAUNCHES.items():
                seg_launches[kernel] += c

    mutate_s, checks = 0.0, 0
    try:
        calls = [("add", [f"served{j}" for j in range(c * SEG_CALL,
                                                      (c + 1) * SEG_CALL)],
                  new_docs[c * SEG_CALL:(c + 1) * SEG_CALL])
                 for c in range(SERVE_SEG_CALLS)]
        calls.append(("delete", [f"doc{j}" for j in
                                 rng.permutation(len(small_corpus))[:SEG_CALL]
                                 + 1], None))
        for kind, names, docs in calls:
            t0 = time.perf_counter()
            got = served(lambda: seg.add_docs(names, docs) if kind == "add"
                         else seg.delete_docs(names))
            mutate_s += time.perf_counter() - t0
            check(got["epoch"] == seg.epoch, "path_serve: mutation epoch")
            _, view = seg.current_index()
            served_res = [(kw, served(lambda: seg.search(
                queries[:16], k=RETR_K, timeout=300, **kw)))
                for kw in ({}, {"scorer": "bm25"})]
            oracle = idx.rebuild_retriever()
            for kw, a in served_res:
                b = oracle.search(queries[:16], k=RETR_K, **kw)
                check(_named(view, a) == _named(oracle, b),
                      f"path_serve: segmented server after {kind} differs "
                      f"from rebuild_retriever() ({kw})")
                # the positions, mapped to the rebuild's, under compare_search
                where = {name: i for i, name in enumerate(oracle.names)}
                ids = np.array([[where[view.names[i]] if i >= 0 else -1
                                 for i in row] for row in a[1]])
                cmp = compare_search(a[0], ids, *b)
                check(cmp["ok"], f"path_serve: segmented {cmp}")
                checks += 1
    finally:
        seg.close()
    check_serve_threads_gone("the segmented server")
    for kernel, c in seg_launches.items():
        total[kernel] += c
    check(seg_launches["tile_scores"] > 0,
          "path_serve: the segmented server never launched B6")
    out["segmented"] = {"base_docs": len(small_corpus),
                        "from_corpus_s": seg_build_s,
                        "mutation_calls": len(calls),
                        "mutate_install_s": mutate_s,
                        "epoch": seg.epoch, "checks": checks,
                        "launches": seg_launches}

    # step 6: cli serve in a subprocess, no --device: it served on cuda
    # (cli_runs, alongside the other CLI runs)
    by_id = serve_lines(cli["serve_single"])
    cli_s = cli["serve_single"]["seconds"]
    want_v, want_i = new.search(queries[:SERVE_CLI_QUERIES], k=RETR_K)
    for i in range(SERVE_CLI_QUERIES):
        got = by_id.get(i, {}).get("results")
        check(got is not None, f"path_serve: cli serve gave no results for "
              f"line {i}: {by_id.get(i)}")
        want = [[new.names[int(d)], float(v)]
                for v, d in zip(want_v[i], want_i[i]) if d >= 0]
        check([nm for nm, _ in got[0]] == [nm for nm, _ in want]
              and all(np.float32(a).view(np.uint32)
                      == np.float32(b).view(np.uint32)
                      for (_, a), (_, b) in zip(got[0], want)),
              f"path_serve: cli serve line {i} differs from the library's "
              f"search")
    health = by_id["op_healthz"]["healthz"]
    metrics = by_id["op_metrics"]["metrics"]
    cli_dev = by_id["op_devmon"]["devmon"]
    check(metrics["fingerprint"]["backend"] == "cuda",
          f"path_serve: cli serve backend {metrics['fingerprint']}")
    check(by_id["op_readyz"]["readyz"]["ready"] is True,
          "path_serve: cli serve not ready")
    check(health["checks"]["xla_recompiles_after_warm"] == 0,
          "path_serve: cli serve recompiled after warm-up")
    check(cli_dev["devices"][0].get("bytes_in_use", 0) > 0,
          "path_serve: cli serve's devmon read no bytes")
    out["cli"] = {"seconds": cli_s,
                  "concurrent_cli_runs": cli["serve_single"]["concurrent"],
                  "health": health["status"],
                  "fingerprint": metrics["fingerprint"],
                  "requests": metrics["requests"],
                  "latency_s": metrics["latency_s"],
                  "devmon_bytes_in_use":
                      cli_dev["devices"][0]["bytes_in_use"],
                  "stderr_tail": cli["serve_single"]["stderr"][-400:]}
    emit({"phase": "path_serve", "docs": n, "k": RETR_K,
          "threads": SERVE_THREADS, "requests_per_thread": SERVE_REQUESTS,
          "mix": ["tfidf", "bm25", "tfidf+id_range"], **out,
          "served_equals_direct": True, "depth2_equals_depth1": True,
          "seconds": time.perf_counter() - t_phase, "ok": True})


# --- path_replicas: the replicated front, 2 replica processes on the card --

REPLICAS = 2              # path_replicas: replica processes on the one card
REPLICA_QUERIES = 64      # path_replicas: queries held to a direct search
REPLICA_BATCH = 16        # path_replicas: queries a batched request
REPLICA_CHAOS = "replica_prepare:fatal:n=1:match=replica=2 boot=0"
REPLICA_WAIT_S = 300      # path_replicas: the deadline of every wait
REPLICA_CLI_DELTA = 1024  # path_replicas tier B: --delta-docs
REPLICA_CLI_ADDS = 1088   # tier B: new docs (fills and seals the delta)
REPLICA_CLI_UPDATES = 32  # tier B: existing names re-added
REPLICA_CLI_DELETES = 64  # tier B: names deleted


def replica_cli_commands(small, queries) -> dict:
    """Tier B of path_replicas, run with the other CLI runs: ``cli serve
    --delta-docs 1024`` over the 32,768 files with ``--replicas 2`` (a
    fresh ``--snapshot-dir``: replica 1 builds and snapshots, replica 2
    restores) and without, on one script: queries, ``add_docs`` (new
    docs past the delta's capacity, and updates), ``delete_docs``,
    ``compact``, the queries again, ``trace_export``, ``replica_info``
    and ``shutdown``."""
    rng = np.random.default_rng(SEED + 9)
    new = zipf_docs(rng, REPLICA_CLI_ADDS + REPLICA_CLI_UPDATES)
    names = [f"added{j}" for j in range(REPLICA_CLI_ADDS)] + [
        f"doc{j}" for j in rng.permutation(N_DOCS)[:REPLICA_CLI_UPDATES] + 1]
    doomed = [f"doc{j}" for j in
              rng.permutation(N_DOCS)[:REPLICA_CLI_DELETES] + 1]

    def asked(tag):
        return [{"id": f"{tag}{i}", "queries": [queries[i]], "k": RETR_K,
                 **SERVE_MIX[i % len(SERVE_MIX)]}
                for i in range(SERVE_CLI_QUERIES)]

    script = asked("a") + [
        {"id": "add", "op": "add_docs",
         "docs": [{"name": nm, "text": d.decode()}
                  for nm, d in zip(names, new)]},
        {"id": "delete", "op": "delete_docs", "names": doomed},
        {"id": "compact", "op": "compact"}] + asked("b") + [
        {"id": "trace", "op": "trace_export"},
        {"id": "info", "op": "replica_info"}, {"op": "shutdown"}]
    lines = "\n".join(json.dumps(x) for x in script) + "\n"
    serve = ["serve", "--input", small, "--doc-len", str(DOC_LEN), "-k",
             str(RETR_K), "--canary-period-ms", "0", "--delta-docs",
             str(REPLICA_CLI_DELTA)]
    snap = os.path.join(os.path.dirname(small), "replica_cli_snapshot")
    return {"serve_replicas": (serve + ["--replicas", str(REPLICAS),
                                        "--snapshot-dir", snap], lines),
            "serve_segmented": (serve, lines)}


def served_rows(resp, what: str):
    """A response's results as (names, float32 score bits) per query."""
    check("results" in resp, f"path_replicas: {what}: {resp}")
    return [([nm for nm, _ in row],
             np.array([v for _, v in row], np.float32).view(np.uint32))
            for row in resp["results"]]


def direct_rows(r, res):
    """A direct search's (vals, ids) in :func:`served_rows`' form."""
    vals, ids = res
    return [([r.names[int(d)] for d in irow if d >= 0],
             np.asarray(vrow, np.float32)[np.asarray(irow) >= 0].view(
                 np.uint32))
            for vrow, irow in zip(vals, ids)]


def same_rows(a, b) -> bool:
    return len(a) == len(b) and all(
        na == nb and np.array_equal(va, vb) for (na, va), (nb, vb)
        in zip(a, b))


def front_load(front, requests):
    """serve_load's clients, each request through the front's
    ``handle_request`` (the protocol dict). Returns the responses, each
    request's host latency in ms and the wall seconds of the load."""
    answers = [[None] * len(reqs) for reqs in requests]
    lat_ms, errors = [], []
    lock = threading.Lock()

    def client(t):
        try:
            for i, (qs, kw) in enumerate(requests[t]):
                t0 = time.perf_counter()
                answers[t][i] = front.handle_request(
                    {"queries": list(qs), "k": RETR_K, **kw},
                    timeout_s=REPLICA_WAIT_S)
                with lock:
                    lat_ms.append((time.perf_counter() - t0) * 1e3)
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(len(requests))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not errors and not any(th.is_alive() for th in threads),
          f"path_replicas: a client failed: {errors[:3]}")
    return answers, lat_ms, wall


def load_figures(lat_ms, wall, n_requests, n_queries) -> dict:
    return {"requests": n_requests, "queries": n_queries, "wall_s": wall,
            "latency_ms_p50": float(np.percentile(lat_ms, 50)),
            "latency_ms_p99": float(np.percentile(lat_ms, 99)),
            "requests_per_s": n_requests / wall,
            "queries_per_s": n_queries / wall}


def replica_launches(info) -> dict:
    """rN -> (boot, launches since its warm-up) from replica_info."""
    return {label: (v["boot"], v["compiled_programs"]["launches"])
            for label, v in info.items()}


def path_replicas(T, K, _build, r, cfg, queries, big, small, total, cli,
                  load, new):
    """The replicated tier on the card. Tier A, the library: a
    ReplicatedFront of 2 replica processes restored from a snapshot of
    the retrieval index, its answers bit-equal to a direct search,
    path_serve's load beside one in-process server, an armed fault that
    aborts the first swap, the supervised restart, the retried swap to
    the 32,768-doc directory (``new``: that directory's ``index_dir`` on
    the card, the replicas' own call), the fleet trace export and each
    replica's launches. Tier B, the CLI: ``serve --replicas 2`` on a
    segmented index (run with the other CLI runs) against the same
    script served in one process."""
    from tfidf_tpu_torch import obs
    from tfidf_tpu_torch.config import ServeConfig
    from tfidf_tpu_torch.parallel.multihost import _card_bytes_in_use
    from tfidf_tpu_torch.serve import (ReplicatedFront, SwapAborted,
                                       TfidfServer)

    t_phase = time.perf_counter()
    cuda = torch.device("cuda")
    # Both libraries exist before any replica starts (built at first use
    # when missing), so no replica builds one after its warm-up.
    _build.load()
    _build.load_host()
    requests, direct = load
    n_requests = sum(len(x) for x in requests)
    n_queries = sum(len(qs) for reqs in requests for qs, _ in reqs)
    want = [[direct_rows(r, res) for res in row] for row in direct]
    out = {}

    # The same load on one in-process server, alone on the card.
    srv = TfidfServer(r, ServeConfig())
    try:
        b = 1
        while b <= srv.config.max_batch:
            r.search([""] * b, k=RETR_K)
            b *= 2
        srv.mark_warm()
        answers, lat_ms, wall = serve_load(srv, requests)
    finally:
        srv.close()
    for t, reqs in enumerate(requests):
        for i in range(len(reqs)):
            check(same_rows(direct_rows(r, answers[t][i]), want[t][i]),
                  f"path_replicas: in-process request {t}/{i} differs")
    out["in_process_load"] = load_figures(lat_ms, wall, n_requests,
                                          n_queries)

    # Tier A: the snapshot, then the front on it.
    root = os.path.dirname(small)
    snap = os.path.join(root, "replica_snapshot")
    t0 = time.perf_counter()
    r.snapshot(snap)
    out["snapshot_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    bytes_before = _card_bytes_in_use(cuda)
    prev_tracer = obs.get_tracer()
    obs.set_tracer(obs.Tracer(), None)  # the front's span ring
    front = ReplicatedFront(big, cfg, ServeConfig(
        replicas=REPLICAS, snapshot_dir=snap, disttrace=True,
        faults=REPLICA_CHAOS), k=RETR_K, doc_len=DOC_LEN)
    spawned, ready = {}, {}
    real_spawn, real_await = front._spawn, front._await_ready

    def spawn(rank, bootstrap):
        spawned[(rank, front._replicas[rank].boot + 1)] = time.perf_counter()
        return real_spawn(rank, bootstrap)

    def await_ready(rank):
        real_await(rank)
        ready[(rank, front._replicas[rank].boot)] = time.perf_counter()

    front._spawn, front._await_ready = spawn, await_ready
    try:
        t0 = time.perf_counter()
        front.start()
        out["start_s"] = time.perf_counter() - t0
        out["boot_s"] = {f"r{rank}": ready[(rank, 0)] - spawned[(rank, 0)]
                         for rank in range(1, REPLICAS + 1)}
        desc = front.describe()
        check(desc["live"] == REPLICAS and front.epoch == 0,
              f"path_replicas: the tier did not come up: {desc}")

        # Answers: one query a request and batches, tfidf and bm25.
        asked = queries[:REPLICA_QUERIES]
        checked = 0
        for kw in ({}, {"scorer": "bm25"}):
            batches = [[q] for q in asked] + [
                asked[i:i + REPLICA_BATCH]
                for i in range(0, len(asked), REPLICA_BATCH)]
            for qs in batches:
                resp = front.handle_request(
                    {"queries": qs, "k": RETR_K, **kw},
                    timeout_s=REPLICA_WAIT_S)
                check(resp.get("epoch") == 0, f"path_replicas: epoch "
                      f"{resp.get('epoch')}")
                check(same_rows(served_rows(resp, "answers"), direct_rows(
                    r, r.search(qs, k=RETR_K, **kw))),
                    f"path_replicas: {kw} {len(qs)} queries differ from a "
                    f"direct search")
                checked += 1

        # path_serve's load through the front.
        answers, lat_ms, wall = front_load(front, requests)
        for t, reqs in enumerate(requests):
            for i in range(len(reqs)):
                check(answers[t][i].get("epoch") == 0
                      and same_rows(served_rows(answers[t][i], "load"),
                                    want[t][i]),
                      f"path_replicas: served request {t}/{i} differs from "
                      f"a direct search")
        out["front_load"] = load_figures(lat_ms, wall, n_requests, n_queries)
        out["front_load"]["routed"] = {
            f"r{k}": v["routed"]
            for k, v in front.describe()["replicas"].items()}
        out["queries_per_s_ratio"] = (
            out["front_load"]["queries_per_s"]
            / out["in_process_load"]["queries_per_s"])
        torch.cuda.synchronize()
        bytes_live = _card_bytes_in_use(cuda)
        out["card_bytes"] = {
            "before": bytes_before, "live": bytes_live,
            "per_replica": (bytes_live - bytes_before) / REPLICAS}
        info_pre = front.replica_info()
        pre = replica_launches(info_pre)

        # Chaos: replica 2 dies between its prepare ack and the commit.
        t0 = time.perf_counter()
        try:
            front.swap_index(small)
            aborted = False
        except SwapAborted:
            aborted = True
        t_abort = time.perf_counter()
        check(aborted, "path_replicas: the armed swap was not aborted")
        out["aborted_swap_s"] = t_abort - t0
        check(front.epoch == 0 and all(
            rep["epoch"] == 0 for rep in front.describe()["replicas"]
            .values()), "path_replicas: a replica left epoch 0 after the "
            "abort")
        for q in asked[:16]:
            resp = front.handle_request({"queries": [q], "k": RETR_K},
                                        timeout_s=REPLICA_WAIT_S)
            check(resp.get("epoch") == 0 and same_rows(
                served_rows(resp, "after the abort"),
                direct_rows(r, r.search([q], k=RETR_K))),
                "path_replicas: an answer after the abort differs")

        # The supervised restart from the snapshot.
        deadline = time.perf_counter() + REPLICA_WAIT_S
        while time.perf_counter() < deadline:
            d = front.describe()["replicas"]
            if d["2"]["state"] == "live" and d["2"]["boot"] >= 1:
                break
            time.sleep(0.05)
        d = front.describe()["replicas"]
        check(d["2"]["state"] == "live" and d["2"]["boot"] == 1
              and d["2"]["epoch"] == 0,
              f"path_replicas: replica 2 did not restart: {d['2']}")
        out["restart"] = {"since_abort_s": ready[(2, 1)] - t_abort,
                          "boot_s": ready[(2, 1)] - spawned[(2, 1)]}
        mid = replica_launches(front.replica_info())

        # The retried swap commits epoch 1 on every replica.
        t0 = time.perf_counter()
        epoch = front.swap_index(small)
        out["swap_s"] = time.perf_counter() - t0
        check(epoch == 1 and front.epoch == 1 and all(
            rep["epoch"] == 1 for rep in front.describe()["replicas"]
            .values()), "path_replicas: the retried swap did not commit")
        for rank in range(1, REPLICAS + 1):
            for kw in ({}, {"scorer": "bm25"}):
                resp = front.handle_request(
                    {"queries": asked, "k": RETR_K, **kw}, rank=rank,
                    timeout_s=REPLICA_WAIT_S)
                check(resp.get("epoch") == 1 and same_rows(
                    served_rows(resp, "after the swap"),
                    direct_rows(new, new.search(asked, k=RETR_K, **kw))),
                    f"path_replicas: replica {rank} after the swap differs "
                    f"from a direct search of the new index ({kw})")

        bundle = front.trace_export()
        procs = {p["process"]: p for p in bundle["processes"]}
        check(set(procs) == {"front", "r1", "r2"},
              f"path_replicas: trace_export processes {sorted(procs)}")
        for label in ("r1", "r2"):
            check(procs[label]["clock"]["samples"] > 0,
                  f"path_replicas: {label} has no clock samples")
        out["trace_export"] = {
            label: {"events": len(p["traceEvents"]), "clock": p.get("clock")}
            for label, p in procs.items()}

        info = front.replica_info()
        end = replica_launches(info)
        for label, v in info.items():
            check(v["recompiles_after_warm"] == 0,
                  f"path_replicas: {label} built after its warm-up")
            boot, launches = end[label]
            check(launches["tile_scores"] > 0,
                  f"path_replicas: {label} never launched tile_scores")
            check(mid[label][0] == boot and launches["ragged_rebuild"]
                  > mid[label][1]["ragged_rebuild"],
                  f"path_replicas: {label}'s swap never launched "
                  f"ragged_rebuild")
        check(pre["r2"][0] == 0 and pre["r2"][1]["tile_scores"] > 0,
              "path_replicas: r2 served nothing before the chaos")
        launches = {kernel: end["r1"][1][kernel] + end["r2"][1][kernel]
                    + pre["r2"][1][kernel] for kernel in K.LAUNCHES}
        out["replica_info"] = info
        out["launches"] = launches
        out["describe"] = front.describe()
    finally:
        front.close()
        obs.set_tracer(prev_tracer)
    check(all(rep.proc is None or rep.proc.poll() is not None
              for rep in front._replicas.values()),
          "path_replicas: a replica process outlived close()")
    check_serve_threads_gone("the front's in-process server")

    # Tier B: cli serve --replicas 2 against the same script in one process.
    tier_b, plain = cli["serve_replicas"], cli["serve_segmented"]
    check(f"front serving {REPLICAS} replica(s)" in tier_b["stderr"],
          "path_replicas: cli serve --replicas printed no front banner")
    by, ref = serve_lines(tier_b), serve_lines(plain)
    for tag in ("a", "b"):
        for i in range(SERVE_CLI_QUERIES):
            a, b = by.get(f"{tag}{i}", {}), ref.get(f"{tag}{i}", {})
            check("results" in a and a.get("results") == b.get("results"),
                  f"path_replicas: cli --replicas line {tag}{i} differs "
                  f"from the in-process serve: {str(a)[:200]}")
            check(a.get("epoch") == (0 if tag == "a" else 3),
                  f"path_replicas: cli line {tag}{i} epoch {a.get('epoch')}")
    check(by["add"].get("replicas") == REPLICAS
          and by["add"].get("added") == REPLICA_CLI_ADDS
          and by["add"].get("updated") == REPLICA_CLI_UPDATES
          and by["delete"].get("deleted") == REPLICA_CLI_DELETES
          and by["compact"].get("epoch") == 3,
          f"path_replicas: cli mutations {by['add']}, {by['delete']}, "
          f"{by['compact']}")
    cli_info = by["info"]["replica_info"]
    check(set(cli_info) == {"r1", "r2"}, f"path_replicas: cli replica_info "
          f"{sorted(cli_info)}")
    cli_launches = {kernel: 0 for kernel in K.LAUNCHES}
    for label, v in cli_info.items():
        check(v["recompiles_after_warm"] == 0 and v["epoch"] == 3,
              f"path_replicas: cli {label}: {v}")
        got = v["compiled_programs"]["launches"]
        check(got["tile_scores"] > 0,
              f"path_replicas: cli {label} never launched tile_scores")
        for kernel, c in got.items():
            cli_launches[kernel] += c
    cli_procs = {p["process"] for p in
                 by["trace"]["trace_export"]["processes"]}
    check({"r1", "r2"} <= cli_procs,
          f"path_replicas: cli trace_export {sorted(cli_procs)}")
    out["cli"] = {"seconds": tier_b["seconds"],
                  "in_process_seconds": plain["seconds"],
                  "concurrent_cli_runs": tier_b["concurrent"],
                  "epochs": [by["add"]["epoch"], by["delete"]["epoch"],
                             by["compact"]["epoch"]],
                  "replica_info": cli_info, "launches": cli_launches,
                  "stderr_tail": tier_b["stderr"][-600:]}
    for kernel in K.LAUNCHES:
        total[kernel] += launches[kernel] + cli_launches[kernel]
    emit({"phase": "path_replicas", "docs": r._num_docs,
          "replicas": REPLICAS, "k": RETR_K, "threads": SERVE_THREADS,
          "requests_per_thread": SERVE_REQUESTS, "answer_checks": checked,
          **out, "served_equals_direct": True,
          "seconds": time.perf_counter() - t_phase, "ok": True})


def b6_bound(data, cols, q: int):
    """What one tile-scores call needs at this data: data at every slot,
    cols at live slots, the qmat rows of the distinct live columns (Q
    floats each), the output; and one FMA per live slot and query."""
    live = data != 0
    n_live = int(live.sum())
    n_distinct = int(torch.unique(cols[live]).numel())
    rows, length = data.shape
    nbytes = rows * length * 4 + n_live * 4 + n_distinct * q * 4 + rows * q * 4
    fmas = n_live * q
    bytes_ms = bound_ms(nbytes)
    ops_ms = fmas / FP32_FMA_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_bound_ms": bytes_ms, "operations_bound_ms": ops_ms,
            "live_slots": n_live, "distinct_columns": n_distinct,
            "bytes": nbytes, "fmas": fmas}


def b6_kernel_cases(K, R, r, cfg, queries, summary):
    """B6 against its plain version on real tiles of the retrieval
    index, and its times at Q = 64 (the kernels line) and Q = 256."""
    from tfidf_tpu_torch.scoring import parse_scorer

    dev = r.device
    cases = []
    faces = {"tfidf": r._scorer_face(parse_scorer("tfidf")),
             "bm25": r._scorer_face(parse_scorer("bm25"))}

    # Q 512 needs more queries than the searches use.
    queries = queries + retrieval_queries(np.random.default_rng(SEED + 4),
                                          max(B6_CHECKED_Q) - len(queries))

    def qmat_for(kind, q):
        mode = "counts" if kind == "bm25" else "cosine"
        return torch.from_numpy(R.query_matrix(
            queries[:q], cfg, r._idf_host(), mode=mode)).to(dev)

    def case(label, data, cols, qmat, dead_rows=0):
        got = K.tile_scores(data, cols, qmat)
        want = K.tile_scores_plain(data, cols, qmat)
        torch.cuda.synchronize()
        check(same_bits(got, want), f"B6 {label}: differs from plain")
        if dead_rows:
            check(bool((got[:dead_rows] == 0).all()),
                  f"B6 {label}: all-dead rows do not score 0")
        cases.append({"kernel": "tile_scores", "case": label,
                      "shape": [*data.shape, *qmat.shape],
                      "whole_output_bit_equal": True, "max_abs_err": 0.0})

    tiles = {}
    for kind, (data, cols) in faces.items():
        d_t, c_t = data[:RETR_TILE], cols[:RETR_TILE]
        for q in B6_TIMED_Q[kind]:
            qm = qmat_for(kind, q)
            tiles[kind, q] = (d_t, c_t, qm)
            case(f"{kind}_q{q}", d_t, c_t, qm)
    d_t, c_t = faces["tfidf"][0][:RETR_TILE], faces["tfidf"][1][:RETR_TILE]
    for q in B6_CHECKED_Q:
        if ("tfidf", q) not in tiles:
            case(f"tfidf_q{q}", d_t, c_t, qmat_for("tfidf", q))
    q64 = tiles["tfidf", 64][2]
    ragged = 3001
    case(f"ragged_{ragged}_rows_q64", faces["tfidf"][0][:ragged].contiguous(),
         faces["tfidf"][1][:ragged].contiguous(), q64)
    dead = d_t.clone()
    dead[:512] = 0
    case("dead_rows_0_512_q64", dead, c_t, q64, dead_rows=512)
    full = d_t.clone()
    full[7] = 0.5  # row 7: every one of its L slots live
    for q in (64, RETR_QUERIES):
        case(f"all_live_row_q{q}", full, c_t, tiles["tfidf", q][2])
    emit({"phase": "kernel_cases_b6", "cases": cases})

    def timed(kind, q):
        data, cols, qmat = tiles[kind, q]
        live = data != 0
        crow = torch.zeros(data.shape[0] + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(live.sum(dim=1), 0)
        csr = torch.sparse_csr_tensor(crow, cols[live].to(torch.int64),
                                      data[live],
                                      size=(data.shape[0], SPARSE_VOCAB),
                                      check_invariants=False)
        lib = torch.sparse.mm(csr, qmat)
        kern = K.tile_scores(data, cols, qmat)
        torch.cuda.synchronize()
        out = torch.empty_like(kern)
        times = kernel_times(
            lambda: K.tile_scores(data, cols, qmat),
            lambda: K.tile_scores_plain(data, cols, qmat),
            lambda: torch.sparse.mm(csr, qmat),
            kernel_only=lambda: K.tile_scores_launch(data, cols, qmat, out))
        torch.cuda.synchronize()
        check(same_bits(out, kern), f"B6 {kind} Q={q}: the timed launch's "
              f"output differs")
        bound = b6_bound(data, cols, q)
        return {**times, **bound, "kernel_bound_ms": bound["bound_ms"],
                "library_max_abs_err": (lib - kern).abs().max().item(),
                "max_abs_err": 0.0,
                "shape": {"rows": data.shape[0], "L": data.shape[1],
                          "V": SPARSE_VOCAB, "Q": q, "face": kind}}

    main = timed("tfidf", 64)
    main["library_call"] = ("torch.sparse.mm(tile as CSR [4096, V], qmat) "
                            "(CSR built outside the timed span)")
    main["other_shapes"] = {f"{kind}_q{q}": timed(kind, q)
                            for kind, qs in B6_TIMED_Q.items() for q in qs
                            if (kind, q) != ("tfidf", 64)}
    summary["tile_scores"] = main


def main() -> int:
    t_run = time.perf_counter()
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device\n")
        return 2
    sys.path.insert(0, REPO)
    import tfidf_tpu_torch as T
    from tfidf_tpu_torch import ingest
    from tfidf_tpu_torch.config import VocabMode
    from tfidf_tpu_torch.golden import golden_output
    from tfidf_tpu_torch.io import fast_tokenizer as FT
    from tfidf_tpu_torch.ops import _build, kernels as K

    card_peaks()
    smi = env_phase(_build)
    summary = kernel_phase(K)

    rng = np.random.default_rng(SEED)
    corpus = zipf_corpus(T.Corpus, rng)
    sparse_cfg = T.PipelineConfig(vocab_mode=VocabMode.HASHED,
                                  vocab_size=SPARSE_VOCAB, max_doc_len=DOC_LEN,
                                  doc_chunk=DOC_LEN, topk=TOPK)
    dense_cfg = T.PipelineConfig(vocab_mode=VocabMode.HASHED,
                                 vocab_size=DENSE_VOCAB, max_doc_len=DOC_LEN,
                                 doc_chunk=DOC_LEN, topk=TOPK, engine="dense")
    check(sparse_cfg.engine == "sparse", "hashed default engine is sparse")
    total = {name: 0 for name in K.LAUNCHES}
    for name, cfg, expect in (
            ("path_sparse_topk", sparse_cfg, ("fused_score_topk", "pack_words")),
            ("path_dense_topk", dense_cfg, ("tf_df", "pack_words"))):
        got = path_phase(name, T, K, corpus, cfg, expect, np.float16)
        for kernel, n in got.items():
            total[kernel] += n

    gold = golden_corpus(T.Corpus, rng)
    K.reset_launches()
    out = T.TfidfPipeline(T.PipelineConfig.golden()).run(gold).output_bytes()
    launches = dict(K.LAUNCHES)
    check(launches["tf_df"] > 0, "path_golden: tf_df never launched")
    for kernel, n in launches.items():
        total[kernel] += n
    want = golden_output(gold)
    check(out == want, "path_golden: output bytes differ from golden_output")
    cpu_out = T.TfidfPipeline(T.PipelineConfig.golden(),
                              device="cpu").run(gold).output_bytes()
    check(out == cpu_out, "path_golden: output bytes differ from CPU run")
    emit({"phase": "path_golden", "docs": len(gold), "lines": out.count(b"\n"),
          "bytes": len(out), "launches": launches, "golden_equal": True,
          "cpu_equal": True, "ok": True})

    path_ragged_batch(T, K, corpus, sparse_cfg, total)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        big = os.path.join(tmp, "resident")
        small = os.path.join(tmp, "streaming")
        os.makedirs(big)
        os.makedirs(small)
        t0 = time.perf_counter()
        big_docs = zipf_docs(np.random.default_rng(SEED + 1), INGEST_DOCS)
        write_corpus(big, big_docs)
        write_corpus(small, corpus.docs)
        emit({"phase": "ingest_corpora", "docs": [INGEST_DOCS, N_DOCS],
              "bytes": [sum(map(len, big_docs)), sum(map(len, corpus.docs))],
              "write_s": time.perf_counter() - t0})
        rg = path_ingest_resident(T, K, FT, ingest, big, big_docs, total,
                                  small)
        path_recovery(T, K, FT, ingest, big, small, rg, total)
        streamed = path_ingest_streaming(T, K, FT, ingest, small, total)
        r, rcfg, queries = path_retrieval(T, K, big, big_docs, total)
        from tfidf_tpu_torch.models import retrieval as R
        b6_kernel_cases(K, R, r, rcfg, queries, summary)
        stream_cli = path_stream(T, K, small, big_docs, rg.df, total)
        seg_idx = path_segmented(T, K, big_docs, queries, total)
        path_exact_terms(T, K, FT, ingest, big, small, total)
        chargram = path_chargram(T, K, FT, total)
        # the CLI runs the next six phases check, run at once
        golden_dir = os.path.join(tmp, "golden")
        observe_dir = os.path.join(tmp, "observe")
        for d in (golden_dir, observe_dir):
            os.makedirs(d)
        write_corpus(golden_dir, gold.docs)
        cli = cli_runs(cli_commands(small, queries, golden_dir, observe_dir))
        path_observe(T, K, ingest, small, big_docs, rcfg, queries, total,
                     cli, observe_dir, want)
        path_mesh(T, K, ingest, corpus, gold, big, small, rg, streamed,
                  chargram, total, cli)
        path_multiprocess(T, K, _build, big, rg, total, cli)
        load = served_load_and_direct(r, queries)
        small_r = path_mesh_serve(T, K, _build, ingest, r, rcfg, queries,
                                  big_docs, seg_idx, small, corpus, total,
                                  cli, stream_cli, load)
        del seg_idx
        path_replicas(T, K, _build, r, rcfg, queries, big, small, total, cli,
                      load, small_r)
        del small_r
        # last: its profile of a multi-threaded load runs after every
        # other profile of the script
        path_serve(T, K, r, rcfg, queries, small, corpus, total, cli, load)
        del r

    sources = {"fused_score_topk": ("tfidf_tpu_torch/csrc/score_topk.cu",
                                    "tfidf_tpu/ops/pallas_kernels.py:466"),
               "tf_df": ("tfidf_tpu_torch/csrc/tf_df.cu",
                         "tfidf_tpu/ops/pallas_kernels.py:105"),
               "pack_words": ("tfidf_tpu_torch/csrc/pack_words.cu",
                              "tfidf_tpu/ops/pallas_kernels.py:282"),
               "ragged_rebuild": ("tfidf_tpu_torch/csrc/ragged_rebuild.cu",
                                  "tfidf_tpu/ops/pallas_kernels.py:210"),
               "tokenize_hash": ("tfidf_tpu_torch/csrc/tokenize_hash.cu",
                                 "tfidf_tpu/ops/pallas_kernels.py:388"),
               "tile_scores": ("tfidf_tpu_torch/csrc/tile_scores.cu",
                               "tfidf_tpu/ops/pallas_kernels.py:526")}
    rows = []
    for kernel, (src, replaces) in sources.items():
        s = summary[kernel]
        rows.append({"name": kernel, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": total[kernel],
                     "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                     "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                     "bound_by": s.get("bound_by", "bytes"),
                     "library_ms": s["library_ms"],
                     "kernel_ms": s["kernel_ms"],
                     "kernel_bound_ms": s["kernel_bound_ms"],
                     "call_ms": s["call_ms"], "shape": s["shape"],
                     **{key: s[key] for key in (
                         "library_call", "bytes_bound_ms",
                         "operations_bound_ms", "library_max_abs_err",
                         "yardstick_ms", "yardstick_call", "kernel_ms_k1",
                         "kernel_ms_k64", "kernel_ms_no_head_slots",
                         "rows_over_32_head_slots", "rebuild_only_ms",
                         "granule_offsets_chain_ms", "token_starts_ms",
                         "launch_floor_ms", "other_shapes") if key in s}})
    emit({"phase": "run_time", "seconds": time.perf_counter() - t_run})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
