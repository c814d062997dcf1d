"""The port's cost model, scoring oracle, device-op table and the rest of
the public surface it shares with the JAX package, on the CPU.

* ``obs.costmodel``: ``span_gbps`` and ``achieved_gbps`` equal the JAX
  package's on the same events; ``hbm_peak_gbs`` knows the H100 by the
  names ``torch.cuda.get_device_name()`` gives and nothing else (None on
  the CPU, for other cards and for TPUs); each of ``stage_bytes``'s
  stages is the bytes of the tensors the port's own stage reads and
  writes at a small shape.
* ``obs.device_op_table`` reads a torch.profiler Chrome export (kineto's
  device categories on the GPU's lanes, its annotations left out) and a
  ``jax.profiler`` one (its ``/device`` lanes).
* ``scoring.oracle`` equals the JAX oracle bit for bit on seeded numpy
  inputs, and ``TfidfRetriever.search`` equals ``oracle_topk`` in ids and
  tie order (scores allclose) for tfidf and bm25 (default and non-default
  k1/b), with and without a filter, as ``tests/test_scoring_family.py``
  holds the JAX retriever.
* ``utils.timing``'s ``Throughput``, ``trace_region`` and
  ``PhaseTimer.seconds``/``items``/``reset``; ``obs.devmon``'s
  ``configure``, ``get_monitor``/``set_monitor``, ``log_census``,
  ``unregister_owner``, ``note_compile`` and the compile watch's
  ``compile_seconds``/``recompiles_after_warm``; ``io.fast_tokenizer``'s
  ``tokenize_hash_ids`` and ``*_available`` predicates.
"""

import random
import time

import numpy as np
import pytest
import torch

from tfidf_tpu.obs import costmodel as jcost
from tfidf_tpu.obs import tracer as jtracer
from tfidf_tpu.scoring import oracle as joracle
from tfidf_tpu.utils import timing as jtiming

from tfidf_tpu_torch import obs
from tfidf_tpu_torch.config import PipelineConfig, VocabMode
from tfidf_tpu_torch.io import fast_tokenizer as FT
from tfidf_tpu_torch.io.corpus import Corpus
from tfidf_tpu_torch.models import TfidfRetriever
from tfidf_tpu_torch.models.retrieval import query_matrix
from tfidf_tpu_torch.obs import costmodel, devmon
from tfidf_tpu_torch.obs import log as tlog
from tfidf_tpu_torch.ops import kernels as K
from tfidf_tpu_torch.ops.hashing import words_to_ids
from tfidf_tpu_torch.ops.histogram import valid_mask
from tfidf_tpu_torch.ops.scoring import idf_from_df
from tfidf_tpu_torch.ops.sparse import sparse_df
from tfidf_tpu_torch.ops.tokenize import whitespace_tokenize
from tfidf_tpu_torch.scoring import oracle, parse_scorer
from tfidf_tpu_torch.scoring.filters import filter_mask, parse_filter
from tfidf_tpu_torch.utils import timing


# --- the cost model ---------------------------------------------------

SPAN_EVENTS = [
    {"ph": "X", "name": "dispatch", "ts": 0.0, "dur": 250.0,
     "args": {"bytes": 11_700_000}},
    {"ph": "X", "name": "drain", "ts": 3.0, "dur": 1.5,
     "args": {"bytes": 98_304, "chunk": 0}},
    {"ph": "X", "name": "fetch", "ts": 1.0, "dur": 0.0,
     "args": {"bytes": 10}},
    {"ph": "X", "name": "fetch", "ts": 1.0, "dur": -1.0,
     "args": {"bytes": 10}},
    {"ph": "X", "name": "emit", "ts": 1.0, "dur": 10.0},
    {"ph": "X", "name": "emit", "ts": 1.0, "dur": 10.0,
     "args": {"bytes": "12"}},
    {"ph": "X", "name": "slab", "ts": 1.0, "dur": 7,
     "args": {"bytes": 0}},
    {"ph": "i", "name": "mark", "ts": 1.0, "args": {"bytes": 4}},
]


@pytest.mark.parametrize("i", range(len(SPAN_EVENTS)))
def test_span_gbps_equals_jax(i):
    ev = SPAN_EVENTS[i]
    assert costmodel.span_gbps(ev) == jcost.span_gbps(ev)


@pytest.mark.parametrize("nbytes,seconds", [
    (1e9, 1.0), (3, 7e-6), (0, 1.0), (10, 0.0), (10, -1.0), (-1, 1.0)])
def test_achieved_gbps_equals_jax(nbytes, seconds):
    assert costmodel.achieved_gbps(nbytes, seconds) \
        == jcost.achieved_gbps(nbytes, seconds)


def test_tracer_exports_gb_s_through_span_gbps():
    t = obs.Tracer()
    obs.set_tracer(t)
    try:
        with obs.span("dispatch", bytes=1 << 20):
            time.sleep(0.002)
    finally:
        obs.set_tracer(None)
    ev = next(e for e in t.chrome_events() if e["ph"] == "X")
    assert ev["args"]["gb_s"] == round(costmodel.span_gbps(ev), 4)
    assert 0 < ev["args"]["gb_s"] < 1


@pytest.mark.parametrize("kind,peak", [
    ("NVIDIA H100 80GB HBM3", 3350.0), ("NVIDIA H100 SXM5 80GB", 3350.0),
    ("h100 sxm", 3350.0), ("NVIDIA A100-SXM4-80GB", None),
    ("NVIDIA H100 PCIe", None), ("cpu", None), ("", None), (None, None),
    ("TPU v5 lite", None), ("TPU v4", None)])
def test_hbm_peak_is_the_h100s_and_nothing_else(kind, peak):
    assert costmodel.hbm_peak_gbs(kind) == peak


def test_peaks_and_default():
    assert costmodel.HBM_PEAK_GBS_DEFAULT == 3350.0
    assert costmodel.INT32_MAD_PER_S == 132 * 64 * 1.98e9
    assert costmodel.FP32_FMA_PER_S == 67e12 / 2
    # no TPU figure anywhere in the port's table
    assert all(p == 3350.0 for _, p in costmodel._HBM_PEAK_TABLE)


@pytest.mark.parametrize("docs,length,topk,vocab", [
    (8, 16, 4, 64), (5, 32, 16, 4096), (3, 48, 64, 128)])
def test_stage_bytes_are_the_port_tensors_bytes(docs, length, topk, vocab):
    """Each stage run at a small shape on the port's own functions: the
    bytes of its input and output tensors are the model's figure."""
    rng = np.random.default_rng(docs)
    ids_np = rng.integers(0, vocab, (docs, length)).astype(np.uint16)
    lengths = torch.full((docs,), length, dtype=torch.int32)
    flat = torch.from_numpy(ids_np.reshape(-1).copy())       # full rows
    tok = K.ragged_rebuild(flat, lengths, length=length, align=16)
    valid = valid_mask(lengths, length)
    masked = torch.where(valid, tok, torch.iinfo(torch.int32).max)
    srt = torch.sort(masked, dim=1, stable=True)
    ids = srt.values
    prev = torch.cat([torch.full((docs, 1), -1, dtype=torch.int32),
                      ids[:, :-1]], dim=1)
    head = valid & (ids != prev)
    from tfidf_tpu_torch.ops.sparse import sorted_term_counts
    ids2, counts, head2 = sorted_term_counts(tok, lengths)
    assert torch.equal(ids2, ids) and torch.equal(head2, head)
    df = sparse_df(ids, head, vocab)
    idf = idf_from_df(df, docs, torch.float32)
    vals, tids = K.fused_score_topk(ids, counts, head, lengths, idf, k=topk)
    words = K.pack_words(vals, tids)

    def nb(*ts):
        return sum(t.nbytes for t in ts)

    want = {
        "rebuild": nb(flat, lengths, tok),
        "row_sort": nb(masked, srt.values, srt.indices),
        "rle": nb(ids, lengths, head, counts),
        "df": nb(ids, head, df),
        "score_topk": nb(ids, counts, head, lengths, idf, vals, tids),
        "pack_words": nb(vals, tids, words),
    }
    got = costmodel.stage_bytes(docs, length, topk, vocab_size=vocab)
    assert got == want


# --- the device-op table ----------------------------------------------

B1_NAME = "void (anonymous namespace)::fused_score_topk_kernel<float, 8>(int const*)"


def _torch_export():
    """The form of torch 2.11's Chrome export on the H100 (as recorded
    there): a host pid with cpu_op and runtime events and a profiler
    overhead lane, a GPU pid named after the program and labelled "GPU 0"
    whose lanes hold kernels, copies, memsets, user annotations and flow
    ends."""
    return [
        {"ph": "M", "name": "process_name", "pid": 4242, "tid": 0,
         "args": {"name": "python3"}},
        {"ph": "M", "name": "process_labels", "pid": 4242, "tid": 0,
         "args": {"labels": "CPU"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": "python3"}},
        {"ph": "M", "name": "process_labels", "pid": 0, "tid": 0,
         "args": {"labels": "GPU 0"}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "pid": 4242,
         "tid": 4242, "ts": 1.0, "dur": 50.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 4242, "tid": 4242, "ts": 2.0, "dur": 3.0},
        {"ph": "X", "cat": "kernel", "name": B1_NAME, "pid": 0, "tid": 7,
         "ts": 10.0, "dur": 43.0, "args": {"stream": 7, "grid": [64, 1, 1]}},
        {"ph": "X", "cat": "kernel", "name": B1_NAME, "pid": 0, "tid": 7,
         "ts": 60.0, "dur": 41.0},
        {"ph": "X", "cat": "overhead", "name": "Activity Buffer Request",
         "pid": -1, "tid": 0, "ts": 0.0, "dur": 30.0},
        {"ph": "X", "cat": "kernel", "name": "pack_words_kernel",
         "pid": 0, "tid": 7, "ts": 110.0, "dur": 6.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable)",
         "pid": 0, "tid": 7, "ts": 0.0, "dur": 9.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
         "pid": 0, "tid": 7, "ts": 9.0, "dur": 1.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "phase_b",
         "pid": 0, "tid": 7, "ts": 10.0, "dur": 120.0},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "pid": 0, "tid": 7,
         "ts": 10.0},
    ]


def _jax_export():
    return [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/host:CPU"}},
        {"ph": "M", "name": "process_name", "pid": 2,
         "args": {"name": "/device:TPU:0"}},
        {"ph": "X", "name": "host_op", "pid": 1, "ts": 0, "dur": 99.0},
        {"ph": "X", "name": "fusion.1", "pid": 2, "ts": 0, "dur": 10.0},
        {"ph": "X", "name": "sort.2", "pid": 2, "ts": 10, "dur": 30.0},
        {"ph": "X", "name": "fusion.1", "pid": 2, "ts": 40, "dur": 5.0},
    ]


@pytest.mark.parametrize("which", ["torch", "jax"])
def test_device_op_table_reads_both_captures(which):
    events = _torch_export() if which == "torch" else _jax_export()
    rows, total = obs.device_op_table(events)
    if which == "torch":
        assert rows == [(B1_NAME, 84.0, 2),
                        ("Memcpy HtoD (Pageable)", 9.0, 1),
                        ("pack_words_kernel", 6.0, 1),
                        ("Memset (Device)", 1.0, 1)]
        assert total == 100.0
    else:
        assert rows == [("sort.2", 30.0, 1), ("fusion.1", 15.0, 2)]
        assert total == 45.0
        # the JAX package's table reads the same capture alike
        assert jtracer.device_op_table(events) == (rows, total)
    assert obs.device_op_table(events, top=1)[0] == rows[:1]


def test_device_op_table_of_a_cpu_capture_is_empty(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64).sum()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    assert obs.device_op_table(obs.load_chrome_trace(path)) == ([], 0.0)


# --- the scoring oracle -----------------------------------------------

def _sorted_rows(rng, d, length, vocab):
    ids = np.sort(rng.integers(0, vocab, (d, length)), axis=1)
    lens = rng.integers(0, length + 1, d)
    ids = np.where(np.arange(length)[None, :] < lens[:, None], ids,
                   np.iinfo(np.int32).max).astype(np.int32)
    prev = np.concatenate([np.full((d, 1), -1), ids[:, :-1]], axis=1)
    head = (ids != prev) & (ids != np.iinfo(np.int32).max)
    return ids, head


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracle_functions_equal_jax_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    d, length, vocab, q = 23, 12, 40, 5
    ids, head = _sorted_rows(rng, d, length, vocab)
    live = rng.random(d) < 0.8

    def same(a, b):
        a, b = (np.asarray(x) for x in (a, b))
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()

    counts, lengths = oracle.counts_from_sorted(ids, head)
    for got, want in zip((counts, lengths),
                         joracle.counts_from_sorted(ids, head)):
        same(got, want)
    df = oracle.df_from_sorted(ids, head, vocab)
    same(df, joracle.df_from_sorted(ids, head, vocab))
    same(oracle.df_from_sorted(ids, head, vocab, live=live),
         joracle.df_from_sorted(ids, head, vocab, live=live))
    same(oracle.tfidf_idf(df, d), joracle.tfidf_idf(df, d))
    same(oracle.bm25_idf(df, d), joracle.bm25_idf(df, d))
    faces = []
    for name, extra in (("tfidf_face", ()),
                        ("bm25_face", (float(lengths.mean()), 1.2, 0.75)),
                        ("bm25_face", (3.5, 0.0, 0.0))):
        got = getattr(oracle, name)(ids, counts, head, lengths, df, d,
                                    *extra)
        want = getattr(joracle, name)(ids, counts, head, lengths, df, d,
                                      *extra)
        for g, w in zip(got, want):
            same(g, w)
        faces.append(got)
    qmat = rng.random((vocab, q)).astype(np.float32)
    qmat[rng.random((vocab, q)) < 0.5] = 0
    for data, cols in faces:
        same(oracle.oracle_scores(data, cols, qmat),
             joracle.oracle_scores(data, cols, qmat))
        for lv in (None, live):
            for k in (1, 4, 40):
                for g, w in zip(oracle.oracle_topk(data, cols, lv, qmat, k),
                                joracle.oracle_topk(data, cols, lv, qmat,
                                                    k)):
                    same(g, w)


CFG = PipelineConfig(vocab_mode=VocabMode.HASHED, vocab_size=512,
                     max_doc_len=32, doc_chunk=32)
# A wide vocabulary keeps score gaps between distinct docs above float32
# noise, so ids and tie order are comparable exactly (as in the JAX
# package's scorer-family tests).
WIDE_WORDS = [f"term{i:02d}" for i in range(64)]
SCORERS = ["tfidf", "bm25", "bm25:k1=1.5,b=0.6", "bm25:k1=0.0,b=0.0"]


def _corpus(n_docs, seed):
    rng = random.Random(seed)
    return Corpus(names=[f"doc{i}" for i in range(n_docs)],
                  docs=[" ".join(rng.choice(WIDE_WORDS)
                                 for _ in range(rng.randint(3, 20))).encode()
                        for _ in range(n_docs)])


def _queries(n, seed):
    rng = random.Random(1000 + seed)
    return [" ".join(rng.choice(WIDE_WORDS) for _ in range(rng.randint(1, 4)))
            for _ in range(n)]


def oracle_search(r, queries, k, scorer=None, filter=None):
    """The retriever's own host face and query columns, ranked by the
    oracle (score desc, row asc), trimmed to the result width."""
    spec = r.scorer if scorer is None else parse_scorer(scorer)
    data, cols = r.scorer_face(spec)
    live = np.zeros((data.shape[0],), bool)
    live[:r._num_docs] = True
    fspec = parse_filter(filter)
    if fspec is not None:
        live[:r._num_docs] &= filter_mask(fspec, r._num_docs, names=r.names)
    qmat = query_matrix(queries, r.config, r._idf_host(),
                        mode="counts" if spec.kind == "bm25" else "cosine")
    vals, ids = oracle.oracle_topk(data, cols, live, qmat, k)
    width = min(k, r._num_docs)
    return vals[:, :width], ids[:, :width]


def _assert_matches_oracle(got, want, ctx):
    np.testing.assert_array_equal(np.asarray(got[1]), want[1], err_msg=ctx)
    np.testing.assert_allclose(np.asarray(got[0]), want[0], rtol=1e-5,
                               atol=1e-6, err_msg=ctx)


@pytest.mark.parametrize("spec", SCORERS)
@pytest.mark.parametrize("q", [1, 7, 65])
def test_search_equals_oracle(spec, q):
    r = TfidfRetriever(CFG, device="cpu").index(_corpus(31, seed=q))
    queries = _queries(q, seed=q)
    got = r.search(queries, k=5, scorer=spec)
    _assert_matches_oracle(got, oracle_search(r, queries, 5, scorer=spec),
                           f"{spec} q={q}")


@pytest.mark.parametrize("spec", ["tfidf", "bm25"])
@pytest.mark.parametrize("filt", [{"ids": [0, 3, 5, 8, 12]},
                                  {"id_range": [4, 15]},
                                  {"prefix": "doc1"}])
def test_filtered_search_equals_oracle(spec, filt):
    r = TfidfRetriever(CFG, device="cpu").index(_corpus(25, seed=7))
    queries = _queries(11, seed=7)
    got = r.search(queries, k=6, scorer=spec, filter=filt)
    _assert_matches_oracle(
        got, oracle_search(r, queries, 6, scorer=spec, filter=filt),
        f"{spec} {filt}")
    allow = filter_mask(parse_filter(filt), r._num_docs, names=r.names)
    ids = np.asarray(got[1])
    assert allow[ids[ids >= 0]].all()


def test_tie_order_is_the_lowest_row():
    """Duplicate documents score exactly alike: the oracle and the
    search both list them by ascending row."""
    docs = [b"alpha beta", b"gamma", b"alpha beta", b"alpha beta", b"delta"]
    r = TfidfRetriever(CFG, device="cpu").index(
        Corpus(names=[f"doc{i}" for i in range(5)], docs=docs))
    got = r.search(["alpha"], k=4)
    want = oracle_search(r, ["alpha"], 4)
    _assert_matches_oracle(got, want, "ties")
    assert list(np.asarray(got[1])[0][:3]) == [0, 2, 3]


# --- timing, devmon, fast_tokenizer -----------------------------------

@pytest.mark.parametrize("mod", [timing, jtiming])
def test_phase_timer_seconds_items_reset(mod):
    t = mod.PhaseTimer()
    with t.phase("a"):
        time.sleep(0.01)
    with t.phase("a"):
        time.sleep(0.01)
    with t.phase("b"):
        pass
    assert t.seconds("a") >= 0.02 and t.seconds("missing") == 0.0
    assert [n for n, _ in t.items()] == ["a", "b"]
    assert "a" in t.report() and "%" in t.report()
    t.reset()
    assert t.items() == [] and t.seconds("a") == 0.0


def test_throughput_as_in_jax():
    for mod in (timing, jtiming):
        tp = mod.Throughput()
        assert tp.docs_per_sec == 0.0
        with tp.measure(100):
            time.sleep(0.01)
        assert tp.docs == 100
        assert 0 < tp.docs_per_sec <= 100 / 0.01
        tp.record(50, 0.5)
        assert tp.docs == 150


def test_trace_region_records_a_profiler_range():
    from torch.profiler import ProfilerActivity, profile
    with timing.trace_region("x", enabled=False):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.trace_region("tfidf_region"):
            torch.ones(8).sum()
    assert "tfidf_region" in {e.name for e in prof.events()}


def test_devmon_configure_reads_the_env(monkeypatch):
    monkeypatch.setattr(devmon, "_monitor", None)
    monkeypatch.delenv("TFIDF_TPU_DEVMON", raising=False)
    assert devmon.configure() is None and devmon.get_monitor() is None
    monkeypatch.setenv("TFIDF_TPU_DEVMON", "1")
    monkeypatch.setenv("TFIDF_TPU_DEVMON_PERIOD_MS", "250")
    mon = devmon.configure()
    try:
        assert mon is devmon.get_monitor() and mon.period_s == 0.25
        assert devmon.configure(period_ms=10) is mon  # idempotent
    finally:
        mon.stop()
        devmon.set_monitor(None)
    assert devmon.get_monitor() is None
    monkeypatch.delenv("TFIDF_TPU_DEVMON_PERIOD_MS")
    mon = devmon.configure()
    try:
        assert mon.period_s == 0.5  # the JAX package's default
    finally:
        mon.stop()
        devmon.set_monitor(None)
    assert devmon.configure(period_ms=0) is None


def test_log_census_and_unregister_owner(monkeypatch):
    log = tlog.EventLog(echo="off")
    monkeypatch.setattr(tlog, "_log", log)
    mon = devmon.DeviceMonitor(device="cpu")
    t = torch.zeros(100, dtype=torch.int32)
    mon.register_owner("resident_index", lambda: [t])
    c = mon.log_census()
    ev = log.events()[-1]
    assert ev["event"] == "hbm_census" and ev["level"] == "info"
    assert ev["total_bytes"] == c["total_bytes"] == 400
    assert ev["owners"]["resident_index"] == {"bytes": 400, "arrays": 1}
    assert ev["owners"]["other"]["bytes"] == 0
    mon.unregister_owner("resident_index")
    mon.unregister_owner("never_registered")
    assert "resident_index" not in mon.census()["owners"]
    assert mon.memory_pressure == 0.0 and mon.peak_bytes == 0


def test_compile_watch_names_and_note_compile(monkeypatch):
    log = tlog.EventLog(echo="off")
    monkeypatch.setattr(tlog, "_log", log)
    watch = devmon.CompileWatch()
    monkeypatch.setattr(devmon, "_watch", watch)
    devmon.note_build("kernels", 1.5, library="a.so")
    devmon.note_compile("search", q=64)
    assert watch.compile_seconds == 1.5 and watch.recompiles_after_warm() == []
    watch.mark_warm()
    devmon.note_compile("search", q=65)
    assert watch.recompiles_after_warm() == [{"program": "search", "q": 65}]
    assert log.events()[-1]["event"] == "xla_recompile"
    monkeypatch.setattr(devmon, "_watch", None)
    devmon.note_compile("search", q=66)  # no watch: a no-op
    assert watch.recompile_count == 1


def test_fast_tokenizer_names(monkeypatch):
    data = b"hello world  foo\tbar hello\n"
    preds = (FT.loader_available, FT.flat_available, FT.slab_available,
             FT.rerank_available, FT.intern_available)
    ids = FT.tokenize_hash_ids(data, 1 << 12, seed=3)
    if FT.available():
        want = words_to_ids(whitespace_tokenize(data), 1 << 12, seed=3)
        np.testing.assert_array_equal(ids, want)
        assert all(p() for p in preds)
    else:
        assert ids is None
    monkeypatch.setenv("TFIDF_TPU_NO_NATIVE", "1")
    assert FT.tokenize_hash_ids(data, 1 << 12) is None
    assert not any(p() for p in preds)


def test_trace_capture_runs_at_toy_size(tmp_path):
    """tfidf_tpu_torch/tools/trace_capture.py on the CPU: a warm chunk
    profiled, the capture and the host trace written, an empty device-op
    table (a CPU capture has no device lanes) and no kernel launch."""
    import json
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "cap"
    p = subprocess.run(
        [sys.executable, os.path.join(repo, "tfidf_tpu_torch", "tools",
                                      "trace_capture.py"),
         "--docs", "64", "--len", "16", "--device", "cpu", "--host-trace",
         "--out", str(out)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, TFIDF_TPU_NO_NATIVE="1"))
    assert p.returncode == 0, p.stderr[-2000:]
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert last["rows"] == [] and last["total_us"] == 0.0
    assert set(last["launches"]) == set(K.LAUNCHES)
    assert not any(last["launches"].values())
    assert "| op | total ms | calls |" in p.stdout
    assert (out / "device_trace.json").exists()
    host = obs.load_chrome_trace(str(out / "host_trace.json"))
    lanes = obs.spans_by_thread(host)
    assert {"main", "packer", "drainer"} <= set(lanes)
