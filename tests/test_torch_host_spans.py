"""The spans that name the port's host steps, on the CPU.

* Serving: a served batch records ``take`` and ``form`` on the batcher
  lane, the ``issue`` device span inside the batch's ``device`` span,
  ``fill_query`` and ``score_tile`` inside ``issue``, and every tile's
  ``tile_scores``, ``tile_topk`` and ``tile_merge`` inside
  ``score_tile``; the drain lane's ``drain`` holds ``d2h_wait`` and
  ``deliver`` under the batch's id. ``window_wait`` is recorded only by
  a batch that found the window full. ``tools/trace_check.py`` passes
  the served trace.
* Ingest: on every wire and in both regimes, ``pack_read`` and
  ``pack_tokenize`` lie inside the packer's ``pack``; ``pass_setup`` and
  ``gather`` open and close the pass on ``main``.
* Answers and ingest results are bit-identical with tracing on and off;
  with no tracer the search loop makes no span object and checks
  ``obs.enabled()`` once a call.
* The ``gc_full`` hook exists only while a tracer is armed and records
  a full collection on the lane of every thread still alive; the lanes
  of finished threads are dropped. ``obs.steps`` records a hot loop's
  steps from its clock reads.
* ``device_span`` opens a ``record_function`` range that a CPU
  torch.profiler capture holds, named with the span's batch or chunk.
"""

import gc
import os
import random
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from tfidf_tpu_torch import obs
from tfidf_tpu_torch.config import PipelineConfig, ServeConfig, VocabMode
from tfidf_tpu_torch.ingest import run_overlapped
from tfidf_tpu_torch.io import fast_tokenizer
from tfidf_tpu_torch.io.corpus import Corpus
from tfidf_tpu_torch.models import TfidfRetriever
from tfidf_tpu_torch.obs import tracer as ttracer
from tfidf_tpu_torch.serve import MicroBatcher, TfidfServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 30  # seconds: the timeout of every wait in this file
CFG = PipelineConfig(vocab_mode=VocabMode.HASHED, vocab_size=512,
                     max_doc_len=16, doc_chunk=16)
WORDS = [f"w{i}" for i in range(60)]
QUERIES = ["w1 w2", "w3", "w4 w5 w6", "w7 w1", "w9 w9 w2"]


def _corpus(n=11, seed=3):
    rng = random.Random(seed)
    docs = [" ".join(rng.choice(WORDS) for _ in range(rng.randint(2, 14)))
            .encode() for _ in range(n)]
    return Corpus(names=[f"doc{i + 1}" for i in range(n)], docs=docs)


@pytest.fixture
def tracer():
    t = obs.Tracer()
    obs.set_tracer(t)
    yield t
    obs.set_tracer(None)


@pytest.fixture
def retriever(monkeypatch):
    # 11 rows in tiles of 4: three tiles, the last one ragged
    monkeypatch.setenv("TFIDF_TPU_QUERY_BLOCK", "4")
    return TfidfRetriever(CFG, device="cpu").index(_corpus())


def _lanes(tracer):
    """lane label -> [(name, t0_ns, end_ns, args)], in start order."""
    out = {}
    for name, tid, t0, dur, args in tracer.events():
        if dur >= 0:
            out.setdefault(tracer.thread_label(tid), []).append(
                (name, t0, t0 + dur, args or {}))
    return {k: sorted(v, key=lambda e: e[1]) for k, v in out.items()}


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _named(events, name):
    return [e for e in events if e[0] == name]


def _serve(retriever, queries, scorer=None):
    with TfidfServer(retriever, ServeConfig(max_wait_ms=1)) as srv:
        return [srv.submit([q], 3, scorer=scorer).result(timeout=T)
                for q in queries]


@pytest.mark.parametrize("scorer", [None, "bm25"])
def test_search_spans_nest_on_the_batcher_and_drain_lanes(retriever, tracer,
                                                          scorer):
    _serve(retriever, QUERIES, scorer)
    lanes = _lanes(tracer)
    batcher, drain = lanes["batcher"], lanes["drain"]
    assert _named(batcher, "take") and _named(batcher, "form")
    devices = _named(batcher, "device")
    assert len(devices) == len(QUERIES)
    for dev in devices:
        bid = dev[3]["batch"]
        issue = [e for e in _named(batcher, "issue")
                 if e[3]["batch"] == bid]
        assert len(issue) == 1 and _inside(issue[0], dev)
        tiles = [e for e in _named(batcher, "score_tile")
                 if _inside(e, issue[0])]
        assert len(tiles) == 1
        fills = [e for e in _named(batcher, "fill_query")
                 if _inside(e, issue[0])]
        assert len(fills) == 1
        assert fills[0][3] == {"queries": 1,
                               "mode": "counts" if scorer else "cosine"}
        for step in ("tile_scores", "tile_topk", "tile_merge"):
            assert len([e for e in _named(batcher, step)
                        if _inside(e, tiles[0])]) == 3
        outer = [e for e in _named(drain, "drain") if e[3]["batch"] == bid]
        assert len(outer) == 1
        for step in ("d2h_wait", "deliver"):
            inner = [e for e in _named(drain, step) if e[3]["batch"] == bid]
            assert len(inner) == 1 and _inside(inner[0], outer[0])
    # every tile step ran inside some score_tile
    for step in ("tile_scores", "tile_topk", "tile_merge"):
        assert all(any(_inside(e, s) for s in _named(batcher, "score_tile"))
                   for e in _named(batcher, step))


def test_answers_are_bit_identical_traced_and_untraced(retriever):
    untraced = _serve(retriever, QUERIES)
    obs.set_tracer(obs.Tracer())
    try:
        traced = _serve(retriever, QUERIES)
    finally:
        obs.set_tracer(None)
    direct = [retriever.search([q], 3) for q in QUERIES]
    for a, b, c in zip(untraced, traced, direct):
        for x, y, z in zip(a, b, c):
            assert np.array_equal(x, y) and np.array_equal(y, z)


class _Held:
    """A dispatched search whose result waits for ``release``."""

    def __init__(self, release):
        self.release = release

    def materialize(self):
        assert self.release.wait(T)
        return np.zeros((1, 1)), np.zeros((1, 1), np.int64)


def _wait_for(cond):
    for _ in range(T * 100):
        if cond():
            return
        threading.Event().wait(0.01)
    raise AssertionError("timed out")


def test_window_wait_is_recorded_only_when_the_window_is_full(tracer):
    release = threading.Event()
    beats = []
    mb = MicroBatcher(lambda q, k, g: None, max_batch=1, max_wait_ms=0,
                      pipeline_depth=2,
                      dispatch_fn=lambda q, k, g: _Held(release),
                      heartbeat=lambda: beats.append(1))
    try:
        futs = [mb.submit(["a"], 1)]
        _wait_for(lambda: mb.inflight_batches() == 1)
        futs.append(mb.submit(["b"], 1))
        _wait_for(lambda: mb.inflight_batches() == 2)
        # the window is full: the third batch waits for a slot
        futs.append(mb.submit(["c"], 1))
        _wait_for(lambda: mb.queued_queries() == 0)
        # the window wait beats every 50 ms: two beats, and it is waiting
        seen = len(beats)
        _wait_for(lambda: len(beats) >= seen + 2)
        release.set()
        for f in futs:
            f.result(timeout=T)
    finally:
        release.set()
        mb.close()
    batcher = _lanes(tracer)["batcher"]
    waits = _named(batcher, "window_wait")
    assert len(waits) == 1
    # it precedes the third batch's issue, the last one
    issues = _named(batcher, "issue")
    assert len(issues) == 3 and waits[0][2] <= issues[2][1]


def test_trace_check_passes_a_served_trace(retriever, tracer, tmp_path):
    _serve(retriever, QUERIES)
    path = obs.export(str(tmp_path / "serve.json"))
    p = subprocess.run([sys.executable,
                        os.path.join(REPO, "tools", "trace_check.py"), path,
                        "--mode", "serve", "--min-threads", "2"],
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr


def test_search_loop_makes_no_span_and_checks_once(retriever, monkeypatch):
    made, checks = [], []
    for cls in (ttracer._Span, ttracer._DeviceSpan):
        real = cls.__init__

        def counting(self, *a, _real=real, **kw):
            made.append(type(self).__name__)
            _real(self, *a, **kw)

        monkeypatch.setattr(cls, "__init__", counting)
    real_enabled = obs.enabled

    def enabled():
        checks.append(1)
        return real_enabled()

    monkeypatch.setattr(obs, "enabled", enabled)
    obs.set_tracer(None)
    retriever.search(QUERIES, 3)   # three tiles
    assert made == [] and len(checks) == 1
    _serve(retriever, QUERIES[:2])
    assert made == [] and len(checks) == 3


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans") / "input"
    root.mkdir()
    for name, doc in zip(*(lambda c: (c.names, c.docs))(_corpus(n=9))):
        (root / name).write_bytes(doc + b"\n")
    return str(root)


def _ingest(corpus_dir, wire):
    cfg = PipelineConfig(vocab_mode=VocabMode.HASHED, topk=4,
                         vocab_size=1 << 12, wire=wire)
    return run_overlapped(corpus_dir, cfg, doc_len=16, chunk_docs=2,
                          device="cpu")


@pytest.mark.parametrize("regime", ["resident", "streaming"])
@pytest.mark.parametrize("wire", ["ragged", "padded", "bytes"])
def test_ingest_spans_nest_and_results_match(corpus_dir, monkeypatch,
                                             regime, wire):
    assert fast_tokenizer.available(), fast_tokenizer.load_error()
    if regime == "streaming":
        monkeypatch.setenv("TFIDF_TPU_RESIDENT_ELEMS", "1")
    plain = _ingest(corpus_dir, wire)
    t = obs.Tracer()
    obs.set_tracer(t)
    try:
        traced = _ingest(corpus_dir, wire)
    finally:
        obs.set_tracer(None)
    assert traced.path == plain.path == regime
    for field in ("df", "topk_vals", "topk_ids", "lengths"):
        assert np.array_equal(getattr(plain, field), getattr(traced, field))
    lanes = _lanes(t)
    packer = [e for lane, evs in lanes.items() if lane == "packer"
              for e in evs]
    packs = _named(packer, "pack")
    assert packs
    for step in ("pack_read", "pack_tokenize"):
        inner = _named(packer, step)
        assert len(inner) == len(packs)
        assert all(any(_inside(e, p) for p in packs) for e in inner)
    reads = _named(packer, "pack_read")
    assert {e[3]["files"] for e in reads} <= {1, 2} and all(
        e[3]["threads"] >= 1 for e in reads)
    main = lanes["main"]
    (setup,), (gather,) = _named(main, "pass_setup"), _named(main, "gather")
    waits = _named(main, "pack_wait")
    assert setup[2] <= waits[0][1]
    assert all(e[2] <= gather[1] for e in main
               if e[0] in ("pack_wait", "dispatch", "phase_b", "fetch",
                           "fetch_wait"))


def _lane_thread(name, stop):
    """A thread that records on its own lane, then waits for ``stop``."""
    def body():
        obs.instant("lane")
        stop.wait(T)
    th = threading.Thread(target=body, name=name)
    th.start()
    return th


def test_gc_hook_only_while_a_tracer_is_armed(tmp_path, monkeypatch):
    obs.set_tracer(None)
    assert ttracer._gc_hook not in gc.callbacks
    t = obs.Tracer()
    obs.set_tracer(t)
    obs.set_tracer(t)  # re-arming keeps one hook
    assert gc.callbacks.count(ttracer._gc_hook) == 1
    stop = threading.Event()
    gone = _lane_thread("gone", stop)
    stop.set()
    gone.join(T)
    assert not gone.is_alive()
    held = threading.Event()
    live = _lane_thread("live", held)
    obs.instant("lane")
    try:
        _wait_for(lambda: len(t.events()) == 3)
        gc.collect(1)   # a younger generation records nothing
        assert [e for e in t.events() if e[0] == "gc_full"] == []
        gc.collect()
    finally:
        held.set()
        live.join(T)
    full = [e for e in t.events() if e[0] == "gc_full"]
    # the lanes of the threads alive through it, not the finished one
    assert sorted(t.thread_label(e[1]) for e in full) == ["live", "main"]
    assert all(set(e[4]) == {"collected", "uncollectable"} and e[3] >= 0
               for e in full)
    obs.set_tracer(None)
    assert ttracer._gc_hook not in gc.callbacks
    gc.collect()
    assert len([e for e in t.events() if e[0] == "gc_full"]) == len(full)
    # configure arms it too
    monkeypatch.delenv("TFIDF_TPU_TRACE", raising=False)
    obs.configure(str(tmp_path / "t.json"))
    try:
        assert gc.callbacks.count(ttracer._gc_hook) == 1
    finally:
        obs.set_tracer(None)
    assert ttracer._gc_hook not in gc.callbacks


def test_gc_full_skips_the_lanes_of_finished_threads(tracer):
    # one short-lived thread a connection, as ``serve --port`` starts
    for i in range(200):
        stop = threading.Event()
        th = _lane_thread(f"conn{i}", stop)
        stop.set()
        th.join(T)
    obs.instant("lane")
    assert len(tracer.events()) == 201
    gc.collect()
    gc.collect()
    full = [e for e in tracer.events() if e[0] == "gc_full"]
    # one event a collection, on main alone; the dead lanes are dropped
    assert [tracer.thread_label(e[1]) for e in full] == ["main", "main"]
    assert list(tracer._threads) == [tracer._tid()]
    # the finished threads' lanes keep their names in the export
    names = {e["args"]["name"] for e in tracer.chrome_events()
             if e["name"] == "thread_name"}
    assert {"main", "conn0", "conn199"} <= names


def test_steps_records_consecutive_spans_on_the_callers_lane(tracer):
    obs.steps(("a", "b", "c"), (10, 15, 15, 40))
    tid = tracer._tid()
    assert tracer.events() == [("a", tid, 10, 5, None),
                               ("b", tid, 15, 0, None),
                               ("c", tid, 15, 25, None)]
    obs.set_tracer(None)
    obs.steps(("a",), (1, 2))   # no tracer: nothing, no error
    assert len(tracer.events()) == 3


@pytest.mark.parametrize("args,label", [
    ({"batch": 7, "queries": 3}, "issue 7"),
    ({"chunk": 2}, "issue 2"),
    ({"docs": 4}, "issue"),
])
def test_device_span_opens_a_profiler_range(tracer, args, label):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.device_span("issue", **args):
            torch.ones(4).sum()
    assert label in {e.name for e in prof.events()}
    assert [(e[0], e[4]) for e in tracer.events()] == [("issue", args)]
