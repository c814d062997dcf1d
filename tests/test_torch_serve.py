"""The serving layer in the port (tfidf_tpu_torch/serve: TfidfServer,
MicroBatcher, ResultCache, the supervisor and the canary) on the CPU.

* Against the JAX package: one seeded corpus indexed by both packages'
  retrievers, one ``TfidfServer`` of each at the same ``ServeConfig``,
  the same scripted requests (mixed sizes, k, scorers, filters). The
  responses agree under ``parity.compare_search`` (ids exact but for
  near-ties, scores within 1e-6, BM25 within 1e-6 plus 4 float32 ulp),
  and snapshots written by either package's server serve in the other.
* Within the port: a served response equals a direct ``search`` of the
  same queries on the same index bit for bit, at pipeline depth 1, 2
  and 4, under coalescing, caching, concurrency and hot swaps; overload,
  deadlines, swap, drain-on-close, poison bisection, retries, the
  breaker, health and the canary behave as the JAX package's tests pin
  them; a segmented server's responses after ``add_docs`` /
  ``delete_docs`` equal ``rebuild_retriever().search``.

Every ``Future.result`` and ``Thread.join`` has a timeout, every server
is closed in a ``finally`` or a ``with``, and no assertion reads wall
time.
"""

import threading
import time

import numpy as np
import pytest

from tfidf_tpu import faults as jfaults
from tfidf_tpu.config import PipelineConfig as JConfig
from tfidf_tpu.config import ServeConfig as JServeConfig
from tfidf_tpu.config import VocabMode as JVocab
from tfidf_tpu.io.corpus import Corpus as JCorpus
from tfidf_tpu.models import TfidfRetriever as JRetriever
from tfidf_tpu.obs import log as jlog
from tfidf_tpu.serve import TfidfServer as JServer

from tfidf_tpu_torch import faults, obs
from tfidf_tpu_torch.config import PipelineConfig, ServeConfig, VocabMode
from tfidf_tpu_torch.index import SegmentedIndex
from tfidf_tpu_torch.io.corpus import Corpus
from tfidf_tpu_torch.models import TfidfRetriever
from tfidf_tpu_torch.obs import devmon
from tfidf_tpu_torch.obs.health import set_monitor
from tfidf_tpu_torch.obs.log import EventLog
from tfidf_tpu_torch.parity import compare_search
from tfidf_tpu_torch.serve import (CanaryProber, DeadlineExceeded,
                                   MicroBatcher, Overloaded, PoisonQuery,
                                   ServeError, ServeMetrics, ServerClosed,
                                   TfidfServer)

T = 30  # seconds: the timeout of every wait in this file

CFG = PipelineConfig(vocab_mode=VocabMode.HASHED, vocab_size=512,
                     max_doc_len=16, doc_chunk=16)
CORPUS = Corpus(
    names=["doc1", "doc2", "doc3", "doc4", "doc5"],
    docs=[b"apple banana apple cherry",
          b"banana banana date",
          b"cherry date elder fig",
          b"apple fig fig fig",
          b"grape grape grape grape"])
CORPUS_B = Corpus(
    names=["doc1", "doc2", "doc3"],
    docs=[b"zebra yak apple",
          b"yak yak quokka",
          b"quokka zebra grape"])
QUERIES = ["apple cherry", "banana", "grape date", "fig", "elder",
           "apple fig", "date banana cherry"]

# The seeded corpus both packages index.
SEED_DOCS = 256
SEED_KW = dict(vocab_size=2048, max_doc_len=32, doc_chunk=32)
WORDS = [f"w{i}" for i in range(400)]


def _seeded_corpus(seed=11, n=SEED_DOCS):
    rng = np.random.default_rng(seed)
    ranks = np.clip(rng.zipf(1.3, n * 24), 1, len(WORDS)) - 1
    lens = rng.integers(1, 25, n)
    offs = np.concatenate([[0], np.cumsum(lens)])
    docs = [" ".join(WORDS[r] for r in ranks[offs[i]:offs[i + 1]]).encode()
            for i in range(n)]
    return [f"doc{i}" for i in range(1, n + 1)], docs


def _seeded_queries(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = int(rng.integers(1, 6))
        ranks = np.clip(rng.zipf(1.3, m), 1, len(WORDS)) - 1
        out.append(" ".join(WORDS[r] for r in ranks))
    return out


@pytest.fixture(scope="module")
def retriever():
    return TfidfRetriever(CFG, device="cpu").index(CORPUS)


@pytest.fixture(scope="module")
def seeded():
    names, docs = _seeded_corpus()
    t = TfidfRetriever(PipelineConfig(vocab_mode=VocabMode.HASHED,
                                      **SEED_KW),
                       device="cpu").index(Corpus(names=names, docs=docs))
    j = JRetriever(JConfig(vocab_mode=JVocab.HASHED, **SEED_KW)).index(
        JCorpus(names=names, docs=docs))
    return t, j


@pytest.fixture(autouse=True)
def _clean_faults_and_obs():
    obs.set_log(EventLog(echo="off"))
    jlog.set_log(jlog.EventLog(echo="off"))
    faults.disarm()
    jfaults.disarm()
    set_monitor(None)
    yield
    faults.disarm()
    jfaults.disarm()
    set_monitor(None)
    devmon.set_watch(None)
    obs.set_log(None)
    jlog.set_log(None)


def quick_cfg(**kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_ms", 5)
    kw.setdefault("queue_depth", 64)
    kw.setdefault("cache_entries", 64)
    return ServeConfig(**kw)


def assert_identical(got, want):
    gv, gi = got
    wv, wi = want
    gv, wv = np.asarray(gv, np.float32), np.asarray(wv, np.float32)
    np.testing.assert_array_equal(gv.view(np.uint32), wv.view(np.uint32))
    np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))


# ---------------------------------------------------------------------
# Against the JAX package

# Scripted request groups: (queries seed, sizes, k, scorer, filter).
SCRIPTS = {
    "tfidf": [(1, 1, 5, None, None), (2, 3, 10, None, None),
              (3, 7, 4, None, None), (4, 2, 1, None, None)],
    "bm25": [(5, 4, 10, "bm25", None), (6, 1, 3, "bm25", None)],
    "bm25_params": [(7, 5, 8, "bm25:k1=1.5,b=0.6", None),
                    (8, 2, 10, {"kind": "bm25", "k1": 0.9, "b": 0.3},
                     None)],
    "id_range": [(9, 6, 10, None, {"id_range": [0, 128]}),
                 (10, 3, 5, "bm25", {"id_range": [64, 200]})],
    "ids": [(11, 4, 6, None, {"ids": [1, 5, 9, 30, 31, 100, 250]})],
    "prefix": [(12, 5, 10, None, {"prefix": "doc1"}),
               (13, 3, 4, "bm25", {"prefix": "doc2"})],
    "mixed_k": [(14, 1, 1, None, None), (15, 1, 2, None, None),
                (16, 8, 16, None, None), (17, 16, 10, None, None)],
}


def _served(srv, script):
    futs = []
    for qseed, n, k, scorer, flt in script:
        qs = _seeded_queries(qseed, n)
        futs.append((qs, k, scorer, flt,
                     srv.submit(qs, k, scorer=scorer, filter=flt)))
    return [(qs, k, scorer, flt, f.result(timeout=T))
            for qs, k, scorer, flt, f in futs]


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_port_server_agrees_with_the_jax_server(seeded, script, depth):
    t, j = seeded
    kw = dict(max_batch=8, max_wait_ms=5, queue_depth=256,
              cache_entries=64, pipeline_depth=depth)
    tsrv = TfidfServer(t, ServeConfig(**kw))
    jsrv = JServer(j, JServeConfig(**kw))
    try:
        got = _served(tsrv, SCRIPTS[script])
        want = _served(jsrv, SCRIPTS[script])
        # and once more: the second pass is served from both caches
        got += _served(tsrv, SCRIPTS[script])
        want += _served(jsrv, SCRIPTS[script])
    finally:
        tsrv.close()
        jsrv.close()
    for (qs, k, scorer, flt, a), (_, _, _, _, b) in zip(got, want):
        bm25 = scorer is not None and "bm25" in str(scorer)
        cmp = compare_search(a[0], a[1], b[0], b[1],
                             val_ulps=4 if bm25 else 0)
        assert cmp["ok"], (script, qs, k, cmp)
        assert np.asarray(a[1]).shape == (len(qs), min(k, SEED_DOCS))
        # and within the port, bit for bit against a direct search
        assert_identical(a, t.search(qs, k, scorer=scorer, filter=flt))


def test_port_and_jax_servers_report_the_same_schema(seeded):
    t, j = seeded
    tsrv = TfidfServer(t, ServeConfig(max_wait_ms=1))
    jsrv = JServer(j, JServeConfig(max_wait_ms=1))
    try:
        for srv in (tsrv, jsrv):
            srv.search(_seeded_queries(1, 3), k=5, timeout=T)
        ts, js = tsrv.metrics_snapshot(), jsrv.metrics_snapshot()
        assert set(ts) == set(js)
        for key in ("shed", "cache", "batch", "queue", "latency_s"):
            assert set(ts[key]) == set(js[key])
        assert ts["fingerprint"]["config_sha"] == \
            js["fingerprint"]["config_sha"]
        assert ts["fingerprint"]["backend"] == "cpu"
        assert set(tsrv.healthz()) == set(jsrv.healthz())
        assert set(tsrv.readyz()) == set(jsrv.readyz())
        te, je = tsrv.obs_export(), jsrv.obs_export()
        assert set(te) == set(je) and te["schema"] == je["schema"]
        tnames = {line.split()[2] for line in
                  tsrv.metrics_prom().splitlines()
                  if line.startswith("# TYPE")}
        jnames = {line.split()[2] for line in
                  jsrv.metrics_prom().splitlines()
                  if line.startswith("# TYPE")}
        assert tnames == jnames
    finally:
        tsrv.close()
        jsrv.close()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_server_snapshots_cross_the_packages(seeded, tmp_path, direction):
    t, j = seeded
    snap = str(tmp_path / "snap")
    qs = _seeded_queries(21, 6)
    tcfg = PipelineConfig(vocab_mode=VocabMode.HASHED, **SEED_KW)
    jcfg = JConfig(vocab_mode=JVocab.HASHED, **SEED_KW)
    if direction == "jax_to_port":
        with JServer(j, JServeConfig(snapshot_dir=snap)) as src:
            src.swap_index(j)                 # snapshots epoch 1 first
            assert src.snapshot() == snap
            want = src.search(qs, k=7, timeout=T)
        r, meta = TfidfRetriever.restore(snap, tcfg, device="cpu")
        dst = TfidfServer(r, ServeConfig(), initial_epoch=meta["epoch"])
    else:
        with TfidfServer(t, ServeConfig(snapshot_dir=snap)) as src:
            src.swap_index(t)
            assert src.snapshot() == snap
            want = src.search(qs, k=7, timeout=T)
        r, meta = JRetriever.restore(snap, jcfg)
        dst = JServer(r, JServeConfig(), initial_epoch=meta["epoch"])
    try:
        assert meta["epoch"] == 1 and dst.epoch == 1
        got = dst.search(qs, k=7, timeout=T)
    finally:
        dst.close()
    assert compare_search(*got, *want)["ok"]
    assert dst.doc_names() == t.names


# ---------------------------------------------------------------------
# Within the port: the MicroBatcher

class TestMicroBatcher:
    def _searcher(self, retriever, calls=None):
        def fn(queries, k, group):
            if calls is not None:
                calls.append(list(queries))
            return retriever.search(queries, k)
        return fn

    def test_single_request_parity(self, retriever):
        b = MicroBatcher(self._searcher(retriever), max_batch=8,
                         max_wait_ms=1)
        try:
            got = b.submit(QUERIES[:3], k=4).result(timeout=T)
            assert_identical(got, retriever.search(QUERIES[:3], k=4))
        finally:
            b.close()

    def test_coalesces_concurrent_submits(self, retriever):
        calls = []
        m = ServeMetrics()
        b = MicroBatcher(self._searcher(retriever, calls), max_batch=64,
                         max_wait_ms=250, metrics=m)
        try:
            futs = [b.submit([q], k=3) for q in QUERIES[:3]]
            for f, q in zip(futs, QUERIES[:3]):
                assert_identical(f.result(timeout=T),
                                 retriever.search([q], k=3))
        finally:
            b.close()
        assert len(calls) == 1 and len(calls[0]) == 3
        snap = m.snapshot()["batch"]
        assert snap["count"] == 1 and snap["mean_occupancy"] == 0.75

    def test_full_batch_flushes_before_the_window(self, retriever):
        calls = []
        b = MicroBatcher(self._searcher(retriever, calls), max_batch=2,
                         max_wait_ms=60_000)
        try:
            f1 = b.submit([QUERIES[0]], k=2)
            f2 = b.submit([QUERIES[1]], k=2)
            f1.result(timeout=T)
            f2.result(timeout=T)
        finally:
            b.close()
        assert [len(c) for c in calls] == [2]

    @pytest.mark.parametrize("kind", ["k", "group"])
    def test_mixed_keys_never_share_a_batch(self, retriever, kind):
        calls = []
        b = MicroBatcher(self._searcher(retriever, calls), max_batch=64,
                         max_wait_ms=100)
        try:
            if kind == "k":
                fa = b.submit([QUERIES[0]], k=2)
                fb = b.submit([QUERIES[1]], k=3)
            else:
                fa = b.submit([QUERIES[0]], k=2, group="epoch0")
                fb = b.submit([QUERIES[1]], k=2, group="epoch1")
            fa.result(timeout=T)
            fb.result(timeout=T)
        finally:
            b.close()
        assert len(calls) == 2

    def test_oversize_request_stays_atomic(self, retriever):
        calls = []
        b = MicroBatcher(self._searcher(retriever, calls), max_batch=2,
                         max_wait_ms=5)
        try:
            got = b.submit(QUERIES, k=3).result(timeout=T)
            assert_identical(got, retriever.search(QUERIES, k=3))
        finally:
            b.close()
        assert [len(c) for c in calls] == [len(QUERIES)]

    def test_search_error_propagates_to_all_coalesced(self):
        def boom(queries, k, group):
            raise RuntimeError("kernel exploded")
        b = MicroBatcher(boom, max_batch=64, max_wait_ms=100)
        try:
            futs = [b.submit(["x"], k=1) for _ in range(3)]
            for f in futs:
                with pytest.raises(RuntimeError, match="kernel exploded"):
                    f.result(timeout=T)
        finally:
            b.close()

    def test_expired_deadline_sheds_before_device(self, retriever):
        calls = []
        m = ServeMetrics()
        b = MicroBatcher(self._searcher(retriever, calls), max_batch=8,
                         max_wait_ms=20, metrics=m)
        try:
            f = b.submit([QUERIES[0]], k=2, deadline=time.monotonic())
            with pytest.raises(DeadlineExceeded):
                f.result(timeout=T)
        finally:
            b.close()
        assert calls == []
        assert m.snapshot()["shed"]["deadline"] == 1

    def test_close_drains_queued_work(self, retriever):
        b = MicroBatcher(self._searcher(retriever), max_batch=1024,
                         max_wait_ms=60_000)
        futs = [b.submit([q], k=2) for q in QUERIES[:3]]
        b.close(drain=True)
        for f, q in zip(futs, QUERIES[:3]):
            assert_identical(f.result(timeout=0),
                             retriever.search([q], k=2))

    def test_close_without_drain_fails_pending(self, retriever):
        b = MicroBatcher(self._searcher(retriever), max_batch=1024,
                         max_wait_ms=60_000)
        f = b.submit([QUERIES[0]], k=2)
        b.close(drain=False)
        with pytest.raises(ServeError):
            f.result(timeout=T)

    def test_submit_after_close_raises(self, retriever):
        b = MicroBatcher(self._searcher(retriever))
        b.close()
        with pytest.raises(ServeError):
            b.submit(["x"], k=1)


def _rows(queries, k=2):
    h = [sum(q.encode()) % 251 for q in queries]
    vals = np.stack([np.arange(k, dtype=np.float32) + x for x in h])
    ids = np.stack([(np.arange(k) + x) % 5 for x in h])
    return vals, ids


class _FakePending:
    """Dispatch returns at once; materialize blocks on a delay or gate."""

    def __init__(self, queries, k, delay=0.0, gate=None):
        self._queries, self._k = list(queries), k
        self._delay, self._gate = delay, gate

    def materialize(self):
        if self._gate is not None:
            assert self._gate.wait(timeout=T), "gate never opened"
        if self._delay:
            time.sleep(self._delay)
        return _rows(self._queries, self._k)


def _fake_batcher(depth, delays=None, gates=None, **kw):
    seq = []

    def dispatch(queries, k, group):
        i = len(seq)
        seq.append(list(queries))
        delay = delays[i % len(delays)] if delays else 0.0
        gate = gates[i] if gates is not None else None
        return _FakePending(queries, k, delay=delay, gate=gate)

    return MicroBatcher(lambda q, k, g: _rows(q, k), pipeline_depth=depth,
                        dispatch_fn=dispatch, **kw)


class TestPipelineWindow:
    @pytest.mark.parametrize("depth", [2, 4])
    def test_batch_major_resolution_under_jittered_device(self, depth):
        rng = np.random.default_rng(22)
        delays = [float(d) for d in rng.uniform(0, 0.01, size=12)]
        b = _fake_batcher(depth, delays=delays, max_batch=4, max_wait_ms=1)
        done = []
        try:
            futs = []
            for i in range(12):
                f = b.submit([QUERIES[i % len(QUERIES)]], k=2, group=i)
                f.add_done_callback(lambda fut, i=i: done.append(i))
                futs.append(f)
            for i, f in enumerate(futs):
                assert_identical(f.result(timeout=T),
                                 _rows([QUERIES[i % len(QUERIES)]], 2))
        finally:
            b.close()
        assert done == sorted(done) and len(done) == 12

    def test_close_drains_window_to_zero(self):
        gates = [threading.Event() for _ in range(3)]
        b = _fake_batcher(2, gates=gates, max_batch=4, max_wait_ms=1)
        futs = [b.submit([QUERIES[i]], k=2, group=i) for i in range(3)]
        deadline = time.monotonic() + T
        while b.inflight_batches() < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert b.inflight_batches() == 2     # the window caps at depth
        opener = threading.Thread(
            target=lambda: [g.set() for g in gates], daemon=True)
        opener.start()
        b.close(drain=True)
        opener.join(timeout=T)
        assert b.inflight_batches() == 0
        for i, f in enumerate(futs):
            assert_identical(f.result(timeout=0), _rows([QUERIES[i]], 2))


# ---------------------------------------------------------------------
# Within the port: the server

class TestTfidfServer:
    @pytest.mark.parametrize("depth", [1, 2, 4])
    def test_served_equals_direct_search(self, retriever, depth):
        with TfidfServer(retriever, quick_cfg(pipeline_depth=depth,
                                              cache_entries=0)) as srv:
            for size in (1, 2, 3, 5, 7):
                qs = QUERIES[:size]
                assert_identical(srv.search(qs, k=4, timeout=T),
                                 retriever.search(qs, k=4))
            futs = [srv.submit([q], k=3) for q in QUERIES]
            for f, q in zip(futs, QUERIES):
                assert_identical(f.result(timeout=T),
                                 retriever.search([q], k=3))

    @pytest.mark.parametrize("depth", [1, 2])
    @pytest.mark.parametrize("setting", [
        {"scorer": "bm25"}, {"scorer": "bm25:k1=1.5,b=0.6"},
        {"filter": {"id_range": [1, 4]}},
        {"scorer": "bm25", "filter": {"ids": [0, 3]}},
        {"filter": {"prefix": "doc"}}])
    def test_scorers_and_filters_served_equal(self, retriever, depth,
                                              setting):
        with TfidfServer(retriever, quick_cfg(pipeline_depth=depth)) as srv:
            for size in (1, 4, 7):
                qs = QUERIES[:size]
                want = retriever.search(qs, k=3, **setting)
                assert_identical(srv.search(qs, k=3, timeout=T, **setting),
                                 want)
                # the cached second answer is the same bits
                assert_identical(srv.search(qs, k=3, timeout=T, **setting),
                                 want)

    @pytest.mark.parametrize("depth", [1, 2])
    def test_stress_concurrent_parity(self, retriever, depth):
        srv = TfidfServer(retriever, quick_cfg(max_wait_ms=2,
                                               pipeline_depth=depth))
        results, errors = {}, []

        def work(tid):
            try:
                rng = np.random.default_rng(tid)
                out = []
                for _ in range(5):
                    qs = [QUERIES[i] for i in rng.integers(
                        0, len(QUERIES), size=int(rng.integers(1, 6)))]
                    scorer = "bm25" if tid % 3 == 0 else None
                    out.append((qs, scorer, srv.search(
                        qs, k=3, timeout=T, scorer=scorer)))
                results[tid] = out
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(8)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=T)
        finally:
            srv.close()
        assert not errors and len(results) == 8
        for out in results.values():
            for qs, scorer, got in out:
                assert_identical(got, retriever.search(qs, k=3,
                                                       scorer=scorer))

    def test_cache_hit_is_bit_identical_and_counted(self, retriever):
        with TfidfServer(retriever, quick_cfg()) as srv:
            first = srv.search(QUERIES[:2], k=3, timeout=T)
            before = srv.metrics_snapshot()["cache"]
            second = srv.search(QUERIES[:2], k=3, timeout=T)
            after = srv.metrics_snapshot()["cache"]
        assert_identical(second, first)
        assert_identical(second, retriever.search(QUERIES[:2], k=3))
        assert after["hits"] == before["hits"] + 2
        assert after["misses"] == before["misses"]

    def test_partial_cache_hit_assembles_exactly(self, retriever):
        with TfidfServer(retriever, quick_cfg()) as srv:
            srv.search([QUERIES[0]], k=3, timeout=T)
            got = srv.search(QUERIES[:3], k=3, timeout=T)
            hits = srv.metrics_snapshot()["cache"]["hits"]
        assert_identical(got, retriever.search(QUERIES[:3], k=3))
        assert hits >= 1

    def test_overload_sheds_with_typed_error(self, retriever):
        srv = TfidfServer(retriever, quick_cfg(
            queue_depth=2, max_batch=1024, max_wait_ms=5_000,
            cache_entries=0))
        try:
            f1 = srv.submit([QUERIES[0]], k=2)
            f2 = srv.submit([QUERIES[1]], k=2)
            with pytest.raises(Overloaded):
                srv.submit([QUERIES[2]], k=2)
            assert srv.metrics_snapshot()["shed"]["overload"] == 1
        finally:
            srv.close(drain=True)
        assert_identical(f1.result(timeout=0),
                         retriever.search([QUERIES[0]], k=2))
        assert_identical(f2.result(timeout=0),
                         retriever.search([QUERIES[1]], k=2))

    def test_inflight_releases_after_completion(self, retriever):
        with TfidfServer(retriever, quick_cfg(queue_depth=2,
                                              cache_entries=0)) as srv:
            srv.search([QUERIES[0]], k=2, timeout=T)
            srv.search([QUERIES[1]], k=2, timeout=T)
            assert srv.metrics_snapshot()["queue"]["depth"] == 0

    def test_deadline_shed_is_typed_and_counted(self, retriever):
        with TfidfServer(retriever, quick_cfg(cache_entries=0)) as srv:
            f = srv.submit([QUERIES[0]], k=2, deadline_ms=0)
            with pytest.raises(DeadlineExceeded):
                f.result(timeout=T)
            assert srv.metrics_snapshot()["shed"]["deadline"] == 1

    def test_default_deadline_from_config(self, retriever):
        with TfidfServer(retriever, quick_cfg(default_deadline_ms=0,
                                              cache_entries=0)) as srv:
            with pytest.raises(DeadlineExceeded):
                srv.search([QUERIES[0]], k=2, timeout=T)

    @pytest.mark.parametrize("depth", [1, 2])
    def test_swap_index_serves_new_corpus(self, retriever, depth):
        new = TfidfRetriever(CFG, device="cpu").index(CORPUS_B)
        with TfidfServer(retriever, quick_cfg(pipeline_depth=depth)) as srv:
            assert_identical(srv.search(["zebra yak"], k=2, timeout=T),
                             retriever.search(["zebra yak"], k=2))
            assert srv.swap_index(new) == 1 and srv.epoch == 1
            assert_identical(srv.search(["zebra yak"], k=2, timeout=T),
                             new.search(["zebra yak"], k=2))
            assert srv.num_docs == 3 and srv.doc_names() == CORPUS_B.names

    def test_swap_pins_admitted_epoch(self, retriever):
        new = TfidfRetriever(CFG, device="cpu").index(CORPUS_B)
        with TfidfServer(retriever, quick_cfg(pipeline_depth=2,
                                              max_wait_ms=100,
                                              cache_entries=0)) as srv:
            futs = [srv.submit([q], k=2) for q in QUERIES[:4]]
            assert srv.swap_index(new) == 1
            for f, q in zip(futs, QUERIES[:4]):
                assert_identical(f.result(timeout=T),
                                 retriever.search([q], k=2))
                assert f.epoch == 0
            assert_identical(srv.search(["zebra yak"], k=2, timeout=T),
                             new.search(["zebra yak"], k=2))

    def test_swap_invalidates_cache(self, retriever):
        twin = TfidfRetriever(CFG, device="cpu").index(CORPUS)
        with TfidfServer(retriever, quick_cfg()) as srv:
            first = srv.search(QUERIES[:2], k=3, timeout=T)
            srv.swap_index(twin)
            before = srv.metrics_snapshot()["cache"]
            again = srv.search(QUERIES[:2], k=3, timeout=T)
            after = srv.metrics_snapshot()["cache"]
        assert after["misses"] == before["misses"] + 2
        assert after["hits"] == before["hits"]
        assert_identical(again, first)

    @pytest.mark.parametrize("depth", [1, 2])
    def test_drain_on_shutdown_resolves_everything(self, retriever, depth):
        srv = TfidfServer(retriever, quick_cfg(max_batch=1024,
                                               max_wait_ms=60_000,
                                               cache_entries=0,
                                               pipeline_depth=depth))
        futs = [srv.submit([q], k=2) for q in QUERIES[:4]]
        srv.close(drain=True)
        for f, q in zip(futs, QUERIES[:4]):
            assert_identical(f.result(timeout=0),
                             retriever.search([q], k=2))
        with pytest.raises(ServerClosed):
            srv.submit(["x"], k=1)
        with pytest.raises(ServerClosed):
            srv.swap_index(retriever)
        assert srv.closed and not srv.readyz()["ready"]

    def test_close_without_drain_fails_queued(self, retriever):
        srv = TfidfServer(retriever, quick_cfg(max_batch=1024,
                                               max_wait_ms=60_000,
                                               cache_entries=0))
        f = srv.submit([QUERIES[0]], k=2)
        srv.close(drain=False)
        with pytest.raises(ServeError):
            f.result(timeout=T)

    def test_metrics_snapshot_schema(self, retriever):
        with TfidfServer(retriever, quick_cfg()) as srv:
            srv.search(QUERIES[:2], k=3, timeout=T)
            snap = srv.metrics_snapshot()
        assert snap["requests"] == 1 and snap["queries"] == 2
        assert {"overload", "deadline", "rate"} <= snap["shed"].keys()
        assert {"hits", "misses", "hit_rate"} <= snap["cache"].keys()
        assert {"count", "mean_occupancy"} <= snap["batch"].keys()
        assert {"depth", "peak"} <= snap["queue"].keys()
        lat = snap["latency_s"]
        assert lat["count"] == 1 and lat["p99"] >= lat["p50"] > 0
        assert 0 < snap["batch"]["mean_occupancy"] <= 1
        assert snap["slo"] == {"configured": False}
        assert "slow_queries" in snap
        fp = snap["fingerprint"]
        assert fp["backend"] == "cpu" and fp["num_docs"] == 5
        assert fp["vocab_size"] == 512 and len(fp["config_sha"]) == 12

    def test_slo_snapshot(self, retriever):
        with TfidfServer(retriever, quick_cfg(slo_ms=10_000.0)) as srv:
            srv.search(QUERIES[:2], k=3, timeout=T)
            slo = srv.metrics_snapshot()["slo"]
        assert slo["configured"] is True and slo["compliance"] == 1.0
        assert slo["total"] >= 1 and slo["fast_burn"] == 0.0

    def test_empty_request_resolves_immediately(self, retriever):
        with TfidfServer(retriever, quick_cfg()) as srv:
            vals, idx = srv.search([], k=3, timeout=T)
        assert vals.shape == (0, 3) and idx.shape == (0, 3)

    def test_unindexed_rejected(self, retriever):
        with pytest.raises(ValueError):
            TfidfServer(TfidfRetriever(CFG, device="cpu"), quick_cfg())
        with TfidfServer(retriever, quick_cfg()) as srv:
            with pytest.raises(ValueError):
                srv.swap_index(TfidfRetriever(CFG, device="cpu"))

    @pytest.mark.parametrize("kw,item", [
        ({"mesh_shards": 2}, "ROADMAP A9"), ({"mesh_shards": 0}, "ROADMAP A9"),
        ({"replicas": 2, "snapshot_dir": "snap"}, "ROADMAP A8b")])
    def test_not_ported_options_raise(self, retriever, kw, item):
        cfg = ServeConfig(**kw)          # the dataclass accepts them
        if item == "ROADMAP A8b":
            # Ported now (ROADMAP A8b): a TfidfServer accepts replicas
            # and ignores it, as the JAX server does (the replicated
            # tier is ReplicatedFront); answers equal the JAX server's.
            j = JRetriever(JConfig(vocab_mode=JVocab.HASHED, vocab_size=512,
                                   max_doc_len=16, doc_chunk=16)).index(
                JCorpus(names=CORPUS.names, docs=CORPUS.docs))
            with TfidfServer(retriever, cfg) as srv, \
                    JServer(j, JServeConfig(**kw)) as jsrv:
                assert srv.config.replicas == jsrv.config.replicas == 2
                assert srv.current_index()[1] is retriever
                for scorer in (None, "bm25"):
                    got = srv.search(QUERIES, k=3, scorer=scorer, timeout=T)
                    assert_identical(got, retriever.search(QUERIES, k=3,
                                                           scorer=scorer))
                    want = jsrv.search(QUERIES, k=3, scorer=scorer,
                                       timeout=T)
                    cmp = compare_search(got[0], got[1], np.asarray(want[0]),
                                         np.asarray(want[1]),
                                         val_ulps=4 if scorer else 0)
                    assert cmp["ok"], cmp
            return
        # Ported now (ROADMAP A9b): the index is served doc-sharded (0:
        # every device, one CPU shard here), answers unchanged
        from tfidf_tpu_torch.parallel import MeshShardedRetriever
        with TfidfServer(retriever, cfg) as srv:
            _, installed = srv.current_index()
            assert isinstance(installed, MeshShardedRetriever)
            assert installed.n_shards == (kw["mesh_shards"] or 1)
            assert installed.parity_oracle() is retriever
            for scorer in (None, "bm25"):
                assert_identical(
                    srv.search(QUERIES, k=3, scorer=scorer, timeout=T),
                    retriever.search(QUERIES, k=3, scorer=scorer))

    def test_set_scorer_bumps_epoch_and_serves_it(self, retriever):
        with TfidfServer(retriever, quick_cfg()) as srv:
            srv.search(QUERIES[:2], k=3, timeout=T)
            assert srv.set_scorer("bm25") == 1
            assert srv.default_scorer_key() == "bm25:b=0.75,k1=1.2"
            assert_identical(srv.search(QUERIES[:2], k=3, timeout=T),
                             retriever.search(QUERIES[:2], k=3,
                                              scorer="bm25"))

    def test_flight_digests_and_obs_export(self, retriever):
        log = EventLog(echo="off")
        obs.set_log(log)
        with TfidfServer(retriever, quick_cfg()) as srv:
            fut = srv.submit(QUERIES[:2], k=3)
            fut.result(timeout=T)
            bundle = srv.obs_export()
            prom = srv.metrics_prom()
        digests = log.digests()
        assert any(d.get("rid") == fut.rid and d["outcome"] == "drained"
                   for d in digests)
        assert bundle["schema"] == "tfidf-obs/1"
        assert bundle["fingerprint"]["backend"] == "cpu"
        assert bundle["registry"]["serve_requests_total"]["kind"] == \
            "counter"
        assert "serve_request_latency_seconds_bucket" in prom


class TestSurvival:
    @pytest.mark.parametrize("depth", [1, 2, 4])
    def test_poison_bisection(self, retriever, depth):
        faults.arm(faults.FaultPlan.parse(
            "device_dispatch:fatal:match=zzpoison"))
        srv = TfidfServer(retriever, quick_cfg(pipeline_depth=depth,
                                               max_wait_ms=40,
                                               cache_entries=0))
        try:
            futs = {q: srv.submit([q], k=3) for q in
                    [QUERIES[0], "zzpoison attack", QUERIES[1]]}
            with pytest.raises(PoisonQuery) as ei:
                futs["zzpoison attack"].result(timeout=T)
            assert ei.value.queries == ["zzpoison attack"]
            for q in (QUERIES[0], QUERIES[1]):
                assert_identical(futs[q].result(timeout=T),
                                 retriever.search([q], k=3))
            with pytest.raises(PoisonQuery):
                srv.submit(["zzpoison attack"], k=3)
            assert len(srv.quarantine) == 1
        finally:
            srv.close()

    @pytest.mark.parametrize("depth", [1, 2])
    def test_transient_faults_keep_responses_bit_identical(self, retriever,
                                                           depth):
        srv = TfidfServer(retriever, quick_cfg(
            pipeline_depth=depth, cache_entries=0,
            faults="device_dispatch:transient:n=2", retry_backoff_ms=0.0))
        try:
            for size in (1, 3, 5):
                assert_identical(srv.search(QUERIES[:size], k=3,
                                            timeout=T),
                                 retriever.search(QUERIES[:size], k=3))
            prom = srv.metrics_prom()
        finally:
            srv.close()
        assert "serve_dispatch_retries_total 2" in prom
        # the server disarmed its plan on close
        assert not faults.get_registry().armed

    def test_breaker_trips_into_degraded_admission(self, retriever):
        srv = TfidfServer(retriever, quick_cfg(
            faults="device_dispatch:fatal", breaker_threshold=1,
            breaker_cooldown_ms=60_000, dispatch_retries=0,
            cache_entries=0, queue_depth=8))
        try:
            f = srv.submit([QUERIES[0]], k=2)
            with pytest.raises(Exception):
                f.result(timeout=T)
            hz = srv.healthz()
            assert hz["status"] == "degraded"
            assert hz["checks"]["circuit_breaker"] == "open"
            assert hz["admission_bound"] < 8
        finally:
            srv.close(drain=False)

    def test_batcher_loop_restarts_and_serves(self, retriever):
        srv = TfidfServer(retriever, quick_cfg(
            faults="batcher_loop:transient:n=1", restart_budget=3,
            cache_entries=0))
        try:
            assert_identical(srv.search(QUERIES[:2], k=3, timeout=T),
                             retriever.search(QUERIES[:2], k=3))
        finally:
            srv.close()


class TestHealthAndCanary:
    def test_healthz_ok_schema(self, retriever):
        with TfidfServer(retriever, quick_cfg()) as srv:
            srv.search(QUERIES[:1], k=2, timeout=T)
            hz = srv.healthz()
            rz = srv.readyz()
        assert hz["status"] == "ok" and hz["reasons"] == []
        assert hz["admission_bound"] == hz["queue_depth"] == 64
        assert "batcher" in hz["checks"]["workers"]
        assert hz["checks"]["xla_recompiles_after_warm"] == 0
        assert rz == {"ready": True, "status": "ok", "epoch": 0}

    def test_saturation_degrades_and_shrinks_admission(self, retriever):
        srv = TfidfServer(retriever, quick_cfg(
            queue_depth=4, max_batch=1024, max_wait_ms=60_000,
            cache_entries=0))
        try:
            futs = [srv.submit([q], k=2) for q in QUERIES[:4]]
            hz = srv.healthz()
            assert hz["status"] == "degraded"
            assert hz["admission_bound"] == 2
        finally:
            srv.close(drain=True)
        for f in futs:
            f.result(timeout=T)

    def test_canary_parity_one_then_detects_corruption(self, retriever):
        twin = TfidfRetriever(CFG, device="cpu").index(CORPUS)
        srv = TfidfServer(twin, quick_cfg())
        canary = CanaryProber(srv, ["apple cherry", "fig", "banana date"],
                              k=3, period_s=60.0)
        try:
            assert canary.probe() == 1.0
            bad = TfidfRetriever(CFG, device="cpu").index(CORPUS)
            srv.swap_index(bad)            # the oracle re-captures here
            assert canary.probe() == 1.0
            bad._idf[bad._ids[0, 0]] *= 3.0   # corrupt a live DF entry
            bad._faces.clear()
            bad._idf_np = None
            assert canary.probe() < 1.0
        finally:
            canary.close()
            srv.close()

    def test_device_monitor_attaches_the_resident_index(self, retriever):
        with TfidfServer(retriever, quick_cfg(devmon_period_ms=50.0)) as srv:
            snap = srv.devmon.sample()
            census = srv.devmon.census()
            assert "memory_pressure" in srv.healthz()["checks"]
        assert snap["devices"] == [{"device": 0, "kind": "cpu",
                                    "platform": "cpu"}]
        want = sum(t.untyped_storage().nbytes() for t in
                   (retriever._ids, retriever._weights, retriever._head,
                    retriever._idf))
        assert census["owners"]["resident_index"]["bytes"] == want

    def test_build_after_warm_degrades_health(self, retriever):
        with TfidfServer(retriever, quick_cfg()) as srv:
            assert devmon.get_watch() is srv.compile_watch
            srv.mark_warm()
            devmon.note_build("kernels", 2.0, library="libk.so")
            hz = srv.healthz()
            assert hz["checks"]["xla_recompiles_after_warm"] == 1
            assert hz["status"] == "degraded"
        assert devmon.get_watch() is None    # uninstalled on close


# ---------------------------------------------------------------------
# Within the port: a segmented server

def _by_name(names, res):
    vals, ids = res
    return (np.asarray(vals, np.float32).view(np.uint32).tolist(),
            [[names[i] if i >= 0 else None for i in row] for row in ids])


MUTATIONS = [
    ("add", ["new1", "new2"], [b"kiwi apple kiwi", b"lemon lime kiwi"]),
    ("add", ["doc2"], [b"banana kiwi lemon"]),          # an update
    ("delete", ["doc4", "nope"], None),
    ("add", ["new3", "new4", "new5"],
     [b"apple apple", b"fig grape lemon", b"date kiwi"]),
    ("delete", ["new1"], None),
]


@pytest.mark.parametrize("depth", [1, 2])
def test_segmented_server_equals_rebuild(depth):
    idx = SegmentedIndex.from_corpus(CORPUS, CFG, delta_docs=4,
                                     compact_at=2, device="cpu")
    srv = TfidfServer(idx.view(), quick_cfg(pipeline_depth=depth))
    srv.attach_segments(idx)
    queries = QUERIES + ["kiwi", "lemon lime", "apple kiwi"]
    try:
        epoch = srv.epoch
        for kind, names, docs in MUTATIONS:
            out = (srv.add_docs(names, docs) if kind == "add"
                   else srv.delete_docs(names))
            assert out["epoch"] == epoch + 1
            epoch = out["epoch"]
            oracle = idx.rebuild_retriever()
            _, view = srv.current_index()
            for kw in ({}, {"scorer": "bm25"}):
                got = srv.search(queries, k=4, timeout=T, **kw)
                want = oracle.search(queries, k=4, **kw)
                assert _by_name(view.names, got) == \
                    _by_name(oracle.names, want)
        summary = srv.compact_now(force=True)
        assert summary is not None and summary["epoch"] == epoch + 1
        oracle = idx.rebuild_retriever()
        _, view = srv.current_index()
        assert _by_name(view.names, srv.search(queries, k=4, timeout=T)) \
            == _by_name(oracle.names, oracle.search(queries, k=4))
        assert srv.delete_docs(["absent"])["epoch"] == summary["epoch"]
        snap = srv.metrics_snapshot()
        assert snap["epoch"] == summary["epoch"]
        assert "serve_segment_count" in srv.metrics_prom()
        census = srv._index_arrays()
        assert census and all(hasattr(t, "untyped_storage")
                              for t in census)
    finally:
        srv.close()


def test_swap_to_a_plain_retriever_detaches_segments(retriever):
    idx = SegmentedIndex.from_corpus(CORPUS, CFG, delta_docs=4,
                                     device="cpu")
    with TfidfServer(idx.view(), quick_cfg()) as srv:
        srv.attach_segments(idx)
        srv.swap_index(retriever)
        with pytest.raises(RuntimeError, match="no segmented index"):
            srv.add_docs(["x"], [b"y"])
        assert srv.compact_now() is None


def test_mutation_without_segments_raises(retriever):
    with TfidfServer(retriever, quick_cfg()) as srv:
        with pytest.raises(RuntimeError, match="no segmented index"):
            srv.delete_docs(["doc1"])


# ---------------------------------------------------------------------
# ServeConfig: the JAX package's fields, validation and env mirrors

def test_serve_config_fields_and_defaults_equal():
    import dataclasses
    tf = {f.name: f.default for f in dataclasses.fields(ServeConfig)}
    jf = {f.name: f.default for f in dataclasses.fields(JServeConfig)}
    assert tf == jf


ENV_CASES = [
    {"TFIDF_TPU_MAX_BATCH": "16", "TFIDF_TPU_MAX_WAIT_MS": "7.5",
     "TFIDF_TPU_QUEUE_DEPTH": "99", "TFIDF_TPU_CACHE_ENTRIES": "3"},
    {"TFIDF_TPU_HEALTH_PERIOD_MS": "0", "TFIDF_TPU_DEVMON_PERIOD_MS": "250"},
    {"TFIDF_TPU_SERVE_PIPELINE": "4", "TFIDF_TPU_QUERY_SLAB": "off",
     "TFIDF_TPU_DISTTRACE": "0"},
    {"TFIDF_TPU_SCORER": "bm25", "TFIDF_TPU_BM25_K1": "1.5",
     "TFIDF_TPU_BM25_B": "0.6"},
    {"TFIDF_TPU_DELTA_DOCS": "64", "TFIDF_TPU_COMPACT_AT": "3",
     "TFIDF_TPU_SLO_MS": "20", "TFIDF_TPU_SLO_TARGET": "0.9"},
    {"TFIDF_TPU_DISPATCH_RETRIES": "0", "TFIDF_TPU_FAULTS":
     "device_dispatch:transient:n=1", "TFIDF_TPU_FAULT_SEED": "5",
     "TFIDF_TPU_RESTART_BUDGET": "1", "TFIDF_TPU_MESH_SHARDS": "2"},
]


@pytest.mark.parametrize("case", range(len(ENV_CASES)))
def test_serve_config_from_env_equal(monkeypatch, case):
    for key, val in ENV_CASES[case].items():
        monkeypatch.setenv(key, val)
    t, j = ServeConfig.from_env(), JServeConfig.from_env()
    import dataclasses
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    # flag > env > default
    assert ServeConfig.from_env(max_batch=4).max_batch == 4


@pytest.mark.parametrize("kw", [
    {"max_batch": 0}, {"queue_depth": 0}, {"cache_entries": -1},
    {"max_wait_ms": -1}, {"pipeline_depth": 0}, {"slo_target": 1.0},
    {"replicas": 2}, {"mesh_shards": -1}, {"scorer": "nope"},
    {"bm25_b": 2.0}, {"compact_at": 1}, {"health_period_ms": 0}])
def test_serve_config_validation_equal(kw):
    with pytest.raises(ValueError):
        JServeConfig(**kw)
    with pytest.raises(ValueError):
        ServeConfig(**kw)
