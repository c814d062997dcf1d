"""The replicated serving front in the port (tfidf_tpu_torch/serve/front.py)
against the JAX package's (tfidf_tpu/serve/front.py), on the CPU.

* Without processes (both fronts built, never started, their replica
  tables set by hand): ``_pick`` routes every query to the replica the
  JAX front picks, for the same live sets and health; the fallback off a
  dead or degraded replica and the error with none live; the JSON
  answers of ``handle_line`` to malformed requests; the replica spec
  (the pipeline config round trip, ``replicas``/``snapshot_dir`` cleared,
  the device); ``ServeConfig``'s replica fields as the JAX package
  validates and reads them.
* A real tier: a front and 2 replica processes on the CPU over a
  12-document seeded corpus, one tier shared by the tests of
  ``TestTier`` in order. Answers equal the port's direct search bit for
  bit and the JAX package's (ids exact, scores by
  ``parity.compare_search``); merged counters are the replicas' sums; an
  armed fault kills replica 2 between its prepare ack and the commit, so
  the first swap aborts with every replica on epoch 0; replica 2
  restarts from the snapshot (the corpus is gone by then), the retried
  swap commits epoch 1 and the answers equal the new index's; no kernel
  library is built after the warm-up; ``trace_export`` holds the front
  and both replicas with their clock offsets; ``close`` is idempotent
  and leaves no replica process.
* A snapshot written by the JAX package's retriever boots a port tier
  with no corpus at all; a segmented tier takes ``add_docs``,
  ``delete_docs`` and ``compact`` through the front and answers as the
  port's ``SegmentedIndex`` after the same mutations.

Every wait has a deadline (``replica_timeout_s`` and the restart wait),
so a hung replica fails its test instead of the run.
"""

import os
import shutil
import time

import numpy as np
import pytest
import torch

from tfidf_tpu.config import PipelineConfig as JConfig
from tfidf_tpu.config import ServeConfig as JServeConfig
from tfidf_tpu.config import VocabMode as JVocab
from tfidf_tpu.models import TfidfRetriever as JRetriever
from tfidf_tpu.serve.front import FrontError as JFrontError
from tfidf_tpu.serve.front import ReplicatedFront as JFront

from tfidf_tpu_torch import obs
from tfidf_tpu_torch.config import PipelineConfig, ServeConfig, VocabMode
from tfidf_tpu_torch.index import SegmentedIndex
from tfidf_tpu_torch.models import TfidfRetriever
from tfidf_tpu_torch.parallel.multihost import _config_from_spec
from tfidf_tpu_torch.parity import compare_search
from tfidf_tpu_torch.serve import FrontError, ReplicatedFront, SwapAborted

TIMEOUT = 60.0  # seconds: replica_timeout_s and every wait of this file
KW = dict(vocab_size=4096, max_doc_len=64)
CFG = PipelineConfig(vocab_mode=VocabMode.HASHED, **KW)
JCFG = JConfig(vocab_mode=JVocab.HASHED, **KW)
QUERIES = ["w1 w2 w3", "w7", "w11 w5", "w2 w2 w9", "w150 w3", "zzz"]
CHAOS = "replica_prepare:fatal:n=1:match=replica=2 boot=0"


def _write_corpus(path, n_docs, seed, n_words=200, doc_len=30):
    """Strict-discovery corpus: doc1..docN, space-joined words."""
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    for i in range(1, n_docs + 1):
        words = [f"w{rng.integers(0, n_words)}" for _ in range(doc_len)]
        with open(os.path.join(path, f"doc{i}"), "w") as f:
            f.write(" ".join(words))
    return str(path)


def _answer(resp):
    """A front response as (names, float32 scores) per query."""
    assert "results" in resp, resp
    return [([n for n, _ in row], np.array([v for _, v in row], np.float32))
            for row in resp["results"]]


def _direct(r, queries, k, scorer=None):
    vals, ids = r.search(queries, k=k, scorer=scorer)
    return [([r.names[int(d)] for d in irow if d >= 0],
             np.asarray(vrow, np.float32)[np.asarray(irow) >= 0])
            for vrow, irow in zip(vals, ids)]


def _assert_bit_equal(got, want):
    assert len(got) == len(want)
    for (gn, gv), (wn, wv) in zip(got, want):
        assert gn == wn
        np.testing.assert_array_equal(gv.view(np.uint32),
                                      wv.view(np.uint32))


def _assert_agrees_with_jax(got, j, queries, k, scorer=None):
    """Names exact, scores by compare_search, against the JAX direct
    search (ids: positions in the JAX index's names)."""
    jv, ji = j.search(queries, k=k, scorer=scorer)
    jv, ji = np.asarray(jv), np.asarray(ji)
    where = {n: i for i, n in enumerate(j.names)}
    vals = np.zeros(jv.shape, np.float32)
    ids = np.full(ji.shape, -1, np.int64)
    for q, (names, scores) in enumerate(got):
        ids[q, :len(names)] = [where[n] for n in names]
        vals[q, :len(names)] = scores
    cmp = compare_search(vals, ids, jv, ji,
                         val_ulps=4 if scorer == "bm25" else 0)
    assert cmp["ok"], cmp


def _query(front, queries, k=5, **kw):
    return front.handle_request({"queries": list(queries), "k": k,
                                 "use_cache": False, **kw},
                                timeout_s=TIMEOUT)


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setenv("TFIDF_TPU_LOG_ECHO", "off")


# ---------------------------------------------------------------------
# Without processes


def _fronts(tmp_path, n=4):
    snap = str(tmp_path / "snap")
    ours = ReplicatedFront(str(tmp_path), CFG, ServeConfig(
        snapshot_dir=snap, replicas=n), k=5, device="cpu")
    theirs = JFront(str(tmp_path), JCFG, JServeConfig(
        snapshot_dir=snap, replicas=n), k=5)
    return ours, theirs


def _set(front, states):
    for rank, (state, health, inflight) in states.items():
        rep = front._replicas[rank]
        rep.state, rep.health, rep.inflight = state, health, inflight


ROUTE_QUERIES = [f"w{i} w{(7 * i) % 23}" for i in range(40)] + [
    "alpha beta", "  alpha   beta ", "", "ünïcode wörds", "w1"]
LIVE_SETS = [
    {r: ("live", "ok", 0) for r in range(1, 5)},
    {1: ("live", "ok", 3), 2: ("dead", "unknown", 0), 3: ("live", "ok", 1),
     4: ("live", "unknown", 2)},
    {1: ("live", "degraded", 0), 2: ("live", "ok", 5), 3: ("failed", "ok", 0),
     4: ("live", "ok", 5)},
    {1: ("dead", "ok", 0), 2: ("starting", "ok", 0), 3: ("live", "failing", 1),
     4: ("stopping", "ok", 0)},
]


@pytest.mark.parametrize("case", range(len(LIVE_SETS)))
def test_pick_routes_as_the_jax_front(tmp_path, case):
    ours, theirs = _fronts(tmp_path)
    try:
        _set(ours, LIVE_SETS[case])
        _set(theirs, LIVE_SETS[case])
        for q in ROUTE_QUERIES:
            req = {"queries": [q]}
            assert ours._norm_for(req) == theirs._norm_for(req)
            assert (ours._pick(ours._norm_for(req))
                    == theirs._pick(theirs._norm_for(req))), q
        # whitespace variants share a key: one replica, one cache entry
        assert ours._norm_for({"queries": ["  alpha   beta "]}) \
            == ours._norm_for({"queries": ["alpha beta"]})
    finally:
        ours.close()
        theirs.close()


def test_pick_falls_back_and_fails_with_none_live(tmp_path):
    front, jfront = _fronts(tmp_path)
    try:
        with pytest.raises(FrontError, match="no live"):
            front._pick(b"anything")
        with pytest.raises(JFrontError, match="no live"):
            jfront._pick(b"anything")
        _set(front, {r: ("live", "ok", 5) for r in range(1, 5)})
        q = {"queries": ["alpha beta"]}
        preferred = front._pick(front._norm_for(q))
        front._replicas[preferred].state = "dead"
        survivors = [r for r in range(1, 5) if r != preferred]
        front._replicas[survivors[-1]].inflight = 0
        assert front._pick(front._norm_for(q)) == survivors[-1]
        front._replicas[preferred].state = "live"
        front._replicas[preferred].health = "degraded"
        assert front._pick(front._norm_for(q)) != preferred
        assert front._pick(b"x", forced=survivors[0]) == survivors[0]
        front._replicas[survivors[0]].state = "dead"
        with pytest.raises(FrontError, match="not live"):
            front._pick(b"x", forced=survivors[0])
        assert front._m_fallbacks.value >= 2
    finally:
        front.close()
        jfront.close()


BAD_LINES = [
    "not json", "[1, 2]", '"a string"',
    '{"id": 1, "queries": "not-a-list"}',
    '{"id": 2, "queries": ["ok", 3]}', '{"id": 3}',
    '{"id": 4, "op": "add_docs", "docs": []}',
    '{"id": 5, "op": "add_docs", "docs": [{"name": "a"}]}',
    '{"id": 6, "op": "add_docs", "docs": "x"}',
    '{"id": 7, "op": "delete_docs", "names": []}',
    '{"id": 8, "op": "delete_docs", "names": [1]}',
    '{"id": 9, "op": "nope"}', '{"id": 10, "op": "swap_index"}',
    '{"id": 11, "op": "compact"}', '{"id": 12, "op": "snapshot"}',
    '{"id": 13, "op": "readyz"}', '{"id": 14, "op": "replica_info"}',
    "   ", '{"op": "shutdown"}']


def test_handle_line_answers_as_the_jax_front(tmp_path):
    ours, theirs = _fronts(tmp_path)
    try:
        for line in BAD_LINES:
            got, want = [], []
            assert ours.handle_line(line, got.append) \
                == theirs.handle_line(line, want.append)
            assert got == want, line
        assert not ours.handle_line('{"op": "shutdown"}', print)
    finally:
        ours.close()
        theirs.close()


def test_spec_round_trips_and_carries_the_device(tmp_path):
    ours, theirs = _fronts(tmp_path)
    try:
        import json
        with open(ours._spec_for(2, 3, False)) as f:
            spec = json.load(f)
        with open(theirs._spec_for(2, 3, False)) as f:
            jspec = json.load(f)
        assert set(spec) == set(jspec) | {"device"}
        assert spec["device"] == "cpu" and ours._device == torch.device("cpu")
        assert _config_from_spec(spec["pipeline"]) == CFG
        assert spec["serve"] == jspec["serve"]
        assert spec["serve"]["replicas"] is None
        assert spec["serve"]["snapshot_dir"] is None
        for key in set(jspec) - {"pipeline"}:
            assert spec[key] == jspec[key], key
    finally:
        ours.close()
        theirs.close()


def test_front_resolves_the_device_before_any_spawn(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ServeConfig(snapshot_dir=str(tmp_path / "s"), replicas=2)
    with pytest.raises(RuntimeError, match="no CUDA device available"):
        ReplicatedFront(str(tmp_path), CFG, cfg)
    front = ReplicatedFront(str(tmp_path), CFG, cfg, device="cpu")
    front.close()


@pytest.mark.parametrize("kw", [{"replicas": 2}, {"replicas": 0,
                                                  "snapshot_dir": "s"},
                                {"replicas": 2, "snapshot_dir": "s",
                                 "replica_timeout_s": 0}])
def test_serve_config_replicas_validated_as_jax(kw):
    errors = []
    for cls in (ServeConfig, JServeConfig):
        with pytest.raises(ValueError) as e:
            cls(**kw)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    with pytest.raises(ValueError, match="replicas"):
        ReplicatedFront(None, CFG, ServeConfig(snapshot_dir="s"),
                        device="cpu")
    with pytest.raises(ValueError, match="replicas"):
        JFront(None, JCFG, JServeConfig(snapshot_dir="s"))


def test_replicas_env_round_trip_as_jax(monkeypatch):
    monkeypatch.setenv("TFIDF_TPU_REPLICAS", "3")
    monkeypatch.setenv("TFIDF_TPU_SNAPSHOT_DIR", "/tmp/x")
    monkeypatch.setenv("TFIDF_TPU_REPLICA_TIMEOUT_S", "7.5")
    ours, theirs = ServeConfig.from_env(), JServeConfig.from_env()
    assert (ours.replicas, ours.snapshot_dir, ours.replica_timeout_s) \
        == (theirs.replicas, theirs.snapshot_dir,
            theirs.replica_timeout_s) == (3, "/tmp/x", 7.5)
    assert ServeConfig.from_env(replicas=2).replicas \
        == JServeConfig.from_env(replicas=2).replicas == 2


# ---------------------------------------------------------------------
# A real tier: 2 replica processes on the CPU


@pytest.fixture(scope="module")
def tier(tmp_path_factory):
    root = tmp_path_factory.mktemp("tier")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TFIDF_TPU_LOG_ECHO", "off")
        input_dir = _write_corpus(str(root / "input"), 12, seed=7)
        new_dir = _write_corpus(str(root / "new"), 9, seed=8)
        prev = obs.get_tracer()
        obs.set_tracer(obs.Tracer(), None)
        serve_cfg = ServeConfig(
            max_batch=8, cache_entries=256, snapshot_dir=str(root / "snap"),
            replicas=2, replica_timeout_s=TIMEOUT, disttrace=True,
            faults=CHAOS)
        front = ReplicatedFront(input_dir, CFG, serve_cfg, k=5,
                                device="cpu")
        state = {"front": front, "input": input_dir, "new": new_dir,
                 "r": TfidfRetriever(CFG, device="cpu").index_dir(input_dir),
                 "j": JRetriever(JCFG).index_dir(input_dir),
                 "r_new": TfidfRetriever(CFG, device="cpu").index_dir(
                     new_dir),
                 "j_new": JRetriever(JCFG).index_dir(new_dir)}
        try:
            front.start()
            yield state
        finally:
            front.close()
            obs.set_tracer(prev)


class TestTier:
    def test_answers_equal_direct_search(self, tier):
        front = tier["front"]
        assert front.describe()["live"] == 2 and front.epoch == 0
        for scorer in (None, "bm25"):
            kw = {"scorer": scorer} if scorer else {}
            for q in QUERIES:
                resp = _query(front, [q], **kw)
                assert resp["epoch"] == 0
                got = _answer(resp)
                _assert_bit_equal(got, _direct(tier["r"], [q], 5, scorer))
                _assert_agrees_with_jax(got, tier["j"], [q], 5, scorer)
            resp = _query(front, QUERIES, **kw)
            _assert_bit_equal(_answer(resp),
                              _direct(tier["r"], QUERIES, 5, scorer))

    def test_merged_metrics_are_the_replicas_sums(self, tier):
        front = tier["front"]
        snap = front.metrics_snapshot()
        assert set(snap["per_replica"]) == {"r1", "r2"}
        for name in ("serve_requests_total", "serve_queries_total"):
            per = [s["registry"][name]
                   for s in snap["per_replica"].values()]
            assert snap["merged"][name] == sum(per) > 0
        assert snap["merged"]["serve_front_routed_total"] >= 2 * len(QUERIES)
        prom = front.metrics_prom()
        assert 'process="r1"' in prom and 'process="r2"' in prom
        assert "serve_front_routed_total" in prom
        bundle = front.obs_export()
        assert bundle["schema"] == "tfidf-obs/1"
        assert set(bundle["replicas"]) == {"r1", "r2"}

    def test_armed_fault_aborts_the_first_swap(self, tier):
        front = tier["front"]
        # From here on the corpus is gone: a restart has only the
        # snapshot to boot from.
        shutil.rmtree(tier["input"])
        with pytest.raises(SwapAborted):
            front.swap_index(tier["new"])
        assert front.epoch == 0
        for rep in front.describe()["replicas"].values():
            assert rep["epoch"] == 0
        for q in QUERIES:   # re-routed off the dead replica, old epoch
            resp = _query(front, [q])
            assert resp["epoch"] == 0
            _assert_bit_equal(_answer(resp), _direct(tier["r"], [q], 5))

    def test_restart_from_snapshot_then_the_swap_commits(self, tier):
        front = tier["front"]
        deadline = time.monotonic() + TIMEOUT
        while time.monotonic() < deadline:
            d = front.describe()["replicas"]
            if all(r["state"] == "live" for r in d.values()) \
                    and d["2"]["boot"] >= 1:
                break
            time.sleep(0.1)
        d = front.describe()["replicas"]
        assert d["2"]["state"] == "live" and d["2"]["boot"] == 1
        assert d["2"]["restarts"] == 1 and d["2"]["epoch"] == 0
        assert front.swap_index(tier["new"]) == 1 and front.epoch == 1
        for rep in front.describe()["replicas"].values():
            assert rep["epoch"] == 1
        for rank in (1, 2):   # each replica serves the new index
            resp = front.handle_request(
                {"queries": QUERIES, "k": 5, "use_cache": False},
                rank=rank, timeout_s=TIMEOUT)
            assert resp["epoch"] == 1
            got = _answer(resp)
            _assert_bit_equal(got, _direct(tier["r_new"], QUERIES, 5))
            _assert_agrees_with_jax(got, tier["j_new"], QUERIES, 5)

    def test_no_build_after_warm_up(self, tier):
        info = tier["front"].replica_info()
        assert set(info) == {"r1", "r2"}
        assert info["r2"]["boot"] == 1
        for v in info.values():
            assert v["recompiles_after_warm"] == 0 and v["epoch"] == 1
            progs = v["compiled_programs"]
            # the CPU runs the plain versions: no kernel launches
            assert set(progs["launches"]) == {
                "fused_score_topk", "tf_df", "pack_words", "ragged_rebuild",
                "tokenize_hash", "tile_scores"}
            assert not any(progs["launches"].values())

    def test_trace_export_holds_the_front_and_both_replicas(self, tier):
        bundle = tier["front"].trace_export()
        assert bundle["schema"] == "tfidf-trace/1" and bundle["epoch"] == 1
        procs = {p["process"]: p for p in bundle["processes"]}
        assert set(procs) == {"front", "r1", "r2"}
        for label in ("r1", "r2"):
            clock = procs[label]["clock"]
            assert clock["samples"] > 0 and clock["uncertainty_ns"] > 0
            assert isinstance(clock["offset_ns"], int)
        names = {e.get("name") for e in procs["front"]["traceEvents"]}
        assert {"route", "epoch_swap", "txn_phase"} <= names
        for label in ("r1", "r2"):
            assert any(e.get("name") == "txn_phase"
                       for e in procs[label]["traceEvents"])

    def test_close_is_idempotent_and_leaves_no_process(self, tier):
        front = tier["front"]
        procs = [rep.proc for rep in front._replicas.values()]
        front.close()
        front.close()
        assert all(p is not None and p.poll() is not None for p in procs)
        assert front.describe()["live"] == 0


# ---------------------------------------------------------------------
# Snapshots across the packages, and a segmented tier


def test_jax_snapshot_boots_a_port_tier(tmp_path):
    input_dir = _write_corpus(str(tmp_path / "input"), 10, seed=3)
    snap = str(tmp_path / "snap")
    j = JRetriever(JCFG).index_dir(input_dir)
    j.snapshot(snap)
    r, _ = TfidfRetriever.restore(snap, CFG, device="cpu")
    front = ReplicatedFront(None, CFG, ServeConfig(
        max_batch=8, snapshot_dir=snap, replicas=2,
        replica_timeout_s=TIMEOUT), k=5, device="cpu")
    try:
        front.start()
        for scorer in (None, "bm25"):
            kw = {"scorer": scorer} if scorer else {}
            got = _answer(_query(front, QUERIES, **kw))
            _assert_agrees_with_jax(got, j, QUERIES, 5, scorer)
            _assert_bit_equal(got, _direct(r, QUERIES, 5, scorer))
    finally:
        front.close()


def test_segmented_tier_equals_the_segmented_index(tmp_path):
    input_dir = _write_corpus(str(tmp_path / "input"), 8, seed=5)
    front = ReplicatedFront(input_dir, CFG, ServeConfig(
        max_batch=8, snapshot_dir=str(tmp_path / "snap"), replicas=2,
        replica_timeout_s=TIMEOUT, delta_docs=2), k=5, device="cpu")
    idx = SegmentedIndex.from_dir(input_dir, CFG, delta_docs=2,
                                  device="cpu")
    docs = [{"name": "doc9", "text": "w1 w7 w7 w150"},
            {"name": "doc10", "text": "w5 w11 zzz"},
            {"name": "doc3", "text": "w2 w9 w9"}]

    def check(epoch):
        view = idx.view()
        for scorer in (None, "bm25"):
            kw = {"scorer": scorer} if scorer else {}
            resp = _query(front, QUERIES, **kw)
            assert resp["epoch"] == epoch
            _assert_bit_equal(_answer(resp),
                              _direct(view, QUERIES, 5, scorer))
    try:
        front.start()
        check(0)
        out = front.add_docs(docs)
        idx.add_docs([d["name"] for d in docs], [d["text"] for d in docs])
        assert (out["epoch"], out["added"], out["updated"],
                out["replicas"]) == (1, 2, 1, 2)
        check(1)
        out = front.delete_docs(["doc1", "doc10", "ghost"])
        idx.delete_docs(["doc1", "doc10", "ghost"])
        assert (out["epoch"], out["deleted"], out["missing"]) == (2, 2, 1)
        check(2)
        assert front.compact_now()["epoch"] == 3
        assert idx.compact(force=True) is not None
        check(3)
        assert front.snapshot()["epoch"] == 3
    finally:
        front.close()
