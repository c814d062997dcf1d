"""Mesh-sharded serving in the port (tfidf_tpu_torch/parallel/serving.py,
``ServeConfig.mesh_shards``, the device monitor's shard gauges) against
the JAX package, on the CPU: the JAX package on its forced CPU devices
(tests/conftest.py), the port on CPU virtual shards of one process.

Contracts, as the port states them:

* ``MeshShardedRetriever`` equals the port's single-device ``search`` of
  its source bit for bit (scores, doc indices, tie order) over random
  corpora x shard counts 1-4 (a ragged last shard and an all-tombstoned
  shard included), every scorer and filter, the untiled path and any
  doc tile width; and it agrees with the JAX package's
  ``MeshShardedRetriever`` under ``parity.compare_search`` (ids exact
  but for near-ties, scores within 1e-6, BM25 also within 4 float32
  ulp).
* A segmented view sharded equals ``view.search`` bit for bit, and a
  rebuild by (name, score).
* Over a 4-shard plan spanning two gloo processes (2 CPU shards each),
  the sharded retriever and ``TfidfRetriever(plan=)`` answer in each
  process as one process's single-device search does.
* ``TfidfServer`` with ``mesh_shards`` shards every install (the
  constructor, ``swap_index``, ``add_docs``/``delete_docs``, a restored
  snapshot), answers equal the source's search, the canary's oracle is
  the single-device source, and the device monitor publishes the
  ``shard_bytes_d*`` / ``shard_imbalance_milli`` gauges and one
  ``shard_balance`` event an install.

The JAX file's ``TestShim`` (its ``shard_map`` compat shim),
``TestDoctorShards`` (``tools/doctor.py``), ``TestLedgerGate`` and
``TestMeshServeBenchSmoke`` (the TPU bench artifact and its gates) have
no counterpart in the port: there is no shim to test, and the doctor,
the ledger and the bench are tools of the JAX package. The JAX
``mesh_search_cache_size`` (a count of jitted programs) has none either:
the port compiles no search program, so the warm-server test holds the
build watch's count at 0 instead.
"""

import random

import jax
import numpy as np
import pytest
import torch

from tfidf_tpu.config import PipelineConfig as JConfig
from tfidf_tpu.config import VocabMode as JVocab
from tfidf_tpu.io.corpus import Corpus as JCorpus
from tfidf_tpu.models import TfidfRetriever as JRetriever
from tfidf_tpu.parallel.serving import make_serving_plan as j_plan
from tfidf_tpu.parallel.serving import shard_index as j_shard

from tfidf_tpu_torch import obs
from tfidf_tpu_torch.config import PipelineConfig, ServeConfig, VocabMode
from tfidf_tpu_torch.index import SegmentedIndex
from tfidf_tpu_torch.io.corpus import Corpus
from tfidf_tpu_torch.models import TfidfRetriever
from tfidf_tpu_torch.obs import devmon
from tfidf_tpu_torch.obs.log import EventLog
from tfidf_tpu_torch.parallel import (MeshPlan, MeshShardedRetriever,
                                      make_serving_plan, shard_index)
from tfidf_tpu_torch.parity import compare_search
from tfidf_tpu_torch.serve import CanaryProber, TfidfServer

T = 30  # seconds: the timeout of every wait in this file

KW = dict(vocab_size=512, max_doc_len=32, doc_chunk=32)
CFG = PipelineConfig(vocab_mode=VocabMode.HASHED, **KW)
JCFG = JConfig(vocab_mode=JVocab.HASHED, **KW)

WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa "
         "lam mu nu xi omicron pi").split()
QUERIES = ["alpha beta", "zeta", "mu nu xi pi", "unknownword"]
SCORERS = ["tfidf", "bm25", "bm25:k1=1.5,b=0.6"]
FILTERS = [None, {"id_range": [1, 9]}, {"ids": [0, 3, 4, 11]},
           {"prefix": "doc1"}]


def make_corpus(n_docs, seed=0):
    rng = random.Random(seed)
    names = [f"doc{i + 1}" for i in range(n_docs)]
    docs = [" ".join(rng.choice(WORDS)
                     for _ in range(rng.randint(3, 20))).encode()
            for _ in range(n_docs)]
    return names, docs


def port_index(names, docs):
    return TfidfRetriever(CFG, device="cpu").index(Corpus(names=names,
                                                          docs=docs))


def cpu_plan(shards):
    return make_serving_plan(shards, device="cpu")


def assert_same(a, b, what=""):
    assert np.array_equal(a[0], b[0]), what
    assert np.array_equal(a[1], b[1]), what


def assert_agree(port, jax_res, scorer="tfidf"):
    bm25 = scorer.startswith("bm25")
    rep = compare_search(port[0], port[1], np.asarray(jax_res[0]),
                         np.asarray(jax_res[1]), val_tol=1e-6, tie_ulps=4,
                         val_ulps=4 if bm25 else 0)
    assert rep["ok"], rep


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.set_log(EventLog(echo="off"))
    devmon.set_watch(None)
    yield
    devmon.set_watch(None)
    obs.set_log(None)


class TestServingPlan:
    def test_shard_counts_and_devices(self):
        assert cpu_plan(3).n_docs_shards == 3
        assert cpu_plan(3).devices == (torch.device("cpu"),) * 3
        # 0 = every device: on the CPU that is one shard per process
        assert cpu_plan(0).n_docs_shards == 1
        # a repeated device list gives virtual shards
        plan = make_serving_plan(4, devices=["cpu"] * 4)
        assert plan.shape == (4, 1, 1)
        # the first n of a longer list
        assert make_serving_plan(2, devices=["cpu"] * 4).n_docs_shards == 2

    @pytest.mark.parametrize("n", [5, -1])
    def test_refused(self, n):
        with pytest.raises(ValueError, match="mesh_shards"):
            make_serving_plan(n, devices=["cpu"] * 4)

    def test_no_gpu_no_silent_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_serving_plan(1)

    def test_same_resolution_as_jax(self):
        # on the JAX side the devices are its 8 forced CPU devices
        assert j_plan(0).n_docs_shards == len(jax.devices())
        with pytest.raises(ValueError, match="exceeds"):
            j_plan(len(jax.devices()) + 1)
        with pytest.raises(ValueError, match="exceeds"):
            make_serving_plan(3, devices=["cpu"] * 2)


class TestBitParity:
    """Sharded against single-device, bit for bit, and against the JAX
    package's sharded search."""

    @pytest.mark.parametrize("seed,n_docs", [(1, 5), (2, 6), (3, 13),
                                             (4, 16)])
    @pytest.mark.parametrize("shards", [1, 2, 3, 4])
    def test_property_random_corpora_x_shard_counts(self, seed, n_docs,
                                                    shards):
        # Ragged last shard included by construction: 5, 6, 13 docs over
        # 2, 3 and 4 shards pad 1-3 dead tail rows.
        names, docs = make_corpus(n_docs, seed=seed)
        single = port_index(names, docs)
        sharded = shard_index(single, cpu_plan(shards))
        assert sharded.n_shards == shards
        jsingle = JRetriever(JCFG).index(JCorpus(names=names, docs=docs))
        jsharded = j_shard(jsingle, j_plan(shards))
        for k in (1, 3, 10, n_docs + 7):
            got = sharded.search(QUERIES, k)
            want = single.search(QUERIES, k)
            assert got[0].shape == want[0].shape  # width min(k, docs)
            assert_same(got, want, (seed, shards, k))
            assert_agree(got, jsharded.search(QUERIES, k))

    @pytest.mark.parametrize("shards", [2, 3])
    def test_tie_order_across_shard_boundary(self, shards):
        # Identical docs land in different shards and score exactly
        # equal; the merge must keep the lower global row, the
        # single-device order. The distinct docs keep DF < N.
        docs = [b"alpha beta", b"alpha beta", b"gamma delta",
                b"alpha beta", b"epsilon zeta", b"alpha beta"]
        names = [f"d{i}" for i in range(len(docs))]
        single = port_index(names, docs)
        sharded = shard_index(single, cpu_plan(shards))
        got = sharded.search(["alpha beta"], k=5)
        want = single.search(["alpha beta"], k=5)
        assert (want[0][0] > 0).sum() >= 4     # the ties actually score
        assert_same(got, want, shards)
        assert list(got[1][0][:4]) == [0, 1, 3, 5]
        jsharded = j_shard(JRetriever(JCFG).index(
            JCorpus(names=names, docs=docs)), j_plan(shards))
        jv, ji = jsharded.search(["alpha beta"], k=5)
        assert np.array_equal(got[1], np.asarray(ji))

    @pytest.mark.parametrize("scorer", SCORERS)
    @pytest.mark.parametrize("filt", FILTERS,
                             ids=["none", "id_range", "ids", "prefix"])
    def test_scorers_and_filters(self, scorer, filt):
        names, docs = make_corpus(14, seed=21)
        single = port_index(names, docs)
        sharded = shard_index(single, cpu_plan(4))
        got = sharded.search(QUERIES, 5, scorer=scorer, filter=filt)
        assert_same(got, single.search(QUERIES, 5, scorer=scorer,
                                       filter=filt), (scorer, filt))
        jsharded = j_shard(JRetriever(JCFG).index(
            JCorpus(names=names, docs=docs)), j_plan(4))
        assert_agree(got, jsharded.search(QUERIES, 5, scorer=scorer,
                                          filter=filt), scorer)

    @pytest.mark.parametrize("env", [
        {"TFIDF_TPU_QUERY_BLOCK": "4"}, {"TFIDF_TPU_QUERY_BLOCK": "1"},
        {"TFIDF_TPU_SCORE_TILING": "off"}])
    def test_tiling_and_query_blocking(self, monkeypatch, env):
        # Narrow doc tiles, and the untiled path's 64-query blocks: the
        # concatenations stay exact on both sides.
        names, docs = make_corpus(9, seed=5)
        single = port_index(names, docs)
        sharded = shard_index(single, cpu_plan(2))
        queries = [f"{WORDS[i % len(WORDS)]} {WORDS[(2 * i) % len(WORDS)]}"
                   for i in range(70)]
        want = single.search(queries, 4)
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        assert_same(sharded.search(queries, 4), want)
        assert_same(sharded.search(queries, 4, scorer="bm25"),
                    single.search(queries, 4, scorer="bm25"))

    def test_empty_queries_and_contract_surface(self):
        names, docs = make_corpus(6, seed=6)
        single = port_index(names, docs)
        sharded = shard_index(single, cpu_plan(2))
        assert sharded.indexed and sharded._num_docs == 6
        assert sharded.names == single.names
        assert sharded.config is single.config
        assert sharded.parity_oracle() is single
        assert sharded.device == torch.device("cpu")
        v, i = sharded.search([], k=3)
        assert v.shape == (0, 3) and i.shape == (0, 3)
        assert_same(sharded.search([""], k=3), single.search([""], k=3))

    def test_shard_index_idempotent_and_guards(self, tmp_path):
        names, docs = make_corpus(4, seed=7)
        single = port_index(names, docs)
        plan = cpu_plan(2)
        sharded = shard_index(single, plan)
        assert shard_index(sharded, plan) is sharded
        # onto another plan: re-sharded from the retained source
        again = shard_index(sharded, cpu_plan(3))
        assert again.n_shards == 3 and again.parity_oracle() is single
        with pytest.raises(ValueError, match="indexed"):
            shard_index(TfidfRetriever(CFG, device="cpu"), plan)
        bad = MeshPlan.create(docs=2, vocab=2, device="cpu")
        with pytest.raises(ValueError, match="docs axis only"):
            MeshShardedRetriever(single, bad)
        dropped = shard_index(single, plan, keep_source=False)
        assert dropped.parity_oracle() is None
        with pytest.raises(ValueError, match="source"):
            dropped.snapshot(str(tmp_path / "nowhere"))
        with pytest.raises(ValueError, match="source"):
            shard_index(dropped, cpu_plan(4))
        with pytest.raises(ValueError, match="source"):
            dropped.search(["alpha"], k=2, scorer="bm25")
        # the default scorer still serves without the source
        assert_same(dropped.search(["alpha"], k=2),
                    single.search(["alpha"], k=2))

    def test_snapshot_delegates_to_the_source(self, tmp_path):
        names, docs = make_corpus(7, seed=8)
        single = port_index(names, docs)
        sharded = shard_index(single, cpu_plan(3))
        sharded.snapshot(str(tmp_path / "snap"))
        back, _ = TfidfRetriever.restore(str(tmp_path / "snap"), CFG,
                                         device="cpu")
        assert_same(back.search(QUERIES, 4), sharded.search(QUERIES, 4))

    @pytest.mark.parametrize("n_docs,shards", [(8, 4), (7, 3)])
    def test_shard_stats_balanced_blocks(self, n_docs, shards):
        names, docs = make_corpus(n_docs, seed=8)
        sharded = shard_index(port_index(names, docs), cpu_plan(shards))
        stats = sharded.shard_stats()
        assert stats["n_shards"] == shards
        assert len(stats["shard_bytes"]) == shards
        assert all(b > 0 for b in stats["shard_bytes"])
        # equal row blocks by construction
        assert stats["imbalance"] == pytest.approx(1.0)
        assert stats["total_bytes"] == sum(stats["shard_bytes"])
        # the census sees every block
        arrays = sharded.index_arrays()
        assert len(arrays) == 1 + 3 * shards

    def test_plan_retriever_source(self):
        # a plan-sharded retriever is a source too: its blocks re-cut
        names, docs = make_corpus(10, seed=9)
        plan_r = TfidfRetriever(CFG, plan=MeshPlan.create(docs=2,
                                                          device="cpu"))
        plan_r.index(Corpus(names=names, docs=docs))
        sharded = shard_index(plan_r, cpu_plan(3))
        assert_same(sharded.search(QUERIES, 6),
                    port_index(names, docs).search(QUERIES, 6))


class TestSegmentedSharding:
    """A sharded IndexView: mutation-era parity, tombstones riding the
    live mask, the all-deleted shard."""

    @staticmethod
    def _names_scores(names, vals, ids):
        return [[(names[i] if i >= 0 else None, float(v))
                 for v, i in zip(vrow, irow)]
                for vrow, irow in zip(vals, ids)]

    @pytest.mark.parametrize("shards", [2, 3, 4])
    def test_sharded_view_matches_view_and_rebuild(self, shards):
        names, docs = make_corpus(10, seed=9)
        seg = SegmentedIndex.from_corpus(Corpus(names=names, docs=docs),
                                         CFG, delta_docs=4, device="cpu")
        seg.add_docs(["extra1", "extra2"],
                     ["alpha kappa pi", "beta beta mu"])
        seg.delete_docs(["doc3", "doc7"])
        view = seg.view()
        queries = ["alpha beta", "kappa pi", "mu"]
        sharded = shard_index(view, cpu_plan(shards))
        assert sharded.owner is seg
        for scorer in SCORERS:
            got = sharded.search(queries, k=6, scorer=scorer)
            # the same padded-row index space: exact equality
            assert_same(got, view.search(queries, k=6, scorer=scorer),
                        (shards, scorer))
        got = sharded.search(queries, k=6, filter={"prefix": "extra"})
        assert_same(got, view.search(queries, k=6,
                                     filter={"prefix": "extra"}))
        # and the from-scratch rebuild agrees on (name, score) rows
        rebuild = seg.rebuild_retriever()
        sv, si = sharded.search(queries, k=6)
        rv, ri = rebuild.search(queries, k=6)
        assert self._names_scores(sharded.names, sv, si) == \
            self._names_scores(rebuild.names, rv, ri)

    def test_all_deleted_shard(self):
        # Base segment (4 rows) + delta (4 rows) -> 8 padded rows; over 2
        # shards, deleting every base doc leaves shard 0 with no live row:
        # it contributes only sentinel candidates.
        names, docs = make_corpus(4, seed=10)
        seg = SegmentedIndex.from_corpus(Corpus(names=names, docs=docs),
                                         CFG, delta_docs=4, device="cpu")
        seg.add_docs(["n1", "n2", "n3"],
                     ["alpha beta gamma", "delta epsilon", "zeta pi"])
        seg.delete_docs([f"doc{i}" for i in range(1, 5)])
        view = seg.view()
        sharded = shard_index(view, cpu_plan(2))
        assert not sharded._live[0].any()  # the premise
        queries = ["alpha beta", "zeta", "epsilon delta"]
        got = sharded.search(queries, k=5)
        assert_same(got, view.search(queries, k=5))
        rebuild = seg.rebuild_retriever()
        assert self._names_scores(sharded.names, *got) == \
            self._names_scores(rebuild.names,
                               *rebuild.search(queries, k=5))

    def test_matches_the_jax_sharded_view(self):
        from tfidf_tpu.index import SegmentedIndex as JSegmented
        names, docs = make_corpus(12, seed=12)
        seg = SegmentedIndex.from_corpus(Corpus(names=names, docs=docs),
                                         CFG, delta_docs=4, device="cpu")
        jseg = JSegmented.from_corpus(JCorpus(names=names, docs=docs),
                                      JCFG, delta_docs=4)
        for s in (seg, jseg):
            s.add_docs(["x1", "x2"], ["alpha alpha pi", "mu nu"])
            s.delete_docs(["doc2", "doc9"])
        got = shard_index(seg.view(), cpu_plan(3)).search(QUERIES, 5)
        want = j_shard(jseg.view(), j_plan(3)).search(QUERIES, 5)
        assert_agree(got, want)


def quick_cfg(**kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_ms", 5)
    kw.setdefault("cache_entries", 0)
    return ServeConfig(**kw)


class TestServeIntegration:
    """TfidfServer under mesh_shards: every install path re-shards, every
    response stays bit-identical."""

    def test_submit_parity_and_sharded_install(self):
        single = port_index(*make_corpus(9, seed=11))
        with TfidfServer(single, quick_cfg(mesh_shards=2)) as server:
            _, installed = server.current_index()
            assert isinstance(installed, MeshShardedRetriever)
            assert installed.n_shards == 2
            queries = ["alpha beta", "kappa", "mu nu"]
            assert_same(server.search(queries, k=4, timeout=T),
                        single.search(queries, k=4))
            assert_same(server.search(queries, k=4, scorer="bm25",
                                      filter={"id_range": [0, 5]},
                                      timeout=T),
                        single.search(queries, k=4, scorer="bm25",
                                      filter={"id_range": [0, 5]}))
            assert server.fingerprint()["backend"] == "cpu"

    def test_mesh_shards_zero_means_all_devices(self):
        # on the CPU "every device" is one shard
        single = port_index(*make_corpus(4, seed=12))
        with TfidfServer(single, quick_cfg(mesh_shards=0)) as server:
            _, installed = server.current_index()
            assert isinstance(installed, MeshShardedRetriever)
            assert installed.n_shards == 1

    def test_swap_reshards_and_holds_parity(self):
        single = port_index(*make_corpus(8, seed=13))
        with TfidfServer(single, quick_cfg(mesh_shards=2)) as server:
            fresh = port_index(*make_corpus(11, seed=14))
            assert server.swap_index(fresh) == 1
            _, installed = server.current_index()
            assert isinstance(installed, MeshShardedRetriever)
            assert installed._num_docs == 11
            assert_same(server.search(["alpha", "pi kappa"], k=5,
                                      timeout=T),
                        fresh.search(["alpha", "pi kappa"], k=5))
            # a scorer change re-installs the same sharded index
            assert server.set_scorer("bm25") == 2
            assert server.current_index()[1] is installed

    def test_mutation_installs_sharded_views(self):
        seg = SegmentedIndex.from_corpus(
            Corpus(*make_corpus(6, seed=15)), CFG, delta_docs=4,
            device="cpu")
        with TfidfServer(seg.view(), quick_cfg(mesh_shards=2)) as server:
            server.attach_segments(seg)
            out = server.add_docs(["fresh1"], ["alpha omicron pi"])
            assert out["epoch"] == 1
            _, installed = server.current_index()
            assert isinstance(installed, MeshShardedRetriever)
            sv, si = server.search(["alpha omicron"], k=4, timeout=T)
            rebuild = seg.rebuild_retriever()
            rv, ri = rebuild.search(["alpha omicron"], k=4)
            names = installed.names
            assert np.array_equal(sv, rv)
            assert [names[i] if i >= 0 else None for i in si[0]] == \
                [rebuild.names[i] if i >= 0 else None for i in ri[0]]
            out = server.delete_docs(["fresh1"])
            assert out["deleted"] == 1 and out["epoch"] == 2
            assert isinstance(server.current_index()[1],
                              MeshShardedRetriever)
            sv2, _ = server.search(["alpha omicron"], k=4, timeout=T)
            rv2, _ = seg.rebuild_retriever().search(["alpha omicron"], k=4)
            assert np.array_equal(sv2, rv2)
            summary = server.compact_now(force=True)
            if summary is not None:
                assert isinstance(server.current_index()[1],
                                  MeshShardedRetriever)

    def test_snapshot_and_restore_round_trip(self, tmp_path):
        single = port_index(*make_corpus(7, seed=16))
        snap = str(tmp_path / "snap")
        with TfidfServer(single, quick_cfg(mesh_shards=2,
                                           snapshot_dir=snap)) as server:
            server.snapshot()
            want = server.search(["alpha beta"], k=4, timeout=T)
        restored, _ = TfidfRetriever.restore(snap, CFG, device="cpu")
        with TfidfServer(restored, quick_cfg(mesh_shards=2)) as server2:
            assert isinstance(server2.current_index()[1],
                              MeshShardedRetriever)
            assert_same(server2.search(["alpha beta"], k=4, timeout=T),
                        want)

    def test_canary_oracle_is_single_device_source(self):
        single = port_index(*make_corpus(8, seed=17))
        with TfidfServer(single, quick_cfg(mesh_shards=2)) as server:
            _, installed = server.current_index()
            assert installed.parity_oracle() is single
            canary = CanaryProber(server, ["alpha beta", "kappa pi"], k=3,
                                  period_s=30)
            try:
                # captured against the SOURCE, probed through the shards
                assert canary.probe() == 1.0
                server.swap_index(port_index(*make_corpus(10, seed=18)))
                assert canary.probe() == 1.0
            finally:
                canary.close()

    def test_shard_balance_gauges_and_census(self):
        single = port_index(*make_corpus(8, seed=19))
        with TfidfServer(single, quick_cfg(mesh_shards=4)) as server:
            mon = devmon.DeviceMonitor(registry=server.metrics.registry)
            server.attach_device_monitor(mon)
            snap = mon.sample()
            shards = snap["shards"]
            assert shards["n_shards"] == 4
            assert all(b > 0 for b in shards["shard_bytes"])
            reg = server.metrics.registry.snapshot()
            for i in range(4):
                assert reg[f"shard_bytes_d{i}"]["value"] > 0
            assert reg["shard_imbalance_milli"]["value"] == 1000
            # the install is an edge: exactly one shard_balance event
            events = [e for e in obs.get_log().events()
                      if e.get("event") == "shard_balance"]
            assert len(events) == 1
            mon.sample()   # unchanged bytes -> no second event
            events = [e for e in obs.get_log().events()
                      if e.get("event") == "shard_balance"]
            assert len(events) == 1
            # the census attributes the sharded arrays to the index
            census = mon.census()
            assert census["owners"]["resident_index"]["bytes"] > 0
            # a swap to another shape is a new edge
            server.swap_index(port_index(*make_corpus(13, seed=20)))
            mon.sample()
            events = [e for e in obs.get_log().events()
                      if e.get("event") == "shard_balance"]
            assert len(events) == 2

    def test_unsharded_server_publishes_no_shards(self):
        single = port_index(*make_corpus(5, seed=21))
        with TfidfServer(single, quick_cfg()) as server:
            mon = devmon.DeviceMonitor(registry=server.metrics.registry)
            server.attach_device_monitor(mon)
            assert "shards" not in mon.sample()

    def test_no_builds_after_bucket_warm(self):
        single = port_index(*make_corpus(8, seed=20))
        cfg = quick_cfg(mesh_shards=2)
        with TfidfServer(single, cfg) as server:
            _, installed = server.current_index()
            b = 1
            while b <= cfg.max_batch:
                installed.search([""] * b, k=3)
                b *= 2
            server.mark_warm()
            for nq in (1, 2, 3, 5, 8):
                server.search([f"alpha {WORDS[nq]}"] * nq, k=3, timeout=T)
            assert server.compile_watch.recompile_count == 0

    def test_replicas_still_not_ported(self):
        # Ported now (ROADMAP A8b): a mesh_shards server with replicas
        # set is built as the JAX package builds it: replicas is the
        # front's field and the server ignores it, so the index is
        # doc-sharded and answers as the JAX sharded server does.
        from tfidf_tpu.config import ServeConfig as JServeConfig
        from tfidf_tpu.serve import TfidfServer as JServer
        names, docs = make_corpus(4, seed=22)
        single = port_index(names, docs)
        kw = dict(mesh_shards=2, replicas=2, snapshot_dir="snap",
                  max_batch=8, max_wait_ms=5, cache_entries=0)
        j = JRetriever(JCFG).index(JCorpus(names=names, docs=docs))
        with TfidfServer(single, ServeConfig(**kw)) as server, \
                JServer(j, JServeConfig(**kw)) as jserver:
            _, installed = server.current_index()
            _, jinstalled = jserver.current_index()
            assert isinstance(installed, MeshShardedRetriever)
            assert installed.n_shards == jinstalled.n_shards == 2
            for scorer in SCORERS:
                got = server.search(QUERIES, k=3, scorer=scorer, timeout=T)
                assert_same(got, single.search(QUERIES, k=3, scorer=scorer))
                assert_agree(got, jserver.search(QUERIES, k=3, scorer=scorer,
                                                 timeout=T), scorer)


_GLOO_SEARCH = r"""
import sys
sys.path.insert(0, sys.argv[1])
import random
import numpy as np
from tfidf_tpu_torch.config import PipelineConfig, VocabMode
from tfidf_tpu_torch.io.corpus import Corpus
from tfidf_tpu_torch.models import TfidfRetriever
from tfidf_tpu_torch.parallel import MeshPlan, shard_index
from tfidf_tpu_torch.parallel.multihost import initialize

addr, pid, expect = sys.argv[2], int(sys.argv[3]), sys.argv[4]
initialize(addr, 2, pid)
words = "alpha beta gamma delta epsilon zeta eta theta iota kappa".split()
rng = random.Random(3)
docs = [" ".join(rng.choice(words) for _ in range(rng.randint(3, 12)))
        .encode() for _ in range(11)]
corpus = Corpus(names=[f"doc{i + 1}" for i in range(11)], docs=docs)
cfg = PipelineConfig(vocab_mode=VocabMode.HASHED, vocab_size=512,
                     max_doc_len=32, doc_chunk=32)
plan = MeshPlan.create(docs=4, device="cpu")  # 2 shards a process
assert (plan.n_local_docs, plan.first_docs_shard) == (2, 2 * pid), plan
exp = np.load(expect)
queries = ["alpha beta", "zeta", "kappa eta iota"]
single = TfidfRetriever(cfg, device="cpu").index(corpus)
for got in (shard_index(single, plan).search(queries, 5),
            TfidfRetriever(cfg, plan=plan).index(corpus).search(queries, 5)):
    np.testing.assert_array_equal(got[0], exp["vals"])
    np.testing.assert_array_equal(got[1], exp["ids"])
print("OK", pid)
"""


def test_search_across_two_gloo_processes(tmp_path):
    """A 4-shard plan over 2 gloo processes (2 CPU shards each): the
    sharded retriever and the plan retriever answer in both processes
    as one process's single-device search does."""
    import os
    import socket
    import subprocess
    import sys
    words = "alpha beta gamma delta epsilon zeta eta theta iota kappa".split()
    rng = random.Random(3)
    docs = [" ".join(rng.choice(words) for _ in range(rng.randint(3, 12)))
            .encode() for _ in range(11)]
    names = [f"doc{i + 1}" for i in range(11)]
    want = port_index(names, docs).search(
        ["alpha beta", "zeta", "kappa eta iota"], 5)
    expect = tmp_path / "expect.npz"
    np.savez(expect, vals=want[0], ids=want[1])
    with socket.socket() as s:
        s.bind(("localhost", 0))
        addr = f"localhost:{s.getsockname()[1]}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GLOO_SEARCH, repo, addr, str(pid),
         str(expect)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rc={p.returncode}\n{out}\n{err}"
    assert sorted(o.strip().splitlines()[-1] for o, _ in outs) \
        == ["OK 0", "OK 1"]
