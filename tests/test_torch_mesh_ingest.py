"""The port's mesh ingest and the multi-process hooks of
``tfidf_tpu_torch.ingest.run_overlapped`` against the JAX package's, on
the CPU (the port on virtual CPU shards, the JAX package on the
conftest's 8 virtual CPU devices).

* ``run_overlapped(plan=)``, resident (``"resident-mesh"``) and
  streaming (``"streaming-mesh"``), at chunk sizes that do and do not
  divide by the shard count, on the packed and the pair result wires and
  with ``wire_vals=False``: equal to the JAX mesh ingest and to the
  port's single-device ``run_overlapped``; the resident budget and the
  triple cache scale with the cards, so virtual shards pick the regime
  one device picks; the docs axis only; no documents.
* ``run_overlapped(shard=, df_merge=, total_docs=)`` in both regimes,
  equal to the JAX package's with the same hooks and to the rows of a
  full run.

Tolerances: DF, lengths and ids exact; the pair wire's float32 scores
within 4 ulp of the JAX package's (IDF's log, ROADMAP C), the packed
wire's within 1 float16 ulp; against the port's own single-device run
everything is bit-equal. Both packages run their Python packers
(``TFIDF_TPU_NO_NATIVE=1``).
"""

import jax
import numpy as np
import pytest
import torch

import tfidf_tpu_torch as T
from tfidf_tpu.config import PipelineConfig as JConfig
from tfidf_tpu.config import VocabMode as JV
from tfidf_tpu.ingest import run_overlapped as jax_run
from tfidf_tpu.parallel import MeshPlan as JMesh
from tfidf_tpu_torch.ingest import run_overlapped
from tfidf_tpu_torch.parallel import MeshPlan


@pytest.fixture(autouse=True)
def _python_packers(monkeypatch):
    monkeypatch.setenv("TFIDF_TPU_NO_NATIVE", "1")
    for var in ("TFIDF_TPU_RESIDENT_ELEMS", "TFIDF_TPU_TRIPLE_CACHE_BYTES",
                "TFIDF_TPU_MAX_CHUNKS"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_ingest") / "input"
    d.mkdir()
    rng = np.random.default_rng(3)
    for i in range(1, 41):
        (d / f"doc{i}").write_text(
            " ".join(f"w{rng.integers(0, 300)}"
                     for _ in range(rng.integers(1, 90))))
    return str(d)


def _cfgs(result_wire="packed"):
    return (T.PipelineConfig(vocab_mode=T.VocabMode.HASHED, vocab_size=2048,
                             topk=4, result_wire=result_wire),
            JConfig(vocab_mode=JV.HASHED, vocab_size=2048, topk=4,
                    result_wire=result_wire))


def _plans(shards):
    return (MeshPlan.create(docs=shards, device="cpu"),
            JMesh.create(docs=shards, devices=jax.devices()[:shards]))


def _runs(corpus_dir, shards, chunk, result_wire="packed", **kw):
    pcfg, jcfg = _cfgs(result_wire)
    pplan, jplan = _plans(shards)
    got = run_overlapped(corpus_dir, pcfg, chunk_docs=chunk, doc_len=64,
                         plan=pplan, **kw)
    want = jax_run(corpus_dir, jcfg, chunk_docs=chunk, doc_len=64,
                   plan=jplan, **kw)
    single = run_overlapped(corpus_dir, pcfg, chunk_docs=chunk, doc_len=64,
                            device="cpu", **kw)
    return got, want, single


def _assert_vs_jax(got, want, result_wire):
    np.testing.assert_array_equal(got.df, np.asarray(want.df))
    np.testing.assert_array_equal(got.topk_ids, want.topk_ids)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert got.path == want.path and got.df_occupied == want.df_occupied
    assert got.names == want.names and got.num_docs == want.num_docs
    assert got.result_wire == want.result_wire
    assert got.bytes_off_wire_pair == want.bytes_off_wire_pair
    if got.topk_vals is None:
        assert want.topk_vals is None
    else:
        rtol = 2 ** -10 if result_wire == "packed" else 4 * 2 ** -23
        np.testing.assert_allclose(got.topk_vals, want.topk_vals,
                                   rtol=rtol, atol=0)


def _assert_same(got, single, ids=True):
    np.testing.assert_array_equal(got.df, single.df)
    np.testing.assert_array_equal(got.lengths, single.lengths)
    if ids:
        np.testing.assert_array_equal(got.topk_ids, single.topk_ids)
    if got.topk_vals is not None:
        np.testing.assert_array_equal(got.topk_vals, single.topk_vals)


@pytest.mark.parametrize("regime", ["resident", "streaming"])
@pytest.mark.parametrize("shards,chunk", [(4, 16), (8, 13), (3, 7), (2, 64)])
@pytest.mark.parametrize("result_wire", ["packed", "pair"])
def test_mesh_ingest_equals_jax_and_single(corpus_dir, monkeypatch, regime,
                                           shards, chunk, result_wire):
    if regime == "streaming":
        monkeypatch.setenv("TFIDF_TPU_RESIDENT_ELEMS", "0")
    got, want, single = _runs(corpus_dir, shards, chunk, result_wire)
    assert got.path == f"{regime}-mesh" and single.path == regime
    assert got.wire == "padded"
    _assert_vs_jax(got, want, result_wire)
    _assert_same(got, single)


@pytest.mark.parametrize("shards,chunk", [(4, 16), (3, 7)])
def test_ids_only_wire(corpus_dir, shards, chunk):
    # wire_vals=False: the scores stay on the devices, -1 in a missing
    # pick (the single-device wire reads bucket 0 there instead).
    got, want, single = _runs(corpus_dir, shards, chunk, wire_vals=False)
    assert got.topk_vals is None and got.path == "resident-mesh"
    _assert_vs_jax(got, want, "packed")
    full = run_overlapped(corpus_dir, _cfgs()[0], chunk_docs=chunk,
                          doc_len=64, plan=_plans(shards)[0])
    np.testing.assert_array_equal(got.topk_ids, full.topk_ids)
    np.testing.assert_array_equal(
        np.where(full.topk_ids >= 0, full.topk_ids, 0), single.topk_ids)


def test_streaming_mesh_partial_cache_and_spill(corpus_dir, monkeypatch):
    # 5 chunks of 8 docs x 64 slots: a chunk caches 8 x 64 x 9 + 8 x 4
    # bytes, so a budget of 10,000 on the one device both virtual shards
    # share holds two of them; the rest come back from host RAM or a
    # re-read.
    monkeypatch.setenv("TFIDF_TPU_RESIDENT_ELEMS", "0")
    monkeypatch.setenv("TFIDF_TPU_TRIPLE_CACHE_BYTES", "10000")
    for spill in ("host", "reread"):
        got, want, single = _runs(corpus_dir, 2, 8, spill=spill)
        assert got.phases["triple_cached_chunks"] == 2.0
        assert single.phases["triple_cached_chunks"] == 2.0
        _assert_vs_jax(got, want, "packed")
        _assert_same(got, single)


def test_resident_budget_scales_with_cards(corpus_dir, monkeypatch):
    # 40 docs x 64 slots = 2,560 > 1,024: four virtual shards share one
    # device's budget, so they stream as the single device does (the JAX
    # package's four devices hold 4 x 1,024 and stay resident); every
    # result agrees. At 2,560 the same plan is resident.
    monkeypatch.setenv("TFIDF_TPU_RESIDENT_ELEMS", "1024")
    got, want, single = _runs(corpus_dir, 4, 16)
    assert (got.path, want.path, single.path) == (
        "streaming-mesh", "resident-mesh", "streaming")
    _assert_same(got, single)
    np.testing.assert_array_equal(got.df, np.asarray(want.df))
    np.testing.assert_array_equal(got.topk_ids, want.topk_ids)
    monkeypatch.setenv("TFIDF_TPU_RESIDENT_ELEMS", "2560")
    resident = run_overlapped(corpus_dir, _cfgs()[0], chunk_docs=16,
                              doc_len=64, plan=_plans(4)[0])
    assert resident.path == "resident-mesh"
    _assert_same(resident, got)


@pytest.mark.parametrize("devices,world,cards", [
    (["cuda:0"] * 4, 1, 1), (["cuda:0", "cuda:1"] * 2, 1, 2),
    (["cuda:0", "cuda:1", "cuda:2", "cuda:3"], 1, 4), (["cuda:0"] * 2, 2, 2),
])
def test_budget_cards(devices, world, cards):
    # The per-card budgets scale with the distinct devices of every
    # process, never with virtual shards (the plan is built directly:
    # no card is touched).
    plan = MeshPlan(tuple(torch.device(d) for d in devices),
                    (len(devices) * world, 1, 1), 0, world)
    assert plan.n_cards == cards


def test_docs_axis_only_and_empty(corpus_dir, tmp_path):
    plan = MeshPlan.create(docs=2, vocab=2, device="cpu")
    with pytest.raises(ValueError, match="docs axis only"):
        run_overlapped(corpus_dir, _cfgs()[0], doc_len=64, plan=plan)
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no documents"):
        run_overlapped(str(tmp_path / "empty"), _cfgs()[0], doc_len=64,
                       plan=MeshPlan.create(docs=2, device="cpu"))


@pytest.mark.parametrize("regime", ["resident", "streaming"])
@pytest.mark.parametrize("result_wire", ["packed", "pair"])
def test_multiprocess_hooks(corpus_dir, monkeypatch, regime, result_wire):
    # One worker's view of a 3-way split: its shard's rows against the
    # global DF (df_merge adds the other workers' DF) and the global
    # document count equal the same rows of the full run, and the JAX
    # package's with the same hooks.
    if regime == "streaming":
        monkeypatch.setenv("TFIDF_TPU_RESIDENT_ELEMS", "0")
    pcfg, jcfg = _cfgs(result_wire)
    full = run_overlapped(corpus_dir, pcfg, chunk_docs=8, doc_len=64,
                          device="cpu")
    rest = (full.df - run_overlapped(corpus_dir, pcfg, chunk_docs=8,
                                     doc_len=64, device="cpu",
                                     shard=(13, 27)).df).astype(np.int32)
    seen = []

    def merge(df):
        seen.append(df.dtype)
        return df + rest

    kw = dict(shard=(13, 27), total_docs=40, df_merge=merge)
    got = run_overlapped(corpus_dir, pcfg, chunk_docs=8, doc_len=64,
                         device="cpu", **kw)
    want = jax_run(corpus_dir, jcfg, chunk_docs=8, doc_len=64, **kw)
    assert seen == [np.dtype(np.int32)] * 2
    assert got.path == regime and got.names == full.names[13:27]
    np.testing.assert_array_equal(got.df, full.df)
    np.testing.assert_array_equal(got.topk_ids, full.topk_ids[13:27])
    np.testing.assert_array_equal(got.topk_vals, full.topk_vals[13:27])
    _assert_vs_jax(got, want, result_wire)
    with pytest.raises(ValueError, match="outside corpus"):
        run_overlapped(corpus_dir, pcfg, doc_len=64, device="cpu",
                       shard=(30, 50))
