"""The port's mesh pipeline (``tfidf_tpu_torch.parallel``) against the JAX
package's on the CPU: virtual CPU shards on the port's side, the
conftest's 8 virtual CPU devices on the JAX side (the dense body's
Pallas kernel in interpret mode where a case asks for it, as
``tests/test_parallel.py`` runs it).

* ``MeshPlan``: axis sizes, padding, docs inference, bad shapes, CPU
  shards, a repeated device list, no CPU fallback for CUDA.
* ``ShardedPipeline`` over docs 2/4/8, {docs 2, vocab 2}, {docs 2, seq
  2} and {docs 2, seq 2, vocab 2}, both engines, top-k and full output:
  equal to the JAX ``ShardedPipeline`` and to the port's own
  single-device run; golden bytes mesh-invariant; config dispatch; an
  unknown axis; an unplanned batch grown to the mesh.
* ``long_doc_histogram`` and ``sharded_tf_df``.
* The docs-sharded device chargram (dense and sparse, docs 2 and 4)
  equal to the JAX ``run_bytes`` with a mesh and to the single-device
  one.
* ``ops.topk.topk_global`` (both lowerings) and ``topk_terms``.

Tolerances: integer outputs (counts, DF, lengths, ids and their tie
order) exact; float scores within 4 float32 ulp of the JAX package's
(IDF's log is taken in float64 in the port, ROADMAP C) and bit-equal to
the port's single-device run; the packed wire within 1 float16 ulp.
"""

import jax
import numpy as np
import pytest
import torch

import tfidf_tpu_torch as T
from tfidf_tpu import PipelineConfig as JConfig
from tfidf_tpu import TfidfPipeline as JPipeline
from tfidf_tpu.config import TokenizerKind as JTok
from tfidf_tpu.config import VocabMode as JV
from tfidf_tpu.golden import golden_output
from tfidf_tpu.io import corpus as jcorpus
from tfidf_tpu.parallel import MeshPlan as JMesh
from tfidf_tpu.parallel import ShardedPipeline as JSharded
from tfidf_tpu_torch.ops import topk as ptopk
from tfidf_tpu_torch.parallel import MeshPlan, ShardedPipeline, sharded_tf_df
from tfidf_tpu_torch.parallel.longdoc import long_doc_histogram

ULP4 = 4 * 2 ** -23
MESHES = [dict(docs=2), dict(docs=4), dict(docs=8), dict(docs=2, vocab=2),
          dict(docs=2, seq=2), dict(docs=2, seq=2, vocab=2)]


def _n(mesh):
    return int(np.prod(list(mesh.values())))


def _jplan(mesh):
    return JMesh.create(**mesh, devices=jax.devices()[:_n(mesh)])


def _corpus(n=29, seed=0, n_words=100, max_len=40):
    rng = np.random.default_rng(seed)
    names = [f"doc{i}" for i in range(1, n + 1)]
    docs = [" ".join(f"w{rng.integers(0, n_words)}"
                     for _ in range(rng.integers(0, max_len))).encode()
            for _ in names]
    return (T.Corpus(names=names, docs=docs),
            jcorpus.Corpus(names=names, docs=docs))


class TestMeshPlan:
    def test_axis_sizes_and_padding(self):
        plan = MeshPlan.create(docs=2, seq=2, vocab=2, device="cpu")
        assert (plan.n_docs_shards, plan.n_seq_shards,
                plan.n_vocab_shards) == (2, 2, 2)
        assert len(plan.devices) == 8 and set(plan.devices) == {
            torch.device("cpu")}
        assert plan.pad_docs(3) == 4 and plan.pad_docs(4) == 4
        assert plan.pad_vocab(65) == 66
        assert plan.pad_tokens(7) == 8
        assert plan.device(1, 0, 1) == torch.device("cpu")

    def test_bad_mesh_shape_raises(self):
        cpus = ["cpu"] * 8
        with pytest.raises(ValueError, match="8 devices"):
            MeshPlan.create(docs=3, devices=cpus)
        with pytest.raises(ValueError, match="divisible"):
            MeshPlan.create(vocab=3, devices=cpus)
        with pytest.raises(ValueError):
            JMesh.create(docs=3, devices=jax.devices()[:8])

    def test_docs_inference(self):
        assert MeshPlan.create(vocab=2, devices=["cpu"] * 8).n_docs_shards \
            == 4 == JMesh.create(vocab=2, devices=jax.devices()[:8]
                                 ).n_docs_shards
        assert MeshPlan.create(device="cpu").shape == (1, 1, 1)

    def test_repeated_devices_are_virtual_shards(self):
        plan = MeshPlan.create(docs=4, devices=["cpu", "cpu", "cpu", "cpu"])
        assert plan.shape == (4, 1, 1) and plan.n_local_docs == 4

    def test_no_silent_cpu(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MeshPlan.create(docs=2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MeshPlan.create(docs=2, devices=["cuda:0", "cuda:0"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.TfidfPipeline(T.PipelineConfig(mesh_shape={"docs": 2}))

    def test_collectives_keep_shard_order(self):
        plan = MeshPlan.create(docs=3, device="cpu")
        parts = [torch.full((2,), i, dtype=torch.int32) for i in range(3)]
        assert plan.psum(parts).tolist() == [3, 3]
        assert plan.all_gather(parts).tolist() == [0, 0, 1, 1, 2, 2]


def _cfgs(engine, topk, **kw):
    base = dict(vocab_size=64, max_doc_len=64, doc_chunk=64, topk=topk,
                engine=engine, **kw)
    return (T.PipelineConfig(vocab_mode=T.VocabMode.HASHED, **base),
            JConfig(vocab_mode=JV.HASHED, **base))


CASES = [(m, e, k) for m in MESHES for e in ("dense", "sparse")
         for k in (None, 4)
         if e == "dense" or (m.get("seq", 1) == 1 and m.get("vocab", 1) == 1)]


@pytest.mark.parametrize("mesh,engine,topk", CASES)
def test_sharded_pipeline_equals_jax_and_single(mesh, engine, topk):
    pc, jc = _corpus()
    pcfg, jcfg = _cfgs(engine, topk, result_wire="pair")
    got = ShardedPipeline(MeshPlan.create(**mesh, device="cpu"),
                          pcfg).run(pc)
    want = JSharded(_jplan(mesh), jcfg).run(jc)
    single = T.TfidfPipeline(pcfg, device="cpu").run(pc)
    d = len(pc)
    assert got.names[:d] == pc.names and set(got.names[d:]) <= {""}
    np.testing.assert_array_equal(got.df, np.asarray(want.df))
    np.testing.assert_array_equal(got.df, single.df)
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))
    if topk is not None:
        np.testing.assert_array_equal(got.topk_ids, np.asarray(want.topk_ids))
        np.testing.assert_allclose(got.topk_vals, np.asarray(want.topk_vals),
                                   rtol=ULP4, atol=0)
        np.testing.assert_array_equal(got.topk_ids[:d], single.topk_ids)
        np.testing.assert_array_equal(got.topk_vals[:d], single.topk_vals)
    elif engine == "dense":
        np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
        np.testing.assert_allclose(got.scores, np.asarray(want.scores),
                                   rtol=ULP4, atol=0)
        np.testing.assert_array_equal(got.counts[:d], single.counts)
        np.testing.assert_array_equal(got.scores[:d], single.scores)
    else:
        for field in ("sparse_ids", "sparse_counts", "sparse_head"):
            np.testing.assert_array_equal(getattr(got, field),
                                          np.asarray(getattr(want, field)))
            np.testing.assert_array_equal(getattr(got, field)[:d],
                                          getattr(single, field))


@pytest.mark.parametrize("mesh", [dict(docs=4), dict(docs=2)])
def test_sparse_packed_wire_equals_single(mesh):
    # The packed result wire: each shard's pack kernel, the words equal
    # to the single-device run's and within 1 float16 ulp of the JAX
    # package's.
    pc, jc = _corpus()
    pcfg, jcfg = _cfgs("sparse", 4)
    got = ShardedPipeline(MeshPlan.create(**mesh, device="cpu"),
                          pcfg).run(pc)
    want = JSharded(_jplan(mesh), jcfg).run(jc)
    single = T.TfidfPipeline(pcfg, device="cpu").run(pc)
    d = len(pc)
    np.testing.assert_array_equal(got.topk_ids[:d], single.topk_ids)
    np.testing.assert_array_equal(got.topk_vals[:d], single.topk_vals)
    np.testing.assert_array_equal(got.topk_ids, np.asarray(want.topk_ids))
    np.testing.assert_allclose(got.topk_vals, np.asarray(want.topk_vals),
                               rtol=2 ** -10, atol=0)


def test_dense_pallas_body_equals_jax(toy_corpus_dir):
    # The JAX package's Pallas shard body (interpret mode) at vocab and
    # seq offsets, against the port's TF/DF-kernel body.
    mesh = dict(docs=2, seq=2, vocab=2)
    base = dict(engine="dense", vocab_mode=JV.HASHED, vocab_size=256,
                max_doc_len=64, doc_chunk=64)
    want = JSharded(_jplan(mesh), JConfig(use_pallas=True, **base)).run(
        jcorpus.discover_corpus(toy_corpus_dir))
    got = ShardedPipeline(
        MeshPlan.create(**mesh, device="cpu"),
        T.PipelineConfig(engine="dense", vocab_mode=T.VocabMode.HASHED,
                         vocab_size=256, max_doc_len=64, doc_chunk=64)).run(
        T.discover_corpus(toy_corpus_dir))
    np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
    np.testing.assert_array_equal(got.df, np.asarray(want.df))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores),
                               rtol=ULP4, atol=0)


@pytest.mark.parametrize("mesh", [dict(docs=8), dict(docs=4, vocab=2),
                                  dict(docs=2, seq=2, vocab=2)])
def test_golden_bytes_mesh_invariant(toy_corpus_dir, mesh):
    corpus = T.discover_corpus(toy_corpus_dir)
    cfg = T.PipelineConfig(vocab_mode=T.VocabMode.HASHED, vocab_size=1 << 15,
                           max_doc_len=64, doc_chunk=64)
    got = ShardedPipeline(MeshPlan.create(**mesh, device="cpu"),
                          cfg).run(corpus).output_bytes()
    assert got == golden_output(jcorpus.discover_corpus(toy_corpus_dir))
    exact = T.TfidfPipeline(T.PipelineConfig(mesh_shape=mesh),
                            device="cpu").run(corpus).output_bytes()
    assert exact == got


def test_mesh_shape_config_dispatch():
    pc, jc = _corpus()
    base = dict(engine="dense", vocab_size=64, max_doc_len=64, doc_chunk=64)
    meshed = T.TfidfPipeline(T.PipelineConfig(
        vocab_mode=T.VocabMode.HASHED, mesh_shape={"docs": 4, "vocab": 2},
        **base), device="cpu").run(pc)
    want = JPipeline(JConfig(vocab_mode=JV.HASHED,
                             mesh_shape={"docs": 4, "vocab": 2},
                             **base)).run(jc)
    single = T.TfidfPipeline(T.PipelineConfig(
        vocab_mode=T.VocabMode.HASHED, **base), device="cpu").run(pc)
    d = single.counts.shape[0]
    np.testing.assert_array_equal(meshed.counts, np.asarray(want.counts))
    np.testing.assert_array_equal(meshed.counts[:d], single.counts)
    np.testing.assert_array_equal(meshed.df, single.df)
    # a defaulted sparse engine falls back to dense on a vocab mesh;
    # an explicit one is refused
    dflt = T.TfidfPipeline(T.PipelineConfig(
        vocab_mode=T.VocabMode.HASHED, vocab_size=64, topk=3,
        mesh_shape={"docs": 2, "vocab": 2}), device="cpu").run(pc)
    assert dflt.topk_ids.shape == (30, 3)
    with pytest.raises(ValueError, match="docs axis only"):
        T.TfidfPipeline(T.PipelineConfig(
            vocab_mode=T.VocabMode.HASHED, vocab_size=64, topk=3,
            engine="sparse", mesh_shape={"docs": 2, "vocab": 2}),
            device="cpu").run(pc)


def test_mesh_shape_unknown_axis_raises(toy_corpus_dir):
    cfg = T.PipelineConfig(vocab_mode=T.VocabMode.HASHED,
                           mesh_shape={"ranks": 8})
    with pytest.raises(ValueError, match="ranks"):
        T.TfidfPipeline(cfg, device="cpu").run(
            T.discover_corpus(toy_corpus_dir))
    with pytest.raises(ValueError, match="ignored by ShardedPipeline"):
        ShardedPipeline(MeshPlan.create(docs=2, device="cpu"),
                        T.PipelineConfig(mesh_shape={"docs": 2})).run(
            T.discover_corpus(toy_corpus_dir))


def test_run_packed_pads_unplanned_batch():
    pc, _ = _corpus(n=13)
    cfg = T.PipelineConfig(engine="dense", vocab_mode=T.VocabMode.HASHED,
                           vocab_size=64, max_doc_len=60, doc_chunk=60)
    pipe = T.TfidfPipeline(cfg, device="cpu")
    batch = pipe.pack(pc)
    sharded = ShardedPipeline(MeshPlan.create(docs=8, seq=2, device="cpu"),
                              cfg).run_packed(batch)
    single = pipe.run_packed(batch)
    assert sharded.counts.shape[0] == 16 and sharded.names[13:] == [""] * 3
    np.testing.assert_array_equal(sharded.counts[:13], single.counts)
    np.testing.assert_array_equal(sharded.df, single.df)
    # a RaggedBatch under a mesh is rebuilt into the padded batch first
    rb = T.pack_ragged(pc, cfg)
    meshed = T.TfidfPipeline(dataclass_replace(cfg, mesh_shape={"docs": 2}),
                             device="cpu").run_packed(rb)
    np.testing.assert_array_equal(meshed.counts[:13], single.counts)


def dataclass_replace(cfg, **kw):
    import dataclasses
    return dataclasses.replace(cfg, **kw)


def test_sharded_topk_ties_go_to_the_lower_id():
    # Every term scores the same in a doc with each word once: the
    # vocab-sharded top-k must keep the lowest ids, as one device does.
    names = ["doc1", "doc2", "doc3", "doc4"]
    docs = [b"a b c d e f g h", b"a b c d e f g h i j", b"x", b"y z"]
    pc = T.Corpus(names=names, docs=docs)
    jc = jcorpus.Corpus(names=names, docs=docs)
    pcfg, jcfg = _cfgs("dense", 4, result_wire="pair")
    mesh = dict(docs=2, vocab=4)
    got = ShardedPipeline(MeshPlan.create(**mesh, device="cpu"),
                          pcfg).run(pc)
    want = JSharded(_jplan(mesh), jcfg).run(jc)
    single = T.TfidfPipeline(pcfg, device="cpu").run(pc)
    np.testing.assert_array_equal(got.topk_ids, np.asarray(want.topk_ids))
    np.testing.assert_array_equal(got.topk_ids, single.topk_ids)


class TestLongDoc:
    def test_mesh_wide_histogram_exact(self):
        from tfidf_tpu.parallel.longdoc import long_doc_histogram as jax_hist
        rng = np.random.default_rng(3)
        toks = rng.integers(0, 50, size=1024).astype(np.int32)
        got = long_doc_histogram(MeshPlan.create(docs=2, seq=2, vocab=2,
                                                 device="cpu"),
                                 toks, 1000, 64).numpy()
        want = np.asarray(jax_hist(_jplan(dict(docs=2, seq=2, vocab=2)),
                                   toks, 1000, 64))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.bincount(toks[:1000],
                                                       minlength=64))
        with pytest.raises(ValueError, match="split"):
            long_doc_histogram(MeshPlan.create(docs=3, device="cpu"),
                               toks, 10, 64)

    def test_sharded_tf_df(self):
        rng = np.random.default_rng(5)
        toks = rng.integers(0, 40, size=(8, 16)).astype(np.int32)
        lens = rng.integers(0, 17, size=8).astype(np.int32)
        plan = MeshPlan.create(docs=2, seq=2, vocab=2, device="cpu")
        counts, df = sharded_tf_df(plan, toks, lens, 40)
        from tfidf_tpu.parallel import sharded_tf_df as jax_tf_df
        jc, jdf = jax_tf_df(_jplan(dict(docs=2, seq=2, vocab=2)), toks, lens,
                            40)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(df.numpy(), np.asarray(jdf))


def _chargram_corpus():
    names = [f"doc{i}" for i in range(1, 12)]
    docs = [bytes(f"doc {i} body {'x' * i} tail {i * 7}", "ascii")
            for i in range(1, 12)]
    return (T.Corpus(names=names, docs=docs),
            jcorpus.Corpus(names=names, docs=docs))


@pytest.mark.parametrize("docs", [2, 4])
@pytest.mark.parametrize("engine", ["dense", "sparse"])
def test_sharded_chargram(docs, engine):
    pc, jc = _chargram_corpus()
    kw = dict(tokenizer=T.TokenizerKind.CHARGRAM, vocab_size=1 << 12,
              ngram_range=(2, 3), topk=4, hash_seed=3)
    if engine == "sparse":
        kw["engine"] = "sparse"
    pcfg = T.PipelineConfig(vocab_mode=T.VocabMode.HASHED,
                            result_wire="pair", mesh_shape={"docs": docs},
                            **kw)
    got = T.TfidfPipeline(pcfg, device="cpu").run(pc)
    single = T.TfidfPipeline(dataclass_replace(pcfg, mesh_shape={}),
                             device="cpu").run_bytes(pc)
    jkw = dict(kw, tokenizer=JTok.CHARGRAM)
    # The JAX mesh takes all 8 test devices: rows past the corpus differ
    # only in padding.
    want = JPipeline(JConfig(vocab_mode=JV.HASHED,
                             mesh_shape={"docs": 8}, **jkw)).run(jc)
    n = len(pc)
    assert got.id_to_word == {} and got.names[:n] == pc.names
    assert len(got.names) == MeshPlan.create(
        docs=docs, device="cpu").pad_docs(n)
    np.testing.assert_array_equal(got.df, np.asarray(want.df))
    np.testing.assert_array_equal(got.lengths[:n],
                                  np.asarray(want.lengths)[:n])
    np.testing.assert_array_equal(got.topk_ids[:n],
                                  np.asarray(want.topk_ids)[:n])
    np.testing.assert_allclose(got.topk_vals[:n],
                               np.asarray(want.topk_vals)[:n],
                               rtol=ULP4, atol=0)
    for field in ("df", "lengths", "topk_ids", "topk_vals"):
        np.testing.assert_array_equal(getattr(got, field)[:n]
                                      if field != "df" else got.df,
                                      getattr(single, field))
    # the packed wire: each shard's words equal the single run's
    packed = dataclass_replace(pcfg, result_wire="packed")
    g2 = T.TfidfPipeline(packed, device="cpu").run(pc)
    s2 = T.TfidfPipeline(dataclass_replace(packed, mesh_shape={}),
                         device="cpu").run(pc)
    np.testing.assert_array_equal(g2.topk_vals[:n], s2.topk_vals)
    np.testing.assert_array_equal(g2.topk_ids[:n], s2.topk_ids)


class TestTopk:
    def test_global_and_terms_equal_jax(self):
        from tfidf_tpu.ops.topk import topk_global, topk_terms
        s = np.array([[0.1, 0.9, 0.3], [0.8, 0.2, 0.0]], np.float32)
        gv, gd, gi = ptopk.topk_global(torch.from_numpy(s), 2)
        jv, jd, ji = topk_global(s, 2)
        assert gd.tolist() == np.asarray(jd).tolist() == [0, 1]
        assert gi.tolist() == np.asarray(ji).tolist() == [1, 0]
        np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))
        tv, ti = ptopk.topk_terms(torch.from_numpy(s), 2)
        jtv, jti = topk_terms(s, 2)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(jti))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jtv), rtol=ULP4)

    @pytest.mark.parametrize("k", [1, 4, 9, 60])
    def test_ties_and_both_lowerings(self, k):
        from tfidf_tpu.ops.topk import _topk_global_two_stage as jax_two
        from tfidf_tpu.ops.topk import topk_global
        rng = np.random.default_rng(k)
        # distinct scores: both lowerings select the same records
        s = rng.permutation(60).reshape(6, 10).astype(np.float32)
        flat = ptopk.topk_global(torch.from_numpy(s), k)
        two = ptopk._topk_global_two_stage(torch.from_numpy(s), k)
        jflat, jtwo = topk_global(s, k), jax_two(s, k)
        for a, b, c, e in zip(flat, two, jflat, jtwo):
            assert a.tolist() == b.tolist() == np.asarray(c).tolist() \
                == np.asarray(e).tolist()
        # heavy ties: each lowering's order is the JAX lowering's
        t = rng.integers(0, 3, size=(6, 10)).astype(np.float32)
        for mine, theirs in ((ptopk.topk_global(torch.from_numpy(t), k),
                              topk_global(t, k)),
                             (ptopk._topk_global_two_stage(
                                 torch.from_numpy(t), k), jax_two(t, k))):
            for a, c in zip(mine, theirs):
                assert a.tolist() == np.asarray(c).tolist()

    def test_overflow_guard_names_bound(self):
        huge = torch.empty((1 << 16, 1 << 16), device="meta")
        with pytest.raises(ValueError, match="int32"):
            ptopk._topk_global_two_stage(huge, 1 << 16)
        out = ptopk._topk_global_two_stage(
            torch.empty((1 << 10, 1 << 10), device="meta"), 8)
        assert out[0].shape == (8,)
