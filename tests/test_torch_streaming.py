"""Streaming TF-IDF, its checkpoints, the vectorizer and ``cli stream``
in the port (tfidf_tpu_torch/streaming.py, checkpoint.py,
models/vectorizer.py, cli.py) against the JAX package, on the same seeded
minibatches, on the CPU.

Contracts, as the port states them:

* ``StreamingTfidf`` on both engines, both wires (padded, ragged) and
  with and without ``fixed_len``: DF and ``docs_seen`` exact; top-k ids
  exact but for near-ties (``parity.compare_topk``'s 4-ulp rule); scores
  within 1 ulp of the wire format (float16 on the packed wire, float32
  on the pair wire, where the two packages' IDF logs differ by an ulp);
  the dense ``[D, V]`` scores within 1e-6 relative.
* State dicts and ``save_state`` checkpoints load across the packages in
  both directions (the JAX package writes Orbax payloads when Orbax is
  installed; the port reads them through tensorstore), and a resumed
  stream equals an uninterrupted one.
* ``TfidfVectorizer``: ``fit``/``partial_fit``/``transform``/
  ``fit_transform`` agree with the JAX package's; ``idf_`` is exact in
  float64.
* ``cli stream`` writes the JAX CLI's ``output.txt`` bytes, with and
  without a kill after a minibatch and ``--resume``, and with
  ``--mesh-docs``.
* ``StreamingTfidf(plan=)`` (CPU shards against the JAX package's forced
  CPU devices) on docs, docs x vocab, docs x seq x vocab and vocab
  meshes, both wires: DF exact against both, words bit for bit against
  the port's single-device stream, within ``compare_topk`` against the
  JAX package; the engine doctrine (an explicit sparse engine on a seq
  or vocab mesh raises, a defaulted one takes dense) and the padded
  vocab's state dict are the JAX package's.
"""

import os

import jax
import numpy as np
import pytest
import torch

from tfidf_tpu import checkpoint as jckpt
from tfidf_tpu.cli import main as jmain
from tfidf_tpu.config import PipelineConfig as JConfig
from tfidf_tpu.config import VocabMode as JVocab
from tfidf_tpu.io.corpus import Corpus as JCorpus
from tfidf_tpu.models import TfidfVectorizer as JVectorizer
from tfidf_tpu.parallel import MeshPlan as JMesh
from tfidf_tpu.streaming import StreamingTfidf as JStream

from tfidf_tpu_torch import checkpoint as tckpt
from tfidf_tpu_torch import cli as tcli
from tfidf_tpu_torch.config import PipelineConfig as TConfig
from tfidf_tpu_torch.config import VocabMode as TVocab
from tfidf_tpu_torch.io.corpus import Corpus as TCorpus
from tfidf_tpu_torch.models import TfidfVectorizer as TVectorizer
from tfidf_tpu_torch.parallel import MeshPlan as TMesh
from tfidf_tpu_torch.parity import compare_topk
from tfidf_tpu_torch.streaming import StreamingTfidf as TStream
from test_torch_hygiene import PORT_ONLY_VOCAB


def _docs(seed: int, n: int, n_words: int = 120, max_len: int = 40):
    """``n`` seeded docs: Zipf word ranks, Zipf-shaped lengths, one empty."""
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n):
        length = int(max(max_len // np.clip(rng.zipf(1.4), 1, max_len), 1))
        ranks = np.clip(rng.zipf(1.3, length), 1, n_words) - 1
        docs.append(b" ".join(b"w%d" % r for r in ranks))
    docs[n // 2] = b""
    return docs


def _minibatches(seed: int = 0, sizes=(23, 17, 30)):
    out, base = [], 0
    for i, n in enumerate(sizes):
        names = [f"doc{base + j + 1}" for j in range(n)]
        docs = _docs(seed + i, n)
        out.append((names, docs))
        base += n
    return out


def _configs(**kw):
    kw.setdefault("vocab_size", 256)
    kw.setdefault("max_doc_len", 16)
    kw.setdefault("doc_chunk", 16)
    return (JConfig(vocab_mode=JVocab.HASHED, **kw),
            TConfig(vocab_mode=TVocab.HASHED, **kw))


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def _pack_both(js, ts, names, docs, wire, fixed_len):
    jb = (js.pack_ragged if wire == "ragged" else js.pack)(
        JCorpus(names=names, docs=docs), fixed_len=fixed_len)
    tb = (ts.pack_ragged if wire == "ragged" else ts.pack)(
        TCorpus(names=names, docs=docs), fixed_len=fixed_len)
    return jb, tb


def _padded(batch):
    # either package's RaggedBatch
    return batch.to_padded() if hasattr(batch, "to_padded") else batch


def _assert_topk(jout, tout, tbatch, df, num_docs, wire_dtype):
    jv, ji = (np.asarray(x) for x in jout)
    tv, ti = (_host(x) for x in tout)
    assert tv.shape == jv.shape and ti.shape == ji.shape
    padded = _padded(tbatch)
    rep = compare_topk(ti, tv, ji, np.asarray(jv, np.float32),
                       token_ids=padded.token_ids, lengths=padded.lengths,
                       df=df, num_docs=num_docs, wire_dtype=wire_dtype)
    assert rep["ok"], rep


# --- StreamingTfidf --------------------------------------------------

@pytest.mark.parametrize("engine", ["sparse", "dense"])
@pytest.mark.parametrize("wire", ["padded", "ragged"])
@pytest.mark.parametrize("fixed_len", [None, 12])
def test_stream_matches_jax(engine, wire, fixed_len):
    jcfg, tcfg = _configs(engine=engine, topk=5)
    js, ts = JStream(jcfg), TStream(tcfg, device="cpu")
    batches = _minibatches()
    packed = []
    for names, docs in batches:
        jb, tb = _pack_both(js, ts, names, docs, wire, fixed_len)
        np.testing.assert_array_equal(_padded(tb).token_ids,
                                      np.asarray(_padded(jb).token_ids))
        if fixed_len is not None:
            assert _padded(tb).token_ids.shape[1] == fixed_len
        js.update(jb)
        ts.update(tb)
        np.testing.assert_array_equal(ts.df(), js.df())
        assert ts.docs_seen == js.docs_seen
        packed.append((jb, tb))
    # score every minibatch against the final DF (the packed word wire)
    for jb, tb in packed:
        jout, tout = js.score(jb), ts.score(tb)
        assert isinstance(tout[0], np.ndarray)  # words decoded on the host
        _assert_topk(jout, tout, tb, ts.df(), ts.docs_seen, np.float16)


@pytest.mark.parametrize("engine", ["sparse", "dense"])
@pytest.mark.parametrize("score_dtype", ["float32", "float16"])
def test_pair_wire_scores(engine, score_dtype):
    jcfg, tcfg = _configs(engine=engine, topk=4, result_wire="pair",
                          score_dtype=score_dtype)
    js, ts = JStream(jcfg), TStream(tcfg, device="cpu")
    for names, docs in _minibatches(seed=5):
        jb, tb = _pack_both(js, ts, names, docs, "padded", 16)
        js.update(jb)
        ts.update(tb)
    np.testing.assert_array_equal(ts.df(), js.df())
    jb, tb = _pack_both(js, ts, *_minibatches(seed=9)[0], "padded", 16)
    tout = ts.score(tb)
    assert isinstance(tout[0], torch.Tensor)  # the full-precision pair
    _assert_topk(js.score(jb), tout, tb, ts.df(), ts.docs_seen,
                 np.float32 if score_dtype == "float32" else np.float16)


@pytest.mark.parametrize("engine", ["sparse", "dense"])
@pytest.mark.parametrize("wire", ["padded", "ragged"])
def test_dense_scores_without_topk(engine, wire):
    jcfg, tcfg = _configs(engine=engine, vocab_size=512)
    js, ts = JStream(jcfg), TStream(tcfg, device="cpu")
    batches = _minibatches(seed=11)
    for names, docs in batches:
        jb, tb = _pack_both(js, ts, names, docs, wire, None)
        js.update(jb)
        ts.update(tb)
    jb, tb = _pack_both(js, ts, *batches[1], wire, None)
    want = np.asarray(js.score(jb))
    got = ts.score(tb)
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_score_mid_stream_and_k_clamped_to_length():
    # topk past L: k clamps to L on the sparse engine; mid-stream scores
    # use the DF folded so far
    jcfg, tcfg = _configs(topk=40, max_doc_len=8, doc_chunk=8)
    js, ts = JStream(jcfg), TStream(tcfg, device="cpu")
    names, docs = _minibatches(seed=2)[0]
    jb, tb = _pack_both(js, ts, names, docs, "padded", 8)
    js.update(jb)
    ts.update(tb)
    jout, tout = js.score(jb), ts.score(tb)
    assert tout[1].shape == (len(names), 8)
    _assert_topk(jout, tout, tb, ts.df(), ts.docs_seen, np.float16)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("engine", ["sparse", "dense"])
def test_state_dict_crosses_packages(direction, engine):
    jcfg, tcfg = _configs(engine=engine, topk=3)
    batches = _minibatches(seed=21, sizes=(12, 9, 15, 8))
    js, ts = JStream(jcfg), TStream(tcfg, device="cpu")
    for names, docs in batches[:2]:
        jb, tb = _pack_both(js, ts, names, docs, "padded", 16)
        js.update(jb)
        ts.update(tb)
    if direction == "jax_to_port":
        state = js.state_dict()
        resumed = TStream(tcfg, device="cpu")
        resumed.load_state(state)
        other = ts
    else:
        state = ts.state_dict()
        resumed = JStream(jcfg)
        resumed.load_state(state)
        other = js
    for key in ("df", "docs_seen"):
        j, t = js.state_dict()[key], ts.state_dict()[key]
        assert j.dtype == t.dtype and j.shape == t.shape
        np.testing.assert_array_equal(j, t)
    for names, docs in batches[2:]:
        for s in (resumed, other):
            cls = JCorpus if isinstance(s, JStream) else TCorpus
            s.update(s.pack(cls(names=names, docs=docs), fixed_len=16))
    assert resumed.docs_seen == other.docs_seen == 44
    np.testing.assert_array_equal(resumed.df(), other.df())


def test_state_dict_is_a_copy():
    _, tcfg = _configs(topk=3)
    ts = TStream(tcfg, device="cpu")
    names, docs = _minibatches()[0]
    ts.update(ts.pack(TCorpus(names=names, docs=docs)))
    state = ts.state_dict()
    before = state["df"].copy()
    ts.update(ts.pack(TCorpus(names=names, docs=docs)))
    np.testing.assert_array_equal(state["df"], before)
    loaded = TStream(tcfg, device="cpu")
    loaded.load_state(state)
    loaded.update(loaded.pack(TCorpus(names=names, docs=docs)))
    np.testing.assert_array_equal(state["df"], before)  # not aliased
    np.testing.assert_array_equal(loaded.df(), ts.df())
    with pytest.raises(ValueError, match="df shape"):
        loaded.load_state({"df": np.zeros(7, np.int32),
                           "docs_seen": np.asarray(1)})


@pytest.mark.parametrize("force_npz", [True, False])
def test_jax_checkpoint_restores_in_port(tmp_path, force_npz):
    jcfg, tcfg = _configs(topk=3)
    js = JStream(jcfg)
    names, docs = _minibatches(seed=4)[0]
    js.update(js.pack(JCorpus(names=names, docs=docs)))
    path = str(tmp_path / "ck")
    jckpt.save_state(path, js.state_dict(), force_npz=force_npz)
    assert tckpt.exists(path)
    ts = TStream(tcfg, device="cpu")
    ts.load_state(tckpt.restore_state(path))
    assert ts.docs_seen == js.docs_seen
    np.testing.assert_array_equal(ts.df(), js.df())


def test_port_checkpoint_restores_in_jax(tmp_path):
    jcfg, tcfg = _configs(topk=3)
    ts = TStream(tcfg, device="cpu")
    names, docs = _minibatches(seed=6)[0]
    ts.update(ts.pack(TCorpus(names=names, docs=docs)))
    path = str(tmp_path / "ck")
    assert tckpt.save_state(path, ts.state_dict()) == "npz"
    assert jckpt.exists(path)
    js = JStream(jcfg)
    js.load_state(jckpt.restore_state(path))
    assert js.docs_seen == ts.docs_seen
    np.testing.assert_array_equal(js.df(), ts.df())


def test_checkpoint_protocol(tmp_path):
    path = str(tmp_path / "ck")
    assert not tckpt.exists(path)
    with pytest.raises(FileNotFoundError):
        tckpt.restore_state(path)
    for n in (1, 2, 3):
        tckpt.save_state(path, {"df": np.full(4, n, np.int32),
                                "docs_seen": np.asarray(n)})
    assert int(tckpt.restore_state(path)["docs_seen"]) == 3
    assert sorted(e for e in os.listdir(path)
                  if e != "LOCK") == ["LATEST", "ckpt-2"]


def test_resume_equals_uninterrupted(tmp_path):
    _, tcfg = _configs(topk=4)
    batches = _minibatches(seed=8, sizes=(10, 10, 10))
    full = TStream(tcfg, device="cpu")
    for names, docs in batches:
        full.update(full.pack(TCorpus(names=names, docs=docs)))
    path = str(tmp_path / "ck")
    first = TStream(tcfg, device="cpu")
    for names, docs in batches[:2]:
        first.update(first.pack(TCorpus(names=names, docs=docs)))
        tckpt.save_state(path, first.state_dict())
    del first
    resumed = TStream(tcfg, device="cpu")
    resumed.load_state(tckpt.restore_state(path))
    assert resumed.docs_seen == 20
    resumed.update(resumed.pack(TCorpus(*batches[2])))
    assert resumed.docs_seen == full.docs_seen == 30
    np.testing.assert_array_equal(resumed.df(), full.df())
    probe = resumed.pack(TCorpus(*batches[0]))
    for a, b in zip(resumed.score(probe), full.score(probe)):
        np.testing.assert_array_equal(a, b)


def test_exact_vocab_rejected_and_plan_not_ported():
    with pytest.raises(ValueError, match="HASHED"):
        TStream(TConfig(), device="cpu")
    with pytest.raises(ValueError, match="HASHED"):
        TVectorizer(TConfig(), device="cpu")
    # Ported now (ROADMAP A9b): a plan runs the docs-sharded stream and
    # fit, equal to one device's (the parity cases below).
    plan = TMesh.create(docs=2, device="cpu")
    cfg = _configs(topk=3)[1]
    assert TStream(cfg, plan=plan).plan is plan
    names, docs = _minibatches()[0]
    got = TVectorizer(cfg, plan=plan).fit_transform(TCorpus(names, docs))
    want = TVectorizer(cfg, device="cpu").fit_transform(TCorpus(names, docs))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# --- StreamingTfidf(plan=): the docs-sharded stream --------------------

MESHES = {"docs4": {"docs": 4}, "docs3": {"docs": 3},
          "docs2_vocab2": {"docs": 2, "vocab": 2},
          "docs2_seq2_vocab2": {"docs": 2, "seq": 2, "vocab": 2},
          "vocab3": {"docs": 1, "vocab": 3}}


def _mesh_pair(mesh, **kw):
    """The JAX mesh stream (its forced CPU devices) and the port's (CPU
    shards) at one config; the port's single-device stream at the engine
    the mesh resolved."""
    import dataclasses
    jcfg, tcfg = _configs(**kw)
    n = int(np.prod(list(mesh.values())))
    jplan = JMesh.create(**mesh, devices=jax.devices()[:n])
    tplan = TMesh.create(**mesh, device="cpu")
    js, ts = JStream(jcfg, jplan), TStream(tcfg, tplan)
    assert ts._engine == js._engine
    single = TStream(dataclasses.replace(tcfg, engine=ts._engine),
                     device="cpu")
    return js, ts, single


@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
@pytest.mark.parametrize("engine", [None, "dense"])
@pytest.mark.parametrize("wire", ["padded", "ragged"])
def test_mesh_stream_matches_single_and_jax(mesh, engine, wire):
    js, ts, single = _mesh_pair(MESHES[mesh], engine=engine, topk=4)
    packed = []
    for names, docs in _minibatches(seed=3):
        jb, tb = _pack_both(js, ts, names, docs, wire, 12)
        sb = (single.pack_ragged if wire == "ragged" else single.pack)(
            TCorpus(names=names, docs=docs), fixed_len=12)
        js.update(jb)
        ts.update(tb)
        single.update(sb)
        np.testing.assert_array_equal(ts.df(), single.df())
        np.testing.assert_array_equal(ts.df(), js.df())
        assert ts.docs_seen == single.docs_seen == js.docs_seen
        packed.append((jb, tb, sb, len(names)))
    assert ts.state_dict()["df"].shape == (ts._vocab,)
    for jb, tb, sb, n in packed:
        tv, ti = ts.score(tb)
        sv, si = single.score(sb)
        # bit for bit against one device (the rows past n pad the mesh)
        np.testing.assert_array_equal(ti[:n], si[:n])
        np.testing.assert_array_equal(tv[:n].view(np.uint16),
                                      sv[:n].view(np.uint16))
        jv, ji = (np.asarray(x)[:n] for x in js.score(jb))
        rep = compare_topk(ti[:n], tv[:n], ji, np.asarray(jv, np.float32),
                           token_ids=_padded(sb).token_ids,
                           lengths=_padded(sb).lengths, df=ts.df(),
                           num_docs=ts.docs_seen, wire_dtype=np.float16)
        assert rep["ok"], rep


@pytest.mark.parametrize("mesh", ["docs4", "docs2_vocab2"])
def test_mesh_stream_pair_wire_and_dense_scores(mesh):
    # the pair wire returns tensors; topk=None the [D, V_padded] scores
    js, ts, single = _mesh_pair(MESHES[mesh], topk=4, result_wire="pair")
    names, docs = _minibatches(seed=4)[1]
    tb = ts.pack(TCorpus(names=names, docs=docs))
    ts.update(tb)
    single.update(single.pack(TCorpus(names=names, docs=docs)))
    n = len(names)
    tv, ti = ts.score(tb)
    sv, si = single.score(single.pack(TCorpus(names=names, docs=docs)))
    assert torch.equal(ti[:n], si) and torch.equal(tv[:n], sv)
    _, tcfg = _configs()
    plan = TMesh.create(**MESHES[mesh], device="cpu")
    dense_mesh = TStream(tcfg, plan)
    dense_single = TStream(tcfg, device="cpu")
    dense_mesh.update(dense_mesh.pack(TCorpus(names=names, docs=docs)))
    dense_single.update(dense_single.pack(TCorpus(names=names, docs=docs)))
    got = dense_mesh.score(dense_mesh.pack(TCorpus(names=names, docs=docs)))
    want = dense_single.score(dense_single.pack(TCorpus(names=names,
                                                        docs=docs)))
    assert got.shape[1] == dense_mesh._vocab
    assert torch.equal(got[:n, :tcfg.vocab_size], want)


def test_mesh_vocab_pads_and_state_dict_crosses():
    # V 250 over 3 vocab shards pads to 252, as the JAX package pads it
    js, ts, single = _mesh_pair(MESHES["vocab3"], vocab_size=250, topk=3,
                                engine="dense")
    assert ts._vocab == js._vocab == 252
    names, docs = _minibatches(seed=5)[0]
    ts.update(ts.pack(TCorpus(names=names, docs=docs)))
    js.update(js.pack(JCorpus(names=names, docs=docs)))
    assert ts.df().shape == (250,)
    state = ts.state_dict()
    assert state["df"].shape == (252,)
    np.testing.assert_array_equal(state["df"],
                                  np.asarray(js.state_dict()["df"]))
    back = TStream(_configs(vocab_size=250, topk=3, engine="dense")[1],
                   TMesh.create(docs=1, vocab=3, device="cpu"))
    back.load_state(js.state_dict())
    np.testing.assert_array_equal(back.df(), ts.df())
    with pytest.raises(ValueError, match="df shape"):
        back.load_state({"df": np.zeros(250, np.int32), "docs_seen": 0})


def test_mesh_engine_doctrine():
    # an explicit engine="sparse" on a seq or vocab mesh raises; a
    # defaulted one falls back to dense (capability, not preference)
    _, tcfg = _configs(engine="sparse", topk=4)
    for shape in ({"docs": 2, "vocab": 2}, {"docs": 2, "seq": 2}):
        plan = TMesh.create(**shape, device="cpu")
        with pytest.raises(ValueError, match="docs axis only"):
            TStream(tcfg, plan)
        assert TStream(_configs(topk=4)[1], plan)._engine == "dense"
    assert TStream(_configs(topk=4)[1],
                   TMesh.create(docs=4, device="cpu"))._engine == "sparse"


def test_entry_points_without_gpu_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _configs()[1]
    with pytest.raises(RuntimeError, match="no CUDA device available"):
        TStream(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device available"):
        TVectorizer(cfg)
    assert TStream(cfg, device="cpu").device.type == "cpu"


def test_update_and_score_spans(tmp_path):
    from tfidf_tpu_torch import obs
    _, tcfg = _configs(topk=3)
    ts = TStream(tcfg, device="cpu")
    names, docs = _minibatches()[0]
    batch = ts.pack(TCorpus(names=names, docs=docs))
    obs.set_tracer(obs.Tracer())
    try:
        ts.update(batch)
        ts.score(batch)
        events = obs.get_tracer().events()
    finally:
        obs.set_tracer(None)
    assert [(e[0], e[4]) for e in events] == [
        ("stream_update", {"docs": len(names)}),
        ("stream_score", {"docs": len(names)})]


# --- TfidfVectorizer -------------------------------------------------

def _corpus_pair(seed, n):
    names = [f"doc{i + 1}" for i in range(n)]
    docs = _docs(seed, n)
    return JCorpus(names=names, docs=docs), TCorpus(names=names, docs=docs)


@pytest.mark.parametrize("topk", [None, 4])
@pytest.mark.parametrize("batch_docs", [7, 64])
def test_vectorizer_fit_transform(topk, batch_docs):
    jcfg, tcfg = _configs(topk=topk, vocab_size=512)
    jv = JVectorizer(jcfg, batch_docs=batch_docs)
    tv = TVectorizer(tcfg, batch_docs=batch_docs, device="cpu")
    jc, tc = _corpus_pair(31, 40)
    jout, tout = jv.fit_transform(jc), tv.fit_transform(tc)
    assert tv.num_docs_ == jv.num_docs_ == 40
    np.testing.assert_array_equal(tv.df_, jv.df_)
    assert tv.idf_.dtype == np.float64
    np.testing.assert_array_equal(tv.idf_, jv.idf_)
    if topk is None:
        assert isinstance(tout, np.ndarray) and tout.shape == (40, 512)
        np.testing.assert_allclose(tout, np.asarray(jout), rtol=1e-6, atol=0)
    else:
        batch = tv._stream.pack(tc)
        _assert_topk(jout, tout, batch, tv.df_, 40, np.float16)


def test_vectorizer_partial_fit_and_refit():
    jcfg, tcfg = _configs(topk=3, vocab_size=512)
    jv = JVectorizer(jcfg, batch_docs=16)
    tv = TVectorizer(tcfg, batch_docs=16, device="cpu")
    (jc1, tc1), (jc2, tc2) = _corpus_pair(41, 30), _corpus_pair(42, 20)
    for v, a, b in ((jv, jc1, jc2), (tv, tc1, tc2)):
        v.fit(a)
        v.partial_fit([b])  # an iterable of minibatches
    assert tv.num_docs_ == jv.num_docs_ == 50
    np.testing.assert_array_equal(tv.df_, jv.df_)
    np.testing.assert_array_equal(tv.idf_, jv.idf_)
    _assert_topk(jv.transform(jc2), tv.transform(tc2),
                 tv._stream.pack(tc2), tv.df_, 50, np.float16)
    tv.fit(tc2)  # fit replaces the state
    assert tv.num_docs_ == 20
    state = tv.state_dict()
    other = TVectorizer(tcfg, device="cpu").load_state(state)
    np.testing.assert_array_equal(other.df_, tv.df_)


def test_vectorizer_transform_before_fit():
    tv = TVectorizer(_configs()[1], device="cpu")
    assert not tv.fitted
    with pytest.raises(RuntimeError, match="transform before fit"):
        tv.transform(TCorpus(names=["a"], docs=[b"x"]))


# --- cli stream ------------------------------------------------------

@pytest.fixture
def stream_dir(tmp_path):
    d = tmp_path / "input"
    d.mkdir()
    for i, doc in enumerate(_docs(51, 26, max_len=30)):
        (d / f"doc{i + 1}").write_bytes(doc)
    return str(d)


class _Killed(Exception):
    pass


def _kill_after(monkeypatch, saves: int):
    """The stream dies after its ``saves``-th checkpoint commit."""
    real = tckpt.save_state
    seen = []

    def save_then_die(path, state):
        out = real(path, state)
        seen.append(path)
        if len(seen) == saves:
            raise _Killed()
        return out

    monkeypatch.setattr(tckpt, "save_state", save_then_die)


@pytest.mark.parametrize("args", [
    ["--batch-docs", "8", "--vocab-size", "256", "--topk", "3"],
    ["--batch-docs", "5", "--vocab-size", "4096", "--topk", "6",
     "--doc-len", "8"],
    ["--batch-docs", "26", "--vocab-size", "65536", "--topk", "2"],
])
@pytest.mark.parametrize("native", [True, False])
def test_cli_stream_bytes_equal_jax(stream_dir, tmp_path, monkeypatch,
                                    args, native):
    if not native:
        monkeypatch.setenv("TFIDF_TPU_NO_NATIVE", "1")
    jout, tout = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    base = ["stream", "--input", stream_dir] + args
    assert jmain(base + ["--output", jout]) == 0
    assert tcli.main(base + ["--output", tout, "--device", "cpu"]) == 0
    want = open(jout, "rb").read()
    assert want and open(tout, "rb").read() == want


@pytest.mark.parametrize("kill_after", [1, 2])
def test_cli_stream_kill_and_resume(stream_dir, tmp_path, monkeypatch,
                                    kill_after):
    base = ["stream", "--input", stream_dir, "--batch-docs", "6",
            "--vocab-size", "512", "--topk", "3"]
    jout = str(tmp_path / "j.txt")
    assert jmain(base + ["--output", jout]) == 0
    ck = str(tmp_path / "ck")
    out = str(tmp_path / "t.txt")
    tbase = base + ["--output", out, "--checkpoint", ck, "--device", "cpu"]
    with monkeypatch.context() as m:
        _kill_after(m, kill_after)
        with pytest.raises(_Killed):
            tcli.main(tbase)
    assert not os.path.exists(out)
    assert int(tckpt.restore_state(ck)["docs_seen"]) == 6 * kill_after
    assert tcli.main(tbase + ["--resume"]) == 0
    assert open(out, "rb").read() == open(jout, "rb").read()
    # resuming a finished stream re-scores the whole corpus the same
    assert tcli.main(tbase + ["--resume"]) == 0
    assert open(out, "rb").read() == open(jout, "rb").read()


def test_cli_stream_resume_from_jax_checkpoint(stream_dir, tmp_path):
    base = ["stream", "--input", stream_dir, "--batch-docs", "8",
            "--vocab-size", "256", "--topk", "3"]
    ck = str(tmp_path / "ck")
    jout, tout = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    assert jmain(base + ["--output", jout, "--checkpoint", ck]) == 0
    assert tcli.main(base + ["--output", tout, "--checkpoint", ck,
                             "--resume", "--device", "cpu"]) == 0
    assert open(tout, "rb").read() == open(jout, "rb").read()


def test_cli_stream_options(stream_dir, tmp_path, monkeypatch, capsys):
    out = str(tmp_path / "t.txt")
    base = ["stream", "--input", stream_dir, "--output", out,
            "--vocab-size", "256"]
    # --mesh-docs (ROADMAP A9b, ported now): the same bytes as the JAX
    # CLI's and as one device's; --batch-docs not a multiple exits 2
    jout, plain = str(tmp_path / "j.txt"), str(tmp_path / "p.txt")
    mesh = base + ["--batch-docs", "8", "--topk", "3"]
    assert tcli.main([*mesh[:4], plain, *mesh[5:], "--device", "cpu"]) == 0
    for n in ("2", "4", "0"):
        assert tcli.main(mesh + ["--mesh-docs", n, "--device", "cpu"]) == 0
        assert open(out, "rb").read() == open(plain, "rb").read()
    assert jmain([*mesh[:4], jout, *mesh[5:], "--mesh-docs", "4"]) == 0
    assert open(jout, "rb").read() == open(plain, "rb").read()
    capsys.readouterr()
    assert tcli.main(mesh[:-4] + ["--batch-docs", "7", "--mesh-docs", "2",
                                  "--device", "cpu"]) == 2
    assert "multiple of --mesh-docs" in capsys.readouterr().err
    trace = str(tmp_path / "trace.json")
    assert tcli.main(base + ["--device", "cpu", "--timing",
                             "--trace", trace]) == 0
    err = capsys.readouterr().err
    assert "pass1_df" in err and "docs/sec" in err and trace in err
    from tfidf_tpu_torch import obs
    names = {e["name"] for e in obs.load_chrome_trace(trace)
             if e.get("ph") == "X"}
    obs.set_tracer(None)
    # the JAX CLI's stream spans: its phases (phase_or_null) and the
    # engine's device spans; less the native loader's steps, which only
    # the port records
    port_only = {name for _, _, name in PORT_ONLY_VOCAB}
    assert names - port_only == {"pass1_df", "pass2_score", "emit",
                                 "stream_update", "stream_score"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device available"):
        tcli.main(base)
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tcli.main(["stream", "--input", str(empty), "--no-strict",
                      "--device", "cpu", "--output", out]) == 1
