"""The port's pipeline end to end (tfidf_tpu_torch.TfidfPipeline on the
CPU) against tfidf_tpu.TfidfPipeline on the same corpus.

Tolerances: integer outputs (counts, DF, lengths, packed token ids) and
``output.txt`` bytes are exact — the double math runs on the host. Top-k
ids are exact except where two candidates' exact scores lie within 4
float32 ulp (the two frameworks' float32 ``log`` differ by an ulp, so
such near-ties may swap); scores agree within 1 ulp of the wire format
(float32 on the pair wire, float16 on the packed wire). See
tfidf_tpu_torch/parity.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import tfidf_tpu as J
import tfidf_tpu_torch as T
from tfidf_tpu.config import VocabMode as JV
from tfidf_tpu.golden import golden_output as jax_golden_output
from tfidf_tpu.io.corpus import pack_corpus as jax_pack_corpus
from tfidf_tpu_torch.config import VocabMode as TV
from tfidf_tpu_torch.golden import golden_output
from tfidf_tpu_torch.interop import batch_from_numpy
from tfidf_tpu_torch.parity import compare_topk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _corpora(docs):
    names = [f"doc{i + 1}" for i in range(len(docs))]
    return J.Corpus(names=names, docs=docs), T.Corpus(names=names, docs=docs)


def _zipf_docs(seed=3, n_docs=150, n_words=400, max_len=64):
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n_docs):
        n = int(max(max_len // np.clip(rng.zipf(1.3), 1, max_len), 1))
        ranks = np.clip(rng.zipf(1.3, n), 1, n_words) - 1
        docs.append(b" ".join(b"w%d" % r for r in ranks))
    docs[5] = b""  # an empty doc: all-padding row
    return docs


def _run_both(docs, **kw):
    jc, tc = _corpora(docs)
    jr = J.TfidfPipeline(J.PipelineConfig(**kw)).run(jc)
    tkw = dict(kw)
    if "vocab_mode" in tkw:
        tkw["vocab_mode"] = TV(tkw["vocab_mode"].value)
    tr = T.TfidfPipeline(T.PipelineConfig(**tkw), device="cpu").run(tc)
    return jr, tr


def _assert_topk_agrees(jr, tr, batch, wire_dtype):
    np.testing.assert_array_equal(tr.df, np.asarray(jr.df))
    rep = compare_topk(tr.topk_ids, tr.topk_vals, np.asarray(jr.topk_ids),
                       np.asarray(jr.topk_vals, np.float32),
                       token_ids=batch.token_ids, lengths=batch.lengths,
                       df=tr.df, num_docs=batch.num_docs,
                       wire_dtype=wire_dtype)
    assert rep["ok"], rep


class TestGoldenBytes:
    @pytest.mark.parametrize("kw", [
        {},
        {"doc_chunk": 8, "max_doc_len": 8},  # L a doc_chunk multiple > chunk
    ])
    def test_toy_corpus(self, toy_corpus_dir, kw):
        corpus = T.discover_corpus(toy_corpus_dir)
        cfg = T.PipelineConfig(vocab_mode=TV.EXACT, **kw)
        ours = T.TfidfPipeline(cfg, device="cpu").run(corpus).output_bytes()
        jcorpus = J.discover_corpus(toy_corpus_dir)
        theirs = J.TfidfPipeline(J.PipelineConfig(vocab_mode=JV.EXACT, **kw)
                                 ).run(jcorpus).output_bytes()
        assert ours == theirs == golden_output(corpus) \
            == jax_golden_output(jcorpus)

    @pytest.mark.parametrize("docs", [
        [b"a b", b"b b"],              # idf 0 for a word in every doc
        [b"w"] * 10,                   # doc10 sorts before doc2
        [b"x y x", b"", b"  \n", b"y"],  # empty and whitespace-only docs
    ])
    def test_small_corpora(self, docs):
        jr, tr = _run_both(docs, vocab_mode=JV.EXACT)
        _, tc = _corpora(docs)
        assert tr.output_bytes() == jr.output_bytes() == golden_output(tc)

    def test_long_docs_two_chunks(self):
        # L = 2 x doc_chunk: the TF/DF kernel takes any L in one launch
        docs = [b" ".join(b"t%d" % (i % 5) for i in range(16)), b"t1 t2 t9"]
        _, tc = _corpora(docs)
        cfg = T.PipelineConfig(vocab_mode=TV.EXACT, doc_chunk=8, max_doc_len=8)
        pipe = T.TfidfPipeline(cfg, device="cpu")
        assert pipe.pack(tc).token_ids.shape[1] == 16
        jr, tr = _run_both(docs, vocab_mode=JV.EXACT, doc_chunk=8,
                           max_doc_len=8)
        assert tr.output_bytes() == jr.output_bytes() == golden_output(tc)

    def test_padding_docs_do_not_change_output(self, toy_corpus_dir):
        corpus = T.discover_corpus(toy_corpus_dir)
        pipe = T.TfidfPipeline(T.PipelineConfig.golden(), device="cpu")
        batch = pipe.pack(corpus, pad_docs_to=8)
        assert batch.token_ids.shape[0] == 8
        assert pipe.run_packed(batch).output_bytes() == golden_output(corpus)

    def test_hashed_no_collisions_matches_golden(self, toy_corpus_dir):
        corpus = T.discover_corpus(toy_corpus_dir)
        cfg = T.PipelineConfig(vocab_mode=TV.HASHED, vocab_size=1 << 20)
        assert cfg.engine == "sparse"
        result = T.TfidfPipeline(cfg, device="cpu").run(corpus)
        assert result.output_bytes() == golden_output(corpus)

    def test_counts_row_sums(self, toy_corpus_dir):
        corpus = T.discover_corpus(toy_corpus_dir)
        r = T.TfidfPipeline(T.PipelineConfig.golden(), device="cpu").run(corpus)
        assert (r.counts.sum(axis=1) == r.lengths[:r.num_docs]).all()


class TestHashedTopk:
    @pytest.mark.parametrize("engine,vocab", [("sparse", 1024),
                                              ("sparse", 1 << 16),
                                              ("dense", 256)])
    @pytest.mark.parametrize("wire", ["packed", "pair"])
    def test_matches_jax(self, engine, vocab, wire):
        docs = _zipf_docs()
        kw = dict(vocab_mode=JV.HASHED, vocab_size=vocab, topk=5,
                  engine=engine, result_wire=wire, max_doc_len=64,
                  doc_chunk=64)
        jr, tr = _run_both(docs, **kw)
        jc, tc = _corpora(docs)
        jb = jax_pack_corpus(jc, J.PipelineConfig(**kw))
        tb = T.pack_corpus(tc, T.PipelineConfig(
            **{**kw, "vocab_mode": TV.HASHED}))
        # the port's own packer: the same ids and lengths as the JAX one
        np.testing.assert_array_equal(tb.token_ids, jb.token_ids)
        np.testing.assert_array_equal(tb.lengths, jb.lengths)
        assert tb.id_to_word == jb.id_to_word
        assert tr.topk_vals.dtype == np.float32
        _assert_topk_agrees(jr, tr, tb,
                            np.float16 if wire == "packed" else np.float32)
        # a JAX-packed batch through the port: exactly the port's run
        tcfg = T.PipelineConfig(**{**kw, "vocab_mode": TV.HASHED})
        viaj = T.TfidfPipeline(tcfg, device="cpu").run_packed(batch_from_numpy(
            jb.token_ids.astype(np.uint16), jb.lengths, jb.num_docs, jb.names,
            jb.vocab_size, jb.id_to_word))
        np.testing.assert_array_equal(viaj.topk_ids, tr.topk_ids)
        np.testing.assert_array_equal(viaj.topk_vals, tr.topk_vals)
        np.testing.assert_array_equal(viaj.df, tr.df)

    @pytest.mark.parametrize("engine,vocab", [("sparse", 1024), ("dense", 256)])
    def test_float16_scores_match_jax(self, engine, vocab):
        # float16 score math takes the packed wire with float16 bits
        kw = dict(vocab_mode=JV.HASHED, vocab_size=vocab, topk=5,
                  engine=engine, max_doc_len=64, doc_chunk=64,
                  score_dtype="float16")
        jr, tr = _run_both(_zipf_docs(), **kw)
        assert tr.topk_vals.dtype == np.asarray(jr.topk_vals).dtype
        np.testing.assert_array_equal(tr.df, np.asarray(jr.df))
        np.testing.assert_array_equal(tr.topk_ids, np.asarray(jr.topk_ids))
        np.testing.assert_array_equal(tr.topk_vals, np.asarray(jr.topk_vals))

    def test_topk_only_run_has_no_output_lines(self):
        _, tr = _run_both(_zipf_docs(n_docs=10), vocab_mode=JV.HASHED,
                          vocab_size=128, topk=2)
        with pytest.raises(ValueError, match="topk-only"):
            tr.output_lines()


class TestHashedFullOutput:
    @pytest.mark.parametrize("engine,vocab", [("sparse", 512), ("dense", 512),
                                              ("sparse", 1 << 16)])
    def test_output_bytes_equal(self, engine, vocab):
        jr, tr = _run_both(_zipf_docs(seed=4, n_docs=60), vocab_mode=JV.HASHED,
                           vocab_size=vocab, engine=engine)
        np.testing.assert_array_equal(tr.df, np.asarray(jr.df))
        assert tr.output_bytes() == jr.output_bytes()


class TestCli:
    def _jax_cli(self, args):
        from tfidf_tpu.cli import main
        assert main(["run", *args]) == 0

    def _port_cli(self, args):
        env = dict(os.environ, PYTHONPATH=REPO)
        proc = subprocess.run(
            [sys.executable, "-m", "tfidf_tpu_torch.cli", "run", *args],
            env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr

    @pytest.mark.parametrize("extra", [
        [],
        ["--vocab-mode", "hashed", "--vocab-size", "1024", "--topk", "3"],
    ])
    def test_same_output_file(self, toy_corpus_dir, tmp_path, extra):
        ours, theirs = tmp_path / "ours.txt", tmp_path / "theirs.txt"
        self._port_cli(["--input", toy_corpus_dir, "--output", str(ours),
                        "--device", "cpu", *extra])
        self._jax_cli(["--input", toy_corpus_dir, "--output", str(theirs),
                       *extra])
        assert ours.read_bytes() == theirs.read_bytes()
        assert ours.stat().st_size > 0
