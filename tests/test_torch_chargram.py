"""The port's device chargram against the JAX package's, on the CPU.

* ``ops.hashing.device_ngram_ids_multi``: bit for bit equal to the JAX
  function at every position, the masked-out (wrapped) windows included,
  over n ranges, vocabularies, seeds, all 256 byte values and the edge
  document lengths (0, 1, shorter than n, the full row).
* ``io.corpus.pack_bytes`` / ``load_and_pack``: equal arrays.
* ``TfidfPipeline.run_bytes`` through ``run``, both lowerings (a
  defaulted engine is dense up to 2^16 and sparse past it; an explicit
  sparse engine is sparse), float32 and float16 scores: df and docSize
  exact, top-k by ``parity.compare_topk`` (ids exact but for near-ties
  within 4 float32 ulp, scores within 1 ulp of the wire format: float16
  on the packed wire, the score dtype on the pair wire).
* ``cli run --tokenizer chargram`` writes the JAX CLI's bytes.
"""

import numpy as np
import pytest
import torch

import tfidf_tpu_torch as T
from tfidf_tpu.config import PipelineConfig as JConfig
from tfidf_tpu.config import TokenizerKind as JTok
from tfidf_tpu.config import VocabMode as JV
from tfidf_tpu.io import corpus as jcorpus
from tfidf_tpu.ops.hashing import device_ngram_ids_multi as jax_ngrams
from tfidf_tpu.pipeline import TfidfPipeline as JPipeline
from tfidf_tpu_torch import pipeline as P
from tfidf_tpu_torch.io import corpus as pcorpus
from tfidf_tpu_torch.ops.hashing import device_ngram_ids, device_ngram_ids_multi
from tfidf_tpu_torch.parity import compare_topk

RANGES = [(1, 1), (3, 5), (2, 7)]
VOCABS = [3, 1 << 12, 65521, 1 << 16, 1 << 20]
SEEDS = [0, 0xDEADBEEF]


def _byte_batch():
    """Every byte value 0..255 in some row, and rows of length 0, 1, 2
    (shorter than most n), 6 and the full 64."""
    rng = np.random.default_rng(3)
    b = rng.integers(0, 256, (8, 64)).astype(np.int32)
    b[0, :64] = np.arange(64)
    b[1, :64] = np.arange(64, 128)
    b[2, :64] = np.arange(128, 192)
    b[3, :64] = np.arange(192, 256)
    lens = np.array([64, 64, 64, 64, 0, 1, 2, 6], np.int32)
    b[np.arange(64)[None, :] >= lens[:, None]] = 0  # zero-padded rows
    return b, lens


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("vocab", VOCABS)
@pytest.mark.parametrize("lo,hi", RANGES)
def test_ngram_ids_bit_equal(lo, hi, vocab, seed):
    import jax.numpy as jnp
    b, lens = _byte_batch()
    want = jax_ngrams(jnp.asarray(b), jnp.asarray(lens), lo, hi, vocab, seed)
    got = device_ngram_ids_multi(torch.from_numpy(b), torch.from_numpy(lens),
                                 lo, hi, vocab, seed)
    assert len(got) == len(want) == hi - lo + 1
    for (wi, wv), (gi, gv) in zip(want, got):
        assert gi.dtype == torch.int32 and gv.dtype == torch.bool
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    # uint8 bytes give the same ids; one n alone equals its multi slot
    got8 = device_ngram_ids_multi(torch.from_numpy(b.astype(np.uint8)),
                                  torch.from_numpy(lens), lo, hi, vocab, seed)
    for (gi, gv), (hi_, hv) in zip(got, got8):
        assert torch.equal(gi, hi_) and torch.equal(gv, hv)
    one_i, one_v = device_ngram_ids(torch.from_numpy(b), torch.from_numpy(lens),
                                    hi, vocab, seed)
    assert torch.equal(one_i, got[-1][0]) and torch.equal(one_v, got[-1][1])


def _docs():
    """30 source-like docs of a small alphabet (n-gram repeats, so real
    DF and ties), an empty doc and docs shorter than 3 bytes."""
    rng = np.random.default_rng(11)
    alpha = np.frombuffer(b"abcdef_(){} =\n", np.uint8)
    docs = [alpha[rng.integers(0, len(alpha), int(rng.integers(0, 200)))]
            .tobytes() for _ in range(30)]
    docs[3], docs[4], docs[5] = b"", b"ab", b"x"
    return [f"doc{i}" for i in range(1, 31)], docs


def _ngram_tokens(docs, lo, hi, vocab, seed):
    """[D, L] n-gram ids per doc (every n, valid windows only, in a row
    prefix) and their count: the near-tie rule's exact-score input."""
    import jax.numpy as jnp
    packed = jcorpus.pack_bytes(jcorpus.Corpus(names=[""] * len(docs),
                                               docs=docs))
    streams = jax_ngrams(jnp.asarray(packed.byte_ids),
                         jnp.asarray(packed.byte_lengths), lo, hi, vocab, seed)
    ids = np.concatenate([np.asarray(i) for i, _ in streams], axis=1)
    valid = np.concatenate([np.asarray(v) for _, v in streams], axis=1)
    lens = valid.sum(axis=1).astype(np.int32)
    toks = np.zeros_like(ids)
    for d in range(len(docs)):
        toks[d, :lens[d]] = ids[d][valid[d]]
    return toks, lens


CASES = [  # (vocab, engine, score dtype, lowering the port must take)
    (1 << 12, None, "float32", "dense"),
    (1 << 12, None, "float16", "dense"),
    (1 << 17, None, "float32", "sparse"),
    (1 << 17, None, "float16", "sparse"),
    (1 << 12, "sparse", "float32", "sparse"),
    (1 << 12, "sparse", "float16", "sparse"),
]


@pytest.mark.parametrize("vocab,engine,dtype,lowering", CASES)
def test_run_bytes_matches_jax(monkeypatch, vocab, engine, dtype, lowering):
    names, docs = _docs()
    kw = dict(vocab_size=vocab, topk=6, engine=engine, score_dtype=dtype,
              ngram_range=(2, 4))
    want = JPipeline(JConfig(vocab_mode=JV.HASHED, tokenizer=JTok.CHARGRAM,
                             **kw)).run(jcorpus.Corpus(names=names, docs=docs))
    ran = []
    for fn in ("_chargram_forward", "_chargram_sparse_forward"):
        real = getattr(P, fn)

        def spy(*a, _real=real, _fn=fn, **k):
            ran.append(_fn)
            return _real(*a, **k)
        monkeypatch.setattr(P, fn, spy)
    cfg = T.PipelineConfig(vocab_mode=T.VocabMode.HASHED,
                           tokenizer=T.TokenizerKind.CHARGRAM, **kw)
    got = T.TfidfPipeline(cfg, device="cpu").run(T.Corpus(names=names,
                                                          docs=docs))
    assert ran == (["_chargram_sparse_forward"] if lowering == "sparse"
                   else ["_chargram_forward"])
    np.testing.assert_array_equal(got.df, np.asarray(want.df))
    np.testing.assert_array_equal(got.lengths, np.asarray(want.lengths))
    assert got.names == want.names and got.num_docs == want.num_docs
    packed = vocab <= (1 << 16)
    wire = np.float16 if packed else np.dtype(dtype).type
    toks, lens = _ngram_tokens(docs, 2, 4, vocab, 0)
    np.testing.assert_array_equal(lens, got.lengths)
    rep = compare_topk(got.topk_ids, got.topk_vals, np.asarray(want.topk_ids),
                       np.asarray(want.topk_vals, np.float64),
                       token_ids=toks, lengths=lens, df=got.df,
                       num_docs=len(docs), wire_dtype=wire)
    assert rep["ok"], rep


def test_run_bytes_full_output_matches_jax():
    """A dense run_bytes without top-k returns counts, df, docSize and
    the scores, as the JAX one does (called directly: ``run`` routes
    only top-k runs to the device chargram)."""
    names, docs = _docs()
    kw = dict(vocab_size=512, ngram_range=(3, 5))
    want = JPipeline(JConfig(vocab_mode=JV.HASHED, tokenizer=JTok.CHARGRAM,
                             **kw)).run_bytes(jcorpus.Corpus(names=names,
                                                             docs=docs))
    got = T.TfidfPipeline(T.PipelineConfig(
        vocab_mode=T.VocabMode.HASHED, tokenizer=T.TokenizerKind.CHARGRAM,
        **kw), device="cpu").run_bytes(T.Corpus(names=names, docs=docs))
    for field in ("counts", "df", "lengths"):
        np.testing.assert_array_equal(getattr(got, field),
                                      np.asarray(getattr(want, field)))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores),
                               rtol=2 ** -22, atol=0)


def test_run_bytes_refusals():
    corpus = T.Corpus(names=["doc1"], docs=[b"abc"])
    for kw in (dict(tokenizer=T.TokenizerKind.WHITESPACE),
               dict(vocab_mode=T.VocabMode.EXACT)):
        base = dict(vocab_mode=T.VocabMode.HASHED,
                    tokenizer=T.TokenizerKind.CHARGRAM, topk=2)
        base.update(kw)
        with pytest.raises(ValueError):
            T.TfidfPipeline(T.PipelineConfig(**base),
                            device="cpu").run_bytes(corpus)
    # The docs-sharded chargram runs now (tests/test_torch_parallel.py);
    # a seq or vocab mesh is refused, as by the JAX package: an n-gram
    # window spans adjacent bytes.
    for mesh in ({"docs": 1, "seq": 2}, {"docs": 1, "vocab": 2}):
        cfg = T.PipelineConfig(vocab_mode=T.VocabMode.HASHED, topk=2,
                               tokenizer=T.TokenizerKind.CHARGRAM,
                               mesh_shape=mesh)
        with pytest.raises(ValueError, match="docs only"):
            T.TfidfPipeline(cfg, device="cpu").run_bytes(corpus)
        with pytest.raises(ValueError, match="docs only"):
            JPipeline(JConfig(vocab_mode=JV.HASHED, topk=2,
                              tokenizer=JTok.CHARGRAM, mesh_shape=mesh)
                      ).run_bytes(jcorpus.Corpus(names=corpus.names,
                                                 docs=corpus.docs))


@pytest.mark.parametrize("pad_docs_to,pad_len_to", [(None, 128), (40, 16)])
def test_pack_bytes_equal(pad_docs_to, pad_len_to):
    names, docs = _docs()
    want = jcorpus.pack_bytes(jcorpus.Corpus(names=names, docs=docs),
                              pad_docs_to, pad_len_to)
    got = pcorpus.pack_bytes(T.Corpus(names=names, docs=docs), pad_docs_to,
                             pad_len_to)
    np.testing.assert_array_equal(got.byte_ids, want.byte_ids)
    np.testing.assert_array_equal(got.byte_lengths, want.byte_lengths)
    assert got.byte_ids.dtype == want.byte_ids.dtype
    assert (got.num_docs, got.names) == (want.num_docs, want.names)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("vocab,pad", [(1 << 10, None), (70000, 9)])
def test_load_and_pack_equal(tmp_path, monkeypatch, native, vocab, pad):
    """The port's loader (its own native build, or the Python pack)
    against the JAX package's Python pack path: equal ids and lengths in
    the pack_corpus shape."""
    rng = np.random.default_rng(5)
    for i in range(1, 8):
        words = [f"w{r}" for r in rng.integers(0, 50, int(rng.integers(0, 30)))]
        (tmp_path / f"doc{i}").write_bytes(" ".join(words).encode())
    kw = dict(vocab_size=vocab, max_doc_len=8, doc_chunk=8)
    monkeypatch.setenv("TFIDF_TPU_NO_NATIVE", "1")
    want = jcorpus.load_and_pack(str(tmp_path), JConfig(vocab_mode=JV.HASHED,
                                                        **kw),
                                 pad_docs_to=pad)
    if native:
        monkeypatch.delenv("TFIDF_TPU_NO_NATIVE")
    got = pcorpus.load_and_pack(str(tmp_path),
                                T.PipelineConfig(vocab_mode=T.VocabMode.HASHED,
                                                 **kw), pad_docs_to=pad)
    np.testing.assert_array_equal(got.token_ids.astype(np.int32),
                                  want.token_ids)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert got.token_ids.dtype == (np.uint16 if native and vocab <= 1 << 16
                                   else np.int32)
    assert (got.num_docs, got.names) == (want.num_docs, want.names)


@pytest.mark.parametrize("extra", [
    ["--vocab-size", "4096", "--topk", "4", "--result-wire", "pair"],
    ["--vocab-size", "200000", "--topk", "3", "--ngram", "2,3"],
    ["--vocab-size", "4096", "--topk", "4", "--engine", "sparse",
     "--result-wire", "pair"],
])
def test_cli_chargram_same_bytes(tmp_path, extra):
    """``cli run --tokenizer chargram`` writes the JAX CLI's file. The
    pair result wire keeps full-precision scores, as the JAX package's
    run_bytes always does; past 2^16 the pair wire is the only one."""
    from tfidf_tpu.cli import main as jax_main
    from tfidf_tpu_torch.cli import main as port_main
    names, docs = _docs()
    src = tmp_path / "in"
    src.mkdir()
    for n, d in zip(names, docs):
        (src / n).write_bytes(d)
    args = ["run", "--input", str(src), "--vocab-mode", "hashed",
            "--tokenizer", "chargram", *extra]
    assert port_main(args + ["--output", str(tmp_path / "ours"),
                             "--device", "cpu"]) == 0
    assert jax_main(args + ["--output", str(tmp_path / "theirs")]) == 0
    ours = (tmp_path / "ours").read_bytes()
    assert ours == (tmp_path / "theirs").read_bytes() and ours

