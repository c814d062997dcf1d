"""The port's overlapped ingest (tfidf_tpu_torch.ingest.run_overlapped on
the CPU) against tfidf_tpu.ingest.run_overlapped on the same corpus.

Every wire (padded, ragged, bytes) x regime (resident; streaming with
the triple cache full, empty or partial, spill host and reread) x result
wire (packed, pair) x finish (scan, chunked). Tolerances: df, lengths
and every IngestResult bookkeeping field exact; top-k by
``parity.compare_topk`` (ids exact but for near-ties, scores within 1
ulp of the wire dtype: float16 on the packed wire, float32 on the pair
wire). Each JAX reference run is computed once per module (a lazy,
module-scoped cache), and both packages see the same environment knobs.

The parity matrix runs both packages on their Python packers
(``TFIDF_TPU_NO_NATIVE=1``), so the native library's presence on either
side cannot change a byte count; the port's native packers are then held
byte-identical to its Python ones and run against the JAX package.
"""

import itertools
import os

import numpy as np
import pytest

import tfidf_tpu_torch as T
from tfidf_tpu import ingest as jing
from tfidf_tpu.config import PipelineConfig as JConfig
from tfidf_tpu.config import VocabMode as JV
from tfidf_tpu.io.corpus import pack_ragged as jax_pack_ragged
from tfidf_tpu.io.corpus import ragged_to_padded_host as jax_to_padded
from tfidf_tpu_torch import ingest as ing
from tfidf_tpu_torch.config import TokenizerKind
from tfidf_tpu_torch.io import fast_tokenizer
from tfidf_tpu_torch.io.corpus import pack_ragged, ragged_to_padded_host
from tfidf_tpu_torch.parity import compare_topk

DOC_LEN = 32
CHUNK = 16
FIELDS = ("wire", "path", "result_wire", "finish", "n_finish_dispatches",
          "bytes_on_wire", "bytes_on_wire_padded", "bytes_off_wire",
          "bytes_off_wire_pair", "df_occupied", "num_docs", "names")
# Streaming regimes: the triple cache's budget decides which chunks pass B
# scores from cached triples; a chunk's triples take 16 x 32 x 9 + 16 x 4
# bytes, so 5000 caches exactly one of the three.
REGIMES = {
    "resident": {},
    "streaming": {"TFIDF_TPU_RESIDENT_ELEMS": "0"},
    "streaming_uncached_host": {"TFIDF_TPU_RESIDENT_ELEMS": "0",
                                "TFIDF_TPU_TRIPLE_CACHE_BYTES": "0",
                                "spill": "host"},
    "streaming_uncached_reread": {"TFIDF_TPU_RESIDENT_ELEMS": "0",
                                  "TFIDF_TPU_TRIPLE_CACHE_BYTES": "0",
                                  "spill": "reread"},
    "streaming_one_cached": {"TFIDF_TPU_RESIDENT_ELEMS": "0",
                             "TFIDF_TPU_TRIPLE_CACHE_BYTES": "5000",
                             "spill": "reread"},
}
KNOBS = ("TFIDF_TPU_RESIDENT_ELEMS", "TFIDF_TPU_TRIPLE_CACHE_BYTES",
         "TFIDF_TPU_NO_NATIVE", "TFIDF_TPU_WIRE", "TFIDF_TPU_FINISH",
         "TFIDF_TPU_WIRE_ALIGN")


def _docs():
    """40 docs: Zipf words, a few past DOC_LEN tokens (truncated), empty
    and whitespace-only docs, multi-byte UTF-8 words and every separator
    byte."""
    rng = np.random.default_rng(7)
    docs = []
    for i in range(40):
        n = int(rng.integers(0, 48))
        words = [f"w{r}" for r in np.clip(rng.zipf(1.4, n), 1, 70)]
        if i % 7 == 3:
            words += ["héllo", "wörld", "中文"]
        docs.append(" ".join(words).encode())
    docs[5] = b""
    docs[11] = b"  \t\n \r "
    docs[17] = b"a\tb\nc\x0bd\x0ce\rf  g a b c"
    return docs


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("ingest_corpus")
    for i, doc in enumerate(_docs(), 1):
        (root / f"doc{i}").write_bytes(doc)
    return str(root)


@pytest.fixture(scope="module")
def padded_ids(corpus_dir):
    """The corpus's [D, L] ids and lengths (the near-tie rule's input)."""
    cfg = _configs()[1]
    names = [f"doc{i}" for i in range(1, 41)]
    return ing.make_chunk_packer(corpus_dir, cfg, 40, DOC_LEN)(names)


def _configs(**kw):
    base = dict(vocab_size=1 << 10, max_doc_len=DOC_LEN, doc_chunk=DOC_LEN,
                topk=5, engine="sparse")
    base.update(kw)
    return (JConfig(vocab_mode=JV.HASHED, **base),
            T.PipelineConfig(vocab_mode=T.VocabMode.HASHED, **base))


class _Env:
    """Set knobs for both packages; restores them on exit."""

    def __init__(self, env):
        self.env = env

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in KNOBS}
        for k in KNOBS:
            os.environ.pop(k, None)
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def jax_runs(corpus_dir):
    """JAX reference runs, each computed at most once per module."""
    cache = {}

    def get(regime, env=(), **cfg_kw):
        key = (regime, tuple(sorted(dict(env).items())),
               tuple(sorted(cfg_kw.items())))
        if key not in cache:
            knobs = dict(REGIMES[regime])
            spill = knobs.pop("spill", "auto")
            with _Env({**knobs, **dict(env)}):
                cache[key] = jing.run_overlapped(
                    corpus_dir, _configs(**cfg_kw)[0], chunk_docs=CHUNK,
                    doc_len=DOC_LEN, spill=spill)
        return cache[key]

    return get


def _port_run(corpus_dir, regime, env=(), **cfg_kw):
    knobs = dict(REGIMES[regime])
    spill = knobs.pop("spill", "auto")
    with _Env({**knobs, **dict(env)}):
        return ing.run_overlapped(corpus_dir, _configs(**cfg_kw)[1],
                                  chunk_docs=CHUNK, doc_len=DOC_LEN,
                                  spill=spill, device="cpu")


def _assert_same(jr, tr, padded_ids, wire_dtype, fields=FIELDS):
    for f in fields:
        assert getattr(tr, f) == getattr(jr, f), f
    np.testing.assert_array_equal(tr.df, np.asarray(jr.df))
    np.testing.assert_array_equal(tr.lengths, jr.lengths)
    assert sorted(tr.phases) == sorted(jr.phases)
    ids, lens = padded_ids
    rep = compare_topk(tr.topk_ids, tr.topk_vals, jr.topk_ids,
                       np.asarray(jr.topk_vals, np.float32), token_ids=ids,
                       lengths=lens, df=tr.df, num_docs=tr.num_docs,
                       wire_dtype=wire_dtype)
    assert rep["ok"], rep


NO_NATIVE = (("TFIDF_TPU_NO_NATIVE", "1"),)


@pytest.mark.parametrize("regime,wire,result_wire,finish", list(
    itertools.product(REGIMES, ["padded", "ragged", "bytes"],
                      ["packed", "pair"], ["scan", "chunked"])))
def test_matches_jax(corpus_dir, padded_ids, jax_runs, regime, wire,
                     result_wire, finish):
    kw = dict(wire=wire, result_wire=result_wire, finish=finish)
    jr = jax_runs(regime, NO_NATIVE, **kw)
    tr = _port_run(corpus_dir, regime, NO_NATIVE, **kw)
    assert tr.wire == wire
    assert tr.path == ("resident" if regime == "resident" else "streaming")
    _assert_same(jr, tr, padded_ids,
                 np.float16 if result_wire == "packed" else np.float32)
    # ids equal, scores within the wire's rounding of each other
    np.testing.assert_array_equal(tr.topk_ids, jr.topk_ids)


@pytest.mark.parametrize("score_dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("result_wire", ["packed", "pair"])
def test_score_dtypes(corpus_dir, padded_ids, jax_runs, score_dtype,
                      result_wire):
    kw = dict(score_dtype=score_dtype, result_wire=result_wire)
    jr = jax_runs("resident", NO_NATIVE, **kw)
    tr = _port_run(corpus_dir, "resident", NO_NATIVE, **kw)
    for f in FIELDS:
        assert getattr(tr, f) == getattr(jr, f), f
    np.testing.assert_array_equal(tr.df, np.asarray(jr.df))
    np.testing.assert_array_equal(tr.topk_ids, jr.topk_ids)
    # 16-bit score math: both sides round after every op; values agree
    # within one ulp of the score dtype.
    jv = np.asarray(jr.topk_vals, np.float32)
    ulp = np.spacing(np.abs(jv).astype(np.float16)).astype(np.float32)
    if score_dtype == "bfloat16":
        ulp = ulp * 8  # bfloat16 has 3 fewer mantissa bits than float16
    assert (np.abs(tr.topk_vals.astype(np.float32) - jv) <= ulp).all()


@pytest.mark.parametrize("regime", ["resident", "streaming"])
def test_wide_vocab_takes_padded_and_pair(corpus_dir, padded_ids, jax_runs,
                                          regime):
    kw = dict(vocab_size=(1 << 16) + 8, wire="bytes")
    jr = jax_runs(regime, NO_NATIVE, **kw)
    tr = _port_run(corpus_dir, regime, NO_NATIVE, **kw)
    assert tr.wire == "padded" and tr.result_wire == "pair"
    _assert_same(jr, tr, padded_ids, np.float32)


@pytest.mark.parametrize("truncate", [2, 5])
@pytest.mark.parametrize("wire", ["ragged", "bytes"])
def test_truncate_and_seed(corpus_dir, padded_ids, jax_runs, truncate, wire):
    kw = dict(wire=wire, truncate_tokens_at=truncate, hash_seed=12345)
    jr = jax_runs("resident", NO_NATIVE, **kw)
    tr = _port_run(corpus_dir, "resident", NO_NATIVE, **kw)
    np.testing.assert_array_equal(tr.df, np.asarray(jr.df))
    np.testing.assert_array_equal(tr.topk_ids, jr.topk_ids)
    np.testing.assert_array_equal(tr.lengths, jr.lengths)


@pytest.mark.parametrize("chunk_cap", ["1", "2"])
def test_resident_chunk_cap(corpus_dir, padded_ids, jax_runs, chunk_cap):
    # TFIDF_TPU_MAX_CHUNKS below the chunk count grows the chunk
    env = (("TFIDF_TPU_MAX_CHUNKS", chunk_cap),) + NO_NATIVE
    KNOB = "TFIDF_TPU_MAX_CHUNKS"
    jr = jax_runs("resident", env)
    os.environ[KNOB] = chunk_cap
    try:
        tr = _port_run(corpus_dir, "resident", NO_NATIVE)
    finally:
        os.environ.pop(KNOB)
    _assert_same(jr, tr, padded_ids, np.float16)


class TestNativePackers:
    """The port's native loader (built with g++ at first use) and its
    Python packers emit identical wires; a native run equals the JAX
    package's."""

    NAMES = [f"doc{i}" for i in range(1, 41)]

    def test_library_builds_and_loads(self):
        assert fast_tokenizer.available(), fast_tokenizer.load_error()

    def test_kill_switch(self, monkeypatch):
        monkeypatch.setenv("TFIDF_TPU_NO_NATIVE", "1")
        assert not fast_tokenizer.available()
        assert fast_tokenizer.load_pack_paths(["x"], 16, fixed_len=4) is None

    @pytest.mark.parametrize("maker", ["chunk", "flat", "bytes"])
    def test_native_equals_python(self, corpus_dir, monkeypatch, maker):
        cfg = _configs(truncate_tokens_at=3)[1]
        make = {"chunk": ing.make_chunk_packer, "flat": ing.make_flat_packer,
                "bytes": ing.make_bytes_packer}[maker]
        call = fast_tokenizer.NATIVE_CALLS.copy()
        native = make(corpus_dir, cfg, 48, DOC_LEN)(self.NAMES)
        assert fast_tokenizer.NATIVE_CALLS != call  # the native path ran
        monkeypatch.setenv("TFIDF_TPU_NO_NATIVE", "1")
        python = make(corpus_dir, cfg, 48, DOC_LEN)(self.NAMES)
        assert len(native) == len(python)
        for a, b in zip(native, python):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        if maker == "chunk":
            assert native[0].dtype == np.uint16
            assert python[0].dtype == np.int32

    @pytest.mark.parametrize("regime", ["resident", "streaming_uncached_host"])
    @pytest.mark.parametrize("wire", ["padded", "ragged", "bytes"])
    def test_native_run_matches_jax(self, corpus_dir, padded_ids, jax_runs,
                                    regime, wire):
        jr = jax_runs(regime, NO_NATIVE, wire=wire)
        tr = _port_run(corpus_dir, regime, wire=wire)
        np.testing.assert_array_equal(tr.df, np.asarray(jr.df))
        np.testing.assert_array_equal(tr.lengths, jr.lengths)
        np.testing.assert_array_equal(tr.topk_ids, jr.topk_ids)
        np.testing.assert_array_equal(tr.topk_vals, jr.topk_vals)
        # the native loader ships uint16 ids: the padded wire's bytes halve
        same = [f for f in FIELDS if not f.startswith("bytes_on_wire")]
        for f in same:
            assert getattr(tr, f) == getattr(jr, f), f
        if wire == "padded":
            assert tr.bytes_on_wire < jr.bytes_on_wire
        else:
            assert tr.bytes_on_wire == jr.bytes_on_wire


class TestOverlapLoop:
    """Ordering contract of the double-buffered upload pipeline: the
    packer thread runs ahead of dispatch, every chunk's upload is issued
    before the terminal result fetch, drains retire chunk-major."""

    def _trace_run(self, corpus_dir, env=(), **kw):
        events = []
        ing._overlap_trace = events.append
        try:
            with _Env(dict(env)):
                ing.run_overlapped(corpus_dir, _configs(**kw)[1],
                                   chunk_docs=10, doc_len=DOC_LEN,
                                   device="cpu")
        finally:
            ing._overlap_trace = None
        return events

    def test_uploads_precede_fetch(self, corpus_dir):
        events = self._trace_run(corpus_dir)
        uploads = [i for i, e in enumerate(events) if e[0] == "upload"]
        assert len(uploads) == 4  # 40 docs / 10-doc chunks
        fetch_start = events.index(("fetch_start", -1))
        fetch_done = events.index(("fetch_done", -1))
        assert all(u < fetch_start < fetch_done for u in uploads)

    def test_pack_rides_ahead_of_dispatch(self, corpus_dir):
        events = self._trace_run(corpus_dir)
        for i in range(3):
            assert events.index(("pack_submit", i + 1)) \
                < events.index(("dispatch", i))
        dones = [e[1] for e in events if e[0] == "pack_done"]
        assert dones == sorted(dones)

    def test_streaming_loop_traces_too(self, corpus_dir):
        events = self._trace_run(corpus_dir,
                                 {"TFIDF_TPU_RESIDENT_ELEMS": "0",
                                  "TFIDF_TPU_TRIPLE_CACHE_BYTES": "0"})
        uploads = [i for i, e in enumerate(events) if e[0] == "upload"]
        fetch_start = events.index(("fetch_start", -1))
        assert len(uploads) == 4
        assert all(u < fetch_start for u in uploads)

    def test_chunked_drain_order(self, corpus_dir):
        events = self._trace_run(corpus_dir, finish="chunked")
        submits = [e[1] for e in events if e[0] == "drain_submit"]
        dones = [e[1] for e in events if e[0] == "drain_done"]
        assert submits == [0, 1, 2, 3] and dones == submits
        fetch_done = events.index(("fetch_done", -1))
        assert all(events.index(("drain_submit", i)) < fetch_done
                   for i in submits)

    def test_scan_finish_drains_once(self, corpus_dir):
        events = self._trace_run(corpus_dir)
        assert [e for e in events if e[0] == "drain_submit"] \
            == [("drain_submit", 0)]

    def test_fetch_ahead_knob_validates(self, monkeypatch):
        monkeypatch.setenv("TFIDF_TPU_FETCH_AHEAD", "0")
        with pytest.raises(ValueError, match="TFIDF_TPU_FETCH_AHEAD"):
            ing._DrainAhead(lambda w: w)


def _sel_cfgs(**kw):
    return _configs(**{"wire": "bytes", **kw})


class TestWireSelection:
    """The bytes -> ragged -> padded chain, the finish knob and their
    environment overrides resolve exactly as in the JAX package."""

    CASES = [
        (dict(), 16, 64), (dict(wire="ragged"), 16, 64),
        (dict(wire="padded"), 16, 64),
        (dict(vocab_size=(1 << 16) + 1), 16, 64),
        (dict(vocab_size=1 << 16), 16, 64),
        (dict(tokenizer="chargram"), 16, 64),
        (dict(wire="ragged"), 1 << 26, 64), (dict(wire="ragged"), 1 << 20, 64),
        (dict(), 1 << 25, 64),
    ]

    @pytest.mark.parametrize("kw,chunk,length", CASES)
    @pytest.mark.parametrize("env", [{}, {"TFIDF_TPU_WIRE": "bytes"},
                                     {"TFIDF_TPU_WIRE": "padded"},
                                     {"TFIDF_TPU_WIRE_ALIGN": "1"}])
    def test_same_choice_as_jax(self, kw, chunk, length, env):
        if kw.get("tokenizer"):
            from tfidf_tpu.config import TokenizerKind as JT
            jc = _sel_cfgs(**{**kw, "tokenizer": JT.CHARGRAM})[0]
            tc = _sel_cfgs(**{**kw, "tokenizer": TokenizerKind.CHARGRAM})[1]
        else:
            jc, tc = _sel_cfgs(**kw)
        with _Env(env):
            for fn in ("resolve_wire", "resolve_finish"):
                assert getattr(ing, fn)(tc) == getattr(jing, fn)(jc)
            for fn in ("use_bytes_wire", "use_ragged_wire"):
                assert getattr(ing, fn)(tc, chunk, length) \
                    == getattr(jing, fn)(jc, chunk, length), fn
            for packed in (True, False):
                assert ing.use_scan_finish(tc, packed) \
                    == jing.use_scan_finish(jc, packed)

    def test_env_validates(self, monkeypatch):
        monkeypatch.setenv("TFIDF_TPU_WIRE", "csr")
        with pytest.raises(ValueError, match="TFIDF_TPU_WIRE"):
            ing.resolve_wire(_sel_cfgs()[1])
        monkeypatch.setenv("TFIDF_TPU_FINISH", "fused")
        with pytest.raises(ValueError, match="TFIDF_TPU_FINISH"):
            ing.resolve_finish(_sel_cfgs()[1])

    def test_config_validates_wire(self):
        with pytest.raises(ValueError, match="wire"):
            _configs(wire="csr")

    def test_pack_threads_validates(self, monkeypatch):
        monkeypatch.setenv("TFIDF_TPU_PACK_THREADS", "0")
        with pytest.raises(ValueError, match="TFIDF_TPU_PACK_THREADS"):
            fast_tokenizer.resolve_pack_threads()
        assert fast_tokenizer.resolve_pack_threads(3) == 3

    def test_env_wire_drives_the_run(self, corpus_dir, monkeypatch):
        monkeypatch.setenv("TFIDF_TPU_WIRE", "bytes")
        assert _port_run(corpus_dir, "resident",
                         (("TFIDF_TPU_WIRE", "bytes"),)).wire == "bytes"


class TestGuards:
    """The wire-granule knob and the int32 bounds raise by name, at the
    same inputs as the JAX package."""

    @pytest.mark.parametrize("align", ["12", "3", str(1 << 18)])
    def test_bad_align(self, monkeypatch, align):
        monkeypatch.setenv("TFIDF_TPU_WIRE_ALIGN", align)
        with pytest.raises(ValueError, match="TFIDF_TPU_WIRE_ALIGN"):
            ing._wire_align()
        with pytest.raises(ValueError, match="TFIDF_TPU_WIRE_ALIGN"):
            jing._wire_align()

    def test_entry_point_names_the_knob(self, corpus_dir, monkeypatch):
        monkeypatch.setenv("TFIDF_TPU_WIRE_ALIGN", "3")
        with pytest.raises(ValueError, match="TFIDF_TPU_WIRE_ALIGN"):
            ing.run_overlapped(corpus_dir, _configs()[1], chunk_docs=16,
                               doc_len=DOC_LEN, device="cpu")

    def test_valid_align(self, monkeypatch):
        monkeypatch.setenv("TFIDF_TPU_WIRE_ALIGN", "8")
        assert ing._wire_align() == 8 == jing._wire_align()

    @pytest.mark.parametrize("name", ["TFIDF_TPU_FLAT_BUCKET",
                                      "TFIDF_TPU_BYTE_BUCKET"])
    def test_bucket_knobs_validate_at_call_time(self, monkeypatch, name):
        monkeypatch.setenv(name, "1000")
        with pytest.raises(ValueError, match=name):
            ing.flat_bucket() if "FLAT" in name else ing.byte_bucket()

    @pytest.mark.parametrize("guard,args", [
        ("_check_chunk_fits_int32", (1 << 24, 128)),
        ("_check_total_slots_fit_int32", (1 << 26, 64)),
        ("_check_slab_fits_int32", (1 << 31,)),
    ])
    def test_int32_guards(self, guard, args):
        with pytest.raises(ValueError, match="int32"):
            getattr(ing, guard)(*args)
        with pytest.raises(ValueError, match="int32"):
            getattr(jing, guard)(*args)
        small = tuple(a // 4 for a in args)
        getattr(ing, guard)(*small)

    def test_entry_point_rejects_huge_chunk(self, corpus_dir):
        with pytest.raises(ValueError, match="int32"):
            ing.run_overlapped(corpus_dir, _configs()[1],
                               chunk_docs=1 << 24, doc_len=256, device="cpu")

    def test_config_requirements(self, corpus_dir):
        with pytest.raises(ValueError, match="HASHED"):
            ing.run_overlapped(corpus_dir, T.PipelineConfig(topk=3),
                               device="cpu")
        with pytest.raises(ValueError, match="topk"):
            ing.run_overlapped(corpus_dir, T.PipelineConfig(
                vocab_mode=T.VocabMode.HASHED), device="cpu")
        with pytest.raises(ValueError, match="spill"):
            ing.run_overlapped(corpus_dir, _configs()[1], spill="disk",
                               device="cpu")

    def test_empty_directory(self, tmp_path):
        with pytest.raises(ValueError, match="no documents"):
            ing.run_overlapped(str(tmp_path), _configs()[1], device="cpu")


class TestWireLayout:
    """The host wire helpers equal the JAX package's."""

    @pytest.mark.parametrize("align", [1, 2, 4, 16])
    @pytest.mark.parametrize("dtype", [np.uint16, np.int32])
    def test_flatten_aligned(self, align, dtype):
        rng = np.random.default_rng(align)
        lens = rng.integers(0, 25, 9).astype(np.int32)
        lens[2], lens[5] = 0, 24
        ids = rng.integers(0, 60000, (9, 24)).astype(np.int32)
        ids[np.arange(24)[None, :] >= lens[:, None]] = 0
        flat, total = ing.flatten_aligned(ids, lens, align, dtype=dtype)
        jflat, jtotal = jing.flatten_aligned(ids, lens, align, dtype=dtype)
        assert total == jtotal and flat.dtype == jflat.dtype
        np.testing.assert_array_equal(flat, jflat)
        np.testing.assert_array_equal(
            ragged_to_padded_host(flat, lens, 24, align), ids)
        np.testing.assert_array_equal(
            ragged_to_padded_host(flat, lens, 24, align),
            jax_to_padded(jflat, lens, 24, align))

    @pytest.mark.parametrize("chunk,length,align", [(16, 64, 16), (1, 1, 1),
                                                    (8192, 256, 16),
                                                    (5, 7, 4)])
    def test_bucket_cap(self, chunk, length, align):
        assert ing._bucket_cap_ids(chunk, length, align) \
            == jing._bucket_cap_ids(chunk, length, align)

    @pytest.mark.parametrize("total", [0, 5, 1 << 17, (1 << 17) + 1])
    def test_bucket_pad(self, total):
        flat = np.arange(total + 3, dtype=np.uint16)
        a = ing._bucket_pad_flat(flat.copy(), total)
        b = jing._bucket_pad_flat(flat.copy(), total)
        np.testing.assert_array_equal(a, b)

    def test_pack_ragged_matches_jax(self):
        from tfidf_tpu.config import PipelineConfig as JC
        from tfidf_tpu.io.corpus import Corpus as JCorpus
        docs = _docs()
        names = [f"doc{i}" for i in range(1, 41)]
        kw = dict(vocab_size=1 << 12, max_doc_len=DOC_LEN, doc_chunk=DOC_LEN)
        jb = jax_pack_ragged(JCorpus(names=names, docs=docs),
                             JC(vocab_mode=JV.HASHED, **kw))
        tb = pack_ragged(T.Corpus(names=names, docs=docs),
                         T.PipelineConfig(vocab_mode=T.VocabMode.HASHED, **kw))
        np.testing.assert_array_equal(tb.flat, jb.flat)
        np.testing.assert_array_equal(tb.lengths, jb.lengths)
        assert (tb.length, tb.align, tb.total) == (jb.length, jb.align,
                                                   jb.total)
        np.testing.assert_array_equal(tb.to_padded().token_ids,
                                      jb.to_padded().token_ids)


class TestEnvKnobs:
    """The JAX package's ingest knobs, read the same way: a bad lowering
    selector raises in both packages (each value runs the port's one
    kernel), and ``TFIDF_TPU_RESULT_WIRE`` overrides the config's result
    wire in both."""

    @pytest.fixture(autouse=True)
    def _python_packers(self, monkeypatch):
        for k in KNOBS:
            monkeypatch.delenv(k, raising=False)
        monkeypatch.setenv("TFIDF_TPU_NO_NATIVE", "1")

    @pytest.mark.parametrize("var,wire", [
        ("TFIDF_TPU_REBUILD", "ragged"),
        ("TFIDF_TPU_DEVICE_TOKENIZE", "bytes"),
        ("TFIDF_TPU_DOWNLINK", "padded"),
        ("TFIDF_TPU_RESULT_WIRE", "padded")])
    def test_a_bad_value_raises_in_both(self, corpus_dir, monkeypatch, var,
                                        wire):
        from tfidf_tpu.ops import downlink as jdownlink
        monkeypatch.setenv(var, "bogus")
        jcfg, tcfg = _configs(wire=wire)
        with pytest.raises(ValueError, match="bogus"):
            if var == "TFIDF_TPU_DOWNLINK":
                # resolved while the JAX package traces its word pack, so
                # a run on a cached program skips it: ask the resolver
                jdownlink.downlink_method()
            else:
                jing.run_overlapped(corpus_dir, jcfg, chunk_docs=CHUNK,
                                    doc_len=DOC_LEN)
        with pytest.raises(ValueError, match="bogus"):
            ing.run_overlapped(corpus_dir, tcfg, chunk_docs=CHUNK,
                               doc_len=DOC_LEN, device="cpu")

    @pytest.mark.parametrize("var,value", [
        ("TFIDF_TPU_REBUILD", "pallas"), ("TFIDF_TPU_DOWNLINK", "pallas"),
        ("TFIDF_TPU_RESULT_WIRE", "pair")])
    def test_a_good_value_runs_as_in_jax(self, corpus_dir, monkeypatch,
                                         padded_ids, var, value):
        monkeypatch.setenv(var, value)
        jcfg, tcfg = _configs()
        jr = jing.run_overlapped(corpus_dir, jcfg, chunk_docs=CHUNK,
                                 doc_len=DOC_LEN)
        tr = ing.run_overlapped(corpus_dir, tcfg, chunk_docs=CHUNK,
                                doc_len=DOC_LEN, device="cpu")
        assert tr.result_wire == jr.result_wire \
            == ("pair" if value == "pair" else "packed")
        _assert_same(jr, tr, padded_ids,
                     np.float32 if value == "pair" else np.float16)
