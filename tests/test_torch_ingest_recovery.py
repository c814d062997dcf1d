"""Restart supervision of the port's ingest workers against the JAX
package's, on the CPU.

Both packages run the same seeded corpus with the same fault plan, each
armed in its own ``faults`` registry, at the JAX package's own restart
test's size (vocab 2^12, top-4, doc_len 16, 2-doc chunks):

* transient ``pack_worker`` and ``drain`` faults on every ingest path
  (the ragged, bytes and padded wires, the streaming regime, the
  device-exact engine, a 2-shard mesh) are absorbed: the port's faulted
  run equals its clean run bit for bit, its DF, lengths and ids equal
  the JAX faulted run's (values within ``parity.compare_topk``, 1
  float16 ulp of the packed wire), its ``worker_restart`` events carry
  the JAX run's ``(worker, chunk, restart)`` triples, and each seam was
  consulted and fired as often as in the JAX run (none on the mesh,
  whose JAX ingest packs inline);
* a re-run job is safe: a drain re-reads the same host buffer, and the
  exact path's intern table gives a re-packed chunk the same ids;
* a fatal fault propagates, the restart budget bounds retries, a real
  exception is restarted too, ``TfidfRetriever.index_dir`` fires no
  seam, the workers beat ``packer``/``drainer``, and the JAX package's
  ``tools/doctor.py`` counts the same restarts on both flight dumps.

The hashed paths run both packages on their Python packers
(``TFIDF_TPU_NO_NATIVE=1``); the device-exact engine needs the native
intern table, which the port builds with g++ (``ops/_build.py``) and the
JAX package loads from the same sources.
"""

import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch

import tfidf_tpu_torch as T
from tfidf_tpu import faults as jfaults
from tfidf_tpu import ingest as jing
from tfidf_tpu import obs as jobs
from tfidf_tpu.config import PipelineConfig as JConfig
from tfidf_tpu.config import VocabMode as JV
from tfidf_tpu.io import fast_tokenizer as jft
from tfidf_tpu.models import TfidfRetriever as JRetriever
from tfidf_tpu.obs.health import HealthMonitor as JHealthMonitor
from tfidf_tpu.obs.health import set_monitor as jset_monitor
from tfidf_tpu.obs.log import EventLog as JEventLog
from tfidf_tpu.parallel import MeshPlan as JMesh
from tfidf_tpu_torch import faults, obs
from tfidf_tpu_torch import ingest as ing
from tfidf_tpu_torch.io import fast_tokenizer as ft
from tfidf_tpu_torch.models import TfidfRetriever
from tfidf_tpu_torch.obs.health import HealthMonitor, set_monitor
from tfidf_tpu_torch.obs.log import EventLog
from tfidf_tpu_torch.ops import _build
from tfidf_tpu_torch.parallel import MeshPlan
from tfidf_tpu_torch.parity import compare_topk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 1 << 12
TOPK = 4
DOC_LEN = 16
CHUNK = 2
TRANSIENT = "pack_worker:transient:n=1;drain:transient:n=1"
# path -> (environment, config fields, run_overlapped keywords)
PATHS = {
    "ragged": ({}, {"wire": "ragged"}, {}),
    "bytes": ({}, {"wire": "bytes"}, {}),
    "padded": ({}, {"wire": "padded"}, {}),
    "streaming": ({"TFIDF_TPU_RESIDENT_ELEMS": "0"}, {}, {}),
    "exact": ({}, {}, {}),
    "mesh": ({}, {}, {"plan": 2}),
}
_ENV = ("TFIDF_TPU_NO_NATIVE", "TFIDF_TPU_RESIDENT_ELEMS", "TFIDF_TPU_WIRE",
        "TFIDF_TPU_TRIPLE_CACHE_BYTES", "TFIDF_TPU_RESTART_BUDGET",
        "TFIDF_TPU_FINISH", "TFIDF_TPU_RESULT_WIRE")


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    """11 docs of Zipf words, some past DOC_LEN tokens, one empty."""
    d = tmp_path_factory.mktemp("recovery") / "input"
    d.mkdir()
    rng = np.random.default_rng(16)
    for i in range(1, 12):
        n = 0 if i == 4 else int(rng.integers(1, 30))
        words = [f"w{r}" for r in np.clip(rng.zipf(1.5, n), 1, 60)]
        (d / f"doc{i}").write_text(" ".join(words))
    return str(d)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Python packers, no fault armed, fresh flight logs, no monitor."""
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TFIDF_TPU_NO_NATIVE", "1")
    logs = (EventLog(echo="off"), JEventLog(echo="off"))
    obs.set_log(logs[0])
    jobs.set_log(logs[1])
    yield logs
    faults.disarm()
    jfaults.disarm()
    set_monitor(None)
    jset_monitor(None)
    obs.set_log(None)
    jobs.set_log(None)


@pytest.fixture
def native(monkeypatch):
    """The native intern table for both packages: the port's build, which
    the JAX package loads too when its own build is absent."""
    monkeypatch.delenv("TFIDF_TPU_NO_NATIVE")
    _build.load_host()
    if not jft.intern_available():
        monkeypatch.setenv("TFIDF_TPU_NATIVE_LIB",
                           str(_build.host_library_path()))
    assert jft.intern_available()


def _cfgs(**kw):
    base = dict(vocab_size=VOCAB, topk=TOPK, **kw)
    return (T.PipelineConfig(vocab_mode=T.VocabMode.HASHED, **base),
            JConfig(vocab_mode=JV.HASHED, **base))


def _port(path, corpus_dir, plan=None):
    _, cfg_kw, run_kw = PATHS[path]
    cfg = _cfgs(**cfg_kw)[0]
    if path == "exact":
        return ing.run_overlapped_exact(corpus_dir, cfg, chunk_docs=CHUNK,
                                        doc_len=DOC_LEN, device="cpu")
    if "plan" in run_kw:
        run_kw = {"plan": MeshPlan.create(docs=run_kw["plan"],
                                          device="cpu")}
    return ing.run_overlapped(corpus_dir, cfg, chunk_docs=CHUNK,
                              doc_len=DOC_LEN, device="cpu", **run_kw)


def _jax(path, corpus_dir):
    _, cfg_kw, run_kw = PATHS[path]
    cfg = _cfgs(**cfg_kw)[1]
    if path == "exact":
        return jing.run_overlapped_exact(corpus_dir, cfg, chunk_docs=CHUNK,
                                         doc_len=DOC_LEN)
    if "plan" in run_kw:
        run_kw = {"plan": JMesh.create(docs=run_kw["plan"],
                                       devices=jax.devices()[:2])}
    return jing.run_overlapped(corpus_dir, cfg, chunk_docs=CHUNK,
                               doc_len=DOC_LEN, **run_kw)


def _restarts(log):
    return sorted((e["worker"], e["chunk"], e["restart"])
                  for e in log.events() if e["event"] == "worker_restart")


def _arm(spec):
    faults.arm(faults.FaultPlan.parse(spec))
    jfaults.arm(jfaults.FaultPlan.parse(spec))


def _padded_ids(corpus_dir, n_docs):
    cfg = _cfgs()[0]
    names = [f"doc{i}" for i in range(1, n_docs + 1)]
    return ing.make_chunk_packer(corpus_dir, cfg, n_docs, DOC_LEN)(names)


def _assert_bit_equal(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


@pytest.mark.parametrize("path", list(PATHS))
def test_transient_faults_leave_the_result_unchanged(corpus_dir, path,
                                                     _clean, monkeypatch,
                                                     request):
    if path == "exact":
        request.getfixturevalue("native")
    for var, val in PATHS[path][0].items():
        monkeypatch.setenv(var, val)
    clean = _port(path, corpus_dir)
    assert _restarts(_clean[0]) == []
    _arm(TRANSIENT)
    got = _port(path, corpus_dir)
    want = _jax(path, corpus_dir)
    # the JAX run says which workers this path has (the mesh ingest
    # packs inline: none) and how often each seam was consulted
    assert _restarts(_clean[0]) == _restarts(_clean[1])
    assert faults.get_registry().snapshot() \
        == jfaults.get_registry().snapshot()
    if path == "exact":
        fields = ("names", "lengths", "topk_ids", "topk_counts", "df",
                  "num_docs", "words")
        _assert_bit_equal(got, clean, fields)
        _assert_bit_equal(got, want, fields)
        return
    _assert_bit_equal(got, clean, ("names", "path", "wire", "df",
                                   "lengths", "topk_ids", "topk_vals"))
    assert got.path == want.path
    np.testing.assert_array_equal(got.df, np.asarray(want.df))
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_array_equal(got.topk_ids, want.topk_ids)
    ids, lens = _padded_ids(corpus_dir, got.num_docs)
    rep = compare_topk(got.topk_ids, got.topk_vals, want.topk_ids,
                       np.asarray(want.topk_vals, np.float32),
                       token_ids=ids, lengths=lens, df=got.df,
                       num_docs=got.num_docs, wire_dtype=np.float16)
    assert rep["ok"], rep


def test_fatal_fault_propagates(corpus_dir, _clean):
    _arm("pack_worker:fatal:n=1")
    with pytest.raises(faults.FatalFault):
        _port("ragged", corpus_dir)
    with pytest.raises(jfaults.FatalFault):
        _jax("ragged", corpus_dir)
    # no restart was tried: the fault went straight to the caller
    assert _restarts(_clean[0]) == _restarts(_clean[1]) == []
    assert [e["seam"] for e in _clean[0].events()
            if e["event"] == "fault_injected"] == ["pack_worker"]


def test_restart_budget_bounds_retries(corpus_dir, _clean, monkeypatch):
    monkeypatch.setenv("TFIDF_TPU_RESTART_BUDGET", "1")
    _arm("pack_worker:transient:n=5")
    with pytest.raises(faults.TransientFault):
        _port("ragged", corpus_dir)
    with pytest.raises(jfaults.TransientFault):
        _jax("ragged", corpus_dir)
    # chunk 0 restarted once and then surfaced; the next chunk's job may
    # have started before the loop closed its worker, in either package
    for log in _clean:
        assert ("packer", 0, 1) in _restarts(log)
        assert max(r for _, _, r in _restarts(log)) == 1


def _crash_once(module, monkeypatch):
    """Wrap ``module.make_flat_packer`` so its first pack raises OSError."""
    real = module.make_flat_packer
    state = {"crashed": False}

    def factory(*a, **k):
        pack = real(*a, **k)

        def crashing(names):
            if not state["crashed"]:
                state["crashed"] = True
                raise OSError("disk hiccup")
            return pack(names)
        return crashing

    monkeypatch.setattr(module, "make_flat_packer", factory)


def test_real_exception_is_restarted(corpus_dir, _clean, monkeypatch):
    clean = _port("ragged", corpus_dir)
    _crash_once(ing, monkeypatch)
    _crash_once(jing, monkeypatch)
    got = _port("ragged", corpus_dir)
    want = _jax("ragged", corpus_dir)
    _assert_bit_equal(got, clean, ("df", "lengths", "topk_ids",
                                   "topk_vals"))
    np.testing.assert_array_equal(got.topk_ids, want.topk_ids)
    for log in _clean:
        errs = [(e["worker"], e["chunk"], e["restart"], e["error"])
                for e in log.events() if e["event"] == "worker_restart"]
        assert errs == [("packer", 0, 1, "OSError")]


def test_index_dir_fires_no_seam(corpus_dir, _clean):
    _arm("pack_worker:fatal:n=1")
    cfg, jcfg = _cfgs()
    TfidfRetriever(cfg, device="cpu").index_dir(
        corpus_dir, doc_len=DOC_LEN, chunk_docs=CHUNK)
    JRetriever(jcfg).index_dir(corpus_dir, doc_len=DOC_LEN,
                               chunk_docs=CHUNK)
    for reg in (faults.get_registry(), jfaults.get_registry()):
        assert reg.snapshot()["pack_worker:fatal:n=1"]["checked"] == 0


def test_workers_beat_the_armed_monitor(corpus_dir):
    monitors = (HealthMonitor(), JHealthMonitor())
    set_monitor(monitors[0])
    jset_monitor(monitors[1])
    _port("ragged", corpus_dir)
    _jax("ragged", corpus_dir)
    names = [set(m._workers) for m in monitors]
    assert names[0] == names[1] == {"packer", "drainer"}
    assert all(m._workers["packer"].beats > 0 for m in monitors)


def _doctor():
    tools = os.path.join(REPO, "tools")
    if tools not in sys.path:
        sys.path.append(tools)
    spec = importlib.util.spec_from_file_location(
        "doctor", os.path.join(tools, "doctor.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_doctor_counts_the_same_restarts(corpus_dir, _clean, tmp_path):
    _arm(TRANSIENT + ";pack_worker:transient:at=3")
    _port("ragged", corpus_dir)
    _jax("ragged", corpus_dir)
    doctor = _doctor()
    by_worker = []
    for log, name in zip(_clean, ("port", "jax")):
        path = log.dump(str(tmp_path / f"{name}.jsonl"))
        by_worker.append(
            doctor.analyze_flight(path)["faults"]["restarts_by_worker"])
    assert by_worker[0] == by_worker[1] == {"packer": 2, "drainer": 1}


def test_a_rerun_drain_reads_the_same_buffer():
    words = torch.arange(24, dtype=torch.int32).reshape(4, 6).view(
        torch.uint32)
    copy = ing._HostCopy(words)
    first = copy.result()
    second = copy.result()
    np.testing.assert_array_equal(first, second)
    assert np.shares_memory(first, second)  # not released, not replaced


def test_a_repacked_exact_chunk_gets_the_same_ids(corpus_dir, native):
    paths = [[os.path.join(corpus_dir, f"doc{i}") for i in (j, j + 1)]
             for j in (1, 3)]
    with ft.InternSession(VOCAB) as sess:
        sess.pack_flat(paths[0], None, DOC_LEN, pad_docs_to=CHUNK)
        first = sess.pack_flat(paths[1], None, DOC_LEN, pad_docs_to=CHUNK)
        n_words = sess.count
        again = sess.pack_flat(paths[1], None, DOC_LEN, pad_docs_to=CHUNK)
        assert sess.count == n_words  # append-only: nothing new
    (flat_a, lens_a, total), (flat_b, lens_b, total_b) = first, again
    assert total == total_b
    np.testing.assert_array_equal(flat_a[:total], flat_b[:total])
    np.testing.assert_array_equal(lens_a, lens_b)
