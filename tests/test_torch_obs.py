"""The port's span tracer, event log and fault registry
(tfidf_tpu_torch/obs/, faults.py) against the JAX package's, on the CPU.

* The tracer exports the JAX package's Chrome trace-event schema for the
  same spans (metadata lanes, complete and instant events, args, the
  export document's keys).
* ``device_span`` records with tracing on and is the shared no-op with
  it off; on the CPU it makes no NVTX call, and with CUDA initialised it
  pushes and pops one range around the span.
* The event ring keeps the last N events, rate-limits per name, and
  dumps the JAX package's flight-recorder schema.
* ``segment_seal`` and ``compaction`` events carry the JAX package's
  fields for the same operations.
* Fault plans parse and fire as in the JAX package, logging to the
  port's ring.
"""

import json

import numpy as np
import pytest
import torch

from tfidf_tpu import faults as jfaults
from tfidf_tpu.config import PipelineConfig as JConfig
from tfidf_tpu.config import VocabMode as JVocab
from tfidf_tpu.index import SegmentedIndex as JIndex
from tfidf_tpu.io.corpus import Corpus as JCorpus
from tfidf_tpu.obs import log as jlog
from tfidf_tpu.obs import tracer as jtracer

from tfidf_tpu_torch import faults as tfaults
from tfidf_tpu_torch import obs
from tfidf_tpu_torch.config import PipelineConfig as TConfig
from tfidf_tpu_torch.config import VocabMode as TVocab
from tfidf_tpu_torch.index import SegmentedIndex as TIndex
from tfidf_tpu_torch.io.corpus import Corpus as TCorpus
from tfidf_tpu_torch.obs import log as tlog
from tfidf_tpu_torch.obs import tracer as ttracer


def _record(mod):
    """The same spans on a fresh tracer of either package."""
    t = mod.Tracer()
    with t.span("outer", bytes=4096, rows=3):
        with t.span("inner"):
            pass
        t.instant("mark", step=1)
    h = t.begin("lifecycle", rid="r1")
    t.end(h, outcome="ok")
    t.name_thread("packer")
    with t.span("labelled"):
        pass
    return t


def _schema(events):
    out = []
    for e in events:
        row = {k: v for k, v in e.items() if k not in ("ts", "dur")}
        if e.get("name") == "process_name":
            row["args"] = {"name": "host"}  # the package's own label
        if "args" in row and "gb_s" in row["args"]:
            row["args"] = {**row["args"], "gb_s": "float"}
        out.append((sorted(e), row))
    return out


def test_chrome_events_schema_equals_jax():
    j, t = _record(jtracer), _record(ttracer)
    je, te = j.chrome_events(), t.chrome_events()
    assert _schema(te) == _schema(je)
    assert {e["ph"] for e in te} == {"M", "X", "i"}
    assert t.span_totals().keys() == j.span_totals().keys()


def test_export_document_schema(tmp_path):
    j, t = _record(jtracer), _record(ttracer)
    jp, tp = j.export(str(tmp_path / "j.json")), t.export(str(tmp_path / "t.json"))
    jd, td = json.load(open(jp)), json.load(open(tp))
    assert sorted(td) == sorted(jd) == ["displayTimeUnit", "disttrace",
                                        "traceEvents"]
    assert sorted(td["disttrace"]) == sorted(jd["disttrace"])
    assert obs.load_chrome_trace(tp) == td["traceEvents"]
    # one thread, relabelled: every span sits on the "packer" lane
    lanes = obs.spans_by_thread(td["traceEvents"])
    assert sorted(lanes) == ["packer"] and len(lanes["packer"]) == 4


def test_module_functions_are_no_ops_when_off():
    obs.set_tracer(None)
    assert not obs.enabled() and obs.export() is None
    assert obs.span("x") is obs.device_span("y")
    obs.end(obs.begin("z"))
    obs.instant("w")
    assert obs.span_totals() == {}


@pytest.fixture
def nvtx_calls(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda.nvtx, "range_push",
                        lambda name: calls.append(("push", name)))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop",
                        lambda: calls.append(("pop",)))
    yield calls
    obs.set_tracer(None)


def test_device_span_on_the_cpu_makes_no_nvtx_call(nvtx_calls):
    assert not torch.cuda.is_initialized()
    with obs.device_span("off", docs=1):
        pass
    obs.set_tracer(obs.Tracer())
    with obs.device_span("on", docs=2):
        pass
    assert nvtx_calls == []
    assert [(e[0], e[4]) for e in obs.get_tracer().events()] == [
        ("on", {"docs": 2})]


def test_device_span_pushes_a_range_once_cuda_is_up(nvtx_calls,
                                                    monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with obs.device_span("off"):
        pass
    assert nvtx_calls == []  # tracing off: nothing at all
    obs.set_tracer(obs.Tracer())
    with pytest.raises(KeyError):
        with obs.device_span("stream_update", docs=3):
            raise KeyError("the range closes on an error too")
    assert nvtx_calls == [("push", "stream_update"), ("pop",)]
    assert obs.span_totals().keys() == {"stream_update"}


def test_configure_and_export(tmp_path, monkeypatch):
    path = str(tmp_path / "t.json")
    monkeypatch.delenv("TFIDF_TPU_TRACE", raising=False)
    try:
        assert obs.configure(None) is None or not obs.enabled()
        assert obs.configure(path) == path and obs.enabled()
        first = obs.get_tracer()
        assert obs.configure(path) == path and obs.get_tracer() is first
        with obs.span("a"):
            pass
        assert obs.export() == path and obs.trace_path() == path
        assert [e["name"] for e in obs.load_chrome_trace(path)
                if e["ph"] == "X"] == ["a"]
    finally:
        obs.set_tracer(None)


@pytest.mark.parametrize("cap", [1, 3, 8])
def test_event_ring_keeps_the_last_n(cap):
    log = tlog.EventLog(capacity=cap, echo="off")
    for i in range(20):
        assert log.info(f"e{i}", i=i)
    got = log.events()
    assert [e["event"] for e in got] == [f"e{i}" for i in range(20 - cap, 20)]
    assert [e["i"] for e in got] == list(range(20 - cap, 20))


def test_rate_limit_and_reserved_kind():
    log = tlog.EventLog(rate_per_s=1.0, burst=2, echo="off")
    admitted = [log.warning("burst") for _ in range(5)]
    assert admitted == [True, True, False, False, False]
    assert log.suppressed() == {"burst": 3}
    log.info("other", kind="x")
    assert log.events()[-1]["field_kind"] == "x"
    with pytest.raises(ValueError, match="unknown log level"):
        log.log("loud", "e")


def test_flight_dump_schema_equals_jax(tmp_path):
    dumps = []
    for mod in (jlog, tlog):
        log = mod.EventLog(echo="off")
        log.info("segment_seal", seg_id=1, docs=4)
        log.digest(outcome="ok", kind="search")
        dumps.append(log.dump(str(tmp_path / f"{mod.__name__}.jsonl")))
    lines = [[json.loads(x) for x in open(p)] for p in dumps]
    assert [sorted(x) for x in lines[0]] == [sorted(x) for x in lines[1]]
    assert lines[1][0]["schema"] == jlog.FLIGHT_SCHEMA == tlog.FLIGHT_SCHEMA
    assert [x.get("kind") for x in lines[1]] == [None, "event", "digest"]


def test_dump_flight_follows_the_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("TFIDF_TPU_FLIGHT", raising=False)
    monkeypatch.setattr(tlog, "_flight", None)
    assert tlog.dump_flight() is None
    obs.set_tracer(obs.Tracer(), str(tmp_path / "t.json"))
    try:
        assert obs.flight_path() == str(tmp_path / "t.json") + ".flight.jsonl"
    finally:
        obs.set_tracer(None)
    assert obs.configure_flight(str(tmp_path / "f.jsonl")) \
        == str(tmp_path / "f.jsonl")
    obs.record_digest(outcome="ok")
    assert obs.dump_flight() == str(tmp_path / "f.jsonl")


@pytest.mark.parametrize("name", [
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "DEFAULT_BUCKETS",
    "HealthMonitor", "HealthThresholds", "HealthStatus", "DeviceMonitor",
    "CompileWatch", "SloTracker"])
def test_serving_members_name_a8(name):
    # The serving members ROADMAP A8 brought: each loads lazily from the
    # port's own module, as the JAX package's load from its.
    import tfidf_tpu.obs as jobs
    member = getattr(obs, name)
    if name == "DEFAULT_BUCKETS":
        assert member == jobs.DEFAULT_BUCKETS
    else:
        assert member.__module__.startswith("tfidf_tpu_torch.obs.")
        assert member.__name__ == getattr(jobs, name).__name__ == name


def test_unknown_member_is_an_attribute_error():
    with pytest.raises(AttributeError):
        obs.no_such_member  # noqa: B018


# --- faults ----------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "swap:fatal:n=2", "swap:transient:at=2", "swap:fatal:match=zz",
    "swap:transient:p=0.5", "device_dispatch:transient:n=2;swap:fatal:n=-1",
    "batcher_loop:sleep:s=0"])
def test_fault_plans_fire_as_in_jax(spec):
    fired = []
    for mod in (jfaults, tfaults):
        plan = mod.FaultPlan.parse(spec, seed=3)
        reg = mod.FaultRegistry().arm(plan)
        got = []
        for i in range(6):
            try:
                reg.fire("swap", text="a zz b" if i % 2 else "plain")
                got.append(None)
            except mod.InjectedFault as e:
                got.append(type(e).__name__)
        fired.append((got, reg.snapshot()))
    assert fired[0] == fired[1]


def test_fault_events_land_in_the_ports_log():
    log = tlog.EventLog(echo="off")
    tlog.set_log(log)
    try:
        tfaults.arm(tfaults.FaultPlan.parse("swap:fatal:n=1"))
        with pytest.raises(tfaults.FatalFault):
            tfaults.fire("swap", op="compact")
        tfaults.fire("swap", op="compact")  # budget spent
    finally:
        tfaults.disarm()
        tlog.set_log(None)
    ev = [e for e in log.events() if e["event"] == "fault_injected"]
    assert len(ev) == 1 and ev[0]["seam"] == "swap" \
        and ev[0]["fault_kind"] == "fatal" and ev[0]["op"] == "compact"


@pytest.mark.parametrize("bad", ["nope:fatal", "swap:weird", "swap",
                                 "swap:fatal:q=1", "swap:fatal:at=0", ""])
def test_bad_fault_specs_raise(bad):
    with pytest.raises(ValueError):
        tfaults.FaultPlan.parse(bad)


def test_backoff_matches_jax():
    import random
    for attempt in (1, 2, 5, 20):
        assert tfaults.backoff_s(attempt, rng=random.Random(1)) \
            == jfaults.backoff_s(attempt, rng=random.Random(1))


# --- index lifecycle events ------------------------------------------

_DOCS = {"doc1": "apple banana apple", "doc2": "banana date",
         "doc3": "cherry fig", "doc4": "fig fig grape"}


def _lifecycle(Index, Config, Vocab, Corpus, logmod, **kw):
    log = logmod.EventLog(echo="off")
    logmod.set_log(log)
    try:
        cfg = Config(vocab_mode=Vocab.HASHED, vocab_size=256,
                     max_doc_len=8, doc_chunk=8)
        idx = Index.from_corpus(
            Corpus(names=list(_DOCS), docs=[v.encode() for v in _DOCS.values()]),
            cfg, delta_docs=2, compact_at=2, **kw)
        idx.add_docs(["a1", "a2", "a3"], ["kiwi", "lime lime", "melon"])
        idx.delete_docs(["doc2", "a1"])
        idx.add_docs(["a4", "a5"], ["kiwi fig", "date"])
        idx.compact()
    finally:
        logmod.set_log(None)
    return [e for e in log.events()
            if e["event"] in ("segment_seal", "compaction")]


def test_seal_and_compaction_events_carry_jax_fields():
    j = _lifecycle(JIndex, JConfig, JVocab, JCorpus, jlog)
    t = _lifecycle(TIndex, TConfig, TVocab, TCorpus, tlog, device="cpu")
    assert [e["event"] for e in t] == [e["event"] for e in j] == [
        "segment_seal", "segment_seal", "compaction"]
    for a, b in zip(t, j):
        assert sorted(a) == sorted(b)
        skip = {"t", "msg", "pause_s"}
        assert {k: v for k, v in a.items() if k not in skip} \
            == {k: v for k, v in b.items() if k not in skip}
    assert t[-1]["dropped_tombstones"] == 2 and np.isfinite(t[-1]["pause_s"])
