"""What a traced run of the port records, against the JAX package's CLI on
the CPU (``TFIDF_TPU_NO_NATIVE=1`` on both sides, so the JAX package never
loads ``native/fast_tokenizer.so``).

* ``run --doc-len`` on the ragged, bytes and padded wires, the golden
  batch ``run``, ``stream`` and ``query``, each with ``--trace``: the
  port's trace, less the spans only the port records
  (``test_torch_hygiene.PORT_ONLY_VOCAB``), has the JAX trace's
  multiset of (lane, span name, carries a byte stamp). The golden run records ``discover``, ``pack``,
  ``transfer``, ``compute``, ``fetch`` and ``emit``.
* ``tools/trace_check.py`` passes the port's ingest traces in ingest
  mode (three lanes, byte stamps on every wire-moving span) and the
  flight dump each subcommand writes next to its trace.
* ``tools/doctor.py`` prints the same phase rows for both packages and
  exits 0; with ``TFIDF_TPU_DEVMON=1`` the run's dump holds an
  ``hbm_census`` and the doctor prints its HBM line.
* The ingest's phase dict and its spans measure the same intervals
  (within the JAX test's 5%); ``--timing`` phases and spans are one
  measurement; with the tracer off no span object is made.
"""

import collections
import concurrent.futures as cf
import importlib.util
import json
import os
import random
import subprocess
import sys

import pytest

from tfidf_tpu_torch import obs
from tfidf_tpu_torch.config import PipelineConfig, VocabMode
from tfidf_tpu_torch.ingest import run_overlapped
from tfidf_tpu_torch.io.corpus import discover_corpus
from tfidf_tpu_torch.obs import tracer as ttracer
from tfidf_tpu_torch.pipeline import TfidfPipeline
from tfidf_tpu_torch.utils.timing import PhaseTimer, phase_or_null
from test_torch_hygiene import PORT_ONLY_VOCAB

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ("tpu mesh psum shard kernel vector lane sublane tile grid "
         "block spec pallas jit pmap xla").split()
INGEST = ["run", "--vocab-mode", "hashed", "--topk", "3", "--doc-len", "16"]
CASES = {
    "ragged": INGEST + ["--wire", "ragged"],
    "bytes": INGEST + ["--wire", "bytes"],
    "padded": INGEST + ["--wire", "padded"],
    "golden": ["run"],
    "stream": ["stream", "--batch-docs", "4", "--doc-len", "16",
               "--topk", "3"],
    "query": ["query", "--query", "tpu mesh", "--query", "kernel", "-k", "3"],
}
WIRES = ["ragged", "bytes", "padded"]


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", TFIDF_TPU_NO_NATIVE="1",
               PYTHONPATH=REPO, TFIDF_TPU_LOG_ECHO="off")
    for key in ("TFIDF_TPU_TRACE", "TFIDF_TPU_FLIGHT", "TFIDF_TPU_DEVMON"):
        env.pop(key, None)
    env.update(extra)
    return env


def _write_corpus(root):
    rng = random.Random(7)
    os.makedirs(root)
    for i in range(1, 7):
        toks = [rng.choice(WORDS) for _ in range(rng.randint(3, 40))]
        with open(os.path.join(root, f"doc{i}"), "wb") as f:
            f.write(" ".join(toks).encode() + b"\n")
    return root


def _cli(pkg, case, corpus, out_dir, env=None):
    args = list(CASES[case]) + ["--input", corpus]
    if case != "query":
        args += ["--output", os.path.join(out_dir, f"{pkg}_{case}.txt")]
    trace = os.path.join(out_dir, f"{pkg}_{case}.json")
    args += ["--trace", trace]
    if pkg == "tfidf_tpu_torch":
        args += ["--device", "cpu"]
    p = subprocess.run([sys.executable, "-m", f"{pkg}.cli", *args],
                       cwd=REPO, env=env or _env(), capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    return trace, p


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """Every case traced by both CLIs: {(pkg, case): trace path}."""
    root = tmp_path_factory.mktemp("traces")
    corpus = _write_corpus(str(root / "input"))
    jobs = [(pkg, case) for case in CASES
            for pkg in ("tfidf_tpu", "tfidf_tpu_torch")]
    with cf.ThreadPoolExecutor(4) as ex:
        futs = {job: ex.submit(_cli, *job, corpus, str(root))
                for job in jobs}
        out = {job: f.result() for job, f in futs.items()}
    return {"corpus": corpus, "root": str(root),
            **{job: trace for job, (trace, _) in out.items()},
            **{("stderr",) + job: p.stderr for job, (_, p) in out.items()}}


PORT_ONLY_SPANS = {name for vocab, _, name in PORT_ONLY_VOCAB
                   if vocab == "spans"}


def _signature(path, drop=()):
    lanes = obs.spans_by_thread(obs.load_chrome_trace(path))
    return collections.Counter(
        (lane, e["name"], "bytes" in (e.get("args") or {}))
        for lane, evs in lanes.items() for e in evs if e["name"] not in drop)


@pytest.mark.parametrize("case", list(CASES))
def test_trace_equals_jax(traces, case):
    ours = _signature(traces["tfidf_tpu_torch", case], PORT_ONLY_SPANS)
    theirs = _signature(traces["tfidf_tpu", case])
    assert ours == theirs
    if case in WIRES:
        assert {lane for lane, _, _ in ours} == {"main", "packer", "drainer"}
        stamped = {name for _, name, b in ours if b}
        assert {"dispatch", "drain"} <= stamped
        if case == "bytes":
            assert {"slab", "device_tokenize"} <= stamped


def test_golden_run_records_the_pipeline_phases(traces):
    names = {name for _, name, _ in
             _signature(traces["tfidf_tpu_torch", "golden"])}
    assert {"discover", "pack", "transfer", "compute", "fetch",
            "emit"} <= names


def _tool(name, *args):
    return subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                        f"{name}.py"),
                           *args], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("wire", WIRES)
def test_trace_check_passes_the_ingest_trace(traces, wire):
    trace = traces["tfidf_tpu_torch", wire]
    p = _tool("trace_check", trace, "--mode", "ingest",
              "--flight", trace + ".flight.jsonl")
    assert p.returncode == 0, p.stdout + p.stderr
    assert "OK" in p.stdout


@pytest.mark.parametrize("case", ["ragged", "stream", "query"])
def test_every_subcommand_dumps_its_flight_recorder(traces, case):
    trace = traces["tfidf_tpu_torch", case]
    flight = trace + ".flight.jsonl"
    assert os.path.exists(flight)
    err = traces["stderr", "tfidf_tpu_torch", case]
    assert f"flight recorder dumped to {flight}" in err
    assert "tools/trace_check.py" in err
    p = _tool("trace_check", trace, "--mode", "schema", "--min-threads",
              "1", "--flight", flight)
    assert p.returncode == 0, p.stdout + p.stderr


def _phase_rows(text):
    """(name, spans) of each phase row of a doctor report."""
    lines = text.splitlines()
    start = next(i for i, line in enumerate(lines)
                 if line.split()[:2] == ["phase", "spans"])
    rows = []
    for line in lines[start + 1:]:
        parts = line.split()
        if len(parts) < 3 or not parts[1].isdigit():
            break
        rows.append((parts[0], int(parts[1])))
    return sorted(rows)


@pytest.mark.parametrize("case", ["ragged", "bytes", "golden", "stream"])
def test_doctor_prints_the_same_phase_rows(traces, case, tmp_path):
    reports = []
    for pkg in ("tfidf_tpu", "tfidf_tpu_torch"):
        trace = traces[pkg, case]
        p = _tool("doctor", trace, "--flight", trace + ".flight.jsonl",
                  "--ledger", str(tmp_path / "none.jsonl"))
        assert p.returncode == 0, p.stdout + p.stderr
        reports.append(_phase_rows(p.stdout))
    theirs, ours = reports
    ours = [row for row in ours if row[0] not in PORT_ONLY_SPANS]
    assert theirs == ours and ours


def test_devmon_census_reaches_the_doctor(traces, tmp_path):
    trace, p = _cli("tfidf_tpu_torch", "ragged", traces["corpus"],
                    str(tmp_path), env=_env(TFIDF_TPU_DEVMON="1"))
    flight = trace + ".flight.jsonl"
    events = [json.loads(line) for line in open(flight)][1:]
    census = [e for e in events if e.get("event") == "hbm_census"]
    assert len(census) == 1
    # on the CPU the census counts what the port can: no allocator total
    assert census[0]["owners"]["other"] == {"bytes": 0, "arrays": 0}
    d = _tool("doctor", trace, "--flight", flight,
              "--ledger", str(tmp_path / "none.jsonl"))
    assert d.returncode == 0, d.stdout + d.stderr
    assert "hbm owners: other 0.0 MB" in d.stdout
    assert "healthy" in d.stdout


def _load_doctor():
    spec = importlib.util.spec_from_file_location(
        "doctor_tool", os.path.join(REPO, "tools", "doctor.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    return mod


@pytest.fixture
def tracer():
    t = obs.Tracer()
    obs.set_tracer(t)
    yield t
    obs.set_tracer(None)


def test_ingest_phases_reconcile_with_spans(traces, tracer, tmp_path):
    """As the JAX package's acceptance pin: the phase dict the ingest
    returns and the doctor's span totals measure the same intervals,
    within 5% (plus 5 ms at the CPU timer's noise floor)."""
    cfg = PipelineConfig(vocab_mode=VocabMode.HASHED, topk=4,
                         vocab_size=1 << 12)
    r = run_overlapped(traces["corpus"], cfg, doc_len=16, chunk_docs=2,
                       device="cpu")
    trace = obs.export(str(tmp_path / "t.json"))
    report = _load_doctor().diagnose(trace, None,
                                     str(tmp_path / "no_ledger.jsonl"))
    phases, ph = report["phases"], r.phases

    def close(a, b):
        return abs(a - b) <= max(0.05 * max(a, b), 0.005)

    assert close(ph["pack"], phases["pack_wait"]["total_s"])
    assert close(ph["put"], phases["dispatch"]["total_s"])
    assert close(ph["pack_host"], phases["pack"]["total_s"])
    assert close(ph["fetch_host"], phases["drain"]["total_s"])
    assert close(ph["fetch"],
                 phases.get("fetch_wait", {}).get("total_s", 0.0)
                 + phases.get("fetch", {}).get("total_s", 0.0))
    assert report["ok"] and report["violations"] == []
    assert phases["dispatch"]["bytes"] > 0
    assert phases["pack"]["spans"] == phases["pack_wait"]["spans"] == 3


def test_timer_and_spans_are_one_measurement(traces, tracer):
    timer = PhaseTimer()
    corpus = discover_corpus(traces["corpus"])
    TfidfPipeline(PipelineConfig.golden(), timer=timer,
                  device="cpu").run(corpus)
    with phase_or_null(timer, "emit"):
        pass
    spans = obs.span_totals()
    assert set(spans) == set(timer.as_dict()) == {
        "pack", "transfer", "compute", "fetch", "emit"}
    for name, secs in timer.items():
        assert abs(spans[name] - secs) <= max(0.05 * secs, 2e-4), name


def test_no_span_object_without_the_tracer(traces, monkeypatch):
    made = []
    for cls in (ttracer._Span, ttracer._DeviceSpan):
        real = cls.__init__

        def counting(self, *a, _real=real, **kw):
            made.append(type(self).__name__)
            _real(self, *a, **kw)

        monkeypatch.setattr(cls, "__init__", counting)
    obs.set_tracer(None)
    with phase_or_null(None, "x"), phase_or_null(PhaseTimer(), "y"):
        pass
    cfg = PipelineConfig(vocab_mode=VocabMode.HASHED, topk=4,
                         vocab_size=1 << 12)
    for wire in WIRES:
        run_overlapped(traces["corpus"],
                       PipelineConfig(vocab_mode=VocabMode.HASHED, topk=4,
                                      vocab_size=1 << 12, wire=wire),
                       doc_len=16, chunk_docs=2, device="cpu")
    TfidfPipeline(PipelineConfig.golden(), timer=PhaseTimer(),
                  device="cpu").run(discover_corpus(traces["corpus"]))
    assert made == []
    # armed, the same calls make spans
    obs.set_tracer(obs.Tracer())
    try:
        run_overlapped(traces["corpus"], cfg, doc_len=16, device="cpu")
    finally:
        obs.set_tracer(None)
    assert made
