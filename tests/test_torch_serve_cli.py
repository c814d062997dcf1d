"""``python -m tfidf_tpu_torch.cli serve`` against ``python -m
tfidf_tpu.cli serve``, in process with stdin monkeypatched, on the CPU.

* The same JSONL lines answer with the same names and scores (under
  ``parity.compare_search``): tfidf and bm25, filters, per-line k, at
  pipeline depth 1 and 2, on the batch index and through ``--doc-len``.
* Every op of the protocol answers: ``metrics``, ``metrics_prom``,
  ``obs_export``, ``healthz``, ``readyz``, ``devmon``, ``canary``,
  ``swap_index``, ``snapshot``, ``add_docs``, ``delete_docs``,
  ``set_scorer``, ``shutdown``; bad lines get error lines.
* ``--snapshot-dir`` restores a snapshot written by either package's
  server and serves the same answers.
* ``--mesh-shards N`` (0 = every device) serves the index doc-sharded
  with the JAX CLI's answers (the JAX side on its forced CPU devices);
  the devmon op reports the shards.
* ``trace_export`` answers the JAX CLI's bundle (empty with no tracer).
* ``--replicas 2 --snapshot-dir D`` runs the replicated tier (a front and
  2 replica processes on the CPU): a script of queries, ``add_docs``,
  ``delete_docs``, ``compact`` and the front's ops answers as the
  in-process ``serve`` of the port and of the JAX package do;
  ``--replica-timeout-s`` alone serves as the JAX CLI does.
* Without ``--device`` and without a GPU the command raises "no CUDA
  device available", with ``--replicas`` before any replica is spawned.
"""

import io
import json
import os
import socket
import threading

import numpy as np
import pytest
import torch

from tfidf_tpu import faults as jfaults
from tfidf_tpu.cli import main as jmain
from tfidf_tpu.obs import log as jlog

from tfidf_tpu_torch import faults, obs
from tfidf_tpu_torch.cli import main as tmain
from tfidf_tpu_torch.obs.health import set_monitor
from tfidf_tpu_torch.obs.log import EventLog
from tfidf_tpu_torch.parity import compare_search

T = 60  # seconds: the timeout of every wait in this file
BASE = ["--vocab-size", "512", "--max-wait-ms", "1", "--max-batch", "8"]
DOCS = [b"apple banana", b"cherry date", b"elder fig grape",
        b"apple grape", b"banana banana fig kiwi", b"date kiwi lemon apple"]


@pytest.fixture(autouse=True)
def _quiet_logs():
    obs.set_log(EventLog(echo="off"))
    jlog.set_log(jlog.EventLog(echo="off"))
    faults.disarm()
    jfaults.disarm()
    yield
    faults.disarm()
    jfaults.disarm()
    set_monitor(None)
    obs.set_log(None)
    jlog.set_log(None)


@pytest.fixture
def corpus_dir(tmp_path):
    d = tmp_path / "input"
    d.mkdir()
    for i, text in enumerate(DOCS, start=1):
        (d / f"doc{i}").write_bytes(text)
    return str(d)


def _run(main, lines, argv, monkeypatch, capsys):
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(lines) + "\n"))
    rc = main(argv)
    out = capsys.readouterr()
    return rc, [json.loads(x) for x in out.out.splitlines() if x], out.err


def _port(lines, argv, monkeypatch, capsys, device=True):
    extra = ["--device", "cpu"] if device else []
    return _run(tmain, lines, ["serve", *argv, *extra], monkeypatch, capsys)


def _jax(lines, argv, monkeypatch, capsys):
    return _run(jmain, lines, ["serve", *argv], monkeypatch, capsys)


def _as_search(results):
    """One response's results as ([Q, k] scores, [Q, k] ids) with the
    doc number as id (docN -> N), -1/0 padded."""
    k = max([len(r) for r in results] + [1])
    vals = np.zeros((len(results), k), np.float32)
    ids = np.full((len(results), k), -1, np.int64)
    for q, row in enumerate(results):
        for j, (name, score) in enumerate(row):
            vals[q, j] = score
            ids[q, j] = int(name[3:])
    return vals, ids


def _by_id(resp):
    return {r["id"]: r for r in resp if "id" in r}


REQUESTS = {
    "tfidf": [{"queries": ["apple", "cherry date"], "k": 3},
              {"queries": ["fig grape banana"], "k": 6},
              {"queries": ["kiwi", "lemon apple", "zzz"]}],
    "bm25": [{"queries": ["apple banana", "kiwi"], "k": 4,
              "scorer": "bm25"},
             {"queries": ["fig"], "k": 2, "scorer": "bm25:k1=1.5,b=0.6"}],
    "filters": [{"queries": ["apple", "kiwi"], "k": 5,
                 "filter": {"id_range": [0, 3]}},
                {"queries": ["banana"], "k": 5,
                 "filter": {"prefix": "doc5"}},
                {"queries": ["date"], "k": 5, "filter": {"ids": [1, 5]},
                 "scorer": "bm25"}],
}


@pytest.mark.parametrize("depth", ["1", "2"])
@pytest.mark.parametrize("doc_len", [None, "8"])
@pytest.mark.parametrize("group", sorted(REQUESTS))
def test_answers_equal_the_jax_cli(corpus_dir, monkeypatch, capsys, group,
                                   doc_len, depth):
    lines = [json.dumps({"id": i, **req})
             for i, req in enumerate(REQUESTS[group])]
    lines.append(json.dumps({"op": "shutdown"}))
    argv = ["--input", corpus_dir, *BASE, "--serve-pipeline-depth", depth]
    if doc_len is not None:
        argv += ["--doc-len", doc_len]
    rc_t, got, _ = _port(lines, argv, monkeypatch, capsys)
    rc_j, want, _ = _jax(lines, argv, monkeypatch, capsys)
    assert rc_t == rc_j == 0
    got, want = _by_id(got), _by_id(want)
    assert set(got) == set(want) == set(range(len(REQUESTS[group])))
    for i, req in enumerate(REQUESTS[group]):
        a, b = got[i], want[i]
        assert "results" in a and "results" in b, (a, b)
        assert a["epoch"] == b["epoch"] == 0 and a["rid"].startswith("r")
        cmp = compare_search(*_as_search(a["results"]),
                             *_as_search(b["results"]),
                             val_ulps=4 if "scorer" in req else 0)
        assert cmp["ok"], (req, a, b, cmp)


def test_every_op_answers(corpus_dir, tmp_path, monkeypatch, capsys):
    other = tmp_path / "other"
    other.mkdir()
    (other / "doc1").write_bytes(b"zebra yak")
    (other / "doc2").write_bytes(b"aardvark wolf")
    flight = tmp_path / "flight.jsonl"
    lines = [json.dumps(x) for x in [
        {"id": 1, "queries": ["apple"], "k": 2,
         "trace": {"id": "t0123456789abcdef", "parent": "s1"}},
        {"id": 2, "op": "healthz"}, {"id": 3, "op": "readyz"},
        {"id": 4, "op": "metrics"}, {"id": 5, "op": "metrics_prom"},
        {"id": 6, "op": "obs_export"}, {"id": 7, "op": "devmon"},
        {"id": 8, "op": "canary"}, {"id": 9, "op": "snapshot"},
        {"id": 10, "op": "set_scorer", "scorer": "bm25"},
        {"id": 11, "op": "swap_index", "input": str(other)},
        {"id": 12, "queries": ["zebra"], "k": 1},
        {"id": 13, "op": "add_docs", "docs": [{"name": "x", "text": "y"}]},
        {"id": 14, "op": "swap_index"},
        {"id": 15, "op": "nope"}, {"id": 16, "queries": "not-a-list"},
        {"id": 17, "queries": ["a"], "scorer": "nope"}]] + [
        "not json", json.dumps({"op": "shutdown"})]
    rc, resp, err = _port(
        lines, ["--input", corpus_dir, *BASE, "--snapshot-dir",
                str(tmp_path / "snap"), "--flight", str(flight)],
        monkeypatch, capsys)
    assert rc == 0 and "serving 6 docs on cpu" in err
    by = _by_id(resp)
    assert by[1]["trace"] == "t0123456789abcdef"
    assert by[1]["results"][0][0][0] in ("doc1", "doc4", "doc6")
    assert by[2]["healthz"]["status"] == "ok"
    assert by[2]["healthz"]["admission_bound"] == 256
    assert by[3]["readyz"] == {"ready": True, "status": "ok", "epoch": 0}
    m = by[4]["metrics"]
    assert m["fingerprint"]["backend"] == "cpu" and m["epoch"] == 0
    assert {"uptime_s", "slo", "latency_s", "batch"} <= m.keys()
    assert "serve_requests_total" in by[5]["metrics_prom"]
    assert by[6]["obs_export"]["schema"] == "tfidf-obs/1"
    dev = by[7]["devmon"]
    assert dev["devices"] == [{"device": 0, "kind": "cpu",
                               "platform": "cpu"}]
    assert dev["census"]["owners"]["resident_index"]["bytes"] > 0
    assert by[8]["canary"] == {"parity": 1.0}
    assert by[9] == {"id": 9, "snapshot": str(tmp_path / "snap"),
                     "epoch": 0}
    assert by[10] == {"id": 10, "scorer": "bm25:b=0.75,k1=1.2", "epoch": 1}
    assert by[11] == {"id": 11, "swapped": True, "epoch": 2}
    assert by[12]["results"][0][0][0] == "doc1" and by[12]["epoch"] == 2
    assert "no segmented index" in by[13]["error"]
    assert "swap failed" in by[14]["error"]
    assert "unknown op" in by[15]["error"]
    assert "bad request" in by[16]["error"]
    assert "bad request" in by[17]["error"]
    assert any(r.get("error", "").startswith("bad request")
               and "id" not in r for r in resp)
    assert flight.exists()
    head = json.loads(flight.read_text().splitlines()[0])
    assert head["schema"] == "tfidf-flight/1"


def test_canary_and_devmon_report_disabled(corpus_dir, monkeypatch, capsys):
    rc, resp, _ = _port(
        [json.dumps({"id": 1, "op": "canary"}),
         json.dumps({"id": 2, "op": "devmon"}), json.dumps({"op": "shutdown"})],
        ["--input", corpus_dir, *BASE, "--canary-period-ms", "0",
         "--devmon-period-ms", "0", "--no-warm"], monkeypatch, capsys)
    assert rc == 0
    by = _by_id(resp)
    assert "disabled" in by[1]["error"] and "disabled" in by[2]["error"]


@pytest.mark.parametrize("depth", ["1", "2"])
def test_add_and_delete_docs_match(corpus_dir, monkeypatch, capsys, depth):
    lines = [json.dumps(x) for x in [
        {"id": 1, "op": "add_docs", "docs": [
            {"name": "new1", "text": "kiwi kiwi zebra"},
            {"name": "doc2", "text": "zebra lemon"}]},
        {"id": 2, "queries": ["zebra", "kiwi"], "k": 3},
        {"id": 3, "op": "delete_docs", "names": ["new1", "ghost"]},
        {"id": 4, "queries": ["zebra", "kiwi"], "k": 3},
        {"id": 5, "op": "add_docs", "docs": "bad"},
        {"id": 6, "op": "delete_docs", "names": []},
        {"op": "shutdown"}]]
    argv = ["--input", corpus_dir, *BASE, "--delta-docs", "4",
            "--serve-pipeline-depth", depth]
    answers = []
    for run in (_port, _jax):
        rc, resp, _ = run(lines, argv, monkeypatch, capsys)
        assert rc == 0
        by = _by_id(resp)
        assert by[1] == {"id": 1, "added": 1, "updated": 1, "sealed": 0,
                         "epoch": 1}
        assert by[3] == {"id": 3, "deleted": 1, "missing": 1, "epoch": 2}
        assert "bad request" in by[5]["error"]
        assert "bad request" in by[6]["error"]
        assert by[2]["epoch"] == 1 and by[4]["epoch"] == 2
        answers.append([[[n for n, _ in row] for row in by[i]["results"]]
                        for i in (2, 4)])
    port_names, jax_names = answers
    assert port_names == jax_names
    assert set(port_names[0][0]) == {"new1", "doc2"}
    assert port_names[1][0] == ["doc2"] and "new1" not in port_names[1][1]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_dir_restores_either_package(corpus_dir, tmp_path,
                                              monkeypatch, capsys, writer):
    snap = str(tmp_path / "snap")
    q = [json.dumps({"id": 1, "queries": ["apple", "fig kiwi"], "k": 4}),
         json.dumps({"op": "shutdown"})]
    argv = ["--input", corpus_dir, *BASE, "--snapshot-dir", snap]
    if writer == "jax":
        rc, first, _ = _jax(q, argv, monkeypatch, capsys)
    else:
        rc, first, _ = _port(q, argv, monkeypatch, capsys)
    assert rc == 0
    # the other package restores it (the corpus is not read: delete it)
    import shutil
    shutil.rmtree(corpus_dir)
    if writer == "jax":
        rc, second, err = _port(q, argv, monkeypatch, capsys)
    else:
        rc, second, err = _jax(q, argv, monkeypatch, capsys)
    assert rc == 0 and "snapshot=restored" in err
    a, b = _by_id(first)[1], _by_id(second)[1]
    assert compare_search(*_as_search(a["results"]),
                          *_as_search(b["results"]))["ok"]


def test_without_device_and_without_gpu_raises(corpus_dir, monkeypatch,
                                               capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device available"):
        _port([json.dumps({"op": "shutdown"})], ["--input", corpus_dir],
              monkeypatch, capsys, device=False)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("flag,item", [
    (["--mesh-shards", "2"], "ROADMAP A9"),
    (["--mesh-shards", "0"], "ROADMAP A9"),
    (["--replicas", "2", "--snapshot-dir", "snap"], "ROADMAP A8b"),
    (["--replica-timeout-s", "5"], "ROADMAP A8b")])
def test_not_ported_flags_raise(corpus_dir, monkeypatch, capsys, flag,
                                item):
    if item == "ROADMAP A8b":
        # Ported now (ROADMAP A8b): --replicas serves through the
        # replicated tier, --replica-timeout-s alone through one server,
        # each with the JAX CLI's answers (the JAX side without
        # --replicas: its tier would spawn JAX replicas).
        monkeypatch.chdir(os.path.dirname(corpus_dir))
        monkeypatch.setenv("TFIDF_TPU_LOG_ECHO", "off")
        lines = [json.dumps({"id": i, **req})
                 for i, req in enumerate(REQUESTS["tfidf"] + REQUESTS["bm25"]
                                         + REQUESTS["filters"])]
        lines.append(json.dumps({"op": "shutdown"}))
        argv = ["--input", corpus_dir, *BASE, *flag]
        rc_t, got, err = _port(lines, argv, monkeypatch, capsys)
        jflag = [] if "--replicas" in flag else flag
        rc_j, want, _ = _jax(lines, ["--input", corpus_dir, *BASE, *jflag],
                             monkeypatch, capsys)
        assert rc_t == rc_j == 0
        assert ("front serving 2 replica(s)" in err) == ("--replicas" in flag)
        got, want = _by_id(got), _by_id(want)
        for i in range(len(lines) - 1):
            a, b = got[i], want[i]
            assert "results" in a and "results" in b, (a, b)
            cmp = compare_search(*_as_search(a["results"]),
                                 *_as_search(b["results"]), val_ulps=4)
            assert cmp["ok"], (a, b, cmp)
        return
    # Ported now (ROADMAP A9b): --mesh-shards serves doc-sharded with the
    # JAX CLI's answers; the devmon op reports the shards.
    lines = [json.dumps({"id": i, **req})
             for i, req in enumerate(REQUESTS["tfidf"] + REQUESTS["bm25"]
                                     + REQUESTS["filters"])]
    lines += [json.dumps({"id": "dev", "op": "devmon"}),
              json.dumps({"op": "shutdown"})]
    argv = ["--input", corpus_dir, *BASE, *flag]
    rc_t, got, err = _port(lines, argv, monkeypatch, capsys)
    rc_j, want, _ = _jax(lines, argv, monkeypatch, capsys)
    assert rc_t == rc_j == 0
    shards = int(flag[1]) or 1  # 0: every device, one CPU shard here
    assert f"mesh={flag[1]}" in err
    got, want = _by_id(got), _by_id(want)
    assert got["dev"]["devmon"]["shards"]["n_shards"] == shards
    for i in range(len(lines) - 2):
        a, b = got[i], want[i]
        assert "results" in a and "results" in b, (a, b)
        cmp = compare_search(*_as_search(a["results"]),
                             *_as_search(b["results"]), val_ulps=4)
        assert cmp["ok"], (a, b, cmp)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_tcp_mode_serves_the_same_protocol(corpus_dir, monkeypatch, capsys):
    port = _free_port()
    rc = {}
    th = threading.Thread(target=lambda: rc.setdefault("rc", tmain(
        ["serve", "--input", corpus_dir, *BASE, "--port", str(port),
         "--device", "cpu", "--canary-period-ms", "0"])), daemon=True)
    th.start()
    conn = None
    for _ in range(600):
        try:
            conn = socket.create_connection(("127.0.0.1", port), timeout=T)
            break
        except OSError:
            th.join(timeout=0.05)
    assert conn is not None, "the TCP server never listened"
    with conn, conn.makefile("rw") as f:
        f.write(json.dumps({"id": 1, "queries": ["cherry date"], "k": 2})
                + "\n")
        f.write(json.dumps({"id": 2, "op": "readyz"}) + "\n")
        f.flush()
        got = {}
        while len(got) < 2:
            line = f.readline()
            assert line, "connection closed early"
            r = json.loads(line)
            got[r["id"]] = r
        f.write(json.dumps({"op": "shutdown"}) + "\n")
        f.flush()
    th.join(timeout=T)
    assert not th.is_alive() and rc["rc"] == 0
    assert got[1]["results"][0][0][0] == "doc2"
    assert got[2]["readyz"]["ready"] is True


def test_sigterm_dumps_the_flight_recorder(corpus_dir, tmp_path):
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    flight = tmp_path / "flight.jsonl"
    proc = subprocess.Popen(
        [sys.executable, "-m", "tfidf_tpu_torch.cli", "serve", "--input",
         corpus_dir, *BASE, "--device", "cpu", "--flight", str(flight),
         "--canary-period-ms", "0"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=repo,
        env={**os.environ, "PYTHONPATH": repo})
    try:
        proc.stdin.write(json.dumps({"id": 1, "op": "readyz"}) + "\n")
        proc.stdin.flush()
        first = []                       # the loop is up and answering
        reader = threading.Thread(
            target=lambda: first.append(proc.stdout.readline()),
            daemon=True)
        reader.start()
        reader.join(timeout=T)
        assert first and json.loads(first[0])["readyz"]["ready"] is True
        proc.terminate()
        assert proc.wait(timeout=T) == 143
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=T)
        for f in (proc.stdin, proc.stdout, proc.stderr):
            f.close()
    lines = flight.read_text().splitlines()
    assert json.loads(lines[0])["schema"] == "tfidf-flight/1"
    assert any(json.loads(x).get("event") == "sigterm" for x in lines[1:])


def test_trace_export_answers_as_the_jax_cli(corpus_dir, monkeypatch,
                                             capsys):
    # No tracer armed in either package: both answer an empty bundle.
    from tfidf_tpu import obs as jobs
    monkeypatch.delenv("TFIDF_TPU_TRACE", raising=False)
    obs.set_tracer(None)
    jobs.set_tracer(None)
    lines = [json.dumps({"id": 1, "op": "trace_export"}),
             json.dumps({"op": "shutdown"})]
    argv = ["--input", corpus_dir, *BASE]
    rc_t, got, _ = _port(lines, argv, monkeypatch, capsys)
    rc_j, want, _ = _jax(lines, argv, monkeypatch, capsys)
    assert rc_t == rc_j == 0
    a, b = _by_id(got)[1], _by_id(want)[1]
    assert a.keys() == b.keys() == {"id", "trace_export"}
    assert a["trace_export"].keys() == b["trace_export"].keys()
    assert a["trace_export"]["schema"] == b["trace_export"]["schema"] \
        == "tfidf-trace/1"
    assert a["trace_export"]["processes"] == [] \
        == b["trace_export"]["processes"]


def _results_by_id(resp):
    return {r["id"]: r["results"] for r in resp if "results" in r}


def test_replicas_answer_as_the_in_process_serve(corpus_dir, tmp_path,
                                                 monkeypatch, capsys):
    # A segmented tier of 2 replica processes on the CPU: queries, then
    # add_docs / delete_docs / compact (each a two-phase epoch bump),
    # queries again, and the front's own ops. The in-process serve of
    # either package answers the same queries the same way (it has no
    # compact op and answers that line with an error). The front answers
    # each line before it reads the next.
    monkeypatch.setenv("TFIDF_TPU_LOG_ECHO", "off")
    queries = [{"queries": ["apple", "kiwi date"], "k": 4},
               {"queries": ["banana fig"], "k": 3, "scorer": "bm25"},
               {"queries": ["zebra apple", "lemon"], "k": 5}]
    script = [{"id": f"a{i}", **q} for i, q in enumerate(queries)]
    script += [
        {"id": "add", "op": "add_docs", "docs": [
            {"name": "doc7", "text": "zebra kiwi kiwi"},
            {"name": "doc8", "text": "apple zebra lemon"},
            {"name": "doc2", "text": "zebra fig"}]},
        {"id": "del", "op": "delete_docs", "names": ["doc3", "ghost"]},
        {"id": "compact", "op": "compact"}]
    script += [{"id": f"b{i}", **q} for i, q in enumerate(queries)]
    script += [{"id": "trace", "op": "trace_export"},
               {"id": "info", "op": "replica_info"}, {"op": "shutdown"}]
    lines = [json.dumps(x) for x in script]
    # a delta of 2 docs: the adds seal a segment, so compact merges
    argv = ["--input", corpus_dir, *BASE, "--delta-docs", "2"]
    rc, front, err = _port(lines, argv + [
        "--replicas", "2", "--snapshot-dir", str(tmp_path / "snap")],
        monkeypatch, capsys)
    assert rc == 0 and "front serving 2 replica(s) on cpu" in err
    rc_t, single, _ = _port(lines, argv, monkeypatch, capsys)
    rc_j, jax_single, _ = _jax(lines, argv, monkeypatch, capsys)
    # The JAX in-process serve has answered a query admitted before a
    # mutation line on the mutated index, so its answers to the first
    # queries come from those queries alone.
    rc_k, jax_first, _ = _jax(lines[:len(queries)] + [lines[-1]], argv,
                              monkeypatch, capsys)
    assert rc_t == rc_j == rc_k == 0
    by = _by_id(front)
    assert by["add"]["epoch"] == 1 and by["add"]["replicas"] == 2
    assert (by["add"]["added"], by["add"]["updated"]) == (2, 1)
    assert (by["del"]["deleted"], by["del"]["missing"],
            by["del"]["epoch"]) == (1, 1, 2)
    assert by["compact"]["epoch"] == 3 and by["compact"]["replicas"] == 2
    for i in range(len(queries)):
        assert by[f"a{i}"]["epoch"] == 0 and by[f"b{i}"]["epoch"] == 3
    info = by["info"]["replica_info"]
    assert set(info) == {"r1", "r2"}
    assert all(v["recompiles_after_warm"] == 0 and v["epoch"] == 3
               for v in info.values())
    procs = by["trace"]["trace_export"]
    assert procs["schema"] == "tfidf-trace/1"
    assert {p["process"] for p in procs["processes"]} == {"r1", "r2"}
    # every answer equals the in-process serve's bit for bit, and the
    # JAX CLI's by name (scores within compare_search's bounds)
    ours, plain = _results_by_id(front), _results_by_id(single)
    theirs = {**_results_by_id(jax_single), **_results_by_id(jax_first)}
    assert ours.keys() == plain.keys() == theirs.keys()
    assert ours == plain
    for key, res in ours.items():
        assert ([[n for n, _ in row] for row in res]
                == [[n for n, _ in row] for row in theirs[key]])
        for row, jrow in zip(res, theirs[key]):
            np.testing.assert_allclose([s for _, s in row],
                                       [s for _, s in jrow], rtol=1e-5,
                                       atol=1e-6)
    assert "doc8" in {n for n, _ in ours["b0"][0]}
    assert all(n != "doc3" for i in range(len(queries))
               for row in ours[f"b{i}"] for n, _ in row)


def test_replicas_without_device_fail_before_any_spawn(
        corpus_dir, tmp_path, monkeypatch, capsys):
    from tfidf_tpu_torch.serve import front
    spawned = []
    monkeypatch.setattr(front, "launch_rank",
                        lambda *a, **kw: spawned.append(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device available"):
        _port([json.dumps({"op": "shutdown"})],
              ["--input", corpus_dir, "--replicas", "2", "--snapshot-dir",
               str(tmp_path / "snap")], monkeypatch, capsys, device=False)
    assert spawned == [] and not (tmp_path / "snap").exists()
    assert capsys.readouterr().out == ""
