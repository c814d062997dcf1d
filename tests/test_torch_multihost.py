"""The port's multi-process runtime (``tfidf_tpu_torch.parallel.multihost``)
against the JAX package's, on the CPU.

* ``MpiLiteComm``: the frame protocol and the root-sequenced
  collectives over in-process socketpairs (allreduce exact and
  replicated, barrier, bcast, a tag mismatch aborts, ``from_env``
  validation), and ``shard_bounds``.
* ``run_sharded_ingest`` with 2 and 3 worker processes on
  ``device="cpu"``, in the resident and the streaming regime: bit-equal
  to a single-process ``run_overlapped`` of the port, and to the JAX
  package (ids, DF, lengths exact; float16 wire scores within 1 ulp, the
  IDF's float32 log may differ by 1 ulp across frameworks). A failing
  worker makes it raise.
* ``initialize``: a no-op without a coordinator, idempotent; a 2-process
  gloo group runs the mesh ingest (resident and streaming) over 2
  processes x 1 shard, bit-equal to the same mesh of 2 shards in one
  process.
* ``cli run --ingest-workers 2 --doc-len``: the JAX CLI's bytes.

Both packages run their Python packers (``TFIDF_TPU_NO_NATIVE=1``), so
no native build is needed. Subprocesses get free ports and their own
``communicate`` timeouts, and stragglers are killed.
"""

import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

import tfidf_tpu_torch as T
from tfidf_tpu_torch.ingest import run_overlapped
from tfidf_tpu_torch.parallel.multihost import (HostTopology, MpiLiteComm,
                                                MpiLiteError, initialize,
                                                run_sharded_ingest,
                                                shard_bounds)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _python_packers(monkeypatch):
    monkeypatch.setenv("TFIDF_TPU_NO_NATIVE", "1")
    monkeypatch.delenv("TFIDF_TPU_RESIDENT_ELEMS", raising=False)


def _make_comms(n):
    """A size-n mpi_lite world over in-process socketpairs."""
    pair = [[-1] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1, n):
            a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
            pair[i][j] = a.detach()
            pair[j][i] = b.detach()
    return [MpiLiteComm(r, n, [pair[r][j] for j in range(n)])
            for r in range(n)]


def _run_ranks(comms, fn):
    """fn(comm) on every rank concurrently -> rank-ordered results."""
    results = [None] * len(comms)
    errors = []

    def body(r):
        try:
            results[r] = fn(comms[r])
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=body, args=(r,))
               for r in range(len(comms))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    for comm in comms:
        comm.close()
    if errors:
        raise errors[0]
    return results


class TestMpiLiteComm:
    @pytest.mark.parametrize("n", [2, 3, 4])
    def test_allreduce_sum_is_exact_and_replicated(self, n):
        rng = np.random.default_rng(n)
        parts = [rng.integers(0, 1000, 64).astype(np.int32) for _ in range(n)]
        want = np.sum(parts, axis=0, dtype=np.int32)
        for got in _run_ranks(_make_comms(n),
                              lambda c: c.allreduce_sum(parts[c.rank])):
            np.testing.assert_array_equal(got, want)

    def test_barrier_and_bcast(self):
        def body(comm):
            comm.barrier()
            return comm.bcast_bytes(b"payload" if comm.rank == 0 else None)
        assert _run_ranks(_make_comms(3), body) == [b"payload"] * 3

    def test_tag_mismatch_aborts_loudly(self):
        def body(comm):
            if comm.rank == 0:
                comm.send(1, 7, b"x")
                return None
            with pytest.raises(MpiLiteError, match="tag mismatch"):
                comm.recv(0, 8)
            return True
        assert _run_ranks(_make_comms(2), body) == [None, True]

    def test_wire_is_the_jax_packages(self):
        # The same bytes on the channel: a JAX-package rank and a port
        # rank speak to each other.
        from tfidf_tpu.parallel.multihost import MpiLiteComm as JComm
        a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
        port = MpiLiteComm(0, 2, [-1, a.detach()])
        jax_side = JComm(1, 2, [b.detach(), -1])
        arr = np.arange(17, dtype=np.int32)
        got = _run_ranks([port, jax_side], lambda c: c.allreduce_sum(arr))
        for g in got:
            np.testing.assert_array_equal(g, 2 * arr)

    def test_from_env_requires_launcher(self, monkeypatch):
        for var in ("MPILITE_RANK", "MPILITE_SIZE", "MPILITE_FDS"):
            monkeypatch.delenv(var, raising=False)
        with pytest.raises(MpiLiteError, match="launcher"):
            MpiLiteComm.from_env()

    def test_from_env_rejects_malformed_fds(self, monkeypatch):
        monkeypatch.setenv("MPILITE_RANK", "0")
        monkeypatch.setenv("MPILITE_SIZE", "2")
        monkeypatch.setenv("MPILITE_FDS", "-1,notanint")
        with pytest.raises(MpiLiteError, match="malformed"):
            MpiLiteComm.from_env()

    def test_shard_bounds_equal_the_jax_packages(self):
        from tfidf_tpu.parallel.multihost import shard_bounds as jax_bounds
        for docs, workers in ((26, 4), (5, 2), (8, 8), (3, 7), (0, 2),
                              (25, 3)):
            bounds = shard_bounds(docs, workers)
            assert bounds == jax_bounds(docs, workers)
            assert bounds[0][0] == 0 and bounds[-1][1] == docs
            for (_, a_hi), (b_lo, _) in zip(bounds, bounds[1:]):
                assert a_hi == b_lo
            assert all(hi > lo for lo, hi in bounds) or docs == 0
        with pytest.raises(ValueError):
            shard_bounds(4, 0)


class TestInitialize:
    def test_noop_reports_local_topology(self, monkeypatch):
        monkeypatch.delenv("MASTER_ADDR", raising=False)
        topo = initialize()
        assert isinstance(topo, HostTopology)
        assert (topo.process_id, topo.num_processes) == (0, 1)
        assert topo.local_devices == topo.global_devices >= 1
        import torch.distributed as dist
        assert not dist.is_initialized()

    def test_idempotent(self, monkeypatch):
        monkeypatch.delenv("MASTER_ADDR", raising=False)
        assert initialize() == initialize()


def _write_corpus(path, n_docs, seed, n_words=300, max_len=40):
    rng = np.random.default_rng(seed)
    path.mkdir()
    for i in range(1, n_docs + 1):
        (path / f"doc{i}").write_text(
            " ".join(f"w{rng.integers(0, n_words)}"
                     for _ in range(rng.integers(1, max_len))))
    return str(path)


def _cfg():
    return T.PipelineConfig(vocab_mode=T.VocabMode.HASHED, vocab_size=2048,
                            topk=4, engine="sparse")


def _jax_cfg():
    from tfidf_tpu.config import PipelineConfig, VocabMode
    return PipelineConfig(vocab_mode=VocabMode.HASHED, vocab_size=2048,
                          topk=4, engine="sparse")


def _assert_bit_identical(ref, got):
    np.testing.assert_array_equal(ref.df, got.df)
    np.testing.assert_array_equal(ref.topk_vals, got.topk_vals)
    np.testing.assert_array_equal(ref.topk_ids, got.topk_ids)
    np.testing.assert_array_equal(ref.lengths, got.lengths)
    assert ref.names == got.names
    assert ref.df_occupied == got.df_occupied


def _assert_equals_jax(got, want):
    np.testing.assert_array_equal(got.df, np.asarray(want.df))
    np.testing.assert_array_equal(got.topk_ids, want.topk_ids)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_allclose(got.topk_vals, want.topk_vals,
                               rtol=2 ** -10, atol=0)
    assert got.names == want.names


class TestShardedIngest:
    @pytest.mark.parametrize("n_workers,regime", [
        (2, "resident"), (3, "resident"), (2, "streaming"),
        (3, "streaming")])
    def test_bit_parity(self, tmp_path, monkeypatch, n_workers, regime):
        from tfidf_tpu.ingest import run_overlapped as jax_run
        if regime == "streaming":
            monkeypatch.setenv("TFIDF_TPU_RESIDENT_ELEMS", "0")
        d = _write_corpus(tmp_path / "input", 25, seed=11 + n_workers)
        ref = run_overlapped(d, _cfg(), chunk_docs=8, doc_len=32,
                             device="cpu")
        assert ref.path == regime
        got, info = run_sharded_ingest(d, _cfg(), n_workers=n_workers,
                                       chunk_docs=8, doc_len=32,
                                       device="cpu", timeout_s=120)
        _assert_bit_identical(ref, got)
        assert got.path == f"sharded-{n_workers}proc:{regime}"
        assert info.n_workers == n_workers == len(info.link_utilization)
        assert info.shards == shard_bounds(25, n_workers)
        assert info.worker_device_bytes == [0] * n_workers
        _assert_equals_jax(got, jax_run(d, _jax_cfg(), chunk_docs=8,
                                        doc_len=32))

    def test_equals_the_jax_sharded_ingest(self, tmp_path):
        from tfidf_tpu.parallel.multihost import \
            run_sharded_ingest as jax_sharded
        d = _write_corpus(tmp_path / "input", 25, seed=11)
        got, info = run_sharded_ingest(d, _cfg(), n_workers=2, chunk_docs=8,
                                       doc_len=32, device="cpu",
                                       timeout_s=120)
        want, jinfo = jax_sharded(d, _jax_cfg(), n_workers=2, chunk_docs=8,
                                  doc_len=32, timeout_s=120)
        _assert_equals_jax(got, want)
        assert info.shards == jinfo.shards == [(0, 12), (12, 25)]
        assert got.path == want.path == "sharded-2proc:resident"
        assert got.df_occupied == want.df_occupied

    def test_failed_worker_raises(self, tmp_path):
        # EXACT vocab is refused by run_overlapped inside each worker.
        d = _write_corpus(tmp_path / "input", 6, seed=3)
        with pytest.raises(RuntimeError, match="ingest worker 0 failed"):
            run_sharded_ingest(d, T.PipelineConfig(topk=4), n_workers=2,
                               doc_len=32, device="cpu", timeout_s=120)

    def test_no_cuda_no_silent_cpu(self, tmp_path):
        import torch
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        d = _write_corpus(tmp_path / "input", 6, seed=3)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_sharded_ingest(d, _cfg(), n_workers=2, doc_len=32)

    def test_hooks_refused_with_a_plan(self, tmp_path):
        from tfidf_tpu_torch.parallel import MeshPlan
        d = _write_corpus(tmp_path / "input", 6, seed=3)
        plan = MeshPlan.create(docs=2, device="cpu")
        for kw in ({"shard": (0, 3)}, {"df_merge": lambda df: df},
                   {"total_docs": 6}):
            with pytest.raises(ValueError, match="multi-PROCESS"):
                run_overlapped(d, _cfg(), doc_len=32, plan=plan, **kw)


_MESH_WORKER = r"""
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import tfidf_tpu_torch as T
from tfidf_tpu_torch.ingest import run_overlapped
from tfidf_tpu_torch.parallel import MeshPlan
from tfidf_tpu_torch.parallel.multihost import initialize

addr, pid, input_dir, expect = sys.argv[2], int(sys.argv[3]), sys.argv[4], \
    sys.argv[5]
topo = initialize(addr, 2, pid)
assert (topo.process_id, topo.num_processes) == (pid, 2), topo
assert initialize() == topo  # idempotent
plan = MeshPlan.create(docs=2, device="cpu")
assert (plan.n_docs_shards, plan.n_local_docs, plan.first_docs_shard) \
    == (2, 1, pid), plan
cfg = T.PipelineConfig(vocab_mode=T.VocabMode.HASHED, vocab_size=2048,
                       topk=4, engine="sparse")
r = run_overlapped(input_dir, cfg, chunk_docs=16, doc_len=32, plan=plan)
exp = np.load(expect)
np.testing.assert_array_equal(r.topk_ids, exp["ids"])
np.testing.assert_array_equal(r.df, exp["df"])
np.testing.assert_array_equal(r.topk_vals, exp["vals"])
np.testing.assert_array_equal(r.lengths, exp["lengths"])
assert r.path == exp["path"].item(), r.path
print("OK", pid)
"""


@pytest.mark.parametrize("regime", ["resident-mesh", "streaming-mesh"])
def test_mesh_ingest_across_processes(tmp_path, monkeypatch, regime):
    """run_overlapped's mesh regimes over 2 gloo processes x 1 shard ==
    the same mesh of 2 shards in one process, bit for bit."""
    from tfidf_tpu_torch.parallel import MeshPlan
    if regime == "streaming-mesh":
        monkeypatch.setenv("TFIDF_TPU_RESIDENT_ELEMS", "0")
    d = _write_corpus(tmp_path / "input", 24, seed=9, n_words=200,
                      max_len=30)
    ref = run_overlapped(d, _cfg(), chunk_docs=16, doc_len=32,
                         plan=MeshPlan.create(docs=2, device="cpu"))
    assert ref.path == regime
    expect = tmp_path / "expect.npz"
    np.savez(expect, ids=ref.topk_ids, vals=ref.topk_vals, df=ref.df,
             lengths=ref.lengths, path=np.array(ref.path))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        addr = f"localhost:{s.getsockname()[1]}"
    env = dict(os.environ)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MESH_WORKER, REPO, addr, str(pid), d,
         str(expect)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rc={p.returncode}\n{out}\n{err}"
    assert sorted(o.strip().splitlines()[-1] for o, _ in outs) \
        == ["OK 0", "OK 1"]


def test_cli_ingest_workers_same_bytes(tmp_path, capsys):
    from tfidf_tpu.cli import main as jax_main
    from tfidf_tpu_torch.cli import main as port_main
    d = _write_corpus(tmp_path / "input", 25, seed=5)
    args = ["run", "--input", d, "--vocab-mode", "hashed", "--vocab-size",
            "2048", "--topk", "4", "--doc-len", "32", "--chunk-docs", "8",
            "--ingest-workers", "2"]
    assert port_main(args + ["--output", str(tmp_path / "a"),
                             "--device", "cpu"]) == 0
    assert "sharded ingest: 2 workers" in capsys.readouterr().err
    # The JAX CLI's sharded run writes its single-process bytes (its own
    # tests pin that); the single-process run spares 2 JAX workers here.
    assert jax_main(args[:-2] + ["--output", str(tmp_path / "b")]) == 0
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
