#!/usr/bin/env python3
"""Does torch.profiler still see the card after a served load? One GPU.

    python3 tfidf_tpu_torch/tools/serve_profile_probe.py [SCENARIO]

Each scenario runs in a process of its own over a 32,768-doc Zipf index
(``chip_smoke.zipf_corpus``, V 2^16) and ends with two probes, three
times each: a profiled ``torch.ones(2^20).sum()`` on the card (3 device
records) and a profiled 8-query search, each reporting how many device
events the profiler recorded.

* ``baseline``: the probes alone.
* ``load``: ``chip_smoke.serve_load`` (8 client threads x 32 requests)
  through a ``TfidfServer``, not profiled, then ``close()``.
* ``profiled1``: the same load from one client thread, profiled.
* ``profiled8``: the 8-thread load, profiled with the host ops of the
  calling thread only.
* ``profiled8_all``: the same with ``profile_all_threads``, so the
  profiler also records the batcher's and the clients' host ops, as
  ``chip_smoke.py``'s ``path_serve`` profiles its load.
* ``threads8``: 8 threads calling ``search`` directly, no server,
  profiled.
* ``cli``: ``cli serve`` in a subprocess over the corpus written out.
* ``big8``, ``big8_all``: ``profiled8`` and ``profiled8_all`` over
  131,072 docs, the index of ``chip_smoke.py``'s ``path_serve`` (32
  tiles a batch, four times the device records of a load).
* ``sessions40``: 40 profiled 8-query searches, then ``profiled8_all``.

Every scenario prints one JSON line: the probes' device-event counts,
the threads still alive after the server's ``close()``, and for a
profiled load the profiler's events per thread (host ops, CUDA runtime
calls, device events). Then the card's name and power limit. With a
scenario's name it runs that one alone, in this process.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SCENARIOS = ("baseline", "load", "profiled1", "profiled8", "profiled8_all",
             "threads8", "cli", "big8", "big8_all", "sessions40")


def profiled(fn, all_threads: bool = False):
    """``fn()`` under the CPU+CUDA profiler: its events and wall ms."""
    from torch.profiler import ProfilerActivity, profile

    kw = {}
    if all_threads:
        from torch._C._profiler import _ExperimentalConfig
        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 **kw) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof.events(), wall_ms


def per_thread(events) -> dict:
    from torch.autograd import DeviceType

    out = {}
    for e in events:
        row = out.setdefault(str(e.thread), {"host_ops": 0, "runtime": 0,
                                             "device": 0})
        if e.device_type == DeviceType.CUDA:
            row["device"] += 1
        elif e.name.startswith("cuda"):
            row["runtime"] += 1
        else:
            row["host_ops"] += 1
    return out


def device_count(events) -> int:
    from torch.autograd import DeviceType

    return sum(e.device_type == DeviceType.CUDA for e in events)


def run(name: str) -> dict:
    import tfidf_tpu_torch as T
    from tfidf_tpu_torch.config import ServeConfig
    from tfidf_tpu_torch.serve import TfidfServer

    rng = np.random.default_rng(cs.SEED)
    big = name.startswith("big")
    corpus = cs.zipf_corpus(T.Corpus, rng,
                            cs.INGEST_DOCS if big else cs.N_DOCS)
    cfg = T.PipelineConfig(vocab_mode=T.VocabMode.HASHED,
                           vocab_size=cs.SPARSE_VOCAB)
    r = T.TfidfRetriever(cfg).index(corpus)
    queries = cs.retrieval_queries(np.random.default_rng(cs.SEED + 3))
    requests = cs.serve_requests(np.random.default_rng(cs.SEED + 7), queries)
    r.search(queries[:8], k=cs.RETR_K)
    out = {"scenario": name, "torch": torch.__version__,
           "docs": len(corpus)}
    if name == "sessions40":
        for _ in range(40):
            profiled(lambda: r.search(queries[:8], k=cs.RETR_K))
        name = "profiled8_all"
    if big:
        name = name.replace("big", "profiled")
    if name in ("load", "profiled1", "profiled8", "profiled8_all"):
        srv = TfidfServer(r, ServeConfig())
        load = requests[:1] if name == "profiled1" else requests
        try:
            if name == "load":
                cs.serve_load(srv, load)
            else:
                events, wall = profiled(lambda: cs.serve_load(srv, load),
                                        name == "profiled8_all")
                out["load_device_events"] = device_count(events)
                out["load_wall_ms"] = wall
                out["load_threads"] = per_thread(events)
        finally:
            srv.close()
    elif name == "threads8":
        def client(t):
            for qs, kw in requests[t]:
                r.search(qs, k=cs.RETR_K, **kw)

        def load():
            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(len(requests))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)

        events, wall = profiled(load)
        out["load_device_events"] = device_count(events)
        out["load_threads"] = per_thread(events)
    elif name == "cli":
        with tempfile.TemporaryDirectory() as tmp:
            cs.write_corpus(tmp, corpus.docs)
            lines = [json.dumps({"id": i, "queries": [queries[i]], "k": 10})
                     for i in range(16)] + [json.dumps({"op": "shutdown"})]
            proc = subprocess.run(
                [sys.executable, "-m", "tfidf_tpu_torch.cli", "serve",
                 "--input", tmp, "--doc-len", str(cs.DOC_LEN),
                 "--canary-period-ms", "0"],
                input="\n".join(lines) + "\n", capture_output=True,
                text=True, timeout=600, cwd=REPO,
                env={**os.environ, "PYTHONPATH": REPO})
            out["cli_rc"] = proc.returncode
    out["threads_alive"] = sorted(t.name for t in threading.enumerate())
    out["probe_ones_device_events"] = []
    out["probe_search_device_events"] = []
    for _ in range(3):
        ones, _ = profiled(lambda: torch.ones(1 << 20, device="cuda").sum())
        search, _ = profiled(lambda: r.search(queries[:8], k=cs.RETR_K))
        out["probe_ones_device_events"].append(device_count(ones))
        out["probe_search_device_events"].append(device_count(search))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        sys.stderr.write("serve_profile_probe: no CUDA device\n")
        return 2
    if len(sys.argv) > 1:
        print(json.dumps(run(sys.argv[1])), flush=True)
        return 0
    rc = 0
    for name in SCENARIOS:
        proc = subprocess.run([sys.executable, __file__, name],
                              capture_output=True, text=True, timeout=600)
        lines = proc.stdout.strip().splitlines()
        print(lines[-1] if proc.returncode == 0 and lines else json.dumps(
            {"scenario": name, "rc": proc.returncode,
             "stderr": proc.stderr[-1500:]}), flush=True)
        rc |= proc.returncode
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
