#!/usr/bin/env python3
"""Profile one warm overlapped-ingest chunk with torch.profiler and print
its device-op table (the port's counterpart of ``tools/trace_capture.py``).

    python3 tfidf_tpu_torch/tools/trace_capture.py [--input DIR | --docs N]
        [--len 256] [--wire ragged|bytes|padded] [--out DIR]
        [--device cuda|cpu] [--host-trace]

Without ``--input`` it writes ``--docs`` seeded Zipf documents (default
32,768: one chunk of ``chip_smoke.py``'s ingest shape) into a temporary
directory. It runs ``ingest.run_overlapped`` over them once as one chunk
(the warm-up: it builds the kernels and the host loader), then once more
under torch.profiler with CPU and CUDA activity, writes the capture to
``<out>/device_trace.json`` (Chrome trace JSON: Perfetto opens it) and
prints ``obs.device_op_table`` of it: each device op's total time, its
calls and its share of the device time, beside the launches
``ops.kernels.LAUNCHES`` counted across the capture. ``--host-trace``
also records the host span timeline of the profiled run into
``<out>/host_trace.json``; both carry the ``phase_b`` marker (an NVTX
range on the card). The last line is one JSON object of the table.

On the CPU (``--device cpu``) the capture has no device lanes and the
table is empty.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tfidf_tpu_torch import obs  # noqa: E402
from tfidf_tpu_torch.config import PipelineConfig, VocabMode  # noqa: E402
from tfidf_tpu_torch.ingest import run_overlapped  # noqa: E402
from tfidf_tpu_torch.ops import kernels as K  # noqa: E402

VOCAB = 1 << 16
TOPK = 16
N_WORDS = 8192


def write_zipf_corpus(root: str, n_docs: int, length: int,
                      seed: int = 0) -> None:
    """``n_docs`` files doc1.. of Zipf(1.3) words over N_WORDS words,
    Zipf-shaped lengths capped at ``length`` tokens."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}".encode() for i in range(N_WORDS)]
    lens = np.clip(rng.zipf(1.5, n_docs) * 8, 1, length)
    for d, n in enumerate(lens.tolist()):
        ranks = np.clip(rng.zipf(1.3, n), 1, N_WORDS) - 1
        with open(os.path.join(root, f"doc{d + 1}"), "wb") as f:
            f.write(b" ".join(words[r] for r in ranks.tolist()) + b"\n")


def capture(input_dir: str, cfg: PipelineConfig, *, doc_len: int,
            chunk_docs: int, device: str, out_dir: str,
            host_trace: bool = False) -> dict:
    """One warm-up run, then one profiled run of ``run_overlapped``:
    the table, its total device microseconds, the launches counted across
    the profiled run and the capture's path. ``host_trace`` arms the span
    tracer for the profiled run (into ``<out_dir>/host_trace.json``; the
    caller exports it)."""
    from torch.profiler import ProfilerActivity, profile

    kw = dict(doc_len=doc_len, chunk_docs=chunk_docs, device=device)
    run_overlapped(input_dir, cfg, **kw)
    if host_trace:
        obs.configure(os.path.join(out_dir, "host_trace.json"))
    activities = [ProfilerActivity.CPU]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    before = dict(K.LAUNCHES)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        r = run_overlapped(input_dir, cfg, **kw)
        if cuda:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "device_trace.json")
    prof.export_chrome_trace(path)
    rows, total_us = obs.device_op_table(obs.load_chrome_trace(path),
                                         top=25)
    return {"trace": path, "rows": rows, "total_us": total_us,
            "launches": launches, "wall_ms": wall_ms, "docs": r.num_docs,
            "wire": r.wire, "path": r.path, "finish": r.finish}


def print_table(cap: dict, top: int) -> None:
    total = cap["total_us"]
    print(f"trace: {cap['trace']}")
    print("\n| op | total ms | calls | % of device time |")
    print("|---|---|---|---|")
    for name, us, calls in cap["rows"][:top]:
        print(f"| {name[:60]} | {us / 1e3:9.4f} | {calls:5d} | "
              f"{100 * us / max(total, 1e-9):5.1f}% |")
    print(f"\ntotal device-lane time: {total / 1e3:.4f} ms in a "
          f"{cap['wall_ms']:.2f} ms run of {cap['docs']} docs "
          f"({cap['wire']} wire, {cap['path']}, {cap['finish']} finish)")
    print(f"kernel launches: {cap['launches']}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default=None)
    ap.add_argument("--docs", type=int, default=32768)
    ap.add_argument("--len", type=int, dest="length", default=256)
    ap.add_argument("--wire", choices=["ragged", "bytes", "padded"],
                    default="ragged")
    ap.add_argument("--out", default=None,
                    help="directory of the capture (default: a temporary "
                         "one, removed)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--host-trace", action="store_true")
    args = ap.parse_args()
    cfg = PipelineConfig(vocab_mode=VocabMode.HASHED, vocab_size=VOCAB,
                         max_doc_len=args.length, doc_chunk=args.length,
                         topk=TOPK, wire=args.wire)
    with tempfile.TemporaryDirectory(prefix="trace_capture_") as tmp:
        input_dir = args.input
        if input_dir is None:
            input_dir = os.path.join(tmp, "corpus")
            os.makedirs(input_dir)
            write_zipf_corpus(input_dir, args.docs, args.length)
        n_docs = len(os.listdir(input_dir))
        out_dir = args.out or os.path.join(tmp, "capture")
        cap = capture(input_dir, cfg, doc_len=args.length,
                      chunk_docs=n_docs, device=args.device,
                      out_dir=out_dir, host_trace=args.host_trace)
        host = obs.export()
        print_table(cap, args.top)
        if host:
            print(f"host trace: {host}")
        print(json.dumps({k: cap[k] for k in (
            "rows", "total_us", "launches", "wall_ms", "docs", "wire",
            "path", "finish")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
