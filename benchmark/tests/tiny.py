"""Tiny sizes of every cell, for runs of the harness on the CPU."""

import time

from benchmark import harness

SERVE = {"config": {"docs": 2000, "word_types": 8192,
                    "serve": {"max_batch": 8, "max_wait_ms": 2.0,
                              "queue_depth": 256, "cache_entries": 4096,
                              "pipeline_depth": 2,
                              "scorer": "bm25:b=0.68,k1=0.82"}}}
TRAFFIC = {
    "serve_open": {"rate": 60, "profile_s": 0.5},
    "serve_closed": {"clients": 6, "profile_s": 0.5},
}
INGEST = {"config": {"docs": 1500, "word_types": 8192, "doc_len": 128,
                     "chunk_docs": 512,
                     "length": {"kind": "lognormal", "median": 60,
                                "sigma": 1.2, "min": 1, "max": 1000}}}


def overrides(layout: harness.Layout, cell: str) -> dict:
    kind = layout.cell(cell)["driver"]
    if kind == "ingest_passes":
        return INGEST
    return {**SERVE, "traffic": TRAFFIC[kind]}


def run(cell: str, seed: int = 11, seconds: float = 1.0, trace=False,
        layout=None, precision="float64") -> dict:
    layout = layout or harness.Layout()
    return harness.execute(cell, seed, seconds, trace, "cpu",
                           time.perf_counter(), layout,
                           overrides(layout, cell), precision)
