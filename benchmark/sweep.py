#!/usr/bin/env python3
"""Find the knee of an open-loop served cell: the highest offered rate
the server sustains (at least 99% of the offered queries answered, the
backlog not growing) and, beside it, the highest at which the request
p99 also stays within a latency budget.

    python3 benchmark/sweep.py --workload marco-serve-steady --seed 7 \\
        --rates 400,600,800,1000 [--repeats 2] [--seconds 40] \\
        [--budget-ms 100]

One process builds the cell's index once, then offers each rate in turn
for ``--seconds`` through the cell's own driver, every request a query
not sent before; the whole list of rates is offered ``--repeats`` times
(rates ascending each time). Prints one JSON line a window (p50/p95/p99
ms, the answered share, the median latency of the last tenth of the
requests over the first tenth's: above 2 the backlog grows, the full
garbage collections) and the knees, a rate passing only when every one
of its windows passes. Run it once to fix a cell's rate; the
benchmark's runs never search for one.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--budget-ms", type=float, default=100.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import numpy as np
    from benchmark import harness
    from benchmark.traffic import serving, text
    layout = harness.Layout()
    cell = layout.cell(args.workload)
    driver = layout.driver(cell["driver"])
    rates = [float(r) for r in args.rates.split(",")]
    workdir = tempfile.mkdtemp(prefix="sweep-",
                               dir=os.environ.get("TMPDIR"))
    sustained = {r: True for r in rates}
    within = {r: True for r in rates}
    try:
        ctx = harness.Context(args.workload, cell,
                              layout.config(cell["config"]), args.seed,
                              args.seconds, False, args.device, workdir)
        st = serving.setup(ctx, driver.widest(ctx))
        stream = st.queries
        for rep in range(args.repeats):
            for rate in rates:
                st.due = text.arrivals({**cell["traffic"], "rate": rate},
                                       args.seconds)
                st.queries = stream.take(len(st.due))
                st.unanswered = 0
                t0 = time.perf_counter()
                win = driver.measure(ctx, st)
                lat = st.latencies
                answered = 1.0 - win.failed / max(win.attempted, 1)
                tenth = max(1, len(st.due) // 10)
                growth = float(np.median(lat[-tenth:])
                               / np.median(lat[:tenth]))
                ok = answered >= 0.99 and growth <= 2.0
                sustained[rate] &= ok
                within[rate] &= ok and win.e2e["p99_ms"] <= args.budget_ms
                print(json.dumps({
                    "rate": rate, "repeat": rep, "p99_ms": win.e2e["p99_ms"],
                    "p95_ms": win.e2e["p95_ms"],
                    "p50_ms": float(np.median(lat)) * 1e3,
                    "answered": answered, "backlog_growth": growth,
                    "gc_full": st.gc["full"], "gc_full_s": st.gc["full_s"],
                    "seconds": time.perf_counter() - t0}), flush=True)
        knee = max((r for r in rates if sustained[r]), default=None)
        budget = max((r for r in rates if within[r]), default=None)
        print(json.dumps({"knee": knee, "cell_rate": None if knee is None
                          else round(0.8 * knee),
                          "knee_within_budget": budget}), flush=True)
        driver.release(ctx, st)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
