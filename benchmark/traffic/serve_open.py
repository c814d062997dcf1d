"""Driver kind ``serve_open``: an open loop of independent users.

Requests arrive on a schedule fixed by the cell (``traffic.rate``
requests/s, Poisson gaps), each one query, sent by one generator thread
whether or not earlier ones have been answered. A request's latency
runs from when it was due, not when it was sent, so a late generator or
a stalled server shows in the tail; a refused request (``Overloaded``)
or one never answered counts as failed and as having waited until the
run stopped waiting. Reports, over every request of the window,
``in_budget_pct``, the share answered within the cell's
``traffic.budget_ms``, and ``p99_ms`` and ``p95_ms`` (``BENCHMARK.json``
says which a cell is judged on; the traced run reads ``p99_ms`` as a
per-layer metric); the other percentiles, the generator's lateness and
the window's garbage collections go to standard error.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import Context, Window
from benchmark.traffic import serving, text

# The control: the plain reference in bfloat16 in the program's place.
CONTROL = "reference"
reference_control = serving.reference_control

GRACE_S = 60.0


def widest(ctx: Context) -> int:
    """An open loop can fill any batch the server forms."""
    return int(ctx.config["serve"]["max_batch"])


def setup(ctx: Context):
    due = text.arrivals(ctx.cell["traffic"], ctx.seconds)
    st = serving.setup(ctx, widest(ctx))
    st.due = due
    st.queries.take(len(due))
    return st


def offer(ctx: Context, st, due: np.ndarray, first: int, prof=None):
    """Send query ``first + i`` at ``due[i]`` seconds from now, then wait
    for the answers. Returns the answers, when each was sent, the
    requests refused and those never answered, and the stretch's
    start and end on the host's clock."""
    from tfidf_tpu_torch.serve.batcher import Overloaded
    n, queries = len(due), st.queries
    sent = np.full(n, np.nan)
    submitted = np.zeros(n, bool)
    ans = serving.Answers(n, st.k)
    server, k, scorer = st.server, st.k, st.scorer
    t0 = time.perf_counter() + 0.01
    refused = 0
    for i in range(n):
        if prof is not None:
            prof.tick(time.perf_counter() - t0)
        target = t0 + due[i]
        wait = target - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        sent[i] = time.perf_counter()
        try:
            fut = server.submit([queries[first + i]], k, scorer=scorer)
        except Overloaded:
            refused += 1
            continue
        submitted[i] = True
        fut.add_done_callback(ans.callback(i))
        del fut
    if prof is not None:
        prof.stop()
    missing = ans.wait(submitted, t0 + due[-1] + GRACE_S)
    return ans, sent, refused, missing, t0, time.perf_counter()


def measure(ctx: Context, st) -> Window:
    due, n = st.due, len(st.due)
    prof = serving.Profiled(ctx, st.server, ctx.seconds) \
        if ctx.trace else None
    watch = serving.GcWatch()
    before = serving.counters(st.server)
    ans, sent, refused, st.unanswered, t0, end = offer(ctx, st, due, 0,
                                                       prof)
    st.gc = watch.close(ctx)
    ctx.observed.facts["gc_full_ms"] = 1e3 * st.gc["full_s"]
    after = serving.counters(st.server)
    st.answers = ans
    lat = np.where(ans.ok, ans.done, end) - (t0 + due)
    answered = int(ans.ok.sum())
    st.latencies = lat
    late = sent - (t0 + due)
    budget_ms = float(ctx.cell["traffic"]["budget_ms"])
    in_budget = 100.0 * float(np.mean(lat * 1e3 <= budget_ms))
    ctx.log(f"open loop: {n} requests due at {n / ctx.seconds:.1f}/s, "
            f"answered {answered}, refused {refused}; generator lateness "
            f"p50 {np.nanpercentile(late, 50) * 1e3:.3f} ms p99 "
            f"{np.nanpercentile(late, 99) * 1e3:.3f} ms max "
            f"{np.nanmax(late) * 1e3:.3f} ms; latency p50/p90/p95/p99 "
            + "/".join(f"{np.percentile(lat, q) * 1e3:.3f}"
                       for q in (50, 90, 95, 99)) + f" ms; answered within "
            f"{budget_ms:g} ms {in_budget:.4f}%")
    ctx.observed.counters = {k: after[k] - before[k] for k in after}
    p99_ms = float(np.percentile(lat, 99)) * 1e3
    ctx.observed.facts["p99_ms"] = p99_ms
    if prof is not None:
        def again(seconds, retry):
            more = text.arrivals(ctx.cell["traffic"], seconds)
            st.queries.take(len(more))
            offer(ctx, st, more, n, retry)
        serving.read_profile(ctx, st, prof, again)
    return Window({"p99_ms": p99_ms,
                   "p95_ms": float(np.percentile(lat, 95)) * 1e3,
                   "in_budget_pct": in_budget},
                  attempted=n, failed=n - answered)


def release(ctx: Context, st) -> None:
    serving.release(ctx, st)


def check(ctx: Context, st) -> dict:
    return serving.check(ctx, st)
