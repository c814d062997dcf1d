"""Driver kind ``serve_closed``: a closed loop of waiting callers.

``traffic.clients`` callers each keep one request of one query in
flight: when an answer comes, that caller sends its next query at once.
One thread does the sending for all of them, fed by the completion
callbacks. Queries come from the seed's query stream, drawn in blocks
as the loop takes them, so no rate has to be guessed in advance.
Reports ``queries_per_s``: queries answered within the window over its
seconds; requests still in flight when it closes are waited for and
checked, not counted.
"""

from __future__ import annotations

import queue
import time

import numpy as np

from benchmark.harness import Context, Window
from benchmark.traffic import serving

# The control: the plain reference in bfloat16 in the program's place.
CONTROL = "reference"
reference_control = serving.reference_control

GRACE_S = 60.0
# Answer rows allocated at a time as the loop sends.
ROWS = 1 << 16


def widest(ctx: Context) -> int:
    """No batch is wider than the callers in flight."""
    return min(int(ctx.cell["traffic"]["clients"]),
               int(ctx.config["serve"]["max_batch"]))


def setup(ctx: Context):
    st = serving.setup(ctx, widest(ctx))
    st.queries.take(int(ctx.cell["traffic"]["clients"]))
    return st


def offer(ctx: Context, st, seconds: float, first: int, prof=None):
    """Keep ``traffic.clients`` requests in flight for ``seconds``,
    sending queries ``first``, ``first + 1``, ... of the stream, then
    wait for the answers. Returns them, the requests never answered and
    the stretch's end on the host's clock."""
    clients = int(ctx.cell["traffic"]["clients"])
    server, k, scorer, stream = st.server, st.k, st.scorer, st.queries
    ready: "queue.SimpleQueue" = queue.SimpleQueue()
    books = [serving.Answers(ROWS, k, 0, ready.put)]
    sent = 0

    def send():
        nonlocal sent
        i = sent
        rows = books[-1]
        if i >= ROWS * len(books):
            rows = serving.Answers(ROWS, k, i, ready.put)
            books.append(rows)
        fut = server.submit([stream[first + i]], k, scorer=scorer)
        fut.add_done_callback(rows.callback(i - rows.base))
        sent += 1

    t0 = time.perf_counter()
    t_end = t0 + seconds
    for _ in range(clients):
        send()
    while True:
        ready.get(timeout=GRACE_S)
        now = time.perf_counter()
        if now >= t_end:
            break
        if prof is not None:
            prof.tick(now - t0)
        send()
    if prof is not None:
        prof.stop()
    rows = np.arange(ROWS)
    missing = sum(b.wait(rows < sent - j * ROWS, t_end + GRACE_S)
                  for j, b in enumerate(books))
    return serving.Answers.join(books, sent), missing, t_end


def measure(ctx: Context, st) -> Window:
    clients = int(ctx.cell["traffic"]["clients"])
    prof = serving.Profiled(ctx, st.server, ctx.seconds) \
        if ctx.trace else None
    watch = serving.GcWatch()
    before = serving.counters(st.server)
    ans, st.unanswered, t_end = offer(ctx, st, ctx.seconds, 0, prof)
    after = serving.counters(st.server)
    st.answers = ans
    st.gc = watch.close(ctx)
    ctx.observed.facts["gc_full_ms"] = 1e3 * st.gc["full_s"]
    sent = len(ans.ok)
    failed = int(sent - ans.ok.sum())
    in_window = int((ans.ok & (ans.done <= t_end)).sum())
    ctx.log(f"closed loop: {clients} clients, {sent} requests sent, "
            f"{in_window} answered in the window, {failed} failed")
    ctx.observed.counters = {k: after[k] - before[k] for k in after}
    if prof is not None:
        serving.read_profile(
            ctx, st, prof,
            lambda seconds, retry: offer(ctx, st, seconds, sent, retry))
    return Window({"queries_per_s": in_window / ctx.seconds},
                  attempted=sent, failed=failed)


def release(ctx: Context, st) -> None:
    serving.release(ctx, st)


def check(ctx: Context, st) -> dict:
    return serving.check(ctx, st)
