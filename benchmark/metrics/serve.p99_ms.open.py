"""serve.p99_ms.open: the 99th percentile of the client-side latency
of every request of the window (open-loop serving cells), from each
request's due time, on the host's clock. The whole latency distribution
scales with the host's speed from run to run, so the tail is read here,
beside the cell's end-to-end share answered within its budget."""

LAYER = "serve batcher"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "in_budget_pct"


def read(ctx):
    return ctx.observed.facts.get("p99_ms")
