"""serve.queries_per_batch.open: queries answered over device batches
dispatched in the window (open loop), from the program's ServeMetrics counters:
how wide the MicroBatcher coalesces."""

LAYER = "serve batcher"
UNIT = "queries"
SOURCE = "program_counter"
MOVES = "in_budget_pct"


def read(ctx):
    c = ctx.observed.counters
    if not c.get("batches"):
        return None
    return c["queries"] / c["batches"]
