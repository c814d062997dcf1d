"""serve.queries_per_batch.closed: queries answered over device batches
dispatched in the window (closed loop), from the program's ServeMetrics counters:
how wide the MicroBatcher coalesces."""

LAYER = "serve batcher"
UNIT = "queries"
SOURCE = "program_counter"
MOVES = "queries_per_s"


def read(ctx):
    c = ctx.observed.counters
    if not c.get("batches"):
        return None
    return c["queries"] / c["batches"]
