"""serve.gc_full_ms.open: milliseconds of the window (open-loop serving
cells) spent in full garbage collections of the serving process, which
stall every thread, the server's batcher and drain too (the
collector's callbacks, timed on the host's clock)."""

LAYER = "serving process"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "in_budget_pct"


def read(ctx):
    return ctx.observed.facts.get("gc_full_ms")
