"""ingest.pack_wait_share: the share of the passes' wall the main thread
spent waiting on the packer (``pack_wait`` spans of the program's
tracer on the ``main`` lane, over every pass of the window)."""

LAYER = "ingest packer"
UNIT = "%"
SOURCE = "program_span"
MOVES = "docs_per_s"


def read(ctx):
    wall = ctx.observed.facts.get("passes_wall_s")
    waits = [dur for name, thread, _t0, dur in ctx.observed.spans
             if name == "pack_wait" and thread == "main" and dur >= 0]
    if not wall or not waits:
        return None
    return 100.0 * sum(waits) / 1e9 / wall
