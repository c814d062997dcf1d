"""ingest.packer_busy_share: the share of the passes' wall the packer
thread spent packing chunks (``pack`` spans of the program's tracer over
every pass of the window, over the passes' wall): how close the host's
read and tokenize come to setting the pace."""

LAYER = "ingest packer"
UNIT = "%"
SOURCE = "program_span"
MOVES = "docs_per_s"


def read(ctx):
    wall = ctx.observed.facts.get("passes_wall_s")
    packs = [dur for name, _thread, _t0, dur in ctx.observed.spans
             if name == "pack" and dur >= 0]
    if not wall or not packs:
        return None
    return 100.0 * sum(packs) / 1e9 / wall
