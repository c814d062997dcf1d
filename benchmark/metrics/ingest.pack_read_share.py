"""ingest.pack_read_share: the share of the packer's time spent in the
native loader's parallel file read (``pack_read`` spans over ``pack``
spans of the program's tracer, over every pass of the window); the rest
is the tokenize, hash and wire fill."""

LAYER = "ingest packer"
UNIT = "%"
SOURCE = "program_span"
MOVES = "docs_per_s"


def read(ctx):
    reads = sum(dur for name, _thread, _t0, dur in ctx.observed.spans
                if name == "pack_read" and dur >= 0)
    packs = sum(dur for name, _thread, _t0, dur in ctx.observed.spans
                if name == "pack" and dur >= 0)
    if not reads or not packs:
        return None
    return 100.0 * reads / packs
