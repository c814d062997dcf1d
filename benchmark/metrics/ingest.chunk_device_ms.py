"""ingest.chunk_device_ms: device busy time of the traced pass over its
chunks (the device chunk step: upload, B4, the row sort, sparse_df, and
the finish's B1 and B3), from torch.profiler."""

LAYER = "device chunk step"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "docs_per_s"


def read(ctx):
    prof = ctx.observed.profile
    chunks = ctx.observed.facts.get("chunks")
    if prof is None or not chunks or prof.busy_s <= 0:
        return None
    return 1e3 * prof.busy_s / chunks
