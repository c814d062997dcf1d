"""search.launches_per_batch.closed: CUDA kernels launched in the traced
sub-window over the batches dispatched in it (closed loop): the device work a
batch costs the host to issue (score_topk_tiled's per-tile B6, sort and
merge)."""

LAYER = "search"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "queries_per_s"


def read(ctx):
    prof = ctx.observed.profile
    batches = ctx.observed.facts.get("profile_batches")
    if prof is None or not batches or not prof.kernels:
        return None
    return prof.kernels / batches
