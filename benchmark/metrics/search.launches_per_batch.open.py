"""search.launches_per_batch.open: CUDA kernels launched in the traced
sub-window over the batches dispatched in it (open loop): the device work a
batch costs the host to issue (score_topk_tiled's per-tile B6, sort and
merge)."""

LAYER = "search"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "in_budget_pct"


def read(ctx):
    prof = ctx.observed.profile
    batches = ctx.observed.facts.get("profile_batches")
    if prof is None or not batches or not prof.kernels:
        return None
    return prof.kernels / batches
