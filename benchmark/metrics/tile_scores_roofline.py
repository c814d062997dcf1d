"""tile_scores_roofline: B6 (``csrc/tile_scores.cu``, the search's
sparse x dense scoring) against its roofline in the traced sub-window:
per search, the least time of the bytes and operations the index's
head slots and the queries' terms need (frozen ``benchmark/costmodel.py``;
a query's terms and postings are the mean of a seeded sample of the
window's queries), times the searches the sub-window dispatched at the
window's mean queries a batch, over B6's device time."""

from benchmark import costmodel

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "queries_per_s"
KERNEL = "tile_scores"


def read(ctx):
    prof, facts, c = (ctx.observed.profile, ctx.observed.facts,
                      ctx.observed.counters)
    if prof is None or "head_slots" not in facts or not c.get("batches"):
        return None
    seconds = prof.seconds_of(KERNEL)
    batches = facts.get("profile_batches", 0)
    if seconds <= 0 or not batches:
        return None
    cost = costmodel.tile_scores_cost(
        int(facts["head_slots"]), c["queries"] / c["batches"],
        facts["terms_per_query"], facts["postings_per_query"],
        int(ctx.config["k"]))
    least = costmodel.least_seconds(cost["bytes"], cost["flops"])
    return 100.0 * batches * least / seconds
