"""score_topk_roofline: B1 (``csrc/score_topk.cu``, the per-document
score and top-k of the ingest's finish) against its roofline in the
traced pass: the least time the bytes its inputs need take at the
card's peak bandwidth (frozen ``benchmark/costmodel.py``; one pass
scores every document once), over B1's device time."""

from benchmark import costmodel

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "docs_per_s"
KERNEL = "fused_score_topk"


def read(ctx):
    prof, facts = ctx.observed.profile, ctx.observed.facts
    if prof is None or "head_slots" not in facts:
        return None
    seconds = prof.seconds_of(KERNEL)
    if seconds <= 0:
        return None
    nbytes = costmodel.score_topk_bytes(
        int(facts["docs"]), int(facts["head_slots"]),
        int(ctx.config["vocab_size"]), int(ctx.config["topk"]))
    return 100.0 * costmodel.least_seconds(nbytes) / seconds
