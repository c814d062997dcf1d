#!/usr/bin/env python3
"""Readings that set the limits of ``correct``: the program's numbers
over many seeds, and the control's.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \\
        [--mode program|control] [--seconds s] [--device cuda|cpu]

``--mode program`` runs the cell as ``run.py`` does, one seed after
another in this process, and prints each seed's compared numbers (the
lower readings). ``--mode control`` puts the control in the program's
place, at the cell's own size: for an ingest cell the program's own
bfloat16 score path; for a served cell, which has no such path, the
plain reference computed in bfloat16 (its document face and its answers
to the same sampled queries). Each line is one JSON object; the limits
in ``workloads/<cell>.json`` are set between the two sets of readings.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def served_control(ctx, layout) -> dict:
    """The bfloat16 reference in the program's place for a served cell:
    its face and its answers to the sampled queries, judged as the
    program's are."""
    import numpy as np

    from benchmark.reference import compare, tfidf
    from benchmark.traffic import serving, text
    cfg, traffic = ctx.config, ctx.cell["traffic"]
    words = text.make_words(cfg)
    corpus = text.make_corpus(cfg, ctx.seed, words)
    n = len(text.arrivals(traffic, ctx.seconds)) if "rate" in traffic \
        else int(traffic["clients"]) * 64
    queries = text.make_queries(traffic, cfg, words, ctx.seed, n)
    st = serving.ServeState({}, words, corpus, queries, traffic["scorer"],
                            int(cfg["k"]))
    ix = serving.reference_index(ctx, st)
    sc = serving.scorer_dict(st.scorer)
    ref_w = tfidf.face(ix, sc, "float64")
    low_w = tfidf.face(ix, sc, "bfloat16")
    numbers = compare.face_numbers(ix.doc, ix.term, low_w, ix.doc, ix.term,
                                   ref_w, ix.vocab_size, ix.num_docs)
    rows = serving.check_sample(ctx, queries, np.ones(len(queries), bool))
    texts = [queries[i] for i in rows]
    hs = int(cfg["hash_seed"])
    vals, ids, _, _ = tfidf.search(ix, tfidf.invert(ix, low_w), sc, texts,
                                   st.k, "bfloat16", hash_seed=hs)
    ref_v, _, ref_n, at = tfidf.search(ix, tfidf.invert(ix, ref_w), sc,
                                       texts, st.k, "float64", picks=ids,
                                       hash_seed=hs)
    numbers.update(compare.topk_numbers(vals, ids, ref_v, ref_n, at))
    numbers["unanswered"] = 0
    return {"checks": numbers, "checked": len(rows)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--mode", choices=("program", "control"),
                    default="program")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from benchmark import harness
    layout = harness.Layout()
    cell = layout.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        served = cell["driver"] != "ingest_passes"
        if args.mode == "control" and served:
            ctx = harness.Context(args.workload, cell,
                                  layout.config(cell["config"]), seed,
                                  args.seconds, False, args.device, "",
                                  "bfloat16")
            out = served_control(ctx, layout)
        else:
            prec = "bfloat16" if args.mode == "control" else "float64"
            res = harness.execute(args.workload, seed, args.seconds, False,
                                  args.device, t0, layout, precision=prec)
            out = {"checks": {k: v["value"]
                              for k, v in res["checks"].items()},
                   "correct": res["correct"], "metrics": res["metrics"]}
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
