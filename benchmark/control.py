#!/usr/bin/env python3
"""Readings that set the limits of ``correct``: the program's numbers
over many seeds, and the control's.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \\
        [--mode program|control] [--seconds s] [--device cuda|cpu]

``--mode program`` runs the cell as ``run.py`` does, one seed after
another in this process, and prints each seed's compared numbers (the
lower readings). ``--mode control`` puts the control in the program's
place, at the cell's own size, as the cell's driver kind declares it
(``CONTROL`` in ``traffic/<kind>.py``): ``"program"``, the program's own
bfloat16 path (an ingest cell's score path); ``"reference"``, for a kind
whose program has no such path, the plain reference computed in
bfloat16 (the kind's ``reference_control``: for a served cell its
document face and its answers to the same sampled queries). Each line
is one JSON object; the limits in ``workloads/<cell>.json`` are set
between the two sets of readings.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


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
    driver = layout.driver(cell["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.mode == "control" and driver.CONTROL == "reference":
            ctx = harness.Context(args.workload, cell,
                                  layout.config(cell["config"]), seed,
                                  args.seconds, False, args.device, "",
                                  "bfloat16")
            out = driver.reference_control(ctx)
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
