"""The two readings each compared number's limit is set from: the program's
over a dozen seeds or more (the lower reading: the largest), and the
control's, the reference in bfloat16 in the program's place (check.judge,
`control=True`), over three seeds or more (the upper reading: the
smallest), all in one process at the cell's own size and load.

    python3 -m rmcl_bench.tools.calibrate --workload <cell> [--seconds 1]
        [--seeds ...] [--control-seeds ...]

Each reading is a whole run of the cell (run.run) with a short window:
the same set-up, entry, kept frames and sample as a benchmark run. Prints
a JSON line a run and a summary line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

DEFAULT_SEEDS = [2**31 + 11 * k for k in range(1, 13)]
DEFAULT_CONTROL = [2**31 + 7919 * k for k in range(1, 4)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=DEFAULT_SEEDS)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=DEFAULT_CONTROL)
    args = ap.parse_args(argv)
    from .. import run

    readings = {"program": {}, "control": {}}
    for side, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            res = run.run(args.workload, seed, args.seconds, False,
                          control=side == "control", t_start=time.perf_counter(),
                          log=lambda *a: None)
            nums = {k: v["value"] for k, v in res["checks"].items()}
            readings[side][seed] = nums
            print(json.dumps({"side": side, "seed": seed, "correct": res["correct"],
                              "attempted": res["attempted"], **nums}), flush=True)
    names = next(iter(readings["program"].values())).keys()
    summary = {k: {"lower": max(r[k] for r in readings["program"].values()),
                   "upper": min(r[k] for r in readings["control"].values())} for k in names}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
