"""Readings that the limits of ``correct`` are set from, at a cell's size.

    python3 benchmark/calibrate.py --workload NAME --seeds 1,2,3 \
        --what control|stale|half|altered [--seconds S]

Runs the cell through the harness, one run a seed in this process, with
that kind of ``faults.py`` planted in the program's place (``control``:
the reference in bfloat16) and a window of ``--seconds``, and prints one
JSON object a run: the seed, the numbers compared, and ``correct`` as the
harness decides it. The benchmark's runs never call this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import faults, harness  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", required=True, choices=faults.KINDS)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        res, _ = harness.run_cell(args.workload, seed, args.seconds, False,
                                  args.device, t, fault=args.what)
        nums = {k: v["value"] for k, v in res["checks"].items()}
        print(json.dumps({"workload": args.workload, "what": args.what,
                          "seed": seed, **nums, "correct": res["correct"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
