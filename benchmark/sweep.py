"""Find the highest rate a preview cell's server sustains, by a sweep.

    python3 benchmark/sweep.py --workload huge-preview-serve \
        --rates 4,5,6,7,8 --seconds 30 --seed 1

Runs the cell once per offered rate (each run starts its own server) and
prints one JSON line a rate: latency quantiles, the server's own render
seconds, and how the latency of the window's last third compares with its
first third (a ratio well above 1 means the backlog grows all through the
window). The benchmark's runs never call this; the chosen cell rate is
written into the traffic file as a number.
"""

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    for rate in (float(r) for r in args.rates.split(",")):
        ctx = harness.context(args.workload, args.seed, args.seconds, False,
                              args.device, time.perf_counter(),
                              overrides={"traffic": {"rate_per_s": rate}})
        rec = harness.record(ctx)
        lat = rec.latencies_s
        third = max(1, len(lat) // 3)
        print(json.dumps({
            "rate_per_s": rate, "requests": len(lat), "failed": rec.failed,
            "p50_s": statistics.median(lat),
            "p95_s": statistics.quantiles(lat, n=20)[18],
            "server_s_mean": statistics.fmean(
                r["seconds"] for r in rec.responses),
            "late_over_early": statistics.median(lat[-third:])
            / statistics.median(lat[:third]),
            "correct": harness.result(ctx, rec)[0]["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
