"""Start the program's render server for the benchmark, and report on it.

    python3 benchmark/serve_launcher.py --socket PATH --device cuda \
        --report FILE

Runs ``raytracinginoneweekend_tpu_torch.serve.serve`` in this process
until a shutdown request, then writes FILE (JSON): the device's name, the
process's peak of allocated device memory, the loaded modules of JAX or of
the JAX package (there should be none), and, when asked, the device trace
of a stretch of requests. A ``ping`` request carrying ``"bench_trace": N``
asks for that: the next N render requests are profiled (``torch.profiler``,
from the start of the first to the end of the last). Every request goes to
the program's own handler unchanged; the server ignores keys it does not
know. Each response gains ``bench_handle_s``: the seconds the handler
took, on this process's clock (the render, the colour quantisation and the
PNG encode; not the queue or the socket).
"""

import argparse
import json
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--socket", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--report", required=True)
    p.add_argument("--fault", default=None,
                   help="plant a kind of benchmark/faults.py (tests and "
                        "calibrate.py only)")
    p.add_argument("--cell", default=None,
                   help="with --fault: a JSON file of the run's config, "
                        "traffic, cell and seed")
    args = p.parse_args(argv)

    import torch

    from benchmark import faults, guard
    from benchmark.profiling import DeviceTrace
    from raytracinginoneweekend_tpu_torch import serve

    device = torch.device(args.device)
    state = {"left": 0, "trace": None, "summary": None}
    handle = serve.handle_request

    def traced_handle(req, dev):
        if isinstance(req, dict) and req.get("cmd") == "ping" and (
                "bench_trace" in req):
            state["left"] = int(req["bench_trace"])
        render = isinstance(req, dict) and req.get("cmd") == "render"
        if render and state["left"] and state["trace"] is None:
            state["trace"] = DeviceTrace(True, device).__enter__()
        t0 = time.perf_counter()
        resp = handle(req, dev)
        if render:
            resp["bench_handle_s"] = time.perf_counter() - t0
        if render and state["trace"] is not None:
            state["left"] -= 1
            if state["left"] == 0:
                state["trace"].__exit__(None, None, None)
                state["summary"] = state["trace"].summary
        return resp

    serve.handle_request = traced_handle
    ctx = None
    if args.fault:
        with open(args.cell) as f:
            ctx = types.SimpleNamespace(**json.load(f), device=device)
    with faults.planted(ctx, args.fault):
        rc = serve.serve(args.socket, device)
    report = {
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else device.type),
        "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(device))
                              if device.type == "cuda" else 0),
        "forbidden_modules": guard.forbidden_modules(),
        "trace": state["summary"],
    }
    with open(args.report, "w") as f:
        json.dump(report, f)
    return rc


if __name__ == "__main__":
    sys.exit(main())
