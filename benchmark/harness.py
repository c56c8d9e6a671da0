"""One run of one cell: set up, measure a window, check, report.

``main`` is the command line (``benchmark/run.py``): it finds the cell by
name (``manifest.cell``), refuses to run without the CUDA cards the cell
asks for, runs the cell's driver on the card, and prints one JSON line.
``run_cell`` is the same run on any device, with optional overrides of the
cell's files, so that the benchmark's tests can drive a cell at a tiny
size on the CPU.

A driver (``benchmark/drivers/<traffic driver>.py``) returns a ``Record``:
what the window did (its seconds, completed units and work, latencies,
spans, counters, the device trace of a ``--trace 1`` run) and the numbers
that decide ``correct``, each beside its limit. The metric readers
(``benchmark/metrics/<name>.py``, each a ``read(record)`` that returns a
number or None) turn the record into the result's metrics.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import statistics
import sys

from . import faults, guard, manifest
from .profiling import breakdown


@dataclasses.dataclass
class Record:
    setup_s: float = math.nan
    window_s: float = math.nan
    units: int = 0                 # frames, steps or requests completed
    attempted: int = 0
    failed: int = 0
    work: dict = dataclasses.field(default_factory=dict)
    latencies_s: list = dataclasses.field(default_factory=list)
    spans: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    responses: list = dataclasses.field(default_factory=list)
    trace: dict | None = None      # profiling.summarize of the traced part
    traced_units: int = 0
    checks: dict = dataclasses.field(default_factory=dict)  # name: (v, lim)
    memory_peak_bytes: int = 0
    device: dict = dataclasses.field(default_factory=dict)
    notes: list = dataclasses.field(default_factory=list)   # for stderr

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)


@dataclasses.dataclass
class Context:
    name: str
    config: dict
    traffic: dict
    cell: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float                     # process start on time.perf_counter
    fault: str | None = None      # faults.py: tests and calibrate only


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def _reader(name: str, root: str):
    path = manifest.metric_file(name, root)
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _driver(name: str):
    spec = importlib.util.find_spec(f"benchmark.drivers.{name}")
    if spec is None:
        raise KeyError(f"no traffic driver named {name!r}")
    return importlib.import_module(f"benchmark.drivers.{name}")


def check_ok(value, limit) -> bool:
    return value is not None and math.isfinite(value) and value <= limit


def context(name: str, seed: int, seconds: float, trace: bool, device,
            t0: float, *, root: str = manifest.ROOT,
            overrides: dict | None = None,
            fault: str | None = None) -> Context:
    """A cell's run, set out from its files.

    overrides: {"config": {...}, "traffic": {...}, "cell": {...}} merged
    into the cell's files (tests run a cell at a tiny size this way);
    fault: a kind of ``faults.py`` planted in the timed path."""
    import torch

    files = manifest.cell(manifest.load(root), name, root)
    over = overrides or {}
    return Context(name=name,
                   config=_merge(files["config"], over.get("config")),
                   traffic=_merge(files["traffic"], over.get("traffic")),
                   cell=_merge(files["cell"], over.get("cell")),
                   seed=int(seed), seconds=float(seconds), trace=bool(trace),
                   device=torch.device(device), t0=t0, fault=fault)


def record(ctx: Context) -> Record:
    """Run the cell's driver (with the context's fault planted)."""
    with faults.planted(ctx, ctx.fault):
        return _driver(ctx.traffic["driver"]).run(ctx)


def result(ctx: Context, rec: Record,
           root: str = manifest.ROOT) -> tuple[dict, list]:
    """A record -> (the result's dict, lines for standard error)."""
    metrics = {}
    for spec in manifest.metrics_for(manifest.load(root), ctx.name,
                                     ctx.trace):
        value = _reader(spec["name"], root)(rec)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    correct = rec.failed == 0 and rec.units > 0 and all(
        check_ok(v, lim) for v, lim in rec.checks.values())
    res = {"correct": correct, "attempted": rec.attempted,
           "failed": rec.failed, "metrics": metrics,
           "device": dict(rec.device,
                          memory_peak_bytes=int(rec.memory_peak_bytes))}
    if ctx.trace and rec.trace is not None:
        res["device"]["busy_s"] = rec.trace["busy_s"]
        res["device"]["window_s"] = rec.trace["window_s"]
        res["breakdown"] = breakdown(rec.trace)
    res["checks"] = {  # a non-finite number is written as null
        k: {"value": v if v is not None and math.isfinite(v) else None,
            "limit": lim} for k, (v, lim) in rec.checks.items()}
    lines = list(rec.notes) + [
        f"{name}: {len(s)} in the window, seconds min {min(s):.4f} median "
        f"{statistics.median(s):.4f} max {max(s):.4f}"
        for name, s in rec.spans.items() if s] + [
        f"check {k}: {v!r} (limit {lim!r}) "
        f"{'ok' if check_ok(v, lim) else 'FAILED'}"
        for k, (v, lim) in rec.checks.items()]
    return res, lines


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t0: float, *, root: str = manifest.ROOT,
             overrides: dict | None = None,
             fault: str | None = None) -> tuple[dict, list]:
    """Run one cell -> (the result's dict, lines for standard error);
    arguments as ``context``."""
    ctx = context(name, seed, seconds, trace, device, t0, root=root,
                  overrides=overrides, fault=fault)
    return result(ctx, record(ctx), root)


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    entry = manifest.by_name(manifest.load()["workloads"], args.workload,
                             "workload")
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < entry["chips"]):
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda", t0)
    found = guard.forbidden_modules()
    if found:
        print("modules of JAX or of the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0
