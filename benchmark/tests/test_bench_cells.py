"""Each cell's code path at a tiny size on the CPU, the traffic
generator, the faults that ``correct`` must catch, the import check and
the trace reduction."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import faults, guard, harness, manifest, profiling
from benchmark.drivers import previews

torch.set_num_threads(2)

TINY = {
    "huge-frame": {"config": {"width": 12, "height": 8, "max_depth": 6,
                              "pool_size": 128},
                   "traffic": {"spp": 4}, "cell": {"check": {"pixels": 48}}},
    "simple-frame": {"config": {"width": 12, "height": 8, "max_depth": 6,
                                "pool_size": 128},
                     "traffic": {"spp": 4},
                     "cell": {"check": {"pixels": 48}}},
    "huge-fit": {"config": {"width": 16, "height": 12, "max_depth": 5},
                 "traffic": {"batch_pixels": 64, "target_spp": 2,
                             "fit_spp": 2, "engine": "wavefront"}},
    "huge-preview-serve": {"config": {"width": 12, "height": 8,
                                      "max_depth": 4, "pool_size": 128},
                           "traffic": {"rate_per_s": 4.0},
                           "cell": {"check": {"requests": 2, "pixels": 48},
                                    "trace": {"requests": 2}}},
}
SECONDS = {"huge-preview-serve": 1.0}
M = manifest.load()
CELLS = [w["name"] for w in M["workloads"]]


def _run(cell, trace=False, fault=None, seed=2 ** 33 + 5):
    return harness.run_cell(cell, seed, SECONDS.get(cell, 0.0), trace,
                            "cpu", time.perf_counter(),
                            overrides=TINY[cell], fault=fault)


def test_every_cell_has_a_tiny_size():
    assert set(TINY) == set(CELLS)


@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell, trace):
    res, lines = _run(cell, trace)
    assert res["correct"], lines
    want = {x["name"] for x in manifest.metrics_for(M, cell, trace)}
    got = set(res["metrics"])
    if trace:
        # shares of the device are not reported without a device timeline
        assert got <= want and got
        assert res["device"]["window_s"] > 0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert got == want
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert json.loads(json.dumps(res)) == res


@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_makes_the_run_incorrect(cell, kind):
    res, lines = _run(cell, fault=kind)
    assert not res["correct"], lines


def test_traffic_is_the_same_schedule_with_other_scenes():
    a = previews.plan(8.0, 30.0, [1, 4, 16], 1, 2 ** 40 + 3)
    b = previews.plan(8.0, 30.0, [1, 4, 16], 1, 2 ** 40 + 3)
    c = previews.plan(8.0, 30.0, [1, 4, 16], 1, 11)
    d = previews.plan(8.0, 30.0, [1, 4, 16], 2, 11)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert len(a[0]) == 240
    assert np.array_equal(a[0], c[0]) and np.array_equal(a[1], c[1])
    assert not np.array_equal(a[2], c[2])
    assert sorted(a[1]) == sorted(d[1]) and not np.array_equal(a[1], d[1])
    # the same exponential quantiles as gaps, in another order
    ga = np.sort(np.diff(np.append(a[0], 30.0)))
    gd = np.sort(np.diff(np.append(d[0], 30.0)))
    assert np.allclose(ga, gd)
    assert a[0][0] == 0 and a[0][-1] < 30.0
    assert len(set(a[2])) == len(a[2])


def test_guard_compares_whole_top_level_names():
    mods = {"raytracinginoneweekend_tpu_torch": 1,
            "raytracinginoneweekend_tpu_torch.ops": 1, "jaxtyping": 1,
            "jax.numpy": 1, "raytracinginoneweekend_tpu.ops": 1, "flax": 1}
    assert guard.forbidden_modules(mods) == [
        "flax", "jax.numpy", "raytracinginoneweekend_tpu.ops"]


def test_a_run_loads_nothing_of_jax():
    code = ("import sys; sys.path.insert(0, %r);"
            "import benchmark.harness, benchmark.drivers.frames,"
            "benchmark.drivers.fit, benchmark.drivers.previews,"
            "raytracinginoneweekend_tpu_torch.optim,"
            "raytracinginoneweekend_tpu_torch.serve;"
            "from benchmark import guard; print(guard.forbidden_modules())"
            % manifest.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "huge-frame",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


def test_trace_summary():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "cpu_op", "name": "launch", "ts": 0, "dur": 10},
          {"ph": "X", "cat": "cuda_runtime", "name": "sync", "ts": 40,
           "dur": 50},
          {"ph": "X", "cat": "kernel", "name": "void k<1>()", "ts": 10,
           "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "void k<1>()", "ts": 20,
           "dur": 20},
          {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 60,
           "dur": 20}]
    s = profiling.summarize(ev)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(50e-6)
    assert s["kernel_s"]["void k<1>()"] == pytest.approx(40e-6)
    assert s["gaps"] == pytest.approx({"launch": 10e-6, "sync": 40e-6})
    assert profiling.device_seconds(s, ("k<",)) == pytest.approx(40e-6)
