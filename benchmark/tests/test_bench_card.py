"""On the card, at each cell's own size: the lower-precision control fails
the cell's limits, and a short run of the cell is correct. Skipped on a
machine without a CUDA card."""

import time

import pytest

from benchmark import harness, manifest

M = manifest.load()
CELLS = [w["name"] for w in M["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell, card):
    for seed in (11, 2 ** 33 + 12, 3 * 10 ** 9 + 13):
        res, lines = harness.run_cell(cell, seed, 1.0, False, card,
                                      time.perf_counter(), fault="control")
        assert not res["correct"], lines


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(cell, card):
    res, lines = harness.run_cell(cell, 2 ** 34 + 5, 2.0, False, card,
                                  time.perf_counter())
    assert res["correct"], lines


@pytest.mark.card
def test_run_fails_without_the_program(card, tmp_path):
    """A checkout of the benchmark alone prints no result and fails."""
    import os
    import shutil
    import subprocess
    import sys

    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(manifest.ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "simple-frame",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout == ""
