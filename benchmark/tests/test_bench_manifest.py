"""BENCHMARK.json against the contract, lookup by name, and a cell, a
configuration and a metric added by files and entries alone."""

import json
import math
import os
import shutil
import time

import pytest
import torch

from benchmark import harness, manifest

torch.set_num_threads(2)

M = manifest.load()
CELLS = [w["name"] for w in M["workloads"]]
METRICS = [x["name"] for x in M["end_to_end"] + M["per_layer"]]


def test_manifest_meets_the_contract():
    assert manifest.problems(M) == []
    assert M["command"] == ["python3", "benchmark/run.py"]
    assert M["paths"] == ["benchmark"]


@pytest.mark.parametrize("bad", [
    {"name": "has space"}, {"name": "slash/name"}, {"unit": "tokens per s"},
    {"unit": "µs"}, {"better": "up"}, {"bound": 0.3}, {"source": "guess"},
    {"extra": 1}])
def test_problems_catches_a_broken_metric(bad):
    m = json.loads(json.dumps(M))
    m["end_to_end"][0].update(bad)
    assert manifest.problems(m)


@pytest.mark.parametrize("cell", CELLS)
def test_lookup_by_name(cell):
    files = manifest.cell(M, cell)
    assert files["entry"]["name"] == cell
    assert files["config"]["width"] > 0
    assert files["traffic"]["driver"] in ("frames", "fit", "previews")
    assert files["cell"]["limits"]
    reported = manifest.metrics_for(M, cell, False)
    assert {"setup_s"} < {x["name"] for x in reported}
    assert manifest.metrics_for(M, cell, True)


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        manifest.cell(M, "no-such-cell")
    with pytest.raises(KeyError):
        manifest.by_name(M["configs"], "no-such-config", "configuration")


@pytest.mark.parametrize("name", METRICS)
def test_reader_reports_nothing_from_an_empty_record(name):
    rec = harness.Record()
    value = harness._reader(name, manifest.ROOT)(rec)
    assert value is None or (name == "setup_s" and math.isnan(value))


def test_a_config_cell_and_metric_are_added_by_files_alone(tmp_path):
    """A later change adds files and BENCHMARK.json entries, edits no file
    that is there, and the new cell runs with its new metric."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(manifest.ROOT, "benchmark"),
                    root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    b = root / "benchmark"
    conf = json.loads((b / "configs" / "simple-cuda.json").read_text())
    conf.update(name="simple-cuda-deep", max_depth=64)
    (b / "configs" / "simple-cuda-deep.json").write_text(json.dumps(conf))
    (b / "traffic" / "frames-8spp.json").write_text(json.dumps(
        {"driver": "frames", "spp": 8, "why": "short frames"}))
    (b / "workloads" / "deep-frame.json").write_text(json.dumps(
        {"check": {"frames": 1, "pixels": 32}, "trace": {"frames": 1},
         "limits": {"frame_mean_abs_err": 1e-4}}))
    (b / "metrics" / "frames_done.frame.py").write_text(
        "def read(rec):\n    return float(rec.units) if rec.units else None\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "simple-cuda-deep", "source": "a test",
                         "file": "benchmark/configs/simple-cuda-deep.json",
                         "reduced": ["max_depth"], "why": "deeper paths"})
    m["workloads"].append({"name": "deep-frame", "config": "simple-cuda-deep",
                           "traffic": "frames-8spp", "chips": 1,
                           "why": "a test cell"})
    for x in m["end_to_end"]:
        if x["name"] == "camera_rays_per_s":
            x["workloads"].append("deep-frame")
    m["per_layer"].append({"name": "frames_done.frame", "unit": "frames",
                           "better": "higher", "source": "host_clock",
                           "layer": "device", "moves": "camera_rays_per_s",
                           "workloads": ["deep-frame"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    assert manifest.problems(m, str(root)) == []
    changed = [p for p, data in before.items()
               if p.name != "BENCHMARK.json" and p.read_bytes() != data]
    assert changed == []
    small = {"config": {"width": 8, "height": 6, "max_depth": 5,
                        "pool_size": 128}}
    res, _ = harness.run_cell("deep-frame", 5, 0.0, True, "cpu",
                              time.perf_counter(), root=str(root),
                              overrides=small)
    assert res["correct"]
    assert res["metrics"]["frames_done.frame"]["value"] >= 1
