"""The per-layer metrics that read the program's own spans
(``utils/timing.profiled``): reported by a traced run, positive, read from
that run's profiler session alone (two traced runs in one process read
the same count of reads), and absent from a timed run."""

import pytest

from benchmark.tests import test_bench_cells as cells

READ = {"huge-frame": ("engine_setup_ms.frame", "host_reads.frame"),
        "huge-fit": ("ad_epochs_ms.train", "ad_recompute_ms.train",
                     "ad_shade_ms.train")}


@pytest.mark.parametrize("cell", sorted(READ))
def test_span_metrics_read_each_traced_run_alone(cell):
    runs = [cells._run(cell, trace=True) for _ in range(2)]
    for res, lines in runs:
        assert res["correct"], lines
        for name in READ[cell]:
            assert res["metrics"][name]["value"] > 0, name
    if cell == "huge-frame":
        a, b = (r["metrics"]["host_reads.frame"]["value"] for r, _ in runs)
        assert a == b
    res, lines = cells._run(cell, trace=False)
    assert res["correct"], lines
    assert not set(READ[cell]) & set(res["metrics"])
