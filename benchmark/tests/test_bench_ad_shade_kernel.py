"""The reader of ``ad_shade_kernel_ms.train`` on synthetic trace summaries:
the AD pool's two shade kernels by name, device ms a traced step, and
nothing where the program has no such kernel."""

import pytest

from benchmark import harness, manifest


def _read(trace, traced_units=2):
    rec = harness.Record(trace=trace, traced_units=traced_units)
    return harness._reader("ad_shade_kernel_ms.train", manifest.ROOT)(rec)


def test_reads_both_kernels_a_step():
    trace = {"kernel_s": {
        "ad_shade_kernel(AdShadeConfig, AsIn, AsOut, float const*)": 3e-3,
        "ad_shade_grad_kernel(AdShadeConfig, AsIn, AsGin, AsGout, "
        "float const*)": 1e-3,
        "void closest_hit_kernel<8>(int const*, float const*)": 5e-3,
        "void shade_regen_kernel<3>(ShadeRegenConfig, StatePtrs)": 7e-3}}
    assert _read(trace) == pytest.approx(2.0)
    assert _read(trace, traced_units=4) == pytest.approx(1.0)


def test_reads_nothing_without_the_kernels_or_a_trace():
    parent = {"kernel_s": {
        "void closest_hit_kernel<8>(int const*, float const*)": 5e-3,
        "void at::native::vectorized_elementwise_kernel<4>()": 1e-3}}
    assert _read(parent) is None
    assert _read(None) is None
    assert _read({"kernel_s": {"ad_shade_kernel(AdShadeConfig)": 1e-3}},
                 traced_units=0) is None


def test_manifest_lists_it_for_the_fit_cell_only():
    m = manifest.load()
    (spec,) = [x for x in m["per_layer"]
               if x["name"] == "ad_shade_kernel_ms.train"]
    assert spec["workloads"] == ["huge-fit"] and spec["moves"] == "step_s"
    assert spec["source"] == "device_trace"
    assert not manifest.problems(m)
