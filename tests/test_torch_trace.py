"""PyTorch port: the program's spans (``utils/timing``).

Off (no profiler, no ``collect()``) a span is a flag check that builds no
``record_function`` and reads no clock. Under ``torch.profiler`` spans
nest and are the trace's ``user_annotation`` events; each profiler session
starts an empty table, and a torch without the hook that tells sessions
apart is refused. ``collect()`` takes the spans of every thread. On tiny
CPU frames the spans count what the engines' own numbers say: one host
read an epoch and one at the end of the wavefront frame, one recompute of
the AD pool's epoch for each epoch. The server's ``spans`` and ``render
--profile``'s trace are tested in tests/test_torch_serve.py.
"""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytracinginoneweekend_tpu_torch import cli as pcli
from raytracinginoneweekend_tpu_torch import config as pconfig
from raytracinginoneweekend_tpu_torch import optim as poptim
from raytracinginoneweekend_tpu_torch.ops.threefry import key_words
from raytracinginoneweekend_tpu_torch.ops.wavefront import render_wavefront
from raytracinginoneweekend_tpu_torch.utils import timing

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _profiled(body):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        body()
    return timing.profiled(), prof


def _nested():
    with timing.span("rtw.test.outer"):
        with timing.span("rtw.test.inner"):
            pass


def _names(table, name):
    return sum(s.name == name for s in table.spans)


def test_off_builds_no_record_function_and_reads_no_clock(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("called while nothing records")

    before = len(timing.profiled().spans)
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", boom)
        m.setattr(time, "perf_counter_ns", boom)
        _nested()
        timing.record("rtw.test.past", 0, 1)
        assert timing.span("rtw.test.x") is timing.span("rtw.test.y")
    assert len(timing.profiled().spans) == before


def test_spans_nest_and_are_the_traces_annotations(tmp_path):
    table, prof = _profiled(_nested)
    by_name = {s.name: s for s in table.spans}
    outer, inner = by_name["rtw.test.outer"], by_name["rtw.test.inner"]
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert set(table.seconds()) == {"rtw.test.outer", "rtw.test.inner"}
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"rtw.test.outer", "rtw.test.inner"} <= names


def test_a_new_profiler_session_starts_an_empty_table():
    first, _ = _profiled(_nested)
    assert len(first.spans) == 2
    second, _ = _profiled(lambda: None)
    assert not second.spans and second is not first
    assert len(first.spans) == 2  # the earlier session's table is kept


def test_a_torch_without_the_session_hook_is_refused(monkeypatch):
    import torch.autograd.profiler as ap

    monkeypatch.setattr(timing, "_hooked", False)
    monkeypatch.delattr(ap, "_run_on_profiler_start")
    with timing.collect(), pytest.raises(RuntimeError, match="told apart"):
        with timing.span("rtw.test.x"):
            pass


def test_collect_records_every_threads_spans_without_a_profiler():
    with timing.collect() as outer:
        timing.record("rtw.test.past", 10, 30)
        with timing.collect() as inner:
            _nested()
        worker = threading.Thread(target=_nested)
        worker.start()
        worker.join()
    assert not torch._C._autograd._profiler_enabled()
    assert [s.name for s in outer.spans] == [
        "rtw.test.past", "rtw.test.inner", "rtw.test.outer",
        "rtw.test.inner", "rtw.test.outer"]
    assert outer.seconds()["rtw.test.past"] == pytest.approx(20e-9)
    assert [s.name for s in inner.spans] == [
        "rtw.test.inner", "rtw.test.outer"]
    with timing.span("rtw.test.after"):
        pass
    assert "rtw.test.after" not in outer.seconds()


def _frame(flush_every=4):
    scene = pcli._build_scene("simple-cuda", 0, CPU)
    cam = pcli._build_camera("cuda", 12, 8, CPU)
    options = dataclasses.replace(pconfig.DEFAULT, intersect="jnp")
    _fb, stats = render_wavefront(
        scene, cam, key_words(1), spp=4, width=12, height=8, max_depth=4,
        camera_mode="cuda", options=options, pool_size=128, device=CPU,
        flush_every=flush_every, return_stats=True)
    return stats


@pytest.mark.parametrize("how", ["profiler", "collect"])
def test_wavefront_host_reads_are_the_frames_epochs_plus_one(how):
    stats = []
    if how == "profiler":
        table, _ = _profiled(lambda: stats.append(_frame()))
    else:
        with timing.collect() as table:
            stats.append(_frame())
    epochs = stats[0]["iters"] // 4
    assert epochs >= 2
    assert _names(table, "rtw.wavefront.read") == epochs + 1
    seconds = table.seconds()
    assert seconds["rtw.wavefront.build"] > 0
    assert {"rtw.wavefront.read", "rtw.wavefront.fold"} <= set(seconds)
    assert "rtw.wavefront.capture" not in seconds  # no graph on the CPU


def test_ad_pool_recomputes_each_epoch_once_in_the_backward():
    g = np.random.default_rng(4)
    w, h = 16, 12
    ids = torch.from_numpy(g.permutation(w * h)[:64].astype(np.int32))
    scene = pcli._build_scene("simple-cuda", 0, CPU)
    params = poptim.params_from_scene(scene, ("albedo",))

    def step():
        loss = poptim.render_loss(
            params, scene, pcli._build_camera("cuda", w, h, CPU),
            torch.full((64, 3), 0.3), ids, key_words(4), width=w, height=h,
            spp=2, max_depth=4, camera_mode="cuda",
            options=pconfig.DEFAULT, engine="wavefront",
            engine_opts={"epoch_len": 1})
        loss.backward()

    table, _ = _profiled(step)
    epochs = _names(table, "rtw.ad.epoch")
    assert epochs >= 2
    assert _names(table, "rtw.ad.recompute") == epochs
    # one iteration an epoch, shaded by the forward and the recompute
    assert _names(table, "rtw.ad.shade") == 2 * epochs
    assert params["albedo"].grad is not None
