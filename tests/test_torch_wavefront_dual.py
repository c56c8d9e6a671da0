"""PyTorch port vs the JAX package: the dual-pool wavefront engine.

``render_wavefront_dual(device="cpu")`` of the port (plain PyTorch versions
of the two kernels) against the JAX ``render_wavefront_dual`` (Pallas
kernels in interpret mode) and against the port's own single pool, same
scene, camera, key and options.

Tolerances, and why:
  * frames: the renderer's frame rule (golden.compare_frames: at most 1%
    knife-edge pixels, the rest atol 5e-4 / rtol 1e-4 on the huge scene,
    as tests/test_torch_wavefront.py states) against the JAX package; the
    same rule with atol 5e-5 -- the JAX package's own dual-vs-single
    tolerance -- against the port's single pool, where every path is
    traced by the same arithmetic and only the order of the framebuffer
    sums differs;
  * metrics: ``iterations`` and the lane counts equal the JAX run's; the
    traffic counters within 0.5% (a knife-edge flip ends or prolongs one
    path; the JAX package sums them in float32) and the candidate total
    within 1% (a sphere on a cull bound);
  * the first iteration, state for state, against the JAX package's own
    pieces (camera_rays, the cone cull, the list kernel, bounce_planar):
    the FIFO holds the scattered rays of exactly the lanes that hit, hit
    point 1e-4 / direction 2e-3 of unit size, attenuation equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracinginoneweekend_tpu_torch as rt
from raytracinginoneweekend_tpu import config as jconfig
from raytracinginoneweekend_tpu.models import camera as jcamera
from raytracinginoneweekend_tpu.models import scene as jscene
from raytracinginoneweekend_tpu.ops import cull as jcull
from raytracinginoneweekend_tpu.ops import pallas_segment as jseg
from raytracinginoneweekend_tpu.ops import planar as jplanar
from raytracinginoneweekend_tpu.ops import wavefront_dual as jdual
from raytracinginoneweekend_tpu_torch import golden
from raytracinginoneweekend_tpu_torch.models import camera as pcamera
from raytracinginoneweekend_tpu_torch.models import scene as pscene
from raytracinginoneweekend_tpu_torch.ops import wavefront_dual as pdual

# The suite runs in several worker processes that share the machine's cores.
# PyTorch's default, one intra-op thread per core in EVERY worker,
# oversubscribes them (measured: the same small frames take five times as
# long with six workers); the planes here are small, two threads are plenty.
torch.set_num_threads(2)

POOL = 3 * 8192
SCENES = {
    "simple-cuda": (jscene.simple_scene_cuda,
                    lambda: pscene.simple_scene_cuda("cpu")),
    "huge": (lambda: jscene.huge_scene(0),
             lambda: pscene.huge_scene(0, "cpu")),
}
CAMERAS = {
    "cuda": (jcamera.reference_cuda_camera, pcamera.reference_cuda_camera),
    "cpu": (jcamera.reference_cpu_camera, pcamera.reference_cpu_camera),
}


def _options(mod, compat, changes):
    base = {"default": mod.DEFAULT,
            "reference-cuda": mod.REFERENCE_CUDA}[compat]
    return dataclasses.replace(base, **dict(changes))


@functools.lru_cache(maxsize=None)
def _jax_dual(scene, camera, compat, mode, w, h, spp, depth, changes=(),
              k_s=2, metrics=False):
    out = jdual.wavefront_dual_fb(
        SCENES[scene][0](), CAMERAS[camera][0](w, h), jax.random.key(0),
        width=w, height=h, spp=spp, max_depth=depth, camera_mode=mode,
        options=_options(jconfig, compat, changes), pool_size=POOL, k_s=k_s,
        with_metrics=metrics)
    if metrics:
        return (np.asarray(out[0]) / spp,
                {k: float(v) for k, v in out[1].items()})
    return np.asarray(out) / spp


def _port_kw(scene, camera, compat, mode, w, h, spp, depth, changes=()):
    return (SCENES[scene][1](), CAMERAS[camera][1](w, h, "cpu"),
            rt.key_words(0)), dict(
        width=w, height=h, spp=spp, max_depth=depth, camera_mode=mode,
        options=_options(rt.config, compat, changes), device="cpu")


def _port_dual(*args, changes=(), k_s=2, metrics=False):
    pos, kw = _port_kw(*args, changes=changes)
    out = pdual.render_wavefront_dual(*pos, pool_size=POOL, k_s=k_s,
                                      with_metrics=metrics, **kw)
    if metrics:
        return out[0].numpy(), out[1]
    return out.numpy()


def _port_single(*args, changes=()):
    pos, kw = _port_kw(*args, changes=changes)
    return rt.render_wavefront(*pos, pool_size=4096, **kw).numpy()


RR = (("rr_terminate", True),)
STRAT = (("sampling", "stratified"),)
HUGE = ("huge", "cpu", "default", "thinlens", 48, 32, 4, 8)
FRAMES = {
    "huge": (HUGE, {}, 5e-4),
    "simple_cuda_reference_cuda": (
        ("simple-cuda", "cuda", "reference-cuda", "cuda", 48, 32, 4, 8), {},
        3e-5),
    "huge_rr": (HUGE, {"changes": RR}, 5e-4),
    "huge_stratified": (HUGE, {"changes": STRAT}, 5e-4),
    "huge_three_copies": (HUGE, {"k_s": 3}, 5e-4),
    # spp no multiple of the task, image no multiple of the tile edge
    "huge_odd": (("huge", "cpu", "default", "thinlens", 50, 34, 3, 5), {},
                 5e-4),
    "huge_depth_1": (("huge", "cpu", "default", "thinlens", 48, 32, 2, 1),
                     {}, 5e-4),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_dual_frame_matches_jax_and_single_pool(name):
    args, kw, atol = FRAMES[name]
    got = _port_dual(*args, **kw)
    assert got.shape == (args[4] * args[5], 3) and got.dtype == np.float32
    assert np.isfinite(got).all() and got.max() > 0.05
    cmp = golden.compare_frames(got, _jax_dual(*args, **kw), atol=atol)
    assert cmp["ok"], cmp
    single = _port_single(*args, changes=kw.get("changes", ()))
    cmp = golden.compare_frames(got, single, atol=5e-5)
    assert cmp["ok"], cmp


def test_metrics_match_jax():
    want_img, want = _jax_dual(*HUGE, metrics=True)
    got_img, got = _port_dual(*HUGE, metrics=True)
    assert golden.compare_frames(got_img, want_img, atol=5e-4)["ok"]
    assert set(got) == set(want)
    assert all(isinstance(v, int) for v in got.values())
    for k in ("iterations", "p_lanes", "s_lanes", "issue_lane_iters"):
        assert got[k] == want[k], k
    assert got["issue_lane_iters"] == 48 * 32 * 4  # one per camera ray
    for k in ("secondary_active_lane_iters", "primary_blocked_lane_iters",
              "handoffs"):
        assert abs(got[k] - want[k]) <= 5e-3 * want[k], k
    assert abs(got["primary_candidate_total"]
               - want["primary_candidate_total"]) \
        <= 1e-2 * want["primary_candidate_total"]
    # the metrics run renders the same image as the run without
    np.testing.assert_allclose(got_img, _port_dual(*HUGE), atol=1e-6)


def test_plain_flag_is_the_cpu_path():
    pos, kw = _port_kw(*HUGE)
    a = pdual.render_wavefront_dual(*pos, pool_size=POOL, **kw)
    b = pdual.render_wavefront_dual(*pos, pool_size=POOL, plain=True, **kw)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("args", [(1 << 16, 100, 2), (3 << 20, 100, 2),
                                  (100, 4, 2), (1 << 16, 8, 3),
                                  (5 * 8192 + 17, 8, 4)])
def test_dual_pool_lanes_equal(args):
    pool, spp, k_s = args
    assert pdual.dual_pool_lanes(pool, spp, k_s) == \
        jdual.dual_pool_lanes(pool, spp, k_s)


@pytest.mark.parametrize("n_g", [1, 2, 3, 7, 10, 241, 1000, 4096])
def test_granule_stride_equal(n_g):
    assert pdual._granule_stride(n_g) == jdual._granule_stride(n_g)


def test_constants_equal():
    for name in ("LANES", "ROWS", "BLOCK", "TASK_SAMPLES", "FLUSH_EVERY",
                 "SECONDARY_COPIES"):
        assert getattr(pdual, name) == getattr(jdual, name), name


def _first_iteration(changes=()):
    """The port's first iteration from the all-idle state, and what the
    JAX package's pieces give for the same lanes."""
    w, h, spp = 48, 32, 4
    pos, kw = _port_kw("huge", "cpu", "default", "thinlens", w, h, spp, 8,
                       changes=changes)
    eng = pdual.build_dual_engine(*pos, pool_size=POOL, **kw)
    s0 = pdual.initial_dual_state(eng)
    met = torch.zeros(6, dtype=torch.int64)
    s1 = pdual.dual_step(eng, s0, met)
    # the JAX side: lane l holds sequential task l (granule 0 -> itself)
    lane = np.arange(eng.p, dtype=np.int32).reshape(-1, 128)
    assert eng.tpp == 1 and eng.n_g == 1
    pid, valid = jcull.tile_pixel(jnp.asarray(lane), w, h)
    issue = np.asarray(valid) & (lane < eng.n_tasks)
    sid = jnp.zeros_like(pid)
    jopt = _options(jconfig, "default", changes)
    *rays, rk0, rk1 = jplanar.camera_rays(
        CAMERAS["cpu"][0](w, h), pid, sid, jax.random.key(0), w, h,
        "thinlens", sampling=jopt.sampling, spp=spp)
    jp = jseg.sphere_params_from_scene(SCENES["huge"][0]())
    stats = jcull.block_cone_stats(jnp.asarray(issue), tuple(rays),
                                   jdual.ROWS)
    counts, lists = jcull.candidate_lists(stats, *jp[:4], jopt.t_min)
    seg = jseg.trace_segment_list(tuple(rays), jp, counts, lists, jopt.t_min,
                                  rows=jdual.ROWS, active=jnp.asarray(issue))
    strat0 = None
    if jopt.sampling == "stratified":
        from raytracinginoneweekend_tpu.ops.threefry import key_words
        b0, b1 = key_words(jax.random.key(0))
        strat0 = jplanar.strat0_scatter_planes(rk0, rk1, pid, sid, b0, b1,
                                               spp, True)
    nd = jplanar.bounce_planar(seg, tuple(rays[3:]), rk0, rk1, sid,
                               unit_sample=True, phys_refract=True,
                               sky_bias=0.5, strat0=strat0)
    return eng, s1, met, issue, np.asarray(pid), seg, nd, counts


@pytest.mark.parametrize("changes", [(), STRAT], ids=["iid", "stratified"])
def test_first_iteration_state_for_state(changes):
    eng, s1, met, issue, pid, seg, nd, counts = _first_iteration(changes)
    hit = np.asarray(seg["hit"]) > 0
    survive = issue & hit & np.asarray(nd[3])
    val = s1.h0.val.numpy()
    assert (val != survive).sum() <= 2e-3 * issue.sum()
    same = val & survive
    assert same.sum() > 200 and not s1.h1.val.any()
    np.testing.assert_array_equal(s1.h0.pid.numpy()[same], pid[same])
    assert (s1.h0.sid.numpy()[same] == 0).all()
    for name, want, tol in (("ox", seg["px"], 1e-4), ("oy", seg["py"], 1e-4),
                            ("oz", seg["pz"], 1e-4), ("dx", nd[0], 2e-3),
                            ("dy", nd[1], 2e-3), ("dz", nd[2], 2e-3)):
        got = getattr(s1.h0, name).numpy()[same]
        close = np.isclose(got, np.asarray(want)[same], rtol=1e-4, atol=tol)
        assert close.mean() >= 0.995, (name, close.mean())
    for name, want in (("ar", seg["ar"]), ("ag", seg["ag"]),
                       ("ab", seg["ab"])):
        got = getattr(s1.h0, name).numpy()[same]
        assert (got == np.asarray(want)[same]).mean() >= 0.995, name
    # task bookkeeping: every issuing lane holds its task, one sample on
    assert (s1.task.numpy()[issue] == np.flatnonzero(issue.ravel())).all()
    assert (s1.task.numpy()[~issue] == -1).all()
    assert (s1.sid.numpy()[issue] == 1).all()
    np.testing.assert_array_equal(s1.outs.numpy(), val.astype(np.int32))
    assert not s1.s_act.any() and (s1.pp == eng.n_pixels).all()
    # sky radiance of the misses went into the task accumulators
    miss = issue & ~hit
    np.testing.assert_allclose(s1.accr.numpy()[miss],
                               np.asarray(nd[4])[miss], rtol=1e-5)
    m = dict(zip(pdual.METRICS, met.tolist()))
    assert m["iterations"] == 1 and m["issue_lane_iters"] == issue.sum()
    assert m["handoffs"] == 0 and m["secondary_active_lane_iters"] == 0
    assert abs(m["primary_candidate_total"] - int(counts.sum())) <= 4


def test_dual_state_round_trip():
    pos, kw = _port_kw(*HUGE)
    eng = pdual.build_dual_engine(*pos, pool_size=POOL, **kw)
    state = pdual.initial_dual_state(eng)
    for _ in range(3):
        state = pdual.dual_step(eng, state)
    planes = pdual.dual_state_to_numpy(state)
    assert len(planes) == 48
    assert planes[0].shape == (64, 128) and planes[35].shape == (128, 128)
    assert planes[11].dtype == bool and planes[35].dtype == bool
    back = pdual.dual_state_from_numpy(planes, device="cpu")
    for a, b in zip(pdual._flat_planes(back), pdual._flat_planes(state)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    nxt = pdual.dual_step(eng, back)
    want = pdual.dual_step(eng, state)
    for a, b in zip(pdual._flat_planes(nxt), pdual._flat_planes(want)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="48"):
        pdual.dual_state_from_numpy(planes[:40], device="cpu")


def test_refusals():
    pos, kw = _port_kw(*HUGE)
    with pytest.raises(ValueError, match="worker_index"):
        pdual.render_wavefront_dual(*pos, worker_index=2, n_workers=2, **kw)
    with pytest.raises(ValueError, match="int32 ray-id"):
        pdual.render_wavefront_dual(*pos, **dict(kw, width=1 << 16,
                                                 height=1 << 15, spp=1))
    with pytest.raises(ValueError, match="k_s"):
        pdual.render_wavefront_dual(*pos, k_s=0, **kw)
