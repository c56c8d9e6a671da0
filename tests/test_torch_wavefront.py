"""PyTorch port vs the JAX package: the forward wavefront render as a whole.

``render_wavefront(device="cpu")`` of the port (the kernels' plain PyTorch
versions) against the JAX ``render_wavefront`` (Pallas kernels in
interpret mode), same scene, camera, key and options.

Tolerance: the renderer's own frame rule (the JAX package's
tests/test_golden_oracle.py::_compare, here golden.compare_frames) -- at
most 1% knife-edge pixels (a t_min or grazing decision that float rounding
flips sends a path elsewhere), every other pixel within atol 3e-5 / rtol
1e-4. The two sides draw the same random numbers and differ in float
rounding only (XLA:CPU contracts multiply-adds, two libms). On the huge
scene atol is 5e-4, as in the JAX package's own huge-crop test: the
near root on the r = 1000 ground sphere amplifies that rounding.
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
from raytracinginoneweekend_tpu.ops import wavefront as jwave
from raytracinginoneweekend_tpu_torch import golden
from raytracinginoneweekend_tpu_torch.models import camera as pcamera
from raytracinginoneweekend_tpu_torch.models import scene as pscene
from raytracinginoneweekend_tpu_torch.ops import wavefront as pwave

# The suite runs in several worker processes that share the machine's cores.
# PyTorch's default, one intra-op thread per core in EVERY worker,
# oversubscribes them (measured: the same small frames take five times as
# long with six workers); the planes here are small, two threads are plenty.
torch.set_num_threads(2)

SCENES = {
    "simple-cuda": (jscene.simple_scene_cuda,
                    lambda: pscene.simple_scene_cuda("cpu")),
    "simple-cpu": (jscene.simple_scene_cpu,
                   lambda: pscene.simple_scene_cpu("cpu")),
    "huge": (lambda: jscene.huge_scene(0),
             lambda: pscene.huge_scene(0, "cpu")),
}
CAMERAS = {
    "cuda": (jcamera.reference_cuda_camera, pcamera.reference_cuda_camera),
    "cpu": (jcamera.reference_cpu_camera, pcamera.reference_cpu_camera),
}


def _options(mod, compat, **changes):
    base = {"default": mod.DEFAULT, "reference-cuda": mod.REFERENCE_CUDA,
            "reference-cpu": mod.REFERENCE_CPU}[compat]
    return dataclasses.replace(base, **changes)


@functools.lru_cache(maxsize=None)
def _render_jax(scene, camera, compat, mode, w, h, spp, depth, seed=0,
                pool_size=4096, stats=False, changes=()):
    out = jwave.render_wavefront(
        SCENES[scene][0](), CAMERAS[camera][0](w, h), jax.random.key(seed),
        width=w, height=h, spp=spp, max_depth=depth, camera_mode=mode,
        options=_options(jconfig, compat, **dict(changes)),
        pool_size=pool_size, return_stats=stats)
    if stats:
        return np.asarray(out[0]), {k: int(v) for k, v in out[1].items()}
    return np.asarray(out)


def _render_port(scene, camera, compat, mode, w, h, spp, depth, seed=0,
                 pool_size=4096, stats=False, changes=(), **kw):
    out = rt.render_wavefront(
        SCENES[scene][1](), CAMERAS[camera][1](w, h, "cpu"),
        rt.key_words(seed), width=w, height=h, spp=spp, max_depth=depth,
        camera_mode=mode, options=_options(rt.config, compat,
                                           **dict(changes)),
        pool_size=pool_size, return_stats=stats, device="cpu", **kw)
    if stats:
        return out[0].numpy(), out[1]
    return out.numpy()


RR = (("rr_terminate", True),)
STRAT_RR = (("rr_terminate", True), ("sampling", "stratified"))

FRAMES = {
    # name: (args, atol)
    "simple_cuda_reference_cuda": (
        ("simple-cuda", "cuda", "reference-cuda", "cuda", 32, 24, 4, 8),
        {}, 3e-5),
    "simple_cpu_default_thinlens": (
        ("simple-cpu", "cpu", "default", "thinlens", 24, 16, 4, 8), {},
        3e-5),
    "huge_crop": (("huge", "cpu", "default", "thinlens", 32, 24, 2, 6), {},
                  5e-4),
    "simple_cpu_rr": (
        ("simple-cpu", "cpu", "default", "thinlens", 24, 16, 4, 8),
        {"changes": RR}, 3e-5),
    "simple_cpu_stratified_rr": (
        ("simple-cpu", "cpu", "default", "thinlens", 24, 16, 4, 8),
        {"changes": STRAT_RR}, 3e-5),
    # spp not a multiple of TASK_SAMPLES: two tasks per pixel, 16 + 4
    "simple_cuda_spp20": (
        ("simple-cuda", "cuda", "default", "thinlens", 16, 12, 20, 4), {},
        3e-5),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frame_matches_jax(name):
    args, kw, atol = FRAMES[name]
    want = _render_jax(*args, **kw)
    got = _render_port(*args, **kw)
    assert got.shape == want.shape == (args[4] * args[5], 3)
    assert got.dtype == np.float32
    cmp = golden.compare_frames(got, want, atol=atol)
    assert cmp["ok"], cmp


def test_return_stats_match_jax():
    args = FRAMES["huge_crop"][0]
    want, wstats = _render_jax(*args, stats=True)
    got, gstats = _render_port(*args, stats=True)
    assert golden.compare_frames(got, want, atol=5e-4)["ok"]
    assert set(gstats) == set(wstats) == {"iters", "segments", "lanes"}
    assert gstats["iters"] == wstats["iters"]
    assert gstats["lanes"] == wstats["lanes"]
    # a knife-edge flip ends or prolongs one path: within 0.5%
    assert abs(gstats["segments"] - wstats["segments"]) \
        <= 5e-3 * wstats["segments"]
    # the stats run renders the same image as the run without
    np.testing.assert_array_equal(got, _render_port(*args))


@pytest.mark.parametrize("name", golden.GOLDEN_NAMES)
def test_golden_frames_still_match_jax(name):
    """The committed golden frames are what the JAX package renders today
    (so they cannot drift), and the port agrees with them."""
    image, flags = golden.load_golden(name)
    args = (flags["scene"], flags["camera"], flags["compat"], flags["mode"],
            flags["width"], flags["height"], flags["spp"], flags["depth"])
    want = _render_jax(*args, seed=flags["seed"],
                       pool_size=flags["pool_size"])
    # the same JAX code compiled on another CPU may round differently and
    # flip a knife-edge pixel: the frame rule at a tight tolerance
    fresh = golden.compare_frames(image, want, atol=1e-5, rtol=1e-5)
    assert fresh["ok"], fresh
    got = golden.render_golden(flags, device="cpu").numpy()
    atol = 5e-4 if flags["scene"] == "huge" else 3e-5
    cmp = golden.compare_frames(got, image, atol=atol)
    assert cmp["ok"], cmp


def test_pool_invariance():
    """Pixels do not depend on the pool size (draws are keyed by pixel
    and sample; only the ledger's summation order could differ, and with
    one task per pixel it does not)."""
    args = ("simple-cuda", "cuda", "default", "thinlens", 48, 32, 8, 6)
    small, s1 = _render_port(*args, pool_size=32, stats=True)
    big, s2 = _render_port(*args, pool_size=1 << 14, stats=True)
    assert s1["lanes"] == 8192 and s2["lanes"] == 16384
    assert s1["segments"] == s2["segments"]
    np.testing.assert_allclose(small, big, atol=1e-6, rtol=1e-6)


def test_plain_flag_is_the_cpu_path():
    args = FRAMES["simple_cpu_default_thinlens"][0]
    np.testing.assert_array_equal(_render_port(*args),
                                  _render_port(*args, plain=True))


@pytest.mark.parametrize("args", [
    (1 << 15, 1200, 800, 100), (1 << 20, 1200, 800, 100), (32, 24, 16, 2),
    (1 << 14, 48, 32, 8), (5000, 100, 100, 3), (1 << 15, 240, 160, 8),
])
def test_pool_lanes_equal(args):
    assert pwave.pool_lanes(*args) == jwave.pool_lanes(*args)
    assert pwave.pool_lanes(*args, task_samples=4) == \
        jwave.pool_lanes(*args, task_samples=4)


def test_constants_equal():
    for name in ("TASK_SAMPLES", "FLUSH_EVERY", "N_SLOTS", "ROWS_DEFAULT",
                 "LEDGER_CAP_BYTES", "N_BASE", "LANES"):
        assert getattr(pwave, name) == getattr(jwave, name), name


def _tiny(**kw):
    args = dict(width=8, height=8, spp=1, max_depth=2,
                camera_mode="thinlens", options=rt.DEFAULT, device="cpu")
    args.update(kw)
    return rt.render_wavefront(
        pscene.simple_scene_cuda("cpu"),
        pcamera.reference_cuda_camera(8, 8, "cpu"), rt.key_words(0), **args)


def test_ray_id_overflow_raises():
    with pytest.raises(ValueError, match="int32 ray-id"):
        _tiny(width=1 << 16, height=1 << 15, spp=1)


@pytest.mark.parametrize("resolve", ["split", "f32"])
def test_resolve_variants_bit_identical(resolve):
    """tests/test_wavefront.py::test_resolve_variants_bit_identical: the
    JAX package's resolve forms are exact gathers that give the "onehot"
    frame; the port's lookup is a direct index, the same for all three.
    Against JAX's frame of the same form: the frame rule."""
    for scene, w, h, atol in (("simple-cuda", 32, 20, 3e-5),
                              ("huge", 28, 16, 5e-4)):
        args = (scene, "cpu", "default", "thinlens", w, h, 4, 6, 3, 2048)
        base = _render_port(*args)
        assert np.isfinite(base).all() and base.max() > 0.05
        got = _render_port(*args, changes=(("resolve", resolve),))
        np.testing.assert_array_equal(base, got, err_msg=resolve)
        want = _render_jax(*args, changes=(("resolve", resolve),))
        cmp = golden.compare_frames(got, want, atol=atol)
        assert cmp["ok"], cmp


def test_unknown_resolve_raises():
    with pytest.raises(ValueError, match="resolve"):
        rt.TraceOptions(resolve="bf16")


@pytest.mark.parametrize("n_workers", [2, 3])
def test_workers_partial_frames_sum_to_one_worker(n_workers):
    """Worker w of n (strided ownership: its lanes start at w*P and step
    n*P) traces only its own tasks; the sum of the workers' partial
    framebuffers is the one-worker frame within rtol 2e-4 / atol 2e-5
    (tests/test_parallel.py's bound: a pixel's tasks add in another
    order). One task a pixel here, so it is the frame to the bit; 17408
    tasks over 8192-lane workers, so the third worker has some too."""
    w, h = 136, 128
    kw = dict(width=w, height=h, spp=2, max_depth=3,
              camera_mode="thinlens", options=rt.DEFAULT, pool_size=32,
              device="cpu")
    scene = pscene.simple_scene_cuda("cpu")
    cam = pcamera.reference_cuda_camera(w, h, "cpu")
    want = pwave.wavefront_fb(scene, cam, rt.key_words(0), **kw)
    parts = [pwave.wavefront_fb(scene, cam, rt.key_words(0), worker_index=w,
                                n_workers=n_workers, **kw)
             for w in range(n_workers)]
    assert all(float(p.abs().sum()) > 0 for p in parts)
    got = parts[0]
    for p in parts[1:]:
        got = got + p
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="worker_index"):
        pwave.wavefront_fb(scene, cam, rt.key_words(0), worker_index=n_workers,
                           n_workers=n_workers, **kw)


@pytest.mark.parametrize("changes, match", [
    (dict(rr_terminate=True), "rr_terminate"),
    (dict(ownership="tile"), "ownership='tile'"),
    (dict(hit_kernel="sorted"), "hit_kernel='sorted'"),
    (dict(sampling="stratified"), "stratified"),
], ids=["rr", "tile", "sorted", "stratified"])
def test_whole_bounce_combinations_keep_the_jax_errors(changes, match):
    """What the JAX engine refuses with a ValueError under mega='bounce'
    is refused with the same error here."""
    for mod, fn in ((rt, _tiny), (jconfig, _tiny_jax)):
        with pytest.raises(ValueError, match=match):
            fn(options=mod.TraceOptions(mega="bounce", **changes))


def _tiny_jax(**kw):
    args = dict(width=8, height=8, spp=1, max_depth=2,
                camera_mode="thinlens", options=jconfig.DEFAULT)
    args.update(kw)
    return jwave.render_wavefront(
        jscene.simple_scene_cuda(), jcamera.reference_cuda_camera(8, 8),
        jax.random.key(0), **args)


# ---------------------------------------------------------------------------
# The coherent-ray variants of the single pool: fusion level, closest-hit
# kernel, task ownership
# ---------------------------------------------------------------------------

VARIANTS = {
    "off": (("mega", "off"),),
    "tile": (("ownership", "tile"),),
    "sorted": (("hit_kernel", "sorted"),),
    "sorted_tile": (("hit_kernel", "sorted"), ("ownership", "tile")),
    "sorted_tile_rows8_no_ladder": (
        ("hit_kernel", "sorted"), ("ownership", "tile"), ("sorted_rows", 8),
        ("sorted_ladder", ())),
    "off_tile": (("mega", "off"), ("ownership", "tile")),
    "off_sorted_tile": (("mega", "off"), ("hit_kernel", "sorted"),
                        ("ownership", "tile")),
}
VARIANT_FRAMES = {
    "huge": ("huge", "cpu", "default", "thinlens", 36, 20, 4, 6),
    "simple": ("simple-cuda", "cpu", "default", "thinlens", 40, 24, 4, 6),
    # two tasks per pixel (20 = 16 + 4 samples): the fold sums a pixel's
    # tasks in the same order under either ownership
    "simple_spp20": ("simple-cuda", "cuda", "default", "thinlens", 16, 12,
                     20, 4),
}


@functools.lru_cache(maxsize=None)
def _port_frame(frame, changes=(), stats=False, pool_size=2048):
    return _render_port(*VARIANT_FRAMES[frame], changes=changes, stats=stats,
                        pool_size=pool_size)


@pytest.mark.parametrize("frame", sorted(VARIANT_FRAMES))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_frames_bit_equal_to_default(variant, frame):
    """Tile ownership, the sorted kernel and the unfused step move tasks
    between lanes, reorder the sphere loop and split the step, but trace
    every (pixel, sample) with the same arithmetic and sum a pixel's tasks
    in the same order: BIT-equal frames, as the JAX package demands of
    itself (its test_tile_ownership_images_bit_identical)."""
    np.testing.assert_array_equal(_port_frame(frame, VARIANTS[variant]),
                                  _port_frame(frame))


def test_wall_scene_variants_bit_equal():
    """The depth-bounded wall scene (the JAX package's demonstration
    workload for sorted + tile), pinhole camera."""
    scene = pscene.wall_scene(0, device="cpu")
    w, h = 36, 24
    cam = pcamera.make_camera((0.0, 11.0, 4.0), (0.0, 11.0, 0.0), (0, 1, 0),
                              w / h, 60.0, 0.0, 4.0, device="cpu")
    kw = dict(width=w, height=h, spp=4, max_depth=4, camera_mode="pinhole",
              pool_size=2048, device="cpu")
    base = rt.render_wavefront(scene, cam, rt.key_words(1),
                               options=rt.DEFAULT, **kw).numpy()
    assert np.isfinite(base).all() and base.max() > 0.05
    for hk, own in (("sublane", "tile"), ("sorted", "strided"),
                    ("sorted", "tile")):
        o = dataclasses.replace(rt.DEFAULT, hit_kernel=hk, ownership=own)
        got = rt.render_wavefront(scene, cam, rt.key_words(1), options=o,
                                  **kw).numpy()
        np.testing.assert_array_equal(base, got, err_msg=f"{hk}/{own}")


@pytest.mark.parametrize("variant", ["off", "sorted_tile", "off_sorted_tile"])
def test_variant_frame_matches_jax(variant):
    args = VARIANT_FRAMES["huge"]
    want = _render_jax(*args, pool_size=2048, changes=VARIANTS[variant])
    cmp = golden.compare_frames(_port_frame("huge", VARIANTS[variant]), want,
                                atol=5e-4)
    assert cmp["ok"], cmp


@pytest.mark.parametrize("mega", ["fused", "off"])
def test_mxu_frame_under_the_one_percent_rule(mega):
    """The mxu kernel regroups the dot products, so single knife-edge
    candidates round the other way: at most 1% of pixels more than 1e-3
    (relative, floor 1e-3) away from the default frame -- the JAX
    package's own rule -- and within the frame rule of the JAX mxu
    frame."""
    changes = (("hit_kernel", "mxu"), ("mega", mega))
    a = _port_frame("huge", (("mega", mega),))
    b = _port_frame("huge", changes)
    err = np.abs(a - b) / (np.abs(a) + 1e-3)
    assert (err.max(axis=-1) > 1e-3).mean() <= 0.01
    want = _render_jax(*VARIANT_FRAMES["huge"], pool_size=2048,
                       changes=changes)
    cmp = golden.compare_frames(b, want, atol=5e-4)
    assert cmp["ok"], cmp


@pytest.mark.parametrize("variant", ["off", "tile", "sorted_tile"])
def test_variant_stats_match_jax(variant):
    args = VARIANT_FRAMES["huge"]
    _w, wstats = _render_jax(*args, pool_size=2048, stats=True,
                             changes=VARIANTS[variant])
    got, gstats = _port_frame("huge", VARIANTS[variant], stats=True)
    np.testing.assert_array_equal(got, _port_frame("huge"))
    assert set(gstats) == {"iters", "segments", "lanes"}
    assert gstats["iters"] == wstats["iters"]
    assert gstats["lanes"] == wstats["lanes"]
    assert abs(gstats["segments"] - wstats["segments"]) \
        <= 5e-3 * wstats["segments"]


def test_tile_ownership_decomposition():
    """own_bl, T_b, the padded task space and the first task ids, as the
    JAX engine works them out (ops/wavefront.py there, :187-210, :259-264)."""
    scene = pscene.simple_scene_cuda("cpu")
    cam = pcamera.reference_cuda_camera(50, 34, "cpu")
    eng = pwave.build_engine(
        scene, cam, rt.key_words(0), width=50, height=34, spp=20,
        max_depth=4, camera_mode="thinlens",
        options=rt.TraceOptions(ownership="tile", sorted_rows=16),
        pool_size=16384, device="cpu")
    n_vp = 64 * 64                      # 2 x 2 tiles of 32 x 32
    assert (eng.lanes, eng.tpp, eng.own_bl) == (16384, 2, 2048)
    assert eng.own_tb % eng.own_bl == 0 and eng.own_tb % eng.tpp == 0
    assert eng.n_tasks == 8 * eng.own_tb >= n_vp * 2
    assert eng.n_tasks - n_vp * 2 < 8 * eng.own_bl  # less than a round over
    assert eng.n_k == eng.own_tb // eng.own_bl and eng.stride == eng.own_bl
    first = pwave.first_tasks(eng.lanes, "cpu", eng.own_bl, eng.own_tb)
    lane = np.arange(eng.lanes)
    np.testing.assert_array_equal(
        first.numpy().ravel(),
        (lane // 2048) * eng.own_tb + lane % 2048)
    # every task id has exactly one owner
    ids = (first.numpy().ravel()[None, :]
           + np.arange(eng.n_k)[:, None] * eng.stride)
    assert sorted(ids.ravel().tolist()) == list(range(eng.n_tasks))
    with pytest.raises(ValueError, match="cull blocks"):
        pwave.build_engine(
            scene, cam, rt.key_words(0), width=50, height=34, spp=20,
            max_depth=4, camera_mode="thinlens",
            options=rt.TraceOptions(hit_kernel="sorted", sorted_rows=48),
            pool_size=8192, device="cpu")


def test_one_unfused_iteration_state_for_state():
    """One mega="off" iteration against the JAX package. Its unrotated
    step is regen-then-trace; the JAX package exposes the rotated fused
    step (trace-then-regen), so from one mid-frame state s:
    regen(off_step(s)) must equal fused_step(regen(s)) -- the JAX Pallas
    shade_regen (interpret mode) on the right, the port's plain PyTorch on
    the left. Tolerance: tests/test_torch_fused.py's."""
    from raytracinginoneweekend_tpu.ops import pallas_fused as jfused
    from raytracinginoneweekend_tpu.ops import pallas_segment as jseg
    from test_torch_fused import _compare

    w, h, spp, depth = 48, 32, 6, 6
    opts = rt.TraceOptions(mega="off")
    scene = pscene.huge_scene(0, "cpu")
    cam = pcamera.reference_cpu_camera(w, h, "cpu")
    eng = pwave.build_engine(scene, cam, rt.key_words(7), width=w, height=h,
                             spp=spp, max_depth=depth,
                             camera_mode="thinlens", options=opts,
                             pool_size=1024, task_samples=4, device="cpu")
    state = pwave.engine_prologue(eng)
    assert not (state[3] > 0).any()   # the unrotated step starts all idle
    for _ in range(4):
        state = pwave.engine_step(eng, state)
    left = pwave.engine_regen(eng, pwave.engine_step(eng, state))

    jsc, jcam = jscene.huge_scene(0), jcamera.reference_cpu_camera(w, h)
    jp = jseg.sphere_params_from_scene(jsc)
    mid = pwave.engine_regen(eng, state)
    jstate = tuple(jnp.asarray(a) for a in pwave.lane_state_to_numpy(mid))
    # both sides shade the SAME (hit, t, sphere) -- the port's; the closest
    # hit itself is held against JAX's in tests/test_torch_segment.py
    hit, t, sb = (jnp.asarray(x.numpy())
                  for x in pwave.engine_closest_hit(eng, mid))
    kw = {k: v for k, v in eng.step_kw.items() if k != "own_bl"}
    want = jfused.shade_regen(
        jstate, (hit, t), jseg.resolve_params(sb, jp),
        jfused.pack_camera(jcam), jnp.asarray(eng.base_words, jnp.uint32),
        rows=8, **kw)
    _compare(left, want, eng.n_slots, "unfused step")
    assert (np.asarray(want[13]) >= 2).any()  # rays were mid-path


def _tiny_engine(**kw):
    args = dict(width=8, height=8, spp=1, max_depth=2,
                camera_mode="thinlens", options=rt.DEFAULT, device="cpu")
    args.update(kw)
    return pwave.build_engine(
        pscene.simple_scene_cuda("cpu"),
        pcamera.reference_cuda_camera(8, 8, "cpu"), rt.key_words(0), **args)


def test_bad_deposit_and_ledger_cap():
    """An unknown deposit is refused; a frame whose ledger would pass
    LEDGER_CAP_BYTES deposits by pixel. The engine is only built: the
    8192x8192 frame (67 M pixels, a 805 MB ledger at 32768 lanes) is not
    rendered."""
    with pytest.raises(ValueError, match="deposit"):
        _tiny(deposit="heap")
    eng = _tiny_engine(width=8192, height=8192, spp=1)
    assert 3 * 4 * eng.n_k * eng.lanes > pwave.LEDGER_CAP_BYTES
    assert eng.deposit == "scatter"
    assert _tiny_engine().deposit == "ledger"
    with pytest.raises(ValueError, match="deposit"):
        _tiny_engine(deposit="heap")


def _worker_tasks(eng):
    """Every task id worker ``eng`` may trace: its lanes' own sequences
    and its reserve slice."""
    first = pwave.first_tasks(eng.lanes, "cpu", eng.own_bl, eng.own_tb,
                              eng.base).reshape(-1).to(torch.int64)
    if eng.own_bl:
        return torch.arange(eng.base, eng.base + eng.n_k * eng.lanes)
    own = (first[None, :] + eng.stride
           * torch.arange(eng.n_k)[:, None]).reshape(-1)
    return torch.cat([own[own < eng.owned_end],
                      torch.arange(eng.res_start, eng.res_end)])


@pytest.mark.parametrize("n_workers", [2, 4])
@pytest.mark.parametrize("own", ["strided", "tile"])
def test_worker_ledger_is_local_and_capped(own, n_workers, monkeypatch):
    """Under several workers a worker's ledger holds its own cells only:
    ``ledger_cell`` maps its tasks one to one onto them, and the fold's
    ``spread_cells`` puts each back at its task id. The cap bounds every
    array of the ledger deposit (the cells and the fold's task-indexed
    array)."""
    frame = dict(width=256, height=128, spp=40, pool_size=8192,
                 options=rt.TraceOptions(ownership=own),
                 reserve_frac=0.3 if own == "strided" else None)
    engs = [_tiny_engine(worker_index=w, n_workers=n_workers, **frame)
            for w in range(n_workers)]
    n_tasks = engs[0].n_tasks  # tile ownership pads it by worker count
    covered = torch.zeros(n_tasks, dtype=torch.int64)
    for eng in engs:
        tasks = _worker_tasks(eng)
        cells = pwave.ledger_cell(eng, tasks)
        n_own = pwave.own_cells(eng)
        assert int(cells.min()) >= 0 and int(cells.max()) < n_own
        assert torch.unique(cells).numel() == tasks.numel()
        assert n_own < n_tasks // n_workers + eng.lanes
        assert tuple(pwave.new_ledger(eng).cells.shape) == (
            3, n_own + eng.lanes)
        vals = torch.zeros((3, n_own), dtype=torch.float32)
        vals[:, cells] = tasks.to(torch.float32) + 1
        full = pwave.spread_cells(eng, vals)
        assert full.shape == (3, n_tasks)
        np.testing.assert_array_equal(full[0, tasks].numpy(),
                                      tasks.numpy() + 1)
        covered.index_add_(0, tasks, torch.ones_like(tasks))
    # every task id has one owner
    assert bool((covered == 1).all())
    need = 3 * 4 * max([n_tasks] + [pwave.own_cells(e) for e in engs])
    for cap, want in ((need, "ledger"), (3 * 4 * n_tasks - 1, "scatter")):
        monkeypatch.setattr(pwave, "LEDGER_CAP_BYTES", cap)
        for w in range(n_workers):
            eng = _tiny_engine(worker_index=w, n_workers=n_workers, **frame)
            assert eng.deposit == want, (cap, w)
            assert want == "scatter" or 3 * 4 * pwave.own_cells(eng) <= cap


def test_deposit_scatter_renders_the_ledger_frame():
    """deposit="scatter" asked for explicitly: with one task a pixel the
    cell gets 0 + x, the ledger frame to the bit."""
    got = _tiny(deposit="scatter").numpy()
    assert np.isfinite(got).all() and got.max() > 0
    np.testing.assert_array_equal(got, _tiny(deposit="ledger").numpy())


def _jax_picks_scatter(cap, **frame):
    """Whether the JAX engine deposits by pixel for this frame under a
    ledger cap of ``cap`` bytes: its program then holds a scatter-add
    (traced only, not compiled; one worker, no reserve -- the ledger
    path has none)."""
    old = jwave.LEDGER_CAP_BYTES
    jwave.LEDGER_CAP_BYTES = cap
    try:
        jaxpr = jax.make_jaxpr(lambda: jwave.wavefront_fb(
            jscene.simple_scene_cuda(), jcamera.reference_cuda_camera(8, 8),
            jax.random.key(0), max_depth=2, camera_mode="thinlens",
            **frame))()
    finally:
        jwave.LEDGER_CAP_BYTES = old
    return "scatter-add" in str(jaxpr)


@pytest.mark.parametrize("own", ["strided", "tile"])
def test_auto_deposit_switches_where_jax_does(own, monkeypatch):
    """"auto" picks the scatter deposit exactly past the cap, as the JAX
    engine does: with the cap set to this frame's ledger bytes both
    packages keep the ledger, one byte under it both scatter."""
    frame = dict(width=40, height=24, spp=20, pool_size=2048)
    eng = _tiny_engine(options=rt.TraceOptions(ownership=own), **frame)
    need = 3 * 4 * eng.n_k * eng.lanes
    for cap, want in ((need, "ledger"), (need - 1, "scatter")):
        monkeypatch.setattr(pwave, "LEDGER_CAP_BYTES", cap)
        got = _tiny_engine(options=rt.TraceOptions(ownership=own),
                           **frame).deposit
        assert got == want, (cap, got)
        assert _jax_picks_scatter(
            cap, options=jconfig.TraceOptions(ownership=own),
            **frame) == (want == "scatter"), cap


@functools.lru_cache(maxsize=None)
def _scatter_frames(own, task_samples):
    """The huge crop with every deposit: port scatter, port ledger, JAX
    scatter. task_samples < spp puts several tasks on one pixel."""
    args = VARIANT_FRAMES["huge"]
    changes = (("ownership", own),)
    kw = dict(pool_size=2048, changes=changes, task_samples=task_samples)
    port_s = _render_port(*args, deposit="scatter", **kw)
    port_l = _render_port(*args, deposit="ledger", **kw)
    jax_s = np.asarray(jwave.render_wavefront(
        SCENES[args[0]][0](), CAMERAS[args[1]][0](args[4], args[5]),
        jax.random.key(0), width=args[4], height=args[5], spp=args[6],
        max_depth=args[7], camera_mode=args[3],
        options=_options(jconfig, args[2], ownership=own), pool_size=2048,
        task_samples=task_samples, deposit="scatter"))
    return port_s, port_l, jax_s


@pytest.mark.parametrize("task_samples", [4, 1], ids=["tpp1", "tpp4"])
@pytest.mark.parametrize("own", ["strided", "tile"])
def test_scatter_frame_matches_ledger_and_jax(own, task_samples):
    """The scatter deposit against the port's ledger frame: bit-equal with
    one task a pixel (spp <= task samples), else within the JAX package's
    own deposit bound (rtol 2e-4, atol 2e-5: a pixel's tasks summed in
    flush order, not task order). Against the JAX package's scatter frame:
    the frame rule of the other frames here (knife-edge pixels; atol 5e-4
    on the huge scene)."""
    port_s, port_l, jax_s = _scatter_frames(own, task_samples)
    assert np.isfinite(port_s).all() and port_s.max() > 0.05
    if task_samples >= VARIANT_FRAMES["huge"][6]:
        np.testing.assert_array_equal(port_s, port_l)
    else:
        np.testing.assert_allclose(port_s, port_l, rtol=2e-4, atol=2e-5)
    cmp = golden.compare_frames(port_s, jax_s, atol=5e-4)
    assert cmp["ok"], cmp


def _pairwise(vals):
    """float32 pairwise sum: neighbours first, then pairs of pairs."""
    vals = list(vals)
    while len(vals) > 1:
        vals = [vals[i] + vals[i + 1] if i + 1 < len(vals) else vals[i]
                for i in range(0, len(vals), 2)]
    return vals[0]


def test_scatter_flush_sums_in_a_fixed_order():
    """scatter_flush on values that collide: each pixel's run, in the
    order the values came in (the sort is stable), is summed by a pairwise
    tree -- to the bit the float32 tree here -- and added onto its cell;
    free slots go to the dump. Run twice, the cells are equal."""
    eng = _tiny_engine(spp=80, task_samples=16)  # tpp = 5
    g = np.random.default_rng(0)
    n = 4096
    pix = g.integers(0, 64, n)
    pix[g.random(n) < 0.3] = 64  # free slots -> the dump
    runs = {}
    keep = []
    for i, p_ in enumerate(pix.tolist()):  # a run is at most tpp long
        if p_ == 64 or len(runs.setdefault(p_, [])) < eng.tpp:
            keep.append(i)
            if p_ != 64:
                runs[p_].append(i)
    rgb = g.random((3, n), dtype=np.float32)
    base = g.random((3, 64 + len(keep)), dtype=np.float32)
    cells = torch.from_numpy(base.copy())
    pwave.scatter_flush(eng, cells, torch.from_numpy(pix[keep]),
                        torch.from_numpy(rgb[:, keep].copy()))
    want = base.copy()
    for p_, idx in runs.items():
        for c in range(3):
            want[c, p_] = base[c, p_] + _pairwise(rgb[c, idx])
    np.testing.assert_array_equal(cells[:, :64].numpy(), want[:, :64])
    again = torch.from_numpy(base.copy())
    pwave.scatter_flush(eng, again, torch.from_numpy(pix[keep]),
                        torch.from_numpy(rgb[:, keep].copy()))
    assert torch.equal(again[:, :64], cells[:, :64])


def test_device_none_means_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        _tiny(device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        pscene.huge_scene(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        pcamera.reference_cpu_camera(8, 8)
