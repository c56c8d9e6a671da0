"""Kernel 2's three entries (fused, shade-only, regen-only) through the
port's CPU dispatch, the epoch loop and its CUDA-graph bookkeeping.

On the CPU each wrapper of ops/cuda_fused.py runs its plain version:
``shade_update`` then ``regen`` must give the fused ``shade_regen`` to the
bit (one arithmetic, as the card's three entries share one), and each is
held against the JAX package's ``pallas_fused.shade_regen`` (the Pallas
kernel in interpret mode) on the same numpy-made lane states, with the
tolerance of tests/test_torch_fused.py (integer planes equal on all but
2e-3 of lanes, key words bit-equal where they agree, floats rtol 1e-5 /
atol 5e-5: two libraries' sin/cos/sqrt/pow and XLA:CPU's contraction).
The JAX package has only the fused step; its halves are the fused step
on states where the other half has nothing to do: regen alone is the
fused step on a state with every lane inactive (nothing to shade), the
shade alone the fused step on a state where no lane has a task or can
acquire one (nothing to regenerate).

The engine's epoch loop (ops/wavefront.engine_epoch, replayed as a CUDA
graph on the card) must give, run eagerly on the CPU, the frame of the
loop it replaced to the bit, for each step (``mega``).
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
from raytracinginoneweekend_tpu.ops import pallas_fused as jfused
from raytracinginoneweekend_tpu.ops import pallas_segment as jseg
from raytracinginoneweekend_tpu_torch import kernels
from raytracinginoneweekend_tpu_torch.models import camera as pcamera
from raytracinginoneweekend_tpu_torch.models import scene as pscene
from raytracinginoneweekend_tpu_torch.ops import cuda_fused as pfused
from raytracinginoneweekend_tpu_torch.ops import cuda_segment as pseg
from raytracinginoneweekend_tpu_torch.ops import cull as pcull
from raytracinginoneweekend_tpu_torch.ops import threefry as ptf
from raytracinginoneweekend_tpu_torch.ops import wavefront as pwave

# Several worker processes share the machine's cores (see
# tests/test_torch_fused.py); the planes here are small.
torch.set_num_threads(2)

ROWS = 2
P = ROWS * 128
W, H, SPP, TASK_SAMPLES, DEPTH, SEED = 16, 12, 4, 2, 4, 3
TPP = SPP // TASK_SAMPLES
N_SLOTS = 2
N_STEPS = 3
INT_PLANES = (0, 1, 2, 3, 13)
KEY_PLANES = (17, 18)


def _compare(got, want, what):
    """The port's lane state (tensors) against the JAX one (arrays)."""
    got = pwave.lane_state_to_numpy(got)
    want = [np.asarray(w) for w in want]
    assert len(got) == len(want) == 19 + 4 * N_SLOTS
    ints = list(INT_PLANES) + [19 + 4 * j for j in range(N_SLOTS)]
    agree = np.ones(want[0].shape, bool)
    for i in ints:
        agree &= got[i] == want[i]
    budget = 2e-3 * agree.size
    assert (~agree).sum() <= budget, (what, int((~agree).sum()))
    for i in KEY_PLANES:
        assert (got[i] == want[i])[agree].all(), (what, i)
    outliers = np.zeros_like(agree)
    for i in range(len(want)):
        if i not in ints and i not in KEY_PLANES:
            outliers |= agree & ~np.isclose(got[i], want[i], rtol=1e-5,
                                            atol=5e-5, equal_nan=True)
    assert outliers.sum() <= budget, (what, int(outliers.sum()))


def _bit_equal(a, b):
    return len(a) == len(b) and all(
        torch.equal(x.view(torch.int32), y.view(torch.int32))
        for x, y in zip(a, b))


STRAT_RR = dataclasses.replace(jconfig.DEFAULT, sampling="stratified",
                               rr_terminate=True)
CONFIGS = {"thinlens_iid": (jconfig.DEFAULT, False),
           "stratified_rr_tile": (STRAT_RR, True)}


@functools.lru_cache(maxsize=None)
def _rig(name):
    """One configuration's JAX-made trajectory: the prologue and N_STEPS
    fused steps of both packages' inputs -> (kw of the port's wrappers,
    tables, the JAX step, [(state, (hit, t, sb)) per step])."""
    jopt, tile = CONFIGS[name]
    jsc = jscene.huge_scene(0)
    jcam = jcamera.reference_cpu_camera(W, H)
    psc = pscene.scene_from_numpy(*(np.asarray(a) for a in jsc),
                                  device="cpu")
    pcam = pcamera.camera_from_numpy(*(np.asarray(a) for a in jcam),
                                     device="cpu")
    kw = dict(max_depth=DEPTH, unit_sample=jopt.scatter_sample == "unit",
              phys_refract=jopt.refract == "physical",
              sky_bias=0.5 if jopt.sky == "cuda" else 1.0, width=W,
              height=H, spp=SPP, task_samples=TASK_SAMPLES, tpp=TPP,
              n_tasks=W * H * TPP, n_slots=N_SLOTS, stride=P,
              camera_mode="thinlens", rr_terminate=jopt.rr_terminate,
              rr_start=1, rr_qmin=jopt.rr_qmin, rr_scale=1.0,
              sampling=jopt.sampling)
    first = np.arange(P, dtype=np.int32).reshape(ROWS, 128)
    extra = {}
    if tile:
        # two ownership blocks of 128 lanes over the 1 x 1 tile grid (16
        # wide: most virtual pixels lie outside the image)
        _, _, n_vp = pcull.virtual_grid(W, H)
        own_bl = P // 2
        t_b = -(-(n_vp * TPP) // (2 * own_bl)) * own_bl
        extra = dict(own_bl=own_bl, t_b=t_b,
                     tiles_x=pcull.virtual_grid(W, H)[0])
        kw.update(n_tasks=2 * t_b, stride=own_bl, **extra)
        first = pwave.first_tasks(P, "cpu", own_bl, t_b).numpy()
    jkw = dict(kw)
    pkw = dict(kw, worker_base=0) if tile else kw
    jparams = jseg.sphere_params_from_scene(jsc)
    table = pseg.sphere_table(pseg.sphere_params_from_scene(psc))
    jcamvec = jfused.pack_camera(jcam)
    pcamvec = pfused.pack_camera(pcam)
    base_words = ptf.key_words(SEED)
    jbase = jnp.asarray(base_words, jnp.uint32)
    jstep_fn = jax.jit(functools.partial(jfused.shade_regen, rows=ROWS,
                                         **jkw))
    jhit = jax.jit(functools.partial(jseg.segment_closest_hit,
                                     t_min=jopt.t_min, rows=ROWS))

    def jstep(state, seg):
        hit, t, sb = (jnp.asarray(a) for a in seg)
        return [np.asarray(a) for a in jstep_fn(
            tuple(jnp.asarray(a) for a in state), (hit, t),
            jseg.resolve_params(sb, jparams), jcamvec, jbase)]

    def trace(state):
        js = [jnp.asarray(a) for a in state]
        hit, t, sb = jhit(tuple(js[4:10]), *jparams[:4], active=js[3])
        return (np.asarray(jnp.where(js[3], hit, 0)), np.asarray(t),
                np.asarray(jnp.where(js[3], sb, 0)))

    st = [np.array(a) for a in pwave.lane_state_to_numpy(
        pwave.initial_lane_state(P, N_SLOTS, "cpu"))]
    st[0] = first
    zero = (np.zeros((ROWS, 128), np.int32),
            np.zeros((ROWS, 128), np.float32),
            np.zeros((ROWS, 128), np.int32))
    state = jstep(st, zero)  # the prologue
    steps = []
    for _ in range(N_STEPS):
        seg = trace(state)
        steps.append((state, seg))
        state = jstep(state, seg)
    return pkw, table, pcamvec, base_words, jstep, steps


def _port(state, seg=None):
    planes = pwave.lane_state_from_numpy(state, device="cpu")
    if seg is None:
        return planes
    return planes, tuple(torch.from_numpy(np.array(a)) for a in seg)


def _shade_kw(kw):
    return {k: kw[k] for k in (
        "max_depth", "unit_sample", "phys_refract", "sky_bias", "width",
        "height", "spp", "tpp", "rr_terminate", "rr_start", "rr_qmin",
        "rr_scale", "sampling")} | {"own_bl": kw.get("own_bl", 0)}


def _regen_kw(kw):
    return {k: v for k, v in kw.items() if k not in (
        "max_depth", "unit_sample", "phys_refract", "sky_bias",
        "rr_terminate", "rr_start", "rr_qmin", "rr_scale")}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_shade_then_regen_is_the_fused_step_and_matches_jax(name):
    kw, table, camvec, base_words, jstep, steps = _rig(name)
    for k, (state, seg) in enumerate(steps):
        planes, pseg_in = _port(state, seg)
        fused = pfused.shade_regen(planes, pseg_in, table, camvec,
                                   base_words, **kw)
        shaded = pfused.shade_update(planes, pseg_in, table, base_words,
                                     **_shade_kw(kw))
        composed = pfused.regen(shaded, camvec, base_words, **_regen_kw(kw))
        assert _bit_equal(composed, fused), (name, k)
        _compare(composed, jstep(state, seg), f"{name} step {k}")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_regen_alone_matches_jax(name):
    """Every lane inactive: the JAX fused step shades nothing and is its
    regen half -- slot moves, acquisitions, next samples, camera rays."""
    kw, table, camvec, base_words, jstep, steps = _rig(name)
    zero = (np.zeros((ROWS, 128), np.int32),
            np.zeros((ROWS, 128), np.float32),
            np.zeros((ROWS, 128), np.int32))
    moved = 0
    for k, (state, _seg) in enumerate(steps):
        state = [np.array(a) for a in state]
        state[3] = np.zeros_like(state[3])
        got = pfused.regen(_port(state), camvec, base_words,
                           **_regen_kw(kw))
        want = jstep(state, zero)
        assert want[3].any()  # camera rays issued
        moved += int(((want[19] >= 0) & (state[19] < 0)).sum())
        _compare(got, want, f"{name} regen {k}")
    assert moved  # finished tasks moved into a pending slot


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_shade_alone_matches_jax(name):
    """No lane has a task or can acquire one: the JAX fused step
    regenerates nothing and is its shade half."""
    kw, table, camvec, base_words, jstep, steps = _rig(name)
    for k, (state, seg) in enumerate(steps):
        state = [np.array(a) for a in state]
        state[1] = np.full_like(state[1], -1)
        state[0] = np.full_like(state[0], kw["n_tasks"] + P)
        planes, pseg_in = _port(state, seg)
        got = pfused.shade_update(planes, pseg_in, table, base_words,
                                  **_shade_kw(kw))
        want = jstep(state, seg)
        assert (np.asarray(got[3]) > 0).any()
        _compare(got, want, f"{name} shade {k}")


EPOCH_FRAME = dict(width=16, height=12, spp=4, max_depth=4,
                   camera_mode="thinlens", flush_every=4, task_samples=2,
                   device="cpu")


def _loop_it_replaced(eng):
    """The frame loop as it stood before engine_epoch: the ledger, flush
    and termination test as closures, iterations written out."""
    p, n_tasks = eng.lanes, eng.n_tasks
    ledger = torch.zeros((3, n_tasks + p), dtype=torch.float32)
    dump = torch.arange(n_tasks, n_tasks + p, dtype=torch.int64)
    block_end = n_tasks

    def flush(state):
        for j in range(eng.n_slots):
            pt, pr, pg, pb = state[19 + 4 * j: 19 + 4 * (j + 1)]
            pt_flat = pt.reshape(-1)
            cell = torch.where(pt_flat >= 0, pt_flat.to(torch.int64), dump)
            ledger.index_copy_(1, cell, torch.stack(
                [pr.reshape(-1), pg.reshape(-1), pb.reshape(-1)]))
            pt.fill_(-1)
            pr.zero_()
            pg.zero_()
            pb.zero_()

    def more(state):
        nxt, task, _sid, act = state[:4]
        return bool(((act > 0).any() | (task >= 0).any()
                     | (nxt < block_end).any()).item())

    state = pwave.engine_prologue(eng)
    epochs = 0
    while more(state):
        sortstate = pwave.engine_sortstate(eng, state)
        for _ in range(eng.flush_every):
            if eng.mega != "fused":
                state = pwave.engine_regen(eng, state)
            state = pwave.engine_segment(eng, state, sortstate)
        flush(state)
        epochs += 1
    return pwave.fold_ledger(eng, ledger), epochs


@pytest.mark.parametrize("mega", ["fused", "off", "bounce"])
def test_epoch_loop_gives_the_frame_of_the_loop_it_replaced(mega):
    scene, cam = pscene.huge_scene(0, "cpu"), pcamera.reference_cpu_camera(
        16, 12, device="cpu")
    options = dataclasses.replace(rt.DEFAULT, mega=mega)
    fb, stats = pwave.wavefront_fb(scene, cam, rt.key_words(5),
                                   options=options, return_stats=True,
                                   **EPOCH_FRAME)
    eng = pwave.build_engine(scene, cam, rt.key_words(5), options=options,
                             **EPOCH_FRAME)
    want, epochs = _loop_it_replaced(eng)
    assert epochs >= 2 and stats["iters"] == epochs * eng.flush_every
    assert not pwave.epoch_graphable(eng)  # the CPU runs every epoch
    assert torch.equal(fb, want)
    assert float(fb.sum()) > 0


def test_replay_launch_bookkeeping():
    """A capture counts its epoch's launches but runs nothing: they are
    taken back, and every replay adds them again, so the counts equal the
    launches the card ran."""
    table = dict.fromkeys(("closest_hit", "shade_regen", "regen_only",
                           "mega_bounce"), 0)
    table["regen_only"] = 1  # the prologue
    eager_epoch = {"closest_hit": 32, "shade_regen": 32}
    table = kernels.add_launches(table, eager_epoch)  # the warm-up epoch
    before = dict(table)
    captured = kernels.add_launches(table, eager_epoch)  # counted in capture
    per_epoch = kernels.launch_delta(before, captured)
    assert per_epoch == eager_epoch
    table = dict(before)  # taken back
    for _ in range(5):
        table = kernels.add_launches(table, per_epoch)
    assert table == {"closest_hit": 6 * 32, "shade_regen": 6 * 32,
                     "regen_only": 1, "mega_bounce": 0}
    assert kernels.add_launches(table, per_epoch, times=0) == table
    assert kernels.add_launches({}, {"shade_only": 2}, times=3) == {
        "shade_only": 6}
    assert kernels.launch_delta(table, table) == {}
    assert set(kernels.LAUNCHES) >= {"shade_regen", "shade_only",
                                     "regen_only"}


def test_capture_needs_the_card():
    scene, cam = pscene.simple_scene_cuda("cpu"), \
        pcamera.reference_cuda_camera(8, 8, device="cpu")
    eng = pwave.build_engine(scene, cam, rt.key_words(0), width=8, height=8,
                             spp=1, max_depth=2, camera_mode="cuda",
                             options=rt.DEFAULT, device="cpu")
    ledger = pwave.new_ledger(eng)
    state = pwave.engine_prologue(eng)
    with pytest.raises(ValueError, match="eagerly"):
        pwave.capture_epoch(eng, state, ledger)
    assert not pwave.epoch_graphable(eng._replace(graph=False))


def test_launch_shape_picker():
    small = pfused.shade_regen_threads(1 << 15, 132)
    big = pfused.shade_regen_threads(1 << 20, 132)
    assert (small, big) == (256, 64)
    assert {small, big} <= set(pfused.SR_THREADS)
    # the wave of resident threads is the edge
    edge = 132 * pfused.SR_RESIDENT_THREADS_PER_SM
    assert pfused.shade_regen_threads(edge, 132) == 256
    assert pfused.shade_regen_threads(edge + 128, 132) == 64
    with pytest.raises(ValueError, match="threads=96"):
        pfused._threads("shade_regen", 96, 1 << 15, torch.device("cuda"))


def _meta_inputs():
    kw, table, camvec, base_words, _jstep, steps = _rig("thinlens_iid")
    state, seg = steps[0]
    planes, pseg_in = _port(state, seg)
    meta = tuple(p.to("meta") for p in planes)
    mseg = tuple(p.to("meta") for p in pseg_in)
    return kw, table.to("meta"), camvec.to("meta"), base_words, meta, mseg


@pytest.mark.parametrize("entry", ["shade_regen", "shade_update", "regen"])
def test_tensors_off_cpu_and_cuda_raise(entry):
    kw, table, camvec, base_words, state, seg = _meta_inputs()
    calls = {
        "shade_regen": lambda: pfused.shade_regen(state, seg, table, camvec,
                                                  base_words, **kw),
        "shade_update": lambda: pfused.shade_update(
            state, seg, table, base_words, **_shade_kw(kw)),
        "regen": lambda: pfused.regen(state, camvec, base_words,
                                      **_regen_kw(kw)),
    }
    with pytest.raises(ValueError, match="no kernel for device meta"):
        calls[entry]()


@pytest.mark.parametrize("entry", ["shade_update", "regen"])
def test_out_is_taken_on_cuda_only(entry):
    kw, table, camvec, base_words, _jstep, steps = _rig("thinlens_iid")
    planes, seg = _port(*steps[0])
    with pytest.raises(ValueError, match="CUDA only"):
        if entry == "regen":
            pfused.regen(planes, camvec, base_words, out=planes,
                         **_regen_kw(kw))
        else:
            pfused.shade_update(planes, seg, table, base_words, out=planes,
                                **_shade_kw(kw))
