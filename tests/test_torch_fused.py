"""PyTorch port vs the JAX package: the fused shade+regen step.

One JAX-made lane state goes through both ``shade_regen``s: the JAX one is
the Pallas kernel in interpret mode, the port's (on the CPU) the plain
PyTorch version of its CUDA kernel. The states come from the JAX side:
the prologue (the fused step applied to the all-idle initial state, which
is exactly the engine's regen) and then eight steps along the JAX
trajectory, the port being fed the JAX state at every step so that a
knife-edge flip does not compound.

Tolerance, and why. Both sides get the same (hit, t, sphere) input, so
what differs is sin/cos/sqrt/pow/division of two libraries and XLA:CPU's
contraction of multiply-adds:
  * integer planes (nxt task sid active depth, the slots' task ids) and
    with them the key words are equal on all lanes but at most 2e-3 of
    them (2 lanes in 1024) -- a lane whose `u < probability` or `dot > 0`
    decision sits within an ulp of the edge;
  * on the lanes whose integer planes agree the key words are BIT-EQUAL
    and the float planes agree to rtol 1e-5 / atol 5e-5, but for the same
    2e-3 (a reflect-or-refract flip keeps the integers). The atol is the
    scattered direction's: the normal (p - c) / r of an r = 0.2 sphere
    ten units from the origin turns one or two ulps of p (1e-6, a
    contracted multiply-add in p = o + t*d) into 1e-5.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginoneweekend_tpu import config as jconfig
from raytracinginoneweekend_tpu.models import camera as jcamera
from raytracinginoneweekend_tpu.models import scene as jscene
from raytracinginoneweekend_tpu.ops import pallas_fused as jfused
from raytracinginoneweekend_tpu.ops import pallas_segment as jseg
from raytracinginoneweekend_tpu_torch.models import camera as pcamera
from raytracinginoneweekend_tpu_torch.models import scene as pscene
from raytracinginoneweekend_tpu_torch.ops import cull as pcull
from raytracinginoneweekend_tpu_torch.ops import cuda_fused as pfused
from raytracinginoneweekend_tpu_torch.ops import cuda_segment as pseg
from raytracinginoneweekend_tpu_torch.ops import threefry as ptf
from raytracinginoneweekend_tpu_torch.ops import wavefront as pwave

# The suite runs in several worker processes that share the machine's cores.
# PyTorch's default, one intra-op thread per core in EVERY worker,
# oversubscribes them (measured: the same small frames take five times as
# long with six workers); the planes here are small, two threads are plenty.
torch.set_num_threads(2)

ROWS = 8
P = ROWS * 128
W, H, SPP, TASK_SAMPLES, DEPTH, SEED = 48, 32, 6, 4, 6, 7
TPP = -(-SPP // TASK_SAMPLES)
N_TASKS = W * H * TPP
N_STEPS = 8

INT_PLANES = (0, 1, 2, 3, 13)
KEY_PLANES = (17, 18)


def _compare(got, want, n_slots, what):
    """got: the port's lane state (tensors); want: the JAX one (arrays)."""
    got = pwave.lane_state_to_numpy(got)
    want = [np.asarray(w) for w in want]
    assert len(got) == len(want) == 19 + 4 * n_slots
    ints = list(INT_PLANES) + [19 + 4 * j for j in range(n_slots)]
    agree = np.ones(want[0].shape, bool)
    for i in ints:
        assert got[i].dtype == want[i].dtype, (what, i)
        agree &= got[i] == want[i]
    budget = 2e-3 * agree.size
    assert (~agree).sum() <= budget, (what, int((~agree).sum()))
    for i in KEY_PLANES:
        assert got[i].dtype == np.uint32
        assert (got[i] == want[i])[agree].all(), (what, i)
    outliers = np.zeros_like(agree)
    for i in range(len(want)):
        if i in ints or i in KEY_PLANES:
            continue
        outliers |= agree & ~np.isclose(got[i], want[i], rtol=1e-5,
                                        atol=5e-5, equal_nan=True)
    assert outliers.sum() <= budget, (what, int(outliers.sum()))


class Rig:
    """One configuration: both packages' scene, camera and step function."""

    def __init__(self, scene_name, camera_name, mode, jopt, n_slots,
                 tile=False):
        jsc = {"huge": lambda: jscene.huge_scene(0),
               "simple-cuda": jscene.simple_scene_cuda,
               "simple-cpu": jscene.simple_scene_cpu}[scene_name]()
        jcam = {"cpu": jcamera.reference_cpu_camera,
                "cuda": jcamera.reference_cuda_camera}[camera_name](W, H)
        self.n_slots = n_slots
        self.t_min = jopt.t_min
        self.jparams = jseg.sphere_params_from_scene(jsc)
        psc = pscene.scene_from_numpy(*(np.asarray(a) for a in jsc),
                                      device="cpu")
        pcam = pcamera.camera_from_numpy(*(np.asarray(a) for a in jcam),
                                         device="cpu")
        self.pparams = pseg.sphere_params_from_scene(psc)
        self.table = pseg.sphere_table(self.pparams)
        self.kw = dict(
            max_depth=DEPTH, unit_sample=jopt.scatter_sample == "unit",
            phys_refract=jopt.refract == "physical",
            sky_bias=0.5 if jopt.sky == "cuda" else 1.0, width=W, height=H,
            spp=SPP, task_samples=TASK_SAMPLES, tpp=TPP, n_tasks=N_TASKS,
            n_slots=n_slots, stride=P, camera_mode=mode,
            rr_terminate=jopt.rr_terminate, rr_start=1,
            rr_qmin=jopt.rr_qmin, rr_scale=1.0, sampling=jopt.sampling)
        self.first = np.arange(P, dtype=np.int32).reshape(ROWS, 128)
        self.stride = P
        if tile:
            # TILE ownership: two ownership blocks of 512 lanes, each with
            # a contiguous range of T_b task ids over the 2 x 1 tile grid
            # (48 wide: a third of the virtual pixels lie outside the
            # image). The decomposition is ops/wavefront.build_engine's.
            tiles_x, _, n_vp = pcull.virtual_grid(W, H)
            own_bl = P // 2
            align = own_bl * TPP // math.gcd(own_bl, TPP)
            t_b = -(-(n_vp * TPP) // (2 * align)) * align
            self.kw.update(own_bl=own_bl, t_b=t_b, tiles_x=tiles_x,
                           n_tasks=2 * t_b, stride=own_bl)
            self.first = pwave.first_tasks(P, "cpu", own_bl, t_b).numpy()
            self.stride = own_bl
        self.pkw = dict(self.kw, worker_base=0) if tile else self.kw
        self.jcamvec = jfused.pack_camera(jcam)
        self.pcamvec = pfused.pack_camera(pcam)
        np.testing.assert_array_equal(self.pcamvec.numpy(),
                                      np.asarray(self.jcamvec))
        self.base_words = ptf.key_words(SEED)
        self.jbase = jnp.asarray(self.base_words, jnp.uint32)
        self.jstep = jax.jit(functools.partial(jfused.shade_regen, rows=ROWS,
                                               **self.kw))
        self.jhit = jax.jit(functools.partial(
            jseg.segment_closest_hit, t_min=jopt.t_min, rows=ROWS))

    def initial_state(self):
        """The all-idle state (numpy planes in the JAX package's dtypes),
        its task queues advanced by one round: the first round of tasks
        is the top of the image, all sky."""
        st = pwave.lane_state_to_numpy(
            pwave.initial_lane_state(P, self.n_slots, "cpu"))
        st = [np.array(a) for a in st]
        st[0] = self.first + self.stride
        return st

    def trace(self, state):
        """JAX closest hit + winner params for a JAX-side state."""
        jstate = [jnp.asarray(a) for a in state]
        cx, cy, cz, r = self.jparams[:4]
        hit, t, sb = self.jhit(tuple(jstate[4:10]), cx, cy, cz, r,
                               active=jstate[3])
        # JAX leaves sb of an all-inactive block stale; give both sides a
        # defined index there (the lanes are inactive: fully masked).
        sb = jnp.where(jstate[3], sb, 0)
        hit = jnp.where(jstate[3], hit, 0)
        return hit, t, sb

    def both_steps(self, state, seg):
        hit, t, sb = seg
        want = self.jstep(tuple(jnp.asarray(a) for a in state), (hit, t),
                          jseg.resolve_params(sb, self.jparams),
                          self.jcamvec, self.jbase)
        pstate = pwave.lane_state_from_numpy(state, device="cpu")
        pseg_in = tuple(torch.from_numpy(np.array(a)) for a in seg)
        got = pfused.shade_regen(pstate, pseg_in, self.table, self.pcamvec,
                                 self.base_words, **self.pkw)
        return got, want

    def run(self, what):
        state = self.initial_state()
        zero_seg = (jnp.zeros((ROWS, 128), jnp.int32),
                    jnp.zeros((ROWS, 128), jnp.float32),
                    jnp.zeros((ROWS, 128), jnp.int32))
        # prologue: every lane acquires a task and gets its camera ray
        got, want = self.both_steps(state, zero_seg)
        _compare(got, want, self.n_slots, f"{what} prologue")
        assert np.asarray(want[3]).all()
        states = []
        for k in range(N_STEPS):
            state = [np.asarray(a) for a in want]
            states.append(state)
            got, want = self.both_steps(state, self.trace(state))
            _compare(got, want, self.n_slots, f"{what} step {k}")
        return states, [np.asarray(a) for a in want]


RR = dataclasses.replace(jconfig.DEFAULT, rr_terminate=True)
STRAT = dataclasses.replace(jconfig.DEFAULT, sampling="stratified")
STRAT_RR = dataclasses.replace(STRAT, rr_terminate=True)

CONFIGS = {
    "thinlens_iid": ("huge", "cpu", "thinlens", jconfig.DEFAULT, 2),
    "thinlens_iid_rr": ("huge", "cpu", "thinlens", RR, 2),
    "thinlens_stratified": ("huge", "cpu", "thinlens", STRAT, 2),
    "thinlens_stratified_rr": ("huge", "cpu", "thinlens", STRAT_RR, 2),
    "cuda_reference_cuda": ("simple-cuda", "cuda", "cuda",
                            jconfig.REFERENCE_CUDA, 2),
    "cpu_reference_cpu": ("simple-cpu", "cpu", "cpu",
                          jconfig.REFERENCE_CPU, 2),
    "pinhole_one_slot": ("huge", "cpu", "pinhole", jconfig.DEFAULT, 1),
    "tile_ownership": ("huge", "cpu", "thinlens", jconfig.DEFAULT, 2, True),
    "tile_ownership_stratified_rr": ("huge", "cpu", "thinlens", STRAT_RR, 2,
                                     True),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_shade_regen_matches_jax_along_a_trajectory(name):
    rig = Rig(*CONFIGS[name])
    states, last = rig.run(name)
    # the trajectory really exercised the step: rays bounced, tasks
    # finished and moved into pending slots, lanes re-acquired tasks
    # (the "cpu" camera mode's quirk aims most rays at the sky)
    deepest = max(int(s[13].max()) for s in states)
    assert deepest >= (1 if CONFIGS[name][2] == "cpu" else 2)
    assert (last[19] >= 0).any()
    assert (last[0] >= rig.first + 3 * rig.stride).any()
    if rig.stride != P:
        # tile ownership: no lane runs past its block's range, and some
        # lane traced a virtual pixel outside the image as pixel 0
        end = (rig.first // rig.kw["t_b"] + 1) * rig.kw["t_b"]
        assert (last[0] <= end + rig.stride).all()
        assert any((s[1] >= 0).any() for s in states)


def test_shade_regen_with_every_slot_full():
    """Lanes whose pending slots are all occupied keep their finished task
    and idle; lanes with one free slot use it."""
    rig = Rig(*CONFIGS["thinlens_iid"])
    states, _ = rig.run("slots")
    state = [np.array(a) for a in states[-1]]
    lanes = np.arange(P).reshape(ROWS, 128)
    full = lanes % 4 == 0
    half = lanes % 4 == 1
    for j in range(rig.n_slots):
        occupy = full | (half & (j == 0))
        state[19 + 4 * j] = np.where(occupy, 5 + j, state[19 + 4 * j]
                                     ).astype(np.int32)
        for c in range(1, 4):
            state[19 + 4 * j + c] = np.where(
                occupy, np.float32(0.25 * c), state[19 + 4 * j + c])
    got, want = rig.both_steps(state, rig.trace(state))
    _compare(got, want, rig.n_slots, "slots full")
    want = [np.asarray(a) for a in want]
    # a lane with every slot full that finished its task still holds it
    stuck = full & (want[1] >= 0) & ~want[3]
    assert stuck.any()


def test_lane_state_round_trip_and_errors():
    rig = Rig(*CONFIGS["thinlens_iid"])
    state = rig.initial_state()
    back = pwave.lane_state_to_numpy(
        pwave.lane_state_from_numpy(state, device="cpu"))
    for a, b in zip(back, state):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert back[3].dtype == bool and back[17].dtype == np.uint32
    with pytest.raises(ValueError):
        pwave.lane_state_from_numpy(state[:20], device="cpu")
    pstate = pwave.lane_state_from_numpy(state, device="cpu")
    seg = tuple(torch.zeros((ROWS, 128), dtype=dt)
                for dt in (torch.int32, torch.float32, torch.int32))
    with pytest.raises(ValueError, match="camera mode"):
        pfused.shade_regen(pstate, seg, rig.table, rig.pcamvec, (0, 1),
                           **dict(rig.kw, camera_mode="fisheye"))
    with pytest.raises(ValueError, match="tile ownership"):
        pfused.shade_regen(pstate, seg, rig.table, rig.pcamvec, (0, 1),
                           **dict(rig.kw, own_bl=512, t_b=2048, tiles_x=7))
    with pytest.raises(ValueError, match="CUDA only"):
        pfused.shade_regen(pstate, seg, rig.table, rig.pcamvec, (0, 1),
                           out=pstate, **rig.kw)
