"""The split loops of the two t-space closest hits, the (N, 3) intersect
kernel (``csrc/intersect.cu``) and the sphere-group kernel
(``csrc/closest_hit_grouped.cu``), in plain terms.

Both kernels split a ray's loop over K threads (the grouped kernel each
group's 16 spheres, K <= 16), take the square root only where the
discriminant is > 0 -- strict, as the t-space contract counts a tangent as
a miss -- and reduce the K partials over (t, sphere index), the grouped
kernel's index in its sorted order. A CUDA kernel cannot run here;
``chip_smoke.py`` holds both to the bit against their plain versions on the
card at every K. These tests hold what the CPU can reach; every comparison
is exact unless it says otherwise:
  * ``closest_hit_checks.guarded_t``, the guarded t-space candidate,
    reduced by the first least index, is the plain version
    (``ops/intersect.closest_hit``) bit for bit, on
    ``tspace_ties_and_grazes`` (exact tangents with disc == 0, planted exact
    ties, roots below, on and above t_min, a hollow shell; also against its
    exact answers) and on the huge scene's tiled-engine rays after three
    bounces; the plain version against the JAX kernel
    (``closest_hit_pallas`` in interpret mode) on both, under
    tests/test_torch_intersect.py's tolerances (XLA:CPU contracts products
    into FMAs);
  * ``closest_hit_checks.split_min`` over those candidates is the plain
    version at every K from 1 to 32, ties across threads included;
  * ``closest_hit_checks.grouped_split`` -- the bound test, the vote over a
    warp of 32 / K rays, each group split over K threads and the reduce
    over (t, sorted index) -- is the plain grouped version
    (``segment_closest_hit_grouped_reference``) at every K <= 16, on
    ``group_scene`` of the huge scene with a mid-frame lane state, and on
    ``ties_and_grazes``' table, whose tied copies 1 to 8 places apart in
    one group fall to different threads, with a row of lanes (a whole
    block at every K) inactive;
  * the K each wrapper picks at 32768, 131,072, 960,000 and 2^20 rays,
    and the checking of ``split=``;
  * ``disc_pairs(strict=True)`` counts the pairs that reach the t-space
    kernels' square root.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracinginoneweekend_tpu_torch as rt
from raytracinginoneweekend_tpu.ops.pallas_intersect import closest_hit_pallas
from raytracinginoneweekend_tpu_torch import cli
from raytracinginoneweekend_tpu_torch import closest_hit_checks as chk
from raytracinginoneweekend_tpu_torch.ops import cuda_segment as pseg
from raytracinginoneweekend_tpu_torch.ops import integrate
from raytracinginoneweekend_tpu_torch.ops import intersect as pint
from raytracinginoneweekend_tpu_torch.ops.cuda_intersect import (
    closest_hit_cuda)
from test_torch_intersect import _check
from test_torch_sorted_split import _mid_frame

torch.set_num_threads(2)  # several test workers share the machine's cores
# the module, not the package's ``render`` function of the same name
prender = importlib.import_module("raytracinginoneweekend_tpu_torch.render")

SPLITS = (1, 2, 4, 8, 16, 32)
GROUPED_SPLITS = (1, 2, 4, 8, 16)
BIG = np.float32(1e30)
H100_SMS = 132
TILED = dict(width=64, height=48)  # 3072 camera rays, one sample a pixel


def _tiled_rays():
    """The tiled engine's rays of the huge scene after three bounces (the
    port's own engine, intersect="pallas": on the CPU the wrapper runs the
    plain version), as chip_smoke.training_rays takes them at full width."""
    w, h = TILED["width"], TILED["height"]
    scene = cli._build_scene("huge", 0, "cpu")
    cam = cli._build_camera("cpu", w, h, "cpu")
    pids = torch.arange(w * h, dtype=torch.int32)
    o, d, keys = prender.make_primary_rays(
        cam, pids, torch.zeros_like(pids), rt.key_words(0), w, h,
        "thinlens")
    options = dataclasses.replace(rt.DEFAULT, intersect="pallas")
    state = integrate._init_state(o, d, keys)
    with torch.no_grad():
        for b in range(3):
            state = integrate._bounce_step(scene, options, state, b,
                                           allow_pallas=True)
    return (state[0].contiguous(), state[1].contiguous(), scene.centers,
            scene.radii, rt.DEFAULT.t_min)


@pytest.fixture(scope="module")
def tspace_cases():
    ties = chk.tspace_ties_and_grazes(torch.device("cpu"))
    return {"tspace_ties_and_grazes": ties[:5],
            "huge_tiled_after_3_bounces": _tiled_rays()}


def _candidates(o, d, centers, radii, t_min):
    """The guarded t-space candidates, (rays, spheres)."""
    x, y, z, vx, vy, vz = (v[:, k:k + 1] for v in (o, d) for k in range(3))
    a = vx * vx + vy * vy + vz * vz
    return chk.guarded_t(x, y, z, vx, vy, vz, a, 1.0 / a,
                         torch.tensor(t_min, dtype=torch.float32),
                         *(centers[None, :, k] for k in range(3)),
                         (radii * radii)[None, :])


def _same_bits(got, want):
    (gt, gi, gh), (wt, wi, wh) = got, want
    return (torch.equal(gt.view(torch.int32), wt.view(torch.int32))
            and torch.equal(gi.to(torch.int32), wi)
            and torch.equal(gh, wh))


def _as_result(t_b, s_b):
    t_b, s_b = torch.as_tensor(t_b), torch.as_tensor(s_b)
    return t_b, s_b.to(torch.int32), t_b < float(BIG)


CASES = ("tspace_ties_and_grazes", "huge_tiled_after_3_bounces")


@pytest.mark.parametrize("case", CASES)
def test_guarded_t_candidate_is_the_plain_closest_hit(tspace_cases, case):
    args = tspace_cases[case]
    want = pint.closest_hit(*args)
    t_b, s_b = torch.min(_candidates(*args), dim=1)  # first least index
    assert _same_bits(_as_result(t_b, s_b), want)
    hits = int(want[2].sum())
    assert 0 < hits < want[2].numel()
    if case == "tspace_ties_and_grazes":
        exact = chk.tspace_ties_and_grazes(torch.device("cpu"))[5]
        assert _same_bits(want, exact)


@pytest.mark.parametrize("case", CASES)
def test_tspace_plain_against_jax_interpret(tspace_cases, case):
    """The plain version against the JAX kernel in interpret mode, in
    tests/test_torch_intersect.py's terms; the planted case's small exact
    numbers leave XLA's contractions nothing to round, so there every
    hit and index is equal too."""
    args = tspace_cases[case]
    got = [x.numpy() for x in pint.closest_hit(*args)]
    want = [np.asarray(x) for x in closest_hit_pallas(
        *(jnp.asarray(x.numpy()) for x in args[:4]), args[4],
        interpret=True)]
    _check(got, want, args[3].numpy())
    if case == "tspace_ties_and_grazes":
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", SPLITS)
def test_tspace_split_is_the_plain_closest_hit(tspace_cases, case, k):
    args = tspace_cases[case]
    t_b, s_b = chk.split_min(_candidates(*args).numpy(), k)
    assert _same_bits(_as_result(t_b, s_b), pint.closest_hit(*args))


def test_tangent_is_a_miss_in_tspace(tspace_cases):
    """disc == 0 exactly: t-space's strict guard refuses the tangent that
    kernel 1's q-space guard (disc >= 0) takes as a hit."""
    o, d, centers, radii, t_min = tspace_cases["tspace_ties_and_grazes"]
    tangent = torch.arange(o.shape[0]) % 13 == 9
    t, idx, hit = pint.closest_hit(o[tangent], d[tangent], centers, radii,
                                   t_min)
    assert not hit.any() and (idx == 0).all()
    x, y, z, vx, vy, vz = (v[tangent, k:k + 1] for v in (o, d)
                           for k in range(3))
    a = vx * vx + vy * vy + vz * vz
    q = chk.guarded(x, y, z, vx, vy, vz, a, torch.tensor(
        t_min, dtype=torch.float32) * a, *(centers[None, :, c]
                                           for c in range(3)),
        (radii * radii)[None, :])
    assert (q.argmin(dim=1) == chk.GRAZE_SPHERE).all()


def test_disc_pairs_strict(tspace_cases):
    """The pairs that reach the t-space kernels' sqrt (disc > 0): fewer than
    kernel 1's (disc >= 0) by at least the exact tangents, and at least the
    pairs with a candidate."""
    for case, args in tspace_cases.items():
        o, d, centers, radii, _ = args
        cols = tuple(v[:, k] for v in (o, d) for k in range(3))
        geom = (centers[:, 0], centers[:, 1], centers[:, 2], radii)
        n_gt, n_pairs = chk.disc_pairs(cols, *geom, chunk=500, strict=True)
        n_ge, _ = chk.disc_pairs(cols, *geom, chunk=500)
        n_cand = int((_candidates(*args) < float(BIG)).sum())
        assert n_pairs == o.shape[0] * centers.shape[0]
        assert n_ge >= n_gt >= n_cand > 0
        if case == "tspace_ties_and_grazes":
            n_tangent = int((torch.arange(o.shape[0]) % 13 == 9).sum())
            assert n_ge - n_gt >= n_tangent


# --------------------------------------------------------------------- #
# closest_hit_grouped
# --------------------------------------------------------------------- #

def _bounds(cx, cy, cz, r):
    """A bounding sphere per group of 16 (group_scene's own form)."""
    bx, by, bz, br = (v.reshape(-1, pseg.GROUP) for v in (cx, cy, cz, r))
    g = [(v.amin(dim=1) + v.amax(dim=1)) * 0.5 for v in (bx, by, bz)]
    e = [v - c[:, None] for v, c in zip((bx, by, bz), g)]
    dist = torch.sqrt(e[0] * e[0] + e[1] * e[1] + e[2] * e[2])
    return (*g, (dist + br.abs()).amax(dim=1))


def _planted_grouped_case():
    """``ties_and_grazes``' planes and table as a grouped scene of 6 groups
    (tied copies at sorted positions 5/6, 7/8, 20/22, 40/44 and 48/56 share
    a group and fall to different threads for every K from 2 to 16), with
    row 3 (128 lanes: a whole thread block at every K) and every 37th lane
    inactive."""
    rays, geom, t_min, _ = chk.ties_and_grazes(torch.device("cpu"))
    active = torch.ones(rays[0].shape, dtype=torch.int32)
    active[3] = 0
    active.reshape(-1)[5::37] = 0
    return rays, geom, _bounds(*geom), t_min, active


def _huge_grouped_case():
    """``group_scene`` of the huge scene and a mid-frame lane state."""
    eng, state = _mid_frame(rt.DEFAULT)
    sorted_params, groups = pseg.group_scene(eng.sphere_params)
    return (tuple(state[4:10]), sorted_params[:4], groups, eng.t_min,
            state[3])


@pytest.fixture(scope="module")
def grouped_cases():
    return {"planted_ties": _planted_grouped_case(),
            "huge_mid_frame": _huge_grouped_case()}


@pytest.mark.parametrize("case", ["planted_ties", "huge_mid_frame"])
@pytest.mark.parametrize("k", GROUPED_SPLITS)
def test_grouped_split_is_the_plain_grouped(grouped_cases, case, k):
    rays, geom, groups, t_min, active = grouped_cases[case]
    want = pseg.segment_closest_hit_grouped_reference(
        rays, *geom, groups, t_min, active)
    got, (skipped, in_all) = chk.grouped_split(rays, *geom, groups, t_min,
                                               active, k)
    assert not any(chk.bit_diff(got, want).values())
    assert int(want[0].sum()) > 0 and 0 <= skipped <= in_all
    n_warps = -(-rays[0].numel() // (32 // k))
    assert in_all <= n_warps * groups[0].numel()
    if case == "planted_ties":
        # the earlier copy of every planted pair wins; the inactive row
        # (a whole block) misses
        kind = np.arange(rays[0].numel()) % 11
        on = (kind < 9) & (active.reshape(-1).numpy() > 0)
        np.testing.assert_array_equal(
            want[2].reshape(-1).numpy()[on],
            np.array([p[0] for p in chk.TIE_PAIRS])[kind[on]])
        assert int(got[0][3].sum()) == 0
        assert bool((got[1][3] == float(BIG)).all())


@pytest.mark.parametrize("n,ix_k,grouped_k", [
    (1 << 15, 8, 4), (131072, 2, 1), (960000, 1, 1), (1 << 20, 1, 1)])
def test_split_pickers_of_the_tspace_kernels(n, ix_k, grouped_k):
    """The K each wrapper launches with on an H100's 132 SMs: closest_hit's
    picker aimed at the target each kernel's own K sweep chose (the
    grouped kernel's at most 16)."""
    for target in (pseg.IX_THREADS_PER_SM, pseg.GROUPED_THREADS_PER_SM):
        assert target in (pseg.CH_THREADS_PER_SM, pseg.SPLIT_THREADS_PER_SM)
    assert pseg.closest_hit_split(n, H100_SMS,
                                  pseg.IX_THREADS_PER_SM) == ix_k
    assert min(pseg.closest_hit_split(n, H100_SMS,
                                      pseg.GROUPED_THREADS_PER_SM),
               pseg.GROUPED_SPLITS[-1]) == grouped_k
    assert pseg.GROUPED_SPLITS == GROUPED_SPLITS


def test_split_keyword_checked(tspace_cases, grouped_cases):
    """``split=`` forces the K of both kernels (for measuring); on the CPU
    every K is the plain version, and a K a kernel lacks raises (the
    grouped kernel splits a group of 16: K = 32 is refused)."""
    args = tspace_cases["tspace_ties_and_grazes"]
    want = pint.closest_hit(*args)
    for bad in (3, 64):
        with pytest.raises(ValueError, match="split"):
            closest_hit_cuda(*args, split=bad)
    for k in (1, 32):
        assert _same_bits(closest_hit_cuda(*args, split=k), want)
    rays, geom, groups, t_min, active = grouped_cases["planted_ties"]
    want_g = pseg.segment_closest_hit_grouped_reference(
        rays, *geom, groups, t_min, active)
    for bad in (32, 5):
        with pytest.raises(ValueError, match="split"):
            pseg.segment_closest_hit_grouped(rays, *geom, groups, t_min,
                                             active=active, split=bad)
    for k in (1, 16):
        got = pseg.segment_closest_hit_grouped(rays, *geom, groups, t_min,
                                               active=active, split=k)
        assert not any(chk.bit_diff(got, want_g).values())
