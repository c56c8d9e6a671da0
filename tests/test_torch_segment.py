"""PyTorch port vs the JAX package: closest hit and the winner lookup.

The port's ``segment_closest_hit`` (on the CPU: the plain PyTorch version
of the CUDA kernel) against the JAX ``segment_closest_hit`` (the Pallas
kernel in interpret mode), same rays made with numpy from a seed.

Tolerances, and why. XLA:CPU may contract ``b*b - a*c`` and the dot
products into fused multiply-adds (and does so differently from build to
build); the port rounds every product and sum separately, as its CUDA
kernel does. So:
  * hit and sphere index are equal on active lanes, but for at most 1e-3
    of them (a grazing or t_min knife edge), and there t agrees to 1e-4
    or one side missed;
  * on ordinary spheres t agrees to 2e-6 at the median, 1e-4 at the 99th
    percentile and 1e-3 everywhere (measured: 4e-7, 2e-5 and 1.3e-4; the
    tail is grazing incidence, where the discriminant cancels);
  * on the r = 1000 ground sphere the near root ``-b - sqrt(b*b - a*c)``
    cancels catastrophically -- one ulp of any product moves the JAX value
    by percents with the contraction (measured: 99th percentile up to
    0.02, maximum 0.06) -- so there the port's t is held to a float64
    NumPy witness of the same rays and the same sphere, which depends on
    neither float32 arithmetic: median error 1e-4, 90th percentile 0.02,
    99th 0.2 (measured: 6e-6, 1.4e-5 and 2.3e-5; hit and index stay held
    to JAX).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginoneweekend_tpu.models import scene as jscene
from raytracinginoneweekend_tpu.ops import pallas_segment as jseg
from raytracinginoneweekend_tpu_torch.models import scene as pscene
from raytracinginoneweekend_tpu_torch.ops import cuda_segment as pseg

# The suite runs in several worker processes that share the machine's cores.
# PyTorch's default, one intra-op thread per core in EVERY worker,
# oversubscribes them (measured: the same small frames take five times as
# long with six workers); the planes here are small, two threads are plenty.
torch.set_num_threads(2)

R = 32
N = R * 128
T_MIN = 0.008


def _unit(g, n):
    v = g.normal(size=(3, n)).astype(np.float32)
    return v / np.linalg.norm(v, axis=0)


def _rays(scene_name, seed=0):
    """Half camera-like rays towards the scene, half restarts from the
    ground sphere's surface (origin on the surface to f32 rounding)."""
    g = np.random.default_rng(seed)
    h = N // 2
    if scene_name == "huge":
        eye, box, gc, gr = (-4, 3.2, 5), 11.0, (0, -1000.125, 0), 1000.0
    else:
        eye, box, gc, gr = (0, 0, 0), 1.5, (0, -100.5, -1), 100.0
    o1 = (np.array(eye, np.float32)[:, None]
          + g.normal(size=(3, h)).astype(np.float32) * 0.03)
    tgt = np.stack([g.uniform(-box, box, h), g.uniform(0, 2, h) - (
        0 if scene_name == "huge" else 1), g.uniform(-box, box, h)])
    d1 = (tgt.astype(np.float32) - o1) * g.uniform(0.5, 2, h).astype(
        np.float32)
    n = np.stack([g.uniform(-.011, .011, h), np.ones(h),
                  g.uniform(-.011, .011, h)]).astype(np.float32)
    n /= np.linalg.norm(n, axis=0)
    o2 = np.array(gc, np.float32)[:, None] + n * np.float32(gr)
    d2 = n + _unit(g, h)
    o = np.concatenate([o1, o2], 1).reshape(3, R, 128)
    d = np.concatenate([d1, d2], 1).reshape(3, R, 128)
    active = g.random((R, 128)) < 0.85
    active[:8] = False  # one whole JAX kernel block inactive
    return o, d, active


def _both(scene_name, o, d, active, t_min=T_MIN):
    jsc = {"huge": lambda: jscene.huge_scene(0),
           "simple": jscene.simple_scene_cuda}[scene_name]()
    psc = {"huge": lambda: pscene.huge_scene(0, device="cpu"),
           "simple": lambda: pscene.simple_scene_cuda(device="cpu")
           }[scene_name]()
    jp = jseg.sphere_params_from_scene(jsc)
    pp = pseg.sphere_params_from_scene(psc)
    for a, b in zip(pp, jp):  # the pre-gathered tables are equal
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jact = None if active is None else jnp.asarray(active)
    pact = None if active is None else torch.from_numpy(active)
    want = jseg.segment_closest_hit(
        tuple(jnp.asarray(x) for x in (*o, *d)), *jp[:4], t_min, rows=8,
        active=jact)
    got = pseg.segment_closest_hit(
        tuple(torch.from_numpy(x.copy()) for x in (*o, *d)), *pp[:4],
        t_min, active=pact)
    radii = np.asarray(jp[3])
    return [g.numpy() for g in got], [np.asarray(w) for w in want], radii


def _witness_t(scene_name, o, d, sb, t_min=T_MIN):
    """float64 t of each lane's ray against the sphere ``sb`` (the nearest
    root past t_min), from the same float32 rays and sphere table."""
    psc = {"huge": lambda: pscene.huge_scene(0, device="cpu"),
           "simple": lambda: pscene.simple_scene_cuda(device="cpu")
           }[scene_name]()
    cx, cy, cz, r = (p.numpy().astype(np.float64) for p in
                     pseg.sphere_params_from_scene(psc)[:4])
    o64, d64 = o.astype(np.float64), d.astype(np.float64)
    oc = o64 - np.stack([cx[sb], cy[sb], cz[sb]])
    a = (d64 * d64).sum(0)
    b = (oc * d64).sum(0)
    c = (oc * oc).sum(0) - r[sb] ** 2
    sq = np.sqrt(np.maximum(b * b - a * c, 0.0))
    near, far = (-b - sq) / a, (-b + sq) / a
    return np.where(near > t_min, near, far)


def _check(got, want, radii, active, witness=None):
    """``witness``: the float64 t of the port's sphere on each lane
    (``_witness_t``), which the ground class is held to; without it (the
    callers in other files) the ground class is held to JAX."""
    (gh, gt, gs), (wh, wt, ws) = got, want
    act = np.ones_like(gh, bool) if active is None else active
    assert gh.dtype == np.int32 and gt.dtype == np.float32
    assert gs.dtype == np.int32
    # the port's convention on inactive lanes
    assert (gh[~act] == 0).all() and (gs[~act] == 0).all()
    assert (gt[~act] == np.float32(1e30)).all()
    both = act & (gh > 0) & (wh > 0)
    differ = act & ((gh != wh) | (both & (gs != ws)))
    assert differ.sum() <= 1e-3 * act.sum(), int(differ.sum())
    swapped = both & (gs != ws)
    assert np.allclose(gt[swapped], wt[swapped], rtol=1e-4)
    agree = both & ~swapped
    assert agree.sum() > 0.2 * act.sum()
    rel = np.abs(gt - wt) / np.abs(wt)
    # (index by agreeing lanes only: JAX leaves sb of a skipped block stale)
    big = np.abs(radii[np.where(agree, ws, 0)]) >= 100.0
    small = agree & ~big
    assert np.median(rel[small]) <= 2e-6
    assert np.percentile(rel[small], 99) <= 1e-4
    assert rel[small].max() <= 1e-3
    ground = agree & big
    if ground.any():
        ref = wt if witness is None else witness
        rel_w = np.abs(gt - ref) / np.abs(ref)
        assert np.median(rel_w[ground]) <= 1e-4
        assert np.percentile(rel_w[ground], 90) <= 0.02
        assert np.percentile(rel_w[ground], 99) <= 0.2


@pytest.mark.parametrize("scene_name", ["simple", "huge"])
def test_segment_closest_hit_matches_jax(scene_name):
    o, d, active = _rays(scene_name)
    got, want, radii = _both(scene_name, o, d, active)
    _check(got, want, radii, active, _witness_t(scene_name, o, d, got[2]))


def test_segment_closest_hit_all_lanes_active_when_no_mask():
    o, d, _ = _rays("huge", seed=1)
    got, want, radii = _both("huge", o, d, None)
    _check(got, want, radii, None, _witness_t("huge", o, d, got[2]))


def test_negative_radius_is_hit_from_inside():
    """Rays from inside the hollow glass (sphere 4, radius -0.499 inside
    sphere 3) hit the inner shell first: far root, negative radius."""
    g = np.random.default_rng(2)
    c = np.array([-1.0, 0.0, -1.0], np.float32).reshape(3, 1)
    o = (c + _unit(g, N) * 0.2).reshape(3, R, 128).astype(np.float32)
    d = _unit(g, N).reshape(3, R, 128)
    got, want, radii = _both("simple", o, d, None)
    assert (got[0] == 1).all() and (got[2] == 4).all()
    assert (want[2] == 4).all()
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)


@pytest.mark.parametrize("t_min", [0.008, 0.5, 5.0])
def test_t_min_window(t_min):
    """Roots at or below t_min are not hits; the far root takes over."""
    o, d, active = _rays("simple", seed=3)
    got, want, radii = _both("simple", o, d, active, t_min=t_min)
    a = (d * d).sum(0)
    hit = got[0] > 0
    assert (got[1][hit] > t_min * (1 - 1e-5)).all()
    assert hit.sum() > 0
    differ = active & (got[0] != want[0])
    assert differ.sum() <= 1e-3 * active.sum()
    assert a.min() > 0


def test_resolve_params_bit_exact():
    jsc = jscene.huge_scene(0)
    psc = pscene.huge_scene(0, device="cpu")
    jp = jseg.sphere_params_from_scene(jsc)
    pp = pseg.sphere_params_from_scene(psc)
    s_b = np.random.default_rng(4).integers(
        0, jsc.num_spheres, size=(R, 128), dtype=np.int32)
    want = jseg.resolve_params(jnp.asarray(s_b), jp)
    got = pseg.resolve_params(torch.from_numpy(s_b), pp)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    table = pseg.sphere_table(pp)
    assert tuple(table.shape) == (jsc.num_spheres, 10)
    assert table.dtype == torch.float32 and table.is_contiguous()
    np.testing.assert_array_equal(table[:, 4].numpy(),
                                  np.asarray(jp[4], np.float32))


def test_unported_kernel_layouts_raise():
    """Every layout is carried (the mxu, sorted and grouped ones:
    tests/test_torch_segment_variants.py); what is refused is a call that
    does not give a layout what it needs: the sphere-group kernel takes
    the sorted, padded table of ``group_scene``, and the sorted kernel a
    sort state, so the dispatcher points to its wrapper."""
    o, d, _ = _rays("simple")
    rays = tuple(torch.from_numpy(x.copy()) for x in (*o, *d))
    pp = pseg.sphere_params_from_scene(pscene.simple_scene_cuda("cpu"))
    with pytest.raises(ValueError, match="group_scene"):
        pseg.trace_segment(rays, pp, T_MIN, group_params=(None,) * 4)
    with pytest.raises(ValueError, match="segment_closest_hit_sorted"):
        pseg.closest_hit_planar(rays, *pp[:4], T_MIN, kernel="sorted")
    for kernel in ("sublane", "mxu"):
        got = pseg.closest_hit_planar(rays, *pp[:4], T_MIN, kernel=kernel)
        assert got[0].shape == (R, 128)
