"""PyTorch port vs the JAX package: the (N, 3) closest hit and its gradient.

``ops/intersect.closest_hit`` is the plain PyTorch version of the CUDA
kernel behind ``ops/cuda_intersect.closest_hit_cuda``; on CPU tensors the
wrapper runs it. Both go against the JAX ``intersect.closest_hit`` and
against the Pallas kernel ``closest_hit_pallas`` in interpret mode, on rays
made with numpy from a seed.

Tolerances, and why. XLA:CPU may contract ``b*b - a*c`` and the dot
products into fused multiply-adds; the port rounds every product and sum
separately, as its CUDA kernel does (-fmad=false). So:
  * hit and sphere index are equal but for at most 1e-3 of rays (a grazing
    or t_min knife edge);
  * on ordinary spheres t agrees to 2e-6 at the median and 1e-3 everywhere
    (the tail is grazing incidence, where the discriminant cancels);
  * on a ground sphere (|r| >= 100) the near root cancels catastrophically,
    so one ulp of any product (a contraction, a square root not rounded to
    nearest) moves t by percents; there the port's t is held to a float64
    NumPy witness of the same rays and the same sphere, which depends on
    neither float32 arithmetic: median 1e-4, 90th percentile 0.02, 99th
    0.2 (measured: 5e-6, 6e-5 and 4e-4) -- the class
    tests/test_torch_segment.py holds the planar kernel's plain version
    to. Hit and index stay held to JAX.
The plain version's square root is rounded to nearest on the CPU
(``ops/math3.sqrt_rn``; torch.sqrt there is not, and has rounded
otherwise on its first call in a loaded process), so repeated calls give
the same bits.
Gradients: rtol 2e-3 / atol 1e-5 against ``jax.grad`` of the JAX
``closest_hit_diff`` and against autograd through the plain forward (the
JAX package's own tolerance for its custom VJP).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginoneweekend_tpu.models import scene as jscene
from raytracinginoneweekend_tpu.ops import intersect as jint
from raytracinginoneweekend_tpu.ops.pallas_intersect import closest_hit_pallas
from raytracinginoneweekend_tpu_torch.ops import intersect as pint
from raytracinginoneweekend_tpu_torch.ops.cuda_intersect import (
    closest_hit_cuda)

T_MIN = 0.008


def _scene_geometry(name):
    if name == "negative":
        # concentric shells, the inner ones hollow (negative radius, Q10)
        g = np.random.default_rng(5)
        centers = g.normal(size=(12, 3)).astype(np.float32) * 2
        radii = g.uniform(0.3, 1.0, size=12).astype(np.float32)
        centers[6:] = centers[:6]
        radii[6:] = -0.9 * radii[:6]
        return centers, radii
    sc = {"simple": jscene.simple_scene_cuda,
          "huge": lambda: jscene.huge_scene(0)}[name]()
    return np.asarray(sc.centers), np.asarray(sc.radii)


def _rays(name, n, seed=0):
    """Camera-like rays, rays from inside the scene's box, and restarts
    from the ground sphere's surface (origin on the surface to rounding)."""
    g = np.random.default_rng(seed)
    o = (g.normal(size=(n, 3)) * 2).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    if name == "negative":
        # half the rays start inside a hollow shell: the far root of the
        # negative-radius sphere is the first hit
        centers, _ = _scene_geometry(name)
        k = n // 2
        o[:k] = centers[g.integers(0, 6, size=k)] + (
            g.normal(size=(k, 3)) * 0.05).astype(np.float32)
    else:
        gc, gr = ((0, -1000.125, 0), 1000.0) if name == "huge" else (
            (0, -100.5, -1), 100.0)
        k = n // 3
        nrm = np.stack([g.uniform(-.011, .011, k), np.ones(k),
                        g.uniform(-.011, .011, k)], 1).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        o[:k] = np.array(gc, np.float32) + nrm * np.float32(gr)
        v = g.normal(size=(k, 3)).astype(np.float32)
        d[:k] = nrm + v / np.linalg.norm(v, axis=1, keepdims=True)
    return o, d


def _witness_t(o, d, centers, radii, idx):
    """float64 t of each ray against the sphere ``idx`` (the nearest root
    past T_MIN), from the same float32 rays and spheres."""
    oc = o.astype(np.float64) - centers[idx].astype(np.float64)
    d64 = d.astype(np.float64)
    a = (d64 * d64).sum(-1)
    b = (oc * d64).sum(-1)
    c = (oc * oc).sum(-1) - radii[idx].astype(np.float64) ** 2
    sq = np.sqrt(np.maximum(b * b - a * c, 0.0))
    near, far = (-b - sq) / a, (-b + sq) / a
    return np.where(near > T_MIN, near, far)


def _check(got, want, radii, witness=None):
    """``witness``: the float64 t of the port's sphere for each ray
    (``_witness_t``), which the ground class is held to; without it (the
    callers in other files) the ground class is held to JAX."""
    (gt, gi, gh), (wt, wi, wh) = got, want
    assert gt.dtype == np.float32 and gi.dtype == np.int32
    assert gh.dtype == np.bool_
    assert (gt[~gh] == np.float32(1e30)).all() and (gi[~gh] == 0).all()
    both = gh & wh
    differ = (gh != wh) | (both & (gi != wi))
    assert differ.sum() <= max(1, 1e-3 * gh.size), int(differ.sum())
    agree = both & ~differ
    assert agree.sum() > 0.2 * gh.size
    rel = np.abs(gt - wt) / np.abs(wt)
    big = np.abs(radii[np.where(agree, wi, 0)]) >= 100.0
    small = agree & ~big
    assert np.median(rel[small]) <= 2e-6
    assert rel[small].max() <= 1e-3
    ground = agree & big
    if ground.any():
        ref = wt if witness is None else witness
        rel_w = np.abs(gt - ref) / np.abs(ref)
        assert np.median(rel_w[ground]) <= 1e-4
        assert np.percentile(rel_w[ground], 90) <= 0.02
        assert np.percentile(rel_w[ground], 99) <= 0.2


@pytest.mark.parametrize("reference", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("wrapper", ["plain", "cuda_wrapper_on_cpu"])
@pytest.mark.parametrize("scene", ["simple", "huge", "negative"])
def test_closest_hit_matches_jax(scene, wrapper, reference):
    centers, radii = _scene_geometry(scene)
    n = 4096 + 7 if scene == "huge" else 600  # not a multiple of any block
    o, d = _rays(scene, n, seed=3)
    jargs = tuple(jnp.asarray(x) for x in (o, d, centers, radii))
    if reference == "jnp":
        want = jint.closest_hit(*jargs, T_MIN)
    else:
        want = closest_hit_pallas(*jargs, T_MIN, interpret=True)
    fn = pint.closest_hit if wrapper == "plain" else closest_hit_cuda
    got = fn(*(torch.from_numpy(x.copy()) for x in (o, d, centers, radii)),
             T_MIN)
    got = [x.numpy() for x in got]
    _check(got, [np.asarray(x) for x in want], radii,
           _witness_t(o, d, centers, radii, got[1]))


@pytest.mark.parametrize("scene", ["simple", "huge", "negative"])
def test_plain_closest_hit_gives_the_same_bits_every_call(scene):
    """The port's plain closest hit on the same rays, called three times in
    one worker (twice on fresh copies, once on tensors that share the
    NumPy buffers), gives the same bits each time."""
    centers, radii = _scene_geometry(scene)
    o, d = _rays(scene, 4096 + 7 if scene == "huge" else 600, seed=3)
    arrays = (o, d, centers.copy(), radii.copy())  # all writable
    runs = [pint.closest_hit(*(torch.from_numpy(x.copy()) for x in arrays),
                             T_MIN) for _ in range(2)]
    runs.append(pint.closest_hit(*(torch.from_numpy(x) for x in arrays),
                                 T_MIN))
    for got in runs[1:]:
        for a, b in zip(runs[0], got):
            assert torch.equal(a, b)


def _single(fn, o, d, centers, radii, **kw):
    t, idx, hit = fn(torch.tensor([o], dtype=torch.float32),
                     torch.tensor([d], dtype=torch.float32),
                     torch.tensor(centers, dtype=torch.float32),
                     torch.tensor(radii, dtype=torch.float32), T_MIN, **kw)
    return float(t[0]), int(idx[0]), bool(hit[0])


CASES = {
    # name: (origin, direction, centers, radii, hit, t, idx)
    "head_on": ([0, 0, 0], [0, 0, -1], [[0, 0, -2]], [1.0], True, 1.0, 0),
    "miss": ([0, 0, 0], [0, 1, 0], [[0, 0, -2]], [1.0], False, 1e30, 0),
    "far_root_when_inside": ([0, 0, -2], [0, 0, -1], [[0, 0, -2]], [1.0],
                             True, 1.0, 0),
    "t_min_window": ([0, 0, -1.001], [0, 0, -1], [[0, 0, -2]], [1.0], True,
                     1.999, 0),
    "tie_keeps_earliest": ([0, 0, 0], [0, 0, -1],
                           [[0, 0, -5], [0, 0, -3], [0, 0, -3]],
                           [1.0, 1.0, 1.0], True, 2.0, 1),
    "negative_radius": ([0, 0, 0], [0, 0, -1], [[0, 0, -2]], [-1.0], True,
                        1.0, 0),
    "non_unit_direction": ([0, 0, 0], [0, 0, -4], [[0, 0, -2]], [1.0], True,
                           0.25, 0),
}


@pytest.mark.parametrize("fn", [pint.closest_hit, closest_hit_cuda],
                         ids=["plain", "cuda_wrapper_on_cpu"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_closest_hit_cases(case, fn):
    o, d, centers, radii, want_hit, want_t, want_idx = CASES[case]
    t, idx, hit = _single(fn, o, d, centers, radii)
    assert hit == want_hit and idx == want_idx
    assert np.isclose(t, want_t, rtol=1e-4)


def test_streamed_blocks_match_single_block():
    g = np.random.default_rng(7)
    centers = torch.from_numpy(g.normal(size=(37, 3)).astype(np.float32) * 3)
    radii = torch.from_numpy(g.uniform(0.2, 1.0, size=37).astype(np.float32))
    o = torch.from_numpy(g.normal(size=(64, 3)).astype(np.float32) * 0.1)
    d = torch.from_numpy(g.normal(size=(64, 3)).astype(np.float32))
    a = pint.closest_hit(o, d, centers, radii, T_MIN, sphere_block=512)
    b = pint.closest_hit(o, d, centers, radii, T_MIN, sphere_block=8)
    for x, y in zip(a, b):  # the same operations per candidate: bit-equal
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_hit_surface_matches_jax_and_negative_radius_flips_normal():
    centers, radii = _scene_geometry("negative")
    o, d = _rays("negative", 300, seed=1)
    jt, ji, jh = jint.closest_hit(*(jnp.asarray(x) for x in (
        o, d, centers, radii)), T_MIN)
    want = jint.hit_surface(jnp.asarray(o), jnp.asarray(d), jt, ji, jh,
                            jnp.asarray(centers), jnp.asarray(radii))
    pt, pi, ph = (torch.from_numpy(np.asarray(x).copy())
                  for x in (jt, ji, jh))
    tc, tr = torch.from_numpy(centers), torch.from_numpy(radii)
    got = pint.hit_surface(torch.from_numpy(o), torch.from_numpy(d), pt, pi,
                           ph, tc, tr)
    for g_, w in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    one = torch.tensor([[0.0, 0.0, 0.0]]), torch.tensor([[0.0, 0.0, -1.0]])
    c1, r1 = torch.tensor([[0.0, 0.0, -2.0]]), torch.tensor([-1.0])
    t, idx, hit = pint.closest_hit(*one, c1, r1, T_MIN)
    _, n = pint.hit_surface(*one, t, idx, hit, c1, r1)
    np.testing.assert_allclose(n[0].numpy(), [0, 0, -1], atol=1e-5)


def _grad_inputs():
    g = np.random.default_rng(11)
    centers = g.normal(size=(9, 3)).astype(np.float32) * 2
    radii = g.uniform(0.4, 1.2, size=9).astype(np.float32)
    o = g.normal(size=(40, 3)).astype(np.float32) * 0.1
    d = g.normal(size=(40, 3)).astype(np.float32)
    return o, d, centers, radii


def _torch_grads(fn, arrays):
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True)
              for a in arrays]
    t, _idx, hit = fn(*leaves)
    torch.sum(torch.where(hit, torch.sin(t), torch.zeros_like(t))).backward()
    return [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_closest_hit_diff_gradients_match_jax(use_pallas):
    arrays = _grad_inputs()

    def jloss(o, d, c, r):
        t, _idx, hit = jint.closest_hit_diff(o, d, c, r, T_MIN)
        return jnp.sum(jnp.where(hit, jnp.sin(t), 0.0))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in arrays))
    got = _torch_grads(lambda *x: pint.closest_hit_diff(
        *x, T_MIN, use_pallas=use_pallas), arrays)
    for g_, w in zip(got, want):
        assert np.abs(np.asarray(w)).max() > 0
        np.testing.assert_allclose(g_, np.asarray(w), rtol=2e-3, atol=1e-5)


def test_closest_hit_diff_matches_autograd_through_the_plain_forward():
    arrays = _grad_inputs()
    auto = _torch_grads(lambda *x: pint.closest_hit(*x, T_MIN), arrays)
    custom = _torch_grads(lambda *x: pint.closest_hit_diff(*x, T_MIN),
                          arrays)
    for a, c in zip(auto, custom):
        np.testing.assert_allclose(c, a, rtol=2e-3, atol=1e-5)


def test_closest_hit_diff_matches_finite_differences():
    def tval(cz):
        centers = torch.stack([torch.zeros(()), torch.zeros(()), cz])[None]
        t, _, _ = pint.closest_hit_diff(
            torch.zeros((1, 3)), torch.tensor([[0.0, 0.0, -1.0]]), centers,
            torch.tensor([1.0]), T_MIN)
        return t[0]

    cz = torch.tensor(-3.0, requires_grad=True)
    tval(cz).backward()
    eps = 1e-3
    with torch.no_grad():
        fd = (tval(torch.tensor(-3.0 + eps))
              - tval(torch.tensor(-3.0 - eps))) / (2 * eps)
    assert np.isclose(float(cz.grad), float(fd), rtol=1e-3)
    assert np.isclose(float(cz.grad), -1.0, rtol=1e-4)  # head-on


def test_closest_hit_diff_zeroes_misses_and_grazing_hits():
    # ray 0 misses; ray 1 is tangent to the unit sphere to rounding.
    o = torch.tensor([[0.0, 5.0, 0.0], [1.0, 0.0, 0.0]], requires_grad=True)
    d = torch.tensor([[0.0, 1.0, 0.0], [0.0, 0.0, -1.0]], requires_grad=True)
    c = torch.tensor([[0.0, 0.0, -2.0]], requires_grad=True)
    r = torch.tensor([1.0 + 1e-7], requires_grad=True)
    t, _idx, hit = pint.closest_hit_diff(o, d, c, r, T_MIN)
    torch.sum(torch.where(hit, t, torch.zeros_like(t))).backward()
    for x in (o, d, c, r):
        assert bool(torch.isfinite(x.grad).all())
    assert float(o.grad[0].abs().max()) == 0.0


@pytest.mark.parametrize("mode", ["cuda", "pinhole", "thinlens", "cpu"])
def test_closest_hit_diff_hands_the_kernel_dense_rows(mode, monkeypatch):
    """Camera modes "cuda" and "pinhole" give one origin expanded over the
    rays (stride 0); the kernel's wrapper refuses anything but dense rows,
    so closest_hit_diff(use_pallas=True) must hand it a dense copy."""
    from raytracinginoneweekend_tpu_torch.models import camera as pcam
    from raytracinginoneweekend_tpu_torch.ops import cuda_intersect, rng

    seen = []

    def strict_wrapper(o, d, c, r, t_min):
        # the CUDA branch's own demand, applied to CPU tensors
        assert o.is_contiguous() and d.is_contiguous()
        seen.append(o.shape[0])
        return pint.closest_hit(o, d, c, r, t_min)

    monkeypatch.setattr(cuda_intersect, "closest_hit_cuda", strict_wrapper)
    n = 300
    g = np.random.default_rng(2)
    cam = pcam.reference_cuda_camera(32, 24, device="cpu")
    keys = rng.ray_key((0, 1), torch.arange(n, dtype=torch.int32),
                       torch.zeros(n, dtype=torch.int32))
    u, v = (torch.from_numpy(g.uniform(size=n).astype(np.float32))
            for _ in range(2))
    o, d = pcam.camera_ray(cam, u, v, keys, mode)
    centers, radii = (torch.from_numpy(np.array(x))
                      for x in _scene_geometry("simple"))
    got = pint.closest_hit_diff(o, d, centers, radii, T_MIN, use_pallas=True)
    want = pint.closest_hit(o, d, centers, radii, T_MIN)
    assert seen == [n]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got[2].any())


def test_closest_hit_in_float64_is_the_float32_result_refined():
    """float64 rays and spheres give a float64 t (the gradient checks'
    witness runs the tiled engine so); off knife edges it is the float32
    t to float32 rounding."""
    centers, radii = _scene_geometry("simple")
    o, d = _rays("simple", 600, seed=4)
    args32 = tuple(torch.from_numpy(np.array(x))
                   for x in (o, d, centers, radii))
    t32, i32, h32 = pint.closest_hit(*args32, T_MIN)
    t64, i64, h64 = pint.closest_hit(*(x.double() for x in args32), T_MIN)
    assert t32.dtype == torch.float32 and t64.dtype == torch.float64
    assert i64.dtype == torch.int32 and h64.dtype == torch.bool
    same = h32 & h64 & (i32 == i64)
    assert same.sum() >= 0.99 * h32.sum() > 0
    small = same & (radii_abs(radii, i32) < 100.0)
    rel = ((t32.double() - t64).abs() / t64.abs())[small]
    assert rel.median() <= 2e-6 and rel.max() <= 1e-3


def radii_abs(radii, idx):
    return torch.from_numpy(np.abs(radii))[idx.to(torch.int64)]


@pytest.mark.parametrize("grad", [False, True])
def test_gather_rows_forward_stays_in_float32(grad):
    """``gather_rows``'s forward is the plain float32 gather, with or
    without autograd: no float64 tensor is made until the backward, whose
    per-row sums are ``sum_by_winner``'s (float64, rounded once)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Dtypes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else [out]):
                if isinstance(t, torch.Tensor):
                    self.seen.add(t.dtype)
            return out

    g = np.random.default_rng(0)
    table = torch.from_numpy(g.normal(size=(7, 3)).astype(np.float32))
    table.requires_grad_(grad)
    idx = torch.from_numpy(g.integers(0, 7, 4096))
    rows = torch.from_numpy(g.normal(size=(4096, 3)).astype(np.float32))
    with torch.set_grad_enabled(grad), Dtypes() as mode:
        got = pint.gather_rows(table, idx)
    assert mode.seen == {torch.float32}, mode.seen
    np.testing.assert_array_equal(got.detach().numpy(),
                                  table.detach().numpy()[idx.numpy()])
    if grad:
        got.mul(rows).sum().backward()
        np.testing.assert_array_equal(
            table.grad.numpy(), pint.sum_by_winner(idx, rows, 7).numpy())
