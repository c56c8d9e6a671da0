"""PyTorch port vs the JAX package: the silhouette boundary surrogates.

``boundary_surrogate`` and ``secondary_boundary_surrogate`` of the port
(ops/silhouette.py) against the JAX package's on seeded inputs, on the JAX
tests' own kind of small scenes: a black sphere against the sky, a
floating black occluder over a gray ground, a rough metal and a glass
sphere beside them.

Tolerances: both sides draw the same numbers (jax.random's layouts, bit for
bit, tests/test_torch_threefry_rng.py) and trace the same probe paths; they
differ by the float rounding of sin/cos/sqrt/log in two libms and of the
closest hit's two gradient forms (autograd through the root in JAX, the
implicit-function backward here). So each gradient element within 1e-4 of
its leaf's largest |gradient| (measured: ~1e-7 of it) and the primary
term's value within rtol 1e-4; the secondary term's value is a sum that
cancels to ~1e-8 and is not compared. The detached scene, the probe
traces and the angle/lens/candidate draws are what a wrong port would
move; every case asserts a nonzero gradient first.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginoneweekend_tpu.config import DEFAULT as JDEFAULT
from raytracinginoneweekend_tpu.models import camera as jcamera
from raytracinginoneweekend_tpu.models.scene import (DIELECTRIC, LAMBERT,
                                                     METAL, Scene)
from raytracinginoneweekend_tpu.ops import silhouette as jsil
from raytracinginoneweekend_tpu_torch import config as pconfig
from raytracinginoneweekend_tpu_torch import optim as poptim
from raytracinginoneweekend_tpu_torch.models import camera as pcamera
from raytracinginoneweekend_tpu_torch.models import scene as pscene
from raytracinginoneweekend_tpu_torch.ops import silhouette as psil
from raytracinginoneweekend_tpu_torch.ops import threefry as ptf

torch.set_num_threads(2)

W, H = 24, 16


def _scene(centers, radii, mtype, albedo, fuzz, ior) -> Scene:
    n = len(radii)
    return Scene(
        centers=jnp.array(centers, jnp.float32),
        radii=jnp.array(radii, jnp.float32),
        material_index=jnp.arange(n, dtype=jnp.int32),
        mtype=jnp.array(mtype, jnp.int32),
        albedo=jnp.array(albedo, jnp.float32),
        fuzz=jnp.array(fuzz, jnp.float32),
        ior=jnp.array(ior, jnp.float32))


def black_and_glass():
    """A black lambert sphere (tests/test_silhouette.py's) and a glass one
    beside it (the dielectric deep inside probe)."""
    return _scene([[0.0, 0.0, -1.5], [0.6, 0.2, -2.5]], [0.5, 0.4],
                  [LAMBERT, DIELECTRIC], [[0, 0, 0], [1, 1, 1]], [0, 0],
                  [1.0, 1.5])


def shadow_mix():
    """The floating-occluder shadow config (ground + black occluder) with a
    rough metal and a glass sphere in view."""
    return _scene([[0.0, -100.5, -1.0], [0.0, 1.5, -1.0], [0.5, 0.0, -2.0],
                   [-0.6, 0.1, -1.8]], [100.0, 0.4, 0.5, 0.45],
                  [LAMBERT, LAMBERT, METAL, DIELECTRIC],
                  [[0.5, 0.5, 0.5], [0, 0, 0], [0.8, 0.7, 0.6], [1, 1, 1]],
                  [0, 0, 0.3, 0], [1, 1, 1, 1.5])


def _port_scene(js):
    return pscene.scene_from_numpy(*map(np.asarray, js), device="cpu")


def _cams(aperture=0.1):
    jc = jcamera.make_camera((0, 0.3, 0.5), (0, 0, -1.5), (0, 1, 0), W / H,
                             60.0, aperture, 1.5)
    return jc, pcamera.camera_from_numpy(*map(np.asarray, jc), device="cpu")


def _grads_close(want: dict, got: dict, names, share: float = 1e-4):
    """Every element within ``share`` of its leaf's largest |gradient|."""
    for name in names:
        w, g = np.asarray(want[name]), got[name]
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(g, w, rtol=0, atol=share * scale,
                                   err_msg=name)


def _port_value_and_grads(fn, ps, names):
    leaves = {k: getattr(ps, k).clone().requires_grad_(True) for k in names}
    value = fn(ps._replace(**leaves))
    value.backward()
    return float(value.detach()), {
        k: (v.grad.numpy() if v.grad is not None
            else np.zeros(tuple(v.shape), np.float32))
        for k, v in leaves.items()}


def test_constants_equal():
    for name in ("TAG_EDGE_PHI", "TAG_EDGE_PROBE", "TAG_EDGE_LENS",
                 "TAG_EDGE2_VERTEX", "TAG_EDGE2_SPHERE", "TAG_EDGE2_PHI",
                 "TAG_EDGE2_PROBE", "TAG_EDGE2_DEPTH", "PROBE_DIEL_FRAC",
                 "PROBE_RR_QCAP"):
        assert getattr(psil, name) == getattr(jsil, name), name
    opts = psil._probe_options(pconfig.DEFAULT)
    assert opts.rr_terminate and not pconfig.DEFAULT.rr_terminate
    assert psil._probe_options(opts) is opts


@pytest.mark.parametrize("mode", ["pinhole", "thinlens", "cuda", "cpu"])
def test_silhouette_frame_and_projection_match_jax(mode):
    """The analytic silhouette, its frame and the film projection (with
    per-sample lens offsets where the mode takes them), float for float."""
    g = np.random.default_rng(1)
    c = g.normal(0, 1, (3, 3)).astype(np.float32) - [0, 0, 4]
    r = np.array([0.5, -0.7, 0.3], np.float32)  # negative: the same edge
    phis = g.uniform(0, 6.3, (3, 7)).astype(np.float32)
    eye = g.normal(0, 0.05, (3, 7, 3)).astype(np.float32)
    jc, pc = _cams()
    want = jsil.silhouette_frame(jnp.asarray(c), jnp.asarray(r),
                                 jnp.asarray(eye), jnp.asarray(phis))
    got = psil.silhouette_frame(torch.from_numpy(c), torch.from_numpy(r),
                                torch.from_numpy(eye), torch.from_numpy(phis))
    for w, x in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(
                        (got[0], got[1], tuple(got[2])))):
        np.testing.assert_allclose(np.asarray(x), np.asarray(w), atol=2e-6)
    off = eye if mode in ("thinlens", "cpu") else None
    jw = jsil.project_to_screen(jc, want[0], mode,
                                None if off is None else jnp.asarray(off))
    pw = psil.project_to_screen(pc, got[0], mode,
                                None if off is None else torch.from_numpy(off))
    np.testing.assert_allclose(pw[0].numpy(), np.asarray(jw[0]), atol=2e-5)
    np.testing.assert_array_equal(pw[1].numpy(), np.asarray(jw[1]))
    jo, jd = jsil._probe_directions(jc, jw[0], mode,
                                    None if off is None else jnp.asarray(off))
    po, pd = psil._probe_directions(pc, pw[0], mode,
                                    None if off is None
                                    else torch.from_numpy(off))
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=2e-5)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), atol=2e-5)


@pytest.mark.parametrize("sample", ["unit", "ball"])
def test_lobe_direction_density_matches_jax(sample):
    g = np.random.default_rng(2)
    w = g.normal(size=(4000, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    axis = g.normal(size=(4000, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    f = g.uniform(0.05, 1.0, 4000).astype(np.float32)
    want = np.asarray(jsil.lobe_direction_density(
        jnp.asarray(w), jnp.asarray(axis), jnp.asarray(f), sample))
    got = psil.lobe_direction_density(torch.from_numpy(w),
                                      torch.from_numpy(axis),
                                      torch.from_numpy(f), sample).numpy()
    assert (want > 0).mean() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


BOUNDARY_CASES = {
    "pinhole": dict(mode="pinhole"),
    "thinlens": dict(mode="thinlens"),
    "cuda": dict(mode="cuda"),
    "cpu": dict(mode="cpu"),
    "cpu_central_ablation": dict(mode="cpu", _cpu_central_ablation=True),
}


@pytest.mark.parametrize("case", sorted(BOUNDARY_CASES))
def test_boundary_surrogate_matches_jax(case):
    """Value and gradient w.r.t. centers and radii, in every camera mode
    (thin lens and the quirk-Q2 lens integrate over the aperture)."""
    kw = dict(BOUNDARY_CASES[case])
    mode = kw.pop("mode")
    js = black_and_glass()
    jc, pc = _cams()
    cot = np.random.default_rng(0).normal(size=(W * H, 3)).astype(np.float32)
    names = ("centers", "radii")

    def jf(params):
        return jsil.boundary_surrogate(
            js._replace(**params), jc, mode, jnp.asarray(cot), W, H,
            jax.random.key(5), 4, JDEFAULT, n_angles=16, **kw)

    wv, wg = jax.value_and_grad(jf)({k: getattr(js, k) for k in names})
    gv, gg = _port_value_and_grads(
        lambda s: psil.boundary_surrogate(
            s, pc, mode, torch.from_numpy(cot), W, H, ptf.key_words(5), 4,
            pconfig.DEFAULT, n_angles=16, **kw),
        _port_scene(js), names)
    np.testing.assert_allclose(gv, float(wv), rtol=1e-4)
    _grads_close(wg, gg, names)


@functools.lru_cache(maxsize=None)
def _secondary(vertex_depth):
    js = shadow_mix()
    jc, pc = _cams(aperture=0.0)
    g = np.random.default_rng(0)
    ids = g.permutation(W * H)[:200].astype(np.int32)
    cot = g.normal(size=(200, 3)).astype(np.float32)
    names = ("centers", "radii", "albedo", "ior")

    def jf(params):
        return jsil.secondary_boundary_surrogate(
            js._replace(**params), jc, "pinhole", jnp.asarray(cot),
            jnp.asarray(ids), W, H, jax.random.key(5), 4, JDEFAULT,
            n_angles=8, n_spheres=2, vertex_depth=vertex_depth)

    _, wg = jax.value_and_grad(jf)({k: getattr(js, k) for k in names})
    _, gg = _port_value_and_grads(
        lambda s: psil.secondary_boundary_surrogate(
            s, pc, "pinhole", torch.from_numpy(cot), torch.from_numpy(ids),
            W, H, ptf.key_words(5), 4, pconfig.DEFAULT, n_angles=8,
            n_spheres=2, vertex_depth=vertex_depth),
        _port_scene(js), names)
    return wg, gg


@pytest.mark.parametrize("vertex_depth", [0, 1])
def test_secondary_boundary_surrogate_matches_jax(vertex_depth):
    """The one-bounce term at the first hit and one scatter step deeper
    (the attached prefix walk): gradients w.r.t. centers and radii; the
    term reaches neither albedo nor ior (zero on both sides)."""
    wg, gg = _secondary(vertex_depth)
    _grads_close(wg, gg, ("centers", "radii"))
    for name in ("albedo", "ior"):
        assert not np.asarray(wg[name]).any() and not gg[name].any(), name


def test_interior_ad_is_blind_and_the_boundary_term_is_not():
    """The port's counterpart of the JAX package's control
    (tests/test_silhouette.py): on the black sphere against the sky the
    loss gradient w.r.t. center and radius is EXACTLY zero without the
    boundary term, and nonzero and finite with it."""
    js = _scene([[0.0, 0.0, -1.5]], [0.5], [LAMBERT], [[0, 0, 0]], [0],
                [1.0])
    ps = _port_scene(js)
    _jc, pc = _cams(aperture=0.0)
    ids = torch.arange(W * H, dtype=torch.int32)
    target = torch.zeros((W * H, 3))

    def grads(boundary):
        params = poptim.params_from_scene(ps, ("centers", "radii"))
        loss = poptim.render_loss(
            params, ps, pc, target, ids, ptf.key_words(3), width=W,
            height=H, spp=2, max_depth=2, camera_mode="pinhole",
            options=pconfig.DEFAULT, boundary_samples=boundary)
        loss.backward()
        return {k: v.grad.numpy() for k, v in params.items()}

    g0 = grads(0)
    assert not g0["centers"].any() and not g0["radii"].any()
    g1 = grads(64)
    assert np.isfinite(g1["centers"]).all() and np.isfinite(g1["radii"]).all()
    assert np.abs(g1["radii"]).max() > 0 and np.abs(g1["centers"]).max() > 0
