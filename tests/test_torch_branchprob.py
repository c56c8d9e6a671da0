"""PyTorch port vs the JAX package: the delta-lobe surrogate.

``branch_probability_surrogate`` of the port (ops/branchprob.py) -- the
Russian-roulette branch-flip term and the direction-sweep edge term with
its refract chains and reflection arms -- against the JAX package's on
seeded inputs, on the JAX tests' kind of small scenes: a lone glass sphere
(the pure RR term), a perfect mirror ground with a black occluder (the
sweep), and a mix of glass, rough metal and a black occluder.

Tolerances as tests/test_torch_silhouette.py's, for the same reason (the
same draws and paths, two libms): each gradient element within 1e-4 of its
leaf's largest |gradient| (measured: ~1e-6 of it), the value within rtol
1e-4. One case is looser, 2e-3 of the largest |gradient|: with
``sweep_redraws`` the re-walked lanes take arccos of cosines near 1 (a lane
almost on a cone's axis), where one ulp of a camera ray moves the angle by
~1e-4 rad; XLA:CPU contracts the camera ray's multiply-adds, and moving the
port's own camera by one ulp moves its ior gradient there by 1.8e-3 of the
largest (measured; port against JAX 7.5e-4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginoneweekend_tpu.config import DEFAULT as JDEFAULT
from raytracinginoneweekend_tpu.config import REFERENCE_CUDA as JREFCUDA
from raytracinginoneweekend_tpu.models import camera as jcamera
from raytracinginoneweekend_tpu.models.scene import (DIELECTRIC, LAMBERT,
                                                     METAL)
from raytracinginoneweekend_tpu.ops import branchprob as jbp
from raytracinginoneweekend_tpu_torch import config as pconfig
from raytracinginoneweekend_tpu_torch import optim as poptim
from raytracinginoneweekend_tpu_torch.models import camera as pcamera
from raytracinginoneweekend_tpu_torch.ops import branchprob as pbp
from raytracinginoneweekend_tpu_torch.ops import threefry as ptf
from test_torch_silhouette import (_grads_close, _port_scene,
                                   _port_value_and_grads, _scene,
                                   shadow_mix)

torch.set_num_threads(2)

W, H = 24, 16
NAMES = ("centers", "radii", "ior")


def lone_glass():
    """tests/test_branchprob.py's lone glass sphere: at depth 2 the pixel
    is p_reflect(ior) * sky, the whole ior dependence the RR decision."""
    return _scene([[0.0, 0.0, -2.0]], [0.6], [DIELECTRIC], [[1, 1, 1]],
                  [0], [1.5])


def mirror_occluder():
    """tests/test_branchprob.py's perfect mirror ground with a black
    occluder seen only in the reflection."""
    return _scene([[0.0, -100.5, -1.0], [0.0, 0.49, -2.69]], [100.0, 0.3],
                  [METAL, LAMBERT], [[0.7, 0.7, 0.7], [0, 0, 0]], [0, 0],
                  [1, 1])


SCENES = {"lone_glass": lone_glass, "mirror": mirror_occluder,
          "mix": shadow_mix}


def _cams(scene):
    if scene == "mirror":  # tilted down at the ground (its shadow_cam)
        jc = jcamera.make_camera((0, 0.5, 0.3), (0, -0.5, -1.2), (0, 1, 0),
                                 W / H, 40.0, 0.0, 1.0)
    else:
        jc = jcamera.make_camera((0, 0.3, 0.5), (0, 0, -1.5), (0, 1, 0),
                                 W / H, 60.0, 0.0, 1.5)
    return jc, pcamera.camera_from_numpy(*map(np.asarray, jc), device="cpu")


CASES = {
    # name: (scene, max_depth, camera mode, options, keyword arguments)
    # (the tolerance is 1e-4 of a leaf's largest |gradient| but where
    # REDRAW_ATOL names the case)
    "lone_glass_depth2": ("lone_glass", 2, "pinhole", "default", {}),
    "lone_glass_reference_cuda": ("lone_glass", 3, "cuda", "reference-cuda",
                                  {}),
    "mirror_sweep": ("mirror", 2, "pinhole", "default", {}),
    "mix_vd0": ("mix", 5, "pinhole", "default", {}),
    "mix_vd1": ("mix", 5, "pinhole", "default", {"vertex_depth": 1}),
    "mix_ablations": ("mix", 5, "pinhole", "default", {
        "sweep_redraws": 2, "rr_probe_splits": 2,
        "boundary_rim_frac": 0.15, "chain_rr_arms": 1}),
    "mix_vd1_detached_prefix_sweep_only": (
        "mix", 5, "pinhole", "default",
        {"vertex_depth": 1, "_detach_prefix": True, "_rr_term": False}),
}


REDRAW_ATOL = {"mix_ablations": 2e-3}


@functools.lru_cache(maxsize=None)
def _case(name):
    scene, depth, mode, compat, kw = CASES[name]
    js = SCENES[scene]()
    jc, pc = _cams(scene)
    g = np.random.default_rng(0)
    ids = g.permutation(W * H)[:240].astype(np.int32)
    cot = g.normal(size=(240, 3)).astype(np.float32)
    jopt = JREFCUDA if compat == "reference-cuda" else JDEFAULT
    popt = (pconfig.REFERENCE_CUDA if compat == "reference-cuda"
            else pconfig.DEFAULT)

    def jf(params):
        return jbp.branch_probability_surrogate(
            js._replace(**params), jc, mode, jnp.asarray(cot),
            jnp.asarray(ids), W, H, jax.random.key(5), depth, jopt, **kw)

    wv, wg = jax.value_and_grad(jf)({k: getattr(js, k) for k in NAMES})
    gv, gg = _port_value_and_grads(
        lambda s: pbp.branch_probability_surrogate(
            s, pc, mode, torch.from_numpy(cot), torch.from_numpy(ids), W, H,
            ptf.key_words(5), depth, popt, **kw),
        _port_scene(js), NAMES)
    return float(wv), wg, gv, gg


def test_constants_equal():
    for name in ("TAG_RR_VERTEX", "TAG_RR_PROBE", "TAG_RR_DEPTH",
                 "TAG_SWEEP_PROBE", "TAG_SWEEP_REDRAW"):
        assert getattr(pbp, name) == getattr(jbp, name), name


@pytest.mark.parametrize("phys", [True, False], ids=["physical",
                                                     "reference"])
def test_refract_dir_clamped_matches_jax(phys):
    """Both refraction expressions, with the discriminant clamped at 0
    (half the rows past total internal reflection)."""
    g = np.random.default_rng(3)
    u = g.normal(size=(512, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    n = g.normal(size=(512, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    ri = g.uniform(0.6, 1.6, 512).astype(np.float32)
    cos_o = np.sum(n * u, axis=-1)
    k = (1.0 - ri * ri * (1.0 - cos_o * cos_o)).astype(np.float32)
    assert (k < 0).mean() > 0.05
    want = np.asarray(jbp._refract_dir_clamped(
        *(jnp.asarray(a) for a in (u, n, ri, cos_o, k)), phys))
    got = pbp._refract_dir_clamped(
        *(torch.from_numpy(a) for a in (u, n, ri, cos_o, k)), phys).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CASES))
def test_branch_probability_surrogate_matches_jax(name):
    """Value and gradient w.r.t. centers, radii and ior: the RR term alone
    (lone glass at depth 2, also under the reference refraction), the
    mirror's sweep, and the full term at vertex depths 0 and 1 with every
    ablation knob at a non-default value once."""
    wv, wg, gv, gg = _case(name)
    np.testing.assert_allclose(gv, wv, rtol=1e-4, atol=1e-7)
    leaves = [k for k in NAMES if np.abs(np.asarray(wg[k])).max() > 0]
    assert leaves, name
    _grads_close(wg, gg, leaves, REDRAW_ATOL.get(name, 1e-4))
    for k in set(NAMES) - set(leaves):
        assert not gg[k].any(), (name, k)


def test_rr_term_is_the_only_ior_gradient_of_the_lone_glass():
    """The port's counterpart of the JAX package's control
    (tests/test_branchprob.py): on the lone glass at depth 2 interior AD
    gives EXACTLY zero for ior; rr_grad a nonzero, finite gradient."""
    js = lone_glass()
    ps = _port_scene(js)
    _jc, pc = _cams("lone_glass")
    ids = torch.arange(W * H, dtype=torch.int32)
    target = torch.zeros((W * H, 3))

    def grad(rr):
        params = poptim.params_from_scene(ps, ("ior",))
        loss = poptim.render_loss(
            params, ps, pc, target, ids, ptf.key_words(3), width=W,
            height=H, spp=4, max_depth=2, camera_mode="pinhole",
            options=pconfig.DEFAULT, rr_grad=rr)
        loss.backward()
        return float(params["ior"].grad[0])

    assert grad(False) == 0.0
    g1 = grad(True)
    assert np.isfinite(g1) and g1 != 0.0
