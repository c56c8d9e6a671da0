"""PyTorch port vs the JAX package: the planar AD engine.

``closest_hit_planar`` (the closest-hit kernel under a
``torch.autograd.Function``; on the CPU its plain version), the winner
gather, the shade step and ``render_pixels_planar`` against the JAX
package's (Pallas kernel in interpret mode), same inputs made with numpy
from a seed.

Tolerances: forward hit/index/t in the class of tests/test_torch_segment.py
(XLA:CPU contracts multiply-adds); gradients rtol 2e-3 / atol 1e-5 (the JAX
package's own tolerance for its custom VJP); radiance rtol 1e-4 / atol 5e-4
on all but 1% of pixels (the knife-edge rule), as tests/test_planar.py holds
planar against tiled.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginoneweekend_tpu import config as jconfig
from raytracinginoneweekend_tpu.models import camera as jcamera
from raytracinginoneweekend_tpu.models import scene as jscene
from raytracinginoneweekend_tpu.ops import integrate_planar as jplanar
from raytracinginoneweekend_tpu_torch import config as pconfig
from raytracinginoneweekend_tpu_torch.models import camera as pcamera
from raytracinginoneweekend_tpu_torch.models import scene as pscene
from raytracinginoneweekend_tpu_torch.ops import cuda_segment
from raytracinginoneweekend_tpu_torch.ops import integrate_planar as pplanar
from raytracinginoneweekend_tpu_torch.ops import threefry as ptf

prender = importlib.import_module("raytracinginoneweekend_tpu_torch.render")

W, H, SPP, DEPTH, SEED = 24, 16, 4, 4, 7
T_MIN = 0.008
SHAPE = (8, 128)


def _rays_and_geometry():
    g = np.random.default_rng(11)
    centers = g.normal(size=(9, 3)).astype(np.float32) * 2
    radii = g.uniform(0.4, 1.2, size=9).astype(np.float32)
    radii[7] = -radii[7]
    o = [g.normal(size=SHAPE).astype(np.float32) * 0.1 for _ in range(3)]
    d = [g.normal(size=SHAPE).astype(np.float32) for _ in range(3)]
    return o + d, centers, radii


def test_closest_hit_planar_forward_matches_jax():
    rays, centers, radii = _rays_and_geometry()
    wt, wsb, whit = jplanar.closest_hit_planar(
        tuple(jnp.asarray(p) for p in rays),
        (jnp.asarray(centers), jnp.asarray(radii)), T_MIN, 8)
    gt, gsb, ghit = pplanar.closest_hit_planar(
        tuple(torch.from_numpy(p) for p in rays),
        (torch.from_numpy(centers), torch.from_numpy(radii)), T_MIN)
    assert gt.dtype == torch.float32 and gsb.dtype == torch.int32
    assert ghit.dtype == torch.int32 and tuple(gt.shape) == SHAPE
    hit = np.asarray(whit) > 0
    np.testing.assert_array_equal(ghit.numpy() > 0, hit)
    np.testing.assert_array_equal(gsb.numpy()[hit], np.asarray(wsb)[hit])
    np.testing.assert_allclose(gt.numpy()[hit], np.asarray(wt)[hit],
                               rtol=1e-4)
    assert 0.2 < hit.mean() < 1.0


def test_closest_hit_planar_gradients_match_jax_and_plain_autograd():
    rays, centers, radii = _rays_and_geometry()

    def jloss(rays, c, r):
        t, _sb, hit_i = jplanar.closest_hit_planar(rays, (c, r), T_MIN, 8)
        return jnp.sum(jnp.where(hit_i > 0, jnp.sin(t), 0.0))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        tuple(jnp.asarray(p) for p in rays), jnp.asarray(centers),
        jnp.asarray(radii))
    want = [*want[0], want[1], want[2]]

    def grads(fn):
        leaves = [torch.from_numpy(a.copy()).requires_grad_(True)
                  for a in (*rays, centers, radii)]
        t, hit = fn(leaves)
        torch.sum(torch.where(hit, torch.sin(t),
                              torch.zeros_like(t))).backward()
        return [x.grad.numpy() for x in leaves]

    def through_function(leaves):
        t, _sb, hit_i = pplanar.closest_hit_planar(
            tuple(leaves[:6]), (leaves[6], leaves[7]), T_MIN)
        return t, hit_i > 0

    def through_plain(leaves):
        # autograd through the (N, 3) plain closest hit on the same rays
        from raytracinginoneweekend_tpu_torch.ops.intersect import (
            closest_hit)

        o = torch.stack([p.reshape(-1) for p in leaves[:3]], dim=-1)
        d = torch.stack([p.reshape(-1) for p in leaves[3:6]], dim=-1)
        t, _idx, hit = closest_hit(o, d, leaves[6], leaves[7], T_MIN)
        return t.reshape(SHAPE), hit.reshape(SHAPE)

    got, plain = grads(through_function), grads(through_plain)
    for g_, w, p in zip(got, want, plain):
        assert np.abs(np.asarray(w)).max() > 0
        np.testing.assert_allclose(g_, np.asarray(w), rtol=2e-3, atol=1e-5)
        np.testing.assert_allclose(g_, p, rtol=2e-3, atol=1e-5)


def test_material_table_and_pick_rows():
    jsc, psc = jscene.huge_scene(0), pscene.huge_scene(0, "cpu")
    np.testing.assert_array_equal(
        pplanar._material_table(psc).numpy(),
        np.asarray(jplanar._material_table(jsc)))
    for n in (1, 1023, 1024, 8191, 8192, 131072):
        assert pplanar._pick_rows(n) == jplanar._pick_rows(n)
    # the table carries the leaves' gradients: albedo rows sum over the
    # spheres that share a material
    albedo = psc.albedo.clone().requires_grad_(True)
    pplanar._material_table(psc._replace(albedo=albedo))[:, 5:8].sum(
    ).backward()
    counts = np.bincount(psc.material_index.numpy(),
                         minlength=albedo.shape[0])
    np.testing.assert_array_equal(albedo.grad[:, 0].numpy(), counts)


def _options(mod, compat, **changes):
    base = {"default": mod.DEFAULT, "reference-cuda": mod.REFERENCE_CUDA,
            "reference-cpu": mod.REFERENCE_CPU}[compat]
    return dataclasses.replace(base, **changes)


def _few_differ(got, want, rtol=1e-4, atol=5e-4, budget=0.01):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    bad = ~np.isclose(got, want, rtol=rtol, atol=atol).all(axis=-1)
    assert bad.mean() <= budget, (int(bad.sum()), bad.size)


def _port_planar(ids, compat="default", mode="thinlens", spp=SPP,
                 depth=DEPTH, scene=None, **kw):
    changes = {k: kw.pop(k) for k in list(kw)
               if k in ("sampling", "rr_terminate", "rr_start")}
    return pplanar.render_pixels_planar(
        scene or pscene.simple_scene_cuda("cpu"),
        pcamera.reference_cuda_camera(W, H, "cpu"), torch.from_numpy(ids),
        ptf.key_words(SEED), width=W, height=H, spp=spp, max_depth=depth,
        camera_mode=mode, options=_options(pconfig, compat, **changes), **kw)


CONFIGS = {
    "default_thinlens": ("default", "thinlens", {}),
    "reference_cuda": ("reference-cuda", "cuda", {}),
    "reference_cpu_ball": ("reference-cpu", "cpu", {}),
    "pinhole_stratified_rr": ("default", "pinhole",
                              {"sampling": "stratified",
                               "rr_terminate": True, "rr_start": 1}),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_render_pixels_planar_matches_jax_and_the_tiled_engine(name):
    compat, mode, changes = CONFIGS[name]
    ids = np.arange(W * H, dtype=np.int32)
    want = jplanar.render_pixels_planar(
        jscene.simple_scene_cuda(), jcamera.reference_cuda_camera(W, H),
        jnp.asarray(ids), jax.random.key(SEED), width=W, height=H, spp=SPP,
        max_depth=DEPTH, camera_mode=mode,
        options=_options(jconfig, compat, **changes))
    got = _port_planar(ids, compat, mode, **changes).numpy()
    _few_differ(got, want)
    tiled = prender.render_pixels(
        pscene.simple_scene_cuda("cpu"),
        pcamera.reference_cuda_camera(W, H, "cpu"), torch.from_numpy(ids),
        ptf.key_words(SEED), width=W, height=H, spp=SPP, wave_spp=SPP,
        max_depth=DEPTH, camera_mode=mode,
        options=_options(pconfig, compat, **changes)).numpy()
    _few_differ(got, tiled, atol=2e-5)


def test_planar_ragged_batch_padding_and_huge_scene():
    """A pixel count that does not fill the (rows*128) layout is padded and
    masked: every pixel equals its value in the full render."""
    ids = np.arange(W * H, dtype=np.int32)
    whole = _port_planar(ids, spp=3, depth=3).numpy()
    ragged = (np.arange(37, dtype=np.int32) * 7) % (W * H)
    np.testing.assert_allclose(_port_planar(ragged, spp=3, depth=3).numpy(),
                               whole[ragged], rtol=1e-6, atol=1e-7)
    huge = pscene.huge_scene(0, "cpu")
    got = _port_planar(ids[:128], spp=2, depth=3, scene=huge).numpy()
    want = jplanar.render_pixels_planar(
        jscene.huge_scene(0), jcamera.reference_cuda_camera(W, H),
        jnp.asarray(ids[:128]), jax.random.key(SEED), width=W, height=H,
        spp=2, max_depth=3, camera_mode="thinlens",
        options=jconfig.DEFAULT)
    _few_differ(got, want, budget=0.03)


def test_sample_offset_and_strata_windows():
    ids = np.arange(64, dtype=np.int32)
    # iid: windows [0, 2) and [2, 4) average to the 4-sample render
    a = _port_planar(ids, spp=2).numpy()
    b = _port_planar(ids, spp=2, sample_offset=2).numpy()
    whole = _port_planar(ids, spp=4).numpy()
    np.testing.assert_allclose((a + b) / 2, whole, rtol=1e-5, atol=1e-6)
    # stratified: the same with the strata denominator of the union
    kw = dict(sampling="stratified", spp_strata=4)
    a = _port_planar(ids, spp=2, **kw).numpy()
    b = _port_planar(ids, spp=2, sample_offset=2, **kw).numpy()
    whole = _port_planar(ids, spp=4, sampling="stratified").numpy()
    np.testing.assert_allclose((a + b) / 2, whole, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="strata"):
        _port_planar(ids, spp=2, sample_offset=2, sampling="stratified")


def test_backward_never_relaunches_the_closest_hit(monkeypatch):
    """The kernel's outputs are inputs of the checkpointed shade step, so
    forward and backward together call it max_depth times."""
    calls = []
    real = cuda_segment.segment_closest_hit

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(pplanar, "segment_closest_hit", counting)
    psc = pscene.simple_scene_cuda("cpu")
    leaves = {k: getattr(psc, k).clone().requires_grad_(True)
              for k in ("centers", "radii", "albedo", "fuzz", "ior")}
    ids = (np.arange(64, dtype=np.int32) * 6) % (W * H)  # sky and spheres
    out = _port_planar(ids, depth=5, scene=psc._replace(**leaves))
    assert len(calls) == 5
    out.square().sum().backward()
    assert len(calls) == 5
    for k, v in leaves.items():
        assert v.grad is not None and bool(torch.isfinite(v.grad).all()), k
        assert float(v.grad.abs().max()) > 0, k
