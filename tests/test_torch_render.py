"""PyTorch port vs the JAX package: camera rays and the tiled renderer.

``camera_ray`` / ``make_primary_rays`` / ``render_pixels`` / ``render`` of
the port on the CPU against the JAX package's, same scene, camera, key and
options. Key words are BIT-EQUAL; rays agree to rtol 1e-5 / atol 1e-6 (two
libms). Radiance: rtol 1e-4 / atol 5e-4 per pixel value (the tolerance of
the JAX package's own planar-vs-tiled test on the huge scene), with at most
1% of pixels beyond it -- a path that a rounding difference sends through
another t_min or grazing decision, the renderer's knife-edge rule
(golden.compare_frames).
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
from raytracinginoneweekend_tpu.ops import rng as jrng
from raytracinginoneweekend_tpu.ops import threefry as jtf
from raytracinginoneweekend_tpu_torch import config as pconfig
from raytracinginoneweekend_tpu_torch.models import camera as pcamera
from raytracinginoneweekend_tpu_torch.models import scene as pscene
from raytracinginoneweekend_tpu_torch.ops import rng as prng
from raytracinginoneweekend_tpu_torch.ops import threefry as ptf

# (both packages export a function `render` that shadows the module)
jrender = importlib.import_module("raytracinginoneweekend_tpu.render")
prender = importlib.import_module("raytracinginoneweekend_tpu_torch.render")

W, H, SPP, DEPTH, SEED = 24, 16, 4, 4, 7


def _close_pixels(got, want, rtol=1e-4, atol=5e-4, budget=0.01):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    bad = ~np.isclose(got, want, rtol=rtol, atol=atol).all(axis=-1)
    assert bad.mean() <= budget, (int(bad.sum()), bad.size)


@pytest.mark.parametrize("mode", ["cuda", "pinhole", "cpu", "thinlens"])
def test_camera_ray(mode):
    g = np.random.default_rng(0)
    n = 400
    u, v = g.random(n, dtype=np.float32), g.random(n, dtype=np.float32)
    pid = g.integers(0, W * H, size=n, dtype=np.int32)
    sid = g.integers(0, SPP, size=n, dtype=np.int32)
    jcam = jcamera.reference_cpu_camera(W, H)
    base = jax.random.key(SEED)
    want = jax.vmap(lambda u, v, p, s: jcamera.camera_ray(
        jcam, u, v, jrng.ray_key(base, p, s), mode))(
        *(jnp.asarray(a) for a in (u, v, pid, sid)))
    keys = prng.ray_key(ptf.key_words(SEED), torch.from_numpy(pid),
                        torch.from_numpy(sid))
    got = pcamera.camera_ray(pcamera.reference_cpu_camera(W, H, "cpu"),
                             torch.from_numpy(u), torch.from_numpy(v), keys,
                             mode)
    for g_, w in zip(got, want):
        assert tuple(g_.shape) == (n, 3)
        np.testing.assert_allclose(g_.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_camera_ray_unknown_mode_and_lens_uv():
    cam = pcamera.reference_cpu_camera(W, H, "cpu")
    u = torch.rand(8)
    keys = prng.ray_key((0, 1), torch.arange(8), 0)
    with pytest.raises(ValueError):
        pcamera.camera_ray(cam, u, u, keys, "fisheye")
    # a supplied lens pair replaces the key's draw
    lens = (torch.full((8,), 0.25), torch.full((8,), 0.5))
    o, _ = pcamera.camera_ray(cam, u, u, keys, "thinlens", lens_uv=lens)
    assert float((o - o[0]).abs().max()) == 0.0


@pytest.mark.parametrize("sampling", ["iid", "stratified"])
@pytest.mark.parametrize("mode", ["thinlens", "cuda"])
def test_make_primary_rays(mode, sampling):
    g = np.random.default_rng(1)
    n = 300
    pid = g.integers(0, W * H, size=n, dtype=np.int32)
    sid = g.integers(0, SPP, size=n, dtype=np.int32)
    wo, wd, wkeys = jrender.make_primary_rays(
        jcamera.reference_cpu_camera(W, H), jnp.asarray(pid),
        jnp.asarray(sid), jax.random.key(SEED), W, H, mode,
        sampling=sampling, spp=SPP)
    go, gd, gkeys = prender.make_primary_rays(
        pcamera.reference_cpu_camera(W, H, "cpu"), torch.from_numpy(pid),
        torch.from_numpy(sid), ptf.key_words(SEED), W, H, mode,
        sampling=sampling, spp=SPP)
    for g_, w in zip(gkeys, jtf.key_words(wkeys)):
        np.testing.assert_array_equal(g_.numpy().astype(np.uint32),
                                      np.asarray(w))
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5,
                               atol=1e-6)


SCENES = {
    "simple-cuda": (jscene.simple_scene_cuda,
                    lambda: pscene.simple_scene_cuda("cpu")),
    "huge": (lambda: jscene.huge_scene(0),
             lambda: pscene.huge_scene(0, "cpu")),
}


def _options(mod, compat, **changes):
    base = {"default": mod.DEFAULT, "reference-cuda": mod.REFERENCE_CUDA,
            "reference-cpu": mod.REFERENCE_CPU}[compat]
    return dataclasses.replace(base, **changes)


def _port_pixels(scene="simple-cuda", compat="default", mode="thinlens",
                 ids=None, spp=SPP, wave_spp=SPP, depth=DEPTH,
                 differentiable=False, **changes):
    ids = np.arange(W * H, dtype=np.int32) if ids is None else ids
    return prender.render_pixels(
        SCENES[scene][1](), pcamera.reference_cuda_camera(W, H, "cpu"),
        torch.from_numpy(ids), ptf.key_words(SEED), width=W, height=H,
        spp=spp, wave_spp=wave_spp, max_depth=depth, camera_mode=mode,
        options=_options(pconfig, compat, **changes),
        differentiable=differentiable).detach().numpy()


CONFIGS = {
    "default_thinlens": ("simple-cuda", "default", "thinlens", {}),
    "reference_cuda": ("simple-cuda", "reference-cuda", "cuda", {}),
    "reference_cpu": ("simple-cuda", "reference-cpu", "cpu", {}),
    "stratified_rr": ("simple-cuda", "default", "thinlens",
                      {"sampling": "stratified", "rr_terminate": True,
                       "rr_start": 1}),
    "huge_take_block64": ("huge", "default", "pinhole",
                          {"gather": "take", "sphere_block": 64}),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_render_pixels_matches_jax(name):
    scene, compat, mode, changes = CONFIGS[name]
    want = jrender.render_pixels(
        SCENES[scene][0](), jcamera.reference_cuda_camera(W, H),
        jnp.arange(W * H, dtype=jnp.int32), jax.random.key(SEED), width=W,
        height=H, spp=SPP, wave_spp=SPP, max_depth=DEPTH, camera_mode=mode,
        options=_options(jconfig, compat, **changes))
    got = _port_pixels(scene, compat, mode, **changes)
    _close_pixels(got, want)
    assert got.std() > 0.05  # an image, not a constant


def test_render_pixels_is_invariant_to_waves_chunks_and_the_tracer():
    whole = _port_pixels()
    # wave size, including one that does not divide spp (masked samples)
    for wave_spp in (1, 3):
        np.testing.assert_allclose(_port_pixels(wave_spp=wave_spp), whole,
                                   rtol=1e-5, atol=1e-6)
    # pixel chunks, and a ragged set of ids
    ids = np.arange(W * H, dtype=np.int32)
    parts = [_port_pixels(ids=ids[lo:lo + 100]) for lo in range(0, W * H,
                                                                100)]
    np.testing.assert_array_equal(np.concatenate(parts), whole)
    ragged = (np.arange(37, dtype=np.int32) * 7) % (W * H)
    np.testing.assert_array_equal(_port_pixels(ids=ragged), whole[ragged])
    # the checkpointed tracer computes what the early-exit one computes
    np.testing.assert_allclose(_port_pixels(differentiable=True), whole,
                               rtol=1e-6, atol=1e-7)
    # on the CPU the kernel's wrapper runs the plain version
    np.testing.assert_array_equal(_port_pixels(intersect="pallas"), whole)


@pytest.mark.parametrize("rays_per_chunk", [1 << 20, 100])
def test_render_full_image_matches_jax(rays_per_chunk):
    jcfg = jconfig.RenderConfig(width=W, height=H, spp=2, max_depth=3,
                                camera_mode="thinlens",
                                rays_per_chunk=rays_per_chunk)
    pcfg = pconfig.RenderConfig(width=W, height=H, spp=2, max_depth=3,
                                camera_mode="thinlens",
                                rays_per_chunk=rays_per_chunk)
    want = jrender.render(jscene.simple_scene_cuda(),
                          jcamera.reference_cuda_camera(W, H), jcfg,
                          jax.random.key(3))
    got = prender.render(pscene.simple_scene_cuda("cpu"),
                         pcamera.reference_cuda_camera(W, H, "cpu"), pcfg,
                         ptf.key_words(3), device="cpu")
    assert tuple(got.shape) == (H, W, 3)
    _close_pixels(got.numpy().reshape(-1, 3),
                  np.asarray(want).reshape(-1, 3))


def test_render_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        prender.render(pscene.simple_scene_cuda("cpu"),
                       pcamera.reference_cuda_camera(8, 8, "cpu"),
                       pconfig.RenderConfig(width=8, height=8, spp=1))
