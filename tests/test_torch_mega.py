"""PyTorch port vs the JAX package: the whole-bounce kernel
(ops/cuda_mega.py, TPU kernel ``pallas_mega.py::_kernel_mega``) and the
wavefront engine's ``mega="bounce"`` step.

On the CPU ``mega_bounce`` runs its plain PyTorch version; the JAX
``mega_bounce`` runs its Pallas kernel in interpret mode. The same lane
state, made with numpy from a seed, goes through both.

Tolerances, and why:
  * one bounce against the JAX kernel: keep and depth equal on every lane;
    attenuation and accumulated radiance rtol 1e-5 / atol 1e-6 on every
    lane; the new origin and direction rtol 1e-5 / atol 1e-6 on all but 5%
    of the active lanes and rtol 1e-2 / atol 1e-3 on every lane (measured:
    at most 29 of ~820, the largest 3e-3). XLA:CPU contracts the
    discriminant's multiply-adds, so t moves by 1e-4 at the 99th
    percentile on ordinary spheres and by percents on the r = 1000 ground
    (tests/test_torch_segment.py); the hit point carries t's error, the
    normal divides it by a radius of 0.2, the scattered direction carries
    the normal's. Lanes that pass through are exact;
  * frames of the three fusion levels (``off``, ``bounce``, ``fused``)
    within rtol 1e-5 / atol 1e-6 of each other, the JAX package's own test
    (tests/test_wavefront.py::test_wavefront_mega_modes_match) at its own
    shapes; on the CPU the port's three are in fact bit-equal (one
    arithmetic for every step);
  * a ``bounce`` frame against the JAX package's: the renderer's frame
    rule (golden.compare_frames).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginoneweekend_tpu import config as jconfig
from raytracinginoneweekend_tpu.models import camera as jcamera
from raytracinginoneweekend_tpu.models import scene as jscene
from raytracinginoneweekend_tpu.ops import pallas_mega as jmega
from raytracinginoneweekend_tpu.ops import pallas_segment as jseg
from raytracinginoneweekend_tpu.ops import wavefront as jwave
import raytracinginoneweekend_tpu_torch as rt
from raytracinginoneweekend_tpu_torch import cli as pcli
from raytracinginoneweekend_tpu_torch.golden import compare_frames
from raytracinginoneweekend_tpu_torch.models import camera as pcamera
from raytracinginoneweekend_tpu_torch.models import scene as pscene
from raytracinginoneweekend_tpu_torch.ops import cuda_mega
from raytracinginoneweekend_tpu_torch.ops import cuda_segment as pseg

# Several test workers share the machine's cores (see
# tests/test_torch_segment_variants.py): two intra-op threads each.
torch.set_num_threads(2)

SHAPE = (8, 128)
T_MIN = 0.008
PRESETS = {"default": dict(unit_sample=False, phys_refract=True,
                           sky_bias=1.0),
           "reference_cuda": dict(unit_sample=True, phys_refract=False,
                                  sky_bias=0.5)}


def _lane_state(seed: int, max_depth: int = 50):
    """A mid-frame-like lane state among the huge scene's spheres: 80% of
    lanes active, rays from inside the sphere field in any direction,
    depths below max_depth, any keys."""
    g = np.random.default_rng(seed)
    f32 = np.float32
    act = g.random(SHAPE) < 0.8
    act[0, :64] = False
    o = np.stack([g.uniform(-8, 8, SHAPE), g.uniform(0.05, 1.6, SHAPE),
                  g.uniform(-8, 8, SHAPE)]).astype(f32)
    d = g.normal(size=(3,) + SHAPE).astype(f32)
    d /= np.linalg.norm(d, axis=0)
    d *= g.uniform(0.5, 1.5, SHAPE).astype(f32)
    att = g.uniform(0.2, 1.0, (3,) + SHAPE).astype(f32)
    acc = g.uniform(0.0, 2.0, (3,) + SHAPE).astype(f32)
    depth = g.integers(0, max_depth, SHAPE).astype(np.int32)
    keys = g.integers(0, 2 ** 32, (2,) + SHAPE, dtype=np.uint64).astype(
        np.uint32)
    return act, o, d, att, acc, depth, keys


def _both(seed: int, preset: str, max_depth: int):
    act, o, d, att, acc, depth, keys = _lane_state(seed, max_depth)
    kw = dict(t_min=T_MIN, max_depth=max_depth, **PRESETS[preset])
    jp = jseg.sphere_params_from_scene(jscene.huge_scene(0))
    want = jmega.mega_bounce(
        (jnp.asarray(act), *map(jnp.asarray, (*o, *d, *att, *acc)),
         jnp.asarray(depth), jnp.asarray(keys[0]), jnp.asarray(keys[1])),
        jp, rows=8, **kw)
    pp = pseg.sphere_params_from_scene(pscene.huge_scene(0, device="cpu"))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    got = cuda_mega.mega_bounce(
        (t(act.astype(np.int32)), *map(t, (*o, *d, *att, *acc)), t(depth),
         t(keys[0].view(np.int32)), t(keys[1].view(np.int32))), pp, **kw)
    return act, o, d, got, want, pp


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("max_depth", [3, 50])
def test_mega_bounce_plain_matches_jax(preset, max_depth):
    act, _o, _d, got, want, _pp = _both(1 + max_depth, preset, max_depth)
    got = [g.numpy() for g in got]
    want = [np.asarray(w) for w in want]
    assert got[12].dtype == np.int32 and got[13].dtype == np.int32
    np.testing.assert_array_equal(got[12] > 0, want[12])  # keep
    np.testing.assert_array_equal(got[13], want[13])       # depth
    keep = want[12]
    assert 0.1 < keep.mean() < act.mean()  # scatters, misses and absorbs
    n_act = int(act.sum())
    for i in range(12):
        exact = ~act | (~keep & (i < 9))  # passed through or not moved
        np.testing.assert_array_equal(got[i][exact], want[i][exact], str(i))
        if i >= 6:  # attenuation, accumulated radiance
            np.testing.assert_allclose(got[i], want[i], rtol=1e-5,
                                       atol=1e-6, err_msg=str(i))
            continue
        near = np.isclose(got[i], want[i], rtol=1e-5, atol=1e-6)
        assert (~near).sum() <= 0.05 * n_act, (i, int((~near).sum()))
        np.testing.assert_allclose(got[i], want[i], rtol=1e-2, atol=1e-3,
                                   err_msg=str(i))
    # inactive lanes copy their state through, with keep 0
    assert not keep[~act].any()


def test_mega_bounce_refuses_bad_input():
    act, o, d, att, acc, depth, keys = _lane_state(0)
    pp = pseg.sphere_params_from_scene(pscene.simple_scene_cuda("cpu"))
    planes = [torch.zeros(SHAPE)] * 15
    with pytest.raises(ValueError, match="16"):
        cuda_mega.mega_bounce(planes, pp, t_min=T_MIN, max_depth=4,
                              unit_sample=True, phys_refract=True,
                              sky_bias=1.0)


def _frames(scene_name, camera_mode, mod):
    """The three fusion levels' frames of one package at the JAX test's
    shapes (20x12 on the simple scene, 16x10 on the huge one)."""
    w, h = (20, 12) if scene_name == "simple" else (16, 10)
    kw = dict(width=w, height=h, spp=2, max_depth=6,
              camera_mode=camera_mode, pool_size=1 << 12)
    if mod is rt:
        scene = (pscene.simple_scene_cuda("cpu") if scene_name == "simple"
                 else pscene.huge_scene(0, device="cpu"))
        cam = (pcamera.reference_cuda_camera if scene_name == "simple"
               else pcamera.reference_cpu_camera)(w, h, "cpu")
        return {m: rt.render_wavefront(
            scene, cam, rt.key_words(7), device="cpu",
            options=dataclasses.replace(rt.DEFAULT, mega=m), **kw).numpy()
            for m in ("off", "bounce", "fused")}
    scene = (jscene.simple_scene_cuda() if scene_name == "simple"
             else jscene.huge_scene(0))
    cam = (jcamera.reference_cuda_camera if scene_name == "simple"
           else jcamera.reference_cpu_camera)(w, h)
    return np.asarray(jwave.render_wavefront(
        scene, cam, jax.random.key(7),
        options=dataclasses.replace(jconfig.DEFAULT, mega="bounce"), **kw))


@pytest.mark.parametrize("camera_mode", ["cuda", "pinhole", "cpu",
                                         "thinlens"])
def test_three_fusion_levels_agree(camera_mode):
    for scene_name in ("simple", "huge"):
        imgs = _frames(scene_name, camera_mode, rt)
        assert np.isfinite(imgs["bounce"]).all()
        np.testing.assert_allclose(imgs["bounce"], imgs["off"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(imgs["fused"], imgs["off"], rtol=1e-5,
                                   atol=1e-6)
        # one arithmetic on the CPU: the three are the same bits
        np.testing.assert_array_equal(imgs["bounce"], imgs["off"])


@pytest.mark.parametrize("scene_name,camera_mode", [("simple", "cuda"),
                                                    ("huge", "thinlens")])
def test_bounce_frame_matches_jax(scene_name, camera_mode):
    got = _frames(scene_name, camera_mode, rt)["bounce"]
    want = _frames(scene_name, camera_mode, jax)
    res = compare_frames(got, want, atol=5e-4 if scene_name == "huge"
                         else 3e-5)
    assert res["ok"], res


def test_cli_fusion_bounce_renders_the_unfused_frame(tmp_path):
    """``render --fusion bounce`` runs the whole-bounce step; on the CPU
    its image is the ``--fusion off`` image, bit for bit."""
    imgs = {}
    for fusion in ("bounce", "off"):
        out = str(tmp_path / f"{fusion}.png")
        assert pcli.main(["render", "--scene", "simple-cuda", "--width", "16",
                          "--height", "12", "--spp", "2", "--depth", "4",
                          "--device", "cpu", "--fusion", fusion,
                          "--out", out]) == 0
        imgs[fusion] = open(out, "rb").read()
    assert imgs["bounce"] == imgs["off"]
