"""The plain reference against the program at tiny sizes on the CPU, and
its lower-precision control against the reference."""

import zlib
import struct

import numpy as np
import pytest
import torch

from benchmark.drivers import common
from benchmark.reference import compare, fit as ref_fit
from benchmark.reference import image, scenes, threefry as tf, tracer
from raytracinginoneweekend_tpu_torch.config import DEFAULT
from raytracinginoneweekend_tpu_torch.io.image import write_png
from raytracinginoneweekend_tpu_torch.models import camera as port_camera
from raytracinginoneweekend_tpu_torch.models import scene as port_scene
from raytracinginoneweekend_tpu_torch.ops import threefry as port_tf
from raytracinginoneweekend_tpu_torch.ops.postprocess import to_u8
from raytracinginoneweekend_tpu_torch.ops.wavefront import render_wavefront
from raytracinginoneweekend_tpu_torch.optim import inverse

torch.set_num_threads(2)

HUGE = {"scene": {"generator": "huge", "seed": 0}, "width": 24,
        "height": 16, "camera": {"position": [-4, 3.2, 5],
                                 "lookat": [0, 1, 0], "up": [0, 1, 0],
                                 "vfov": 42, "aperture": 0.0625,
                                 "focus": "distance"}}
SIMPLE = {"scene": {"generator": "simple_cuda", "seed": 0}, "width": 24,
          "height": 16, "camera": {"position": [0, 0, 0],
                                   "lookat": [0, 0, -1], "up": [0, 1, 0],
                                   "vfov": 88, "aperture": 0.0625,
                                   "focus": 1.0}}


def test_threefry_matches_the_program():
    base = tf.seed_key(2 ** 40 + 17, 3)
    pid = torch.arange(0, 5000, 7)
    ours = tf.ray_key(base, pid, 3)
    theirs = port_tf.fold_in_words(*port_tf.fold_in_words(*base, pid), 3)
    assert all(torch.equal(a, b) for a, b in zip(ours, theirs))
    u = tf.uniforms(ours, 5, 1)
    v = port_tf.draw_uniform2(*theirs, 5, 1)
    assert all(torch.equal(a, b) for a, b in zip(u, v))


@pytest.mark.parametrize("n,k", [(1000, 100), (20000, 512)])
def test_choice_matches_the_program(n, k):
    key = tf.seed_key(99, 1)
    assert torch.equal(tf.choice(key, n, k, "cpu"),
                       port_tf.choice_without_replacement(key, n, k, "cpu"))


@pytest.mark.parametrize("seed", [0, 7])
def test_scenes_match_the_program(seed):
    ours = scenes.huge(seed)
    theirs = port_scene.huge_scene(seed, device="cpu")
    for name in scenes.FIELDS:
        assert np.array_equal(ours[name], getattr(theirs, name).numpy())
    simple = port_scene.simple_scene_cuda(device="cpu")
    for name in scenes.FIELDS:
        assert np.array_equal(scenes.simple_cuda()[name],
                              getattr(simple, name).numpy())


def test_camera_matches_the_program():
    _, ours = scenes.from_config(HUGE)
    theirs = port_camera.reference_cpu_camera(24, 16, device="cpu")
    for name in scenes.CAMERA_FIELDS:
        assert np.allclose(ours[name], getattr(theirs, name).numpy(),
                           rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cfg", [HUGE, SIMPLE], ids=["huge", "simple"])
def test_frames_match_the_program(cfg):
    arrays, cam = scenes.from_config(cfg)
    key = tf.seed_key(2 ** 35 + 1, 1, 4)
    scene, pcam = common.port_inputs(arrays, cam, "cpu")
    prog = render_wavefront(scene, pcam, key, spp=4, width=24, height=16,
                            max_depth=8, camera_mode="thinlens",
                            options=DEFAULT, pool_size=256, device="cpu")
    ref = tracer.trace(tracer.Scene(arrays, "cpu"), cam, torch.arange(384),
                       4, key, width=24, height=16, max_depth=8)
    assert common.mean_abs_gap(prog, ref) < 1e-6
    control = tracer.trace(tracer.Scene(arrays, "cpu", torch.bfloat16), cam,
                           torch.arange(384), 4, key, width=24, height=16,
                           max_depth=8, dtype=torch.bfloat16)
    assert common.mean_abs_gap(control.float(), ref) > 1e-2


def test_gradients_match_the_program():
    arrays, cam = scenes.from_config(HUGE)
    rng = np.random.default_rng(3)
    start = dict(arrays)
    for name in ("albedo", "centers"):
        start[name] = (arrays[name] + 0.1 * rng.standard_normal(
            arrays[name].shape)).astype(np.float32)
    pix = torch.arange(0, 384, 3)
    target = tracer.trace(tracer.Scene(arrays, "cpu"), cam, pix, 2,
                          (0, 5), width=24, height=16, max_depth=6)
    scene, pcam = common.port_inputs(start, cam, "cpu")
    params = inverse.params_from_scene(scene, ("albedo", "centers"))
    loss = inverse.render_loss(params, scene, pcam, target,
                               pix.to(torch.int32), (0, 9), width=24,
                               height=16, spp=2, max_depth=6,
                               camera_mode="thinlens", options=DEFAULT,
                               engine="wavefront")
    loss.backward()
    leaves = {k: torch.tensor(start[k], requires_grad=True)
              for k in ("albedo", "centers")}
    got = tracer.trace(tracer.Scene(start, "cpu", **leaves), cam, pix, 2,
                       (0, 9), width=24, height=16, max_depth=6, grad=True)
    ref_loss = ((got - target) ** 2).mean()
    ref_loss.backward()
    assert abs(float(loss) - float(ref_loss)) <= 1e-6 * float(ref_loss)
    for k in leaves:
        a, b = params[k].grad.norm(), leaves[k].grad.norm()
        assert abs(float(a - b)) <= 1e-3 * float(b)


def test_adam_is_optax_adam():
    p = torch.tensor([1.0, -2.0])
    mu, nu = torch.zeros(2), torch.zeros(2)
    g = torch.tensor([0.5, -0.25])
    ref_fit.adam(p, g, mu, nu, 1, 0.01)
    # the first bias-corrected step moves each element by lr * sign(g)
    assert torch.allclose(p, torch.tensor([0.99, -1.99]), atol=1e-6)


def test_to_u8_matches_the_program():
    x = torch.rand(4096, 3) * 1.5 - 0.1
    assert np.array_equal(image.to_u8(x.numpy()), to_u8(x).numpy())


def test_png_reads_what_the_program_writes(tmp_path):
    img = (np.random.default_rng(1).random((7, 5, 3)) * 255).astype(np.uint8)
    write_png(str(tmp_path / "a.png"), img)
    assert np.array_equal(image.read_png((tmp_path / "a.png").read_bytes()),
                          img)


def _png_with_filter(img, kind):
    h, w, _ = img.shape
    rows, prev = [], np.zeros(3 * w, np.int64)
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(3, np.int64), cur[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int64), prev[:-3]])
        if kind == 1:
            f = cur - left
        elif kind == 2:
            f = cur - prev
        elif kind == 3:
            f = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
            f = cur - pred
        rows.append(bytes([kind]) + (f & 0xFF).astype(np.uint8).tobytes())
        prev = cur

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [1, 2, 3, 4])
def test_png_filters(kind):
    img = (np.random.default_rng(kind).random((6, 9, 3)) * 255).astype(
        np.uint8)
    assert np.array_equal(image.read_png(_png_with_filter(img, kind)), img)


def test_fit_control_reads_far_from_the_reference():
    """The fit's control (the reference in bfloat16) against the float32
    reference, at a tiny size: its gaps lie far above the cell's limits."""
    from benchmark import manifest
    from benchmark.drivers import fit

    limits = manifest.cell(manifest.load(), "huge-fit")["cell"]["limits"]
    arrays, cam = scenes.from_config(HUGE)
    start = fit.perturbed(arrays, ("albedo", "centers"), 0.1, 4,
                          {"albedo": [0.0, 1.0]})
    kw = dict(steps=3, base=(0, 3), target_key=(0, 4), width=24, height=16,
              max_depth=6, target_spp=2, fit_spp=2, batch=96, lr=0.01,
              device="cpu")
    ref = ref_fit.follow(arrays, start, cam, ("albedo", "centers"), **kw)
    low = ref_fit.follow(arrays, start, cam, ("albedo", "centers"),
                         dtype=torch.bfloat16, **kw)
    gaps = compare.fit_gaps(low["losses"], low["grads"], low["first"],
                            low["last"], ref)
    assert any(gaps[k] > limits[k] for k in gaps)


def test_preview_control_reads_far_from_the_reference():
    from benchmark import manifest

    limit = manifest.cell(manifest.load(), "huge-preview-serve")["cell"][
        "limits"]["png_mean_abs_err"]
    arrays, cam = scenes.from_config(HUGE, scene_seed=12)
    ids = torch.arange(0, 384, 2)
    kw = dict(width=24, height=16, max_depth=6)
    ref = tracer.trace(tracer.Scene(arrays, "cpu"), cam, ids, 4, (0, 12),
                       **kw)
    low = tracer.trace(tracer.Scene(arrays, "cpu", torch.bfloat16), cam,
                       ids, 4, (0, 12), dtype=torch.bfloat16, **kw)
    gap = common.mean_abs_gap(image.to_u8(low.float().numpy()).astype(float),
                              image.to_u8(ref.numpy()))
    assert gap > limit
