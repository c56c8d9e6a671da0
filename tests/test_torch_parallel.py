"""PyTorch port vs the JAX package: the mesh of workers (parallel/mesh.py).

The seven tests of tests/test_parallel.py, the port over
``make_mesh([torch.device("cpu")] * 8)`` and the JAX package over its 8
virtual CPU devices (tests/conftest.py), plus the dry run at n = 8.

Tolerances: the port's sharded frames are held to the port's own unsharded
frames -- BIT-EQUAL for the tiled engine and under tile ownership (every
pixel's tasks lie in one worker's range), rtol 2e-4 / atol 2e-5 under
strided ownership (tests/test_parallel.py's bound: the workers' partial
sums add a pixel's tasks in another order), 2e-6 with the tail reserve
against without (the JAX test's bound); gradients through the mesh rtol
2e-5 / atol 1e-7 of the one-device gradients (the JAX test's). Against the
JAX package each engine keeps its existing tolerance: the tiled engine
rtol 1e-4 / atol 5e-4 with at most 1% of pixels beyond
(tests/test_torch_render.py), the wavefront engine the frame rule
(golden.compare_frames; atol 5e-4 on the huge scene,
tests/test_torch_wavefront.py), gradients rtol 1e-3 / atol 1e-6
(tests/test_torch_optim.py).
"""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracinginoneweekend_tpu_torch as rt
from raytracinginoneweekend_tpu import optim as joptim
from raytracinginoneweekend_tpu import parallel as jparallel
from raytracinginoneweekend_tpu.config import DEFAULT as JDEFAULT
from raytracinginoneweekend_tpu.config import RenderConfig as JRenderConfig
from raytracinginoneweekend_tpu.models import camera as jcamera
from raytracinginoneweekend_tpu.models import scene as jscene
from raytracinginoneweekend_tpu.parallel import mesh as jmesh
from raytracinginoneweekend_tpu_torch import golden, optim as poptim
from raytracinginoneweekend_tpu_torch import parallel as pparallel
from raytracinginoneweekend_tpu_torch.models import camera as pcamera
from raytracinginoneweekend_tpu_torch.models import scene as pscene
from raytracinginoneweekend_tpu_torch.parallel import dryrun as pdryrun

torch.set_num_threads(2)

W, H, SPP, DEPTH = 16, 8, 2, 4
CPU = torch.device("cpu")


def _mesh(n=8):
    return pparallel.make_mesh([CPU] * n)


def _setup():
    return (jscene.simple_scene_cuda(), pscene.simple_scene_cuda("cpu"),
            jcamera.reference_cuda_camera(W, H),
            pcamera.reference_cuda_camera(W, H, "cpu"))


def _close_pixels(got, want, rtol=1e-4, atol=5e-4, budget=0.01):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    bad = ~np.isclose(got, want, rtol=rtol, atol=atol).all(axis=-1)
    assert bad.mean() <= budget, (int(bad.sum()), bad.size)


def _sha(t) -> str:
    return hashlib.sha256(np.ascontiguousarray(t.numpy()).tobytes()
                          ).hexdigest()


def test_mesh_size_and_devices():
    mesh = _mesh()
    assert mesh.size == 8 == jparallel.make_mesh().size
    assert mesh.group is None and mesh.first == 0
    assert [g for g, _ in mesh.workers()] == list(range(8))
    with pytest.raises(ValueError, match="device"):
        pparallel.make_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pparallel.make_mesh()


def test_sharded_render_matches_single_device():
    jsc, psc, jcam, pcam = _setup()
    kwargs = dict(width=W, height=H, spp=SPP, wave_spp=SPP, max_depth=DEPTH,
                  camera_mode="thinlens")
    got = pparallel.render_sharded(
        psc, pcam, torch.arange(W * H, dtype=torch.int32), rt.key_words(3),
        mesh=_mesh(), options=rt.DEFAULT, **kwargs)
    want = rt.render_pixels(psc, pcam, torch.arange(W * H,
                                                    dtype=torch.int32),
                            rt.key_words(3), options=rt.DEFAULT, **kwargs)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    jgot = jmesh.render_sharded(
        jsc, jcam, jnp.arange(W * H, dtype=jnp.int32), jax.random.key(3),
        mesh=jparallel.make_mesh(), options=JDEFAULT, **kwargs)
    _close_pixels(got.numpy(), jgot)
    with pytest.raises(ValueError, match="divide"):
        pparallel.render_sharded(
            psc, pcam, torch.arange(W * H - 1, dtype=torch.int32),
            rt.key_words(3), mesh=_mesh(), options=rt.DEFAULT, **kwargs)


@pytest.mark.parametrize("width,height", [(W, H), (9, 5)])
def test_sharded_image_matches_host_tiled_render(width, height):
    """(9, 5): 45 pixels do not divide the 8-worker mesh, the pad-and-drop
    path."""
    jsc, psc, _, _ = _setup()
    jcam = jcamera.reference_cuda_camera(W, H)
    pcam = pcamera.reference_cuda_camera(W, H, "cpu")
    cfg = rt.RenderConfig(width=width, height=height, spp=SPP,
                          max_depth=DEPTH, camera_mode="thinlens",
                          options=rt.DEFAULT)
    got = pparallel.render_image_sharded(psc, pcam, cfg, rt.key_words(3),
                                         mesh=_mesh())
    want = rt.render(psc, pcam, cfg, rt.key_words(3), device="cpu")
    assert tuple(got.shape) == (height, width, 3)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    jcfg = JRenderConfig(width=width, height=height, spp=SPP,
                         max_depth=DEPTH, camera_mode="thinlens",
                         options=JDEFAULT)
    jgot = jparallel.render_image_sharded(jsc, jcam, jcfg,
                                          jax.random.key(3))
    _close_pixels(got.numpy().reshape(-1, 3),
                  np.asarray(jgot).reshape(-1, 3))


def test_param_grads_match_through_mesh():
    """The mesh's gradients (autograd summing the workers' shards) against
    the port's one-device gradients and the JAX package's (which marks its
    own test slow; the port's side is cheap)."""
    jsc, psc, jcam, pcam = _setup()
    ids = np.arange(W * H, dtype=np.int32)
    target = np.zeros((W * H, 3), np.float32)
    kwargs = dict(width=W, height=H, spp=SPP, max_depth=DEPTH,
                  camera_mode="thinlens")

    def grads(mesh):
        params = poptim.params_from_scene(psc, ("centers", "albedo"))
        loss = poptim.render_loss(params, psc, pcam,
                                  torch.from_numpy(target),
                                  torch.from_numpy(ids), rt.key_words(3),
                                  options=rt.DEFAULT, mesh=mesh, **kwargs)
        loss.backward()
        return float(loss.detach()), {k: v.grad.numpy()
                                      for k, v in params.items()}

    l1, g1 = grads(None)
    l8, g8 = grads(_mesh())
    np.testing.assert_allclose(l8, l1, rtol=1e-6)
    jparams = joptim.params_from_scene(jsc, ("centers", "albedo"))
    jg = jax.grad(joptim.render_loss)(
        jparams, jsc, jcam, jnp.asarray(target), jnp.asarray(ids),
        jax.random.key(3), options=JDEFAULT, mesh=None, **kwargs)
    for name in g1:
        np.testing.assert_allclose(g8[name], g1[name], rtol=2e-5,
                                   atol=1e-7, err_msg=name)
        assert np.isfinite(g8[name]).all() and np.abs(g8[name]).max() > 0
        np.testing.assert_allclose(g8[name], np.asarray(jg[name]),
                                   rtol=1e-3, atol=1e-6, err_msg=name)


def test_sharded_wavefront_matches_single_device():
    jsc, psc, jcam, pcam = _setup()
    kwargs = dict(width=W, height=H, spp=4, max_depth=DEPTH,
                  camera_mode="thinlens", pool_size=128)
    got = pparallel.render_wavefront_sharded(
        psc, pcam, rt.key_words(3), mesh=_mesh(), options=rt.DEFAULT,
        **kwargs)
    again = pparallel.render_wavefront_sharded(
        psc, pcam, rt.key_words(3), mesh=_mesh(), options=rt.DEFAULT,
        **kwargs)
    assert _sha(got) == _sha(again)  # no float atomics in any fold
    want = rt.render_wavefront(psc, pcam, rt.key_words(3),
                               options=rt.DEFAULT, device="cpu", **kwargs)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-5)
    # one worker: the unsharded frame to the bit
    one = pparallel.render_wavefront_sharded(
        psc, pcam, rt.key_words(3), mesh=_mesh(1), options=rt.DEFAULT,
        **kwargs)
    np.testing.assert_array_equal(one.numpy(), want.numpy())
    jgot = jmesh.render_wavefront_sharded(
        jsc, jcam, jax.random.key(3), mesh=jparallel.make_mesh(),
        options=JDEFAULT, **kwargs)
    cmp = golden.compare_frames(got.numpy(), np.asarray(jgot), atol=3e-5)
    assert cmp["ok"], cmp


def test_tile_ownership_shard_invariant():
    """ownership='tile' + the sorted kernel under the 8-worker mesh: each
    worker owns whole ownership blocks of the shared tile-order task space
    (its block offset in the lanes' first tasks and in the kernel's
    worker_base), every pixel's tasks lie in one worker's range, so the
    sum of the partial frames is the one-worker frame to the bit."""
    o = dataclasses.replace(rt.DEFAULT, ownership="tile", hit_kernel="sorted")
    scene = pscene.huge_scene(0, "cpu")
    w, h = 36, 20
    cam = pcamera.reference_cpu_camera(w, h, "cpu")
    kw = dict(width=w, height=h, spp=4, max_depth=6, camera_mode="thinlens",
              pool_size=2048, options=o)
    a = pparallel.render_wavefront_sharded(scene, cam, rt.key_words(0),
                                           mesh=_mesh(), **kw).numpy()
    b = rt.render_wavefront(scene, cam, rt.key_words(0), device="cpu",
                            **kw).numpy()
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and a.max() > 0.05


def test_sharded_reserve_stealing_matches():
    """Every worker grants only from its own reserve slice: the reserve
    frame against the reserve-off sharded frame within the JAX test's
    bound, and against the JAX package's sharded reserve frame within the
    frame rule."""
    scene = pscene.huge_scene(0, "cpu")
    w, h = 36, 20
    cam = pcamera.reference_cpu_camera(w, h, "cpu")
    kw = dict(width=w, height=h, spp=4, max_depth=4, camera_mode="thinlens",
              pool_size=1024)
    a = pparallel.render_wavefront_sharded(
        scene, cam, rt.key_words(2), mesh=_mesh(), options=rt.DEFAULT,
        **kw).numpy()
    b, st = pparallel.render_wavefront_sharded(
        scene, cam, rt.key_words(2), mesh=_mesh(), options=rt.DEFAULT,
        reserve_frac=0.15, return_stats=True, **kw)
    np.testing.assert_allclose(a, b.numpy(), rtol=2e-6, atol=2e-6)
    assert len(st["workers"]) == 8
    want = jmesh.render_wavefront_sharded(
        jscene.huge_scene(0), jcamera.reference_cpu_camera(w, h),
        jax.random.key(2), mesh=jparallel.make_mesh(), options=JDEFAULT,
        reserve_frac=0.15, **kw)
    cmp = golden.compare_frames(b.numpy(), np.asarray(want), atol=5e-4)
    assert cmp["ok"], cmp


def test_sharded_dual_matches_one_worker():
    """The dual-pool engine over 2 workers (lane0 = w*P + l, stride 2P over
    the granule-scrambled order) against its one-worker frame."""
    scene = pscene.huge_scene(0, "cpu")
    w, h = 36, 20
    cam = pcamera.reference_cpu_camera(w, h, "cpu")
    kw = dict(width=w, height=h, spp=4, max_depth=4, camera_mode="thinlens",
              options=rt.DEFAULT, pool_size=24576)
    a = pparallel.render_wavefront_dual_sharded(
        scene, cam, rt.key_words(2), mesh=_mesh(2), **kw).numpy()
    b = rt.ops.wavefront_dual.render_wavefront_dual(
        scene, cam, rt.key_words(2), device="cpu", **kw).numpy()
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    assert np.isfinite(a).all() and a.max() > 0.05


def test_dryrun_8_workers():
    out = pdryrun.dryrun(8, device="cpu")
    assert out["render_image_sharded"] == [9, 18, 3]
    assert out["render_wavefront_dual_sharded"] == [162, 3]
    assert np.isfinite(out["train_step_loss"])


def test_sum_by_winner_is_split_invariant():
    """The per-sphere sums behind every AD engine's backward accumulate in
    float64 and round once: a sum split over workers (each rounded, then
    added) agrees with the whole to a float32 rounding or two, and the
    whole is the float64 sum rounded (a float32 running sum of 2^17 rows
    drifts ~3e-5 of itself)."""
    from raytracinginoneweekend_tpu_torch.ops import intersect

    g = np.random.default_rng(0)
    n, n_sph = 1 << 17, 5
    idx = torch.from_numpy(g.integers(0, n_sph, n))
    rows = torch.from_numpy(g.normal(0.01, 1.0, (n, 4)).astype(np.float32))
    whole = intersect.sum_by_winner(idx, rows, n_sph)
    exact = torch.zeros((n_sph, 4), dtype=torch.float64).index_add_(
        0, idx, rows.double())
    np.testing.assert_array_equal(whole.numpy(), exact.float().numpy())
    half = n // 2
    split = (intersect.sum_by_winner(idx[:half], rows[:half], n_sph)
             + intersect.sum_by_winner(idx[half:], rows[half:], n_sph))
    ulp = np.spacing(np.abs(exact.numpy()).astype(np.float32))
    assert (np.abs(split.numpy() - whole.numpy()) <= 2 * ulp).all()
    # the gather's backward takes the same sums
    table = torch.zeros((n_sph, 4), requires_grad=True)
    intersect.gather_rows(table, idx).mul(rows).sum().backward()
    np.testing.assert_array_equal(table.grad.numpy(), whole.numpy())
