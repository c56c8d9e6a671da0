"""PyTorch port vs the JAX package: the regenerative AD pool
(ops/wavefront_ad.py) and the ``engine="wavefront"`` / ``"auto"`` wiring.

The port's pool on the CPU (its closest hit is the plain version of kernel
1 under the planar engine's ``autograd.Function``) against the JAX
package's ``render_pixels_wavefront_ad`` (the Pallas segment kernel in
interpret mode), the same pixel ids and keys, at the JAX package's own
test shape (tests/test_wavefront_ad.py: 24x16, 4 spp, depth 6, the simple
scene).

Tolerances, and why:
  * pixels against the JAX pool and against the port's planar engine:
    rtol 1e-4 / atol 2e-5, the JAX package's own tolerance between its
    pool and its fixed-depth engine (XLA:CPU contracts multiply-adds that
    the port rounds separately);
  * inside the port: BIT-EQUAL across pool sizes, epoch lengths and the
    flat budget in both remat modes -- every ray's radiance is computed by
    the same operations whatever the schedule, and each ray's ledger cell
    is written once;
  * gradients against ``jax.grad``: every element within 2e-4 of the
    row's largest |gradient| over the leaf (tests/test_wavefront_ad.py's
    measure between engines): per-sphere sums of per-lane terms taken in
    another order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginoneweekend_tpu import config as jconfig
from raytracinginoneweekend_tpu import optim as joptim
from raytracinginoneweekend_tpu.models import camera as jcamera
from raytracinginoneweekend_tpu.models import scene as jscene
from raytracinginoneweekend_tpu.ops import wavefront_ad as jad
from raytracinginoneweekend_tpu_torch import config as pconfig
from raytracinginoneweekend_tpu_torch import optim as poptim
from raytracinginoneweekend_tpu_torch.models import camera as pcamera
from raytracinginoneweekend_tpu_torch.models import scene as pscene
from raytracinginoneweekend_tpu_torch.ops import integrate_planar as pplanar
from raytracinginoneweekend_tpu_torch.ops import threefry as ptf
from raytracinginoneweekend_tpu_torch.ops import wavefront_ad as pad
from raytracinginoneweekend_tpu_torch.optim import inverse as pinverse

# Several test workers share the machine's cores (see
# tests/test_torch_segment_variants.py): two intra-op threads each.
torch.set_num_threads(2)

W, H, SPP, DEPTH = 24, 16, 4, 6


def _ids(n=256, seed=3):
    return np.random.default_rng(seed).permutation(W * H)[:n].astype(
        np.int32)


def _port(ids, key, options, scene=None, **kw):
    args = dict(width=W, height=H, spp=SPP, max_depth=DEPTH,
                camera_mode="thinlens")
    args.update(kw)
    return pad.render_pixels_wavefront_ad(
        scene or pscene.simple_scene_cuda("cpu"),
        pcamera.reference_cuda_camera(W, H, "cpu"), torch.from_numpy(ids),
        ptf.key_words(key), options=options, **args)


def _port_planar(ids, key, options, **kw):
    args = dict(width=W, height=H, spp=SPP, max_depth=DEPTH,
                camera_mode="thinlens")
    args.update(kw)
    return pplanar.render_pixels_planar(
        pscene.simple_scene_cuda("cpu"),
        pcamera.reference_cuda_camera(W, H, "cpu"), torch.from_numpy(ids),
        ptf.key_words(key), options=options, **args)


@pytest.mark.parametrize("mode,compat", [("thinlens", "default"),
                                         ("cuda", "reference-cuda")])
def test_matches_the_jax_pool_and_the_planar_engine(mode, compat):
    jopt = {"default": jconfig.DEFAULT,
            "reference-cuda": jconfig.REFERENCE_CUDA}[compat]
    popt = {"default": pconfig.DEFAULT,
            "reference-cuda": pconfig.REFERENCE_CUDA}[compat]
    ids = _ids()
    want = np.asarray(jad.render_pixels_wavefront_ad(
        jscene.simple_scene_cuda(), jcamera.reference_cuda_camera(W, H),
        jnp.asarray(ids), jax.random.key(7), width=W, height=H, spp=SPP,
        max_depth=DEPTH, camera_mode=mode, options=jopt, pool_size=1024))
    got = _port(ids, 7, popt, camera_mode=mode, pool_size=1024).numpy()
    assert got.shape == (256, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
    planar = _port_planar(ids, 7, popt, camera_mode=mode).numpy()
    np.testing.assert_allclose(got, planar, rtol=1e-4, atol=2e-5)


def test_pool_size_and_epoch_len_bit_invariance():
    """The regeneration schedule changes no ray's radiance: pools of 1, 2
    and 4 waves, and epochs of 4 and 16 iterations, give the same bits."""
    ids = _ids()
    base = _port(ids, 5, pconfig.DEFAULT, pool_size=1024).numpy()
    for kw in (dict(pool_size=256), dict(pool_size=512),
               dict(pool_size=512, epoch_len=4)):
        np.testing.assert_array_equal(
            _port(ids, 5, pconfig.DEFAULT, **kw).numpy(), base, str(kw))


def test_depth_exhaustion_and_stratified_match_the_planar_engine():
    """max_depth 1 and 2 (depth-out kills without a deposit) and the
    first-bounce stratified substitution, against the fixed-depth engine."""
    ids = _ids()
    for depth in (1, 2):
        got = _port(ids, 9, pconfig.DEFAULT, max_depth=depth,
                    camera_mode="cuda", pool_size=512).numpy()
        want = _port_planar(ids, 9, pconfig.DEFAULT, max_depth=depth,
                            camera_mode="cuda").numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
    strat = dataclasses.replace(pconfig.DEFAULT, sampling="stratified")
    np.testing.assert_allclose(
        _port(ids, 2, strat, pool_size=512).numpy(),
        _port_planar(ids, 2, strat).numpy(), rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("remat", ["none", "step"])
def test_flat_budget_equals_epoch_mode(remat):
    """A budget that covers the batch, run flat, gives the epoch
    structure's pixels and albedo gradient bit for bit."""
    ids = _ids()
    scene = pscene.simple_scene_cuda("cpu")
    kw = dict(camera_mode="cuda", pool_size=512)

    def img_grad(**extra):
        albedo = scene.albedo.clone().requires_grad_(True)
        img = _port(ids, 0, pconfig.DEFAULT,
                    scene=scene._replace(albedo=albedo), **kw, **extra)
        (img ** 2).sum().backward()
        return img.detach().numpy(), albedo.grad.numpy()

    base_img, base_grad = img_grad()
    img, grad = img_grad(iters=24, remat=remat)
    np.testing.assert_array_equal(img, base_img)
    np.testing.assert_array_equal(grad, base_grad)


def test_done_and_budget_equal_the_jax_values():
    ids = _ids()
    kw = dict(width=W, height=H, spp=SPP, max_depth=DEPTH,
              camera_mode="cuda", pool_size=512)
    jargs = (jscene.simple_scene_cuda(), jcamera.reference_cuda_camera(W, H),
             jnp.asarray(ids), jax.random.key(0))
    pargs = (pscene.simple_scene_cuda("cpu"),
             pcamera.reference_cuda_camera(W, H, "cpu"),
             torch.from_numpy(ids), ptf.key_words(0))
    for iters in (4, 24):
        want = bool(jad.wavefront_ad_done(*jargs, iters=iters,
                                          options=jconfig.DEFAULT, **kw))
        got = pad.wavefront_ad_done(*pargs, iters=iters,
                                    options=pconfig.DEFAULT, **kw)
        assert got is want, iters
    assert want and not pad.wavefront_ad_done(
        *pargs, iters=4, options=pconfig.DEFAULT, **kw)
    budget = pad.wavefront_ad_budget(*pargs, options=pconfig.DEFAULT, **kw)
    assert budget == jad.wavefront_ad_budget(*jargs,
                                             options=jconfig.DEFAULT, **kw)
    assert pad.wavefront_ad_done(*pargs, iters=budget,
                                 options=pconfig.DEFAULT, **kw)
    # a truncating budget is reported when asked for, and renders black
    with pytest.warns(UserWarning, match="TRUNCATED"):
        short = _port(ids, 0, pconfig.DEFAULT, camera_mode="cuda",
                      pool_size=512, iters=2, debug_check_complete=True)
    full = _port(ids, 0, pconfig.DEFAULT, camera_mode="cuda",
                 pool_size=512)
    assert float(short.sum()) < float(full.sum())


@pytest.mark.parametrize("epoch_len", [1, 2])
def test_pad_lane_drain_at_an_epoch_boundary_equals_the_jax_values(
        epoch_len):
    """1030 rays on a pool of 1024 lanes: the second wave holds 6 real
    rays, and every other lane's next ray is pad. With this key the last
    ray to finish is such a lane's first, at an epoch boundary: the state
    before its regen still shows the lane's unacquired pad ray, so the
    JAX package works one epoch more, and the port's shade op, which
    parks the lane in its own regen, must count it too (its ``busy``).
    The epoch count, ``done`` on each side of the budget, and the pixels
    against the JAX pool."""
    ids = _ids(206)
    kw = dict(width=W, height=H, spp=5, max_depth=DEPTH, camera_mode="cuda",
              pool_size=1024)
    pid, sid, rows, n = jad._wave_layout(jnp.asarray(ids), 5, 1024)
    assert pid.shape[0] == 2 and n == 1030
    jargs = (jscene.simple_scene_cuda(), jcamera.reference_cuda_camera(W, H))
    pargs = (pscene.simple_scene_cuda("cpu"),
             pcamera.reference_cuda_camera(W, H, "cpu"),
             torch.from_numpy(ids), ptf.key_words(3))
    jled, (jdone, jbudget) = jad.trace_wavefront_ad(
        *jargs, pid, sid, jax.random.key(3), n=n, rows=rows,
        epoch_len=epoch_len, return_done=True, options=jconfig.DEFAULT,
        **{k: v for k, v in kw.items() if k != "pool_size"})
    budget = pad.wavefront_ad_budget(*pargs, options=pconfig.DEFAULT,
                                     epoch_len=epoch_len, **kw)
    assert bool(jdone) and budget == int(jbudget)
    for iters in (budget - epoch_len, budget):
        want = bool(jad.wavefront_ad_done(
            *jargs, jnp.asarray(ids), jax.random.key(3), iters=iters,
            options=jconfig.DEFAULT, **kw))
        got = pad.wavefront_ad_done(*pargs, iters=iters,
                                    options=pconfig.DEFAULT, **kw)
        assert got is want is (iters == budget), iters
    want = np.stack([np.asarray(c).reshape(-1)[:n].reshape(206, 5).mean(1)
                     for c in jled], -1)
    got = pad.render_pixels_wavefront_ad(*pargs, options=pconfig.DEFAULT,
                                         epoch_len=epoch_len, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)


def _grads(rr: bool):
    g = np.random.default_rng(4)
    ids = g.permutation(W * H)[:128].astype(np.int32)
    target = np.full((128, 3), 0.3, np.float32)
    changes = dict(rr_terminate=rr, rr_start=2, rr_scale=1.0)
    kw = dict(width=W, height=H, spp=2, max_depth=4, camera_mode="cuda")
    names = ("albedo", "centers", "radii", "fuzz", "ior")
    jsc = jscene.simple_scene_cuda()
    arrays = {k: np.asarray(getattr(jsc, k)) for k in names}
    want = jax.grad(joptim.render_loss)(
        {k: jnp.asarray(v) for k, v in arrays.items()}, jsc,
        jcamera.reference_cuda_camera(W, H), jnp.asarray(target),
        jnp.asarray(ids), jax.random.key(4), engine="wavefront",
        options=dataclasses.replace(jconfig.DEFAULT, **changes), **kw)
    params = poptim.params_from_numpy(arrays, device="cpu")
    loss = poptim.render_loss(
        params, pscene.simple_scene_cuda("cpu"),
        pcamera.reference_cuda_camera(W, H, "cpu"), torch.from_numpy(target),
        torch.from_numpy(ids), ptf.key_words(4), engine="wavefront",
        options=dataclasses.replace(pconfig.DEFAULT, **changes), **kw)
    loss.backward()
    return {k: (params[k].grad.numpy(), np.asarray(want[k]))
            for k in names}


@pytest.mark.parametrize("rr", [False, True], ids=["rr_off", "rr_on"])
def test_gradients_match_jax(rr):
    for name, (got, want) in _grads(rr).items():
        assert np.isfinite(got).all(), name
        scale = max(np.abs(want).max(), 1e-8)
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got / scale, want / scale, atol=2e-4,
                                   err_msg=name)


def test_rr_terminate_parity_with_the_jax_pool_and_the_planar_engine():
    """rr_terminate consumes the same (TAG_BOUNCE + b, counter 2) draw in
    the pool as in the fixed-depth engine and the JAX pool."""
    opts = dict(rr_terminate=True, rr_start=2, rr_scale=1.0)
    ids = np.arange(W * H, dtype=np.int32)
    kw = dict(max_depth=8, pool_size=512)
    want = np.asarray(jad.render_pixels_wavefront_ad(
        jscene.simple_scene_cuda(), jcamera.reference_cuda_camera(W, H),
        jnp.asarray(ids), jax.random.key(3), width=W, height=H, spp=SPP,
        camera_mode="thinlens",
        options=dataclasses.replace(jconfig.DEFAULT, **opts), **kw))
    popt = dataclasses.replace(pconfig.DEFAULT, **opts)
    got = _port(ids, 3, popt, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(
        got, _port_planar(ids, 3, popt, max_depth=8).numpy(), rtol=1e-4,
        atol=2e-5)


def test_auto_selects_the_pool_above_the_crossover():
    """'auto' resolves as the JAX package's does (depth 32, 28 with rr),
    and is pure dispatch: the same loss and gradient as the explicit
    engine, bit for bit."""
    assert pinverse.AD_ENGINE_AUTO_DEPTH == 32
    assert pinverse.AD_ENGINE_AUTO_DEPTH_RR == 28
    for depth, rr in ((32, False), (33, False), (28, True), (29, True),
                      (50, False)):
        assert (pinverse.resolve_ad_engine(depth, rr)
                == jinverse_resolve(depth, rr)), (depth, rr)
    assert pinverse.resolve_ad_engine(33) == "wavefront"
    assert pinverse.resolve_ad_engine(29, rr_terminate=True) == "wavefront"
    psc = pscene.simple_scene_cuda("cpu")
    ids = torch.from_numpy(_ids(64, seed=5))
    target = torch.full((64, 3), 0.2)
    for depth, rr in ((33, False), (29, True)):
        options = dataclasses.replace(pconfig.REFERENCE_CUDA,
                                      rr_terminate=rr)
        out = {}
        for engine in ("auto", "wavefront"):
            params = poptim.params_from_scene(psc, ("albedo",))
            loss = poptim.render_loss(
                params, psc, pcamera.reference_cuda_camera(W, H, "cpu"),
                target, ids, ptf.key_words(5), width=W, height=H, spp=2,
                max_depth=depth, camera_mode="cuda", options=options,
                engine=engine)
            loss.backward()
            out[engine] = (float(loss.detach()), params["albedo"].grad.numpy())
        assert out["auto"][0] == out["wavefront"][0], (depth, rr)
        np.testing.assert_array_equal(out["auto"][1], out["wavefront"][1])


def jinverse_resolve(depth, rr):
    from raytracinginoneweekend_tpu.optim.inverse import resolve_ad_engine
    return resolve_ad_engine(depth, rr_terminate=rr)


def test_backward_never_relaunches_the_closest_hit(monkeypatch):
    """The kernel's outputs are recorded on an epoch's first run and
    replayed when backward recomputes it: one closest hit per pool
    iteration, forward and backward together."""
    calls = []
    real = pplanar.segment_closest_hit

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(pplanar, "segment_closest_hit", counting)
    ids = _ids()
    scene = pscene.simple_scene_cuda("cpu")
    leaves = {k: getattr(scene, k).clone().requires_grad_(True)
              for k in ("centers", "radii", "albedo", "fuzz", "ior")}
    out = _port(ids, 1, pconfig.DEFAULT, scene=scene._replace(**leaves),
                pool_size=256, epoch_len=4)
    n_forward = len(calls)
    budget = pad.wavefront_ad_budget(
        scene, pcamera.reference_cuda_camera(W, H, "cpu"),
        torch.from_numpy(ids), ptf.key_words(1), width=W, height=H,
        spp=SPP, max_depth=DEPTH, camera_mode="thinlens",
        options=pconfig.DEFAULT, pool_size=256, epoch_len=4)
    assert n_forward == budget > 0
    out.square().sum().backward()
    assert len(calls) == 2 * n_forward  # + the budget probe's forward
    for k, v in leaves.items():
        assert v.grad is not None and bool(torch.isfinite(v.grad).all()), k
        assert float(v.grad.abs().max()) > 0, k


def test_wave_layout_matches_jax():
    for n_px, spp, pool in ((256, 4, 1024), (37, 3, 64), (384, 4, 1 << 15)):
        ids = np.arange(n_px, dtype=np.int32)[::-1].copy()
        want = jad._wave_layout(jnp.asarray(ids), spp, pool)
        got = pad._wave_layout(torch.from_numpy(ids), spp, pool)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[2:] == tuple(int(x) for x in want[2:])
    assert pad.EPOCH_LEN == jad.EPOCH_LEN
    assert pad._RES_BYTES_PER_LANE_ITER == jad._RES_BYTES_PER_LANE_ITER
    assert pad._NOREMAT_CAP_BYTES == jad._NOREMAT_CAP_BYTES
    with pytest.raises(ValueError, match="remat"):
        _port(_ids(), 0, pconfig.DEFAULT, iters=4, remat="epoch")
