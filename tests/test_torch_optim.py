"""PyTorch port vs the JAX package: inverse rendering (the training path).

``render_loss`` (value and per-leaf gradients), ``render_pixels_vjp``,
three optimiser steps and the checkpoint file of the port on the CPU
against the JAX package with optax, from the same parameters, pixel ids and
keys. Tolerances: loss rtol 1e-5; gradients rtol 1e-3 / atol 1e-6 (the JAX
package's own planar-vs-tiled tolerance: sums of ~1e3 per-ray terms taken
in two orders); parameters after three Adam steps rtol 1e-4 / atol 2e-6
(Adam divides by sqrt(v): a relative gradient difference of 1e-3 moves a
step of size lr by less than lr * 1e-3).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raytracinginoneweekend_tpu import config as jconfig
from raytracinginoneweekend_tpu import optim as joptim
from raytracinginoneweekend_tpu.models import camera as jcamera
from raytracinginoneweekend_tpu.models import scene as jscene
from raytracinginoneweekend_tpu.optim import inverse as jinverse
from raytracinginoneweekend_tpu_torch import config as pconfig
from raytracinginoneweekend_tpu_torch import optim as poptim
from raytracinginoneweekend_tpu_torch.models import camera as pcamera
from raytracinginoneweekend_tpu_torch.models import scene as pscene
from raytracinginoneweekend_tpu_torch.ops import threefry as ptf
from raytracinginoneweekend_tpu_torch.optim import inverse as pinverse

W, H = 16, 12
NAMES = ("albedo", "centers", "radii", "fuzz", "ior")
KW = dict(width=W, height=H, spp=2, max_depth=3, camera_mode="pinhole")


def _setup(seed=0):
    g = np.random.default_rng(seed)
    jsc, psc = jscene.simple_scene_cuda(), pscene.simple_scene_cuda("cpu")
    jcam = jcamera.reference_cuda_camera(W, H)
    pcam = pcamera.reference_cuda_camera(W, H, "cpu")
    ids = g.permutation(W * H)[:96].astype(np.int32)
    target = g.uniform(0, 1, (96, 3)).astype(np.float32)
    return jsc, psc, jcam, pcam, ids, target


def _numpy_params(jsc, names=NAMES):
    return {k: np.asarray(getattr(jsc, k)) for k in names}


@pytest.mark.parametrize("sampling,rr", [("iid", False), ("iid", True),
                                         ("stratified", False),
                                         ("stratified", True)])
@pytest.mark.parametrize("engine", ["tiled", "planar"])
def test_render_loss_value_and_gradients_match_jax(engine, sampling, rr):
    jsc, psc, jcam, pcam, ids, target = _setup()
    changes = dict(sampling=sampling, rr_terminate=rr, rr_start=1)
    jopt = dataclasses.replace(jconfig.DEFAULT, **changes)
    popt = dataclasses.replace(pconfig.DEFAULT, **changes)
    arrays = _numpy_params(jsc)
    want_l, want_g = jax.value_and_grad(joptim.render_loss)(
        {k: jnp.asarray(v) for k, v in arrays.items()}, jsc, jcam,
        jnp.asarray(target), jnp.asarray(ids), jax.random.key(7),
        options=jopt, engine=engine, **KW)
    params = poptim.params_from_numpy(arrays, device="cpu")
    loss = poptim.render_loss(params, psc, pcam, torch.from_numpy(target),
                              torch.from_numpy(ids), ptf.key_words(7),
                              options=popt, engine=engine, **KW)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_l),
                               rtol=1e-5)
    for name in NAMES:
        want = np.asarray(want_g[name])
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(params[name].grad.numpy(), want,
                                   rtol=1e-3, atol=1e-6, err_msg=name)


def test_render_pixels_vjp_matches_jax():
    jsc, psc, jcam, pcam, ids, cot = _setup(1)
    arrays = _numpy_params(jsc)
    want_g, want_px = joptim.render_pixels_vjp(
        {k: jnp.asarray(v) for k, v in arrays.items()}, jsc, jcam,
        jnp.asarray(cot), jnp.asarray(ids), jax.random.key(3),
        options=jconfig.DEFAULT, engine="planar", **KW)
    params = poptim.params_from_numpy(arrays, device="cpu")
    got_g, got_px = poptim.render_pixels_vjp(
        params, psc, pcam, cot, torch.from_numpy(ids), ptf.key_words(3),
        options=pconfig.DEFAULT, engine="planar", **KW)
    assert not got_px.requires_grad
    np.testing.assert_allclose(got_px.numpy(), np.asarray(want_px),
                               rtol=1e-4, atol=2e-5)
    for name in NAMES:
        np.testing.assert_allclose(got_g[name].numpy(),
                                   np.asarray(want_g[name]), rtol=1e-3,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("engine", ["auto", "tiled"])
def test_three_train_steps_match_optax(engine):
    """The same parameters, optimiser state, pixel ids and keys through
    both packages' train step, three times over."""
    jsc, psc, jcam, pcam, _, _ = _setup()
    names = ("albedo", "centers")
    arrays = _numpy_params(jsc, names)
    g = np.random.default_rng(5)
    arrays["albedo"] = np.clip(arrays["albedo"] + g.normal(
        size=arrays["albedo"].shape).astype(np.float32) * 0.1, 0.05, 0.95)
    lr = 1e-2

    jopt = optax.adam(lr)
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    jstate = jopt.init(jparams)
    jstep = joptim.make_train_step(jopt, options=jconfig.DEFAULT,
                                   engine=engine, **KW)

    params = poptim.params_from_numpy(arrays, device="cpu")
    opt = pinverse.make_adam(params, lr)
    pstep = poptim.make_train_step(opt, options=pconfig.DEFAULT,
                                   engine=engine, **KW)
    for i in range(3):
        ids = g.permutation(W * H)[:96].astype(np.int32)
        target = g.uniform(0, 1, (96, 3)).astype(np.float32)
        jparams, jstate, jloss = jstep(
            jparams, jstate, jsc, jcam, jnp.asarray(target),
            jnp.asarray(ids), jax.random.key(100 + i))
        ploss = pstep(params, psc, pcam, torch.from_numpy(target),
                      torch.from_numpy(ids), ptf.key_words(100 + i))
        assert not ploss.requires_grad
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5)
        for k in names:
            moved = np.abs(np.asarray(jparams[k]) - arrays[k]).max()
            assert moved > 0.5 * lr  # Adam's first steps are ~lr
            np.testing.assert_allclose(params[k].detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-4,
                                       atol=2e-6, err_msg=f"{k} step {i}")
    # the optimiser state, in optax's layout
    state = poptim.adam_state_to_numpy(opt, params)
    jadam = jstate[0]
    assert int(state["count"]) == int(jadam.count) == 3
    for k in names:
        np.testing.assert_allclose(state["mu"][k], np.asarray(jadam.mu[k]),
                                   rtol=1e-3, atol=1e-7)
        np.testing.assert_allclose(state["nu"][k], np.asarray(jadam.nu[k]),
                                   rtol=2e-3, atol=1e-10)


def test_adam_state_carries_across_and_continues_like_optax():
    """optax's (count, mu, nu) -> the port's Adam -> one more step, equal
    to the bit with optax's update under jax.jit (the form the JAX
    package's train step runs)."""
    g = np.random.default_rng(2)
    arrays = {"albedo": g.random((4, 3), dtype=np.float32),
              "radii": g.random(5, dtype=np.float32)}
    grads = [{k: g.normal(size=v.shape).astype(np.float32)
              for k, v in arrays.items()} for _ in range(3)]
    jopt = optax.adam(3e-2)

    @jax.jit
    def update(p, s, gr):
        u, s = jopt.update(gr, s, p)
        return optax.apply_updates(p, u), s

    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    jstate = jopt.init(jparams)
    for gr in grads[:2]:
        jparams, jstate = update(
            jparams, jstate, {k: jnp.asarray(v) for k, v in gr.items()})
    params = poptim.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    opt = pinverse.make_adam(params, 3e-2)
    poptim.adam_state_from_numpy(opt, params, {
        "count": np.asarray(jstate[0].count),
        "mu": {k: np.asarray(v) for k, v in jstate[0].mu.items()},
        "nu": {k: np.asarray(v) for k, v in jstate[0].nu.items()}})
    back = poptim.adam_state_to_numpy(opt, params)
    assert int(back["count"]) == 2
    np.testing.assert_array_equal(back["mu"]["radii"],
                                  np.asarray(jstate[0].mu["radii"]))
    jparams, jstate = update(
        jparams, jstate, {k: jnp.asarray(v) for k, v in grads[2].items()})
    for k, p in params.items():
        p.grad = torch.from_numpy(grads[2][k])
    opt.step()
    # optax's float32 bias correction, its fused multiply-adds and XLA's
    # regrouped division: the same bits (tests/test_torch_fit_draws.py)
    for k in arrays:
        np.testing.assert_array_equal(params[k].detach().numpy(),
                                      np.asarray(jparams[k]))
    state = poptim.adam_state_to_numpy(opt, params)
    assert int(state["count"]) == 3
    for k in arrays:
        np.testing.assert_array_equal(state["nu"][k],
                                      np.asarray(jstate[0].nu[k]))
    # a fresh optimiser reads as zeros
    fresh = poptim.adam_state_to_numpy(pinverse.make_adam(params, 1e-2),
                                       params)
    assert int(fresh["count"]) == 0 and not fresh["mu"]["albedo"].any()


def test_checkpoint_round_trip_and_both_packages_read_it(tmp_path):
    psc = pscene.simple_scene_cuda("cpu")
    params = poptim.params_from_scene(psc, ("centers", "albedo"))
    opt = pinverse.make_adam(params, 1e-2)
    for p in params.values():
        p.grad = torch.full_like(p, 0.25)
    opt.step()
    path = str(tmp_path / "ck.npz")
    poptim.save_checkpoint(path, params, opt, 17)
    assert not os.path.exists(path + ".tmp")
    with np.load(path) as data:
        assert sorted(data.files) == sorted(
            ["__step__", "p0", "p1", "o0", "o1", "o2", "o3", "o4"])
        assert data["__step__"].dtype == np.int64
        assert data["o0"].dtype == np.int32 and int(data["o0"]) == 1
        np.testing.assert_array_equal(  # sorted names: albedo first
            data["p0"], params["albedo"].detach().numpy())
    p2, o2, step = poptim.load_checkpoint(
        path, poptim.params_from_scene(psc, ("centers", "albedo")))
    assert step == 17 and all(v.requires_grad for v in p2.values())
    for k in params:
        np.testing.assert_array_equal(p2[k].detach().numpy(),
                                      params[k].detach().numpy())
    state = poptim.adam_state_to_numpy(opt, params)
    for k in params:
        np.testing.assert_array_equal(o2["mu"][k], state["mu"][k])
        np.testing.assert_array_equal(o2["nu"][k], state["nu"][k])
    # the JAX package reads the same file with its own templates
    jsc = jscene.simple_scene_cuda()
    jt = joptim.params_from_scene(jsc, ("centers", "albedo"))
    jp, jo, jstep = joptim.load_checkpoint(path, jt,
                                           optax.adam(1e-2).init(jt))
    assert jstep == 17 and int(jo[0].count) == 1
    np.testing.assert_array_equal(np.asarray(jp["centers"]),
                                  params["centers"].detach().numpy())
    np.testing.assert_array_equal(np.asarray(jo[0].nu["albedo"]),
                                  state["nu"]["albedo"])
    # and the port reads a file the JAX package wrote
    jpath = str(tmp_path / "jax.npz")
    joptim.save_checkpoint(jpath, jp, jo, 23)
    p3, o3, step3 = poptim.load_checkpoint(jpath, params)
    assert step3 == 23 and int(o3["count"]) == 1
    np.testing.assert_array_equal(p3["albedo"].detach().numpy(),
                                  params["albedo"].detach().numpy())


@pytest.mark.parametrize("what", ["shape", "dtype"])
def test_checkpoint_mismatch_raises(tmp_path, what):
    psc = pscene.simple_scene_cuda("cpu")
    params = poptim.params_from_scene(psc, ("albedo",))
    path = str(tmp_path / "ck.npz")
    poptim.save_checkpoint(path, params, pinverse.make_adam(params, 1e-2),
                           1)
    if what == "shape":
        tmpl = {"albedo": torch.zeros((2, 3))}
    else:
        tmpl = {"albedo": params["albedo"].detach().to(torch.float64)}
    with pytest.raises(ValueError, match=what):
        poptim.load_checkpoint(path, tmpl)


def _fit_setup():
    psc = pscene.simple_scene_cuda("cpu")
    pcam = pcamera.reference_cuda_camera(W, H, "cpu")
    cfg = pconfig.RenderConfig(width=W, height=H, spp=4, max_depth=4,
                               camera_mode="pinhole")
    from raytracinginoneweekend_tpu_torch.render import render as prender

    target = prender(psc, pcam, cfg, ptf.key_words(0), device="cpu")
    bad = psc.albedo.clone()
    bad[0] = torch.tensor([0.9, 0.9, 0.9])
    return psc, psc._replace(albedo=bad), pcam, cfg, target


def test_fit_recovers_a_perturbed_albedo_and_resumes(tmp_path):
    truth, bad, pcam, cfg, target = _fit_setup()
    kw = dict(which=("albedo",), learning_rate=5e-2, batch_pixels=W * H,
              spp=4, device="cpu")
    seen = []
    scene, params, opt, losses = poptim.fit(
        bad, pcam, target, cfg, steps=30,
        callback=lambda i, p, o, l: seen.append((i, l)), **kw)
    assert [i for i, _ in seen] == list(range(30))
    # (the JAX package's own bar for this recovery: tests/test_optim.py)
    assert losses[-1] < 0.5 * losses[0]
    err0 = float((bad.albedo[0] - truth.albedo[0]).abs().max())
    err = float((params["albedo"][0].detach()
                 - truth.albedo[0]).abs().max())
    assert err < 0.5 * err0
    assert torch.equal(scene.albedo, params["albedo"])
    assert not bad.albedo.requires_grad  # the scene given stays as it was
    # 4 + 3 resumed steps == 7 steps (same step keys, batches and state)
    _, p7, _, l7 = poptim.fit(bad, pcam, target, cfg, steps=7, **kw)
    _, p4, o4, _ = poptim.fit(bad, pcam, target, cfg, steps=4, **kw)
    path = str(tmp_path / "ck.npz")
    poptim.save_checkpoint(path, p4, o4, 4)
    p0, o0, step0 = poptim.load_checkpoint(
        path, poptim.params_from_scene(bad, ("albedo",)))
    _, p43, _, l43 = poptim.fit(bad, pcam, target, cfg, steps=3,
                                init_params=p0, init_opt_state=o0,
                                start_step=step0, **kw)
    np.testing.assert_allclose(l43, l7[4:], rtol=1e-6)
    np.testing.assert_allclose(p43["albedo"].detach().numpy(),
                               p7["albedo"].detach().numpy(), rtol=1e-6,
                               atol=1e-7)


def test_fit_planar_default_matches_tiled():
    _, bad, pcam, cfg, target = _fit_setup()
    kw = dict(which=("albedo",), steps=4, learning_rate=5e-2,
              batch_pixels=64, spp=2, device="cpu")
    _, p_planar, _, _ = poptim.fit(bad, pcam, target, cfg, **kw)
    _, p_tiled, _, _ = poptim.fit(bad, pcam, target, cfg, engine="tiled",
                                  **kw)
    np.testing.assert_allclose(p_planar["albedo"].detach().numpy(),
                               p_tiled["albedo"].detach().numpy(),
                               rtol=1e-3, atol=1e-5)


def test_pixel_batches_are_distinct_and_reproducible():
    key = pinverse.step_keys(ptf.key_words(7), 3)[0]
    a = pinverse.draw_pixel_batch(key, 1000, 256, torch.device("cpu"))
    b = pinverse.draw_pixel_batch(key, 1000, 256, torch.device("cpu"))
    assert a.dtype == torch.int32 and torch.equal(a, b)
    assert len(set(a.tolist())) == 256 and 0 <= int(a.min())
    assert int(a.max()) < 1000
    other = pinverse.step_keys(ptf.key_words(7), 4)[0]
    assert not torch.equal(a, pinverse.draw_pixel_batch(
        other, 1000, 256, torch.device("cpu")))


def test_engine_policy_and_parameter_helpers():
    assert poptim.DIFFERENTIABLE_LEAVES == joptim.DIFFERENTIABLE_LEAVES
    assert poptim.AD_ENGINE_AUTO_DEPTH == jinverse.AD_ENGINE_AUTO_DEPTH
    assert (poptim.AD_ENGINE_AUTO_DEPTH_RR
            == jinverse.AD_ENGINE_AUTO_DEPTH_RR)
    for depth in (1, 16, 28, 29, 32, 33, 50):
        for rr in (False, True):
            assert poptim.resolve_ad_engine(depth, rr) == \
                jinverse.resolve_ad_engine(depth, rr)
    psc = pscene.simple_scene_cuda("cpu")
    with pytest.raises(ValueError, match="non-differentiable"):
        poptim.params_from_scene(psc, ("mtype",))
    with pytest.raises(ValueError, match="non-differentiable"):
        poptim.params_from_numpy({"mtype": np.zeros(3)}, device="cpu")
    params = poptim.params_from_scene(psc, ("radii",))
    assert params["radii"].requires_grad and params["radii"].is_leaf
    assert params["radii"].data_ptr() != psc.radii.data_ptr()
    swapped = poptim.scene_with_params(psc, params)
    assert swapped.radii is params["radii"]
    assert swapped.centers is psc.centers
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            poptim.params_from_numpy({"radii": np.zeros(3)})


def test_mesh_at_every_entry():
    """mesh= splits the batch over a 2-worker CPU mesh at every entry:
    render_loss and render_pixels_vjp give the one-device value and
    gradients within rtol 2e-5 / atol 1e-7 (tests/test_parallel.py's
    bound), the train step the same parameters, and fit rounds the batch
    to the mesh's multiple."""
    from raytracinginoneweekend_tpu_torch import parallel

    _, psc, _, pcam, ids, target = _setup()
    mesh = parallel.make_mesh([torch.device("cpu")] * 2)
    kw = dict(KW, options=pconfig.DEFAULT)
    args = (psc, pcam, torch.from_numpy(target), torch.from_numpy(ids),
            ptf.key_words(0))

    def loss_grads(m):
        params = poptim.params_from_scene(psc, ("albedo", "centers"))
        loss = poptim.render_loss(params, *args, mesh=m, **kw)
        loss.backward()
        return float(loss.detach()), {k: v.grad for k, v in params.items()}

    def vjp(m):
        params = poptim.params_from_scene(psc, ("albedo", "centers"))
        return poptim.render_pixels_vjp(params, *args, mesh=m, **kw)

    def stepped(m):
        params = poptim.params_from_scene(psc, ("albedo", "centers"))
        step = poptim.make_train_step(pinverse.make_adam(params, 1e-2),
                                      mesh=m, **kw)
        step(params, *args)
        return params

    (l1, g1), (l2, g2) = loss_grads(None), loss_grads(mesh)
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    (v1, p1), (v2, p2) = vjp(None), vjp(mesh)
    np.testing.assert_array_equal(p2.numpy(), p1.numpy())
    s1, s2 = stepped(None), stepped(mesh)
    for k in g1:
        np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(), rtol=2e-5,
                                   atol=1e-7, err_msg=k)
        np.testing.assert_allclose(v2[k].numpy(), v1[k].numpy(), rtol=2e-5,
                                   atol=1e-7, err_msg=k)
        np.testing.assert_allclose(s2[k].detach().numpy(),
                                   s1[k].detach().numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    with pytest.raises(ValueError, match="divide"):
        poptim.render_loss(poptim.params_from_scene(psc, ("albedo",)),
                           psc, pcam, torch.from_numpy(target[:95]),
                           torch.from_numpy(ids[:95]), ptf.key_words(0),
                           mesh=mesh, **kw)
    three = parallel.make_mesh([torch.device("cpu")] * 3)
    cfg = pconfig.RenderConfig(width=4, height=5, spp=1, max_depth=2,
                               camera_mode="pinhole")
    cam = pcamera.reference_cuda_camera(4, 5, "cpu")
    _, _, _, losses = poptim.fit(psc, cam, torch.zeros((5, 4, 3)), cfg,
                                 which=("albedo",), steps=1,
                                 batch_pixels=64, mesh=three)
    assert len(losses) == 1 and np.isfinite(losses[0])


@pytest.mark.parametrize("kwargs,leaf", [
    ({"boundary_samples": 4}, "centers"),
    ({"secondary_samples": 2, "secondary_vertex_depths": 2}, "centers"),
    ({"rr_grad": True, "rr_grad_arms": 1}, "ior"),
], ids=["boundary", "secondary", "rr_grad"])
def test_surrogate_knobs_reach_every_entry(kwargs, leaf):
    """Each surrogate knob is carried by render_loss, render_pixels_vjp
    and a train step: the value stays the plain loss (the surrogates enter
    as s - s.detach()), the gradient of ``leaf`` moves, and the step
    updates the parameters with the moved gradient."""
    _, psc, _, pcam, ids, target = _setup()
    args = (psc, pcam, torch.from_numpy(target), torch.from_numpy(ids),
            ptf.key_words(0))
    kw = dict(KW, options=pconfig.DEFAULT)

    def loss_and_grad(**extra):
        params = poptim.params_from_scene(psc, ("centers", "ior"))
        loss = poptim.render_loss(params, *args, **kw, **extra)
        loss.backward()
        return float(loss.detach()), params[leaf].grad.clone()

    plain_l, plain_g = loss_and_grad()
    sur_l, sur_g = loss_and_grad(**kwargs)
    np.testing.assert_allclose(sur_l, plain_l, rtol=1e-6)
    assert torch.isfinite(sur_g).all() and not torch.equal(sur_g, plain_g)

    params = poptim.params_from_scene(psc, ("centers", "ior"))
    cot = torch.ones((ids.shape[0], 3))
    g_plain, _ = poptim.render_pixels_vjp(params, psc, pcam, cot,
                                          *args[3:], **kw)
    g_sur, px = poptim.render_pixels_vjp(params, psc, pcam, cot, *args[3:],
                                         **kw, **kwargs)
    assert px.shape == (ids.shape[0], 3)
    assert not torch.equal(g_sur[leaf], g_plain[leaf])

    step = poptim.make_train_step(pinverse.make_adam(params, 1e-2), **kw,
                                  **kwargs)
    before = params[leaf].detach().clone()
    loss = step(params, *args)
    np.testing.assert_allclose(float(loss), plain_l, rtol=1e-6)
    assert not torch.equal(params[leaf].detach(), before)


def test_unknown_engine_raises():
    _, psc, _, pcam, ids, target = _setup()
    params = poptim.params_from_scene(psc, ("albedo",))
    with pytest.raises(ValueError, match="unknown AD engine"):
        poptim.render_loss(params, psc, pcam, torch.from_numpy(target),
                           torch.from_numpy(ids), ptf.key_words(0),
                           options=pconfig.DEFAULT, engine="bvh", **KW)
