"""PyTorch port vs the JAX package: the (N, 3) bounce step and tracers.

One ``_bounce_step``, ``trace`` and ``trace_fast`` of the port on the CPU
against the JAX package's, on primary rays of the same scene, camera and
key. The key words are BIT-EQUAL. State after one bounce: rtol 1e-4 / atol
1e-5 on all but at most 1% of rays (a rounding difference that flips a
t_min, grazing, ``dot > 0`` or ``u < probability`` decision sends the ray
elsewhere). Radiance and gradients: stated at each test.
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
from raytracinginoneweekend_tpu.ops import integrate as jintegrate
from raytracinginoneweekend_tpu_torch import config as pconfig
from raytracinginoneweekend_tpu_torch.models import camera as pcamera
from raytracinginoneweekend_tpu_torch.models import scene as pscene
from raytracinginoneweekend_tpu_torch.ops import integrate as pintegrate
from raytracinginoneweekend_tpu_torch.ops import threefry as ptf

jrender = importlib.import_module("raytracinginoneweekend_tpu.render")
prender = importlib.import_module("raytracinginoneweekend_tpu_torch.render")

W, H, SPP, SEED = 24, 16, 2, 5
N = W * H * SPP


def _primary(sampling="iid"):
    pid = np.repeat(np.arange(W * H, dtype=np.int32), SPP)
    sid = np.tile(np.arange(SPP, dtype=np.int32), W * H)
    jo, jd, jk = jrender.make_primary_rays(
        jcamera.reference_cuda_camera(W, H), jnp.asarray(pid),
        jnp.asarray(sid), jax.random.key(SEED), W, H, "thinlens",
        sampling=sampling, spp=SPP)
    po, pd, pk = prender.make_primary_rays(
        pcamera.reference_cuda_camera(W, H, "cpu"), torch.from_numpy(pid),
        torch.from_numpy(sid), ptf.key_words(SEED), W, H, "thinlens",
        sampling=sampling, spp=SPP)
    return (jo, jd, jk), (po, pd, pk)


def _few_differ(got, want, budget=0.01, rtol=1e-4, atol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    bad = ~np.isclose(got, want, rtol=rtol, atol=atol)
    if bad.ndim > 1:
        bad = bad.any(axis=-1)
    assert bad.mean() <= budget, (int(bad.sum()), bad.size)


@pytest.mark.parametrize("sky", ["cuda", "cpu"])
def test_background_color(sky):
    g = np.random.default_rng(0)
    d = g.normal(size=(500, 3)).astype(np.float32) * 3
    want = jintegrate.background_color(
        jnp.asarray(d), dataclasses.replace(jconfig.DEFAULT, sky=sky))
    got = pintegrate.background_color(
        torch.from_numpy(d), dataclasses.replace(pconfig.DEFAULT, sky=sky))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("changes", [
    {}, {"gather": "take"}, {"rr_terminate": True, "rr_start": 1},
    {"scatter_sample": "ball", "refract": "reference", "sky": "cpu"},
], ids=["default", "take", "rr", "reference_cpu"])
def test_bounce_step_matches_jax(changes):
    (jo, jd, jk), (po, pd, pk) = _primary()
    jopt = dataclasses.replace(jconfig.DEFAULT, **changes)
    popt = dataclasses.replace(pconfig.DEFAULT, **changes)
    jstate = jintegrate._init_state(jo, jd, jk)
    pstate = pintegrate._init_state(po, pd, pk)
    jsc, psc = jscene.simple_scene_cuda(), pscene.simple_scene_cuda("cpu")
    for bounce in range(2):
        jstate, (jidx, jhit) = jintegrate._bounce_step(
            jsc, jopt, jstate, bounce, return_hit=True)
        pstate, (pidx, phit) = pintegrate._bounce_step(
            psc, popt, pstate, bounce, return_hit=True)
    assert (phit.numpy() != np.asarray(jhit)).mean() <= 0.01
    both = phit.numpy() & np.asarray(jhit)
    assert (pidx.numpy() != np.asarray(jidx))[both].mean() <= 0.01
    assert (pstate[4].numpy() != np.asarray(jstate[4])).mean() <= 0.01
    for k in range(4):  # origin, direction, attenuation, radiance
        _few_differ(pstate[k].numpy(), jstate[k])


def test_bounce_step_strat0_replaces_the_first_scatter_vector():
    _, (po, pd, pk) = _primary()
    psc = pscene.simple_scene_cuda("cpu")
    strat0 = torch.zeros((N, 3))
    strat0[:, 1] = 1.0
    state = pintegrate._init_state(po, pd, pk)
    a = pintegrate._bounce_step(psc, pconfig.DEFAULT, state, 0)
    b = pintegrate._bounce_step(psc, pconfig.DEFAULT, state, 0,
                                strat0=strat0)
    c = pintegrate._bounce_step(psc, pconfig.DEFAULT, state, 1,
                                strat0=strat0)
    d = pintegrate._bounce_step(psc, pconfig.DEFAULT, state, 1)
    assert not torch.equal(a[1], b[1])  # bounce 0: directions change
    assert torch.equal(c[1], d[1])  # later bounces: untouched
    assert torch.equal(a[3], b[3])  # the sky term does not read the draw


@pytest.mark.parametrize("sampling,rr", [("iid", False),
                                         ("stratified", True)])
def test_trace_and_trace_fast_match_jax(sampling, rr):
    (jo, jd, jk), (po, pd, pk) = _primary(sampling)
    changes = dict(sampling=sampling, rr_terminate=rr, rr_start=1)
    jopt = dataclasses.replace(jconfig.DEFAULT, **changes)
    popt = dataclasses.replace(pconfig.DEFAULT, **changes)
    want = jintegrate.trace_fast(jscene.simple_scene_cuda(), jo, jd, jk, 5,
                                 jopt)
    psc = pscene.simple_scene_cuda("cpu")
    fast = pintegrate.trace_fast(psc, po, pd, pk, 5, popt)
    slow = pintegrate.trace(psc, po, pd, pk, 5, popt)
    assert not fast.requires_grad
    # the two tracers run the same step: equal to the last bits
    np.testing.assert_allclose(slow.numpy(), fast.numpy(), rtol=1e-6,
                               atol=1e-7)
    _few_differ(fast.numpy(), want, rtol=1e-4, atol=5e-4)
    assert float(fast.mean()) > 0.1


def test_trace_fast_stops_when_no_ray_is_alive(monkeypatch):
    """Rays pointing at the sky die at bounce 0: one step, then the exit."""
    calls = []
    real = pintegrate._bounce_step

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(pintegrate, "_bounce_step", counting)
    n = 64
    o = torch.zeros((n, 3))
    o[:, 1] = 50.0
    d = torch.zeros((n, 3))
    d[:, 1] = 1.0
    keys = (torch.arange(n, dtype=torch.int64),
            torch.arange(n, dtype=torch.int64))
    out = pintegrate.trace_fast(pscene.simple_scene_cuda("cpu"), o, d, keys,
                                9, pconfig.DEFAULT)
    assert len(calls) == 1
    np.testing.assert_allclose(out.numpy(), np.tile([0.5, 0.7, 1.0],
                                                    (n, 1)), rtol=1e-6)


def test_trace_gradients_match_jax():
    """d(sum radiance * weights)/d(scene leaves) through the checkpointed
    trace against jax.grad of the JAX trace: rtol 1e-3 / atol 1e-5 (sums
    of ~1e3 per-ray terms in two orders)."""
    (jo, jd, jk), (po, pd, pk) = _primary()
    names = ("centers", "radii", "albedo", "fuzz", "ior")
    wts = np.random.default_rng(2).random((N, 3), dtype=np.float32)
    jsc = jscene.simple_scene_cuda()

    def jloss(p):
        out = jintegrate.trace(jsc._replace(**p), jo, jd, jk, 3,
                               jconfig.DEFAULT)
        return jnp.sum(out * jnp.asarray(wts))

    want = jax.grad(jloss)({k: getattr(jsc, k) for k in names})
    psc = pscene.simple_scene_cuda("cpu")
    leaves = {k: getattr(psc, k).clone().requires_grad_(True)
              for k in names}
    out = pintegrate.trace(psc._replace(**leaves), po, pd, pk, 3,
                           pconfig.DEFAULT)
    torch.sum(out * torch.from_numpy(wts)).backward()
    for k in names:
        assert np.abs(np.asarray(want[k])).max() > 0, k
        np.testing.assert_allclose(leaves[k].grad.numpy(),
                                   np.asarray(want[k]), rtol=1e-3,
                                   atol=1e-5, err_msg=k)


def test_trace_recomputes_each_bounce_in_backward(monkeypatch):
    """torch.utils.checkpoint: the bounce runs once forward and once more
    when its gradient is taken; nothing of a bounce is held in between."""
    calls = []
    real = pintegrate.closest_hit_opt

    def counting(*a, **k):
        calls.append(torch.is_grad_enabled())
        return real(*a, **k)

    monkeypatch.setattr(pintegrate, "closest_hit_opt", counting)
    _, (po, pd, pk) = _primary()
    psc = pscene.simple_scene_cuda("cpu")
    albedo = psc.albedo.clone().requires_grad_(True)
    out = pintegrate.trace(psc._replace(albedo=albedo), po, pd, pk, 3,
                           pconfig.DEFAULT)
    assert len(calls) == 3
    out.sum().backward()
    assert len(calls) == 6
    assert bool(torch.isfinite(albedo.grad).all())
