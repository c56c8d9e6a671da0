"""PyTorch port vs the JAX package: math3 and the material scatter.

Same inputs, made with numpy from a seed, through both packages. The
functions are a few float32 products, sums, one sqrt and one division per
output; XLA:CPU may contract a multiply-add that PyTorch rounds twice, so
values agree to rtol 1e-5 / atol 1e-6. ``scatter``'s ``valid`` flag and its
reflect/refract choice are decisions on such values: at most 1e-3 of rays
may sit on the other side of a knife edge.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginoneweekend_tpu import config as jconfig
from raytracinginoneweekend_tpu.ops import math3 as jm
from raytracinginoneweekend_tpu.ops import scatter as jscatter
from raytracinginoneweekend_tpu_torch import config as pconfig
from raytracinginoneweekend_tpu_torch.ops import math3 as pm
from raytracinginoneweekend_tpu_torch.ops import scatter as pscatter

N = 2000
TOL = dict(rtol=1e-5, atol=1e-6)


def _unit(g, n=N):
    v = g.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("fn", ["dot", "norm2", "normalize", "reflect",
                                "cross"])
def test_math3_vector_functions(fn):
    g = np.random.default_rng(0)
    a = g.normal(size=(N, 3)).astype(np.float32)
    b = _unit(g)
    a[:4] = 0.0  # normalize leaves the zero vector alone
    args = (a,) if fn in ("norm2", "normalize") else (a, b)
    want = getattr(jm, fn)(*(jnp.asarray(x) for x in args))
    got = getattr(pm, fn)(*(_t(x) for x in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fn", ["refract", "refract_reference"])
def test_refract_and_its_tir_flag(fn):
    g = np.random.default_rng(1)
    i, n = _unit(g), _unit(g)
    eta = g.choice(np.array([1 / 1.5, 1.5, 1.0], np.float32), size=N)
    wv, wt = getattr(jm, fn)(jnp.asarray(i), jnp.asarray(n),
                             jnp.asarray(eta))
    gv, gt = getattr(pm, fn)(_t(i), _t(n), _t(eta))
    flips = gt.numpy() != np.asarray(wt)
    assert flips.mean() <= 1e-3
    assert 0.05 < gt.numpy().mean() < 0.95  # both branches exercised
    np.testing.assert_allclose(gv.numpy()[~flips], np.asarray(wv)[~flips],
                               **TOL)
    assert (gv.numpy()[gt.numpy()] == 0).all()  # TIR: the zero vector


def test_refract_gradient_is_finite_at_total_reflection():
    """where BEFORE sqrt: the masked branch must not leak inf * 0."""
    i = torch.tensor([[0.8, -0.6, 0.0], [0.0, -1.0, 0.0]])
    n = torch.tensor([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    eta = torch.tensor([1.5, 1.5], requires_grad=True)  # ray 0: TIR
    for fn in (pm.refract, pm.refract_reference):
        v, tir = fn(i, n, eta)
        assert tir.tolist() == [True, False]
        g, = torch.autograd.grad(v.sum(), eta)
        assert bool(torch.isfinite(g).all()) and float(g[0]) == 0.0
    z = torch.zeros((1, 3), requires_grad=True)
    g, = torch.autograd.grad(pm.normalize(z).sum(), z)
    assert bool(torch.isfinite(g).all())


def test_schlick_and_mix():
    g = np.random.default_rng(2)
    ri = g.choice(np.array([1 / 1.5, 1.5], np.float32), size=N)
    cos = g.random(N, dtype=np.float32)
    np.testing.assert_allclose(
        pm.schlick(_t(ri), _t(cos)).numpy(),
        np.asarray(jm.schlick(jnp.asarray(ri), jnp.asarray(cos))), **TOL)
    x, y = g.random((N, 3), dtype=np.float32), g.random((N, 3),
                                                        dtype=np.float32)
    a = (g.random(N, dtype=np.float32) * 2 - 0.5)  # unclamped
    np.testing.assert_allclose(
        pm.mix(_t(x), _t(y), _t(a)).numpy(),
        np.asarray(jm.mix(jnp.asarray(x), jnp.asarray(y),
                          jnp.asarray(a)[:, None])), **TOL)


def _surface(seed, mtype):
    g = np.random.default_rng(seed)
    n = _unit(g)
    d = _unit(g) * g.uniform(0.5, 3.0, size=(N, 1)).astype(np.float32)
    mt = (np.full(N, mtype, np.int32) if mtype is not None
          else g.integers(0, 3, size=N, dtype=np.int32))
    albedo = g.random((N, 3), dtype=np.float32)
    fuzz = np.where(mt == 1, g.uniform(0, 0.5, size=N), 0.0).astype(
        np.float32)
    ior = np.where(mt == 2, 1.5, 1.0).astype(np.float32)
    rand_vec = _unit(g) * g.uniform(0.2, 1.0, size=(N, 1)).astype(
        np.float32)
    ru = g.random(N, dtype=np.float32)
    return d, n, mt, albedo, fuzz, ior, rand_vec, ru


@pytest.mark.parametrize("refract", ["physical", "reference"])
@pytest.mark.parametrize("mtype", [0, 1, 2, None],
                         ids=["lambert", "metal", "dielectric", "mixed"])
def test_scatter_matches_jax(mtype, refract):
    args = _surface(4, mtype)
    jopt = dataclasses.replace(jconfig.DEFAULT, refract=refract)
    popt = dataclasses.replace(pconfig.DEFAULT, refract=refract)
    wd, wa, wv = jscatter.scatter(*(jnp.asarray(a) for a in args), jopt)
    gd, ga, gv = pscatter.scatter(*(_t(a) for a in args), popt)
    assert gv.dtype == torch.bool
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    assert (gv.numpy() != np.asarray(wv)).mean() <= 1e-3
    bad = ~np.isclose(gd.numpy(), np.asarray(wd), **TOL).all(axis=1)
    assert bad.mean() <= 1e-3, int(bad.sum())
    if mtype == 1:
        assert 0.0 < gv.numpy().mean() < 1.0  # some metal rays absorbed


def test_scatter_gradients_match_jax():
    d, n, mt, albedo, fuzz, ior, rand_vec, ru = _surface(5, None)

    def jloss(d, n, albedo, fuzz, ior):
        nd, at, _ = jscatter.scatter(d, n, jnp.asarray(mt), albedo, fuzz,
                                     ior, jnp.asarray(rand_vec),
                                     jnp.asarray(ru), jconfig.DEFAULT)
        return jnp.sum(jnp.sin(nd)) + jnp.sum(at * at)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (d, n, albedo, fuzz, ior)))
    leaves = [_t(a).requires_grad_(True) for a in (d, n, albedo, fuzz, ior)]
    nd, at, _ = pscatter.scatter(leaves[0], leaves[1], _t(mt), leaves[2],
                                 leaves[3], leaves[4], _t(rand_vec), _t(ru),
                                 pconfig.DEFAULT)
    (torch.sum(torch.sin(nd)) + torch.sum(at * at)).backward()
    for leaf, w in zip(leaves, want):
        assert bool(torch.isfinite(leaf.grad).all())
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5)
