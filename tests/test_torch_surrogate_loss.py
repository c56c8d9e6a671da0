"""PyTorch port vs the JAX package: the training loss with every gradient
surrogate on.

``render_loss`` and ``render_pixels_vjp`` with ``boundary_samples``,
``secondary_samples`` (vertex depths 0 and 1) and ``rr_grad`` at once, on
the planar and the tiled engine, from the same parameters, pixel ids and
key: the value and the gradient of every differentiable leaf. The setup is
tests/test_torch_optim.py's (the simple scene at 16x12, 2 spp, depth 3).

Tolerances: tests/test_torch_optim.py's -- loss rtol 1e-5, gradients rtol
1e-3 / atol 1e-6 (sums of per-ray terms taken in two orders); each
surrogate alone is held tighter in tests/test_torch_silhouette.py and
tests/test_torch_branchprob.py. Measured: every gradient within 3e-5 of
JAX's, relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginoneweekend_tpu import config as jconfig
from raytracinginoneweekend_tpu import optim as joptim
from raytracinginoneweekend_tpu_torch import config as pconfig
from raytracinginoneweekend_tpu_torch import optim as poptim
from raytracinginoneweekend_tpu_torch.ops import threefry as ptf
from test_torch_optim import KW, NAMES, _numpy_params, _setup

torch.set_num_threads(2)

SURROGATES = dict(boundary_samples=8, secondary_samples=4,
                  secondary_vertex_depths=2, rr_grad=True)


@functools.lru_cache(maxsize=None)
def _jax(entry, engine):
    jsc, _psc, jcam, _pcam, ids, target = _setup()
    params = {k: jnp.asarray(v) for k, v in _numpy_params(jsc).items()}
    args = (jsc, jcam)
    kw = dict(options=jconfig.DEFAULT, engine=engine, **KW, **SURROGATES)
    if entry == "loss":
        value, grads = jax.value_and_grad(joptim.render_loss)(
            params, *args, jnp.asarray(target), jnp.asarray(ids),
            jax.random.key(7), **kw)
        return float(value), {k: np.asarray(v) for k, v in grads.items()}
    grads, pixels = joptim.render_pixels_vjp(
        params, *args, jnp.asarray(_cotangent()), jnp.asarray(ids),
        jax.random.key(7), **kw)
    return np.asarray(pixels), {k: np.asarray(v) for k, v in grads.items()}


def _cotangent():
    return np.random.default_rng(11).normal(size=(96, 3)).astype(np.float32)


def _close(want: dict, got: dict):
    for name in NAMES:
        assert np.abs(want[name]).max() > 0, name
        np.testing.assert_allclose(got[name], want[name], rtol=1e-3,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("engine", ["planar", "tiled"])
def test_render_loss_with_every_surrogate_matches_jax(engine):
    jsc, psc, _jcam, pcam, ids, target = _setup()
    want_l, want_g = _jax("loss", engine)
    params = poptim.params_from_numpy(_numpy_params(jsc), device="cpu")
    loss = poptim.render_loss(params, psc, pcam, torch.from_numpy(target),
                              torch.from_numpy(ids), ptf.key_words(7),
                              options=pconfig.DEFAULT, engine=engine, **KW,
                              **SURROGATES)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_l, rtol=1e-5)
    _close(want_g, {k: v.grad.numpy() for k, v in params.items()})


@pytest.mark.parametrize("engine", ["planar", "tiled"])
def test_render_pixels_vjp_with_every_surrogate_matches_jax(engine):
    jsc, psc, _jcam, pcam, ids, _target = _setup()
    want_px, want_g = _jax("vjp", engine)
    params = poptim.params_from_numpy(_numpy_params(jsc), device="cpu")
    grads, pixels = poptim.render_pixels_vjp(
        params, psc, pcam, torch.from_numpy(_cotangent()),
        torch.from_numpy(ids), ptf.key_words(7), options=pconfig.DEFAULT,
        engine=engine, **KW, **SURROGATES)
    np.testing.assert_allclose(pixels.numpy(), want_px, rtol=1e-4,
                               atol=1e-6)
    _close(want_g, {k: v.numpy() for k, v in grads.items()})
