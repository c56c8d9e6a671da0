"""The plain reference of the fit step: the same steps from the same start.

Step i of a fit with base key ``base`` draws its pixel batch with
``jax.random.choice(fold_in(fold_in(base, i), 0), n_pixels, (batch,),
replace=False)`` and renders with the key ``fold_in(fold_in(base, i), 1)``;
the loss is the mean squared error of the batch's pixels against the
target's, whose pixels the reference renders itself (the target is the true
scene at ``target_spp`` under ``target_key``); the gradient is autograd's
through ``tracer.trace``; the update is Adam (Kingma & Ba; b1 0.9, b2
0.999, eps 1e-8, bias-corrected), all in ``dtype``.
"""

from __future__ import annotations

import torch

from . import threefry as tf
from . import tracer

B1, B2, EPS = 0.9, 0.999, 1e-8
LEAVES = ("centers", "albedo")


def adam(p, g, mu, nu, count: int, lr: float):
    """One Adam update of p in place; mu and nu updated in place."""
    mu.mul_(B1).add_(g, alpha=1 - B1)
    nu.mul_(B2).add_(g * g, alpha=1 - B2)
    mu_hat = mu / (1 - B1 ** count)
    nu_hat = nu / (1 - B2 ** count)
    p.sub_(lr * mu_hat / (torch.sqrt(nu_hat) + EPS))


def follow(truth: dict, start: dict, cam: dict, names, *, steps: int, base,
           target_key, width: int, height: int, max_depth: int,
           target_spp: int, fit_spp: int, batch: int, lr: float, device,
           dtype=torch.float32, first_step: int = 0,
           state: dict | None = None) -> dict:
    """Run fit steps ``first_step`` .. ``first_step + steps - 1`` ->
    {"losses": [...], "grads": {leaf: the first step's gradient},
    "first": {...}, "last": {...}} (NumPy arrays).

    They start from ``start``'s leaves and a fresh Adam, or from
    ``state``: {"params", "mu", "nu": {leaf: array}, "count": steps
    taken}, the leaves and Adam's moments before step ``first_step``."""
    bad = set(names) - set(LEAVES)
    if bad:
        raise ValueError(f"the reference fits {LEAVES}, not {sorted(bad)}")
    true_scene = tracer.Scene(truth, device, dtype)

    def put(arrays):
        return {k: torch.tensor(arrays[k], device=device, dtype=dtype)
                for k in names}  # copies: the caller's arrays stay as given

    if state is None:
        p = put(start)
        mu = {k: torch.zeros_like(v) for k, v in p.items()}
        nu = {k: torch.zeros_like(v) for k, v in p.items()}
        count = 0
    else:
        p, mu, nu = put(state["params"]), put(state["mu"]), put(state["nu"])
        count = int(state["count"])
    out = {"losses": [], "grads": None,
           "first": {k: v.float().cpu().numpy().copy() for k, v in p.items()}}
    frame = dict(width=width, height=height, max_depth=max_depth,
                 dtype=dtype)
    for s in range(steps):
        i = first_step + s
        k_step = tf.key_of(tf.fold_in(base, i))
        ids = tf.choice(tf.key_of(tf.fold_in(k_step, 0)), width * height,
                        batch, device)
        want = tracer.trace_blocks(true_scene, cam, ids, target_spp,
                                   target_key, **frame)
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        scene = tracer.Scene(start, device, dtype, **leaves)
        got = tracer.trace(scene, cam, ids, fit_spp,
                           tf.key_of(tf.fold_in(k_step, 1)), grad=True,
                           **frame)
        loss = ((got - want) ** 2).mean()
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        out["losses"].append(float(loss.detach()))
        if s == 0:
            out["grads"] = {k: g.float().cpu().numpy()
                            for k, g in zip(names, grads)}
        with torch.no_grad():
            for k, g in zip(names, grads):
                adam(p[k], g, mu[k], nu[k], count + s + 1, lr)
    out["last"] = {k: v.float().cpu().numpy() for k, v in p.items()}
    return out
