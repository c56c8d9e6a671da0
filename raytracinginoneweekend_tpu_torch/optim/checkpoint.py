"""Checkpoint/resume for inverse rendering (params + optimizer state).

Counterpart of ``raytracinginoneweekend_tpu/optim/checkpoint.py``, with the
same file: a single ``.npz`` holding ``__step__`` (int64), the parameters
as ``p0, p1, ...`` and the optimiser state as ``o0, o1, ...``.

Leaf order (fixed, and the order in which the JAX package flattens its
``{name: array}`` dict and ``optax.adam``'s state):
  * ``p{i}``: the parameters in SORTED NAME order;
  * ``o0``: Adam's step count (int32 scalar); then the first moments in
    sorted name order; then the second moments in sorted name order.
So a checkpoint written by either package's ``fit`` with ``optax.adam`` /
``make_adam`` over the same parameter names can be read by the other's.
The structure comes from a template on load; nothing is pickled.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .inverse import adam_state_to_numpy


def _opt_leaves(opt_state: dict) -> list:
    names = sorted(opt_state["mu"])
    return ([np.asarray(opt_state["count"], np.int32)]
            + [np.asarray(opt_state["mu"][k]) for k in names]
            + [np.asarray(opt_state["nu"][k]) for k in names])


def save_checkpoint(path: str, params: dict, optimizer, step: int) -> None:
    """Atomically write params + optimizer state + step to ``path`` (.npz).

    ``optimizer``: the ``Adam`` (``make_adam``) bound to ``params``, or its
    state in optax's layout (``adam_state_to_numpy``'s dict)."""
    opt_state = (optimizer if isinstance(optimizer, dict)
                 else adam_state_to_numpy(optimizer, params))
    arrays = {"__step__": np.asarray(step, np.int64)}
    for i, name in enumerate(sorted(params)):
        arrays[f"p{i}"] = params[name].detach().cpu().numpy()
    for i, leaf in enumerate(_opt_leaves(opt_state)):
        arrays[f"o{i}"] = leaf
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic on POSIX


def load_checkpoint(path: str, params_template: dict):
    """Restore (params, opt_state, step) shaped like the template.

    params_template: a {name: tensor} dict; it supplies the names, shapes,
    dtypes and the device. Returns new leaf tensors with ``requires_grad``
    on the template's device, the optimiser state in optax's layout
    (``adam_state_from_numpy`` / ``fit(init_opt_state=...)`` take it) and
    the step. A leaf whose shape or dtype differs from the template's
    raises ``ValueError``.
    """
    names = sorted(params_template)
    n = len(names)
    with np.load(path) as data:
        step = int(data["__step__"])
        new_p = [data[f"p{i}"] for i in range(n)]
        new_o = [data[f"o{i}"] for i in range(1 + 2 * n)]
    tmpl_p = [params_template[k].detach().cpu().numpy() for k in names]
    tmpl_o = [np.zeros((), np.int32)] + tmpl_p + tmpl_p
    for tmpl, new in zip(tmpl_p + tmpl_o, new_p + new_o):
        if np.shape(tmpl) != np.shape(new):
            raise ValueError(
                f"checkpoint leaf shape {np.shape(new)} != template "
                f"{np.shape(tmpl)}")
        if tmpl.dtype != np.asarray(new).dtype:
            raise ValueError(
                f"checkpoint leaf dtype {np.asarray(new).dtype} != "
                f"template {tmpl.dtype}")
    params = {
        k: torch.from_numpy(np.array(a)).to(params_template[k].device)
        .requires_grad_(True) for k, a in zip(names, new_p)}
    opt_state = {"count": new_o[0],
                 "mu": dict(zip(names, new_o[1:1 + n])),
                 "nu": dict(zip(names, new_o[1 + n:]))}
    return params, opt_state, step
