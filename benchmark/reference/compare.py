"""The numbers that decide ``correct`` for a fit, from the program's and
the reference's readings of one check: a run of steps that both start
from the same leaves and Adam state.

* ``fit_loss_gap``: the check's first step's loss, relative. Later steps
  start from parameters that the first update moved, and carry its
  rounding.
* ``fit_grad_gap``: the first gradient's norm (as the optimiser got it),
  by leaf, on the leaves the cell names. A leaf whose gradient is set by a
  few grazing hits (the 1/sqrt(disc) of a silhouette) reads rounding: the
  sphere centres' norm parts by 20-230% between the float32 and float64
  references themselves (``PERF.md``), so no limit can hold it.
* ``fit_change_gap``: the norm of each leaf's change over the check's
  steps. Leaves whose first gradient in the reference is under a
  thousandth of the median leaf's move by rounding alone under Adam; they
  are left out.

Norms are taken leaf by leaf (a leaf is one fitted array), and each gap is
the worst leaf's ``| |program| - |reference| |`` over the larger of the
reference's norm of that leaf and the median leaf's.
"""

from __future__ import annotations

import math

import numpy as np


def _norm(a) -> float:
    a = np.asarray(a, np.float64)
    return float(np.sqrt((a * a).sum())) if np.isfinite(a).all() else math.inf


def _worst(prog: dict, ref: dict, keys) -> float:
    keys = list(keys)
    if not keys:
        return 0.0
    med = float(np.median([ref[k] for k in keys]))
    worst = 0.0
    for k in keys:
        if not (math.isfinite(prog[k]) and math.isfinite(ref[k])):
            return math.inf
        scale = max(ref[k], med)
        worst = max(worst, abs(prog[k] - ref[k]) / scale if scale > 0
                    else (0.0 if prog[k] == 0 else math.inf))
    return worst


def fit_gaps(losses, grads, first, checked, ref, grad_leaves=None) -> dict:
    """-> {fit_loss_gap, fit_grad_gap, fit_change_gap}.

    losses: the program's losses of the check's steps (the first is
    compared: from the same state on both sides); grads: its first
    gradient by leaf, compared on ``grad_leaves`` (None: every leaf);
    first / checked: its leaves before the check's first step and after
    its last; ref: ``reference.fit.follow``'s result."""
    lp, lr = losses[0], ref["losses"][0]
    ok = math.isfinite(lp) and math.isfinite(lr) and lr != 0
    loss_gap = abs(lp - lr) / abs(lr) if ok else math.inf
    g_ref = {k: _norm(v) for k, v in ref["grads"].items()}
    g_prog = {k: _norm(grads[k]) for k in g_ref}
    med = float(np.median(list(g_ref.values())))
    moving = [k for k in g_ref if g_ref[k] >= 1e-3 * med]
    d_ref = {k: _norm(ref["last"][k] - ref["first"][k]) for k in g_ref}
    d_prog = {k: _norm(np.asarray(checked[k], np.float64) - first[k])
              for k in g_ref}
    keys = list(g_ref) if grad_leaves is None else list(grad_leaves)
    return {"fit_loss_gap": loss_gap,
            "fit_grad_gap": _worst(g_prog, g_ref, keys),
            "fit_change_gap": _worst(d_prog, d_ref, moving)}
