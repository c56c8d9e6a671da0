"""Optimiser steps of inverse rendering, one after another (closed loop).

Traffic keys: ``params`` (the scene leaves fitted), ``perturb`` (the
standard deviation of the normal noise added to them, drawn from the
seed), ``clip`` (the range each perturbed leaf is held to),
``target_spp`` (the target image's samples a pixel, rendered in
set-up by the program's tiled engine, ``render.render``), ``fit_spp``,
``batch_pixels``, ``lr`` and ``engine`` (the AD engine, as ``fit
--ad-engine``).

Set-up builds one train step (``optim.inverse.make_adam`` +
``make_train_step``) and drives it through the cell's first
``check.steps`` steps, which are also its warm-up; the window goes on with
the same step object and optimiser state. Step i draws its pixel batch and
render key as ``optim.fit`` does (``step_keys``, ``draw_pixel_batch``) and
ends when its loss is on the host; the leaves and Adam's state are then
copied to the host (a few kB). ``--trace 1`` profiles the window's first
``trace.steps`` steps, called part by part in the step's own order so that
the forward and the backward pass can be spanned.

The check follows the program with the plain reference (its own pixel
batches, target pixels, forward, autograd backward and Adam): the set-up's
steps from the same perturbed parameters, and ``check.window_steps`` steps
drawn from the seed among those the window completed, each from the
leaves and Adam state that the program held before it. Each compares the
first step's loss, the first gradient's norm on the cell's
``check.grad_leaves`` (from Adam's first moment before and after it) and
the norm of each leaf's change over its steps, as the worst leaf's gap
(``reference.compare.fit_gaps``); each number is the worst over the
checks.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..harness import Record
from ..profiling import DeviceTrace
from ..reference import compare, fit as ref_fit, scenes
from ..reference import threefry as tf
from . import common

BETA1 = 0.9


def perturbed(arrays: dict, names, sigma: float, seed: int,
              clip: dict | None = None) -> dict:
    """The scene's arrays with normal noise of ``sigma`` on ``names``,
    then held to ``clip``'s {name: [low, high]}."""
    rng = np.random.default_rng((seed, 2))
    out = dict(arrays)
    for name in names:
        noise = rng.standard_normal(arrays[name].shape)
        value = arrays[name] + sigma * noise
        if clip and name in clip:
            value = np.clip(value, *clip[name])
        out[name] = value.astype(np.float32)
    return out


def run(ctx) -> Record:
    from raytracinginoneweekend_tpu_torch.config import RenderConfig
    from raytracinginoneweekend_tpu_torch.optim import inverse
    from raytracinginoneweekend_tpu_torch.render import render

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    rec = Record(device=common.device_info(dev))
    names = tuple(tr["params"])
    truth, cam_arrays = scenes.from_config(cfg)
    start = perturbed(truth, names, tr["perturb"], ctx.seed, tr.get("clip"))
    true_scene, cam = common.port_inputs(truth, cam_arrays, dev)
    scene, _ = common.port_inputs(start, cam_arrays, dev)
    w, h, depth = cfg["width"], cfg["height"], cfg["max_depth"]
    opts = common.port_options(cfg, dev)
    target = render(true_scene, cam, RenderConfig(
        width=w, height=h, spp=tr["target_spp"], max_depth=depth,
        camera_mode=cfg["camera_mode"], options=opts),
        tf.seed_key(ctx.seed, 2), device=dev).reshape(-1, 3)
    del true_scene
    params = inverse.params_from_scene(scene, names)
    opt = inverse.make_adam(params, tr["lr"])
    kw = dict(width=w, height=h, spp=tr["fit_spp"], max_depth=depth,
              camera_mode=cfg["camera_mode"], options=opts,
              engine=tr["engine"])
    step_fn = inverse.make_train_step(opt, **kw)
    base = tf.seed_key(ctx.seed, 3)

    def batch(i):
        batch_key, render_key = inverse.step_keys(base, i)
        ids = inverse.draw_pixel_batch(batch_key, w * h, tr["batch_pixels"],
                                       dev)
        return ids, target.index_select(0, ids.to(torch.int64)), render_key

    def step(i):
        ids, want, key = batch(i)
        return float(step_fn(params, scene, cam, want, ids, key))

    def step_in_parts(i):
        ids, want, key = batch(i)
        opt.zero_grad(set_to_none=True)
        t = time.perf_counter()
        loss = inverse.render_loss(params, scene, cam, want, ids, key, **kw)
        common.sync(dev)
        rec.span("forward", time.perf_counter() - t)
        t = time.perf_counter()
        loss.backward()
        common.sync(dev)
        rec.span("backward", time.perf_counter() - t)
        opt.step()
        return float(loss.detach())

    def state():
        """The leaves and Adam's state (zeros before the first step), on
        the host: what the reference starts a checked step from."""
        out = {"params": {}, "mu": {}, "nu": {}, "count": 0}
        for k, p in params.items():
            st = opt.state.get(p)
            out["params"][k] = p.detach().cpu().numpy().copy()
            for name, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                out[name][k] = (st[key].detach().cpu().numpy().copy() if st
                                else np.zeros(p.shape, np.float32))
            out["count"] = int(st["step"]) if st else 0
        return out

    n_check = ctx.cell["check"]["steps"]
    states, losses = [state()], []  # states[i]: before step i
    for i in range(n_check):
        losses.append(step(i))
        states.append(state())
    common.sync(dev)
    rec.setup_s = time.perf_counter() - ctx.t0

    n_traced = ctx.cell["trace"]["steps"] if ctx.trace else 0
    t0 = time.perf_counter()
    with DeviceTrace(n_traced > 0, dev) as traced:
        for i in range(n_check, n_check + n_traced):
            losses.append(step_in_parts(i))
            states.append(state())
    rec.trace, rec.traced_units = traced.summary, n_traced
    i = n_check + n_traced
    while i == n_check or time.perf_counter() - t0 < ctx.seconds:
        t = time.perf_counter()
        try:
            losses.append(step(i))
        except RuntimeError as e:  # a step that fails is counted, once
            rec.failed += 1
            rec.notes.append(f"step {i} failed: {e}")
            break
        states.append(state())
        rec.span("step", time.perf_counter() - t)
        i += 1
    rec.window_s = time.perf_counter() - t0
    rec.notes.append("step seconds: " + " ".join(
        f"{x:.3f}" for x in rec.spans.get("step", [])))
    rec.units = i - n_check
    rec.attempted = rec.units + rec.failed
    rec.work["steps"] = rec.units
    rec.memory_peak_bytes = common.memory_peak(dev)
    del params, opt, step_fn, scene, cam, target
    common.release(dev)

    # the set-up's steps from the start, then each step drawn from the
    # window, from the state the program held before it
    picked = n_check + common.draw_ids(np.random.default_rng((ctx.seed, 8)),
                                       rec.units,
                                       ctx.cell["check"]["window_steps"])
    follow = dict(base=base, target_key=tf.seed_key(ctx.seed, 2),
                  width=w, height=h, max_depth=depth,
                  target_spp=tr["target_spp"], fit_spp=tr["fit_spp"],
                  batch=tr["batch_pixels"], lr=tr["lr"], device=dev)
    runs = [(0, n_check, None)] + [(int(j), 1, states[j]) for j in picked]
    limits = ctx.cell["limits"]
    worst = {k: 0.0 for k in limits}
    t_ref = time.perf_counter()
    for first, n, st in runs:
        ref = ref_fit.follow(truth, start, cam_arrays, names, steps=n,
                             first_step=first, state=st, **follow)
        a, b, z = states[first], states[first + 1], states[first + n]
        grads = {k: (b["mu"][k].astype(np.float64) - BETA1 * a["mu"][k])
                 / (1 - BETA1) for k in names}
        gaps = compare.fit_gaps(losses[first:first + n], grads, a["params"],
                                z["params"], ref,
                                ctx.cell["check"].get("grad_leaves"))
        rec.notes.append(f"steps {first}..{first + n - 1}: losses program "
                         f"{losses[first:first + n]} reference "
                         f"{ref['losses']}; gaps {gaps}")
        for k, v in gaps.items():
            worst[k] = worst[k] if v <= worst[k] else v  # NaN stays
    rec.notes.append(f"reference: {len(runs)} checks in "
                     f"{time.perf_counter() - t_ref:.3f} s")
    for k, v in worst.items():
        rec.checks[k] = (v, limits[k])
    return rec
