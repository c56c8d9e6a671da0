"""Faults and the control, planted in the program's timed path, to show
that ``correct`` catches them. Only the benchmark's tests and
``calibrate.py`` plant them.

Each driver's kinds:

* ``stale``: a step that returns its state unchanged (a frame or a preview
  that repeats the first one rendered; optimiser steps that leave the
  parameters as they were once the window runs);
* ``half``: half of the batch left out, the mean taken over the rest (half
  the samples of every pixel; the loss over half the pixel batch);
* ``altered``: an answer altered where it is produced (the rendered
  radiance scaled by 1.05);
* ``control``: the plain reference computed in bfloat16, the precision
  below the configurations' float32, put in the program's place: a frame
  or a preview holds the reference's radiance at the pixels the check
  reads (zeros elsewhere), and an optimiser step is the reference's
  forward, autograd backward and Adam, on the program's parameters and
  optimiser state.

A kind is planted by replacing a function of the program's modules for
the duration of a ``with planted(ctx, kind)`` block; the render server
plants it in its own process (``serve_launcher.py --fault``).
"""

from __future__ import annotations

import contextlib
import importlib

import torch

SCALE = 1.05
LOW = torch.bfloat16
KINDS = ("stale", "half", "altered", "control")


def _scaled(out):
    if isinstance(out, tuple):
        return (out[0] * SCALE,) + out[1:]
    return out * SCALE


def _frames(kind, ctx):
    mod = importlib.import_module("raytracinginoneweekend_tpu_torch.ops."
                                  "wavefront")
    orig, first = mod.render_wavefront, []

    if kind == "control":
        from .drivers import frames
        from .reference import scenes, tracer

        arrays, cam = scenes.from_config(ctx.config)
        low_scene = tracer.Scene(arrays, ctx.device, LOW)
        ids = torch.as_tensor(frames.check_pixels(ctx))

        def control(scene, cam_, key, *, spp, width, height, max_depth,
                    **kw):
            low = tracer.trace_blocks(low_scene, cam, ids, spp, key,
                                      width=width, height=height,
                                      max_depth=max_depth, dtype=LOW)
            fb = torch.zeros((width * height, 3), device=ctx.device)
            fb[ids.to(ctx.device)] = low.float()
            return fb

        return [(mod, "render_wavefront", control)]

    def render(scene, cam, key, *, spp, **kw):
        if kind == "half":
            return orig(scene, cam, key, spp=max(1, spp // 2), **kw)
        if kind == "altered":
            return _scaled(orig(scene, cam, key, spp=spp, **kw))
        if not first:
            first.append(orig(scene, cam, key, spp=spp, **kw))
        return first[0]

    return [(mod, "render_wavefront", render)]


def _control_step(ctx, optimizer, kw):
    """The fit's control: ``make_train_step``'s step, done by the
    reference in bfloat16 on the program's parameters and Adam state."""
    from .reference import fit as ref_fit, scenes, tracer
    from .reference import threefry as tf

    arrays, cam = scenes.from_config(ctx.config)
    lr = optimizer.param_groups[0]["lr"]

    def step(params, scene, cam_, target, ids, key):
        names = sorted(params)
        leaves = {k: params[k].detach().to(LOW).requires_grad_(True)
                  for k in names}
        got = tracer.trace(tracer.Scene(arrays, ctx.device, LOW, **leaves),
                           cam, ids.to(torch.int64), kw["spp"],
                           tf.key_of(key), width=kw["width"],
                           height=kw["height"], max_depth=kw["max_depth"],
                           dtype=LOW, grad=True)
        loss = ((got - target.to(LOW)) ** 2).mean()
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        with torch.no_grad():
            for k, g in zip(names, grads):
                p = params[k]
                st = optimizer.state[p]
                if not st:
                    st.update(step=torch.zeros((), dtype=torch.int32),
                              exp_avg=torch.zeros_like(p),
                              exp_avg_sq=torch.zeros_like(p))
                count = int(st["step"]) + 1
                pl, mu, nu = (t.to(LOW) for t in (p, st["exp_avg"],
                                                  st["exp_avg_sq"]))
                ref_fit.adam(pl, g, mu, nu, count, lr)
                p.copy_(pl.float())
                st.update(step=torch.tensor(count, dtype=torch.int32),
                          exp_avg=mu.float(), exp_avg_sq=nu.float())
        return loss.detach().float()

    return step


def _fit(kind, ctx):
    mod = importlib.import_module("raytracinginoneweekend_tpu_torch.optim."
                                  "inverse")
    if kind == "control":
        return [(mod, "make_train_step",
                 lambda optimizer, **kw: _control_step(ctx, optimizer, kw))]
    if kind == "stale":
        # the cell's first (set-up) steps update; the window's do not
        orig, calls = mod.Adam.step, [0]
        n = ctx.cell["check"]["steps"]

        def step(self, closure=None):
            calls[0] += 1
            return orig(self, closure) if calls[0] <= n else None

        return [(mod.Adam, "step", step)]
    if kind == "half":
        orig = mod.render_loss

        def loss(params, scene, cam, target, ids, key, **kw):
            h = max(1, ids.shape[0] // 2)
            return orig(params, scene, cam, target[:h], ids[:h], key, **kw)

        return [(mod, "render_loss", loss)]
    orig = mod._render_batch
    return [(mod, "_render_batch", lambda *a, **k: orig(*a, **k) * SCALE)]


def _previews(kind, ctx):
    mod = importlib.import_module("raytracinginoneweekend_tpu_torch.cli")
    orig, first = mod._render_image, []

    if kind == "control":
        from .drivers import previews
        from .reference import scenes, tracer

        ids = torch.as_tensor(previews.check_pixels(ctx))

        def control(args):
            arrays, cam = scenes.from_config(ctx.config,
                                             scene_seed=int(args.seed))
            low = tracer.trace_blocks(
                tracer.Scene(arrays, ctx.device, LOW), cam, ids, args.spp,
                (0, int(args.seed)), width=args.width, height=args.height,
                max_depth=args.depth, dtype=LOW)
            img = torch.zeros((args.width * args.height, 3),
                              device=ctx.device)
            img[ids.to(ctx.device)] = low.float()
            return img.reshape(args.height, args.width, 3), None

        return [(mod, "_render_image", control)]

    def render(args):
        if kind == "half":
            args.spp = max(1, args.spp // 2)
            return orig(args)
        if kind == "altered":
            img, cfg = orig(args)
            return img * SCALE, cfg
        if not first:
            first.append(orig(args))
        return first[0]

    return [(mod, "_render_image", render)]


FAULTS = {"frames": _frames, "fit": _fit, "previews": _previews}


@contextlib.contextmanager
def planted(ctx, kind: str | None):
    """Run the block with ``kind`` planted in the path of ``ctx``'s
    driver (None: nothing planted). ctx: the run's ``harness.Context``,
    or what the render server is given of it."""
    if kind is None:
        yield
        return
    if kind not in KINDS:
        raise ValueError(f"unknown fault {kind!r}")
    patches = FAULTS[ctx.traffic["driver"]](kind, ctx)
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, new in patches:
        setattr(obj, name, new)
    try:
        yield
    finally:
        for obj, name, old in saved:
            setattr(obj, name, old)
