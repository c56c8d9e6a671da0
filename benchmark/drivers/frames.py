"""Closed loop of full frames through the program's main render path.

Traffic keys: ``spp`` (samples a pixel). Each frame is
``ops.wavefront.render_wavefront`` (what ``render --engine auto`` runs) of
the configuration's scene and camera, with a fresh key from (seed, frame
index); it ends when its linear framebuffer is on the host. Set-up renders
one frame of its own key, which builds the kernels, captures the epoch's
CUDA graph and allocates what the frames reuse.

``--trace 1`` profiles the window's first ``trace.frames`` frames (cell
file), then renders one frame with the engine's occupancy counters on.

The check (cell file ``check``): ``frames`` frames drawn from the seed
among those the window completed, at ``pixels`` pixel ids drawn from the
seed; the reference renders those pixels with each frame's key, and the
number compared is the mean absolute gap over pixels and channels
(``frame_mean_abs_err``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..harness import Record
from ..reference import scenes, tracer
from ..reference import threefry as tf
from ..profiling import DeviceTrace
from . import common


def check_pixels(ctx) -> np.ndarray:
    """The pixel ids the check reads, drawn from the run's seed."""
    w, h = ctx.config["width"], ctx.config["height"]
    return common.draw_ids(np.random.default_rng((ctx.seed, 1)), w * h,
                           ctx.cell["check"]["pixels"])


def run(ctx) -> Record:
    from raytracinginoneweekend_tpu_torch.ops.wavefront import (
        render_wavefront)

    cfg, dev = ctx.config, ctx.device
    rec = Record(device=common.device_info(dev))
    scene_arrays, cam_arrays = scenes.from_config(cfg)
    scene, cam = common.port_inputs(scene_arrays, cam_arrays, dev)
    w, h, spp = cfg["width"], cfg["height"], ctx.traffic["spp"]
    kw = dict(spp=spp, width=w, height=h, max_depth=cfg["max_depth"],
              camera_mode=cfg["camera_mode"],
              options=common.port_options(cfg, dev),
              pool_size=cfg["pool_size"], device=dev)
    ids = check_pixels(ctx)
    n_traced = ctx.cell["trace"]["frames"] if ctx.trace else 0

    def frame(i, stats=False):
        out = render_wavefront(scene, cam, tf.seed_key(ctx.seed, 1, i),
                               return_stats=stats, **kw)
        fb, st = out if stats else (out, None)
        return fb.cpu().numpy(), st

    frame(-1)  # set-up: build, capture, allocate
    if n_traced:
        frame(-2, stats=True)
    common.sync(dev)
    rec.setup_s = time.perf_counter() - ctx.t0

    samples = []
    t0 = time.perf_counter()
    with DeviceTrace(n_traced > 0, dev) as traced:
        for i in range(n_traced):
            samples.append(frame(i)[0][ids])
    rec.trace, rec.traced_units = traced.summary, n_traced
    if n_traced:
        # the engine's counters cost a reduction an iteration: a frame of
        # their own, after the profiled ones
        host, st = frame(n_traced, stats=True)
        samples.append(host[ids])
        rec.counters = {"segments": st["segments"],
                        "lane_iters": st["iters"] * st["lanes"]}
    i = len(samples)
    while not samples or time.perf_counter() - t0 < ctx.seconds:
        t = time.perf_counter()
        try:
            host, _ = frame(i)
        except RuntimeError as e:  # a frame that fails is counted, once
            rec.failed += 1
            rec.notes.append(f"frame {i} failed: {e}")
            break
        samples.append(host[ids])
        rec.span("frame", time.perf_counter() - t)
        i += 1
    rec.window_s = time.perf_counter() - t0
    rec.units = len(samples)
    rec.attempted = rec.units + rec.failed
    rec.work["camera_rays"] = rec.units * w * h * spp
    rec.memory_peak_bytes = common.memory_peak(dev)
    del scene, cam
    common.release(dev)

    pick = common.draw_ids(np.random.default_rng((ctx.seed, 7)),
                           len(samples), ctx.cell["check"]["frames"])
    ref_scene = tracer.Scene(scene_arrays, dev)
    worst = 0.0
    t_ref = time.perf_counter()
    for f in pick:
        ref = tracer.trace_blocks(
            ref_scene, cam_arrays, torch.as_tensor(ids), spp,
            tf.seed_key(ctx.seed, 1, int(f)), width=w, height=h,
            max_depth=cfg["max_depth"])
        worst = max(worst, common.mean_abs_gap(samples[f], ref.cpu()))
    rec.notes.append(f"reference: {len(pick)} frames x {len(ids)} pixels "
                     f"in {time.perf_counter() - t_ref:.3f} s")
    rec.checks["frame_mean_abs_err"] = (
        worst, ctx.cell["limits"]["frame_mean_abs_err"])
    return rec
