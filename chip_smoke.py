#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # every phase, with the verdict
    python3 chip_smoke.py --phases kernels  # build + the kernel checks only

Needs one CUDA card, ``nvcc`` and this repository's checkout; imports only
``torch``, ``numpy`` and the port (``raytracinginoneweekend_tpu_torch``),
nothing of JAX. It exits non-zero -- and prints no ``"ok": true`` -- when
there is no CUDA device, when the port is not beside it, when a kernel does
not build, launch or agree with its plain PyTorch version, when the main
path did not go through a kernel, or when any phase's check fails.

Phases (one JSON object per line on standard output):
  device           card, versions, the kernels' build time.
  kernels          each hand-written kernel against its plain PyTorch
                   version on the card: real mid-frame lane states of the
                   huge scene at the main path's pool shape, synthetic edge
                   cases for closest_hit, and shade_regen stepped beside
                   its plain version for a few dozen iterations in five
                   configurations; closest_hit again as the training path
                   launches it (every lane of the planar AD engine's own
                   (1024, 128) ray planes, no active plane, at bounce 0
                   and after three bounces); intersect (the (N, 3) closest
                   hit) on
                   synthetic edge cases and on the huge scene's real rays
                   at bounce 0 and after three bounces, at the training
                   path's two shapes (960000 and 131072 rays). Times:
                   ``ms`` is the kernel's device time (launches queued
                   behind other work, so the host's launch overhead is
                   out), ``call_ms`` what one call of the wrapper costs the
                   engine's loop (device or host, whichever is longer),
                   ``plain_ms`` the plain version, ``bound_ms`` the least
                   the card could take.
  grad_vs_plain    the two closest-hit autograd.Functions -- forward through
                   the kernel, backward through the Function -- against
                   plain autograd through the plain forward, on the same
                   rays and cotangents; the per-sphere sum of the backward
                   timed as index_add_ and as a one-hot matrix product; a
                   render_loss gradient (240x160, depth 8), planar engine
                   against tiled and both against a float64 witness (the
                   tiled engine traced in float64), per leaf.
  frame_vs_plain   the whole engine, kernels against plain versions, at
                   240x160, 8 spp, depth 12 on the huge scene; and the
                   tiled engine with the intersect kernel against the
                   plain closest hit in each of the four camera modes.
  frame_vs_golden  the kernel path against the committed frames that the
                   JAX package rendered (testdata/golden_*.npz).
  main_path        the full-width render -- huge scene, 1200x800, 100 spp,
                   depth 50, thin lens, default options -- through the CLI
                   (writes a PNG into the kernels' build directory) with the
                   launch counts read around it, then timed at two pool
                   sizes and for the two estimator arms.
  train_path       the training path at full width -- huge scene, 1200x800
                   camera, thin lens, default options with
                   intersect="pallas": the target by render.render (tiled
                   engine, the intersect kernel) at 8 spp, depth 16, then
                   optim.fit on albedo and centers, 16384 pixels x 8 spp
                   a step, depth 16, engine "auto" (-> planar: the
                   closest_hit kernel under autograd), one warm-up step
                   and ten timed ones, with the launch counts read around
                   it; then one step split into forward, backward and
                   update, and one step of engine "tiled" on the same
                   batch.
  cli_fit          ``fit`` through the CLI on the small scene (200x112,
                   20 steps, a checkpoint written, reloaded and resumed).
Then the ``kernels`` line (``launches`` from the main path's run for
closest_hit and shade_regen and from the training path's for intersect,
``launches_train_path`` beside it, every other number measured in this
run), the card's name and power limit as
``nvidia-smi`` gives them, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Tolerances, and why:
  closest_hit   hit/sphere index equal on active lanes but for at most
                1e-4 of them, t within rtol 1e-6: kernel and plain version
                do the same IEEE float32 operations in the same order (the
                kernel is built with -fmad=false), so they agree to the
                bit; the allowance is for a compiler that orders one sum
                differently.
  shade_regen   integer planes (and the key words with them) equal on all
                but at most 1e-3 of lanes, float planes rtol 1e-5 / atol
                1e-6 on the lanes whose integer planes agree, but for at
                most 1e-4 of lanes: sinf/cosf/powf of the kernel's and of
                PyTorch's builds may differ by an ulp, which flips a
                `u < probability` or `dot > 0` decision on a few lanes in
                a million; a flip that keeps the integers (reflect against
                refract) shows as a float outlier.
  intersect     hit and sphere index equal on every ray, t within rtol
                1e-6: kernel and plain version do the same IEEE float32
                operations in the same order (ties keep the earliest
                sphere in both).
  gradients     closest-hit Functions against plain autograd: per input,
                max |difference| <= 2e-3 of the largest |gradient|, with
                the cotangent zeroed on grazing rays (|cos| of the angle
                between ray and normal under 0.05: there the implicit
                formula's (p-c).d and autograd's sqrt(disc) cancel
                differently, and the JAX package's own check of its custom
                VJP stays away from them too).
  render_loss   planar against tiled, per leaf, on the pixels whose
                radiance agrees (all but at most 1%, the frame rule; at
                most 10% against the float64 witness, whose t_min window
                on the r = 1000 ground falls on other restarts). Every
                element's error is taken over the size of its own row
                (one sphere's or one material's gradient), so the small
                spheres weigh as much as the ground. An element-wise rtol
                1e-3 cannot be met here by ANY float32 engine: at depth 8
                on 489 spheres the paths are chaotic, and the plain tiled
                engine itself sits 1e-3 of a row's size (median; a few
                percent at the 90th percentile) from its own float64
                trace in centers, radii, fuzz and ior. So the bar is the
                witness: at the median and at the 90th percentile the
                difference between the two engines must be at most a
                quarter of the tiled engine's own float32 error (measured:
                a fortieth or less), and the planar engine must sit no
                more than twice as far from the witness as the tiled one
                (measured: 0.9 to 1.3 times). A wrong or missing term on
                any tenth of a leaf's elements moves the 90th percentile.
                Albedo scales a fixed path's radiance and is well
                conditioned: every element within rtol 1e-3 plus 1e-2 of
                its row's size, and 1e-4 of the largest |gradient|. The
                99th percentile and the largest difference are printed.
                Sums by atomic adds change in the last bits besides.
  frames        the renderer's own rule (golden.compare_frames): at most
                1% knife-edge pixels, the rest atol 3e-5 / rtol 1e-4
                (atol 5e-4 against the JAX-made huge crop, whose XLA:CPU
                arithmetic contracts multiply-adds).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import time

PHASES = ("kernels", "grad_vs_plain", "frame_vs_plain", "frame_vs_golden",
          "main_path", "train_path", "cli_fit")

# Published peaks of one H100 SXM (NVIDIA's data sheet): float32 outside the
# tensor cores and HBM bandwidth. The bounds below are stated against them.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# closest_hit: float operations per lane and sphere (3 sub, 6 mul + 4 add
# for b and |oc|^2, 1 sub for c, 3 for the discriminant, sqrt, negate, 2
# roots, 2 window compares + 2 selects, 1 compare + 2 selects for the min).
CH_FLOPS_PER_SPHERE = 27
# shade_regen: float operations per lane (surface point and normal, shade,
# sky, state update, camera ray): a generous count; the integer hashing is
# not in the float peak's table and the bound is the bytes anyway.
SR_FLOPS_PER_LANE = 400

# intersect: float operations per ray and sphere (3 sub, 5 for b, 6 for c,
# 3 for the discriminant, 1 compare + 1 select under the sqrt, sqrt, negate,
# 2 roots, 2 products with 1/a, 2 window compares + 2 ands + 2 selects,
# 1 compare + 2 selects for the min).
IX_FLOPS_PER_SPHERE = 32
# bytes per ray: origin and direction in (24), t, index and hit flag out (9)
IX_BYTES_PER_RAY = 33

MAIN = dict(scene="huge", width=1200, height=800, spp=100, depth=50)
SMALL = dict(width=240, height=160, spp=8, depth=12)
# The training path: the target's frame and the step's batch (the JAX
# package's own AD measurement shape: 16384 pixels x 8 spp).
TRAIN = dict(width=1200, height=800, target_spp=8, depth=16,
             batch_pixels=16384, spp=8, warmup_steps=1, timed_steps=10,
             lr=1e-2, perturb=0.1)  # the CLI's default perturbation
GRAD = dict(width=240, height=160, spp=2, depth=8, rays=32768)
CLI_FIT = dict(width=200, height=112, steps=20)


class Failed(Exception):
    """A phase's check failed."""


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


# --------------------------------------------------------------------- #
# kernels phase
# --------------------------------------------------------------------- #

def make_engine(rt, torch, scene_name, camera_name, mode, options, *, width,
                height, spp, depth, pool_size, seed=0):
    from raytracinginoneweekend_tpu_torch import cli
    from raytracinginoneweekend_tpu_torch.ops import wavefront

    dev = torch.device("cuda")
    scene = cli._build_scene(scene_name, seed, dev)
    cam = cli._build_camera(camera_name, width, height, dev)
    return wavefront.build_engine(
        scene, cam, rt.key_words(seed), width=width, height=height, spp=spp,
        max_depth=depth, camera_mode=mode, options=options,
        pool_size=pool_size, device=dev)


def mid_frame_state(eng, n_steps: int):
    """A lane state captured from the engine in mid-frame: every lane's
    task queue is advanced to the middle of the image (lane l owns tasks l,
    l+P, ...; the first rounds are the top rows, all sky), then the engine
    runs n_steps iterations, which mixes depths, hits, misses and
    re-issues as the steady state does."""
    from raytracinginoneweekend_tpu_torch.ops import cuda_fused, wavefront

    state = list(wavefront.initial_lane_state(eng.lanes, eng.n_slots,
                                              eng.device))
    state[0] += (eng.n_k // 2) * eng.lanes
    state = cuda_fused.regen(tuple(state), eng.camvec, eng.base_words,
                             **eng.regen_kw)
    for _ in range(n_steps):
        state = wavefront.engine_step(eng, state)
    return tuple(p.clone() for p in state)


def compare_closest_hit(torch, rays, geom, t_min, active, table=None):
    """Kernel against plain version on one input -> dict of errors."""
    from raytracinginoneweekend_tpu_torch.ops import cuda_segment as seg

    hk, tk, sk = seg.segment_closest_hit(rays, *geom, t_min, active=active,
                                         table=table)
    hr, tr, sr = seg.segment_closest_hit_reference(rays, *geom, t_min,
                                                   active)
    torch.cuda.synchronize()
    act = (active > 0) if active is not None else torch.ones_like(hk) > 0
    n_act = int(act.sum())
    hit_bad = act & (hk != hr)
    both = act & (hk > 0) & (hr > 0)
    sb_bad = both & (sk != sr)
    agree = both & ~sb_bad
    dt = (tk - tr).abs()[agree]
    rel = (dt / tr[agree].abs()) if dt.numel() else dt
    idle = ~act
    idle_ok = bool(((hk[idle] == 0) & (tk[idle] == 1e30)
                    & (sk[idle] == 0)).all())
    n_bad = int((hit_bad | sb_bad).sum())
    return {"active": n_act, "hits": int((act & (hk > 0)).sum()),
            "int_mismatch": n_bad,
            "max_abs_err": float(dt.max()) if dt.numel() else 0.0,
            "max_rel_err": float(rel.max()) if rel.numel() else 0.0,
            "idle_ok": idle_ok,
            "ok": idle_ok and n_bad <= 1e-4 * max(n_act, 1)
            and (not rel.numel() or float(rel.max()) <= 1e-6),
            "out": (hk, tk, sk)}


def synthetic_closest_hit(torch, geom, t_min, lanes: int):
    """Edge cases for closest_hit on the huge scene -> {name: result}."""
    dev = geom[0].device
    gen = torch.Generator(device="cpu").manual_seed(7)
    shape = (lanes // 128, 128)

    def rnd(*s):
        return torch.rand(*s, generator=gen, dtype=torch.float32)

    def unit():
        v = torch.randn(3, *shape, generator=gen, dtype=torch.float32)
        return v / v.norm(dim=0, keepdim=True)

    def planes(o, d):
        return tuple(x.contiguous().to(dev) for x in (*o, *d))

    ones = torch.ones(shape, dtype=torch.int32, device=dev)
    out = {}
    # every lane inactive: the (0, 1e30, 0) convention and nothing else
    d = unit()
    o = torch.stack([rnd(*shape) * 8 - 4, rnd(*shape) * 2, rnd(*shape) * 8])
    res = compare_closest_hit(torch, planes(o, d), geom, t_min, ones * 0)
    require(res["active"] == 0 and res["idle_ok"], "all-inactive lanes")
    out["all_inactive"] = res
    # rays that miss everything: far above the scene, pointing up
    o = torch.stack([rnd(*shape) * 20 - 10, 2000 + rnd(*shape),
                     rnd(*shape) * 20 - 10])
    d = unit()
    d[1] = d[1].abs() + 0.1
    res = compare_closest_hit(torch, planes(o, d), geom, t_min, ones)
    require(res["hits"] == 0, "rays pointing away must miss everything")
    out["miss_everything"] = res
    # rays starting inside the hollow glass (sphere 4, radius -0.99, inside
    # sphere 3): the negative-radius shell must be the first hit. The rays
    # point upward, away from the small spheres that overlap the glass.
    c = torch.tensor([-2.0, 1.0, 0.0]).reshape(3, 1, 1)
    o = c + unit() * (rnd(*shape) * 0.5)
    d = unit()
    d[1] = d[1].abs()
    res = compare_closest_hit(torch, planes(o, d), geom, t_min, ones)
    require(bool((res["out"][2] == 4).all()) and res["hits"] == lanes,
            "rays inside the hollow glass must hit the inner shell")
    out["inside_hollow_glass"] = res
    # a lambert restart on the r = 1000 ground sphere: the origin sits on
    # the surface to float32 rounding, the exit root straddles t_min
    gc = torch.tensor([0.0, -1000.125, 0.0]).reshape(3, 1, 1)
    n = torch.stack([rnd(*shape) * 0.02 - 0.01, torch.ones(shape),
                     rnd(*shape) * 0.02 - 0.01])
    n = n / n.norm(dim=0, keepdim=True)
    o = gc + n * 1000.0
    res = compare_closest_hit(torch, planes(o, n + unit()), geom, t_min,
                              ones)
    out["ground_restart"] = res
    for name, res in out.items():
        require(res["ok"], f"closest_hit disagrees on {name}: "
                f"{ {k: v for k, v in res.items() if k != 'out'} }")
    return {name: {k: v for k, v in res.items() if k != "out"}
            for name, res in out.items()}


INT_PLANES = (0, 1, 2, 3, 13)
KEY_PLANES = (17, 18)


def compare_states(torch, got, want, n_slots: int):
    """shade_regen's output against the plain version's -> error dict."""
    n_base = 19
    ints = list(INT_PLANES) + [n_base + 4 * j for j in range(n_slots)]
    floats = [i for i in range(len(got))
              if i not in ints and i not in KEY_PLANES]
    int_agree = torch.ones_like(got[0], dtype=torch.bool)
    for i in ints:
        int_agree &= got[i] == want[i]
    key_agree = torch.ones_like(int_agree)
    for i in KEY_PLANES:
        key_agree &= got[i] == want[i]
    flt_ok = torch.ones_like(int_agree)
    max_abs = 0.0
    bit_unequal = {}
    for i in floats:
        close = torch.isclose(got[i], want[i], rtol=1e-5, atol=1e-6,
                              equal_nan=True)
        flt_ok &= close
        n_bits = int((int_agree & (got[i].view(torch.int32)
                                   != want[i].view(torch.int32))).sum())
        if n_bits:
            bit_unequal[i] = n_bits
        sel = int_agree & close & torch.isfinite(want[i])
        if bool(sel.any()):
            max_abs = max(max_abs,
                          float((got[i] - want[i]).abs()[sel].max()))
    return {"int_mismatch": int((~int_agree).sum()),
            "key_mismatch": int((int_agree & ~key_agree).sum()),
            "float_outliers": int((int_agree & ~flt_ok).sum()),
            "max_abs_err": max_abs, "bit_unequal_by_plane": bit_unequal}


def step_shade_regen(torch, eng, steps: int, start_steps: int):
    """Step the kernel beside its plain version from the same state,
    re-synchronised each step so that a knife-edge flip does not compound.
    """
    from raytracinginoneweekend_tpu_torch.ops import cuda_fused, cuda_segment

    lanes = eng.lanes
    state = mid_frame_state(eng, start_steps)
    geom = eng.sphere_params[:4]
    tot = {"int_mismatch": 0, "key_mismatch": 0, "float_outliers": 0,
           "max_abs_err": 0.0, "worst_int_mismatch": 0,
           "worst_float_outliers": 0, "bit_unequal_by_plane": {}}
    for k in range(steps):
        hit, t, sb = cuda_segment.segment_closest_hit(
            tuple(state[4:10]), *geom, eng.t_min, active=state[3],
            table=eng.htable)
        got = cuda_fused.shade_regen(state, (hit, t, sb), eng.table,
                                     eng.camvec, eng.base_words,
                                     **eng.step_kw)
        want = cuda_fused.shade_regen_reference(
            state, (hit, t),
            cuda_segment.resolve_params(sb, eng.sphere_params), eng.camvec,
            eng.base_words, **eng.step_kw)
        if k == 0:
            # the in-place form the engine uses gives the same planes
            inplace = tuple(p.clone() for p in state)
            cuda_fused.shade_regen(inplace, (hit, t, sb), eng.table,
                                   eng.camvec, eng.base_words, out=inplace,
                                   **eng.step_kw)
            same = all(bool(((a == b) | ((a != a) & (b != b))).all())
                       for a, b in zip(inplace, got))
            require(same, "shade_regen in place differs from out of place")
        torch.cuda.synchronize()
        res = compare_states(torch, got, want, eng.n_slots)
        for key in ("int_mismatch", "key_mismatch", "float_outliers"):
            tot[key] += res[key]
        tot["max_abs_err"] = max(tot["max_abs_err"], res["max_abs_err"])
        for plane, n in res["bit_unequal_by_plane"].items():
            tot["bit_unequal_by_plane"][plane] = (
                tot["bit_unequal_by_plane"].get(plane, 0) + n)
        tot["worst_int_mismatch"] = max(tot["worst_int_mismatch"],
                                        res["int_mismatch"])
        tot["worst_float_outliers"] = max(tot["worst_float_outliers"],
                                          res["float_outliers"])
        state = got
    tot["steps"] = steps
    tot["lanes"] = lanes
    tot["ok"] = (tot["worst_int_mismatch"] <= 1e-3 * lanes
                 and tot["key_mismatch"] == 0
                 and tot["worst_float_outliers"] <= max(1, 1e-4 * lanes))
    return tot


def kernels_phase(rt, torch, nvidia_smi: str):
    from raytracinginoneweekend_tpu_torch.ops import (cuda_fused,
                                                      cuda_segment)
    from raytracinginoneweekend_tpu_torch.utils.timing import cuda_time_ms

    rr = dataclasses.replace(rt.DEFAULT, rr_terminate=True)
    strat = dataclasses.replace(rt.DEFAULT, sampling="stratified")
    strat_rr = dataclasses.replace(strat, rr_terminate=True)
    shape = dict(width=MAIN["width"], height=MAIN["height"],
                 spp=MAIN["spp"], depth=MAIN["depth"])
    ch, sr = {}, {}
    for pool in (1 << 15, 1 << 20):
        eng = make_engine(rt, torch, "huge", "cpu", "thinlens", rt.DEFAULT,
                          pool_size=pool, **shape)
        state = mid_frame_state(eng, 40)
        rays, act = tuple(state[4:10]), state[3]
        geom = eng.sphere_params[:4]
        res = compare_closest_hit(torch, rays, geom, eng.t_min, act,
                                  table=eng.htable)
        seg = res.pop("out")
        require(res["ok"], f"closest_hit disagrees on a real lane state "
                f"(pool {pool}): {res}")
        n_sph = geom[0].shape[0]
        def run_ch():
            cuda_segment.segment_closest_hit(rays, *geom, eng.t_min,
                                             active=act, table=eng.htable)

        ms = cuda_time_ms(run_ch, iters=20, queue_behind=True)
        call_ms = cuda_time_ms(run_ch, iters=20)
        plain_ms = cuda_time_ms(
            lambda: cuda_segment.segment_closest_hit_reference(
                rays, *geom, eng.t_min, act), warmup=1, iters=3)
        flops = res["active"] * n_sph * CH_FLOPS_PER_SPHERE
        nbytes = eng.lanes * 40 + n_sph * 16
        t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
        ch[pool] = dict(res, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                        bound_ms=max(t_ops, t_bytes) * 1e3,
                        bound_by="operations" if t_ops >= t_bytes
                        else "bytes", lanes=eng.lanes, spheres=n_sph)

        n_state = len(state)
        outbuf = tuple(torch.empty_like(p) for p in state)
        def run_sr():
            cuda_fused.shade_regen(state, seg, eng.table, eng.camvec,
                                   eng.base_words, out=outbuf, **eng.step_kw)

        ms = cuda_time_ms(run_sr, iters=20, queue_behind=True)
        call_ms = cuda_time_ms(run_sr, iters=20)
        params = cuda_segment.resolve_params(seg[2], eng.sphere_params)
        plain_ms = cuda_time_ms(lambda: cuda_fused.shade_regen_reference(
            state, seg[:2], params, eng.camvec, eng.base_words,
            **eng.step_kw), warmup=1, iters=3)
        nbytes = eng.lanes * 4 * (3 + 2 * n_state) + n_sph * 40 + 19 * 4
        t_ops = eng.lanes * SR_FLOPS_PER_LANE / PEAK_F32_FLOPS
        t_bytes = nbytes / PEAK_BYTES_PER_S
        sr[pool] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                        bound_ms=max(t_ops, t_bytes) * 1e3,
                        bound_by="operations" if t_ops >= t_bytes
                        else "bytes", lanes=eng.lanes)
        if pool == 1 << 15:
            ch["synthetic"] = synthetic_closest_hit(torch, geom, eng.t_min,
                                                    eng.lanes)

    # shade_regen beside its plain version, five configurations
    stepped = {}
    configs = {
        "thinlens_iid": ("huge", "cpu", "thinlens", rt.DEFAULT),
        "thinlens_iid_rr": ("huge", "cpu", "thinlens", rr),
        "thinlens_stratified": ("huge", "cpu", "thinlens", strat),
        "thinlens_stratified_rr": ("huge", "cpu", "thinlens", strat_rr),
        "cuda_reference_cuda": ("simple-cuda", "cuda", "cuda",
                                rt.REFERENCE_CUDA),
    }
    worst = {"int_mismatch": 0, "float_outliers": 0, "max_abs_err": 0.0}
    for name, (scn, camn, mode, options) in configs.items():
        eng = make_engine(rt, torch, scn, camn, mode, options,
                          pool_size=1 << 15, **shape)
        res = step_shade_regen(torch, eng, steps=24, start_steps=8)
        stepped[name] = res
        require(res["ok"], f"shade_regen disagrees with its plain version "
                f"({name}): {res}")
        worst["int_mismatch"] = max(worst["int_mismatch"],
                                    res["worst_int_mismatch"])
        worst["float_outliers"] = max(worst["float_outliers"],
                                      res["worst_float_outliers"])
        worst["max_abs_err"] = max(worst["max_abs_err"], res["max_abs_err"])

    ch["train_shape"] = closest_hit_train_shape(rt, torch)
    main_pool = 1 << 15
    line = [
        {"name": "closest_hit", "route": "cuda",
         "source": "raytracinginoneweekend_tpu_torch/csrc/closest_hit.cu",
         "replaces": "raytracinginoneweekend_tpu/ops/pallas_segment.py:55",
         "launches": None,
         "max_abs_err": ch[main_pool]["max_abs_err"],
         "max_rel_err": ch[main_pool]["max_rel_err"],
         "int_mismatch_lanes": ch[main_pool]["int_mismatch"],
         "ms": ch[main_pool]["ms"], "call_ms": ch[main_pool]["call_ms"],
         "plain_ms": ch[main_pool]["plain_ms"],
         "bound_ms": ch[main_pool]["bound_ms"],
         "bound_by": ch[main_pool]["bound_by"], "library_ms": None,
         "lanes": ch[main_pool]["lanes"],
         "active_lanes": ch[main_pool]["active"],
         "at_pool_1m": {k: ch[1 << 20][k] for k in (
             "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "lanes",
             "active",
             "max_abs_err", "int_mismatch")},
         "at_train_shape": {k: ch["train_shape"]["after_3_bounces"][k]
                            for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "lanes", "shape",
                                      "max_abs_err", "max_rel_err",
                                      "int_mismatch")}},
        {"name": "shade_regen", "route": "cuda",
         "source": "raytracinginoneweekend_tpu_torch/csrc/shade_regen.cu",
         "replaces": "raytracinginoneweekend_tpu/ops/pallas_fused.py:87",
         "launches": None,
         "max_abs_err": worst["max_abs_err"],
         "int_mismatch_lanes": worst["int_mismatch"],
         "float_outlier_lanes": worst["float_outliers"],
         "ms": sr[main_pool]["ms"], "call_ms": sr[main_pool]["call_ms"],
         "plain_ms": sr[main_pool]["plain_ms"],
         "bound_ms": sr[main_pool]["bound_ms"],
         "bound_by": sr[main_pool]["bound_by"], "library_ms": None,
         "lanes": sr[main_pool]["lanes"],
         "at_pool_1m": sr[1 << 20]},
    ]
    ix = intersect_checks(rt, torch)
    big, small = ix["rays_960000"], ix["rays_131072"]
    line.append(
        {"name": "intersect", "route": "cuda",
         "source": "raytracinginoneweekend_tpu_torch/csrc/intersect.cu",
         "replaces": "raytracinginoneweekend_tpu/ops/pallas_intersect.py:40",
         "launches": None,
         "max_abs_err": max(r["max_abs_err"] for r in ix.values()),
         "max_rel_err": max(r["max_rel_err"] for r in ix.values()),
         "int_mismatch_lanes": sum(r["int_mismatch"] for r in ix.values()),
         "ms": big["ms"], "call_ms": big["call_ms"],
         "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
         "bound_by": big["bound_by"], "library_ms": None,
         "rays": big["rays"], "spheres": big["spheres"],
         "at_131072_rays": {k: small[k] for k in (
             "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "rays",
             "max_abs_err", "int_mismatch")}})
    emit({"phase": "kernels", "card": nvidia_smi, "closest_hit": ch,
          "shade_regen": sr, "shade_regen_stepped": stepped,
          "intersect": ix})
    return line


# --------------------------------------------------------------------- #
# kernels phase: intersect, the (N, 3) closest hit
# --------------------------------------------------------------------- #

def compare_intersect(torch, o, d, centers, radii, t_min):
    """Kernel against plain version on one input -> dict of errors."""
    from raytracinginoneweekend_tpu_torch.ops.cuda_intersect import (
        closest_hit_cuda)
    from raytracinginoneweekend_tpu_torch.ops.intersect import closest_hit

    tk, ik, hk = closest_hit_cuda(o, d, centers, radii, t_min)
    tr, ir, hr = closest_hit(o, d, centers, radii, t_min)
    torch.cuda.synchronize()
    bad = (hk != hr) | (ik != ir)
    agree = hk & hr & ~bad
    dt = (tk - tr).abs()[agree]
    rel = dt / tr[agree].abs()
    miss_ok = bool(((tk[~hk] == 1e30) & (ik[~hk] == 0)).all())
    res = {"rays": o.shape[0], "spheres": centers.shape[0],
           "hits": int(hk.sum()), "int_mismatch": int(bad.sum()),
           "max_abs_err": float(dt.max()) if dt.numel() else 0.0,
           "max_rel_err": float(rel.max()) if rel.numel() else 0.0,
           "miss_convention_ok": miss_ok}
    res["ok"] = (miss_ok and res["int_mismatch"] == 0
                 and res["max_rel_err"] <= 1e-6)
    return res, (tk, ik, hk)


def synthetic_intersect(torch, scene, t_min):
    """Edge cases for intersect -> {name: result}."""
    dev = scene.centers.device
    gen = torch.Generator(device="cpu").manual_seed(11)
    n = 4096 + 77  # not a multiple of the block

    def rnd(*s):
        return torch.rand(*s, generator=gen, dtype=torch.float32)

    def unit(k=n):
        v = torch.randn(k, 3, generator=gen, dtype=torch.float32)
        return v / v.norm(dim=1, keepdim=True)

    def run(o, d, centers=scene.centers, radii=scene.radii, tm=t_min):
        return compare_intersect(torch, o.contiguous().to(dev),
                                 d.contiguous().to(dev), centers, radii, tm)

    out = {}
    # rays far above the scene, pointing up: nothing is hit
    o = torch.stack([rnd(n) * 20 - 10, 2000 + rnd(n), rnd(n) * 20 - 10], 1)
    d = unit()
    d[:, 1] = d[:, 1].abs() + 0.1
    res, _ = run(o, d)
    require(res["hits"] == 0, "rays pointing away must miss everything")
    out["miss_everything"] = res
    # inside the hollow glass (sphere 4, radius -0.99, inside sphere 3):
    # the far root of the negative-radius shell is the first hit
    o = torch.tensor([-2.0, 1.0, 0.0]) + unit() * (rnd(n, 1) * 0.5)
    d = unit()
    d[:, 1] = d[:, 1].abs()
    res, (_, idx, _) = run(o, d)
    require(bool((idx == 4).all()) and res["hits"] == n,
            "rays inside the hollow glass must hit the inner shell")
    out["inside_hollow_glass"] = res
    # a restart on the r = 1000 ground sphere: the origin sits on the
    # surface to float32 rounding, the exit root straddles t_min
    nrm = torch.stack([rnd(n) * 0.02 - 0.01, torch.ones(n),
                       rnd(n) * 0.02 - 0.01], 1)
    nrm = nrm / nrm.norm(dim=1, keepdim=True)
    o = torch.tensor([0.0, -1000.125, 0.0]) + nrm * 1000.0
    out["ground_restart"], _ = run(o, nrm + unit())
    # a wide t_min window: near roots inside it are refused for far ones
    o = torch.stack([rnd(n) * 8 - 4, rnd(n) * 2, rnd(n) * 8], 1)
    out["t_min_window_0.5"], _ = run(o, unit(), tm=0.5)
    # exact ties: every sphere twice, the earlier copy must win
    c2 = torch.cat([scene.centers[:40], scene.centers[:40]])
    r2 = torch.cat([scene.radii[:40], scene.radii[:40]])
    res, (_, idx, hit) = run(o, unit() * 3.0, centers=c2, radii=r2)
    require(bool((idx < 40).all()) and res["hits"] > 0,
            "a tie must keep the earliest sphere")
    out["exact_ties"] = res
    # one ray, one sphere
    res, (t, _, _) = run(torch.zeros(1, 3), torch.tensor([[0.0, 0.0, -4.0]]),
                         centers=torch.tensor([[0.0, 0.0, -2.0]],
                                              device=dev),
                         radii=torch.tensor([1.0], device=dev))
    require(abs(float(t[0]) - 0.25) < 1e-6, "t is in units of |d|")
    out["one_ray_one_sphere"] = res
    for name, res in out.items():
        require(res["ok"], f"intersect disagrees on {name}: {res}")
    return out


def training_rays(rt, torch, scene, cam, pixel_ids, spp, bounces):
    """The tiled engine's real rays: primary rays of ``pixel_ids`` x spp,
    then ``bounces`` steps of the engine -> [(origin, direction), ...] at
    bounce 0 and after the last step."""
    import importlib

    from raytracinginoneweekend_tpu_torch.ops import integrate

    prender = importlib.import_module(
        "raytracinginoneweekend_tpu_torch.render")
    pids = torch.repeat_interleave(pixel_ids, spp)
    sids = torch.arange(spp, dtype=torch.int32,
                        device=pixel_ids.device).repeat(pixel_ids.shape[0])
    with torch.no_grad():
        o, d, keys = prender.make_primary_rays(
            cam, pids, sids, rt.key_words(0), TRAIN["width"],
            TRAIN["height"], "thinlens")
        out = [(o.contiguous(), d.contiguous())]
        state = integrate._init_state(o, d, keys)
        options = dataclasses.replace(rt.DEFAULT, intersect="pallas")
        for b in range(bounces):
            state = integrate._bounce_step(scene, options, state, b,
                                           allow_pallas=True)
        out.append((state[0].contiguous(), state[1].contiguous()))
    return out


def planar_training_planes(rt, torch, scene, cam, pixel_ids, spp, bounces):
    """The planar AD engine's own ray planes, as trace_planar hands them to
    closest_hit: the camera rays of ``pixel_ids`` x spp on (R, 128) planes,
    then ``bounces`` steps of the engine -> [6 planes, ...] at bounce 0 and
    after the last step."""
    from raytracinginoneweekend_tpu_torch.ops import integrate_planar as ip
    from raytracinginoneweekend_tpu_torch.ops import planar

    dev = pixel_ids.device
    pid = torch.repeat_interleave(pixel_ids, spp).reshape(-1, ip.LANES)
    sid = torch.arange(spp, dtype=torch.int32, device=dev).repeat(
        pixel_ids.shape[0]).reshape(-1, ip.LANES)
    with torch.no_grad():
        *rays, rk0, rk1 = planar.camera_rays(
            cam, pid, sid, rt.key_words(0), TRAIN["width"], TRAIN["height"],
            "thinlens", sampling="iid", spp=spp)
        one, zero = torch.ones_like(rays[0]), torch.zeros_like(rays[0])
        state = (*rays, one, one, one, zero, zero, zero, one > 0, rk0, rk1)
        out = [tuple(rays)]
        table = ip._material_table(scene)
        for b in range(bounces):
            khit = ip.closest_hit_planar(state[:6], (scene.centers,
                                                     scene.radii),
                                         rt.DEFAULT.t_min)
            state = ip._shade_step_planar(table, rt.DEFAULT, state, khit, b)
        out.append(tuple(p.contiguous() for p in state[:6]))
    return out


def closest_hit_train_shape(rt, torch):
    """closest_hit as the training path launches it: every lane of the
    planar engine's (1024, 128) ray planes, no active plane, the table
    built by the wrapper -- against its plain version, and timed."""
    from raytracinginoneweekend_tpu_torch import cli
    from raytracinginoneweekend_tpu_torch.ops import cuda_segment
    from raytracinginoneweekend_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", TRAIN["width"], TRAIN["height"], dev)
    t_min = rt.DEFAULT.t_min
    gen = torch.Generator(device="cpu").manual_seed(3)
    batch = torch.randperm(TRAIN["width"] * TRAIN["height"],
                           generator=gen)[:TRAIN["batch_pixels"]]
    planes = planar_training_planes(rt, torch, scene, cam,
                                    batch.to(torch.int32).to(dev),
                                    TRAIN["spp"], bounces=3)
    geom = cuda_segment.sphere_params_from_scene(scene)[:4]
    n_sph = geom[0].shape[0]
    out = {}
    for tag, rays in zip(("bounce_0", "after_3_bounces"), planes):
        res = compare_closest_hit(torch, rays, geom, t_min, None)
        del res["out"]
        require(res["ok"] and res["int_mismatch"] == 0, "closest_hit "
                f"disagrees on the training path's planes ({tag}): {res}")
        res["ms"] = cuda_time_ms(
            lambda: cuda_segment.segment_closest_hit(rays, *geom, t_min),
            iters=20, queue_behind=True)
        res["plain_ms"] = cuda_time_ms(
            lambda: cuda_segment.segment_closest_hit_reference(
                rays, *geom, t_min, None), warmup=1, iters=3)
        lanes = rays[0].numel()
        t_ops = lanes * n_sph * CH_FLOPS_PER_SPHERE / PEAK_F32_FLOPS
        t_bytes = (lanes * 36 + n_sph * 16) / PEAK_BYTES_PER_S
        res.update(lanes=lanes, shape=list(rays[0].shape), spheres=n_sph,
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        out[tag] = res
    return out


def intersect_checks(rt, torch):
    from raytracinginoneweekend_tpu_torch import cli
    from raytracinginoneweekend_tpu_torch.ops.cuda_intersect import (
        closest_hit_cuda)
    from raytracinginoneweekend_tpu_torch.ops.intersect import closest_hit
    from raytracinginoneweekend_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", TRAIN["width"], TRAIN["height"], dev)
    t_min = rt.DEFAULT.t_min
    out = {f"synthetic_{k}": v
           for k, v in synthetic_intersect(torch, scene, t_min).items()}
    n_pix = TRAIN["width"] * TRAIN["height"]
    gen = torch.Generator(device="cpu").manual_seed(3)
    batch = torch.randperm(n_pix, generator=gen)[:TRAIN["batch_pixels"]]
    shapes = {
        n_pix: (torch.arange(n_pix, dtype=torch.int32, device=dev), 1),
        TRAIN["batch_pixels"] * TRAIN["spp"]: (
            batch.to(torch.int32).to(dev), TRAIN["spp"]),
    }
    n_sph = scene.centers.shape[0]
    for n, (ids, spp) in shapes.items():
        rays = training_rays(rt, torch, scene, cam, ids, spp, bounces=3)
        for tag, (o, d) in zip(("", "_after_3_bounces"), rays):
            res, _ = compare_intersect(torch, o, d, scene.centers,
                                       scene.radii, t_min)
            require(res["ok"], f"intersect disagrees on real rays "
                    f"({n}{tag}): {res}")
            out[f"rays_{n}{tag}"] = res
        o, d = rays[1]  # mid-path rays: hits, misses and restarts mixed

        def run():
            closest_hit_cuda(o, d, scene.centers, scene.radii, t_min)

        res = out[f"rays_{n}"]
        res["ms"] = cuda_time_ms(run, iters=20, queue_behind=True)
        res["call_ms"] = cuda_time_ms(run, iters=20)
        res["plain_ms"] = cuda_time_ms(
            lambda: closest_hit(o, d, scene.centers, scene.radii, t_min),
            warmup=1, iters=3)
        t_ops = n * n_sph * IX_FLOPS_PER_SPHERE / PEAK_F32_FLOPS
        t_bytes = (n * IX_BYTES_PER_RAY + n_sph * 16) / PEAK_BYTES_PER_S
        res["bound_ms"] = max(t_ops, t_bytes) * 1e3
        res["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return out


# --------------------------------------------------------------------- #
# grad_vs_plain phase
# --------------------------------------------------------------------- #

def _rel_to_largest(got, want):
    """max |got - want| over the largest |want| (0 when both vanish)."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    norm = float(want.norm())
    d = (got - want).abs()
    return {"max_abs_err": err, "largest": scale,
            "rel_to_largest": err / scale if scale > 0 else err,
            "rel_l2": float(d.norm()) / norm if norm > 0
            else float(d.norm()),
            "share_beyond_1e-3_of_largest":
                float((d > 1e-3 * scale).float().mean()),
            "share_beyond_1e-2_of_largest":
                float((d > 1e-2 * scale).float().mean())}


def to_float64(scene, cam, params):
    """The scene's float leaves, the camera and the parameters in float64:
    the tiled engine then traces the same paths (the random draws stay the
    float32 ones) with float64 arithmetic -- the witness the two float32
    engines' gradients are held against."""
    import torch

    f64 = torch.float64
    scene = scene._replace(**{k: getattr(scene, k).to(f64) for k in (
        "centers", "radii", "albedo", "fuzz", "ior")})
    return (scene, type(cam)(*(t.to(f64) for t in cam)),
            {k: v.to(f64) for k, v in params.items()})


def engine_gradients_raw(torch, rt, params, scene, cam, target, ids, key,
                         **kw):
    """render_loss gradients of the planar engine, the tiled engine and the
    float64 witness (the tiled engine in float64) on the pixels where the
    three runs' radiance agrees -> ({run: {leaf: gradient}}, pixels where
    planar and tiled differ, pixels set aside, pixels).

    A path in a thousand crosses a t_min or a Schlick knife edge in one
    run only and then is another path; the renderer's own frame rule sets
    such pixels aside (at most 1%), and so does this comparison: the loss's
    cotangent is zeroed on them, in all three runs.
    """
    from raytracinginoneweekend_tpu_torch import optim
    from raytracinginoneweekend_tpu_torch.optim import inverse

    held = {k: v.detach() for k, v in params.items()}
    runs = {"planar": ("planar", scene, cam, held),
            "tiled": ("tiled", scene, cam, held),
            "witness": ("tiled", *to_float64(scene, cam, held))}
    with torch.no_grad():
        px = {name: inverse._render_batch(
            optim.scene_with_params(sc, p), cm, ids, key, engine=e, **kw)
            for name, (e, sc, cm, p) in runs.items()}
    near = {name: torch.isclose(px[name].to(torch.float32), px["tiled"],
                                rtol=1e-4, atol=3e-5).all(dim=-1)
            for name in ("planar", "witness")}
    agree = near["planar"] & near["witness"]
    cot = 2.0 * (px["tiled"] - target) / target.numel() * agree[:, None]
    grads = {}
    for name, (e, sc, cm, p) in runs.items():
        p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        grads[name], _ = optim.render_pixels_vjp(
            p, sc, cm, cot, ids, key, engine=e, **kw)
    return (grads, int((~near["planar"]).sum()), int((~agree).sum()),
            int(agree.numel()))


def _spread(err, scale, live):
    """Quantiles of err / scale over the live elements."""
    import torch

    r = (err / scale.clamp_min(1e-300))[live]
    q = torch.quantile(r, torch.tensor([0.5, 0.9, 0.99], dtype=r.dtype,
                                       device=r.device))
    return {"median": float(q[0]), "p90": float(q[1]), "p99": float(q[2]),
            "max": float(r.max())}


def engine_gradients(torch, rt, params, scene, cam, target, ids, key, **kw):
    """The per-leaf record behind ``engine_gradients_agree``: planar
    against tiled, and each against the float64 witness, element by
    element, every error over the size of its own row (one sphere's or
    one material's gradient: the witness's largest |element| there), so
    that the small spheres count as much as the ground."""
    grads, n_apart, n_witness_apart, n_px = engine_gradients_raw(
        torch, rt, params, scene, cam, target, ids, key, **kw)
    out = {}
    for k in params:
        p, t, w = (grads[e][k].to(torch.float64).reshape(
            grads[e][k].shape[0], -1) for e in ("planar", "tiled",
                                                "witness"))
        scale = w.abs().amax(dim=1, keepdim=True).expand_as(w)
        live = scale > 0
        res = _rel_to_largest(p, t)
        res["finite"] = bool(torch.isfinite(p).all()
                             and torch.isfinite(t).all())
        res["elements"] = int(live.sum())
        res["planar_vs_tiled"] = _spread((p - t).abs(), scale, live)
        res["tiled_vs_witness"] = _spread((t - w).abs(), scale, live)
        res["planar_vs_witness"] = _spread((p - w).abs(), scale, live)
        own = t.abs().amax(dim=1, keepdim=True)
        res["elements_beyond_rtol_1e-3_atol_1e-2_of_row"] = int(
            ((p - t).abs() > 1e-3 * t.abs() + 1e-2 * own).sum())
        out[k] = res
    return out, {"pixels": n_px, "knife_edge_pixels": n_apart,
                 "witness_knife_edge_pixels": n_witness_apart}


def engine_gradients_agree(leaf: str, res: dict) -> bool:
    """The bar for one leaf of ``engine_gradients`` (see the tolerances in
    the module's docstring)."""
    pt, tw, pw = (res[k] for k in ("planar_vs_tiled", "tiled_vs_witness",
                                   "planar_vs_witness"))
    ok = res["finite"] and res["largest"] > 0 and res["elements"] > 0
    for q in ("median", "p90"):
        ok = ok and pt[q] <= 0.25 * tw[q] and pw[q] <= 2.0 * tw[q]
    if leaf == "albedo":
        ok = (ok and res["rel_to_largest"] <= 1e-4
              and res["elements_beyond_rtol_1e-3_atol_1e-2_of_row"] == 0)
    return ok


def engine_pixels_agree(px: dict):
    """[(condition, message)] for the pixels ``engine_gradients`` set
    aside: the frame rule's 1% between the two float32 engines, 10%
    against the float64 witness (whose t_min window on the r = 1000 ground
    sphere falls on other restarts than float32's)."""
    n = px["pixels"]
    return [(px["knife_edge_pixels"] <= 0.01 * n,
             f"{px['knife_edge_pixels']} of {n} pixels differ between the "
             "planar and the tiled engine"),
            (px["witness_knife_edge_pixels"] <= 0.10 * n,
             f"{px['witness_knife_edge_pixels']} of {n} pixels differ "
             "between the float32 engines and the float64 witness")]


def closest_hit_grads(torch, fn, o, d, centers, radii, cot):
    """d sum(cot * t) / d (origin, direction, centers, radii) through
    ``fn(o, d, centers, radii) -> (t, hit)``."""
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (o, d, centers, radii)]
    t, hit = fn(*leaves)
    torch.sum(torch.where(hit, t, torch.zeros_like(t)) * cot).backward()
    return [x.grad for x in leaves]


def grad_vs_plain_phase(rt, torch, nvidia_smi: str):
    from raytracinginoneweekend_tpu_torch import cli, kernels, optim
    from raytracinginoneweekend_tpu_torch.ops import integrate_planar
    from raytracinginoneweekend_tpu_torch.ops import intersect
    from raytracinginoneweekend_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", TRAIN["width"], TRAIN["height"], dev)
    t_min = rt.DEFAULT.t_min
    n_pix = TRAIN["width"] * TRAIN["height"]
    gen = torch.Generator(device="cpu").manual_seed(5)
    n = GRAD["rays"]
    ids = torch.randperm(n_pix, generator=gen)[:n // TRAIN["spp"]]
    rays = training_rays(rt, torch, scene, cam,
                         ids.to(torch.int32).to(dev), TRAIN["spp"],
                         bounces=2)
    out = {}
    launches0 = dict(kernels.LAUNCHES)
    for tag, (o, d) in zip(("bounce_0", "after_2_bounces"), rays):
        # cotangent: random, zero on grazing rays (see the tolerances)
        with torch.no_grad():
            t, idx, hit = intersect.closest_hit(o, d, scene.centers,
                                                scene.radii, t_min)
            p, nrm = intersect.hit_surface(o, d, t, idx, hit,
                                           scene.centers, scene.radii)
            cos = (nrm * d).sum(-1) / d.norm(dim=-1)
            keep = hit & (cos.abs() > 0.05)
        cot = torch.rand(n, generator=gen).to(dev) * keep

        def plain(o_, d_, c_, r_):
            t_, _i, h_ = intersect.closest_hit(o_, d_, c_, r_, t_min)
            return t_, h_

        def diff(o_, d_, c_, r_):
            t_, _i, h_ = intersect.closest_hit_diff(o_, d_, c_, r_, t_min,
                                                    use_pallas=True)
            return t_, h_

        def planar(o_, d_, c_, r_):
            planes = tuple(o_[:, k].reshape(-1, 128) for k in range(3)) \
                + tuple(d_[:, k].reshape(-1, 128) for k in range(3))
            t_, _sb, hit_i = integrate_planar.closest_hit_planar(
                planes, (c_, r_), t_min)
            return t_.reshape(-1), hit_i.reshape(-1) > 0

        want = closest_hit_grads(torch, plain, o, d, scene.centers,
                                 scene.radii, cot)
        for name, fn in (("closest_hit_diff", diff),
                         ("closest_hit_planar", planar)):
            got = closest_hit_grads(torch, fn, o, d, scene.centers,
                                    scene.radii, cot)
            res = {k: _rel_to_largest(g, w) for k, g, w in zip(
                ("origin", "direction", "centers", "radii"), got, want)}
            res["rays"] = n
            res["rays_with_cotangent"] = int(keep.sum())
            out[f"{name}_{tag}"] = res
    torch.cuda.synchronize()
    used = {k: kernels.LAUNCHES[k] - launches0[k]
            for k in ("closest_hit", "intersect")}
    require(used["closest_hit"] >= 2 and used["intersect"] >= 2,
            f"the Functions' forwards did not launch the kernels: {used}")

    # the backward's per-sphere sum, both ways, at the step's shape
    n_step = TRAIN["batch_pixels"] * TRAIN["spp"]
    with torch.no_grad():
        big = training_rays(
            rt, torch, scene, cam,
            torch.randperm(n_pix, generator=gen)[:TRAIN["batch_pixels"]]
            .to(torch.int32).to(dev), TRAIN["spp"], bounces=2)[1]
        _t, idx, _h = intersect.closest_hit_diff(
            *big, scene.centers, scene.radii, t_min, use_pallas=True)
    idx64 = idx.to(torch.int64)
    rows = torch.rand(n_step, 4, generator=gen).to(dev)
    n_sph = scene.centers.shape[0]
    sphere_ids = torch.arange(n_sph, device=dev)

    def by_index_add():
        return intersect.sum_by_winner(idx64, rows, n_sph)

    def by_onehot_matmul():
        onehot = (idx64[:, None] == sphere_ids[None, :]).to(torch.float32)
        return onehot.T @ rows

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    sums = {"rays": n_step, "spheres": n_sph,
            "share_of_rays_on_sphere_0": float((idx64 == 0).float().mean()),
            "forms_agree": _rel_to_largest(by_index_add(),
                                           by_onehot_matmul())}
    sums["index_add_ms"] = cuda_time_ms(by_index_add, iters=20,
                                        queue_behind=True)
    sums["onehot_matmul_ms"] = cuda_time_ms(by_onehot_matmul, iters=20,
                                            queue_behind=True)
    torch.backends.cuda.matmul.allow_tf32 = tf32

    # render_loss gradients, planar against tiled, per leaf
    w, h = GRAD["width"], GRAD["height"]
    cam_s = cli._build_camera("cpu", w, h, dev)
    ids = torch.arange(w * h, dtype=torch.int32, device=dev)
    target = torch.rand(w * h, 3, generator=gen).to(dev)
    kw = dict(width=w, height=h, spp=GRAD["spp"], max_depth=GRAD["depth"],
              camera_mode="thinlens", options=rt.DEFAULT)
    leaf, px = engine_gradients(
        torch, rt, optim.params_from_scene(scene), scene, cam_s, target,
        ids, rt.key_words(1), **kw)
    emit({"phase": "grad_vs_plain", "card": nvidia_smi,
          "closest_hit_functions": out, "per_sphere_sum": sums,
          "render_loss": {"width": w, "height": h, "spp": GRAD["spp"],
                          "depth": GRAD["depth"], **px, "leaves": leaf}})
    for name, res in out.items():
        for k in ("origin", "direction", "centers", "radii"):
            require(res[k]["rel_to_largest"] <= 2e-3 and res[k]["largest"]
                    > 0, f"{name}: gradient of {k} differs from plain "
                    f"autograd: {res[k]}")
    require(sums["forms_agree"]["rel_to_largest"] <= 1e-5,
            f"index_add_ and the one-hot product disagree: {sums}")
    for cond, what in engine_pixels_agree(px):
        require(cond, what)
    for k, res in leaf.items():
        require(engine_gradients_agree(k, res),
                f"render_loss gradient of {k}, planar vs tiled: {res}")
    return sums


# --------------------------------------------------------------------- #
# frame phases
# --------------------------------------------------------------------- #

def render(rt, torch, options, *, width, height, spp, depth,
           pool_size=1 << 15, plain=False, stats=False, scene=None,
           cam=None):
    from raytracinginoneweekend_tpu_torch import cli

    dev = torch.device("cuda")
    scene = scene or cli._build_scene("huge", 0, dev)
    cam = cam or cli._build_camera("cpu", width, height, dev)
    return rt.render_wavefront(
        scene, cam, rt.key_words(0), width=width, height=height, spp=spp,
        max_depth=depth, camera_mode="thinlens", options=options,
        pool_size=pool_size, plain=plain, return_stats=stats, device=dev)


def tiled_modes(rt, torch):
    """The tiled engine on the card in each camera mode, the intersect
    kernel against the plain closest hit ("cuda" and "pinhole" hand the
    engine one origin expanded over the rays, not dense rows)."""
    import importlib

    from raytracinginoneweekend_tpu_torch import cli, kernels
    from raytracinginoneweekend_tpu_torch.golden import compare_frames

    prender = importlib.import_module(
        "raytracinginoneweekend_tpu_torch.render")
    dev = torch.device("cuda")
    w, h = SMALL["width"], SMALL["height"]
    out = {}
    for mode, scn, camn, preset in (
            ("thinlens", "huge", "cpu", rt.DEFAULT),
            ("pinhole", "huge", "cpu", rt.DEFAULT),
            ("cpu", "huge", "cpu", rt.REFERENCE_CPU),
            ("cuda", "simple-cuda", "cuda", rt.REFERENCE_CUDA)):
        scene = cli._build_scene(scn, 0, dev)
        cam = cli._build_camera(camn, w, h, dev)
        frames = {}
        before = kernels.LAUNCHES["intersect"]
        for how in ("pallas", "jnp"):
            cfg = rt.RenderConfig(
                width=w, height=h, spp=4, max_depth=8, camera_mode=mode,
                options=dataclasses.replace(preset, intersect=how))
            frames[how] = prender.render(scene, cam, cfg, rt.key_words(0),
                                         device=dev)
        res = compare_frames(frames["pallas"].reshape(-1, 3).cpu().numpy(),
                             frames["jnp"].reshape(-1, 3).cpu().numpy())
        res["intersect_launches"] = kernels.LAUNCHES["intersect"] - before
        res["max_abs_diff"] = float((frames["pallas"]
                                     - frames["jnp"]).abs().max())
        out[mode] = res
    return out


def frame_vs_plain_phase(rt, torch, nvidia_smi: str):
    from raytracinginoneweekend_tpu_torch.golden import compare_frames

    img_k, st_k = render(rt, torch, rt.DEFAULT, stats=True, **SMALL)
    img_p, st_p = render(rt, torch, rt.DEFAULT, stats=True, plain=True,
                         **SMALL)
    cmp = compare_frames(img_k.cpu().numpy(), img_p.cpu().numpy())
    seg_rel = abs(st_k["segments"] - st_p["segments"]) / st_p["segments"]
    res = {"phase": "frame_vs_plain", "card": nvidia_smi, **SMALL,
           "kernels": st_k, "plain": st_p, "compare": cmp,
           "segments_rel_diff": seg_rel,
           "mean": float(img_k.mean()), "tiled_modes": tiled_modes(rt, torch)}
    emit(res)
    for mode, r in res["tiled_modes"].items():
        require(r["ok"] and r["intersect_launches"] > 0,
                f"tiled engine, camera mode {mode}: the kernel's frame "
                f"differs from the plain closest hit's: {r}")
    require(cmp["ok"], f"kernel frame differs from plain frame: {cmp}")
    require(st_k["iters"] == st_p["iters"], "iters differ")
    require(seg_rel <= 5e-3, f"segments differ by {seg_rel}")
    return float(img_k.mean())


def frame_vs_golden_phase(rt, torch, nvidia_smi: str):
    from raytracinginoneweekend_tpu_torch import golden

    out = {}
    for name in golden.GOLDEN_NAMES:
        want, flags = golden.load_golden(name)
        got = golden.render_golden(flags, device=torch.device("cuda"))
        atol = 5e-4 if flags["scene"] == "huge" else 3e-5
        out[name] = dict(golden.compare_frames(got.cpu().numpy(), want,
                                               atol=atol), atol=atol)
    emit({"phase": "frame_vs_golden", "card": nvidia_smi, "frames": out})
    for name, cmp in out.items():
        require(cmp["ok"], f"{name}: the card's frame differs from the "
                f"JAX-made golden frame: {cmp}")


def main_path_phase(rt, torch, nvidia_smi: str, small_mean, arm_spp: int):
    from raytracinginoneweekend_tpu_torch import cli, kernels
    from raytracinginoneweekend_tpu_torch.golden import compare_frames
    from raytracinginoneweekend_tpu_torch.utils.timing import time_fn

    w, h, spp, depth = (MAIN[k] for k in ("width", "height", "spp", "depth"))
    out_png = os.path.join(kernels.BUILD_DIR, "chip_smoke_cover.png")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    if os.path.exists(out_png):
        os.remove(out_png)
    argv = ["render", "--scene", "huge", "--width", str(w), "--height",
            str(h), "--spp", str(spp), "--depth", str(depth), "--stats",
            "--out", out_png]
    err, said = io.StringIO(), io.StringIO()
    kernels.reset_launches()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(said):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    require(rc == 0, f"cli render returned {rc}")
    stats = json.loads(err.getvalue().strip().splitlines()[-1])
    require(os.path.getsize(out_png) > 10000, "the PNG was not written")
    for name in ("closest_hit", "shade_regen"):
        n = launches[name]
        require(n == stats["iters"] and n > 0,
                f"kernel {name} was launched {n} times on the main path; "
                f"the engine ran {stats['iters']} iterations")

    dev = torch.device("cuda")
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", w, h, dev)
    rays = w * h * spp

    def timed(options, pool, n_spp, iters):
        sec, img = time_fn(
            lambda: render(rt, torch, options, width=w, height=h, spp=n_spp,
                           depth=depth, pool_size=pool, scene=scene,
                           cam=cam),
            warmup=1, iters=iters, device=dev)
        return sec, img

    runs = {}
    images = {}
    for pool in (1 << 15, 1 << 20):
        sec, img = timed(rt.DEFAULT, pool, spp, 2)
        _, st = render(rt, torch, rt.DEFAULT, width=w, height=h, spp=spp,
                       depth=depth, pool_size=pool, scene=scene, cam=cam,
                       stats=True)
        images[pool] = img
        runs[f"pool_{pool}"] = {
            "seconds_per_frame": sec, "camera_rays_per_s": rays / sec,
            "segments_per_s": st["segments"] / sec, **st,
            "occupancy": st["segments"] / (st["iters"] * st["lanes"]),
            "mean": float(img.mean())}
    require(runs[f"pool_{1 << 15}"]["iters"] == stats["iters"],
            "the CLI's run and the timed run took different iterations")
    img = images[1 << 15]
    require(bool(torch.isfinite(img).all()), "non-finite pixels")
    require(tuple(img.shape) == (w * h, 3), f"image shape {img.shape}")
    cmp = compare_frames(images[1 << 20].cpu().numpy(), img.cpu().numpy())
    require(cmp["ok"], f"pool sizes disagree: {cmp}")
    mean_diff = abs(float(img.mean()) - small_mean) \
        if small_mean is not None else None

    arms = {}
    rr = dataclasses.replace(rt.DEFAULT, rr_terminate=True)
    strat_rr = dataclasses.replace(rr, sampling="stratified")
    for name, options in (("rr_terminate", rr),
                          ("stratified_rr", strat_rr)):
        sec, aimg = timed(options, 1 << 15, arm_spp, 1)
        require(bool(torch.isfinite(aimg).all()), f"{name}: non-finite")
        arms[name] = {"spp": arm_spp, "seconds_per_frame": sec,
                      "camera_rays_per_s": w * h * arm_spp / sec,
                      "mean": float(aimg.mean()),
                      "mean_diff_vs_default":
                          abs(float(aimg.mean()) - float(img.mean()))}
        # an unbiased estimator change: the image mean must not move
        require(arms[name]["mean_diff_vs_default"] < 2e-3,
                f"{name}: image mean moved by "
                f"{arms[name]['mean_diff_vs_default']}")
    emit({"phase": "main_path", "card": nvidia_smi, **MAIN,
          "cli_stats": stats, "cli_said": said.getvalue().strip(),
          "launches": launches, "png": out_png,
          "runs": runs, "pool_compare": cmp,
          "mean_diff_vs_small_frame": mean_diff, "arms": arms,
          "arm_spp_cut": arm_spp != spp})
    if mean_diff is not None:
        require(mean_diff < MEAN_TOL, f"image mean differs from the small "
                f"frame's by {mean_diff}")
    return launches


# --------------------------------------------------------------------- #
# train_path and cli_fit phases
# --------------------------------------------------------------------- #

def train_path_phase(rt, torch, nvidia_smi: str):
    import importlib
    import statistics

    from raytracinginoneweekend_tpu_torch import cli, kernels, optim
    from raytracinginoneweekend_tpu_torch.optim import inverse

    prender = importlib.import_module(
        "raytracinginoneweekend_tpu_torch.render")
    dev = torch.device("cuda")
    w, h, depth = TRAIN["width"], TRAIN["height"], TRAIN["depth"]
    options = dataclasses.replace(rt.DEFAULT, intersect="pallas")
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", w, h, dev)
    cfg = rt.RenderConfig(width=w, height=h, spp=TRAIN["target_spp"],
                          max_depth=depth, camera_mode="thinlens",
                          options=options)
    which = ("albedo", "centers")
    gen = torch.Generator(device="cpu").manual_seed(1)
    perturbed = scene
    for name in which:
        leaf = getattr(scene, name)
        noise = TRAIN["perturb"] * torch.randn(leaf.shape, generator=gen)
        perturbed = perturbed._replace(**{name: leaf + noise.to(dev)})
    n_steps = TRAIN["warmup_steps"] + TRAIN["timed_steps"]
    kw = dict(width=w, height=h, spp=TRAIN["spp"], max_depth=depth,
              camera_mode="thinlens", options=options)

    # The loss on a fixed batch, rendered with the TARGET's key and sample
    # ids: at the true parameters it is exactly 0 (the same paths), so it
    # reads the parameters' error without the Monte-Carlo floor that the
    # steps' own losses (fresh keys, fresh batches) sit on.
    require(TRAIN["spp"] == TRAIN["target_spp"],
            "the probe loss needs the target's sample ids")
    probe_ids = inverse.draw_pixel_batch((9, 9), w * h,
                                         TRAIN["batch_pixels"], dev)

    def probe_loss(params, target):
        with torch.no_grad():
            return float(optim.render_loss(
                params, scene, cam,
                target.reshape(-1, 3)[probe_ids.to(torch.int64)],
                probe_ids, rt.key_words(0), engine="tiled", **kw))

    stamps = []

    def callback(i, params, optimizer, loss):
        stamps.append(time.perf_counter())  # fit has just read the loss

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    target = prender.render(scene, cam, cfg, rt.key_words(0), device=dev)
    torch.cuda.synchronize()
    target_seconds = time.perf_counter() - t0
    after_target = dict(kernels.LAUNCHES)
    peak_target = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stamps.append(time.perf_counter())
    _, params, opt, losses = optim.fit(
        perturbed, cam, target, cfg, which=which, steps=n_steps,
        learning_rate=TRAIN["lr"], batch_pixels=TRAIN["batch_pixels"],
        spp=TRAIN["spp"], engine="auto", callback=callback, device=dev)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak_fit = torch.cuda.max_memory_allocated()

    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    timed = step_s[TRAIN["warmup_steps"]:]
    rays_per_step = TRAIN["batch_pixels"] * TRAIN["spp"]
    require(bool(torch.isfinite(target).all())
            and tuple(target.shape) == (h, w, 3), "the target frame")
    require(all(x == x and abs(x) != float("inf") for x in losses),
            f"non-finite loss: {losses}")
    require(all(bool(torch.isfinite(p).all()) for p in params.values()),
            "non-finite parameters after fit")
    require(after_target["intersect"] > 0
            and after_target["closest_hit"] == 0,
            f"the target render's launches: {after_target}")
    require(launches["intersect"] == after_target["intersect"],
            "the AD trace launched the intersect kernel")
    require(launches["closest_hit"] == depth * n_steps,
            f"closest_hit was launched {launches['closest_hit']} times in "
            f"{n_steps} steps of depth {depth}: backward must not launch it "
            f"again")

    start = optim.params_from_scene(perturbed, which)
    loss_before = probe_loss(start, target)
    loss_after = probe_loss(params, target)
    # (checked after the record is printed, so a failure shows its numbers)
    pending = [(loss_after <= loss_before,
                f"the probe loss rose: {loss_before} -> {loss_after}")]

    # one step taken apart, and the two engines on one batch
    batch_key, render_key = inverse.step_keys(rt.key_words(7), n_steps)
    ids = inverse.draw_pixel_batch(batch_key, w * h, TRAIN["batch_pixels"],
                                   dev)
    tb = target.reshape(-1, 3)[ids.to(torch.int64)]
    parts = {}
    for engine in ("planar", "tiled"):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        adam = inverse.make_adam(p, TRAIN["lr"])
        for rep in range(2):  # the second pass is the timed one
            adam.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = optim.render_loss(p, perturbed, cam, tb, ids, render_key,
                                     engine=engine, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss.backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            adam.step()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
        parts[engine] = {"forward_s": t1 - t0, "backward_s": t2 - t1,
                         "adam_s": t3 - t2, "loss": float(loss.detach())}
    diff, px = engine_gradients(
        torch, rt, params, perturbed, cam, tb, ids, render_key, **kw)
    pending.extend(engine_pixels_agree(px))
    for k in which:
        pending.append((engine_gradients_agree(k, diff[k]),
                        f"gradient of {k}, planar vs tiled: {diff[k]}"))
    # a whole step of the tiled engine through make_train_step
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    tiled_step = optim.make_train_step(inverse.make_adam(p, TRAIN["lr"]),
                                       engine="tiled", **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tiled_loss = float(tiled_step(p, perturbed, cam, tb, ids, render_key))
    torch.cuda.synchronize()
    tiled_step_s = time.perf_counter() - t0

    emit({"phase": "train_path", "card": nvidia_smi, **TRAIN,
          "which": which, "engine": "auto -> " + inverse.resolve_ad_engine(
              depth, options.rr_terminate),
          "target_seconds": target_seconds,
          "target_camera_rays": w * h * TRAIN["target_spp"],
          "launches_target": after_target, "launches": launches,
          "rays_per_step": rays_per_step,
          "step_seconds": step_s,
          "step_seconds_median": statistics.median(timed),
          "step_seconds_min": min(timed), "step_seconds_max": max(timed),
          "rays_per_second": rays_per_step / statistics.median(timed),
          "losses": losses, "probe_loss_before": loss_before,
          "probe_loss_after": loss_after,
          "peak_bytes_target": peak_target, "peak_bytes_fit": peak_fit,
          "one_step_parts": parts, "tiled_step_seconds": tiled_step_s,
          "tiled_step_loss": tiled_loss,
          "grad_planar_vs_tiled": diff, "grad_pixels": px})
    for cond, what in pending:
        require(cond, what)
    return launches


def cli_fit_phase(rt, torch, nvidia_smi: str):
    from raytracinginoneweekend_tpu_torch import cli, kernels, optim

    ckpt = os.path.join(kernels.BUILD_DIR, "chip_smoke_fit.npz")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    if os.path.exists(ckpt):
        os.remove(ckpt)
    argv = ["fit", "--scene", "simple-cuda", "--width",
            str(CLI_FIT["width"]), "--height", str(CLI_FIT["height"]),
            "--params", "albedo,centers", "--steps", str(CLI_FIT["steps"]),
            "--ad-engine", "auto", "--checkpoint", ckpt]
    said = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(said):
        rc = cli.main(argv)
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    require(rc == 0, f"cli fit returned {rc}")
    require(os.path.exists(ckpt), "the checkpoint was not written")
    dev = torch.device("cuda")
    scene = cli._build_scene("simple-cuda", 0, dev)
    tmpl = optim.params_from_scene(scene, ("albedo", "centers"))
    params, opt_state, step = optim.load_checkpoint(ckpt, tmpl)
    require(step == CLI_FIT["steps"]
            and int(opt_state["count"]) == CLI_FIT["steps"],
            f"checkpoint at step {step}, Adam count {opt_state['count']}")
    require(all(bool(torch.isfinite(p).all()) for p in params.values()),
            "non-finite parameters in the checkpoint")
    resumed = io.StringIO()
    with contextlib.redirect_stdout(resumed):
        rc = cli.main([*argv[:argv.index("--steps")], "--steps", "2",
                       *argv[argv.index("--steps") + 2:], "--resume", ckpt])
    require(rc == 0 and f"at step {CLI_FIT['steps']}" in resumed.getvalue(),
            "the resumed run")
    _p, _o, step2 = optim.load_checkpoint(ckpt, tmpl)
    require(step2 == CLI_FIT["steps"] + 2, f"resumed to step {step2}")
    lines = said.getvalue().strip().splitlines()
    emit({"phase": "cli_fit", "card": nvidia_smi, "argv": argv,
          "seconds": seconds, "launches": launches,
          "said": lines[-3:], "checkpoint_step": step,
          "resumed_to_step": step2})
    require(launches["intersect"] > 0 and launches["closest_hit"] > 0,
            f"the CLI's fit did not go through the kernels: {launches}")


# The full frame's mean against the 240x160 @ 8 spp frame's: two Monte-Carlo
# estimates of nearly the same integral (the small one stops at depth 12).
MEAN_TOL = 1e-3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of " + ", ".join(PHASES))
    ap.add_argument("--arm-spp", type=int, default=MAIN["spp"],
                    help="samples per pixel of the two estimator arms "
                         "(cut this first if the run nears its time limit)")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in PHASES:
            ap.error(f"unknown phase {p!r}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script checks the port on the card and does "
              "not fall back to the CPU", file=sys.stderr)
        return 1

    import raytracinginoneweekend_tpu_torch as rt
    from raytracinginoneweekend_tpu_torch import kernels

    t_start = time.perf_counter()
    nvidia_smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kernels.build(verbose=True)
    for name in kernels.ENTRIES:
        kernels.entry(name)
    emit({"phase": "device", "card": nvidia_smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "nvcc_flags": list(kernels.NVCC_FLAGS),
          "kernel_build_seconds": kernels.build_seconds})

    line, launches, train_launches, small_mean = None, None, None, None
    try:
        if "kernels" in phases:
            line = kernels_phase(rt, torch, nvidia_smi)
        if "grad_vs_plain" in phases:
            grad_vs_plain_phase(rt, torch, nvidia_smi)
        if "frame_vs_plain" in phases:
            small_mean = frame_vs_plain_phase(rt, torch, nvidia_smi)
        if "frame_vs_golden" in phases:
            frame_vs_golden_phase(rt, torch, nvidia_smi)
        if "main_path" in phases:
            launches = main_path_phase(rt, torch, nvidia_smi, small_mean,
                                       args.arm_spp)
        if "train_path" in phases:
            train_launches = train_path_phase(rt, torch, nvidia_smi)
        if "cli_fit" in phases:
            cli_fit_phase(rt, torch, nvidia_smi)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    if phases != list(PHASES):
        print(f"chip_smoke: ran only {phases}; no verdict", file=sys.stderr)
        return 5
    for k in line:
        # each kernel's count on the path that runs it: the forward render
        # for closest_hit and shade_regen, the training path for intersect
        # (and closest_hit again, under autograd)
        name = k["name"]
        k["launches"] = (train_launches if name == "intersect"
                         else launches)[name]
        k["launches_train_path"] = train_launches[name]
        if k["launches"] <= 0:
            print(f"chip_smoke: FAILED: kernel {name} was launched on no "
                  "path", file=sys.stderr)
            return 1
    emit({"kernels": line})
    print(nvidia_smi, flush=True)
    emit({"seconds": time.perf_counter() - t_start})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
