#!/usr/bin/env python3
"""How long do the wavefront engine's eagerly launched frames take?

Renders the serving frame of the PyTorch/CUDA port (huge scene, 1200x800
reference CPU camera, thin lens, 100 spp, depth 50, key 0) at a pool of
2^15 lanes through the frames that launch every iteration's kernels from
Python: the default step with the epoch NOT replayed as a CUDA graph, and
the sorted closest-hit kernel under strided and tile ownership, also not
replayed (a package from before the sorted epochs were graphed runs them
eagerly whatever it is asked). Each
frame is rendered twice after a small warm-up frame of its own options.
Prints one JSON object per frame (seconds of each run by the host's clock
around work that ends in a synchronise, the process's CPU seconds over the
same span -- steadier than the wall clock on a shared host while the frame
is host-bound --, iterations, host microseconds an iteration), then one
for the host time of a single call of the fused shade_regen wrapper (mean
of 2000 calls on the prologue's lane state, updated in place), one for the
host time of an iteration's pair of launches, closest hit (kernel 1, or
the sorted kernel under either ownership) then shade_regen, where the
wrappers take ``pdl=`` with and without programmatic dependent launch
(blocks of 500 pairs in turns, on a lane state that advances as in a
frame); then the card's name and power limit. ``--profile`` also writes
the host profile of one sorted tile-ownership frame (cProfile, the
functions that take the most time of their own) to standard error.

``--repo`` names the checkout whose package is imported, so that one call
on the card can measure two commits in turns (parent, change, change,
parent). A package without ``render_wavefront(graph=...)`` runs every
frame eagerly and is called without it.

Run on a machine with a CUDA card and nvcc:
    python3 scripts/torch_eager_frames.py [--repo PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import os
import subprocess
import sys
import time

W, H, SPP, DEPTH, POOL = 1200, 800, 100, 50, 1 << 15
CALLS = 2000


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout to import the port from")
    ap.add_argument("--label", default="", help="tag of every line")
    ap.add_argument("--profile", action="store_true",
                    help="profile one sorted tile-ownership frame's host "
                         "code")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))

    import torch

    if not torch.cuda.is_available():
        print("torch_eager_frames: no CUDA device", file=sys.stderr)
        return 1
    import raytracinginoneweekend_tpu_torch as rt
    from raytracinginoneweekend_tpu_torch import cli
    from raytracinginoneweekend_tpu_torch.ops import cuda_fused, wavefront

    dev = torch.device("cuda")
    scene = cli._build_scene("huge", 0, dev)
    has_graph = "graph" in inspect.signature(wavefront.build_engine).parameters
    rep = dataclasses.replace
    eager = {"graph": False} if has_graph else {}
    frames = {
        "default_eager": (rt.DEFAULT, eager),
        "sorted": (rep(rt.DEFAULT, hit_kernel="sorted"), eager),
        "sorted_tile": (rep(rt.DEFAULT, hit_kernel="sorted",
                            ownership="tile"), eager),
    }

    def render(options, kw, w, h, spp):
        cam = cli._build_camera("cpu", w, h, dev)
        return rt.render_wavefront(
            scene, cam, rt.key_words(0), width=w, height=h, spp=spp,
            max_depth=DEPTH, camera_mode="thinlens", options=options,
            pool_size=POOL, return_stats=True, device=dev, **kw)

    for name, (options, kw) in frames.items():
        render(options, kw, 64, 48, 1)
        runs, cpu, stats = [], [], None
        for _ in range(2):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.process_time()
            img, stats = render(options, kw, W, H, SPP)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
            cpu.append(time.process_time() - c0)
        if not (bool(torch.isfinite(img).all())
                and tuple(img.shape) == (W * H, 3)):
            print(f"torch_eager_frames: {name}: bad frame", file=sys.stderr)
            return 1
        print(json.dumps({"label": args.label, "frame": name,
                          "seconds": runs, "cpu_seconds": cpu,
                          "iters": stats["iters"],
                          "host_us_per_iter": [s / stats["iters"] * 1e6
                                               for s in runs]}), flush=True)

    cam = cli._build_camera("cpu", W, H, dev)
    eng = wavefront.build_engine(scene, cam, rt.key_words(0), width=W,
                                 height=H, spp=SPP, max_depth=DEPTH,
                                 camera_mode="thinlens", options=rt.DEFAULT,
                                 pool_size=POOL, device=dev)
    state = wavefront.engine_prologue(eng)
    seg = wavefront.engine_closest_hit(eng, state, None)

    def call():
        cuda_fused.shade_regen(state, seg, eng.table, eng.camvec,
                               eng.base_words, out=state, **eng.step_kw)

    for _ in range(50):
        call()
    torch.cuda.synchronize()
    t0, c0 = time.perf_counter(), time.process_time()
    for _ in range(CALLS):
        call()
    host, host_cpu = time.perf_counter() - t0, time.process_time() - c0
    torch.cuda.synchronize()
    print(json.dumps({"label": args.label, "shade_regen_call_host_us":
                      host / CALLS * 1e6,
                      "shade_regen_call_cpu_us": host_cpu / CALLS * 1e6,
                      "calls": CALLS}), flush=True)
    print(json.dumps({"label": args.label, "pair_host_us": {
        name: pair_host_us(torch, scene, cam, rt, wavefront, cuda_fused,
                           options)
        for name, options in (("closest_hit", rt.DEFAULT),
                              ("sorted", frames["sorted"][0]),
                              ("sorted_tile", frames["sorted_tile"][0]))}}),
          flush=True)
    if args.profile:
        import cProfile
        import pstats

        prof = cProfile.Profile()
        prof.enable()
        render(*frames["sorted_tile"], W, H, SPP)
        torch.cuda.synchronize()
        prof.disable()
        pstats.Stats(prof, stream=sys.stderr).sort_stats(
            "tottime").print_stats(30)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


def pair_host_us(torch, scene, cam, rt, wavefront, cuda_fused, options,
                 block: int = 500, turns: int = 4) -> dict:
    """Host wall and CPU microseconds of one (closest hit, shade_regen)
    pair of launches, with and without PDL where the wrapper takes it."""
    eng = wavefront.build_engine(scene, cam, rt.key_words(0), width=W,
                                 height=H, spp=SPP, max_depth=DEPTH,
                                 camera_mode="thinlens", options=options,
                                 pool_size=POOL, device=torch.device("cuda"))
    state = wavefront.engine_prologue(eng)
    sortstate = wavefront.engine_sortstate(eng, state)

    has_pdl = "pdl" in inspect.signature(cuda_fused.shade_regen).parameters
    modes = (True, False) if has_pdl else (False,)

    def pairs(pdl, n):
        kw = {"pdl": pdl} if has_pdl else {}
        for _ in range(n):
            seg = wavefront.engine_closest_hit(eng, state, sortstate)
            cuda_fused.shade_regen(state, seg, eng.table, eng.camvec,
                                   eng.base_words, out=state, **kw,
                                   **eng.step_kw)

    for pdl in modes:
        pairs(pdl, 50)
    sums = {pdl: [0.0, 0.0] for pdl in modes}
    for _ in range(turns):
        for pdl in modes:
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.process_time()
            pairs(pdl, block)
            torch.cuda.synchronize()
            sums[pdl][0] += time.perf_counter() - t0
            sums[pdl][1] += time.process_time() - c0
    n = block * turns
    return {f"pdl_{'on' if pdl else 'off'}": {
        "wall_us": w / n * 1e6, "cpu_us": c / n * 1e6}
        for pdl, (w, c) in sums.items()}


if __name__ == "__main__":
    sys.exit(main())
