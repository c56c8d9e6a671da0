#!/usr/bin/env python3
"""Time the sorted closest hit (kernel 5), the whole-bounce kernel (kernel
8) and the frames that launch them, for an A/B of two commits on one card.

On the serving frame of the PyTorch/CUDA port (huge scene, 1200x800
reference CPU camera, thin lens, 100 spp, depth 50, key 0):
  * ``kernel`` lines: kernel 5's device time (the wrapper's own launch
    shape, ladder (4,)) on the single pool's mid-frame lane state with a
    sort state half an epoch old, under strided and tile ownership, and
    its share of chunk-stages skipped; kernel 8's device time on the
    default step's mid-frame lane state; kernel 1's on the same rays --
    each at 32768 and 2^20 lanes (CUDA events around 20 launches queued
    behind a long matrix product);
  * ``frame`` lines: seconds per frame (host clock around work that ends
    in a synchronise; two runs after a small warm-up frame) of the default
    step at pools of 2^15 and 2^20 lanes, the sorted kernel under strided
    and under tile ownership at 2^15 (as the package runs them: eagerly
    before its sorted epochs were graphed, replayed after), and the
    whole-bounce step (``--fusion bounce``) at both pools; beside each,
    the pixels that differ at all from the default frame of its pool;
  * a ``frame_vs_plain`` line: the default frame at 240x160, 8 spp, depth
    12 through the kernels against its plain PyTorch frame, counted by the
    frame rule (``golden.compare_frames``);
then the card's name and power limit.

``--repo`` names the checkout whose package is imported, so that one call
on the card can measure two commits in turns (parent, change, change,
parent).

Run on a machine with a CUDA card and nvcc:
    python3 scripts/torch_sorted_bounce_ab.py [--repo PATH] [--label TAG]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

W, H, SPP, DEPTH = 1200, 800, 100, 50
SMALL = dict(width=240, height=160, spp=8, depth=12)
LADDER = (4,)  # TraceOptions.sorted_ladder's default


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout to import the port from")
    ap.add_argument("--label", default="", help="tag of every line")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))

    import torch

    if not torch.cuda.is_available():
        print("torch_sorted_bounce_ab: no CUDA device", file=sys.stderr)
        return 1
    import raytracinginoneweekend_tpu_torch as rt
    from raytracinginoneweekend_tpu_torch import cli, golden
    from raytracinginoneweekend_tpu_torch.ops import (cuda_fused, cuda_mega,
                                                      cuda_segment, wavefront)
    from raytracinginoneweekend_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")
    scene = cli._build_scene("huge", 0, dev)
    rep = dataclasses.replace

    def emit(obj):
        print(json.dumps({"label": args.label, **obj}), flush=True)

    def engine(options, pool):
        cam = cli._build_camera("cpu", W, H, dev)
        return wavefront.build_engine(
            scene, cam, rt.key_words(0), width=W, height=H, spp=SPP,
            max_depth=DEPTH, camera_mode="thinlens", options=options,
            pool_size=pool, device=dev)

    def mid_frame(eng, n_steps):
        """Every lane's task queue advanced to the middle of its sequence,
        then n_steps iterations (chip_smoke.mid_frame_state)."""
        state = list(wavefront.engine_initial_state(eng))
        state[0] += (eng.n_k // 2) * eng.stride
        state = cuda_fused.regen(tuple(state), eng.camvec, eng.base_words,
                                 **eng.regen_kw)
        for _ in range(n_steps):
            state = wavefront.engine_step(eng, state)
        return tuple(p.clone() for p in state)

    def device_ms(fn):
        return cuda_time_ms(fn, iters=20, queue_behind=True)

    rows = wavefront.ROWS_DEFAULT
    for pool in (1 << 15, 1 << 20):
        for own in ("strided", "tile"):
            eng = engine(rep(rt.DEFAULT, ownership=own), pool)
            state = mid_frame(eng, 24)
            geom = eng.sphere_params[:4]
            ss = cuda_segment.sorted_cull_state(state[3], state[4:7], *geom,
                                                rows=rows)
            for _ in range(16):  # the engine sorts once per 32 iterations
                state = wavefront.engine_step(eng, state)
            rays, act = tuple(state[4:10]), state[3]
            table = cuda_segment.hit_table_padded(*geom)

            def k5(stats=None):
                return cuda_segment.segment_closest_hit_sorted(
                    rays, *geom, ss, eng.t_min, rows=rows, active=act,
                    ladder=LADDER, table=table, stats=stats)

            stats = torch.zeros(2, dtype=torch.int64, device=dev)
            k5(stats)
            skipped, total = (int(v) for v in stats.tolist())
            emit({"kernel": "closest_hit_sorted", "lanes": eng.lanes,
                  "ownership": own, "ms": device_ms(k5),
                  "share_skipped": skipped / max(total, 1),
                  "closest_hit_ms_same_rays": device_ms(
                      lambda: cuda_segment.segment_closest_hit(
                          rays, *geom, eng.t_min, active=act))})
        eng = engine(rt.DEFAULT, pool)
        state = mid_frame(eng, 40)
        planes, kw = wavefront.mega_planes(state), wavefront.mega_kw(eng)
        tables = cuda_mega.mega_tables(eng.sphere_params)
        emit({"kernel": "mega_bounce", "lanes": eng.lanes,
              "ms": device_ms(lambda: cuda_mega.mega_bounce(
                  planes, eng.sphere_params, tables=tables, **kw)),
              "closest_hit_ms_same_rays": device_ms(
                  lambda: wavefront.engine_closest_hit(eng, state))})

    def render(options, pool, w=W, h=H, spp=SPP, depth=DEPTH, plain=False):
        cam = cli._build_camera("cpu", w, h, dev)
        return rt.render_wavefront(
            scene, cam, rt.key_words(0), width=w, height=h, spp=spp,
            max_depth=depth, camera_mode="thinlens", options=options,
            pool_size=pool, plain=plain, device=dev)

    frames = [
        ("default", rt.DEFAULT, 1 << 15), ("default", rt.DEFAULT, 1 << 20),
        ("sorted", rep(rt.DEFAULT, hit_kernel="sorted"), 1 << 15),
        ("sorted_tile", rep(rt.DEFAULT, hit_kernel="sorted",
                            ownership="tile"), 1 << 15),
        ("bounce", rep(rt.DEFAULT, mega="bounce"), 1 << 15),
        ("bounce", rep(rt.DEFAULT, mega="bounce"), 1 << 20)]
    default_img = {}
    for name, options, pool in frames:
        render(options, pool, 64, 48, 1)
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = render(options, pool)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        if not (bool(torch.isfinite(img).all())
                and tuple(img.shape) == (W * H, 3)):
            print(f"torch_sorted_bounce_ab: {name}: bad frame",
                  file=sys.stderr)
            return 1
        ref = default_img.setdefault(pool, img)
        emit({"frame": name, "pool": pool, "seconds": runs,
              "pixels_differing_from_default": int(
                  (img != ref).any(dim=1).sum())})

    sw, sh, sspp, sdepth = (SMALL[k] for k in ("width", "height", "spp",
                                               "depth"))
    img_k = render(rt.DEFAULT, 1 << 15, sw, sh, sspp, sdepth)
    img_p = render(rt.DEFAULT, 1 << 15, sw, sh, sspp, sdepth, plain=True)
    emit({"frame_vs_plain": golden.compare_frames(img_k.cpu().numpy(),
                                                  img_p.cpu().numpy())})
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
