#!/usr/bin/env python3
"""Time the regrouped-products closest hit (kernel 7), the cull-list closest
hit (kernel 4) and the frames that launch them, for an A/B of two commits
on one card.

On the serving frame of the PyTorch/CUDA port (huge scene, 1200x800
reference CPU camera, thin lens, 100 spp, depth 50, key 0):
  * ``kernel`` lines: kernel 7's device time (the wrapper's own launch
    shape) on the single pool's mid-frame lane state at 32768 and 2^20
    lanes, and kernel 1's on the same rays; kernel 4's on the dual
    engine's primary pool in mid-frame with its real cull lists, at the
    pools of 3 * 2^20 lanes (2^20 primary) and 2^16 (16384 primary), with
    the mean list length and kernel 1's time on the same rays (CUDA events
    around 20 launches queued behind a long matrix product);
  * ``frame`` lines: seconds per frame (host clock around work that ends
    in a synchronise; two runs after a small warm-up frame) of the default
    step and of ``--hit-kernel mxu`` at pools of 2^15 and 2^20 lanes, each
    epoch replayed as a CUDA graph where the package does so, with a hash
    of the frame's bytes (two commits whose kernels are bit-equal with the
    same plain versions give the same hash); beside each mxu frame the
    share of pixels the JAX package's mxu rule counts against the default
    frame of its pool, and the pixels that differ at all; with ``--dual``
    also the dual-pool engine's frame at 3 * 2^20 lanes (one run, about
    half a minute);
  * a ``frame_vs_plain`` line: the default frame at 240x160, 8 spp, depth
    12 through the kernels against its plain PyTorch frame, counted by the
    frame rule (``golden.compare_frames``);
  * with ``--block-ab``: kernel 4 built again from the checkout's source
    with the other of 128- and 256-thread blocks (``CL_THREADS``), both
    forms held bit-equal with the plain version and timed in turns at both
    dual pools;
then the card's name and power limit.

``--repo`` names the checkout whose package is imported, so that one call
on the card can measure two commits in turns (parent, change, change,
parent).

Run on a machine with a CUDA card and nvcc:
    python3 scripts/torch_mxu_list_ab.py [--repo PATH] [--label TAG]
        [--dual] [--block-ab]
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

W, H, SPP, DEPTH = 1200, 800, 100, 50
SMALL = dict(width=240, height=160, spp=8, depth=12)
DUAL_POOLS = (3 << 20, 1 << 16)
BLOCK_SIZES = ("128", "256")  # csrc/closest_hit_list.cu CL_THREADS


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout to import the port from")
    ap.add_argument("--label", default="", help="tag of every line")
    ap.add_argument("--dual", action="store_true",
                    help="also time the dual-pool frame at 3 * 2^20 lanes")
    ap.add_argument("--block-ab", action="store_true",
                    help="also time kernel 4 at the other of 128 and 256 "
                         "threads a block")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))

    import torch

    if not torch.cuda.is_available():
        print("torch_mxu_list_ab: no CUDA device", file=sys.stderr)
        return 1
    import raytracinginoneweekend_tpu_torch as rt
    from raytracinginoneweekend_tpu_torch import cli, golden, kernels
    from raytracinginoneweekend_tpu_torch.ops import (cuda_fused,
                                                      cuda_segment as seg,
                                                      wavefront,
                                                      wavefront_dual as dual)
    from raytracinginoneweekend_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")
    scene = cli._build_scene("huge", 0, dev)
    rep = dataclasses.replace

    def emit(obj):
        print(json.dumps({"label": args.label, **obj}), flush=True)

    def device_ms(fn):
        return cuda_time_ms(fn, iters=20, queue_behind=True)

    def bits_equal(a, b):
        return all(bool(torch.equal(x, y)) for x, y in zip(a, b))

    for pool in (1 << 15, 1 << 20):
        cam = cli._build_camera("cpu", W, H, dev)
        eng = wavefront.build_engine(
            scene, cam, rt.key_words(0), width=W, height=H, spp=SPP,
            max_depth=DEPTH, camera_mode="thinlens", options=rt.DEFAULT,
            pool_size=pool, device=dev)
        # mid-frame: every lane's task queue advanced to the middle of its
        # sequence, then 40 iterations (chip_smoke.mid_frame_state)
        state = list(wavefront.engine_initial_state(eng))
        state[0] += (eng.n_k // 2) * eng.stride
        state = cuda_fused.regen(tuple(state), eng.camvec, eng.base_words,
                                 **eng.regen_kw)
        for _ in range(40):
            state = wavefront.engine_step(eng, state)
        rays, act = tuple(state[4:10]), state[3]
        geom = eng.sphere_params[:4]
        table = seg.mxu_table(*geom)

        def k7():
            return seg.segment_closest_hit_mxu(rays, *geom, eng.t_min,
                                               active=act, table=table)

        emit({"kernel": "closest_hit_mxu", "lanes": eng.lanes,
              "ms": device_ms(k7),
              "bit_equal_with_plain": bits_equal(
                  k7(), seg.segment_closest_hit_mxu_reference(
                      rays, *geom, eng.t_min, act)),
              "closest_hit_ms_same_rays": device_ms(
                  lambda: seg.segment_closest_hit(rays, *geom, eng.t_min,
                                                  active=act,
                                                  table=eng.htable))})

    cam = cli._build_camera("cpu", W, H, dev)
    list_inputs = {}
    for pool in DUAL_POOLS:
        eng = dual.build_dual_engine(
            scene, cam, rt.key_words(0), width=W, height=H, spp=SPP,
            max_depth=DEPTH, camera_mode="thinlens", options=rt.DEFAULT,
            pool_size=pool, device=dev)
        state = dual.initial_dual_state(eng)
        for _ in range(24):
            state = dual.dual_step(eng, state)
        calls = []
        fn = seg.segment_closest_hit_list
        seg.segment_closest_hit_list = (
            lambda *a, **kw: calls.append((a, kw)) or fn(*a, **kw))
        try:
            dual.dual_step(eng, state)
        finally:
            seg.segment_closest_hit_list = fn
        (rays, cx, cy, cz, r, counts, lists, t_min), kw = calls[0]
        geom = (cx, cy, cz, r)
        issue = kw["active"].to(torch.int32)
        rows, table = kw["rows"], kw["table"]

        def k4(rays=rays, geom=geom, counts=counts, lists=lists, t_min=t_min,
               rows=rows, issue=issue, table=table):
            return seg.segment_closest_hit_list(
                rays, *geom, counts, lists, t_min, rows=rows, active=issue,
                table=table)

        want = seg.segment_closest_hit_list_reference(
            rays, *geom, counts, lists, t_min, rows, issue)
        per_block = issue.reshape(-1, rows * 128).sum(dim=1)
        list_inputs[pool] = (k4, want)
        emit({"kernel": "closest_hit_list", "pool": pool,
              "lanes": rays[0].numel(), "ms": device_ms(k4),
              "bit_equal_with_plain": bits_equal(k4(), want),
              "mean_list": float(counts[per_block > 0].float().mean()),
              "closest_hit_ms_same_rays": device_ms(
                  lambda: seg.segment_closest_hit(
                      rays, *geom, t_min, active=issue, table=eng.htable))})

    if args.block_ab:
        name = "rtw_closest_hit_list"
        kernels.entry(name)
        built = kernels._fns[name]
        src = open(os.path.join(kernels.CSRC_DIR,
                                "closest_hit_list.cu")).read()
        line = {b: f"#define CL_THREADS {b}\n" for b in BLOCK_SIZES}
        have = [b for b in BLOCK_SIZES if src.count(line[b]) == 1]
        if len(have) != 1:
            print("torch_mxu_list_ab: the block size line moved",
                  file=sys.stderr)
            return 1
        other = next(b for b in BLOCK_SIZES if b != have[0])
        os.makedirs(kernels.BUILD_DIR, exist_ok=True)
        alt = os.path.join(kernels.BUILD_DIR, f"closest_hit_list_t{other}.cu")
        with open(alt, "w") as f:
            f.write(src.replace(line[have[0]], line[other]))
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                        kernels.CSRC_DIR, "-o", alt[:-3] + ".so", alt],
                       check=True)
        alt_fn = getattr(ctypes.CDLL(alt[:-3] + ".so"), name)
        alt_fn.argtypes = kernels.ENTRIES[name][1]
        alt_fn.restype = ctypes.c_int
        for pool, (k4, want) in list_inputs.items():
            out = {"block_ab": "closest_hit_list", "pool": pool,
                   "built": f"threads_{have[0]}"}
            for _ in range(2):
                for form, fn in ((f"threads_{have[0]}", built),
                                 (f"threads_{other}", alt_fn)):
                    kernels._fns[name] = fn
                    try:
                        if not bits_equal(k4(), want):
                            print(f"torch_mxu_list_ab: {form} is not "
                                  "bit-equal", file=sys.stderr)
                            return 1
                        out.setdefault(form, []).append(device_ms(k4))
                    finally:
                        kernels._fns[name] = built
            emit(out)

    def render(options, pool, w=W, h=H, spp=SPP, depth=DEPTH, plain=False):
        cam = cli._build_camera("cpu", w, h, dev)
        return rt.render_wavefront(
            scene, cam, rt.key_words(0), width=w, height=h, spp=spp,
            max_depth=depth, camera_mode="thinlens", options=options,
            pool_size=pool, plain=plain, device=dev)

    def timed(fn, runs):
        fn(64, 48, 1)  # warm-up
        secs, img = [], None
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = fn(W, H, SPP)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        if not (bool(torch.isfinite(img).all())
                and tuple(img.shape) == (W * H, 3)):
            raise RuntimeError("bad frame")
        return secs, img

    default_img = {}
    for name, options, pool in (
            ("default", rt.DEFAULT, 1 << 15),
            ("default", rt.DEFAULT, 1 << 20),
            ("mxu", rep(rt.DEFAULT, hit_kernel="mxu"), 1 << 15),
            ("mxu", rep(rt.DEFAULT, hit_kernel="mxu"), 1 << 20)):
        secs, img = timed(lambda w, h, spp: render(options, pool, w, h,
                                                   spp), 2)
        ref = default_img.setdefault(pool, img)
        line = {"frame": name, "pool": pool, "seconds": secs,
                "sha256": hashlib.sha256(img.cpu().numpy().tobytes())
                .hexdigest()}
        if name == "mxu":
            err = (img - ref).abs() / (ref.abs() + 1e-3)
            line.update(
                share_beyond_1e_3_of_default=float(
                    (err.amax(dim=-1) > 1e-3).float().mean()),
                pixels_differing_from_default=int(
                    (img != ref).any(dim=1).sum()))
        emit(line)
    if args.dual:
        def dual_frame(w, h, spp):
            cam = cli._build_camera("cpu", w, h, dev)
            return dual.render_wavefront_dual(
                scene, cam, rt.key_words(0), width=w, height=h, spp=spp,
                max_depth=DEPTH, camera_mode="thinlens", options=rt.DEFAULT,
                pool_size=DUAL_POOLS[0], device=dev)

        secs, _ = timed(dual_frame, 1)
        emit({"frame": "dual", "pool": DUAL_POOLS[0], "seconds": secs})

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
