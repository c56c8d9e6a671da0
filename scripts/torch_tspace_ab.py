#!/usr/bin/env python3
"""Time the two t-space closest hits -- the (N, 3) intersect kernel (kernel
3) and the sphere-group closest hit (kernel 6) -- and the paths around
them, for an A/B of two commits on one card.

On the huge scene (1200x800 reference CPU camera, thin lens, key 0):
  * ``kernel`` lines: kernel 3's device time (the wrapper's own launch
    shape) on the tiled engine's rays after three bounces at the training
    path's two shapes, every pixel once (960,000 rays) and 16384 pixels x 8
    spp (131,072); kernel 6's on the camera rays of the full frame's first
    pool (2^20 lanes, tile ownership), on a mid-frame state of that frame
    and on the camera rays of the default pool (32768 lanes), each with
    kernel 1's time on the same rays and the share of group tests kernel 6
    skipped (CUDA events around 20 launches queued behind a long matrix
    product); each kernel held bit-equal with its plain version;
  * a ``target`` line: seconds of the training path's target render (tiled
    engine, intersect="pallas", 8 spp, depth 16; host clock around work
    that ends in a synchronise; ``--target-runs`` runs, two by default,
    after a small warm-up) and, in
    each run, kernel 3's device time summed over its launches (CUDA events
    around each launch);
  * ``frame`` lines: seconds per frame of the default serving frame (100
    spp, depth 50) at pools of 2^15 and 2^20 lanes, each epoch replayed as
    a CUDA graph, two runs after a small warm-up, with a hash of the
    frame's bytes;
  * a ``frame_vs_plain`` line: the default frame at 240x160, 8 spp, depth
    12 through the kernels against its plain PyTorch frame, counted by the
    frame rule (``golden.compare_frames``);
  * with ``--block-ab``: kernel 3 built again from the checkout's source
    with the other of 128- and 256-thread blocks (``IX_THREADS``), both
    forms held bit-equal with the plain version and timed in turns at both
    shapes;
then the card's name and power limit.

``--repo`` names the checkout whose package is imported, so that one call
on the card can measure two commits in turns (parent, change, change,
parent).

Run on a machine with a CUDA card and nvcc:
    python3 scripts/torch_tspace_ab.py [--repo PATH] [--label TAG]
        [--target-runs N] [--block-ab]
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import hashlib
import importlib
import json
import os
import subprocess
import sys
import time

W, H, SPP, DEPTH = 1200, 800, 100, 50
TARGET = dict(spp=8, depth=16, batch_pixels=16384)
SMALL = dict(width=240, height=160, spp=8, depth=12)
BLOCK_SIZES = ("128", "256")  # csrc/intersect.cu IX_THREADS


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout to import the port from")
    ap.add_argument("--label", default="", help="tag of every line")
    ap.add_argument("--target-runs", type=int, default=2,
                    help="timed runs of the target render")
    ap.add_argument("--block-ab", action="store_true",
                    help="also time kernel 3 at the other of 128 and 256 "
                         "threads a block")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))

    import torch

    if not torch.cuda.is_available():
        print("torch_tspace_ab: no CUDA device", file=sys.stderr)
        return 1
    import raytracinginoneweekend_tpu_torch as rt
    from raytracinginoneweekend_tpu_torch import cli, golden, kernels
    from raytracinginoneweekend_tpu_torch.ops import (cuda_fused,
                                                      cuda_segment as seg,
                                                      integrate, wavefront)
    from raytracinginoneweekend_tpu_torch.ops.cuda_intersect import (
        closest_hit_cuda)
    from raytracinginoneweekend_tpu_torch.ops.intersect import closest_hit
    from raytracinginoneweekend_tpu_torch.utils.timing import cuda_time_ms

    prender = importlib.import_module(
        "raytracinginoneweekend_tpu_torch.render")
    dev = torch.device("cuda")
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", W, H, dev)
    tiled = dataclasses.replace(rt.DEFAULT, intersect="pallas")

    def emit(obj):
        print(json.dumps({"label": args.label, **obj}), flush=True)

    def device_ms(fn):
        return cuda_time_ms(fn, iters=20, queue_behind=True)

    def bits_equal(a, b):
        return all(bool(torch.equal(x, y)) for x, y in zip(a, b))

    # kernel 3 on the tiled engine's rays after three bounces
    gen = torch.Generator(device="cpu").manual_seed(3)
    batch = torch.randperm(W * H, generator=gen)[:TARGET["batch_pixels"]]
    k3_inputs = {}
    for pids, spp in ((torch.arange(W * H, dtype=torch.int32), 1),
                      (batch.to(torch.int32), TARGET["spp"])):
        pids = torch.repeat_interleave(pids.to(dev), spp)
        sids = torch.arange(spp, dtype=torch.int32, device=dev).repeat(
            pids.shape[0] // spp)
        with torch.no_grad():
            o, d, keys = prender.make_primary_rays(
                cam, pids, sids, rt.key_words(0), W, H, "thinlens")
            state = integrate._init_state(o, d, keys)
            for b in range(3):
                state = integrate._bounce_step(scene, tiled, state, b,
                                               allow_pallas=True)
        o, d = state[0].contiguous(), state[1].contiguous()

        def k3(o=o, d=d):
            return closest_hit_cuda(o, d, scene.centers, scene.radii,
                                    rt.DEFAULT.t_min)

        want = closest_hit(o, d, scene.centers, scene.radii,
                           rt.DEFAULT.t_min)
        k3_inputs[o.shape[0]] = (k3, want)
        emit({"kernel": "intersect", "rays": o.shape[0], "ms": device_ms(k3),
              "bit_equal_with_plain": bits_equal(
                  [x.view(torch.int32) if x.is_floating_point() else x
                   for x in k3()],
                  [x.view(torch.int32) if x.is_floating_point() else x
                   for x in want])})

    # kernel 6 on coherent rays, kernel 1 on the same rays
    tile = dataclasses.replace(rt.DEFAULT, ownership="tile")
    for name, pool, steps in (("camera_rays", 1 << 20, None),
                              ("mid_frame", 1 << 20, 40),
                              ("camera_rays", 1 << 15, None)):
        eng = wavefront.build_engine(
            scene, cam, rt.key_words(0), width=W, height=H, spp=SPP,
            max_depth=DEPTH, camera_mode="thinlens", options=tile,
            pool_size=pool, device=dev)
        if steps is None:
            state = wavefront.engine_prologue(eng)
        else:  # chip_smoke.mid_frame_state
            state = list(wavefront.engine_initial_state(eng))
            state[0] += (eng.n_k // 2) * eng.stride
            state = cuda_fused.regen(tuple(state), eng.camvec,
                                     eng.base_words, **eng.regen_kw)
            for _ in range(steps):
                state = wavefront.engine_step(eng, state)
        rays, act = tuple(p.clone() for p in state[4:10]), state[3].clone()
        sorted_params, groups = seg.group_scene(eng.sphere_params)
        geom_s = sorted_params[:4]
        stats = torch.zeros(2, dtype=torch.int64, device=dev)

        def k6(stats=None):
            return seg.segment_closest_hit_grouped(
                rays, *geom_s, groups, eng.t_min, active=act, stats=stats)

        got = k6(stats)
        want = seg.segment_closest_hit_grouped_reference(
            rays, *geom_s, groups, eng.t_min, active=act)
        skipped, total = (int(v) for v in stats.tolist())
        emit({"kernel": "closest_hit_grouped", "rays": name,
              "lanes": eng.lanes, "ms": device_ms(k6),
              "bit_equal_with_plain": bits_equal(
                  (got[0], got[1].view(torch.int32), got[2]),
                  (want[0], want[1].view(torch.int32), want[2])),
              "share_skipped": skipped / max(total, 1),
              "closest_hit_ms_same_rays": device_ms(
                  lambda: seg.segment_closest_hit(
                      rays, *eng.sphere_params[:4], eng.t_min, active=act,
                      table=eng.htable))})

    if args.block_ab:
        name = "rtw_closest_hit_n3"
        built = kernels.entry(name)
        src = open(os.path.join(kernels.CSRC_DIR, "intersect.cu")).read()
        line = {b: f"#define IX_THREADS {b}\n" for b in BLOCK_SIZES}
        have = [b for b in BLOCK_SIZES if src.count(line[b]) == 1]
        if len(have) != 1:
            print("torch_tspace_ab: the block size line moved",
                  file=sys.stderr)
            return 1
        other = next(b for b in BLOCK_SIZES if b != have[0])
        os.makedirs(kernels.BUILD_DIR, exist_ok=True)
        alt = os.path.join(kernels.BUILD_DIR, f"intersect_t{other}.cu")
        with open(alt, "w") as f:
            f.write(src.replace(line[have[0]], line[other]))
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                        kernels.CSRC_DIR, "-o", alt[:-3] + ".so", alt],
                       check=True)
        alt_fn = getattr(ctypes.CDLL(alt[:-3] + ".so"), name)
        alt_fn.argtypes = kernels.ENTRIES[name][1]
        alt_fn.restype = ctypes.c_int
        for n, (k3, want) in k3_inputs.items():
            out = {"block_ab": "intersect", "rays": n,
                   "built": f"threads_{have[0]}"}
            for _ in range(2):
                for form, fn in ((f"threads_{have[0]}", built),
                                 (f"threads_{other}", alt_fn)):
                    kernels._fns[name] = fn
                    try:
                        got = k3()
                        if not (torch.equal(got[0].view(torch.int32),
                                            want[0].view(torch.int32))
                                and torch.equal(got[1], want[1])
                                and torch.equal(got[2], want[2])):
                            print(f"torch_tspace_ab: {form} is not "
                                  "bit-equal", file=sys.stderr)
                            return 1
                        out.setdefault(form, []).append(device_ms(k3))
                    finally:
                        kernels._fns[name] = built
            emit(out)

    @contextlib.contextmanager
    def intersect_events():
        """CUDA events around every launch of kernel 3 -> its ms each."""
        name = "rtw_closest_hit_n3"
        fn = kernels.entry(name)
        pairs, out = [], []

        def wrapper(*a):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            err = fn(*a)
            e1.record()
            pairs.append((e0, e1))
            return err

        kernels._fns[name] = wrapper
        try:
            yield out
        finally:
            kernels._fns[name] = fn
        torch.cuda.synchronize()
        out.extend(a.elapsed_time(b) for a, b in pairs)

    def target(w, h):
        c = cli._build_camera("cpu", w, h, dev)
        cfg = rt.RenderConfig(width=w, height=h, spp=TARGET["spp"],
                              max_depth=TARGET["depth"],
                              camera_mode="thinlens", options=tiled)
        return prender.render(scene, c, cfg, rt.key_words(0), device=dev)

    target(64, 48)  # warm-up
    secs, k3_s, launches = [], [], []
    for _ in range(args.target_runs):
        torch.cuda.synchronize()
        with intersect_events() as ms:
            t0 = time.perf_counter()
            img = target(W, H)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        k3_s.append(sum(ms) / 1e3)
        launches.append(len(ms))
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("bad target frame")
    emit({"target": "train_path", "seconds": secs,
          "intersect_seconds": k3_s, "intersect_launches": launches,
          "sha256": hashlib.sha256(img.cpu().numpy().tobytes()).hexdigest()})

    def render(pool, w=W, h=H, spp=SPP, depth=DEPTH, plain=False):
        c = cli._build_camera("cpu", w, h, dev)
        return rt.render_wavefront(
            scene, c, rt.key_words(0), width=w, height=h, spp=spp,
            max_depth=depth, camera_mode="thinlens", options=rt.DEFAULT,
            pool_size=pool, plain=plain, device=dev)

    for pool in (1 << 15, 1 << 20):
        render(pool, 64, 48, 1)  # warm-up
        secs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = render(pool)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        if not (bool(torch.isfinite(img).all())
                and tuple(img.shape) == (W * H, 3)):
            raise RuntimeError("bad frame")
        emit({"frame": "default", "pool": pool, "seconds": secs,
              "sha256": hashlib.sha256(img.cpu().numpy().tobytes())
              .hexdigest()})

    sw, sh, sspp, sdepth = (SMALL[k] for k in ("width", "height", "spp",
                                               "depth"))
    img_k = render(1 << 15, sw, sh, sspp, sdepth)
    img_p = render(1 << 15, sw, sh, sspp, sdepth, plain=True)
    emit({"frame_vs_plain": golden.compare_frames(img_k.cpu().numpy(),
                                                  img_p.cpu().numpy())})
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
