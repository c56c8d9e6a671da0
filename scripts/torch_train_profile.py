#!/usr/bin/env python3
"""Where does a train step of the PyTorch/CUDA port spend its time?

Takes train steps at the training path's full width (huge scene, 1200x800
camera, thin lens, 16384 pixels x 8 spp = 131072 rays a step, depth 16,
parameters albedo and centers) with the planar and the tiled AD engine on
one GPU, each under ``torch.profiler`` (CPU and CUDA activities), and
prints one JSON object per engine: the step's wall time under the profiler
and without it (the step before, synchronised host clock), the device's
busy time (sum of kernel times) and idle share against either wall time,
the number of device kernels launched, and the kernels that take most
device time, by name. The hand-written closest-hit kernel shows as
``closest_hit_kernel``; ``index_add_`` as ``indexFuncLargeIndex``. If the
profiler reports no device time on this machine the line says so.

The step's split into forward, backward and update, and the closest-hit
kernel's own time at this shape, are chip_smoke.py's (``train_path``:
``one_step_parts``; ``kernels``: ``closest_hit.train_shape``).

Run on a machine with a CUDA card and nvcc:
    python3 scripts/torch_train_profile.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

W, H, DEPTH, BATCH, SPP, LR = 1200, 800, 16, 16384, 8, 1e-2
WHICH = ("albedo", "centers")


def emit(obj):
    print(json.dumps(obj), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1

    import raytracinginoneweekend_tpu_torch as rt
    from raytracinginoneweekend_tpu_torch import cli, kernels, optim
    from raytracinginoneweekend_tpu_torch.optim import inverse

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    options = dataclasses.replace(rt.DEFAULT, intersect="pallas")
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", W, H, dev)
    gen = torch.Generator(device="cpu").manual_seed(1)
    perturbed = scene
    for name in WHICH:
        leaf = getattr(scene, name)
        noise = 0.1 * torch.randn(leaf.shape, generator=gen)
        perturbed = perturbed._replace(**{name: leaf + noise.to(dev)})
    ids = inverse.draw_pixel_batch((1, 2), W * H, BATCH, dev)
    target = torch.rand(BATCH, 3, generator=gen).to(dev)
    kw = dict(width=W, height=H, spp=SPP, max_depth=DEPTH,
              camera_mode="thinlens", options=options)

    def make(engine):
        params = optim.params_from_scene(perturbed, WHICH)
        step = optim.make_train_step(inverse.make_adam(params, LR),
                                     engine=engine, **kw)
        return lambda i: step(params, perturbed, cam, target, ids,
                              rt.key_words(100 + i))

    from torch.profiler import ProfilerActivity, profile

    for engine in ("planar", "tiled"):
        run = make(engine)
        run(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(2)
        torch.cuda.synchronize()
        bare = time.perf_counter() - t0
        kernels.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # Kernel rows only: an operator's row repeats the device time of
        # the kernels it launched.
        rows = []
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0.0)
            if dev_us > 0:
                rows.append((ev.key, float(dev_us), int(ev.count)))
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows) * 1e-6
        rec = {"profile": engine, "card": card,
               "rays_per_step": BATCH * SPP, "depth": DEPTH,
               "wall_seconds_under_profiler": wall,
               "wall_seconds_without_profiler": bare,
               "launches": dict(kernels.LAUNCHES)}
        if busy <= 0:
            rec["device_time"] = "not measured: the profiler reported no " \
                                 "device time on this machine"
        else:
            rec.update(
                device_busy_seconds=busy,
                device_idle_share=max(0.0, 1.0 - busy / wall),
                device_idle_share_without_profiler=max(
                    0.0, 1.0 - busy / bare),
                device_kernels=sum(r[2] for r in rows),
                top=[{"name": r[0][:80], "ms": r[1] * 1e-3, "count": r[2]}
                     for r in rows[:14]])
        emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
