#!/usr/bin/env python3
"""Where does the regenerative AD pool start to beat the planar engine on
this card?

Takes three train steps (after one warm-up step; all on the same batch,
each from the same parameters) of each reverse-mode engine of the
PyTorch/CUDA port at the training path's shape (huge scene, 1200x800
camera, thin lens, 16384 pixels x 8 spp = 131072 rays, parameters albedo
and centers) at depths 16, 32 and 50, with and without Russian-roulette
termination: the planar engine (ops/integrate_planar.py), the pool at its
default of 2^15 lanes (four waves of rays) and the pool at 2^17 lanes (one
wave). Prints one JSON object per (depth, rr, engine): the median step,
forward, backward and Adam seconds of the three (host clock around
synchronised work; the step is launch-bound, so its time moves with the
host), the closest-hit kernel's launches in a step, the pool's iterations
for the batch (``wavefront_ad_budget``), the peak device memory; then the
card's name and power limit. The engines' losses on one batch are equal
to float32 rounding (same draws, same paths).

``optim.inverse.AD_ENGINE_AUTO_DEPTH`` (32, 28 with rr) is the JAX
package's crossover, measured on a TPU; PERF.md records what this script
reads on an NVIDIA card.

Run on a machine with a CUDA card and nvcc:
    python3 scripts/torch_ad_crossover.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

W, H, BATCH, SPP, LR = 1200, 800, 16384, 8, 1e-2
WHICH = ("albedo", "centers")
DEPTHS = (16, 32, 50)
ENGINES = {"planar": ("planar", None),
           "pool_32768": ("wavefront", {"pool_size": 1 << 15}),
           "pool_131072": ("wavefront", {"pool_size": 1 << 17})}


def emit(obj):
    print(json.dumps(obj), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_ad_crossover: no CUDA device", file=sys.stderr)
        return 1

    import raytracinginoneweekend_tpu_torch as rt
    from raytracinginoneweekend_tpu_torch import cli, kernels, optim
    from raytracinginoneweekend_tpu_torch.ops import wavefront_ad
    from raytracinginoneweekend_tpu_torch.optim import inverse

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", W, H, dev)
    gen = torch.Generator(device="cpu").manual_seed(1)
    for name in WHICH:  # the CLI's perturbation of the parameters
        leaf = getattr(scene, name)
        scene = scene._replace(**{name: leaf + (0.1 * torch.randn(
            leaf.shape, generator=gen)).to(dev)})
    batch_key, key = inverse.step_keys(rt.key_words(7), 0)
    ids = inverse.draw_pixel_batch(batch_key, W * H, BATCH, dev)
    target = torch.rand(BATCH, 3, generator=gen).to(dev)

    def step(engine, opts, **kw):
        p = optim.params_from_scene(scene, WHICH)
        adam = inverse.make_adam(p, LR)
        adam.zero_grad(set_to_none=True)
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = optim.render_loss(p, scene, cam, target, ids, key,
                                 engine=engine, engine_opts=opts, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        adam.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        return {"step_s": t3 - t0, "forward_s": t1 - t0,
                "backward_s": t2 - t1, "adam_s": t3 - t2,
                "loss": float(loss.detach()),
                "closest_hit_launches": kernels.LAUNCHES["closest_hit"],
                "peak_bytes": torch.cuda.max_memory_allocated()}

    for depth in DEPTHS:
        for rr in (False, True):
            options = dataclasses.replace(rt.DEFAULT, rr_terminate=rr)
            kw = dict(width=W, height=H, spp=SPP, max_depth=depth,
                      camera_mode="thinlens", options=options)
            for name, (engine, opts) in ENGINES.items():
                step(engine, opts, **kw)  # warm-up
                runs = [step(engine, opts, **kw) for _ in range(3)]
                res = {k: (statistics.median(r[k] for r in runs)
                           if k.endswith("_s") else runs[-1][k])
                       for k in runs[0]}
                res["step_s_all"] = [r["step_s"] for r in runs]
                if engine == "wavefront":
                    res["iterations"] = wavefront_ad.wavefront_ad_budget(
                        scene, cam, ids, key, **opts, **kw)
                emit({"depth": depth, "rr_terminate": rr, "engine": name,
                      "auto": inverse.resolve_ad_engine(depth, rr),
                      "card": card, **res})
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
