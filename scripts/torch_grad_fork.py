#!/usr/bin/env python3
"""Why does an albedo gradient element of the planar AD engine sometimes sit
percents of its row away from the tiled engine's?

chip_smoke.py's train_path holds the two engines' render_loss gradients
against each other on one batch of the training path's shape (huge scene,
1200x800 camera, 16384 pixels x 8 spp, depth 16) at the parameters the fit
has just reached. Those parameters differ from run to run in the last bits
(the backward's per-sphere sums are atomic adds), so every run checks a
slightly different scene. This script repeats the check on ``--trials``
seeded scenes (the training path's perturbation with another seed each, and
another batch and key each) and, for every albedo element beyond the check's
tolerance (rtol 1e-3 plus 1e-2 of the row's largest element; with none beyond,
for the element nearest to it), finds where it comes from:

  * it moves that one albedo entry by ``EPS`` and renders the batch again
    with both engines, without autograd: the difference of the two frames,
    times the loss's cotangent, is each pixel's share of the element -- by
    the forward passes alone;
  * the pixel whose share differs most between the engines is printed with
    its radiance in both engines, the distance between them in units of the
    set-aside tolerance (rtol 1e-4 + atol 3e-5: a pixel beyond 1 is set
    aside as a knife edge), and what part of the element's difference it
    explains.

If the forward shares add up to each engine's gradient and ONE pixel explains
the difference, the element is a path that took another way in one engine
inside a pixel whose radiance moved less than the set-aside tolerance -- not
a wrong term in a backward. The distribution of the distance over all kept
pixels says whether a tighter radiance tolerance would catch such pixels (it
would not: such pixels sit as low as 0.02 of the tolerance).

It also tries the remedy chip_smoke.py uses: the two engines render the batch
once more with every albedo set to 1 -- the same paths, whose radiance is then
the sky they reach however deep they are -- and the pixels that differ there
are set aside too (``with_the_white_probe``: how many more pixels, and the
albedo elements still beyond the tolerance).

One JSON object per line. Run on a machine with a CUDA card and nvcc:
    python3 scripts/torch_grad_fork.py --trials 40
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

EPS = 0.05
RTOL, ATOL = 1e-4, 3e-5  # the set-aside tolerance of engine_gradients_raw


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=40)
    ap.add_argument("--locate", type=int, default=3,
                    help="elements taken apart per trial, at most")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch-pixels", type=int, default=None,
                    help="pixels a batch (default: the training path's)")
    ap.add_argument("--size", type=int, nargs=2, default=None,
                    metavar=("WIDTH", "HEIGHT"))
    args = ap.parse_args(argv)

    import dataclasses

    import torch

    import raytracinginoneweekend_tpu_torch as rt
    from raytracinginoneweekend_tpu_torch import cli, optim
    from raytracinginoneweekend_tpu_torch.optim import inverse

    dev = torch.device(args.device)
    smi = "cpu" if dev.type == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    train = dict(cs.TRAIN)
    if args.batch_pixels:
        train["batch_pixels"] = args.batch_pixels
    if args.size:
        train["width"], train["height"] = args.size
    w, h = train["width"], train["height"]
    options = dataclasses.replace(rt.DEFAULT, intersect="pallas")
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", w, h, dev)
    kw = dict(width=w, height=h, spp=train["spp"],
              max_depth=train["depth"], camera_mode="thinlens",
              options=options)
    which = ("albedo", "centers")
    counts, counts_white = [], []
    for trial in range(args.trials):
        gen = torch.Generator(device="cpu").manual_seed(100 + trial)
        perturbed = scene
        for name in which:
            leaf = getattr(scene, name)
            noise = train["perturb"] * torch.randn(leaf.shape, generator=gen)
            perturbed = perturbed._replace(**{name: leaf + noise.to(dev)})
        params = {k: v.detach() for k, v in optim.params_from_scene(
            perturbed, which).items()}
        batch_key, key = inverse.step_keys(rt.key_words(7), trial)
        ids = inverse.draw_pixel_batch(batch_key, w * h,
                                       train["batch_pixels"], dev)
        target = torch.rand(ids.numel(), 3, generator=gen).to(dev)

        def frame(engine, p, sc=perturbed, cm=cam):
            with torch.no_grad():
                return inverse._render_batch(
                    optim.scene_with_params(sc, p), cm, ids, key,
                    engine=engine, **kw)

        px = {"planar": frame("planar", params),
              "tiled": frame("tiled", params)}
        sc64, cam64, p64 = cs.to_float64(perturbed, cam, params)
        px["witness"] = frame("tiled", p64, sc64, cam64).to(torch.float32)
        # distance planar-tiled in units of the set-aside tolerance
        dist = ((px["planar"] - px["tiled"]).abs()
                / (ATOL + RTOL * px["tiled"].abs())).amax(dim=-1)
        near_w = torch.isclose(px["witness"], px["tiled"], rtol=RTOL,
                               atol=ATOL).all(dim=-1)
        agree = (dist <= 1.0) & near_w
        # The same paths with every albedo 1: a path's radiance is then the
        # sky it reaches, however deep, so a path that goes another way in
        # one engine shows at full size.
        white = dict(params, albedo=torch.ones_like(params["albedo"]))
        pw = {e: frame(e, white) for e in ("planar", "tiled")}
        dist_white = ((pw["planar"] - pw["tiled"]).abs()
                      / (ATOL + RTOL * pw["tiled"].abs())).amax(dim=-1)
        agree_white = agree & (dist_white <= 1.0)

        def albedo_excess(keep):
            c = 2.0 * (px["tiled"] - target) / target.numel() * keep[:, None]
            g = {}
            for e in ("planar", "tiled"):
                p = {k: v.clone().requires_grad_(True)
                     for k, v in params.items()}
                g[e] = optim.render_pixels_vjp(
                    p, perturbed, cam, c, ids, key, engine=e,
                    **kw)[0]["albedo"].to(torch.float64)
            own_ = g["tiled"].abs().amax(dim=1, keepdim=True)
            ex = (g["planar"] - g["tiled"]).abs() / (
                1e-3 * g["tiled"].abs() + 1e-2 * own_).clamp_min(1e-300)
            return c, g["planar"], g["tiled"], own_, ex

        _c, _gp, _gt, _own, excess_white = albedo_excess(agree_white)
        cot, gp, gt, own, excess = albedo_excess(agree)
        beyond = (excess > 1.0).nonzero().tolist()
        kept = dist[agree]
        q = torch.quantile(kept.double(), torch.tensor(
            [0.5, 0.9, 0.99, 0.999], dtype=torch.float64, device=dev))
        rec = {"trial": trial, "card": smi, "pixels": int(agree.numel()),
               "set_aside_planar_vs_tiled": int((dist > 1.0).sum()),
               "set_aside_in_all": int((~agree).sum()),
               "albedo_elements_live": int((own.expand_as(gt) > 0).sum()),
               "albedo_elements_beyond": len(beyond),
               "with_the_white_probe": {
                   "set_aside_more": int((agree & ~agree_white).sum()),
                   "albedo_elements_beyond": int((excess_white > 1.0).sum()),
                   "largest_excess": float(excess_white.max())},
               "largest_excess": float(excess.max()),
               "kept_pixels_distance": {
                   "median": float(q[0]), "p90": float(q[1]),
                   "p99": float(q[2]), "p999": float(q[3]),
                   "kept_beyond_0.1": int((kept > 0.1).sum()),
                   "kept_beyond_0.3": int((kept > 0.3).sum())},
               "located": []}
        counts.append(len(beyond))
        counts_white.append(int((excess_white > 1.0).sum()))
        # with nothing beyond, the element nearest to the tolerance
        worst = divmod(int(excess.argmax()), excess.shape[1])
        for row, ch in (beyond or [list(worst)])[:args.locate]:
            moved = {k: v.clone() for k, v in params.items()}
            moved["albedo"][row, ch] += EPS
            share = {e: ((frame(e, moved) - px[e]) * cot).sum(dim=-1).to(
                torch.float64) / EPS for e in ("planar", "tiled")}
            diff = share["planar"] - share["tiled"]
            order = diff.abs().argsort(descending=True)[:3].tolist()
            rec["located"].append({
                "sphere": row, "channel": ch,
                "gradient": {"planar": float(gp[row, ch]),
                             "tiled": float(gt[row, ch])},
                "row_largest": float(own[row]),
                "excess": float(excess[row, ch]),
                # the forward passes' account of the same two numbers
                "sum_of_forward_shares": {e: float(share[e].sum())
                                          for e in share},
                "pixels_with_a_share": {e: int((share[e] != 0).sum())
                                        for e in share},
                "pixels": [{
                    "pixel_id": int(ids[i]),
                    "share": {e: float(share[e][i]) for e in share},
                    "part_of_the_gradients_difference":
                        float(diff[i] / (gp[row, ch] - gt[row, ch])),
                    "radiance": {e: px[e][i].tolist()
                                 for e in ("planar", "tiled")},
                    "distance_in_set_aside_tolerances": float(dist[i]),
                } for i in order]})
        print(json.dumps(rec), flush=True)
    print(json.dumps({"trials": args.trials, "card": smi,
                      "albedo_elements_beyond_per_trial": counts,
                      "trials_with_any": sum(c > 0 for c in counts),
                      "with_the_white_probe": counts_white,
                      "largest_count": max(counts)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
