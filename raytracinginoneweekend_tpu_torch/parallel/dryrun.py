"""A dry run of the sharded program on tiny shapes.

    python -m raytracinginoneweekend_tpu_torch.parallel.dryrun 8 [--device cpu]

The port's counterpart of the JAX package's ``dryrun_multichip(n)``: ONE
sharded train step (forward render, backward, parameter gradients summed
over the workers, Adam) and every sharded render -- the tiled engine (a
pixel count the mesh does not divide, several chunks), the single-pool
wavefront engine (default and ``rr_terminate``, with the tail reserve) and
the dual-pool engine -- over an n-worker mesh, every output checked finite.
The workers are ``n`` copies of one device (the CUDA card unless the CPU is
asked for): what runs is the program of n workers, not a measure of n
cards.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from ..config import DEFAULT, RenderConfig
from ..models.camera import reference_cuda_camera
from ..models.scene import huge_scene, simple_scene_cuda
from ..ops.threefry import key_words
from ..optim import make_train_step, params_from_scene
from ..optim.inverse import make_adam
from ..utils.device import resolve_device
from .mesh import (make_mesh, render_image_sharded, render_sharded,
                   render_wavefront_dual_sharded, render_wavefront_sharded)


def _finite(what: str, t: torch.Tensor) -> None:
    if not bool(torch.isfinite(t).all()):
        raise AssertionError(f"dry run: {what} is not finite")


def dryrun(n_workers: int, device=None) -> dict:
    """Run the sharded program once over ``n_workers`` workers on
    ``device`` (None = the CUDA card) -> {each render: the shape of its
    output, "train_step_loss": the step's loss}. Raises on any non-finite
    output."""
    device = resolve_device(device)
    mesh = make_mesh([device] * n_workers)
    out = {}
    width, height, spp, depth = 16, 8, 2, 3
    scene = simple_scene_cuda(device)
    cam = reference_cuda_camera(width, height, device)

    # the tiled engine over the mesh: the whole (tiny) image as the target
    n_pixels = width * height
    n_pad = -(-n_pixels // n_workers) * n_workers
    target = render_sharded(
        scene, cam, torch.arange(n_pad, dtype=torch.int32), key_words(0),
        mesh=mesh, width=width, height=height, spp=spp, wave_spp=spp,
        max_depth=depth, camera_mode="thinlens", options=DEFAULT)
    _finite("render_sharded", target)
    out["render_sharded"] = list(target.shape)

    # one train step: forward, backward, gradients summed over the
    # workers (by autograd in one process), Adam (the planar AD engine)
    params = params_from_scene(scene)
    opt = make_adam(params, 1e-2)
    batch_ids = (torch.arange(n_workers * 8, dtype=torch.int32)
                 % n_pixels).to(device)
    step = make_train_step(
        opt, width=width, height=height, spp=spp, max_depth=depth,
        camera_mode="thinlens", options=DEFAULT, mesh=mesh)
    loss = step(params, scene, cam,
                target.detach()[batch_ids.to(torch.int64)],
                batch_ids, key_words(1))
    _finite("the train step's loss", loss)
    for name, p in params.items():
        _finite(f"parameter {name} after the step", p)
    out["train_step_loss"] = float(loss)

    # the huge scene: the full-image tiler with several chunks and a pixel
    # count the mesh does not divide; the wavefront engines
    hscene = huge_scene(0, device)
    hw, hh = 18, 9
    himg = render_image_sharded(
        hscene, cam, RenderConfig(width=hw, height=hh, spp=2, max_depth=3,
                                  camera_mode="thinlens", options=DEFAULT,
                                  rays_per_chunk=64),
        key_words(3), mesh=mesh)
    _finite("render_image_sharded", himg)
    out["render_image_sharded"] = list(himg.shape)
    kw = dict(mesh=mesh, width=hw, height=hh, spp=2, camera_mode="thinlens")
    for name, options, depth_, extra in (
            ("render_wavefront_sharded", DEFAULT, 3, {}),
            ("render_wavefront_sharded_rr",
             dataclasses.replace(DEFAULT, rr_terminate=True), 4,
             {"reserve_frac": 0.15})):
        img = render_wavefront_sharded(hscene, cam, key_words(4),
                                       max_depth=depth_, options=options,
                                       pool_size=1000, **kw, **extra)
        _finite(name, img)
        out[name] = list(img.shape)
    dimg = render_wavefront_dual_sharded(hscene, cam, key_words(6),
                                         max_depth=3, options=DEFAULT,
                                         pool_size=1024, **kw)
    _finite("render_wavefront_dual_sharded", dimg)
    out["render_wavefront_dual_sharded"] = list(dimg.shape)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_workers", type=int)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (fails without one)")
    args = ap.parse_args(argv)
    print(dryrun(args.n_workers, args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
