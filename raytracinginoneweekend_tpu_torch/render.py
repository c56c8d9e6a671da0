"""High-level renderer of the tiled engine: camera rays + trace + tiling.

Counterpart of ``raytracinginoneweekend_tpu/render.py``: the (N, 3),
autograd-capable engine (the forward wavefront engine is ops/wavefront.py).

Structure:
  * The unit of device work is ``render_pixels``: a flat chunk of P pixel
    ids, looped over spp *waves* -- each wave traces P*wave_spp rays
    through the wavefront integrator and accumulates into a (P, 3)
    framebuffer chunk. Memory is O(P * wave_spp) rays, whatever the spp.
  * ``render`` tiles the full image over pixel chunks.

Every random draw is keyed by (global pixel id, global sample id) only
(ops/rng.py), so the image is invariant to chunk size and wave size.

Pixel addressing matches the reference: pixel_index = x + y*width, row 0
at the top (cuda_impl.cu:363-364), u = (x + U01)/width,
v = (y + U01)/height (cuda_impl.cu:370-371).
"""

from __future__ import annotations

import torch

from .config import RenderConfig, TraceOptions
from .models.camera import Camera, camera_ray
from .models.scene import Scene
from .ops import rng
from .ops import threefry as tf
from .ops.integrate import trace, trace_fast
from .utils.device import resolve_device


def make_primary_rays(cam: Camera, pixel_ids, sample_ids, base_key,
                      width: int, height: int, camera_mode: str,
                      sampling: str = "iid", spp: int = 0):
    """Generate jittered camera rays for (pixel, sample) pairs.

    pixel_ids, sample_ids: equal-shape (R,) i32 tensors; base_key: the
    ``(k0, k1)`` base-key words. sampling="stratified" remaps the jitter
    per rng.stratify_uv and, in thinlens mode, the lens pair per
    rng.stratify_lens_uv (needs spp, the total samples per pixel).
    Returns (origins (R,3), directions (R,3), ray_keys) with ray_keys the
    pair (k0, k1) of (R,) key-word tensors.
    """
    rkey = rng.ray_key(base_key, pixel_ids, sample_ids)
    ju, jv = rng.jitter_uv(rkey)
    lens_uv = None
    if sampling == "stratified":
        # Per-PIXEL rotation: the pixel's sid=0 jitter word (shared across
        # samples -- see rng.stratify_uv).
        zkey = rng.ray_key(base_key, pixel_ids, 0)
        rot_v = rng.jitter_uv(zkey)[1]
        ju, jv = rng.stratify_uv(ju, rot_v, sample_ids, spp)
        if camera_mode == "thinlens":
            # Stratified lens pair: rotations from the unconsumed (pid, 0)
            # (TAG_LENS, j=2) counter.
            lu0, _ = tf.draw_uniform2(*rkey, rng.TAG_LENS, 0)
            lr_u, lr_v = tf.draw_uniform2(*zkey, rng.TAG_LENS, 2)
            lens_uv = rng.stratify_lens_uv(lu0, lr_u, lr_v, sample_ids, spp)
    y = torch.div(pixel_ids, width, rounding_mode="floor")
    x = pixel_ids - y * width
    u = (x.to(torch.float32) + ju) / float(width)
    v = (y.to(torch.float32) + jv) / float(height)
    o, d = camera_ray(cam, u, v, rkey, camera_mode, lens_uv=lens_uv)
    return o, d, rkey


def render_pixels_impl(scene: Scene, cam: Camera, pixel_ids, base_key, *,
                       width: int, height: int, spp: int, wave_spp: int,
                       max_depth: int, camera_mode: str,
                       options: TraceOptions, differentiable: bool = False):
    """Render a flat chunk of pixels -> (P, 3) linear radiance means.

    pixel_ids: (P,) i32 tensor on the device to render on (scene and
    camera lie there too). spp is split into ceil(spp/wave_spp) waves;
    each wave is a full wavefront trace of P*wave_spp rays.
    ``differentiable`` selects the checkpointed integrator (``trace``)
    instead of the forward-only early-exit one (``trace_fast``).
    """
    p = pixel_ids.shape[0]
    dev = pixel_ids.device
    n_waves = -(-spp // wave_spp)
    tracer = trace if differentiable else trace_fast
    pids = torch.repeat_interleave(pixel_ids.to(torch.int32), wave_spp)
    acc = torch.zeros((p, 3), dtype=torch.float32, device=dev)
    for wave_idx in range(n_waves):
        sample_ids = wave_idx * wave_spp + torch.arange(
            wave_spp, dtype=torch.int32, device=dev)
        sids = sample_ids.repeat(p)
        o, d, rkeys = make_primary_rays(cam, pids, sids, base_key, width,
                                        height, camera_mode,
                                        sampling=options.sampling, spp=spp)
        strat0 = None
        if options.sampling == "stratified":
            # First-bounce stratified scatter (rng.strat0_scatter): fixed
            # per wave, computed once here.
            strat0 = rng.strat0_scatter(rkeys, pids, sids, base_key, spp,
                                        options.scatter_sample)
        colors = tracer(scene, o, d, rkeys, max_depth, options,
                        strat0=strat0)
        # Mask samples beyond spp (when spp % wave_spp != 0).
        live = (sids < spp).to(colors.dtype)[:, None]
        acc = acc + (colors * live).reshape(p, wave_spp, 3).sum(dim=1)
    return acc / float(spp)


# The JAX package jits render_pixels_impl under this name; PyTorch runs
# eagerly, so the two are one function here.
render_pixels = render_pixels_impl


def render(scene: Scene, cam: Camera, cfg: RenderConfig, base_key=None,
           differentiable: bool = False, device=None):
    """Render a full image -> (H, W, 3) float32 linear radiance, a tensor
    on ``device`` (None = the CUDA card; scene and camera are moved there).

    base_key: the ``(k0, k1)`` base-key words (None = those of seed 0).
    Tiles pixels into chunks sized so that each wave traces at most
    cfg.rays_per_chunk rays.
    """
    device = resolve_device(device)
    scene, cam = scene.to(device), cam.to(device)
    if base_key is None:
        base_key = tf.key_words(0)
    w, h, spp = cfg.width, cfg.height, cfg.spp
    n_pixels = w * h

    wave_spp = max(1, min(spp, cfg.rays_per_chunk // max(1, n_pixels)))
    if wave_spp > 1:
        chunk = n_pixels  # whole image fits one chunk
    else:
        chunk = min(n_pixels, cfg.rays_per_chunk)
    n_chunks = -(-n_pixels // chunk)

    # Ids past the image (the last chunk's padding) render defined values
    # that are dropped below.
    all_ids = torch.arange(n_chunks * chunk, dtype=torch.int32,
                           device=device)
    parts = []
    for i in range(n_chunks):
        parts.append(render_pixels(
            scene, cam, all_ids[i * chunk:(i + 1) * chunk], base_key,
            width=w, height=h, spp=spp, wave_spp=wave_spp,
            max_depth=cfg.max_depth, camera_mode=cfg.camera_mode,
            options=cfg.options, differentiable=differentiable))
    return torch.cat(parts)[:n_pixels].reshape(h, w, 3)


def render_rays_count(cfg: RenderConfig) -> int:
    """Camera rays for a config (the rays/s denominator)."""
    return cfg.width * cfg.height * cfg.spp
