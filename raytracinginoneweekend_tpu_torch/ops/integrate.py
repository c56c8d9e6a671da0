"""Wavefront integrator over (N, 3) rays: the tiled engine's bounce loop.

The port's copy of ``raytracinginoneweekend_tpu/ops/integrate.py``. The
reference's integrator is a per-thread loop with data-dependent early
returns (main.cxx:52-75; cuda_impl.cu:265-297):
  hit -> scatter -> attenuation *= albedo, continue
  metal absorb   -> return black
  miss           -> return sky(t) * attenuation
  depth exhausted-> return black

Here the loop runs over a *fixed* bounce count with an explicit live-ray
mask. Per-ray state is SoA tensors; nothing is updated in place, so every
tensor autograd saved stays as it was:

  state: origin (N,3), dir (N,3), attenuation (N,3), result (N,3),
         alive (N,), ray key words (k0, k1)
  per bounce:
    t, idx, hit = closest_hit(...)                # ops/intersect.py
    result += (alive & ~hit) ? attenuation * sky(dir) : 0
    new_dir, alb, valid = scatter(...)            # ops/scatter.py
    attenuation *= alb   where scattering
    alive = alive & hit & valid

Two tracers over the same step function:
  - ``trace(...)``:       a Python loop, reverse-mode differentiable; each
                          step is rematerialised in backward
                          (torch.utils.checkpoint, non-reentrant), which
                          keeps memory O(N), not O(N * depth).
  - ``trace_fast(...)``:  forward-only (no graph is built), with an
                          any-alive early exit. The exit test reads one
                          boolean from the device each bounce: a
                          host-device synchronisation per bounce, which is
                          the function's meaning.

RNG: bounce b draws the two raw counter blocks (TAG_BOUNCE + b, j) under
the ray key (ops/rng.py contract v3), so results are independent of
wavefront chunking and of the device.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from ..config import TraceOptions
from ..models.scene import Scene
from . import math3, rng
from .intersect import closest_hit_diff, gather_rows, hit_surface
from .scatter import scatter

SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)  # main.cxx:49; cuda_impl.cu:125


def background_color(direction, options: TraceOptions):
    """Vertical sky gradient mix(white, blue, t).

    t = .5*unit_y + .5 under "cuda" (cuda_impl.cu:293, correct) or
    t = .5*unit_y + 1  under "cpu"  (main.cxx:71, quirk Q6). ``mix`` is
    unclamped in both, as in math.hxx:325-335.
    """
    unit_y = math3.normalize(direction)[..., 1]
    t = 0.5 * unit_y + (0.5 if options.sky == "cuda" else 1.0)
    white = torch.tensor(SKY_WHITE, dtype=torch.float32,
                         device=direction.device)
    blue = torch.tensor(SKY_BLUE, dtype=torch.float32,
                        device=direction.device)
    return math3.mix(white, blue, t[..., None])


def closest_hit_opt(origin, direction, scene: Scene, options: TraceOptions,
                    allow_pallas: bool):
    """Dispatch closest hit. The autograd.Function (analytic O(N)
    backward) serves both the forward-only and the reverse-mode path, so
    options.intersect == "pallas" may select the hand-written kernel even
    under autograd. ``allow_pallas`` is kept for callers that must stay on
    the plain forward (e.g. comparing the two)."""
    use_pallas = allow_pallas and options.intersect == "pallas"
    return closest_hit_diff(origin, direction, scene.centers, scene.radii,
                            options.t_min, options.sphere_block, use_pallas)


def _bounce_step(scene: Scene, options: TraceOptions, state, bounce: int,
                 allow_pallas: bool = False, return_hit: bool = False,
                 strat0=None, rr_qcap: float = 1.0):
    """One wavefront bounce.

    strat0: optional (N, 3) replacement scatter vectors substituted at
    bounce == 0 (rng.strat0_scatter -- the first-bounce half of
    sampling="stratified").

    return_hit=True also returns this bounce's (idx, hit), so a caller
    walking a vertex prefix can classify the visited materials without a
    second closest hit.

    options.gather: the JAX package gathers the winner's parameters
    either by index ("take") or by a one-hot matrix product against a
    per-sphere table ("onehot", there because per-ray gathers are slow on
    a TPU). Both name the same exact gather; the port indexes for both.
    """
    origin, direction, atten, result, alive, rk0, rk1 = state

    t, idx, hit = closest_hit_opt(origin, direction, scene, options,
                                  allow_pallas)

    idx64 = idx.to(torch.int64)
    pos, normal = hit_surface(origin, direction, t, idx, hit,
                              scene.centers, scene.radii)
    mi = scene.material_index.to(torch.int64).index_select(0, idx64)
    mtype = scene.mtype.index_select(0, mi)
    albedo = gather_rows(scene.albedo, mi)
    fuzz = gather_rows(scene.fuzz, mi)
    ior = gather_rows(scene.ior, mi)

    # Per-bounce randomness (ops/rng.py draw-order contract v3): two raw
    # counter blocks under the ray key, tag TAG_BOUNCE + bounce.
    rand_vec, ru = rng.bounce_draws((rk0, rk1), bounce,
                                    options.scatter_sample)
    if strat0 is not None and bounce == 0:
        rand_vec = strat0

    new_dir, alb, valid = scatter(direction, normal, mtype, albedo, fuzz,
                                  ior, rand_vec, ru, options)

    sky = background_color(direction, options)
    miss_now = alive & ~hit
    scatter_now = alive & hit & valid

    result = result + torch.where(miss_now[:, None], atten * sky,
                                  torch.zeros_like(atten))
    atten = torch.where(scatter_now[:, None], atten * alb, atten)
    origin = torch.where(scatter_now[:, None], pos, origin)
    direction = torch.where(scatter_now[:, None], new_dir, direction)

    keep = scatter_now
    if options.rr_terminate:
        # RR path termination: the shared contract (same draw words and
        # update order as the planar AD engine), which is also what makes
        # trace_fast's any-alive exit fire on deep batches.
        ax, ay, az, keep = rng.rr_terminate_update(
            rk0, rk1, bounce, atten[:, 0], atten[:, 1], atten[:, 2], keep,
            rr_start=options.rr_start, rr_qmin=options.rr_qmin,
            rr_scale=options.rr_scale, rr_qcap=rr_qcap)
        atten = torch.stack([ax, ay, az], dim=-1)

    out = (origin, direction, atten, result, keep, rk0, rk1)
    if return_hit:
        return out, (idx, hit)
    return out


def _init_state(origins, directions, ray_keys):
    n = origins.shape[0]
    dev = origins.device
    return (
        origins,
        directions,
        torch.ones((n, 3), dtype=torch.float32, device=dev),  # attenuation
        torch.zeros((n, 3), dtype=torch.float32, device=dev),  # radiance
        torch.ones((n,), dtype=torch.bool, device=dev),  # alive
        *ray_keys,
    )


def trace(scene: Scene, origins, directions, ray_keys, max_depth: int,
          options: TraceOptions, strat0=None):
    """Differentiable fixed-depth trace -> radiance (N, 3).

    ray_keys: the rays' key words (k0, k1), two (N,) tensors. Each bounce
    is rematerialised in backward (torch.utils.checkpoint, non-reentrant):
    only the state between bounces is held, and the closest hit of a
    bounce runs again when its gradient is taken. The forward is the plain
    closest hit, as in the JAX package's ``trace``.
    """
    step = functools.partial(_bounce_step, scene, options, strat0=strat0)
    state = _init_state(origins, directions, ray_keys)
    for bounce in range(max_depth):
        state = checkpoint(step, state, bounce, use_reentrant=False,
                           preserve_rng_state=False)
    return state[3]


@torch.no_grad()
def trace_fast(scene: Scene, origins, directions, ray_keys, max_depth: int,
               options: TraceOptions, strat0=None, rr_qcap: float = 1.0):
    """Forward-only trace with any-alive early exit.

    The same per-step math and RNG as ``trace``, but stops as soon as every
    ray has terminated -- the wavefront analogue of the reference threads'
    early returns -- and may take the hand-written closest-hit kernel
    (options.intersect == "pallas"). rr_qcap < 1 (probe traces): see
    rng.rr_terminate_update.
    """
    state = _init_state(origins, directions, ray_keys)
    for bounce in range(max_depth):
        if not bool(state[4].any()):  # one device->host read per bounce
            break
        state = _bounce_step(scene, options, state, bounce,
                             allow_pallas=True, strat0=strat0,
                             rr_qcap=rr_qcap)
    return state[3]
