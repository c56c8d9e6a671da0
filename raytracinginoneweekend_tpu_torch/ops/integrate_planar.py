"""Planar (R, 128) differentiable integrator: the fast AD engine.

The port's copy of ``raytracinginoneweekend_tpu/ops/integrate_planar.py``:
the wavefront engine's PLANAR formulation made reverse-mode differentiable.

  * ray state is (R, 128) planes end to end (camera generation included,
    ops/planar.py);
  * closest hit is the forward-only hand-written kernel
    (ops/cuda_segment.segment_closest_hit -> csrc/closest_hit.cu; its plain
    version on CPU tensors) under a ``torch.autograd.Function`` whose
    backward is the analytic implicit-function formula of
    ops/intersect.closest_hit_diff, in plain PyTorch -- O(N) elementwise
    plus one (N,) -> (S,) sum, and the kernel is never differentiated;
  * per-ray sphere/material parameters are ONE gather of a
    differentiable (S, 10) table (``intersect.gather_rows``); its backward
    sums the rows into the table's gradient in float64
    (``intersect.sum_by_winner``). (The JAX package computes
    this gather as a one-hot matrix product because per-ray gathers are
    slow on a TPU; the values are the same.)
  * the scatter/material math is the wavefront engine's planar code with
    autograd-safe double-where guards (sqrt/divide never see a value whose
    backward would be inf on a masked lane);
  * each bounce's shade step is rematerialised in backward
    (torch.utils.checkpoint, non-reentrant) while the kernel's three output
    planes are kept OUTSIDE the checkpoint, so backward memory is
    O(R*128) per bounce for the state and the backward never launches the
    kernel again.

Nothing here writes in place into a tensor that autograd saved: every
state update is a ``torch.where`` into a new plane.

RNG discipline is EXACTLY ops/rng.py's contract v3, so radiance agrees
per ray with the tiled engine and the wavefront engine.

Semantics parity (reference): hit -> scatter -> attenuation *= albedo;
metal absorb -> black; miss -> sky * attenuation; depth exhausted -> black
(main.cxx:52-75, cuda_impl.cu:265-297).
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from ..config import TraceOptions
from ..models.camera import Camera
from ..models.scene import DIELECTRIC, METAL, Scene
from . import planar, rng
from .cuda_segment import segment_closest_hit
from .intersect import gather_rows, sum_by_winner
from .math3 import sqrt_rn

LANES = 128
SKY_WHITE = planar.SKY_WHITE
SKY_BLUE = planar.SKY_BLUE  # main.cxx:49; cuda_impl.cu:125


# ---------------------------------------------------------------------------
# Planar closest hit with analytic backward (autograd.Function on the kernel)
# ---------------------------------------------------------------------------

class _ClosestHitPlanar(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ox, oy, oz, dx, dy, dz, centers, radii, t_min, known):
        if known is not None:
            t, sb, hit_i = known
        else:
            with torch.no_grad():
                cx, cy, cz = (centers[:, k].contiguous() for k in range(3))
                rays = tuple(p.contiguous()
                             for p in (ox, oy, oz, dx, dy, dz))
                hit_i, t, sb = segment_closest_hit(rays, cx, cy, cz,
                                                   radii.contiguous(), t_min)
        ctx.save_for_backward(ox, oy, oz, dx, dy, dz, centers, radii, t, sb,
                              hit_i)
        ctx.mark_non_differentiable(sb, hit_i)
        return t, sb, hit_i

    @staticmethod
    def backward(ctx, g_t, _g_sb, _g_hit):
        ox, oy, oz, dx, dy, dz, centers, radii, t, sb, hit_i = \
            ctx.saved_tensors
        hit = hit_i > 0
        shape = ox.shape
        sb64 = sb.reshape(-1).to(torch.int64)

        # Winning sphere's center/radius: a plain gather.
        ctab = torch.cat([centers, radii[:, None]], dim=1)  # (S, 4)
        p4 = ctab.index_select(0, sb64)

        def col(i):
            return p4[:, i].reshape(shape)

        chx, chy, chz, rh = col(0), col(1), col(2), col(3)
        one = torch.ones_like(t)
        t_safe = torch.where(hit, t, one)
        pcx = ox + t_safe * dx - chx
        pcy = oy + t_safe * dy - chy
        pcz = oz + t_safe * dz - chz
        denom = pcx * dx + pcy * dy + pcz * dz  # (p-c).d
        # Grazing hits (denom -> 0) have unbounded dt; zero them like the
        # sanitized no-hit lanes (standard for silhouette-adjacent samples).
        good = hit & (denom.abs() > 1e-12)
        scale = torch.where(good, g_t / torch.where(good, denom, one),
                            torch.zeros_like(g_t))

        gcx, gcy, gcz = scale * pcx, scale * pcy, scale * pcz  # dt/dc rows
        g_r_rows = scale * rh  # dt/dr = r/denom
        g_centers = g_radii = None
        if ctx.needs_input_grad[6] or ctx.needs_input_grad[7]:
            # Per-sphere accumulation: (N, 4) rows summed by winner index.
            # Rows with scale = 0 (no hit / grazing) add nothing wherever
            # their sb points.
            g4 = torch.stack([gcx.reshape(-1), gcy.reshape(-1),
                              gcz.reshape(-1), g_r_rows.reshape(-1)], dim=-1)
            acc = sum_by_winner(sb64, g4, centers.shape[0])
            g_centers, g_radii = acc[:, :3], acc[:, 3]
        return (-gcx, -gcy, -gcz, -t_safe * gcx, -t_safe * gcy,
                -t_safe * gcz, g_centers, g_radii, None, None)


def closest_hit_planar(rays, geom, t_min, known=None):
    """Closest hit over planar rays via the hand-written kernel.

    rays: 6-tuple of (R, 128) f32 planes (ox oy oz dx dy dz); geom:
    (centers (S, 3), radii (S,)) -- the differentiable leaves; t_min:
    static. (The JAX package's fourth argument, the kernel's block height,
    has no counterpart: a CUDA launch takes any R.) known: the (t,
    sphere_idx, hit_i) this call returned when it first ran on the same
    rays, detached; given, the kernel is not launched again (a
    checkpointed region that replays its forward, ops/wavefront_ad.py).
    Returns (t, sphere_idx, hit_i): (R, 128) planes (f32, i32, i32).

    Backward: implicit differentiation of the winning sphere's quadratic
    F = |o + t d - c|^2 - r^2 = 0 (see ops/intersect.closest_hit_diff) --
    dt = [(p-c).dc + r dr - (p-c).do - t (p-c).dd] / ((p-c).d).
    """
    centers, radii = geom
    return _ClosestHitPlanar.apply(*rays, centers, radii, float(t_min),
                                   known)


# ---------------------------------------------------------------------------
# One differentiable planar bounce
# ---------------------------------------------------------------------------

def _material_table(scene: Scene) -> torch.Tensor:
    """Differentiable per-sphere (S, 10) parameter table:
    [cx cy cz r mtype ar ag ab fuzz ior] (only (S,)-sized gathers)."""
    mi = scene.material_index.to(torch.int64)
    return torch.cat([
        scene.centers,
        scene.radii[:, None],
        scene.mtype[mi].to(torch.float32)[:, None],
        scene.albedo[mi],
        scene.fuzz[mi][:, None],
        scene.ior[mi][:, None],
    ], dim=1)


def shade_geometry_planar(state6, khit, params_cols):
    """Hit position + outward normal from the gathered winner.

    state6: (ox..dz) planes; params_cols: (chx, chy, chz, rh) winner
    geometry columns."""
    ox, oy, oz, dx, dy, dz = state6
    t, _sb, hit_i = khit
    hit = hit_i > 0
    chx, chy, chz, rh = params_cols
    one = torch.ones_like(t)
    t_safe = torch.where(hit, t, one)
    px = ox + t_safe * dx
    py = oy + t_safe * dy
    pz = oz + t_safe * dz
    r_safe = torch.where(hit, rh, one)
    inv_r = 1.0 / torch.where(r_safe != 0.0, r_safe, one)
    nx = (px - chx) * inv_r
    ny = (py - chy) * inv_r
    nz = (pz - chz) * inv_r
    return hit, px, py, pz, nx, ny, nz


def scatter_planar_ad(dirs, normals, mats, draws, options: TraceOptions):
    """The per-material scatter math with autograd-safe double-where
    guards.

    dirs: (dx, dy, dz); normals: (nx, ny, nz); mats: (mt, fz, io);
    draws: (rvx, rvy, rvz, ru) from planar.bounce_draws. Returns
    (ndx, ndy, ndz, valid, uy) with uy the unit-direction y (for the sky
    term). Semantics: lambert cuda_impl.cu:204-213, metal :216-229,
    dielectric :232-262 (Schlick + TIR)."""
    dx, dy, dz = dirs
    nx, ny, nz = normals
    mt, fz, io = mats
    rvx, rvy, rvz, ru = draws

    ux, uy, uz = planar.normalize3(dx, dy, dz)

    # lambert (cuda_impl.cu:204-213)
    ldx, ldy, ldz = nx + rvx, ny + rvy, nz + rvz
    # metal (cuda_impl.cu:216-229)
    du = ux * nx + uy * ny + uz * nz
    rfx = ux - 2.0 * du * nx
    rfy = uy - 2.0 * du * ny
    rfz = uz - 2.0 * du * nz
    mdx, mdy, mdz = rfx + rvx * fz, rfy + rvy * fz, rfz + rvz * fz
    metal_ok = (mdx * nx + mdy * ny + mdz * nz) > 0.0
    # dielectric (cuda_impl.cu:232-262) with autograd-safe sqrt guards
    cos = du
    entering = cos <= 0.0
    one = torch.ones_like(cos)
    zero = torch.zeros_like(cos)
    sgn = torch.where(entering, one, -one)
    owx, owy, owz = nx * sgn, ny * sgn, nz * sgn
    ri = torch.where(entering, 1.0 / torch.where(io != 0.0, io, one), io)
    cosab = torch.abs(cos)
    cos_i = owx * ux + owy * uy + owz * uz
    kk = 1.0 - ri * ri * (1.0 - cos_i * cos_i)
    pos = kk > 0.0
    # double-where: sqrt never sees <=0, so its backward never sees inf
    sq = torch.where(pos, sqrt_rn(torch.where(pos, kk, one)), zero)
    tir = kk < 0.0
    if options.refract == "physical":
        tx = ri * ux - (ri * cos_i + sq) * owx
        ty = ri * uy - (ri * cos_i + sq) * owy
        tz = ri * uz - (ri * cos_i + sq) * owz
    else:
        # math.hxx:304-308: dot*eta broadcast-added per component.
        tx = ux * ri - (owx * sq + cos_i * ri)
        ty = uy * ri - (owy * sq + cos_i * ri)
        tz = uz * ri - (owz * sq + cos_i * ri)
    tx = torch.where(tir, zero, tx)
    ty = torch.where(tir, zero, ty)
    tz = torch.where(tir, zero, tz)
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    c1 = 1.0 - cosab
    c2 = c1 * c1
    schlick = r0 + (1.0 - r0) * (c1 * (c2 * c2))
    prob = torch.where(tir, one, schlick)
    refl = ru < prob
    gdx = torch.where(refl, rfx, tx)
    gdy = torch.where(refl, rfy, ty)
    gdz = torch.where(refl, rfz, tz)

    is_metal = mt == METAL
    is_diel = mt == DIELECTRIC
    ndx = torch.where(is_diel, gdx, torch.where(is_metal, mdx, ldx))
    ndy = torch.where(is_diel, gdy, torch.where(is_metal, mdy, ldy))
    ndz = torch.where(is_diel, gdz, torch.where(is_metal, mdz, ldz))
    valid = metal_ok | ~is_metal
    return ndx, ndy, ndz, valid, uy


def _shade_step_planar(table: torch.Tensor, options: TraceOptions, state,
                       khit, bounce: int, strat0=None):
    """Everything in a bounce downstream of the closest-hit kernel.

    table: ``_material_table(scene)``, made once per trace (its gradient
    carries the scene leaves'). strat0: optional (svx, svy, svz)
    replacement planes (planar.strat0_scatter_planes) substituted at
    bounce == 0 -- the first-bounce half of sampling="stratified".
    """
    (ox, oy, oz, dx, dy, dz, ax, ay, az, resr, resg, resb, alive,
     rk0, rk1) = state
    shape = ox.shape

    t, sb, hit_i = khit

    # Gather of the winning sphere's geometry + material. The index is a
    # piecewise-constant function of the scene (no gradient); the TABLE
    # carries the scene-leaf gradients (sum_by_winner in backward).
    params = gather_rows(table, sb.reshape(-1).to(torch.int64))

    def col(i):
        return params[:, i].reshape(shape)

    mt = col(4).to(torch.int32)
    alr, alg, alb_ = col(5), col(6), col(7)
    fz, io = col(8), col(9)

    hit, px, py, pz, nx, ny, nz = shade_geometry_planar(
        (ox, oy, oz, dx, dy, dz), khit, (col(0), col(1), col(2), col(3)))

    # Per-bounce randomness (ops/rng.py draw-order contract v3).
    rvx, rvy, rvz, ru = planar.bounce_draws(
        rk0, rk1, bounce, options.scatter_sample == "unit")
    if strat0 is not None and bounce == 0:
        rvx, rvy, rvz = strat0

    ndx, ndy, ndz, valid, uy = scatter_planar_ad(
        (dx, dy, dz), (nx, ny, nz), (mt, fz, io), (rvx, rvy, rvz, ru),
        options)

    miss_now = alive & ~hit
    scatter_now = alive & hit & valid

    # sky (cuda_impl.cu:123-126 / main.cxx:47-50), unclamped mix
    sky_bias = 0.5 if options.sky == "cuda" else 1.0
    tsky = 0.5 * uy + sky_bias
    miss_f = miss_now.to(torch.float32)
    resr = resr + miss_f * ax * (SKY_WHITE[0] * (1.0 - tsky)
                                 + SKY_BLUE[0] * tsky)
    resg = resg + miss_f * ay * (SKY_WHITE[1] * (1.0 - tsky)
                                 + SKY_BLUE[1] * tsky)
    resb = resb + miss_f * az * (SKY_WHITE[2] * (1.0 - tsky)
                                 + SKY_BLUE[2] * tsky)

    ox = torch.where(scatter_now, px, ox)
    oy = torch.where(scatter_now, py, oy)
    oz = torch.where(scatter_now, pz, oz)
    dx = torch.where(scatter_now, ndx, dx)
    dy = torch.where(scatter_now, ndy, dy)
    dz = torch.where(scatter_now, ndz, dz)
    ax = torch.where(scatter_now, ax * alr, ax)
    ay = torch.where(scatter_now, ay * alg, ay)
    az = torch.where(scatter_now, az * alb_, az)
    keep = scatter_now
    if options.rr_terminate:
        # RR path termination under autograd: the shared contract with
        # survival weights held constant (rng.rr_terminate_update; a
        # killed lane saves no time here -- fixed trip count -- the point
        # is estimator parity with the wavefront engines).
        ax, ay, az, keep = rng.rr_terminate_update(
            rk0, rk1, bounce, ax, ay, az, keep,
            rr_start=options.rr_start, rr_qmin=options.rr_qmin,
            rr_scale=options.rr_scale)
    return (ox, oy, oz, dx, dy, dz, ax, ay, az, resr, resg, resb,
            keep, rk0, rk1)


def trace_planar(scene: Scene, rays, rkey_words, max_depth: int,
                 options: TraceOptions, strat0=None):
    """Differentiable fixed-depth planar trace -> (resr, resg, resb) planes.

    rays: 6-tuple of (R, 128) planes; rkey_words: (k0, k1) per-ray
    key-word planes (int32 bit patterns, ops/planar.camera_rays).

    The shade step is rematerialised for backward, but the closest hit
    stays OUTSIDE the checkpoint: its three (R, 128) output planes per
    bounce are saved as inputs of the checkpointed step, so the backward
    pass never launches the kernel again (max_depth launches per trace,
    forward and backward together).
    """
    shape = rays[0].shape
    dev = rays[0].device
    zero = torch.zeros(shape, dtype=torch.float32, device=dev)
    one = torch.ones(shape, dtype=torch.float32, device=dev)
    state = (*rays, one, one, one, zero, zero, zero,
             torch.ones(shape, dtype=torch.bool, device=dev), *rkey_words)
    table = _material_table(scene)
    shade = functools.partial(_shade_step_planar, table, options,
                              strat0=strat0)
    geom = (scene.centers, scene.radii)
    for bounce in range(max_depth):
        khit = closest_hit_planar(state[:6], geom, options.t_min)
        state = checkpoint(shade, state, khit, bounce, use_reentrant=False,
                           preserve_rng_state=False)
    return state[9], state[10], state[11]


# ---------------------------------------------------------------------------
# Pixel-chunk renderer (the planar drop-in for render.render_pixels_impl)
# ---------------------------------------------------------------------------

def _pick_rows(n_lanes_min: int) -> int:
    """Rows of 128 lanes the ray count is padded to a multiple of: the JAX
    package's kernel block heights (64 for big batches, 8 for tiny ones),
    kept so that both packages trace the same padded wavefront."""
    for rows in (64, 8):
        if n_lanes_min >= rows * LANES:
            return rows
    return 8


def render_pixels_planar_impl(scene: Scene, cam: Camera, pixel_ids,
                              base_key, *, width: int, height: int,
                              spp: int, max_depth: int, camera_mode: str,
                              options: TraceOptions,
                              differentiable: bool = True,
                              sample_offset: int = 0,
                              spp_strata: int = 0):
    """Render a flat chunk of pixels -> (P, 3) linear radiance means.

    Signature-compatible with render.render_pixels_impl (wave_spp is
    implicit: the whole P*spp wavefront is one planar wave). pixel_ids: a
    (P,) i32 tensor on the device to render on; base_key: the (k0, k1)
    base-key words. Rays are laid out ray-major (pixel*spp + sample),
    padded to the (rows*128) layout multiple, and masked out of the pixel
    reduction.

    sample_offset: render sample ids [offset, offset+spp) instead of
    [0, spp) -- the RNG contract keys on (pixel, sample), so offset ranges
    draw fresh, reproducible samples.

    spp_strata (stratified only; 0 = spp): the STRATA DENOMINATOR when
    this call renders a sub-window of a larger stratified sample set: the
    remaps derive each sample's stratum from its absolute sid against this
    total. The window must lie inside the strata set; with sampling="iid"
    it is ignored.
    """
    del differentiable  # the planar engine is always the autograd-safe one
    strata = spp_strata or spp
    if options.sampling != "iid" and sample_offset + spp > strata:
        raise ValueError(
            "stratified sample window [%d, %d) exceeds the strata set "
            "[0, %d); pass spp_strata or sampling='iid'"
            % (sample_offset, sample_offset + spp, strata))
    dev = pixel_ids.device
    p = pixel_ids.shape[0]
    n = p * spp
    blk = _pick_rows(n) * LANES
    n_pad = -(-n // blk) * blk
    r_total = n_pad // LANES

    pid_flat = torch.repeat_interleave(pixel_ids.to(torch.int32), spp)
    sid_flat = torch.arange(sample_offset, sample_offset + spp,
                            dtype=torch.int32, device=dev).repeat(p)
    pad = n_pad - n
    if pad:
        zpad = torch.zeros(pad, dtype=torch.int32, device=dev)
        pid_flat = torch.cat([pid_flat, zpad])
        sid_flat = torch.cat([sid_flat, zpad])
    pid = pid_flat.reshape(r_total, LANES)
    sid = sid_flat.reshape(r_total, LANES)

    ox, oy, oz, dx, dy, dz, rk0, rk1 = planar.camera_rays(
        cam, pid, sid, base_key, width, height, camera_mode,
        sampling=options.sampling, spp=strata)
    strat0 = None
    if options.sampling == "stratified":
        # First-bounce stratified scatter: the rays are fixed, so the
        # replacement planes are computed once here.
        strat0 = planar.strat0_scatter_planes(
            rk0, rk1, pid, sid, base_key, strata,
            options.scatter_sample == "unit")
    resr, resg, resb = trace_planar(
        scene, (ox, oy, oz, dx, dy, dz), (rk0, rk1), max_depth, options,
        strat0=strat0)

    def reduce(plane):
        flat = plane.reshape(-1)[:n]
        return flat.reshape(p, spp).sum(dim=1) / float(spp)

    return torch.stack([reduce(resr), reduce(resg), reduce(resb)], dim=-1)


# The JAX package jits the impl under this name; PyTorch runs eagerly.
render_pixels_planar = render_pixels_planar_impl
