"""Regenerative differentiable wavefront: the reverse-mode occupancy fix.

The port's copy of ``raytracinginoneweekend_tpu/ops/wavefront_ad.py``. The
fixed-depth AD engines (ops/integrate.py, ops/integrate_planar.py) run
every lane for ``max_depth`` bounces; at depth 50 most lanes of a bounce
are dead paths. This engine keeps a POOL of L lanes busy instead: a lane
whose path ended takes the next (pixel, sample) ray it owns, in the same
iteration, and the whole loop is differentiable.

  * Lane pool of L = R*128 planar lanes; lane l owns rays l, l+L, 2L, ...
    (strided ownership, no communication between lanes). The (pixel,
    sample) ids of all N rays are laid out wave-major as (W, R, 128)
    planes (W = ceil(N/L), only the last wave padded), and the camera
    rays of all N rays (and, under stratified sampling, their first-bounce
    scatter vectors) are generated ONCE from them up front, as the planar
    engine does. A lane that acquires its next ray reads its ray by INDEX
    into those flat arrays. (The JAX package selects the ids with a W-way
    one-hot, which avoids gathers on a TPU, and generates the camera rays
    of the acquiring lanes every iteration; each ray's values are the same
    elementwise function of its (pixel, sample), so the results are the
    same, and an iteration here saves the hundreds of small launches that
    the camera rays' threefry hashing takes.) The JAX package regenerates
    at the top of an iteration; here the shade op regenerates at its end,
    and one regen runs before the first iteration: the same sequence of
    states, one regen earlier.
  * Radiance deposit: a WAVE-INDEXED LEDGER. Ray (w, lane) has the unique
    cell w*L + lane; only a miss carries radiance (absorb and depth-out
    are black), so a ray deposits at most once, at the iteration it dies,
    and the deposit is a WRITE of the unique cells (``index_copy``; lanes
    that do not deposit write a zero into their own dump cell past the
    ledger). Its backward is the matching read. The JAX package adds a
    one-hot mask over the wave axis instead; onto a zero cell both give
    the same value.
  * The closest hit is ops/integrate_planar.closest_hit_planar: the
    hand-written kernel (csrc/closest_hit.cu) under a
    ``torch.autograd.Function``. The rest of the bounce -- the winner's
    parameters from the differentiable (S, 10) table, the scatter and sky
    math of the planar engine (scatter_planar_ad, shade_geometry_planar),
    the deposit's values and cells -- and the regen of the lanes it left
    idle are ONE op, ops/cuda_ad_shade.ad_shade: a kernel forward and its
    adjoint kernel backward on the card (csrc/ad_shade.cu), the plain
    version under autograd on the CPU; on the card its table gradient sums
    each lane's row by sphere with ``index_add_``, as ``index_select``'s
    backward does. The per-pixel
    mean reduces in the same sample order, so pixels are BIT-invariant to
    pool_size and agree with render_pixels_planar to float32
    reassociation.
  * Iterations run in EPOCHS of ``epoch_len`` under
    ``torch.utils.checkpoint`` (non-reentrant): backward memory is
    O(state * epochs) plus the kernel's three output planes per iteration,
    which are kept OUTSIDE the checkpoint (recorded on the first run,
    replayed when backward recomputes the epoch; ``_HitTape``), so the
    backward never launches the kernel. The JAX package skips drained
    epochs with ``lax.cond``; here the loop is eager and stops once the
    pool has drained, with one device->host read per epoch. Both test the
    state before its regen (the op's ``busy``): a lane whose next ray is
    in the last wave's pad counts until the regen parks it.
  * A tuned flat budget (``iters``) runs exactly that many iterations with
    no host read: ``remat="none"`` keeps every intermediate,
    ``remat="step"`` checkpoints each iteration, ``"auto"`` picks by the
    JAX package's memory estimate. Rays not finished within the budget
    are dropped (black): validate a budget with ``wavefront_ad_done``.

Nothing here writes in place into a tensor that autograd saved.
RNG discipline is ops/rng.py's (pixel, sample, tag) contract.
"""

from __future__ import annotations

import functools
import warnings

import torch
from torch.utils.checkpoint import checkpoint

from ..config import TraceOptions
from ..models.camera import Camera
from ..models.scene import Scene
from ..utils.timing import span
from . import cuda_ad_shade, planar
from .integrate_planar import _material_table, _pick_rows, closest_hit_planar

LANES = 128

EPOCH_LEN = 16  # inner bounces per rematerialised epoch

# Lane-state tuple layout (all (R, 128) planes):
#   0 nxtw  (i32)  next wave index this lane may acquire
#   1 wcur  (i32)  wave index of the task in flight
#   2 active (bool)
#   3..8  ox oy oz dx dy dz
#   9..11 ax ay az
#   12 depth (i32)
#   13 k0  14 k1  (per-ray threefry key words, i32 bit patterns)

# Rough per-(lane, iteration) residual footprint of an iteration that is
# not rematerialised (kernel outputs, gathered params, the scatter chain):
# sizes the remat="auto" choice. The JAX package's values.
_RES_BYTES_PER_LANE_ITER = 260
_NOREMAT_CAP_BYTES = 1536 << 20


class _HitTape:
    """The closest hit's outputs of one checkpointed region, in call order:
    recorded (detached) on its first run, replayed when backward
    recomputes the region, so the kernel runs once per iteration."""

    def __init__(self):
        self.hits = []
        self.pos = 0

    def closest_hit(self, rays, geom, t_min):
        known = self.hits[self.pos] if self.pos < len(self.hits) else None
        out = closest_hit_planar(rays, geom, t_min, known=known)
        if known is None:
            self.hits.append(tuple(x.detach() for x in out))
        self.pos += 1
        return out


def _ray_tables(pid_flat, sid_flat, cam: Camera, base_words, *,
                width: int, height: int, camera_mode: str,
                options: TraceOptions, spp: int) -> cuda_ad_shade.RayTables:
    """Every ray's camera ray and key words (and, under stratified
    sampling, its first-bounce scatter vector), in the wave-major ray
    order: what a lane that acquires a ray reads it from."""
    pid, sid = pid_flat[None, :], sid_flat[None, :]
    planes = planar.camera_rays(cam, pid, sid, base_words, width, height,
                                camera_mode, sampling=options.sampling,
                                spp=spp)
    floats = list(planes[:6])
    if options.sampling == "stratified":
        floats += planar.strat0_scatter_planes(
            planes[6], planes[7], pid, sid, base_words, spp,
            options.scatter_sample == "unit")
    return cuda_ad_shade.RayTables(torch.cat(floats), torch.cat(planes[6:8]))


def _shade_deposit(table, rays, spec: cuda_ad_shade.Spec, state, khit,
                   ledger):
    """One pool iteration downstream of the kernel: the bounce, the ledger
    deposit on a miss and the regen, -> (state, ledger, busy).

    table: ``_material_table(scene)``; rays: the ``_ray_tables``; ledger:
    (3, W*L + L) f32, the wave cells then one dump cell per lane. The
    bounce and the regen are one op (ops/cuda_ad_shade.ad_shade: one
    kernel forward, one backward on the card); the ledger write stays out
    of place, as the checkpoint needs.
    """
    state, deposit, cell, busy = cuda_ad_shade.ad_shade(
        table, state, khit, rays, spec)
    return state, torch.index_copy(ledger, 1, cell, deposit), busy


def trace_wavefront_ad(scene: Scene, cam: Camera, pid_waves, sid_waves,
                       base_key, *, width: int, height: int, spp: int,
                       max_depth: int, camera_mode: str,
                       options: TraceOptions, n: int,
                       epoch_len: int = EPOCH_LEN,
                       iters: int | None = None, remat: str = "auto",
                       return_done: bool = False):
    """Run the regenerative pool -> ledger planes ((W, R, 128) r, g, b).

    pid_waves/sid_waves: (W, R, 128) i32 ray-id planes (wave-major flat
    ray order); n: true ray count (the tail of the last wave is pad);
    base_key: the (k0, k1) base-key words. (The JAX package's ``rows``, its
    kernel's block height, has no counterpart: a CUDA launch takes any R.)

    iters: bounce-iteration budget.
      * None (default) = run until the pool drains (at most the
        guaranteed-complete W * max_depth iterations), in epochs of
        ``epoch_len`` under torch.utils.checkpoint, one device->host read
        per epoch.
      * an int = a TUNED budget run flat, with no host read: rays not
        finished within it are dropped from the ledger (black); validate
        it with ``wavefront_ad_done``.

    remat (flat mode only): "step" = checkpoint per iteration; "none" = no
    checkpoint (backward keeps every intermediate, ~_RES_BYTES_PER_LANE_ITER
    bytes a lane and iteration, and replays nothing); "auto" = "none" when
    that estimate fits _NOREMAT_CAP_BYTES, else "step".

    return_done: also return (done, iterations): done is True iff every
    ray completed within the budget (the pool drained); iterations is the
    budget run (epoch mode: the worked epochs times epoch_len, the exact
    flat budget that completes this batch at epoch granularity).
    """
    if remat not in ("auto", "none", "step"):
        raise ValueError(f"unknown remat mode: {remat!r}")
    if epoch_len < 1:
        raise ValueError(f"epoch_len must be positive, got {epoch_len}")
    w, r_rows, _ = pid_waves.shape
    lanes = r_rows * LANES
    device = pid_waves.device
    geom = (scene.centers, scene.radii)
    table = _material_table(scene)
    base_words = tuple(int(x) for x in base_key)
    rays_all = _ray_tables(pid_waves.reshape(-1), sid_waves.reshape(-1), cam,
                           base_words, width=width, height=height,
                           camera_mode=camera_mode, options=options, spp=spp)
    shade = functools.partial(
        _shade_deposit, table, rays_all,
        cuda_ad_shade.Spec(max_depth, options, w * lanes, n))

    def run(state, ledger, n_iters: int, tape):
        """``n_iters`` pool iterations: closest hit -> shade, deposit and
        regen -> (state, ledger, busy). The backward runs a checkpointed
        call again (inside the autograd engine's graph task), and is
        spanned apart."""
        if tape is not None:
            tape.pos = 0
        recompute = torch._C._current_graph_task_id() != -1
        with span("rtw.ad.recompute" if recompute else "rtw.ad.epoch"):
            for _ in range(n_iters):
                rays = state[3:9]
                khit = (tape.closest_hit(rays, geom, options.t_min)
                        if tape is not None
                        else closest_hit_planar(rays, geom, options.t_min))
                with span("rtw.ad.shade"):
                    state, ledger, busy = shade(state, khit, ledger)
        return state, ledger, busy

    def checkpointed(state, ledger, n_iters: int):
        fn = functools.partial(run, n_iters=n_iters, tape=_HitTape())
        return checkpoint(fn, state, ledger, use_reentrant=False,
                          preserve_rng_state=False)

    shape = (r_rows, LANES)
    zero = torch.zeros(shape, dtype=torch.float32, device=device)
    izero = torch.zeros(shape, dtype=torch.int32, device=device)
    state = (izero, izero, torch.zeros(shape, dtype=torch.bool,
                                       device=device),
             zero, zero, zero, zero + 1.0, zero, zero,
             zero, zero, zero, izero, izero, izero)
    ledger = torch.zeros((3, w * lanes + lanes), dtype=torch.float32,
                         device=device)
    # The first iteration's regen; every later one is the shade op's.
    state, busy = cuda_ad_shade.regen_reference(state, rays_all, n=n, w=w)

    def work_left(busy) -> bool:
        """Before the latest regen, was any lane tracing, or any lane left
        with unacquired rays (lanes out of rays park nxtw at W)? One
        device->host read."""
        return bool(busy.any().item())

    if iters is None:
        n_epochs = -(-(w * max_depth) // epoch_len)
        n_active = 0
        for _ in range(n_epochs):
            if not work_left(busy):
                break
            state, ledger, busy = checkpointed(state, ledger, epoch_len)
            n_active += epoch_len
    else:
        if remat == "auto":
            remat = ("none" if iters * lanes * _RES_BYTES_PER_LANE_ITER
                     <= _NOREMAT_CAP_BYTES else "step")
        for _ in range(iters):
            if remat == "none":
                state, ledger, busy = run(state, ledger, 1, None)
            else:
                state, ledger, busy = checkpointed(state, ledger, 1)
        n_active = iters

    out = tuple(ledger[c, :w * lanes].reshape(w, r_rows, LANES)
                for c in range(3))
    if return_done:
        return out, (not work_left(busy), n_active)
    return out


def _wave_layout(pixel_ids, spp: int, pool_size: int):
    """(pid_waves, sid_waves, rows, n): the engine's wave-major ray layout
    -- the ONE definition of the ray ordering and padding (ray-major
    pixel*spp + sample, pool rounded to the JAX package's kernel block
    multiple and capped at the ray count, only the LAST wave padded).
    Shared by the renderer and the budget prober."""
    dev = pixel_ids.device
    p = pixel_ids.shape[0]
    n = p * spp
    rows = _pick_rows(min(n, pool_size))
    blk = rows * LANES
    lanes = min(pool_size, n)
    lanes = -(-lanes // blk) * blk
    r_rows = lanes // LANES
    w = -(-n // lanes)

    pid_flat = torch.repeat_interleave(pixel_ids.to(torch.int32), spp)
    sid_flat = torch.arange(spp, dtype=torch.int32, device=dev).repeat(p)
    pad = w * lanes - n
    if pad:
        zpad = torch.zeros(pad, dtype=torch.int32, device=dev)
        pid_flat = torch.cat([pid_flat, zpad])
        sid_flat = torch.cat([sid_flat, zpad])
    return (pid_flat.reshape(w, r_rows, LANES),
            sid_flat.reshape(w, r_rows, LANES), rows, n)


def render_pixels_wavefront_ad_impl(scene: Scene, cam: Camera, pixel_ids,
                                    base_key, *, width: int, height: int,
                                    spp: int, max_depth: int,
                                    camera_mode: str, options: TraceOptions,
                                    pool_size: int = 1 << 15,
                                    epoch_len: int = EPOCH_LEN,
                                    iters: int | None = None,
                                    remat: str = "auto",
                                    differentiable: bool = True,
                                    debug_check_complete: bool = False):
    """Render a flat pixel chunk -> (P, 3) linear radiance means.

    Drop-in for integrate_planar.render_pixels_planar_impl (same ray
    order, the same pixels up to float32 reassociation) with wavefront
    occupancy in forward and backward. pixel_ids: a (P,) i32 tensor on the
    device to render on; base_key: the (k0, k1) base-key words.
    pool_size: requested lane count (rounded to the JAX package's block
    multiple, capped at the ray count); epoch_len, iters, remat: see
    ``trace_wavefront_ad``.

    With a TUNED integer ``iters`` budget, rays not finished within it
    render BLACK with no error. ``debug_check_complete=True`` runs the
    done check (a second, forward-only pass) and warns when the budget
    dropped rays.
    """
    del differentiable  # the pool is always the autograd-safe engine
    p = pixel_ids.shape[0]
    pid_waves, sid_waves, _rows, n = _wave_layout(pixel_ids, spp, pool_size)
    kw = dict(width=width, height=height, spp=spp, max_depth=max_depth,
              camera_mode=camera_mode, options=options, n=n)
    lr, lg, lb = trace_wavefront_ad(
        scene, cam, pid_waves, sid_waves, base_key, epoch_len=epoch_len,
        iters=iters, remat=remat, **kw)

    if debug_check_complete and iters is not None:
        with torch.no_grad():
            _, (done, _need) = trace_wavefront_ad(
                scene, cam, pid_waves, sid_waves, base_key, iters=iters,
                remat="none", return_done=True, **kw)
        if not done:
            warnings.warn(
                f"wavefront_ad: iteration budget {iters} TRUNCATED rays of "
                "this batch -- dropped rays render black; re-probe with "
                "wavefront_ad_budget and pad by whole epochs", stacklevel=2)

    def reduce(ch):
        flat = ch.reshape(-1)[:n]
        return flat.reshape(p, spp).sum(dim=1) / float(spp)

    return torch.stack([reduce(lr), reduce(lg), reduce(lb)], dim=-1)


# The JAX package jits the impl under this name; PyTorch runs eagerly.
render_pixels_wavefront_ad = render_pixels_wavefront_ad_impl


def _probe(scene: Scene, cam: Camera, pixel_ids, base_key, *, width: int,
           height: int, spp: int, max_depth: int, camera_mode: str,
           options: TraceOptions, pool_size: int = 1 << 15,
           iters: int | None, epoch_len: int = EPOCH_LEN):
    pid_waves, sid_waves, _rows, n = _wave_layout(pixel_ids, spp, pool_size)
    with torch.no_grad():
        _, aux = trace_wavefront_ad(
            scene, cam, pid_waves, sid_waves, base_key, width=width,
            height=height, spp=spp, max_depth=max_depth,
            camera_mode=camera_mode, options=options, n=n,
            epoch_len=epoch_len, iters=iters, remat="none",
            return_done=True)
    return aux


def wavefront_ad_done(scene, cam, pixel_ids, base_key, *, iters: int,
                      **kw) -> bool:
    """Forward-only budget validator: True iff every ray of this batch
    completes within ``iters`` pool iterations."""
    return _probe(scene, cam, pixel_ids, base_key, iters=iters, **kw)[0]


def wavefront_ad_budget(scene, cam, pixel_ids, base_key, **kw) -> int:
    """The flat-scan iteration budget that completes this batch: one
    forward run to the drain, counting worked epochs (a contiguous
    prefix, so the count is the budget at epoch_len granularity). Pad by
    a couple of epochs before reusing it across step keys."""
    done, n_active = _probe(scene, cam, pixel_ids, base_key, iters=None,
                            **kw)
    if not done:
        raise RuntimeError("wavefront_ad_budget: the pool did not drain "
                           "within W * max_depth iterations")
    return int(n_active)
