"""Fused shade+regen: the wavefront engine's whole per-lane tier in one
kernel per iteration -- CUDA kernel wrapper and plain version.

Counterpart of ``raytracinginoneweekend_tpu/ops/pallas_fused.py``.

  iteration = closest-hit kernel (ops/cuda_segment.py)
              -> [THIS KERNEL: winner lookup + surface math + RNG draws +
                  material scatter + state update + task regeneration +
                  camera rays for re-issued lanes]

The loop body is ROTATED against a regen-then-trace order: the kernel
shades the segment that was just traced, then immediately regenerates dead
lanes for the NEXT iteration; a one-time prologue (``regen``) issues the
initial rays. Per-ray semantics do not depend on the rotation (the RNG
contract keys every draw by (pixel, sample, bounce), not by iteration).

KERNEL NOTE. ``shade_regen`` on CUDA tensors launches
``csrc/shade_regen.cu``, which replaces the Pallas TPU kernel
``pallas_fused.py::_kernel_shade_regen``. It is bound by bytes (3 input
planes + 19+4*n_slots state planes read, 19+4*n_slots written, per lane);
the design is one thread per lane over plane-per-quantity arrays
(coalesced), all reads before all writes so the state is updated IN PLACE,
and the winner's ten parameters are indexed straight from the (S, 10)
table instead of being resolved by a separate pass (see the source's
header). ``shade_regen_reference`` is its plain PyTorch version, composed
of the package's one copy of the shade math (ops/planar.bounce_planar),
the Russian-roulette contract (ops/rng.rr_terminate_update) and ``regen``.

For a tensor on the CPU the wrapper runs the plain version; for a CUDA
tensor it launches the kernel or raises -- it never falls back.

LANE STATE (the JAX package's layout, ops/wavefront.py): 19 base planes,
then 4 per pending slot, each (R, 128):
    0 nxt   1 task   2 sid   3 active        (i32; active is 0/1)
    4..9  ox oy oz dx dy dz                  (f32)
    10..12 ax ay az    13 depth              (f32, i32)
    14..16 accr accg accb                    (f32)
    17 k0  18 k1   per-ray threefry key words (i32 BIT PATTERNS)
    19+4j .. 22+4j: slot j = (pt, pr, pg, pb); pt = finished TASK id,
                    -1 = free.               (i32, f32, f32, f32)
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..models.camera import Camera
from . import cull
from . import planar
from . import rng
from . import threefry as tf
from .cuda_segment import (LANES, check_current_device, resolve_params,
                           surface_from_params)

N_BASE = 19  # must match ops/wavefront.py's lane-state layout
ACT = 3      # index of the `active` plane within the state
MAX_SLOTS = 4  # csrc/shade_regen.cu SR_MAX_SLOTS
CAMERA_MODES = {"cuda": 0, "pinhole": 1, "cpu": 2, "thinlens": 3}

_I32, _F32 = torch.int32, torch.float32
_BASE_DTYPES = ([_I32] * 4 + [_F32] * 9 + [_I32] + [_F32] * 3 + [_I32] * 2)
_SLOT_DTYPES = [_I32, _F32, _F32, _F32]


def state_dtypes(n_slots: int) -> list:
    """The dtype of each lane-state plane, in layout order."""
    return _BASE_DTYPES + _SLOT_DTYPES * n_slots


class _Config(ctypes.Structure):
    """csrc/shade_regen.cu ShadeRegenConfig, field for field."""

    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "max_depth", "unit_sample", "phys_refract", "width", "height",
            "spp", "task_samples", "tpp", "n_tasks", "n_slots", "stride",
            "camera_mode", "rr_terminate", "rr_start", "stratified",
            "own_bl", "t_b", "tiles_x", "worker_base")]
        + [(n, ctypes.c_float) for n in ("sky_bias", "rr_qmin", "rr_scale")]
        + [("b0", ctypes.c_uint32), ("b1", ctypes.c_uint32)])


def pack_camera(cam: Camera) -> torch.Tensor:
    """Camera -> (19,) f32 vector: origin, lower_left, horizontal,
    vertical, basis_u, basis_v, lens_radius."""
    return torch.cat([
        cam.origin, cam.lower_left, cam.horizontal, cam.vertical,
        cam.basis_u, cam.basis_v,
        cam.lens_radius.reshape(1)]).to(torch.float32).contiguous()


def unpack_camera(camvec: torch.Tensor) -> Camera:
    """The inverse of pack_camera (views into the vector)."""
    return Camera(camvec[0:3], camvec[3:6], camvec[6:9], camvec[9:12],
                  camvec[12:15], camvec[15:18], camvec[18])


def _fdiv(a, b: int):
    """Floor division (Python's //) of an i32 plane by a positive int:
    task and pixel ids are -1 on lanes without a task."""
    return torch.div(a, b, rounding_mode="floor")


def _check_tile_kw(width: int, own_bl: int, t_b: int, tiles_x: int) -> None:
    if own_bl < 0 or (own_bl and (
            t_b <= 0 or tiles_x != cull.virtual_grid(width, 1)[0])):
        raise ValueError(
            f"tile ownership needs own_bl > 0, t_b > 0 and tiles_x = "
            f"ceil(width / {cull.TILE}); got own_bl={own_bl} t_b={t_b} "
            f"tiles_x={tiles_x} at width {width}")


def _task_pixel(vp, width: int, height: int, own_bl: int):
    """A task's virtual pixel -> row-major pixel id: itself under strided
    ownership; under tile ownership the 32x32 tile de-swizzle
    (cull.tile_pixel), out-of-image virtual pixels giving pixel 0 (they
    trace like any other and drop at the engine's fold)."""
    if not own_bl:
        return vp
    return cull.tile_pixel(torch.clamp(vp, min=0), width, height)[0]


def regen(lane_state, camvec, base_words, *, width: int, height: int,
          spp: int, task_samples: int, tpp: int, n_tasks: int, n_slots: int,
          stride: int, camera_mode: str, sampling: str = "iid",
          own_bl: int = 0, t_b: int = 0, tiles_x: int = 0,
          worker_base: int = 0):
    """Regenerate dead lanes: move finished tasks to a pending slot,
    acquire the next task of the lane's own sequence, advance the sample
    id and issue the camera ray. The second half of the fused step, and --
    applied once to the all-idle initial state -- the engine's prologue.

    own_bl = 0 is STRIDED ownership: a lane's sequence ends at n_tasks and
    a task's virtual pixel is its pixel. own_bl > 0 is TILE ownership
    (ops/wavefront.py): the lane's sequence ends at ``worker_base +
    (lane // own_bl + 1) * t_b`` and task ids map to pixels through the
    32x32 tile de-swizzle over a grid ``tiles_x`` tiles wide.

    Returns the next lane state (new tensors; same layout).
    """
    _check_tile_kw(width, own_bl, t_b, tiles_x)
    (nxt, task, sid, act, ox, oy, oz, dx, dy, dz, ax, ay, az,
     depth, accr, accg, accb, k0, k1) = lane_state[:N_BASE]
    slots = [tuple(lane_state[N_BASE + 4 * j: N_BASE + 4 * (j + 1)])
             for j in range(n_slots)]
    active = act > 0

    idle = ~active
    has_task = task >= 0
    pid_old = _fdiv(task, tpp)
    run_end_old = torch.clamp(
        (task - pid_old * tpp) * task_samples + task_samples, max=spp)

    # 1. Completed tasks move their accumulator into the first free
    #    pending slot (every slot full -> the lane idles until flush).
    task_done = idle & has_task & (sid + 1 >= run_end_old)
    remaining = task_done
    new_slots = []
    for (pt, pr, pg, pb) in slots:
        mv = remaining & (pt < 0)
        new_slots.append((torch.where(mv, task, pt),
                          torch.where(mv, accr, pr),
                          torch.where(mv, accg, pg),
                          torch.where(mv, accb, pb)))
        remaining = remaining & ~mv
    moved = task_done & ~remaining
    zero = torch.zeros_like(accr)
    accr = torch.where(moved, zero, accr)
    accg = torch.where(moved, zero, accg)
    accb = torch.where(moved, zero, accb)
    task = torch.where(moved, torch.full_like(task, -1), task)

    # 2. Taskless lanes acquire their next strided task.
    if own_bl:
        lane = torch.arange(nxt.numel(), dtype=_I32,
                            device=nxt.device).reshape(nxt.shape)
        block_end = worker_base + (_fdiv(lane, own_bl) + 1) * t_b
    else:
        block_end = n_tasks
    acquire = idle & (task < 0) & (nxt < block_end)
    task = torch.where(acquire, nxt, task)
    nxt = torch.where(acquire, nxt + stride, nxt)

    # 3. Recompute pixel/run for the (possibly new) task; advance sid.
    vp = _fdiv(task, tpp)
    run_start = (task - vp * tpp) * task_samples
    pid = _task_pixel(vp, width, height, own_bl)
    next_sample = idle & has_task & (sid + 1 < run_end_old) & ~task_done
    sid = torch.where(acquire, run_start,
                      torch.where(next_sample, sid + 1, sid))
    issue = acquire | next_sample

    # 4. Camera ray for issued (pixel, sample) pairs; unissued lanes'
    #    results are fully masked off.
    nox, noy, noz, ndx, ndy, ndz, rk0, rk1 = planar.camera_rays(
        unpack_camera(camvec), pid, sid, base_words, width, height,
        camera_mode, sampling=sampling, spp=spp)

    one = torch.ones_like(ax)
    return (nxt, task, sid, (active | issue).to(_I32),
            torch.where(issue, nox, ox), torch.where(issue, noy, oy),
            torch.where(issue, noz, oz), torch.where(issue, ndx, dx),
            torch.where(issue, ndy, dy), torch.where(issue, ndz, dz),
            torch.where(issue, one, ax), torch.where(issue, one, ay),
            torch.where(issue, one, az),
            torch.where(issue, torch.zeros_like(depth), depth),
            accr, accg, accb,
            torch.where(issue, rk0, k0), torch.where(issue, rk1, k1),
            *(p for s in new_slots for p in s))


def shade_update(lane_state, seg, base_words, *, max_depth: int,
                 unit_sample: bool, phys_refract: bool, sky_bias: float,
                 width: int, height: int, spp: int, tpp: int,
                 rr_terminate: bool = False, rr_start: int = 3,
                 rr_qmin: float = 0.05, rr_scale: float = 1.0,
                 sampling: str = "iid", own_bl: int = 0):
    """Shade the segment just traced and update the lane state: the first
    half of the fused step (and the second half of the unrotated
    ``mega="off"`` step), in plain PyTorch.

    seg: the surface/material planes of
    ops/cuda_segment.surface_from_params. Returns the next lane state with
    ``active`` = the lanes that keep tracing, before any regeneration.
    """
    (nxt, task, sid, act, ox, oy, oz, dx, dy, dz, ax, ay, az,
     dep, acr, acg, acb, k0, k1) = lane_state[:N_BASE]
    active = act > 0
    hit = seg["hit"] > 0

    strat0 = None
    if sampling == "stratified":
        # First-bounce stratified scatter: the CURRENT ray's pixel from
        # its task plane (same arithmetic as regen).
        pid_cur = _task_pixel(_fdiv(torch.clamp(task, min=0), tpp), width,
                              height, own_bl)
        strat0 = planar.strat0_scatter_planes(k0, k1, pid_cur, sid,
                                              base_words, spp, unit_sample)
    sdx, sdy, sdz, valid, sky_r, sky_g, sky_b = planar.bounce_planar(
        seg, (dx, dy, dz), k0, k1, dep, unit_sample=unit_sample,
        phys_refract=phys_refract, sky_bias=sky_bias, strat0=strat0)

    miss_now = active & ~hit
    scatter_now = active & hit & valid
    depth_out = scatter_now & (dep + 1 >= max_depth)
    keep = scatter_now & ~depth_out

    acr = torch.where(miss_now, acr + ax * sky_r, acr)
    acg = torch.where(miss_now, acg + ay * sky_g, acg)
    acb = torch.where(miss_now, acb + az * sky_b, acb)

    ox = torch.where(keep, seg["px"], ox)
    oy = torch.where(keep, seg["py"], oy)
    oz = torch.where(keep, seg["pz"], oz)
    dx = torch.where(keep, sdx, dx)
    dy = torch.where(keep, sdy, dy)
    dz = torch.where(keep, sdz, dz)
    ax = torch.where(keep, ax * seg["ar"], ax)
    ay = torch.where(keep, ay * seg["ag"], ay)
    az = torch.where(keep, az * seg["ab"], az)
    if rr_terminate:
        ax, ay, az, keep = rng.rr_terminate_update(
            k0, k1, dep, ax, ay, az, keep, rr_start=rr_start,
            rr_qmin=rr_qmin, rr_scale=rr_scale)
    dep = torch.where(keep, dep + 1, dep)
    return (nxt, task, sid, keep.to(_I32), ox, oy, oz, dx, dy, dz,
            ax, ay, az, dep, acr, acg, acb, k0, k1, *lane_state[N_BASE:])


def shade_regen_reference(lane_state, seg, params, camvec, base_words, *,
                          max_depth: int, unit_sample: bool,
                          phys_refract: bool, sky_bias: float, width: int,
                          height: int, spp: int, task_samples: int, tpp: int,
                          n_tasks: int, n_slots: int, stride: int,
                          camera_mode: str, rr_terminate: bool = False,
                          rr_start: int = 3, rr_qmin: float = 0.05,
                          rr_scale: float = 1.0, sampling: str = "iid",
                          own_bl: int = 0, t_b: int = 0, tiles_x: int = 0,
                          worker_base: int = 0):
    """Plain PyTorch version of the fused shade+regen kernel:
    ``shade_update`` then ``regen``.

    seg: (hit_i, t) planes; params: the 10 resolved per-ray param planes
    (ops/cuda_segment.resolve_params). Everything else as ``shade_regen``.
    Returns the next lane state as new tensors.
    """
    hit_i, seg_t = seg
    surf = surface_from_params(tuple(lane_state[4:10]), params, hit_i, seg_t)
    shaded = shade_update(
        lane_state, surf, base_words, max_depth=max_depth,
        unit_sample=unit_sample, phys_refract=phys_refract,
        sky_bias=sky_bias, width=width, height=height, spp=spp, tpp=tpp,
        rr_terminate=rr_terminate, rr_start=rr_start, rr_qmin=rr_qmin,
        rr_scale=rr_scale, sampling=sampling, own_bl=own_bl)
    return regen(shaded, camvec, base_words, width=width, height=height,
                 spp=spp, task_samples=task_samples, tpp=tpp,
                 n_tasks=n_tasks, n_slots=n_slots, stride=stride,
                 camera_mode=camera_mode, sampling=sampling, own_bl=own_bl,
                 t_b=t_b, tiles_x=tiles_x, worker_base=worker_base)


def _check_planes(planes, n_slots: int, shape, device, what: str) -> None:
    dtypes = state_dtypes(n_slots)
    if len(planes) != len(dtypes):
        raise ValueError(f"shade_regen: {what} has {len(planes)} planes; "
                         f"n_slots={n_slots} needs {len(dtypes)}")
    for i, (p, dt) in enumerate(zip(planes, dtypes)):
        if (p.dtype != dt or p.shape != shape or p.device != device
                or not p.is_contiguous()):
            raise ValueError(
                f"shade_regen: {what} plane {i} must be a contiguous {dt} "
                f"tensor of shape {tuple(shape)} on {device}; got {p.dtype} "
                f"{tuple(p.shape)} on {p.device}, "
                f"contiguous={p.is_contiguous()}")


def shade_regen(lane_state, seg, table, camvec, base_words, *,
                max_depth: int, unit_sample: bool, phys_refract: bool,
                sky_bias: float, width: int, height: int, spp: int,
                task_samples: int, tpp: int, n_tasks: int, n_slots: int,
                stride: int, camera_mode: str, rr_terminate: bool = False,
                rr_start: int = 3, rr_qmin: float = 0.05,
                rr_scale: float = 1.0, sampling: str = "iid", out=None,
                own_bl: int = 0, t_b: int = 0, tiles_x: int = 0,
                worker_base: int = 0):
    """One fused shade+state-update+regen step on the lane state.

    lane_state: the (19 + 4*n_slots)-plane tuple of the module docstring.
    seg: (hit_i, t, sphere_idx) from ops/cuda_segment.segment_closest_hit.
    table: ops/cuda_segment.sphere_table(sphere_params), the (S, 10) f32
      per-sphere table the winner's parameters are read from.
    camvec: pack_camera(cam); base_words: the (k0, k1) base-key words.
    own_bl, t_b, tiles_x, worker_base: tile ownership (see ``regen``;
      own_bl = 0, the default, is strided ownership).
    out: optional tuple of planes to write the next state into (CUDA
      only); ``out=lane_state`` updates the state in place. Absent, new
      planes are allocated.
    Returns the next lane state (same layout). CUDA tensors go through the
    hand-written kernel on the current stream (no synchronise); CPU
    tensors through the plain version.
    """
    if camera_mode not in CAMERA_MODES:
        raise ValueError(f"unknown camera mode: {camera_mode!r}")
    if sampling == "stratified" and spp <= 0:
        raise ValueError("sampling='stratified' requires spp > 0 "
                         f"(got spp={spp})")
    if min(width, height, tpp, task_samples, stride, max_depth) <= 0:
        raise ValueError(
            "shade_regen: width, height, tpp, task_samples, stride and "
            "max_depth must be positive")
    _check_tile_kw(width, own_bl, t_b, tiles_x)
    hit_i, seg_t, s_b = seg
    opts = dict(max_depth=max_depth, unit_sample=unit_sample,
                phys_refract=phys_refract, sky_bias=sky_bias, width=width,
                height=height, spp=spp, task_samples=task_samples, tpp=tpp,
                n_tasks=n_tasks, n_slots=n_slots, stride=stride,
                rr_terminate=rr_terminate, rr_start=rr_start, own_bl=own_bl,
                t_b=t_b, tiles_x=tiles_x, worker_base=worker_base)
    device = hit_i.device
    if device.type == "cpu":
        if out is not None:
            raise ValueError("shade_regen: out= is taken on CUDA only")
        cols = table.unbind(dim=1)
        params = resolve_params(
            s_b, cols[:4] + (cols[4].to(_I32),) + cols[5:])
        return shade_regen_reference(
            lane_state, (hit_i, seg_t), params, camvec, base_words,
            camera_mode=camera_mode, rr_qmin=rr_qmin, rr_scale=rr_scale,
            sampling=sampling, **opts)
    if device.type != "cuda":
        raise ValueError(f"shade_regen: no kernel for device {device}")

    check_current_device(device)
    if not 1 <= n_slots <= MAX_SLOTS:
        raise ValueError(f"shade_regen: n_slots={n_slots}; the kernel "
                         f"takes 1..{MAX_SLOTS}")
    shape = hit_i.shape
    if len(shape) != 2 or shape[1] != LANES:
        raise ValueError(f"shade_regen: planes must be (R, {LANES}); got "
                         f"{tuple(shape)}")
    _check_planes(lane_state, n_slots, shape, device, "lane_state")
    for name, p, dt in (("hit", hit_i, _I32), ("t", seg_t, _F32),
                        ("sphere_idx", s_b, _I32)):
        if (p.dtype != dt or p.shape != shape or p.device != device
                or not p.is_contiguous()):
            raise ValueError(f"shade_regen: {name} must be a contiguous "
                             f"{dt} tensor of shape {tuple(shape)} on "
                             f"{device}")
    if (table.dtype != _F32 or table.dim() != 2 or table.shape[1] != 10
            or table.shape[0] < 1 or table.device != device
            or not table.is_contiguous()):
        raise ValueError("shade_regen: table must be a contiguous (S, 10) "
                         f"float32 tensor on {device}")
    if (camvec.dtype != _F32 or camvec.shape != (19,)
            or camvec.device != device or not camvec.is_contiguous()):
        raise ValueError("shade_regen: camvec must be a contiguous (19,) "
                         f"float32 tensor on {device}")
    if out is None:
        out = tuple(torch.empty(shape, dtype=dt, device=device)
                    for dt in state_dtypes(n_slots))
    elif out is not lane_state:  # in place: the same planes, checked above
        out = tuple(out)
        _check_planes(out, n_slots, shape, device, "out")

    b0, b1 = (tf.u32(w) for w in base_words)
    cfg = _Config(camera_mode=CAMERA_MODES[camera_mode],
                  stratified=int(sampling == "stratified"),
                  rr_qmin=rr_qmin, rr_scale=rr_scale, b0=b0, b1=b1,
                  **{k: (int(v) if k != "sky_bias" else v)
                     for k, v in opts.items()})
    n_state = len(out)
    ptrs = ctypes.c_void_p * n_state
    # Named so that the arrays outlive the call that reads them.
    in_ptrs = ptrs(*(p.data_ptr() for p in lane_state))
    out_ptrs = ptrs(*(p.data_ptr() for p in out))
    fn = kernels.entry("rtw_shade_regen")
    err = fn(ctypes.byref(cfg), in_ptrs, out_ptrs, hit_i.data_ptr(),
             seg_t.data_ptr(), s_b.data_ptr(), table.data_ptr(),
             camvec.data_ptr(), hit_i.numel(), table.shape[0],
             torch.cuda.current_stream(device).cuda_stream)
    kernels.check(err, "shade_regen")
    kernels.LAUNCHES["shade_regen"] += 1
    return out
