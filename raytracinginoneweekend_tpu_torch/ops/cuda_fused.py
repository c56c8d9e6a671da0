"""Shade and regen: the wavefront engine's per-lane tier -- CUDA kernel
wrappers and plain versions.

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

KERNEL NOTE. ``csrc/shade_regen.cu`` replaces the Pallas TPU kernel
``pallas_fused.py::_kernel_shade_regen``. Its two halves -- shade, and
regen (slots, task acquisition, camera ray) -- are device functions behind
three entries, one wrapper each:
  * ``shade_regen``: both halves, the fused engine's step;
  * ``shade_update``: the shade half (the unrotated ``mega="off"`` step);
  * ``regen``: the regen half (the engine's prologue, and the unrotated
    steps' regeneration).
So every camera ray and every bounce draw on the card comes from one
arithmetic. What bounds the kernel: at the default pool's 32768 lanes
latency and the grid's fixed cost (each thread runs serial chains of
loads, threefry blocks, the shade and the camera ray); at 2^20 lanes bytes
(3 input planes + 19+4*n_slots state planes read, 19+4*n_slots written,
per lane). The design: one thread per lane (``shade_regen_threads`` picks
the block size) over plane-per-quantity arrays
(coalesced), all reads before all writes so the state is updated IN PLACE
(``out=lane_state``), the winner's ten parameters indexed straight from
the (S, 10) table, the lane state read before the closest hit's outputs --
with ``pdl=True`` as a programmatic dependent launch, while the closest-hit
kernel before it drains (see the source's header for the caller's promise
this needs) -- and the draws and every lane's candidate camera ray
computed while those outputs land.
``shade_regen_reference``, ``shade_update_reference`` and
``regen_reference`` are the plain PyTorch versions, composed of the
package's one copy of the shade math (ops/planar.bounce_planar), the
Russian-roulette contract (ops/rng.rr_terminate_update) and the camera
rays (ops/planar.camera_rays).

For a tensor on the CPU a wrapper runs the plain version; for a CUDA
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
import functools

import torch

from .. import kernels
from ..models.camera import Camera
from . import cull
from . import planar
from . import rng
from . import threefry as tf
from .cuda_segment import (LANES, _sm_count, check_current_device,
                           resolve_params, surface_from_params)

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


def regen_reference(lane_state, camvec, base_words, *, width: int,
                    height: int, spp: int, task_samples: int, tpp: int,
                    n_tasks: int, n_slots: int, stride: int,
                    camera_mode: str, sampling: str = "iid",
                    own_bl: int = 0, t_b: int = 0, tiles_x: int = 0,
                    worker_base: int = 0):
    """Plain PyTorch version of the regen-only kernel (``regen``).

    Regenerate dead lanes: move finished tasks to a pending slot,
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


def shade_update_reference(lane_state, seg, base_words, *, max_depth: int,
                           unit_sample: bool, phys_refract: bool,
                           sky_bias: float, width: int, height: int,
                           spp: int, tpp: int, rr_terminate: bool = False,
                           rr_start: int = 3, rr_qmin: float = 0.05,
                           rr_scale: float = 1.0, sampling: str = "iid",
                           own_bl: int = 0):
    """Plain PyTorch version of the shade-only kernel (``shade_update``).

    Shade the segment just traced and update the lane state: the first
    half of the fused step (and the second half of the unrotated
    ``mega="off"`` step).

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
    ``shade_update_reference`` then ``regen_reference``.

    seg: (hit_i, t) planes; params: the 10 resolved per-ray param planes
    (ops/cuda_segment.resolve_params). Everything else as ``shade_regen``.
    Returns the next lane state as new tensors.
    """
    hit_i, seg_t = seg
    surf = surface_from_params(tuple(lane_state[4:10]), params, hit_i, seg_t)
    shaded = shade_update_reference(
        lane_state, surf, base_words, max_depth=max_depth,
        unit_sample=unit_sample, phys_refract=phys_refract,
        sky_bias=sky_bias, width=width, height=height, spp=spp, tpp=tpp,
        rr_terminate=rr_terminate, rr_start=rr_start, rr_qmin=rr_qmin,
        rr_scale=rr_scale, sampling=sampling, own_bl=own_bl)
    return regen_reference(
        shaded, camvec, base_words, width=width, height=height, spp=spp,
        task_samples=task_samples, tpp=tpp, n_tasks=n_tasks,
        n_slots=n_slots, stride=stride, camera_mode=camera_mode,
        sampling=sampling, own_bl=own_bl, t_b=t_b, tiles_x=tiles_x,
        worker_base=worker_base)


# Block sizes csrc/shade_regen.cu takes (one lane a thread).
SR_THREADS = (64, 128, 256, 512)
# Threads an SM holds at once (2048 on this card): a grid within one such
# wave launches few blocks of 256; beyond it blocks of 64 spread the tail
# (chip_smoke.py's sweep at 32768 and 2^20 lanes; PERF.md).
SR_RESIDENT_THREADS_PER_SM = 2048


def shade_regen_threads(n_lanes: int, n_sms: int) -> int:
    """The block size of ``csrc/shade_regen.cu`` at ``n_lanes`` lanes on a
    card of ``n_sms`` SMs: 256 while the grid fits one wave of resident
    threads, else 64."""
    return 256 if n_lanes <= n_sms * SR_RESIDENT_THREADS_PER_SM else 64


@functools.lru_cache(maxsize=None)
def _picked_threads(n_lanes: int, device_index: int) -> int:
    return shade_regen_threads(n_lanes, _sm_count(device_index))


def _threads(name: str, threads, n_lanes: int, device) -> int:
    """The block size of one launch: ``threads`` (for measuring) or the
    picked one, worked out once per lane count."""
    if threads is None:
        return _picked_threads(n_lanes, device.index)
    if threads not in SR_THREADS:
        raise ValueError(f"{name}: threads={threads}; the kernel takes "
                         f"{SR_THREADS}")
    return threads


def _check_planes(name: str, planes, n_slots: int, shape, device,
                  what: str) -> None:
    dtypes = state_dtypes(n_slots)
    if len(planes) != len(dtypes):
        raise ValueError(f"{name}: {what} has {len(planes)} planes; "
                         f"n_slots={n_slots} needs {len(dtypes)}")
    for i, (p, dt) in enumerate(zip(planes, dtypes)):
        if (p.dtype != dt or p.shape != shape or p.device != device
                or not p.is_contiguous()):
            raise ValueError(
                f"{name}: {what} plane {i} must be a contiguous {dt} "
                f"tensor of shape {tuple(shape)} on {device}; got {p.dtype} "
                f"{tuple(p.shape)} on {p.device}, "
                f"contiguous={p.is_contiguous()}")


def _cuda_state(name: str, lane_state, n_slots: int):
    """What every entry asks of a CUDA lane state -> (shape, device)."""
    device = lane_state[0].device
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    check_current_device(device)
    if not 1 <= n_slots <= MAX_SLOTS:
        raise ValueError(f"{name}: n_slots={n_slots}; the kernel "
                         f"takes 1..{MAX_SLOTS}")
    shape = lane_state[0].shape
    if len(shape) != 2 or shape[1] != LANES:
        raise ValueError(f"{name}: planes must be (R, {LANES}); got "
                         f"{tuple(shape)}")
    _check_planes(name, lane_state, n_slots, shape, device, "lane_state")
    return shape, device


def _check_segment(name: str, seg, table, shape, device) -> None:
    for pname, p, dt in zip(("hit", "t", "sphere_idx"), seg,
                            (_I32, _F32, _I32)):
        if (p.dtype != dt or p.shape != shape or p.device != device
                or not p.is_contiguous()):
            raise ValueError(f"{name}: {pname} must be a contiguous "
                             f"{dt} tensor of shape {tuple(shape)} on "
                             f"{device}")
    if (table.dtype != _F32 or table.dim() != 2 or table.shape[1] != 10
            or table.shape[0] < 1 or table.device != device
            or not table.is_contiguous()):
        raise ValueError(f"{name}: table must be a contiguous (S, 10) "
                         f"float32 tensor on {device}")


def _check_camvec(name: str, camvec, device) -> None:
    if (camvec.dtype != _F32 or camvec.shape != (19,)
            or camvec.device != device or not camvec.is_contiguous()):
        raise ValueError(f"{name}: camvec must be a contiguous (19,) "
                         f"float32 tensor on {device}")


def _state_out(name: str, lane_state, out, n_slots: int, shape, device):
    """The planes a kernel writes into: new ones (out=None), the state
    itself (in place) or the caller's, checked."""
    if out is None:
        return tuple(torch.empty(shape, dtype=dt, device=device)
                     for dt in state_dtypes(n_slots))
    if out is lane_state:  # in place: the same planes, checked already
        return out
    out = tuple(out)
    _check_planes(name, out, n_slots, shape, device, "out")
    return out


def _config(*, camera_mode: str = "cuda", sampling: str = "iid",
            rr_qmin: float = 0.05, rr_scale: float = 1.0, sky_bias=1.0,
            base_words, **opts) -> _Config:
    """The kernel's ShadeRegenConfig; fields an entry does not read stay
    0."""
    b0, b1 = (tf.u32(w) for w in base_words)
    return _Config(camera_mode=CAMERA_MODES[camera_mode],
                   stratified=int(sampling == "stratified"),
                   sky_bias=float(sky_bias), rr_qmin=float(rr_qmin),
                   rr_scale=float(rr_scale), b0=b0, b1=b1,
                   **{k: int(v) for k, v in opts.items()})


def _ptrs(planes):
    return (ctypes.c_void_p * len(planes))(*(p.data_ptr() for p in planes))


def _check_frame(name: str, camera_mode, sampling: str, spp: int,
                 **positive) -> None:
    if camera_mode is not None and camera_mode not in CAMERA_MODES:
        raise ValueError(f"unknown camera mode: {camera_mode!r}")
    if sampling == "stratified" and spp <= 0:
        raise ValueError("sampling='stratified' requires spp > 0 "
                         f"(got spp={spp})")
    if min(positive.values()) <= 0:
        raise ValueError(f"{name}: {', '.join(positive)} must be positive")


def regen(lane_state, camvec, base_words, *, width: int, height: int,
          spp: int, task_samples: int, tpp: int, n_tasks: int, n_slots: int,
          stride: int, camera_mode: str, sampling: str = "iid",
          own_bl: int = 0, t_b: int = 0, tiles_x: int = 0,
          worker_base: int = 0, out=None, pdl: bool = False, threads=None):
    """Regenerate dead lanes (the regen half of the step): move finished
    tasks to a pending slot, acquire the next task of the lane's own
    sequence, advance the sample id and issue the camera ray. Applied once
    to the all-idle initial state it is the engine's prologue.

    own_bl = 0 is STRIDED ownership: a lane's sequence ends at n_tasks and
    a task's virtual pixel is its pixel. own_bl > 0 is TILE ownership
    (ops/wavefront.py): the lane's sequence ends at ``worker_base +
    (lane // own_bl + 1) * t_b`` and task ids map to pixels through the
    32x32 tile de-swizzle over a grid ``tiles_x`` tiles wide.
    out: as ``shade_regen``'s (CUDA only). pdl: launch as a programmatic
    dependent launch (CUDA only; this entry reads nothing before its wait,
    so any caller may). threads: force the block size (for measuring;
    changes no result).

    Returns the next lane state (same layout). CUDA tensors go through the
    regen-only kernel on the current stream (no synchronise); CPU tensors
    through ``regen_reference``.
    """
    kw = dict(width=width, height=height, spp=spp, task_samples=task_samples,
              tpp=tpp, n_tasks=n_tasks, n_slots=n_slots, stride=stride,
              own_bl=own_bl, t_b=t_b, tiles_x=tiles_x,
              worker_base=worker_base)
    if lane_state[0].device.type == "cpu":
        if out is not None:
            raise ValueError("regen: out= is taken on CUDA only")
        return regen_reference(lane_state, camvec, base_words,
                               camera_mode=camera_mode, sampling=sampling,
                               **kw)
    name = "regen"
    _check_frame(name, camera_mode, sampling, spp, width=width,
                 height=height, tpp=tpp, task_samples=task_samples,
                 stride=stride)
    _check_tile_kw(width, own_bl, t_b, tiles_x)
    shape, device = _cuda_state(name, lane_state, n_slots)
    _check_camvec(name, camvec, device)
    threads = _threads(name, threads, shape.numel(), device)
    out = _state_out(name, lane_state, out, n_slots, shape, device)
    cfg = _config(camera_mode=camera_mode, sampling=sampling,
                  base_words=base_words, **kw)
    in_ptrs, out_ptrs = _ptrs(lane_state), _ptrs(out)
    err = kernels.entry("rtw_regen_only")(
        ctypes.byref(cfg), in_ptrs, out_ptrs, camvec.data_ptr(),
        shape.numel(), threads, int(bool(pdl)),
        torch.cuda.current_stream(device).cuda_stream)
    kernels.check(err, "regen_only")
    kernels.LAUNCHES["regen_only"] += 1
    return out


def shade_update(lane_state, seg, table, base_words, *, max_depth: int,
                 unit_sample: bool, phys_refract: bool, sky_bias: float,
                 width: int, height: int, spp: int, tpp: int,
                 rr_terminate: bool = False, rr_start: int = 3,
                 rr_qmin: float = 0.05, rr_scale: float = 1.0,
                 sampling: str = "iid", own_bl: int = 0, out=None,
                 pdl: bool = False, threads=None):
    """Shade the segment just traced and update the lane state (the shade
    half of the step; the unrotated ``mega="off"`` step's second half).

    seg: (hit_i, t, sphere_idx) from ops/cuda_segment.segment_closest_hit;
    table: ops/cuda_segment.sphere_table(sphere_params), the (S, 10) f32
    table the winner's parameters are read from by index.
    out: None (new planes for what the shade changes, planes 3..16; the
    others are the input's, as in the plain version) or ``lane_state``
    itself (in place; CUDA only). pdl, threads: as ``shade_regen``'s.
    Returns the next lane state with ``active`` = the lanes that keep
    tracing, before any regeneration. CUDA tensors go through the
    shade-only kernel on the current stream (no synchronise); CPU tensors
    through ``shade_update_reference``.
    """
    kw = dict(max_depth=max_depth, unit_sample=unit_sample,
              phys_refract=phys_refract, sky_bias=sky_bias, width=width,
              height=height, spp=spp, tpp=tpp, rr_terminate=rr_terminate,
              rr_start=rr_start, rr_qmin=rr_qmin, rr_scale=rr_scale,
              sampling=sampling, own_bl=own_bl)
    hit_i, seg_t, s_b = seg
    name = "shade_update"
    if hit_i.device.type == "cpu":
        if out is not None:
            raise ValueError(f"{name}: out= is taken on CUDA only")
        cols = table.unbind(dim=1)
        params = resolve_params(
            s_b, cols[:4] + (cols[4].to(_I32),) + cols[5:])
        surf = surface_from_params(tuple(lane_state[4:10]), params, hit_i,
                                   seg_t)
        return shade_update_reference(lane_state, surf, base_words, **kw)
    _check_frame(name, None, sampling, spp, width=width, height=height,
                 tpp=tpp, max_depth=max_depth)
    n_slots, rem = divmod(len(lane_state) - N_BASE, 4)
    if rem:
        raise ValueError(f"{name}: {len(lane_state)} planes is not "
                         "19 + 4*n_slots")
    shape, device = _cuda_state(name, lane_state, n_slots)
    _check_segment(name, seg, table, shape, device)
    tiles_x = cull.virtual_grid(width, 1)[0] if own_bl else 0
    if own_bl < 0:
        raise ValueError(f"{name}: own_bl={own_bl}")
    threads = _threads(name, threads, shape.numel(), device)
    if out is None:
        changed = {i: torch.empty(shape, dtype=dt, device=device)
                   for i, dt in enumerate(state_dtypes(n_slots))
                   if 3 <= i <= 16}
        out = tuple(changed.get(i, p) for i, p in enumerate(lane_state))
    elif out is not lane_state:
        raise ValueError(f"{name}: out= takes the lane state itself (in "
                         "place) or None")
    cfg = _config(base_words=base_words, n_slots=n_slots, tiles_x=tiles_x,
                  **kw)
    in_ptrs, out_ptrs = _ptrs(lane_state), _ptrs(out)
    err = kernels.entry("rtw_shade_only")(
        ctypes.byref(cfg), in_ptrs, out_ptrs, hit_i.data_ptr(),
        seg_t.data_ptr(), s_b.data_ptr(), table.data_ptr(), shape.numel(),
        table.shape[0], threads, int(bool(pdl)),
        torch.cuda.current_stream(device).cuda_stream)
    kernels.check(err, "shade_only")
    kernels.LAUNCHES["shade_only"] += 1
    return out


def shade_regen(lane_state, seg, table, camvec, base_words, *,
                max_depth: int, unit_sample: bool, phys_refract: bool,
                sky_bias: float, width: int, height: int, spp: int,
                task_samples: int, tpp: int, n_tasks: int, n_slots: int,
                stride: int, camera_mode: str, rr_terminate: bool = False,
                rr_start: int = 3, rr_qmin: float = 0.05,
                rr_scale: float = 1.0, sampling: str = "iid", out=None,
                own_bl: int = 0, t_b: int = 0, tiles_x: int = 0,
                worker_base: int = 0, pdl: bool = False, threads=None):
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
    pdl: launch as a programmatic dependent launch (CUDA only): the kernel
      reads the lane state and draws before it waits for the kernel ahead
      of it in the stream, so that kernel must not write the lane state
      (the engine's closest-hit kernel never does).
    threads: force the block size (one of ``SR_THREADS``; for measuring,
      changes no result). Absent, ``shade_regen_threads`` picks it.
    Returns the next lane state (same layout). CUDA tensors go through the
    hand-written kernel on the current stream (no synchronise); CPU
    tensors through the plain version.
    """
    _check_frame("shade_regen", camera_mode, sampling, spp, width=width,
                 height=height, tpp=tpp, task_samples=task_samples,
                 stride=stride, max_depth=max_depth)
    _check_tile_kw(width, own_bl, t_b, tiles_x)
    hit_i, seg_t, s_b = seg
    opts = dict(max_depth=max_depth, unit_sample=unit_sample,
                phys_refract=phys_refract, sky_bias=sky_bias, width=width,
                height=height, spp=spp, task_samples=task_samples, tpp=tpp,
                n_tasks=n_tasks, n_slots=n_slots, stride=stride,
                rr_terminate=rr_terminate, rr_start=rr_start, own_bl=own_bl,
                t_b=t_b, tiles_x=tiles_x, worker_base=worker_base)
    if hit_i.device.type == "cpu":
        if out is not None:
            raise ValueError("shade_regen: out= is taken on CUDA only")
        cols = table.unbind(dim=1)
        params = resolve_params(
            s_b, cols[:4] + (cols[4].to(_I32),) + cols[5:])
        return shade_regen_reference(
            lane_state, (hit_i, seg_t), params, camvec, base_words,
            camera_mode=camera_mode, rr_qmin=rr_qmin, rr_scale=rr_scale,
            sampling=sampling, **opts)
    name = "shade_regen"
    if hit_i.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {hit_i.device}")
    shape, device = _cuda_state(name, lane_state, n_slots)
    _check_segment(name, seg, table, shape, device)
    _check_camvec(name, camvec, device)
    threads = _threads(name, threads, shape.numel(), device)
    out = _state_out(name, lane_state, out, n_slots, shape, device)
    cfg = _config(camera_mode=camera_mode, sampling=sampling,
                  rr_qmin=rr_qmin, rr_scale=rr_scale, base_words=base_words,
                  **opts)
    # Named so that the arrays outlive the call that reads them.
    in_ptrs, out_ptrs = _ptrs(lane_state), _ptrs(out)
    err = kernels.entry("rtw_shade_regen")(
        ctypes.byref(cfg), in_ptrs, out_ptrs, hit_i.data_ptr(),
        seg_t.data_ptr(), s_b.data_ptr(), table.data_ptr(),
        camvec.data_ptr(), shape.numel(), table.shape[0], threads,
        int(bool(pdl)), torch.cuda.current_stream(device).cuda_stream)
    kernels.check(err, "shade_regen")
    kernels.LAUNCHES["shade_regen"] += 1
    return out
