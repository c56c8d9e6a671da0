"""Whole-bounce kernel: closest hit + winner lookup + RNG draws + shade +
lane-state update in one launch -- CUDA kernel wrapper and plain version.

Counterpart of ``raytracinginoneweekend_tpu/ops/pallas_mega.py``; the
wavefront engine's ``mega="bounce"`` step (ops/wavefront.py) is plain
``regen`` followed by this kernel.

KERNEL NOTE. ``mega_bounce`` on CUDA tensors launches
``csrc/mega_bounce.cu``, which replaces the Pallas TPU kernel
``pallas_mega.py::_kernel_mega``. It is bound by float32 instruction
issue: closest_hit's loop (about 27 operations per active lane and
sphere, 18 where the discriminant is negative) dominates, against 30
words a lane of traffic. The design is closest_hit's split loop -- K
threads a ray (``cuda_segment.closest_hit_split`` with
``SPLIT_THREADS_PER_SM``), reduced over (q, sphere index) with warp
shuffles, the square root only where the discriminant is >= 0 -- then
one thread a lane for the lookup, draws, shade and writes, over
plane-per-quantity arrays, with the (cx, cy, cz, r*r) table and the (S,
10) parameter table both in shared memory, so the winner's parameters
are a direct read (the TPU kernel's transposed one-hot product has no
counterpart); an inactive lane copies its state through (see the source's
header). Every K gives the same result to the bit.
``mega_bounce_reference`` is its plain PyTorch version: closest_hit's
plain version, the winner's parameters by index, the hit
point and normal of ``cuda_segment.surface_from_params`` and
``planar.bounce_planar`` -- the same float32 operations in the same order
as the kernel (the TPU kernel's 8-way tournament only reorders strict-<
comparisons, so the first least candidate wins in both).

For a tensor on the CPU the wrapper runs the plain version; for a CUDA
tensor it launches the kernel or raises -- it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from . import planar
from .cuda_segment import (LANES, SPLIT_THREADS_PER_SM,
                           check_current_device, check_split, hit_table,
                           picked_split, resolve_params,
                           segment_closest_hit_reference, sphere_table,
                           surface_from_params)

N_IN = 16   # active, ox oy oz dx dy dz, ax ay az, accr accg accb, depth, k0 k1
N_OUT = 14  # ox oy oz dx dy dz, ax ay az, accr accg accb, keep, depth
_I32, _F32 = torch.int32, torch.float32
_IN_DTYPES = [_I32] + [_F32] * 12 + [_I32] * 3
# both tables in a block's shared memory: 16 + 40 bytes a sphere
MAX_SPHERES = (227 * 1024) // 56


def mega_tables(sphere_params) -> tuple:
    """(hit_table, sphere_table) of a scene's 10 per-sphere arrays: the
    kernel's (S, 4) geometry and (S, 10) parameter tables, made once by a
    caller that launches many times on one scene."""
    return hit_table(*sphere_params[:4]), sphere_table(sphere_params)


def mega_bounce_reference(state_planes, sphere_params, *, t_min: float,
                          max_depth: int, unit_sample: bool,
                          phys_refract: bool, sky_bias: float):
    """Plain PyTorch version of the whole-bounce kernel (arguments and
    results as ``mega_bounce``)."""
    (active, ox, oy, oz, dx, dy, dz, ax, ay, az, accr, accg, accb,
     depth, k0, k1) = state_planes
    act = active if active.dtype == torch.bool else active > 0
    rays = (ox, oy, oz, dx, dy, dz)
    hit_i, t, sb = segment_closest_hit_reference(
        rays, *sphere_params[:4], t_min, act)
    seg = surface_from_params(rays, resolve_params(sb, sphere_params),
                              hit_i, t)
    sdx, sdy, sdz, valid, sky_r, sky_g, sky_b = planar.bounce_planar(
        seg, (dx, dy, dz), k0, k1, depth, unit_sample=unit_sample,
        phys_refract=phys_refract, sky_bias=sky_bias)

    hit = hit_i > 0
    miss_now = act & ~hit
    scatter_now = act & hit & valid
    keep = scatter_now & ~(depth + 1 >= max_depth)
    return (torch.where(keep, seg["px"], ox), torch.where(keep, seg["py"], oy),
            torch.where(keep, seg["pz"], oz), torch.where(keep, sdx, dx),
            torch.where(keep, sdy, dy), torch.where(keep, sdz, dz),
            torch.where(keep, ax * seg["ar"], ax),
            torch.where(keep, ay * seg["ag"], ay),
            torch.where(keep, az * seg["ab"], az),
            torch.where(miss_now, accr + ax * sky_r, accr),
            torch.where(miss_now, accg + ay * sky_g, accg),
            torch.where(miss_now, accb + az * sky_b, accb),
            keep.to(_I32), torch.where(keep, depth + 1, depth))


def mega_bounce(state_planes, sphere_params, *, t_min: float,
                max_depth: int, unit_sample: bool, phys_refract: bool,
                sky_bias: float, tables=None, out=None, split=None):
    """One full wavefront bounce on planar lane state.

    state_planes: (active, ox, oy, oz, dx, dy, dz, ax, ay, az, accr, accg,
      accb, depth, k0, k1) -- (R, 128) planes (active bool or i32 0/1,
      depth i32, k0/k1 the key words as i32 bit patterns, the rest f32).
    sphere_params: the 10-tuple of cuda_segment.sphere_params_from_scene.
    tables: optional ``mega_tables(sphere_params)``.
    out: optional 14 planes to write the result into (CUDA only). The
      kernel reads all of a lane's planes before it writes any, so they
      may be the state's own planes (the engine updates in place: ox ... dz,
      ax ... accb and depth, and ``active`` for keep).
    split: forces the kernel's K (one of ``cuda_segment.CH_SPLITS``) in
      place of the picked one; for measuring, it changes no result.
    Returns (ox, oy, oz, dx, dy, dz, ax, ay, az, accr, accg, accb, keep,
    depth): the post-bounce lane state, keep as an i32 0/1 plane (the
    port's lane state keeps ``active`` as i32; the JAX package returns a
    bool). CUDA tensors go through the hand-written kernel on the current
    stream (no synchronise); CPU tensors through the plain version.
    """
    kw = dict(t_min=t_min, max_depth=max_depth, unit_sample=unit_sample,
              phys_refract=phys_refract, sky_bias=sky_bias)
    check_split("mega_bounce", split)
    if len(state_planes) != N_IN:
        raise ValueError(f"mega_bounce: {len(state_planes)} state planes; "
                         f"it takes {N_IN}")
    device = state_planes[1].device
    if device.type == "cpu":
        if out is not None:
            raise ValueError("mega_bounce: out= is taken on CUDA only")
        return mega_bounce_reference(state_planes, sphere_params, **kw)
    if device.type != "cuda":
        raise ValueError(f"mega_bounce: no kernel for device {device}")
    if max_depth < 1:
        raise ValueError(f"mega_bounce: max_depth={max_depth}")
    check_current_device(device)
    planes = list(state_planes)
    if planes[0].dtype == torch.bool:
        planes[0] = planes[0].to(_I32)
    shape = planes[1].shape
    if len(shape) != 2 or shape[1] != LANES:
        raise ValueError(f"mega_bounce: planes must be (R, {LANES}); got "
                         f"{tuple(shape)}")
    for i, (p, dt) in enumerate(zip(planes, _IN_DTYPES)):
        if (p.dtype != dt or p.shape != shape or p.device != device
                or not p.is_contiguous()):
            raise ValueError(
                f"mega_bounce: plane {i} must be a contiguous {dt} tensor "
                f"of shape {tuple(shape)} on {device}; got {p.dtype} "
                f"{tuple(p.shape)} on {p.device}")
    n_spheres = sphere_params[0].shape[0]
    if not 1 <= n_spheres <= MAX_SPHERES:
        raise ValueError(f"mega_bounce: {n_spheres} spheres; the kernel "
                         f"takes 1..{MAX_SPHERES}")
    table4, table10 = tables if tables is not None else mega_tables(
        sphere_params)
    for name, tab, cols in (("table4", table4, 4), ("table10", table10, 10)):
        if (tab.dtype != _F32 or tuple(tab.shape) != (n_spheres, cols)
                or tab.device != device or not tab.is_contiguous()):
            raise ValueError(f"mega_bounce: {name} must be a contiguous "
                             f"({n_spheres}, {cols}) float32 tensor on "
                             f"{device}")
    out_dtypes = [_F32] * 12 + [_I32] * 2
    if out is None:
        out = tuple(torch.empty(shape, dtype=dt, device=device)
                    for dt in out_dtypes)
    else:
        out = tuple(out)
        if len(out) != N_OUT or any(
                p.dtype != dt or p.shape != shape or p.device != device
                or not p.is_contiguous() for p, dt in zip(out, out_dtypes)):
            raise ValueError(f"mega_bounce: out must be {N_OUT} contiguous "
                             f"planes of shape {tuple(shape)} on {device} "
                             "(12 float32, then keep and depth int32)")
    if split is None:
        split = picked_split(planes[1].numel(), device.index,
                             SPLIT_THREADS_PER_SM)
    ptrs_in = (ctypes.c_void_p * N_IN)(*(p.data_ptr() for p in planes))
    ptrs_out = (ctypes.c_void_p * N_OUT)(*(p.data_ptr() for p in out))
    fn = kernels.entry("rtw_mega_bounce")
    err = fn(ptrs_in, ptrs_out, table4.data_ptr(), table10.data_ptr(),
             planes[1].numel(), n_spheres, float(t_min), int(max_depth),
             int(unit_sample), int(phys_refract), float(sky_bias), split,
             torch.cuda.current_stream(device).cuda_stream)
    kernels.check(err, "mega_bounce")
    kernels.LAUNCHES["mega_bounce"] += 1
    return out
