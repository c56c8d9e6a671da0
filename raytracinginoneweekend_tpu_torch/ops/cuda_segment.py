"""Closest-hit over planar rays: CUDA kernel wrappers and plain versions.

Counterpart of ``raytracinginoneweekend_tpu/ops/pallas_segment.py``:
``sphere_params_from_scene``, ``segment_closest_hit`` and its three
siblings for coherent rays (``segment_closest_hit_list``,
``segment_closest_hit_sorted`` with ``sorted_cull_state``,
``segment_closest_hit_mxu``), ``closest_hit_planar``, ``resolve_params``,
``resolve_segment``, ``trace_segment`` and ``trace_segment_list``, and
the sphere-group kernel (``group_scene``, ``segment_closest_hit_grouped``,
``trace_segment(group_params=...)``).

KERNEL NOTE. ``segment_closest_hit`` on CUDA tensors launches
``csrc/closest_hit.cu``, which replaces the Pallas TPU kernel
``pallas_segment.py::_kernel``. It is bound by float32 instruction issue
(about 27 operations per lane and sphere against 40 bytes per lane; under
``-fmad=false`` each is its own instruction). The design keeps the sphere
table in shared memory and splits each ray's sphere loop over K threads
(``closest_hit_split`` picks K so that the grid fills the card: one thread
per lane left the default pool's 32768 lanes at 8 warps an SM), reduces
the K partials lexicographically over (q, sphere index) with warp
shuffles, and takes the square root only where the discriminant is
non-negative (see the source's header). The result is the one-thread
loop's to the bit for every K. ``segment_closest_hit_reference`` is its
plain PyTorch version: the same candidate arithmetic in the same order,
vectorised over (lanes, spheres).

KERNEL NOTES, the four siblings (each source's header has the detail):
  * ``segment_closest_hit_list`` launches ``csrc/closest_hit_list.cu``
    (replaces ``pallas_segment.py::_kernel_list``): the loop runs over a
    per-cull-block candidate list from ops/cull.py, gathered into shared
    memory once per thread block; kernel 1's split loop (K threads a ray
    from ``closest_hit_split`` with ``LIST_THREADS_PER_SM``, reduced over
    (q, position in the list)) and guarded square root. Bound by bytes at
    the list lengths of a coherent block. Bit-identical with
    ``segment_closest_hit`` wherever the list holds the true winner.
  * ``segment_closest_hit_sorted`` launches ``csrc/closest_hit_sorted.cu``
    (replaces ``_kernel_sorted``): spheres in per-cull-block distance
    order, stages of the loop skipped when every ray of a warp provably
    cannot improve; kernel 1's split loop (K threads a ray from
    ``closest_hit_split`` with ``SPLIT_THREADS_PER_SM``, reduced over (q,
    position in the sorted order)) and guarded square root. Bound by
    arithmetic when nothing is skipped. Equal to ``segment_closest_hit``
    except on exact q ties between two spheres.
  * ``segment_closest_hit_grouped`` launches
    ``csrc/closest_hit_grouped.cu`` (replaces ``_kernel_grouped``): the
    spheres sorted into groups of 16 by ``group_scene``, each group behind
    a bounding-sphere test that a warp skips when none of its active lanes
    might hit it; each group's 16 spheres split over K threads a ray (from
    ``closest_hit_split`` with ``GROUPED_THREADS_PER_SM``, at most 16,
    reduced over (t, sorted sphere index)). The t-space candidate of the
    intersect kernel (square root only where ``disc > 0``), so it is held
    to ``segment_closest_hit`` only within float32 rounding. Bound by
    arithmetic when nothing is skipped.
  * ``segment_closest_hit_mxu`` launches ``csrc/closest_hit_mxu.cu``
    (replaces ``_kernel_mxu``): the regrouped dot products d.C and o.C in
    the kernel's own body, in float32 in a fixed order; kernel 1's split
    loop (K from ``closest_hit_split`` with ``MXU_THREADS_PER_SM``, reduced
    over (q, sphere index)) and guarded square root. Bound by arithmetic.
    Not bit-equal with ``segment_closest_hit``.
Each has its plain PyTorch version beside it (``..._reference``), which
does the same float32 operations in the same order.

For a tensor on the CPU a wrapper runs the plain version; for a CUDA
tensor it launches the kernel or raises -- it never falls back.

Semantics (identical to the TPU kernel): near root preferred, far root
fallback, window (t_min, inf) compared in q-space (q = t*|d|^2), strict
'<' running min keeping the earliest sphere; sqrt of a negative
discriminant is NaN and NaN compares false, so misses fall through to the
1e30 sentinel. One difference in what is DEFINED: an inactive lane always
gets (hit 0, t 1e30, sb 0) here, where the TPU kernel leaves t/sb of a
skipped block stale.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import kernels
from ..utils.device import resolve_device
from .math3 import sqrt_rn
from .rng import _f32

LANES = 128
BIG = 1e30
UNROLL = 8  # spheres per chunk of the sorted kernel's order (the JAX value)
GROUP = 16  # spheres per group of the grouped kernel (the JAX value)
# the grouped kernel's sorted table and bounds in shared memory: 17 bytes a
# sorted sphere (16, and 16 per group of 16)
GROUP_MAX_SPHERES = (227 * 1024) // 17 // GROUP * GROUP
MXU_MAX_SPHERES = 4096  # above it hit_kernel="mxu" means the sublane kernel
MAX_LADDER = 16  # csrc/closest_hit_sorted.cu CS_MAX_LADDER
_SORT_KEY_MARGIN = 1e-3  # key-side absolute margin (sorted_cull_state)
MAX_SPHERES = (227 * 1024) // 16  # the table must fit a block's shared memory
_REF_CHUNK = 1 << 16  # lanes per slab of the plain version's (N, S) arrays


def sphere_params_from_scene(scene):
    """Pre-gather per-sphere material params: 10 (S,) tensors
    (cx cy cz r mtype ar ag ab fuzz ior); mtype is i32, the rest f32.

    The only gather is (S,)-sized (materials indexed by
    scene.material_index), done once per trace -- never per ray.
    """
    mi = scene.material_index.to(torch.int64)
    alb = scene.albedo[mi]
    return (scene.centers[:, 0].contiguous(), scene.centers[:, 1].contiguous(),
            scene.centers[:, 2].contiguous(), scene.radii,
            scene.mtype[mi].to(torch.int32),
            alb[:, 0].contiguous(), alb[:, 1].contiguous(),
            alb[:, 2].contiguous(), scene.fuzz[mi], scene.ior[mi])


def sphere_table(sphere_params) -> torch.Tensor:
    """The 10 per-sphere arrays as one contiguous (S, 10) f32 table (the
    material type stored as a float, exact for 0/1/2) -- what the
    shade+regen kernel indexes by the winning sphere."""
    return torch.stack([p.to(torch.float32) for p in sphere_params],
                       dim=1).contiguous()


def resolve_params(s_b, sphere_params):
    """Winning sphere index plane -> 10 per-ray param planes
    (cx, cy, cz, r, mt_i32, ar, ag, ab, fz, io): a plain index gather.

    The JAX package computes the same gather as a one-hot matrix product
    (exact: one nonzero term per row); the values are bit-identical.
    """
    idx = s_b.to(torch.int64)
    return tuple(p[idx] for p in sphere_params)


def _candidates(x, y, z, vx, vy, vz, a, q_min, cx, cy, cz, rr):
    """Every sphere's candidate for every ray in q-space (q = t*|d|^2),
    broadcast over (rays, spheres): the one copy of the arithmetic that
    the plain versions of closest_hit, closest_hit_list and
    closest_hit_sorted share, unguarded (the kernels' loop,
    csrc/rtw_common.cuh rtw_closest_guarded, is its bit-equal guarded
    form)."""
    ocx = x - cx
    ocy = y - cy
    ocz = z - cz
    b = ocx * vx + ocy * vy + ocz * vz
    c = ocx * ocx + ocy * ocy + ocz * ocz - rr
    sq = sqrt_rn(b * b - a * c)  # NaN when disc < 0
    nb = -b
    q0 = nb - sq
    q1 = nb + sq
    big = torch.full_like(q0, BIG)
    return torch.where(q0 > q_min, q0, torch.where(q1 > q_min, q1, big))


def _mask_inactive(hit, t, sb, active):
    """The port's convention: an inactive lane gets (0, 1e30, 0)."""
    if active is None:
        return hit, t, sb
    act = active if active.dtype == torch.bool else active > 0
    return (torch.where(act, hit, torch.zeros_like(hit)),
            torch.where(act, t, torch.full_like(t, BIG)),
            torch.where(act, sb, torch.zeros_like(sb)))


def segment_closest_hit_reference(rays, cx, cy, cz, r, t_min, active=None):
    """Plain PyTorch version of the closest-hit kernel.

    rays: 6-tuple of (R, 128) f32 planes; cx/cy/cz/r: (S,) sphere
    geometry; active: optional (R, 128) bool/i32 plane. Returns
    (hit_i i32, t f32, sphere_idx i32) planes. Only the active lanes are
    traced (an inactive lane's result is (0, 1e30, 0) whatever its ray),
    in slabs of lanes so the (lanes, spheres) intermediates stay bounded.
    """
    shape = rays[0].shape
    planes = [p.reshape(-1, 1) for p in rays]
    dev = planes[0].device
    n_all = planes[0].shape[0]
    sel = None
    if active is not None:
        act = active if active.dtype == torch.bool else active > 0
        sel = act.reshape(-1).nonzero().squeeze(1)
        planes = [p[sel] for p in planes]
    ox, oy, oz, dx, dy, dz = planes
    n = ox.shape[0]
    rr = (r * r)[None, :]
    cx, cy, cz = cx[None, :], cy[None, :], cz[None, :]
    t_min = _f32(t_min)
    hit = torch.empty(n, dtype=torch.int32, device=dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    sb = torch.empty(n, dtype=torch.int32, device=dev)
    for lo in range(0, n, _REF_CHUNK):
        sl = slice(lo, min(lo + _REF_CHUNK, n))
        x, y, z = ox[sl], oy[sl], oz[sl]
        vx, vy, vz = dx[sl], dy[sl], dz[sl]
        a = vx * vx + vy * vy + vz * vz
        inv_a = 1.0 / a
        q = _candidates(x, y, z, vx, vy, vz, a, t_min * a, cx, cy, cz, rr)
        # torch.min returns the FIRST minimal index: the earliest sphere
        # wins ties, as the strict '<' running min does.
        q_b, s_b = torch.min(q, dim=1)
        h = q_b < BIG
        hit[sl] = h.to(torch.int32)
        t[sl] = torch.where(h, q_b * inv_a[:, 0], torch.full_like(q_b, BIG))
        sb[sl] = s_b.to(torch.int32)
    if sel is not None:
        out = (torch.zeros(n_all, dtype=torch.int32, device=dev),
               torch.full((n_all,), BIG, dtype=torch.float32, device=dev),
               torch.zeros(n_all, dtype=torch.int32, device=dev))
        for o, v in zip(out, (hit, t, sb)):
            o[sel] = v
        hit, t, sb = out
    return hit.reshape(shape), t.reshape(shape), sb.reshape(shape)


def _plane(x: torch.Tensor, dtype, shape, device, name: str):
    if (x.dtype != dtype or x.shape != shape or x.device != device
            or not x.is_contiguous()):
        raise ValueError(
            f"closest_hit: plane {name} must be a contiguous {dtype} tensor "
            f"of shape {tuple(shape)} on {device}; got {x.dtype} "
            f"{tuple(x.shape)} on {x.device}, contiguous={x.is_contiguous()}")
    return x


def hit_table(cx, cy, cz, r) -> torch.Tensor:
    """(S, 4) f32 table (cx, cy, cz, r*r): the kernel's sphere geometry."""
    return torch.stack([cx, cy, cz, r * r], dim=1).contiguous()


def check_current_device(device: torch.device) -> None:
    """The kernels launch on the process's current CUDA device."""
    if device.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"tensors are on {device} but the current CUDA "
                         f"device is {torch.cuda.current_device()}")


def _check_launch(name: str, rays, cx, cy, cz, r, active, max_spheres: int):
    """What every closest-hit kernel asks of its CUDA inputs ->
    (shape, device, n_spheres, i32 active plane)."""
    ox = rays[0]
    if ox.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {ox.device}")
    shape, device = ox.shape, ox.device
    if len(rays) != 6 or len(shape) != 2 or shape[1] != LANES:
        raise ValueError(f"{name}: rays must be 6 (R, {LANES}) planes; "
                         f"got {len(rays)} of shape {tuple(shape)}")
    for pname, p in zip(("ox", "oy", "oz", "dx", "dy", "dz"), rays):
        _plane(p, torch.float32, shape, device, pname)
    n_spheres = cx.shape[0]
    if not 1 <= n_spheres <= max_spheres:
        raise ValueError(f"{name}: {n_spheres} spheres; the kernel "
                         f"takes 1..{max_spheres}")
    for pname, p in zip(("cx", "cy", "cz", "r"), (cx, cy, cz, r)):
        if (p.dtype != torch.float32 or p.shape != (n_spheres,)
                or p.device != device):
            raise ValueError(f"{name}: {pname} must be ({n_spheres},) "
                             f"float32 on {device}")
    if active is None:
        act = torch.ones(shape, dtype=torch.int32, device=device)
    else:
        if active.dtype == torch.bool:
            active = active.to(torch.int32)
        act = _plane(active, torch.int32, shape, device, "active")
    check_current_device(device)
    return shape, device, n_spheres, act


def _check_table(name: str, table, rows: int, device):
    if (table.dtype != torch.float32 or table.shape != (rows, 4)
            or table.device != device or not table.is_contiguous()):
        raise ValueError(f"{name}: table must be a contiguous "
                         f"({rows}, 4) float32 tensor on {device}")
    return table


def _block_array(name: str, what: str, x, dtype, shape, device):
    if (x.dtype != dtype or tuple(x.shape) != tuple(shape)
            or x.device != device or not x.is_contiguous()):
        raise ValueError(
            f"{name}: {what} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}; got {x.dtype} {tuple(x.shape)} "
            f"on {x.device}, contiguous={x.is_contiguous()}")
    return x


def _outputs(shape, device):
    return (torch.empty(shape, dtype=torch.int32, device=device),
            torch.empty(shape, dtype=torch.float32, device=device),
            torch.empty(shape, dtype=torch.int32, device=device))


# csrc/closest_hit.cu: K, the threads that share a ray's sphere loop, is a
# power of two up to a warp.
CH_SPLITS = (1, 2, 4, 8, 16, 32)
# Threads an SM that closest_hit_split aims the grid at (chip_smoke.py's
# sweep of K at the kernel's three shapes; PERF.md) ...
CH_THREADS_PER_SM = 1024
# ... and for closest_hit_sorted and mega_bounce, whose K sweeps are
# fastest at half of that: the sorted kernel gathers its cull block's
# spheres once a thread block, the whole-bounce kernel's shade holds 54
# registers a thread (chip_smoke.py; PERF.md).
SPLIT_THREADS_PER_SM = 512
# The targets of closest_hit_mxu and closest_hit_list: whichever of the two
# above each kernel's own K sweep found fastest (chip_smoke.py; PERF.md).
MXU_THREADS_PER_SM = CH_THREADS_PER_SM
LIST_THREADS_PER_SM = SPLIT_THREADS_PER_SM
# ... and of the two t-space kernels, intersect (ops/cuda_intersect.py)
# and closest_hit_grouped, likewise from their own K sweeps.
IX_THREADS_PER_SM = CH_THREADS_PER_SM
GROUPED_THREADS_PER_SM = SPLIT_THREADS_PER_SM
# csrc/closest_hit_grouped.cu splits a group's 16 spheres: K up to 16.
GROUPED_SPLITS = tuple(k for k in CH_SPLITS if k <= GROUP)


def closest_hit_split(n_lanes: int, n_sms: int,
                      threads_per_sm: int = CH_THREADS_PER_SM) -> int:
    """K for ``csrc/closest_hit.cu``: the smallest power of two, at most
    32, for which ``n_lanes * K`` threads put ``threads_per_sm`` threads
    on each of the card's ``n_sms`` SMs (with 132 SMs and
    ``CH_THREADS_PER_SM``: 8 at the default pool's 32768 lanes, 2 at the
    train shape's 131072, 1 at 2^20; with ``SPLIT_THREADS_PER_SM``, for
    the sorted and whole-bounce kernels, 4 at 32768 lanes, 1 at 2^20)."""
    k = CH_SPLITS[0]
    while k < CH_SPLITS[-1] and n_lanes * k < n_sms * threads_per_sm:
        k *= 2
    return k


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@functools.lru_cache(maxsize=None)
def picked_split(n_lanes: int, device_index: int,
                 threads_per_sm: int = CH_THREADS_PER_SM) -> int:
    """``closest_hit_split`` on this card, worked out once per lane count:
    the K of closest_hit, or with another target (``SPLIT_THREADS_PER_SM``,
    ``MXU_THREADS_PER_SM``, ``LIST_THREADS_PER_SM``) of the other
    split-loop kernels."""
    return closest_hit_split(n_lanes, _sm_count(device_index),
                             threads_per_sm)


def check_split(name: str, split, splits=CH_SPLITS) -> None:
    """``split=`` forces a split-loop kernel's K (for measuring only)."""
    if split is not None and split not in splits:
        raise ValueError(f"{name}: split must be one of {splits}; "
                         f"got {split!r}")


def picked_grouped_split(n_lanes: int, device_index: int) -> int:
    """The K of closest_hit_grouped: the picker aimed at
    ``GROUPED_THREADS_PER_SM``, at most 16 (a group's spheres)."""
    return min(picked_split(n_lanes, device_index, GROUPED_THREADS_PER_SM),
               GROUPED_SPLITS[-1])


def segment_closest_hit(rays, cx, cy, cz, r, t_min, active=None, table=None,
                        split=None):
    """Closest hit over planar rays -> (hit_i, t, sphere_idx).

    rays: 6-tuple of (R, 128) f32 planes; cx/cy/cz/r: (S,) f32 sphere
    geometry; active: optional (R, 128) bool or i32 plane (absent = all
    lanes active); table: optional ``hit_table(cx, cy, cz, r)`` made once
    by a caller that launches many times on one scene. CUDA tensors go
    through the hand-written kernel on the current stream (no
    synchronise); CPU tensors through the plain version. ``split`` forces
    the kernel's K (one of ``CH_SPLITS``) in place of
    ``closest_hit_split``'s; it is for measuring the kernel and changes no
    result.
    """
    check_split("closest_hit", split)
    ox = rays[0]
    if ox.device.type == "cpu":
        return segment_closest_hit_reference(rays, cx, cy, cz, r, t_min,
                                             active)
    shape, device, n_spheres, act = _check_launch(
        "closest_hit", rays, cx, cy, cz, r, active, MAX_SPHERES)
    if table is None:
        table = hit_table(cx, cy, cz, r)
    _check_table("closest_hit", table, n_spheres, device)
    if split is None:
        split = picked_split(ox.numel(), device.index)
    hit, t, sb = _outputs(shape, device)
    fn = kernels.entry("rtw_closest_hit")
    err = fn(act.data_ptr(), *(p.data_ptr() for p in rays),
             table.data_ptr(), hit.data_ptr(), t.data_ptr(), sb.data_ptr(),
             ox.numel(), n_spheres, float(t_min), split,
             torch.cuda.current_stream(device).cuda_stream)
    kernels.check(err, "closest_hit")
    kernels.LAUNCHES["closest_hit"] += 1
    return hit, t, sb


# ---------------------------------------------------------------------------
# Per-cull-block candidate lists: the list kernel and the sorted kernel
# ---------------------------------------------------------------------------

def hit_table_padded(cx, cy, cz, r) -> torch.Tensor:
    """(S + 1, 4) f32 table (cx, cy, cz, r*r) whose last row is the PAD
    sphere (0, 0, 0, -1): its discriminant is b^2 - a(|oc|^2 + 1) <= -a < 0
    (Cauchy-Schwarz), so it can never give a candidate. Lists and sort
    orders pad with its id, S."""
    pad = torch.tensor([[0.0, 0.0, 0.0, -1.0]], dtype=torch.float32,
                       device=cx.device)
    return torch.cat([hit_table(cx, cy, cz, r), pad]).contiguous()


def _closest_over_block_lists(rays, table, ids, n_valid, t_min, rows: int,
                              active):
    """Plain closest hit where cull block b (``rows`` x 128 lanes) tests
    the spheres ``ids[b, :n_valid[b]]`` of the padded ``table`` in that
    order; torch.min keeps the FIRST least candidate, as the kernels'
    strict '<' running min does. n_valid None = every column."""
    shape = rays[0].shape
    device = rays[0].device
    nb, width = ids.shape
    bl = rows * LANES
    t_min = _f32(t_min)
    if n_valid is not None and nb:
        width = min(width, int(n_valid.max()))  # one host read
    hit = torch.zeros((nb, bl), dtype=torch.int32, device=device)
    t = torch.full((nb, bl), BIG, dtype=torch.float32, device=device)
    sb = torch.zeros((nb, bl), dtype=torch.int32, device=device)
    if width > 0:
        ids = ids[:, :width].to(torch.int64)
        ox, oy, oz, dx, dy, dz = (p.reshape(nb, bl, 1) for p in rays)
        col = torch.arange(width, device=device)
        step = max(1, (_REF_CHUNK * 512) // (bl * width))  # blocks a slab
        for lo in range(0, nb, step):
            sl = slice(lo, min(lo + step, nb))
            cand = table[ids[sl]]                     # (b, width, 4)
            vx, vy, vz = dx[sl], dy[sl], dz[sl]
            a = vx * vx + vy * vy + vz * vz
            inv_a = 1.0 / a
            q = _candidates(ox[sl], oy[sl], oz[sl], vx, vy, vz, a,
                            t_min * a, cand[:, None, :, 0],
                            cand[:, None, :, 1], cand[:, None, :, 2],
                            cand[:, None, :, 3])
            if n_valid is not None:
                past = col[None, :] >= n_valid[sl, None]
                q = torch.where(past[:, None, :], torch.full_like(q, BIG), q)
            q_b, k_b = torch.min(q, dim=2)
            h = q_b < BIG
            hit[sl] = h.to(torch.int32)
            t[sl] = torch.where(h, q_b * inv_a[..., 0],
                                torch.full_like(q_b, BIG))
            won = torch.gather(ids[sl], 1, k_b).to(torch.int32)
            # a lane that found nothing keeps index 0, as the running min
            sb[sl] = torch.where(h, won, torch.zeros_like(won))
    return _mask_inactive(hit.reshape(shape), t.reshape(shape),
                          sb.reshape(shape), active)


def _check_blocks(name: str, rays, rows: int) -> int:
    r_total = rays[0].shape[0]
    if rows <= 0 or r_total % rows:
        raise ValueError(f"{name}: {r_total} rows of lanes do not divide "
                         f"into cull blocks of rows={rows}")
    return r_total // rows


def segment_closest_hit_list_reference(rays, cx, cy, cz, r, counts, lists,
                                       t_min, rows: int = 128, active=None):
    """Plain PyTorch version of the list kernel (arguments as
    ``segment_closest_hit_list``)."""
    nb = _check_blocks("closest_hit_list", rays, rows)
    if counts.shape != (nb,) or lists.dim() != 2 or lists.shape[0] != nb:
        raise ValueError(f"closest_hit_list: counts {tuple(counts.shape)} "
                         f"and lists {tuple(lists.shape)} do not describe "
                         f"{nb} cull blocks")
    return _closest_over_block_lists(
        rays, hit_table_padded(cx, cy, cz, r), lists,
        torch.clamp(counts, 0, lists.shape[1]), t_min, rows, active)


def segment_closest_hit_list(rays, cx, cy, cz, r, counts, lists, t_min,
                             rows: int = 128, active=None, table=None,
                             split=None):
    """List-driven closest hit: cull block b tests only its candidates.

    counts: (B,) i32 candidates per cull block (B = R/rows; ops/cull.py
      rounds them up to UNROLL_LIST and pads).
    lists: (B, L) i32 sphere ids, ascending per block; entries past the
      true count must index the pad sphere (id S), which never wins.
    table: optional ``hit_table_padded(cx, cy, cz, r)``.
    split: forces the kernel's K (one of ``CH_SPLITS``) in place of the
      picker's (``LIST_THREADS_PER_SM``); for measuring, changes no result.
    Returns (hit_i, t, sphere_idx) exactly like segment_closest_hit, and
    bit-identical with it wherever the list holds the true winner. CUDA
    tensors go through the hand-written kernel; CPU tensors through the
    plain version.
    """
    check_split("closest_hit_list", split)
    ox = rays[0]
    if ox.device.type == "cpu":
        return segment_closest_hit_list_reference(
            rays, cx, cy, cz, r, counts, lists, t_min, rows, active)
    name = "closest_hit_list"
    shape, device, n_spheres, act = _check_launch(
        name, rays, cx, cy, cz, r, active, MAX_SPHERES - 1)
    nb = _check_blocks(name, rays, rows)
    _block_array(name, "counts", counts, torch.int32, (nb,), device)
    if lists.dim() != 2:
        raise ValueError(f"{name}: lists must be (B, L)")
    list_len = lists.shape[1]
    _block_array(name, "lists", lists, torch.int32, (nb, list_len), device)
    if list_len * 20 > 227 * 1024:
        raise ValueError(f"{name}: lists of {list_len} entries do not fit a "
                         "block's shared memory")
    if table is None:
        table = hit_table_padded(cx, cy, cz, r)
    _check_table(name, table, n_spheres + 1, device)
    if split is None:
        split = picked_split(ox.numel(), device.index, LIST_THREADS_PER_SM)
    hit, t, sb = _outputs(shape, device)
    fn = kernels.entry("rtw_closest_hit_list")
    err = fn(counts.data_ptr(), lists.data_ptr(), act.data_ptr(),
             *(p.data_ptr() for p in rays), table.data_ptr(),
             hit.data_ptr(), t.data_ptr(), sb.data_ptr(), ox.numel(),
             n_spheres, rows * LANES, list_len, float(t_min), split,
             torch.cuda.current_stream(device).cuda_stream)
    kernels.check(err, name)
    kernels.LAUNCHES["closest_hit_list"] += 1
    return hit, t, sb


def sorted_cull_state(active, origins, cx, cy, cz, r, rows: int):
    """Per-cull-block sphere ordering + early-exit bounds for the sorted
    kernel. Plain PyTorch, called once per engine epoch.

    active: (R, 128) bool/i32; origins: (ox, oy, oz) planar (R, 128).
    cx/cy/cz/r: (S,) sphere geometry (the UNPADDED scene arrays).
    Returns (perm (B, S_pad) i32, suf (B, n_chunks+1) f32, oc (B, 3) f32,
    yb (2,) f32) where B = R/rows and S_pad rounds S up to UNROLL (pad
    entries index the pad sphere id S).

    key_j = |O_c - C_j| - |R_j| - margin is a lower bound on any lane's
    hit distance on sphere j minus the lane's distance from the block's
    active-origin centroid O_c. Staleness of O_c between epochs loosens
    the early exit but never its soundness (the kernel measures |o - O_c|
    per segment against the SAME O_c). The sort is stable, as the JAX
    package's is.
    """
    ox, oy, oz = origins
    nb = ox.shape[0] // rows
    s = cx.shape[0]

    def blk(v):
        return v.reshape(nb, rows * LANES)

    act = active if active.dtype == torch.bool else active > 0
    m = blk(act.to(torch.float32))
    n = m.sum(dim=1)
    safe_n = torch.clamp(n, min=1.0)
    ocx = (m * blk(ox)).sum(dim=1) / safe_n
    ocy = (m * blk(oy)).sum(dim=1) / safe_n
    ocz = (m * blk(oz)).sum(dim=1) / safe_n

    rabs = torch.abs(r)[None, :]
    keys = sqrt_rn((cx[None, :] - ocx[:, None]) ** 2
                      + (cy[None, :] - ocy[:, None]) ** 2
                      + (cz[None, :] - ocz[:, None]) ** 2
                      ) - rabs - _SORT_KEY_MARGIN
    order = torch.argsort(keys, dim=1, stable=True)
    ks = torch.gather(keys, 1, order)
    perm = order.to(torch.int32)
    pad = -s % UNROLL
    if pad:
        perm = torch.cat([perm, torch.full((nb, pad), s, dtype=torch.int32,
                                           device=perm.device)], dim=1)
        ks = torch.cat([ks, torch.full((nb, pad), BIG, dtype=torch.float32,
                                       device=ks.device)], dim=1)
    n_chunks = (s + pad) // UNROLL
    cmin = ks.reshape(nb, n_chunks, UNROLL).amin(dim=-1)
    suf = torch.flip(torch.cummin(torch.flip(cmin, [1]), dim=1).values, [1])
    suf = torch.cat([suf, torch.full((nb, 1), BIG, dtype=torch.float32,
                                     device=suf.device)], dim=1)
    yb = torch.stack([torch.max(cy + torch.abs(r)),    # slab top (ymax)
                      torch.min(cy - torch.abs(r))])   # slab bottom (ymin)
    oc = torch.stack([ocx, ocy, ocz], dim=1)
    return perm.contiguous(), suf.contiguous(), oc.contiguous(), yb


def ladder_points(ladder, n_chunks: int) -> list:
    """The checkpoints the sorted kernel uses of a ``ladder``: distinct,
    ascending, inside (0, n_chunks)."""
    return sorted({int(c) for c in ladder if 0 < int(c) < n_chunks})


def _check_sortstate(name: str, sortstate, nb: int, device):
    perm, suf, oc, yb = sortstate
    if perm.dim() != 2 or perm.shape[1] % UNROLL or perm.shape[1] == 0:
        raise ValueError(f"{name}: perm must be (B, S_pad) with S_pad a "
                         f"multiple of {UNROLL}; got {tuple(perm.shape)}")
    n_chunks = perm.shape[1] // UNROLL
    i32, f32 = torch.int32, torch.float32
    _block_array(name, "perm", perm, i32, (nb, perm.shape[1]), device)
    _block_array(name, "suf", suf, f32, (nb, n_chunks + 1), device)
    _block_array(name, "oc", oc, f32, (nb, 3), device)
    _block_array(name, "yb", yb, f32, (2,), device)
    return n_chunks


def segment_closest_hit_sorted_reference(rays, cx, cy, cz, r, sortstate,
                                         t_min, rows: int = 128, active=None,
                                         ladder: tuple = (1, 8)):
    """Plain PyTorch version of the sorted kernel: the candidates in
    ``perm`` order, the first least one wins, mapped back through
    ``perm``. The kernel's early exit changes no result (every bound
    carries slack), so the plain version has none and ``ladder`` does not
    enter it."""
    del ladder
    nb = _check_blocks("closest_hit_sorted", rays, rows)
    _check_sortstate("closest_hit_sorted", sortstate, nb, rays[0].device)
    return _closest_over_block_lists(
        rays, hit_table_padded(cx, cy, cz, r), sortstate[0], None, t_min,
        rows, active)


def segment_closest_hit_sorted(rays, cx, cy, cz, r, sortstate, t_min,
                               rows: int = 128, active=None,
                               ladder: tuple = (1, 8), table=None,
                               stats=None, split=None):
    """Distance-ordered early-exit closest hit.

    sortstate: the tuple from sorted_cull_state (same rows). ladder: chunk
    checkpoints for the staged exit (() = no checks). table: optional
    ``hit_table_padded(cx, cy, cz, r)``. stats: optional (2,) int64 CUDA
    tensor the kernel ADDS (chunks skipped, chunks in all), counted per
    warp with an active lane, to -- how often the exit fires.
    split: forces the kernel's K (one of ``CH_SPLITS``) in place of
    ``closest_hit_split``'s; for measuring, it changes no result.
    Results are identical to segment_closest_hit except on exact f32 q
    ties between distinct spheres (sorted-order vs id-order tie winner).
    CUDA tensors go through the hand-written kernel; CPU tensors through
    the plain version.
    """
    check_split("closest_hit_sorted", split)
    ox = rays[0]
    if ox.device.type == "cpu":
        if stats is not None:
            raise ValueError("closest_hit_sorted: stats= is the kernel's "
                             "counter (CUDA only)")
        return segment_closest_hit_sorted_reference(
            rays, cx, cy, cz, r, sortstate, t_min, rows, active, ladder)
    name = "closest_hit_sorted"
    shape, device, n_spheres, act = _check_launch(
        name, rays, cx, cy, cz, r, active, MAX_SPHERES - 1)
    nb = _check_blocks(name, rays, rows)
    n_chunks = _check_sortstate(name, sortstate, nb, device)
    if n_chunks * UNROLL * 20 > 227 * 1024:
        raise ValueError(f"{name}: {n_chunks * UNROLL} sorted spheres do "
                         "not fit a block's shared memory")
    pts = ladder_points(ladder, n_chunks)
    if len(pts) > MAX_LADDER:
        raise ValueError(f"{name}: a ladder of {len(pts)} checkpoints; the "
                         f"kernel takes at most {MAX_LADDER}")
    if stats is not None:
        _block_array(name, "stats", stats, torch.int64, (2,), device)
    if table is None:
        table = hit_table_padded(cx, cy, cz, r)
    _check_table(name, table, n_spheres + 1, device)
    perm, suf, oc, yb = sortstate
    if split is None:
        split = picked_split(ox.numel(), device.index, SPLIT_THREADS_PER_SM)
    hit, t, sb = _outputs(shape, device)
    c_ladder = (ctypes.c_int * max(len(pts), 1))(*pts)
    fn = kernels.entry("rtw_closest_hit_sorted")
    err = fn(c_ladder, len(pts), perm.data_ptr(), suf.data_ptr(),
             oc.data_ptr(), yb.data_ptr(), act.data_ptr(),
             *(p.data_ptr() for p in rays), table.data_ptr(),
             hit.data_ptr(), t.data_ptr(), sb.data_ptr(),
             None if stats is None else stats.data_ptr(), ox.numel(),
             n_spheres, rows * LANES, n_chunks, float(t_min), split,
             torch.cuda.current_stream(device).cuda_stream)
    kernels.check(err, name)
    kernels.LAUNCHES["closest_hit_sorted"] += 1
    return hit, t, sb


# ---------------------------------------------------------------------------
# The regrouped-products kernel
# ---------------------------------------------------------------------------

def mxu_table(cx, cy, cz, r) -> torch.Tensor:
    """(S, 4) f32 table (cx, cy, cz, |C|^2 - r^2) of the mxu kernel."""
    ccr = cx * cx + cy * cy + cz * cz - r * r
    return torch.stack([cx, cy, cz, ccr], dim=1).contiguous()


def segment_closest_hit_mxu_reference(rays, cx, cy, cz, r, t_min,
                                      active=None):
    """Plain PyTorch version of the mxu kernel: the regrouped arithmetic
    (-b = d.C - d.o, c = (|o|^2 - 2 o.C) + (|C|^2 - r^2)) elementwise over
    (lanes, spheres) in the kernel's operation order -- no matrix product,
    so no reduced-precision path can enter."""
    shape = rays[0].shape
    ox, oy, oz, dx, dy, dz = (p.reshape(-1, 1) for p in rays)
    n = ox.shape[0]
    tab = mxu_table(cx, cy, cz, r)
    tx, ty, tz, ccr = (tab[None, :, k] for k in range(4))
    t_min = _f32(t_min)
    hit = torch.empty(n, dtype=torch.int32, device=ox.device)
    t = torch.empty(n, dtype=torch.float32, device=ox.device)
    sb = torch.empty(n, dtype=torch.int32, device=ox.device)
    for lo in range(0, n, _REF_CHUNK):
        sl = slice(lo, min(lo + _REF_CHUNK, n))
        x, y, z = ox[sl], oy[sl], oz[sl]
        vx, vy, vz = dx[sl], dy[sl], dz[sl]
        a = vx * vx + vy * vy + vz * vz
        d_o = vx * x + vy * y + vz * z
        o_o = x * x + y * y + z * z
        q_min = t_min * a
        d_c = vx * tx + vy * ty + vz * tz
        o_c = x * tx + y * ty + z * tz
        bneg = d_c - d_o
        c = (o_o - (o_c + o_c)) + ccr
        sq = sqrt_rn(bneg * bneg - a * c)  # NaN when disc < 0
        q0 = bneg - sq
        q1 = bneg + sq
        big = torch.full_like(q0, BIG)
        q = torch.where(q0 > q_min, q0, torch.where(q1 > q_min, q1, big))
        q_b, s_b = torch.min(q, dim=1)  # the first least index wins ties
        h = q_b < BIG
        hit[sl] = h.to(torch.int32)
        t[sl] = torch.where(h, q_b / a[:, 0], torch.full_like(q_b, BIG))
        sb[sl] = torch.where(h, s_b, torch.zeros_like(s_b)).to(torch.int32)
    return _mask_inactive(hit.reshape(shape), t.reshape(shape),
                          sb.reshape(shape), active)


def segment_closest_hit_mxu(rays, cx, cy, cz, r, t_min, active=None,
                            table=None, split=None):
    """Regrouped-products closest hit; same contract as
    segment_closest_hit up to f32 rounding on knife-edge candidates
    (planes in, planes out; at most MXU_MAX_SPHERES spheres). table:
    optional ``mxu_table(cx, cy, cz, r)``. ``split`` forces the kernel's K
    (one of ``CH_SPLITS``) in place of the picker's
    (``MXU_THREADS_PER_SM``); for measuring, it changes no result. CUDA
    tensors go through the hand-written kernel; CPU tensors through the
    plain version.
    """
    check_split("closest_hit_mxu", split)
    n_spheres = cx.shape[0]
    if n_spheres > MXU_MAX_SPHERES:
        raise ValueError(f"closest_hit_mxu: {n_spheres} spheres; at most "
                         f"{MXU_MAX_SPHERES}")
    ox = rays[0]
    if ox.device.type == "cpu":
        return segment_closest_hit_mxu_reference(rays, cx, cy, cz, r, t_min,
                                                 active)
    name = "closest_hit_mxu"
    shape, device, n_spheres, act = _check_launch(
        name, rays, cx, cy, cz, r, active, MXU_MAX_SPHERES)
    if table is None:
        table = mxu_table(cx, cy, cz, r)
    _check_table(name, table, n_spheres, device)
    if split is None:
        split = picked_split(ox.numel(), device.index, MXU_THREADS_PER_SM)
    hit, t, sb = _outputs(shape, device)
    fn = kernels.entry("rtw_closest_hit_mxu")
    err = fn(act.data_ptr(), *(p.data_ptr() for p in rays),
             table.data_ptr(), hit.data_ptr(), t.data_ptr(), sb.data_ptr(),
             ox.numel(), n_spheres, float(t_min), split,
             torch.cuda.current_stream(device).cuda_stream)
    kernels.check(err, name)
    kernels.LAUNCHES["closest_hit_mxu"] += 1
    return hit, t, sb


# ---------------------------------------------------------------------------
# The sphere-group kernel
# ---------------------------------------------------------------------------

def group_order(sphere_params) -> torch.Tensor:
    """The permutation ``group_scene`` sorts the spheres by: a STABLE
    argsort of the (z-cell, x-cell) key of the centres (cells of 2 units),
    as the JAX package's ``jnp.argsort``. Sorted position k holds sphere
    ``group_order(...)[k]``."""
    cx, cz = sphere_params[0], sphere_params[2]
    cell = 2.0
    key = torch.floor(cz / cell) * 4096 + torch.floor(cx / cell)
    return torch.argsort(key, stable=True)


def group_scene(sphere_params):
    """Sort spheres into depth-band groups; a bounding sphere per group.

    Input/output: the 10-tuple of ``sphere_params_from_scene``, reordered by
    ``group_order`` and padded to a multiple of GROUP (pads repeat the last
    centre with r = 0 and zero materials: by Cauchy-Schwarz their
    discriminant is never positive). Returns (sorted_params, (gx, gy, gz,
    gr)): per group the centre of the extent of its centres and the
    largest distance from it plus |r|.
    """
    perm = group_order(sphere_params)
    params = [a[perm] for a in sphere_params]
    s = perm.shape[0]
    pad = -s % GROUP
    if pad:
        params = [torch.cat([a, (a[-1:] if i < 3 else torch.zeros_like(
            a[:1])).expand(pad)]) for i, a in enumerate(params)]
    cx, cy, cz, r = params[:4]
    n_g = cx.shape[0] // GROUP
    bx, by, bz, br = (v.reshape(n_g, GROUP) for v in (cx, cy, cz, r))
    gx = (bx.amin(dim=1) + bx.amax(dim=1)) * 0.5
    gy = (by.amin(dim=1) + by.amax(dim=1)) * 0.5
    gz = (bz.amin(dim=1) + bz.amax(dim=1)) * 0.5
    ex, ey, ez = bx - gx[:, None], by - gy[:, None], bz - gz[:, None]
    d = sqrt_rn(ex * ex + ey * ey + ez * ez)
    gr = (d + torch.abs(br)).amax(dim=1)
    return tuple(params), (gx, gy, gz, gr)


def _check_groups(name: str, cx, group_params, device) -> int:
    """The grouped kernel's sorted table and bounds -> the group count."""
    s_pad = cx.shape[0]
    if s_pad % GROUP:
        raise ValueError(f"{name}: {s_pad} sorted spheres is not a multiple "
                         f"of {GROUP} (group_scene pads them)")
    n_g = s_pad // GROUP
    if len(group_params) != 4:
        raise ValueError(f"{name}: group_params must be (gx, gy, gz, gR)")
    for k, g in zip(("gx", "gy", "gz", "gR"), group_params):
        _block_array(name, k, g, torch.float32, (n_g,), device)
    return n_g


def segment_closest_hit_grouped_reference(rays, cx, cy, cz, r, group_params,
                                          t_min, active=None):
    """Plain PyTorch version of the grouped kernel: the t-space min loop
    (ops/intersect.closest_hit) over the whole sorted table, with no cull
    -- the bound is conservative, so the cull changes no result. Arguments
    as ``segment_closest_hit_grouped``."""
    from .intersect import closest_hit

    _check_groups("closest_hit_grouped", cx, group_params, cx.device)
    shape = rays[0].shape
    o = torch.stack([p.reshape(-1) for p in rays[:3]], dim=1)
    d = torch.stack([p.reshape(-1) for p in rays[3:]], dim=1)
    t, idx, hit = closest_hit(o, d, torch.stack([cx, cy, cz], dim=1), r,
                              _f32(t_min))
    return _mask_inactive(hit.to(torch.int32).reshape(shape),
                          t.reshape(shape), idx.reshape(shape), active)


def segment_closest_hit_grouped(rays, cx, cy, cz, r, group_params, t_min,
                                active=None, stats=None, split=None):
    """Closest hit with per-warp sphere-group culling -> (hit_i, t,
    sphere_idx), the index into the SORTED order.

    cx/cy/cz/r: the sorted, padded geometry of ``group_scene`` (S_pad, a
    multiple of GROUP); group_params: its (gx, gy, gz, gR), (S_pad/GROUP,)
    each. stats: optional (2,) int64 CUDA tensor the kernel ADDS (groups
    skipped, groups in all), counted per warp with an active lane, to.
    ``split`` forces the kernel's K (one of ``GROUPED_SPLITS``) in place of
    ``picked_grouped_split``'s; for measuring, it changes no result.
    Results are those of the unculled t-space loop (the bound is
    conservative). CUDA tensors go through the hand-written kernel; CPU
    tensors through the plain version.
    """
    check_split("closest_hit_grouped", split, GROUPED_SPLITS)
    ox = rays[0]
    if ox.device.type == "cpu":
        if stats is not None:
            raise ValueError("closest_hit_grouped: stats= is the kernel's "
                             "counter (CUDA only)")
        return segment_closest_hit_grouped_reference(
            rays, cx, cy, cz, r, group_params, t_min, active)
    name = "closest_hit_grouped"
    shape, device, _, act = _check_launch(name, rays, cx, cy, cz, r, active,
                                          GROUP_MAX_SPHERES)
    n_g = _check_groups(name, cx, group_params, device)
    if stats is not None:
        _block_array(name, "stats", stats, torch.int64, (2,), device)
    table = torch.stack([cx, cy, cz, r], dim=1).contiguous()
    bounds = torch.stack(list(group_params), dim=1).contiguous()
    if split is None:
        split = picked_grouped_split(ox.numel(), device.index)
    hit, t, sb = _outputs(shape, device)
    fn = kernels.entry("rtw_closest_hit_grouped")
    err = fn(act.data_ptr(), *(p.data_ptr() for p in rays),
             table.data_ptr(), bounds.data_ptr(), hit.data_ptr(),
             t.data_ptr(), sb.data_ptr(),
             None if stats is None else stats.data_ptr(), ox.numel(), n_g,
             float(t_min), split,
             torch.cuda.current_stream(device).cuda_stream)
    kernels.check(err, name)
    kernels.LAUNCHES["closest_hit_grouped"] += 1
    return hit, t, sb


# ---------------------------------------------------------------------------
# Dispatch and the segment's surface planes
# ---------------------------------------------------------------------------

def closest_hit_planar(rays, cx, cy, cz, r, t_min, active=None,
                       kernel: str = "sublane", table=None):
    """Dispatch between the two whole-table closest-hit kernels: "mxu" up
    to MXU_MAX_SPHERES spheres, else the sublane kernel (as the JAX
    package's dispatcher). ``table`` is the chosen kernel's own
    (``hit_table`` or ``mxu_table``). The sorted kernel needs a sort state
    and is not dispatched here."""
    if kernel == "sorted":
        raise ValueError("closest_hit_planar: the sorted kernel takes a sort "
                         "state; call segment_closest_hit_sorted")
    if kernel not in ("sublane", "mxu"):
        raise ValueError(f"unknown hit_kernel: {kernel!r}")
    if kernel == "mxu" and cx.shape[0] <= MXU_MAX_SPHERES:
        return segment_closest_hit_mxu(rays, cx, cy, cz, r, t_min,
                                       active=active, table=table)
    return segment_closest_hit(rays, cx, cy, cz, r, t_min, active=active,
                               table=table)


def surface_from_params(rays, params, hit_i, t_b):
    """(hit, t) and the winner's 10 resolved param planes -> the
    segment's surface/material planes: dict of hit (i32 0/1), t, px py pz
    (hit point), nx ny nz (normal; a negative radius flips it inward),
    mt (i32), ar ag ab, fz, io."""
    cx_b, cy_b, cz_b, r_b, mt, ar, ag, ab, fz, io = params
    ox, oy, oz, dx, dy, dz = rays
    hit = hit_i > 0
    t_safe = torch.where(hit, t_b, torch.ones_like(t_b))
    px = ox + t_safe * dx
    py = oy + t_safe * dy
    pz = oz + t_safe * dz
    inv_r = 1.0 / torch.where(r_b != 0.0, r_b, torch.ones_like(r_b))
    return {
        "hit": hit_i, "t": t_b, "px": px, "py": py, "pz": pz,
        "nx": (px - cx_b) * inv_r, "ny": (py - cy_b) * inv_r,
        "nz": (pz - cz_b) * inv_r,
        "mt": mt, "ar": ar, "ag": ag,
        "ab": ab, "fz": fz, "io": io,
    }


def resolve_segment(rays, sphere_params, hit_i, t_b, s_b):
    """Winning (hit, t, idx) -> full surface/material planes (the dict of
    ``surface_from_params``)."""
    return surface_from_params(rays, resolve_params(s_b, sphere_params),
                               hit_i, t_b)


def trace_segment(rays, sphere_params, t_min, active=None,
                  group_params=None, hit_kernel: str = "sublane",
                  table=None):
    """One trace segment over planar ray state: closest hit, then the
    winner's surface and material planes (``resolve_segment``).

    rays: 6 planar (R, 128) f32 planes; sphere_params: the 10-tuple of
    ``sphere_params_from_scene``; active: optional (R, 128) bool/i32
    plane; hit_kernel: "sublane" or "mxu"; table: the kernel's table.
    group_params: the bounds of ``group_scene``, whose SORTED params
    ``sphere_params`` must then be; the grouped kernel runs
    (``segment_closest_hit_grouped``) and ``hit_kernel`` and ``table`` are
    not read.
    """
    cx, cy, cz, r = sphere_params[:4]
    if group_params is not None:
        hit_i, t_b, s_b = segment_closest_hit_grouped(
            rays, cx, cy, cz, r, group_params, t_min, active=active)
    else:
        hit_i, t_b, s_b = closest_hit_planar(rays, cx, cy, cz, r, t_min,
                                             active=active,
                                             kernel=hit_kernel, table=table)
    return resolve_segment(rays, sphere_params, hit_i, t_b, s_b)


def trace_segment_list(rays, sphere_params, counts, lists, t_min,
                       rows: int = 128, active=None, table=None):
    """trace_segment driven by per-block candidate lists (ops/cull.py).

    Same outputs as trace_segment; winners are bit-identical whenever the
    lists are conservative (they contain every possible closest hit).
    """
    cx, cy, cz, r = sphere_params[:4]
    hit_i, t_b, s_b = segment_closest_hit_list(
        rays, cx, cy, cz, r, counts, lists, t_min, rows=rows, active=active,
        table=table)
    return resolve_segment(rays, sphere_params, hit_i, t_b, s_b)


# ---------------------------------------------------------------------------
# State carried across from numpy
# ---------------------------------------------------------------------------

def sortstate_from_numpy(perm, suf, oc, yb, device=None) -> tuple:
    """A sort state as numpy arrays (the JAX package's
    ``sorted_cull_state``) -> the port's tuple of tensors on ``device``
    (None = the CUDA card)."""
    device = resolve_device(device)
    return (torch.from_numpy(np.array(perm, dtype=np.int32)).to(device),
            *(torch.from_numpy(np.array(x, dtype=np.float32)).to(device)
              for x in (suf, oc, yb)))


def cull_lists_from_numpy(counts, lists, device=None) -> tuple:
    """(counts, lists) as numpy arrays (the JAX package's
    ``cull.candidate_lists``) -> i32 tensors on ``device`` (None = the
    CUDA card)."""
    device = resolve_device(device)
    return tuple(torch.from_numpy(np.array(x, dtype=np.int32)).to(device)
                 for x in (counts, lists))
