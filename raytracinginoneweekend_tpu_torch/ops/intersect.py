"""Closest-hit over the sphere list: a streamed masked argmin.

The port's copy of ``raytracinginoneweekend_tpu/ops/intersect.py``.
Reference semantics being re-expressed:
  - per-sphere quadratic with near root preferred, far root as fallback,
    both tested against the (t_min, inf) window
    (raytracer.hxx:52-92; cuda_impl.cu:128-170);
  - closest hit = minimum valid t over all spheres; ties keep the earliest
    sphere index (CPU stable min_element, raytracer.hxx:108-113; CUDA strict
    `<` running min, cuda_impl.cu:183-188).

``closest_hit`` is plain PyTorch: (N, B) candidates from (N, 1) x (1, B)
broadcasts of the components, streamed over sphere blocks of size
``sphere_block`` with a running (t, idx) minimum, and over slabs of rays so
that the intermediates stay bounded. It is also the PLAIN VERSION of the
hand-written CUDA kernel behind ``ops/cuda_intersect.closest_hit_cuda``
(TPU kernel ``pallas_intersect.py::_kernel``): the same candidate formula
-- guarded discriminant, ``t = (-b -/+ sqrt(disc)) * (1/a)``, each root
tested ``> t_min`` -- in the same operation order.

``closest_hit_diff`` is the differentiable form: a
``torch.autograd.Function`` whose forward is either of the two and whose
backward is the analytic O(N) implicit-function formula, in plain PyTorch
(the JAX package has no backward kernel either).
"""

from __future__ import annotations

import torch

from .math3 import sqrt_rn

BIG = 1e30  # "no hit" sentinel
_RAY_CHUNK = 1 << 16  # rays per slab of the (N, B) intermediates


def _block_candidates(ox, oy, oz, dx, dy, dz, a, inv_a, cx, cy, cz, rad,
                      t_min):
    """Per-sphere candidate t for one block; all args broadcast to (N, B).

    Mirrors raytracer.hxx:55-91: oc = origin - center; b = oc . dir;
    c = oc . oc - r^2; disc = b^2 - a*c; roots (-b -/+ sqrt(disc)) / a,
    near preferred.
    """
    ocx = ox - cx
    ocy = oy - cy
    ocz = oz - cz
    b = ocx * dx + ocy * dy + ocz * dz
    c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    disc = b * b - a * c
    pos = disc > 0.0
    # "double where": sqrt never sees negatives.
    sq = sqrt_rn(torch.where(pos, disc, torch.ones_like(disc)))
    nb = -b
    t0 = (nb - sq) * inv_a
    t1 = (nb + sq) * inv_a
    v0 = pos & (t0 > t_min)
    v1 = pos & (t1 > t_min)
    big = torch.full_like(t0, BIG)
    return torch.where(v0, t0, torch.where(v1, t1, big))


def closest_hit(origin, direction, centers, radii, t_min,
                sphere_block: int = 512):
    """Vectorized closest hit, plain PyTorch.

    origin, direction: (N, 3) f32 rays; centers: (S, 3) f32; radii: (S,)
    f32 (negative radii allowed, quirk Q10); t_min: scalar epsilon;
    sphere_block: streaming block size over the sphere axis.

    Returns t (N,) f32 (BIG where no hit), idx (N,) i32 (0 where no hit),
    hit (N,) bool. Not differentiable by itself as the engines use it:
    see ``closest_hit_diff``. Float64 rays or spheres give a float64 t
    (the gradient checks trace a float64 witness through this function).
    """
    n, s = origin.shape[0], centers.shape[0]
    dev = origin.device
    dtype = torch.promote_types(origin.dtype, centers.dtype)
    t_out = torch.empty(n, dtype=dtype, device=dev)
    i_out = torch.empty(n, dtype=torch.int32, device=dev)
    cx, cy, cz = (centers[:, k][None, :] for k in range(3))
    rad = radii[None, :]
    for lo in range(0, n, _RAY_CHUNK):
        sl = slice(lo, min(lo + _RAY_CHUNK, n))
        ox, oy, oz = (origin[sl, k:k + 1] for k in range(3))
        dx, dy, dz = (direction[sl, k:k + 1] for k in range(3))
        a = dx * dx + dy * dy + dz * dz  # dot(dir, dir), raytracer.hxx:57
        inv_a = 1.0 / a
        t_best = torch.full((a.shape[0],), BIG, dtype=dtype, device=dev)
        i_best = torch.zeros(a.shape[0], dtype=torch.int64, device=dev)
        for base in range(0, s, sphere_block):
            bl = slice(base, min(base + sphere_block, s))
            tc = _block_candidates(ox, oy, oz, dx, dy, dz, a, inv_a,
                                   cx[:, bl], cy[:, bl], cz[:, bl],
                                   rad[:, bl], t_min)
            # torch.min returns the FIRST minimal index: within a block
            # the earliest sphere wins ties.
            tb, ib = torch.min(tc, dim=1)
            better = tb < t_best  # strict: ties keep the earlier block
            t_best = torch.where(better, tb, t_best)
            i_best = torch.where(better, ib + base, i_best)
        t_out[sl] = t_best
        i_out[sl] = i_best.to(torch.int32)
    return t_out, i_out, t_out < BIG


def sum_by_winner(idx64, rows, n_spheres: int):
    """Per-sphere sums of per-ray rows: out[s] = sum of rows[i] over the
    rays with idx64[i] == s. idx64: (N,) int64; rows: (N,) or (N, K).

    The (N,) -> (S,) half of both closest-hit backward passes (the per-ray
    table gathers, ``gather_rows``, take the same sum). It is one
    ``index_add_`` (atomic adds on the card) into a float64 accumulator,
    rounded once to the rows' dtype: a float32 running sum of a train step's ~10^5 rows a sphere
    carried rounding of ~3e-5 of the sum, which moved with the order of the
    card's atomics and with a split of the rows over workers
    (parallel/mesh.py); in float64 the sum is the same to the bit from run
    to run, and a split sum agrees with the whole to its last rounding.
    (The JAX package takes the same sum as a one-hot matrix product;
    chip_smoke.py times both forms on the card, PERF.md has the numbers.)
    """
    wide = torch.float64 if rows.dtype == torch.float32 else rows.dtype
    out = torch.zeros((n_spheres,) + tuple(rows.shape[1:]), dtype=wide,
                      device=rows.device)
    return out.index_add_(0, idx64, rows.to(wide)).to(rows.dtype)


class _GatherRows(torch.autograd.Function):
    """table.index_select(0, idx64) with ``sum_by_winner`` as its backward."""

    @staticmethod
    def forward(ctx, table, idx64):
        ctx.save_for_backward(idx64)
        ctx.n_rows = table.shape[0]
        return table.index_select(0, idx64)

    @staticmethod
    def backward(ctx, g_rows):
        (idx64,) = ctx.saved_tensors
        return sum_by_winner(idx64, g_rows, ctx.n_rows), None


def gather_rows(table, idx64):
    """``table.index_select(0, idx64)`` whose backward is ``sum_by_winner``
    (float64 accumulation, rounded once) rather than autograd's float32
    ``index_add_``. The forward is the plain gather, so a forward-only
    caller (``torch.no_grad``, a target render) pays nothing for it. The
    per-ray gathers of scene parameters in the AD engines."""
    return _GatherRows.apply(table, idx64)


class _ClosestHitDiff(torch.autograd.Function):
    """closest_hit with an analytic O(N) backward (see closest_hit_diff)."""

    @staticmethod
    def forward(ctx, origin, direction, centers, radii, t_min, sphere_block,
                use_pallas):
        with torch.no_grad():
            if use_pallas:
                from .cuda_intersect import closest_hit_cuda

                # a camera's origins may be one point expanded to (N, 3):
                # the kernel reads dense rows
                t, idx, hit = closest_hit_cuda(origin.contiguous(),
                                               direction.contiguous(),
                                               centers, radii, t_min)
            else:
                t, idx, hit = closest_hit(origin, direction, centers, radii,
                                          t_min, sphere_block)
        ctx.save_for_backward(origin, direction, centers, radii, t, idx, hit)
        ctx.mark_non_differentiable(idx, hit)
        return t, idx, hit

    @staticmethod
    def backward(ctx, g_t, _g_idx, _g_hit):
        origin, direction, centers, radii, t, idx, hit = ctx.saved_tensors
        idx64 = idx.to(torch.int64)
        t_safe = torch.where(hit, t, torch.ones_like(t))
        c_hit = centers.index_select(0, idx64)
        r_hit = radii.index_select(0, idx64)
        p = origin + t_safe[:, None] * direction
        pc = p - c_hit  # (N, 3)
        denom = torch.sum(pc * direction, dim=-1)  # (p-c).d
        # Grazing hits (denom -> 0) have unbounded dt; zero them like the
        # sanitized no-hit lanes (standard for silhouette-adjacent samples).
        good = hit & (denom.abs() > 1e-12)
        scale = torch.where(
            good, g_t / torch.where(good, denom, torch.ones_like(denom)),
            torch.zeros_like(g_t))
        g_c_rows = scale[:, None] * pc  # dt/dc = (p-c)/denom
        g_r_rows = scale * r_hit  # dt/dr = r/denom
        # (N,) -> (S,) sums. Rows with scale = 0 (no hit / grazing) add
        # nothing wherever their idx points.
        g_centers = g_radii = None
        n_spheres = centers.shape[0]
        if ctx.needs_input_grad[2]:
            g_centers = sum_by_winner(idx64, g_c_rows, n_spheres)
        if ctx.needs_input_grad[3]:
            g_radii = sum_by_winner(idx64, g_r_rows, n_spheres)
        g_origin = -g_c_rows if ctx.needs_input_grad[0] else None
        g_direction = (-t_safe[:, None] * g_c_rows
                       if ctx.needs_input_grad[1] else None)
        return g_origin, g_direction, g_centers, g_radii, None, None, None


def closest_hit_diff(origin, direction, centers, radii, t_min,
                     sphere_block: int = 512, use_pallas: bool = False):
    """closest_hit with an analytic O(N) backward pass -> (t, idx, hit).

    Autograd through the (N, S) candidate broadcast would hold the whole
    candidate tensor; but t locally depends only on the WINNING sphere
    (argmin is piecewise constant), so implicit differentiation of
    F = |o + t d - c|^2 - r^2 = 0 gives

        dt = [ (p-c).dc + r dr - (p-c).do - t (p-c).dd ] / ((p-c).d)

    with p = o + t d -- all O(N) elementwise plus one (N,)->(S,) sum for
    the sphere cotangents (``sum_by_winner``).

    use_pallas=True (the JAX package's name for "the hand-written kernel")
    takes the forward from ops/cuda_intersect.closest_hit_cuda: the CUDA
    kernel on CUDA tensors, the plain version on CPU tensors.
    """
    return _ClosestHitDiff.apply(origin, direction, centers, radii,
                                 float(t_min), int(sphere_block),
                                 bool(use_pallas))


def hit_surface(origin, direction, t, idx, hit, centers, radii):
    """Position and normal at the hit point (gathered per ray).

    p = o + t*d (math.hxx:349-352 point_at); n = (p - c)/r
    (raytracer.hxx:71; negative r flips the normal inward -- hollow glass,
    quirk Q10). ``t`` and the gathered radius are sanitized where no hit so
    dead lanes never produce inf/NaN that would poison a gradient.
    """
    t_safe = torch.where(hit, t, torch.ones_like(t))
    idx64 = idx.to(torch.int64)
    c_hit = gather_rows(centers, idx64)
    r_hit = gather_rows(radii, idx64)
    r_safe = torch.where(hit, r_hit, torch.ones_like(r_hit))
    p = origin + t_safe[:, None] * direction
    nrm = (p - c_hit) / r_safe[:, None]
    return p, nrm
