"""The AD pool's shade step and regen as one op: a forward kernel and its
adjoint kernel under one ``torch.autograd.Function`` -- CUDA kernel
wrappers and plain version.

  pool iteration = closest hit (ops/integrate_planar.closest_hit_planar)
                   -> [THIS OP: winner lookup + hit point and normal +
                       bounce draws + scatter + sky + throughput and
                       Russian roulette + the deposit's values and cells
                       + regen: each lane left idle takes its next ray]
                   -> the ledger write (``index_copy``, in the caller)
  (one eager ``regen_reference`` before a trace's first iteration)

KERNEL NOTE. ``csrc/ad_shade.cu`` replaces no TPU kernel: the JAX package
leaves this step to XLA, which fuses it. Run eagerly, the shade is ~620
small launches an iteration forward and the regen ~50, as many again when
the checkpoint recomputes the epoch, and ~460 autograd nodes in the
backward; the card waits on the host. ``ad_shade_kernel`` does the
forward's arithmetic, one thread a lane, and ``ad_shade_grad_kernel`` the
adjoint: it recomputes the lane's forward values in registers from the
same inputs, then sweeps them in reverse. Each moves ~120-180 bytes a lane
and is bound by latency (serial threefry chains, then the shade) at the
pool's 32768 lanes. The winner's ten parameters are read straight from the
(S, 10) table by the sphere index, as kernel 2 reads them; the backward
writes one row of the table's gradient a lane, which ``index_add_`` sums
by sphere, as ``index_select``'s backward did. An acquiring lane reads its
ray from the ``RayTables`` by its ray id. Each call's outputs are views of
one allocation per dtype.

``ad_shade_reference`` (the pool's shade step) followed by
``regen_reference`` is the plain version, ``op_reference``: the eager
chain, which autograd differentiates. The adjoint kernel follows
autograd's rules through it: a ``where`` selects a gradient and never
multiplies by a mask, so what the unselected branch holds (a miss lane's
t, a lambert's ior of 0) cannot reach a gradient, and the planes a lane's
acquire overwrote pass none back to the shade; the Russian-roulette q is a
constant (``stop_grad``); the material type, the draws, the depth, the
keys, the masks and the ray tables carry none. Where autograd's own result
is finite the two agree to float32 reassociation; they part only where
autograd carries a NaN from an unselected branch (0 * inf), or takes the
root's gradient at a direction of length <= FLT_MIN (0 / 0), where the
kernel gives 0.

For a tensor on the CPU the op is the plain version under autograd; for a
CUDA tensor it launches the kernels or raises -- it never falls back.
"""

from __future__ import annotations

import ctypes
import typing

import torch

from .. import kernels
from ..config import TraceOptions
from . import planar, rng
from .cuda_segment import check_current_device
from .integrate_planar import scatter_planar_ad, shade_geometry_planar
from .planar import SKY_BLUE, SKY_WHITE

_F32, _I32 = torch.float32, torch.int32


class Spec(typing.NamedTuple):
    """What the op takes besides tensors: the depth cap, the options, the
    first dump cell of the ledger (its wave cells' count, W * L for W
    waves of L lanes) and the true ray count (the rest of the last wave
    is pad)."""
    max_depth: int
    options: TraceOptions
    w_cells: int
    n_rays: int


class RayTables(typing.NamedTuple):
    """Every ray of a trace in the wave-major ray order (ray w * L + lane
    is wave w's ray of lane l; ops/wavefront_ad._ray_tables): what a lane
    that acquires a ray reads. floats: (6, W * L) float32, origin and
    direction, or (9, W * L) with the first-bounce scatter vector under
    sampling="stratified"; keys: (2, W * L) int32, the key words."""
    floats: torch.Tensor
    keys: torch.Tensor


def _lane_ids(plane):
    return torch.arange(plane.numel(), dtype=torch.int32,
                        device=plane.device).reshape(plane.shape)


def _sky_bias(options: TraceOptions) -> float:
    return 0.5 if options.sky == "cuda" else 1.0


def ad_shade_reference(table, state, khit, strat0, spec: Spec):
    """Plain PyTorch version of ``ad_shade_kernel``: one bounce downstream
    of the closest hit.

    table: ``integrate_planar._material_table(scene)``; state: the pool's
    lane-state tuple (ops/wavefront_ad.py); khit: (t, sphere_idx, hit_i);
    strat0: the first-bounce scatter vectors of this iteration's regen
    (valid on the depth == 0 lanes), substituted there, or None.
    Returns (state, deposit, cell): the next state, the (3, L) radiance of
    each lane's deposit (zero but on a miss) and each lane's ledger cell
    (the ray's wave cell ``wcur * L + lane`` on a miss, else the lane's
    dump cell ``w_cells + lane``).
    """
    (nxtw, wcur, active, ox, oy, oz, dx, dy, dz, ax, ay, az, depth,
     k0, k1) = state
    options, max_depth = spec.options, spec.max_depth
    shape = ox.shape
    lanes = ox.numel()

    t, sb, hit_i = khit
    params = table.index_select(0, sb.reshape(-1).to(torch.int64))

    def col(i):
        return params[:, i].reshape(shape)

    mt = col(4).to(torch.int32)
    alr, alg, alb_ = col(5), col(6), col(7)
    fz, io = col(8), col(9)

    hit, px, py, pz, nx, ny, nz = shade_geometry_planar(
        (ox, oy, oz, dx, dy, dz), khit, (col(0), col(1), col(2), col(3)))

    # Per-bounce randomness: per-LANE depth plane (tasks sit at mixed
    # depths), same (pixel, sample, bounce) contract as every engine.
    rvx, rvy, rvz, ru = planar.bounce_draws(
        k0, k1, depth, options.scatter_sample == "unit")
    if strat0 is not None:
        svx, svy, svz = strat0
        m0 = depth == 0
        rvx = torch.where(m0, svx, rvx)
        rvy = torch.where(m0, svy, rvy)
        rvz = torch.where(m0, svz, rvz)

    ndx, ndy, ndz, valid, uy = scatter_planar_ad(
        (dx, dy, dz), (nx, ny, nz), (mt, fz, io), (rvx, rvy, rvz, ru),
        options)

    miss_now = active & ~hit
    scatter_now = active & hit & valid
    keep = scatter_now & (depth + 1 < max_depth)

    # sky (cuda_impl.cu:123-126 / main.cxx:47-50), unclamped mix
    tsky = 0.5 * uy + _sky_bias(options)
    miss_f = miss_now.to(torch.float32)
    cr = miss_f * ax * (SKY_WHITE[0] * (1.0 - tsky) + SKY_BLUE[0] * tsky)
    cg = miss_f * ay * (SKY_WHITE[1] * (1.0 - tsky) + SKY_BLUE[1] * tsky)
    cb = miss_f * az * (SKY_WHITE[2] * (1.0 - tsky) + SKY_BLUE[2] * tsky)

    # Wave-indexed deposit: ray (wcur, lane) writes its unique cell; the
    # other lanes write a zero into their own dump cell.
    lane = torch.arange(lanes, dtype=torch.int64, device=ox.device)
    cell = torch.where(miss_now.reshape(-1),
                       wcur.reshape(-1).to(torch.int64) * lanes + lane,
                       spec.w_cells + lane)
    deposit = torch.stack([cr.reshape(-1), cg.reshape(-1), cb.reshape(-1)])

    ox = torch.where(keep, px, ox)
    oy = torch.where(keep, py, oy)
    oz = torch.where(keep, pz, oz)
    dx = torch.where(keep, ndx, dx)
    dy = torch.where(keep, ndy, dy)
    dz = torch.where(keep, ndz, dz)
    ax = torch.where(keep, ax * alr, ax)
    ay = torch.where(keep, ay * alg, ay)
    az = torch.where(keep, az * alb_, az)
    if options.rr_terminate:
        # RR path termination: the shared contract with the survival
        # weights held constant (rng.rr_terminate_update). A killed lane
        # regenerates next iteration, so the saving is real in forward
        # and backward.
        ax, ay, az, keep = rng.rr_terminate_update(
            k0, k1, depth, ax, ay, az, keep, rr_start=options.rr_start,
            rr_qmin=options.rr_qmin, rr_scale=options.rr_scale)
    depth = torch.where(keep, depth + 1, depth)
    state = (nxtw, wcur, keep, ox, oy, oz, dx, dy, dz, ax, ay, az,
             depth, k0, k1)
    return state, deposit, cell


def regen_reference(state, rays: RayTables, *, n: int, w: int):
    """Plain PyTorch version of ``ad_shade_kernel``'s regen: each idle
    lane takes its next strided ray, ray ``nxtw * L + lane``, from
    ``rays``; one whose next ray is in the last wave's pad (only the last
    wave is padded, and later waves' ids only grow) is out of work for
    good and parks nxtw at ``w``. n: the true ray count; w: the waves.
    Returns (state, busy): busy is each lane's "tracing, or waves left"
    before the regen, which the pool's drain test reads."""
    (nxtw, wcur, active, ox, oy, oz, dx, dy, dz, ax, ay, az, depth,
     k0, k1) = state
    lanes = nxtw.numel()
    idle = ~active
    can = nxtw < w
    busy = active | can
    ray = nxtw * lanes + _lane_ids(nxtw)
    in_range = ray < n
    acquire = idle & can & in_range
    nxtw = torch.where(idle & can & ~in_range, torch.full_like(nxtw, w),
                       nxtw)

    at = torch.clamp(ray, 0, n - 1).reshape(-1).to(torch.int64)
    nox, noy, noz, ndx, ndy, ndz = rays.floats[:6].index_select(
        1, at).reshape(6, *nxtw.shape)
    rk0, rk1 = rays.keys.index_select(1, at).reshape(2, *nxtw.shape)

    one = torch.ones_like(ax)
    state = (torch.where(acquire, nxtw + 1, nxtw),
             torch.where(acquire, nxtw, wcur), active | acquire,
             torch.where(acquire, nox, ox), torch.where(acquire, noy, oy),
             torch.where(acquire, noz, oz), torch.where(acquire, ndx, dx),
             torch.where(acquire, ndy, dy), torch.where(acquire, ndz, dz),
             torch.where(acquire, one, ax), torch.where(acquire, one, ay),
             torch.where(acquire, one, az),
             torch.where(acquire, torch.zeros_like(depth), depth),
             torch.where(acquire, rk0, k0), torch.where(acquire, rk1, k1))
    return state, busy


def strat0_reference(state, rays: RayTables, n: int):
    """The first-bounce scatter vectors that ``ad_shade_reference``
    substitutes on the depth-0 lanes, each read at the lane's own ray
    ``wcur * L + lane`` (a lane at depth 0 traces the ray it acquired);
    None without them in ``rays``."""
    if rays.floats.shape[0] == 6:
        return None
    wcur = state[1]
    at = torch.clamp(wcur * wcur.numel() + _lane_ids(wcur), 0,
                     n - 1).reshape(-1).to(torch.int64)
    return tuple(rays.floats[6:9].index_select(1, at).reshape(
        3, *wcur.shape))


def op_reference(table, state, khit, rays: RayTables, spec: Spec):
    """Plain PyTorch version of the whole op: ``ad_shade_reference``
    (with ``strat0_reference``'s vectors) followed by ``regen_reference``
    -> (state, deposit, cell, busy)."""
    state, deposit, cell = ad_shade_reference(
        table, state, khit, strat0_reference(state, rays, spec.n_rays),
        spec)
    state, busy = regen_reference(state, rays, n=spec.n_rays,
                                  w=spec.w_cells // state[0].numel())
    return state, deposit, cell, busy


# ---- CUDA ------------------------------------------------------------

class _Config(ctypes.Structure):
    """csrc/ad_shade.cu AdShadeConfig, field for field."""

    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "n_lanes", "n_spheres", "w_cells", "max_depth", "unit_sample",
            "phys_refract", "rr_terminate", "rr_start", "stratified",
            "n_rays", "n_waves")]
        + [(n, ctypes.c_float) for n in ("sky_bias", "rr_qmin", "rr_scale")])


def _config(spec: Spec, n_lanes: int, n_spheres: int, rays: RayTables):
    o = spec.options
    return _Config(n_lanes=n_lanes, n_spheres=n_spheres,
                   w_cells=spec.w_cells, max_depth=spec.max_depth,
                   unit_sample=int(o.scatter_sample == "unit"),
                   phys_refract=int(o.refract == "physical"),
                   rr_terminate=int(o.rr_terminate), rr_start=o.rr_start,
                   stratified=int(rays.floats.shape[0] == 9),
                   n_rays=spec.n_rays, n_waves=spec.w_cells // n_lanes,
                   sky_bias=_sky_bias(o), rr_qmin=float(o.rr_qmin),
                   rr_scale=float(o.rr_scale))


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(
        *(None if x is None else x.data_ptr() for x in tensors))


def _check_inputs(name: str, table, floats, ints, active, rays: RayTables,
                  spec: Spec):
    """What both kernels ask of their inputs -> the lane count."""
    w_cells = spec.w_cells
    if not 0 <= w_cells < 2 ** 31:  # an int field of the kernel's config
        raise ValueError(f"{name}: {w_cells} wave cells")
    device = table.device
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    check_current_device(device)
    n = floats[0].numel()
    if (table.dtype != _F32 or table.dim() != 2 or table.shape[1] != 10
            or table.shape[0] < 1 or not table.is_contiguous()):
        raise ValueError(f"{name}: table must be a contiguous (S, 10) "
                         f"float32 tensor on {device}")
    checks = ([(x, _F32) for x in floats] + [(x, _I32) for x in ints]
              + [(active, torch.bool)])
    for x, dt in checks:
        if (x.dtype != dt or x.numel() != n or x.device != device
                or not x.is_contiguous()):
            raise ValueError(
                f"{name}: every plane must be a contiguous {dt} tensor of "
                f"{n} lanes on {device}; got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}, contiguous={x.is_contiguous()}")
    if not 0 < n < 2 ** 31:
        raise ValueError(f"{name}: {n} lanes")
    if w_cells % n or not 0 < spec.n_rays <= w_cells:
        raise ValueError(f"{name}: {spec.n_rays} rays in {w_cells} wave "
                         f"cells of {n} lanes")
    f, k = rays
    if (f.dtype != _F32 or f.shape not in ((6, w_cells), (9, w_cells))
            or k.dtype != _I32 or k.shape != (2, w_cells)
            or f.device != device or k.device != device
            or not (f.is_contiguous() and k.is_contiguous())):
        raise ValueError(
            f"{name}: the ray tables must be contiguous float32 (6 or 9, "
            f"{w_cells}) and int32 (2, {w_cells}) tensors on {device}; got "
            f"{f.dtype} {tuple(f.shape)} and {k.dtype} {tuple(k.shape)}")
    return n


def ad_shade_cuda(table, t, planes, sb, hit_i, active, depth, nxtw, wcur,
                  k0, k1, rays: RayTables, spec: Spec):
    """Launch ``ad_shade_kernel`` on the current stream (no synchronise)
    -> (the nine next float planes, deposit (3, L), nxtw, wcur, depth, k0,
    k1, active, busy, cell (L,) int64): views of one allocation per
    dtype."""
    name = "ad_shade"
    n = _check_inputs(name, table, (*planes, t),
                      (sb, hit_i, depth, nxtw, wcur, k0, k1), active, rays,
                      spec)
    dev, shape = t.device, t.shape
    f = torch.empty((12, n), dtype=_F32, device=dev)
    i = torch.empty((5, *shape), dtype=_I32, device=dev)
    b = torch.empty((2, *shape), dtype=torch.bool, device=dev)
    cell = torch.empty((n,), dtype=torch.int64, device=dev)
    cfg = _config(spec, n, table.shape[0], rays)
    # Named so that the arrays outlive the call that reads them.
    ins = _ptrs([*planes, t, sb, hit_i, active, depth, wcur, k0, k1, nxtw,
                 *rays])
    outs = _ptrs([f, i, b, cell])
    err = kernels.entry("rtw_ad_shade")(
        ctypes.byref(cfg), ins, outs, table.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, name)
    kernels.LAUNCHES[name] += 1
    return (*f[:9].view(9, *shape).unbind(), f[9:], *i.unbind(),
            *b.unbind(), cell)


def ad_shade_grad_cuda(table, t, planes, sb, hit_i, active, depth, nxtw,
                       wcur, k0, k1, rays: RayTables, grads, g_deposit,
                       spec: Spec):
    """Launch ``ad_shade_grad_kernel`` on the current stream (no
    synchronise). grads: the gradients of the nine next-state planes;
    g_deposit: the (3, L) gradient of the deposit -> (the gradients of the
    nine planes, of t, rows): rows is the (L, 10) gradient of each lane's
    winner row, which ``index_add_`` sums by sphere into the table's."""
    name = "ad_shade_grad"
    grads = [g.contiguous() for g in grads]
    g_deposit = g_deposit.contiguous()
    n = _check_inputs(name, table, (*planes, t, *grads),
                      (sb, hit_i, depth, nxtw, wcur, k0, k1), active, rays,
                      spec)
    if g_deposit.dtype != _F32 or g_deposit.shape != (3, n):
        raise ValueError(f"{name}: the deposit's gradient must be (3, {n}) "
                         f"float32; got {g_deposit.dtype} "
                         f"{tuple(g_deposit.shape)}")
    dev, shape = t.device, t.shape
    out = torch.empty((20 * n,), dtype=_F32, device=dev)
    g_out, rows = out[:10 * n].view(10, *shape), out[10 * n:].view(n, 10)
    cfg = _config(spec, n, table.shape[0], rays)
    ins = _ptrs([*planes, t, sb, hit_i, active, depth, wcur, k0, k1, nxtw,
                 *rays])
    gins = _ptrs([*grads, g_deposit])
    gouts = _ptrs([g_out, rows])
    err = kernels.entry("rtw_ad_shade_grad")(
        ctypes.byref(cfg), ins, gins, gouts, table.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, name)
    kernels.LAUNCHES[name] += 1
    *g_planes, g_t = g_out.unbind()
    return tuple(g_planes), g_t, rows


class _AdShade(torch.autograd.Function):
    """The op on CUDA tensors: ``ad_shade_kernel`` forward,
    ``ad_shade_grad_kernel`` backward."""

    @staticmethod
    def forward(ctx, table, t, ox, oy, oz, dx, dy, dz, ax, ay, az, sb,
                hit_i, active, depth, nxtw, wcur, k0, k1, ray_floats,
                ray_keys, spec: Spec):
        planes = (ox, oy, oz, dx, dy, dz, ax, ay, az)
        rays = RayTables(ray_floats, ray_keys)
        out = ad_shade_cuda(table, t, planes, sb, hit_i, active, depth, nxtw,
                            wcur, k0, k1, rays, spec)
        ctx.spec = spec
        ctx.save_for_backward(table, t, *planes, sb, hit_i, active, depth,
                              nxtw, wcur, k0, k1, ray_floats, ray_keys)
        ctx.mark_non_differentiable(*out[10:])
        return out

    @staticmethod
    def backward(ctx, *g):
        (table, t, ox, oy, oz, dx, dy, dz, ax, ay, az, sb, hit_i, active,
         depth, nxtw, wcur, k0, k1, ray_floats,
         ray_keys) = ctx.saved_tensors
        planes = (ox, oy, oz, dx, dy, dz, ax, ay, az)
        g_planes, g_t, rows = ad_shade_grad_cuda(
            table, t, planes, sb, hit_i, active, depth, nxtw, wcur, k0, k1,
            RayTables(ray_floats, ray_keys), g[:9], g[9], ctx.spec)
        g_table = None
        if ctx.needs_input_grad[0]:
            g_table = torch.zeros_like(table).index_add_(
                0, sb.reshape(-1).to(torch.int64), rows)
        return (g_table, g_t, *g_planes) + (None,) * 11


def ad_shade(table, state, khit, rays: RayTables, spec: Spec):
    """One pool iteration downstream of the closest hit -- the shade step
    (see ``ad_shade_reference``) and the regen (``regen_reference``) -- as
    one differentiable op -> (state, deposit, cell, busy). CUDA tensors go
    through ``ad_shade_kernel`` forward and ``ad_shade_grad_kernel``
    backward; CPU tensors through the plain version, ``op_reference``,
    under autograd. The ray tables carry no gradient."""
    t = khit[0]
    if t.device.type == "cpu":
        return op_reference(table, state, khit, rays, spec)
    if t.device.type != "cuda":
        raise ValueError(f"ad_shade: no kernel for device {t.device}")
    (nxtw, wcur, active, ox, oy, oz, dx, dy, dz, ax, ay, az, depth,
     k0, k1) = state
    t, sb, hit_i = khit
    (*planes, deposit, nxtw, wcur, depth, k0, k1, active, busy,
     cell) = _AdShade.apply(
        table, t, ox, oy, oz, dx, dy, dz, ax, ay, az, sb, hit_i, active,
        depth, nxtw, wcur, k0, k1, *rays, spec)
    return ((nxtw, wcur, active, *planes, depth, k0, k1), deposit, cell,
            busy)
