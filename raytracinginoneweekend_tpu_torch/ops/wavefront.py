"""Regenerative persistent-wavefront renderer: the forward path.

Counterpart of ``raytracinginoneweekend_tpu/ops/wavefront.py`` (one
worker; ledger and scatter deposits). The engine keeps a persistent pool
of P ray lanes: each iteration every dead lane re-seeds itself with its next
unconsumed (pixel, sample) camera ray, all lanes trace one bounce segment
together, and terminating rays deposit into the framebuffer.

  * PLANAR ray state: every per-ray quantity is its own (R, 128) plane
    (layout in ops/cuda_fused.py), the JAX package's layout.
  * One iteration of the default step (``mega="fused"``) is two
    hand-written CUDA kernels: closest hit (ops/cuda_segment.py; the
    sublane, mxu or sorted kernel by ``hit_kernel``) and the fused
    shade+regen (ops/cuda_fused.py). ``mega="off"`` is the unrotated
    step ``segment(regen(state))``: the regen-only kernel, the same
    closest-hit kernel, then the shade-only kernel. ``mega="bounce"`` is
    the unrotated step with the whole segment in ONE kernel
    (ops/cuda_mega.py: closest hit, winner lookup, draws, shade, state
    update) after the regen-only kernel. The three entries of
    csrc/shade_regen.cu share one arithmetic, so the three steps trace
    the same paths. On CPU tensors every kernel runs its plain version.
  * Lane regeneration is not compacted: a lane owns a fixed sequence of
    task ids and advances independently -- no inter-lane communication.
    ``ownership="strided"``: lane l owns tasks l, l+P, l+2P, ...
    ``ownership="tile"``: the lanes of ownership block b (own_bl lanes)
    share the contiguous range [b*T_b, (b+1)*T_b) of task ids, lane l
    taking b*T_b + l % own_bl + k*own_bl, and task ids run over the 32x32
    tile order of the image (ops/cull.tile_pixel) -- a block's rays stay
    in a few neighbouring tiles, the coherent layout for
    ``hit_kernel="sorted"``. Both ownerships trace the same (pixel,
    sample) paths, every camera ray from one arithmetic (the kernels'
    on the card, the plain versions' on the CPU and with ``plain=True``),
    so their frames are bit-identical.
  * Framebuffer deposit: a TASK-INDEXED LEDGER. A task = up to
    TASK_SAMPLES consecutive samples of ONE pixel, accumulated in the
    lane's registers; a finished task waits in one of the lane's pending
    slots and once per epoch (FLUSH_EVERY iterations) the pendings are
    written into their unique ledger cells; the frame-end fold to pixels
    is a reshape+sum (task id // tasks-per-pixel is a contiguous-run map),
    under tile ownership followed by the de-swizzle of the tile order.
    A frame whose ledger would pass LEDGER_CAP_BYTES deposits by PIXEL
    instead (``deposit="scatter"``, chosen by ``auto``): each flush adds
    the pendings into a per-pixel buffer in a fixed order
    (``scatter_flush``), so the frame is the same to the bit on every run.

The loop is plain Python: ``while`` over epochs (``engine_epoch``: the
iterations of one epoch, then the flush). The host reads the device once
per epoch (the termination test), never per iteration. On the card the
lane state and the pending slots are updated IN PLACE (each thread touches
only its own lane), so an epoch's shapes and addresses never change: after
one eager epoch the engine captures the next as a CUDA graph
(``capture_epoch``) and replays it for every later epoch, which leaves the
host one graph launch and one read an epoch instead of ~70 launches of
Python wrappers (``build_engine(graph=False)`` keeps the eager loop, for
measuring; ``plain=True`` runs eagerly). The sorted kernel's sort state is
rebuilt at the start of every epoch from the current lane origins, inside
the epoch and so inside its graph, as the JAX package's jitted epoch does.
A capture that fails raises.

RNG discipline is ops/rng.py's (pixel, sample, tag, word) contract, so
this engine produces the same per-ray radiance as the JAX package's; only
float rounding of individual operations and the framebuffer accumulation
order differ.

SEVERAL WORKERS (``worker_index`` of ``n_workers``; parallel/mesh.py runs
one engine a worker): worker w's lane l owns tasks w*P + l, + n_workers*P,
... (strided), or the worker's blocks start at worker_base = w * nb_local *
T_b (tile). A worker's ledger holds only its own cells (``ledger_cell``:
its rounds of P lanes, or its blocks, then its reserve slice); at the fold
they are copied to their task ids in a zeroed task-indexed array, whose
fold is the one-worker fold: plain indexed writes, no float atomics, and
the workers' partial frames are summed in worker order.

THE TAIL RESERVE (``reserve_frac``, strided ownership only; inert under
tile ownership as in the JAX package): each worker withholds its slice of
the last ``reserve_frac`` of the task space from its lanes' sequences, and
once an epoch, after the flush, lanes that are idle with their own
sequence exhausted take consecutive reserve ids by cumsum rank
(``grant``). The grant is branch-free -- with no taker it is a no-op of
masks -- so it runs inside the captured epoch, and the taking lanes'
camera rays come from kernel 2's regen-only entry, the arithmetic of every
other camera ray. A reserve task has a ledger cell of its own like any
other (one worker: its task id), so the reserve frame is the reserve-off
frame to the bit.

``resolve`` ("onehot", "split", "f32") picks among the JAX package's
one-hot matrix forms of the winner lookup, all exact gathers that give the
same frame; the port's lookup is a direct index, the same for all three.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..config import TraceOptions
from ..models.camera import Camera
from ..models.scene import Scene
from ..utils.device import on_device, resolve_device
from ..utils.timing import span
from . import cull
from .cuda_fused import (ACT, N_BASE, pack_camera, regen, regen_reference,
                         shade_regen, shade_regen_reference, shade_update,
                         shade_update_reference, state_dtypes)
from .cuda_mega import mega_bounce, mega_bounce_reference
from .cuda_segment import (LANES, MXU_MAX_SPHERES, closest_hit_planar,
                           hit_table, hit_table_padded, mxu_table,
                           resolve_params, resolve_segment,
                           segment_closest_hit_mxu_reference,
                           segment_closest_hit_reference,
                           segment_closest_hit_sorted,
                           segment_closest_hit_sorted_reference,
                           sorted_cull_state, sphere_params_from_scene,
                           sphere_table)

TASK_SAMPLES = 16  # samples of one pixel accumulated per task (in-register)
FLUSH_EVERY = 32   # inner iterations per epoch (pending->ledger cadence)
N_SLOTS = 2        # pending slots per lane (task-done buffering)

# Ledger cap: the ledger deposit's largest array -- its cells, or under
# several workers the fold's task-indexed array -- must fit 3 f32 channels
# under this budget, else the engine deposits by pixel (deposit="scatter").
LEDGER_CAP_BYTES = 512 << 20

# Pool granularity in rows of 128 lanes: the JAX package's kernel block
# height, kept so that a pool_size request yields the same lane count (and
# so the same task ownership) in both packages. Also the default height of
# a cull block of the sorted kernel and of a tile-ownership block.
ROWS_DEFAULT = 64


def pool_lanes(pool_size: int, width: int, height: int, spp: int,
               rows: int = ROWS_DEFAULT,
               task_samples: int | None = None) -> int:
    """The actual (layout-rounded) lane count a pool_size request yields."""
    task_samples = min(task_samples or TASK_SAMPLES, spp)
    tpp = -(-spp // task_samples)
    n_tasks = width * height * tpp
    p = min(pool_size, n_tasks * task_samples)
    p = max(p, rows * LANES)
    return -(-p // (rows * LANES)) * (rows * LANES)


def _check_options(options: TraceOptions) -> None:
    """The JAX engine's own refusals."""
    if options.mega == "bounce":
        if options.rr_terminate:
            raise ValueError(
                "rr_terminate is implemented for mega='fused' and "
                "mega='off' only (the whole-bounce megakernel is an "
                "ablation variant)")
        if options.ownership == "tile":
            raise ValueError("ownership='tile' is implemented for "
                             "mega='fused' and mega='off' only")
        if options.hit_kernel == "sorted":
            raise ValueError("hit_kernel='sorted' is implemented for "
                             "mega='fused' and mega='off' only")


def first_tasks(p: int, device, own_bl: int = 0, own_tb: int = 0,
                base: int = 0):
    """(R, 128) i32 plane of every lane's FIRST task id: ``base`` (the
    worker's offset: worker_index * P strided, worker_base under tile
    ownership) plus the lane index under strided ownership, or under tile
    ownership (own_bl > 0) plus ``(l // own_bl) * own_tb + l % own_bl``."""
    lane = torch.arange(p, dtype=torch.int32, device=device)
    if own_bl:
        blk = torch.div(lane, own_bl, rounding_mode="floor")
        lane = blk * own_tb + (lane - blk * own_bl)
    return (lane + base).reshape(p // LANES, LANES)


def initial_lane_state(p: int, n_slots: int, device, own_bl: int = 0,
                       own_tb: int = 0, base: int = 0) -> tuple:
    """The all-idle lane state before the first regen: every lane will
    acquire the first task of its own sequence (``first_tasks``)."""
    shape = (p // LANES, LANES)
    state = [torch.zeros(shape, dtype=dt, device=device)
             for dt in state_dtypes(n_slots)]
    state[0] = first_tasks(p, device, own_bl, own_tb, base)  # nxt
    state[1].fill_(-1)   # task (-1 = none)
    state[7].fill_(1.0)  # direction (non-degenerate dummy)
    for j in range(n_slots):
        state[N_BASE + 4 * j].fill_(-1)  # pt = -1 sentinel: free
    return tuple(state)


def lane_state_from_numpy(planes, device=None) -> tuple:
    """A lane state as numpy arrays (the JAX package's: bool ``active``,
    uint32 key words) -> the port's tuple of tensors on ``device`` (None =
    the CUDA card): ``active`` becomes i32 0/1 and the key words int32
    bit patterns."""
    device = resolve_device(device)
    n_slots, rem = divmod(len(planes) - N_BASE, 4)
    if len(planes) < N_BASE or rem:
        raise ValueError(f"{len(planes)} planes is not 19 + 4*n_slots")
    out = []
    for a, dt in zip(planes, state_dtypes(n_slots)):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        np_dt = np.int32 if dt == torch.int32 else np.float32
        out.append(torch.from_numpy(np.array(a, dtype=np_dt)).to(device))
    return tuple(out)


def lane_state_to_numpy(lane_state) -> tuple:
    """The inverse of lane_state_from_numpy: bool ``active``, uint32 key
    words, everything else as stored."""
    out = [p.detach().cpu().numpy() for p in lane_state]
    out[ACT] = out[ACT] > 0
    out[17] = out[17].view(np.uint32)
    out[18] = out[18].view(np.uint32)
    return tuple(out)


class Engine(NamedTuple):
    """Everything one frame's loop needs, worked out once: the static
    decomposition, the per-scene tables on the device and the keyword
    sets of the two halves of an iteration."""

    device: torch.device
    lanes: int         # P, the pool's lane count
    n_slots: int
    n_tasks: int       # task ids run over [0, n_tasks) (padded under tile)
    tpp: int           # tasks per pixel
    n_k: int           # ledger rounds (max tasks per lane)
    n_workers: int     # >1: the ledger holds this worker's cells only
    deposit: str       # "ledger" or "scatter"
    stride: int        # task-id step between a lane's consecutive tasks
    own_bl: int        # lanes per tile-ownership block (0 = strided)
    own_tb: int        # task ids per tile-ownership block
    base: int          # this worker's first task offset (first_tasks)
    owned_end: int     # strided: the lanes' own sequences end here
    res_start: int     # this worker's reserve slice [res_start, res_end)
    res_end: int       # (res_start == res_end: no reserve)
    width: int
    height: int
    flush_every: int
    sphere_params: tuple   # cuda_segment.sphere_params_from_scene
    htable: torch.Tensor   # the closest-hit kernel's own table (hit_table,
    #                        mxu_table or hit_table_padded by hit_kernel;
    #                        hit_table under mega="bounce")
    table: torch.Tensor    # cuda_segment.sphere_table
    camvec: torch.Tensor   # cuda_fused.pack_camera
    base_words: tuple
    t_min: float
    mega: str          # "fused", "off" or "bounce"
    hit_kernel: str    # "sublane", "mxu" or "sorted"
    sorted_rows: int   # rows of a cull block of the sorted kernel
    sorted_ladder: tuple
    regen_kw: dict     # keywords of cuda_fused.regen
    shade_kw: dict     # keywords of cuda_fused.shade_update
    step_kw: dict      # keywords of cuda_fused.shade_regen
    plain: bool        # run the kernels' plain versions on any device
    graph: bool        # replay the epoch as a CUDA graph (capture_epoch)


def build_engine(scene: Scene, cam: Camera, base_key, *, width: int,
                 height: int, spp: int, max_depth: int, camera_mode: str,
                 options: TraceOptions, pool_size: int = 1 << 15,
                 worker_index: int = 0, n_workers: int = 1,
                 task_samples: int | None = None,
                 flush_every: int | None = None,
                 pending_slots: int | None = None,
                 deposit: str | None = None,
                 reserve_frac: float | None = None, plain: bool = False,
                 graph: bool = True, device=None) -> Engine:
    """Validate a frame's configuration and prepare its Engine (arguments
    as ``wavefront_fb``)."""
    _check_options(options)
    if not 0 <= worker_index < n_workers:
        raise ValueError(f"worker_index={worker_index} is not one of "
                         f"{n_workers} workers")
    device = resolve_device(device)
    n_pixels = width * height
    task_samples = min(task_samples or TASK_SAMPLES, spp)
    n_slots = pending_slots or N_SLOTS
    tpp = -(-spp // task_samples)  # tasks per pixel
    n_tasks = n_pixels * tpp
    if n_pixels * spp >= 2 ** 31:
        raise ValueError(
            f"{width}x{height} @ {spp}spp = {n_pixels * spp} rays overflows "
            "the int32 ray-id space; render in passes (e.g. split spp and "
            "average)")
    p = pool_lanes(pool_size, width, height, spp, ROWS_DEFAULT, task_samples)
    sorted_rows = options.sorted_rows or ROWS_DEFAULT
    tile_kw = {}
    res_start = res_end = 0
    if options.ownership == "tile":
        # Tasks run over the 32x32-tile virtual pixel grid; each ownership
        # block of own_bl lanes owns a CONTIGUOUS tile-order range of T_b
        # task ids. T_b is a multiple of lcm(own_bl, tpp), so every
        # block's range is whole rounds of its lanes and whole virtual
        # pixels. Virtual pixels outside the image trace normally and drop
        # at the fold. The blocks of all workers share the task space.
        tiles_x, _tiles_y, n_vp = cull.virtual_grid(width, height)
        own_bl = min(sorted_rows * LANES, p)
        if p % own_bl:
            raise ValueError(f"the pool's {p} lanes do not divide into "
                             f"ownership blocks of {own_bl}")
        nb_local = p // own_bl
        nb_global = n_workers * nb_local
        align = own_bl * tpp // math.gcd(own_bl, tpp)
        own_tb = -(-(n_vp * tpp) // (nb_global * align)) * align
        n_k = own_tb // own_bl         # ledger rounds per lane
        n_tasks = nb_global * own_tb   # padded task-id space
        stride = own_bl                # within-block stride
        base = worker_index * nb_local * own_tb
        owned_end = n_tasks
        tile_kw = dict(own_bl=own_bl, t_b=own_tb, tiles_x=tiles_x,
                       worker_base=base)
    else:
        own_bl = own_tb = 0
        stride = n_workers * p
        base = worker_index * p
        owned_end = n_tasks
        if reserve_frac:
            # the JAX engine's split: every worker's slice is equal, and
            # the lanes' own sequences end where the reserve begins
            per_worker = int(n_tasks * reserve_frac) // n_workers
            if per_worker and n_tasks - n_workers * per_worker > 0:
                owned_end = n_tasks - n_workers * per_worker
                res_start = owned_end + worker_index * per_worker
                res_end = res_start + per_worker
        n_k = -(-owned_end // stride)

    if deposit in (None, "auto"):
        # the ledger's largest array: its cells (one worker: n_k*P, or
        # n_tasks with a reserve) or, under several workers, the fold's
        # n_tasks array
        cells = max(n_k * p + res_end - res_start, n_tasks)
        deposit = ("ledger" if 3 * 4 * cells <= LEDGER_CAP_BYTES
                   else "scatter")
    if deposit not in ("ledger", "scatter"):
        raise ValueError(f"unknown deposit mode: {deposit!r}")
    if options.hit_kernel == "sorted" and (p // LANES) % sorted_rows:
        raise ValueError(f"the pool's {p // LANES} rows of lanes do not "
                         f"divide into cull blocks of {sorted_rows} rows")

    scene, cam = scene.to(device), cam.to(device)
    sphere_params = sphere_params_from_scene(scene)
    geom = sphere_params[:4]
    n_spheres = geom[0].shape[0]
    if options.mega == "bounce":
        htable = hit_table(*geom)  # the whole-bounce kernel's own loop
    elif options.hit_kernel == "sorted":
        htable = hit_table_padded(*geom)
    elif options.hit_kernel == "mxu" and n_spheres <= MXU_MAX_SPHERES:
        htable = mxu_table(*geom)
    else:
        htable = hit_table(*geom)
    regen_kw = dict(width=width, height=height, spp=spp,
                    task_samples=task_samples, tpp=tpp, n_tasks=owned_end,
                    n_slots=n_slots, stride=stride, camera_mode=camera_mode,
                    sampling=options.sampling, **tile_kw)
    shade_kw = dict(max_depth=max_depth,
                    unit_sample=options.scatter_sample == "unit",
                    phys_refract=options.refract == "physical",
                    sky_bias=0.5 if options.sky == "cuda" else 1.0,
                    rr_terminate=options.rr_terminate,
                    rr_start=options.rr_start, rr_qmin=options.rr_qmin,
                    rr_scale=options.rr_scale, width=width, height=height,
                    spp=spp, tpp=tpp, sampling=options.sampling,
                    own_bl=own_bl)
    step_kw = {**shade_kw, **regen_kw}
    return Engine(
        device=device, lanes=p, n_slots=n_slots, n_tasks=n_tasks, tpp=tpp,
        n_k=n_k, n_workers=n_workers, deposit=deposit, stride=stride,
        own_bl=own_bl,
        own_tb=own_tb, base=base, owned_end=owned_end, res_start=res_start,
        res_end=res_end, width=width, height=height,
        flush_every=flush_every or FLUSH_EVERY,
        sphere_params=sphere_params, htable=htable,
        table=sphere_table(sphere_params),
        camvec=pack_camera(cam),
        base_words=tuple(int(w) for w in base_key), t_min=options.t_min,
        mega=options.mega, hit_kernel=options.hit_kernel,
        sorted_rows=sorted_rows, sorted_ladder=tuple(options.sorted_ladder),
        regen_kw=regen_kw, shade_kw=shade_kw, step_kw=step_kw, plain=plain,
        graph=graph)


def engine_initial_state(eng: Engine) -> tuple:
    """The all-idle lane state of this engine's ownership."""
    return initial_lane_state(eng.lanes, eng.n_slots, eng.device,
                              eng.own_bl, eng.own_tb, eng.base)


def _on_card(eng: Engine) -> bool:
    """The kernels run (not their plain versions) and update in place."""
    return eng.device.type == "cuda" and not eng.plain


def _pdl(eng: Engine) -> bool:
    """Launch kernel 2's entries as programmatic dependent launches: on the
    card while an epoch is captured as a CUDA graph, whose programmatic
    edges save 1-2 us of device time a step. Not in the eager loop, which
    is host-bound: there such a launch was measured to cost host time
    while the kernel ahead of it still runs (the sorted kernel's frames,
    PERF.md)."""
    return _on_card(eng) and torch.cuda.is_current_stream_capturing()


def engine_regen(eng: Engine, state: tuple) -> tuple:
    """cuda_fused.regen with this engine's keywords: on the card the
    regen-only kernel, in place; with ``plain`` (or on the CPU) its plain
    version."""
    if eng.plain:
        return regen_reference(state, eng.camvec, eng.base_words,
                               **eng.regen_kw)
    card = _on_card(eng)
    return regen(state, eng.camvec, eng.base_words,
                 out=state if card else None, pdl=_pdl(eng), **eng.regen_kw)


def engine_prologue(eng: Engine) -> tuple:
    """The first lane state. The fused step is rotated -- it regenerates
    AFTER shading -- so there the initial task acquisition + camera rays
    run once up front; the unrotated steps (``mega="off"``, ``"bounce"``)
    regenerate first and start from the all-idle state."""
    state = engine_initial_state(eng)
    return engine_regen(eng, state) if eng.mega == "fused" else state


def engine_sortstate(eng: Engine, state: tuple):
    """The sorted kernel's per-block order and bounds from the CURRENT
    lane origins (None for the other kernels). Once per epoch, at its
    start (``engine_epoch``): staleness within the epoch loosens but never
    breaks the bounds. All device work with static shapes and no read to
    the host, so a captured epoch rebuilds it at every replay."""
    if eng.hit_kernel != "sorted":
        return None
    return sorted_cull_state(state[ACT], state[4:7], *eng.sphere_params[:4],
                             rows=eng.sorted_rows)


def engine_closest_hit(eng: Engine, state: tuple, sortstate=None) -> tuple:
    """(hit, t, sphere_idx) of the state's rays through the engine's
    closest-hit kernel (or, with ``plain``, its plain version)."""
    rays, active = tuple(state[4:10]), state[ACT]
    geom = eng.sphere_params[:4]
    if eng.hit_kernel == "sorted":
        if eng.plain:
            return segment_closest_hit_sorted_reference(
                rays, *geom, sortstate, eng.t_min, eng.sorted_rows, active,
                eng.sorted_ladder)
        return segment_closest_hit_sorted(
            rays, *geom, sortstate, eng.t_min, rows=eng.sorted_rows,
            active=active, ladder=eng.sorted_ladder, table=eng.htable)
    mxu = eng.hit_kernel == "mxu" and geom[0].shape[0] <= MXU_MAX_SPHERES
    if eng.plain:
        ref = (segment_closest_hit_mxu_reference if mxu
               else segment_closest_hit_reference)
        return ref(rays, *geom, eng.t_min, active)
    return closest_hit_planar(rays, *geom, eng.t_min, active=active,
                              kernel=eng.hit_kernel, table=eng.htable)


def mega_planes(state: tuple) -> tuple:
    """The 16 planes of a lane state that the whole-bounce kernel takes,
    in its order (ops/cuda_mega.mega_bounce)."""
    (_nxt, _task, _sid, act, ox, oy, oz, dx, dy, dz, ax, ay, az, dep,
     acr, acg, acb, k0, k1) = state[:N_BASE]
    return (act, ox, oy, oz, dx, dy, dz, ax, ay, az, acr, acg, acb, dep,
            k0, k1)


def mega_kw(eng: Engine) -> dict:
    """The whole-bounce kernel's keywords for this engine's frame."""
    return dict(t_min=eng.t_min, **{k: eng.shade_kw[k] for k in (
        "max_depth", "unit_sample", "phys_refract", "sky_bias")})


def engine_mega(eng: Engine, state: tuple) -> tuple:
    """``mega="bounce"``: the whole segment in one kernel (or, with
    ``plain``, its plain version) on the 16 planes it takes -> the next
    lane state (new tensors, no regeneration)."""
    planes, kw = mega_planes(state), mega_kw(eng)
    if eng.plain:
        out = mega_bounce_reference(planes, eng.sphere_params, **kw)
    else:
        # on the card in place: the kernel's outputs are its inputs' planes
        # (keep into ``active``)
        out = mega_bounce(planes, eng.sphere_params,
                          tables=(eng.htable, eng.table),
                          out=(planes[1:13] + (planes[0], planes[13])
                               if _on_card(eng) else None), **kw)
    (ox, oy, oz, dx, dy, dz, ax, ay, az, acr, acg, acb, keep, dep) = out
    return (*state[:3], keep, ox, oy, oz, dx, dy, dz, ax, ay, az, dep,
            acr, acg, acb, *state[17:])


def engine_segment(eng: Engine, state: tuple, sortstate=None) -> tuple:
    """Trace and shade the state's active rays. ``mega="fused"``: closest
    hit, then the fused shade+regen. ``mega="off"``: closest hit, then the
    shade with no regeneration (the shade-only kernel). ``mega="bounce"``:
    ``engine_mega``. On the card the state is updated in place (and
    returned), and while an epoch is captured the kernel after the closest
    hit is a programmatic dependent launch (``_pdl``): the closest-hit
    kernels never write the lane state.
    With ``plain`` (or on the CPU) the plain versions return new
    tensors."""
    if eng.mega == "bounce":
        return engine_mega(eng, state)
    hit, t, sb = engine_closest_hit(eng, state, sortstate)
    card = _on_card(eng)
    if eng.mega == "off":
        if eng.plain:
            seg = resolve_segment(tuple(state[4:10]), eng.sphere_params,
                                  hit, t, sb)
            return shade_update_reference(state, seg, eng.base_words,
                                          **eng.shade_kw)
        return shade_update(state, (hit, t, sb), eng.table, eng.base_words,
                            out=state if card else None, pdl=_pdl(eng),
                            **eng.shade_kw)
    if eng.plain:
        return shade_regen_reference(
            state, (hit, t), resolve_params(sb, eng.sphere_params),
            eng.camvec, eng.base_words, **eng.step_kw)
    return shade_regen(
        state, (hit, t, sb), eng.table, eng.camvec, eng.base_words,
        out=state if card else None, pdl=_pdl(eng), **eng.step_kw)


def engine_step(eng: Engine, state: tuple, sortstate=None) -> tuple:
    """One iteration: ``engine_segment``, under the unrotated steps
    (``mega="off"`` and ``"bounce"``) after a regen."""
    if eng.mega != "fused":
        state = engine_regen(eng, state)
    return engine_segment(eng, state, sortstate)


def fold_ledger(eng: Engine, ledger: torch.Tensor) -> torch.Tensor:
    """The deposit's cells -> (H*W, 3) pixel sums. A task ledger (3, >=
    n_tasks) indexed by task id: a pixel's tpp tasks are consecutive ids;
    under tile ownership the ids run over the padded tile order, which is
    de-swizzled and cropped. A scatter deposit (3, H*W + dump) already
    holds pixel sums: its dump columns are dropped."""
    if eng.deposit == "scatter":
        return ledger[:, :eng.width * eng.height].t().contiguous()
    if eng.n_workers > 1:
        ledger = spread_cells(eng, ledger)
    per_vp = ledger[:, :eng.n_tasks].reshape(3, -1, eng.tpp).sum(dim=2)
    if eng.own_bl:
        tiles_x, tiles_y, n_vp = cull.virtual_grid(eng.width, eng.height)
        img = per_vp[:, :n_vp].reshape(3, tiles_y, tiles_x, cull.TILE,
                                       cull.TILE)
        img = img.permute(0, 1, 3, 2, 4).reshape(
            3, tiles_y * cull.TILE, tiles_x * cull.TILE)
        per_vp = img[:, :eng.height, :eng.width].reshape(3, -1)
    return per_vp.t().contiguous()


class Ledger(NamedTuple):
    """A frame's deposit. Under ``deposit="ledger"`` the task ledger: one
    cell per task this worker may trace (``ledger_cell``; one worker: the
    task id), plus one row of P dump cells (after them) that free slots
    write a zero into, so the flush is one unconditional indexed copy with
    unique indices: no atomics, no device->host read. Under
    ``deposit="scatter"`` one cell per pixel plus one dump cell per pending
    slot of the pool (columns H*W ...), where every value that does not
    land on a pixel goes (``scatter_flush``)."""

    cells: torch.Tensor   # (3, own_cells + P), scatter (3, H*W + P*n_slots)
    dump: object          # ledger: (P,) i64 own_cells + lane; scatter: None
    block_end: object     # where each lane's own task sequence ends
    res_next: object      # () i32 next reserve id to grant (None: none)
    res_end: int          # the end of this worker's reserve slice


def own_cells(eng: Engine) -> int:
    """The ledger's task cells: every task id for one worker; for several,
    this worker's rounds of P lanes (its blocks under tile ownership) and
    its reserve slice."""
    if eng.n_workers == 1:
        return eng.n_tasks
    return eng.n_k * eng.lanes + eng.res_end - eng.res_start


def ledger_cell(eng: Engine, task: torch.Tensor) -> torch.Tensor:
    """Task ids (int64, this worker's own) -> their ledger cells. One
    worker: the id. Several: tile ownership counts from worker_base;
    strided ownership puts round k's lanes at k*P + lane and the reserve
    slice after the rounds."""
    if eng.n_workers == 1:
        return task
    if eng.own_bl:
        return task - eng.base
    rnd = torch.div(task, eng.stride, rounding_mode="floor")
    own = rnd * eng.lanes + task - rnd * eng.stride - eng.base
    return torch.where(task >= eng.owned_end,
                       task - eng.res_start + eng.n_k * eng.lanes, own)


def spread_cells(eng: Engine, cells: torch.Tensor) -> torch.Tensor:
    """A worker's ledger cells -> a (3, n_tasks) ledger indexed by task id,
    zero at every other worker's tasks (``ledger_cell`` inverted; a plain
    indexed copy). Cells of rounds past the lanes' own sequences were never
    written and go to one extra column, dropped."""
    n_own, device = own_cells(eng), cells.device
    cell = torch.arange(n_own, dtype=torch.int64, device=device)
    if eng.own_bl:
        task = cell + eng.base
    else:
        rounds = eng.n_k * eng.lanes
        rnd = torch.div(cell, eng.lanes, rounding_mode="floor")
        task = eng.base + cell - rnd * eng.lanes + rnd * eng.stride
        task = torch.where(task >= eng.owned_end, eng.n_tasks, task)
        task = torch.where(cell >= rounds, cell - rounds + eng.res_start,
                           task)
    full = torch.zeros((3, eng.n_tasks + 1), dtype=cells.dtype,
                       device=device)
    return full.index_copy_(1, task, cells[:, :n_own])[:, :eng.n_tasks]


def new_ledger(eng: Engine) -> Ledger:
    p, n_own, device = eng.lanes, own_cells(eng), eng.device
    if eng.own_bl:
        block_end = (first_tasks(p, device, eng.own_bl, eng.own_tb, eng.base)
                     // eng.own_tb + 1) * eng.own_tb
    else:
        block_end = eng.owned_end
    res_next = (torch.full((), eng.res_start, dtype=torch.int32,
                           device=device)
                if eng.res_end > eng.res_start else None)
    if eng.deposit == "scatter":
        return Ledger(torch.zeros((3, eng.width * eng.height
                                   + p * eng.n_slots),
                                  dtype=torch.float32, device=device),
                      None, block_end, res_next, eng.res_end)
    return Ledger(
        torch.zeros((3, n_own + p), dtype=torch.float32, device=device),
        torch.arange(n_own, n_own + p, dtype=torch.int64, device=device),
        block_end, res_next, eng.res_end)


def task_pixels(eng: Engine, task: torch.Tensor) -> torch.Tensor:
    """Task ids (-1 = a free slot) -> pixel ids, H*W (off the image: the
    scatter deposit's dump) for a free slot and, under tile ownership, for
    a virtual pixel off the image. The counterpart of the JAX engine's
    ``task_pixel`` with its validity folded in."""
    n_pixels = eng.width * eng.height
    vp = torch.div(task.clamp_min(0), eng.tpp, rounding_mode="floor")
    ok = task >= 0
    if eng.own_bl:
        vp, valid = cull.tile_pixel(vp, eng.width, eng.height)
        ok = ok & valid
    return torch.where(ok, vp, torch.full_like(vp, n_pixels))


def scatter_flush(eng: Engine, cells: torch.Tensor, pixel: torch.Tensor,
                  rgb: torch.Tensor) -> None:
    """Add values into pixel cells in an order fixed by the inputs alone
    (in place). pixel: (N,) cell per value (H*W = off the image); rgb:
    (3, N); cells: (3, H*W + N), the last N the dump.

    A pixel's tasks are consecutive ids on neighbouring lanes, so one
    flush brings a pixel up to tpp values; a float ``index_add_`` of them
    would add in the order of the card's atomics, which changes the last
    bits from run to run. Here the values are stably sorted by pixel (so a
    pixel's run keeps the slot-major, lane order of the flush), each run
    is summed by a pairwise tree over its positions (log2 tpp elementwise
    passes), and only the run's head, one per pixel, is added to its
    cell; every other value goes to a dump cell of its own (H*W + its
    position), so no two adds meet on one address. Static shapes and no
    read to the host: an epoch with this flush is captured as a CUDA graph
    like the ledger's. With one task a pixel the cell gets 0 + x = x, the
    ledger frame's value."""
    n = pixel.shape[0]
    dump = eng.width * eng.height
    key, order = torch.sort(pixel.to(torch.int32), stable=True)
    vals = rgb.index_select(1, order)
    head = torch.ones(n, dtype=torch.bool, device=pixel.device)
    head[1:] = key[1:] != key[:-1]
    pos = torch.arange(n, device=pixel.device)
    rank = pos - torch.cummax(torch.where(head, pos, 0), dim=0).values
    s = 1
    while s < eng.tpp:  # a pixel's run is at most tpp long
        same = torch.zeros(n, dtype=torch.bool, device=pixel.device)
        same[:n - s] = key[s:] == key[:n - s]
        take = same & (rank % (2 * s) == 0)
        nxt = torch.zeros_like(vals)
        nxt[:, :n - s] = vals[:, s:]
        vals = vals + torch.where(take, nxt, torch.zeros_like(nxt))
        s *= 2
    cells.index_add_(1, torch.where(head & (key < dump), key, dump + pos),
                     vals)


def flush(eng: Engine, ledger: Ledger, state: tuple) -> None:
    """Drain every pending slot into the deposit; free the slots (in
    place). Ledger: a task finishes once, so its cell is written once and
    copy equals the JAX package's add onto zero. Scatter: the slots' values
    are added by pixel (``scatter_flush``), slot-major, lane by lane."""
    slots = [state[N_BASE + 4 * j: N_BASE + 4 * (j + 1)]
             for j in range(eng.n_slots)]
    if eng.deposit == "scatter":
        pt = torch.cat([s[0].reshape(-1) for s in slots]).to(torch.int64)
        rgb = torch.stack([torch.cat([s[c].reshape(-1) for s in slots])
                           for c in (1, 2, 3)])
        scatter_flush(eng, ledger.cells, task_pixels(eng, pt), rgb)
    for pt, pr, pg, pb in slots:
        if eng.deposit != "scatter":
            pt_flat = pt.reshape(-1)
            cell = torch.where(pt_flat >= 0,
                               ledger_cell(eng, pt_flat.to(torch.int64)),
                               ledger.dump)
            ledger.cells.index_copy_(1, cell, torch.stack(
                [pr.reshape(-1), pg.reshape(-1), pb.reshape(-1)]))
        pt.fill_(-1)
        pr.zero_()
        pg.zero_()
        pb.zero_()


def pending(ledger: Ledger, state: tuple) -> torch.Tensor:
    """Anything left to trace? A bool on the device (nothing read)."""
    nxt, task, _sid, act = state[:4]
    left = ((act > 0).any() | (task >= 0).any()
            | (nxt < ledger.block_end).any())
    if ledger.res_next is not None:
        left = left | (ledger.res_next < ledger.res_end)
    return left


def more(ledger: Ledger, state: tuple) -> bool:
    """Anything left to trace? One device->host read."""
    return bool(pending(ledger, state).item())


def grant(eng: Engine, ledger: Ledger, state: tuple) -> tuple:
    """The tail reserve's grant, once an epoch after the flush (the JAX
    engine's ``grant``): lanes that are idle with no task and their own
    sequence exhausted take consecutive reserve ids by cumsum rank, up to
    the end of this worker's slice, and are issued their first camera ray.

    Branch-free, so an epoch with it is captured as a CUDA graph: with no
    taker every select keeps its lane. The taking lanes' ``nxt`` is set to
    their grant, every other lane past its own sequence is pushed past the
    whole task space, and one regen whose sequences end at the slice's end
    then acquires exactly the grants -- through kernel 2's regen-only entry
    on the card, so a reserve task's camera ray has the arithmetic of every
    other. That regen also does for the other lanes what the next step's
    would (a finished task to a slot, the next sample, the next own task):
    it moves when a lane traces what, never what it traces."""
    nxt, task, _sid, act = state[:4]
    idle_ex = (act == 0) & (task < 0) & (nxt >= eng.owned_end)
    flat = idle_ex.reshape(-1).to(torch.int32)
    rank = (torch.cumsum(flat, 0, dtype=torch.int32) - flat).reshape(
        idle_ex.shape)
    gid = ledger.res_next + rank
    take = idle_ex & (gid < eng.res_end)
    past = torch.full_like(nxt, eng.n_tasks)
    nxt.copy_(torch.where(take, gid, torch.where(nxt >= eng.owned_end, past,
                                                 nxt)))
    ledger.res_next.add_(take.sum(dtype=torch.int32))
    kw = dict(eng.regen_kw, n_tasks=eng.res_end)
    if eng.plain:
        return regen_reference(state, eng.camvec, eng.base_words, **kw)
    card = _on_card(eng)
    return regen(state, eng.camvec, eng.base_words,
                 out=state if card else None, pdl=_pdl(eng), **kw)


def engine_epoch(eng: Engine, state: tuple, ledger: Ledger, sortstate=None,
                 segs=None) -> tuple:
    """One epoch: the sorted kernel's sort state from the epoch's first
    lane state (``engine_sortstate``; ``sortstate`` passes one in),
    ``flush_every`` iterations (under the unrotated steps a regen before
    each segment), the flush, then with a reserve the grant -> the next
    lane state (on the card the same planes, updated in place). ``segs``:
    an optional device scalar that counts the lanes that trace (after the
    regen under the unrotated steps)."""
    if sortstate is None:
        sortstate = engine_sortstate(eng, state)
    for _ in range(eng.flush_every):
        if eng.mega != "fused":
            state = engine_regen(eng, state)
        if segs is not None:
            segs += state[ACT].sum()
        state = engine_segment(eng, state, sortstate)
    flush(eng, ledger, state)
    if ledger.res_next is not None:
        state = grant(eng, ledger, state)
    return state


def epoch_graphable(eng: Engine) -> bool:
    """Whether the loop replays this engine's epochs as a CUDA graph: on
    the card, with the kernels, unless asked not to (``graph=False``)."""
    return eng.graph and _on_card(eng)


def capture_epoch(eng: Engine, state: tuple, ledger: Ledger, segs=None,
                  keep_graph: bool = False):
    """Capture one ``engine_epoch`` on ``state`` as a CUDA graph -> (the
    graph, the launches one replay makes, by kernel).

    Capture launches nothing: a replay runs the epoch on the same planes
    (the state, the ledger, ``segs``), which must have stayed where they
    are -- the epoch updates them in place. The sorted kernel's sort state
    is computed inside the captured epoch (its tensors come from the
    graph's memory pool), so every replay rebuilds it from the lanes of
    that epoch; its ladder is fixed per engine and baked into the captured
    launches. The kernels must have been built and launched once (an
    eager epoch), so that nothing is compiled or loaded during the
    capture. The wrappers count their launches in
    Python, which runs only now: the counts are taken back here, and the
    caller adds ``per_epoch`` at every replay (kernels.add_launches).
    ``keep_graph`` keeps the captured cudaGraph_t for inspection
    (``raw_cuda_graph``). Raises if the capture fails or the epoch does
    not update the state in place; there is no eager fallback.
    """
    if not epoch_graphable(eng):
        raise ValueError("capture_epoch: this engine's epoch runs eagerly "
                         "(graph=False, plain or off the card)")
    graph = (torch.cuda.CUDAGraph(keep_graph=True) if keep_graph
             else torch.cuda.CUDAGraph())
    before = dict(kernels.LAUNCHES)
    try:
        with torch.cuda.graph(graph):
            after = engine_epoch(eng, state, ledger, None, segs)
        per_epoch = kernels.launch_delta(before, kernels.LAUNCHES)
    finally:
        kernels.LAUNCHES.update(before)
    if len(after) != len(state) or any(a is not b
                                       for a, b in zip(after, state)):
        raise RuntimeError("capture_epoch: the epoch did not update the "
                           "lane state in place; it cannot be replayed")
    return graph, per_epoch


def wavefront_fb(scene: Scene, cam: Camera, base_key, *,
                 return_stats: bool = False, **config):
    """Trace every task -> UNNORMALIZED (H*W, 3) framebuffer sums.

    Keyword arguments (``build_engine`` takes them):
      width, height, spp, max_depth, camera_mode, options: the frame.
        Of ``options`` the engine reads ``mega`` ("fused", "off" or
        "bounce"), ``hit_kernel``, ``sorted_rows``, ``sorted_ladder``,
        ``ownership`` and the estimator switches.
      base_key: the ``(k0, k1)`` base-key words (ops/threefry.key_words).
      pool_size: number of persistent ray lanes (rounded to layout
        multiple).
      task_samples, flush_every, pending_slots: the decomposition's
        constants (None = TASK_SAMPLES, FLUSH_EVERY, N_SLOTS).
      deposit: None / "auto" (the ledger while 3*4*max(n_k*P + reserve,
        n_tasks) bytes fit LEDGER_CAP_BYTES, else "scatter"), "ledger" or
        "scatter".
      worker_index, n_workers: this worker of how many (the module
        docstring; parallel/mesh.py sums the workers' partial frames).
      reserve_frac: the tail reserve's share of the task space (None or
        0 = off; inert under tile ownership; ``grant``).
      plain: run the kernels' plain PyTorch versions whatever the device
        -- the reference a frame of the kernels is held against.
      graph: on the card, replay every epoch after the first as a CUDA
        graph (``capture_epoch``); False keeps the eager loop. The frame
        is the same to the bit either way.
      device: where to render (None = the CUDA card); scene and camera
        are moved there.
    return_stats: also return {"iters", "segments", "lanes"} occupancy
      counters (segments are summed on the device and read once at the
      end; counted after the regen under the unrotated steps).

    Work decomposition:
      * a TASK = up to TASK_SAMPLES consecutive samples of ONE pixel;
        every lane owns a fixed sequence of task ids (strided or tile
        ownership, see the module docstring), so lanes never communicate;
      * a lane traces its task's samples back-to-back, accumulating their
        radiance into per-lane register planes (plain adds, no scatter);
      * a finished task's (task id, rgb) moves to the lane's first FREE
        pending slot (N_SLOTS of them; a lane with every slot occupied
        idles until the epoch flush);
      * once per EPOCH pendings are flushed into the deposit. In the
        ledger of one worker THE CELL INDEX IS THE TASK ID ITSELF.
        Strided: task id = k*P + lane. Tile: task id = b*T_b + k*own_bl +
        lane % own_bl with b = lane // own_bl and T_b = n_k*own_bl, so
        block b's cells are the range [b*T_b, (b+1)*T_b). (Several
        workers: ``ledger_cell``.) Either way every id has one owner and a
        task finishes once, so every cell is written exactly once. In the
        scatter deposit (past the cap) the cell is the pixel.
    """
    with span("rtw.wavefront.build"):
        run = FrameRun(build_engine(scene, cam, base_key, **config),
                       return_stats)
    while run.more():
        run.epoch()
    fb = run.framebuffer()
    return (fb, run.stats()) if return_stats else fb


class FrameRun:
    """One worker's frame in flight: its engine, deposit and lane state,
    and on the card the epoch captured as a CUDA graph after the first
    eager one. ``wavefront_fb`` steps one; parallel/mesh.py steps one per
    worker in turn, every worker's epoch before any termination read."""

    def __init__(self, eng: Engine, return_stats: bool = False):
        self.eng = eng
        with on_device(eng.device):
            self.ledger = new_ledger(eng)
            self.segs = (torch.zeros((), dtype=torch.int64,
                                     device=eng.device)
                         if return_stats else None)
            self.state = engine_prologue(eng)
        self.iters, self.graph, self.per_epoch = 0, None, None

    def pending(self) -> torch.Tensor:
        """Anything left to trace, as a bool on the device (no read)."""
        with on_device(self.eng.device):
            return pending(self.ledger, self.state)

    def more(self) -> bool:
        """Anything left to trace? One device->host read, which waits for
        the epochs enqueued before it."""
        with span("rtw.wavefront.read"):
            return bool(self.pending().item())

    def epoch(self) -> None:
        """Run (or replay) one epoch; nothing is read to the host."""
        eng = self.eng
        with on_device(eng.device):
            if self.graph is None and self.iters and epoch_graphable(eng):
                with span("rtw.wavefront.capture"):
                    self.graph, self.per_epoch = capture_epoch(
                        eng, self.state, self.ledger, self.segs)
            if self.graph is not None:
                self.graph.replay()
                kernels.LAUNCHES.update(
                    kernels.add_launches(kernels.LAUNCHES, self.per_epoch))
            else:
                self.state = engine_epoch(eng, self.state, self.ledger,
                                          segs=self.segs)
        self.iters += eng.flush_every

    def framebuffer(self) -> torch.Tensor:
        """The UNNORMALIZED (H*W, 3) sums of this worker's tasks."""
        with on_device(self.eng.device), span("rtw.wavefront.fold"):
            return fold_ledger(self.eng, self.ledger.cells)

    def stats(self) -> dict:
        return {"iters": self.iters, "segments": int(self.segs.item()),
                "lanes": self.eng.lanes}


def render_wavefront(scene: Scene, cam: Camera, base_key, *, spp: int,
                     return_stats: bool = False, **config):
    """Render the full image -> (H*W, 3) linear radiance means, a tensor
    on ``device`` (None = the CUDA card). Arguments as ``wavefront_fb``.

    return_stats=True also returns the engine's occupancy counters
    ({"iters", "segments", "lanes"}; occupancy = segments/(iters*lanes)).
    """
    out = wavefront_fb(scene, cam, base_key, spp=spp,
                       return_stats=return_stats, **config)
    if return_stats:
        fb, stats = out
        return fb / float(spp), stats
    return out / float(spp)
