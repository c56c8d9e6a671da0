"""Regenerative persistent-wavefront renderer: the forward path.

Counterpart of ``raytracinginoneweekend_tpu/ops/wavefront.py`` (one
worker, ledger deposit). The engine keeps a persistent pool of P ray
lanes: each iteration every dead lane re-seeds itself with its next
unconsumed (pixel, sample) camera ray, all lanes trace one bounce segment
together, and terminating rays deposit into the framebuffer.

  * PLANAR ray state: every per-ray quantity is its own (R, 128) plane
    (layout in ops/cuda_fused.py), the JAX package's layout.
  * One iteration of the default step (``mega="fused"``) is two
    hand-written CUDA kernels: closest hit (ops/cuda_segment.py; the
    sublane, mxu or sorted kernel by ``hit_kernel``) and the fused
    shade+regen (ops/cuda_fused.py). ``mega="off"`` is the unrotated
    step ``segment(regen(state))``: the same closest-hit kernel, the rest
    in plain PyTorch. ``mega="bounce"`` is the unrotated step with the
    whole segment in ONE kernel (ops/cuda_mega.py: closest hit, winner
    lookup, draws, shade, state update) after the plain ``regen``. On CPU
    tensors every kernel runs its plain version.
  * Lane regeneration is not compacted: a lane owns a fixed sequence of
    task ids and advances independently -- no inter-lane communication.
    ``ownership="strided"``: lane l owns tasks l, l+P, l+2P, ...
    ``ownership="tile"``: the lanes of ownership block b (own_bl lanes)
    share the contiguous range [b*T_b, (b+1)*T_b) of task ids, lane l
    taking b*T_b + l % own_bl + k*own_bl, and task ids run over the 32x32
    tile order of the image (ops/cull.tile_pixel) -- a block's rays stay
    in a few neighbouring tiles, the coherent layout for
    ``hit_kernel="sorted"``. Both ownerships trace the same (pixel,
    sample) paths; their frames are bit-identical where every camera ray
    is generated by one arithmetic (the plain versions, so on the CPU and
    with ``plain=True``). On the card the lanes' FIRST rays come from the
    plain ``regen`` and every later one from the shade_regen kernel, whose
    sinf/cosf differ by an ulp on some arguments; which (pixel, sample)
    pairs are first rays depends on the ownership, so there the two frames
    agree inside the frame rule (golden.compare_frames) only.
  * Framebuffer deposit: a TASK-INDEXED LEDGER. A task = up to
    TASK_SAMPLES consecutive samples of ONE pixel, accumulated in the
    lane's registers; a finished task waits in one of the lane's pending
    slots and once per epoch (FLUSH_EVERY iterations) the pendings are
    written into their unique ledger cells; the frame-end fold to pixels
    is a reshape+sum (task id // tasks-per-pixel is a contiguous-run map),
    under tile ownership followed by the de-swizzle of the tile order.

The loop is plain Python: ``while`` over epochs, ``for`` over the
iterations of one epoch. The host reads the device once per epoch (the
termination test), never per iteration. Under ``mega="fused"`` the lane
state and the pending slots are updated IN PLACE on the card (each thread
touches only its own lane), which saves an allocation of every plane per
iteration.

RNG discipline is ops/rng.py's (pixel, sample, tag, word) contract, so
this engine produces the same per-ray radiance as the JAX package's; only
float rounding of individual operations and the framebuffer accumulation
order differ.

What the port does not carry raises NotImplementedError at the engine's
entry (``_check_carried``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import TraceOptions
from ..models.camera import Camera
from ..models.scene import Scene
from ..utils.device import resolve_device
from . import cull
from .cuda_fused import (ACT, N_BASE, pack_camera, regen, shade_regen,
                         shade_regen_reference, shade_update, state_dtypes)
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

# Ledger cap: a frame's task count must fit 3 f32 ledger channels under
# this budget (beyond it the JAX package falls back to pixel scatter-adds,
# which the port does not carry yet).
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


def _check_carried(options: TraceOptions, n_workers: int, deposit,
                   reserve_frac) -> None:
    """The JAX engine's own refusals, then -- by name -- what later slices
    of the port bring."""
    def later(what, queue):
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP.md, {queue})")

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
    if options.resolve != "onehot":
        later(f"resolve={options.resolve!r}", "Queue 1: code the port "
              "does not carry -- the winner lookup is a direct index")
    if reserve_frac:
        later("reserve_frac", "Queue 1: ablation engines")
    if deposit == "scatter":
        later("deposit='scatter'", "Queue 1: ablation engines")
    if n_workers != 1:
        later("n_workers > 1", "Queue 1: multi-GPU")


def first_tasks(p: int, device, own_bl: int = 0, own_tb: int = 0):
    """(R, 128) i32 plane of every lane's FIRST task id (one worker):
    the lane index under strided ownership; under tile ownership
    (own_bl > 0) ``(l // own_bl) * own_tb + l % own_bl``."""
    lane = torch.arange(p, dtype=torch.int32, device=device)
    if own_bl:
        blk = torch.div(lane, own_bl, rounding_mode="floor")
        lane = blk * own_tb + (lane - blk * own_bl)
    return lane.reshape(p // LANES, LANES)


def initial_lane_state(p: int, n_slots: int, device, own_bl: int = 0,
                       own_tb: int = 0) -> tuple:
    """The all-idle lane state before the first regen: every lane will
    acquire the first task of its own sequence (``first_tasks``)."""
    shape = (p // LANES, LANES)
    state = [torch.zeros(shape, dtype=dt, device=device)
             for dt in state_dtypes(n_slots)]
    state[0] = first_tasks(p, device, own_bl, own_tb)  # nxt
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
    stride: int        # task-id step between a lane's consecutive tasks
    own_bl: int        # lanes per tile-ownership block (0 = strided)
    own_tb: int        # task ids per tile-ownership block
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


def build_engine(scene: Scene, cam: Camera, base_key, *, width: int,
                 height: int, spp: int, max_depth: int, camera_mode: str,
                 options: TraceOptions, pool_size: int = 1 << 15,
                 n_workers: int = 1, task_samples: int | None = None,
                 flush_every: int | None = None,
                 pending_slots: int | None = None,
                 deposit: str | None = None,
                 reserve_frac: float | None = None, plain: bool = False,
                 device=None) -> Engine:
    """Validate a frame's configuration and prepare its Engine (arguments
    as ``wavefront_fb``)."""
    _check_carried(options, n_workers, deposit, reserve_frac)
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
    if options.ownership == "tile":
        # Tasks run over the 32x32-tile virtual pixel grid; each ownership
        # block of own_bl lanes owns a CONTIGUOUS tile-order range of T_b
        # task ids. T_b is a multiple of lcm(own_bl, tpp), so every
        # block's range is whole rounds of its lanes and whole virtual
        # pixels. Virtual pixels outside the image trace normally and drop
        # at the fold.
        tiles_x, _tiles_y, n_vp = cull.virtual_grid(width, height)
        own_bl = min(sorted_rows * LANES, p)
        if p % own_bl:
            raise ValueError(f"the pool's {p} lanes do not divide into "
                             f"ownership blocks of {own_bl}")
        nb_local = p // own_bl
        align = own_bl * tpp // math.gcd(own_bl, tpp)
        own_tb = -(-(n_vp * tpp) // (nb_local * align)) * align
        n_k = own_tb // own_bl         # ledger rounds per lane
        n_tasks = nb_local * own_tb    # padded task-id space
        stride = own_bl                # within-block stride
        tile_kw = dict(own_bl=own_bl, t_b=own_tb, tiles_x=tiles_x,
                       worker_base=0)
    else:
        own_bl = own_tb = 0
        stride = p
        n_k = -(-n_tasks // p)

    if deposit not in (None, "auto", "ledger"):
        raise ValueError(f"unknown deposit mode: {deposit!r}")
    if 3 * 4 * n_k * p > LEDGER_CAP_BYTES:
        raise NotImplementedError(
            f"the task ledger of this frame ({3 * 4 * n_k * p} bytes) "
            "exceeds LEDGER_CAP_BYTES and deposit='scatter' is not ported "
            "yet (ROADMAP.md, Queue 1: ablation engines); render in passes")
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
                    task_samples=task_samples, tpp=tpp, n_tasks=n_tasks,
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
        n_k=n_k, stride=stride, own_bl=own_bl, own_tb=own_tb, width=width,
        height=height, flush_every=flush_every or FLUSH_EVERY,
        sphere_params=sphere_params, htable=htable,
        table=sphere_table(sphere_params),
        camvec=pack_camera(cam),
        base_words=tuple(int(w) for w in base_key), t_min=options.t_min,
        mega=options.mega, hit_kernel=options.hit_kernel,
        sorted_rows=sorted_rows, sorted_ladder=tuple(options.sorted_ladder),
        regen_kw=regen_kw, shade_kw=shade_kw, step_kw=step_kw, plain=plain)


def engine_initial_state(eng: Engine) -> tuple:
    """The all-idle lane state of this engine's ownership."""
    return initial_lane_state(eng.lanes, eng.n_slots, eng.device,
                              eng.own_bl, eng.own_tb)


def engine_regen(eng: Engine, state: tuple) -> tuple:
    """cuda_fused.regen with this engine's keywords (plain PyTorch)."""
    return regen(state, eng.camvec, eng.base_words, **eng.regen_kw)


def engine_prologue(eng: Engine) -> tuple:
    """The first lane state. The fused step is rotated -- it regenerates
    AFTER shading -- so there the initial task acquisition + camera rays
    run once up front; the unrotated steps (``mega="off"``, ``"bounce"``)
    regenerate first and start from the all-idle state."""
    state = engine_initial_state(eng)
    return engine_regen(eng, state) if eng.mega == "fused" else state


def engine_sortstate(eng: Engine, state: tuple):
    """The sorted kernel's per-block order and bounds from the CURRENT
    lane origins (None for the other kernels). Once per epoch: staleness
    within the epoch loosens but never breaks the bounds."""
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
        out = mega_bounce(planes, eng.sphere_params,
                          tables=(eng.htable, eng.table), **kw)
    (ox, oy, oz, dx, dy, dz, ax, ay, az, acr, acg, acb, keep, dep) = out
    return (*state[:3], keep, ox, oy, oz, dx, dy, dz, ax, ay, az, dep,
            acr, acg, acb, *state[17:])


def engine_segment(eng: Engine, state: tuple, sortstate=None) -> tuple:
    """Trace and shade the state's active rays. ``mega="fused"``: closest
    hit, then the fused shade+regen; on the card the state is updated in
    place (and returned). ``mega="off"``: closest hit, winner lookup and
    shading with no regeneration, all but the closest hit in plain
    PyTorch (new tensors). ``mega="bounce"``: ``engine_mega``."""
    if eng.mega == "bounce":
        return engine_mega(eng, state)
    hit, t, sb = engine_closest_hit(eng, state, sortstate)
    if eng.mega == "off":
        seg = resolve_segment(tuple(state[4:10]), eng.sphere_params, hit, t,
                              sb)
        return shade_update(state, seg, eng.base_words, **eng.shade_kw)
    if eng.plain:
        return shade_regen_reference(
            state, (hit, t), resolve_params(sb, eng.sphere_params),
            eng.camvec, eng.base_words, **eng.step_kw)
    return shade_regen(
        state, (hit, t, sb), eng.table, eng.camvec, eng.base_words,
        out=state if eng.device.type == "cuda" else None, **eng.step_kw)


def engine_step(eng: Engine, state: tuple, sortstate=None) -> tuple:
    """One iteration: ``engine_segment``, under the unrotated steps
    (``mega="off"`` and ``"bounce"``) after a regen."""
    if eng.mega != "fused":
        state = engine_regen(eng, state)
    return engine_segment(eng, state, sortstate)


def fold_ledger(eng: Engine, ledger: torch.Tensor) -> torch.Tensor:
    """(3, >= n_tasks) ledger indexed by task id -> (H*W, 3) pixel sums.
    A pixel's tpp tasks are consecutive ids; under tile ownership the ids
    run over the padded tile order, which is de-swizzled and cropped."""
    per_vp = ledger[:, :eng.n_tasks].reshape(3, -1, eng.tpp).sum(dim=2)
    if eng.own_bl:
        tiles_x, tiles_y, n_vp = cull.virtual_grid(eng.width, eng.height)
        img = per_vp[:, :n_vp].reshape(3, tiles_y, tiles_x, cull.TILE,
                                       cull.TILE)
        img = img.permute(0, 1, 3, 2, 4).reshape(
            3, tiles_y * cull.TILE, tiles_x * cull.TILE)
        per_vp = img[:, :eng.height, :eng.width].reshape(3, -1)
    return per_vp.t().contiguous()


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
      n_workers, deposit, reserve_frac: accepted at their defaults only
        (what the JAX package does with them is not ported yet).
      plain: run the kernels' plain PyTorch versions whatever the device
        -- the reference a frame of the kernels is held against.
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
      * once per EPOCH pendings are flushed into the ledger. THE CELL
        INDEX IS THE TASK ID ITSELF. Strided: task id = k*P + lane.
        Tile: task id = b*T_b + k*own_bl + lane % own_bl with b = lane //
        own_bl and T_b = n_k*own_bl, so block b's cells are the range
        [b*T_b, (b+1)*T_b). Either way every id has one owner and a task
        finishes once, so every cell is written exactly once.
    """
    eng = build_engine(scene, cam, base_key, **config)
    p, n_tasks, device = eng.lanes, eng.n_tasks, eng.device

    # Ledger: one cell per task id, plus one row of P dump cells (cell
    # n_tasks + lane) that free slots write a zero into, so the flush is
    # one unconditional indexed copy with unique indices: no atomics, no
    # device->host read.
    ledger = torch.zeros((3, n_tasks + p), dtype=torch.float32,
                         device=device)
    dump = torch.arange(n_tasks, n_tasks + p, dtype=torch.int64,
                        device=device)
    # where each lane's own task sequence ends
    if eng.own_bl:
        block_end = (first_tasks(p, device, eng.own_bl, eng.own_tb)
                     // eng.own_tb + 1) * eng.own_tb
    else:
        block_end = n_tasks

    def flush(state):
        """Drain every pending slot into the ledger; free the slots (in
        place). A task finishes once, so its cell is written once and
        copy equals the JAX package's add onto zero."""
        for j in range(eng.n_slots):
            pt, pr, pg, pb = state[N_BASE + 4 * j: N_BASE + 4 * (j + 1)]
            pt_flat = pt.reshape(-1)
            cell = torch.where(pt_flat >= 0, pt_flat.to(torch.int64), dump)
            ledger.index_copy_(1, cell, torch.stack(
                [pr.reshape(-1), pg.reshape(-1), pb.reshape(-1)]))
            pt.fill_(-1)
            pr.zero_()
            pg.zero_()
            pb.zero_()

    def more(state) -> bool:
        """Anything left to trace? One device->host read."""
        nxt, task, _sid, act = state[:4]
        return bool(((act > 0).any() | (task >= 0).any()
                     | (nxt < block_end).any()).item())

    state = engine_prologue(eng)
    iters = 0
    segs = torch.zeros((), dtype=torch.int64, device=device)
    while more(state):
        sortstate = engine_sortstate(eng, state)
        for _ in range(eng.flush_every):
            if eng.mega != "fused":
                state = engine_regen(eng, state)
            if return_stats:
                # lanes that trace this iteration (the unrotated steps
                # regenerate first, so there it counts after the regen)
                segs += state[ACT].sum()
            state = engine_segment(eng, state, sortstate)
        iters += eng.flush_every
        flush(state)

    fb = fold_ledger(eng, ledger)
    if return_stats:
        return fb, {"iters": iters, "segments": int(segs.item()), "lanes": p}
    return fb


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
