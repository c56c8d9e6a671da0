"""Dual-pool wavefront: coherence-split rendering for many-sphere scenes.

Counterpart of ``raytracinginoneweekend_tpu/ops/wavefront_dual.py``.
Several workers (``worker_index`` of ``n_workers``, parallel/mesh.py)
split the sequential task space as the single pool's strided ownership
does: worker w's primary lane l walks w*P + l, + n_workers*P, ...

The single-pool engine (ops/wavefront.py) pays the full O(S) brute-force
sphere loop for EVERY segment because its lanes mix camera rays with
direction-scattered bounce rays: no per-block bound can cull an incoherent
block. This engine splits the pools so coherence is an invariant, not an
accident:

  PRIMARY pool  -- every lane issues one camera ray per iteration. Tasks
    map to pixels through a 32x32 tile swizzle (ops/cull.tile_pixel), and
    the granule-scrambled task order (a fixed coprime permutation of
    block-sized task granules -- pure index arithmetic) keeps each cull
    block inside 2-4 adjacent tiles while the POOL as a whole works a
    spatial mix of image regions (sky and ground tiles simultaneously),
    so secondary load stays statistically level over the frame. Each
    block's rays fit a narrow bounding cone; the conservative cone +
    occlusion cull (ops/cull.py) shrinks its sphere loop to a per-block
    candidate LIST run by the list kernel
    (ops/cuda_segment.segment_closest_hit_list, csrc/closest_hit_list.cu).

  SECONDARY pool -- k_s stacked lane-aligned copies of the primary lane
    space running the plain brute-force closest-hit kernel
    (csrc/closest_hit.cu). A primary lane's surviving scatter ray enters a
    two-deep per-lane handoff FIFO; one of its OWN k_s secondary lanes
    (same (row, lane), different copy) picks it up -- every transfer is an
    elementwise select: no cross-lane data movement, no compaction, no
    prefix sums. Back-pressure (FIFO full) pauses that primary lane's
    issue; secondary acceptance itself never stalls.

RETURN-CREDIT accumulation: a terminated path's radiance is added
directly to its feeder lane's task accumulator (lane-aligned again), and
an ``outstanding`` counter holds the task open until every handed-off path
lands. The framebuffer therefore sees exactly ONE scatter-add per task
(amortized over FLUSH_EVERY iterations); the secondary pool needs no
deposit machinery at all.

Radiance per (pixel, sample) follows the same contract as every other
engine (the ops/rng.py key contract and ops/planar.bounce_planar shading
are shared); only framebuffer accumulation order differs -- here it also
varies from run to run on the card, where the flush's ``index_add_`` sums
with atomics.

One iteration (``dual_step``) is the two kernels and a few hundred plain
PyTorch operations on (R, 128) planes; the secondary planes are
(k_s, R, 128) stacks whose copies are views. The step builds new tensors
(nothing is updated in place but the framebuffer and the metrics). The
loop is plain Python: ``while`` over epochs of FLUSH_EVERY iterations,
one device->host read per epoch for the termination test.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import TraceOptions
from ..models.camera import Camera
from ..models.scene import Scene
from ..utils.device import on_device, resolve_device
from . import cull
from . import rng
from .cuda_segment import (hit_table, hit_table_padded, resolve_segment,
                           segment_closest_hit_list_reference,
                           segment_closest_hit_reference,
                           sphere_params_from_scene, trace_segment,
                           trace_segment_list)
from .planar import (bounce_planar, camera_rays, ray_key_words,
                     strat0_scatter_planes)

LANES = 128
ROWS = 64                    # rows per cull block (both pools)
BLOCK = ROWS * LANES
TASK_SAMPLES = 64            # camera samples of one pixel per primary task
FLUSH_EVERY = 16
SECONDARY_COPIES = 2         # k_s: secondary lanes per primary lane

METRICS = ("iterations", "issue_lane_iters", "secondary_active_lane_iters",
           "primary_blocked_lane_iters", "primary_candidate_total",
           "handoffs")


def dual_pool_lanes(pool_size: int, spp: int,
                    k_s: int = SECONDARY_COPIES) -> int:
    """Primary-pool lane count for a total lane budget (block-rounded)."""
    p = max(pool_size // (1 + k_s), BLOCK)
    return max(BLOCK, p // BLOCK * BLOCK)


def _granule_stride(n_g: int) -> int:
    """A fixed multiplier coprime to n_g near the golden ratio, so
    consecutive granules land far apart in the image."""
    if n_g <= 2:
        return 1
    k = max(1, round(n_g * 0.618))
    while math.gcd(k, n_g) != 1:
        k += 1
    return k


class Handoff(NamedTuple):
    """One stage of the per-lane handoff FIFO: (R, 128) planes."""

    val: torch.Tensor   # bool: the stage holds a ray
    ox: torch.Tensor
    oy: torch.Tensor
    oz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    ar: torch.Tensor
    ag: torch.Tensor
    ab: torch.Tensor
    pid: torch.Tensor
    sid: torch.Tensor


class DualState(NamedTuple):
    """One iteration's lane state. Primary planes are (R, 128), secondary
    planes (k_s, R, 128): copy j of primary lane (row, lane) is
    [j, row, lane]. Booleans are torch.bool, ids int32, the rest float32.
    """

    nxt: torch.Tensor    # next sequential task counter of the lane
    task: torch.Tensor   # sequential task id in flight (-1 = none)
    sid: torch.Tensor    # next sample id to issue
    outs: torch.Tensor   # handed-off paths not yet home
    accr: torch.Tensor   # the task's accumulated radiance
    accg: torch.Tensor
    accb: torch.Tensor
    pp: torch.Tensor     # pending pixel id (n_pixels = empty)
    pr: torch.Tensor     # pending radiance
    pg: torch.Tensor
    pb: torch.Tensor
    h0: Handoff          # FIFO head
    h1: Handoff          # FIFO tail
    s_act: torch.Tensor  # secondary pool
    s_ox: torch.Tensor
    s_oy: torch.Tensor
    s_oz: torch.Tensor
    s_dx: torch.Tensor
    s_dy: torch.Tensor
    s_dz: torch.Tensor
    s_ar: torch.Tensor
    s_ag: torch.Tensor
    s_ab: torch.Tensor
    s_dep: torch.Tensor
    s_pid: torch.Tensor
    s_sid: torch.Tensor


def _flat_planes(state: DualState) -> list:
    return [*state[:11], *state.h0, *state.h1, *state[13:]]


def dual_state_to_numpy(state: DualState) -> tuple:
    """The state as 48 numpy arrays in the JAX package's order (its loop
    carry without the iteration counter and the metrics): 11 primary
    planes, the two FIFO stages of 12, the 13 secondary planes stacked
    copy over copy as (k_s * R, 128)."""
    out = []
    for i, p in enumerate(_flat_planes(state)):
        a = p.detach().cpu().numpy()
        out.append(a.reshape(-1, LANES) if i >= 35 else a)
    return tuple(out)


def dual_state_from_numpy(planes, k_s: int = SECONDARY_COPIES,
                          device=None) -> DualState:
    """The inverse of dual_state_to_numpy, onto ``device`` (None = the
    CUDA card)."""
    device = resolve_device(device)
    if len(planes) != 48:
        raise ValueError(f"{len(planes)} planes; a dual state has 48")
    ts = []
    for i, a in enumerate(planes):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        t = torch.from_numpy(np.array(a)).to(device)
        if i >= 35:
            t = t.reshape(k_s, -1, LANES)
        ts.append(t)
    return DualState(*ts[:11], Handoff(*ts[11:23]), Handoff(*ts[23:35]),
                     *ts[35:])


class DualEngine(NamedTuple):
    """Everything one frame's loop needs, worked out once."""

    device: torch.device
    p: int             # primary lanes
    k_s: int
    width: int
    height: int
    spp: int
    max_depth: int
    camera_mode: str
    options: TraceOptions
    n_pixels: int      # also the "empty" value of the pending pixel plane
    task_samples: int
    lane0: int         # this worker's first sequential task: worker_index*P
    stride: int        # sequential-task step of a primary lane: n_workers*P
    tpp: int           # tasks per virtual pixel
    n_tasks: int
    n_g: int           # granules of BLOCK sequential task ids
    n_seq: int         # n_g * BLOCK
    gk: int            # granule multiplier
    cam: Camera
    base_words: tuple
    sphere_params: tuple
    htable: torch.Tensor   # cuda_segment.hit_table (secondary pool)
    ptable: torch.Tensor   # cuda_segment.hit_table_padded (primary pool)
    shade_kw: dict         # keywords of planar.bounce_planar
    plain: bool            # run the kernels' plain versions on any device


def build_dual_engine(scene: Scene, cam: Camera, base_key, *, width: int,
                      height: int, spp: int, max_depth: int,
                      camera_mode: str, options: TraceOptions,
                      pool_size: int = 1 << 16,
                      k_s: int = SECONDARY_COPIES, worker_index: int = 0,
                      n_workers: int = 1, plain: bool = False,
                      device=None) -> DualEngine:
    """Validate a frame's configuration and prepare its DualEngine
    (arguments as ``wavefront_dual_fb``)."""
    if not 0 <= worker_index < n_workers:
        raise ValueError(f"worker_index={worker_index} is not one of "
                         f"{n_workers} workers")
    if k_s < 1:
        raise ValueError(f"k_s={k_s}; the secondary pool needs a copy")
    device = resolve_device(device)
    _, _, n_vp = cull.virtual_grid(width, height)
    task_samples = min(TASK_SAMPLES, spp)
    tpp = -(-spp // task_samples)
    n_tasks = n_vp * tpp
    if n_vp * spp >= 2 ** 31:
        raise ValueError(
            f"{width}x{height} @ {spp}spp overflows the int32 ray-id "
            "space; render in passes (split spp and average)")
    # Granule-scrambled task order: the per-lane counters walk the
    # sequential space [0, n_g*BLOCK); granule g maps to (g*K) mod n_g.
    n_g = -(-n_tasks // BLOCK)
    scene, cam = scene.to(device), cam.to(device)
    sphere_params = sphere_params_from_scene(scene)
    geom = sphere_params[:4]
    p = dual_pool_lanes(pool_size, spp, k_s)
    return DualEngine(
        device=device, p=p, k_s=k_s, lane0=worker_index * p,
        stride=n_workers * p,
        width=width, height=height, spp=spp, max_depth=max_depth,
        camera_mode=camera_mode, options=options, n_pixels=width * height,
        task_samples=task_samples, tpp=tpp, n_tasks=n_tasks, n_g=n_g,
        n_seq=n_g * BLOCK, gk=_granule_stride(n_g), cam=cam,
        base_words=tuple(int(w) for w in base_key),
        sphere_params=sphere_params, htable=hit_table(*geom),
        ptable=hit_table_padded(*geom),
        shade_kw=dict(unit_sample=options.scatter_sample == "unit",
                      phys_refract=options.refract == "physical",
                      sky_bias=0.5 if options.sky == "cuda" else 1.0),
        plain=plain)


def initial_dual_state(eng: DualEngine) -> DualState:
    """Every lane idle: primary lane l will acquire sequential task
    lane0 + l."""
    dev, r_p = eng.device, eng.p // LANES

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    f32, i32 = torch.float32, torch.int32
    ps, ss = (r_p, LANES), (eng.k_s, r_p, LANES)
    zp, ip = full(ps, 0.0, f32), full(ps, 0, i32)
    zs, is_ = full(ss, 0.0, f32), full(ss, 0, i32)
    # a non-degenerate dummy direction on every lane that holds no ray
    h = Handoff(full(ps, False, torch.bool), zp, zp, zp, zp + 1.0, zp, zp,
                zp, zp, zp, ip, ip)
    return DualState(
        torch.arange(eng.lane0, eng.lane0 + eng.p, dtype=i32,
                     device=dev).reshape(ps),
        ip - 1, ip, ip, zp, zp, zp, ip + eng.n_pixels, zp, zp, zp, h, h,
        full(ss, False, torch.bool), zs, zs, zs, zs + 1.0, zs, zs,
        zs, zs, zs, is_, is_, is_)


def _fdiv(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


def _rr(options: TraceOptions, keep, rk0, rk1, dep, nar, nag, nab):
    """Russian-roulette termination on the NEW attenuation (nar, nag,
    nab): the shared contract (rng.rr_terminate_update: TAG_BOUNCE +
    depth, counter 2; survivors boost 1/q, casualties die like absorb)
    -> (keep', boosted attenuation)."""
    ar, ag, ab, keep = rng.rr_terminate_update(
        rk0, rk1, dep, nar, nag, nab, keep, rr_start=options.rr_start,
        rr_qmin=options.rr_qmin, rr_scale=options.rr_scale)
    return keep, (ar, ag, ab)


def dual_step(eng: DualEngine, state: DualState, metrics=None) -> DualState:
    """One iteration of both pools -> the next state (new tensors).

    metrics: optional (6,) int64 tensor on the device, updated IN PLACE
    with this iteration's counts in the order of ``METRICS``.
    """
    (nxt, task, sid, outs, accr, accg, accb, pp, pr, pg, pb, h0, h1,
     s_act, s_ox, s_oy, s_oz, s_dx, s_dy, s_dz, s_ar, s_ag, s_ab,
     s_dep, s_pid, s_sid) = state
    options, k_s = eng.options, eng.k_s
    spp, tpp, max_depth = eng.spp, eng.tpp, eng.max_depth
    free_pix = eng.n_pixels

    # ---- secondary accept: free lanes pull their feeder's FIFO --------
    taken = torch.zeros_like(h0.val)
    can = []
    for j in range(k_s):
        can_j = ~s_act[j] & h0.val & ~taken
        can.append(can_j)
        taken = taken | can_j
    can = torch.stack(can)

    def accept(s_plane, h_plane):
        return torch.where(can, h_plane[None], s_plane)

    s_ox, s_oy, s_oz = (accept(s_ox, h0.ox), accept(s_oy, h0.oy),
                        accept(s_oz, h0.oz))
    s_dx, s_dy, s_dz = (accept(s_dx, h0.dx), accept(s_dy, h0.dy),
                        accept(s_dz, h0.dz))
    s_ar, s_ag, s_ab = (accept(s_ar, h0.ar), accept(s_ag, h0.ag),
                        accept(s_ab, h0.ab))
    s_dep = torch.where(can, torch.ones_like(s_dep), s_dep)
    s_pid, s_sid = accept(s_pid, h0.pid), accept(s_sid, h0.sid)
    s_act = s_act | can
    h0_val = h0.val & ~taken
    # FIFO shift: h1 moves into freed h0 slots.
    mv = ~h0_val & h1.val
    h0_val = h0_val | mv
    h1_val = h1.val & ~mv
    h0_rest = [torch.where(mv, b, a) for a, b in zip(h0[1:], h1[1:])]
    h1_rest = list(h1[1:])

    # ---- primary task management --------------------------------------
    has_task = task >= 0
    acquire = ~has_task & (nxt < eng.n_seq)
    task_seq = torch.where(acquire, nxt, task)
    nxt = torch.where(acquire, nxt + eng.stride, nxt)
    # granule scramble: sequential counter -> spatial task id
    g = _fdiv(task_seq, BLOCK)
    t_sp = (torch.remainder(g * eng.gk, eng.n_g) * BLOCK
            + (task_seq - g * BLOCK))
    vp = _fdiv(t_sp, tpp)
    run_start = (t_sp - vp * tpp) * eng.task_samples
    run_end = torch.clamp(run_start + eng.task_samples, max=spp)
    pid, pvalid = cull.tile_pixel(vp, eng.width, eng.height)
    # virtual-padding tasks have no real pixel: drop them whole
    dead_task = acquire & (~pvalid | (t_sp >= eng.n_tasks))
    task = torch.where(dead_task, torch.full_like(task_seq, -1), task_seq)
    sid = torch.where(acquire, run_start, sid)
    has_task = task >= 0

    fifo_room = ~h0_val | ~h1_val
    issue = has_task & ~dead_task & (sid < run_end) & fifo_room
    blocked_now = has_task & ~dead_task & ~issue

    ox, oy, oz, dx, dy, dz, rk0, rk1 = camera_rays(
        eng.cam, pid, sid, eng.base_words, eng.width, eng.height,
        eng.camera_mode, sampling=options.sampling, spp=spp)
    rays = tuple(p.contiguous() for p in (ox, oy, oz, dx, dy, dz))

    # ---- primary trace: cone cull + list kernel -----------------------
    stats = cull.block_cone_stats(issue, rays, ROWS)
    geom = eng.sphere_params[:4]
    counts, lists = cull.candidate_lists(stats, *geom, options.t_min)
    if eng.plain:
        seg = resolve_segment(
            rays, eng.sphere_params, *segment_closest_hit_list_reference(
                rays, *geom, counts, lists, options.t_min, ROWS, issue))
    else:
        seg = trace_segment_list(rays, eng.sphere_params, counts, lists,
                                 options.t_min, rows=ROWS, active=issue,
                                 table=eng.ptable)
    hit = seg["hit"] > 0
    depth0 = torch.zeros_like(sid)
    strat0 = None
    if options.sampling == "stratified":
        # Every primary-pool shade IS bounce 0, so the first-bounce
        # stratified substitution applies to the whole pool; secondaries
        # (depth >= 1 by construction) stay iid -- the same contract as
        # the single-pool engines.
        strat0 = strat0_scatter_planes(rk0, rk1, pid, sid, eng.base_words,
                                       spp, eng.shade_kw["unit_sample"])
    ndx, ndy, ndz, valid, sky_r, sky_g, sky_b = bounce_planar(
        seg, (dx, dy, dz), rk0, rk1, depth0, strat0=strat0, **eng.shade_kw)

    miss_now = issue & ~hit
    accr = torch.where(miss_now, accr + sky_r, accr)
    accg = torch.where(miss_now, accg + sky_g, accg)
    accb = torch.where(miss_now, accb + sky_b, accb)

    survive = issue & hit & valid
    if max_depth <= 1:
        survive = torch.zeros_like(survive)
    p_att = (seg["ar"], seg["ag"], seg["ab"])
    if options.rr_terminate:
        survive, p_att = _rr(options, survive, rk0, rk1, depth0, *p_att)
    to_h0 = survive & ~h0_val
    to_h1 = survive & h0_val          # issue guaranteed FIFO room
    h0_val = h0_val | to_h0
    h1_val = h1_val | to_h1
    new = (seg["px"], seg["py"], seg["pz"], ndx, ndy, ndz, *p_att, pid,
           sid)
    h0 = Handoff(h0_val, *(torch.where(to_h0, n, a)
                           for n, a in zip(new, h0_rest)))
    h1 = Handoff(h1_val, *(torch.where(to_h1, n, a)
                           for n, a in zip(new, h1_rest)))
    outs = outs + survive.to(torch.int32)
    sid = torch.where(issue, sid + 1, sid)

    # ---- secondary trace: the brute-force kernel ----------------------
    def rows2d(v):
        return v.reshape(-1, LANES)

    s_rays = tuple(rows2d(v) for v in (s_ox, s_oy, s_oz, s_dx, s_dy, s_dz))
    if eng.plain:
        sseg = resolve_segment(
            s_rays, eng.sphere_params, *segment_closest_hit_reference(
                s_rays, *geom, options.t_min, rows2d(s_act)))
    else:
        sseg = trace_segment(s_rays, eng.sphere_params, options.t_min,
                             active=rows2d(s_act), table=eng.htable)
    sseg = {k: v.reshape(s_act.shape) for k, v in sseg.items()}
    s_hit = sseg["hit"] > 0
    s_rk0, s_rk1 = ray_key_words(eng.base_words, s_pid, s_sid)
    sdx2, sdy2, sdz2, s_valid, sk_r, sk_g, sk_b = bounce_planar(
        sseg, (s_dx, s_dy, s_dz), s_rk0, s_rk1, s_dep, **eng.shade_kw)

    s_miss = s_act & ~s_hit
    s_scatter = s_act & s_hit & s_valid
    s_keep = s_scatter & (s_dep + 1 < max_depth)
    s_att = (s_ar * sseg["ar"], s_ag * sseg["ag"], s_ab * sseg["ab"])
    if options.rr_terminate:
        s_keep, s_att = _rr(options, s_keep, s_rk0, s_rk1, s_dep, *s_att)
    s_done = s_act & ~s_keep
    s_act_old = s_act

    # return credits: terminal radiance lands in the FEEDER's task
    # accumulator (lane-aligned); outstanding count drops.
    zero = torch.zeros_like(accr)
    for j in range(k_s):
        accr = accr + torch.where(s_miss[j], s_ar[j] * sk_r[j], zero)
        accg = accg + torch.where(s_miss[j], s_ag[j] * sk_g[j], zero)
        accb = accb + torch.where(s_miss[j], s_ab[j] * sk_b[j], zero)
    outs = outs - s_done.sum(dim=0, dtype=torch.int32)

    s_ox = torch.where(s_keep, sseg["px"], s_ox)
    s_oy = torch.where(s_keep, sseg["py"], s_oy)
    s_oz = torch.where(s_keep, sseg["pz"], s_oz)
    s_dx = torch.where(s_keep, sdx2, s_dx)
    s_dy = torch.where(s_keep, sdy2, s_dy)
    s_dz = torch.where(s_keep, sdz2, s_dz)
    s_ar = torch.where(s_keep, s_att[0], s_ar)
    s_ag = torch.where(s_keep, s_att[1], s_ag)
    s_ab = torch.where(s_keep, s_att[2], s_ab)
    s_dep = torch.where(s_keep, s_dep + 1, s_dep)

    # ---- task completion: all samples issued AND all paths home -------
    done = has_task & (sid >= run_end) & (outs == 0) & (pp == free_pix)
    pp = torch.where(done, pid, pp)
    pr = torch.where(done, accr, pr)
    pg = torch.where(done, accg, pg)
    pb = torch.where(done, accb, pb)
    accr = torch.where(done, zero, accr)
    accg = torch.where(done, zero, accg)
    accb = torch.where(done, zero, accb)
    task = torch.where(done, torch.full_like(task, -1), task)

    if metrics is not None:
        metrics += torch.stack([
            torch.ones((), dtype=torch.int64, device=eng.device),
            issue.sum(), s_act_old.sum(), blocked_now.sum(),
            counts.sum().to(torch.int64), taken.sum()])
    return DualState(nxt, task, sid, outs, accr, accg, accb, pp, pr, pg, pb,
                     h0, h1, s_keep, s_ox, s_oy, s_oz, s_dx, s_dy, s_dz,
                     s_ar, s_ag, s_ab, s_dep, s_pid, s_sid)


def wavefront_dual_fb(scene: Scene, cam: Camera, base_key, *,
                      with_metrics: bool = False, **config):
    """Trace every task -> UNNORMALIZED (H*W, 3) framebuffer sums.

    Keyword arguments (``build_dual_engine`` takes them): width, height,
    spp, max_depth, camera_mode, options (the frame); base_key: the
    ``(k0, k1)`` base-key words; pool_size: the total lane budget, of
    which 1 / (1 + k_s) are primary lanes; k_s: secondary copies;
    worker_index, n_workers: this worker of how many (the module
    docstring); plain: run the kernels' plain PyTorch versions whatever
    the device; device: where to render (None = the CUDA card).

    with_metrics=True additionally returns an occupancy/stall dict
    (iterations, issue/active/blocked lane-iteration sums, candidate
    totals, handoffs: exact integers summed on the device and read once
    at the end; p_lanes, s_lanes) for performance diagnosis.
    """
    run = DualRun(build_dual_engine(scene, cam, base_key, **config),
                  with_metrics)
    while run.more():
        run.epoch()
    out = run.framebuffer()
    return (out, run.metrics()) if with_metrics else out


class DualRun:
    """One worker's dual-pool frame in flight (see ops/wavefront.FrameRun):
    ``wavefront_dual_fb`` steps one, parallel/mesh.py one per worker."""

    def __init__(self, eng: DualEngine, with_metrics: bool = False):
        self.eng = eng
        # one dump cell past the image takes the empty pendings
        self.fb = torch.zeros((3, eng.n_pixels + 1), dtype=torch.float32,
                              device=eng.device)
        self.met = (torch.zeros(len(METRICS), dtype=torch.int64,
                                device=eng.device)
                    if with_metrics else None)
        self.state = initial_dual_state(eng)

    def pending(self) -> torch.Tensor:
        """Anything left to trace, as a bool on the device (no read)."""
        return (self.state.task >= 0).any() | (
            self.state.nxt < self.eng.n_seq).any()

    def more(self) -> bool:
        """Anything left to trace? One device->host read."""
        return bool(self.pending().item())

    def epoch(self) -> None:
        """FLUSH_EVERY steps, then the flush of the pendings."""
        eng, state = self.eng, self.state
        with on_device(eng.device):
            for _ in range(FLUSH_EVERY):
                state = dual_step(eng, state, self.met)
            self.fb.index_add_(1, state.pp.reshape(-1).to(torch.int64),
                               torch.stack([state.pr.reshape(-1),
                                            state.pg.reshape(-1),
                                            state.pb.reshape(-1)]))
            zero = torch.zeros_like(state.pr)
            self.state = state._replace(
                pp=torch.full_like(state.pp, eng.n_pixels), pr=zero,
                pg=zero, pb=zero)

    def framebuffer(self) -> torch.Tensor:
        """The UNNORMALIZED (H*W, 3) sums of this worker's tasks."""
        return self.fb[:, :self.eng.n_pixels].t().contiguous()

    def metrics(self) -> dict:
        met = dict(zip(METRICS, (int(v) for v in self.met.tolist())))
        met.update(p_lanes=self.eng.p, s_lanes=self.eng.k_s * self.eng.p)
        return met


def render_wavefront_dual(scene: Scene, cam: Camera, base_key, *, spp: int,
                          with_metrics: bool = False, **config):
    """Render the full image -> (H*W, 3) linear radiance means, a tensor
    on ``device`` (None = the CUDA card). Arguments as
    ``wavefront_dual_fb``; with_metrics=True also returns its dict."""
    out = wavefront_dual_fb(scene, cam, base_key, spp=spp,
                            with_metrics=with_metrics, **config)
    if with_metrics:
        fb, met = out
        return fb / float(spp), met
    return out / float(spp)
