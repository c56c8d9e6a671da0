"""A mesh of workers over the pixel/task axis.

Counterpart of ``raytracinginoneweekend_tpu/parallel/mesh.py``. Where the
JAX package shard_maps one program over a 1-D ``jax.sharding.Mesh``, the
port runs one engine a WORKER: a worker is a device of this process
(``Mesh.devices``, which may name one card several times) and, under a
``torch.distributed`` process group, the workers of every rank together
form the mesh. Scene and camera are replicated (moved to each worker's
device); worker g of ``mesh.size`` renders its shard of the pixels or
tasks with the same program one device runs, and the shards meet once at
the end of the frame: the workers' results are gathered and summed (or
concatenated) in global worker order, so the frame does not depend on
which worker finished first and two renders hash the same.

The workers of one process are stepped in turn, one epoch each before any
worker's termination flag is read, so distinct cards overlap and no
worker's host read stalls the others; no collective runs inside an epoch
(nor inside a captured epoch graph).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..config import RenderConfig, TraceOptions
from ..models.camera import Camera
from ..models.scene import Scene
from ..ops import threefry as tf
from ..ops.wavefront import FrameRun, build_engine
from ..ops.wavefront_dual import SECONDARY_COPIES, DualRun, build_dual_engine
from ..render import render_pixels_impl
from ..utils.device import on_device, resolve_device
from ..utils.timing import span


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The workers this process drives, in global order from ``first``.

    devices: one ``torch.device`` a local worker (may repeat a device);
    group: the process group the workers of other ranks are in (None: this
    process holds the whole mesh); first: the global index of this
    process's first worker; size: the global worker count."""

    devices: tuple
    group: object = None
    first: int = 0
    size: int = 0

    def workers(self):
        """(global worker index, device) of each local worker."""
        return [(self.first + i, d) for i, d in enumerate(self.devices)]


def make_mesh(devices=None) -> Mesh:
    """A 1-D mesh over ``devices``.

    Without a process group, None means every local CUDA card (and raises
    when there is none: ``resolve_device``'s rule). Under an initialised
    process group (``distributed.initialize_distributed``), None means this
    rank's one card, and every rank must name as many devices. A device may
    repeat: ``make_mesh([torch.device("cpu")] * 8)`` is 8 workers on the
    CPU, ``make_mesh([torch.device("cuda")] * 4)`` 4 workers on one card.
    """
    grouped = dist.is_available() and dist.is_initialized()
    if devices is None:
        resolve_device(None)  # raises without a card
        devices = ([torch.device("cuda", torch.cuda.current_device())]
                   if grouped else
                   [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())])
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if not grouped:
        return Mesh(devices, None, 0, len(devices))
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, len(devices))
    if len(set(counts)) != 1:
        raise ValueError(f"every rank must name as many devices: {counts}")
    return Mesh(devices, dist.group.WORLD, dist.get_rank() * len(devices),
                len(devices) * len(counts))


def _collective(mesh: Mesh, tensor: torch.Tensor, run) -> torch.Tensor:
    """Run ``run(t)`` on a copy of ``tensor`` where the group's backend
    takes it (gloo: the host) and return the result where ``tensor``
    lies."""
    host = (dist.get_backend(mesh.group) == "gloo"
            and tensor.device.type != "cpu")
    out = run(tensor.cpu() if host else tensor)
    return out.to(tensor.device)


def all_reduce_sum(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """The sum of ``tensor`` over the ranks of the mesh (itself without a
    process group)."""
    if mesh.group is None:
        return tensor

    def run(t):
        t = t.clone()
        dist.all_reduce(t, group=mesh.group)
        return t
    return _collective(mesh, tensor, run)


def gather_workers(mesh: Mesh, parts) -> list:
    """Every worker's tensor, in global worker order, on the mesh's first
    device. ``parts``: this process's workers' tensors (equal shapes), in
    local order; across ranks one all-gather."""
    dev0 = mesh.devices[0]
    local = torch.stack([p.to(dev0) for p in parts])
    if mesh.group is None:
        return list(local.unbind(0))

    def run(t):
        bufs = [torch.empty_like(t) for _ in range(dist.get_world_size(
            mesh.group))]
        dist.all_gather(bufs, t, group=mesh.group)
        return torch.cat(bufs)
    return list(_collective(mesh, local, run).unbind(0))


def _ordered_sum(parts) -> torch.Tensor:
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def render_sharded(scene: Scene, cam: Camera, pixel_ids, base_key, *,
                   mesh: Mesh, width: int, height: int, spp: int,
                   wave_spp: int, max_depth: int, camera_mode: str,
                   options: TraceOptions, differentiable: bool = False):
    """Render a chunk of pixels sharded over the mesh -> (P, 3) on the
    mesh's first device.

    ``pixel_ids`` (the whole chunk, on every rank) must divide by the mesh
    size (pad with any ids and drop the tail). Worker g renders the g-th
    equal shard with the tiled engine (``render.render_pixels_impl``) on
    its device. In one process the shards are concatenated (autograd flows
    back through every shard); under a process group they are gathered,
    and the result is detached.
    """
    n = pixel_ids.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} pixel ids do not divide over a mesh of "
                         f"{mesh.size} workers")
    per = n // mesh.size
    outs = []
    for g, dev in mesh.workers():
        with on_device(dev):
            outs.append(render_pixels_impl(
                scene.to(dev), cam.to(dev),
                pixel_ids[g * per:(g + 1) * per].to(dev), base_key,
                width=width, height=height, spp=spp, wave_spp=wave_spp,
                max_depth=max_depth, camera_mode=camera_mode,
                options=options, differentiable=differentiable))
    if mesh.group is None:
        return torch.cat([o.to(mesh.devices[0]) for o in outs])
    return torch.cat(gather_workers(mesh, [o.detach() for o in outs]))


def render_image_sharded(scene: Scene, cam: Camera, cfg: RenderConfig,
                         base_key=None, mesh: Mesh | None = None,
                         differentiable: bool = False):
    """Render a full image over the mesh -> (H, W, 3) linear float32 on
    the mesh's first device.

    Tiling as ``render.render``: pixels x spp are chunked so that each
    WORKER traces at most cfg.rays_per_chunk rays a wave. The pixel count
    is padded up to a multiple of the mesh size (the padded tail is traced
    -- at most mesh.size - 1 wasted pixels a chunk -- and dropped).
    """
    if base_key is None:
        base_key = tf.key_words(0)
    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.size
    w, h, spp = cfg.width, cfg.height, cfg.spp
    n_pixels = w * h

    # Per-worker wave sizing (the one-device policy, with the budget
    # applying to each worker's shard).
    per_dev_pixels = -(-n_pixels // n_dev)
    wave_spp = max(1, min(spp, cfg.rays_per_chunk // max(1, per_dev_pixels)))
    if wave_spp > 1:
        chunk = n_dev * per_dev_pixels  # whole image in one sharded call
    else:
        chunk = min(n_pixels, cfg.rays_per_chunk * n_dev)
        chunk = -(-chunk // n_dev) * n_dev
    n_chunks = -(-n_pixels // chunk)

    all_ids = torch.arange(n_chunks * chunk, dtype=torch.int32)
    parts = [render_sharded(
        scene, cam, all_ids[i * chunk:(i + 1) * chunk], base_key, mesh=mesh,
        width=w, height=h, spp=spp, wave_spp=wave_spp,
        max_depth=cfg.max_depth, camera_mode=cfg.camera_mode,
        options=cfg.options, differentiable=differentiable)
        for i in range(n_chunks)]
    return torch.cat(parts)[:n_pixels].reshape(h, w, 3)


def _drive(runs) -> None:
    """Step every worker's frame to its end: one epoch of each live worker
    in turn, then the termination flags of all (each a device read)."""
    live = list(runs)
    while live:
        flags = [r.pending() for r in live]
        live = [r for r, f in zip(live, flags) if bool(f)]
        for r in live:
            r.epoch()


def render_wavefront_sharded(scene: Scene, cam: Camera, base_key, *,
                             mesh: Mesh, width: int, height: int, spp: int,
                             max_depth: int, camera_mode: str,
                             options: TraceOptions,
                             pool_size: int = 1 << 15,
                             reserve_frac: float | None = None,
                             return_stats: bool = False):
    """Multi-worker wavefront render -> (H*W, 3) linear radiance means on
    the mesh's first device.

    Worker g runs the single-pool engine (ops/wavefront.py) with
    ``worker_index=g, n_workers=mesh.size`` on its device: its lane l owns
    tasks g*P + l, + n*P, ... (or, under tile ownership, the g-th range of
    ownership blocks), with its own slice of the tail reserve. No
    communication until the frame's end, where the partial framebuffers
    are gathered and summed in worker order and divided by spp.
    pool_size is PER WORKER. return_stats: also return {"workers": [each local worker's
    {"iters", "segments", "lanes"}]}.
    """
    with span("rtw.wavefront.build"):
        runs = [FrameRun(build_engine(
            scene, cam, base_key, width=width, height=height, spp=spp,
            max_depth=max_depth, camera_mode=camera_mode, options=options,
            pool_size=pool_size, worker_index=g, n_workers=mesh.size,
            reserve_frac=reserve_frac, device=dev), return_stats)
            for g, dev in mesh.workers()]
    _drive(runs)
    fb = _ordered_sum(gather_workers(
        mesh, [r.framebuffer() for r in runs])) / float(spp)
    if return_stats:
        return fb, {"workers": [r.stats() for r in runs]}
    return fb


def render_wavefront_dual_sharded(scene: Scene, cam: Camera, base_key, *,
                                  mesh: Mesh, width: int, height: int,
                                  spp: int, max_depth: int,
                                  camera_mode: str, options: TraceOptions,
                                  pool_size: int = 1 << 15,
                                  k_s: int = SECONDARY_COPIES):
    """Multi-worker dual-pool render -> (H*W, 3) radiance means on the
    mesh's first device: the structure of ``render_wavefront_sharded``
    over ops/wavefront_dual.py. pool_size is the PER-WORKER lane budget
    across both pools."""
    runs = [DualRun(build_dual_engine(
        scene, cam, base_key, width=width, height=height, spp=spp,
        max_depth=max_depth, camera_mode=camera_mode, options=options,
        pool_size=pool_size, k_s=k_s, worker_index=g, n_workers=mesh.size,
        device=dev)) for g, dev in mesh.workers()]
    _drive(runs)
    return _ordered_sum(gather_workers(
        mesh, [r.framebuffer() for r in runs])) / float(spp)
