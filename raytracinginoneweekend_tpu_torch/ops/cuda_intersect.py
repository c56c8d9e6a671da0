"""Closest hit over an (N, 3) ray wavefront: CUDA kernel wrapper.

Counterpart of ``raytracinginoneweekend_tpu/ops/pallas_intersect.py``.

KERNEL NOTE. ``closest_hit_cuda`` on CUDA tensors launches
``csrc/intersect.cu``, which replaces the Pallas TPU kernel
``pallas_intersect.py::_kernel`` (reached through ``closest_hit_pallas``).
It is bound by float32 instruction issue (about 18 operations per ray and
sphere where the discriminant is not positive, nearly every pair, 31
where it is, against 33 bytes per ray; under ``-fmad=false`` each is its
own instruction). The design keeps the sphere table in shared memory,
splits each ray's sphere loop over K threads (``closest_hit_split``
aimed at ``cuda_segment.IX_THREADS_PER_SM`` picks K so that the grid
fills the card), reduces the K partials lexicographically over (t, sphere
index) with warp shuffles, takes the square root only where the
discriminant is positive, and takes any N with a bounds check where the
TPU wrapper pads to blocks of 4096 rays (see the source's header). The
result is the one-thread loop's to the bit for every K. Its plain
PyTorch version is ``ops/intersect.closest_hit``: the same t-space
candidate formula in the same order.

For a tensor on the CPU the wrapper runs the plain version; for a CUDA
tensor it launches the kernel or raises -- it never falls back.

Forward only, like the TPU kernel: ``ops/intersect.closest_hit_diff``
(``use_pallas=True``) puts it under autograd.
"""

from __future__ import annotations

import torch

from .. import kernels
from .cuda_segment import (IX_THREADS_PER_SM, MAX_SPHERES,
                           check_current_device, check_split, picked_split)
from .intersect import closest_hit


def closest_hit_cuda(origin, direction, centers, radii, t_min, split=None):
    """Drop-in ``closest_hit``: (N,3), (N,3), (S,3), (S,) -> (t, idx, hit)
    with t (N,) f32 (1e30 where no hit), idx (N,) i32 (0 where no hit),
    hit (N,) bool. ``split`` forces the kernel's K (one of
    ``cuda_segment.CH_SPLITS``) in place of the picker's
    (``IX_THREADS_PER_SM``); for measuring, it changes no result. CUDA
    tensors go through the hand-written kernel on the current stream (no
    synchronise); CPU tensors through the plain version.
    """
    check_split("intersect", split)
    if origin.device.type == "cpu":
        return closest_hit(origin, direction, centers, radii, t_min)
    if origin.device.type != "cuda":
        raise ValueError(f"intersect: no kernel for device {origin.device}")
    device, n = origin.device, origin.shape[0]
    for name, x in (("origin", origin), ("direction", direction)):
        if (x.dtype != torch.float32 or x.shape != (n, 3)
                or x.device != device or not x.is_contiguous()):
            raise ValueError(
                f"intersect: {name} must be a contiguous float32 ({n}, 3) "
                f"tensor on {device}; got {x.dtype} {tuple(x.shape)} on "
                f"{x.device}, contiguous={x.is_contiguous()}")
    if not 1 <= 3 * n < 2 ** 31:
        raise ValueError(f"intersect: {n} rays; the kernel indexes "
                         "3*N with a 32-bit int and takes at least one ray")
    s = centers.shape[0]
    if not 1 <= s <= MAX_SPHERES:
        raise ValueError(f"intersect: {s} spheres; the kernel takes "
                         f"1..{MAX_SPHERES}")
    if (centers.dtype != torch.float32 or centers.shape != (s, 3)
            or centers.device != device):
        raise ValueError(f"intersect: centers must be ({s}, 3) float32 on "
                         f"{device}")
    if (radii.dtype != torch.float32 or radii.shape != (s,)
            or radii.device != device):
        raise ValueError(f"intersect: radii must be ({s},) float32 on "
                         f"{device}")
    check_current_device(device)
    table = torch.cat([centers.detach(), radii.detach()[:, None]],
                      dim=1).contiguous()  # (S, 4) cx cy cz r
    if split is None:
        split = picked_split(n, device.index, IX_THREADS_PER_SM)
    t = torch.empty(n, dtype=torch.float32, device=device)
    idx = torch.empty(n, dtype=torch.int32, device=device)
    hit = torch.empty(n, dtype=torch.bool, device=device)
    fn = kernels.entry("rtw_closest_hit_n3")
    err = fn(origin.data_ptr(), direction.data_ptr(), table.data_ptr(),
             t.data_ptr(), idx.data_ptr(), hit.data_ptr(), n, s,
             float(t_min), split,
             torch.cuda.current_stream(device).cuda_stream)
    kernels.check(err, "intersect")
    kernels.LAUNCHES["intersect"] += 1
    return t, idx, hit
