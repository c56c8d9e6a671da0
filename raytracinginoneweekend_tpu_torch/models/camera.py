"""Thin-lens camera as a small container of tensors.

The port's copy of ``raytracinginoneweekend_tpu/models/camera.py``.
``camera_ray`` is the tiled engine's ray generator, written batched over
(N,) film coordinates; the planar engines generate rays on planes
(ops/planar.camera_rays).
Re-expression of ``raytracer::camera`` (camera.hxx:19-77): the constructor
math is identical (basis from position/lookat/up, FOV half-angle tangent,
focus-distance-scaled film rectangle, camera.hxx:31-43), in float32.

Defocus modes (static config, selects the ray-generation code):
  - "thinlens" (default): physically correct thin-lens -- offset sampled on
    the lens disk in the camera's (u,v) basis; direction re-aimed at the
    focal point.
  - "pinhole": no lens.
  - "cuda": no defocus at all, offset = 0 (camera.hxx:48-49, quirk Q1).
  - "cpu": the dead CPU path's quirky defocus (camera.hxx:51-53, quirk Q2):
    a point in the unit *sphere* scaled by lens_radius, with the offset
    built in WORLD axes as (u*rd.x, v*rd.y, 0).

Direction quirk Q11 (camera.hxx:56): the reference ray direction never
subtracts ``origin``. Modes "cuda"/"cpu" reproduce the reference
expression verbatim; "thinlens" and "pinhole" subtract origin properly.

The v flip ``vertical*(1-v)`` (camera.hxx:56) is kept in all modes: v=0 is
the TOP image row.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import math3
from ..utils.device import resolve_device


class Camera(NamedTuple):
    origin: torch.Tensor  # (3,)
    lower_left: torch.Tensor  # (3,)
    horizontal: torch.Tensor  # (3,)
    vertical: torch.Tensor  # (3,)
    basis_u: torch.Tensor  # (3,) lens-plane x axis
    basis_v: torch.Tensor  # (3,) lens-plane y axis
    lens_radius: torch.Tensor  # ()

    def to(self, device) -> "Camera":
        """The same camera with every tensor on ``device``."""
        return Camera(*(t.to(device) for t in self))


def camera_from_numpy(origin, lower_left, horizontal, vertical, basis_u,
                      basis_v, lens_radius, device=None) -> Camera:
    """Arrays -> Camera on ``device`` (None = the CUDA card). Carries a
    camera of the JAX package across:
    ``camera_from_numpy(*map(np.asarray, jax_cam), device=...)``."""
    device = resolve_device(device)

    def put(a):
        # np.array copies (and keeps a 0-d lens radius 0-d)
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return Camera(put(origin), put(lower_left), put(horizontal),
                  put(vertical), put(basis_u), put(basis_v),
                  put(lens_radius))


def make_camera(position, lookat, up, aspect, vfov_degrees, aperture,
                focus_distance, device=None) -> Camera:
    """camera.hxx:24-44, verbatim math, in float32 on the host; the
    result is moved to ``device`` (None = the CUDA card)."""
    device = resolve_device(device)
    f32 = torch.float32
    position = torch.tensor(np.asarray(position, np.float64), dtype=f32)
    lookat = torch.tensor(np.asarray(lookat, np.float64), dtype=f32)
    up = torch.tensor(np.asarray(up, np.float64), dtype=f32)

    theta = math3.radians(torch.tensor(vfov_degrees, dtype=f32)) / 2.0
    height = torch.tan(theta)
    width = height * aspect

    w = math3.normalize(position - lookat)
    u = math3.normalize(math3.cross(up, w))
    v = math3.normalize(math3.cross(w, u))

    lower_left = position - (u * width + v * height + w) * focus_distance
    horizontal = u * width * focus_distance * 2.0
    vertical = v * height * focus_distance * 2.0

    return Camera(
        origin=position,
        lower_left=lower_left,
        horizontal=horizontal,
        vertical=vertical,
        basis_u=u,
        basis_v=v,
        lens_radius=torch.tensor(aperture, dtype=f32) / 2.0,
    ).to(device)


def camera_ray(cam: Camera, u, v, key_words, mode: str = "thinlens",
               lens_uv=None):
    """Generate primary rays for (N,) film coordinates u, v.

    Returns (origin (N, 3), direction (N, 3)). ``key_words`` is the rays'
    RAY KEY, a pair of (N,) key-word tensors (ops/rng.ray_key); lens draws
    use its TAG_LENS counter blocks ("cuda" and "pinhole" draw nothing).

    lens_uv: optional pre-remapped (u0, u1) pair for the thinlens disk
    sample (the stratified-lens path, rng.stratify_lens_uv); None draws
    the iid pair from the ray key.
    """
    from ..ops import rng

    u, v = u[:, None], v[:, None]
    film = cam.lower_left + cam.horizontal * u + cam.vertical * (1.0 - v)
    origin = cam.origin.expand(film.shape)
    if mode == "cuda":
        # camera.hxx:48-49 + :56 (no -origin, quirk Q11).
        return origin, film
    if mode == "cpu":
        # camera.hxx:51-56: unit-SPHERE sample, world-axis offset scaled by
        # screen (u,v); direction keeps quirk Q11 (no -origin).
        rd = rng.lens_sphere(key_words) * cam.lens_radius
        offset = torch.cat([u * rd[:, 0:1], v * rd[:, 1:2],
                            torch.zeros_like(u)], dim=1)
        return cam.origin + offset, film - offset
    if mode == "thinlens":
        # True thin-lens: disk sample in the lens basis; correct direction.
        if lens_uv is not None:
            rd = torch.stack(rng.disk_from_uv(*lens_uv), dim=-1)
        else:
            rd = rng.lens_disk(key_words)
        rd = rd * cam.lens_radius
        offset = cam.basis_u * rd[:, 0:1] + cam.basis_v * rd[:, 1:2]
        return cam.origin + offset, film - cam.origin - offset
    if mode == "pinhole":
        return origin, film - cam.origin
    raise ValueError(f"unknown camera mode: {mode!r}")


def reference_cuda_camera(width: int, height: int, device=None) -> Camera:
    """The camera the reference actually renders with (cuda_impl.cu:348-352):
    position (0,0,0) -> lookat (0,0,-1), vFOV 88, aperture .0625, focus 1."""
    return make_camera((0, 0, 0), (0, 0, -1), (0, 1, 0),
                       float(width) / float(height), 88.0, 0.0625, 1.0,
                       device=device)


def reference_cpu_camera(width: int, height: int, device=None) -> Camera:
    """The dead CPU path's camera (main.cxx:179-183)."""
    pos = np.array([-4.0, 3.2, 5.0])
    lookat = np.array([0.0, 1.0, 0.0])
    focus = float(np.linalg.norm(pos - lookat))
    return make_camera(pos, lookat, (0, 1, 0),
                       float(width) / float(height), 42.0, 0.0625, focus,
                       device=device)
