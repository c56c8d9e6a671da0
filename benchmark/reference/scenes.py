"""The benchmark's scenes and cameras, as NumPy arrays.

A frozen copy of the scene generators and the thin-lens camera of Ray
Tracing in One Weekend as the upstream project (Alabuta/
RaytracingInOneWeekend) writes them, so that the inputs of a cell never
depend on the program under test:

* ``simple_cuda`` is the five-sphere scene of the project's active CUDA
  renderer (``cuda_impl.cu:404-417``), with its hollow glass sphere of
  radius -0.499;
* ``huge(seed)`` is the 22 x 22 random-sphere cover scene
  (``main.cxx:131-177``): the base scene of ``main.cxx:120-129``, then for
  every grid cell a sphere of radius 0.2 unless it lies within 1 of
  (0, 1, 0), its material drawn from a ``numpy.random.default_rng(seed)``;
  the upstream draw of material type 3, which dangles, is a lambertian;
* ``camera`` is ``camera.hxx:24-44`` in float32.

Both sides of a comparison get these arrays: the program through its own
``scene_from_numpy`` / ``camera_from_numpy``, the reference directly.
"""

from __future__ import annotations

import numpy as np

LAMBERT, METAL, DIELECTRIC = 0, 1, 2

_BASE_MATERIALS = [
    (LAMBERT, (0.1, 0.2, 0.5), 0.0, 1.0),
    (METAL, (0.8, 0.6, 0.2), 0.0, 1.0),
    (DIELECTRIC, (1.0, 1.0, 1.0), 0.0, 1.5),
    (LAMBERT, (0.64, 0.8, 0.0), 0.0, 1.0),
]

FIELDS = ("centers", "radii", "material_index", "mtype", "albedo", "fuzz",
          "ior")
CAMERA_FIELDS = ("origin", "lower_left", "horizontal", "vertical",
                 "basis_u", "basis_v", "lens_radius")


def _arrays(materials, spheres) -> dict:
    return {
        "centers": np.array([s[0] for s in spheres], np.float32),
        "radii": np.array([s[1] for s in spheres], np.float32),
        "material_index": np.array([s[2] for s in spheres], np.int32),
        "mtype": np.array([m[0] for m in materials], np.int32),
        "albedo": np.array([m[1] for m in materials], np.float32),
        "fuzz": np.array([m[2] for m in materials], np.float32),
        "ior": np.array([m[3] for m in materials], np.float32),
    }


def simple_cuda() -> dict:
    spheres = [
        ((0.0, 0.0, -1.0), 0.5, 0),
        ((0.0, -100.5, -1.0), 100.0, 3),
        ((1.0, 0.0, -1.0), 0.5, 1),
        ((-1.0, 0.0, -1.0), 0.5, 2),
        ((-1.0, 0.0, -1.0), -0.499, 2),
    ]
    return _arrays(list(_BASE_MATERIALS), spheres)


def huge(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    materials = list(_BASE_MATERIALS)
    spheres = [
        ((0.0, 1.0, 0.0), 1.0, 0),
        ((0.0, -1000.125, 0.0), 1000.0, 3),
        ((2.0, 1.0, 0.0), 1.0, 1),
        ((-2.0, 1.0, 0.0), 1.0, 2),
        ((-2.0, 1.0, 0.0), -0.99, 2),
    ]
    for a in range(-11, 11):
        for b in range(-11, 11):
            kind = int(rng.integers(0, 4))
            center = (0.9 * float(rng.random()) + a, 0.2,
                      0.9 * float(rng.random()) + b)
            if np.linalg.norm(np.array(center) - (0.0, 1.0, 0.0)) < 1.0:
                continue
            color = tuple(float(rng.random()) for _ in range(3))
            if kind in (0, 3):
                materials.append((LAMBERT, color, 0.0, 1.0))
            elif kind == 1:
                materials.append((METAL, color, 0.5 * float(rng.random()),
                                  1.0))
            else:
                materials.append((DIELECTRIC, color, 0.0, 1.5))
            spheres.append((center, 0.2, len(materials) - 1))
    return _arrays(materials, spheres)


SCENES = {"simple_cuda": lambda seed: simple_cuda(), "huge": huge}


def _unit(v):
    n = np.float32(np.sqrt(np.float32(np.dot(v, v))))
    return (v / n).astype(np.float32)


def camera(position, lookat, up, aspect, vfov, aperture, focus) -> dict:
    """camera.hxx:24-44 in float32 -> the camera's arrays."""
    f32 = np.float32
    position, lookat, up = (np.asarray(x, f32) for x in (position, lookat,
                                                         up))
    if focus == "distance":
        focus = float(np.linalg.norm(np.asarray(position, np.float64)
                                     - np.asarray(lookat, np.float64)))
    half = np.tan(f32(vfov) * f32(np.pi / 180.0) / f32(2), dtype=f32)
    width = f32(half * f32(aspect))
    w = _unit(position - lookat)
    u = _unit(np.cross(up, w).astype(f32))
    v = _unit(np.cross(w, u).astype(f32))
    focus = f32(focus)
    return {
        "origin": position,
        "lower_left": (position - (u * width + v * half + w) * focus
                       ).astype(f32),
        "horizontal": (u * width * focus * f32(2)).astype(f32),
        "vertical": (v * half * focus * f32(2)).astype(f32),
        "basis_u": u, "basis_v": v,
        "lens_radius": np.asarray(f32(aperture) / f32(2), f32),
    }


def from_config(cfg: dict, scene_seed: int | None = None):
    """A configuration file's scene and camera -> (scene, camera) arrays.
    ``scene_seed`` replaces the configuration's generator seed."""
    sc = cfg["scene"]
    seed = sc["seed"] if scene_seed is None else scene_seed
    cam = cfg["camera"]
    return (SCENES[sc["generator"]](seed),
            camera(cam["position"], cam["lookat"], cam["up"],
                   cfg["width"] / cfg["height"], cam["vfov"],
                   cam["aperture"], cam["focus"]))
