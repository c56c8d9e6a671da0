"""The plain path tracer the benchmark holds the program to.

Vectorised PyTorch over rays, with the semantics of Ray Tracing in One
Weekend as the upstream CUDA renderer computes them (``cuda_impl.cu``) and
the corrected physics of the program's default options:

* camera ray of (pixel, sample): jitter (u, v) from draw (0, 0); film point
  ``lower_left + horizontal * (x + u) / W + vertical * (1 - (y + v) / H)``;
  a thin lens of radius ``lens_radius`` sampled on the unit disk from draw
  (1, 0) (angle 2 pi u0, radius sqrt(u1)) in the camera's (u, v) basis; the
  ray leaves the lens point towards the film point;
* closest hit: the first sphere index with the smallest root t of
  ``|o + t d - c|^2 = r^2`` in (t_min, inf), the near root before the far;
  negative radii turn the normal ``(p - c) / r`` inwards;
* bounce b draws (2 + b, 0) -> a uniform unit vector (z = 2 u0 - 1, angle
  2 pi u1) and (2 + b, 1) -> its second word picks reflection over
  refraction; lambertian: n + vector; metal: reflect(unit d, n) + fuzz *
  vector, absorbed unless it leaves the surface; dielectric: Schlick's
  reflectance or total internal reflection against Snell's refraction;
* a ray that misses takes the sky ``(1 - t) white + t (0.5, 0.7, 1)``, t =
  0.5 y + 0.5 of its unit direction, times the product of the albedos it
  met; after ``max_depth`` hits without a miss, or absorbed, it is black;
* a pixel is the mean of its samples.

``trace`` renders pixel ids in the given dtype (float32, or a lower one for
the benchmark's controls). With ``grad=True`` the scene's centers and
albedos may require gradients: the closest sphere and root are picked
without them, then the root is recomputed for the winner, so autograd
differentiates the same root formula the hit used.
"""

from __future__ import annotations

import math

import torch

from . import threefry as tf
from .scenes import DIELECTRIC, METAL

T_MIN = 0.008
SKY_BLUE = (0.5, 0.7, 1.0)
_PAIRS = 1 << 24  # ray-sphere pairs a closest-hit block evaluates at once


class Scene:
    """The scene's tensors on one device, in one dtype (the geometry and
    materials; ``centers`` and ``albedo`` may be autograd leaves)."""

    def __init__(self, arrays: dict, device, dtype=torch.float32,
                 centers=None, albedo=None):
        def put(name, dt):
            return torch.as_tensor(arrays[name]).to(device=device, dtype=dt)

        self.centers = put("centers", dtype) if centers is None else centers
        self.radii = put("radii", dtype)
        self.material = put("material_index", torch.int64)
        self.mtype = put("mtype", torch.int64)
        self.albedo = put("albedo", dtype) if albedo is None else albedo
        self.fuzz = put("fuzz", dtype)
        self.ior = put("ior", dtype)


def _dot(a, b):
    return (a * b).sum(-1)


def _unit(v):
    return v / torch.sqrt(_dot(v, v))[:, None]


def closest_hit(o, d, centers, radii, t_min=T_MIN):
    """-> (sphere index, hit mask, far-root mask) of each ray."""
    n, s = o.shape[0], centers.shape[0]
    best_t = torch.full((n,), math.inf, dtype=o.dtype, device=o.device)
    best_i = torch.zeros((n,), dtype=torch.int64, device=o.device)
    best_far = torch.zeros((n,), dtype=torch.bool, device=o.device)
    a = _dot(d, d)[:, None]
    step = max(1, _PAIRS // max(1, n))
    for lo in range(0, s, step):
        c, r = centers[lo:lo + step], radii[lo:lo + step]
        oc = o[:, None, :] - c[None, :, :]
        b = (oc * d[:, None, :]).sum(-1)
        cc = (oc * oc).sum(-1) - r * r
        disc = b * b - a * cc
        ok = disc > 0
        sq = torch.sqrt(torch.where(ok, disc, torch.ones_like(disc)))
        near, far = (-b - sq) / a, (-b + sq) / a
        use_near = ok & (near > t_min)
        use_far = ok & ~use_near & (far > t_min)
        t = torch.where(use_near, near, torch.where(use_far, far, math.inf))
        t_blk, i_blk = torch.min(t, dim=1)
        far_blk = torch.gather(use_far, 1, i_blk[:, None])[:, 0]
        better = t_blk < best_t
        best_t = torch.where(better, t_blk, best_t)
        best_i = torch.where(better, i_blk + lo, best_i)
        best_far = torch.where(better, far_blk, best_far)
    return best_i, torch.isfinite(best_t), best_far


GRAZE = 1e-12  # |(p - c) . d| at or under which a hit's root is held


def hit_distance(o, d, c, r, far):
    """The root of the hit sphere (its center c, radius r), near or far.

    Its derivative is the implicit one, -dF / (dF/dt) with dF/dt = 2 (p -
    c) . d = +-2 sqrt(disc); a grazing hit, sqrt(disc) <= GRAZE, has none
    that float32 can hold, and its root is held constant (autograd would
    give inf, and Adam NaN)."""
    oc = o - c
    a = _dot(d, d)
    b = _dot(oc, d)
    disc = b * b - a * (_dot(oc, oc) - r * r)
    ok = disc > GRAZE * GRAZE
    sq = torch.where(ok, torch.sqrt(torch.where(ok, disc, 1.0)),
                     torch.sqrt(torch.clamp(disc, min=0.0)).detach())
    t = torch.where(far, -b + sq, -b - sq) / a
    return torch.where(ok, t, t.detach())


def camera_rays(cam: dict, pid, sid, base, width, height, dtype):
    """Camera rays of (pixel, sample) pairs -> (o, d, ray key)."""
    key = tf.ray_key(base, pid, sid)
    ju, jv = (x.to(dtype) for x in tf.uniforms(key, 0, 0))
    y = torch.div(pid, width, rounding_mode="floor")
    x = pid - y * width
    u = (x.to(dtype) + ju) / width
    v = (y.to(dtype) + jv) / height
    film = (cam["lower_left"] + cam["horizontal"] * u[:, None]
            + cam["vertical"] * (1.0 - v)[:, None])
    l0, l1 = (x.to(dtype) for x in tf.uniforms(key, 1, 0))
    theta, rad = 2 * math.pi * l0, torch.sqrt(l1)
    r0 = torch.cos(theta) * rad * cam["lens_radius"]
    r1 = torch.sin(theta) * rad * cam["lens_radius"]
    offset = cam["basis_u"] * r0[:, None] + cam["basis_v"] * r1[:, None]
    return cam["origin"] + offset, film - cam["origin"] - offset, key


def _scatter(ud, nrm, mt, fuzz, ior, vec, pick):
    """New directions and whether each survives (metal may absorb)."""
    cos = _dot(ud, nrm)
    refl = ud - 2.0 * cos[:, None] * nrm
    metal = refl + vec * fuzz[:, None]
    lambert = nrm + vec
    entering = cos <= 0
    outward = torch.where(entering[:, None], nrm, -nrm)
    eta = torch.where(entering, 1.0 / ior, ior)
    cos_i = _dot(outward, ud)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k < 0
    # double where: the root's derivative is never taken at k <= 0
    pos = k > 0
    sq = torch.where(pos, torch.sqrt(torch.where(pos, k, 1.0)), 0.0)
    refr = eta[:, None] * ud - (eta * cos_i + sq)[:, None] * outward
    r0 = ((1.0 - eta) / (1.0 + eta)) ** 2
    c = 1.0 - cos.abs()
    c2 = c * c
    prob = torch.where(tir, torch.ones_like(c),
                       r0 + (1.0 - r0) * (c * (c2 * c2)))
    glass = torch.where((pick < prob)[:, None], refl, refr)
    new = torch.where((mt == DIELECTRIC)[:, None], glass,
                      torch.where((mt == METAL)[:, None], metal, lambert))
    alive = (mt != METAL) | (_dot(metal, nrm) > 0)
    return new, alive


def trace(scene: Scene, cam: dict, pixel_ids, spp: int, base, *,
          width: int, height: int, max_depth: int, dtype=torch.float32,
          grad: bool = False) -> torch.Tensor:
    """Mean radiance of each pixel id -> (P, 3) in ``dtype``.

    cam: ``scenes.camera`` arrays; base: the frame's key words. Every
    live ray is traced together; rays that finish leave the batch."""
    with torch.set_grad_enabled(grad):
        return _trace(scene, cam, pixel_ids, spp, base, width, height,
                      max_depth, dtype, grad)


def _trace(scene, cam, pixel_ids, spp, base, width, height, max_depth,
           dtype, grad):
    dev = scene.radii.device
    cam = {k: torch.as_tensor(v).to(device=dev, dtype=dtype)
           for k, v in cam.items()}
    pid = torch.as_tensor(pixel_ids, device=dev).to(torch.int64)
    n = pid.numel() * spp
    pid = pid.repeat_interleave(spp)
    sid = torch.arange(spp, device=dev).repeat(n // spp)
    with torch.no_grad():
        o, d, key = camera_rays(cam, pid, sid, base, width, height, dtype)
    radiance = torch.zeros((n, 3), dtype=dtype, device=dev)
    atten = torch.ones((n, 3), dtype=dtype, device=dev)
    ray = torch.arange(n, device=dev)
    white = torch.ones(3, dtype=dtype, device=dev)
    blue = torch.tensor(SKY_BLUE, dtype=dtype, device=dev)
    for bounce in range(max_depth):
        if ray.numel() == 0:
            break
        with torch.no_grad():
            sph, hit, far = closest_hit(o.detach(), d.detach(),
                                        scene.centers.detach(), scene.radii)
        miss = ~hit
        ud = _unit(d[miss])
        t_sky = 0.5 * ud[:, 1:2] + 0.5
        sky = white * (1.0 - t_sky) + blue * t_sky
        radiance = radiance.index_add(0, ray[miss], atten[miss] * sky)
        o, d, atten, ray, sph, far = (x[hit] for x in (o, d, atten, ray,
                                                       sph, far))
        key = (key[0][hit], key[1][hit])
        c, r = scene.centers[sph], scene.radii[sph]
        t = hit_distance(o, d, c, r, far)
        p = o + t[:, None] * d
        nrm = (p - c) / r[:, None]
        mat = scene.material[sph]
        u0, u1 = (x.to(dtype) for x in tf.uniforms(key, 2 + bounce, 0))
        _, pick = (x.to(dtype) for x in tf.uniforms(key, 2 + bounce, 1))
        z = 2.0 * u0 - 1.0
        rho = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = 2 * math.pi * u1
        vec = torch.stack([rho * torch.cos(phi), rho * torch.sin(phi), z], -1)
        new_d, alive = _scatter(_unit(d), nrm, scene.mtype[mat],
                                scene.fuzz[mat], scene.ior[mat], vec, pick)
        atten = atten * scene.albedo[mat]
        o, d, atten, ray = p[alive], new_d[alive], atten[alive], ray[alive]
        key = (key[0][alive], key[1][alive])
    return radiance.reshape(-1, spp, 3).sum(1) / spp


def trace_blocks(scene: Scene, cam: dict, pixel_ids, spp: int, base, *,
                 rays_per_block: int = 1 << 18, **kw) -> torch.Tensor:
    """``trace`` over blocks of pixels, so that any count fits."""
    pixel_ids = torch.as_tensor(pixel_ids)
    per = max(1, rays_per_block // spp)
    return torch.cat([trace(scene, cam, pixel_ids[i:i + per], spp, base,
                            **kw)
                      for i in range(0, pixel_ids.numel(), per)])
