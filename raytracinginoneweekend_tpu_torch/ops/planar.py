"""Planar (R, 128) primitives of the wavefront engine, in plain PyTorch.

The port's copy of ``raytracinginoneweekend_tpu/ops/planar.py``. Every
per-ray quantity is its own (R, 128) f32/i32 plane -- the JAX package's
lane-state layout, kept so that tests compare plane by plane (and, on the
card, so that neighbouring threads touch neighbouring addresses).

Two layers live here:
  * planar draws over the raw-counter contract of ops/rng.py: threefry
    blocks run directly on key-word planes (int32 bit patterns, see
    ops/threefry.py);
  * planar camera-ray generation for all four camera modes (quirks
    Q1/Q2/Q11 included) and the per-bounce material/sky shading.

ONE COPY. In the JAX package the fused kernel keeps literal in-kernel
copies of ``bounce_draws`` and ``bounce_planar``
(``pallas_mega.kernel_bounce_draws`` / ``kernel_shade``). Here the plain
PyTorch version of the fused kernel (ops/cuda_fused.shade_regen_reference)
calls these functions directly, and the CUDA kernel's copy is
csrc/rtw_common.cuh -- written to the same operation order.

Operation order matters: float32 products and sums are written in the JAX
source's order, integer powers as explicit products (x*x, x*(x2*x2)), and
max/min propagate NaN (ops/rng.nan_max).
"""

from __future__ import annotations

import torch

from ..models.camera import Camera
from ..models.scene import DIELECTRIC, METAL
from . import rng
from . import threefry as tf
from .math3 import FLT_MIN, sqrt_rn

LANES = 128

SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, rng._f32(0.7), 1.0)  # main.cxx:49; cuda_impl.cu:125


def ray_key_words(base_words, pid, sid):
    """The ray-key chain on planes: fold base by pid, then sid.

    base_words: the ``(k0, k1)`` base-key words (Python ints). Returns two
    u32-in-int64 planes (ops/threefry.py).
    """
    b0, b1 = base_words
    k0, k1 = tf.fold_in_words(b0, b1, pid)
    return tf.fold_in_words(k0, k1, sid)


def bounce_draws(k0, k1, bounce, unit_sample: bool):
    """(vec planes, rr plane) from key-word planes at bounce ``bounce``
    (an i32 plane: the wavefront engine's per-lane depth)."""
    tag = rng.TAG_BOUNCE + tf.u32(bounce)
    u0, u1 = tf.draw_uniform2(k0, k1, tag, 0)
    u2, u3 = tf.draw_uniform2(k0, k1, tag, 1)
    x, y, z = rng.unit_from_uv(u0, u1)
    if not unit_sample:
        r = torch.pow(u2, rng.THIRD)
        x, y, z = x * r, y * r, z * r
    return x, y, z, u3


def strat0_scatter_planes(k0, k1, pid, sid, base_words, spp: int,
                          unit_sample: bool):
    """Stratified FIRST-BOUNCE scatter vector replacement planes.

    The bounce-0 (u0, u1) pair is remapped through the rotated-stratified
    / van-der-Corput scheme (rng.stratify_lens_uv) with per-PIXEL
    rotations drawn at the unconsumed ((pid, 0), TAG_BOUNCE + 0, j=3)
    counter, then mapped through the same polar map (and ball radius u2,
    which stays iid) as the ordinary draw. Marginals stay U[0,1)
    (Cranley-Patterson) -> unbiased.

    k0, k1: CURRENT per-ray key-word planes; pid/sid: the rays' (pixel,
    sample) planes; base_words: the base-key words. Callers substitute
    the result for the scatter vector on depth==0 lanes only.
    """
    b0, b1 = base_words
    pk0, pk1 = tf.fold_in_words(b0, b1, pid)
    zk0, zk1 = tf.fold_in_words(pk0, pk1, 0)
    ru_, rv_ = tf.draw_uniform2(zk0, zk1, rng.TAG_BOUNCE, 3)
    u0, _ = tf.draw_uniform2(k0, k1, rng.TAG_BOUNCE, 0)
    su, sv = rng.stratify_lens_uv(u0, ru_, rv_, sid, spp)
    x, y, z = rng.unit_from_uv(su, sv)
    if not unit_sample:
        u2, _ = tf.draw_uniform2(k0, k1, rng.TAG_BOUNCE, 1)
        r = torch.pow(u2, rng.THIRD)
        x, y, z = x * r, y * r, z * r
    return x, y, z


def normalize3(x, y, z):
    """Planar math3.normalize (FLT_MIN guard, math.hxx:226-233)."""
    l = sqrt_rn(x * x + y * y + z * z)
    good = l > FLT_MIN
    inv = 1.0 / torch.where(good, l, torch.ones_like(l))
    return (torch.where(good, x * inv, x), torch.where(good, y * inv, y),
            torch.where(good, z * inv, z))


def bounce_planar(seg, dirs, k0, k1, depth, *, unit_sample: bool,
                  phys_refract: bool, sky_bias: float, strat0=None):
    """One bounce of material scatter + sky, on planar ray state.

    Semantics per material mirror the reference exactly: lambert
    cuda_impl.cu:204-213, metal :216-229 (absorb -> valid False),
    dielectric :232-262 (Schlick + TIR), sky mix main.cxx:47-50 /
    cuda_impl.cu:123-126 (unclamped).

    seg: dict with the planes nx ny nz (normal), mt (i32 material type),
    fz, io; dirs: (dx, dy, dz) planes; k0, k1: per-ray key-word planes;
    depth: i32 plane. Returns (ndx, ndy, ndz, valid, sky_r, sky_g, sky_b):
    the scattered direction, whether the scatter survives (metal absorb
    kills), and the UNATTENUATED sky radiance for miss lanes.

    strat0: optional (svx, svy, svz) replacement planes
    (strat0_scatter_planes) substituted on depth==0 lanes.
    """
    dx, dy, dz = dirs
    nx, ny, nz = seg["nx"], seg["ny"], seg["nz"]
    mt = seg["mt"]
    fz, io = seg["fz"], seg["io"]

    rvx, rvy, rvz, ru = bounce_draws(k0, k1, depth, unit_sample)
    if strat0 is not None:
        m0 = depth == 0
        svx, svy, svz = strat0
        rvx = torch.where(m0, svx, rvx)
        rvy = torch.where(m0, svy, rvy)
        rvz = torch.where(m0, svz, rvz)

    ux, uy, uz = normalize3(dx, dy, dz)

    # lambert (cuda_impl.cu:204-213)
    ldx, ldy, ldz = nx + rvx, ny + rvy, nz + rvz
    # metal (cuda_impl.cu:216-229)
    du = ux * nx + uy * ny + uz * nz
    rfx = ux - 2.0 * du * nx
    rfy = uy - 2.0 * du * ny
    rfz = uz - 2.0 * du * nz
    mdx, mdy, mdz = rfx + rvx * fz, rfy + rvy * fz, rfz + rvz * fz
    metal_ok = (mdx * nx + mdy * ny + mdz * nz) > 0.0
    # dielectric (cuda_impl.cu:232-262)
    cos = du  # dot(unit_dir, normal)
    entering = cos <= 0.0
    one = torch.ones_like(cos)
    sgn = torch.where(entering, one, -one)
    owx, owy, owz = nx * sgn, ny * sgn, nz * sgn
    ri = torch.where(entering, 1.0 / io, io)
    cosab = torch.abs(cos)
    cos_i = owx * ux + owy * uy + owz * uz  # dot(outward, unit_dir)
    kk = 1.0 - ri * ri * (1.0 - cos_i * cos_i)
    tir = kk < 0.0
    sq = sqrt_rn(rng.nan_max(kk, 0.0))
    if phys_refract:
        tx = ri * ux - (ri * cos_i + sq) * owx
        ty = ri * uy - (ri * cos_i + sq) * owy
        tz = ri * uz - (ri * cos_i + sq) * owz
    else:
        # math.hxx:304-308: dot*eta broadcast-added per component.
        tx = ux * ri - (owx * sq + cos_i * ri)
        ty = uy * ri - (owy * sq + cos_i * ri)
        tz = uz * ri - (owz * sq + cos_i * ri)
    zero = torch.zeros_like(tx)
    tx = torch.where(tir, zero, tx)
    ty = torch.where(tir, zero, ty)
    tz = torch.where(tir, zero, tz)
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    c1 = 1.0 - cosab
    c2 = c1 * c1
    schlick = r0 + (1.0 - r0) * (c1 * (c2 * c2))
    prob = torch.where(tir, one, schlick)
    refl = ru < prob
    gdx = torch.where(refl, rfx, tx)
    gdy = torch.where(refl, rfy, ty)
    gdz = torch.where(refl, rfz, tz)

    is_metal = mt == METAL
    is_diel = mt == DIELECTRIC
    ndx = torch.where(is_diel, gdx, torch.where(is_metal, mdx, ldx))
    ndy = torch.where(is_diel, gdy, torch.where(is_metal, mdy, ldy))
    ndz = torch.where(is_diel, gdz, torch.where(is_metal, mdz, ldz))
    valid = metal_ok | ~is_metal

    # sky (cuda_impl.cu:123-126 / main.cxx:47-50), unclamped mix.
    tsky = 0.5 * uy + sky_bias
    sky_r = SKY_WHITE[0] * (1.0 - tsky) + SKY_BLUE[0] * tsky
    sky_g = SKY_WHITE[1] * (1.0 - tsky) + SKY_BLUE[1] * tsky
    sky_b = SKY_WHITE[2] * (1.0 - tsky) + SKY_BLUE[2] * tsky
    return ndx, ndy, ndz, valid, sky_r, sky_g, sky_b


def camera_rays(cam: Camera, pid, sid, base_words, width: int, height: int,
                camera_mode: str, sampling: str = "iid", spp: int = 0):
    """Planar camera-ray generation for (pixel, sample) planes.

    pid, sid: (R, 128) i32 planes. Returns (ox, oy, oz, dx, dy, dz, k0,
    k1) with k0/k1 the per-ray KEY-WORD planes as int32 bit patterns.
    sampling="stratified" remaps the jitter per rng.stratify_uv and, in
    thinlens mode, the lens pair per rng.stratify_lens_uv.

    Modes: "cuda" (no defocus + quirk Q11 direction), "pinhole", "cpu"
    (quirks Q2+Q11), "thinlens". pid may be -1 on lanes without a task:
    the integer divisions below FLOOR (as the JAX package's do), so such
    lanes get defined -- and masked -- values.
    """
    origin = cam.origin
    ll, hor, ver = cam.lower_left, cam.horizontal, cam.vertical
    bu, bv = cam.basis_u, cam.basis_v
    lens_r = cam.lens_radius

    k0, k1 = ray_key_words(base_words, pid, sid)
    jux, juy = tf.draw_uniform2(k0, k1, rng.TAG_JITTER, 0)
    if sampling == "stratified":
        # Per-PIXEL rotation from the (pid, sid=0) key (rng.stratify_uv).
        k0z, k1z = ray_key_words(base_words, pid, 0)
        _, rot_v = tf.draw_uniform2(k0z, k1z, rng.TAG_JITTER, 0)
        jux, juy = rng.stratify_uv(jux, rot_v, sid, spp)
    y = torch.div(pid, width, rounding_mode="floor")
    x = pid - y * width
    u = (x.to(torch.float32) + jux) / float(width)
    v = (y.to(torch.float32) + juy) / float(height)

    def film(k):
        return ll[k] + hor[k] * u + ver[k] * (1.0 - v)

    def plane(s):
        return s.expand(u.shape)

    fx, fy, fz_ = film(0), film(1), film(2)
    if camera_mode == "cuda":
        ox, oy, oz = plane(origin[0]), plane(origin[1]), plane(origin[2])
        dx, dy, dz = fx, fy, fz_  # quirk Q11: no -origin
    elif camera_mode == "pinhole":
        ox, oy, oz = plane(origin[0]), plane(origin[1]), plane(origin[2])
        dx, dy, dz = fx - origin[0], fy - origin[1], fz_ - origin[2]
    elif camera_mode == "cpu":
        # camera.hxx:51-56 (quirks Q2 + Q11): unit-SPHERE lens sample,
        # world-axis offset scaled by screen (u, v).
        lu0, lu1 = tf.draw_uniform2(k0, k1, rng.TAG_LENS, 0)
        lu2, _ = tf.draw_uniform2(k0, k1, rng.TAG_LENS, 1)
        sx, sy, _sz = rng.unit_from_uv(lu0, lu1)
        sr = torch.pow(lu2, rng.THIRD)
        rdx, rdy = sx * sr, sy * sr
        offx = u * rdx * lens_r
        offy = v * rdy * lens_r
        ox, oy = origin[0] + offx, origin[1] + offy
        oz = plane(origin[2])
        dx, dy, dz = fx - offx, fy - offy, fz_
    elif camera_mode == "thinlens":
        lu0, lu1 = tf.draw_uniform2(k0, k1, rng.TAG_LENS, 0)
        if sampling == "stratified":
            # Per-PIXEL lens rotations from the unconsumed (pid, sid=0)
            # (TAG_LENS, j=2) counter -- see rng.stratify_lens_uv.
            lr_u, lr_v = tf.draw_uniform2(k0z, k1z, rng.TAG_LENS, 2)
            lu0, lu1 = rng.stratify_lens_uv(lu0, lr_u, lr_v, sid, spp)
        r0, r1 = rng.disk_from_uv(lu0, lu1)
        r0, r1 = r0 * lens_r, r1 * lens_r
        offx = bu[0] * r0 + bv[0] * r1
        offy = bu[1] * r0 + bv[1] * r1
        offz = bu[2] * r0 + bv[2] * r1
        ox = origin[0] + offx
        oy = origin[1] + offy
        oz = origin[2] + offz
        dx = fx - origin[0] - offx
        dy = fy - origin[1] - offy
        dz = fz_ - origin[2] - offz
    else:
        raise ValueError(f"unknown camera mode: {camera_mode!r}")
    return ox, oy, oz, dx, dy, dz, tf.as_i32(k0), tf.as_i32(k1)
