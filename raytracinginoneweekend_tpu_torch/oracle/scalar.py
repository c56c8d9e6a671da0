"""Scalar NumPy oracle: the unit-test ground truth for the port's engines.

The port's copy of ``raytracinginoneweekend_tpu/oracle/scalar.py``. The
reference's de-facto correctness oracle was "the CPU and CUDA
implementations of the same math should agree" (SURVEY section 4). This
module formalizes that: a straight-line, per-ray NumPy tracer written in
the *reference's* control-flow style -- sequential sphere loop with a
shrinking t_max (cuda_impl.cu:172-192), per-material if/else branches
(raytracer.hxx:120-199), early returns from the bounce loop
(main.cxx:52-75) -- with zero vectorization, masking, or torch control
flow.

Randomness: all draws are precomputed on the CPU with the port's
ops/rng.py and ops/threefry.py under the exact (pixel, sample, bounce,
tag) key discipline, as batched tensors over every (pixel, sample) pair,
then indexed scalar-wise. The engines and this oracle therefore see the
SAME sample sequence, so tests assert near-bitwise agreement --
validating the engines' masking and selection logic itself, not just
statistics. It imports neither JAX nor the JAX package, so it also runs
beside the card (``chip_smoke.py`` holds a frame rendered there to it).

Slow by design; use on tiny images (tests use <= 24x16 @ 2-4 spp).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import TraceOptions
from ..models.scene import DIELECTRIC, LAMBERT, METAL, Scene
from ..ops import rng
from ..ops import threefry as tf

FLT_MIN = np.float32(1.17549435e-38)


def _normalize(v):
    l = np.sqrt(float(np.dot(v, v)))
    return v / l if abs(l) > FLT_MIN else v


def _reflect(i, n):
    return i - 2.0 * np.dot(n, i) * n


def _refract(i, n, eta, mode):
    cos_i = float(np.dot(n, i))
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    if k < 0.0:
        return None  # TIR
    if mode == "physical":
        return eta * i - (eta * cos_i + np.sqrt(k)) * n
    # "reference": math.hxx:304-308 -- dot*eta broadcast-added per component.
    return i * eta - (n * np.sqrt(k) + cos_i * eta)


def _schlick(ri, cos):
    r0 = ((1.0 - ri) / (1.0 + ri)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cos) ** 5


def _intersect(o, d, center, radius, t_min, t_max):
    """raytracer.hxx:52-92: near root, then far root, window (t_min, t_max)."""
    oc = o - center
    a = float(np.dot(d, d))
    b = float(np.dot(oc, d))
    c = float(np.dot(oc, oc)) - radius * radius
    disc = b * b - a * c
    if disc > 0.0:
        sq = np.sqrt(b * b - a * c)
        for t in ((-b - sq) / a, (-b + sq) / a):
            if t_min < t < t_max:
                return t
    return None


def _hit_world(scene_np, o, d, t_min):
    """cuda_impl.cu:172-192: sequential scan, shrinking t_max."""
    centers, radii, _ = scene_np
    min_t = np.inf
    best = None
    for s in range(centers.shape[0]):
        t = _intersect(o, d, centers[s], radii[s], t_min, min_t)
        if t is not None:
            min_t = t
            best = s
    return (best, min_t) if best is not None else None


def _precompute_draws(base_key, pixel_ids, spp, depth, camera_mode, options):
    """All randomness for (P, S) rays, drawn with the ops/rng.py contract
    on the CPU -> NumPy (jitter (P, S, 2), lens (P, S, 3), scatter vectors
    (P, S, depth, 3), the dielectric uniforms (P, S, depth), the
    termination uniforms (P, S, depth)).

    sampling="stratified" applies the SAME three remaps as the engines
    (jitter stratify_uv, thin-lens stratify_lens_uv, bounce-0
    strat0_scatter -- shared rng functions, so the sequences stay
    bit-identical); rr_terminate reads the termination uniform (tag
    TAG_BOUNCE+b, j=2 word0). Every (pixel, sample) pair is one element of
    a flat batch, the JAX oracle's vmap over pixels and samples."""
    p_n = len(pixel_ids)
    pid = torch.as_tensor(np.asarray(pixel_ids, np.int64)).repeat_interleave(
        spp)
    sid = torch.arange(spp, dtype=torch.int64).repeat(p_n)
    stratified = options.sampling == "stratified"
    rkey = rng.ray_key(base_key, pid, sid)
    ju, jv = rng.jitter_uv(rkey)
    zkey = rng.ray_key(base_key, pid, 0) if stratified else None
    if stratified:
        rot_v = rng.jitter_uv(zkey)[1]
        ju, jv = rng.stratify_uv(ju, rot_v, sid, spp)
    if camera_mode == "thinlens":
        if stratified:
            lr_u, lr_v = tf.draw_uniform2(*zkey, rng.TAG_LENS, 2)
            lu0, _ = tf.draw_uniform2(*rkey, rng.TAG_LENS, 0)
            su, sv = rng.stratify_lens_uv(lu0, lr_u, lr_v, sid, spp)
            dx_, dy_ = rng.disk_from_uv(su, sv)
            lens = torch.stack([dx_, dy_, torch.zeros_like(dx_)], dim=-1)
        else:
            disk = rng.lens_disk(rkey)
            lens = torch.cat([disk, torch.zeros_like(disk[:, :1])], dim=-1)
    elif camera_mode == "cpu":
        lens = rng.lens_sphere(rkey)
    else:
        lens = torch.zeros((p_n * spp, 3))

    vecs, rrs, rrts = [], [], []
    for b in range(depth):
        vec, ru = rng.bounce_draws(rkey, b, options.scatter_sample)
        u_rr, _ = tf.draw_uniform2(*rkey, rng.TAG_BOUNCE + b, 2)
        vecs.append(vec)
        rrs.append(ru)
        rrts.append(u_rr)
    if stratified and depth:
        vecs[0] = rng.strat0_scatter(rkey, pid, sid, base_key, spp,
                                     options.scatter_sample)
    shape = (p_n, spp)
    jit_uv = torch.stack([ju, jv], dim=-1).reshape(*shape, 2)
    if depth:
        vecs = torch.stack(vecs, dim=1).reshape(*shape, depth, 3)
        rrs = torch.stack(rrs, dim=1).reshape(*shape, depth)
        rrts = torch.stack(rrts, dim=1).reshape(*shape, depth)
    else:
        vecs = torch.zeros((*shape, 0, 3))
        rrs = rrts = torch.zeros((*shape, 0))
    return (jit_uv.numpy(), lens.reshape(*shape, 3).numpy(), vecs.numpy(),
            rrs.numpy(), rrts.numpy())


def _camera_vectors(position, lookat, up, aspect, vfov, aperture, focus):
    """camera.hxx:24-44 in float32 numpy (bit-matching models/camera.py)."""
    position = np.asarray(position, np.float32)
    lookat = np.asarray(lookat, np.float32)
    up = np.asarray(up, np.float32)
    theta = np.float32(vfov) * np.float32(0.01745329251994329576923690768489) / np.float32(2)
    height = np.tan(theta, dtype=np.float32)
    width = np.float32(height * aspect)
    w = _normalize((position - lookat).astype(np.float32))
    u = _normalize(np.cross(up, w).astype(np.float32))
    v = _normalize(np.cross(w, u).astype(np.float32))
    lower_left = position - (u * width + v * height + w) * np.float32(focus)
    horizontal = u * width * np.float32(focus) * np.float32(2)
    vertical = v * height * np.float32(focus) * np.float32(2)
    return (position, lower_left.astype(np.float32),
            horizontal.astype(np.float32), vertical.astype(np.float32),
            u, v, np.float32(aperture) / np.float32(2))


def _np(x) -> np.ndarray:
    """A scene leaf (a tensor on any device, or an array) -> NumPy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def render_oracle(scene: Scene, cam_params: dict, width: int, height: int,
                  spp: int, max_depth: int, base_key,
                  camera_mode: str = "cuda",
                  options: TraceOptions = TraceOptions(),
                  pixel_ids=None) -> np.ndarray:
    """Render (H, W, 3) linear float, or a subset of pixel ids -> (P, 3).

    scene: the port's Scene (its leaves may lie on any device);
    cam_params: dict(position, lookat, up, vfov, aperture, focus), aspect
    width/height; base_key: the base-key words ``(k0, k1)``
    (``ops.threefry.key_words(seed)`` for ``jax.random.key(seed)``).
    """
    origin, lower_left, horizontal, vertical, bu, bv, lens_radius = (
        _camera_vectors(cam_params["position"], cam_params["lookat"],
                        cam_params["up"], float(width) / float(height),
                        cam_params["vfov"], cam_params["aperture"],
                        cam_params["focus"]))

    centers = _np(scene.centers).astype(np.float32)
    radii = _np(scene.radii).astype(np.float32)
    mat_idx = _np(scene.material_index)
    mtype = _np(scene.mtype)
    albedo = _np(scene.albedo).astype(np.float32)
    fuzz = _np(scene.fuzz).astype(np.float32)
    ior = _np(scene.ior).astype(np.float32)
    scene_np = (centers, radii, mat_idx)

    full_image = pixel_ids is None
    if full_image:
        pixel_ids = np.arange(width * height)
    pixel_ids = np.asarray(_np(pixel_ids))
    jit_uv, lens, vecs, rrs, rrts = _precompute_draws(
        base_key, pixel_ids, spp, max_depth, camera_mode, options)

    sky_white = np.array([1.0, 1.0, 1.0], np.float32)
    sky_blue = np.array([0.5, 0.7, 1.0], np.float32)
    sky_bias = 0.5 if options.sky == "cuda" else 1.0

    def sky(d):
        t = 0.5 * _normalize(d)[1] + sky_bias
        return sky_white * (1.0 - t) + sky_blue * t  # unclamped mix

    def trace_one(o, d, p, s):
        atten = np.ones(3, np.float32)
        for b in range(max_depth):
            h = _hit_world(scene_np, o, d, options.t_min)
            if h is None:
                return sky(d) * atten
            si, t = h
            pos = o + t * d
            nrm = (pos - centers[si]) / radii[si]
            mi = mat_idx[si]
            mt = int(mtype[mi])
            rand_vec = vecs[p, s, b]
            ru = float(rrs[p, s, b])
            unit_d = _normalize(d)
            if mt == LAMBERT:
                new_d = nrm + rand_vec
            elif mt == METAL:
                new_d = _reflect(unit_d, nrm) + rand_vec * fuzz[mi]
                if np.dot(new_d, nrm) <= 0.0:
                    return np.zeros(3, np.float32)  # absorbed
            else:
                assert mt == DIELECTRIC
                cos = float(np.dot(unit_d, nrm))
                if cos <= 0.0:  # entering
                    outward, ri, cosab = nrm, 1.0 / ior[mi], -cos
                else:  # exiting
                    outward, ri, cosab = -nrm, float(ior[mi]), cos
                refr = _refract(unit_d, outward, ri, options.refract)
                prob = 1.0 if refr is None else _schlick(ri, cosab)
                if ru < prob:
                    new_d = _reflect(unit_d, nrm)
                else:
                    new_d = refr
            atten = atten * albedo[mi]
            if options.rr_terminate and b + 1 >= options.rr_start:
                # Russian-roulette path termination (ops/rng.py
                # rr_terminate_update): survive with q = clip(rr_scale *
                # max-channel(attenuation), qmin, 1), boost survivors 1/q;
                # the uniform is the (tag TAG_BOUNCE+b, j=2) word0 of the
                # ray key.
                q = float(np.clip(options.rr_scale * atten.max(),
                                  options.rr_qmin, 1.0))
                if float(rrts[p, s, b]) >= q:
                    return np.zeros(3, np.float32)  # terminated
                atten = atten / np.float32(q)
            o, d = pos, new_d
        return np.zeros(3, np.float32)  # depth exhausted -> black

    out = np.zeros((len(pixel_ids), 3), np.float32)
    for p, pid in enumerate(pixel_ids):
        y, x = divmod(int(pid), width)
        acc = np.zeros(3, np.float32)
        for s in range(spp):
            u = (x + jit_uv[p, s, 0]) / width
            v = (y + jit_uv[p, s, 1]) / height
            film = lower_left + horizontal * u + vertical * (1.0 - v)
            if camera_mode == "cuda":
                o, d = origin, film  # quirk Q11: no -origin
            elif camera_mode == "cpu":
                rd = lens[p, s] * lens_radius
                off = np.array([u * rd[0], v * rd[1], 0.0], np.float32)
                o, d = origin + off, film - off  # Q2 + Q11
            elif camera_mode == "thinlens":
                rd = lens[p, s] * lens_radius
                off = bu * rd[0] + bv * rd[1]
                o, d = origin + off, film - origin - off
            else:  # pinhole
                o, d = origin, film - origin
            acc += trace_one(o.astype(np.float32), d.astype(np.float32), p, s)
        out[p] = acc / spp
    if full_image:
        return out.reshape(height, width, 3)
    return out
