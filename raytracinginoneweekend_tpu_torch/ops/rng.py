"""Counter-based RNG discipline shared by every engine of the renderer.

The port's copy of ``raytracinginoneweekend_tpu/ops/rng.py``. Every
random draw is a pure function of ``(base_key, pixel_id, sample_id, tag,
word)``, which gives determinism at a fixed key and invariance to pool
size and device.

Two faces over the same threefry blocks: the planar engines draw on
(R, 128) key-word planes (ops/planar.py); the tiled engine uses the
KEY-ARRAY API at the end of this module (``ray_key``, ``jitter_uv``,
``lens_disk``, ``lens_sphere``, ``bounce_draws``, ``strat0_scatter``).
Where the JAX package ``vmap``s scalar functions over a key array, these
are written batched: a ray key is the pair ``(k0, k1)`` of ``(N,)``
key-word tensors, and the words are the planar half's bit for bit.

Draw-order contract v3 (identical in both packages):
  ray_key  = fold_in(fold_in(base, pixel_id), sample_id)
  draw site (tag, j): BOTH uint32 words of threefry2x32(ray_key, (tag, j))
    jitter   : tag TAG_JITTER, j=0            -> (u, v) pixel jitter
    lens     : tag TAG_LENS,   j=0 (+ j=1 for the cpu-mode 3rd uniform)
    bounce b : tag TAG_BOUNCE+b, j=0 -> scatter u0,u1; j=1 -> u2, rr
               (j=2 word0 -> the Russian-roulette termination uniform,
               drawn ONLY when TraceOptions.rr_terminate)
  per-PIXEL sites (key = fold_in(fold_in(base, pixel_id), 0), consumed
  ONLY under sampling="stratified"; no per-sample draw touches them):
    jitter rotation : tag TAG_JITTER, j=0 word1 (stratify_uv rot_v)
    lens rotations  : tag TAG_LENS, j=2 -> (rot_u, rot_v)
    bounce-0 rotations : tag TAG_BOUNCE+0, j=3 -> (rot_u, rot_v)

Arithmetic notes that keep the plain versions, the CUDA kernels
(csrc/rtw_common.cuh) and the JAX package in step: constants that are not
exact in float32 are rounded to float32 once (``_f32``), ``u ** (1/3)`` is
a float32 ``pow`` with the float32 exponent (never ``cbrt``), and every
``x / n`` is a true division.
"""

from __future__ import annotations

import numpy as np
import torch

from . import threefry as tf
from .math3 import sqrt_rn

TAG_JITTER = 0
TAG_LENS = 1
TAG_BOUNCE = 2  # bounce b uses tag TAG_BOUNCE + b


def _f32(x: float) -> float:
    """Round a Python float to float32 (returned as an exact double)."""
    return float(np.float32(x))


TWO_PI = _f32(6.283185307179586)
THIRD = _f32(1.0 / 3.0)


def nan_max(a: torch.Tensor, b) -> torch.Tensor:
    """NaN-propagating max (``jnp.maximum``); b may be a Python float."""
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return torch.maximum(a, b)


def nan_min(a: torch.Tensor, b) -> torch.Tensor:
    """NaN-propagating min (``jnp.minimum``); b may be a Python float."""
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return torch.minimum(a, b)


def rr_terminate_update(k0, k1, depth, ax, ay, az, keep, *, rr_start: int,
                        rr_qmin: float, rr_scale: float,
                        rr_qcap: float = 1.0, stop_grad: bool = True):
    """Shared Russian-roulette path-termination update -> (ax, ay, az, keep).

    THE one definition of the rr_terminate contract (TraceOptions.rr_*):
    draw word 0 of (TAG_BOUNCE + depth, j=2) under the ray key;
    continuations with >= rr_start completed bounces survive with
    q = clip(rr_scale * max-channel(attenuation), rr_qmin, 1); survivors
    boost attenuation by 1/q, casualties die like absorb.

    k0/k1: per-ray key-word planes; depth: completed-bounce count (an
    i32 plane, or a Python int for the fixed-depth AD engines); keep: the
    continuation mask BEFORE rr.
    rr_qcap: survival ceiling (< 1 forces geometric drain even on bright
    paths; probe traces only -- the engines keep 1.0).
    stop_grad: hold q constant under autograd, so the weighted estimator's
    gradient is RR applied to the gradient integrand; a differentiable q
    would add spurious d(1/q)/dtheta terms. Values are the same either way.
    """
    tag = TAG_BOUNCE + tf.u32(depth)
    u_rr, _ = tf.draw_uniform2(k0, k1, tag, 2)
    q = nan_min(nan_max(_f32(rr_scale) * nan_max(ax, nan_max(ay, az)),
                        _f32(rr_qmin)), _f32(rr_qcap))
    if stop_grad:
        q = q.detach()
    consider = keep & (depth + 1 >= rr_start)
    surv = consider & (u_rr < q)
    boost = torch.where(surv, 1.0 / q, torch.ones_like(q))
    return (ax * boost, ay * boost, az * boost,
            keep & (~consider | surv))


def bitrev32(x):
    """Bit-reversed uint32 (u32 in an int64 carrier): the base-2 radical
    inverse scaled by 2^32. A shift/mask ladder."""
    x = tf.u32(x)
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & tf.MASK32


def _check_spp(spp: int) -> None:
    if spp <= 0:
        # A stratified call that forgot to thread spp through would
        # silently produce NaN u.
        raise ValueError("sampling='stratified' requires spp > 0 "
                         f"(got spp={spp})")


def _vdc(sid: torch.Tensor) -> torch.Tensor:
    """Base-2 van der Corput radical inverse of sid, top 24 bits (exact
    in float32)."""
    return (bitrev32(sid) >> 8).to(torch.float32) * (1.0 / 16777216.0)


def stratify_uv(ju, rot_v, sid, spp: int):
    """Remap an iid sub-pixel jitter pair to a STRATIFIED one (opt-in
    TraceOptions.sampling="stratified").

    u: exactly stratified -- sample sid jitters (with its own iid draw
    ju) within stratum [sid/spp, (sid+1)/spp).
    v: base-2 van der Corput radical inverse of sid plus a PER-PIXEL
    Cranley-Patterson rotation rot_v, shared by every sample of the pixel
    (callers pass the pixel's sid=0 jitter word). The marginal stays
    U[0,1) (unbiased); sample 0's v equals its iid value (vdc(0) = 0).
    """
    _check_spp(spp)
    u = (sid.to(torch.float32) + ju) / float(spp)
    v = _vdc(sid) + rot_v
    return u, v - torch.floor(v)


def stratify_lens_uv(lu0, rot_u, rot_v, sid, spp: int):
    """Remap the iid thin-lens disk pair to a rotated stratified pair
    (the lens half of TraceOptions.sampling="stratified"; thinlens mode
    only -- the "cpu" quirk lens stays iid).

    theta-dim u: sample sid's stratum with its own iid jitter lu0, then a
    per-pixel TOROIDAL rotation rot_u (decorrelates the lens theta from
    the equally-sid-stratified pixel jitter u). r-dim v: van der Corput of
    sid under rot_v, exactly as stratify_uv's v. BOTH rotations are
    per-PIXEL and come from counter words no sample consumes itself
    ((pixel, sid=0) / (TAG_LENS, j=2)).
    """
    _check_spp(spp)
    u = (sid.to(torch.float32) + lu0) / float(spp) + rot_u
    v = _vdc(sid) + rot_v
    return u - torch.floor(u), v - torch.floor(v)


def unit_from_uv(u0, u1):
    """Uniform unit direction from two uniforms (polar/Archimedes map):
    z uniform on [-1, 1), azimuth uniform. Returns (x, y, z)."""
    z = 2.0 * u0 - 1.0
    rho = sqrt_rn(nan_max(1.0 - z * z, 0.0))
    phi = TWO_PI * u1
    return rho * torch.cos(phi), rho * torch.sin(phi), z


def disk_from_uv(u0, u1):
    """Uniform point in the unit disk from two uniforms (componentwise)."""
    theta = TWO_PI * u0
    r = sqrt_rn(u1)
    return torch.cos(theta) * r, torch.sin(theta) * r


# ---------------------------------------------------------------------------
# Key-array API (the tiled engine): a ray key is (k0, k1), two (N,) tensors
# ---------------------------------------------------------------------------

def ray_key(base_words, pixel_id, sample_id):
    """Per-(pixel, sample) key words: fold the base key by pixel id, then
    by sample id. base_words: the ``(k0, k1)`` base-key words (Python
    ints); pixel_id/sample_id: integer tensors (or ints)."""
    k0, k1 = tf.fold_in_words(*base_words, pixel_id)
    return tf.fold_in_words(k0, k1, sample_id)


def jitter_uv(rkey):
    """Sub-pixel jitter in [0,1)^2 -> (ju, jv)
    (main.cxx:199-200; cuda_impl.cu:370-371)."""
    return tf.draw_uniform2(*rkey, TAG_JITTER, 0)


def lens_disk(rkey):
    """Thin-lens defocus sample: uniform point in the unit disk, (N, 2)."""
    u0, u1 = tf.draw_uniform2(*rkey, TAG_LENS, 0)
    return torch.stack(disk_from_uv(u0, u1), dim=-1)


def lens_sphere(rkey):
    """CPU-mode (quirk Q2) defocus sample: uniform point in the unit
    ball, (N, 3): a uniform unit direction scaled by U^(1/3) -- the
    reference's rejection sampler (raytracer.hxx:32-43) without the loop.
    """
    u0, u1 = tf.draw_uniform2(*rkey, TAG_LENS, 0)
    u2, _ = tf.draw_uniform2(*rkey, TAG_LENS, 1)
    vec = torch.stack(unit_from_uv(u0, u1), dim=-1)
    return vec * torch.pow(u2, THIRD)[..., None]


def bounce_draws(rkey, bounce, sample: str):
    """All per-bounce randomness: (scatter vec (N, 3), rr uniform (N,)).

    sample: "unit" (normalized direction, CUDA semantics) or "ball"
    (unnormalized point in the unit sphere, CPU semantics). Both cost two
    threefry blocks; the ball variant spends u2 on the radius.
    """
    tag = TAG_BOUNCE + tf.u32(bounce)
    u0, u1 = tf.draw_uniform2(*rkey, tag, 0)
    u2, u3 = tf.draw_uniform2(*rkey, tag, 1)
    vec = torch.stack(unit_from_uv(u0, u1), dim=-1)
    if sample != "unit":
        vec = vec * torch.pow(u2, THIRD)[..., None]
    return vec, u3


def strat0_scatter(rkey, pid, sid, base_words, spp: int, sample: str):
    """Stratified FIRST-BOUNCE scatter vector, key-array form -> (N, 3).

    The tiled engine's counterpart of planar.strat0_scatter_planes (the
    same fold chain, stratify_lens_uv and polar map, so the same values):
    the bounce-0 (u0, u1) pair remapped through the rotated stratified /
    van-der-Corput scheme with per-pixel rotations at the unconsumed
    ((pid, 0), TAG_BOUNCE + 0, j=3) counter; ball radius u2 stays iid.
    """
    zkey = ray_key(base_words, pid, 0)
    ru_, rv_ = tf.draw_uniform2(*zkey, TAG_BOUNCE, 3)
    u0, _ = tf.draw_uniform2(*rkey, TAG_BOUNCE, 0)
    su, sv = stratify_lens_uv(u0, ru_, rv_, sid, spp)
    vec = torch.stack(unit_from_uv(su, sv), dim=-1)
    if sample != "unit":
        u2, _ = tf.draw_uniform2(*rkey, TAG_BOUNCE, 1)
        vec = vec * torch.pow(u2, THIRD)[..., None]
    return vec
