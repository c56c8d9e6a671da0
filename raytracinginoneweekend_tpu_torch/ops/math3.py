"""Vector math on trailing-axis-3 tensors.

The port's copy of ``raytracinginoneweekend_tpu/ops/math3.py``: pure
functions over tensors of shape ``(..., 3)``.

Reference citations: dot/cross/length/normalize math.hxx:246-292,
reflect math.hxx:295-298, refract math.hxx:300-309, pow/mix
math.hxx:311-335, radians math.hxx:7-21, the normalize() guard
math.hxx:221-229.

Quirks handled here, as in the JAX package:
  - Q7: the reference ``refract`` multiplies by ``(k >= 0)`` but
    ``sqrt(k<0)`` is NaN and ``NaN*0 == NaN``; here TIR is an explicit mask
    (``refract`` returns the refracted direction *and* a TIR flag).
  - QR: the reference computes ``I*eta - (N*sqrt(k) + dot*eta)`` with the
    scalar ``dot*eta`` broadcast-added per component. Both forms exist:
    ``refract`` (standard) and ``refract_reference`` (bug-compatible).

Everything is safe under reverse-mode autograd: a ``sqrt`` or a division
whose result is masked out sees a harmless argument (``where`` BEFORE the
operation), so no ``0 * inf`` reaches a gradient. Integer powers are
explicit products, the order XLA expands them in.
"""

from __future__ import annotations

import torch

# Smallest positive normal float32, the guard used by the reference's
# normalize() (math.hxx:226: `if (std::abs(length) > FLT_MIN)`).
FLT_MIN = 1.17549435e-38

_DEG2RAD = 0.01745329251994329576923690768489  # math.hxx:12


def radians(degrees: torch.Tensor) -> torch.Tensor:
    return degrees * torch.tensor(_DEG2RAD, dtype=torch.float32,
                                  device=degrees.device)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3-dot product -> (...,) (math.hxx:275-279)."""
    return torch.sum(a * b, dim=-1)


def norm2(v: torch.Tensor) -> torch.Tensor:
    """Squared length (math.hxx:216-219 `norm`)."""
    return dot(v, v)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Square root rounded to the nearest float32, as the CUDA kernels'
    ``sqrtf`` and XLA's are. torch.sqrt of a float32 tensor on the CPU is
    not: 19 of 3000 random inputs come out an ulp off, and under load the
    first call in a process has rounded otherwise than the later calls on
    the same inputs. The float64 root rounds to the nearest float32
    exactly (53 >= 2 * 24 + 2 bits). Other dtypes and devices take
    torch.sqrt. Every plain version's float32 square root goes through it,
    so the CPU comparisons with the JAX package see XLA's roots."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def fma_rn(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32, as a fused multiply-add is (XLA
    contracts a multiply feeding an add into one): the exact product of two
    float32 values plus c in float64, then float32. That differs from the
    fused result only where the float64 sum rounds to a float32 tie, about
    once in 2**29. a, b, c: float32 tensors or Python floats that are
    float32 values."""
    a = a.double() if isinstance(a, torch.Tensor) else a
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a * b + c).float()


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Safe normalize matching the reference's FLT_MIN guard
    (math.hxx:226-233): divides only when |len| > FLT_MIN, otherwise
    returns the vector unchanged (the zero vector stays zero). The guard
    is applied UNDER the sqrt too: its backward is inf at exactly 0."""
    l2 = norm2(v)[..., None]
    good = l2 > FLT_MIN * FLT_MIN
    l = sqrt_rn(torch.where(good, l2, torch.ones_like(l2)))
    return torch.where(good, v / l, v)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3D cross product (math.hxx:281-292)."""
    return torch.linalg.cross(a, b, dim=-1)


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection: I - 2*N*dot(N, I) (math.hxx:295-298)."""
    return i - 2.0 * dot(n, i)[..., None] * n


def _refract_terms(i, n, eta):
    eta = eta[..., None]
    cos_i = dot(n, i)[..., None]
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k[..., 0] < 0.0
    # Double-where: sqrt's backward is inf at k == 0 (the grazing/TIR
    # boundary) and would NaN the masked branch in reverse mode.
    pos = k > 0.0
    sq = torch.where(pos, sqrt_rn(torch.where(pos, k, torch.ones_like(k))),
                     torch.zeros_like(k))
    return eta, cos_i, sq, tir


def refract(i: torch.Tensor, n: torch.Tensor, eta: torch.Tensor):
    """Standard Snell refraction with explicit TIR handling.

    i: incident unit direction (..., 3); n: outward surface normal
    (..., 3); eta: relative index ratio n_incident / n_transmit, (...,).
    Returns (refracted, tir): the refracted direction (zero vector where
    TIR) and a boolean TIR mask; no NaNs on total internal reflection.
    """
    eta, cos_i, sq, tir = _refract_terms(i, n, eta)
    refracted = eta * i - (eta * cos_i + sq) * n
    return torch.where(tir[..., None], torch.zeros_like(refracted),
                       refracted), tir


def refract_reference(i: torch.Tensor, n: torch.Tensor, eta: torch.Tensor):
    """Bug-compatible reference refraction (math.hxx:300-309):
    ``(I*eta - (N*sqrt(k) + dot*eta))`` with ``dot*eta`` a scalar
    broadcast-added per component. TIR is an explicit mask instead of the
    reference's accidental NaN vector (its caller treats both alike)."""
    eta, cos_i, sq, tir = _refract_terms(i, n, eta)
    refracted = i * eta - (n * sq + cos_i * eta)
    return torch.where(tir[..., None], torch.zeros_like(refracted),
                       refracted), tir


def schlick(refraction_index: torch.Tensor,
            cosine_theta: torch.Tensor) -> torch.Tensor:
    """Schlick Fresnel reflection probability: R0 + (1-R0)*(1-cos)^5 with
    R0 = ((1-n)/(1+n))^2 (raytracer.hxx:45-50; cuda_impl.cu:116-121)."""
    q = (1.0 - refraction_index) / (1.0 + refraction_index)
    r0 = q * q
    c1 = 1.0 - cosine_theta
    c2 = c1 * c1
    return r0 + (1.0 - r0) * (c1 * (c2 * c2))


def mix(x: torch.Tensor, y: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Linear blend x*(1-a) + y*a, *unclamped* (math.hxx:325-335)."""
    if a.dim() < x.dim():
        a = a[..., None]
    return x * (1.0 - a) + y * a
