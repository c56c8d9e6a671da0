"""Threefry-2x32 on integer tensors, bit for bit the JAX package's.

The renderer's RNG contract (ops/rng.py) is counter-based threefry2x32
keyed by (pixel, sample, tag, word). This module is the port's copy of
``raytracinginoneweekend_tpu/ops/threefry.py``: the same 20-round block,
the same ``fold_in`` and raw counter-mode draws, so every draw equals the
JAX package's bit for bit (tests/test_torch_threefry_rng.py).

HOW 32-BIT WORDS ARE CARRIED. PyTorch has no usable ``uint32`` arithmetic
on the CPU (add, shift and compare are not implemented for ``UInt32``), so
the plain versions here do the arithmetic in ``int64`` and mask every sum
and rotation with ``0xFFFFFFFF``:

  * inside this module and ops/rng.py a word is an ``int64`` tensor (or a
    Python int) holding a value in [0, 2**32) -- "u32 in an int64 carrier";
    ``u32()`` brings any integer tensor into that form (an ``int32`` is
    read as its two's-complement bit pattern, so -1 becomes 0xFFFFFFFF,
    as ``astype(uint32)`` does in the JAX package);
  * the key-word planes of the engine's lane state are stored as ``int32``
    BIT PATTERNS (``as_i32`` converts a carrier back); the CUDA kernels
    reinterpret those planes as ``uint32_t`` and use native arithmetic
    (csrc/rtw_common.cuh).

The "explicit generator" of this package is the pair of base-key words
``(k0, k1)``: ``key_words(seed)`` gives the words of ``jax.random.key(seed)``
-- ``(0, seed)`` -- without importing JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .math3 import fma_rn, sqrt_rn

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)


def u32(x):
    """Integer tensor or Python int -> u32 value in an int64 carrier."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return int(x) & MASK32


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """u32-in-int64 carrier -> int32 bit pattern (the lane-state form)."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block: hash (x0, x1) under key (k0, k1).

    Arguments are integer tensors or Python ints (broadcastable; int32
    bit patterns or int64 carriers alike); returns two int64 carriers.
    Bit-identical to JAX's threefry2x32 (the 20-round schedule with key
    injections every 4 rounds).
    """
    k0, k1, x0, x1 = u32(k0), u32(k1), u32(x0), u32(x1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    # 5 groups of 4 rounds; group g injects (ks[(g+1)%3], ks[(g+2)%3]+g+1).
    for g in range(5):
        for r in (_ROT_A if g % 2 == 0 else _ROT_B):
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r)
            x1 = x0 ^ x1
        x0 = (x0 + ks[(g + 1) % 3]) & MASK32
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & MASK32
    return x0, x1


def fold_in_words(k0, k1, data):
    """jax.random.fold_in on raw key words: new key = hash(0, data).

    ``data`` is an integer tensor; a negative int32 is read as its bit
    pattern (what ``astype(uint32)`` does in the JAX package).
    """
    return threefry2x32(k0, k1, 0, data)


def draw_words(k0, k1, tag, j):
    """Raw counter-mode draw: both words of hash (tag, j).

    Distinct (tag, j) pairs give independent 64-bit blocks under the
    same ray key -- no fold chain needed per draw site.
    """
    return threefry2x32(k0, k1, tag, j)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """u32 bits -> f32 uniform in [0, 1), jax.random.uniform's map.

    Mantissa-fill: (bits >> 9) | 0x3f800000 viewed as f32 is 1.xxx in
    [1, 2); subtract 1.
    """
    fb = (u32(bits) >> 9) | 0x3F800000
    return fb.to(torch.int32).view(torch.float32) - 1.0


def draw_uniform2(k0, k1, tag, j):
    """Two f32 uniforms from ONE hash (the raw-counter contract)."""
    b0, b1 = draw_words(k0, k1, tag, j)
    return uniform_from_bits(b0), uniform_from_bits(b1)


def key_words(seed: int) -> tuple[int, int]:
    """The base-key words of ``jax.random.key(seed)``: ``(0, seed)``."""
    seed = int(seed)
    if not 0 <= seed <= MASK32:
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    return 0, seed


# ---------------------------------------------------------------------------
# jax.random's own layouts (threefry_partitionable=True), for the gradient
# surrogates (ops/silhouette.py, ops/branchprob.py), which draw through
# jax.random.uniform / categorical rather than the raw counter contract.
# ---------------------------------------------------------------------------

F32_TINY = float(torch.finfo(torch.float32).tiny)


def random_bits(key, shape, device) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit) -> u32 carriers of
    ``shape``: the flat row-major index i of each element is hashed as the
    counter (hi, lo) = (i >> 32, i & 0xFFFFFFFF) under the key, and the two
    output words are XOR-ed (JAX's partitionable threefry layout)."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key[0], key[1], idx >> 32, idx & MASK32)
    return (b0 ^ b1).reshape(shape)


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def uniform(key, shape, device, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``, bit for
    bit: the mantissa-fill float f in [0, 1), then
    ``max(minval, f * (maxval - minval) + minval)`` in float32."""
    f = uniform_from_bits(random_bits(key, shape, device))
    lo = _f32(minval)
    span = _f32(_f32(maxval) - lo)
    return torch.clamp_min(f * span + lo, lo)


def gumbel(key, shape, device) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` (the default "low" mode):
    ``-log(-log(u))`` with u uniform on [tiny, 1). The logs are PyTorch's,
    which may differ from XLA's by an ulp."""
    u = uniform(key, shape, device, minval=F32_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(key, logits: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1, shape=shape)``: the
    Gumbel-max draw, argmax over the last axis of ``gumbel + logits``,
    with the gumbel noise drawn over ``shape + (n_categories,)`` (the
    batch dims of ``logits``, its last axis removed, broadcast to
    ``shape``'s trailing dims) -> int64 indices of ``shape``. Ties go to
    the first index, as ``jnp.argmax`` does."""
    shape = tuple(shape)
    noise = gumbel(key, shape + (logits.shape[-1],), logits.device)
    lead = len(shape) - (logits.dim() - 1)
    return torch.argmax(noise + logits.reshape(
        (1,) * lead + tuple(logits.shape)), dim=-1)


# ---------------------------------------------------------------------------
# The rest of jax.random's host-side layout, for fit's draws: the pixel
# batches (optim/inverse.draw_pixel_batch) and the CLI's perturbation.
# ---------------------------------------------------------------------------

def split(key, num: int = 2) -> list:
    """``jax.random.split(key, num)`` (the partitionable, fold-like
    split): key i is BOTH output words of hash (0, i) under ``key`` --
    kept as the new key's words, not XOR-ed as ``random_bits`` does.
    Key words that are Python ints give Python ints."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def permutation(key, n: int, device) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` -> an int64 tensor of ``n`` on
    ``device``: JAX's shuffle by repeated sorts. Each of ``ceil(3 ln n /
    ln(2**32 - 1))`` rounds splits the key, draws ``random_bits(sub,
    (n,))`` and sorts by those u32 keys, carrying the values. The sort is
    STABLE, as ``lax.sort_key_val`` is: about n**2 / 2**33 pairs of keys
    collide in a round, and only a stable sort gives JAX's order."""
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,), device), stable=True)[1]
        x = x[order]
    return x


def choice_without_replacement(key, n: int, k: int,
                               device) -> torch.Tensor:
    """``jax.random.choice(key, n, (k,), replace=False)``: the head of
    ``permutation(key, n)`` -> int64 tensor of ``k``."""
    if not 0 <= k <= n:
        raise ValueError(f"cannot take {k} of {n} without replacement")
    return permutation(key, n, device)[:k]


# XLA's float32 erf_inv, as XLA:CPU evaluates it (the JAX package's
# reference platform): chlo.erf_inv (Giles' single-precision polynomial,
# coefficients from the highest power down, for w < 5 and for w >= 5, where
# w = -log1p(-x * x)) over XLA:CPU's log1p (Cephes' rational function below
# sqrt(2) - 1, log(1 + x) above it) and log (Cephes' logf), with every
# multiply-add contracted to a fused multiply-add as LLVM contracts it
# (``math3.fma_rn``).
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def _poly(x: torch.Tensor, coeffs) -> torch.Tensor:
    """Horner from the highest power down, each step fused."""
    p = torch.full_like(x, _f32(coeffs[0]))
    for c in coeffs[1:]:
        p = fma_rn(p, x, _f32(c))
    return p


def xla_log(y: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 log of a positive finite float32 tensor (Cephes'
    logf: the mantissa in [sqrt(1/2), sqrt(2)) less 1, a degree-8
    polynomial in three fused parts, the exponent's ln 2 in two pieces)."""
    y = torch.clamp_min(y, F32_TINY)
    bits = y.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    low = m < _f32(0.707106781186547524)
    x = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.float()
    x2 = x * x
    x3 = x2 * x
    c = [_f32(v) for v in _LOG_P]
    y0 = fma_rn(fma_rn(x, c[0], c[1]), x, c[2])
    y1 = fma_rn(fma_rn(x, c[3], c[4]), x, c[5])
    y2 = fma_rn(fma_rn(x, c[6], c[7]), x, c[8])
    r = fma_rn(fma_rn(fma_rn(y0, x3, y1), x3, y2), x3, e * _f32(_LOG_Q1))
    x = fma_rn(-0.5, x2, x) + r
    return fma_rn(_f32(_LOG_Q2), e, x)


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 log1p of a float32 tensor > -1: below |x| <
    sqrt(2) - 1 Cephes' rational function x - x**2 / 2 + x**3 * P(x) /
    Q(x), else ``xla_log(1 + x)``."""
    x2 = x * x
    small = (x * x2) * (_poly(x, _LOG1P_NUM) / _poly(x, _LOG1P_DEN))
    small = x + fma_rn(-0.5, x2, small)
    big = xla_log(x + 1.0)
    return torch.where(x.abs() < _f32(0.41421356237309504880), small, big)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``lax.erf_inv`` of a float32 tensor in XLA:CPU's arithmetic, not
    ``torch.erfinv``'s: w = -log1p(-x * x); below 5 the polynomial in
    w - 2.5, else in sqrt(w) - 3; times x; +-inf at |x| == 1."""
    w = -xla_log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt_rn(w) - 3.0)
    lt5 = torch.tensor(_ERFINV_LT5, dtype=torch.float32, device=x.device)
    ge5 = torch.tensor(_ERFINV_GE5, dtype=torch.float32, device=x.device)
    p = torch.where(lt, lt5[0], ge5[0])
    for i in range(1, len(_ERFINV_LT5)):
        p = fma_rn(p, w, torch.where(lt, lt5[i], ge5[i]))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key, shape, device) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (float32): u uniform on
    [nextafter(-1, 0), 1), then sqrt(2) * erf_inv(u) in float32, with
    XLA's erf_inv (see ``erf_inv``)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, tuple(shape), device, minval=lo, maxval=1.0)
    return _f32(math.sqrt(2.0)) * erf_inv(u)
