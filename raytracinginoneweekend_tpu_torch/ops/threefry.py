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

import torch

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
