"""Threefry-2x32 counter hashing and the draws built on it, in plain PyTorch.

A frozen copy of the renderer's random-number contract, written for the
benchmark so that the yardstick does not move when the program does:

* ``threefry2x32(k0, k1, x0, x1)`` is the 20-round Threefry-2x32 block
  (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011)
  with key injections every four rounds, as ``jax.random`` computes it.
* a ray's key is ``fold_in(fold_in(base, pixel), sample)``, where
  ``fold_in(k, d) = threefry(k, (0, d))``;
* a draw site ``(tag, j)`` of a ray is both words of ``threefry(ray_key,
  (tag, j))``; tag 0 is the pixel jitter, 1 the lens, ``2 + b`` bounce b;
* a word becomes a float32 uniform in [0, 1) by filling the mantissa:
  ``((w >> 9) | 0x3F800000)`` read as a float, minus 1;
* ``split``, ``random_bits`` and ``choice`` are ``jax.random``'s
  partitionable layouts, which the fit's pixel batches are drawn from.

Words are carried as int64 tensors holding values in [0, 2**32), since
PyTorch has no unsigned 32-bit arithmetic on every device.
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _word(x, device=None):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK
    return torch.tensor(int(x) & MASK, dtype=torch.int64, device=device)


def threefry2x32(k0, k1, x0, x1):
    """Hash the counter (x0, x1) under the key (k0, k1) -> two words.

    Arguments broadcast; ints and tensors mix. Returns int64 tensors."""
    dev = next((t.device for t in (k0, k1, x0, x1)
                if isinstance(t, torch.Tensor)), None)
    k0, k1, x0, x1 = (_word(t, dev) for t in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    a = (x0 + ks[0]) & MASK
    b = (x1 + ks[1]) & MASK
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            a = (a + b) & MASK
            b = ((b << r) | (b >> (32 - r))) & MASK
            b = a ^ b
        a = (a + ks[(group + 1) % 3]) & MASK
        b = (b + ks[(group + 2) % 3] + group + 1) & MASK
    return a, b


def fold_in(key, data):
    """``jax.random.fold_in`` on key words: the key's hash of (0, data)."""
    return threefry2x32(key[0], key[1], 0, data)


def ray_key(base, pixel, sample):
    """The key of one (pixel, sample) ray: fold by pixel, then by sample."""
    return fold_in(fold_in(base, pixel), sample)


def uniform(word: torch.Tensor) -> torch.Tensor:
    """A word -> a float32 uniform in [0, 1) (mantissa fill)."""
    bits = ((word >> 9) | 0x3F800000).to(torch.int32)
    return bits.view(torch.float32) - 1.0


def uniforms(key, tag, j):
    """The two uniforms of draw site (tag, j) under a ray key."""
    w0, w1 = threefry2x32(key[0], key[1], tag, j)
    return uniform(w0), uniform(w1)


def key_of(words) -> tuple[int, int]:
    """Two Python ints from key words (tensors or ints)."""
    return tuple(int(w) & MASK for w in words)


def split(key, num: int = 2) -> list:
    """``jax.random.split``: key i is both words of the hash of (0, i)."""
    return [key_of(threefry2x32(key[0], key[1], 0, i)) for i in range(num)]


def random_bits(key, n: int, device) -> torch.Tensor:
    """``jax.random.bits(key, (n,))``: element i hashes the counter
    (i >> 32, i & MASK), and its two words are XOR-ed."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    w0, w1 = threefry2x32(key[0], key[1], i >> 32, i & MASK)
    return w0 ^ w1


def choice(key, n: int, k: int, device) -> torch.Tensor:
    """``jax.random.choice(key, n, (k,), replace=False)``: the first k of
    ``jax.random.permutation(key, n)``, which sorts by fresh random bits
    (stably) in ceil(3 ln n / ln(2**32 - 1)) rounds."""
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(2 ** 32 - 1))
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(rounds):
        key, sub = split(key)
        x = x[torch.sort(random_bits(sub, n, device), stable=True)[1]]
    return x[:k]


def seed_key(seed: int, *path: int) -> tuple[int, int]:
    """Key words for a run's seed (any non-negative int below 2**64),
    folded by each number of ``path``: the benchmark's own keys."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed {seed} outside [0, 2**64)")
    key = (seed >> 32, seed & MASK)
    for p in path:
        key = key_of(fold_in(key, p))
    return key
