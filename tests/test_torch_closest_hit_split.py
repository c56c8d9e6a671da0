"""The split closest-hit loop of ``csrc/closest_hit.cu``, in plain terms.

The kernel splits each ray's sphere loop over K threads (thread j scans
spheres j, j + K, ...), reduces the K partials lexicographically over
(q, sphere index) with warp shuffles, and takes the square root only where
the discriminant is >= 0. A CUDA kernel cannot run here; ``chip_smoke.py``
holds it to the bit against its plain version on the card. These tests
hold what the CPU can reach, with no tolerance (every comparison is exact):
  * a plain emulation of the K-way strided partition and the butterfly
    reduce (``closest_hit_checks.split_min``) equals ``torch.min``'s first
    index -- what the plain version returns -- for every K, on q arrays
    with ties planted across partitions, rows that miss everything and
    exact equalities;
  * the guarded candidate (``closest_hit_checks.guarded``) equals the
    unguarded one bit for bit;
  * the picker ``closest_hit_split``;
  * the ``ties_and_grazes`` table (``closest_hit_checks``) through the
    port's plain ``segment_closest_hit`` against the JAX
    ``segment_closest_hit`` (the Pallas kernel in interpret mode) and the
    exact expectation. Its numbers are small and exact in float32, so
    XLA:CPU's contraction of multiply-adds cannot move them;
  * ``closest_hit_checks.disc_pairs``, the count of pairs that reach the
    sqrt, from which ``chip_smoke.py`` states the kernel's second bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginoneweekend_tpu.ops import pallas_segment as jseg
from raytracinginoneweekend_tpu_torch import closest_hit_checks as chk
from raytracinginoneweekend_tpu_torch.models import scene as pscene
from raytracinginoneweekend_tpu_torch.ops import cuda_segment as pseg

torch.set_num_threads(2)  # several test workers share the machine's cores

BIG = np.float32(1e30)
SPLITS = (1, 2, 4, 8, 16, 32)
H100_SMS = 132


def _planted_ties(g, n_sph=96):
    """Rows whose minimum sits at two or three indices, in one partition
    or in several for each K (pairs s, s + 1 and s, s + K; the later copy
    in a lower thread, as (7, 8) for K = 8)."""
    pairs = [(0, 1), (1, 2), (3, 4), (7, 8), (15, 16), (31, 32), (63, 64),
             (5, 6), (20, 22), (40, 44), (48, 56), (57, 73), (60, 92),
             (2, 95), (94, 95)]
    q = g.uniform(1.0, 100.0, (len(pairs) * 4, n_sph)).astype(np.float32)
    for row, (a, b) in enumerate(pairs * 4):
        m = np.float32(g.uniform(0.01, 0.9))
        q[row, [a, b]] = m
        if row >= 2 * len(pairs):  # a third copy further on
            q[row, min(b + 9, n_sph - 1)] = m
    q[len(pairs):2 * len(pairs), ::3] = BIG  # misses among the ties
    return q


def _all_big(g, n_sph=96):
    return np.full((8, n_sph), BIG, np.float32)


def _exact_equalities(g, n_sph=96):
    """Whole rows equal; rows of a few values, each repeated; a row
    where the minimum is the last sphere only."""
    q = g.choice(np.float32([0.5, 2.0, 7.25]), (6, n_sph))
    q[0] = np.float32(3.0)
    q[1] = BIG
    q[1, -1] = np.float32(3.0)
    return q


def _real_candidates(g, n_sph=None):
    """Candidates of rays among the huge scene's 489 spheres
    (``cuda_segment._candidates``, the plain version's arithmetic)."""
    sc = pscene.huge_scene(0, device="cpu")
    cx, cy, cz, r = pseg.sphere_params_from_scene(sc)[:4]
    n = 64
    o = np.stack([g.uniform(-8, 8, n), g.uniform(0.05, 1.5, n),
                  g.uniform(-8, 8, n)]).astype(np.float32)
    d = g.normal(size=(3, n)).astype(np.float32)
    o, d = torch.from_numpy(o)[:, :, None], torch.from_numpy(d)[:, :, None]
    a = (d * d).sum(0)
    q = pseg._candidates(*o, *d, a, np.float32(0.008) * a, cx[None],
                         cy[None], cz[None], (r * r)[None])
    return q.numpy()


CASES = {"planted_ties": _planted_ties, "all_big": _all_big,
         "exact_equalities": _exact_equalities,
         "real_candidates": _real_candidates}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("k", SPLITS)
def test_split_reduce_is_first_min(case, k):
    q = CASES[case](np.random.default_rng(k))
    q_b, s_b = chk.split_min(q, k)
    want_q, want_s = torch.min(torch.from_numpy(q), dim=1)
    np.testing.assert_array_equal(q_b.view(np.int32),
                                  want_q.numpy().view(np.int32))
    np.testing.assert_array_equal(s_b, want_s.numpy())
    if case == "all_big":
        assert (s_b == 0).all()  # a ray that misses everything: sb 0


@pytest.mark.parametrize("scene", ["huge", "ties_and_grazes"])
def test_guarded_candidate_is_bit_equal(scene):
    if scene == "huge":
        g = np.random.default_rng(1)
        n = 256
        o = torch.from_numpy(np.stack([
            g.uniform(-8, 8, n), g.uniform(0.05, 1.5, n),
            g.uniform(-8, 8, n)]).astype(np.float32))
        d = torch.from_numpy(g.normal(size=(3, n)).astype(np.float32))
        cx, cy, cz, r = pseg.sphere_params_from_scene(
            pscene.huge_scene(0, device="cpu"))[:4]
    else:
        rays, (cx, cy, cz, r), _, _ = chk.ties_and_grazes(
            torch.device("cpu"))
        o = torch.stack([p.reshape(-1) for p in rays[:3]])
        d = torch.stack([p.reshape(-1) for p in rays[3:]])
    o, d = o[:, :, None], d[:, :, None]
    a = (d * d).sum(0)
    args = (*o, *d, a, np.float32(0.008) * a, cx[None], cy[None], cz[None],
            (r * r)[None])
    want = pseg._candidates(*args)
    got = chk.guarded(*args)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.numpy().view(np.int32))
    if scene == "ties_and_grazes":  # the exact graze is a hit
        graze = want[:, chk.GRAZE_SPHERE] < 1e30
        assert bool(graze[9::11].all())


@pytest.mark.parametrize("n_lanes,want", [
    (1 << 15, 8), (1 << 17, 2), (1 << 20, 1), (1 << 22, 1), (1 << 16, 4),
    (1024, 32), (1, 32), (31, 32), (32, 32)])
def test_split_picker(n_lanes, want):
    assert pseg.closest_hit_split(n_lanes, H100_SMS) == want


def test_split_picker_rule():
    """K is a power of two up to 32, never grows with the lane count, and
    is the smallest that reaches the target of threads an SM (or 32)."""
    target = H100_SMS * pseg.CH_THREADS_PER_SM
    last = 32
    for n in [1, 7, 32, 100, 128 * 3, 4096, 20000, 32768, 50000, 131072,
              262144, 600000, 1 << 20, 3 << 20]:
        k = pseg.closest_hit_split(n, H100_SMS)
        assert k in pseg.CH_SPLITS and k <= last
        assert k == 32 or n * k >= target
        assert k == 1 or n * (k // 2) < target
        last = k
    assert pseg.closest_hit_split(32768, 66) == 4  # half the SMs, half K


def test_split_keyword_checked():
    rays, geom, t_min, want = chk.ties_and_grazes(torch.device("cpu"))
    with pytest.raises(ValueError, match="split"):
        pseg.segment_closest_hit(rays, *geom, t_min, split=3)
    for k in SPLITS:  # on the CPU every K is the plain version
        got = pseg.segment_closest_hit(rays, *geom, t_min, split=k)
        assert not any(chk.bit_diff(got, want).values())


def test_ties_and_grazes_against_jax():
    rays, geom, t_min, want = chk.ties_and_grazes(torch.device("cpu"))
    got = pseg.segment_closest_hit(rays, *geom, t_min)
    jgot = jseg.segment_closest_hit(
        tuple(jnp.asarray(p.numpy()) for p in rays),
        *(jnp.asarray(p.numpy()) for p in geom), t_min, rows=8)
    for g, j, w in zip(got, jgot, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    hit, t, sb = (x.reshape(-1).numpy() for x in got)
    kind = np.arange(hit.size) % 11
    assert (sb[kind < 9] == np.array(
        [p[0] for p in chk.TIE_PAIRS])[kind[kind < 9]]).all()
    assert (hit[kind == 9] == 1).all() and (t[kind == 9][::2] == 5.0).all()
    assert (hit[kind == 10] == 0).all() and (sb[kind == 10] == 0).all()


def test_disc_pairs_on_ties_and_grazes():
    """Exact counts: a ray at a tied pair crosses both copies' spheres, the
    graze has disc 0, and the ray that misses everything still crosses the
    unit sphere's line behind it (disc > 0 counts whatever the roots)."""
    rays, geom, _, _ = chk.ties_and_grazes(torch.device("cpu"))
    lanes = rays[0].numel()
    per_lane = np.where(np.arange(lanes) % 11 < 9, 2, 1)
    assert chk.disc_pairs(rays, *geom) == (per_lane.sum(),
                                           lanes * chk.TIE_SPHERES)
    even = np.arange(lanes) % 2 == 0
    act = torch.from_numpy(even.astype(np.int32).reshape(rays[0].shape))
    assert chk.disc_pairs(rays, *geom, act, chunk=100) == (
        per_lane[even].sum(), int(even.sum()) * chk.TIE_SPHERES)


@pytest.mark.parametrize("chunk", [7, 1 << 15])
def test_disc_pairs_huge_scene(chunk):
    """Against the same float32 operations in numpy on random rays among
    the huge scene's 489 spheres, with some lanes inactive."""
    g = np.random.default_rng(3)
    n = 2 * 128
    o = np.stack([g.uniform(-8, 8, n), g.uniform(0.05, 1.5, n),
                  g.uniform(-8, 8, n)]).astype(np.float32)
    d = g.normal(size=(3, n)).astype(np.float32)
    act = g.integers(0, 2, n).astype(np.int32)
    cx, cy, cz, r = pseg.sphere_params_from_scene(
        pscene.huge_scene(0, device="cpu"))[:4]
    rays = tuple(torch.from_numpy(p.reshape(2, 128).copy())
                 for p in (*o, *d))
    got = chk.disc_pairs(rays, cx, cy, cz, r,
                         torch.from_numpy(act.reshape(2, 128)), chunk=chunk)
    sel = act > 0
    (x, y, z), (vx, vy, vz) = (v[:, sel, None] for v in (o, d))
    c3 = [p.numpy()[None, :] for p in (cx, cy, cz)]
    rr = (r * r).numpy()[None, :]
    a = vx * vx + vy * vy + vz * vz
    ocx, ocy, ocz = x - c3[0], y - c3[1], z - c3[2]
    b = ocx * vx + ocy * vy + ocz * vz
    c = ocx * ocx + ocy * ocy + ocz * ocz - rr
    disc = b * b - a * c
    assert got == (int((disc >= 0).sum()), disc.size)
    assert 0 < got[0] < got[1]
