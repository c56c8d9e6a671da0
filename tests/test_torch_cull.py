"""PyTorch port vs the JAX package: the cone cull (ops/cull.py).

The same camera rays (made by the JAX package, handed over as numpy) go
through both packages' ``block_cone_stats`` and ``candidate_lists`` at a
small cull block (rows=8, two blocks).

Tolerances, and why:
  * ``tile_pixel`` / ``virtual_grid`` are integer arithmetic: equal;
  * cone stats: rtol 1e-5 (atol 1e-6): the two packages sum a block's 1024
    lanes in another order; ``n`` is an integer and equal;
  * lists: every bound is a float32 comparison, so a sphere that sits
    within rounding of a bound may be in one package's list and not in the
    other's: per block the two lists, as sets, differ by at most 2 ids.
    Where the sets are equal the integers are equal: ascending ids, pads =
    S, counts rounded up to UNROLL_LIST;
  * strictly, whatever the package: no sphere that wins the brute-force
    closest hit on an active lane is missing from its block's list.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginoneweekend_tpu.models.camera import reference_cpu_camera
from raytracinginoneweekend_tpu.models.scene import huge_scene
from raytracinginoneweekend_tpu.ops import cull as jcull
from raytracinginoneweekend_tpu.ops.planar import camera_rays
from raytracinginoneweekend_tpu_torch.ops import cull as pcull
from raytracinginoneweekend_tpu_torch.ops import cuda_segment as pseg

# The suite runs in several worker processes that share the machine's cores.
# PyTorch's default, one intra-op thread per core in EVERY worker,
# oversubscribes them (measured: the same small frames take five times as
# long with six workers); the planes here are small, two threads are plenty.
torch.set_num_threads(2)

ROWS = 8
BLOCK = ROWS * 128
T_MIN = 1e-3
W, H = 1200, 800


@pytest.fixture(scope="module")
def geo():
    scene = huge_scene(0)
    g = (scene.centers[:, 0], scene.centers[:, 1], scene.centers[:, 2],
         scene.radii)
    return g, tuple(torch.from_numpy(np.array(v)) for v in g)


def _camera_blocks(seed, n_blocks=2, tpp=4):
    """Tile-contiguous camera rays of the 1200x800 frame, as the dual
    engine's primary pool holds them -> (rays (6 numpy planes), active)."""
    cam = reference_cpu_camera(W, H)
    _, _, n_vp = jcull.virtual_grid(W, H)
    rng = np.random.default_rng(seed)
    vps, sids = [], []
    for _ in range(n_blocks):
        base = int(rng.integers(0, n_vp * tpp - BLOCK))
        tasks = base + np.arange(BLOCK)
        vps.append(tasks // tpp)
        sids.append((tasks % tpp) * 32 + int(rng.integers(0, 32)))
    vp = np.concatenate(vps).reshape(-1, 128)
    sid = np.concatenate(sids).reshape(-1, 128).astype(np.int32)
    pid, valid = jcull.tile_pixel(jnp.asarray(vp), W, H)
    rays = camera_rays(cam, pid, jnp.asarray(sid), jax.random.key(0), W, H,
                       "thinlens")[:6]
    active = np.asarray(valid) & (rng.random(vp.shape) < 0.9)
    return [np.asarray(r) for r in rays], active


def _both_stats(rays, active):
    want = jcull.block_cone_stats(jnp.asarray(active),
                                  tuple(jnp.asarray(r) for r in rays), ROWS)
    got = pcull.block_cone_stats(
        torch.from_numpy(active),
        tuple(torch.from_numpy(r.copy()) for r in rays), ROWS)
    return got, want


@pytest.mark.parametrize("size", [(1200, 800), (48, 32), (50, 34), (32, 32),
                                  (7, 100)])
def test_tile_pixel_equal_and_bijective(size):
    w, h = size
    assert pcull.virtual_grid(w, h) == jcull.virtual_grid(w, h)
    assert pcull.TILE == jcull.TILE
    _, _, n_vp = pcull.virtual_grid(w, h)
    vp = np.arange(-3, n_vp + 5, dtype=np.int32)
    gp, gv = pcull.tile_pixel(torch.from_numpy(vp), w, h)
    wp, wv = jcull.tile_pixel(jnp.asarray(vp), w, h)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    inside = (vp >= 0) & (vp < n_vp)
    pids = gp.numpy()[gv.numpy() & inside]
    assert len(pids) == w * h == len(np.unique(pids))
    assert (gp.numpy()[~gv.numpy()] == 0).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cone_stats_match_jax(seed):
    rays, active = _camera_blocks(seed)
    got, want = _both_stats(rays, active)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["n"].numpy(), np.asarray(want["n"]))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert (got["cosa"].numpy() > 0.9).all()  # coherent blocks


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lists_match_jax_as_sets_and_cull_no_winner(geo, seed):
    jgeo, pgeo = geo
    s = pgeo[0].shape[0]
    rays, active = _camera_blocks(seed)
    got_stats, want_stats = _both_stats(rays, active)
    wc, wl = jcull.candidate_lists(want_stats, *jgeo, T_MIN)
    gc, gl = pcull.candidate_lists(got_stats, *pgeo, T_MIN)
    wc, wl, gc, gl = np.asarray(wc), np.asarray(wl), gc.numpy(), gl.numpy()
    assert gl.dtype == np.int32 and gc.dtype == np.int32
    assert gl.shape == wl.shape == (2, -(-s // 4) * 4)
    # brute-force winners of the active lanes (the port's plain closest hit)
    planes = tuple(torch.from_numpy(r.copy()) for r in rays)
    hit, _t, sb = pseg.segment_closest_hit_reference(
        planes, *pgeo, T_MIN, torch.from_numpy(active))
    for b in range(2):
        n_true = int((gl[b] < s).sum())
        assert gc[b] == -(-n_true // pcull.UNROLL_LIST) * pcull.UNROLL_LIST
        assert (np.diff(gl[b, :n_true]) > 0).all()
        assert (gl[b, n_true:] == s).all()
        gset = set(gl[b, :n_true].tolist())
        wset = set(wl[b][wl[b] < s].tolist())
        assert len(gset ^ wset) <= 2, sorted(gset ^ wset)
        if gset == wset:
            np.testing.assert_array_equal(gl[b], wl[b])
            assert gc[b] == wc[b]
        rows = slice(b * ROWS, (b + 1) * ROWS)
        winners = set(sb[rows][hit[rows] > 0].tolist())
        assert winners <= gset, sorted(winners - gset)
        assert winners <= wset, sorted(winners - wset)
    assert gc.max() < 128  # coherent camera blocks cull hard


def test_lists_from_mask_is_the_compaction():
    g = np.random.default_rng(5)
    keep = g.random((7, 489)) < 0.02
    keep[3] = False
    keep[4] = True
    counts, lists = pcull.lists_from_mask(torch.from_numpy(keep))
    assert lists.shape == (7, 492)
    for b in range(7):
        ids = np.flatnonzero(keep[b])
        assert counts[b] == -(-len(ids) // 4) * 4
        np.testing.assert_array_equal(lists[b, :len(ids)].numpy(), ids)
        assert (lists[b, len(ids):] == 489).all()


def test_incoherent_block_keeps_everything_and_empty_block_nothing(geo):
    jgeo, pgeo = geo
    s = pgeo[0].shape[0]
    o = np.random.default_rng(9).uniform(-1, 1, (6, 2 * ROWS, 128)).astype(
        np.float32)
    rays = [o[0] * 10, o[1] * 2 + 2, o[2] * 10, o[3], o[4], o[5]]
    active = np.ones((2 * ROWS, 128), bool)
    active[ROWS:] = False  # the second block is empty
    got, want = _both_stats(rays, active)
    gc, gl = pcull.candidate_lists(got, *pgeo, T_MIN)
    wc, wl = jcull.candidate_lists(want, *jgeo, T_MIN)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    assert gc[0] >= s and gc[1] == 0
    assert (gl[1] == s).all()


def test_ground_is_the_first_largest_sphere(geo):
    """Two spheres of the largest |radius|: the ground special case reads
    the FIRST, as jnp.argmax does."""
    jgeo, _ = geo
    cx, cy, cz, r = (np.array(v) for v in jgeo)
    r[5] = -1000.0  # as large as the ground (sphere 0), elsewhere
    rays, active = _camera_blocks(4)
    got, want = _both_stats(rays, active)
    wc, wl = jcull.candidate_lists(want, *(jnp.asarray(v) for v in
                                           (cx, cy, cz, r)), T_MIN)
    gc, gl = pcull.candidate_lists(got, *(torch.from_numpy(v) for v in
                                          (cx, cy, cz, r)), T_MIN)
    for b in range(2):
        gset = set(gl[b].numpy().tolist())
        wset = set(np.asarray(wl[b]).tolist())
        assert len(gset ^ wset) <= 2
