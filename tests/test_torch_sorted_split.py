"""The split loops of the sorted closest hit (``csrc/closest_hit_sorted.cu``)
and of the whole-bounce kernel (``csrc/mega_bounce.cu``), in plain terms,
and the sorted frame's sort state computed inside the epoch.

Both kernels split a ray's sphere loop over K threads and reduce the K
partials with warp shuffles; the sorted kernel reduces over (q, POSITION in
its cull block's sorted order), the whole-bounce kernel over (q, sphere
index), and the sorted kernel votes its staged exit over a warp of 32 / K
rays. A CUDA kernel cannot run here; ``chip_smoke.py`` holds both to the bit
against their plain versions on the card at every K. These tests hold what
the CPU can reach, with no tolerance (every comparison is exact) but the
JAX frame's:
  * ``closest_hit_checks.split_min`` over positions equals the sequential
    sorted-order running min for every K and any assignment of positions
    to threads, on ties planted where the sorted order and the id order
    disagree -- where a reduce over (q, sphere id) gives another sphere;
  * the same partition and reduce over the id order is the plain
    whole-bounce step's closest hit on a mid-frame lane state;
  * ``closest_hit_checks.sorted_split`` -- the sorted kernel step for step,
    the exit vote of every thread of a warp of 32 / K rays included -- is
    the plain sorted closest hit on a stale sort state of a mid-frame lane
    state, at every K and ladder, and where its vote fires (near hits in
    every thread's partition, rays that left the slab);
  * the sorted frame with its sort state computed inside each epoch (as a
    captured epoch computes it on the card) is the frame of a loop that
    passes the sort state in, under both ownerships; the two ownerships'
    frames are bit-equal and within the frame rule of the JAX engine's
    (atol 5e-4 on the huge scene, as the other sorted frames are held).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import raytracinginoneweekend_tpu_torch as rt
from raytracinginoneweekend_tpu import config as jconfig
from raytracinginoneweekend_tpu.models import camera as jcamera
from raytracinginoneweekend_tpu.models import scene as jscene
from raytracinginoneweekend_tpu.ops import wavefront as jwave
from raytracinginoneweekend_tpu_torch import closest_hit_checks as chk
from raytracinginoneweekend_tpu_torch import golden
from raytracinginoneweekend_tpu_torch.models import camera as pcamera
from raytracinginoneweekend_tpu_torch.models import scene as pscene
from raytracinginoneweekend_tpu_torch.ops import cuda_segment as pseg
from raytracinginoneweekend_tpu_torch.ops import wavefront as pwave

torch.set_num_threads(2)  # several test workers share the machine's cores

SPLITS = (1, 2, 4, 8, 16, 32)
BIG = np.float32(1e30)


def _sequential(q):
    """The one-thread loop: ascending strict-`<` running min -> (q, first
    position of it) per row, (BIG, 0) for a row that misses."""
    qb = np.full(q.shape[0], BIG, np.float32)
    pb = np.zeros(q.shape[0], np.int64)
    for p in range(q.shape[1]):
        w = q[:, p] < qb
        qb[w], pb[w] = q[w, p], p
    return qb, pb


def _planted_sorted_ties(g, m=96):
    """q in a cull block's sorted order beside its perm, with ties at
    positions (a, b), a < b, whose ids run the other way (perm[a] >
    perm[b]): the sorted order keeps position a, the id order perm[b]."""
    perm = g.permutation(m)
    pairs = [(0, 1), (3, 4), (7, 8), (15, 16), (31, 32), (5, 6), (20, 22),
             (40, 44), (48, 56), (57, 73), (60, 92), (2, 95), (94, 95)]
    q = g.uniform(1.0, 100.0, (2 * len(pairs), m)).astype(np.float32)
    for row, (a, b) in enumerate(pairs * 2):
        if perm[a] < perm[b]:
            perm[a], perm[b] = perm[b], perm[a]
        q[row, [a, b]] = np.float32(g.uniform(0.01, 0.9))
        if row >= len(pairs):
            q[row, ::3] = np.where(np.arange(m)[::3] == a, q[row, a], BIG)
    return q, perm


@pytest.mark.parametrize("k", SPLITS)
def test_sorted_reduce_over_positions_is_the_sorted_running_min(k):
    g = np.random.default_rng(10 + k)
    q, perm = _planted_sorted_ties(g)
    want_q, want_p = _sequential(q)
    for thread in (None, g.integers(0, k, q.shape[1])):
        q_b, p_b = chk.split_min(q, k, thread=thread)
        np.testing.assert_array_equal(q_b.view(np.int32),
                                      want_q.view(np.int32))
        np.testing.assert_array_equal(perm[p_b], perm[want_p])
    # the reduce over (q, sphere id) instead keeps the lower id, another
    # sphere wherever the tied positions lie in two threads
    q_i, s_i = chk.split_min(q, k, key=perm)
    np.testing.assert_array_equal(q_i, want_q)
    if k == 1:
        np.testing.assert_array_equal(s_i, perm[want_p])
    else:
        assert (s_i != perm[want_p]).any()


SMALL = dict(width=24, height=16, spp=4, max_depth=6, camera_mode="thinlens",
             pool_size=2048, device="cpu")


def _mid_frame(options, steps: int = 3):
    """A mid-frame lane state of the huge scene at 24x16 (the default
    step's engine advanced ``steps`` iterations past the prologue)."""
    scene = pscene.huge_scene(0, "cpu")
    cam = pcamera.reference_cpu_camera(SMALL["width"], SMALL["height"],
                                       device="cpu")
    eng = pwave.build_engine(scene, cam, rt.key_words(3), options=options,
                             **{k: v for k, v in SMALL.items()
                                if k != "max_depth"},
                             max_depth=SMALL["max_depth"])
    state = pwave.engine_prologue(eng)
    for _ in range(steps):
        state = pwave.engine_step(eng, state)
    return eng, state


@pytest.mark.parametrize("k", SPLITS)
def test_mega_loop_split_is_the_plain_closest_hit(k):
    eng, state = _mid_frame(rt.DEFAULT)
    act = state[3] > 0
    sel = act.reshape(-1)
    rays = [p.reshape(-1)[sel][:, None] for p in state[4:10]]
    cx, cy, cz, r = (p[None, :] for p in eng.sphere_params[:4])
    vx, vy, vz = rays[3:]
    a = vx * vx + vy * vy + vz * vz
    q = pseg._candidates(*rays, a, np.float32(eng.t_min) * a, cx, cy, cz,
                         r * r)
    q_b, s_b = chk.split_min(q.numpy(), k)
    hit, t, sb = pseg.segment_closest_hit_reference(
        tuple(state[4:10]), *eng.sphere_params[:4], eng.t_min, act)
    h = q_b < BIG
    assert 0 < h.sum() < h.size
    np.testing.assert_array_equal(h, hit.reshape(-1)[sel].numpy() > 0)
    np.testing.assert_array_equal(s_b, sb.reshape(-1)[sel].numpy())
    t_b = np.where(h, q_b * (1.0 / a[:, 0].numpy()), BIG).astype(np.float32)
    np.testing.assert_array_equal(t_b.view(np.int32),
                                  t.reshape(-1)[sel].numpy().view(np.int32))


@pytest.fixture(scope="module")
def stale_sorted_case():
    """Tile ownership's mid-frame lane state with a sort state taken four
    iterations earlier (the engine sorts once an epoch, so the kernel sees
    sort states up to an epoch old), in cull blocks of 8 rows."""
    options = dataclasses.replace(rt.DEFAULT, ownership="tile")
    eng, state = _mid_frame(options, steps=2)
    rows = 8
    sortstate = pseg.sorted_cull_state(state[3], state[4:7],
                                       *eng.sphere_params[:4], rows=rows)
    for _ in range(4):
        state = pwave.engine_step(eng, state)
    return eng, state, sortstate, rows


@pytest.mark.parametrize("ladder", [(1, 8), (4,), ()])
@pytest.mark.parametrize("k", SPLITS)
def test_sorted_vote_at_warp_width_changes_no_result(stale_sorted_case, k,
                                                     ladder):
    eng, state, sortstate, rows = stale_sorted_case
    rays, act = tuple(state[4:10]), state[3]
    geom = eng.sphere_params[:4]
    want = pseg.segment_closest_hit_sorted_reference(
        rays, *geom, sortstate, eng.t_min, rows, act, ladder)
    got, (skipped, chunks) = chk.sorted_split(
        rays, *geom, sortstate, eng.t_min, rows, act, ladder, k)
    assert not any(chk.bit_diff(got, want).values())
    assert int(want[0].sum()) > 0
    n_chunks = sortstate[0].shape[1] // pseg.UNROLL
    warps = (act.reshape(-1, chk.WARP // k) > 0).any(dim=1)
    assert chunks == int(warps.sum()) * n_chunks
    if not ladder:
        assert skipped == 0


@pytest.mark.parametrize("k", SPLITS)
def test_sorted_vote_skips_when_every_thread_is_finished(k):
    """Eight concentric shells ahead of every ray and 40 spheres some 50
    units off: each ray hits all eight shells, so after the first chunk
    (the shells, sorted first) each of up to 8 threads holds a near hit
    and is finished, and the warp skips every later chunk; at K = 16 and
    32 some threads hold no shell and the warp runs on. The result is the
    plain version's either way."""
    g = np.random.default_rng(4)
    ang = np.linspace(0.0, 2 * np.pi, 40, endpoint=False)
    cx = np.concatenate([np.zeros(8), 50 * np.cos(ang)])
    cz = np.concatenate([np.zeros(8), 50 * np.sin(ang)])
    r = np.concatenate([1.0 + 0.01 * np.arange(8), np.ones(40)])
    geom = tuple(torch.from_numpy(v.astype(np.float32))
                 for v in (cx, np.zeros(48), cz, r))
    rows, lanes = 8, 8 * 128
    o = np.stack([g.uniform(-0.2, 0.2, lanes), g.uniform(-0.2, 0.2, lanes),
                  5.0 + g.uniform(0.0, 0.2, lanes)])
    d = np.stack([g.uniform(-0.01, 0.01, lanes),
                  g.uniform(-0.01, 0.01, lanes), -np.ones(lanes)])
    rays = tuple(torch.from_numpy(v.astype(np.float32).reshape(rows, 128))
                 for v in (*o, *d))
    act = torch.ones((rows, 128), dtype=torch.int32)
    ss = pseg.sorted_cull_state(act, rays[:3], *geom, rows=rows)
    assert sorted(ss[0][0, :8].tolist()) == list(range(8))
    want = pseg.segment_closest_hit_sorted_reference(rays, *geom, ss, 0.008,
                                                     rows, act, (1, 8))
    got, (skipped, chunks) = chk.sorted_split(rays, *geom, ss, 0.008, rows,
                                              act, (1, 8), k)
    assert not any(chk.bit_diff(got, want).values())
    assert bool((want[0] == 1).all()) and bool((want[2] == 7).all())
    n_chunks = ss[0].shape[1] // pseg.UNROLL
    assert chunks == lanes * k // 32 * n_chunks
    assert skipped == (chunks // n_chunks * (n_chunks - 1) if k <= 8 else 0)


def test_sorted_vote_skips_rays_that_left_the_slab():
    """Rays above every sphere heading up are finished from the start: the
    warps that hold only such rays (half of them) skip every chunk, and the
    result is the plain version's."""
    eng, state = _mid_frame(rt.DEFAULT, steps=1)
    rays = [p.clone() for p in state[4:10]]
    act = torch.ones_like(state[3])
    away = (torch.arange(act.numel()) // 64 % 2 == 0).reshape(act.shape)
    rays[1] = torch.where(away, rays[1] + 2000.0, rays[1])
    rays[4] = torch.where(away, rays[4].abs() + 0.1, rays[4])
    rays = tuple(rays)
    geom = eng.sphere_params[:4]
    rows = 8
    sortstate = pseg.sorted_cull_state(act, rays[:3], *geom, rows=rows)
    want = pseg.segment_closest_hit_sorted_reference(
        rays, *geom, sortstate, eng.t_min, rows, act)
    n_chunks = sortstate[0].shape[1] // pseg.UNROLL
    for k in (1, 4, 32):
        got, (skipped, chunks) = chk.sorted_split(
            rays, *geom, sortstate, eng.t_min, rows, act, (1, 8), k)
        assert not any(chk.bit_diff(got, want).values())
        assert chunks == act.numel() * k // 32 * n_chunks
        assert chunks // 2 <= skipped < chunks
    assert int(want[0][away].sum()) == 0


JAX_FRAME = dict(width=24, height=16, spp=2, max_depth=4,
                 camera_mode="thinlens", pool_size=2048, flush_every=2)


def _sorted_options(mod, ownership):
    return dataclasses.replace(mod.DEFAULT, hit_kernel="sorted",
                               ownership=ownership)


@functools.lru_cache(maxsize=None)
def _sorted_frame(ownership):
    """-> (the frame with the sort state made inside each epoch, the frame
    of wavefront_fb's loop with the sort state made outside the epoch and
    passed in, as the loop ran before the epoch made its own)."""
    scene = pscene.huge_scene(0, "cpu")
    cam = pcamera.reference_cpu_camera(24, 16, device="cpu")
    kw = dict(options=_sorted_options(rt, ownership), device="cpu",
              **JAX_FRAME)
    inside = pwave.wavefront_fb(scene, cam, rt.key_words(0), **kw)
    eng = pwave.build_engine(scene, cam, rt.key_words(0), **kw)
    ledger = pwave.new_ledger(eng)
    state = pwave.engine_prologue(eng)
    epochs = 0
    while pwave.more(ledger, state):
        state = pwave.engine_epoch(eng, state, ledger,
                                   pwave.engine_sortstate(eng, state))
        epochs += 1
    assert epochs >= 2
    return inside, pwave.fold_ledger(eng, ledger.cells)


@pytest.mark.parametrize("ownership", ["strided", "tile"])
def test_sort_state_inside_the_epoch(ownership):
    inside, passed_in = _sorted_frame(ownership)
    assert float(inside.sum()) > 0
    assert torch.equal(inside, passed_in)


def test_sorted_frames_inside_the_epoch_match_jax():
    """Tile ownership traces the strided frame's paths: the two frames are
    bit-equal, and held to the JAX engine's sorted tile frame."""
    strided, tile = (_sorted_frame(own)[0] for own in ("strided", "tile"))
    assert torch.equal(strided, tile)
    want = np.asarray(jwave.render_wavefront(
        jscene.huge_scene(0), jcamera.reference_cpu_camera(24, 16),
        jax.random.key(0), options=_sorted_options(jconfig, "tile"),
        **JAX_FRAME))
    cmp = golden.compare_frames((tile / JAX_FRAME["spp"]).numpy(), want,
                                atol=5e-4)
    assert cmp["ok"], cmp


def test_split_keyword_checked():
    """``split=`` forces the K of the two kernels (for measuring); on the
    CPU every K is the plain version, and a K the kernels lack raises."""
    from raytracinginoneweekend_tpu_torch.ops import cuda_mega

    eng, state = _mid_frame(rt.DEFAULT, steps=1)
    rays, act = tuple(state[4:10]), state[3]
    geom = eng.sphere_params[:4]
    rows = 8
    ss = pseg.sorted_cull_state(act, rays[:3], *geom, rows=rows)
    planes, kw = pwave.mega_planes(state), pwave.mega_kw(eng)
    with pytest.raises(ValueError, match="split"):
        pseg.segment_closest_hit_sorted(rays, *geom, ss, eng.t_min, rows,
                                        act, split=3)
    with pytest.raises(ValueError, match="split"):
        cuda_mega.mega_bounce(planes, eng.sphere_params, split=64, **kw)
    want = pseg.segment_closest_hit_sorted_reference(rays, *geom, ss,
                                                     eng.t_min, rows, act)
    want_m = cuda_mega.mega_bounce_reference(planes, eng.sphere_params,
                                             **kw)
    for k in (1, 32):
        got = pseg.segment_closest_hit_sorted(rays, *geom, ss, eng.t_min,
                                              rows, act, split=k)
        assert not any(chk.bit_diff(got, want).values())
        got_m = cuda_mega.mega_bounce(planes, eng.sphere_params, split=k,
                                      **kw)
        assert all(torch.equal(g, w) for g, w in zip(got_m, want_m))


@pytest.mark.parametrize("n_lanes,want", [
    (1 << 15, 4), (1 << 16, 2), (1 << 17, 1), (1 << 20, 1), (8192, 16),
    (1024, 32)])
def test_split_picker_of_the_sorted_and_whole_bounce_kernels(n_lanes, want):
    """closest_hit's picker aimed at SPLIT_THREADS_PER_SM threads an SM of
    an H100's 132: the K the two kernels launch with."""
    assert pseg.closest_hit_split(n_lanes, 132,
                                  pseg.SPLIT_THREADS_PER_SM) == want
