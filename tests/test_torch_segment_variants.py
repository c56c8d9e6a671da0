"""PyTorch port vs the JAX package: the three closest-hit kernels for
coherent rays (list, sorted, mxu), the sort state and the segment planes.

On the CPU each of the port's wrappers runs its plain PyTorch version; the
JAX functions run their Pallas kernels in interpret mode. The same rays,
made with numpy from a seed, go through both; lists and sort states made
by the JAX package are carried across as numpy.

Tolerances, and why:
  * against the JAX package: the tolerance class of
    tests/test_torch_segment.py (``_check`` there, imported): hit and
    sphere index equal on active lanes but for at most 1e-3 of them (a
    grazing or t_min knife edge that XLA:CPU's contracted multiply-adds
    round the other way), t to 1e-4 at the 99th percentile on ordinary
    spheres and the looser ground-sphere quantiles stated there;
  * inside the port: the list kernel over the full list, and the sorted
    kernel, do kernel 1's float32 operations in kernel 1's order, so they
    are BIT-EQUAL with it (the sorted one off exact q ties between two
    spheres; none occur on these rays); a 40-sphere sublist is bit-equal
    with the 40-sphere sub-scene;
  * mxu regroups the dot products (-b = d.C - d.o, terms of size |o||C|
    where kernel 1 has |o - C|), so its t carries more cancellation noise:
    against the JAX mxu kernel (same grouping, another summation order)
    and against kernel 1 it may pick another winner on at most 1e-3 of the
    active lanes; on the ordinary spheres of the agreeing lanes t agrees
    with JAX's to 2e-6 at the median, 1e-3 at the 99th percentile and 5e-3
    everywhere (measured on the huge scene: 2e-7, 2.7e-4, 6.6e-4), with
    kernel 1's to 5e-5, 2e-3 and 1e-2 (measured: 9e-6, 3.6e-4, 9.3e-4);
  * ``sorted_cull_state``: ``oc`` and ``suf`` rtol 1e-6 (block sums in
    another order), ``perm`` equal wherever neighbouring keys differ by
    more than 1e-5, ``yb`` equal;
  * the grouped kernel (``group_scene`` + ``trace_segment(group_params=)``):
    the sorted tables equal, the bounds rtol 1e-6 (a square root of sums of
    squares); against the JAX package's grouped and ungrouped segments the
    assertions of tests/test_pallas_intersect.py (hit equal, t rtol 2e-4 /
    atol 1e-3, material planes equal on hit lanes) -- the t-space candidate
    and the q-space one of kernel 1 round differently; against the port's
    own t-space loop over the sorted table, which is its plain version,
    bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginoneweekend_tpu.models import scene as jscene
from raytracinginoneweekend_tpu.ops import pallas_segment as jseg
from raytracinginoneweekend_tpu_torch.models import scene as pscene
from raytracinginoneweekend_tpu_torch.ops import cuda_segment as pseg
from test_torch_segment import N, R, T_MIN, _check, _rays

# The suite runs in several worker processes that share the machine's cores.
# PyTorch's default, one intra-op thread per core in EVERY worker,
# oversubscribes them (measured: the same small frames take five times as
# long with six workers); the planes here are small, two threads are plenty.
torch.set_num_threads(2)

ROWS = 8
NB = R // ROWS


@pytest.fixture(scope="module")
def params():
    jp = jseg.sphere_params_from_scene(jscene.huge_scene(0))
    pp = pseg.sphere_params_from_scene(pscene.huge_scene(0, device="cpu"))
    return jp, pp


def _planes(o, d, mod):
    if mod is torch:
        return tuple(torch.from_numpy(x.copy()) for x in (*o, *d))
    return tuple(jnp.asarray(x) for x in (*o, *d))


def _np(out):
    return [np.asarray(x) for x in out]


def _full_lists(s):
    n_round = -(-s // 4) * 4
    row = np.where(np.arange(n_round) < s, np.arange(n_round), s)
    return (np.full((NB,), n_round, np.int32),
            np.broadcast_to(row, (NB, n_round)).astype(np.int32).copy())


def test_list_full_list_is_kernel_1_and_matches_jax(params):
    jp, pp = params
    o, d, active = _rays("huge")
    counts, lists = _full_lists(pp[0].shape[0])
    counts[1] = 0                     # an empty block
    pc, pl = pseg.cull_lists_from_numpy(counts, lists, device="cpu")
    assert pc.dtype == pl.dtype == torch.int32
    pact = torch.from_numpy(active)
    got = pseg.segment_closest_hit_list(_planes(o, d, torch), *pp[:4], pc,
                                        pl, T_MIN, rows=ROWS, active=pact)
    base = pseg.segment_closest_hit(_planes(o, d, torch), *pp[:4], T_MIN,
                                    active=pact)
    empty = np.zeros((R, 128), bool)
    empty[ROWS:2 * ROWS] = True
    for g, b, fill in zip(got, base, (0, np.float32(1e30), 0)):
        np.testing.assert_array_equal(g.numpy()[~empty], b.numpy()[~empty])
        assert (g.numpy()[empty] == fill).all()
    want = jseg.segment_closest_hit_list(
        _planes(o, d, jnp), *jp[:4], jnp.asarray(counts), jnp.asarray(lists),
        T_MIN, rows=ROWS, active=jnp.asarray(active))
    ok = active & ~empty              # JAX leaves t/sb of such a block stale
    _check(_np(got), _np(want), np.asarray(jp[3]), ok)


def test_list_sublist_is_the_sub_scene(params):
    jp, pp = params
    s = pp[0].shape[0]
    o, d, active = _rays("huge", seed=5)
    sub = np.sort(np.random.default_rng(0).choice(s, 40, replace=False))
    lst = np.full((NB, 44), s, np.int32)
    lst[:, :40] = sub
    counts = np.full((NB,), 40, np.int32)  # a count that is no multiple of 4
    pc, pl = pseg.cull_lists_from_numpy(counts, lst, device="cpu")
    rays = _planes(o, d, torch)
    got = pseg.segment_closest_hit_list(rays, *pp[:4], pc, pl, T_MIN,
                                        rows=ROWS, active=None)
    idx = torch.from_numpy(sub)
    want = pseg.segment_closest_hit(rays, *(p[idx] for p in pp[:4]), T_MIN)
    hm = want[0].numpy() > 0
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_array_equal(got[2].numpy()[hm],
                                  sub[want[2].numpy()[hm]])
    assert (got[2].numpy()[~hm] == 0).all() and hm.sum() > 100
    jwant = jseg.segment_closest_hit_list(
        _planes(o, d, jnp), *jp[:4], jnp.full((NB,), 44, jnp.int32),
        jnp.asarray(lst), T_MIN, rows=ROWS)
    _check(_np(got), _np(jwant), np.asarray(jp[3]), None)


def test_list_rejects_lists_of_another_block_count(params):
    _, pp = params
    o, d, _ = _rays("huge")
    counts, lists = _full_lists(pp[0].shape[0])
    with pytest.raises(ValueError, match="cull blocks"):
        pseg.segment_closest_hit_list(
            _planes(o, d, torch), *pp[:4], torch.from_numpy(counts[:-1]),
            torch.from_numpy(lists[:-1]), T_MIN, rows=ROWS)
    with pytest.raises(ValueError, match="rows"):
        pseg.segment_closest_hit_list(
            _planes(o, d, torch), *pp[:4], torch.from_numpy(counts),
            torch.from_numpy(lists), T_MIN, rows=5)


@pytest.mark.parametrize("seed", [0, 3])
def test_sorted_cull_state_matches_jax(params, seed):
    jp, pp = params
    o, _d, active = _rays("huge", seed=seed)
    want = jseg.sorted_cull_state(
        jnp.asarray(active), tuple(jnp.asarray(x) for x in o), *jp[:4],
        rows=ROWS)
    got = pseg.sorted_cull_state(
        torch.from_numpy(active), tuple(torch.from_numpy(x.copy())
                                        for x in o), *pp[:4], rows=ROWS)
    perm, suf, oc, yb = (g.numpy() for g in got)
    wperm, wsuf, woc, wyb = _np(want)
    assert perm.dtype == np.int32 and perm.shape == wperm.shape == (NB, 496)
    assert suf.shape == wsuf.shape == (NB, 63)
    np.testing.assert_array_equal(yb, wyb)
    np.testing.assert_allclose(oc, woc, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(suf, wsuf, rtol=1e-6, atol=2e-6)
    assert (oc[0] == 0).all()         # the all-inactive block
    # the order is equal wherever the keys are apart
    cx, cy, cz, r = (np.asarray(v, np.float64) for v in jp[:4])
    s = cx.shape[0]
    for b in range(NB):
        keys = np.sqrt((cx - oc[b, 0]) ** 2 + (cy - oc[b, 1]) ** 2
                       + (cz - oc[b, 2]) ** 2) - np.abs(r)
        assert sorted(perm[b, :s].tolist()) == list(range(s))
        assert (perm[b, s:] == s).all()
        differ = perm[b, :s] != wperm[b, :s]
        gap = np.abs(keys[perm[b, :s]] - keys[wperm[b, :s]])
        assert (gap[differ] < 1e-5).all()
        assert (np.diff(keys[perm[b, :s]]) > -1e-5).all()


@pytest.mark.parametrize("ladder", [(), (1, 8), (4,)])
def test_sorted_matches_jax_and_kernel_1(params, ladder):
    jp, pp = params
    o, d, active = _rays("huge", seed=2)
    jss = jseg.sorted_cull_state(
        jnp.asarray(active), tuple(jnp.asarray(x) for x in o), *jp[:4],
        rows=ROWS)
    want = jseg.segment_closest_hit_sorted(
        _planes(o, d, jnp), *jp[:4], jss, T_MIN, rows=ROWS,
        active=jnp.asarray(active), ladder=ladder)
    pss = pseg.sortstate_from_numpy(*_np(jss), device="cpu")
    pact = torch.from_numpy(active)
    got = pseg.segment_closest_hit_sorted(
        _planes(o, d, torch), *pp[:4], pss, T_MIN, rows=ROWS, active=pact,
        ladder=ladder)
    _check(_np(got), _np(want), np.asarray(jp[3]), active)
    base = pseg.segment_closest_hit(_planes(o, d, torch), *pp[:4], T_MIN,
                                    active=pact)
    for g, b in zip(got, base):
        np.testing.assert_array_equal(g.numpy(), b.numpy())


def test_sorted_ties_keep_the_earliest_in_sorted_order():
    """Every sphere twice: kernel 1 keeps the lower id, the sorted kernel
    the copy that comes first in perm -- here made the HIGHER id."""
    psc = pscene.simple_scene_cuda(device="cpu")
    cx, cy, cz, r = (torch.cat([p, p]) for p in
                     pseg.sphere_params_from_scene(psc)[:4])
    s = cx.shape[0]
    o, d, _ = _rays("simple", seed=4)
    rays = _planes(o, d, torch)
    order = list(range(s // 2, s)) + list(range(s // 2))
    perm = np.array([order + [s] * (-s % 8)] * NB, np.int32)
    n_chunks = perm.shape[1] // 8
    ss = pseg.sortstate_from_numpy(
        perm, np.full((NB, n_chunks + 1), -1e30, np.float32),
        np.zeros((NB, 3), np.float32), np.array([1e3, -1e3], np.float32),
        device="cpu")
    got = pseg.segment_closest_hit_sorted(rays, cx, cy, cz, r, ss, T_MIN,
                                          rows=ROWS)
    base = pseg.segment_closest_hit(rays, cx, cy, cz, r, T_MIN)
    hm = base[0].numpy() > 0
    assert hm.sum() > 100
    np.testing.assert_array_equal(got[1].numpy(), base[1].numpy())
    assert (base[2].numpy()[hm] < s // 2).all()
    np.testing.assert_array_equal(got[2].numpy()[hm],
                                  base[2].numpy()[hm] + s // 2)


def test_ladder_points():
    assert pseg.ladder_points((8, 1, 1, 0, 99, 62), 62) == [1, 8]
    assert pseg.ladder_points((), 62) == []


@pytest.mark.parametrize("scene_name", ["simple", "huge"])
def test_mxu_matches_jax_and_kernel_1(scene_name):
    jsc = {"huge": lambda: jscene.huge_scene(0),
           "simple": jscene.simple_scene_cuda}[scene_name]()
    psc = {"huge": lambda: pscene.huge_scene(0, device="cpu"),
           "simple": lambda: pscene.simple_scene_cuda(device="cpu")
           }[scene_name]()
    jp = jseg.sphere_params_from_scene(jsc)
    pp = pseg.sphere_params_from_scene(psc)
    o, d, active = _rays(scene_name, seed=6)
    pact = torch.from_numpy(active)
    got = pseg.segment_closest_hit_mxu(_planes(o, d, torch), *pp[:4], T_MIN,
                                       active=pact)
    want = jseg.segment_closest_hit_mxu(_planes(o, d, jnp), *jp[:4], T_MIN,
                                        rb=256, active=jnp.asarray(active))
    radii = np.asarray(jp[3])
    base = pseg.segment_closest_hit(_planes(o, d, torch), *pp[:4], T_MIN,
                                    active=pact)
    # (the JAX kernel computes inactive lanes of an active block like any
    # other; the port's convention is (0, 1e30, 0))
    (gh, gt, gs) = _np(got)
    assert (gs[gh == 0] == 0).all() and (gt[gh == 0] == 1e30).all()
    for (wh, wt, ws), med, p99, top in ((_np(want), 2e-6, 1e-3, 5e-3),
                                        (_np(base), 5e-5, 2e-3, 1e-2)):
        both = active & (gh > 0) & (wh > 0)
        differ = active & ((gh != wh) | (both & (gs != ws)))
        assert differ.sum() <= 1e-3 * active.sum(), int(differ.sum())
        agree = both & (gs == ws)
        assert agree.sum() > 0.2 * active.sum()
        rel = (np.abs(gt - wt) / np.abs(wt))[
            agree & (np.abs(radii[np.where(agree, ws, 0)]) < 100)]
        assert np.median(rel) <= med and rel.max() <= top
        assert np.percentile(rel, 99) <= p99


def test_closest_hit_planar_dispatch(params, monkeypatch):
    _, pp = params
    o, d, active = _rays("huge", seed=7)
    rays, pact = _planes(o, d, torch), torch.from_numpy(active)
    sub = pseg.closest_hit_planar(rays, *pp[:4], T_MIN, active=pact)
    mxu = pseg.closest_hit_planar(rays, *pp[:4], T_MIN, active=pact,
                                  kernel="mxu")
    want = pseg.segment_closest_hit_mxu_reference(rays, *pp[:4], T_MIN, pact)
    for g, w in zip(mxu, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert not all(bool((a == b).all()) for a, b in zip(mxu, sub))
    # above MXU_MAX_SPHERES "mxu" means the sublane kernel, as in JAX
    assert pseg.MXU_MAX_SPHERES == jseg.MXU_MAX_SPHERES
    monkeypatch.setattr(pseg, "MXU_MAX_SPHERES", 100)
    big = pseg.closest_hit_planar(rays, *pp[:4], T_MIN, active=pact,
                                  kernel="mxu")
    for g, w in zip(big, sub):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    with pytest.raises(ValueError, match="at most"):
        pseg.segment_closest_hit_mxu(rays, *pp[:4], T_MIN)
    with pytest.raises(ValueError, match="unknown hit_kernel"):
        pseg.closest_hit_planar(rays, *pp[:4], T_MIN, kernel="bvh")


@pytest.mark.parametrize("hit_kernel", ["sublane", "mxu"])
def test_trace_segment_matches_jax(params, hit_kernel):
    jp, pp = params
    o, d, active = _rays("huge", seed=8)
    want = jseg.trace_segment(_planes(o, d, jnp), jp, T_MIN, rows=ROWS,
                              active=jnp.asarray(active),
                              hit_kernel=hit_kernel)
    got = pseg.trace_segment(_planes(o, d, torch), pp, T_MIN,
                             active=torch.from_numpy(active),
                             hit_kernel=hit_kernel)
    _check_segment(got, want, active, np.asarray(jp[3]))


def test_trace_segment_list_matches_jax(params):
    jp, pp = params
    o, d, active = _rays("huge", seed=9)
    counts, lists = _full_lists(pp[0].shape[0])
    want = jseg.trace_segment_list(
        _planes(o, d, jnp), jp, jnp.asarray(counts), jnp.asarray(lists),
        T_MIN, rows=ROWS, active=jnp.asarray(active))
    got = pseg.trace_segment_list(
        _planes(o, d, torch), pp, torch.from_numpy(counts),
        torch.from_numpy(lists), T_MIN, rows=ROWS,
        active=torch.from_numpy(active))
    _check_segment(got, want, active, np.asarray(jp[3]))


def _check_segment(got, want, active, radii):
    """The segment dicts plane by plane, on the lanes where both packages
    hit the same ordinary sphere (material planes are table values: equal;
    hit point 1e-4 of the scene's size; normal 2e-3, the hit point's error
    over a radius of 0.2)."""
    assert set(got) == set(want)
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    both = active & (got["hit"] > 0) & (want["hit"] > 0)
    same = both & (got["mt"] == want["mt"]) & (got["ar"] == want["ar"]) \
        & (got["io"] == want["io"]) & (got["fz"] == want["fz"])
    assert same.sum() >= 0.995 * both.sum() and both.sum() > 200
    for k in ("ag", "ab"):
        np.testing.assert_array_equal(got[k][same], want[k][same])
    near = same & (np.abs(got["t"] - want["t"]) <= 1e-4 * np.abs(want["t"]))
    assert near.sum() >= 0.8 * same.sum()
    for k in ("px", "py", "pz"):
        np.testing.assert_allclose(got[k][near], want[k][near], rtol=1e-4,
                                   atol=2e-3)
    assert got["mt"].dtype == np.int32 and got["hit"].dtype == np.int32


def test_constants_equal():
    assert pseg.UNROLL == jseg.UNROLL and pseg.LANES == jseg.LANES
    assert pseg._SORT_KEY_MARGIN == jseg._SORT_KEY_MARGIN
    assert N == R * 128


def test_group_scene_matches_jax(params):
    jp, pp = params
    jsorted, jgroups = jseg.group_scene(jp)
    psorted, pgroups = pseg.group_scene(pp)
    assert len(psorted) == 10 and psorted[0].shape[0] % pseg.GROUP == 0
    for a, b, c in zip(psorted, jsorted, pp):
        assert a.dtype == c.dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(pgroups, jgroups):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    perm = pseg.group_order(pp).numpy()
    s = pp[0].shape[0]
    assert sorted(perm.tolist()) == list(range(s))
    for a, b in zip(psorted, pp):  # the sorted params are a permutation
        np.testing.assert_array_equal(a.numpy()[:s], b.numpy()[perm])
    # every sphere lies inside its group's bound
    cx, cy, cz, r = (x.numpy().reshape(-1, pseg.GROUP) for x in psorted[:4])
    gx, gy, gz, gr = (g.numpy()[:, None] for g in pgroups)
    dist = np.sqrt((cx - gx) ** 2 + (cy - gy) ** 2 + (cz - gz) ** 2)
    assert (dist + np.abs(r) <= gr * (1 + 1e-6)).all()


def _jax_test_rays(mod):
    """The rays of tests/test_pallas_intersect.py's grouped test."""
    rng = np.random.default_rng(5)
    rays = [rng.normal(size=(8, 128)).astype(np.float32) for _ in range(6)]
    if mod is torch:
        return tuple(torch.from_numpy(x) for x in rays)
    return tuple(jnp.asarray(x) for x in rays)


def _grouped_vs_ungrouped(got, want, active=None):
    """tests/test_pallas_intersect.py's assertions between a grouped and an
    ungrouped segment (on the active lanes)."""
    got = {k: np.asarray(v) for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    act = np.ones_like(got["hit"], bool) if active is None else active
    np.testing.assert_array_equal(got["hit"][act], want["hit"][act])
    hit = act & (want["hit"] > 0)
    assert hit.sum() > 100
    np.testing.assert_allclose(got["t"][hit], want["t"][hit], rtol=2e-4,
                               atol=1e-3)
    for k in ("ar", "ag", "ab", "fz", "io", "mt"):
        np.testing.assert_array_equal(got[k][hit], want[k][hit], k)


def test_grouped_matches_jax_and_the_ungrouped_segment(params):
    jp, pp = params
    jsorted, jgroups = jseg.group_scene(jp)
    psorted, pgroups = pseg.group_scene(pp)
    want = jseg.trace_segment(_jax_test_rays(jnp), jp, T_MIN, rows=8)
    want_g = jseg.trace_segment(_jax_test_rays(jnp), jsorted, T_MIN, rows=8,
                                group_params=jgroups)
    got = pseg.trace_segment(_jax_test_rays(torch), psorted, T_MIN,
                             group_params=pgroups)
    _grouped_vs_ungrouped(got, want)
    _grouped_vs_ungrouped(got, want_g)
    # the port's own ungrouped segment on the unsorted scene
    _grouped_vs_ungrouped(got, pseg.trace_segment(_jax_test_rays(torch), pp,
                                                  T_MIN))


def test_grouped_on_engine_like_rays_with_an_active_plane(params):
    """Camera rays and ground restarts (tests/test_torch_segment.py's rays)
    with inactive lanes and a wholly inactive block: the port's convention
    on inactive lanes, kernel 1's hits, and the plain t-space loop's bits
    (the sphere index mapped back through the sort)."""
    _jp, pp = params
    psorted, pgroups = pseg.group_scene(pp)
    o, d, active = _rays("huge", seed=12)
    act = torch.from_numpy(active)
    hit, t, sb = pseg.segment_closest_hit_grouped(
        _planes(o, d, torch), *psorted[:4], pgroups, T_MIN, active=act)
    assert not hit.numpy()[~active].any()
    assert (t.numpy()[~active] == np.float32(1e30)).all()
    assert not sb.numpy()[~active].any()
    from raytracinginoneweekend_tpu_torch.ops.intersect import closest_hit
    o3 = torch.from_numpy(o.reshape(3, -1).T.copy())
    d3 = torch.from_numpy(d.reshape(3, -1).T.copy())
    t_ref, i_ref, h_ref = closest_hit(
        o3, d3, torch.stack(psorted[:3], dim=1), psorted[3], T_MIN)
    flat = active.reshape(-1)
    np.testing.assert_array_equal(hit.numpy().reshape(-1)[flat],
                                  h_ref.numpy()[flat])
    np.testing.assert_array_equal(t.numpy().reshape(-1)[flat],
                                  t_ref.numpy()[flat])
    np.testing.assert_array_equal(sb.numpy().reshape(-1)[flat],
                                  i_ref.numpy()[flat])
    h1, t1, s1 = pseg.segment_closest_hit(_planes(o, d, torch), *pp[:4],
                                          T_MIN, active=act)
    both = active & (hit.numpy() > 0) & (h1.numpy() > 0)
    differ = active & (hit.numpy() != h1.numpy())
    assert differ.sum() <= 1e-3 * active.sum(), int(differ.sum())
    perm = pseg.group_order(pp).numpy()
    same = both & (perm[np.minimum(sb.numpy(), perm.size - 1)] == s1.numpy())
    assert same.sum() >= 0.999 * both.sum()
    np.testing.assert_allclose(t.numpy()[same], t1.numpy()[same], rtol=2e-4,
                               atol=1e-3)


def test_grouped_refuses_what_the_kernel_does_not_take(params):
    _jp, pp = params
    psorted, pgroups = pseg.group_scene(pp)
    rays = _jax_test_rays(torch)
    with pytest.raises(ValueError, match="multiple of 16"):
        pseg.segment_closest_hit_grouped(rays, *pp[:4], pgroups, T_MIN)
    with pytest.raises(ValueError, match="gx"):
        pseg.segment_closest_hit_grouped(
            rays, *psorted[:4], (pgroups[0][:3],) + pgroups[1:], T_MIN)
    with pytest.raises(ValueError, match="CUDA only"):
        pseg.segment_closest_hit_grouped(
            rays, *psorted[:4], pgroups, T_MIN,
            stats=torch.zeros(2, dtype=torch.int64))
    assert pseg.GROUP == jseg.GROUP
