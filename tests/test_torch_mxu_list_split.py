"""The split loops of the regrouped-products closest hit
(``csrc/closest_hit_mxu.cu``) and of the cull-list closest hit
(``csrc/closest_hit_list.cu``), in plain terms.

Both kernels split a ray's loop over K threads and take the square root
only where the discriminant is >= 0; the mxu kernel reduces its K partials
over (q, sphere index), the list kernel over (q, POSITION in the cull
block's list), mapping only the winning position through the list. A CUDA
kernel cannot run here; ``chip_smoke.py`` holds both to the bit against
their plain versions on the card at every K. These tests hold what the CPU
can reach, with no tolerance (every comparison is exact):
  * ``closest_hit_checks.mxu_guarded``, the guarded regrouped candidate,
    reduced by the first least index, is the plain mxu version
    (``segment_closest_hit_mxu_reference``) bit for bit, on
    ``ties_and_grazes`` (also against its exact answers and the JAX mxu
    kernel in interpret mode) and on a huge-scene mid-frame lane state;
  * ``closest_hit_checks.split_min`` over the sphere index on those
    candidates is the plain mxu version at every K;
  * ``closest_hit_checks.list_split`` -- the list kernel's partition of
    list positions and reduce over (q, position) -- is the plain list
    version (``segment_closest_hit_list_reference``) at every K, on lists
    with planted exact ties whose list order and id order disagree, pad
    entries, an empty list and a block with no active lane (where a reduce
    over (q, sphere id) gives another sphere), and on the cone cull's real
    lists of the huge scene;
  * the K each wrapper picks at 16384, 32768 and 2^20 lanes, and the
    checking of ``split=``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracinginoneweekend_tpu_torch as rt
from raytracinginoneweekend_tpu.ops import pallas_segment as jseg
from raytracinginoneweekend_tpu_torch import closest_hit_checks as chk
from raytracinginoneweekend_tpu_torch.ops import cuda_segment as pseg
from raytracinginoneweekend_tpu_torch.ops import cull
from test_torch_segment import T_MIN
from test_torch_sorted_split import _mid_frame

torch.set_num_threads(2)  # several test workers share the machine's cores

SPLITS = (1, 2, 4, 8, 16, 32)
BIG = np.float32(1e30)
H100_SMS = 132


def _mxu_case(name):
    """(rays, (cx, cy, cz, r), t_min, active) of one mxu case."""
    if name == "ties_and_grazes":
        rays, geom, t_min, _ = chk.ties_and_grazes(torch.device("cpu"))
        return rays, geom, t_min, None
    eng, state = _mid_frame(rt.DEFAULT)
    return tuple(state[4:10]), eng.sphere_params[:4], eng.t_min, state[3]


@pytest.fixture(scope="module")
def mxu_cases():
    return {name: _mxu_case(name) for name in ("ties_and_grazes",
                                               "huge_mid_frame")}


def _mxu_candidates(rays, geom, t_min, active):
    """The active lanes' guarded regrouped candidates, (lanes, spheres),
    with each lane's a and its index in the plane."""
    sel = torch.arange(rays[0].numel())
    if active is not None:
        sel = (active.reshape(-1) > 0).nonzero().squeeze(1)
    x, y, z, vx, vy, vz = (p.reshape(-1)[sel][:, None] for p in rays)
    a = vx * vx + vy * vy + vz * vz
    tab = pseg.mxu_table(*geom)
    q = chk.mxu_guarded(x, y, z, vx, vy, vz, a, torch.tensor(
        t_min, dtype=torch.float32) * a, *(tab[None, :, c] for c in range(4)))
    return q, a[:, 0], sel


def _as_planes(q_b, s_b, a, sel, shape):
    """Per-lane (q, index) of the active lanes -> (hit, t, sb) planes with
    the mxu kernel's epilogue: t = q / a, inactive lanes (0, 1e30, 0)."""
    q_b = torch.as_tensor(q_b)
    h = q_b < float(BIG)
    hit = torch.zeros(shape, dtype=torch.int32).reshape(-1)
    t = torch.full(shape, float(BIG)).reshape(-1)
    sb = torch.zeros(shape, dtype=torch.int32).reshape(-1)
    hit[sel] = h.to(torch.int32)
    t[sel] = torch.where(h, q_b / a, torch.full_like(q_b, float(BIG)))
    sb[sel] = torch.where(h, torch.as_tensor(s_b).to(torch.int32),
                          torch.zeros_like(sel, dtype=torch.int32))
    return hit.reshape(shape), t.reshape(shape), sb.reshape(shape)


@pytest.mark.parametrize("case", ["ties_and_grazes", "huge_mid_frame"])
def test_mxu_guarded_candidate_is_the_plain_mxu(mxu_cases, case):
    rays, geom, t_min, active = mxu_cases[case]
    q, a, sel = _mxu_candidates(rays, geom, t_min, active)
    q_b, s_b = torch.min(q, dim=1)  # the first least index
    got = _as_planes(q_b, s_b, a, sel, rays[0].shape)
    want = pseg.segment_closest_hit_mxu_reference(rays, *geom, t_min, active)
    assert not any(chk.bit_diff(got, want).values())
    assert 0 < int(want[0].sum()) < want[0].numel()
    if case == "ties_and_grazes":
        exact = chk.ties_and_grazes(torch.device("cpu"))[3]
        assert not any(chk.bit_diff(want, exact).values())


def test_mxu_ties_and_grazes_against_jax(mxu_cases):
    """The exact answers through the JAX mxu kernel (Pallas in interpret
    mode): the regrouped products of these small numbers are exact too."""
    rays, geom, t_min, _ = mxu_cases["ties_and_grazes"]
    got = pseg.segment_closest_hit_mxu(rays, *geom, t_min)
    jgot = jseg.segment_closest_hit_mxu(
        tuple(jnp.asarray(p.numpy()) for p in rays),
        *(jnp.asarray(p.numpy()) for p in geom), t_min, rb=256)
    for g, j in zip(got, jgot):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


@pytest.mark.parametrize("case", ["ties_and_grazes", "huge_mid_frame"])
@pytest.mark.parametrize("k", SPLITS)
def test_mxu_split_is_the_plain_mxu(mxu_cases, case, k):
    rays, geom, t_min, active = mxu_cases[case]
    q, a, sel = _mxu_candidates(rays, geom, t_min, active)
    q_b, s_b = chk.split_min(q.numpy(), k)
    got = _as_planes(q_b, s_b, a, sel, rays[0].shape)
    want = pseg.segment_closest_hit_mxu_reference(rays, *geom, t_min, active)
    assert not any(chk.bit_diff(got, want).values())


def test_mxu_disc_pairs_regrouped(mxu_cases):
    """The mxu kernel's count of pairs that reach its sqrt: its own
    arithmetic, exact on ties_and_grazes (the same pairs as kernel 1's)."""
    rays, geom, _, _ = mxu_cases["ties_and_grazes"]
    assert chk.disc_pairs(rays, *geom, regrouped=True) == chk.disc_pairs(
        rays, *geom)
    rays, geom, t_min, active = mxu_cases["huge_mid_frame"]
    q, _, _ = _mxu_candidates(rays, geom, t_min, active)
    n_ge, n_pairs = chk.disc_pairs(rays, *geom, active, chunk=100,
                                   regrouped=True)
    assert n_pairs == q.numel() and n_ge >= int((q < float(BIG)).sum()) > 0


# --------------------------------------------------------------------- #
# closest_hit_list
# --------------------------------------------------------------------- #

LIST_ROWS = 2  # cull blocks of 256 lanes: ties_and_grazes' 1024 are four


def _planted_list_case():
    """``ties_and_grazes`` with ``closest_hit_checks.ties_and_grazes_lists``
    (descending and shuffled lists, pad entries, an empty list, a block
    with no active lane)."""
    rays, geom, t_min, _ = chk.ties_and_grazes(torch.device("cpu"))
    counts, lists, act = chk.ties_and_grazes_lists(torch.device("cpu"),
                                                   LIST_ROWS)
    return rays, geom, t_min, counts, lists, act


def _real_list_case():
    """The cone cull's lists (ops/cull.py) of coherent rays among the huge
    scene's spheres: four cull blocks of 8 rows, each a bundle from the
    cover camera's eye towards its own patch of the scene (a narrow cone,
    so a short list), a sixth of the lanes inactive, and the last block
    with no active lane."""
    g = np.random.default_rng(4)
    rows, nb = 8, 4
    lanes = rows * 128
    eye = np.array([13.0, 2.0, 3.0], np.float32)
    o, d = [], []
    for _ in range(nb):
        patch = np.array([g.uniform(-6, 6), g.uniform(0, 1),
                          g.uniform(-6, 6)], np.float32)
        tgt = patch[:, None] + g.uniform(-0.4, 0.4, (3, lanes))
        o.append(eye[:, None] + g.normal(size=(3, lanes)) * 0.01)
        d.append(tgt - o[-1])
    o = np.concatenate(o, 1).astype(np.float32)
    d = np.concatenate(d, 1).astype(np.float32)
    rays = tuple(torch.from_numpy(x.reshape(nb * rows, 128).copy())
                 for x in (*o, *d))
    active = (g.random((nb, lanes)) < 0.85).astype(np.int32)
    active[-1] = 0
    act = torch.from_numpy(active.reshape(nb * rows, 128))
    eng, _ = _mid_frame(rt.DEFAULT, steps=0)
    geom = eng.sphere_params[:4]
    stats = cull.block_cone_stats(act, rays, rows)
    counts, lists = cull.candidate_lists(stats, *geom, T_MIN)
    return rays, geom, T_MIN, counts, lists, act, rows


@pytest.fixture(scope="module")
def list_cases():
    return {"planted_ties": _planted_list_case() + (LIST_ROWS,),
            "real_lists": _real_list_case()}


@pytest.mark.parametrize("case", ["planted_ties", "real_lists"])
@pytest.mark.parametrize("k", SPLITS)
def test_list_split_is_the_plain_list(list_cases, case, k):
    rays, geom, t_min, counts, lists, act, rows = list_cases[case]
    want = pseg.segment_closest_hit_list_reference(
        rays, *geom, counts, lists, t_min, rows, act)
    got = chk.list_split(rays, *geom, counts, lists, t_min, rows, act, k)
    assert not any(chk.bit_diff(got, want).values())
    hit = want[0].reshape(-1, rows * 128)
    assert int(hit.sum()) > 0
    if case == "planted_ties":
        # block 0: a tied pair's later id wins (its earlier list position);
        # blocks 2 (empty list) and 3 (no active lane) miss everywhere
        kind = np.arange(hit.shape[1]) % 11
        sb0 = want[2].reshape(4, -1)[0].numpy()
        on = (kind < 9) & (act.reshape(4, -1)[0].numpy() > 0)
        np.testing.assert_array_equal(
            sb0[on], np.array([p[1] for p in chk.TIE_PAIRS])[kind[on]])
        assert int(hit[2:].sum()) == 0
        assert bool((want[1].reshape(4, -1)[2:] == float(BIG)).all())
    else:
        assert int(counts[-1]) == 0  # the block with no active lane
        assert 0 < int(counts.max()) < lists.shape[1] // 4


@pytest.mark.parametrize("k", SPLITS[1:])
def test_list_reduce_over_sphere_ids_would_differ(list_cases, k):
    """Reduced over (q, sphere id), the planted ties of block 0 -- pairs 1
    to 32 list positions apart -- give the earlier id, not the earlier list
    position, for every K > 1: the position is the tie key."""
    rays, geom, t_min, counts, lists, act, rows = list_cases["planted_ties"]
    s = geom[0].shape[0]
    x, y, z, vx, vy, vz = (p.reshape(4, -1)[0][:, None] for p in rays)
    a = vx * vx + vy * vy + vz * vz
    ids = lists[0, :int(counts[0])].to(torch.int64)
    tab = pseg.hit_table_padded(*geom)[ids]
    q = chk.guarded(x, y, z, vx, vy, vz, a, torch.tensor(
        t_min, dtype=torch.float32) * a, *(tab[None, :, c] for c in range(4)))
    _, pos = chk.split_min(q.numpy(), k)
    _, by_id = chk.split_min(q.numpy(), k, key=ids.numpy())
    assert (ids.numpy()[pos] != by_id).any()
    assert (by_id <= s).all()


@pytest.mark.parametrize("n_lanes,mxu_k,list_k", [
    (16384, 16, 8), (1 << 15, 8, 4), (1 << 20, 1, 1)])
def test_split_pickers_of_the_mxu_and_list_kernels(n_lanes, mxu_k, list_k):
    """The K each wrapper launches with on an H100's 132 SMs: closest_hit's
    picker aimed at the target each kernel's own K sweep chose."""
    assert pseg.MXU_THREADS_PER_SM in (pseg.CH_THREADS_PER_SM,
                                       pseg.SPLIT_THREADS_PER_SM)
    assert pseg.LIST_THREADS_PER_SM in (pseg.CH_THREADS_PER_SM,
                                        pseg.SPLIT_THREADS_PER_SM)
    assert pseg.closest_hit_split(n_lanes, H100_SMS,
                                  pseg.MXU_THREADS_PER_SM) == mxu_k
    assert pseg.closest_hit_split(n_lanes, H100_SMS,
                                  pseg.LIST_THREADS_PER_SM) == list_k


def test_split_keyword_checked(mxu_cases, list_cases):
    """``split=`` forces the K of both kernels (for measuring); on the CPU
    every K is the plain version, and a K the kernels lack raises."""
    rays, geom, t_min, active = mxu_cases["ties_and_grazes"]
    with pytest.raises(ValueError, match="split"):
        pseg.segment_closest_hit_mxu(rays, *geom, t_min, split=3)
    want = pseg.segment_closest_hit_mxu_reference(rays, *geom, t_min)
    rays_l, geom_l, t_l, counts, lists, act, rows = list_cases[
        "planted_ties"]
    with pytest.raises(ValueError, match="split"):
        pseg.segment_closest_hit_list(rays_l, *geom_l, counts, lists, t_l,
                                      rows=rows, active=act, split=64)
    want_l = pseg.segment_closest_hit_list_reference(
        rays_l, *geom_l, counts, lists, t_l, rows, act)
    for k in (1, 32):
        got = pseg.segment_closest_hit_mxu(rays, *geom, t_min, split=k)
        assert not any(chk.bit_diff(got, want).values())
        got_l = pseg.segment_closest_hit_list(
            rays_l, *geom_l, counts, lists, t_l, rows=rows, active=act,
            split=k)
        assert not any(chk.bit_diff(got_l, want_l).values())
