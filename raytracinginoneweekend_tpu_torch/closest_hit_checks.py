"""Check cases, counts and plain emulations for the split-loop closest-hit
kernels (``csrc/closest_hit.cu``, ``csrc/closest_hit_sorted.cu``,
``csrc/closest_hit_mxu.cu``, ``csrc/closest_hit_list.cu``, the loop of
``csrc/mega_bounce.cu``, and the two t-space kernels ``csrc/intersect.cu``
and ``csrc/closest_hit_grouped.cu``).

``chip_smoke.py`` holds the kernels against them on the card and
``tests/test_torch_closest_hit_split.py``, ``tests/test_torch_sorted_
split.py``, ``tests/test_torch_mxu_list_split.py`` and
``tests/test_torch_tspace_split.py`` on the CPU:
  * ``ties_and_grazes``: a small sphere table of its own whose answers are
    exact in float32 -- duplicate spheres split across the kernel's K-way
    partitions, an exact graze, a ray that misses everything -- and
    ``ties_and_grazes_lists``, cull lists for it whose order runs against
    the ids; ``tspace_ties_and_grazes``, its t-space counterpart for the
    (N, 3) intersect kernel (exact tangents, which t-space counts as
    misses, roots on and across t_min, a hollow shell);
  * ``bit_diff``: where two (hit, t, sb) results differ at all;
  * ``disc_pairs``: how many (lane, sphere) pairs of an input reach the
    kernel's square root (discriminant >= 0, or > 0 with ``strict`` for
    the t-space kernels; ``regrouped`` for the mxu kernel's arithmetic).
    The rest stop after the discriminant and its compare, so the count
    gives the work that input needs, from which ``chip_smoke.py`` states a
    second bound;
  * ``mxu_guarded``: the mxu kernel's regrouped candidate with the square
    root only where its discriminant is >= 0 (``rtw_mxu_guarded``);
  * ``guarded_t``: the t-space candidate with the square root only where
    the discriminant is > 0 (``rtw_closest_t_guarded``);
  * ``split_min``: the K-way partition of a ray's scan and the warp
    shuffles' lexicographic reduce, in numpy, over any tie key (the
    sphere index of closest_hit and mega_bounce, the position in the
    sorted order of closest_hit_sorted);
  * ``sorted_split``: closest_hit_sorted as a whole -- its exit terms, the
    stage vote of every thread over a warp of 32 / K rays, the partition
    and the reduce over (q, position) -- in plain PyTorch and numpy, with
    its count of skipped chunks;
  * ``list_split``: closest_hit_list as a whole -- the guarded candidate
    over each cull block's list, the partition of list positions and the
    reduce over (q, position), the winner mapped through the list;
  * ``grouped_split``: closest_hit_grouped as a whole -- the bound test,
    the vote over a warp of 32 / K rays, each group's 16 spheres split
    over K threads and the reduce over (t, sorted index) -- with its count
    of skipped group tests.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.math3 import sqrt_rn

BIG = np.float32(1e30)
WARP = 32

# ties_and_grazes: pairs of identical spheres (first index, second index).
# The second copy sits 1, 2, 4, 8, 16 or 32 places later, so for every K of
# closest_hit's split loop some pair lies in two partitions -- (7, 8) puts
# the later copy in thread 0 of a group of 8 and the earlier in thread 7 --
# and some in one.
TIE_PAIRS = ((5, 6), (7, 8), (15, 16), (31, 32), (20, 22), (40, 44),
             (48, 56), (57, 73), (60, 92))
TIE_SPHERES = 96
GRAZE_SPHERE = 3


def ties_and_grazes(device, rows: int = 8):
    """closest_hit's synthetic case on a small table of its own -> (rays,
    (cx, cy, cz, r), t_min, (hit, t, sb) expected), all on ``device``.

    Every number is small and exact in float32, so the expected results
    are exact whatever the order of the sums: each ray of kind i < 9 flies
    along +z at TIE_PAIRS[i]'s sphere (r = 0.5, 10 + m units ahead; |d| 1
    or 2) and hits it at q = |d| (10 + m) - |d| / 2, the earlier copy's
    index winning; kind 9 grazes the unit sphere at the origin (o = (-5, 1,
    0), d along +x: disc = 25 - 25 = 0 exactly, a hit at t = 5 / |d|);
    kind 10 starts above it pointing up and misses everything (sb 0). The
    other spheres lie far below every ray's line."""
    n_lanes = rows * 128
    cx = [float(i) for i in range(TIE_SPHERES)]
    cy = [-100.0] * TIE_SPHERES
    cz = [-100.0] * TIE_SPHERES
    r = [0.25] * TIE_SPHERES
    cx[GRAZE_SPHERE], cy[GRAZE_SPHERE], cz[GRAZE_SPHERE] = 0.0, 0.0, 0.0
    r[GRAZE_SPHERE] = 1.0
    for i, pair in enumerate(TIE_PAIRS):
        for s in pair:
            cx[s], cy[s], cz[s], r[s] = 10.0 + 3 * i, 0.0, 30.0, 0.5
    o, d, want = [], [], []
    for lane in range(n_lanes):
        kind, m = lane % 11, (lane // 11) % 4
        v = 1.0 + m % 2
        if kind < len(TIE_PAIRS):
            o.append((10.0 + 3 * kind, 0.0, 20.0 - m))
            d.append((0.0, 0.0, v))
            want.append((1, (v * (10 + m) - v / 2) / (v * v),
                         TIE_PAIRS[kind][0]))
        elif kind == 9:
            o.append((-5.0, 1.0, 0.0))
            d.append((v, 0.0, 0.0))
            want.append((1, 5.0 / v, GRAZE_SPHERE))
        else:
            o.append((0.0, 100.0, 0.0))
            d.append((0.0, v, 0.0))
            want.append((0, 1e30, 0))

    def planes(rows_of, col, dtype=torch.float32):
        return torch.tensor([x[col] for x in rows_of], dtype=dtype).reshape(
            rows, 128).contiguous().to(device)

    rays = tuple(planes(src, c) for src in (o, d) for c in range(3))
    geom = tuple(torch.tensor(x, dtype=torch.float32, device=device)
                 for x in (cx, cy, cz, r))
    expect = (planes(want, 0, torch.int32), planes(want, 1),
              planes(want, 2, torch.int32))
    return rays, geom, 0.008, expect


def ties_and_grazes_lists(device, rows: int = 2):
    """Cull lists for ``ties_and_grazes`` (its 1024 lanes as four cull
    blocks of ``rows`` = 2 rows) -> (counts, lists, active) on ``device``:
    block 0 lists every sphere in DESCENDING id order -- each tied pair's
    later copy first, 1 to 32 positions before the earlier one -- with pad
    entries (id S) among them and past its count; block 1 every sphere in
    a random order; block 2 an empty list; block 3 no active lane. A few
    lanes of blocks 0-2 are inactive too. The list kernel keeps the
    earliest list POSITION on a tie, so block 0's tied rays get the later
    id (``TIE_PAIRS[i][1]``)."""
    s, nb = TIE_SPHERES, 4
    g = np.random.default_rng(11)
    width = s + 8
    lists = np.full((nb, width), s, np.int32)
    desc = list(range(s - 1, -1, -1))
    for at in (0, 17, 50):
        desc.insert(at, s)
    lists[0, :len(desc)] = desc
    lists[1, :s] = g.permutation(s)
    lists[2] = g.permutation(width).clip(max=s)
    lists[3] = lists[1]
    counts = np.array([len(desc) + 2, s, 0, s], np.int32)
    active = np.ones((nb, rows * 128), np.int32)
    active[3] = 0
    active[:3, 5::37] = 0
    return (torch.from_numpy(counts).to(device),
            torch.from_numpy(lists).to(device),
            torch.from_numpy(active.reshape(nb * rows, 128)).to(device))


# tspace_ties_and_grazes: the extra spheres of its table. STRADDLE (r = 1)
# is met by rays starting on its surface or 0.25 to 0.75 units before it,
# so that the near root falls below, ON or above t_min = TSPACE_T_MIN;
# GLASS (r = 2) holds the hollow shell GLASS_INNER (r = -1.5), which a ray
# starting at their common centre hits first.
STRADDLE_SPHERE, GLASS_SPHERE, GLASS_INNER = 70, 80, 81
TSPACE_T_MIN = 0.25


def tspace_ties_and_grazes(device, n: int = 1040):
    """The t-space synthetic case of the (N, 3) intersect kernel on
    ``ties_and_grazes``' table with three more spheres -> (origin, direction
    (N, 3), centers (S, 3), radii (S,), t_min, (t, idx, hit) expected), all
    on ``device``.

    Every number is small and exact in float32, so the expected answers
    are exact whatever the order of the sums; each ray kind i (of 13,
    ``lane % 13``) comes at |d| = 1 or 2 and 4 offsets m:
      * i < 9: along +z at TIE_PAIRS[i]'s identical spheres (1 to 32 places
        apart: for every K some pair lies in two threads' partitions),
        hitting the earlier copy at t = (9.5 + m) / |d|;
      * 9: an exact tangent to the unit sphere GRAZE_SPHERE (disc = 25|d|^2
        - 25|d|^2 = 0), which t-space counts as a MISS (and kernel 1's
        q-space loop as a hit), and nothing else on its line;
      * 10: up, missing everything (t 1e30, idx 0);
      * 11: along +z from STRADDLE's surface (near root 0), 0.25 before it
        (near root exactly t_min at |d| = 1: refused, strict `>`), 0.5 or
        0.75 before it (near root past t_min): the far root, the far root,
        the near root, the near root;
      * 12: from the centre of GLASS, hitting its hollow inner shell
        GLASS_INNER (r = -1.5) at t = 1.5 / |d|.
    The other spheres lie far from every ray's line."""
    cx = [float(i) for i in range(TIE_SPHERES)]
    cy = [-100.0] * TIE_SPHERES
    cz = [-100.0] * TIE_SPHERES
    r = [0.25] * TIE_SPHERES
    cx[GRAZE_SPHERE], cy[GRAZE_SPHERE], cz[GRAZE_SPHERE] = 0.0, 0.0, 0.0
    r[GRAZE_SPHERE] = 1.0
    for i, pair in enumerate(TIE_PAIRS):
        for s in pair:
            cx[s], cy[s], cz[s], r[s] = 10.0 + 3 * i, 0.0, 30.0, 0.5
    cx[STRADDLE_SPHERE], cy[STRADDLE_SPHERE], cz[STRADDLE_SPHERE] = (
        100.0, 0.0, 50.0)
    r[STRADDLE_SPHERE] = 1.0
    for s, rad in ((GLASS_SPHERE, 2.0), (GLASS_INNER, -1.5)):
        cx[s], cy[s], cz[s], r[s] = 200.0, 0.0, 50.0, rad
    o, d, want = [], [], []
    for lane in range(n):
        kind, m = lane % 13, (lane // 13) % 4
        v = 1.0 + (lane // 52) % 2
        if kind < len(TIE_PAIRS):
            o.append((10.0 + 3 * kind, 0.0, 20.0 - m))
            d.append((0.0, 0.0, v))
            want.append(((9.5 + m) / v, TIE_PAIRS[kind][0], True))
        elif kind == 9:
            o.append((-5.0, 1.0, 0.0))
            d.append((v, 0.0, 0.0))
            want.append((1e30, 0, False))
        elif kind == 10:
            o.append((0.0, 100.0, 0.0))
            d.append((0.0, v, 0.0))
            want.append((1e30, 0, False))
        elif kind == 11:
            back = 1.0 + 0.25 * m  # from the centre, along -z
            o.append((100.0, 0.0, 50.0 - back))
            d.append((0.0, 0.0, v))
            near, far = back - 1.0, back + 1.0
            want.append(((near if near / v > TSPACE_T_MIN else far) / v,
                         STRADDLE_SPHERE, True))
        else:
            o.append((200.0, 0.0, 50.0))
            d.append((0.0, 0.0, v))
            want.append((1.5 / v, GLASS_INNER, True))

    def f32(rows):
        return torch.tensor(rows, dtype=torch.float32, device=device)

    expect = (f32([w[0] for w in want]),
              torch.tensor([w[1] for w in want], dtype=torch.int32,
                           device=device),
              torch.tensor([w[2] for w in want], device=device))
    return (f32(o), f32(d), f32(list(zip(cx, cy, cz))), f32(r),
            TSPACE_T_MIN, expect)


def bit_diff(got, want) -> dict:
    """Lanes where two (hit, t, sb) results differ at all: the hit flag,
    the sphere index, the bits of t (every lane, inactive ones too)."""
    (hk, tk, sk), (hr, tr, sr) = got, want
    return {"hit_differs": int((hk != hr).sum()),
            "sb_differs": int((sk != sr).sum()),
            "t_bits_differ": int((tk.view(torch.int32)
                                  != tr.view(torch.int32)).sum())}


def disc_pairs(rays, cx, cy, cz, r, active=None, chunk: int = 1 << 15,
               regrouped: bool = False,
               strict: bool = False) -> tuple[int, int]:
    """-> (pairs whose discriminant b*b - a*c is >= 0, or > 0 with
    ``strict``, all pairs) over the active lanes and every sphere, with the
    kernel's float32 arithmetic (rtw_closest_guarded in
    csrc/rtw_common.cuh; with ``regrouped`` the mxu kernel's
    rtw_mxu_guarded; with ``strict`` the t-space kernels'
    rtw_closest_t_guarded, whose discriminant is rtw_closest_guarded's and
    whose guard is `> 0`; a NaN discriminant counts as not reaching the
    square root, as the guards treat it). ``rays`` are six planes, or six
    (N,) columns of (N, 3) rays. Works in slabs of ``chunk`` lanes so the
    (lanes, spheres) intermediates stay bounded."""
    planes = [p.reshape(-1, 1) for p in rays]
    if active is not None:
        act = active if active.dtype == torch.bool else active > 0
        sel = act.reshape(-1).nonzero().squeeze(1)
        planes = [p[sel] for p in planes]
    ox, oy, oz, dx, dy, dz = planes
    rr = (r * r)[None, :]
    cx, cy, cz = cx[None, :], cy[None, :], cz[None, :]
    ccr = cx * cx + cy * cy + cz * cz - rr
    n_ge = 0
    for lo in range(0, ox.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        x, y, z = ox[sl], oy[sl], oz[sl]
        vx, vy, vz = dx[sl], dy[sl], dz[sl]
        a = vx * vx + vy * vy + vz * vz
        if regrouped:
            disc = _mxu_disc(x, y, z, vx, vy, vz, a, cx, cy, cz, ccr)[0]
        else:
            ocx, ocy, ocz = x - cx, y - cy, z - cz
            b = ocx * vx + ocy * vy + ocz * vz
            c = ocx * ocx + ocy * ocy + ocz * ocz - rr
            disc = b * b - a * c
        n_ge += int(((disc > 0) if strict else (disc >= 0)).sum())
    return n_ge, ox.shape[0] * rr.shape[1]


def _mxu_disc(x, y, z, vx, vy, vz, a, cx, cy, cz, ccr):
    """The mxu kernel's regrouped -b and discriminant, broadcast over
    (rays, spheres), in rtw_mxu_guarded's operation order -> (disc,
    -b)."""
    d_o = vx * x + vy * y + vz * z
    o_o = x * x + y * y + z * z
    d_c = vx * cx + vy * cy + vz * cz
    o_c = x * cx + y * cy + z * cz
    bneg = d_c - d_o
    c = (o_o - (o_c + o_c)) + ccr
    return bneg * bneg - a * c, bneg


def mxu_guarded(x, y, z, vx, vy, vz, a, q_min, cx, cy, cz, ccr):
    """rtw_mxu_guarded's candidate (csrc/rtw_common.cuh) broadcast over
    (rays, spheres): the regrouped -b = d.C - d.o and c = (|o|^2 - 2 o.C) +
    (|C|^2 - r^2) (``ccr``, the mxu table's fourth column), then the roots
    and the window only where the discriminant is >= 0, RTW_BIG
    elsewhere."""
    disc, bneg = _mxu_disc(x, y, z, vx, vy, vz, a, cx, cy, cz, ccr)
    pos = disc >= 0
    sq = sqrt_rn(torch.where(pos, disc, torch.ones_like(disc)))
    q0, q1 = bneg - sq, bneg + sq
    big = torch.full_like(q0, float(BIG))
    q = torch.where(q0 > q_min, q0, torch.where(q1 > q_min, q1, big))
    return torch.where(pos, q, big)


def guarded(x, y, z, vx, vy, vz, a, q_min, cx, cy, cz, rr):
    """rtw_closest_guarded's candidate (csrc/rtw_common.cuh) broadcast over
    (rays, spheres): kernel 1's arithmetic, the roots and the window only
    where the discriminant is >= 0, RTW_BIG elsewhere."""
    ocx, ocy, ocz = x - cx, y - cy, z - cz
    b = ocx * vx + ocy * vy + ocz * vz
    c = ocx * ocx + ocy * ocy + ocz * ocz - rr
    disc = b * b - a * c
    pos = disc >= 0
    sq = sqrt_rn(torch.where(pos, disc, torch.ones_like(disc)))
    q0, q1 = -b - sq, -b + sq
    big = torch.full_like(q0, float(BIG))
    q = torch.where(q0 > q_min, q0, torch.where(q1 > q_min, q1, big))
    return torch.where(pos, q, big)


def guarded_t(x, y, z, vx, vy, vz, a, inv_a, t_min, cx, cy, cz, rr):
    """rtw_closest_t_guarded's candidate (csrc/rtw_common.cuh) broadcast
    over (rays, spheres): the t-space arithmetic of the TPU intersect
    kernel, the roots and the window only where the discriminant is > 0,
    RTW_BIG elsewhere; ``inv_a`` = 1 / a, ``rr`` = r * r."""
    ocx, ocy, ocz = x - cx, y - cy, z - cz
    b = ocx * vx + ocy * vy + ocz * vz
    c = ocx * ocx + ocy * ocy + ocz * ocz - rr
    disc = b * b - a * c
    pos = disc > 0
    sq = sqrt_rn(torch.where(pos, disc, torch.ones_like(disc)))
    nb = -b
    t0, t1 = (nb - sq) * inv_a, (nb + sq) * inv_a
    big = torch.full_like(t0, float(BIG))
    t = torch.where(t0 > t_min, t0, torch.where(t1 > t_min, t1, big))
    return torch.where(pos, t, big)


def split_min(q: np.ndarray, k: int, key=None, thread=None):
    """A split-loop kernel's scan of one ray per row, in numpy -> (q_b,
    key_b) per row. ``q`` (n, m) holds the candidates in scan order;
    ``thread[p]`` is the one of the K threads that tests position p (by
    default p % K); ``key[p]`` is what the reduce breaks a tie on (by
    default p). Each thread runs the ascending strict-`<` min over its
    positions from (BIG, 0); then, for offsets K/2 ... 1, every thread
    takes its xor-partner's pair when that is lexicographically smaller
    in (q, key); thread 0's pair is the result."""
    n, m = q.shape
    key = np.arange(m) if key is None else np.asarray(key)
    thread = np.arange(m) % k if thread is None else np.asarray(thread)
    qb = np.full((n, k), BIG, np.float32)
    kb = np.zeros((n, k), np.int64)
    for p in range(m):
        j = thread[p]
        w = q[:, p] < qb[:, j]
        qb[w, j] = q[w, p]
        kb[w, j] = key[p]
    off = k // 2
    while off:
        partner = np.arange(k) ^ off
        oq, ok = qb[:, partner], kb[:, partner]
        take = (oq < qb) | ((oq == qb) & (ok < kb))
        qb, kb = np.where(take, oq, qb), np.where(take, ok, kb)
        off //= 2
    return qb[:, 0], kb[:, 0]


def sorted_split(rays, cx, cy, cz, r, sortstate, t_min, rows: int, active,
                 ladder, k: int):
    """closest_hit_sorted at K threads a ray, step for step, in plain
    PyTorch (float32, the kernel's operation order) and numpy -> ((hit, t,
    sb) planes, (chunks skipped, chunks in all) counted per warp with an
    active lane, as the kernel's ``stats``).

    Per cull block the candidates in perm order; the exit terms (block
    distance and slab exit with their slack); at each stage of the ladder
    each thread's exit on its own best q so far (the min over the
    positions it ran) and a vote over each warp of 32 / K consecutive
    lanes, K threads each; the positions of a stage that runs go to thread
    (p - lo*8) % K, and ``split_min`` reduces over (q, position), which
    maps through perm."""
    from .ops import cuda_segment as seg

    perm, suf, oc, yb = sortstate
    nb, s_pad = perm.shape
    n_chunks = s_pad // seg.UNROLL
    bl_lanes = rows * seg.LANES
    w = WARP // k
    act = (active if active.dtype == torch.bool else active > 0).reshape(
        nb, bl_lanes)
    ox, oy, oz, dx, dy, dz = (p.reshape(nb, bl_lanes) for p in rays)
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a
    q_min = torch.tensor(t_min, dtype=torch.float32) * a
    rsa = 1.0 / torch.sqrt(a)
    blx, bly, blz = ox - oc[:, 0:1], oy - oc[:, 1:2], oz - oc[:, 2:3]
    bl = torch.sqrt(blx * blx + bly * bly + blz * blz)
    bl = bl + (bl * 5e-6 + 1e-4)
    going = dy.abs() > 0
    yexit = torch.where(dy > 0, yb[0], yb[1])
    ex = ((yexit - oy) * (a * rsa)) / torch.where(going, dy,
                                                  torch.ones_like(dy))
    dist_up = torch.where(going, ex + (ex.abs() * 5e-6 + 1e-4),
                          torch.full_like(ex, float(BIG)))
    sky_done = ~act | (dist_up <= 0)
    table = seg.hit_table_padded(cx, cy, cz, r)
    cand = table[perm.to(torch.int64)][:, None]              # (B, 1, S, 4)
    q = seg._candidates(*(v[..., None] for v in (ox, oy, oz, dx, dy, dz, a)),
                        q_min[..., None], *(cand[..., c] for c in range(4)))
    q = torch.where(act[..., None], q, torch.full_like(q, float(BIG)))

    pts = seg.ladder_points(ladder, n_chunks)
    q_thr = torch.full((nb, bl_lanes, k), float(BIG))  # each thread's q
    run_pos = torch.zeros(nb, bl_lanes, s_pad, dtype=torch.bool)
    thread = np.zeros(s_pad, np.int64)
    warp_active = act.reshape(nb, -1, w).any(dim=2)
    skipped = torch.zeros_like(warp_active, dtype=torch.int64)
    lo = 0
    for hi in pts + [n_chunks]:
        p0, p1 = lo * seg.UNROLL, hi * seg.UNROLL
        thread[p0:p1] = np.arange(p1 - p0) % k
        if pts:
            qd = torch.minimum(q_thr * rsa[..., None], dist_up[..., None])
            done = sky_done[..., None] | (qd + bl[..., None]
                                          <= suf[:, lo:lo + 1, None])
            run = ~done.reshape(nb, -1, w * k).all(dim=2)
        else:
            run = torch.ones_like(warp_active)
        skipped += (~run).to(torch.int64) * (hi - lo)
        run_lane = run.repeat_interleave(w, dim=1)
        run_pos[:, :, p0:p1] = run_lane[..., None]
        for j in range(k):
            mine = torch.from_numpy(np.nonzero(thread[p0:p1] == j)[0] + p0)
            if mine.numel():
                q_thr[..., j] = torch.where(run_lane, torch.minimum(
                    q_thr[..., j], q[:, :, mine].amin(dim=2)), q_thr[..., j])
        lo = hi
    q_run = torch.where(run_pos, q, torch.full_like(q, float(BIG)))
    q_b, pos = split_min(q_run.reshape(-1, s_pad).numpy(), k, thread=thread)
    q_b = torch.from_numpy(q_b).reshape(nb, bl_lanes)
    pos = torch.from_numpy(pos).reshape(nb, bl_lanes)
    h = act & (q_b < float(BIG))
    sb = torch.gather(perm.to(torch.int64), 1, pos).to(torch.int32)
    shape = rays[0].shape
    hit = h.to(torch.int32).reshape(shape)
    t = torch.where(h, q_b * inv_a, torch.full_like(q_b, float(BIG)))
    sb = torch.where(h, sb, torch.zeros_like(sb)).reshape(shape)
    counted = warp_active
    return (hit, t.reshape(shape), sb), (
        int(skipped[counted].sum()), int(counted.sum()) * n_chunks)


def list_split(rays, cx, cy, cz, r, counts, lists, t_min, rows: int,
               active, k: int):
    """closest_hit_list at K threads a ray, in plain PyTorch (float32, the
    kernel's operation order) and numpy -> (hit, t, sb) planes.

    Per cull block b (``rows`` x 128 lanes) the guarded candidate over the
    padded table's rows ``lists[b, :counts[b]]`` (ids clamped to the table,
    as the kernel's gather clamps them) in list order; list position p goes
    to thread p % K, and ``split_min`` reduces over (q, position); the
    winning position maps through the list. Lanes that are inactive, or
    whose block's list is empty, get (0, 1e30, 0)."""
    from .ops import cuda_segment as seg

    nb, width = lists.shape
    bl = rows * seg.LANES
    n_sph = cx.shape[0]
    table = seg.hit_table_padded(cx, cy, cz, r)
    ids = lists.to(torch.int64).clamp(0, n_sph)
    n = counts.to(torch.int64).clamp(0, width)
    act = (active if active.dtype == torch.bool else active > 0).reshape(
        nb, bl)
    ox, oy, oz, dx, dy, dz = (p.reshape(nb, bl, 1) for p in rays)
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a[..., 0]
    q_min = torch.tensor(t_min, dtype=torch.float32) * a
    cand = table[ids][:, None]                               # (B, 1, L, 4)
    q = guarded(ox, oy, oz, dx, dy, dz, a, q_min,
                *(cand[..., c] for c in range(4)))           # (B, bl, L)
    past = torch.arange(width)[None, :] >= n[:, None]
    q = torch.where(past[:, None, :] | ~act[..., None],
                    torch.full_like(q, float(BIG)), q)
    q_b, pos = split_min(q.reshape(-1, width).numpy(), k)
    q_b = torch.from_numpy(q_b).reshape(nb, bl)
    pos = torch.from_numpy(pos).reshape(nb, bl)
    h = act & (q_b < float(BIG))
    won = (torch.gather(ids, 1, pos) if width else pos).to(torch.int32)
    shape = rays[0].shape
    return (h.to(torch.int32).reshape(shape),
            torch.where(h, q_b * inv_a,
                        torch.full_like(q_b, float(BIG))).reshape(shape),
            torch.where(h, won, torch.zeros_like(won)).reshape(shape))


def grouped_split(rays, cx, cy, cz, r, group_params, t_min, active,
                  k: int):
    """closest_hit_grouped at K threads a ray (K <= 16), in plain PyTorch
    (float32, the kernel's operation order) and numpy -> ((hit, t, sb)
    planes, sb in the sorted order; (groups skipped, groups in all)
    counted per warp with an active lane, as the kernel's ``stats``).

    Per lane and group the bound test (might = disc > 0 and (b < 0 or
    c < 0), on an active lane); a warp of 32 / K consecutive lanes runs a
    group when any of its lanes might hit it; sorted position s of a group
    that runs goes to thread s % K (thread j of a group takes its spheres
    j, j + K, ...), and ``split_min`` reduces the guarded t-space
    candidates over (t, position). Inactive lanes get (0, 1e30, 0)."""
    from .ops import cuda_segment as seg

    n_g = cx.shape[0] // seg.GROUP
    w = WARP // k
    x, y, z, vx, vy, vz = (p.reshape(-1, 1) for p in rays)
    n = x.shape[0]
    act = (active if active.dtype == torch.bool else active > 0).reshape(-1)
    a = vx * vx + vy * vy + vz * vz
    gx, gy, gz, gr = (g[None, :] for g in group_params)
    ocx, ocy, ocz = x - gx, y - gy, z - gz
    b = ocx * vx + ocy * vy + ocz * vz
    c = ocx * ocx + ocy * ocy + ocz * ocz - gr * gr
    might = act[:, None] & (b * b - a * c > 0) & ((b < 0) | (c < 0))
    pad = -n % w
    if pad:  # lanes past the end vote "no"
        might = torch.cat([might, torch.zeros(pad, n_g, dtype=torch.bool)])
    run = might.reshape(-1, w, n_g).any(dim=1)               # (warps, G)
    warp_active = torch.cat([act, torch.zeros(pad, dtype=torch.bool)]
                            ).reshape(-1, w).any(dim=1)
    skipped = int((~run)[warp_active].sum())
    run_lane = run.repeat_interleave(w, dim=0)[:n]
    tf = torch.tensor(t_min, dtype=torch.float32)
    t = guarded_t(x, y, z, vx, vy, vz, a, 1.0 / a, tf, cx[None, :],
                  cy[None, :], cz[None, :], (r * r)[None, :])
    keep = act[:, None] & run_lane.repeat_interleave(seg.GROUP, dim=1)
    t = torch.where(keep, t, torch.full_like(t, float(BIG)))
    t_b, s_b = split_min(t.numpy(), k)
    t_b, s_b = torch.from_numpy(t_b), torch.from_numpy(s_b)
    h = act & (t_b < float(BIG))
    shape = rays[0].shape
    out = (h.to(torch.int32).reshape(shape),
           torch.where(act, t_b, torch.full_like(t_b, float(BIG))
                       ).reshape(shape),
           torch.where(act, s_b, torch.zeros_like(s_b)).to(
               torch.int32).reshape(shape))
    return out, (skipped, int(warp_active.sum()) * n_g)
