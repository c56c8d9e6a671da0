"""Check cases and counts for the closest-hit kernel (``csrc/closest_hit.cu``).

``chip_smoke.py`` holds the kernel against them on the card and
``tests/test_torch_closest_hit_split.py`` on the CPU:
  * ``ties_and_grazes``: a small sphere table of its own whose answers are
    exact in float32 -- duplicate spheres split across the kernel's K-way
    partitions, an exact graze, a ray that misses everything;
  * ``bit_diff``: where two (hit, t, sb) results differ at all;
  * ``disc_pairs``: how many (lane, sphere) pairs of an input reach the
    kernel's square root (discriminant >= 0). The rest stop after the
    discriminant and its compare, so the count gives the work that input
    needs, from which ``chip_smoke.py`` states a second bound.
"""

from __future__ import annotations

import torch

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


def bit_diff(got, want) -> dict:
    """Lanes where two (hit, t, sb) results differ at all: the hit flag,
    the sphere index, the bits of t (every lane, inactive ones too)."""
    (hk, tk, sk), (hr, tr, sr) = got, want
    return {"hit_differs": int((hk != hr).sum()),
            "sb_differs": int((sk != sr).sum()),
            "t_bits_differ": int((tk.view(torch.int32)
                                  != tr.view(torch.int32)).sum())}


def disc_pairs(rays, cx, cy, cz, r, active=None,
               chunk: int = 1 << 15) -> tuple[int, int]:
    """-> (pairs whose discriminant b*b - a*c is >= 0, all pairs) over the
    active lanes and every sphere, with the kernel's float32 arithmetic
    (rtw_closest_guarded in csrc/rtw_common.cuh; a NaN discriminant counts
    as < 0, as the guard treats it). Works in slabs of ``chunk`` lanes so
    the (lanes, spheres) intermediates stay bounded."""
    planes = [p.reshape(-1, 1) for p in rays]
    if active is not None:
        act = active if active.dtype == torch.bool else active > 0
        sel = act.reshape(-1).nonzero().squeeze(1)
        planes = [p[sel] for p in planes]
    ox, oy, oz, dx, dy, dz = planes
    rr = (r * r)[None, :]
    cx, cy, cz = cx[None, :], cy[None, :], cz[None, :]
    n_ge = 0
    for lo in range(0, ox.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        vx, vy, vz = dx[sl], dy[sl], dz[sl]
        a = vx * vx + vy * vy + vz * vz
        ocx, ocy, ocz = ox[sl] - cx, oy[sl] - cy, oz[sl] - cz
        b = ocx * vx + ocy * vy + ocz * vz
        c = ocx * ocx + ocy * ocy + ocz * ocz - rr
        n_ge += int((b * b - a * c >= 0).sum())
    return n_ge, ox.shape[0] * rr.shape[1]
