"""Conservative per-block candidate culling for coherent ray blocks.

Counterpart of ``raytracinginoneweekend_tpu/ops/cull.py``; plain PyTorch
(the JAX package's is plain array code too, no kernel).

The dual-pool wavefront (ops/wavefront_dual.py) keeps PRIMARY camera rays
in their own pool whose cull blocks hold tile-contiguous pixels, so each
block's rays fit a narrow bounding cone. This module computes, per cull
block (``rows`` x 128 lanes) and entirely on the device:

  1. block cone stats -- apex sphere (o0, ro) around the origins, axis u =
     mean unit direction, cos of the max deviation half-angle;
  2. a conservative might-WIN sphere mask: the sphere (expanded by ro +
     margin) must touch the solid cone, and must not be provably occluded
     -- a sphere whose nearest possible hit lies beyond the farthest
     possible near-hit of a sphere the WHOLE cone surely hits can never
     win the closest-hit running min;
  3. per-block candidate index lists + counts for the list-driven kernel
     (ops/cuda_segment.segment_closest_hit_list).

All bounds are conservative with explicit f32 margins:
  * cone containment: every ray origin is within ro of o0 and every unit
    direction within angle alpha of u, so any hittable sphere center lies
    within r + ro of the solid cone from o0;
  * occluder sure-hit: a ray's lateral offset from the axis at axial
    distance a1 is at most ro + a1*tan(alpha); if that stays under the
    occluder radius (with margin) every ray pierces it;
  * distance ordering happens in world units; t_min windows are converted
    with the block's max |d|.
Blocks whose cone is wide (cos alpha < 0.5) or empty fall back to
keep-everything; correctness never depends on coherence.

The arithmetic follows the JAX source's operation order. Sums over a
block's lanes are taken in another order than XLA's, so a sphere that sits
within an ulp of a bound may enter one package's list and not the other's;
the margins make either list conservative.
"""

from __future__ import annotations

import torch

from .math3 import sqrt_rn

LANES = 128
UNROLL_LIST = 4      # list counts are rounded up to this (the JAX contract)
_MARGIN = 3e-2       # absolute world-space slack over f32 bound errors
_MIN_COSA = 0.5      # below this (half-angle > 60deg) keep everything


def block_cone_stats(active, rays, rows: int):
    """Masked per-cull-block cone statistics.

    active: (R, 128) bool (or i32 0/1); rays: 6 planar (R, 128) f32
    planes. Returns dict of (B,) tensors (B = R/rows): o0x/y/z, ro,
    ux/y/z, cosa, n (active count), oy_hi, wy_hi, dn_hi.
    """
    ox, oy, oz, dx, dy, dz = rays
    b = ox.shape[0] // rows
    inf = float("inf")

    def blk(v):
        return v.reshape(b, rows * LANES)

    m = blk(active if active.dtype == torch.bool else active > 0)
    n = m.sum(dim=1)
    safe_n = torch.clamp(n, min=1).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=ox.device)

    def msum(v):
        return torch.where(m, v, zero).sum(dim=1)

    def mmax(v, fill):
        return torch.where(m, v, zero + fill).amax(dim=1)

    bx, by, bz = blk(ox), blk(oy), blk(oz)
    o0x, o0y, o0z = msum(bx) / safe_n, msum(by) / safe_n, msum(bz) / safe_n
    d2 = ((bx - o0x[:, None]) ** 2 + (by - o0y[:, None]) ** 2
          + (bz - o0z[:, None]) ** 2)
    ro = sqrt_rn(mmax(d2, 0.0))

    ddx, ddy, ddz = blk(dx), blk(dy), blk(dz)
    dn = sqrt_rn(ddx * ddx + ddy * ddy + ddz * ddz)
    dn_safe = torch.where(dn > 0, dn, zero + 1.0)
    wx, wy, wz = ddx / dn_safe, ddy / dn_safe, ddz / dn_safe
    umx, umy, umz = msum(wx) / safe_n, msum(wy) / safe_n, msum(wz) / safe_n
    ul = sqrt_rn(umx * umx + umy * umy + umz * umz)
    degenerate = ul < 1e-6
    ul_safe = torch.where(degenerate, zero + 1.0, ul)
    ux, uy, uz = umx / ul_safe, umy / ul_safe, umz / ul_safe
    cosa = torch.where(m, wx * ux[:, None] + wy * uy[:, None]
                       + wz * uz[:, None], zero + 1.0).amin(dim=1)
    cosa = torch.clamp(torch.where(degenerate | (n == 0), zero - 1.0, cosa),
                       -1.0, 1.0)
    return {
        "o0x": o0x, "o0y": o0y, "o0z": o0z, "ro": ro,
        "ux": ux, "uy": uy, "uz": uz, "cosa": cosa, "n": n,
        "oy_hi": mmax(by, -inf), "wy_hi": mmax(wy, -inf),
        "dn_hi": mmax(dn, 0.0),
    }


def candidate_mask(stats, cx, cy, cz, radii, t_min: float):
    """(B,) cone stats + (S,) sphere geometry -> (B, S) bool might-win
    mask (the first half of ``candidate_lists``)."""
    inf = float("inf")
    rabs = torch.abs(radii)[None, :]
    vx = cx[None, :] - stats["o0x"][:, None]
    vy = cy[None, :] - stats["o0y"][:, None]
    vz = cz[None, :] - stats["o0z"][:, None]
    ux, uy, uz = (stats[k][:, None] for k in ("ux", "uy", "uz"))
    ro = stats["ro"][:, None]
    cosa = stats["cosa"][:, None]
    sina = sqrt_rn(torch.clamp(1.0 - cosa * cosa, 0.0, 1.0))

    a1 = vx * ux + vy * uy + vz * uz
    vv = vx * vx + vy * vy + vz * vz
    perp = sqrt_rn(torch.clamp(vv - a1 * a1, min=0.0))
    r_eff = rabs + ro + _MARGIN
    e = cosa * perp - sina * a1
    keep = (e <= r_eff) & (a1 >= -r_eff)

    # --- occlusion ---------------------------------------------------
    narrow = stats["cosa"] > _MIN_COSA
    tana = sina / torch.where(cosa > _MIN_COSA, cosa, torch.ones_like(cosa))
    m_hi = perp + ro + torch.clamp(a1, min=0.0) * tana
    vlen = sqrt_rn(vv)
    near = vlen - rabs - ro              # earliest possible hit distance
    t_min_w = t_min * stats["dn_hi"][:, None]
    sure = (narrow[:, None] & (a1 > 0.0) & (m_hi + _MARGIN <= rabs)
            & (near > t_min_w + _MARGIN))
    s_occ_s = vlen + ro - sqrt_rn(
        torch.clamp(rabs * rabs - m_hi * m_hi, min=0.0))
    s_occ = torch.where(sure, s_occ_s,
                        torch.full_like(s_occ_s, inf)).amin(dim=1)

    # Ground special case: a huge sphere is locally its tangent plane
    # y = cy_g + r_g (sagitta <= Rh^2/(2 r_g) below it at horizontal
    # range Rh from the tangent point). When every unit direction points
    # steeply down and every origin is above the plane, the plane
    # distance (plus sagitta) upper-bounds the ground-hit distance.
    g = torch.argmax(torch.abs(radii))   # the first maximum, as jnp's
    r_g = torch.abs(radii)[g]
    y_t = cy[g] + r_g                    # tangent-plane height
    wy_hi = stats["wy_hi"]
    oy_rel = stats["oy_hi"] - y_t
    down = (r_g > 100.0) & (wy_hi < -0.05) & (oy_rel > stats["ro"])
    wy_safe = torch.where(down, -wy_hi, torch.ones_like(wy_hi))
    s_plane = (oy_rel + stats["ro"]) / wy_safe
    rh = (sqrt_rn((stats["o0x"] - cx[g]) ** 2
                     + (stats["o0z"] - cz[g]) ** 2)
          + stats["ro"] + s_plane)
    drop = rh * rh / (2.0 * r_g)
    s_g = (oy_rel + stats["ro"] + drop) / wy_safe + _MARGIN
    s_occ = torch.minimum(s_occ, torch.where(down, s_g,
                                             torch.full_like(s_g, inf)))

    keep = keep & ~(near > (s_occ[:, None] * (1.0 + 1e-4) + _MARGIN))

    # Wide/degenerate/empty blocks: trust nothing, keep everything.
    keep = keep | (~narrow & (stats["n"] > 0))[:, None]
    return keep & (stats["n"] > 0)[:, None]


def lists_from_mask(keep):
    """(B, S) bool mask -> (counts (B,) i32 rounded up to UNROLL_LIST,
    lists (B, L) i32 ascending ids, pads = S; L = S rounded up).

    The JAX package compacts with a triangular matrix product and a
    one-hot contraction (scans are slow on its hardware); here it is a
    cumulative sum and one indexed write, which give the same integers.
    """
    b, s = keep.shape
    l_round = -(-s // UNROLL_LIST) * UNROLL_LIST
    rank = torch.cumsum(keep.to(torch.int32), dim=1) - 1   # (B, S), 0-based
    n_keep = keep.sum(dim=1).to(torch.int32)
    # kept sphere s of block b goes to column rank[b, s]; the others to a
    # dump column past the end, dropped below.
    lists = torch.full((b, l_round + 1), s, dtype=torch.int32,
                       device=keep.device)
    col = torch.where(keep, rank, torch.full_like(rank, l_round))
    ids = torch.arange(s, dtype=torch.int32, device=keep.device)
    lists.scatter_(1, col.to(torch.int64), ids[None, :].expand(b, s))
    lists[:, l_round] = s
    counts = torch.div(n_keep + (UNROLL_LIST - 1), UNROLL_LIST,
                       rounding_mode="floor") * UNROLL_LIST
    return counts, lists[:, :l_round].contiguous()


def candidate_lists(stats, cx, cy, cz, radii, t_min: float):
    """(B,) cone stats + (S,) sphere geometry -> (counts, lists).

    counts: (B,) i32, rounded up to UNROLL_LIST (0 for empty blocks).
    lists: (B, L) i32 ascending candidate ids; pads point at id S (the
    pad sphere of the list kernel's table). L = ceil(S/UNROLL_LIST)*UNROLL.
    """
    return lists_from_mask(candidate_mask(stats, cx, cy, cz, radii, t_min))


TILE = 32  # tile edge for the primary-pool pixel swizzle (power of two)


def virtual_grid(width: int, height: int, tile: int = TILE):
    """Padded tile grid: (tiles_x, tiles_y, virtual pixel count)."""
    tiles_x = -(-width // tile)
    tiles_y = -(-height // tile)
    return tiles_x, tiles_y, tiles_x * tiles_y * tile * tile


def _fdiv(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


def tile_pixel(vp, width: int, height: int, tile: int = TILE):
    """Virtual (tile-order) pixel index -> (row-major pixel id, valid).

    Tiles are row-major over a PADDED tile grid; pixels row-major inside
    each tile. Virtual pixels outside the true image return valid=False
    and pixel id 0. Closed-form integer arithmetic (floor divisions, as
    the JAX package's ``//``).
    """
    tiles_x = -(-width // tile)
    tile_sz = tile * tile
    t_id = _fdiv(vp, tile_sz)
    o = vp - t_id * tile_sz
    ty = _fdiv(t_id, tiles_x)
    tx = t_id - ty * tiles_x
    oy = _fdiv(o, tile)
    oxs = o - oy * tile
    py = ty * tile + oy
    px = tx * tile + oxs
    valid = (px < width) & (py < height)
    pid = torch.where(valid, py * width + px, torch.zeros_like(px))
    return pid, valid
