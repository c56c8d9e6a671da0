"""Two-stage adaptive sampling: spend extra samples where the noise is.

The port's counterpart of ``raytracinginoneweekend_tpu/adaptive.py``, line
for line, on the planar engine (ops/integrate_planar.render_pixels_planar:
its pixel-subset API with ``sample_offset`` and ``spp_strata``):

  Stage 1  render every pixel twice at spp_base/2 (sample ids [0, h) and
           [h, spp_base); the RNG contract keys on (pixel, sample), so
           under iid the halves are independent), giving the base mean and
           a per-pixel noise score |half_a - half_b|. Under
           sampling="stratified" the halves are the complementary
           sub-windows of the FULL stratified pattern (spp_strata =
           spp_base).
  Tiering  rank pixels by score, noisiest first (a STABLE sort, as
           ``jnp.argsort`` is: ties keep pixel order, so a tier holds the
           same pixels as in the JAX package); fixed tier fractions of the
           pixel count get fixed extra sample counts.
  Stage 2  render each tier's pixels at its extra spp from sample id
           spp_base on (fresh ids under the same contract; iid, since the
           windows sit beyond the strata set), and combine by total sample
           count.

The float operations keep the JAX package's order, so the result matches
it as closely as the planar engine does. The allocation depends on stage
1's own samples, so the combined mean is not exactly unbiased (the JAX
module's estimator note; docs/ADAPTIVE_r04.json records the equal-budget
MSE). The parity defaults never enable this.

Everything runs without autograd, on the device of the scene's tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import TraceOptions
from .models.camera import Camera
from .models.scene import Scene
from .ops.integrate_planar import render_pixels_planar

# (fraction of pixels, extra spp as a multiple of spp_base), noisiest
# first. Default: top 6.25% get +4x, next 25% get +1x -- average extra
# 0.5x spp_base, i.e. a 1.5x total budget.
DEFAULT_TIERS = ((0.0625, 4.0), (0.25, 1.0))


def stage1(scene: Scene, cam: Camera, base_key, pixel_ids, *, width: int,
           height: int, spp_base: int, max_depth: int, camera_mode: str,
           options: TraceOptions):
    """The two half-buffers of stage 1 -> (m_a, m_b), each (P, 3)."""
    h = spp_base // 2
    kw = dict(width=width, height=height, max_depth=max_depth,
              camera_mode=camera_mode, spp=h, spp_strata=spp_base,
              options=options)
    m_a = render_pixels_planar(scene, cam, pixel_ids, base_key,
                               sample_offset=0, **kw)
    m_b = render_pixels_planar(scene, cam, pixel_ids, base_key,
                               sample_offset=h, **kw)
    return m_a, m_b


def noise_order(m_a, m_b):
    """Positions of the pixels, noisiest first (stable on ties)."""
    score = (m_a - m_b).abs().sum(dim=-1)
    return torch.argsort(-score, stable=True)


def render_adaptive(scene: Scene, cam: Camera, base_key, *, width: int,
                    height: int, spp_base: int, max_depth: int,
                    camera_mode: str, options: TraceOptions,
                    tiers=DEFAULT_TIERS, pixel_ids=None,
                    return_stats: bool = False):
    """Adaptive render -> (P, 3) radiance means (P = all pixels unless
    pixel_ids is given). spp_base must be even (half-buffer split).

    base_key: the (k0, k1) base-key words (ops/threefry.key_words). With
    ``return_stats`` -> (means, stats), stats as the JAX package's:
    spp_base, tiers ((pixels, extra spp) per tier rendered), rays_stage1,
    rays_stage2, avg_spp.
    """
    if spp_base < 2 or spp_base % 2:
        raise ValueError(f"spp_base must be even >= 2 (got {spp_base})")
    dev = scene.centers.device
    if pixel_ids is None:
        pixel_ids = torch.arange(width * height, dtype=torch.int32,
                                 device=dev)
    p = int(pixel_ids.shape[0])
    kw = dict(width=width, height=height, max_depth=max_depth,
              camera_mode=camera_mode)
    # Stage-2 tiers draw beyond the strata set -> iid.
    tier_options = (dataclasses.replace(options, sampling="iid")
                    if options.sampling != "iid" else options)
    with torch.no_grad():
        m_a, m_b = stage1(scene, cam, base_key, pixel_ids,
                          spp_base=spp_base, options=options, **kw)
        order = noise_order(m_a, m_b)

        total = torch.full((p,), float(spp_base), dtype=torch.float32,
                           device=dev)
        acc = (m_a + m_b) * (0.5 * spp_base)
        del m_a, m_b

        offset = spp_base
        start = 0
        tier_sizes = []
        for frac, mult in tiers:
            # Clamp to the pixels left in the ranking (a tiny batch would
            # otherwise slice past `order` while the stats claimed the
            # full tier budget).
            n_t = min(max(1, int(p * frac)), p - start)
            if n_t <= 0:
                break
            e_t = max(1, int(round(mult * spp_base)))
            pos = order[start:start + n_t]
            m_t = render_pixels_planar(scene, cam, pixel_ids[pos], base_key,
                                       spp=e_t, sample_offset=offset,
                                       options=tier_options, **kw)
            # A tier's positions are unique: each add is one float add.
            acc.index_add_(0, pos, m_t * e_t)
            total.index_add_(0, pos, torch.full((n_t,), float(e_t),
                                                dtype=torch.float32,
                                                device=dev))
            tier_sizes.append((n_t, e_t))
            start += n_t
            # Tiers draw from disjoint sample-id windows, which keeps each
            # tier's render reproducible in isolation.
            offset += e_t

        out = acc / total[:, None]
    if not return_stats:
        return out
    extra_rays = sum(n_t * e_t for n_t, e_t in tier_sizes)
    stats = {
        "spp_base": spp_base,
        "tiers": tuple(tier_sizes),
        "rays_stage1": p * spp_base,
        "rays_stage2": extra_rays,
        "avg_spp": (p * spp_base + extra_rays) / p,
    }
    return out, stats
