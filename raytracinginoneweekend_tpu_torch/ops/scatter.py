"""Branchless material scatter: the one polymorphic site, made data-parallel.

The port's copy of ``raytracinginoneweekend_tpu/ops/scatter.py``. The
reference dispatches materials through a tagged union (raytracer.hxx:128-198,
cuda_impl.cu:194-263); here the whole wavefront evaluates all three BSDFs
and selects by the integer material type, and everything stays
differentiable w.r.t. albedo/fuzz/ior.

Semantics per material (CUDA path, the active one):
  - lambert:    dir' = normal + rand_vec;            always valid
                (cuda_impl.cu:204-213)
  - metal:      dir' = reflect(unit(dir), n) + fuzz * rand_vec;
                ABSORBED when dot(dir', n) <= 0 (cuda_impl.cu:216-229)
  - dielectric: entering/exiting by sign of cos = dot(unit(dir), n);
                refract vs reflect by Schlick Russian roulette; TIR forces
                reflection (cuda_impl.cu:232-262)

``rand_vec`` is a *unit* vector under options.scatter_sample == "unit" or
an unnormalized point in the unit ball under "ball" (quirk Q3). The same
single draw serves lambert and metal. Attenuation is the material albedo
in all three cases.
"""

from __future__ import annotations

import torch

from ..config import TraceOptions
from ..models.scene import DIELECTRIC, METAL
from . import math3


def scatter(direction, normal, mtype, albedo, fuzz, ior, rand_vec,
            rr_uniform, options: TraceOptions):
    """Evaluate the scatter decision for a wavefront.

    direction: (N, 3) incoming ray directions (not necessarily unit);
    normal: (N, 3) outward geometric normals at the hit (unit); mtype:
    (N,) i32 material type per ray (gathered); albedo: (N, 3); fuzz, ior:
    (N,) gathered material params; rand_vec: (N, 3) the per-bounce sphere
    sample; rr_uniform: (N,) uniform in [0,1) for the dielectric Russian
    roulette; options: static TraceOptions.

    Returns (new_direction (N,3), attenuation (N,3), valid (N,) bool)
    where ``valid`` is False only for the metal below-surface absorption.
    """
    unit_dir = math3.normalize(direction)

    # --- lambert (cuda_impl.cu:204-213) ---------------------------------
    lambert_dir = normal + rand_vec

    # --- metal (cuda_impl.cu:216-229) -----------------------------------
    reflected = math3.reflect(unit_dir, normal)
    metal_dir = reflected + rand_vec * fuzz[:, None]
    metal_ok = math3.dot(metal_dir, normal) > 0.0

    # --- dielectric (cuda_impl.cu:232-262) ------------------------------
    cos_theta = math3.dot(unit_dir, normal)
    entering = cos_theta <= 0.0
    # Reference initializes outward = -normal / ri = ior for the EXITING
    # case and flips when entering (cuda_impl.cu:234-242).
    outward = torch.where(entering[:, None], normal, -normal)
    ri = torch.where(entering, 1.0 / ior, ior)
    cos_abs = torch.abs(cos_theta)
    refract_fn = (math3.refract if options.refract == "physical"
                  else math3.refract_reference)
    refracted, tir = refract_fn(unit_dir, outward, ri)
    # TIR => reflection probability stays 1 (raytracer.hxx:177-180).
    reflect_prob = torch.where(tir, torch.ones_like(ri),
                               math3.schlick(ri, cos_abs))
    diel_dir = torch.where((rr_uniform < reflect_prob)[:, None],
                           reflected, refracted)

    # --- select by material type ----------------------------------------
    is_metal = mtype == METAL
    is_diel = mtype == DIELECTRIC
    new_dir = torch.where(is_diel[:, None], diel_dir,
                          torch.where(is_metal[:, None], metal_dir,
                                      lambert_dir))
    valid = metal_ok | ~is_metal
    return new_dir, albedo, valid
