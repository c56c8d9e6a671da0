"""Delta-lobe vertex gradients: RR branch flips + direction-sweep edges.

The port's copy of ``raytracinginoneweekend_tpu/ops/branchprob.py`` (its
docstring has the measured scope, the reproducers and the residual terms).
Dielectric and perfect-mirror vertices scatter along DETERMINISTIC
directions (delta lobes), so the lobe-density edge sampling of
ops/silhouette.py does not apply there. This module supplies the two
gradient terms such vertices carry, both invisible to interior AD:

1. The RUSSIAN-ROULETTE BRANCH-FLIP term (dielectric only). The renderer
   picks reflect or refract by ``ru < p_reflect`` (raytracer.hxx:182-191);
   interior AD at fixed draws sees only the taken branch, yet the expected
   pixel carries E[dp/dtheta (L_reflect - L_refract)]. The TIR step is
   kernel-smoothed inside the surrogate only:
   p_surrogate = schlick + (1 - schlick) * sigmoid(-k / h), with k the
   refraction discriminant (TIR <=> k < 0).
2. The DIRECTION-SWEEP edge term: the reflected/refracted continuation
   direction w(theta) moves with ior (Snell) and geometry, sweeping across
   scene silhouettes. Each delta branch is followed through the
   deterministic dielectric chain to air (refracting with the ATTACHED
   Snell map, internal reflection under TIR), the nearest cone edge of the
   final air segment is found, the radiance step across it probed with a
   common-random-number pair, and the crossing delta kernel-smoothed over
   a width-h angular band:

       surrogate -= detach(cot . thru (f_in - f_out) K_h(g) p_branch) g(theta)

   The chain's first ``chain_rr_arms`` internal-RR reflection arms get
   their own side chains.

Each term enters the loss as ``s - s.detach()``. The vertex walk runs on
the ATTACHED scene with the integrator's own bounce step; probes trace
the detached scene through ``integrate.trace_fast``. The draws are
``jax.random``'s own layouts (ops/threefry.uniform), under the same
``fold_in`` tags.
"""

from __future__ import annotations

import torch

from ..config import TraceOptions
from ..models.camera import Camera
from ..models.scene import Scene
from . import threefry as tf
from .math3 import sqrt_rn
from .silhouette import (PROBE_RR_QCAP, _cat_keys, _fold_keys,
                         _probe_options, detach_scene)


def _refract_dir_clamped(u, outward, ri, cos_o, k, phys: bool):
    """Refraction direction with the discriminant clamped at 0.

    The renderer's SELECTED expression -- "physical" Snell (math3.refract)
    or the reference's scalar-broadcast form (math3.refract_reference,
    math.hxx:300-309). k <= 0 yields the grazing limit (sq = 0) instead of
    NaN/zero, which is what the TIR-band smoothing crosses through.
    """
    kp = k > 0.0
    sq = torch.where(kp, sqrt_rn(torch.where(kp, k, torch.ones_like(k))),
                     torch.zeros_like(k))
    if phys:
        return ri[:, None] * u - (ri * cos_o + sq)[:, None] * outward
    # reference: i*eta - (n*sq + cos_i*eta) with cos_i*eta broadcast per
    # component (cos_i = dot(outward, u) = cos_o).
    return u * ri[:, None] - (outward * sq[:, None] + (cos_o * ri)[:, None])


TAG_RR_VERTEX = 120  # fold_in tags (disjoint from silhouette.py's 101-108)
TAG_RR_PROBE = 121
TAG_RR_DEPTH = 122
TAG_SWEEP_PROBE = 123  # + branch index
TAG_SWEEP_REDRAW = 140  # + br * 16 + redraw index (sweep_redraws)


def branch_probability_surrogate(scene: Scene, cam: Camera,
                                 camera_mode: str, cot, pixel_ids,
                                 width: int, height: int, base_key,
                                 max_depth: int, options: TraceOptions,
                                 vertex_depth: int = 0,
                                 tir_bandwidth: float = 0.02,
                                 sweep_bandwidth: float = 0.03,
                                 probe_delta: float = 2e-3,
                                 probe_delta_diel: float = 0.05,
                                 chain_rr_arms: int = 2,
                                 sweep_redraws: int = 0,
                                 rr_probe_splits: int = 1,
                                 boundary_rim_frac: float | None = None,
                                 _detach_prefix: bool = False,
                                 _rr_term: bool = True,
                                 _sweep_term: bool = True):
    """Surrogate scalar for BOTH delta-lobe terms (module docstring).

    cot: (P, 3) dL/dI for exactly the ``pixel_ids`` batch (detached);
    base_key: the (k0, k1) key words. vertex_depth: walk the vertex this
    many bounces of the renderer's own step first. tir_bandwidth: kernel
    width h (discriminant units) smoothing the TIR step in the RR term.
    sweep_bandwidth: angular kernel width (radians) of the sweep term.
    probe_delta: angular half-offset of the sweep probe pair (clamped to
    half the candidate's cone half-angle); probe_delta_diel: the inner
    probe's depth when the nearest-edge candidate is a DIELECTRIC sphere.
    chain_rr_arms: how many of the refract chain's internal-RR reflection
    arms get their own side-chain edge term. rr_probe_splits: independent
    CRN probe pairs averaged in the RR term (split 0 keeps the historical
    key stream). sweep_redraws: M fresh pixel-jitter re-walks per lane for
    the main branches' sweep kernel (<= 16). boundary_rim_frac: ABLATION
    only, drops vertex_depth-0 dielectric sweep lanes grazing the rim.
    _detach_prefix / _rr_term / _sweep_term: test-only ablations.
    The defaults are the JAX package's. Returns a scalar tensor; add
    ``s - s.detach()`` to the loss.
    """
    from . import math3
    from ..models.camera import camera_ray
    from ..models.scene import DIELECTRIC, METAL
    from ..render import make_primary_rays
    from .integrate import _bounce_step, closest_hit_opt, trace_fast
    from .intersect import hit_surface

    dev = scene.centers.device
    p_count = pixel_ids.shape[0]
    scene_det = detach_scene(scene)
    mat_det = scene_det.material_index.to(torch.int64)

    def gather_mat(idx):
        return mat_det.index_select(0, idx.to(torch.int64))

    def is_delta(mi, hit):
        mt = scene_det.mtype.index_select(0, mi)
        return hit & ((mt == DIELECTRIC)
                      | ((mt == METAL)
                         & (scene_det.fuzz.index_select(0, mi) <= 1e-3)))

    def attached_hit(o, d):
        t, idx, hit = closest_hit_opt(o, d, scene, options, True)
        y, n = hit_surface(o, d, t, idx, hit, scene.centers, scene.radii)
        return idx, hit, y, n

    def ones3():
        return torch.ones((p_count, 3), device=dev)

    def zeros3():
        return torch.zeros((p_count, 3), device=dev)

    def all_alive():
        return torch.ones((p_count,), dtype=torch.bool, device=dev)

    # 1. One vertex per batch pixel, walked with the integrator's step.
    vkey = tf.fold_in_words(*base_key, TAG_RR_VERTEX)
    o, d, ray_keys = make_primary_rays(cam, pixel_ids,
                                       torch.zeros_like(pixel_ids), vkey,
                                       width, height, camera_mode)
    state = (o, d, ones3(), zeros3(), all_alive(), *ray_keys)
    # Whether the prefix already visited a delta vertex: the sweep term
    # follows the WHOLE deterministic chain from the first delta vertex, so
    # firing it again at deeper chain vertices would double-count.
    prefix_delta = torch.zeros((p_count,), dtype=torch.bool, device=dev)
    # The walk runs on the ATTACHED scene (the prefix-motion channel of
    # dp/dtheta); all weights stay detached.
    walk_scene = scene_det if _detach_prefix else scene
    for b in range(vertex_depth):
        state, (idx_b, hit_b) = _bounce_step(walk_scene, options, state, b,
                                             return_hit=True)
        prefix_delta = prefix_delta | is_delta(gather_mat(idx_b), hit_b)
    o, d, path_alb, _, alive, _, _ = state
    path_alb = path_alb.detach()

    # Final hop ATTACHED: the normal at y(theta) carries the geometry
    # dependence of cos/Schlick.
    idx, hit, y_att, n_att = attached_hit(o, d)
    y = y_att.detach()
    mi = gather_mat(idx)
    mt = scene_det.mtype.index_select(0, mi)
    is_diel = mt == DIELECTRIC
    is_mirror = (mt == METAL) & (scene_det.fuzz.index_select(0, mi) <= 1e-3)
    active = alive & hit & is_diel

    # 2. Attached reflection probability, TIR step kernel-smoothed.
    ior_att = scene.ior.index_select(0, mi)  # ATTACHED gather
    unit_dir = math3.normalize(d)
    cos_theta = torch.sum(unit_dir * n_att, dim=-1)
    entering = cos_theta <= 0.0
    outward = torch.where(entering[:, None], n_att, -n_att)
    ri = torch.where(entering, 1.0 / ior_att, ior_att)
    cos_abs = torch.abs(cos_theta)
    cos_o = torch.sum(outward * unit_dir, dim=-1)
    k_att = 1.0 - ri * ri * (1.0 - cos_o * cos_o)
    schlick_att = math3.schlick(ri, cos_abs)
    p_att = schlick_att + (1.0 - schlick_att) * torch.sigmoid(
        -k_att / tir_bandwidth)

    # 3. ATTACHED branch directions (the refract direction clamps the
    # discriminant at 0: the grazing direction the TIR band crosses).
    phys = options.refract == "physical"
    reflected_att = math3.reflect(unit_dir, n_att)
    refracted_att = _refract_dir_clamped(unit_dir, outward, ri, cos_o,
                                         k_att, phys)
    probe_depth = max(max_depth - 1 - vertex_depth, 0)

    # RR term: both continuations with common random numbers, averaged
    # over rr_probe_splits independent pairs.
    l_reflect, l_refract = zeros3(), zeros3()
    o_all = torch.cat([y, y])
    d_all = torch.cat([reflected_att, refracted_att]).detach()
    for j in range(rr_probe_splits):
        kj = tf.fold_in_words(*base_key, TAG_RR_PROBE)
        if j > 0:  # split 0 keeps the historical key stream
            kj = tf.fold_in_words(*kj, j)
        pkeys = _fold_keys(kj, p_count, dev)
        f_all = trace_fast(scene_det, o_all, d_all,
                           _cat_keys([pkeys, pkeys]), probe_depth,
                           _probe_options(options), rr_qcap=PROBE_RR_QCAP)
        l_reflect = l_reflect + f_all[:p_count]
        l_refract = l_refract + f_all[p_count:]
    l_reflect = l_reflect / rr_probe_splits
    l_refract = l_refract / rr_probe_splits

    # 4. Detached RR weight; the only attached factor is p(theta). The
    # vertex attenuation is the material albedo (material.hxx:33-38).
    thru = cot * path_alb * scene_det.albedo.index_select(0, mi)
    w = torch.sum(thru * (l_reflect - l_refract), dim=-1)
    w = torch.where(active, w, torch.zeros_like(w)).detach()
    surrogate = (torch.sum(w * p_att) if _rr_term
                 else torch.zeros((), device=dev))

    # 5. DIRECTION-SWEEP edge term per delta branch. The true branch
    # probability (step TIR, detached) weights each branch; mirrors have
    # one reflect branch of weight 1.
    p_step = torch.where(k_att < 0.0, torch.ones_like(schlick_att),
                         schlick_att).detach()
    active_delta = alive & hit & (is_diel | is_mirror)
    # Grazing-entry gate: an ABLATION (production callers pass None).
    if vertex_depth == 0 and boundary_rim_frac is not None:
        grazing_cos = (1.0 - (1.0 - boundary_rim_frac) ** 2) ** 0.5
        active_delta = active_delta & (is_mirror | (cos_abs >= grazing_cos))
    prob_reflect = torch.where(is_mirror, torch.ones_like(p_step), p_step)
    prob_refract = torch.where(is_diel, 1.0 - p_step,
                               torch.zeros_like(p_step))
    h = sweep_bandwidth
    n_chain = 5  # refract-chain unroll: hollow glass exits in <= 4 hits

    def chain_step(y_c, w_c, done, prob, alb):
        """Follow the deterministic dielectric chain one interface: where
        the segment's hit is a dielectric, refract through it (ATTACHED
        Snell; TIR falls back to the internal reflection), else (y_c, w_c)
        already is the final air segment. ``prob`` accumulates the arm's
        renderer probability, ``alb`` its per-interface albedo (both
        detached). Also returns the dropped internal-RR reflection arm:
        (yh, refl, p_reflect, alb_arm, spawnable)."""
        idx_c, hit_c, yh, nh = attached_hit(y_c, w_c)
        mic = gather_mat(idx_c)
        is_d = (hit_c & (scene_det.mtype.index_select(0, mic) == DIELECTRIC)
                & ~done)
        u = math3.normalize(w_c)
        cosn = torch.sum(u * nh, dim=-1)
        ent = cosn <= 0.0
        ior_c = scene.ior.index_select(0, mic)  # attached
        outw = torch.where(ent[:, None], nh, -nh)
        rif = torch.where(ent, 1.0 / ior_c, ior_c)
        cos_oc = torch.sum(outw * u, dim=-1)
        kc = 1.0 - rif * rif * (1.0 - cos_oc * cos_oc)
        refr = _refract_dir_clamped(u, outw, rif, cos_oc, kc, phys)
        refl = math3.reflect(u, nh)
        tir_c = kc < 0.0
        w_new = torch.where(tir_c[:, None], refl, refr)
        p_refl = math3.schlick(rif, torch.abs(cosn))
        p_cont = torch.where(tir_c, torch.ones_like(p_refl), 1.0 - p_refl)
        prob_out = prob * torch.where(is_d, p_cont.detach(),
                                      torch.ones_like(p_cont))
        alb_c = scene_det.albedo.index_select(0, mic)
        alb_vis = alb * alb_c  # one albedo factor per interface visit
        alb_out = torch.where(is_d[:, None], alb_vis, alb)
        y_out = torch.where(is_d[:, None], yh, y_c)
        w_out = torch.where(is_d[:, None], w_new, w_c)
        spawn = is_d & ~tir_c
        return (y_out, w_out, done | ~is_d, prob_out, alb_out, is_d,
                (yh, refl, prob * p_refl.detach(), alb_vis, spawn))

    def follow_chain(y0, w0, prob0, alb0, steps0, n_steps, collect_arms):
        """Run the refract chain; optionally collect reflection arms."""
        y_f, w_f, prob, alb, steps = y0, w0, prob0, alb0, steps0
        done = torch.zeros((p_count,), dtype=torch.bool, device=dev)
        arms = []
        for j in range(n_steps):
            y_f, w_f, done, prob, alb, stepped, arm = chain_step(
                y_f, w_f, done, prob, alb)
            steps = steps + stepped.to(torch.int32)
            if j < collect_arms:
                arms.append((arm, steps))  # the arm consumed this interface
        return y_f, w_f, done, prob, alb, steps, arms

    def rewalk_branch(rjkey, br):
        """Camera ray -> prefix walk -> final hop -> branch -> refract
        chain again at a FRESH uniform pixel jitter (sweep_redraws), with
        the lane's own per-ray keys (so every discrete draw matches the
        lane's walk). Duplicates steps 1-3 and the gate above."""
        ju = tf.uniform(tf.fold_in_words(*rjkey, 0), (p_count,), dev)
        jv = tf.uniform(tf.fold_in_words(*rjkey, 1), (p_count,), dev)
        yp = torch.div(pixel_ids, width, rounding_mode="floor")
        xp = pixel_ids - yp * width
        u2 = (xp.to(torch.float32) + ju) / width
        v2 = (yp.to(torch.float32) + jv) / height
        o2, d2 = camera_ray(cam, u2, v2, ray_keys, camera_mode)
        st = (o2, d2, ones3(), zeros3(), all_alive(), *ray_keys)
        pdelta2 = torch.zeros((p_count,), dtype=torch.bool, device=dev)
        for b in range(vertex_depth):
            st, (ib, hb) = _bounce_step(walk_scene, options, st, b,
                                        return_hit=True)
            pdelta2 = pdelta2 | is_delta(gather_mat(ib), hb)
        o2, d2, palb2, _, alive2, _, _ = st
        palb2 = palb2.detach()
        idx2, hit2, y2_att, n2_att = attached_hit(o2, d2)
        mi2 = gather_mat(idx2)
        mt2 = scene_det.mtype.index_select(0, mi2)
        isd2 = mt2 == DIELECTRIC
        ismir2 = (mt2 == METAL) & (scene_det.fuzz.index_select(0, mi2)
                                   <= 1e-3)
        ud2 = math3.normalize(d2)
        cth2 = torch.sum(ud2 * n2_att, dim=-1)
        ent2 = cth2 <= 0.0
        outw2 = torch.where(ent2[:, None], n2_att, -n2_att)
        ior2 = scene.ior.index_select(0, mi2)
        ri2 = torch.where(ent2, 1.0 / ior2, ior2)
        cabs2 = torch.abs(cth2)
        cos_o2 = torch.sum(outw2 * ud2, dim=-1)
        k2 = 1.0 - ri2 * ri2 * (1.0 - cos_o2 * cos_o2)
        sch2 = math3.schlick(ri2, cabs2)
        p_step2 = torch.where(k2 < 0.0, torch.ones_like(sch2),
                              sch2).detach()
        if br == 0:
            w_br2 = math3.reflect(ud2, n2_att)
            prob_br2 = torch.where(ismir2, torch.ones_like(p_step2),
                                   p_step2)
        else:
            w_br2 = _refract_dir_clamped(ud2, outw2, ri2, cos_o2, k2, phys)
            prob_br2 = torch.where(isd2, 1.0 - p_step2,
                                   torch.zeros_like(p_step2))
        active2 = alive2 & hit2 & (isd2 | ismir2)
        if vertex_depth == 0 and boundary_rim_frac is not None:
            gcos = (1.0 - (1.0 - boundary_rim_frac) ** 2) ** 0.5
            active2 = active2 & (ismir2 | (cabs2 >= gcos))
        gate2 = active2 & ~pdelta2
        thru2 = cot * palb2 * scene_det.albedo.index_select(0, mi2)
        y_f2, w_f2, done2, prob2, alb2, steps2, _ = follow_chain(
            y2_att, w_br2, prob_br2.detach(), ones3(),
            torch.zeros((p_count,), dtype=torch.int32, device=dev),
            n_chain, 0)
        return dict(y_f=y_f2, w_f=w_f2, done=done2, prob=prob2,
                    alb=alb2, steps=steps2, gate=gate2, thru=thru2)

    def cone_distance(w_att, y_f, c_s, r_s):
        """Attached angular distance g = angle(w, axis) - beta of the
        candidate cone, with the detached axis a_hat and beta."""
        mv = c_s - y_f
        dist_a = torch.clamp_min(torch.linalg.norm(mv, dim=-1), 1e-6)
        beta_a = torch.arcsin(torch.clamp(torch.abs(r_s) / dist_a,
                                          0.0, 1.0 - 1e-7))
        cos_a = torch.sum(w_att * mv / dist_a[:, None], dim=-1)
        g = torch.arccos(torch.clamp(cos_a, -1.0 + 1e-7, 1.0 - 1e-7)) - beta_a
        return g, (mv / dist_a[:, None]).detach(), beta_a.detach()

    def sweep_term(y_f, w_f_att, done, prob, alb, steps, gate, br,
                   redraw: bool = False):
        """The final-air-segment cone-edge crossing term."""
        # The final air segment must still fit the continuation budget.
        budget_ok = steps <= max_depth - 2 - vertex_depth
        w_hat_att = math3.normalize(w_f_att)
        w_hat = w_hat_att.detach()
        y_fd = y_f.detach()

        # Nearest cone edge over all spheres from the final air vertex
        # (detached selection; own/enclosing spheres excluded).
        m_all = scene_det.centers[None] - y_fd[:, None]
        dist = torch.linalg.norm(m_all, dim=-1)
        rho = torch.abs(scene_det.radii)[None]
        sil_ok = dist > rho * (1.0 + 1e-5)
        dist_s = torch.where(sil_ok, dist, torch.ones_like(dist))
        m_hat = m_all / dist_s[..., None]
        beta_all = torch.arcsin(torch.clamp(rho / dist_s, 0.0, 1.0 - 1e-7))
        cosang = torch.sum(w_hat[:, None, :] * m_hat, dim=-1)
        ang = torch.arccos(torch.clamp(cosang, -1.0 + 1e-7, 1.0 - 1e-7))
        g_all = torch.where(sil_ok, torch.abs(ang - beta_all),
                            torch.full_like(ang, float("inf")))
        j_star = torch.argmin(g_all, dim=-1)
        any_ok = torch.isfinite(torch.min(g_all, dim=-1).values)

        # Attached edge distance through w(theta), y(theta), c_j, r_j.
        c_s = scene.centers.index_select(0, j_star)
        r_s = scene.radii.index_select(0, j_star)
        g_att, a_hat, beta_d = cone_distance(w_hat_att, y_f, c_s, r_s)
        g_det = g_att.detach()

        # Probe pair straddling the cone at the point nearest w; the
        # DIELECTRIC candidate's inner probe goes deep, past the rim's
        # grazing band.
        t_raw = w_hat - torch.sum(w_hat * a_hat, dim=-1, keepdim=True) * a_hat
        t_norm = torch.linalg.norm(t_raw, dim=-1)
        ok_t = t_norm > 1e-6  # w parallel to the axis: deep inside, K=0
        t_hat = t_raw / torch.clamp_min(t_norm, 1e-6)[:, None]
        delta = torch.clamp_max(0.49 * beta_d, probe_delta)
        mt_c = scene_det.mtype.index_select(0, mat_det.index_select(0, j_star))
        delta_in = torch.where(mt_c == DIELECTRIC,
                               torch.clamp_max(0.49 * beta_d,
                                               probe_delta_diel),
                               delta)
        w_in = (torch.cos(beta_d - delta_in)[:, None] * a_hat
                + torch.sin(beta_d - delta_in)[:, None] * t_hat)
        w_out = (torch.cos(beta_d + delta)[:, None] * a_hat
                 + torch.sin(beta_d + delta)[:, None] * t_hat)
        skeys = _fold_keys(tf.fold_in_words(*base_key, TAG_SWEEP_PROBE + br),
                           p_count, dev)
        f_sw = trace_fast(scene_det, torch.cat([y_fd, y_fd]),
                          torch.cat([w_in, w_out]),
                          _cat_keys([skeys, skeys]), probe_depth,
                          _probe_options(options), rr_qcap=PROBE_RR_QCAP)
        f_in, f_out = f_sw[:p_count], f_sw[p_count:]

        # Triangular kernel on the angular distance; I(g) steps from f_in
        # (inside, g < 0) to f_out: dI/dtheta = -(f_in - f_out) K dg.
        if redraw and sweep_redraws > 0:
            if sweep_redraws > 16:
                raise ValueError(
                    "sweep_redraws > 16 would collide redraw fold_in "
                    "tags across branches (TAG_SWEEP_REDRAW + br*16 + m)")
            # M fresh re-jitters of this pixel replace the lane's single
            # kernel sample; the candidate edge (j_star) and its probe
            # pair's step are reused, and only lanes whose own chain was
            # valid contribute.
            fstep = (f_in - f_out).detach()
            orig_ok = gate & done & budget_ok & any_ok & ok_t
            acc = torch.zeros((), device=dev)
            for m in range(sweep_redraws):
                rw = rewalk_branch(
                    tf.fold_in_words(*base_key,
                                     TAG_SWEEP_REDRAW + br * 16 + m), br)
                wv2 = math3.normalize(rw["w_f"])
                g2, a2, _ = cone_distance(wv2, rw["y_f"], c_s, r_s)
                wv2d = wv2.detach()
                tr2 = wv2d - torch.sum(wv2d * a2, dim=-1, keepdim=True) * a2
                okt2 = torch.linalg.norm(tr2, dim=-1) > 1e-6
                budget2 = rw["steps"] <= max_depth - 2 - vertex_depth
                kern2 = torch.clamp_min(
                    1.0 - torch.abs(g2.detach()) / h, 0.0) / h
                w2 = (torch.sum(rw["thru"] * rw["alb"] * fstep, dim=-1)
                      * rw["prob"] * kern2)
                w2 = torch.where(orig_ok & rw["gate"] & rw["done"] & budget2
                                 & okt2, w2, torch.zeros_like(w2))
                acc = acc - torch.sum(w2.detach() * g2)
            return acc / sweep_redraws

        kern = torch.clamp_min(1.0 - torch.abs(g_det) / h, 0.0) / h
        w_sw = torch.sum(thru * alb * (f_in - f_out), dim=-1) * prob * kern
        w_sw = torch.where(gate & done & budget_ok & any_ok & ok_t, w_sw,
                           torch.zeros_like(w_sw))
        return -torch.sum(w_sw.detach() * g_att)

    if not _sweep_term:
        return surrogate
    gate0 = active_delta & ~prefix_delta
    zero_steps = torch.zeros((p_count,), dtype=torch.int32, device=dev)
    for br, (w_br_att, prob_br) in enumerate(
            [(reflected_att, prob_reflect), (refracted_att, prob_refract)]):
        y_f, w_f, done, prob, alb_f, steps, arms = follow_chain(
            y_att, w_br_att, prob_br.detach(), ones3(), zero_steps, n_chain,
            chain_rr_arms)
        surrogate = surrogate + sweep_term(y_f, w_f, done, prob, alb_f,
                                           steps, gate0, br, redraw=True)
        # Internal-RR REFLECTION arms: each follows its own refract chain
        # (no further side arms) to air, weighted by prob_before * schlick.
        for a, ((yh_a, refl_a, prob_a, alb_a, spawn_a), steps_a) in \
                enumerate(arms):
            ya, wa, da, pa, aa, sa, _ = follow_chain(
                yh_a, refl_a, prob_a, alb_a, steps_a, n_chain - 1 - a, 0)
            surrogate = surrogate + sweep_term(
                ya, wa, da, pa, aa, sa, gate0 & spawn_a,
                2 + br * n_chain + a)
    return surrogate
