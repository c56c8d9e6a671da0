"""Edge-sampled silhouette gradients: the visibility boundary term.

The port's copy of ``raytracinginoneweekend_tpu/ops/silhouette.py`` (its
docstring has the derivation and the measured scope). The rendered image
is discontinuous in sphere centers/radii at silhouettes (the hit/miss flip
of ``raytracer::intersect``'s discriminant, raytracer.hxx:52-92): interior
automatic differentiation sees only the smooth shading term, so gradients
w.r.t. geometry cannot move a silhouette.

For sphere scenes the silhouette is ANALYTIC. For sphere (c, r) seen from
the viewpoint o the silhouette points are

    p(phi) = c + rho * n(phi),         rho = |r|
    n(phi) = (rho/D) m_hat + sqrt(1 - rho^2/D^2) (cos(phi) e1 + sin(phi) e2)

with m = o - c, D = |m|. Projecting p(phi) to the film gives the
screen-space silhouette curve x(phi; c, r), differentiable in (c, r). The
pixel-area integral's boundary term is

    dI_pix/dtheta |_edge = W*H * oint_{edge in pix} (f_in - f_out)
                                                    (dx/dtheta . n_s) ds

with f_in/f_out probed by two rays offset +/-delta along the screen normal
n_s (an occluded edge reads f_in == f_out and contributes nothing).

Each term is a SURROGATE scalar whose gradient is the Monte-Carlo
boundary estimate and whose value is irrelevant: callers add
``s - s.detach()`` to the loss.

    surrogate = sum_e  w_e_detached * (x_e(theta) . n_e_detached)

``boundary_surrogate`` samples the boundary from the CAMERA (primary
visibility); ``secondary_boundary_surrogate`` one bounce deeper, from a
lambert or fuzzy-metal path vertex (shadows, rough reflections), at
``vertex_depth`` scatter steps of the renderer's own draw contract.
Defocus: "pinhole"/"cuda" are exact, "thinlens" integrates the boundary
over the aperture (each edge sample its own lens point), "cpu" (quirk Q2)
finds the lens-sampled edge as a two-iteration fixed point.

How the JAX idioms map here: ``jax.lax.stop_gradient`` is ``.detach()``
(``scene_det`` is the scene with every tensor detached); ``jax.jvp`` of
the detached curve is ``torch.func.jvp``; ``take_along_axis`` is
``gather``; ``jnp.where``'s double-where guards are kept as written (a NaN
from the unselected branch poisons a torch gradient as it does a JAX one).
The draws are ``jax.random``'s own layouts (ops/threefry.uniform /
categorical), keyed by the same ``fold_in`` tags. Probe traces run through
``integrate.trace_fast`` on the detached scene (on the card, with
``options.intersect == "pallas"``, the intersect kernel,
csrc/intersect.cu); the vertex walks through ``integrate._bounce_step`` on
the attached scene.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..config import TraceOptions
from ..models.camera import Camera
from ..models.scene import Scene
from . import threefry as tf

TAG_EDGE_PHI = 101  # fold_in tags (disjoint from ops/rng.py's 0/1/2+b)
TAG_EDGE_PROBE = 102
TAG_EDGE_LENS = 103
TAG_EDGE2_VERTEX = 104  # secondary (one-bounce) boundary term
TAG_EDGE2_SPHERE = 105
TAG_EDGE2_PHI = 106
TAG_EDGE2_PROBE = 107
TAG_EDGE2_DEPTH = 108  # + vertex_depth: per-depth key split (render_loss)

# Default deep-inside-probe depth (fraction of the projected radius) for
# DIELECTRIC rim probes; one constant shared with ops/branchprob.py.
PROBE_DIEL_FRAC = 0.15

# Probe-trace survival ceiling (rng.rr_terminate_update rr_qcap): q <= 0.5
# past rr_start drains a large probe batch in ~rr_start + log2(N) bounces;
# unbiased (1/q boost).
PROBE_RR_QCAP = 0.5

TWO_PI = 2.0 * math.pi


def _probe_options(options: TraceOptions) -> TraceOptions:
    """Options for the surrogates' DETACHED probe traces: Russian-roulette
    termination forced ON. The probe radiance enters every surrogate
    linearly, so any unbiased estimator of it leaves the surrogate's
    expectation unchanged, and RR lets a large probe batch drain instead
    of carrying a live lane to full depth."""
    return (options if options.rr_terminate
            else dataclasses.replace(options, rr_terminate=True))


def detach_scene(scene: Scene) -> Scene:
    """The scene with every tensor detached (``stop_gradient(scene)``)."""
    return Scene(*(t.detach() for t in scene))


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def silhouette_frame(centers, radii, eye, phis):
    """Silhouette points of each sphere from ``eye`` plus the cone frame.

    Returns (p, valid, frame) where frame = (m_hat, e1, e2, cos_a, sin_a)
    with m = eye - center and m_hat its unit vector, so the silhouette
    normal is n(phi) = cos_a*m_hat + sin_a*(cos(phi)*e1 + sin(phi)*e2)
    and p = center + |r|*n. Frame entries are (S, E, 3) / (S, E) shaped.
    """
    s_count, e_count = centers.shape[0], phis.shape[1]
    rho = torch.abs(radii)[:, None]  # (S, 1)
    eye = torch.broadcast_to(eye, (s_count, e_count, 3))
    m = eye - centers[:, None, :]  # (S, E, 3)
    d = torch.sqrt(torch.sum(m * m, dim=-1))  # (S, E)
    valid = d > rho * (1.0 + 1e-6)
    d_safe = torch.where(valid, d, torch.ones_like(d))
    m_hat = m / d_safe[..., None]

    # Orthonormal frame (e1, e2) perpendicular to m_hat; the helper axis
    # switches to Y where m_hat is nearly X-aligned.
    near_x = torch.abs(m_hat[..., 0]) > 0.9
    helper = torch.where(near_x[..., None], _vec([0.0, 1.0, 0.0], m_hat),
                         _vec([1.0, 0.0, 0.0], m_hat))
    e1 = torch.linalg.cross(m_hat, helper, dim=-1)
    e1 = e1 / torch.linalg.norm(e1, dim=-1, keepdim=True)
    e2 = torch.linalg.cross(m_hat, e1, dim=-1)

    cos_a = torch.clamp(rho / d_safe, 0.0, 1.0 - 1e-7)  # n . m_hat
    sin_a = torch.sqrt(1.0 - cos_a * cos_a)
    n = (cos_a[..., None] * m_hat
         + sin_a[..., None] * (torch.cos(phis)[..., None] * e1
                               + torch.sin(phis)[..., None] * e2))
    p = centers[:, None, :] + rho[..., None] * n
    return p, valid, (m_hat, e1, e2, cos_a, sin_a)


def silhouette_points(centers, radii, eye, phis):
    """Exact silhouette points of each sphere from viewpoint ``eye``.

    centers (S, 3), radii (S,) (sign ignored: a negative-radius shell has
    its mirror's silhouette), eye (3,) or per-sample (S, E, 3), phis
    (S, E). Returns (p (S, E, 3), valid (S, E)); valid is False where the
    viewpoint is inside the sphere.
    """
    p, valid, _ = silhouette_frame(centers, radii, eye, phis)
    return p, valid


def project_to_screen(cam: Camera, p, camera_mode: str, lens_offset=None):
    """World points (..., 3) -> (u, v) in [0,1]^2 screen space (+ validity).

    Inverts the reference's film mapping (camera.hxx:56): the ray for
    (u, v) from lens point origin+off has direction A + horizontal*u +
    vertical*(1-v) with A = lower_left - origin - off for the corrected
    modes and A = lower_left for the "cuda"/"cpu" quirk-Q11 modes. A point
    p projects to the (u, v) whose direction is parallel to p - (origin +
    off): a 3x3 solve with the dual basis of (horizontal, vertical, film
    normal). valid is False behind the camera or at grazing film angles.
    """
    if camera_mode == "cpu" and lens_offset is not None:
        # Quirk Q2 + Q11 (camera.hxx:51-56).
        a_vec = cam.lower_left - lens_offset
        eye = cam.origin + lens_offset
    elif camera_mode in ("cuda", "cpu"):
        a_vec = cam.lower_left  # quirk Q11: direction never subtracts origin
        eye = cam.origin
    elif lens_offset is None:
        a_vec = cam.lower_left - cam.origin
        eye = cam.origin
    else:
        a_vec = cam.lower_left - cam.origin - lens_offset  # (..., 3)
        eye = cam.origin + lens_offset
    hor, ver = cam.horizontal, cam.vertical
    n_f = torch.linalg.cross(hor, ver, dim=-1)

    g = p - eye
    g_nf = torch.sum(g * n_f, dim=-1)
    ok = torch.abs(g_nf) > 1e-12
    s = (torch.sum(a_vec * n_f, dim=-1)
         / torch.where(ok, g_nf, torch.ones_like(g_nf)))
    valid = ok & (s > 0.0)
    w = s[..., None] * g - a_vec

    h_star = torch.linalg.cross(ver, n_f, dim=-1)
    h_star = h_star / torch.sum(hor * h_star)
    v_star = torch.linalg.cross(hor, n_f, dim=-1)
    v_star = v_star / torch.sum(ver * v_star)
    u = torch.sum(w * h_star, dim=-1)
    b = torch.sum(w * v_star, dim=-1)
    return torch.stack([u, 1.0 - b], dim=-1), valid


def _probe_directions(cam: Camera, uv, camera_mode: str, lens_offset=None):
    """Probe-ray origin/direction for screen points (..., 2): central rays
    by default, through the thin-lens offsets ``lens_offset`` (..., 3)
    when given."""
    u, v = uv[..., 0], uv[..., 1]
    film = (cam.lower_left + cam.horizontal * u[..., None]
            + cam.vertical * (1.0 - v)[..., None])
    if camera_mode == "cpu" and lens_offset is not None:
        o = torch.broadcast_to(cam.origin + lens_offset, film.shape)
        return o, film - lens_offset  # quirk Q2 defocus probes
    if camera_mode in ("cuda", "cpu"):
        return torch.broadcast_to(cam.origin, film.shape), film  # quirk Q11
    if lens_offset is None:
        o = torch.broadcast_to(cam.origin, film.shape)
        return o, film - cam.origin
    o = torch.broadcast_to(cam.origin + lens_offset, film.shape)
    return o, film - o


def lobe_direction_density(w, axis, f, sample_mode: str, eps: float = 1e-4):
    """Solid-angle density of the reference's scatter draw dir' = axis+f*s.

    ``s`` is uniform in the unit ball under "ball" (raytracer.hxx:134/147,
    quirk Q3) or uniform ON the unit sphere under "unit"
    (cuda_impl.cu:206/220). With chord roots t+- = cos +- sqrt(f^2 - sin^2),
    cos = w.axis:

        ball:  p(w) = (t+^3 - t-^3) / (4 pi f^3)      (roots clamped to 0)
        unit:  p(w) = (t+^2 [t+>0] + t-^2 [t->0]) / (4 pi f sqrt(f^2-sin^2))

    ``eps`` floors the "unit" density's sqrt. w (..., 3) unit directions,
    axis (..., 3) unit lobe axis, f (...,) lobe radius > 0 -> (...,)
    density, zero outside the support cone.
    """
    c = torch.sum(w * axis, dim=-1)
    disc = f * f - (1.0 - c * c)
    s = torch.sqrt(torch.clamp_min(disc, 0.0))
    tp = torch.clamp_min(c + s, 0.0)
    tm = torch.clamp_min(c - s, 0.0)
    if sample_mode == "unit":
        num = tp * tp * (tp > 0.0) + tm * tm * (tm > 0.0)
        dens = num / (4.0 * math.pi * f * torch.clamp_min(s, eps))
    else:  # "ball"
        dens = (tp * tp * tp - tm * tm * tm) / (4.0 * math.pi * f * f * f)
    return torch.where(disc > 0.0, dens, torch.zeros_like(dens))


def _fold_keys(key, n: int, device):
    """``vmap(fold_in, (None, 0))(key, arange(n))``: the (k0, k1) words of
    n per-sample keys."""
    return tf.fold_in_words(key[0], key[1],
                            torch.arange(n, dtype=torch.int64,
                                         device=device))


def _cat_keys(keys):
    return tuple(torch.cat([k[i] for k in keys]) for i in range(2))


def boundary_surrogate(scene: Scene, cam: Camera, camera_mode: str,
                       cot_image, width: int, height: int, base_key,
                       max_depth: int, options: TraceOptions,
                       n_angles: int = 256, probe_delta: float | None = None,
                       probe_diel_frac: float = PROBE_DIEL_FRAC,
                       _cpu_central_ablation: bool = False):
    """Surrogate scalar whose gradient w.r.t. scene.centers/scene.radii is
    the edge-sampled visibility boundary term of the pixel loss.

    scene: the ATTACHED scene; cot_image: (width*height, 3) dL/dI per
    pixel (detached; zero outside the loss batch); base_key: the (k0, k1)
    key words for the angle jitter and the probe paths; n_angles: edge
    samples per sphere (E); probe_delta: screen-space half-offset of the
    two probe rays (default 0.3 pixels); _cpu_central_ablation: test-only,
    the central-viewpoint approximation for camera_mode="cpu".
    Returns a scalar tensor; add ``s - s.detach()`` to the loss.
    """
    from . import rng
    from .integrate import trace_fast  # local: avoid an import cycle

    dev = scene.centers.device
    s_count = scene.num_spheres
    e = n_angles
    if probe_delta is None:
        probe_delta = 0.3 / max(width, height)
    cen_det, rad_det = scene.centers.detach(), scene.radii.detach()

    # Stratified, jittered angles (one jitter per sphere).
    jit = tf.uniform(tf.fold_in_words(*base_key, TAG_EDGE_PHI),
                     (s_count, 1), dev)
    phis = ((torch.arange(e, device=dev)[None, :] + jit)
            * (TWO_PI / e))

    # Thin-lens aperture integration: each edge sample draws its own lens
    # point and the whole chain runs through it. Other modes use the
    # central viewpoint.
    if camera_mode == "thinlens":
        lu = tf.uniform(tf.fold_in_words(*base_key, TAG_EDGE_LENS),
                        (s_count, e, 2), dev)
        l0, l1 = rng.disk_from_uv(lu[..., 0], lu[..., 1])
        l0, l1 = l0 * cam.lens_radius, l1 * cam.lens_radius
        lens_off = (cam.basis_u * l0[..., None]
                    + cam.basis_v * l1[..., None])
        eye = cam.origin + lens_off
        cpu_rd = None
    elif camera_mode == "cpu" and not _cpu_central_ablation:
        # Quirk-Q2 aperture integration: off(u, v) = (u*rd.x, v*rd.y, 0) *
        # lens_radius depends on the screen point being solved for, so the
        # lens-sampled edge is a FIXED POINT in (u, v): two Picard
        # iterations from the central projection (detached), then a pass
        # through the ATTACHED scene that keeps the screen-scaling feedback
        # of d(off)/d(theta) in the gradient.
        lu = tf.uniform(tf.fold_in_words(*base_key, TAG_EDGE_LENS),
                        (s_count, e, 3), dev)
        bx, by, _bz = rng.unit_from_uv(lu[..., 0], lu[..., 1])
        rcube = torch.pow(lu[..., 2], rng.THIRD)
        cpu_rd = (bx * rcube * cam.lens_radius,
                  by * rcube * cam.lens_radius)  # (S, E) each

        def cpu_off(uv):
            return torch.stack(
                [uv[..., 0] * cpu_rd[0], uv[..., 1] * cpu_rd[1],
                 torch.zeros_like(cpu_rd[0])], dim=-1)

        p_fp, _ = silhouette_points(cen_det, rad_det, cam.origin, phis)
        x_fp, _ = project_to_screen(cam, p_fp, "cpu", None)
        for _ in range(2):
            off_det = cpu_off(x_fp.detach())
            p_fp, _ = silhouette_points(cen_det, rad_det,
                                        cam.origin + off_det, phis)
            x_fp, _ = project_to_screen(cam, p_fp, "cpu", off_det)
        off_det = cpu_off(x_fp.detach())
        p_pre, _ = silhouette_points(scene.centers, scene.radii,
                                     cam.origin + off_det, phis)
        x_pre, _ = project_to_screen(cam, p_pre, "cpu", off_det)
        lens_off = cpu_off(x_pre)  # attached through x_pre
        eye = cam.origin + lens_off
    else:
        lens_off = None
        eye = cam.origin
        cpu_rd = None

    # Silhouette curve and its screen projection, attached to theta.
    p, sphere_ok = silhouette_points(scene.centers, scene.radii, eye, phis)
    x, proj_ok = project_to_screen(cam, p, camera_mode, lens_off)  # (S,E,2)

    # Curve tangent dx/dphi via one jvp through the same chain, detached
    # (every use of it below is detached, as in the JAX package).
    eye_det = eye.detach()
    off_det = None if lens_off is None else lens_off.detach()

    def x_of_phi(ph):
        pp, _ = silhouette_points(cen_det, rad_det, eye_det, ph)
        xx, _ = project_to_screen(cam, pp, camera_mode, off_det)
        return xx

    _, tau = torch.func.jvp(x_of_phi, (phis,), (torch.ones_like(phis),))
    x_det = x.detach()

    # Screen normal: the tangent turned 90 degrees, oriented OUTWARD (away
    # from the projected center -- the projected region is convex).
    n_raw = torch.stack([tau[..., 1], -tau[..., 0]], dim=-1)
    x_c, _ = project_to_screen(
        cam, torch.broadcast_to(cen_det[:, None, :], (s_count, e, 3)),
        camera_mode, off_det)  # (S, E, 2)
    outward = torch.sum(n_raw * (x_det - x_c), dim=-1)
    sign = torch.where(outward >= 0.0, 1.0, -1.0)
    tau_norm = torch.linalg.norm(n_raw, dim=-1)
    n_unit = (n_raw * sign[..., None]
              / torch.clamp_min(tau_norm, 1e-12)[..., None])

    # Pixel lookup + on-screen mask.
    u, v = x_det[..., 0], x_det[..., 1]
    on_screen = (u >= 0.0) & (u < 1.0) & (v >= 0.0) & (v < 1.0)
    valid = sphere_ok & proj_ok & on_screen & (tau_norm > 1e-12)
    ix = torch.clamp((u * width).to(torch.int32), 0, width - 1)
    iy = torch.clamp((v * height).to(torch.int32), 0, height - 1)
    pid = (iy * width + ix).to(torch.int64)
    cot = cot_image.index_select(0, pid.reshape(-1)).reshape(s_count, e, 3)

    # Probe radiance just inside/outside the edge, common random numbers
    # (one key per edge sample, shared by both probes). DIELECTRIC spheres
    # get a DEEP inside probe (probe_diel_frac of the projected radius,
    # capped at 49%): just inside a glass silhouette sits a grazing band
    # whose radiance reads like the outside.
    from ..models.scene import DIELECTRIC

    scene_det = detach_scene(scene)
    is_diel_s = (scene_det.mtype.index_select(
        0, scene_det.material_index.to(torch.int64)) == DIELECTRIC)  # (S,)
    r_proj = torch.linalg.norm(x_det - x_c, dim=-1)  # (S, E) screen radius
    delta_in = torch.where(
        is_diel_s[:, None],
        torch.minimum(torch.clamp_min(probe_diel_frac * r_proj,
                                      probe_delta), 0.49 * r_proj),
        torch.full_like(r_proj, probe_delta))
    uv_in = x_det - delta_in[..., None] * n_unit
    uv_out = x_det + probe_delta * n_unit
    if cpu_rd is not None:
        # Each probe re-derives its own quirk-Q2 offset from ITS screen
        # point (the renderer scales by the sampled pixel's coords).
        o_in, d_in = _probe_directions(cam, uv_in, camera_mode,
                                       cpu_off(uv_in))
        o_out, d_out = _probe_directions(cam, uv_out, camera_mode,
                                         cpu_off(uv_out))
    else:
        o_in, d_in = _probe_directions(cam, uv_in, camera_mode, off_det)
        o_out, d_out = _probe_directions(cam, uv_out, camera_mode, off_det)
    pkeys = _fold_keys(tf.fold_in_words(*base_key, TAG_EDGE_PROBE),
                       s_count * e, dev)
    o_all = torch.cat([o_in.reshape(-1, 3), o_out.reshape(-1, 3)]).detach()
    d_all = torch.cat([d_in.reshape(-1, 3), d_out.reshape(-1, 3)]).detach()
    f_all = trace_fast(scene_det, o_all, d_all, _cat_keys([pkeys, pkeys]),
                       max_depth, _probe_options(options),
                       rr_qcap=PROBE_RR_QCAP)
    f_in = f_all[:s_count * e].reshape(s_count, e, 3)
    f_out = f_all[s_count * e:].reshape(s_count, e, 3)

    # Per-sample detached weight; the only attached factor is x(theta).
    w = (torch.sum(cot * (f_in - f_out), dim=-1)
         * tau_norm * (TWO_PI / e) * (width * height))
    w = torch.where(valid, w, torch.zeros_like(w)).detach()
    return torch.sum(w * torch.sum(x * n_unit.detach(), dim=-1))


def secondary_boundary_surrogate(scene: Scene, cam: Camera,
                                 camera_mode: str, cot, pixel_ids,
                                 width: int, height: int, base_key,
                                 max_depth: int, options: TraceOptions,
                                 n_angles: int = 8, n_spheres: int = 2,
                                 probe_delta: float = 2e-3,
                                 vertex_depth: int = 0,
                                 probe_diel_frac: float = PROBE_DIEL_FRAC):
    """Surrogate scalar for the ONE-BOUNCE visibility boundary term.

    The continuation integral at a lambert or fuzzy-metal vertex y is
    I(y) = integral of p(w) L(y, w) dw with p the analytic scatter-lobe
    density (``lobe_direction_density``). L flips across sphere
    silhouettes AS SEEN FROM y, contributing

        dI/dtheta |_edge = oint_{C_j(y)} p(w) (L_in - L_out)
                                        (dw/dtheta . n_perp) dsigma(w)

    over each sphere j's silhouette circle on the direction sphere: the
    gradient that moves a SHADOW when its caster moves.

    Estimator: one jittered primary vertex per batch pixel (walked
    ``vertex_depth`` scatter steps of the renderer's own step on the
    ATTACHED scene), ``n_spheres`` candidate spheres per vertex drawn in
    proportion to subtended solid angle (``jax.random.categorical``'s
    draw; unbiased via 1/(K q)), ``n_angles`` stratified silhouette angles
    per candidate, two probe continuation rays per angle straddling the
    edge with common random numbers (continuation depth
    max_depth-1-vertex_depth, detached scene). Vertices whose ray misses,
    lands on a dielectric or a perfect mirror (fuzz <= 1e-3), or sees no
    candidate contribute zero.

    cot: (P, 3) dL/dI for exactly the ``pixel_ids`` batch (detached);
    probe_delta: angular half-offset (radians) of the probe pair, clamped
    per candidate to half its cone half-angle; probe_diel_frac: the deep
    inside probe of DIELECTRIC candidates.
    Returns a scalar tensor; add ``s - s.detach()`` to the loss.
    """
    from . import math3
    from ..models.scene import DIELECTRIC, LAMBERT, METAL
    from ..render import make_primary_rays
    from .integrate import _bounce_step, closest_hit_opt, trace_fast
    from .intersect import hit_surface

    dev = scene.centers.device
    p_count = pixel_ids.shape[0]
    k, e = n_spheres, n_angles
    pk = p_count * k
    scene_det = detach_scene(scene)

    # 1. One vertex per batch pixel: jittered primary ray, walked
    # ``vertex_depth`` bounces of the integrator's own step on the
    # ATTACHED scene (the prefix hops' motion rides the gradient; every
    # sampling decision below uses detached copies).
    vkey = tf.fold_in_words(*base_key, TAG_EDGE2_VERTEX)
    o, d, (rk0, rk1) = make_primary_rays(cam, pixel_ids,
                                         torch.zeros_like(pixel_ids), vkey,
                                         width, height, camera_mode)
    state = (o, d, torch.ones((p_count, 3), device=dev),
             torch.zeros((p_count, 3), device=dev),
             torch.ones((p_count,), dtype=torch.bool, device=dev), rk0, rk1)
    for b in range(vertex_depth):
        state = _bounce_step(scene, options, state, b)
    o, d, path_alb, _, alive, _, _ = state
    path_alb = path_alb.detach()
    # The FINAL hop on the ATTACHED scene: the vertex y(theta) rides the
    # receiver sphere it lands on, so the edge direction carries the
    # receiver-motion component of the boundary term.
    t_a, idx, hit = closest_hit_opt(o, d, scene, options, True)
    y_att, n_att = hit_surface(o, d, t_a, idx, hit, scene.centers,
                               scene.radii)
    y, n_y = y_att.detach(), n_att.detach()
    mi = scene_det.material_index.to(torch.int64).index_select(
        0, idx.to(torch.int64))
    mt_v = scene_det.mtype.index_select(0, mi)
    fuzz_v = scene_det.fuzz.index_select(0, mi)
    is_metal_v = mt_v == METAL
    # Lobe of the continuation draw (ops/scatter.py): the normal with
    # radius 1 for lambert, the mirror direction with radius = roughness
    # for metal. Perfect mirrors (delta lobe) stay out of scope.
    axis_lobe = torch.where(is_metal_v[:, None],
                            math3.reflect(math3.normalize(d.detach()), n_y),
                            n_y)
    f_lobe = torch.where(is_metal_v, torch.clamp_min(fuzz_v, 1e-3),
                         torch.ones_like(fuzz_v))
    active = (alive & hit
              & ((mt_v == LAMBERT) | (is_metal_v & (fuzz_v > 1e-3))))
    thru = cot * path_alb * scene_det.albedo.index_select(0, mi)  # (P, 3)

    # 2. Candidate spheres per vertex ~ solid angle, dropping spheres the
    # vertex sits on/inside and caps entirely below the hemisphere.
    m = scene_det.centers[None] - y[:, None]  # (P, S, 3) vertex->center
    dist = torch.linalg.norm(m, dim=-1)
    rho = torch.abs(scene_det.radii)[None]
    sil_ok = dist > rho * (1.0 + 1e-5)
    dist_safe = torch.where(sil_ok, dist, torch.ones_like(dist))
    sin_b = torch.clamp(rho / dist_safe, 0.0, 1.0)  # cone half-angle sine
    cos_b = torch.sqrt(1.0 - sin_b * sin_b)
    mu = torch.sum(m * n_y[:, None], dim=-1) / dist_safe
    q = torch.where(sil_ok & (mu > -sin_b), 1.0 - cos_b,
                    torch.zeros_like(cos_b))
    q_sum = torch.sum(q, dim=-1, keepdim=True)
    has_any = q_sum[:, 0] > 0.0
    q = q / torch.where(q_sum > 0.0, q_sum, torch.ones_like(q_sum))

    logits = torch.where(q > 0.0, torch.log(torch.clamp_min(q, 1e-30)),
                         torch.full_like(q, -math.inf))
    # All--inf rows would NaN the draw; flatten them (masked by has_any).
    logits = torch.where(has_any[:, None], logits, torch.zeros_like(logits))
    j_sel = tf.categorical(tf.fold_in_words(*base_key, TAG_EDGE2_SPHERE),
                           logits[:, None, :], (p_count, k))  # (P, K)
    q_sel = torch.gather(q, 1, j_sel)
    sin_b_sel = torch.gather(sin_b, 1, j_sel)
    j_flat = j_sel.reshape(-1)

    # 3. Silhouette of each candidate from its vertex (ATTACHED gathers of
    # the candidate centers/radii carry the theta dependence).
    c_sel = scene.centers.index_select(0, j_flat)  # (P*K, 3) attached
    r_sel = scene.radii.index_select(0, j_flat)
    y_rep = torch.repeat_interleave(y, k, dim=0)  # (P*K, 3) detached
    eye = torch.broadcast_to(y_rep[:, None, :], (pk, e, 3))
    # Attached viewpoint for the edge-direction chain only: w_e(theta)
    # moves with candidate AND vertex.
    eye_att = torch.broadcast_to(
        torch.repeat_interleave(y_att, k, dim=0)[:, None, :], (pk, e, 3))
    ajit = tf.uniform(tf.fold_in_words(*base_key, TAG_EDGE2_PHI), (pk, 1),
                      dev)
    phis = (torch.arange(e, device=dev)[None, :] + ajit) * (TWO_PI / e)
    p_sil, val_sil, _ = silhouette_frame(c_sel, r_sel, eye_att, phis)
    w_att = math3.normalize(p_sil - eye_att)  # (P*K, E, 3) attached

    # Curve tangent dw/dphi on the direction sphere (detached chain).
    c_det, r_det = c_sel.detach(), r_sel.detach()

    def w_of_phi(ph):
        pp, _, _ = silhouette_frame(c_det, r_det, eye, ph)
        return math3.normalize(pp - eye)

    _, tau = torch.func.jvp(w_of_phi, (phis,), (torch.ones_like(phis),))
    w_dir = w_att.detach()
    tau_norm = torch.linalg.norm(tau, dim=-1)

    # Outward in-tangent-plane curve normal: perpendicular to tangent and
    # direction, oriented away from the cap axis.
    axis = math3.normalize(c_det - y_rep)
    n_perp = torch.linalg.cross(tau, w_dir, dim=-1)
    outward = torch.sum(n_perp * (w_dir - axis[:, None, :]), dim=-1)
    sign = torch.where(outward >= 0.0, 1.0, -1.0)
    n_perp = (n_perp * sign[..., None]
              / torch.clamp_min(tau_norm, 1e-12)[..., None])

    # Scatter-lobe density at the edge directions; metal also zeroes
    # below-surface directions (the absorb of raytracer.hxx:152-155).
    n_y_rep = torch.repeat_interleave(n_y, k, dim=0)
    axis_rep = torch.repeat_interleave(axis_lobe, k, dim=0)
    f_rep = torch.repeat_interleave(f_lobe, k, dim=0)[:, None]
    dens = lobe_direction_density(w_dir, axis_rep[:, None, :], f_rep,
                                  options.scatter_sample)
    cos_i = torch.sum(w_dir * n_y_rep[:, None, :], dim=-1)
    dens = dens * (cos_i > 0.0)

    # 4. Probe radiance just inside/outside the edge (common random
    # numbers; continuation budget max_depth-1-vertex_depth). DIELECTRIC
    # candidates get the deep inside probe.
    beta_sel = torch.arcsin(sin_b_sel).reshape(pk)[:, None, None]
    delta = torch.clamp_max(0.5 * beta_sel, probe_delta)
    cand_diel = (scene_det.mtype.index_select(
        0, scene_det.material_index.to(torch.int64).index_select(0, j_flat))
        == DIELECTRIC).reshape(pk)[:, None, None]
    delta_in = torch.where(
        cand_diel,
        torch.minimum(torch.maximum(delta, probe_diel_frac * beta_sel),
                      0.49 * beta_sel),
        delta)
    w_in = math3.normalize(w_dir - delta_in * n_perp)
    w_out = math3.normalize(w_dir + delta * n_perp)
    o_rep = torch.broadcast_to(y_rep[:, None, :], (pk, e, 3)).reshape(-1, 3)
    pkeys = _fold_keys(tf.fold_in_words(*base_key, TAG_EDGE2_PROBE),
                       pk * e, dev)
    o_all = torch.cat([o_rep, o_rep])
    d_all = torch.cat([w_in.reshape(-1, 3), w_out.reshape(-1, 3)])
    f_all = trace_fast(scene_det, o_all, d_all, _cat_keys([pkeys, pkeys]),
                       max(max_depth - 1 - vertex_depth, 0),
                       _probe_options(options), rr_qcap=PROBE_RR_QCAP)
    f_in = f_all[:pk * e].reshape(pk, e, 3)
    f_out = f_all[pk * e:].reshape(pk, e, 3)

    # 5. Detached weight; the only attached factor is w(theta).
    thru_rep = torch.repeat_interleave(thru * active[:, None].to(thru.dtype),
                                       k, dim=0)  # (P*K, 3)
    q_pos = q_sel > 0.0
    inv_kq = torch.where(
        q_pos, 1.0 / (k * torch.where(q_pos, q_sel, torch.ones_like(q_sel))),
        torch.zeros_like(q_sel)).reshape(pk)
    w = (torch.sum(thru_rep[:, None, :] * (f_in - f_out), dim=-1)
         * dens * tau_norm * (TWO_PI / e) * inv_kq[:, None])
    valid = val_sil & (tau_norm > 1e-12)
    w = torch.where(valid, w, torch.zeros_like(w)).detach()
    return torch.sum(w * torch.sum(w_att * n_perp.detach(), dim=-1))
