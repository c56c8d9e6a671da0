"""Differentiable inverse rendering.

Counterpart of ``raytracinginoneweekend_tpu/optim/inverse.py``. Pipeline:
pick the differentiable subset of scene leaves (centers, radii, albedo,
fuzz, ior), render a random pixel minibatch with a reverse-mode engine, L2
against the target pixels, Adam update.

Monte-Carlo gradient discipline: each step re-renders the *same* pixels
with the *same* keys as the target comparison, so the stochastic estimator
is consistent (the loss is exactly differentiable at fixed RNG; sphere
silhouettes are discontinuous only on a measure-zero set).

PyTorch's idiom where it differs from the JAX package's:
  * parameters are a ``{name: tensor}`` dict of leaf tensors with
    ``requires_grad``; a ``torch.optim`` optimiser is bound to them, holds
    its own state and updates the tensors in place, so a train step
    returns the loss only;
  * the optimiser is ``Adam``, this module's ``torch.optim.Optimizer``
    with ``optax.adam``'s float32 arithmetic in the order XLA runs it
    inside the JAX package's jitted train step (see ``Adam``);
  * ``fit``'s draws are jax.random's: each step's pixel batch is
    ``choice(fold_in(fold_in(base, i), 0), n_pixels, (batch,),
    replace=False)`` (``draw_pixel_batch``, on the step's device), and
    the render key ``fold_in(fold_in(base, i), 1)``. So a whole ``fit``
    draws the JAX package's pixel ids bit for bit and follows its
    trajectory up to the float32 rounding of the gradients.

The gradient surrogates are carried (``boundary_samples``,
``secondary_samples`` with ``secondary_spheres`` /
``secondary_vertex_depths``, ``rr_grad`` with ``rr_grad_arms``:
ops/silhouette.py, ops/branchprob.py); each enters the loss as
``s - s.detach()``, so the value is the plain loss and only the gradient
changes.

``mesh=`` (parallel/mesh.py) splits the interior batch over the mesh's
workers, as the JAX package's shard_map does; the surrogates stay
unsharded. In one process each worker renders its shard from the
parameters moved to its device and autograd sums the shards' gradients.
Under a process group each rank renders its own workers' shards: the loss
is normalised by the global batch, the train step all-reduces the
parameter gradients once after the backward pass
(``all_reduce_gradients``), and the surrogates -- on the whole batch --
are attached on the rank that holds worker 0 only.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from ..config import RenderConfig
from ..models.camera import Camera
from ..models.scene import Scene
from ..ops import threefry as tf
from ..ops.math3 import fma_rn, sqrt_rn
from ..ops.rng import _f32
from ..render import render_pixels_impl
from ..utils.device import resolve_device

DIFFERENTIABLE_LEAVES = ("centers", "radii", "albedo", "fuzz", "ior")


def params_from_scene(scene: Scene,
                      which: Iterable[str] = DIFFERENTIABLE_LEAVES) -> dict:
    """Extract the optimizable parameters: a {name: leaf tensor} dict.
    Each tensor is a detached copy of the scene's with ``requires_grad``
    (an optimiser updates it in place; the scene stays as it was)."""
    which = tuple(which)
    bad = set(which) - set(DIFFERENTIABLE_LEAVES)
    if bad:
        raise ValueError(f"non-differentiable scene leaves: {sorted(bad)}")
    return {name: getattr(scene, name).detach().clone().requires_grad_(True)
            for name in which}


def params_from_numpy(arrays: dict, device=None) -> dict:
    """{name: numpy array} -> {name: float32 leaf tensor with
    ``requires_grad``} on ``device`` (None = the CUDA card). Carries the
    JAX package's parameter dict across."""
    device = resolve_device(device)
    bad = set(arrays) - set(DIFFERENTIABLE_LEAVES)
    if bad:
        raise ValueError(f"non-differentiable scene leaves: {sorted(bad)}")
    return {name: torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
            .requires_grad_(True) for name, a in arrays.items()}


def scene_with_params(scene: Scene, params: dict) -> Scene:
    """Rebuild a Scene with the optimized leaves substituted in."""
    return scene._replace(**params)


# ---------------------------------------------------------------------------
# Adam state <-> optax's (count, mu, nu)
# ---------------------------------------------------------------------------

def _bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay**count`` in float32: the float64 power rounded
    to float32, then the float32 subtraction -- XLA:CPU's value at every
    count tests/test_torch_fit_draws.py checks (1 to 2000)."""
    return _f32(np.float32(1.0) - np.float32(
        np.float64(np.float32(decay)) ** count))


class Adam(torch.optim.Optimizer):
    """``optax.adam(lr, b1, b2, eps)`` as the JAX package's train step runs
    it: every operation in float32, with an int32 step count. XLA:CPU
    fuses optax's update and ``apply_updates`` into

        mu = g * (1 - b1) + mu * b1          (one fused multiply-add)
        nu = g * g * (1 - b2) + nu * b2      (one fused multiply-add)
        count = count + 1
        u  = mu / ((1 - b1**count) * (sqrt(nu / (1 - b2**count)) + eps))
        p  = u * (-lr) + p                   (one fused multiply-add)

    -- the bias corrections in float32, and mu_hat / (sqrt(nu_hat) + eps)
    regrouped by XLA's simplifier into one division. The result is
    bit-equal with ``jax.jit`` of optax's update on the CPU
    (tests/test_torch_fit_draws.py); op by op, un-jitted, optax rounds
    otherwise, within 1e-4 * lr over ten steps. The state is kept in
    ``torch.optim.Adam``'s names (``step``, ``exp_avg``, ``exp_avg_sq``), so
    ``adam_state_to_numpy`` / ``adam_state_from_numpy`` and the checkpoint
    carry it across to optax's (count, mu, nu)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.int32)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                count = min(int(st["step"]) + 1, 2 ** 31 - 1)
                st["step"] = torch.tensor(count, dtype=torch.int32)
                g = p.grad
                mu = fma_rn(g, _f32(1.0 - b1), st["exp_avg"] * _f32(b1))
                nu = fma_rn(g * g, _f32(1.0 - b2), st["exp_avg_sq"] * _f32(b2))
                # device tensors, not Python scalars: CUDA divides by a
                # host scalar through its reciprocal
                c1 = torch.full((), _bias_correction(b1, count),
                                device=p.device)
                c2 = torch.full((), _bias_correction(b2, count),
                                device=p.device)
                u = mu / (c1 * (sqrt_rn(nu / c2) + _f32(group["eps"])))
                p.copy_(fma_rn(u, _f32(-group["lr"]), p))
                st["exp_avg"], st["exp_avg_sq"] = mu, nu


def make_adam(params: dict, learning_rate: float) -> Adam:
    """``Adam`` over the parameter dict (sorted names) with the constants
    of ``optax.adam(learning_rate)``: b1 0.9, b2 0.999, eps 1e-8."""
    return Adam([params[k] for k in sorted(params)], lr=learning_rate)


def _param_slots(optimizer: torch.optim.Optimizer, params: dict) -> dict:
    """{name: index of the tensor in the optimiser's state_dict}."""
    flat = [p for g in optimizer.param_groups for p in g["params"]]
    slots = {}
    for name, p in params.items():
        hits = [i for i, q in enumerate(flat) if q is p]
        if len(hits) != 1:
            raise ValueError(f"parameter {name!r} is not bound to the "
                             "optimiser exactly once")
        slots[name] = hits[0]
    return slots


def adam_state_to_numpy(optimizer: torch.optim.Optimizer,
                        params: dict) -> dict:
    """The optimiser's state as optax lays Adam's out:
    ``{"count": int32 scalar, "mu": {name: array}, "nu": {name: array}}``
    (``count`` = steps taken, ``mu``/``nu`` = first/second moments; zeros
    before the first step)."""
    state = optimizer.state_dict()["state"]
    count, mu, nu = 0, {}, {}
    for name, slot in _param_slots(optimizer, params).items():
        st = state.get(slot)
        if st:
            count = int(st["step"])
            mu[name] = st["exp_avg"].detach().cpu().numpy().copy()
            nu[name] = st["exp_avg_sq"].detach().cpu().numpy().copy()
        else:
            zeros = np.zeros(tuple(params[name].shape), np.float32)
            mu[name], nu[name] = zeros, zeros.copy()
    return {"count": np.asarray(count, np.int32), "mu": mu, "nu": nu}


def adam_state_from_numpy(optimizer: torch.optim.Optimizer, params: dict,
                          state: dict) -> None:
    """Load optax-layout Adam state (``adam_state_to_numpy``'s form, or
    optax's ``ScaleByAdamState`` fields as numpy) into the optimiser,
    through its ``state_dict``."""
    sd = optimizer.state_dict()
    count = float(np.asarray(state["count"]))
    for name, slot in _param_slots(optimizer, params).items():
        p = params[name]
        sd["state"][slot] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": torch.from_numpy(np.array(
                state["mu"][name], dtype=np.float32)).to(p.device),
            "exp_avg_sq": torch.from_numpy(np.array(
                state["nu"][name], dtype=np.float32)).to(p.device),
        }
    optimizer.load_state_dict(sd)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

AD_ENGINE_AUTO_DEPTH = 32
"""max_depth above which 'auto' picks the regenerative wavefront engine.
The value is the JAX package's, carried so that 'auto' resolves to the
same engine in both packages. scripts/torch_ad_crossover.py measures the
two engines on an NVIDIA card (PERF.md: on an H100 the pool at its default
size is the slower one at every depth measured, 16 to 50)."""

AD_ENGINE_AUTO_DEPTH_RR = 28
"""The same threshold with rr_terminate=True; the JAX package's value
(see AD_ENGINE_AUTO_DEPTH)."""


def resolve_ad_engine(max_depth: int, rr_terminate: bool = False) -> str:
    """'auto' policy: the fixed-depth planar engine at low depth, the
    regenerative pool past AD_ENGINE_AUTO_DEPTH (or the lower
    AD_ENGINE_AUTO_DEPTH_RR when the estimator terminates paths)."""
    cut = AD_ENGINE_AUTO_DEPTH_RR if rr_terminate else AD_ENGINE_AUTO_DEPTH
    return "wavefront" if max_depth > cut else "planar"


def _grouped(mesh) -> bool:
    """The mesh spans several processes."""
    return mesh is not None and mesh.group is not None


def _render_batch(full_scene, cam, pixel_ids, base_key, *, width, height,
                  spp, max_depth, camera_mode, options, engine, mesh=None,
                  engine_opts=None):
    """Differentiable pixel batch via the chosen AD engine -> the radiance
    of pixel_ids[lo:hi] (``_rows``): the whole batch, but under a process
    group this rank's workers' shards."""
    if engine == "auto":
        engine = resolve_ad_engine(max_depth, options.rr_terminate)
    if engine == "planar":
        from ..ops.integrate_planar import render_pixels_planar_impl
        impl = render_pixels_planar_impl
    elif engine == "wavefront":
        # The regenerative pool (ops/wavefront_ad.py): wavefront occupancy
        # under reverse mode, the deep-path engine.
        from ..ops.wavefront_ad import render_pixels_wavefront_ad_impl
        impl = render_pixels_wavefront_ad_impl
    elif engine == "tiled":
        impl = render_pixels_impl
    else:
        raise ValueError(f"unknown AD engine: {engine!r}")
    kwargs = dict(width=width, height=height, spp=spp,
                  max_depth=max_depth, camera_mode=camera_mode,
                  options=options, differentiable=True)
    if engine_opts:
        # Engine-specific knobs (e.g. the planar engine's sample_offset /
        # spp_strata, the regenerative pool's pool_size / iters / remat).
        kwargs.update(engine_opts)
    if engine == "tiled":
        kwargs["wave_spp"] = spp
    if mesh is None:
        return impl(full_scene, cam, pixel_ids, base_key, **kwargs)
    from ..utils.device import on_device

    per = _rows(mesh, pixel_ids.shape[0])[2]
    outs = []
    for g, dev in mesh.workers():
        with on_device(dev):
            outs.append(impl(full_scene.to(dev), cam.to(dev),
                             pixel_ids[g * per:(g + 1) * per].to(dev),
                             base_key, **kwargs).to(mesh.devices[0]))
    return torch.cat(outs)


def _rows(mesh, n: int) -> tuple:
    """(lo, hi, per): the rows of an n-pixel batch that this process
    renders (all n but under a process group) and the rows a worker."""
    if mesh is None:
        return 0, n, n
    if n % mesh.size:
        raise ValueError(f"a batch of {n} pixels does not divide over a "
                         f"mesh of {mesh.size} workers")
    per = n // mesh.size
    if not _grouped(mesh):
        return 0, n, per
    return mesh.first * per, (mesh.first + len(mesh.devices)) * per, per


def all_reduce_gradients(params: dict, mesh) -> None:
    """Sum the parameters' ``.grad`` over the ranks of the mesh, in place
    (nothing without a process group): what a caller of ``render_loss``
    under a process group does after its backward pass, as the train step
    does."""
    if not _grouped(mesh):
        return
    from ..parallel.mesh import all_reduce_sum

    for p in params.values():
        if p.grad is not None:
            p.grad.copy_(all_reduce_sum(mesh, p.grad))


def _whole_batch(mesh, part: torch.Tensor) -> torch.Tensor:
    """Under a process group the ranks' detached rows gathered in order
    (each rank holds its workers' rows); else ``part`` itself."""
    if not _grouped(mesh):
        return part
    from ..parallel.mesh import gather_workers

    return torch.cat(gather_workers(mesh, [part]))


def _surrogates_here(mesh) -> bool:
    """The surrogates (on the whole batch) are attached once: in one
    process, or under a process group on the rank of worker 0."""
    return not _grouped(mesh) or mesh.first == 0


def _attach_surrogates(value, cot, full_scene, cam, camera_mode, pixel_ids,
                       base_key, *, width, height, max_depth, options,
                       boundary_samples, secondary_samples,
                       secondary_spheres, secondary_vertex_depths, rr_grad,
                       rr_grad_arms=2):
    """Add the zero-valued surrogate terms whose GRADIENTS carry the
    boundary (silhouette/shadow/rough-reflection) and delta-lobe (RR
    branch-flip) contributions interior AD cannot see.

    cot: (P, 3) detached d(value)/d(pixel) weights for pixel_ids. Each
    surrogate enters as ``value + s - s.detach()`` (the JAX package's
    order of operations), so the value is unchanged and only the gradient
    is augmented. The key words of each term are the JAX package's:
    ``fold_in(base, 0x51170)`` (boundary), ``fold_in(fold_in(base,
    0x51171), TAG_EDGE2_DEPTH + b)`` (secondary at vertex depth b) and
    ``fold_in(fold_in(base, 0x51172), TAG_RR_DEPTH + b)`` (rr_grad).
    """
    if boundary_samples:
        from ..ops.silhouette import boundary_surrogate

        # d(value)/dI for each batch pixel, scattered into a dense image
        # so edge samples can look their pixel up (pixels outside the
        # batch contribute nothing). pixel_ids must be unique.
        cot_image = torch.zeros((width * height, 3), dtype=cot.dtype,
                                device=cot.device)
        cot_image.index_copy_(0, pixel_ids.to(torch.int64), cot)
        sur = boundary_surrogate(
            full_scene, cam, camera_mode, cot_image, width, height,
            tf.fold_in_words(*base_key, 0x51170), max_depth, options,
            n_angles=boundary_samples)
        value = value + sur - sur.detach()
    if secondary_samples:
        from ..ops.silhouette import (TAG_EDGE2_DEPTH,
                                      secondary_boundary_surrogate)

        k2 = tf.fold_in_words(*base_key, 0x51171)
        for b in range(secondary_vertex_depths):
            if max_depth - 1 - b <= 0:
                break  # no continuation budget left: the term is 0
            sur2 = secondary_boundary_surrogate(
                full_scene, cam, camera_mode, cot, pixel_ids, width,
                height, tf.fold_in_words(*k2, TAG_EDGE2_DEPTH + b),
                max_depth, options, n_angles=secondary_samples,
                n_spheres=secondary_spheres, vertex_depth=b)
            value = value + sur2 - sur2.detach()
    if rr_grad:
        from ..ops.branchprob import (TAG_RR_DEPTH,
                                      branch_probability_surrogate)

        # The grazing-entry gate (boundary_rim_frac) is never threaded
        # here: it is an ablation of the JAX package's ownership study.
        k3 = tf.fold_in_words(*base_key, 0x51172)
        for b in range(max(secondary_vertex_depths, 1)):
            if max_depth - 1 - b <= 0:
                break
            sur3 = branch_probability_surrogate(
                full_scene, cam, camera_mode, cot, pixel_ids, width,
                height, tf.fold_in_words(*k3, TAG_RR_DEPTH + b),
                max_depth, options, vertex_depth=b,
                chain_rr_arms=rr_grad_arms)
            value = value + sur3 - sur3.detach()
    return value


def render_loss(params: dict, scene: Scene, cam: Camera, target_pixels,
                pixel_ids, base_key, *, width: int, height: int, spp: int,
                max_depth: int, camera_mode: str, options, mesh=None,
                boundary_samples: int = 0, secondary_samples: int = 0,
                secondary_spheres: int = 2,
                secondary_vertex_depths: int = 1, rr_grad: bool = False,
                rr_grad_arms: int = 2, engine: str = "auto",
                engine_opts: dict | None = None):
    """Mean-squared error between rendered and target pixel radiance: a
    scalar tensor, differentiable w.r.t. the tensors of ``params``.

    target_pixels: (P, 3) linear radiance for the same pixel_ids (a (P,)
    i32 tensor); base_key: the (k0, k1) base-key words. Everything lies on
    the device of the scene.

    engine: "auto" (resolve_ad_engine picks by max_depth: the fixed-depth
    planar engine up to the crossover depth; above it the regenerative
    pool), "planar" ((R, 128) planes + the hand-written closest-hit kernel
    under autograd, ops/integrate_planar.py), "wavefront" (the
    regenerative pool with the same kernel, ops/wavefront_ad.py) or
    "tiled" (the (N, 3) engine). Same RNG contract, radiance agrees to
    float32 reassociation.

    boundary_samples > 0 adds the edge-sampled silhouette boundary term
    (ops/silhouette.boundary_surrogate, that many edge samples a sphere)
    to the loss GRADIENT (the value is unchanged): interior AD alone
    cannot move a silhouette. secondary_samples > 0 adds the ONE-BOUNCE
    boundary term (shadow and rough-reflection edges seen from lambert /
    fuzzy-metal path vertices; that many silhouette angles a candidate,
    ``secondary_spheres`` candidates a vertex) at vertex depths 0 ..
    ``secondary_vertex_depths`` - 1 (depths without continuation budget
    are skipped). rr_grad=True adds the dielectric branch-flip and
    direction-sweep term (ops/branchprob.py) at the same depths, with
    ``rr_grad_arms`` internal-RR reflection arms a refract chain. On the
    card the probe traces take the intersect kernel when
    ``options.intersect == "pallas"``.

    mesh: split the batch over a parallel/mesh.py mesh (its size must
    divide it). Under a process group every rank passes the whole batch,
    the value is the global loss, and the gradient is this rank's share:
    sum it over the ranks with ``all_reduce_gradients`` (the train step
    does).
    """
    full_scene = scene_with_params(scene, params)
    lo, hi, _ = _rows(mesh, pixel_ids.shape[0])
    rendered = _render_batch(
        full_scene, cam, pixel_ids, base_key, width=width, height=height,
        spp=spp, max_depth=max_depth, camera_mode=camera_mode,
        options=options, engine=engine, mesh=mesh, engine_opts=engine_opts)
    diff = rendered - target_pixels[lo:hi].to(rendered.device)
    grouped = _grouped(mesh)
    # under a process group this rank's share of the global mean
    loss = (torch.sum(diff * diff) / target_pixels.numel() if grouped
            else torch.mean(diff * diff))
    if boundary_samples or secondary_samples or rr_grad:
        # every rank gathers (a collective); one attaches
        cot = 2.0 * _whole_batch(mesh, diff.detach()) / target_pixels.numel()
        if _surrogates_here(mesh):
            loss = _attach_surrogates(
                loss, cot, full_scene, cam, camera_mode, pixel_ids,
                base_key, width=width, height=height, max_depth=max_depth,
                options=options, boundary_samples=boundary_samples,
                secondary_samples=secondary_samples,
                secondary_spheres=secondary_spheres,
                secondary_vertex_depths=secondary_vertex_depths,
                rr_grad=rr_grad, rr_grad_arms=rr_grad_arms)
    if not grouped:
        return loss
    # the value is the global loss on every rank (x - x is 0 exactly), the
    # gradient this rank's share (all_reduce_gradients sums them)
    from ..parallel.mesh import all_reduce_sum

    return all_reduce_sum(mesh, loss.detach()) + (loss - loss.detach())


def render_pixels_vjp(params: dict, scene: Scene, cam: Camera, cotangent,
                      pixel_ids, base_key, *, width: int, height: int,
                      spp: int, max_depth: int, camera_mode: str, options,
                      mesh=None, boundary_samples: int = 0,
                      secondary_samples: int = 0, secondary_spheres: int = 2,
                      secondary_vertex_depths: int = 1,
                      rr_grad: bool = False, rr_grad_arms: int = 2,
                      engine: str = "auto",
                      engine_opts: dict | None = None):
    """Direct pixel-Jacobian VJP: d<cotangent, I(params)>/d(params).

    For an ARBITRARY per-pixel cotangent u (P, 3) -- a one-hot u selects a
    single d(pixel)/d(param) row -- returns (grads, pixels): the gradient
    of sum(u * I) as a {name: tensor} dict and the rendered (P, 3) batch
    (detached). No target/MSE is involved; the surrogate terms are folded
    in, weighted by the caller's cotangent. All keyword knobs mean what
    they mean in render_loss.
    """
    full_scene = scene_with_params(scene, params)
    lo, hi, _ = _rows(mesh, pixel_ids.shape[0])
    rendered = _render_batch(
        full_scene, cam, pixel_ids, base_key, width=width, height=height,
        spp=spp, max_depth=max_depth, camera_mode=camera_mode,
        options=options, engine=engine, mesh=mesh, engine_opts=engine_opts)
    cot = torch.as_tensor(cotangent, dtype=torch.float32,
                          device=rendered.device).detach()
    value = torch.sum(rendered * cot[lo:hi])
    if _surrogates_here(mesh):
        value = _attach_surrogates(
            value, cot, full_scene, cam, camera_mode, pixel_ids, base_key,
            width=width, height=height, max_depth=max_depth,
            options=options, boundary_samples=boundary_samples,
            secondary_samples=secondary_samples,
            secondary_spheres=secondary_spheres,
            secondary_vertex_depths=secondary_vertex_depths,
            rr_grad=rr_grad, rr_grad_arms=rr_grad_arms)
    names = list(params)
    # under a process group a rank without the surrogates may not reach
    # every leaf: its share of that gradient is zero
    grads = torch.autograd.grad(value, [params[k] for k in names],
                                allow_unused=_grouped(mesh))
    grads = {k: torch.zeros_like(params[k]) if g is None else g
             for k, g in zip(names, grads)}
    if _grouped(mesh):
        from ..parallel.mesh import all_reduce_sum

        grads = {k: all_reduce_sum(mesh, g) for k, g in grads.items()}
    return grads, _whole_batch(mesh, rendered.detach())


def make_train_step(optimizer: torch.optim.Optimizer, *, width: int,
                    height: int, spp: int, max_depth: int, camera_mode: str,
                    options, mesh=None, boundary_samples: int = 0,
                    secondary_samples: int = 0, secondary_spheres: int = 2,
                    secondary_vertex_depths: int = 1, rr_grad: bool = False,
                    rr_grad_arms: int = 2, engine: str = "auto",
                    engine_opts: dict | None = None):
    """Build ``step(params, scene, cam, target_pixels, pixel_ids,
    base_key) -> loss``.

    ``optimizer`` is a ``torch.optim`` optimiser bound to the tensors of
    the ``params`` dict the step will be called with (``make_adam``). One
    step: forward render, backward pass (rematerialised per bounce inside
    the engine), optimiser update IN PLACE on the parameter tensors. The
    loss comes back as a detached scalar tensor on the device; nothing is
    read to the host.
    """
    def step(params, scene, cam, target_pixels, pixel_ids, base_key):
        optimizer.zero_grad(set_to_none=True)
        loss = render_loss(
            params, scene, cam, target_pixels, pixel_ids, base_key,
            width=width, height=height, spp=spp, max_depth=max_depth,
            camera_mode=camera_mode, options=options, mesh=mesh,
            boundary_samples=boundary_samples,
            secondary_samples=secondary_samples,
            secondary_spheres=secondary_spheres,
            secondary_vertex_depths=secondary_vertex_depths,
            rr_grad=rr_grad, rr_grad_arms=rr_grad_arms, engine=engine,
            engine_opts=engine_opts)
        loss.backward()
        all_reduce_gradients(params, mesh)
        optimizer.step()
        return loss.detach()

    return step


def step_keys(base_key, i: int):
    """The keys of train step ``i`` -> (batch_key, render_key): words of
    ``fold_in(fold_in(base, i), 0)`` and ``fold_in(fold_in(base, i), 1)``,
    the JAX package's bit for bit."""
    kstep = tf.fold_in_words(*base_key, i)
    return tf.fold_in_words(*kstep, 0), tf.fold_in_words(*kstep, 1)


def draw_pixel_batch(batch_key, n_pixels: int, batch_pixels: int,
                     device) -> torch.Tensor:
    """``batch_pixels`` distinct pixel ids, an i32 tensor on ``device``:
    ``jax.random.choice(batch_key, n_pixels, (batch_pixels,),
    replace=False)``, the JAX package's draw bit for bit, made on the
    device (ops/threefry.choice_without_replacement: two stable sorts of
    n_pixels u32 keys at 1200x800)."""
    return tf.choice_without_replacement(
        batch_key, n_pixels, batch_pixels, device).to(torch.int32)


def fit(scene: Scene, cam: Camera, target_image, cfg: RenderConfig, *,
        which: Iterable[str] = DIFFERENTIABLE_LEAVES, steps: int = 200,
        learning_rate: float = 1e-2, batch_pixels: int = 4096,
        spp: int | None = None, base_key=None, mesh=None,
        callback=None, init_params: dict | None = None,
        init_opt_state: dict | None = None, start_step: int = 0,
        boundary_samples: int = 0, secondary_samples: int = 0,
        secondary_spheres: int = 2, secondary_vertex_depths: int = 1,
        rr_grad: bool = False, rr_grad_arms: int = 2, engine: str = "auto",
        engine_opts: dict | None = None, device=None):
    """Optimize scene params toward a target image.

    target_image: (H, W, 3) linear radiance (as produced by render.render).
    Runs on ``device`` (None = the CUDA card, or with ``mesh`` the mesh's
    first device; scene, camera and target are moved there). ``mesh``
    splits each step's batch over its workers (the module docstring;
    batch_pixels is rounded to the mesh's multiple). Returns (optimized_scene, params, optimizer, losses):
    ``optimizer`` is the bound ``torch.optim`` optimiser, which holds the
    optimiser state (``adam_state_to_numpy`` reads it).

    base_key: the (k0, k1) base-key words (None = those of seed 7). The
    optimiser is ``make_adam(params, learning_rate)``.
    ``init_params`` / ``init_opt_state`` / ``start_step`` resume from a
    checkpoint (optim.checkpoint.load_checkpoint gives all three).
    callback(i, params, optimizer, loss) runs after every step; reading
    the loss as a float there, as ``fit`` itself does for ``losses``, is
    one device->host read per step.
    """
    if device is None and mesh is not None:
        device = mesh.devices[0]
    device = resolve_device(device)
    scene, cam = scene.to(device), cam.to(device)
    if base_key is None:
        base_key = tf.key_words(7)
    spp = spp or cfg.spp
    if init_params is not None:
        params = {k: v.detach().to(device).clone().requires_grad_(True)
                  for k, v in init_params.items()}
    else:
        params = params_from_scene(scene, which)
    opt = make_adam(params, learning_rate)
    if init_opt_state is not None:
        adam_state_from_numpy(opt, params, init_opt_state)

    target_flat = torch.as_tensor(target_image, dtype=torch.float32,
                                  device=device).reshape(-1, 3)
    n_pixels = cfg.width * cfg.height
    # the draw takes distinct pixels: clamp for small images, then round to
    # the mesh's multiple (down where up would overflow again), as JAX does
    batch_pixels = min(batch_pixels, n_pixels)
    if mesh is not None:
        up = -(-batch_pixels // mesh.size) * mesh.size
        batch_pixels = up if up <= n_pixels else (
            (batch_pixels // mesh.size) * mesh.size)
        if batch_pixels <= 0:
            raise ValueError(
                f"image of {n_pixels} pixels is smaller than the "
                f"{mesh.size}-worker mesh batch granularity")

    step_fn = make_train_step(
        opt, width=cfg.width, height=cfg.height, spp=spp,
        max_depth=cfg.max_depth, camera_mode=cfg.camera_mode,
        options=cfg.options, mesh=mesh,
        boundary_samples=boundary_samples,
        secondary_samples=secondary_samples,
        secondary_spheres=secondary_spheres,
        secondary_vertex_depths=secondary_vertex_depths,
        rr_grad=rr_grad, rr_grad_arms=rr_grad_arms, engine=engine,
        engine_opts=engine_opts)

    losses = []
    for i in range(start_step, start_step + steps):
        batch_key, render_key = step_keys(base_key, i)
        pixel_ids = draw_pixel_batch(batch_key, n_pixels, batch_pixels,
                                     device)
        target_batch = target_flat.index_select(0, pixel_ids.to(torch.int64))
        loss = step_fn(params, scene, cam, target_batch, pixel_ids,
                       render_key)
        losses.append(float(loss))
        if callback is not None:
            callback(i, params, opt, losses[-1])
    return scene_with_params(scene, params), params, opt, losses
