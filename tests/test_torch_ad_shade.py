"""The AD pool's shade op (ops/cuda_ad_shade.py): the shade step and the
regen of the lanes it leaves idle. On the CPU, where the op is its plain
version under autograd: the shade's forward and gradients against the JAX
package's eager shade chain (its ops/wavefront_ad._shade_deposit); with
the regen ("shade_regen" cases), the op against that chain followed by a
regen written here in JAX, and bit for bit against the port's eager pair
(``ad_shade_reference`` then ``regen_reference``); and against finite
differences. On a card: the forward kernel against the plain version, the
adjoint kernel against autograd through it, what an unselected branch
holds, the guarded branches, a fit step's launches, and a fit step against
the eager regen around the shade kernel.

Tolerances, and why:
  * against the JAX package: integer and boolean planes and cells equal;
    floats within rtol 1e-5 / atol 1e-6 (XLA:CPU contracts multiply-adds
    that the port rounds separately, an ulp a product); gradients within
    rtol 1e-5 / atol 1e-5 of the leaf's largest |gradient| (the table's
    leaves are sums over lanes taken in another order);
  * on the CPU, the op against the port's eager pair: bit for bit (the
    same operations);
  * on the card, the forward kernel against the plain version: integers
    equal, floats within rtol 1e-5 / atol 1e-6, on every element; the
    adjoint kernel against autograd through the plain version: every
    element within rtol 1e-4 / atol 1e-5 of the output's largest |value|
    (float32 reassociation), with no exception; a fit step against the
    eager regen around the shade kernel: the same loss, gradients within
    1e-5 of the leaf's largest |gradient| (``index_add_``'s order).

Card tests (marker ``card``) skip without a CUDA device. Only the CPU
tests import JAX (inside them), so on the card the file runs without the
suite's conftest:
    python -m pytest --noconftest -p no:cacheprovider -m card \
        tests/test_torch_ad_shade.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracinginoneweekend_tpu_torch import config, kernels
from raytracinginoneweekend_tpu_torch.models import camera as pcamera
from raytracinginoneweekend_tpu_torch.models import scene as pscene
from raytracinginoneweekend_tpu_torch.ops import cuda_ad_shade as cas
from raytracinginoneweekend_tpu_torch.ops import integrate_planar as ip
from raytracinginoneweekend_tpu_torch.ops import planar, rng
from raytracinginoneweekend_tpu_torch.ops import wavefront_ad as pad
from raytracinginoneweekend_tpu_torch.optim import inverse as pinverse

torch.set_num_threads(2)

MAX_DEPTH = 6
# The pool's waves: lanes past half a pool have no ray in the last wave
# (their next ray is pad, and they park), and every eighth lane has none
# left at all.
WAVES = 3
CASES = ("mixed", "inside_glass", "grazing", "depth_out")
ARMS = {
    "default": {},
    "rr": dict(rr_terminate=True, rr_start=1, rr_scale=1.0),
    "stratified": dict(sampling="stratified"),
    "reference_refract": dict(refract="reference"),
    "cpu_sky": dict(sky="cpu"),
    "ball": dict(scatter_sample="ball"),
    "all": dict(rr_terminate=True, rr_start=2, sampling="stratified",
                refract="reference", sky="cpu", scatter_sample="ball"),
}
# Every material the op branches on: lambert, a mirror, a fuzz-1 metal
# (absorbs often), glass with a hollow inner shell, the ground.
MATERIALS = [(pscene.LAMBERT, (0.1, 0.2, 0.5), 0.0, 1.0),
             (pscene.METAL, (0.8, 0.6, 0.2), 0.0, 1.0),
             (pscene.METAL, (0.7, 0.7, 0.7), 1.0, 1.0),
             (pscene.DIELECTRIC, (1.0, 1.0, 1.0), 0.0, 1.5),
             (pscene.LAMBERT, (0.64, 0.8, 0.0), 0.0, 0.0)]
SPHERES = [((0.0, 0.0, -1.0), 0.5, 0), ((0.0, -100.5, -1.0), 100.0, 4),
           ((1.0, 0.0, -1.0), 0.5, 1), ((1.0, 0.9, -1.6), 0.4, 2),
           ((-1.0, 0.0, -1.0), 0.5, 3), ((-1.0, 0.0, -1.0), -0.45, 3)]
GLASS = 3
LEAVES = ("centers", "radii", "albedo", "fuzz", "ior")
# Values planted where the op must guard them. Each is read by no select
# that keeps it (a miss lane's t and row; the ior of every material but
# glass), or takes a guarded branch (an ior or a radius of 0; a direction
# of length 0, on a fifth of the hit lanes).
PLANTS = ("miss_t", "miss_row", "other_ior", "zero_ior", "glass_zero_ior",
          "zero_radius", "zero_direction")
STRAT_SPP = 4
BASE_WORDS = (0x9E3779B9, 0x7F4A7C15)


@pytest.fixture
def card():
    """The CUDA device, or a skip: the kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _materials_spheres(plant=None):
    """MATERIALS and SPHERES with a plant of the scene's own arrays."""
    mats, sph = list(MATERIALS), list(SPHERES)
    if plant in ("zero_ior", "other_ior"):
        bad = 0.0 if plant == "zero_ior" else float("nan")
        mats = [m if i == GLASS else (*m[:3], bad)
                for i, m in enumerate(mats)]
    elif plant == "glass_zero_ior":
        mats[GLASS] = (*mats[GLASS][:3], 0.0)
    elif plant == "zero_radius":
        sph[0] = (sph[0][0], 0.0, sph[0][2])
    return mats, sph


def _scene(device, plant=None):
    return pscene._build(*_materials_spheres(plant), device)


def _n_rays(lanes: int) -> int:
    return (WAVES - 1) * lanes + lanes // 2


def _pool_ids(state):
    """The state's wave indices made those a pool can hold: a task in
    flight is a real ray (wcur * L + lane < n), and every eighth lane is
    out of rays (nxtw = WAVES)."""
    nxtw, wcur = state[:2]
    lanes = wcur.numel()
    lane = torch.arange(lanes, dtype=torch.int32).reshape(wcur.shape)
    wcur = torch.where(wcur * lanes + lane >= _n_rays(lanes), wcur - 1, wcur)
    nxtw = torch.where(lane % 8 == 0, WAVES, nxtw)
    return (nxtw, wcur, *state[2:])


def _rays(state, strat0, seed: int) -> cas.RayTables:
    """Ray tables for ``state``'s pool (WAVES waves): random origins,
    directions and key words; under stratified sampling each lane's
    ``strat0`` vector at its own ray, wcur * L + lane, where the op reads
    it."""
    g = np.random.default_rng(seed + 100)
    lanes = state[3].numel()
    cells = WAVES * lanes
    floats = torch.from_numpy(g.normal(size=(6, cells)).astype(np.float32))
    if strat0 is not None:
        lane = torch.arange(lanes, device=state[1].device)
        at = (state[1].reshape(-1).to(torch.int64) * lanes + lane).cpu()
        vec = torch.from_numpy(g.normal(scale=0.5, size=(3, cells))
                               .astype(np.float32))
        vec[:, at] = torch.stack([x.reshape(-1).cpu().float()
                                  for x in strat0])
        floats = torch.cat([floats, vec])
    keys = torch.from_numpy(g.integers(-2 ** 31, 2 ** 31, size=(2, cells),
                                       dtype=np.int64).astype(np.int32))
    dev = state[3].device
    return cas.RayTables(floats.to(dev), keys.to(dev))


def _inputs(case: str, seed: int, rows: int = 4, device="cpu",
            stratified: bool = False, plant=None):
    """(table, state, khit, strat0) of one pool iteration: rays of the
    case, their closest hits on ``_scene``, random depths, keys and wave
    indices (``_pool_ids``); then the plant, if any (the hits stay those
    of the scene without it)."""
    g = np.random.default_rng(seed)
    shape = (rows, pad.LANES)
    scene = _scene("cpu")
    if case == "inside_glass":
        # from inside the glass shell: grazing exits reflect totally
        u = g.normal(size=(3,) + shape)
        u /= np.linalg.norm(u, axis=0)
        o = np.array([-1.0, 0.0, -1.0])[:, None, None] + 0.48 * u
        d = g.normal(size=(3,) + shape)
    elif case == "grazing":
        # rays that pass a sphere's centre at 1 - 1e-4 .. 1 + 1e-4 radii
        c = np.array([0.0, 0.0, -1.0])[:, None, None]
        d = g.normal(size=(3,) + shape)
        d /= np.linalg.norm(d, axis=0)
        side = np.cross(d, g.normal(size=(3,) + shape), axis=0)
        side /= np.linalg.norm(side, axis=0)
        b = 0.5 * (1.0 + g.uniform(-1e-4, 1e-4, size=shape))
        o = c + b * side - 2.0 * d
    else:
        o = g.normal(scale=0.8, size=(3,) + shape) + np.array(
            [0.0, 0.3, -1.0])[:, None, None]
        d = g.normal(size=(3,) + shape)
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    o, d = [f32(x) for x in o], [f32(x) for x in d]
    t, sb, hit = ip.closest_hit_planar(tuple(o) + tuple(d),
                                       (scene.centers, scene.radii), 0.008)
    depth = g.integers(0, MAX_DEPTH, size=shape)
    if case == "depth_out":
        depth[:] = MAX_DEPTH - 1
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    keys = g.integers(-2 ** 31, 2 ** 31, size=(2,) + shape)
    state = (i32(g.integers(0, WAVES, size=shape)),
             i32(g.integers(0, WAVES, size=shape)),
             torch.from_numpy(g.uniform(size=shape) < 0.9),
             *o, *d, *(f32(g.uniform(0.05, 1.0, size=shape))
                       for _ in range(3)),
             i32(depth), i32(keys[0]), i32(keys[1]))
    state = _pool_ids(state)
    strat0 = None
    if stratified:
        strat0 = tuple(f32(x) for x in
                       g.normal(scale=0.5, size=(3,) + shape))
    table = ip._material_table(_scene("cpu", plant))
    miss = state[2] & (hit == 0)
    if plant == "miss_t":
        t = torch.where(miss, torch.tensor([float("nan"), float("inf")])
                        .repeat(t.numel() // 2).reshape(t.shape), t)
    elif plant == "miss_row":
        # miss lanes point at a row of NaNs that no hit reads
        table = torch.cat([table, torch.full((1, 10), float("nan"))])
        sb = torch.where(miss, torch.full_like(sb, table.shape[0] - 1), sb)
    elif plant == "zero_direction":
        lanes = torch.arange(t.numel()).reshape(t.shape)
        zero = (hit > 0) & (lanes % 5 == 0)
        state = (*state[:6], *(torch.where(zero, 0.0, x)
                               for x in state[6:9]), *state[9:])
    out = (table, state, (t, sb, hit), strat0)
    return _to(out, device)


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        out = [_to(y, device) for y in x]
        return type(x)(*out) if hasattr(x, "_fields") else tuple(out)
    return x


def _spec(arm: str, lanes: int) -> cas.Spec:
    return cas.Spec(MAX_DEPTH, dataclasses.replace(config.DEFAULT,
                                                   **ARMS[arm]),
                    WAVES * lanes, _n_rays(lanes))


def _kinds(table, state, khit, spec):
    """How many lanes of each kind the inputs hold, read off the plain
    version's next state (Russian roulette off). A kept dielectric lane
    refracted where its new direction goes on through the surface: d . n
    and d' . n of one sign. The regen's kinds: an idle lane acquires its
    next ray, parks (its next ray is pad) or has none left; a fresh lane
    is tracing at depth 0 (the stratified vector's lanes)."""
    t, sb, hit_i = khit
    active, depth = state[2], state[12]
    spec = spec._replace(options=dataclasses.replace(spec.options,
                                                     rr_terminate=False))
    nxt, _dep, _cell = cas.ad_shade_reference(table, state, khit, None, spec)
    keep = nxt[2]
    p = table.index_select(0, sb.reshape(-1).to(torch.int64)).reshape(
        *t.shape, 10)
    mt = p[..., 4].to(torch.int32)
    metal, diel = mt == pscene.METAL, mt == pscene.DIELECTRIC
    hit = hit_i > 0
    on = active & hit & (depth + 1 < spec.max_depth)
    d, o = state[6:9], state[3:6]
    n = [(oc + t * dc - p[..., i]) / p[..., 3]
         for i, (oc, dc) in enumerate(zip(o, d))]
    dn = sum(a * b for a, b in zip(d, n))
    ndn = sum(a * b for a, b in zip(nxt[6:9], n))
    cos2 = dn * dn / sum(a * a for a in d)
    io = p[..., 9]
    ri = torch.where(dn <= 0, 1.0 / io, io)
    tir = 1.0 - ri * ri * (1.0 - cos2) < 0
    nxtw = state[0]
    lanes = nxtw.numel()
    lane = torch.arange(lanes, device=nxtw.device).reshape(nxtw.shape)
    can = ~keep & (nxtw < WAVES)
    in_range = nxtw * lanes + lane < spec.n_rays
    return {
        "miss": int((active & ~hit).sum()),
        "lambert": int((on & ~metal & ~diel).sum()),
        "metal_scatter": int((on & metal & keep).sum()),
        "metal_absorb": int((on & metal & (p[..., 8] > 0) & ~keep).sum()),
        "dielectric_tir": int((on & diel & tir).sum()),
        "dielectric_refract": int((on & diel & keep & ~tir
                                   & ((dn > 0) == (ndn > 0))).sum()),
        "depth_out": int((active & hit
                          & (depth + 1 >= spec.max_depth)).sum()),
        "inactive": int((~active).sum()),
        "acquire": int((can & in_range).sum()),
        "park": int((can & ~in_range).sum()),
        "out_of_work": int((~keep & (nxtw >= WAVES)).sum()),
        "fresh": int((active & (depth == 0)).sum()),
    }


WANT_KINDS = {
    "mixed": ("miss", "lambert", "metal_scatter", "metal_absorb",
              "dielectric_refract", "inactive"),
    "inside_glass": ("dielectric_tir", "dielectric_refract"),
    "grazing": ("miss", "lambert"),
    "depth_out": ("miss", "depth_out"),
}
# ... and the regen's (every depth-out lane is at depth MAX_DEPTH - 1)
REGEN_KINDS = {case: ("acquire", "park", "out_of_work")
               + (("fresh",) if case != "depth_out" else ())
               for case in CASES}


# ---- on the CPU, against the JAX package --------------------------------

def _jax_regen(nxt, rays: cas.RayTables, n: int):
    """The regen of the lanes the JAX package's shade left idle, written
    here in JAX from ops/wavefront_ad._regen's selects, on the ray tables
    -> (the nine float planes, the ints: active, depth, nxtw, wcur, k0,
    k1, busy)."""
    import jax.numpy as jnp

    nxtw, wcur, keep = nxt[:3]
    lanes = nxtw.size
    ray = nxtw * lanes + jnp.arange(lanes, dtype=jnp.int32).reshape(
        nxtw.shape)
    can = ~keep & (nxtw < WAVES)
    acq = can & (ray < n)
    at = jnp.clip(ray, 0, n - 1)
    tf = jnp.asarray(rays.floats.numpy())[:6, at]
    tk = jnp.asarray(rays.keys.numpy().view(np.uint32))[:, at]
    planes = [jnp.where(acq, tf[i], x) for i, x in enumerate(nxt[3:9])]
    planes += [jnp.where(acq, 1.0, x) for x in nxt[9:12]]
    ints = (keep | acq, jnp.where(acq, 0, nxt[12]),
            jnp.where(acq, nxtw + 1, jnp.where(can, WAVES, nxtw)),
            jnp.where(acq, nxtw, wcur), jnp.where(acq, tk[0], nxt[13]),
            jnp.where(acq, tk[1], nxt[14]), keep | (nxtw < WAVES))
    return planes, ints


def _with_jax(case: str, seed: int, arm: str, plant=None,
              regen: bool = False):
    """``_inputs`` (under a stratified arm with the bounce-0 planes that
    the JAX package derives from random (pixel, sample) ids) and, with
    ``regen``, ``_rays`` -> (inputs, ``jax_shade``): ``jax_shade(leaves,
    t, planes)`` runs the JAX package's ``_shade_deposit`` on the same
    inputs, with the scene's five leaves, t and the nine float planes as
    JAX arrays, then, with ``regen``, ``_jax_regen``, and returns (the
    nine next planes and the (3, W*L) wave cells of its ledger, the
    ints: active and depth, with ``regen`` also nxtw, wcur, k0, k1 and
    busy)."""
    import jax.numpy as jnp

    from raytracinginoneweekend_tpu import config as jconfig
    from raytracinginoneweekend_tpu.models import scene as jscene
    from raytracinginoneweekend_tpu.ops import planar as jplanar
    from raytracinginoneweekend_tpu.ops import wavefront_ad as jad

    table, state, khit, _ = _inputs(case, seed, plant=plant)
    shape = tuple(state[3].shape)
    opts = dataclasses.replace(config.DEFAULT, **ARMS[arm])
    jopts = dataclasses.replace(jconfig.DEFAULT, **ARMS[arm])
    k0, k1 = (jnp.asarray(k.numpy().view(np.uint32)) for k in state[13:])
    base = tuple(jnp.uint32(w) for w in BASE_WORDS)
    psid = strat0 = None
    if opts.sampling == "stratified":
        g = np.random.default_rng(seed + 1)
        psid = (jnp.asarray(g.integers(0, 384, shape, dtype=np.int32)),
                jnp.asarray(g.integers(0, STRAT_SPP, shape,
                                       dtype=np.int32)))
        strat0 = tuple(torch.from_numpy(np.array(x)) for x in
                       jplanar.strat0_scatter_planes(
                           k0, k1, *psid, *base, STRAT_SPP,
                           opts.scatter_sample == "unit"))
    rays = _rays(state, strat0, seed) if regen else None
    jscn = jscene._build(*_materials_spheres(plant))
    fixed = [jnp.asarray(x.numpy()) for x in (*state[:3], state[12])]
    sb, hit = (jnp.asarray(x.numpy()) for x in khit[1:])

    def jax_shade(leaves, t, planes):
        st = (*fixed[:3], *planes, fixed[3], k0, k1)
        ledger = tuple(jnp.zeros((WAVES,) + shape, jnp.float32)
                       for _ in range(3))
        nxt, led = jad._shade_deposit(
            jscn._replace(**leaves), jopts, MAX_DEPTH, st, (t, sb, hit),
            ledger, psid, base_words=base, spp=STRAT_SPP)
        out, ints = nxt[3:12], (nxt[2], nxt[12])
        if regen:
            out, ints = _jax_regen(nxt, rays, _n_rays(t.size))
        return (*out, jnp.stack(led).reshape(3, -1)), ints

    return (table, state, khit, strat0, rays), jax_shade


def _eager_pair(table, state, khit, strat0, rays, spec):
    """The port's eager pair: ``ad_shade_reference`` with the test's own
    stratified planes, then ``regen_reference`` -> (state, deposit, cell,
    busy)."""
    nxt, deposit, cell = cas.ad_shade_reference(table, state, khit, strat0,
                                                spec)
    nxt, busy = cas.regen_reference(nxt, rays, n=spec.n_rays, w=WAVES)
    return nxt, deposit, cell, busy


def _port_and_jax(case, seed, arm, plant=None, weights_seed=None,
                  regen=False):
    """The op's CPU path and the JAX package's chain on the same inputs ->
    (port, jax, inputs): each a dict of ``out``, the nine next planes and
    the (3, W*L) wave cells of the ledger; ``ints`` (see ``_with_jax``);
    and, with ``weights_seed``, ``grads``, the gradients of a random
    weighting of ``out`` with respect to the scene's five leaves, t and
    the nine planes. Without ``regen`` the port runs the shade alone
    (``ad_shade_reference``); with it the whole op (``cas.ad_shade``),
    and ``port`` also holds ``pair``: the same outputs and gradients
    through ``_eager_pair``."""
    import jax
    import jax.numpy as jnp

    inp, jax_shade = _with_jax(case, seed, arm, plant, regen)
    table, state, khit, strat0, rays = inp
    lanes = state[3].numel()
    spec = _spec(arm, lanes)
    scene = _scene("cpu", plant)

    def run(shade):
        leaves = {k: getattr(scene, k).clone().requires_grad_(True)
                  for k in LEAVES}
        t = khit[0].clone().requires_grad_(True)
        planes = [p.clone().requires_grad_(True) for p in state[3:12]]
        nxt, deposit, cell, *busy = shade(
            ip._material_table(scene._replace(**leaves)),
            (*state[:3], *planes, *state[12:]), (t, *khit[1:]))
        ledger = torch.index_copy(torch.zeros((3, (WAVES + 1) * lanes)), 1,
                                  cell, deposit)
        assert not bool(ledger[:, WAVES * lanes:].any())  # the dump cells
        out = [*nxt[3:12], ledger[:, :WAVES * lanes]]
        ints = [nxt[2], nxt[12]]
        if regen:
            ints += [nxt[0], nxt[1], nxt[13], nxt[14], busy[0]]
        res = {"out": [x.detach().numpy() for x in out],
               "ints": [x.numpy() for x in ints]}
        if weights_seed is not None:
            g = np.random.default_rng(weights_seed)
            w = [g.standard_normal(x.shape).astype(np.float32) for x in out]
            loss = sum((torch.from_numpy(a) * b).sum()
                       for a, b in zip(w, out))
            res["grads"] = [x.numpy() for x in torch.autograd.grad(
                loss, [*leaves.values(), t, *planes])]
            res["weights"] = w
        return res, leaves, t, planes

    if regen:
        port, leaves, t, planes = run(
            lambda tab, st, kh: cas.ad_shade(tab, st, kh, rays, spec))
        port["pair"] = run(lambda tab, st, kh: _eager_pair(
            tab, st, kh, strat0, rays, spec))[0]
    else:
        port, leaves, t, planes = run(
            lambda tab, st, kh: cas.ad_shade_reference(tab, st, kh, strat0,
                                                       spec))
    jargs = ({k: jnp.asarray(v.detach().numpy()) for k, v in leaves.items()},
             jnp.asarray(t.detach().numpy()),
             [jnp.asarray(p.detach().numpy()) for p in planes])
    jout, vjp, jints = jax.vjp(jax_shade, *jargs, has_aux=True)
    want = {"out": [np.asarray(x) for x in jout],
            "ints": [np.asarray(x) for x in jints]}
    if weights_seed is not None:
        jl, jt, jp = vjp(tuple(jnp.asarray(x) for x in port["weights"]))
        want["grads"] = [np.asarray(x) for x in (*(jl[k] for k in LEAVES),
                                                 jt, *jp)]
    return port, want, inp


INT_NAMES = ("active", "depth", "nxtw", "wcur", "k0", "k1", "busy")


def _assert_forward_equal(port, want, what):
    """The ints equal (``_with_jax``; k0, k1 as bit patterns); the float
    planes and the ledger within rtol 1e-5 / atol 1e-6 (NaN where the
    other has NaN)."""
    assert len(port["ints"]) == len(want["ints"])
    for name, a, b in zip(INT_NAMES, port["ints"], want["ints"]):
        if name in ("k0", "k1"):
            a, b = a.view(np.uint32), b.view(np.uint32)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")
    for i, (a, b) in enumerate(zip(port["out"], want["out"])):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                   equal_nan=True, err_msg=f"{what} out {i}")


def _assert_grads_close(got, want, what):
    names = (*LEAVES, "t", "ox", "oy", "oz", "dx", "dy", "dz", "ax", "ay",
             "az")
    for name, a, b in zip(names, got, want):
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), fin,
                                      err_msg=f"{what} {name}: non-finite")
        scale = float(np.abs(b[fin]).max()) if fin.any() else 0.0
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-5,
                                   atol=1e-5 * max(scale, 1e-30),
                                   err_msg=f"{what} {name}")


def _assert_pair_bit_equal(port, what):
    """The op's outputs (and gradients) and the eager pair's, bit for
    bit."""
    for key in ("out", "ints", "grads"):
        for i, (a, b) in enumerate(zip(port.get(key, ()),
                                       port["pair"].get(key, ()))):
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {key} {i}")


@pytest.mark.parametrize("regen", ["shade", "shade_regen"])
@pytest.mark.parametrize("arm", ["default", "rr", "stratified", "all"])
@pytest.mark.parametrize("case", CASES)
def test_plain_forward_equals_the_eager_chain(case, arm, regen):
    """(a) The op's CPU path (the plain version) against the JAX package's
    eager shade chain on the same inputs, then, in the "shade_regen"
    cases, the regen of ``_jax_regen``: the next state and the ledger, on
    every kind of lane the case is there for, and every kind of lane the
    regen tells apart (an acquire, a park, a lane out of rays, and lanes
    at depth 0, where the stratified arms read the table); and the op
    against the port's eager pair bit for bit."""
    port, want, inp = _port_and_jax(case, 11, arm, regen=regen != "shade")
    table, state, khit = inp[:3]
    kinds = _kinds(table, state, khit, _spec(arm, state[3].numel()))
    for kind in WANT_KINDS[case] + (REGEN_KINDS[case] if regen != "shade"
                                    else ()):
        assert kinds[kind] > 0, (kind, kinds)
    _assert_forward_equal(port, want, f"{case}/{arm}/{regen}")
    if regen != "shade":
        _assert_pair_bit_equal(port, f"{case}/{arm}")


@pytest.mark.parametrize("regen", ["shade", "shade_regen"])
@pytest.mark.parametrize("arm", sorted(ARMS))
@pytest.mark.parametrize("case", CASES)
def test_plain_backward_equals_autograd_through_the_eager_chain(case, arm,
                                                                regen):
    """(b) float32: the gradients of the op's CPU path (autograd through
    the plain version) against ``jax.vjp`` through the JAX package's eager
    chain (and ``_jax_regen``), per leaf: the scene's five leaves, t and
    the nine planes; with the regen, also bit for bit against autograd
    through the port's eager pair."""
    port, want, _ = _port_and_jax(case, 5, arm, weights_seed=3,
                                  regen=regen != "shade")
    _assert_grads_close(port["grads"], want["grads"], f"{case}/{arm}")
    if regen != "shade":
        _assert_pair_bit_equal(port, f"{case}/{arm}")


@pytest.mark.parametrize("regen", ["shade", "shade_regen"])
@pytest.mark.parametrize("arm", ["default", "stratified",
                                 "reference_refract", "ball"])
@pytest.mark.parametrize("case", ["mixed", "inside_glass"])
def test_plain_backward_passes_gradcheck_in_float64(case, arm, regen):
    """(b) float64: the op's CPU gradient against finite differences on a
    tiny pool (16 lanes), the material type column held out (a step of it
    is a step of material); "shade" is the shade alone, "shade_regen" the
    whole op, across its acquire mask (lanes that acquire and lanes that
    keep the shade's values). Russian roulette is not among the arms: the
    op holds its q constant, as the contract says, and finite differences
    do not; the float32 comparison covers it."""
    table, state, khit, strat0 = _inputs(
        case, 2, stratified=ARMS[arm].get("sampling") == "stratified")
    sl = (slice(0, 2), slice(0, 8))
    state = _pool_ids(tuple(s[sl].contiguous() for s in state))
    khit = tuple(k[sl].contiguous() for k in khit)
    if strat0 is not None:
        strat0 = tuple(s[sl].contiguous() for s in strat0)
    spec = _spec(arm, state[3].numel())
    rays = _rays(state, strat0, 2)
    if regen != "shade":
        kinds = _kinds(table, state, khit, spec)
        assert 0 < kinds["acquire"] < state[3].numel(), kinds
    if strat0 is not None:
        strat0 = tuple(s.double() for s in strat0)

    mtype = table[:, 4:5].double()

    def fn(tab, t, *planes):
        st = (*state[:3], *planes, *state[12:])
        tab = torch.cat([tab[:, :4], mtype, tab[:, 4:]], dim=1)
        if regen == "shade":
            nxt, deposit, _ = cas.ad_shade_reference(
                tab, st, (t, *khit[1:]), strat0, spec)
        else:
            nxt, deposit, _, _ = cas.ad_shade(tab, st, (t, *khit[1:]), rays,
                                              spec)
        return (*nxt[3:12], deposit)

    table = torch.cat([table[:, :4], table[:, 5:]], dim=1)
    args = [table.double(), khit[0].double(),
            *(p.double() for p in state[3:12])]
    args = [a.requires_grad_(True) for a in args]
    assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-5,
                                    rtol=1e-4)


@pytest.mark.parametrize("plant", ["miss_t", "zero_ior", "glass_zero_ior",
                                   "zero_radius", "zero_direction"])
def test_guarded_branches_match_jax(plant):
    """The op's CPU path against the JAX package where a guard decides:
    planted values (``PLANTS``) give the same next state, ledger and
    gradients, NaN where JAX's autodiff gives NaN. (A NaN row or a NaN ior
    is left to the card test: the JAX package's one-hot gather spreads a
    NaN row to every lane.)"""
    port, want, _ = _port_and_jax("mixed", 7, "default", plant,
                                  weights_seed=4)
    _assert_forward_equal(port, want, plant)
    _assert_grads_close(port["grads"], want["grads"], plant)


def test_no_kernel_for_another_device():
    """A tensor on neither the CPU nor a card is refused, not computed."""
    table, state, khit, _ = _inputs("mixed", 1, rows=1)
    rays = _rays(state, None, 1)
    table, state, khit, rays = _to((table, state, khit, rays), "meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        cas.ad_shade(table, state, khit, rays, _spec("default", 128))


def test_too_many_wave_cells_are_refused():
    """The kernel's config holds the ledger's wave cells in 32 bits: a
    ledger past that is refused, not wrapped."""
    table, state, khit, _ = _inputs("mixed", 1, rows=1)
    spec = _spec("default", 128)._replace(w_cells=2 ** 31)
    with pytest.raises(ValueError, match="wave cells"):
        _kernel_forward(table, state, khit, _rays(state, None, 1), spec)


# ---- on the card --------------------------------------------------------

def _card_inputs(case, seed, arm, rows, device, plant=None):
    """``_inputs`` and ``_rays`` on the card -> (table, state, khit,
    rays)."""
    table, state, khit, strat0 = _inputs(
        case, seed, rows=rows, device=device, plant=plant,
        stratified=ARMS[arm].get("sampling") == "stratified")
    return table, state, khit, _rays(state, strat0, seed)


def _forward_outputs(table, state, khit, rays, spec):
    """The plain version's outputs in the kernel wrapper's order."""
    nxt, deposit, cell, busy = cas.op_reference(table, state, khit, rays,
                                                spec)
    return (*nxt[3:12], deposit, nxt[0], nxt[1], nxt[12], nxt[13], nxt[14],
            nxt[2], busy, cell)


def _kernel_forward(table, state, khit, rays, spec):
    return cas.ad_shade_cuda(table, khit[0], state[3:12], khit[1], khit[2],
                             state[2], state[12], state[0], state[1],
                             state[13], state[14], rays, spec)


def _assert_forward_class(got, want, what):
    """Integer and boolean planes and cells equal; floats within rtol 1e-5
    / atol 1e-6 on every element (NaN where the plain version has NaN)."""
    assert len(got) == len(want) == 18
    for i in range(10, 18):
        assert torch.equal(got[i], want[i]), (what, i)
    for i in range(10):
        bad = ~torch.isclose(got[i], want[i], rtol=1e-5, atol=1e-6,
                             equal_nan=True)
        assert int(bad.sum()) == 0, (
            what, i, int(bad.sum()),
            float((got[i] - want[i]).abs().nan_to_num().max()))


def _adjoint_pair(table, state, khit, rays, spec, seed):
    """The adjoint kernel's gradients and autograd's through the plain
    version, for one random weighting of the outputs -> (got, want), each
    [the table's, t's, the nine planes'] (the table's summed by sphere)."""
    dev = table.device
    g = torch.Generator(device=dev).manual_seed(seed)
    lanes = state[3].numel()
    g_out = [torch.randn(state[3].shape, generator=g, device=dev)
             for _ in range(9)]
    g_out.append(torch.randn((3, lanes), generator=g, device=dev))
    leaves = [table.clone().requires_grad_(True),
              khit[0].clone().requires_grad_(True),
              *(p.clone().requires_grad_(True) for p in state[3:12])]
    nxt, deposit, _, _ = cas.op_reference(
        leaves[0], (*state[:3], *leaves[2:], *state[12:]),
        (leaves[1], *khit[1:]), rays, spec)
    want = torch.autograd.grad([*nxt[3:12], deposit], leaves, g_out)
    g_planes, g_t, rows = cas.ad_shade_grad_cuda(
        table, khit[0], state[3:12], khit[1], khit[2], state[2], state[12],
        state[0], state[1], state[13], state[14], rays, g_out[:9], g_out[9],
        spec)
    g_table = torch.zeros_like(table).index_add_(
        0, khit[1].reshape(-1).to(torch.int64), rows)
    return [g_table, g_t, *g_planes], list(want)


def _assert_adjoint_class(got, want, what):
    """Every element of every gradient finite and within rtol 1e-4 / atol
    1e-5 of the output's largest |value|, where autograd's is finite."""
    for i, (a, b) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(a).all()), (what, i)
        fin = torch.isfinite(b)
        scale = float(b[fin].abs().max()) if bool(fin.any()) else 0.0
        bad = fin & ~torch.isclose(a, b, rtol=1e-4, atol=1e-5 * scale)
        assert int(bad.sum()) == 0, (
            what, i, int(bad.sum()),
            float((a - b)[fin].abs().max()) / max(scale, 1e-30))


@pytest.mark.card
@pytest.mark.parametrize("arm", sorted(ARMS))
@pytest.mark.parametrize("case", CASES)
def test_card_forward_kernel_matches_the_plain_version(card, case, arm):
    """The forward kernel, shade and regen, against the plain version on
    the same CUDA inputs, with every kind of lane the regen tells
    apart."""
    inp = _card_inputs(case, 21, arm, 256, card)
    spec = _spec(arm, inp[1][3].numel())
    kinds = _kinds(*inp[:3], spec)
    for kind in REGEN_KINDS[case]:
        assert kinds[kind] > 0, (kind, kinds)
    before = kernels.LAUNCHES["ad_shade"]
    got = _kernel_forward(*inp, spec)
    assert kernels.LAUNCHES["ad_shade"] == before + 1
    want = _forward_outputs(*inp, spec)
    torch.cuda.synchronize()
    _assert_forward_class(got, want, f"{case}/{arm}")


@pytest.mark.card
@pytest.mark.parametrize("arm", sorted(ARMS))
@pytest.mark.parametrize("case", CASES)
def test_card_adjoint_kernel_matches_the_plain_version(card, case, arm):
    """The adjoint kernel against autograd through the plain version on
    the same CUDA inputs."""
    inp = _card_inputs(case, 23, arm, 256, card)
    spec = _spec(arm, inp[1][3].numel())
    got, want = _adjoint_pair(*inp, spec, seed=1)
    torch.cuda.synchronize()
    _assert_adjoint_class(got, want, f"{case}/{arm}")


@pytest.mark.card
@pytest.mark.parametrize("plant", PLANTS)
def test_an_unselected_branch_leaks_no_nan(card, plant):
    """(c) A NaN or inf planted where a select leaves it unread, or a
    value that takes a guarded branch (``PLANTS``): the forward kernel
    gives the plain version's outputs, and the adjoint kernel's gradients
    are finite everywhere and equal autograd's wherever that is finite
    (autograd carries a NaN from an unselected branch as 0 * NaN; the
    kernel's selects never read it)."""
    inp = _card_inputs("mixed", 7, "default", 64, card, plant=plant)
    table, state, khit, rays = inp
    assert int((state[2] & (khit[2] == 0)).sum()) > 0
    spec = _spec("default", state[3].numel())
    _assert_forward_class(_kernel_forward(*inp, spec),
                          _forward_outputs(*inp, spec), plant)
    got, want = _adjoint_pair(*inp, spec, seed=2)
    torch.cuda.synchronize()
    _assert_adjoint_class(got, want, plant)


def _card_fit(card, options):
    """A pool fit step's set-up on the card -> (scene, camera, pixel ids,
    target, render_loss's keywords)."""
    w, h, spp = 32, 24, 4
    sc = _scene(card)
    cam = pcamera.reference_cuda_camera(w, h, card)
    ids = torch.arange(0, w * h, 3, dtype=torch.int32, device=card)
    kw = dict(width=w, height=h, spp=spp, max_depth=12, camera_mode="cuda",
              options=options)
    return sc, cam, ids, torch.full((ids.numel(), 3), 0.3, device=card), kw


@pytest.mark.card
@pytest.mark.parametrize("rr", [False, True], ids=["rr_off", "rr_on"])
def test_card_fit_step_runs_the_op_and_never_the_eager_chain(card, rr,
                                                            monkeypatch):
    """A fit step through the pool on the card: one forward launch an
    iteration and one more as the checkpoint recomputes it, one adjoint
    launch an iteration, the closest hit once an iteration (never again
    in the backward), no eager shade op, and the eager regen once, before
    the first iteration: never inside an epoch."""
    sc, cam, ids, target, kw = _card_fit(
        card, dataclasses.replace(config.DEFAULT, rr_terminate=rr))
    budget = pad.wavefront_ad_budget(sc, cam, ids, (0, 9), pool_size=512,
                                     **kw)

    def eager(*a, **k):
        raise AssertionError("the eager shade chain ran on the card")

    for mod, name in ((cas, "ad_shade_reference"), (cas, "op_reference"),
                      (cas, "strat0_reference"),
                      (cas, "scatter_planar_ad"),
                      (cas, "shade_geometry_planar"),
                      (planar, "bounce_draws"), (rng, "rr_terminate_update")):
        monkeypatch.setattr(mod, name, eager)
    regens = []
    real_regen = cas.regen_reference

    def counted_regen(*a, **k):
        regens.append(kernels.LAUNCHES["closest_hit"])
        return real_regen(*a, **k)

    monkeypatch.setattr(cas, "regen_reference", counted_regen)
    params = pinverse.params_from_scene(sc, ("albedo", "centers"))
    kernels.reset_launches()
    loss = pinverse.render_loss(params, sc, cam, target, ids, (0, 9),
                                engine="wavefront",
                                engine_opts=dict(pool_size=512), **kw)
    n_forward = kernels.LAUNCHES["closest_hit"]
    assert n_forward == budget > 0
    assert kernels.LAUNCHES["ad_shade"] == n_forward
    loss.backward()
    torch.cuda.synchronize()
    assert regens == [0]
    assert kernels.LAUNCHES["closest_hit"] == n_forward
    assert kernels.LAUNCHES["ad_shade"] == 2 * n_forward
    assert kernels.LAUNCHES["ad_shade_grad"] == n_forward
    assert sum(kernels.LAUNCHES.values()) == 4 * n_forward
    for k, v in params.items():
        assert bool(torch.isfinite(v.grad).all()), k
        assert float(v.grad.abs().max()) > 0, k


def _shade_then_eager_regen(table, rays, spec, state, khit, ledger):
    """ops/wavefront_ad._shade_deposit as it was before the op took the
    regen over: the shade alone (the op given no waves left, so that no
    lane acquires or parks and its adjoint masks nothing; then the real
    nxtw put back), and the eager ``regen_reference``, whose selects
    autograd differentiates."""
    nxtw = state[0]
    waves = spec.w_cells // nxtw.numel()
    nxt, deposit, cell, _ = cas.ad_shade(
        table, (torch.full_like(nxtw, waves), *state[1:]), khit, rays, spec)
    nxt, busy = cas.regen_reference((nxtw, *nxt[1:]), rays, n=spec.n_rays,
                                    w=waves)
    return nxt, torch.index_copy(ledger, 1, cell, deposit), busy


@pytest.mark.card
@pytest.mark.parametrize("arm", ["default", "all"])
def test_card_fit_step_equals_the_eager_regen_around_the_shade_kernel(
        card, arm, monkeypatch):
    """One fit step from one state, with the regen inside the op and with
    the eager regen around the shade kernel (how the pool ran before):
    the same loss bit for bit, and gradients within 1e-5 of each leaf's
    largest |gradient| (``index_add_``'s atomic order)."""
    options = dataclasses.replace(config.DEFAULT, **ARMS[arm])
    sc, cam, ids, target, kw = _card_fit(card, options)

    def step():
        params = pinverse.params_from_scene(sc, ("albedo", "centers"))
        loss = pinverse.render_loss(params, sc, cam, target, ids, (0, 9),
                                    engine="wavefront",
                                    engine_opts=dict(pool_size=512), **kw)
        loss.backward()
        return float(loss.detach()), {k: v.grad for k, v in params.items()}

    loss, grads = step()
    monkeypatch.setattr(pad, "_shade_deposit", _shade_then_eager_regen)
    want_loss, want = step()
    assert loss == want_loss
    for k, g in grads.items():
        scale = float(want[k].abs().max())
        assert scale > 0, k
        assert float((g - want[k]).abs().max()) <= 1e-5 * scale, k


@pytest.mark.card
def test_card_tensors_launch_or_raise(card, monkeypatch):
    """On a CUDA tensor the op launches its kernel or raises: it never
    falls back to the plain version."""
    table, state, khit, rays = _card_inputs("mixed", 3, "default", 2, card)

    def refused(name):
        def fn(*a):
            return 1  # cudaErrorInvalidValue
        return fn

    monkeypatch.setattr(kernels, "entry", refused)
    with pytest.raises(RuntimeError, match="failed to launch"):
        cas.ad_shade(table, state, khit, rays, _spec("default", 256))
