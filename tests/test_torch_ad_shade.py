"""The AD pool's shade op (ops/cuda_ad_shade.py). On the CPU, where the op
is its plain version under autograd: the forward and the gradients against
the JAX package's eager shade chain (its ops/wavefront_ad._shade_deposit)
and against finite differences. On a card: the forward kernel against the
plain version, the adjoint kernel against autograd through it, what an
unselected branch holds, the guarded branches, and a fit step's launches.

Tolerances, and why:
  * against the JAX package: integer and boolean planes and cells equal;
    floats within rtol 1e-5 / atol 1e-6 (XLA:CPU contracts multiply-adds
    that the port rounds separately, an ulp a product); gradients within
    rtol 1e-5 / atol 1e-5 of the leaf's largest |gradient| (the table's
    leaves are sums over lanes taken in another order);
  * on the card, the forward kernel against the plain version: integers
    equal, floats within rtol 1e-5 / atol 1e-6, on every element; the
    adjoint kernel against autograd through the plain version: every
    element within rtol 1e-4 / atol 1e-5 of the output's largest |value|
    (float32 reassociation), with no exception.

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


def _inputs(case: str, seed: int, rows: int = 4, device="cpu",
            stratified: bool = False, plant=None):
    """(table, state, khit, strat0) of one pool iteration: rays of the
    case, their closest hits on ``_scene``, random depths, keys and wave
    indices; then the plant, if any (the hits stay those of the scene
    without it)."""
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
        return tuple(_to(y, device) for y in x)
    return x


def _spec(arm: str, lanes: int) -> cas.Spec:
    return cas.Spec(MAX_DEPTH, dataclasses.replace(config.DEFAULT,
                                                   **ARMS[arm]),
                    WAVES * lanes)


def _kinds(table, state, khit, spec):
    """How many lanes of each kind the inputs hold, read off the plain
    version's next state (Russian roulette off). A kept dielectric lane
    refracted where its new direction goes on through the surface: d . n
    and d' . n of one sign."""
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
    }


WANT_KINDS = {
    "mixed": ("miss", "lambert", "metal_scatter", "metal_absorb",
              "dielectric_refract", "inactive"),
    "inside_glass": ("dielectric_tir", "dielectric_refract"),
    "grazing": ("miss", "lambert"),
    "depth_out": ("miss", "depth_out"),
}


# ---- on the CPU, against the JAX package --------------------------------

def _with_jax(case: str, seed: int, arm: str, plant=None):
    """``_inputs`` (under a stratified arm with the bounce-0 planes that
    the JAX package derives from random (pixel, sample) ids) -> (inputs,
    ``jax_shade``): ``jax_shade(leaves, t, planes)`` runs the JAX
    package's ``_shade_deposit`` on the same inputs, with the scene's five
    leaves, t and the nine float planes as JAX arrays, and returns (the
    nine next planes and the (3, W*L) wave cells of its ledger, (keep,
    depth))."""
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
        return (*nxt[3:12], jnp.stack(led).reshape(3, -1)), (nxt[2],
                                                              nxt[12])

    return (table, state, khit, strat0), jax_shade


def _port_and_jax(case, seed, arm, plant=None, weights_seed=None):
    """The op's CPU path (ops/wavefront_ad._shade_deposit) and the JAX
    package's on the same inputs -> (port, jax, inputs): each a dict of
    ``out``, the nine next planes and the (3, W*L) wave cells of the
    ledger; ``ints``, keep and depth; and, with ``weights_seed``,
    ``grads``, the gradients of a random weighting of ``out`` with respect
    to the scene's five leaves, t and the nine planes."""
    import jax
    import jax.numpy as jnp

    inp, jax_shade = _with_jax(case, seed, arm, plant)
    table, state, khit, strat0 = inp
    lanes = state[3].numel()
    spec = _spec(arm, lanes)
    scene = _scene("cpu", plant)
    leaves = {k: getattr(scene, k).clone().requires_grad_(True)
              for k in LEAVES}
    t = khit[0].clone().requires_grad_(True)
    planes = [p.clone().requires_grad_(True) for p in state[3:12]]
    ledger = torch.zeros((3, (WAVES + 1) * lanes))
    nxt, ledger = pad._shade_deposit(
        ip._material_table(scene._replace(**leaves)), spec.options,
        MAX_DEPTH, (*state[:3], *planes, *state[12:]), (t, *khit[1:]),
        ledger, strat0)
    assert not bool(ledger[:, WAVES * lanes:].any())  # the dump cells
    out = [*nxt[3:12], ledger[:, :WAVES * lanes]]
    port = {"out": [x.detach().numpy() for x in out],
            "ints": [nxt[2].numpy(), nxt[12].numpy()]}
    jargs = ({k: jnp.asarray(v.detach().numpy()) for k, v in leaves.items()},
             jnp.asarray(t.detach().numpy()),
             [jnp.asarray(p.detach().numpy()) for p in planes])
    jout, vjp, jints = jax.vjp(jax_shade, *jargs, has_aux=True)
    want = {"out": [np.asarray(x) for x in jout],
            "ints": [np.asarray(x) for x in jints]}
    if weights_seed is not None:
        g = np.random.default_rng(weights_seed)
        w = [g.standard_normal(x.shape).astype(np.float32)
             for x in want["out"]]
        loss = sum((torch.from_numpy(a) * b).sum() for a, b in zip(w, out))
        port["grads"] = [x.numpy() for x in torch.autograd.grad(
            loss, [*leaves.values(), t, *planes])]
        jl, jt, jp = vjp(tuple(jnp.asarray(x) for x in w))
        want["grads"] = [np.asarray(x) for x in (*(jl[k] for k in LEAVES),
                                                 jt, *jp)]
    return port, want, inp


def _assert_forward_equal(port, want, what):
    """keep and depth equal; the float planes and the ledger within rtol
    1e-5 / atol 1e-6 (NaN where the other has NaN)."""
    for name, a, b in zip(("keep", "depth"), port["ints"], want["ints"]):
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


@pytest.mark.parametrize("arm", ["default", "rr", "stratified", "all"])
@pytest.mark.parametrize("case", CASES)
def test_plain_forward_equals_the_eager_chain(case, arm):
    """(a) The op's CPU path (the plain version, through
    ops/wavefront_ad._shade_deposit) against the JAX package's eager
    shade chain on the same inputs: the next state and the ledger, on
    every kind of lane the case is there for."""
    port, want, inp = _port_and_jax(case, 11, arm)
    table, state, khit, _ = inp
    kinds = _kinds(table, state, khit, _spec(arm, state[3].numel()))
    for kind in WANT_KINDS[case]:
        assert kinds[kind] > 0, (kind, kinds)
    _assert_forward_equal(port, want, f"{case}/{arm}")


@pytest.mark.parametrize("arm", sorted(ARMS))
@pytest.mark.parametrize("case", CASES)
def test_plain_backward_equals_autograd_through_the_eager_chain(case, arm):
    """(b) float32: the gradients of the op's CPU path (autograd through
    the plain version) against ``jax.vjp`` through the JAX package's eager
    chain, per leaf: the scene's five leaves, t and the nine planes."""
    port, want, _ = _port_and_jax(case, 5, arm, weights_seed=3)
    _assert_grads_close(port["grads"], want["grads"], f"{case}/{arm}")


@pytest.mark.parametrize("arm", ["default", "stratified",
                                 "reference_refract", "ball"])
@pytest.mark.parametrize("case", ["mixed", "inside_glass"])
def test_plain_backward_passes_gradcheck_in_float64(case, arm):
    """(b) float64: the op's CPU gradient against finite differences on a
    tiny pool (16 lanes), the material type column held out (a step of it
    is a step of material). Russian roulette is not among the arms: the op
    holds its q constant, as the contract says, and finite differences do
    not; the float32 comparison covers it."""
    table, state, khit, strat0 = _inputs(
        case, 2, stratified=ARMS[arm].get("sampling") == "stratified")
    sl = (slice(0, 2), slice(0, 8))
    state = tuple(s[sl] for s in state)
    khit = tuple(k[sl] for k in khit)
    if strat0 is not None:
        strat0 = tuple(s[sl].double() for s in strat0)
    spec = _spec(arm, state[3].numel())

    mtype = table[:, 4:5].double()

    def fn(tab, t, *planes):
        st = (*state[:3], *planes, *state[12:])
        tab = torch.cat([tab[:, :4], mtype, tab[:, 4:]], dim=1)
        nxt, deposit, _ = cas.ad_shade(tab, st, (t, *khit[1:]), strat0,
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
    table, state, khit, strat0 = _to(_inputs("mixed", 1, rows=1), "meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        cas.ad_shade(table, state, khit, strat0, _spec("default", 128))


def test_too_many_wave_cells_are_refused():
    """The kernel's config holds the ledger's wave cells in 32 bits: a
    ledger past that is refused, not wrapped."""
    table, state, khit, strat0 = _inputs("mixed", 1, rows=1)
    spec = _spec("default", 128)._replace(w_cells=2 ** 31)
    with pytest.raises(ValueError, match="wave cells"):
        cas.ad_shade_cuda(table, khit[0], state[3:12], khit[1], khit[2],
                          state[2], state[12], state[1], state[13],
                          state[14], strat0, spec)


# ---- on the card --------------------------------------------------------

def _forward_outputs(table, state, khit, strat0, spec):
    """The plain version's outputs in the kernel wrapper's order."""
    nxt, deposit, cell = cas.ad_shade_reference(table, state, khit, strat0,
                                                spec)
    return (*nxt[3:12], nxt[2], nxt[12], deposit, cell)


def _kernel_forward(table, state, khit, strat0, spec):
    return cas.ad_shade_cuda(table, khit[0], state[3:12], khit[1], khit[2],
                             state[2], state[12], state[1], state[13],
                             state[14], strat0, spec)


def _assert_forward_class(got, want, what):
    """Integer and boolean planes and cells equal; floats within rtol 1e-5
    / atol 1e-6 on every element (NaN where the plain version has NaN)."""
    for i in (9, 10, 12):
        assert torch.equal(got[i], want[i]), (what, i)
    for i in (*range(9), 11):
        bad = ~torch.isclose(got[i], want[i], rtol=1e-5, atol=1e-6,
                             equal_nan=True)
        assert int(bad.sum()) == 0, (
            what, i, int(bad.sum()),
            float((got[i] - want[i]).abs().nan_to_num().max()))


def _adjoint_pair(table, state, khit, strat0, spec, seed):
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
    nxt, deposit, _ = cas.ad_shade_reference(
        leaves[0], (*state[:3], *leaves[2:], *state[12:]),
        (leaves[1], *khit[1:]), strat0, spec)
    want = torch.autograd.grad([*nxt[3:12], deposit], leaves, g_out)
    g_planes, g_t, rows = cas.ad_shade_grad_cuda(
        table, khit[0], state[3:12], khit[1], khit[2], state[2], state[12],
        state[13], state[14], strat0, g_out[:9], g_out[9], spec)
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
    inp = _inputs(case, 21, rows=256, device=card,
                  stratified=ARMS[arm].get("sampling") == "stratified")
    spec = _spec(arm, inp[1][3].numel())
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
    inp = _inputs(case, 23, rows=256, device=card,
                  stratified=ARMS[arm].get("sampling") == "stratified")
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
    inp = _inputs("mixed", 7, rows=64, device=card, plant=plant)
    table, state, khit, strat0 = inp
    assert int((state[2] & (khit[2] == 0)).sum()) > 0
    spec = _spec("default", state[3].numel())
    _assert_forward_class(_kernel_forward(*inp, spec),
                          _forward_outputs(*inp, spec), plant)
    got, want = _adjoint_pair(*inp, spec, seed=2)
    torch.cuda.synchronize()
    _assert_adjoint_class(got, want, plant)


@pytest.mark.card
@pytest.mark.parametrize("rr", [False, True], ids=["rr_off", "rr_on"])
def test_card_fit_step_runs_the_op_and_never_the_eager_chain(card, rr,
                                                            monkeypatch):
    """A fit step through the pool on the card: one forward launch an
    iteration and one more as the checkpoint recomputes it, one adjoint
    launch an iteration, the closest hit once an iteration (never again
    in the backward), and no eager shade op."""
    w, h, spp = 32, 24, 4
    sc = _scene(card)
    cam = pcamera.reference_cuda_camera(w, h, card)
    ids = torch.arange(0, w * h, 3, dtype=torch.int32, device=card)
    options = dataclasses.replace(config.DEFAULT, rr_terminate=rr)
    kw = dict(width=w, height=h, spp=spp, max_depth=12, camera_mode="cuda",
              options=options)
    budget = pad.wavefront_ad_budget(sc, cam, ids, (0, 9), pool_size=512,
                                     **kw)

    def eager(*a, **k):
        raise AssertionError("the eager shade chain ran on the card")

    for mod, name in ((cas, "ad_shade_reference"),
                      (cas, "scatter_planar_ad"),
                      (cas, "shade_geometry_planar"),
                      (planar, "bounce_draws"), (rng, "rr_terminate_update")):
        monkeypatch.setattr(mod, name, eager)
    params = pinverse.params_from_scene(sc, ("albedo", "centers"))
    kernels.reset_launches()
    loss = pinverse.render_loss(
        params, sc, cam, torch.full((ids.numel(), 3), 0.3, device=card),
        ids, (0, 9), engine="wavefront",
        engine_opts=dict(pool_size=512), **kw)
    n_forward = kernels.LAUNCHES["closest_hit"]
    assert n_forward == budget > 0
    assert kernels.LAUNCHES["ad_shade"] == n_forward
    loss.backward()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["closest_hit"] == n_forward
    assert kernels.LAUNCHES["ad_shade"] == 2 * n_forward
    assert kernels.LAUNCHES["ad_shade_grad"] == n_forward
    for k, v in params.items():
        assert bool(torch.isfinite(v.grad).all()), k
        assert float(v.grad.abs().max()) > 0, k


@pytest.mark.card
def test_card_tensors_launch_or_raise(card, monkeypatch):
    """On a CUDA tensor the op launches its kernel or raises: it never
    falls back to the plain version."""
    table, state, khit, strat0 = _inputs("mixed", 3, rows=2, device=card)

    def refused(name):
        def fn(*a):
            return 1  # cudaErrorInvalidValue
        return fn

    monkeypatch.setattr(kernels, "entry", refused)
    with pytest.raises(RuntimeError, match="failed to launch"):
        cas.ad_shade(table, state, khit, strat0, _spec("default", 256))
