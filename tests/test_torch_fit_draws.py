"""PyTorch port vs the JAX package: fit's draws and updates, and whole fits.

``ops/threefry.py``'s split, permutation, choice and normal against
jax.random on the CPU (jax_threefry_partitionable, the conftest's setting);
``optim.inverse.draw_pixel_batch`` against ``fit``'s
``jax.random.choice``; the port's ``Adam`` against optax.adam; a whole API
``fit``, the CLI's ``fit``, a JAX checkpoint resumed by the port, and the
committed fit golden, against the JAX package.

Tolerances: every integer (split keys, permutations, pixel ids) is
bit-equal, with no tolerance; ``normal`` is bit-equal (0 ulps: XLA:CPU's
erf_inv, log1p and log with its fused multiply-adds); Adam is bit-equal
with ``jax.jit`` of optax's update (the form the JAX package's train step
runs) and within 1e-4 * lr of optax op by op (XLA regroups the jitted
update). Whole
fits: pixel ids bit-equal at every step, the perturbation bit-equal,
losses rtol 1e-5, parameters the train step's rtol 1e-4 / atol 2e-6
compounded once every three steps (``golden.fit_tolerance``); the
gradients' float32 sums are the only difference left.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raytracinginoneweekend_tpu import config as jconfig
from raytracinginoneweekend_tpu import optim as joptim
from raytracinginoneweekend_tpu.models import camera as jcamera
from raytracinginoneweekend_tpu.models import scene as jscene
from raytracinginoneweekend_tpu.render import render as jrender
from raytracinginoneweekend_tpu_torch import cli as pcli
from raytracinginoneweekend_tpu_torch import config as pconfig
from raytracinginoneweekend_tpu_torch import golden
from raytracinginoneweekend_tpu_torch import optim as poptim
from raytracinginoneweekend_tpu_torch.models import camera as pcamera
from raytracinginoneweekend_tpu_torch.models import scene as pscene
from raytracinginoneweekend_tpu_torch.ops import threefry as ptf
from raytracinginoneweekend_tpu_torch.optim import inverse as pinverse

torch.set_num_threads(2)


def _words(jkey):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(jkey)))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


# ---------------------------------------------------------------------------
# jax.random's host-side layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 - 1])
def test_split_matches_jax(seed):
    want = [_words(k) for k in jax.random.split(jax.random.key(seed), 5)]
    assert ptf.split(ptf.key_words(seed), 5) == want
    # a chain of splits, as the CLI's perturbation takes them
    jk, pk = jax.random.key(seed), ptf.key_words(seed)
    for _ in range(3):
        jk, jsub = jax.random.split(jk)
        pk, psub = ptf.split(pk)
        assert (pk, psub) == (_words(jk), _words(jsub))


@pytest.mark.parametrize("seed,n", [(0, 1), (3, 100), (5, 1536), (5, 1626),
                                    (9, 20000), (1, 100000)])
def test_permutation_matches_jax(seed, n):
    """One round up to n = 1625, two from 1626 (ceil(3 ln n / ln(2^32 - 1)));
    the integers are JAX's bit for bit."""
    got = ptf.permutation(ptf.key_words(seed), n, "cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.random.permutation(jax.random.key(seed),
                                                       n)))


def test_permutation_ties_need_the_stable_sort():
    """At n = 100000 and seed 1 both rounds draw colliding u32 keys (3 and
    2 pairs); JAX's order keeps the tied elements in place (a stable sort),
    and breaking the ties the other way gives another permutation."""
    n, key = 100000, ptf.key_words(1)
    x = torch.arange(n)
    rev = torch.arange(n)
    ties = []
    for _ in range(2):
        key, sub = ptf.split(key)
        bits = ptf.random_bits(sub, (n,), "cpu")
        ties.append(n - torch.unique(bits).numel())
        x = x[torch.sort(bits, stable=True)[1]]
        # the same keys with ties broken by descending position
        order = np.lexsort((-np.arange(n), bits.numpy()))
        rev = rev[torch.from_numpy(order)]
    assert ties == [3, 2]
    want = np.asarray(jax.random.permutation(jax.random.key(1), n))
    np.testing.assert_array_equal(x.numpy(), want)
    assert not np.array_equal(rev.numpy(), want)


@pytest.mark.parametrize("seed,n,k", [(0, 384, 128), (4, 1536, 512),
                                      (11, 30000, 4096), (2, 7, 7)])
def test_choice_without_replacement_matches_jax(seed, n, k):
    got = ptf.choice_without_replacement(ptf.key_words(seed), n, k, "cpu")
    want = jax.random.choice(jax.random.key(seed), n, (k,), replace=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="without replacement"):
        ptf.choice_without_replacement(ptf.key_words(seed), n, n + 1, "cpu")


@pytest.mark.parametrize("seed,shape", [(0, (100000,)), (1, (489, 3)),
                                        (8, (5,)), (2, (33, 7, 2))])
def test_normal_matches_jax_bit_for_bit(seed, shape):
    got = ptf.normal(ptf.key_words(seed), shape, "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
    assert int(_ulps(got.numpy(), want).max()) == 0


def test_erf_inv_log1p_log_are_xla_cpus():
    """The three float32 functions under ``normal`` against XLA:CPU's, on
    both branches of each (log1p's |x| < sqrt(2) - 1, erf_inv's w < 5) and
    on the edges; torch.erfinv / torch.log1p round otherwise."""
    g = np.random.default_rng(0)
    x = np.concatenate([
        g.uniform(-1, 1, 20000),
        1.0 - 10.0 ** g.uniform(-7, -1, 2000),       # w >= 5
        -(1.0 - 10.0 ** g.uniform(-7, -1, 2000)),
        [0.0, -0.0, 1.0, -1.0, np.nextafter(np.float32(-1), 0)]]
    ).astype(np.float32)
    want = np.asarray(jax.jit(jax.lax.erf_inv)(x))
    got = ptf.erf_inv(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    y = (-(x * x)[np.abs(x) < 1]).astype(np.float32)
    np.testing.assert_array_equal(ptf.xla_log1p(torch.from_numpy(y)).numpy(),
                                  np.asarray(jax.jit(jnp.log1p)(y)))
    z = np.concatenate([g.uniform(1e-6, 4, 20000),
                        10.0 ** g.uniform(-30, 30, 2000)]).astype(np.float32)
    np.testing.assert_array_equal(ptf.xla_log(torch.from_numpy(z)).numpy(),
                                  np.asarray(jax.jit(jnp.log)(z)))
    # the library functions the port does not use differ on these inputs
    assert (torch.erfinv(torch.from_numpy(x[np.abs(x) < 1])).numpy()
            != want[np.abs(x) < 1]).any()


@pytest.mark.parametrize("seed,step,n,k", [(7, 0, 384, 128), (7, 5, 384, 128),
                                           (0, 3, 1536, 512),
                                           (123, 1, 30000, 16384)])
def test_draw_pixel_batch_is_fits_choice(seed, step, n, k):
    """The pixel batch of step ``step`` as the JAX package's ``fit`` draws
    it: choice(fold_in(fold_in(base, i), 0), n, (k,), replace=False)."""
    kstep = jax.random.fold_in(jax.random.key(seed), step)
    want = jax.random.choice(jax.random.fold_in(kstep, 0), n, (k,),
                             replace=False).astype(jnp.int32)
    batch_key, _ = pinverse.step_keys(ptf.key_words(seed), step)
    got = pinverse.draw_pixel_batch(batch_key, n, k, torch.device("cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------

def _adam_case():
    g = np.random.default_rng(0)
    p0 = {"albedo": g.random((40, 3), dtype=np.float32),
          "centers": g.normal(size=(60, 3)).astype(np.float32)}
    # gradients over seven decades, so that some moments sit near eps
    grads = [{k: (g.normal(size=v.shape)
                  * 10.0 ** g.uniform(-6, 1, v.shape)).astype(np.float32)
              for k, v in p0.items()} for _ in range(10)]
    return p0, grads


@pytest.mark.parametrize("lr", [1e-2, 3e-2])
def test_adam_matches_optax_over_ten_steps(lr):
    p0, grads = _adam_case()
    opt = optax.adam(lr)

    def update(p, s, g):
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s

    jitted = jax.jit(update)
    params = poptim.params_from_numpy(p0, device="cpu")
    adam = pinverse.make_adam(params, lr)
    pj = pe = {k: jnp.asarray(v) for k, v in p0.items()}
    sj = se = opt.init(pj)
    for gr in grads:
        gj = {k: jnp.asarray(v) for k, v in gr.items()}
        pj, sj = jitted(pj, sj, gj)
        pe, se = update(pe, se, gj)
        for k, p in params.items():
            p.grad = torch.from_numpy(gr[k])
        adam.step()
        for k, p in params.items():
            got = p.detach().numpy()
            assert int(_ulps(got, np.asarray(pj[k])).max()) == 0, k
            np.testing.assert_allclose(got, np.asarray(pe[k]), rtol=0,
                                       atol=1e-4 * lr, err_msg=k)
    state = poptim.adam_state_to_numpy(adam, params)
    assert state["count"].dtype == np.int32 and int(state["count"]) == 10
    for k in p0:
        np.testing.assert_array_equal(state["mu"][k], np.asarray(sj[0].mu[k]))
        np.testing.assert_array_equal(state["nu"][k], np.asarray(sj[0].nu[k]))


def test_adam_bias_correction_is_float32():
    """optax's 1 - b**count in float32, not double: at count 3, b2 0.999,
    the float32 value differs from the double one by ~2e-5 relative."""
    assert pinverse._bias_correction(0.999, 3) != 1.0 - 0.999 ** 3
    want = np.asarray(jax.jit(lambda c: (1 - 0.9 ** c, 1 - 0.999 ** c))(
        jnp.arange(1, 2001, dtype=jnp.int32)))
    for i, count in enumerate(range(1, 2001)):
        assert pinverse._bias_correction(0.9, count) == want[0][i]
        assert pinverse._bias_correction(0.999, count) == want[1][i]


# ---------------------------------------------------------------------------
# Whole fits
# ---------------------------------------------------------------------------

W, H, STEPS, BATCH = 24, 16, 8, 128
WHICH = ("albedo", "centers")
FIT_KW = dict(which=WHICH, steps=STEPS, learning_rate=1e-2,
              batch_pixels=BATCH, spp=2)


@pytest.fixture(scope="module")
def jax_fit(tmp_path_factory):
    """The JAX package's fit on simple-cuda (pinhole, 24x16, depth 4): its
    target, perturbed scene, every step's parameters and losses, and a
    checkpoint written after step 4."""
    jsc = jscene.simple_scene_cuda()
    jcam = jcamera.reference_cuda_camera(W, H)
    cfg = jconfig.RenderConfig(width=W, height=H, spp=4, max_depth=4,
                               camera_mode="pinhole")
    target = np.asarray(jrender(jsc, jcam, cfg, jax.random.key(0)))
    g = np.random.default_rng(3)
    bad = {k: np.asarray(getattr(jsc, k))
           + (0.1 * g.normal(size=np.shape(getattr(jsc, k)))).astype(
               np.float32) for k in WHICH}
    bad["albedo"] = np.clip(bad["albedo"], 0.05, 0.95)
    ckpt = str(tmp_path_factory.mktemp("jaxfit") / "step4.npz")
    steps = []

    def callback(i, params, opt_state, loss):
        steps.append({k: np.asarray(v) for k, v in params.items()})
        if i == 3:
            joptim.save_checkpoint(ckpt, params, opt_state, i + 1)

    _, _, _, losses = joptim.fit(
        jsc._replace(**{k: jnp.asarray(v) for k, v in bad.items()}), jcam,
        jnp.asarray(target), cfg, callback=callback, **FIT_KW)
    return dict(target=target, bad=bad, steps=steps, losses=losses,
                ckpt=ckpt)


def _port_setup(jax_fit):
    psc = pscene.simple_scene_cuda("cpu")
    bad = psc._replace(**{k: torch.from_numpy(v.copy())
                          for k, v in jax_fit["bad"].items()})
    pcam = pcamera.reference_cuda_camera(W, H, "cpu")
    cfg = pconfig.RenderConfig(width=W, height=H, spp=4, max_depth=4,
                               camera_mode="pinhole")
    return bad, pcam, cfg, torch.from_numpy(jax_fit["target"].copy())


def _jax_ids(step, seed=7):
    kstep = jax.random.fold_in(jax.random.key(seed), step)
    return np.asarray(jax.random.choice(
        jax.random.fold_in(kstep, 0), W * H, (BATCH,), replace=False))


def test_whole_fit_matches_jax(jax_fit):
    """fit's default engine (planar at depth 4), eight steps: the JAX
    package's pixel ids at every step, and its trajectory within the
    compounded step tolerance at every step."""
    bad, pcam, cfg, target = _port_setup(jax_fit)
    steps = []
    with golden.record_fit() as rec:
        _, _, _, losses = poptim.fit(
            bad, pcam, target, cfg, device="cpu",
            callback=lambda i, p, o, l: steps.append(
                {k: v.detach().numpy().copy() for k, v in p.items()}),
            **FIT_KW)
    assert len(rec["ids"]) == STEPS
    for i, ids in enumerate(rec["ids"]):
        np.testing.assert_array_equal(ids, _jax_ids(i), err_msg=f"step {i}")
    np.testing.assert_allclose(losses, jax_fit["losses"], rtol=1e-5)
    for i, (got, want) in enumerate(zip(steps, jax_fit["steps"])):
        tol = golden.fit_tolerance(i + 1)
        for k in WHICH:
            np.testing.assert_allclose(got[k], want[k],
                                       rtol=tol["param_rtol"],
                                       atol=tol["param_atol"],
                                       err_msg=f"{k} step {i}")


def test_jax_checkpoint_resumed_by_the_port_continues_jax(jax_fit):
    """A checkpoint the JAX fit wrote after step 4, resumed by the port's
    fit for four more steps, lands on the JAX fit's steps 5-8."""
    bad, pcam, cfg, target = _port_setup(jax_fit)
    p0, o0, step0 = poptim.load_checkpoint(
        jax_fit["ckpt"], poptim.params_from_scene(bad, WHICH))
    assert step0 == 4 and int(o0["count"]) == 4
    kw = dict(FIT_KW, steps=STEPS - step0)
    steps = []
    with golden.record_fit() as rec:
        _, _, _, losses = poptim.fit(
            bad, pcam, target, cfg, device="cpu", init_params=p0,
            init_opt_state=o0, start_step=step0,
            callback=lambda i, p, o, l: steps.append(
                {k: v.detach().numpy().copy() for k, v in p.items()}),
            **kw)
    for i, ids in enumerate(rec["ids"]):
        np.testing.assert_array_equal(ids, _jax_ids(step0 + i))
    np.testing.assert_allclose(losses, jax_fit["losses"][step0:], rtol=1e-5)
    tol = golden.fit_tolerance(STEPS)
    for got, want in zip(steps, jax_fit["steps"][step0:]):
        for k in WHICH:
            np.testing.assert_allclose(got[k], want[k],
                                       rtol=tol["param_rtol"],
                                       atol=tol["param_atol"], err_msg=k)


def test_cli_fit_matches_the_jax_cli_and_the_golden():
    """The committed fit golden is what the JAX CLI's fit records today
    (scripts/make_torch_golden.py); the port's CLI fit with its flags
    prints the JAX CLI's loss and error lines, draws its pixel ids and
    perturbation bit for bit, and ends within the compounded tolerance
    (golden.cli_fit_against_golden, which chip_smoke.py runs on the card)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "make_torch_golden.py")
    spec = importlib.util.spec_from_file_location("make_torch_golden", path)
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    fresh = maker.fit_jax()
    g = golden.load_fit_golden()
    # (JAX's per-step gradients are checked by the port's Adam replaying
    # the trajectory from them: test_fit_steps_from_jax_hold_on_the_cpu)
    assert sorted(fresh) == sorted(k for k in g if not k.startswith("grads_"))
    for k in ("argv", "ids", "said", "full_width_ids", "perturbed_albedo",
              "perturbed_centers"):
        np.testing.assert_array_equal(fresh[k], g[k], err_msg=k)
    for k in ("losses", "final_albedo", "final_centers"):
        np.testing.assert_allclose(fresh[k], g[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    # on the CPU every parameter stays inside the bound
    res = golden.cli_fit_against_golden("cpu")
    assert res["ok"] and not res["outside"], {
        k: v for k, v in res.items() if k != "record"}
    assert res["said"] == [str(s) for s in g["said"]]
    # the full-width draw of the golden is the port's, on the CPU too
    for i, want in enumerate(g["full_width_ids"]):
        batch_key, _ = pinverse.step_keys(
            ptf.key_words(int(g["full_width_base_seed"])), i)
        got = pinverse.draw_pixel_batch(
            batch_key, int(g["full_width_width"] * g["full_width_height"]),
            int(g["full_width_batch_pixels"]), "cpu")
        np.testing.assert_array_equal(got.numpy(), want)


def test_gradient_probe_reads_the_fits_own_step():
    """golden.fit_gradients (which chip_smoke.py uses to set the card's
    gradients against the host's) reads the gradient of the CLI fit's own
    step: Adam's first step moves each parameter by lr against its sign;
    computing the sines and cosines on the same device changes nothing."""
    g = golden.load_fit_golden()
    argv = [str(a) for a in g["argv"]]
    leaves = ("albedo", "centers")
    at = [{k: g["perturbed_" + k] for k in leaves}]
    grads = golden.fit_gradients(argv, "cpu", at)[0]
    with golden.sincos_on("cpu"):
        again = golden.fit_gradients(argv, "cpu", at)[0]
    for k in leaves:
        np.testing.assert_array_equal(again[k], grads[k])
        moved = g["perturbed_" + k] - g["steps_" + k][0]
        clear = np.abs(grads[k]) > 1e-6
        assert clear.sum() > grads[k].size // 2
        np.testing.assert_array_equal(np.sign(grads[k][clear]),
                                      np.sign(moved[clear]))


def test_fit_steps_from_jax_hold_on_the_cpu():
    """The port's Adam over the JAX gradients that the golden recorded
    gives JAX's trajectory bit for bit, and each of the fit's steps,
    taken alone by the port from JAX's state before it, lands within the
    one-step bound on every parameter (golden.fit_steps_from_jax, which
    chip_smoke.py runs on the card)."""
    res = golden.fit_steps_from_jax("cpu")
    assert res["ok"], res
    assert res["checks"]["jax_state"]


def test_cli_fit_perturbation_is_the_jax_clis():
    """The CLI's perturbation: key(seed + 1), split once a leaf, perturb *
    normal(sub, leaf.shape); bit-equal with the JAX CLI's arithmetic."""
    jsc = jscene.simple_scene_cuda()
    k = jax.random.key(5 + 1)
    want = {}
    for name in ("albedo", "centers", "radii"):
        k, sub = jax.random.split(k)
        want[name] = np.asarray(getattr(jsc, name)
                                + 0.25 * jax.random.normal(
                                    sub, getattr(jsc, name).shape))
    said = io.StringIO()
    with golden.record_fit() as rec, contextlib.redirect_stdout(said):
        assert pcli.main(["fit", "--scene", "simple-cuda", "--width", "8",
                          "--height", "6", "--spp", "1", "--depth", "2",
                          "--params", "albedo,centers,radii", "--seed", "5",
                          "--perturb", "0.25", "--steps", "1", "--fit-spp",
                          "1", "--device", "cpu"]) == 0
    for name, w in want.items():
        np.testing.assert_array_equal(rec["perturbed_" + name], w)
