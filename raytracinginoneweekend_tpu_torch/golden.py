"""Golden files: small results of the JAX package, committed in
``testdata/golden_*.npz``.

They tie the port's output to the JAX reference on a machine that has no
JAX (``chip_smoke.py`` reruns them on the card); ``scripts/
make_torch_golden.py`` writes them. Two kinds:

  * frames (``GOLDEN_NAMES``), each with the flags that rendered it;
    ``tests/test_torch_wavefront.py`` checks that the committed files still
    match a fresh JAX render;
  * a fit trajectory of the JAX CLI (``FIT_GOLDEN``): its flags, the
    perturbed parameters, every step's pixel ids, loss and parameters, the
    final parameters, the printed lines, and the first pixel batches of a
    full-width fit; ``tests/test_torch_fit_draws.py`` checks it against a
    fresh JAX fit. ``record_fit`` records the same things of the port's
    ``optim.fit``, and ``fit_tolerance`` says how close the two must be;
    ``fit_steps_from_jax`` takes each step alone from JAX's state, and
    ``fit_gradient_gap`` sets the port's gradients against JAX's.
"""

from __future__ import annotations

import contextlib
import io
import math
import os

import numpy as np

TESTDATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "testdata")
GOLDEN_NAMES = ("golden_simple_cuda", "golden_huge")


def load_golden(name: str):
    """-> ((H*W, 3) float32 image, dict of the flags that rendered it)."""
    with np.load(os.path.join(TESTDATA_DIR, name + ".npz")) as z:
        flags = {k: z[k].item() for k in z.files if k != "image"}
        return z["image"].astype(np.float32), flags


def render_golden(flags: dict, device=None, **overrides):
    """Render a golden frame's configuration with the port ->
    (H*W, 3) tensor on ``device`` (None = the CUDA card)."""
    from . import cli
    from .ops.threefry import key_words
    from .ops.wavefront import render_wavefront
    from .utils.device import resolve_device

    device = resolve_device(device)
    scene = cli._build_scene(flags["scene"], flags["seed"], device)
    cam = cli._build_camera(flags["camera"], flags["width"],
                            flags["height"], device)
    kw = dict(width=flags["width"], height=flags["height"],
              spp=flags["spp"], max_depth=flags["depth"],
              camera_mode=flags["mode"],
              options=cli._options(flags["compat"]),
              pool_size=flags["pool_size"], device=device)
    kw.update(overrides)
    return render_wavefront(scene, cam, key_words(flags["seed"]), **kw)


def compare_frames(got: np.ndarray, want: np.ndarray, atol: float = 3e-5,
                   rtol: float = 1e-4) -> dict:
    """The renderer's frame-comparison rule (the JAX package's
    tests/test_golden_oracle.py::_compare): every pixel within atol/rtol
    EXCEPT at most 1% knife-edge outliers -- a t_min or grazing decision
    that float rounding flips sends one path elsewhere -- which must
    still be finite and within 1.0. -> {"ok", "n_bad", "n_far",
    "n_pixels", "max_abs_err"}: n_far counts the outliers beyond ten
    times the tolerance (a path that went elsewhere, not rounding that
    grew along a path); max_abs_err is over the non-outlier pixels."""
    got = np.asarray(got, np.float32).reshape(-1, 3)
    want = np.asarray(want, np.float32).reshape(-1, 3)
    close = np.isclose(got, want, atol=atol, rtol=rtol)
    bad = ~close.all(axis=-1)
    n_bad = int(bad.sum())
    n_far = int((~np.isclose(got, want, atol=10 * atol, rtol=10 * rtol)
                 .all(axis=-1)).sum())
    ok = bool(np.isfinite(got).all()) and n_bad <= max(1, bad.size // 100)
    if n_bad:
        ok = ok and float(np.abs(got[bad] - want[bad]).max()) < 1.0
    good = ~bad
    err = float(np.abs(got[good] - want[good]).max()) if good.any() else 0.0
    return {"ok": ok, "n_bad": n_bad, "n_far": n_far,
            "n_pixels": int(bad.size),
            "max_abs_err": err}


FIT_GOLDEN = "golden_fit_simple_cuda"


def load_fit_golden() -> dict:
    """-> {name: array} of the fit golden: ``argv`` (the CLI's flags),
    ``perturbed_<leaf>`` / ``steps_<leaf>`` (after each step) /
    ``final_<leaf>``, ``ids`` (steps, batch) i32, ``losses`` (steps,) f32,
    ``said`` (the printed lines), ``grads_<leaf>`` (steps, ...) (JAX's
    gradient of each step at the parameters it started from), and
    ``full_width_ids`` with the ``full_width_*`` sizes it was drawn at."""
    with np.load(os.path.join(TESTDATA_DIR, FIT_GOLDEN + ".npz")) as z:
        return {k: z[k] for k in z.files}


def fit_tolerance(steps: int) -> dict:
    """The bound a whole fit is held to against the JAX package's: the
    train step's own (parameters rtol 1e-4 / atol 2e-6 after three Adam
    steps, tests/test_torch_optim.py), compounded once every three steps,
    and the loss's rtol 1e-5. Pixel ids and the perturbation are held
    bit-equal."""
    n = max(1, math.ceil(steps / 3))
    return {"param_rtol": 1e-4 * n, "param_atol": 2e-6 * n,
            "loss_rtol": 1e-5}


@contextlib.contextmanager
def record_fit():
    """While the block runs, record every call of the port's
    ``optim.fit`` -> a dict that fills with ``perturbed_<leaf>`` (the
    parameters it starts from), ``ids`` (each step's pixel batch, as
    drawn), ``losses``, ``steps_<leaf>`` (the parameters after each step),
    ``grads_<leaf>`` (the gradient each step took) and ``final_<leaf>``
    (numpy; the last call's)."""
    from . import optim
    from .optim import inverse

    rec = {"ids": [], "losses": []}
    real_fit, real_draw = optim.fit, inverse.draw_pixel_batch

    def draw(*args, **kwargs):
        ids = real_draw(*args, **kwargs)
        rec["ids"].append(ids.detach().cpu().numpy().copy())
        return ids

    def fit(scene, *args, which=inverse.DIFFERENTIABLE_LEAVES,
            callback=None, **kwargs):
        for name in which:
            rec["perturbed_" + name] = \
                getattr(scene, name).detach().cpu().numpy().copy()

        def cb(i, params, opt, loss):
            rec["losses"].append(loss)
            for name in which:
                rec.setdefault("steps_" + name, []).append(
                    params[name].detach().cpu().numpy().copy())
                rec.setdefault("grads_" + name, []).append(
                    params[name].grad.detach().cpu().numpy().copy())
            if callback is not None:
                callback(i, params, opt, loss)

        out = real_fit(scene, *args, which=which, callback=cb, **kwargs)
        for name in which:
            rec["final_" + name] = out[1][name].detach().cpu().numpy().copy()
        return out

    optim.fit, inverse.draw_pixel_batch = fit, draw
    try:
        yield rec
    finally:
        optim.fit, inverse.draw_pixel_batch = real_fit, real_draw


def cli_fit_against_golden(device=None) -> dict:
    """Run the port's CLI ``fit`` with the fit golden's flags on ``device``
    (None = the CUDA card), recording it, and hold it to the golden ->
    {"ok", "checks": {name: bool}, the largest differences, the
    parameters outside the bound, each step's largest share of its bound
    per leaf, the recorded run under "record"}.

    Pixel ids and the perturbation bit-equal; every step's loss within
    ``fit_tolerance``; check "replay": the port's Adam on the CPU, over the
    gradients the run took, gives the run's parameters after every step
    bit for bit (the update, and the state carried from step to step, are
    optax's wherever the run ran); check "params": every final parameter
    within ``fit_tolerance``, which compounds the one-step bound and so
    can be left by rounding that Adam carries (``fit_steps_from_jax``
    holds each step alone)."""
    from . import cli

    g = load_fit_golden()
    argv = [str(a) for a in g["argv"]]
    if device is not None:
        argv += ["--device", str(device)]
    said = io.StringIO()
    with record_fit() as rec, contextlib.redirect_stdout(said):
        rc = cli.main(argv)
    tol = fit_tolerance(len(g["losses"]))
    leaves = [k[len("final_"):] for k in g if k.startswith("final_")]
    out = {"rc": rc, "steps": len(rec["losses"]), "record": rec,
           "said": said.getvalue().strip().splitlines()}
    checks = {"rc": rc == 0, "steps": len(rec["losses"]) == len(g["losses"]),
              "ids": len(rec["ids"]) == len(g["ids"]) and all(
                  np.array_equal(a, b) for a, b in zip(rec["ids"], g["ids"]))}
    outside = []
    for name in leaves:
        want, got = g["perturbed_" + name], rec["perturbed_" + name]
        checks["perturbed_" + name] = np.array_equal(got, want)
        out["perturbed_max_abs_" + name] = float(np.abs(got - want).max())
        out["step_max_share_" + name] = [
            float((np.abs(got - want) / _budget(want, i + 1)).max())
            for i, (got, want) in enumerate(zip(rec["steps_" + name],
                                                g["steps_" + name]))]
        want, got = g["final_" + name], rec["final_" + name]
        err = np.abs(got - want)
        budget = _budget(want, len(g["losses"]))
        out["final_max_share_" + name] = float((err / budget).max())
        out["final_max_abs_" + name] = float(err.max())
        outside += [{"leaf": name, "index": [int(i) for i in ix],
                     "abs_err": float(err[ix]), "bound": float(budget[ix])}
                    for ix in zip(*np.nonzero(err > budget))]
    out["outside"] = outside
    checks["params"] = not outside
    if checks["steps"]:
        replay = _replay_adam(
            {k: rec["perturbed_" + k] for k in leaves},
            {k: rec["grads_" + k] for k in leaves},
            cli.build_parser().parse_args(argv).lr)
        checks["replay"] = all(
            np.array_equal(p[k], rec["steps_" + k][t])
            for t, p in enumerate(replay) for k in leaves)
    got = np.asarray(rec["losses"], np.float64)
    want = g["losses"].astype(np.float64)
    if got.shape == want.shape:
        checks["losses"] = bool(np.allclose(got, want, rtol=tol["loss_rtol"],
                                            atol=0.0))
        out["loss_max_rel"] = float(np.abs(got / want - 1.0).max())
    else:
        checks["losses"] = False
    out.update(ok=all(checks.values()), checks=checks, tolerance=tol)
    return out


def _replay_adam(start: dict, grads: dict, lr: float,
                 states: list | None = None) -> list:
    """The port's Adam on the CPU from the parameters ``start`` ({leaf:
    array}) over the gradients ``grads`` ({leaf: per step an array}) ->
    the parameters after each step [{leaf: array}]; ``states``, when
    given, gets the optax-layout state before each step."""
    import torch

    from .optim import inverse

    params = {k: torch.from_numpy(np.array(v, np.float32))
              .requires_grad_(True) for k, v in start.items()}
    adam = inverse.make_adam(params, lr)
    out = []
    for t in range(len(next(iter(grads.values())))):
        if states is not None:
            states.append(inverse.adam_state_to_numpy(adam, params)
                          if t else None)
        for k in params:
            params[k].grad = torch.from_numpy(np.array(grads[k][t],
                                                       np.float32))
        adam.step()
        out.append({k: v.detach().numpy().copy() for k, v in params.items()})
    return out


def _budget(want: np.ndarray, steps: int) -> np.ndarray:
    """fit_tolerance's parameter bound after ``steps`` steps, element by
    element."""
    tol = fit_tolerance(steps)
    return tol["param_atol"] + tol["param_rtol"] * np.abs(want)


@contextlib.contextmanager
def sincos_on(device):
    """While the block runs, the draws' sines and cosines
    (``ops/rng.unit_from_uv`` and ``disk_from_uv``: every scatter
    direction and lens sample of the plain PyTorch engines) are computed
    on ``device`` and moved back. With "cpu", a fit on the card takes
    the host's libm for them and nothing else of the host's."""
    from .ops import rng

    real = rng.unit_from_uv, rng.disk_from_uv

    def there(fn):
        def call(u0, u1):
            return tuple(t.to(u0.device)
                         for t in fn(u0.to(device), u1.to(device)))
        return call

    rng.unit_from_uv, rng.disk_from_uv = there(real[0]), there(real[1])
    try:
        yield
    finally:
        rng.unit_from_uv, rng.disk_from_uv = real


def _fit_inputs(argv, device):
    """What the CLI's fit pipeline (``cli._fit_impl``) hands ``optim.fit``
    for ``argv`` on ``device`` (None = the CUDA card) -> (args, kwargs),
    without fitting."""
    from . import cli, optim

    class Taken(Exception):
        pass

    got = {}

    def take(*args, **kwargs):
        got.update(args=args, kwargs=kwargs)
        raise Taken

    real, optim.fit = optim.fit, take
    try:
        where = [] if device is None else ["--device", str(device)]
        cli._fit_impl(cli.build_parser().parse_args(list(argv) + where),
                      log=lambda s: None)
    except Taken:
        pass
    finally:
        optim.fit = real
    return got["args"], got["kwargs"]


def fit_gradients(argv, device, params_at, target=None) -> list:
    """The gradient of fit step i at ``params_at[i]`` ({leaf: array}) for
    each i, through ``optim.fit`` itself on the CLI's inputs for ``argv``
    on ``device`` (one step from there, with an optimiser that makes no
    update); ``target`` replaces the CLI's target image -> [{leaf:
    array}]."""
    import torch

    from . import optim
    from .optim import inverse

    args, kwargs = _fit_inputs(argv, device)
    if target is not None:
        args = args[:2] + (target,) + args[3:]

    class Tap(torch.optim.Optimizer):
        def __init__(self, params, lr):
            super().__init__(params, {"lr": lr})

        def step(self, closure=None):
            pass

    def make_tap(params, learning_rate):
        return Tap([params[k] for k in sorted(params)], learning_rate)

    grads = []

    def read(i, params, opt, loss):
        grads.append({k: v.grad.detach().cpu().numpy().copy()
                      for k, v in params.items()})

    real, inverse.make_adam = inverse.make_adam, make_tap
    try:
        for i, at in enumerate(params_at):
            optim.fit(*args, **dict(
                kwargs, steps=1, start_step=i, callback=read,
                init_params=optim.params_from_numpy(at, device=device)))
    finally:
        inverse.make_adam = real
    return grads


def fit_steps_from_jax(device=None) -> dict:
    """Each step of the fit golden taken alone by the port on ``device``
    (None = the CUDA card) from JAX's own state before it: the parameters
    of the JAX trajectory, and Adam's moments rebuilt from JAX's recorded
    gradients by the port's Adam (which must give the recorded trajectory
    bit for bit: check "jax_state"). Each step runs through ``optim.fit``
    resumed there on the CLI's inputs and is held to what JAX's step
    reached: every parameter within ``fit_tolerance(1)``, with nothing
    compounded and no element excused, and the loss within its rtol ->
    {"ok", "checks", "step_max_share_<leaf>", "outside", "loss_max_rel"}.
    """
    from . import cli, optim

    g = load_fit_golden()
    argv = [str(a) for a in g["argv"]]
    lr = cli.build_parser().parse_args(argv).lr
    leaves = [k[len("final_"):] for k in g if k.startswith("final_")]
    steps = len(g["losses"])
    args, kwargs = _fit_inputs(argv, device)

    states = []
    replay = all(np.array_equal(p[k], g["steps_" + k][t])
                 for t, p in enumerate(_replay_adam(
                     {k: g["perturbed_" + k] for k in leaves},
                     {k: g["grads_" + k] for k in leaves}, lr, states))
                 for k in leaves)

    tol = fit_tolerance(1)
    out = {"outside": [], **{"step_max_share_" + k: [] for k in leaves}}
    losses = []
    for t in range(steps):
        took = {}

        def read(i, p, opt, loss):
            took.update(loss=loss, **{k: v.detach().cpu().numpy().copy()
                                      for k, v in p.items()})

        at = {k: g["perturbed_" + k] if t == 0 else g["steps_" + k][t - 1]
              for k in leaves}
        optim.fit(*args, **dict(
            kwargs, steps=1, start_step=t, callback=read,
            init_params=optim.params_from_numpy(at, device="cpu"),
            init_opt_state=states[t]))
        losses.append(took["loss"])
        for k in leaves:
            want = g["steps_" + k][t]
            err = np.abs(took[k] - want)
            budget = _budget(want, 1)
            out["step_max_share_" + k].append(float((err / budget).max()))
            out["outside"] += [
                {"step": t, "leaf": k, "index": [int(i) for i in ix],
                 "abs_err": float(err[ix]), "bound": float(budget[ix])}
                for ix in zip(*np.nonzero(err > budget))]
    rel = np.abs(np.asarray(losses, np.float64)
                 / g["losses"].astype(np.float64) - 1.0)
    checks = {"jax_state": bool(replay), "params": not out["outside"],
              "losses": bool((rel <= tol["loss_rtol"]).all())}
    out.update(ok=all(checks.values()), checks=checks, tolerance=tol,
               loss_max_rel=float(rel.max()))
    return out


def fit_gradient_gap(card="cuda", host="cpu") -> dict:
    """How far the port's gradients of the fit golden's steps lie from
    JAX's, each at the JAX trajectory's parameters before that step: on
    ``host``; on ``card`` as the CLI runs it; on the card with the host's
    sines and cosines (``sincos_on``); and with those and the host's
    target image -> {variant: {leaf: {"rel": per step the largest |port -
    JAX| / |JAX|, "of_leaf": per step the largest |port - JAX| / max
    |JAX|}}}."""
    g = load_fit_golden()
    argv = [str(a) for a in g["argv"]]
    leaves = [k[len("final_"):] for k in g if k.startswith("final_")]
    at = [{k: g["perturbed_" + k] if i == 0 else g["steps_" + k][i - 1]
           for k in leaves} for i in range(len(g["losses"]))]
    host_target = _fit_inputs(argv, host)[0][2]
    out = {}
    for name, dev, sc, target in (
            ("host", host, None, None), ("card", card, None, None),
            ("card_host_sincos", card, host, None),
            ("card_host_sincos_target", card, host, host_target)):
        where = (sincos_on(sc) if sc is not None
                 else contextlib.nullcontext())
        with where:
            got = fit_gradients(argv, dev, at, target=target)
        out[name] = {leaf: {
            "rel": [float((np.abs(a[leaf] - b)
                           / np.maximum(np.abs(b), 1e-30)).max())
                    for a, b in zip(got, g["grads_" + leaf])],
            "of_leaf": [float(np.abs(a[leaf] - b).max() / np.abs(b).max())
                        for a, b in zip(got, g["grads_" + leaf])]}
            for leaf in leaves}
    return out
