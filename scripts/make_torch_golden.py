#!/usr/bin/env python
"""Write the golden files of the PyTorch/CUDA port from the JAX package.

The port (raytracinginoneweekend_tpu_torch) is checked against the JAX
package on a machine that has no JAX through small results made here by
the JAX package and committed inside the port's package
(``raytracinginoneweekend_tpu_torch/testdata/``):

  * ``golden_simple_cuda.npz``, ``golden_huge.npz``: frames of the JAX
    ``render_wavefront``, each with its image (H*W, 3 float32) and the
    flags that made it; ``tests/test_torch_wavefront.py`` re-renders them
    with the JAX package and asserts the committed files still match.
  * ``golden_fit_simple_cuda.npz``: a fit trajectory of the JAX CLI's
    ``fit`` (``FIT_ARGV``), recorded as it runs -- the perturbed
    parameters, each step's pixel ids (from ``jax.random.choice``), each
    step's loss and parameters, the final parameters and the lines it
    printed -- then JAX's gradient of each step at the parameters it
    started from (``fit_jax_gradients``), and the
    pixel ids of the first ``FULL_WIDTH["steps"]`` steps of a full-width
    fit (1200x800, 16384 pixels, the default base key); ``tests/
    test_torch_fit_draws.py`` re-runs the JAX fit and asserts the
    committed file still matches, and ``chip_smoke.py`` holds the port's
    CLI fit on the card to it.

Run (CPU is enough):
    JAX_PLATFORMS=cpu python scripts/make_torch_golden.py [NAME ...]
(no NAME: every file).
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GOLDEN = {
    "golden_simple_cuda": dict(scene="simple-cuda", camera="cuda",
                               compat="reference-cuda", mode="cuda",
                               width=32, height=24, spp=4, depth=8, seed=0,
                               pool_size=4096),
    "golden_huge": dict(scene="huge", camera="cpu", compat="default",
                        mode="thinlens", width=32, height=24, spp=2,
                        depth=6, seed=0, pool_size=4096),
}


FIT_NAME = "golden_fit_simple_cuda"
FIT_ARGV = ("fit", "--scene", "simple-cuda", "--width", "48", "--height",
            "32", "--spp", "2", "--depth", "4", "--params", "albedo,centers",
            "--steps", "8", "--batch-pixels", "512", "--fit-spp", "2",
            "--log-every", "1")
# fit's own defaults for what the full-width draw needs: base key 7, the
# batch key of step i fold_in(fold_in(base, i), 0)
FULL_WIDTH = dict(width=1200, height=800, batch_pixels=16384, steps=2,
                  base_seed=7)


def fit_jax() -> dict:
    """Run the JAX CLI's ``fit`` with ``FIT_ARGV`` and record, as it runs,
    the perturbed parameters its ``optim.fit`` starts from, the pixel ids
    of every step (``jax.random.choice``'s results), each step's loss and
    parameters, the final parameters and the printed lines; add the
    full-width draws.
    -> {name: array} for the ``.npz``."""
    import contextlib
    import io

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_threefry_partitionable", True)
    from raytracinginoneweekend_tpu import cli, optim

    which = FIT_ARGV[FIT_ARGV.index("--params") + 1].split(",")
    rec = {"ids": [], "losses": []}
    real_fit, real_choice = optim.fit, jax.random.choice

    def choice(*args, **kwargs):
        out = real_choice(*args, **kwargs)
        rec["ids"].append(np.asarray(out, np.int32))
        return out

    def fit(scene, *args, callback=None, **kwargs):
        for name in which:
            rec["perturbed_" + name] = np.asarray(getattr(scene, name))

        def cb(i, params, opt_state, loss):
            rec["losses"].append(loss)
            for name in which:
                rec.setdefault("steps_" + name, []).append(
                    np.asarray(params[name]))
            if callback is not None:
                callback(i, params, opt_state, loss)

        out = real_fit(scene, *args, callback=cb, **kwargs)
        for name in which:
            rec["final_" + name] = np.asarray(out[1][name])
        return out

    said = io.StringIO()
    optim.fit, jax.random.choice = fit, choice
    try:
        with contextlib.redirect_stdout(said):
            rc = cli.main(list(FIT_ARGV))
    finally:
        optim.fit, jax.random.choice = real_fit, real_choice
    if rc != 0:
        raise RuntimeError(f"the JAX CLI's fit returned {rc}")
    base = jax.random.key(FULL_WIDTH["base_seed"])
    n = FULL_WIDTH["width"] * FULL_WIDTH["height"]
    full = [np.asarray(jax.random.choice(
        jax.random.fold_in(jax.random.fold_in(base, i), 0), n,
        (FULL_WIDTH["batch_pixels"],), replace=False).astype(jnp.int32))
        for i in range(FULL_WIDTH["steps"])]
    out = {k: np.stack(v) if k.startswith("steps_") else v
           for k, v in rec.items() if k not in ("ids", "losses")}
    out.update(argv=np.asarray(FIT_ARGV), ids=np.stack(rec["ids"]),
               losses=np.asarray(rec["losses"], np.float32),
               said=np.asarray(said.getvalue().strip().splitlines()),
               full_width_ids=np.stack(full),
               **{"full_width_" + k: np.asarray(v)
                  for k, v in FULL_WIDTH.items()})
    return out


def fit_jax_gradients(rec: dict) -> dict:
    """JAX's gradient of every step of the recorded fit (``fit_jax``'s
    record), each at the parameters the step started from, through the JAX
    package's own ``optim.fit`` on the JAX CLI's inputs: one step from
    there, with an optimiser that records the gradient and makes no
    update -> {"grads_<leaf>": (steps, ...) float32}. The port's Adam over
    these gradients gives the recorded trajectory bit for bit
    (tests/test_torch_fit_draws.py)."""
    import jax
    import jax.numpy as jnp
    import optax

    jax.config.update("jax_threefry_partitionable", True)
    from raytracinginoneweekend_tpu import cli, optim

    class Taken(Exception):
        pass

    got = {}

    def take(*args, **kwargs):
        got.update(args=args, kwargs=kwargs)
        raise Taken

    real_fit, optim.fit = optim.fit, take
    try:
        cli.main(list(FIT_ARGV))
    except Taken:
        pass
    finally:
        optim.fit = real_fit
    seen = []

    def update(grads, state, params=None):
        jax.debug.callback(lambda g: seen.append(
            {k: np.asarray(v) for k, v in g.items()}), grads)
        return jax.tree.map(jnp.zeros_like, grads), state

    tap = optax.GradientTransformation(lambda params: (), update)
    which = FIT_ARGV[FIT_ARGV.index("--params") + 1].split(",")
    kwargs = dict(got["kwargs"], callback=None, steps=1, optimizer=tap)
    grads = []
    for i in range(len(rec["losses"])):
        at = {k: jnp.asarray(rec["perturbed_" + k] if i == 0
                             else rec["steps_" + k][i - 1]) for k in which}
        seen.clear()
        real_fit(*got["args"], **dict(kwargs, start_step=i, init_params=at))
        jax.effects_barrier()
        grads.append(seen[0])
    return {"grads_" + k: np.stack([g[k] for g in grads]).astype(np.float32)
            for k in which}


def render_jax(flags: dict) -> np.ndarray:
    """One golden frame by the JAX package -> (H*W, 3) float32."""
    import jax

    from raytracinginoneweekend_tpu import config
    from raytracinginoneweekend_tpu.models import camera, scene
    from raytracinginoneweekend_tpu.ops.wavefront import render_wavefront

    scn = {"simple-cuda": scene.simple_scene_cuda,
           "huge": lambda: scene.huge_scene(flags["seed"])}[flags["scene"]]()
    cam = {"cuda": camera.reference_cuda_camera,
           "cpu": camera.reference_cpu_camera}[flags["camera"]](
               flags["width"], flags["height"])
    options = {"default": config.DEFAULT,
               "reference-cuda": config.REFERENCE_CUDA}[flags["compat"]]
    img = render_wavefront(
        scn, cam, jax.random.key(flags["seed"]), width=flags["width"],
        height=flags["height"], spp=flags["spp"], max_depth=flags["depth"],
        camera_mode=flags["mode"], options=options,
        pool_size=flags["pool_size"])
    return np.asarray(img, np.float32)


def main(argv=None) -> int:
    names = list(argv if argv is not None else sys.argv[1:]) or [
        *GOLDEN, FIT_NAME]
    unknown = set(names) - {*GOLDEN, FIT_NAME}
    if unknown:
        print(f"unknown golden files: {sorted(unknown)}", file=sys.stderr)
        return 2
    out_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "raytracinginoneweekend_tpu_torch", "testdata")
    os.makedirs(out_dir, exist_ok=True)
    if FIT_NAME in names:
        rec = fit_jax()
        rec.update(fit_jax_gradients(rec))
        path = os.path.join(out_dir, FIT_NAME + ".npz")
        np.savez_compressed(path, **rec)
        print(f"wrote {path}: {len(rec['losses'])} steps, losses "
              f"{rec['losses'][0]:.6f} -> {rec['losses'][-1]:.6f}")
    for name, flags in GOLDEN.items():
        if name not in names:
            continue
        img = render_jax(flags)
        path = os.path.join(out_dir, name + ".npz")
        np.savez_compressed(path, image=img,
                            **{k: np.asarray(v) for k, v in flags.items()})
        print(f"wrote {path}: {img.shape}, mean {img.mean():.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
