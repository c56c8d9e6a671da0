"""PyTorch port: the scalar NumPy oracle (``oracle/scalar.py``), and the
port's freedom from JAX.

The port's oracle against the JAX package's on the crops and arms of
tests/test_golden_oracle.py; the port's engines (wavefront, tiled, planar)
held to the port's oracle by the same frame rule the JAX engines are held
to the JAX oracle (``golden.compare_frames``: every pixel within atol
3e-5 / rtol 1e-4 but at most 1% knife-edge outliers; atol 5e-4 on the
huge scene, whose glancing hits compound float32 rounding); and a check
that no module of the port, nor chip_smoke.py, imports jax or the JAX
package.

Tolerance between the two oracles: the integer-made draws (jitter, the
dielectric and termination uniforms) are bit-equal; the scatter and lens
vectors go through PyTorch's sin/cos on the CPU and XLA's in JAX, an ulp
apart on some of them (at most 3e-7), so the radiance agrees to atol
1e-6 on every pixel; the scalar tracer itself is the same NumPy code.
"""

import ast
import dataclasses
import os
import re

import jax
import numpy as np
import pytest
import torch

from raytracinginoneweekend_tpu import config as jconfig
from raytracinginoneweekend_tpu.models import scene as jscene
from raytracinginoneweekend_tpu.oracle import render_oracle as jax_oracle
from raytracinginoneweekend_tpu.oracle import scalar as jscalar
from raytracinginoneweekend_tpu_torch import config as pconfig
from raytracinginoneweekend_tpu_torch import golden
from raytracinginoneweekend_tpu_torch.models import camera as pcamera
from raytracinginoneweekend_tpu_torch.models import scene as pscene
from raytracinginoneweekend_tpu_torch.oracle import render_oracle
from raytracinginoneweekend_tpu_torch.oracle import scalar as pscalar
from raytracinginoneweekend_tpu_torch.ops import threefry as ptf

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CUDA_CAM = dict(position=(0, 0, 0), lookat=(0, 0, -1), up=(0, 1, 0),
                vfov=88.0, aperture=0.0625, focus=1.0)
CPU_CAM = dict(position=(-4, 3.2, 5), lookat=(0, 1, 0), up=(0, 1, 0),
               vfov=42.0, aperture=0.0625,
               focus=float(np.linalg.norm(np.array([-4, 3.2, 5.0]) -
                                          np.array([0, 1, 0.0]))))
TOOLBOX = dict(sampling="stratified", rr_terminate=True, rr_start=2,
               rr_scale=1.5, rr_qmin=0.1)

# name: (scene, camera params, width, height, spp, depth, camera mode,
# options preset, option changes)
CASES = {
    "simple_cuda": ("simple-cuda", CUDA_CAM, 16, 12, 2, 8, "cuda",
                    "REFERENCE_CUDA", {}),
    "simple_cpu": ("simple-cpu", CPU_CAM, 12, 8, 2, 6, "cpu",
                   "REFERENCE_CPU", {}),
    "thinlens": ("simple-cpu", CPU_CAM, 12, 8, 2, 6, "thinlens", "DEFAULT",
                 {}),
    "pinhole": ("simple-cpu", CPU_CAM, 12, 8, 2, 6, "pinhole", "DEFAULT",
                {}),
    "stratified": ("simple-cpu", CPU_CAM, 12, 8, 4, 6, "thinlens",
                   "DEFAULT", {"sampling": "stratified"}),
    "stratified_rr": ("simple-cpu", CPU_CAM, 12, 8, 4, 6, "thinlens",
                      "DEFAULT", TOOLBOX),
    "huge": ("huge", CPU_CAM, 8, 6, 1, 4, "thinlens", "DEFAULT", {}),
}


def _scenes(name):
    if name == "simple-cuda":
        return jscene.simple_scene_cuda(), pscene.simple_scene_cuda("cpu")
    if name == "simple-cpu":
        return jscene.simple_scene_cpu(), pscene.simple_scene_cpu("cpu")
    return jscene.huge_scene(0), pscene.huge_scene(0, "cpu")


def _options(preset, changes):
    return (dataclasses.replace(getattr(jconfig, preset), **changes),
            dataclasses.replace(getattr(pconfig, preset), **changes))


@pytest.mark.parametrize("case", sorted(CASES))
def test_oracle_matches_the_jax_oracle(case):
    scene, cam, w, h, spp, depth, mode, preset, changes = CASES[case]
    jsc, psc = _scenes(scene)
    jopt, popt = _options(preset, changes)
    want = jax_oracle(jsc, cam, w, h, spp, depth, jax.random.key(42),
                      camera_mode=mode, options=jopt)
    got = render_oracle(psc, cam, w, h, spp, depth, ptf.key_words(42),
                        camera_mode=mode, options=popt)
    assert got.shape == want.shape == (h, w, 3) and got.dtype == np.float32
    assert np.isfinite(got).all() and got.max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode,preset,changes", [
    ("thinlens", "DEFAULT", TOOLBOX), ("cpu", "REFERENCE_CPU", {}),
    ("cuda", "REFERENCE_CUDA", {})])
def test_oracle_draws_match_the_jax_oracles(mode, preset, changes):
    """The precomputed draws, by kind: jitter and the two per-bounce
    uniforms bit-equal; scatter and lens vectors within a few ulps."""
    jopt, popt = _options(preset, changes)
    ids = np.arange(40, 136)
    want = jscalar._precompute_draws(jax.random.key(9), ids, 4, 5, mode,
                                     jopt)
    got = pscalar._precompute_draws(ptf.key_words(9), ids, 4, 5, mode, popt)
    names = ("jitter", "lens", "vecs", "rrs", "rrts")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        if name == "lens":
            g = g[..., :w.shape[-1]]  # the JAX disk is a 2-vector
        assert g.shape == w.shape, name
        if name in ("jitter", "rrs", "rrts"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=3e-7,
                                       err_msg=name)


def test_oracle_pixel_subset_and_device_agnostic_scene():
    """pixel_ids renders a subset (P, 3) equal to the full image's rows;
    the scene's leaves are read off any device."""
    _, psc = _scenes("simple-cpu")
    full = render_oracle(psc, CPU_CAM, 12, 8, 2, 4, ptf.key_words(3),
                         camera_mode="thinlens")
    ids = torch.tensor([0, 17, 50, 95])
    part = render_oracle(psc, CPU_CAM, 12, 8, 2, 4, ptf.key_words(3),
                         camera_mode="thinlens", pixel_ids=ids)
    np.testing.assert_array_equal(part, full.reshape(-1, 3)[ids.numpy()])


def _camera(cam, w, h):
    return pcamera.make_camera(cam["position"], cam["lookat"], cam["up"],
                               w / h, cam["vfov"], cam["aperture"],
                               cam["focus"], device="cpu")


def _engine_frame(engine, psc, cam, w, h, spp, depth, mode, options):
    key = ptf.key_words(42)
    ids = torch.arange(w * h, dtype=torch.int32)
    kw = dict(width=w, height=h, spp=spp, max_depth=depth,
              camera_mode=mode, options=options)
    if engine == "wavefront":
        from raytracinginoneweekend_tpu_torch.ops.wavefront import (
            render_wavefront)

        return render_wavefront(psc, cam, key, pool_size=512, device="cpu",
                                **kw)
    if engine == "tiled":
        from raytracinginoneweekend_tpu_torch.render import render_pixels

        return render_pixels(psc, cam, ids, key, wave_spp=spp, **kw)
    from raytracinginoneweekend_tpu_torch.ops.integrate_planar import (
        render_pixels_planar)

    return render_pixels_planar(psc, cam, ids, key, differentiable=False,
                                **kw)


@pytest.mark.parametrize("engine,case", [
    ("wavefront", "simple_cuda"), ("wavefront", "stratified_rr"),
    ("wavefront", "huge"), ("tiled", "simple_cpu"), ("tiled", "thinlens"),
    ("tiled", "stratified"), ("planar", "thinlens"),
    ("planar", "simple_cuda")])
def test_engines_hold_to_the_oracle(engine, case):
    """The port's engines against the port's oracle, by the rule the JAX
    engines are held to the JAX oracle (tests/test_golden_oracle.py):
    rr_terminate only through the wavefront engine, as there."""
    scene, cam, w, h, spp, depth, mode, preset, changes = CASES[case]
    _, psc = _scenes(scene)
    _, popt = _options(preset, changes)
    got = _engine_frame(engine, psc, _camera(cam, w, h), w, h, spp, depth,
                        mode, popt)
    want = render_oracle(psc, cam, w, h, spp, depth, ptf.key_words(42),
                         camera_mode=mode, options=popt)
    atol = 5e-4 if scene == "huge" else 3e-5
    res = golden.compare_frames(got.detach().numpy(), want, atol=atol)
    assert res["ok"], res


_IMPORT = re.compile(r"^\s*(import|from) (jax|raytracinginoneweekend_tpu)\b",
                     re.M)


def _port_sources():
    pkg = os.path.join(ROOT, "raytracinginoneweekend_tpu_torch")
    for dirpath, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_port_module_imports_jax():
    """No module of the port, the oracle and chip_smoke.py included,
    imports jax or the JAX package: not at the top of a file, not inside
    a function (the AST's every import statement), not as a string the
    grep of the acceptance criteria would find."""
    sources = list(_port_sources())
    assert len(sources) > 40
    assert any(s.endswith(os.path.join("oracle", "scalar.py"))
               for s in sources)
    for path in sources:
        with open(path) as f:
            text = f.read()
        assert not _IMPORT.search(text), path
        for node in ast.walk(ast.parse(text, path)):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not {"jax", "jaxlib", "optax",
                        "raytracinginoneweekend_tpu"} & set(roots), (
                path, node.lineno)
