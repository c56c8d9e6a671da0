"""PyTorch port vs the JAX package: two-stage adaptive sampling.

The port's ``adaptive.render_adaptive`` on the planar engine against the
JAX package's (its planar engine reaches the Pallas closest hit in
interpret mode), on the JAX tests' wide-aperture simple scene, same seed;
plus the five tests of tests/test_adaptive.py on the port, and the CLI.

Tolerances, and why:
  * stats equal exactly (integer arithmetic and one division, as in JAX);
  * tier sets equal, except pixels whose JAX noise score ties the tier's
    boundary score to 1e-6 relative (float rounding can order such a tie
    either way; measured: the sets are equal at all four configurations,
    no pixel set aside);
  * radiance rtol 1e-4 / atol 5e-4 on all but 1% of pixels: the planar
    engine's own tolerance against JAX (tests/test_torch_integrate_planar.py;
    measured: every pixel);
  * sample windows that compose, as in the JAX tests: rtol 1e-6 / atol
    1e-7 (the same per-sample radiance; only the reduction tree differs).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinginoneweekend_tpu import adaptive as jadaptive
from raytracinginoneweekend_tpu.config import DEFAULT as JDEFAULT
from raytracinginoneweekend_tpu.models import camera as jcamera
from raytracinginoneweekend_tpu.models import scene as jscene
from raytracinginoneweekend_tpu.ops.integrate_planar import (
    render_pixels_planar as jrender_pixels_planar)
from raytracinginoneweekend_tpu_torch import adaptive
from raytracinginoneweekend_tpu_torch import cli as pcli
from raytracinginoneweekend_tpu_torch.config import DEFAULT
from raytracinginoneweekend_tpu_torch.models.camera import (
    make_camera, reference_cuda_camera)
from raytracinginoneweekend_tpu_torch.models.scene import simple_scene_cuda
from raytracinginoneweekend_tpu_torch.ops.integrate_planar import (
    render_pixels_planar)
from raytracinginoneweekend_tpu_torch.ops.threefry import key_words

# Several worker processes share the machine's cores (see
# tests/test_torch_segment.py); two intra-op threads are plenty here.
torch.set_num_threads(2)

W, H = 32, 18
CPU = "cpu"
WIDE = ((-4, 3.2, 5), (0, 1, 0), (0, 1, 0), W / H, 42.0, 0.5,
        float(np.linalg.norm((-4, 2.2, 5))))


def _wide_cam():
    return make_camera(*WIDE, device=CPU)


def _ids(n=W * H):
    return torch.arange(n, dtype=torch.int32)


def test_sample_offset_windows_compose():
    scene = simple_scene_cuda(CPU)
    cam = reference_cuda_camera(W, H, CPU)
    key = key_words(4)
    kw = dict(width=W, height=H, max_depth=6, camera_mode="thinlens",
              options=DEFAULT)
    a = render_pixels_planar(scene, cam, _ids(), key, spp=4,
                             sample_offset=0, **kw)
    b = render_pixels_planar(scene, cam, _ids(), key, spp=4,
                             sample_offset=4, **kw)
    both = render_pixels_planar(scene, cam, _ids(), key, spp=8, **kw)
    np.testing.assert_allclose(((a + b) / 2).numpy(), both.numpy(),
                               rtol=1e-6, atol=1e-7)


def test_sample_offset_beyond_strata_rejected():
    scene = simple_scene_cuda(CPU)
    cam = reference_cuda_camera(W, H, CPU)
    strat = dataclasses.replace(DEFAULT, sampling="stratified")
    with pytest.raises(ValueError, match="iid"):
        render_pixels_planar(scene, cam, _ids(64), key_words(0), spp=2,
                             sample_offset=2, width=W, height=H,
                             max_depth=3, camera_mode="thinlens",
                             options=strat)


def test_stratified_halves_compose():
    scene = simple_scene_cuda(CPU)
    cam = reference_cuda_camera(W, H, CPU)
    key = key_words(4)
    strat = dataclasses.replace(DEFAULT, sampling="stratified")
    kw = dict(width=W, height=H, max_depth=6, camera_mode="thinlens",
              options=strat)
    a = render_pixels_planar(scene, cam, _ids(), key, spp=4,
                             sample_offset=0, spp_strata=8, **kw)
    b = render_pixels_planar(scene, cam, _ids(), key, spp=4,
                             sample_offset=4, spp_strata=8, **kw)
    both = render_pixels_planar(scene, cam, _ids(), key, spp=8, **kw)
    np.testing.assert_allclose(((a + b) / 2).numpy(), both.numpy(),
                               rtol=1e-6, atol=1e-7)


def test_tiny_batch_tiers_clamped_and_stats_honest():
    scene = simple_scene_cuda(CPU)
    cam = reference_cuda_camera(W, H, CPU)
    out, stats = adaptive.render_adaptive(
        scene, cam, key_words(0), width=W, height=H, spp_base=4,
        max_depth=3, camera_mode="thinlens", options=DEFAULT,
        pixel_ids=_ids(1), return_stats=True)
    assert tuple(out.shape) == (1, 3)
    assert sum(n for n, _ in stats["tiers"]) <= 1  # clamped to p
    extra = sum(n * e for n, e in stats["tiers"])
    assert stats["rays_stage2"] == extra
    assert stats["avg_spp"] == (1 * 4 + extra) / 1
    with pytest.raises(ValueError, match="even"):
        adaptive.render_adaptive(
            scene, cam, key_words(0), width=W, height=H, spp_base=3,
            max_depth=3, camera_mode="thinlens", options=DEFAULT)


def test_adaptive_allocates_to_noise_and_stays_unbiased():
    """(a) stage-2 samples land on the noisiest pixels; (b) the global
    mean matches uniform sampling within MC noise; (c) at equal average
    budget the adaptive image has lower MSE than uniform; (d) the
    stratified composition stays unbiased and does not lose to
    adaptive-iid -- the JAX test's bounds."""
    scene = simple_scene_cuda(CPU)
    cam = _wide_cam()
    kw = dict(width=W, height=H, max_depth=6, camera_mode="thinlens",
              options=DEFAULT)
    truth = render_pixels_planar(scene, cam, _ids(), key_words(999),
                                 spp=256, **kw).numpy()
    n_keys = 6
    mse_ad, mse_un, means_ad, means_un = [], [], [], []
    for k in range(n_keys):
        key = key_words(10 + k)
        img_ad, stats = adaptive.render_adaptive(
            scene, cam, key, spp_base=8, return_stats=True, **kw)
        spp_match = int(np.ceil(stats["avg_spp"]))
        img_un = render_pixels_planar(scene, cam, _ids(), key,
                                      spp=spp_match, **kw)
        img_ad, img_un = img_ad.numpy(), img_un.numpy()
        mse_ad.append(((img_ad - truth) ** 2).mean())
        mse_un.append(((img_un - truth) ** 2).mean())
        means_ad.append(img_ad.mean())
        means_un.append(img_un.mean())
    se = np.std(means_un, ddof=1) / np.sqrt(n_keys)
    assert abs(np.mean(means_ad) - np.mean(means_un)) < 6 * max(se, 1e-4)
    assert np.mean(mse_ad) < 0.9 * np.mean(mse_un), (
        np.mean(mse_ad), np.mean(mse_un))

    strat = dataclasses.replace(DEFAULT, sampling="stratified")
    mse_ast, means_ast = [], []
    for k in range(n_keys):
        img_ast = adaptive.render_adaptive(
            scene, cam, key_words(10 + k), spp_base=8,
            **dict(kw, options=strat)).numpy()
        mse_ast.append(((img_ast - truth) ** 2).mean())
        means_ast.append(img_ast.mean())
    assert abs(np.mean(means_ast) - np.mean(means_un)) < 6 * max(se, 1e-4)
    assert np.mean(mse_ast) < 1.1 * np.mean(mse_ad), (
        np.mean(mse_ast), np.mean(mse_ad))

    m_a, m_b = adaptive.stage1(scene, cam, key_words(10), _ids(),
                               spp_base=8, **kw)
    score = (m_a - m_b).abs().sum(-1).numpy()
    top = np.sort(score)[-len(score) // 16:]
    assert top.mean() > 5 * np.median(score)


def _tier_sets(order, tiers):
    out, start = [], 0
    for n, _e in tiers:
        out.append(set(np.asarray(order[start:start + n]).tolist()))
        start += n
    return out


@pytest.mark.parametrize("sampling", ["iid", "stratified"])
@pytest.mark.parametrize("spp", [4, 8])
def test_render_adaptive_matches_jax(spp, sampling):
    jopts = dataclasses.replace(JDEFAULT, sampling=sampling)
    popts = dataclasses.replace(DEFAULT, sampling=sampling)
    jsc, psc = jscene.simple_scene_cuda(), simple_scene_cuda(CPU)
    jcam, pcam = jcamera.make_camera(*WIDE), _wide_cam()
    kw = dict(width=W, height=H, spp_base=spp, max_depth=6,
              camera_mode="thinlens")
    want, wstats = jadaptive.render_adaptive(
        jsc, jcam, jax.random.key(3), options=jopts, return_stats=True,
        **kw)
    got, gstats = adaptive.render_adaptive(
        psc, pcam, key_words(3), options=popts, return_stats=True, **kw)
    assert gstats == wstats

    # The tiers: JAX's ranking from its own stage 1, the port's from its.
    jids = jnp.arange(W * H, dtype=jnp.int32)
    jkw = dict(width=W, height=H, max_depth=6, camera_mode="thinlens",
               options=jopts, spp=spp // 2, spp_strata=spp)
    m_a = jrender_pixels_planar(jsc, jcam, jids, jax.random.key(3),
                                sample_offset=0, **jkw)
    m_b = jrender_pixels_planar(jsc, jcam, jids, jax.random.key(3),
                                sample_offset=spp // 2, **jkw)
    jscore = np.asarray(jnp.abs(m_a - m_b).sum(axis=-1))
    jorder = np.asarray(jnp.argsort(-jnp.asarray(jscore)))
    pa, pb = adaptive.stage1(psc, pcam, key_words(3), _ids(),
                             spp_base=spp, options=popts,
                             **{k: v for k, v in kw.items()
                                if k != "spp_base"})
    porder = adaptive.noise_order(pa, pb).numpy()
    start = 0
    for (n, _e), js, ps in zip(wstats["tiers"],
                               _tier_sets(jorder, wstats["tiers"]),
                               _tier_sets(porder, wstats["tiers"])):
        edge = jscore[jorder[start + n - 1]]
        tied = {int(i) for i in np.nonzero(
            np.isclose(jscore, edge, rtol=1e-6, atol=0))[0]}
        assert (js ^ ps) <= tied, (js ^ ps) - tied
        start += n

    close = np.isclose(got.numpy(), np.asarray(want), rtol=1e-4,
                       atol=5e-4).all(axis=-1)
    assert (~close).sum() <= max(1, close.size // 100), (~close).sum()


def test_render_adaptive_cli_prints_stats_and_refuses_odd_spp(tmp_path,
                                                             capsys):
    out = str(tmp_path / "a.ppm")
    flags = ["render", "--adaptive", "--scene", "simple-cuda", "--width",
             "16", "--height", "12", "--depth", "3", "--device", "cpu",
             "--engine", "wavefront-sharded", "--stats", "--out", out]
    # --adaptive runs before the engine dispatch: --engine and --stats
    # are ignored, as in the JAX CLI
    assert pcli.main([*flags, "--spp", "4"]) == 0
    lines = [ln for ln in capsys.readouterr().err.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1
    stats = json.loads(lines[0])["adaptive"]
    assert stats == {"spp_base": 4, "tiers": [[12, 16], [48, 4]],
                     "rays_stage1": 768, "rays_stage2": 384,
                     "avg_spp": 6.0}
    with pytest.raises(ValueError, match="even"):
        pcli.main([*flags, "--spp", "3"])
