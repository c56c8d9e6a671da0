"""PyTorch port vs the JAX package: the tail reserve (``reserve_frac``).

The cases of tests/test_wavefront.py::test_reserve_tail_stealing_matches_
default, each a test: the huge scene at 48x32, 24 spp in tasks of 8
samples (three tasks a pixel), depth 6, 1024 lanes asked for. Each reserve
frame of the port is held to the port's reserve-off frame within the JAX
test's bound, rtol 2e-6 / atol 2e-6 -- and, where both deposit into the
task ledger, to the bit: a reserve task's ledger cell is its task id like
any other, so only which lane traces it and when changes. Every task is
traced exactly once: the stats count the same segments with the reserve
and without.

Against the JAX package's reserve frame the case is rendered again at 4
spp in tasks of 2 samples (still two tasks a pixel) and held to the
wavefront engine's frame rule (golden.compare_frames, atol 5e-4 on the huge
scene as in tests/test_torch_wavefront.py): at 24 spp a pixel averages 24
paths and any one that a knife edge sends elsewhere moves it, so the
port's and the JAX package's frames there leave the 1% rule on 26 of 1536
pixels with the reserve and without it alike (3 of 1536 at 4 spp).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import raytracinginoneweekend_tpu_torch as rt
from raytracinginoneweekend_tpu import config as jconfig
from raytracinginoneweekend_tpu.models import camera as jcamera
from raytracinginoneweekend_tpu.models import scene as jscene
from raytracinginoneweekend_tpu.ops import wavefront as jwave
from raytracinginoneweekend_tpu_torch import golden
from raytracinginoneweekend_tpu_torch.models import camera as pcamera
from raytracinginoneweekend_tpu_torch.models import scene as pscene

torch.set_num_threads(2)

W, H = 48, 32
KW = dict(width=W, height=H, spp=24, max_depth=6, camera_mode="thinlens",
          pool_size=1024, task_samples=8)
JAX_KW = dict(KW, spp=4, task_samples=2)  # the frame held to JAX's

# name: (options changes, reserve_frac, deposit, the reserve-off frame it
# is held to: its options changes)
CASES = {
    "rf.1": ((), 0.1, None, ()),
    "rf.3": ((), 0.3, None, ()),
    "rf.1+scatter": ((), 0.1, "scatter", ()),
    "mega_off": ((("mega", "off"),), 0.15, None, (("mega", "off"),)),
    "rr_terminate": ((("rr_terminate", True),), 0.15, None,
                     (("rr_terminate", True),)),
    "tile_inert": ((("ownership", "tile"),), 0.2, None,
                   (("ownership", "tile"),)),
}


@functools.lru_cache(maxsize=None)
def _port(changes=(), reserve_frac=None, deposit=None,
          kw=tuple(KW.items())):
    img, stats = rt.render_wavefront(
        pscene.huge_scene(0, "cpu"), pcamera.reference_cpu_camera(W, H,
                                                                  "cpu"),
        rt.key_words(0), options=dataclasses.replace(rt.DEFAULT,
                                                     **dict(changes)),
        reserve_frac=reserve_frac, deposit=deposit, return_stats=True,
        device="cpu", **dict(kw))
    return img.numpy(), stats


def _jax(changes=(), reserve_frac=None, deposit=None):
    return np.asarray(jwave.render_wavefront(
        jscene.huge_scene(0), jcamera.reference_cpu_camera(W, H),
        jax.random.key(0), options=dataclasses.replace(jconfig.DEFAULT,
                                                       **dict(changes)),
        reserve_frac=reserve_frac, deposit=deposit, **JAX_KW))


@pytest.mark.parametrize("name", sorted(CASES))
def test_reserve_frame(name):
    changes, rf, deposit, base_changes = CASES[name]
    base, base_stats = _port(base_changes)
    got, stats = _port(changes, rf, deposit)
    assert np.isfinite(got).all() and got.max() > 0.05
    np.testing.assert_allclose(got, base, rtol=2e-6, atol=2e-6,
                               err_msg=name)
    assert stats["segments"] == base_stats["segments"]
    if deposit is None:
        np.testing.assert_array_equal(got, base, err_msg=name)
    if name == "tile_inert":
        assert stats["iters"] == base_stats["iters"]
    small = _port(changes, rf, deposit, tuple(JAX_KW.items()))[0]
    cmp = golden.compare_frames(small, _jax(changes, rf, deposit), atol=5e-4)
    assert cmp["ok"], cmp
