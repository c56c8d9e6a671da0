"""Inverse rendering: optimize scene parameters from target pixels.

Counterpart of ``raytracinginoneweekend_tpu/optim``.
"""

from .checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from .inverse import (  # noqa: F401
    AD_ENGINE_AUTO_DEPTH, AD_ENGINE_AUTO_DEPTH_RR, DIFFERENTIABLE_LEAVES,
    adam_state_from_numpy, adam_state_to_numpy, all_reduce_gradients, fit,
    make_train_step,
    params_from_numpy, params_from_scene, render_loss, render_pixels_vjp,
    resolve_ad_engine, scene_with_params)
