"""The check that a run loaded nothing of JAX or of the JAX package.

Top-level module names are compared whole: the PyTorch port,
``raytracinginoneweekend_tpu_torch``, begins with the JAX package's name
and is allowed.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "raytracinginoneweekend_tpu")


def forbidden_modules(modules=None) -> list:
    """Sorted names of loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)
