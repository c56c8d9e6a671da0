"""The scalar NumPy oracle: the port's ground truth for its engines.

Counterpart of ``raytracinginoneweekend_tpu/oracle``.
"""

from .scalar import render_oracle  # noqa: F401
