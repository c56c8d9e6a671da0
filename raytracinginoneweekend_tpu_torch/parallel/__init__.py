"""Several workers: CUDA cards of one process, and processes.

Counterpart of ``raytracinginoneweekend_tpu/parallel/``:

  - ``mesh``: a 1-D mesh of workers over the flattened pixel/task axis.
    Forward rendering is embarrassingly parallel (no collective until the
    frame's one gather); for inverse rendering the parameter gradients of
    the workers' shards are summed -- by autograd within a process, by one
    all-reduce across processes.
  - ``distributed``: the process group (``torch.distributed`` over
    ``tcp://``) and the image gather to rank 0.
  - ``dryrun``: one sharded train step and every sharded render on tiny
    shapes over an n-worker mesh.

Shard-invariance contract: every random draw is keyed only by global
(pixel, sample, bounce) ids (ops/rng.py), so a one-worker and an n-worker
render trace the same paths; the workers' partial frames are summed in a
fixed order, so two renders of one sharded frame are the same to the bit.
"""

from .mesh import (Mesh, make_mesh, render_sharded,  # noqa: F401
                   render_image_sharded, render_wavefront_sharded,
                   render_wavefront_dual_sharded)
from .distributed import initialize_distributed  # noqa: F401
