"""raytracinginoneweekend_tpu_torch: the PyTorch/CUDA port of the path tracer.

The JAX package ``raytracinginoneweekend_tpu`` is the reference; this
package is its port to PyTorch with hand-written CUDA kernels for NVIDIA
Hopper, one slice at a time. It imports ``torch`` and ``numpy`` and nothing
of JAX or of the JAX package. Modules keep the JAX package's names so that
a reader finds the counterpart.

Carried -- all that the JAX package does: the forward wavefront render
with its coherent-ray variants (``ops.wavefront_dual.render_wavefront_dual``, and through
``TraceOptions`` the sorted and mxu closest-hit kernels, tile ownership
and the unfused step) and its scatter deposit for frames past the ledger
cap, the tiled engine and the training path (``fit`` with the planar,
tiled and regenerative-pool AD engines and the gradient surrogates,
ops/silhouette.py and ops/branchprob.py), two-stage adaptive sampling
(``adaptive.render_adaptive``), the render server (``serve.py``), the
native image codec (``native/``), and several workers -- CUDA cards of one
process and ``torch.distributed`` ranks -- with the tail reserve
(``parallel/``: ``make_mesh`` and the sharded renders and train step,
``initialize_distributed``, the dry run):
  Scenes:      Scene, simple_scene_cuda, simple_scene_cpu, huge_scene,
               validate_scene, scene_from_numpy
  Cameras:     Camera, make_camera, reference_cuda_camera,
               reference_cpu_camera, camera_from_numpy
  Rendering:   render_wavefront, render, render_pixels, RenderConfig,
               TraceOptions + presets, key_words (the base key of a seed)
  Optimization: optim.fit, optim.make_train_step, optim.render_loss,
               optim.render_pixels_vjp, optim.save/load_checkpoint
               (each takes mesh=)
  Parallel:    parallel.make_mesh, render_sharded, render_image_sharded,
               render_wavefront_sharded, render_wavefront_dual_sharded,
               initialize_distributed
  Postprocess: to_u8, write_ppm, write_png
  CLI:         python -m raytracinginoneweekend_tpu_torch
               {render,bench,fit,serve} (render --adaptive, --profile;
               --via SOCKET)

Every entry point takes ``device=None``: that means the CUDA card, and
raises when there is none. Ask for ``device="cpu"`` explicitly (the tests
do); on CPU tensors the kernels' plain PyTorch versions run.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
from .config import DEFAULT, REFERENCE_CPU, REFERENCE_CUDA  # noqa: F401
from .config import RenderConfig, TraceOptions  # noqa: F401
from .io.image import write_png, write_ppm  # noqa: F401
from .models.camera import (Camera, camera_from_numpy,  # noqa: F401
                            make_camera, reference_cpu_camera,
                            reference_cuda_camera)
from .models.scene import (Scene, huge_scene, scene_from_numpy,  # noqa: F401
                           simple_scene_cpu, simple_scene_cuda,
                           validate_scene)
from .ops.postprocess import to_u8  # noqa: F401
from .ops.threefry import key_words  # noqa: F401
from .ops.wavefront import render_wavefront  # noqa: F401
from .render import render, render_pixels  # noqa: F401
from . import optim  # noqa: F401
from . import parallel  # noqa: F401
