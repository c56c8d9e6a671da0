"""The process group and the image gather to rank 0.

Counterpart of ``raytracinginoneweekend_tpu/parallel/distributed.py``:
``torch.distributed.init_process_group`` over ``tcp://`` where the JAX
package calls ``jax.distributed.initialize``, and a gather of the frame to
rank 0 for writing.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None) -> None:
    """Join the process group; once a process, before any rendering.

    coordinator_address: ``host:port`` of rank 0's store (None = torchrun's
    ``MASTER_ADDR`` and ``MASTER_PORT``); num_processes and process_id:
    the world size and this rank (None = torchrun's ``WORLD_SIZE`` and
    ``RANK``), as the JAX package reads them from a pod's runtime.
    backend: None = ``"nccl"`` where this rank has a CUDA card (then the
    card ``LOCAL_RANK`` -- by default the rank modulo the card count -- is
    made current) and ``"gloo"`` on the CPU. Ranks that share one card
    must pass ``"gloo"``: NCCL refuses two ranks on one device, and this
    function never switches the backend by itself.
    """
    env = os.environ
    if coordinator_address is None:
        coordinator_address = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                               f"{env['MASTER_PORT']}")
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK",
                            process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=f"tcp://"
                            f"{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def is_primary_host() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def gather_image_to_host(image) -> np.ndarray | None:
    """The full (H, W, 3) frame as a numpy array on rank 0, None elsewhere.

    The sharded renders (parallel/mesh.py) hand every rank the whole frame
    already, so the gather is rank 0's copy to the host; in one process it
    is a plain device->host copy.
    """
    if not is_primary_host():
        return None
    return image.detach().cpu().numpy()
