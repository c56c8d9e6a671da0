"""What the drivers share: the program's inputs made from the benchmark's
arrays, the device's description and peak, and the check's numbers."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..reference import scenes


def device_info(device: torch.device) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1}
    return {"platform": device.type, "kind": device.type, "count": 1}


def memory_peak(device: torch.device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def release(device: torch.device) -> None:
    """Return the program's freed memory before the reference runs."""
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def port_inputs(scene_arrays: dict, camera_arrays: dict, device):
    """The program's Scene and Camera made from the benchmark's arrays."""
    from raytracinginoneweekend_tpu_torch.models.camera import (
        camera_from_numpy)
    from raytracinginoneweekend_tpu_torch.models.scene import (
        scene_from_numpy)

    return (scene_from_numpy(*(scene_arrays[k] for k in scenes.FIELDS),
                             device=device),
            camera_from_numpy(*(camera_arrays[k]
                                for k in scenes.CAMERA_FIELDS),
                              device=device))


def port_options(config: dict, device: torch.device):
    """The configuration's TraceOptions preset, with the hand-written
    intersect kernel on the card (what the command line's ``auto`` picks)."""
    from raytracinginoneweekend_tpu_torch import config as port_config

    opts = getattr(port_config, config["options"])
    return dataclasses.replace(
        opts, intersect="pallas" if device.type == "cuda" else "jnp")


def mean_abs_gap(program, reference) -> float:
    """Mean |program - reference| over every element; inf when either has
    a non-finite element or the shapes differ."""
    p = np.asarray(program, np.float64)
    r = np.asarray(reference, np.float64)
    if p.shape != r.shape or not (np.isfinite(p).all()
                                  and np.isfinite(r).all()):
        return math.inf
    return float(np.abs(p - r).mean())


def draw_ids(rng: np.random.Generator, n: int, k: int) -> np.ndarray:
    """k distinct ids of n, sorted."""
    return np.sort(rng.choice(n, size=min(k, n), replace=False))
