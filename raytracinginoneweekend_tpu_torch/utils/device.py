"""The one rule for choosing a device.

Every entry point of the package takes ``device=None``. ``None`` means the
CUDA card and raises when there is none: no code path picks the CPU by
itself. Tests and ``--device cpu`` ask for the CPU explicitly.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``torch.device("cuda")`` (raises without a CUDA device);
    anything else -> ``torch.device(device)`` as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available and none other was asked for; "
                "pass device='cpu' (or --device cpu) to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def on_device(device):
    """Make ``device`` the current CUDA device for a block: kernel launches
    and graph captures go to the current device's streams, so a worker on
    another card than the current one launches under this. A no-op off the
    card."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
