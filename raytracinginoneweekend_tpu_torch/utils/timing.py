"""Throughput metering: wall time around synchronised device work, CUDA
events for kernel times, and profiler traces.

PyTorch returns from a CUDA call before the device has finished, so every
timed region ends in ``torch.cuda.synchronize()`` (host clock) or is
bracketed by CUDA events (device clock).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_fn(fn, *args, warmup: int = 1, iters: int = 3, device=None,
            **kwargs):
    """Time ``fn(*args, **kwargs)`` -> (best_seconds, last_result).

    ``device`` is the device the work runs on (``None`` = the CUDA card);
    on CUDA each run ends in a synchronise inside the timed region.
    """
    from .device import resolve_device

    device = resolve_device(device)
    result = None
    for _ in range(max(1, warmup)):
        result = fn(*args, **kwargs)
        _sync(device)
    best = float("inf")
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best, result


def cuda_time_ms(fn, warmup: int = 2, iters: int = 10,
                 queue_behind: bool = False) -> float:
    """Mean time of one ``fn()`` in milliseconds, by CUDA events around
    ``iters`` back-to-back calls (after ``warmup`` calls).

    As it stands this is what a caller pays per call: device time or the
    host's time to enqueue, whichever is longer. ``queue_behind=True``
    first enqueues a long matrix product, so the host runs ahead and the
    timed launches wait in the stream and then execute back to back: the
    result is the device's time alone, without launch overhead.
    """
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if queue_behind:
        a = torch.ones((8192, 8192), device="cuda")
        torch.cuda.synchronize()
        for _ in range(2):
            a @ a  # tens of milliseconds of device work to hide behind
    else:
        torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


@contextlib.contextmanager
def profile_trace(log_dir: str, device=None):
    """Capture a ``torch.profiler`` trace of the body into ``log_dir``.

    Counterpart of the JAX package's ``jax.profiler`` trace. The CPU
    activity always, the CUDA activity (the card's kernels by symbol) when
    ``device`` (``None`` = the CUDA card) is one. On exit -- also when the
    body raises -- the trace is written as Chrome-trace JSON,
    ``trace_<pid>_<ns>.json`` in ``log_dir``; yields the profiler.
    """
    from torch.profiler import ProfilerActivity, profile

    from .device import resolve_device

    device = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        _sync(device)
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
