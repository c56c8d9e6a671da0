"""Throughput metering: wall time around synchronised device work, CUDA
events for kernel times, profiler traces, and the program's own spans.

PyTorch returns from a CUDA call before the device has finished, so every
timed region ends in ``torch.cuda.synchronize()`` (host clock) or is
bracketed by CUDA events (device clock).

Spans (``span``) are recorded only while a profiler records or a
``collect()`` table is open; otherwise each call is one flag check. A span
is stored as ``Span(name, start_ns, end_ns)`` on the host's
``time.perf_counter_ns`` clock; while a profiler records it is also a
``record_function`` range, a ``user_annotation`` event on the trace's own
timeline, so it names the device's idle gaps that open inside it.
``profiled()`` is the table of the latest profiler session; ``collect()``
opens one for a stretch of code. A count is the number of a name's spans.
The host's clock measures what the host did: a span around asynchronous
device work ends when the work is enqueued, unless it ends in a read or a
synchronise.

Spans (host seconds):

  rtw.wavefront.build    ops/wavefront: build_engine and FrameRun's
                         ledger and prologue (per frame, per worker)
  rtw.wavefront.capture  FrameRun.epoch: capture_epoch, the epoch's CUDA
                         graph (per frame, on the card)
  rtw.wavefront.read     FrameRun.more: the pending flag's read to the
                         host, which waits for the epoch (once an epoch)
  rtw.wavefront.fold     FrameRun.framebuffer: fold_ledger (enqueue)
  rtw.ad.epoch           ops/wavefront_ad: a run of the AD pool's
                         iterations as the forward runs it (an epoch; in
                         flat mode an iteration)
  rtw.ad.recompute       the same run when the backward recomputes it
  rtw.ad.shade           inside either, each iteration's shade step (the
                         bounce and the deposit)
  rtw.render.scene       cli._render_image: the scene and camera build
  rtw.serve.request      serve.handle_request: one request
  rtw.serve.idle         the server's time from its previous response to
                         this request (recorded after the fact: in the
                         table, not on the trace)
  rtw.serve.sync         the synchronise that ends a render
  rtw.serve.to_host      to_u8 and the copy of the image to the host
  rtw.serve.encode       write_png / write_ppm
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import NamedTuple

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


class Span(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns
    end_ns: int


class Table:
    """The spans of one stretch of code."""

    def __init__(self):
        self.spans: list[Span] = []

    def seconds(self) -> dict:
        """{span name: seconds, summed over its spans}."""
        out = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + (s.end_ns - s.start_ns) * 1e-9
        return out


_profiling = torch._C._autograd._profiler_enabled
_session = Table()             # the latest profiler session's
_collecting: list[Table] = []  # the collect() tables open
_hooked = False


def _new_session() -> None:
    global _session
    _session = Table()


def _hook_sessions() -> None:
    """Start a new session table whenever a profiler starts: torch calls
    ``torch.autograd.profiler._run_on_profiler_start`` then. The hook is
    torch's own, not a public one, so a torch without it is refused rather
    than left to add its sessions together. Installed at the first span
    recorded; a profiler already running then is a new session too."""
    global _hooked
    import torch.autograd.profiler as ap

    start = getattr(ap, "_run_on_profiler_start", None)
    if start is None:
        raise RuntimeError(
            "torch.autograd.profiler._run_on_profiler_start is missing: "
            "the spans of one profiler session cannot be told apart from "
            "the next's")

    def run_on_profiler_start():
        _new_session()
        start()

    ap._run_on_profiler_start = run_on_profiler_start
    _hooked = True
    if _profiling():
        _new_session()


def _tables(profiling: bool) -> list:
    """The tables a span that starts now goes to."""
    if not _hooked:
        _hook_sessions()
    return _collecting + [_session] if profiling else list(_collecting)


_OFF = contextlib.nullcontext()


class _Recording:
    __slots__ = ("name", "tables", "mark", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        profiling = _profiling()
        self.tables = _tables(profiling)
        self.mark = None
        if profiling:
            self.mark = torch.profiler.record_function(self.name)
            self.mark.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.mark is not None:
            self.mark.__exit__(*exc)
        rec = Span(self.name, self.t0, t1)
        for t in self.tables:
            t.spans.append(rec)
        return False


def span(name: str):
    """A context manager that records the body as the span ``name`` (module
    docstring); one flag check when nothing records."""
    if not _collecting and not _profiling():
        return _OFF
    return _Recording(name)


def record(name: str, start_ns: int, end_ns: int) -> None:
    """Store a span that has already ended (``time.perf_counter_ns``
    readings): in the tables only, as a profiler's trace cannot be written
    in the past."""
    profiling = _profiling()
    if not (_collecting or profiling):
        return
    rec = Span(name, start_ns, end_ns)
    for t in _tables(profiling):
        t.spans.append(rec)


@contextlib.contextmanager
def collect():
    """Record every span that starts inside the body into a new Table,
    whether or not a profiler records; yields the table. The table is the
    process's, not the thread's: it also takes the spans of other threads
    meanwhile, such as the autograd engine's device thread, which runs a
    CUDA backward's recompute (``rtw.ad.recompute``)."""
    table = Table()
    _collecting.append(table)
    try:
        yield table
    finally:
        _collecting.remove(table)


def profiled() -> Table:
    """The spans of the latest profiler session (empty before the
    first)."""
    return _session
