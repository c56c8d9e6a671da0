"""Device traces: what ran on the card, when, and what the host was doing.

``DeviceTrace`` wraps a stretch of a run in ``torch.profiler`` (host and
CUDA activity) and a ``bench.window`` annotation, exports the Chrome trace
to a temporary file, reads it back and deletes it. ``summarize`` reduces
the trace's events to what the per-layer metric readers and the result's
``breakdown`` need:

* ``window_s``: the annotation's length (the traced window);
* ``busy_s``: the union of the device's kernel, copy and memset intervals
  inside the window;
* ``kernel_s``: seconds on the device by kernel name, summed;
* ``gaps``: seconds the device sat idle inside the window, each gap named
  by the innermost host event that was running when it began (or
  ``(host idle)``), summed by name.

A trace with no device event gives ``busy_s`` 0; the readers report
nothing then rather than a zero share.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
WINDOW = "bench.window"
_HOST_SCAN = 256  # host events looked back at when naming a gap


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _name_gap(t, starts, host):
    """The innermost host event running at time t (the latest-starting
    one of those that contain it)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - _HOST_SCAN), -1):
        s, e, name = host[j]
        if s <= t < e:
            return name
    return "(host idle)"


def summarize(events: list) -> dict:
    """Chrome-trace events -> the trace summary (seconds throughout)."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in spans if e.get("name") == WINDOW
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise ValueError(f"the trace has no {WINDOW!r} annotation")
    w0 = min(float(e["ts"]) for e in marks)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in marks)
    kernel_s, dev = {}, []
    for e in spans:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        s0, s1 = max(s, w0), min(s + d, w1)
        if s1 <= s0:
            continue
        kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) + (s1 - s0) * 1e-6
        dev.append((s0, s1))
    merged = _merge(dev)
    busy = sum(e - s for s, e in merged)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in spans
                  if e.get("cat") in HOST_CATS and e.get("name") != WINDOW)
    starts = [h[0] for h in host]
    gaps, edge = {}, w0
    for s, e in merged + [[w1, w1]]:
        if s > edge:
            name = _name_gap(edge, starts, host)
            gaps[name] = gaps.get(name, 0.0) + (s - edge) * 1e-6
        edge = max(edge, e)
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy * 1e-6,
            "kernel_s": kernel_s, "gaps": gaps, "device_events": len(dev)}


def top(table: dict, n: int = 10) -> list:
    """The n largest entries of {name: seconds} as [[name, seconds], ...]."""
    return [[k, v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])
            [:n]]


def breakdown(summary: dict) -> dict:
    return {"device_ops": top(summary["kernel_s"]),
            "idle_gaps": top(summary["gaps"])}


def device_seconds(summary: dict, names) -> float:
    """Device seconds of the kernels whose name contains any of names."""
    return sum(v for k, v in summary["kernel_s"].items()
               if any(n in k for n in names))


class DeviceTrace:
    """Profile the body on the host and the card; ``summary`` afterwards
    (None when ``enabled`` is false). Work still queued on the card when
    the body ends is waited for inside the window."""

    def __init__(self, enabled: bool, device):
        self.enabled, self.device, self.summary = enabled, device, None

    def __enter__(self):
        if not self.enabled:
            return self
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._mark = record_function(WINDOW)
        self._mark.__enter__()
        self._torch = torch
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        if self.device.type == "cuda":
            self._torch.cuda.synchronize(self.device)
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        self.summary = summarize(events)
        return False
