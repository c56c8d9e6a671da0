"""Open loop of preview requests to the program's render server.

Traffic keys: ``rate_per_s`` (the offered load), ``spp_choices`` (each
request's samples a pixel, in equal shares), ``schedule`` (the number the
arrival order is drawn from), ``ring`` (output paths that unchecked
requests reuse). Every run offers the same work in the same order:
round(rate x seconds) requests, the same spp counts, and inter-arrival
gaps that are the quantiles of an exponential distribution of that rate,
shuffled by ``schedule``; the run's seed draws each request's scene seed
(which is also its key).

The benchmark starts the server (``benchmark/serve_launcher.py``, the
program's ``serve.serve``) on a Unix socket under ``TMPDIR``, warms it with
one request at each spp, then sends each request when it is due, from a
pool of client threads; a request's latency runs from its due time to its
response. A request that fails counts as missing every limit. The
generator's lateness (send time - due time) is reported on standard error.
``--trace 1`` asks the server to profile its first ``trace.requests``
render requests of the window.

The check: ``check.requests`` requests drawn from the seed write PNGs of
their own; the reference renders ``check.pixels`` pixels of each (the
scene from its seed, the configuration's camera, the request's spp and
key), quantises them, and compares them with the decoded PNG: the number
is the mean absolute gap in 8-bit levels (``png_mean_abs_err``).
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from ..harness import Record
from ..manifest import ROOT
from ..reference import image, scenes, tracer
from . import common

SOCKET_MAX = 100  # bytes a Unix socket path may take, with room


def _connect(s, path: str, timeout: float) -> None:
    """Connect, waiting while the server's listen backlog is full (some
    kernels answer a full backlog with EAGAIN even on a blocking socket)."""
    deadline = time.perf_counter() + timeout
    while True:
        try:
            s.connect(path)
            return
        except BlockingIOError:
            if time.perf_counter() > deadline:
                raise
            time.sleep(0.001)


def _ask(path: str, req: dict, timeout: float) -> dict:
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        _connect(s, path, timeout)
        s.settimeout(timeout)
        s.sendall((json.dumps(req) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.decode())


def plan(rate: float, seconds: float, spp_choices, schedule: int,
         seed: int):
    """-> (due times (s), spp, scene seeds) of the window's requests.

    The schedule (arrivals and spp) comes from the traffic's own
    ``schedule`` number, the same in every run; the run's seed draws the
    requests' scenes and keys."""
    rng = np.random.default_rng((schedule, 4))
    n = max(1, round(rate * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = rng.permutation(gaps) * (seconds / gaps.sum())
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    spp = rng.permutation(np.resize(np.asarray(spp_choices), n))
    seeds = np.random.default_rng((seed, 4)).choice(
        2 ** 31 - 1, size=n, replace=False) + 1
    return due, spp.astype(int), seeds.astype(int)


def _request(cfg, spp, seed, out):
    return {"cmd": "render", "proto": 1, "scene": cfg["scene_name"],
            "seed": int(seed), "width": cfg["width"],
            "height": cfg["height"], "spp": int(spp),
            "depth": cfg["max_depth"], "mode": cfg["camera_mode"],
            "engine": "auto", "pool_size": cfg["pool_size"], "out": out}


def _start(ctx, sock, report, log):
    cmd = [sys.executable, os.path.join(ROOT, "benchmark",
                                        "serve_launcher.py"),
           "--socket", sock, "--device", str(ctx.device), "--report", report]
    if ctx.fault:
        spec = os.path.join(os.path.dirname(report), "cell.json")
        with open(spec, "w") as f:
            json.dump({k: getattr(ctx, k) for k in
                       ("config", "traffic", "cell", "seed")}, f)
        cmd += ["--fault", ctx.fault, "--cell", spec]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=log,
                            stderr=subprocess.STDOUT)
    deadline = time.perf_counter() + 1200
    while time.perf_counter() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"the render server exited ({proc.returncode})")
        if os.path.exists(sock):
            try:
                if _ask(sock, {"cmd": "ping"}, 30).get("ok"):
                    return proc
            except OSError:
                pass
        time.sleep(0.05)
    proc.kill()
    raise RuntimeError("the render server did not answer")


def run(ctx) -> Record:
    rec = Record()
    work = tempfile.mkdtemp(prefix="rb")
    sock = os.path.join(work, "s")
    if len(sock.encode()) > SOCKET_MAX:
        raise RuntimeError(f"socket path {sock!r} is too long; set a "
                           "shorter TMPDIR")
    report = os.path.join(work, "report.json")
    log = open(os.path.join(work, "server.log"), "wb")
    proc = _start(ctx, sock, report, log)
    try:
        return _drive(ctx, rec, work, sock, report, proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
        shutil.rmtree(work, ignore_errors=True)


def _drive(ctx, rec, work, sock, report, proc) -> Record:
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    ring = [os.path.join(work, f"r{i}.png") for i in range(tr["ring"])]
    warm = np.random.default_rng((ctx.seed, 5)).integers(
        1, 2 ** 31, len(tr["spp_choices"]))
    for spp, seed in zip(tr["spp_choices"], warm):
        resp = _ask(sock, _request(cfg, spp, seed, ring[0]), 1200)
        if not resp.get("ok"):
            raise RuntimeError(f"warm-up request failed: {resp}")
    n_traced = ctx.cell["trace"]["requests"] if ctx.trace else 0
    if n_traced:
        _ask(sock, {"cmd": "ping", "bench_trace": n_traced}, 60)
    rec.setup_s = time.perf_counter() - ctx.t0

    due, spp, seeds = plan(tr["rate_per_s"], ctx.seconds, tr["spp_choices"],
                           tr["schedule"], ctx.seed)
    n = len(due)
    checked = set(common.draw_ids(np.random.default_rng((ctx.seed, 7)), n,
                                  ctx.cell["check"]["requests"]).tolist())
    outs = [os.path.join(work, f"c{k}.png") if k in checked
            else ring[k % len(ring)] for k in range(n)]
    done = [None] * n
    late = [0.0] * n
    lock = threading.Lock()
    t0 = time.perf_counter()

    def send(k):
        late[k] = time.perf_counter() - (t0 + due[k])
        try:
            resp = _ask(sock, _request(cfg, spp[k], seeds[k], outs[k]), 600)
        except (OSError, ValueError) as e:
            resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        with lock:
            done[k] = (time.perf_counter(), resp)

    with concurrent.futures.ThreadPoolExecutor(max_workers=64) as pool:
        futures = []
        for k in range(n):
            wait = t0 + due[k] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            futures.append(pool.submit(send, k))
        for f in futures:
            f.result()
    rec.window_s = max(d[0] for d in done) - t0
    rec.attempted = n
    for k, (t_end, resp) in enumerate(done):
        if resp.get("ok"):
            lat = t_end - (t0 + due[k])
            rec.responses.append({"latency_s": lat,
                                  "seconds": resp["seconds"],
                                  "handle_s": resp["bench_handle_s"]})
        else:
            lat = math.inf
            rec.failed += 1
            rec.notes.append(f"request {k} failed: {resp.get('error')}")
        rec.latencies_s.append(lat)
    rec.units = n - rec.failed
    rec.work["previews"] = rec.units
    rec.notes.append(f"generator: {n} requests, latest send "
                     f"{max(late) * 1e3:.3f} ms after its due time")
    _ask(sock, {"cmd": "shutdown"}, 60)
    proc.wait(timeout=120)
    with open(report) as f:
        info = json.load(f)
    if info["forbidden_modules"]:
        raise RuntimeError("the server loaded modules of JAX or of the JAX "
                           "package: " + ", ".join(info["forbidden_modules"]))
    rec.device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": info["kind"], "count": 1}
    rec.memory_peak_bytes = info["memory_peak_bytes"]
    rec.trace, rec.traced_units = info["trace"], n_traced

    _check(ctx, rec, sorted(checked), spp, seeds, outs, done)
    return rec


def check_pixels(ctx) -> np.ndarray:
    """The pixel ids the check reads, drawn from the run's seed."""
    w, h = ctx.config["width"], ctx.config["height"]
    return common.draw_ids(np.random.default_rng((ctx.seed, 6)), w * h,
                           ctx.cell["check"]["pixels"])


def _check(ctx, rec, checked, spp, seeds, outs, done):
    cfg, dev = ctx.config, ctx.device
    w, h = cfg["width"], cfg["height"]
    ids = check_pixels(ctx)
    worst = 0.0
    t_ref = time.perf_counter()
    for k in checked:
        if not done[k][1].get("ok"):
            worst = math.inf
            continue
        with open(outs[k], "rb") as f:
            got = image.read_png(f.read()).reshape(-1, 3)[ids]
        arrays, cam = scenes.from_config(cfg, scene_seed=int(seeds[k]))
        ref = tracer.trace_blocks(
            tracer.Scene(arrays, dev), cam, torch.as_tensor(ids),
            int(spp[k]), (0, int(seeds[k])), width=w, height=h,
            max_depth=cfg["max_depth"])
        worst = max(worst, common.mean_abs_gap(
            got.astype(np.float64), image.to_u8(ref.cpu().numpy())))
    rec.notes.append(f"reference: {len(checked)} requests x {len(ids)} "
                     f"pixels in {time.perf_counter() - t_ref:.3f} s")
    rec.checks["png_mean_abs_err"] = (
        worst, ctx.cell["limits"]["png_mean_abs_err"])
