"""Persistent render server: one long-lived process on the card.

Counterpart of ``raytracinginoneweekend_tpu/serve.py`` with the same wire
protocol. A fresh process pays the torch import, the CUDA context, loading
the kernels' libraries and each frame's first CUDA-graph capture; the
server pays them once and answers many requests. At startup on the card it
calls ``kernels.build()`` (the counterpart of the JAX server's persistent
compilation cache: nvcc's libraries in ``build/``, keyed by a hash of the
sources), so the first request does not wait for nvcc.

Protocol: newline-delimited JSON over a Unix domain socket.

  {"cmd": "ping"}
  {"cmd": "render", "scene": "huge", "width": 400, ...,
   "out": "/tmp/x.png"}
  {"cmd": "bench",  "scene": "huge", ..., "iters": 3}
  {"cmd": "fit",    "scene": "simple-cuda", "params": "albedo",
   "steps": 50, ...}
  {"cmd": "shutdown"}

Responses: {"ok": true, ...} or {"ok": false, "error": "..."}. A
render's response carries ``seconds`` (the render, ending in a
synchronise), ``launches`` (the port's kernels it launched, by kernel) and
``spans``: an operator's view of where the request's time went, seconds
by span name without the ``rtw.`` prefix (``utils/timing``'s list):
``serve.request`` (the handler), ``serve.idle`` (the server's time since
its previous response: about 0 when requests queue; the wait in the listen
backlog is the kernel's and is not seen), ``render.scene`` (scene and
camera build), ``wavefront.build``, ``wavefront.capture``,
``wavefront.read``, ``wavefront.fold`` (the frame's engine; the reads
wait for the card), ``serve.sync``, ``serve.to_host`` (quantise and copy)
and ``serve.encode`` (the PNG or PPM). Under a profiler the same spans
are ``user_annotation`` ranges of its trace. The
render/bench/fit config keys are the CLI's flags (cli.py), with the JAX
package's defaults; keys the server does not know are ignored; an unknown
scene or mode returns an error instead of killing the server. Besides the
JAX package's keys a request takes ``intersect`` (the port's
``--intersect``, default "auto"). Every request runs on the one device the
server was started for (``serve --device``; default the CUDA card, and the
server refuses to start without one). One request is served at a time;
requests queue on the listening socket.

Start:  python -m raytracinginoneweekend_tpu_torch serve --socket PATH
Client: python -m raytracinginoneweekend_tpu_torch render --via PATH ...
        (or any client speaking the JSON protocol, the JAX package's
        ``serve.request`` among them)
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import socketserver
import time
import traceback

import torch

from .utils import timing

# Wire-protocol version: bumped on any incompatible request/response
# change. Clients may send {"proto": N} with any request -- a mismatch is
# an error instead of a silently misinterpreted render; ping always
# reports it. The same number as the JAX package's (one protocol).
PROTO_VERSION = 1

# Request keys and their defaults are the CLI's flags (cli.py), less those
# that mean something only to a local run; a request's frame defaults to
# the JAX package's smaller one, and render's --no-clamp arrives as
# ``clamp``. So a new CLI flag is a new request key, with no second list.
_LOCAL_ONLY = ("stats", "profile", "via", "device", "out", "no_clamp")
_FRAME = dict(width=400, height=225, spp=8, depth=16)


def _request_defaults() -> tuple[dict, dict]:
    """-> (render and bench defaults, the fit-only defaults)."""
    from . import cli

    base = {k: v for cmd in ("render", "bench")
            for k, v in cli.flag_defaults(cmd).items()
            if k not in _LOCAL_ONLY}
    defaults = dict(base, **_FRAME, clamp=True)
    fit = {k: v for k, v in cli.flag_defaults("fit").items()
           if k not in defaults and k not in _LOCAL_ONLY}
    return defaults, fit


_DEFAULTS, _FIT_DEFAULTS = _request_defaults()


def request_keys(cmd: str) -> set:
    """The keys a ``cmd`` request takes."""
    return set(_DEFAULTS) | (set(_FIT_DEFAULTS) if cmd == "fit" else set())


def _config(req, defaults) -> dict:
    cfg = dict(defaults)
    cfg.update({k: v for k, v in req.items() if k in defaults})
    return cfg


def _namespace(cfg: dict, device: torch.device) -> argparse.Namespace:
    """The CLI's Namespace for a request: no counters, no trace, no
    forwarding, the server's device."""
    return argparse.Namespace(**cfg, stats=False, profile=None, via=None,
                              device=str(device))


def _render_once(req, device):
    """One render through the same dispatch the CLI uses."""
    from . import cli

    cfg = _config(req, _DEFAULTS)
    img, _ = cli._render_image(_namespace(cfg, device))
    return img, cfg


_last_response_ns = None  # time.perf_counter_ns at the previous response


def handle_request(req, device) -> dict:
    """Dispatch one request dict -> response dict (never raises), spanned
    as ``rtw.serve.request``; a render's response gains ``spans``."""
    global _last_response_ns
    start = time.perf_counter_ns()
    with timing.collect() as table, timing.span("rtw.serve.request"):
        if _last_response_ns is not None:
            timing.record("rtw.serve.idle", _last_response_ns, start)
        resp = _dispatch(req, device)
    if resp.get("ok") and isinstance(req, dict) and (
            req.get("cmd") == "render"):
        resp["spans"] = {name.removeprefix("rtw."): sec
                         for name, sec in table.seconds().items()}
    _last_response_ns = time.perf_counter_ns()
    return resp


def _dispatch(req, device) -> dict:
    """The request's command -> its response (errors become one)."""
    try:
        proto = req.get("proto", PROTO_VERSION)
        if proto != PROTO_VERSION:
            return {"ok": False, "proto": PROTO_VERSION,
                    "error": f"protocol version mismatch: client {proto}, "
                             f"server {PROTO_VERSION}"}
        cmd = req.get("cmd")
        if cmd == "ping":
            return {"ok": True, "device": device.type, "pid": os.getpid(),
                    "proto": PROTO_VERSION}
        if cmd == "shutdown":
            return {"ok": True, "shutdown": True}
        if cmd == "render":
            from . import kernels

            before = dict(kernels.LAUNCHES)
            t0 = time.perf_counter()
            img, cfg = _render_once(req, device)
            with timing.span("rtw.serve.sync"):
                timing._sync(device)
            dt = time.perf_counter() - t0
            launches = kernels.launch_delta(before, kernels.LAUNCHES)
            out = req.get("out")
            if out:
                from .io.image import write_png, write_ppm
                from .ops.postprocess import to_u8

                with timing.span("rtw.serve.to_host"):
                    u8 = to_u8(img, clamp=cfg["clamp"]).cpu().numpy()
                writer = write_png if out.endswith(".png") else write_ppm
                with timing.span("rtw.serve.encode"):
                    writer(out, u8)
            rays = cfg["width"] * cfg["height"] * cfg["spp"]
            # launches: the kernels this render launched, by kernel
            resp = {"ok": True, "seconds": dt, "rays_per_s": rays / dt,
                    "out": out, "launches": launches}
            if device.type == "cuda":
                resp["memory_reserved"] = torch.cuda.memory_reserved(device)
            return resp
        if cmd == "bench":
            cfg = _config(req, _DEFAULTS)
            secs, _ = timing.time_fn(lambda: _render_once(req, device)[0],
                                     warmup=1, iters=int(cfg["iters"]),
                                     device=device)
            rays = cfg["width"] * cfg["height"] * cfg["spp"]
            return {"ok": True, "seconds_per_frame": secs,
                    "rays_per_s": rays / secs}
        if cmd == "fit":
            from . import cli

            cfg = _config(req, dict(_DEFAULTS, **_FIT_DEFAULTS))
            t0 = time.perf_counter()
            res = cli._fit_impl(_namespace(cfg, device), log=lambda s: None)
            res.update(ok=True, seconds=time.perf_counter() - t0)
            return res
        return {"ok": False, "error": f"unknown cmd: {cmd!r}"}
    except Exception as e:  # keep the server alive on bad requests
        traceback.print_exc()
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}


def serve(socket_path: str, device=None) -> int:
    """Run the blocking server loop until a shutdown request."""
    from .utils.device import resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        from . import kernels

        kernels.build()
    if os.path.exists(socket_path):
        os.unlink(socket_path)

    stop = []

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for line in self.rfile:
                line = line.strip()
                if not line:
                    continue
                t0 = time.perf_counter()
                try:
                    req = json.loads(line)
                except json.JSONDecodeError as e:
                    req, resp = {}, {"ok": False, "error": f"bad json: {e}"}
                else:
                    resp = handle_request(req, device)
                cmd = req.get("cmd") if isinstance(req, dict) else None
                print(f"{cmd} ok={resp.get('ok')} "
                      f"{time.perf_counter() - t0:.3f}s", flush=True)
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()
                if resp.get("shutdown"):
                    stop.append(True)
                    return

    # Owner-only socket: requests carry filesystem paths (out, checkpoint,
    # resume) the server will read and write with its own uid, so any peer
    # who can connect can drive those. The umask is tightened BEFORE bind
    # (a chmod after it would leave a window in which another local user
    # could connect); the chmod then normalises the mode whatever umask
    # bits were inherited.
    old_umask = os.umask(0o177)
    try:
        srv = socketserver.UnixStreamServer(socket_path, Handler)
    finally:
        os.umask(old_umask)
    try:
        os.chmod(socket_path, 0o600)
        print(f"rtw render server listening on {socket_path} "
              f"({device})", flush=True)
        while not stop:
            srv.handle_request()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        if os.path.exists(socket_path):
            os.unlink(socket_path)
    return 0


def request(socket_path: str, req: dict, timeout: float = 3600.0) -> dict:
    """Client: send one request, return the response dict."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(socket_path)
        s.sendall((json.dumps(req) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.decode())
