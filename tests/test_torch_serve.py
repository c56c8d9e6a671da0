"""PyTorch port: the render server, ``--via`` and ``render --profile``.

The port's server (``serve --device cpu``) runs as a real subprocess for
the module and speaks the JAX package's protocol: the ten tests of
tests/test_serve.py on the port, the JAX package's own client against it,
the served frame byte-equal to the port's local render, and the CLI's
``--via`` (round trip, handshake, refusals). Every wait is bounded: the
socket wait to 60 s, each request by its ``timeout``, so a hang fails a
test instead of eating the suite's clock. Tolerances: served and local
frames are the same computation on the same device, so their PPMs are
equal to the byte.
"""

import json
import math
import os
import socketserver
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from raytracinginoneweekend_tpu import serve as jserve
from raytracinginoneweekend_tpu_torch import cli as pcli
from raytracinginoneweekend_tpu_torch import serve
from raytracinginoneweekend_tpu_torch.io.image import read_ppm

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 120  # seconds a request may take here, at most
SMALL = {"scene": "simple-cuda", "width": 48, "height": 27, "spp": 4,
         "depth": 4}
TINY = {"scene": "simple-cuda", "width": 16, "height": 9, "spp": 2,
        "depth": 3}


def _flags(cfg):
    return [f"--{k.replace('_', '-')}={v}" for k, v in cfg.items()]


@pytest.fixture(scope="module")
def server():
    tmp = tempfile.mkdtemp(prefix="rtw")
    sock = os.path.join(tmp, "rtw.sock")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    # Log to a FILE, never a pipe: an undrained pipe fills and blocks the
    # server mid-request.
    log = open(os.path.join(tmp, "server.log"), "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "raytracinginoneweekend_tpu_torch", "serve",
         "--socket", sock, "--device", "cpu"], env=env, stdout=log,
        stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 60
        while True:  # the socket file appears at bind, before listen
            if proc.poll() is not None:
                raise RuntimeError(open(log.name).read())
            if time.monotonic() > deadline:
                raise RuntimeError("the server did not answer in 60 s")
            try:
                serve.request(sock, {"cmd": "ping"}, timeout=10)
                break
            except (FileNotFoundError, ConnectionRefusedError):
                time.sleep(0.1)
        yield sock
    finally:
        try:
            serve.request(sock, {"cmd": "shutdown"}, timeout=10)
        except OSError:
            pass
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()


def test_render_response_carries_its_spans(server, tmp_path):
    out = str(tmp_path / "s.ppm")
    t0 = time.perf_counter()
    resp = serve.request(server, dict(cmd="render", out=out, **TINY),
                         timeout=T)
    wall = time.perf_counter() - t0
    assert resp["ok"], resp
    spans = resp["spans"]
    assert spans["serve.to_host"] >= 0 and spans["serve.encode"] >= 0
    assert (spans["serve.to_host"] + spans["serve.encode"]
            <= spans["serve.request"] <= wall)
    assert {"serve.idle", "serve.sync", "render.scene", "wavefront.build",
            "wavefront.read", "wavefront.fold"} <= set(spans)


def test_socket_owner_only(server):
    assert (os.stat(server).st_mode & 0o777) == 0o600


def test_ping(server):
    resp = serve.request(server, {"cmd": "ping"}, timeout=T)
    assert resp["ok"] and resp["device"] == "cpu"
    assert resp["proto"] == serve.PROTO_VERSION == jserve.PROTO_VERSION


def test_protocol_version_mismatch_rejected(server):
    resp = serve.request(server, {"cmd": "render", "proto": 999}, timeout=T)
    assert not resp["ok"] and "protocol version" in resp["error"]
    assert resp["proto"] == serve.PROTO_VERSION
    assert serve.request(server, {"cmd": "ping"}, timeout=T)["ok"]


def test_render_twice_and_file(server):
    out = server + ".png"
    req = {"cmd": "render", "scene": "simple-cuda", "width": 64,
           "height": 36, "spp": 2, "depth": 4, "out": out}
    r1 = serve.request(server, req, timeout=T)
    assert r1["ok"], r1
    assert os.path.exists(out)
    t0 = time.perf_counter()
    r2 = serve.request(server, req, timeout=T)
    warm = time.perf_counter() - t0
    assert r2["ok"], r2
    assert warm < r1["seconds"] + 5.0
    assert r2["launches"] == {}  # the CPU runs the plain versions


def test_bench(server):
    resp = serve.request(server, {
        "cmd": "bench", "scene": "simple-cuda", "width": 64, "height": 36,
        "spp": 2, "depth": 4, "iters": 1}, timeout=T)
    assert resp["ok"] and resp["rays_per_s"] > 0


def test_bad_request_keeps_server_alive(server):
    resp = serve.request(server, {"cmd": "render", "scene": "nope"},
                         timeout=T)
    assert not resp["ok"] and "error" in resp
    resp = serve.request(server, {"cmd": "nope"}, timeout=T)
    assert not resp["ok"] and "unknown cmd" in resp["error"]
    assert serve.request(server, {"cmd": "ping"}, timeout=T)["ok"]


def test_fit(server, capsys):
    """A fit request runs the train loop in the server and reports what
    the same fit run locally reports, and, as the JAX test asks, a last
    step's loss no higher than the first's: the port draws the JAX
    package's pixel batches and perturbation and runs its Adam, so the six
    steps are the JAX fit's."""
    req = {"scene": "simple-cuda", "width": 24, "height": 16, "spp": 2,
           "depth": 3, "mode": "pinhole", "params": "albedo", "steps": 6,
           "fit_spp": 2, "batch_pixels": 128, "ad_engine": "wavefront"}
    resp = serve.request(server, dict(cmd="fit", **req), timeout=T)
    assert resp["ok"], resp
    assert resp["steps"] == 6
    assert "albedo" in resp["errors"]
    assert resp["loss_end"] <= resp["loss_start"]
    assert pcli.main(["fit", *_flags(req), "--device", "cpu"]) == 0
    said = capsys.readouterr().out
    assert (f"loss: {resp['loss_start']:.6f} -> {resp['loss_end']:.6f}"
            in said)
    assert f"albedo: max abs err vs truth = {resp['errors']['albedo']:.5f}" \
        in said


def test_served_fit_converges(server):
    """At 16 target spp, 8 fit spp, every pixel in each batch and a 0.3
    perturbation, the albedo signal rises above the Monte Carlo noise: ten
    served steps must at least halve the loss (measured on the CPU: 0.026
    -> 0.0058)."""
    resp = serve.request(server, {
        "cmd": "fit", "scene": "simple-cuda", "width": 24, "height": 16,
        "spp": 16, "depth": 3, "mode": "pinhole", "params": "albedo",
        "perturb": 0.3, "lr": 0.05, "steps": 10, "fit_spp": 8,
        "batch_pixels": 384, "ad_engine": "wavefront"}, timeout=T)
    assert resp["ok"], resp
    assert resp["steps"] == 10
    assert resp["loss_end"] < 0.5 * resp["loss_start"], resp


def test_request_defaults_are_the_jax_packages():
    """The request keys come from the port's CLI flags; they and their
    defaults are the JAX server's, plus ``intersect``, less
    ``secondary_spheres``: no CLI flag of either package sets that one,
    so the JAX server accepts it and nothing reads it."""
    assert serve._DEFAULTS == dict(jserve._DEFAULTS, intersect="auto")
    assert serve._FIT_DEFAULTS == {
        k: v for k, v in jserve._FIT_DEFAULTS.items()
        if k != "secondary_spheres"}


def _stub_server(sock, answers):
    """A one-connection-per-answer stub: records each request, replies
    with the next of ``answers`` -> (server, thread, seen)."""
    seen = []

    class Stub(socketserver.StreamRequestHandler):
        def handle(self):
            seen.append(json.loads(self.rfile.readline()))
            self.wfile.write((json.dumps(answers[len(seen) - 1]) + "\n")
                             .encode())

    srv = socketserver.UnixStreamServer(sock, Stub)
    srv.timeout = 30

    def loop():
        for _ in answers:
            srv.handle_request()

    th = threading.Thread(target=loop)
    th.start()
    return srv, th, seen


@pytest.mark.parametrize("cmd", ["render", "bench", "fit"])
def test_via_forwards_every_flag_the_server_takes(tmp_path, capsys, cmd):
    """--via sends each of the command's flags that is a request key, with
    its value; a flag that is not one is a local-only flag (serve's
    ``_LOCAL_ONLY``)."""
    sock = os.path.join(tempfile.mkdtemp(prefix="rtw"), "stub.sock")
    srv, th, seen = _stub_server(sock, [{"ok": True, "proto": 1},
                                        {"ok": True}])
    extra = {"render": ["--out", str(tmp_path / "x.ppm"), "--no-clamp"],
             "bench": ["--iters", "3"],
             "fit": ["--steps", "7", "--rr-grad", "--resume", "r.npz"]}
    try:
        rc = pcli.main([cmd, "--via", sock, *_flags(SMALL), "--intersect",
                        "jnp", "--sampling", "stratified", *extra[cmd]])
    finally:
        th.join(timeout=30)
        srv.server_close()
    assert rc == 0 and not th.is_alive()
    req = seen[1]
    local = pcli.flag_defaults(cmd)
    keys = serve.request_keys(cmd)
    assert set(local) - keys <= set(serve._LOCAL_ONLY)
    assert set(req) == ({k for k in local if k in keys} | {"cmd", "proto"}
                        | ({"out", "clamp"} if cmd == "render" else set()))
    assert req["cmd"] == cmd and req["proto"] == serve.PROTO_VERSION
    assert (req["intersect"], req["sampling"]) == ("jnp", "stratified")
    assert all(req[k] == v for k, v in SMALL.items())
    if cmd == "render":
        assert req["out"] == str(tmp_path / "x.ppm") and not req["clamp"]
    elif cmd == "bench":
        assert req["iters"] == 3
    else:
        assert req["steps"] == 7 and req["rr_grad"]
        assert req["resume"] == os.path.abspath("r.npz")


def test_fit_estimator_knobs_forward_through_server(server):
    resp = serve.request(server, {
        "cmd": "fit", "scene": "simple-cuda", "width": 24, "height": 16,
        "spp": 2, "depth": 3, "mode": "pinhole", "params": "albedo",
        "steps": 6, "fit_spp": 2, "batch_pixels": 128,
        "ad_engine": "wavefront", "rr_terminate": True,
        "sampling": "stratified", "rr_grad": True, "rr_grad_arms": 1},
        timeout=T)
    assert resp["ok"], resp
    assert resp["steps"] == 6 and "albedo" in resp["errors"]
    assert math.isfinite(resp["loss_end"])
    assert resp["loss_end"] < 2.0 * resp["loss_start"]


def test_adaptive_forwards_through_server(server):
    out_u, out_a = server + "_uni.ppm", server + "_ada.ppm"
    base = {"cmd": "render", "scene": "simple-cuda", "width": 48,
            "height": 27, "spp": 4, "depth": 4}
    r1 = serve.request(server, dict(base, out=out_u), timeout=T)
    r2 = serve.request(server, dict(base, out=out_a, adaptive=True),
                       timeout=T)
    assert r1["ok"] and r2["ok"], (r1, r2)
    u = read_ppm(out_u).astype(np.int32)
    a = read_ppm(out_a).astype(np.int32)
    assert (u != a).any()
    assert abs(u.mean() - a.mean()) < 3.0


def test_options_forward_through_server(server):
    out_a, out_b = server + "_a.ppm", server + "_b.ppm"
    base = {"cmd": "render", "scene": "simple-cuda", "width": 64,
            "height": 36, "spp": 4, "depth": 6}
    r1 = serve.request(server, dict(base, out=out_a), timeout=T)
    r2 = serve.request(server, dict(base, out=out_b, sampling="stratified",
                                    rr_terminate=True), timeout=T)
    assert r1["ok"] and r2["ok"], (r1, r2)
    a, b = read_ppm(out_a), read_ppm(out_b)
    assert a.shape == b.shape
    assert (a != b).any()


@pytest.mark.parametrize("adaptive", [False, True])
def test_served_frame_equals_the_local_render(server, tmp_path, adaptive,
                                              capsys):
    served, local = str(tmp_path / "s.ppm"), str(tmp_path / "l.ppm")
    resp = serve.request(server, dict(cmd="render", out=served,
                                      adaptive=adaptive, **SMALL),
                         timeout=T)
    assert resp["ok"], resp
    flags = _flags(SMALL) + (["--adaptive"] if adaptive else [])
    assert pcli.main(["render", *flags, "--device", "cpu", "--out",
                      local]) == 0
    assert open(served, "rb").read() == open(local, "rb").read()


def test_the_jax_packages_client_talks_to_the_port(server, tmp_path):
    ping = jserve.request(server, {"cmd": "ping"}, timeout=T)
    assert ping["ok"] and ping["proto"] == jserve.PROTO_VERSION
    out = str(tmp_path / "j.ppm")
    resp = jserve.request(server, dict(cmd="render", out=out,
                                       proto=jserve.PROTO_VERSION, **SMALL),
                          timeout=T)
    assert resp["ok"], resp
    assert read_ppm(out).shape == (SMALL["height"], SMALL["width"], 3)


@pytest.mark.parametrize("cmd", ["render", "bench", "fit"])
def test_via_round_trip(server, tmp_path, capsys, cmd):
    extra = {"render": ["--out", str(tmp_path / "v.ppm")],
             "bench": ["--iters", "1"],
             "fit": ["--params", "albedo", "--steps", "2", "--fit-spp",
                     "1", "--batch-pixels", "64", "--checkpoint",
                     str(tmp_path / "ck.npz"), "--checkpoint-every",
                     "1"]}[cmd]
    assert pcli.main([cmd, "--via", server, *_flags(SMALL), *extra]) == 0
    resp = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert resp["ok"], resp
    if cmd == "render":
        assert resp["out"] == str(tmp_path / "v.ppm")
        local = str(tmp_path / "l.ppm")
        assert pcli.main(["render", *_flags(SMALL), "--device", "cpu",
                          "--out", local]) == 0
        assert open(resp["out"], "rb").read() == open(local, "rb").read()
    elif cmd == "fit":
        assert resp["steps"] == 2 and os.path.exists(
            str(tmp_path / "ck.npz"))


@pytest.mark.parametrize("flag", ["--stats", "--profile", "--device"])
def test_via_refuses_what_the_server_cannot_honour(server, tmp_path,
                                                   capsys, flag):
    arg = {"--stats": [], "--profile": [str(tmp_path / "p")],
           "--device": ["cpu"]}[flag]
    out = str(tmp_path / "x.ppm")
    assert pcli.main(["render", "--via", server, *_flags(SMALL), flag,
                      *arg, "--out", out]) == 1
    resp = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not resp["ok"] and flag in resp["error"]
    assert not os.path.exists(out)


def test_via_refuses_a_server_of_another_protocol(tmp_path, capsys):
    sock = os.path.join(tempfile.mkdtemp(prefix="rtw"), "stub.sock")
    srv, th, seen = _stub_server(sock, [{"ok": True, "proto": 2}])
    try:
        rc = pcli.main(["render", "--via", sock, *_flags(SMALL), "--out",
                        str(tmp_path / "x.ppm")])
    finally:
        th.join(timeout=30)
        srv.server_close()
    assert not th.is_alive()
    assert rc == 1 and seen == [{"cmd": "ping"}]  # nothing but the ping
    resp = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not resp["ok"] and "protocol 2" in resp["error"]


def test_render_profile_writes_a_trace(tmp_path, capsys):
    prof = tmp_path / "prof"
    assert pcli.main(["render", *_flags(SMALL), "--device", "cpu",
                      "--profile", str(prof), "--out",
                      str(tmp_path / "p.ppm")]) == 0
    files = os.listdir(prof)
    assert len(files) == 1 and files[0].endswith(".json")
    trace = json.load(open(prof / files[0]))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


def test_render_profile_trace_holds_the_programs_spans(tmp_path, capsys):
    prof = tmp_path / "prof"
    assert pcli.main(["render", *_flags(TINY), "--device", "cpu",
                      "--profile", str(prof), "--out",
                      str(tmp_path / "p.ppm")]) == 0
    (name,) = os.listdir(prof)
    with open(prof / name) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"rtw.render.scene", "rtw.wavefront.build", "rtw.wavefront.read",
            "rtw.wavefront.fold"} <= names
