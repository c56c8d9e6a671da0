"""PyTorch port: the command line, and the port's independence of JAX.

The CLI comparison renders the same flags with both packages' CLIs and
compares the written 8-bit images: gamma and quantisation turn a float
difference of 1e-5 into at most one code value, so at least 99% of the
pixels are within +-1 (the remaining 1% is the frame rule's knife-edge
allowance).
"""

import dataclasses
import json
import os
import re
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from raytracinginoneweekend_tpu import cli as jcli
from raytracinginoneweekend_tpu.io.image import read_ppm as jread_ppm
from raytracinginoneweekend_tpu_torch import cli as pcli
from raytracinginoneweekend_tpu_torch import kernels
from raytracinginoneweekend_tpu_torch.io.image import read_ppm

# The suite runs in several worker processes that share the machine's cores.
# PyTorch's default, one intra-op thread per core in EVERY worker,
# oversubscribes them (measured: the same small frames take five times as
# long with six workers); the planes here are small, two threads are plenty.
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "raytracinginoneweekend_tpu_torch")
FLAGS = ["--scene", "simple-cuda", "--width", "32", "--height", "24",
         "--spp", "4", "--depth", "8", "--compat", "reference-cuda",
         "--mode", "cuda", "--pool-size", "4096"]


def _read_png(path):
    """Minimal reader for the 8-bit RGB, filter-0 PNGs the port writes."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            size = struct.unpack(">II", body[:8])
            assert body[8:] == bytes([8, 2, 0, 0, 0])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = size
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_render_cpu_matches_jax_cli(tmp_path, capsys):
    ours, theirs = str(tmp_path / "port.ppm"), str(tmp_path / "jax.ppm")
    png = str(tmp_path / "port.png")
    assert pcli.main(["render", *FLAGS, "--device", "cpu", "--out",
                      ours]) == 0
    assert "on cpu" in capsys.readouterr().out
    assert pcli.main(["render", *FLAGS, "--device", "cpu", "--out",
                      png]) == 0
    assert jcli.main(["render", *FLAGS, "--out", theirs]) == 0
    got, want = read_ppm(ours), jread_ppm(theirs)
    assert got.shape == want.shape == (24, 32, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(_read_png(png), got)
    within = (np.abs(got.astype(int) - want.astype(int)) <= 1).all(axis=-1)
    assert within.mean() >= 0.99, within.mean()
    assert got.std() > 10  # an image, not a constant


def test_render_stats_and_estimator_flags(tmp_path, capsys):
    out = str(tmp_path / "x.ppm")
    assert pcli.main(["render", "--scene", "simple-cpu", "--width", "16",
                      "--height", "12", "--spp", "2", "--depth", "4",
                      "--rr-terminate", "--sampling", "stratified",
                      "--stats", "--no-clamp", "--device", "cpu", "--out",
                      out]) == 0
    stats = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert set(stats) == {"iters", "segments", "lanes", "occupancy",
                          "segments_per_camera_ray"}
    assert stats["segments"] >= 16 * 12 * 2
    assert read_ppm(out).shape == (12, 16, 3)


def test_bench_cpu_prints_record(capsys):
    assert pcli.main(["bench", "--scene", "simple-cuda", "--width", "16",
                      "--height", "12", "--spp", "2", "--depth", "4",
                      "--iters", "1", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == {"metric", "value", "unit", "seconds_per_frame",
                        "device"}
    assert rec["metric"] == "rays_per_s_simple-cuda_16x12_2spp_d4_auto"
    assert rec["unit"] == "rays/s" and rec["device"] == "cpu"
    assert rec["value"] == pytest.approx(
        16 * 12 * 2 / rec["seconds_per_frame"])


@pytest.mark.parametrize("device", ["cpu", None])
def test_cli_joins_the_group_before_touching_a_device(device, tmp_path,
                                                      monkeypatch):
    """Under torchrun (WORLD_SIZE > 1) a sharded render joins the process
    group before it resolves its device or builds the scene, so that each
    rank's first CUDA use is on the card the join made current: NCCL (the
    backend's default) for the card, gloo for ``--device cpu``."""
    from raytracinginoneweekend_tpu_torch.parallel import distributed
    from raytracinginoneweekend_tpu_torch.utils import device as pdevice

    calls = []
    resolve, build = pdevice.resolve_device, pcli._build_scene
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(distributed, "initialize_distributed",
                        lambda backend=None: calls.append(("join", backend)))
    monkeypatch.setattr(pdevice, "resolve_device", lambda d=None: (
        calls.append(("resolve", d)), resolve(d))[1])
    monkeypatch.setattr(pcli, "_build_scene", lambda *a: (
        calls.append(("scene", str(a[-1]))), build(*a))[1])
    argv = ["render", "--width", "8", "--height", "8", "--spp", "1",
            "--engine", "wavefront-sharded", "--out",
            str(tmp_path / "x.ppm")]
    if device is None:
        if torch.cuda.is_available():
            pytest.skip("checks the order up to the missing card")
        with pytest.raises(RuntimeError, match="CUDA"):
            pcli.main(argv)
        assert calls == [("join", None), ("resolve", None)]
        return
    assert pcli.main(argv + ["--device", device]) == 0
    assert calls == [("join", "gloo"), ("resolve", "cpu"), ("scene", "cpu")]


def test_cli_device_default_is_cuda_and_sharded_engines_render(tmp_path):
    out = str(tmp_path / "x.ppm")
    small = ["--width", "8", "--height", "8", "--spp", "1", "--out", out]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pcli.main(["render", *small])
        with pytest.raises(RuntimeError, match="CUDA"):
            pcli.main(["fit", "--width", "8", "--height", "8", "--steps",
                       "1"])
    # the sharded engines on the one device asked for: a one-worker mesh,
    # the unsharded engine's image
    for engine, plain in (("wavefront-sharded", "wavefront"),
                          ("wavefront-dual-sharded", "wavefront-dual")):
        images = []
        for e in (engine, plain):
            out_e = str(tmp_path / f"{e}.ppm")
            assert pcli.main(["render", *small[:-1], out_e, "--device",
                              "cpu", "--engine", e]) == 0
            with open(out_e, "rb") as f:
                images.append(f.read())
        assert images[0] == images[1], engine
    # the whole-bounce step is carried (tests/test_torch_mega.py)
    assert pcli.main(["render", *small, "--device", "cpu", "--fusion",
                      "bounce"]) == 0
    # the server runs on the card unless asked (tests/test_torch_serve.py)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pcli.main(["serve", "--socket", str(tmp_path / "s.sock")])
    assert not os.path.exists(tmp_path / "s.sock")
    # --via forwards to a server, and there is none at this socket
    for cmd in ("render", "bench", "fit"):
        with pytest.raises(FileNotFoundError):
            pcli.main([cmd, "--via", str(tmp_path / "none.sock")])


HUGE_FLAGS = ["--scene", "huge", "--width", "48", "--height", "32", "--spp",
              "4", "--depth", "6"]


def test_render_dual_cpu_matches_jax_cli(tmp_path, capsys):
    flags = [*HUGE_FLAGS, "--engine", "wavefront-dual", "--pool-size",
             "24576"]
    ours, theirs = str(tmp_path / "port.ppm"), str(tmp_path / "jax.ppm")
    assert pcli.main(["render", *flags, "--device", "cpu", "--stats",
                      "--out", ours]) == 0
    met = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert set(met) == {"iterations", "issue_lane_iters",
                        "secondary_active_lane_iters",
                        "primary_blocked_lane_iters",
                        "primary_candidate_total", "handoffs", "p_lanes",
                        "s_lanes"}
    assert met["issue_lane_iters"] == 48 * 32 * 4
    assert (met["p_lanes"], met["s_lanes"]) == (8192, 16384)
    assert jcli.main(["render", *flags, "--out", theirs]) == 0
    got, want = read_ppm(ours), jread_ppm(theirs)
    assert got.shape == want.shape == (32, 48, 3)
    within = (np.abs(got.astype(int) - want.astype(int)) <= 1).all(axis=-1)
    assert within.mean() >= 0.99, within.mean()
    assert got.std() > 10


@pytest.mark.parametrize("flags", [
    ["--hit-kernel", "sorted", "--ownership", "tile"],
    ["--hit-kernel", "sorted"], ["--ownership", "tile"],
    ["--fusion", "off"],
], ids=["sorted_tile", "sorted", "tile", "off"])
def test_render_variant_flags_write_the_default_image(tmp_path, flags):
    """--hit-kernel sorted, --ownership tile and --fusion off change how
    the frame is traced, not one bit of it."""
    base, out = str(tmp_path / "base.ppm"), str(tmp_path / "variant.ppm")
    common = [*HUGE_FLAGS, "--pool-size", "2048", "--device", "cpu"]
    assert pcli.main(["render", *common, "--out", base]) == 0
    assert pcli.main(["render", *common, *flags, "--out", out]) == 0
    np.testing.assert_array_equal(read_ppm(out), read_ppm(base))


def test_render_mxu_flag_matches_jax_cli(tmp_path):
    flags = [*HUGE_FLAGS, "--pool-size", "2048", "--hit-kernel", "mxu"]
    ours, theirs = str(tmp_path / "port.ppm"), str(tmp_path / "jax.ppm")
    assert pcli.main(["render", *flags, "--device", "cpu", "--out",
                      ours]) == 0
    assert jcli.main(["render", *flags, "--out", theirs]) == 0
    got, want = read_ppm(ours), jread_ppm(theirs)
    within = (np.abs(got.astype(int) - want.astype(int)) <= 1).all(axis=-1)
    assert within.mean() >= 0.99, within.mean()


def test_options_take_the_engine_flags():
    opts = pcli._options("default", fusion="off", hit_kernel="sorted",
                         ownership="tile")
    assert (opts.mega, opts.hit_kernel, opts.ownership) == \
        ("off", "sorted", "tile")
    assert opts == dataclasses.replace(
        pcli._options("default"), mega="off", hit_kernel="sorted",
        ownership="tile")
    want = jcli._options("default", "off", False, "sorted", "tile", None)
    assert (want.mega, want.hit_kernel, want.ownership) == \
        ("off", "sorted", "tile")


FIT_FLAGS = ["--scene", "simple-cuda", "--width", "24", "--height", "16",
             "--spp", "2", "--depth", "3", "--params", "albedo", "--fit-spp",
             "2", "--batch-pixels", "128", "--device", "cpu"]


def test_render_tiled_cpu_matches_jax_cli(tmp_path):
    flags = ["--scene", "simple-cuda", "--width", "32", "--height", "24",
             "--spp", "4", "--depth", "6", "--engine", "tiled"]
    ours, theirs = str(tmp_path / "port.ppm"), str(tmp_path / "jax.ppm")
    assert pcli.main(["render", *flags, "--device", "cpu", "--out",
                      ours]) == 0
    assert jcli.main(["render", *flags, "--out", theirs]) == 0
    got, want = read_ppm(ours), jread_ppm(theirs)
    assert got.shape == want.shape == (24, 32, 3)
    within = (np.abs(got.astype(int) - want.astype(int)) <= 1).all(axis=-1)
    assert within.mean() >= 0.99, within.mean()
    with pytest.raises(ValueError, match="--stats"):
        pcli.main(["render", *flags, "--device", "cpu", "--stats", "--out",
                   ours])


def test_fit_cpu_writes_a_checkpoint_and_resumes(tmp_path, capsys):
    ck = str(tmp_path / "fit.npz")
    assert pcli.main(["fit", *FIT_FLAGS, "--steps", "6", "--log-every", "2",
                      "--checkpoint", ck, "--checkpoint-every", "4"]) == 0
    said = capsys.readouterr().out
    assert "rendering target..." in said and "step 6: loss" in said
    assert re.search(r"albedo: max abs err vs truth = \d+\.\d{5}", said)
    assert re.search(r"loss: \d+\.\d{6} -> \d+\.\d{6}", said)
    with np.load(ck) as data:
        assert int(data["__step__"]) == 6 and int(data["o0"]) == 6
        assert data["p0"].shape == (4, 3)  # four materials
    assert pcli.main(["fit", *FIT_FLAGS, "--steps", "2", "--resume", ck,
                      "--checkpoint", ck, "--ad-engine", "tiled",
                      "--rr-terminate", "--sampling", "stratified"]) == 0
    assert "resumed from" in capsys.readouterr().out
    with np.load(ck) as data:
        assert int(data["__step__"]) == 8 and int(data["o0"]) == 8


@pytest.mark.parametrize("flags", [
    ["--boundary-samples", "4"],
    ["--secondary-samples", "2", "--secondary-vertex-depths", "2"],
    ["--rr-grad", "--rr-grad-arms", "1"],
], ids=["boundary", "secondary", "rr_grad"])
def test_fit_runs_the_gradient_surrogates(flags, capsys):
    """fit's surrogate flags reach optim.fit: the run ends with the usual
    report, and its losses are finite."""
    assert pcli.main(["fit", *FIT_FLAGS, "--steps", "2", *flags]) == 0
    said = capsys.readouterr().out
    assert re.search(r"albedo: max abs err vs truth = \d+\.\d{5}", said)
    assert re.search(r"loss: \d+\.\d{6} -> \d+\.\d{6}", said)


@pytest.mark.parametrize("flags", [
    ["--ad-engine", "wavefront"],
    ["--depth", "40", "--ad-engine", "auto"],
    ["--rr-terminate"],  # the CLI's depth 32 with rr: auto -> the pool
], ids=["wavefront", "auto_deep", "rr_terminate_at_the_default_depth"])
def test_fit_runs_the_regenerative_pool(flags, capsys):
    assert pcli.main(["fit", *FIT_FLAGS, "--steps", "2", *flags]) == 0
    said = capsys.readouterr().out
    assert "albedo: max abs err vs truth" in said and "loss:" in said


def test_options_pick_the_kernel_on_a_cuda_device_only():
    assert pcli._options("default").intersect == "jnp"
    assert pcli._options("default",
                         device=torch.device("cpu")).intersect == "jnp"
    opts = pcli._options("reference-cuda", True, "stratified",
                         device=torch.device("cuda"))
    assert opts.intersect == "pallas" and opts.rr_terminate
    assert opts.sampling == "stratified" and opts.refract == "reference"


@pytest.mark.parametrize("flag, device, want", [
    ("jnp", "cuda", "jnp"), ("pallas", "cpu", "pallas"),
    ("auto", "cuda", "pallas"), ("auto", "cpu", "jnp"),
])
def test_intersect_flag_overrides_the_device_default(flag, device, want):
    """--intersect jnp|pallas is taken as given on either device; only
    "auto" looks at the device."""
    opts = pcli._options("default", intersect=flag,
                         device=torch.device(device))
    assert opts.intersect == want
    # the rest of the preset stays the preset's
    assert opts == dataclasses.replace(pcli._options("default"),
                                       intersect=want)


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PORT):
        if os.path.basename(root) in ("build", "__pycache__"):
            continue
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    return files


def test_port_sources_do_not_import_jax():
    files = _port_sources()
    assert len(files) > 20
    pat = re.compile(r"^\s*(import|from)\s+"
                     r"(jax|optax|raytracinginoneweekend_tpu)"
                     r"(\s|\.|$)", re.M)
    for path in files:
        assert not pat.search(open(path).read()), path


def test_port_runs_without_jax_in_the_process():
    code = (
        "import sys\n"
        "import raytracinginoneweekend_tpu_torch as rt\n"
        "from raytracinginoneweekend_tpu_torch import cli, golden, kernels\n"
        "from raytracinginoneweekend_tpu_torch.utils import timing\n"
        "img = rt.render_wavefront(rt.simple_scene_cuda('cpu'),\n"
        "    rt.reference_cuda_camera(8, 8, 'cpu'), rt.key_words(0),\n"
        "    width=8, height=8, spp=1, max_depth=3, camera_mode='cuda',\n"
        "    options=rt.REFERENCE_CUDA, device='cpu')\n"
        "assert tuple(img.shape) == (64, 3)\n"
        "assert cli.main(['fit', '--width', '12', '--height', '8', '--spp',\n"
        "    '1', '--depth', '2', '--steps', '1', '--fit-spp', '1',\n"
        "    '--batch-pixels', '32', '--device', 'cpu']) == 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'optax' or m.startswith('optax.')\n"
        "       or m == 'raytracinginoneweekend_tpu'\n"
        "       or m.startswith('raytracinginoneweekend_tpu.')]\n"
        "assert not bad, bad\n"
        "print('CLEAN')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "CLEAN" in res.stdout


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    res = subprocess.run([sys.executable, os.path.join(REPO,
                                                       "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "no CUDA device" in res.stderr


def test_cpu_tensors_never_reach_the_kernels(monkeypatch, tmp_path):
    """On CPU tensors the wrappers run the plain versions: nothing is
    built, loaded or counted."""
    from raytracinginoneweekend_tpu_torch import golden

    def no_kernels(*a, **k):
        raise AssertionError("a CPU run asked for a CUDA kernel")

    monkeypatch.setattr(kernels, "entry", no_kernels)
    monkeypatch.setattr(kernels, "build", no_kernels)
    kernels.reset_launches()
    _, flags = golden.load_golden("golden_simple_cuda")
    img = golden.render_golden(flags, device="cpu", width=8, height=8)
    assert bool(torch.isfinite(img).all())
    assert pcli.main(["fit", *FIT_FLAGS, "--steps", "1"]) == 0
    assert pcli.main(["render", "--engine", "tiled", "--scene",
                      "simple-cuda", "--width", "8", "--height", "8",
                      "--spp", "1", "--depth", "2", "--device", "cpu",
                      "--out", str(tmp_path / "tiled.ppm")]) == 0
    assert pcli.main(["render", "--fusion", "bounce", "--scene",
                      "simple-cuda", "--width", "8", "--height", "8",
                      "--spp", "1", "--depth", "2", "--device", "cpu",
                      "--out", str(tmp_path / "bounce.ppm")]) == 0
    assert pcli.main(["fit", *FIT_FLAGS, "--steps", "1", "--ad-engine",
                      "wavefront"]) == 0
    assert kernels.LAUNCHES == dict.fromkeys(
        ("closest_hit", "shade_regen", "shade_only", "regen_only",
         "intersect", "closest_hit_list", "closest_hit_sorted",
         "closest_hit_mxu", "mega_bounce", "closest_hit_grouped",
         "ad_shade", "ad_shade_grad"), 0)
    assert not os.path.exists(os.path.join(kernels.BUILD_DIR, "lock"))


def test_nvcc_flags_and_entries():
    assert "-fmad=false" in kernels.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    assert not any("fast_math" in f for f in kernels.NVCC_FLAGS)
    for name, (src, argtypes) in kernels.ENTRIES.items():
        text = open(os.path.join(kernels.CSRC_DIR, src)).read()
        assert f'extern "C" int {name}(' in text
        assert "cudaGetLastError()" in text
        sig = text.split(f'extern "C" int {name}(')[1].split(")")[0]
        assert len(sig.split(",")) == len(argtypes), name
