"""Build and load the package's hand-written CUDA kernels.

The sources are ``csrc/*.cu`` (+ ``csrc/*.cuh``). At first use they are
compiled with ``nvcc`` for ``sm_90a`` into shared libraries with a plain C
interface -- one ``nvcc`` per source, all started together -- inside
``build/`` next to this file (not under version control), keyed by a hash
of all sources and the flags, and loaded with ``ctypes``. Nothing is built
or loaded when the package is imported.

Flags: ``-fmad=false`` and no ``-use_fast_math``. The kernels decide
knife-edge cases (``b*b - a*c`` at grazing incidence, the t_min exit off
the r = 1000 ground sphere) that a fused multiply-add or an approximate
``sqrt``/division/``sin`` flips, and they are held against plain PyTorch
versions whose products and sums are rounded separately.

Each C entry returns ``cudaGetLastError()`` after its launch; ``check``
raises when that is not 0. The wrappers (ops/cuda_segment.py,
ops/cuda_fused.py, ops/cuda_intersect.py, ops/cuda_mega.py,
ops/cuda_ad_shade.py) own the launch
counters; ``LAUNCHES`` here is the one table they count into, so a caller
can zero and read all of them (``launch_delta`` and ``add_launches`` keep
it true across CUDA graph replays, ops/wavefront.capture_epoch).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

# name of the C entry -> (source file, argtypes)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ENTRIES = {
    # act ox oy oz dx dy dz | table4 | hit t sb | n_lanes n_spheres t_min
    # split | stream
    "rtw_closest_hit": ("closest_hit.cu",
                        [_P] * 7 + [_P] + [_P] * 3 + [_I, _I, _F, _I, _P]),
    # config struct | state in ptrs | state out ptrs | hit t sb | table
    # | camera | n_lanes n_spheres threads pdl | stream
    "rtw_shade_regen": ("shade_regen.cu", [_P] * 8 + [_I] * 4 + [_P]),
    # config struct | state in ptrs | state out ptrs | hit t sb | table
    # | n_lanes n_spheres threads pdl | stream
    "rtw_shade_only": ("shade_regen.cu", [_P] * 7 + [_I] * 4 + [_P]),
    # config struct | state in ptrs | state out ptrs | camera | n_lanes
    # threads pdl | stream
    "rtw_regen_only": ("shade_regen.cu", [_P] * 4 + [_I] * 3 + [_P]),
    # cudaGraph_t -> its programmatic (PDL) edges, or -1 - the error
    "rtw_graph_programmatic_edges": ("shade_regen.cu", [_P]),
    # origin direction | table4 | t idx hit | n_rays n_spheres t_min
    # split | stream
    "rtw_closest_hit_n3": ("intersect.cu",
                           [_P] * 2 + [_P] + [_P] * 3
                           + [_I, _I, _F, _I, _P]),
    # counts lists | act ox oy oz dx dy dz | table4 (S+1) | hit t sb
    # | n_lanes n_spheres block_lanes list_len t_min split | stream
    "rtw_closest_hit_list": ("closest_hit_list.cu",
                             [_P] * 2 + [_P] * 7 + [_P] + [_P] * 3
                             + [_I, _I, _I, _I, _F, _I, _P]),
    # ladder (host ints) n_ladder | perm suf oc yb | act ox oy oz dx dy dz
    # | table4 (S+1) | hit t sb | stats | n_lanes n_spheres block_lanes
    # n_chunks t_min split | stream
    "rtw_closest_hit_sorted": ("closest_hit_sorted.cu",
                               [_P, _I] + [_P] * 4 + [_P] * 7 + [_P]
                               + [_P] * 3 + [_P]
                               + [_I, _I, _I, _I, _F, _I, _P]),
    # act ox oy oz dx dy dz | table4 (cx cy cz ccr) | hit t sb
    # | n_lanes n_spheres t_min split | stream
    "rtw_closest_hit_mxu": ("closest_hit_mxu.cu",
                            [_P] * 7 + [_P] + [_P] * 3
                            + [_I, _I, _F, _I, _P]),
    # state in ptrs (16) | state out ptrs (14) | table4 table10 | n_lanes
    # n_spheres t_min max_depth unit_sample phys_refract sky_bias split
    # | stream
    "rtw_mega_bounce": ("mega_bounce.cu",
                        [_P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _F, _I,
                         _P]),
    # act ox oy oz dx dy dz | table4 (sorted, S_pad) bounds4 | hit t sb
    # | stats | n_lanes n_groups t_min split | stream
    "rtw_closest_hit_grouped": ("closest_hit_grouped.cu",
                                [_P] * 7 + [_P] * 2 + [_P] * 3 + [_P]
                                + [_I, _I, _F, _I, _P]),
    # config struct | input ptrs | output ptrs | table | stream
    "rtw_ad_shade": ("ad_shade.cu", [_P] * 5),
    # config struct | input ptrs | gradient in ptrs | gradient out ptrs
    # | table | stream
    "rtw_ad_shade_grad": ("ad_shade.cu", [_P] * 6),
}

# Launch counts, one per kernel entry; each wrapper adds one where it
# launches. shade_regen's three entries (ops/cuda_fused.py) count apart:
# "shade_regen" the fused one, "shade_only" and "regen_only"; the AD
# pool's shade op (ops/cuda_ad_shade.py) "ad_shade" forward and
# "ad_shade_grad" backward.
LAUNCHES = {"closest_hit": 0, "shade_regen": 0, "shade_only": 0,
            "regen_only": 0, "intersect": 0,
            "closest_hit_list": 0, "closest_hit_sorted": 0,
            "closest_hit_mxu": 0, "mega_bounce": 0,
            "closest_hit_grouped": 0, "ad_shade": 0, "ad_shade_grad": 0}

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict = {}
build_seconds: float | None = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_delta(before: dict, after: dict) -> dict:
    """The launches counted between two snapshots of ``LAUNCHES``: {kernel:
    count} of the kernels counted at least once."""
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def add_launches(counts: dict, delta: dict, times: int = 1) -> dict:
    """``counts`` with ``delta`` added ``times`` over (a new dict).

    A CUDA graph replays the kernels its capture launched, but the
    wrappers count in Python, which runs only while the graph is captured
    (and launches nothing then): so the capture's counts are taken back
    and each replay adds them again."""
    out = dict(counts)
    for k, n in delta.items():
        out[k] = out.get(k, 0) + times * n
    return out


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if os.path.exists(cand):
            exe = cand
    if exe is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (PATH, CUDA_HOME, /usr/local/cuda/bin)")
    return exe


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC_DIR, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> dict[str, str]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library yet;
    returns {source file: library path}. Raises on any compiler error."""
    global build_seconds
    tag = _source_hash()
    os.makedirs(BUILD_DIR, exist_ok=True)
    sources = sorted({src for src, _ in ENTRIES.values()})
    out = {src: os.path.join(BUILD_DIR, f"{src[:-3]}_{tag}.so")
           for src in sources}
    todo = [src for src in sources if not os.path.exists(out[src])]
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        tmp = out[src] + f".tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", tmp, os.path.join(CSRC_DIR, src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src} (exit "
                          f"{proc.returncode}):\n{log}")
            continue
        if verbose and log:
            print(log, file=sys.stderr)
        os.replace(tmp, out[src])  # atomic: no half-written library
    if errors:
        raise RuntimeError("\n".join(errors))
    if todo:
        build_seconds = time.perf_counter() - t0
    return out


def entry(name: str):
    """The C function ``name`` (built and loaded at first use)."""
    fn = _fns.get(name)
    if fn is None:
        src, argtypes = ENTRIES[name]
        if src not in _libs:
            _libs[src] = ctypes.CDLL(build()[src])
        fn = getattr(_libs[src], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(err: int, name: str) -> None:
    """Raise when a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
