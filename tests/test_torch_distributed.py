"""The port's process group on the CPU: two real processes (gloo over
localhost), as tests/test_distributed.py runs jax.distributed.

Each rank drives one worker of a 2-worker mesh (``make_mesh([cpu])`` under
``initialize_distributed(..., backend="gloo")``) through the tiled engine's
``render_sharded``, the wavefront engine's ``render_wavefront_sharded`` and
a train step's gradients (``render_loss`` with the silhouette surrogate,
attached on rank 0 only, + ``all_reduce_gradients``).
Both ranks must agree to the bit; the frames must be the port's
one-process frames to the bit (the gather sums the workers' partial frames
in worker order, as one process does), the gradients within rtol 2e-5 /
atol 1e-7 of the one-process gradients (tests/test_parallel.py's bound),
and the tiled frame within the tiled engine's tolerance of the JAX
package's ``render_pixels`` (rtol 1e-4 / atol 5e-4, at most 1% of pixels
beyond; tests/test_torch_render.py).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

W, H, SPP, DEPTH = 16, 8, 2, 3

_WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(2)

coord, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
from raytracinginoneweekend_tpu_torch.parallel import distributed
distributed.initialize_distributed(coord, 2, rank, backend="gloo")

import raytracinginoneweekend_tpu_torch as rt
from raytracinginoneweekend_tpu_torch import optim, parallel
from raytracinginoneweekend_tpu_torch.models import camera, scene

W, H, SPP, DEPTH = 16, 8, 2, 3
mesh = parallel.make_mesh([torch.device("cpu")])
assert (mesh.size, mesh.first) == (2, rank), (mesh.size, mesh.first)
sc = scene.simple_scene_cuda("cpu")
cam = camera.reference_cuda_camera(W, H, "cpu")
ids = torch.arange(W * H, dtype=torch.int32)
img = parallel.render_sharded(
    sc, cam, ids, rt.key_words(3), mesh=mesh, width=W, height=H, spp=SPP,
    wave_spp=SPP, max_depth=DEPTH, camera_mode="thinlens",
    options=rt.DEFAULT)
wf = parallel.render_wavefront_sharded(
    sc, cam, rt.key_words(3), mesh=mesh, width=W, height=H, spp=4,
    max_depth=DEPTH, camera_mode="thinlens", options=rt.DEFAULT,
    pool_size=128)
params = optim.params_from_scene(sc, ("centers", "albedo"))
loss = optim.render_loss(params, sc, cam, torch.zeros((W * H, 3)), ids,
                         rt.key_words(3), width=W, height=H, spp=SPP,
                         max_depth=DEPTH, camera_mode="thinlens",
                         options=rt.DEFAULT, mesh=mesh, boundary_samples=4)
loss.backward()
optim.all_reduce_gradients(params, mesh)
host = distributed.gather_image_to_host(img)
assert (host is None) == (rank != 0)
np.savez(out, img=img.numpy(), wf=wf.numpy(), loss=float(loss.detach()),
         **{k: v.grad.numpy() for k, v in params.items()})
print("WORKER_OK", rank)
"""


def _one_process():
    import raytracinginoneweekend_tpu_torch as rt
    from raytracinginoneweekend_tpu_torch import optim, parallel
    from raytracinginoneweekend_tpu_torch.models import camera, scene

    sc = scene.simple_scene_cuda("cpu")
    cam = camera.reference_cuda_camera(W, H, "cpu")
    ids = torch.arange(W * H, dtype=torch.int32)
    img = rt.render_pixels(sc, cam, ids, rt.key_words(3), width=W, height=H,
                           spp=SPP, wave_spp=SPP, max_depth=DEPTH,
                           camera_mode="thinlens", options=rt.DEFAULT)
    wf = parallel.render_wavefront_sharded(
        sc, cam, rt.key_words(3), mesh=parallel.make_mesh(
            [torch.device("cpu")] * 2), width=W, height=H, spp=4,
        max_depth=DEPTH, camera_mode="thinlens", options=rt.DEFAULT,
        pool_size=128)
    params = optim.params_from_scene(sc, ("centers", "albedo"))
    loss = optim.render_loss(params, sc, cam, torch.zeros((W * H, 3)), ids,
                             rt.key_words(3), width=W, height=H, spp=SPP,
                             max_depth=DEPTH, camera_mode="thinlens",
                             options=rt.DEFAULT, boundary_samples=4)
    loss.backward()
    return img.numpy(), wf.numpy(), float(loss.detach()), {
        k: v.grad.numpy() for k, v in params.items()}


def test_two_process_distributed_render(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs, outs = [], []
    for rank in range(2):
        out = os.path.join(tmp_path, f"rank{rank}.npz")
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, coord, str(rank), out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            log, _ = p.communicate()
        logs.append(log)
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log}"
        assert f"WORKER_OK {rank}" in log

    a, b = np.load(outs[0]), np.load(outs[1])
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    img, wf, loss, grads = _one_process()
    np.testing.assert_array_equal(a["img"], img)
    np.testing.assert_array_equal(a["wf"], wf)
    np.testing.assert_allclose(float(a["loss"]), loss, rtol=1e-6)
    for k, g in grads.items():
        np.testing.assert_allclose(a[k], g, rtol=2e-5, atol=1e-7,
                                   err_msg=k)

    import jax
    import jax.numpy as jnp

    from raytracinginoneweekend_tpu.config import DEFAULT
    from raytracinginoneweekend_tpu.models.camera import reference_cuda_camera
    from raytracinginoneweekend_tpu.models.scene import simple_scene_cuda
    from raytracinginoneweekend_tpu.render import render_pixels

    want = np.asarray(render_pixels(
        simple_scene_cuda(), reference_cuda_camera(W, H),
        jnp.arange(W * H, dtype=jnp.int32), jax.random.key(3), width=W,
        height=H, spp=SPP, wave_spp=SPP, max_depth=DEPTH,
        camera_mode="thinlens", options=DEFAULT))
    bad = ~np.isclose(a["img"], want, rtol=1e-4, atol=5e-4).all(axis=-1)
    assert bad.mean() <= 0.01, (int(bad.sum()), bad.size)
