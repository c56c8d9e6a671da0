"""Command-line front end: the app layer.

Counterpart of ``raytracinginoneweekend_tpu/cli.py``, with the
subcommands the port carries:

  render  -- render a scene to PPM/PNG (the reference's one behavior)
  bench   -- rays/s measurement on any config
  fit     -- inverse-rendering demo (perturb scene params, recover them)

``--device`` chooses where to run; absent, it is the CUDA card and the
command fails when there is none (``--device cpu`` runs the plain PyTorch
versions of the kernels). ``--engine`` is the single-pool wavefront
(``auto``), the dual-pool wavefront (``wavefront-dual``) or the tiled
engine; ``--hit-kernel``, ``--ownership`` and ``--fusion`` choose the
single pool's closest-hit kernel, task ownership and fusion level
(TraceOptions.hit_kernel, .ownership, .mega). ``--intersect`` chooses the tiled
engine's closest hit: ``pallas`` (the JAX package's name for the
hand-written kernel), ``jnp`` (the plain version, what every preset
names), or ``auto``, the default: the kernel on a CUDA device, the
preset's own value elsewhere. That default is the one place where the
same ``--compat`` gives other TraceOptions than the JAX package's CLI,
which never sets the field (ROADMAP.md, Queue 3). ``fit`` carries the
gradient surrogates (``--boundary-samples``, ``--secondary-samples``,
``--secondary-vertex-depths``, ``--rr-grad``, ``--rr-grad-arms``); on a
CUDA device ``--intersect auto`` routes their probe traces through the
intersect kernel. A frame whose task ledger would pass the engine's cap
deposits by pixel by itself (no flag, as in the JAX CLI). ``render
--adaptive`` is two-stage adaptive sampling on the planar engine
(adaptive.py; it ignores ``--engine`` and ``--stats``, as the JAX CLI
does); ``render --profile DIR`` writes a torch.profiler trace of the
render. ``serve`` runs the render server (serve.py) on one device, and
``--via SOCKET`` forwards ``render``, ``bench`` or ``fit`` to it.
``--engine wavefront-sharded`` / ``wavefront-dual-sharded`` render over a
mesh of workers (parallel/mesh.py): one a local CUDA card, or the one
``--device`` asked for; under ``torchrun`` (``WORLD_SIZE`` > 1) each rank
joins the process group -- NCCL, one rank a card, or gloo with
``--device cpu`` -- and rank 0 writes the image.

Examples:
  python -m raytracinginoneweekend_tpu_torch render --scene simple-cuda \
      --width 1920 --height 1080 --spp 48 --out image.png
  python -m raytracinginoneweekend_tpu_torch render --scene huge \
      --width 1200 --height 800 --spp 100 --depth 50 --out cover.png
  python -m raytracinginoneweekend_tpu_torch fit --scene simple-cuda \
      --width 200 --height 112 --params albedo,centers --steps 20 \
      --checkpoint fit.npz
  torchrun --nproc-per-node 2 -m raytracinginoneweekend_tpu_torch render \
      --scene huge --engine wavefront-sharded --out cover.png
  python -m raytracinginoneweekend_tpu_torch serve --socket /tmp/rtw.sock &
  python -m raytracinginoneweekend_tpu_torch render --via /tmp/rtw.sock \
      --scene huge --width 1200 --height 800 --spp 100 --depth 50 \
      --adaptive --out cover.ppm
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time

ENGINES = ("auto", "wavefront", "wavefront-dual", "wavefront-sharded",
           "wavefront-dual-sharded", "tiled")


def _build_scene(name: str, seed: int, device):
    from .models import scene as scenes

    built = {
        "simple-cuda": lambda: scenes.simple_scene_cuda(device),
        "simple-cpu": lambda: scenes.simple_scene_cpu(device),
        "huge": lambda: scenes.huge_scene(seed, device),
        "wall": lambda: scenes.wall_scene(seed, device=device),
    }[name]()
    return scenes.validate_scene(built)


def _build_camera(name: str, width: int, height: int, device):
    from .models import camera as cameras

    return {
        "cuda": cameras.reference_cuda_camera,
        "cpu": cameras.reference_cpu_camera,
    }[name](width, height, device)


def _options(compat: str, rr_terminate: bool = False,
             sampling: str | None = None, intersect: str = "auto",
             device=None, fusion: str | None = None,
             hit_kernel: str | None = None, ownership: str | None = None):
    """The preset's TraceOptions with the CLI's overrides. ``intersect``:
    "jnp" or "pallas" is taken as given; "auto" is the hand-written kernel
    ("pallas") on a CUDA ``device`` and the preset's value elsewhere. The
    wavefront engine ignores the knob."""
    from . import config

    opts = {
        "default": config.DEFAULT,
        "reference-cuda": config.REFERENCE_CUDA,
        "reference-cpu": config.REFERENCE_CPU,
    }[compat]
    if rr_terminate:
        opts = dataclasses.replace(opts, rr_terminate=True)
    if sampling is not None:
        opts = dataclasses.replace(opts, sampling=sampling)
    if fusion is not None:
        opts = dataclasses.replace(opts, mega=fusion)
    if hit_kernel is not None:
        opts = dataclasses.replace(opts, hit_kernel=hit_kernel)
    if ownership is not None:
        opts = dataclasses.replace(opts, ownership=ownership)
    if intersect == "auto":
        on_card = device is not None and device.type == "cuda"
        intersect = "pallas" if on_card else opts.intersect
    return dataclasses.replace(opts, intersect=intersect)


def _add_render_flags(p: argparse.ArgumentParser):
    p.add_argument("--scene", default="simple-cuda",
                   choices=["simple-cuda", "simple-cpu", "huge", "wall"])
    p.add_argument("--camera", default=None, choices=["cuda", "cpu"],
                   help="default: cuda for simple-cuda, cpu otherwise")
    p.add_argument("--mode", default="thinlens",
                   choices=["thinlens", "pinhole", "cuda", "cpu"],
                   help="camera defocus mode (models/camera.py)")
    p.add_argument("--compat", default="default",
                   choices=["default", "reference-cuda", "reference-cpu"])
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--spp", type=int, default=48)
    p.add_argument("--depth", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--engine", default="auto", choices=ENGINES,
                   help="auto = the single-pool wavefront engine; "
                        "wavefront-dual = the dual-pool engine (cone cull "
                        "+ list kernel on the camera rays); tiled = the "
                        "(N, 3) autograd-capable engine; the sharded "
                        "engines run one worker a local CUDA card (or on "
                        "--device alone), --pool-size lanes a worker")
    p.add_argument("--pool-size", type=int, default=1 << 15)
    p.add_argument("--fusion", default=None,
                   choices=["off", "bounce", "fused"],
                   help="wavefront kernel-fusion level (TraceOptions.mega; "
                        "default: the compat preset's, 'fused'; 'bounce' = "
                        "the whole-bounce kernel, 'off' = closest-hit "
                        "kernel + plain PyTorch)")
    p.add_argument("--hit-kernel", default=None,
                   choices=["sublane", "mxu", "sorted"],
                   help="closest-hit kernel (TraceOptions.hit_kernel; "
                        "'sorted' = distance-ordered early exit, 'mxu' = "
                        "regrouped dot products)")
    p.add_argument("--ownership", default=None,
                   choices=["strided", "tile"],
                   help="wavefront task-ownership layout (TraceOptions."
                        "ownership; 'tile' = block-contiguous 32x32-pixel "
                        "tile ranges -- the coherent layout for "
                        "--hit-kernel sorted)")
    p.add_argument("--intersect", default="auto",
                   choices=["auto", "jnp", "pallas"],
                   help="the tiled engine's closest hit "
                        "(TraceOptions.intersect): pallas = the "
                        "hand-written kernel, jnp = the plain version, "
                        "auto = the kernel on a CUDA device and the "
                        "preset's value elsewhere")
    p.add_argument("--sampling", default=None,
                   choices=["iid", "stratified"],
                   help="pixel-jitter sampling (TraceOptions.sampling; "
                        "'stratified' = opt-in low-discrepancy jitter, "
                        "unbiased)")
    p.add_argument("--rr-terminate", action="store_true",
                   help="Russian-roulette path termination (unbiased "
                        "estimator change: fewer traced segments, "
                        "slightly higher MC variance)")
    p.add_argument("--stats", action="store_true",
                   help="print the wavefront engine's occupancy counters "
                        "(iterations, traced segments, lane occupancy; "
                        "for --engine wavefront-dual its metrics dict) as "
                        "a JSON line on stderr")
    p.add_argument("--adaptive", action="store_true",
                   help="two-stage adaptive sampling (adaptive.py): "
                        "--spp becomes the base; the noisiest 6.25%% of "
                        "pixels get +4x and the next 25%% +1x extra "
                        "samples (avg 1.5x budget). Opt-in estimator "
                        "change; composes with --sampling stratified "
                        "(stage 1 keeps the full stratified pattern, "
                        "tiers draw iid); runs on the planar engine")
    p.add_argument("--device", default=None,
                   help="torch device to run on; default: the CUDA card "
                        "(fails when there is none). 'cpu' runs the "
                        "kernels' plain PyTorch versions")
    p.add_argument("--via", default=None, metavar="SOCKET",
                   help="forward to a running render server (see the "
                        "serve subcommand), which renders on its own "
                        "device with its kernels already loaded")


def _process_group_up() -> bool:
    """A torch.distributed process group is initialised (torchrun)."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


SHARDED_ENGINES = ("wavefront-sharded", "wavefront-dual-sharded")


def _join_group(args) -> None:
    """Under torchrun (WORLD_SIZE > 1) a sharded render joins the process
    group before anything touches a card, so that each rank's first CUDA
    use is on its own card (NCCL; gloo when the CPU was asked for)."""
    if (args.adaptive or args.engine not in SHARDED_ENGINES
            or int(os.environ.get("WORLD_SIZE", "1")) <= 1
            or _process_group_up()):
        return
    from .parallel.distributed import initialize_distributed

    cpu = args.device is not None and str(args.device).startswith("cpu")
    initialize_distributed(backend="gloo" if cpu else None)


def _render_image(args):
    """-> ((H, W, 3) linear radiance tensor on the device, RenderConfig)."""
    from .config import RenderConfig
    from .ops.threefry import key_words, normal, split
    from .ops.wavefront import render_wavefront
    from .utils.device import resolve_device
    from .utils.timing import span

    _join_group(args)
    device = resolve_device(args.device)
    with span("rtw.render.scene"):
        scene = _build_scene(args.scene, args.seed, device)
        camera_name = args.camera or ("cuda" if args.scene == "simple-cuda"
                                      else "cpu")
        cam = _build_camera(camera_name, args.width, args.height, device)
    options = _options(args.compat, args.rr_terminate, args.sampling,
                       args.intersect, device, args.fusion,
                       args.hit_kernel, args.ownership)
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.depth, camera_mode=args.mode,
                       options=options)
    if args.adaptive:
        # Before the engine dispatch, as in the JAX CLI: the planar
        # engine, whatever --engine or --stats say.
        from .adaptive import render_adaptive

        img, astats = render_adaptive(
            scene, cam, key_words(args.seed), width=args.width,
            height=args.height, spp_base=args.spp, max_depth=args.depth,
            camera_mode=args.mode, options=options, return_stats=True)
        print(json.dumps({"adaptive": astats}), file=sys.stderr)
        return img.reshape(args.height, args.width, 3), cfg
    if args.engine == "tiled":
        from .render import render

        if args.stats:
            raise ValueError("--stats reports the wavefront engine's "
                             "counters; the tiled engine has none")
        return render(scene, cam, cfg, key_words(args.seed),
                      device=device), cfg
    kw = dict(width=args.width, height=args.height, spp=args.spp,
              max_depth=args.depth, camera_mode=args.mode,
              options=options, pool_size=args.pool_size, device=device)
    key = key_words(args.seed)
    if args.engine in SHARDED_ENGINES:
        from .parallel import mesh as pmesh

        if args.stats:
            raise ValueError("--stats reports one engine's counters; run "
                             "the unsharded engine for them")
        # every local card (under a process group this rank's), or the
        # one device asked for
        mesh = pmesh.make_mesh(None if args.device is None else [device])
        kw.pop("device")
        fn = (pmesh.render_wavefront_sharded
              if args.engine == "wavefront-sharded"
              else pmesh.render_wavefront_dual_sharded)
        img = fn(scene, cam, key, mesh=mesh, **kw)
    elif args.engine == "wavefront-dual":
        from .ops.wavefront_dual import render_wavefront_dual

        if args.stats:
            img, met = render_wavefront_dual(scene, cam, key,
                                             with_metrics=True, **kw)
            print(json.dumps(met), file=sys.stderr)
        else:
            img = render_wavefront_dual(scene, cam, key, **kw)
    elif args.stats:
        img, stats = render_wavefront(scene, cam, key, return_stats=True,
                                      **kw)
        it, seg, lanes = stats["iters"], stats["segments"], stats["lanes"]
        print(json.dumps({
            **stats,
            "occupancy": seg / max(it * lanes, 1),
            "segments_per_camera_ray":
                seg / (args.width * args.height * args.spp),
        }), file=sys.stderr)
    else:
        img = render_wavefront(scene, cam, key, **kw)
    return img.reshape(args.height, args.width, 3), cfg


def _via_server(args, cmd: str) -> int:
    """Forward a render/bench/fit request to a running render server."""
    from . import serve

    # Handshake BOTH ways: the request carries proto (a newer server
    # rejects us), and we check the server's ping proto first (an OLDER
    # server would otherwise drop unknown request keys -- e.g. adaptive
    # -- and silently render something else).
    info = serve.request(args.via, {"cmd": "ping"})
    if info.get("proto") != serve.PROTO_VERSION:
        print(json.dumps({
            "ok": False,
            "error": f"server at {args.via} runs protocol "
                     f"{info.get('proto')!r}, client needs "
                     f"{serve.PROTO_VERSION} -- restart the server "
                     f"from this checkout"}))
        return 1
    refused = [flag for flag, on in (
        ("--stats", args.stats), ("--profile", getattr(args, "profile",
                                                       None)),
        ("--device", args.device)) if on]
    if refused:
        # The server would render fine but never produce the counters or
        # the trace asked for, and it renders on its own device (serve
        # --device): refuse instead of silently diverging.
        print(json.dumps({
            "ok": False,
            "error": f"{'/'.join(refused)} not supported with --via; run "
                     "locally for engine counters or profiler traces, "
                     "and choose the server's device with serve "
                     "--device"}))
        return 1
    # Every knob that changes the frame forwards (the server's request
    # keys are this CLI's flags), or a --via render would silently differ
    # from the local one; paths go as absolute paths.
    req = {k: v for k, v in vars(args).items()
           if k in serve.request_keys(cmd)}
    req.update(cmd=cmd, proto=serve.PROTO_VERSION)
    if cmd == "render":
        req["out"] = os.path.abspath(args.out)
        req["clamp"] = not args.no_clamp
    for k in ("checkpoint", "resume"):
        if req.get(k):
            req[k] = os.path.abspath(req[k])
    resp = serve.request(args.via, req)
    print(json.dumps(resp))
    return 0 if resp.get("ok") else 1


def cmd_render(args) -> int:
    if args.via:
        return _via_server(args, "render")
    from .io.image import write_png, write_ppm
    from .ops.postprocess import to_u8
    from .utils.device import resolve_device
    from .utils.timing import profile_trace

    prof = (profile_trace(args.profile, resolve_device(args.device))
            if args.profile else contextlib.nullcontext())
    t0 = time.perf_counter()
    with prof:
        img, _cfg = _render_image(args)
        u8 = to_u8(img, clamp=not args.no_clamp).cpu().numpy()  # waits
    dt = time.perf_counter() - t0
    from .parallel.distributed import is_primary_host

    if is_primary_host():
        writer = write_png if args.out.endswith(".png") else write_ppm
        writer(args.out, u8)  # one writer under a process group
    rays = args.width * args.height * args.spp
    print(f"wrote {args.out} ({args.width}x{args.height} @ {args.spp}spp, "
          f"depth {args.depth}) in {dt:.2f}s "
          f"({rays / dt / 1e6:.2f} Mrays/s) on {img.device}")
    return 0


def cmd_bench(args) -> int:
    if args.via:
        return _via_server(args, "bench")
    from .render import render_rays_count
    from .utils.device import resolve_device
    from .utils.timing import time_fn

    device = resolve_device(args.device)
    cfgs = []

    def run():
        img, cfg = _render_image(args)
        cfgs.append(cfg)
        return img

    seconds, _ = time_fn(run, warmup=1, iters=args.iters, device=device)
    print(json.dumps({
        "metric": f"rays_per_s_{args.scene}_{args.width}x{args.height}_"
                  f"{args.spp}spp_d{args.depth}_{args.engine}",
        "value": render_rays_count(cfgs[-1]) / seconds,
        "unit": "rays/s",
        "seconds_per_frame": seconds,
        "device": device.type,
    }))
    return 0


def _fit_impl(args, log=print) -> dict:
    """The fit pipeline (perturb -> recover); returns a result dict.

    The target is rendered by the tiled engine (``render.render``); the
    parameters named by ``--params`` are perturbed with the JAX package's
    normal noise (from the key of ``--seed + 1``, split once a leaf:
    ``k, sub = split(k)``, ``--perturb * normal(sub, leaf.shape)``) and
    recovered by ``optim.fit``, whose pixel batches and Adam are the JAX
    package's too.
    """
    from .config import RenderConfig
    from .ops.threefry import key_words, normal, split
    from .optim import (fit, load_checkpoint, params_from_scene,
                        save_checkpoint)
    from .render import render
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    scene = _build_scene(args.scene, args.seed, device)
    camera_name = args.camera or ("cuda" if args.scene == "simple-cuda"
                                  else "cpu")
    cam = _build_camera(camera_name, args.width, args.height, device)
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.depth, camera_mode=args.mode,
                       options=_options(args.compat, args.rr_terminate,
                                        args.sampling, args.intersect,
                                        device, args.fusion,
                                        args.hit_kernel, args.ownership))
    log("rendering target...")
    target = render(scene, cam, cfg, key_words(args.seed), device=device)

    # Perturb the optimizable leaves, then recover them.
    k = key_words(args.seed + 1)
    which = tuple(args.params.split(","))
    perturbed = scene
    for name in which:
        leaf = getattr(scene, name)
        k, sub = split(k)
        noise = args.perturb * normal(sub, leaf.shape, device)
        perturbed = perturbed._replace(**{name: leaf + noise})

    init = {}
    if args.resume:
        p0, o0, step0 = load_checkpoint(args.resume,
                                        params_from_scene(perturbed, which))
        init = dict(init_params=p0, init_opt_state=o0, start_step=step0)
        log(f"resumed from {args.resume} at step {step0}")

    ckpt_path = args.checkpoint

    def callback(i, params, optimizer, loss):
        if (i + 1) % args.log_every == 0:
            log(f"step {i + 1}: loss {loss:.6f}")
        if ckpt_path and (i + 1) % args.checkpoint_every == 0:
            save_checkpoint(ckpt_path, params, optimizer, i + 1)

    _, params, optimizer, losses = fit(
        perturbed, cam, target, cfg, which=which, steps=args.steps,
        learning_rate=args.lr, batch_pixels=args.batch_pixels,
        spp=args.fit_spp, callback=callback,
        boundary_samples=args.boundary_samples,
        secondary_samples=args.secondary_samples,
        secondary_vertex_depths=args.secondary_vertex_depths,
        rr_grad=args.rr_grad, rr_grad_arms=args.rr_grad_arms,
        engine=args.ad_engine, device=device, **init)
    if ckpt_path:
        save_checkpoint(ckpt_path, params, optimizer,
                        init.get("start_step", 0) + args.steps)
    truth = params_from_scene(scene, which)
    errors = {name: float((params[name].detach() - truth[name].detach()).abs().max())
              for name in which}
    return {"errors": errors, "loss_start": losses[0],
            "loss_end": losses[-1], "steps": len(losses)}


def cmd_fit(args) -> int:
    if args.via:
        return _via_server(args, "fit")
    res = _fit_impl(args, log=lambda s: print(s, flush=True))
    for name, err in res["errors"].items():
        print(f"{name}: max abs err vs truth = {err:.5f}")
    print(f"loss: {res['loss_start']:.6f} -> {res['loss_end']:.6f}")
    return 0


def cmd_serve(args) -> int:
    from .serve import serve

    return serve(args.socket, args.device)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="raytracinginoneweekend_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a scene to PPM/PNG")
    _add_render_flags(p)
    p.add_argument("--out", default="image.png")
    p.add_argument("--no-clamp", action="store_true",
                   help="reference-exact raw u8 cast (can wrap, quirk Q6)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the render "
                        "(Chrome-trace JSON; the card's kernels by symbol "
                        "on a CUDA device) into DIR")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("bench", help="measure rays/s")
    _add_render_flags(p)
    p.add_argument("--iters", type=int, default=2)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("serve", help="persistent render server (the "
                                     "kernels and CUDA context load once)")
    p.add_argument("--socket",
                   default=os.path.join(tempfile.gettempdir(), "rtw.sock"))
    p.add_argument("--device", default=None,
                   help="the device every request runs on; default: the "
                        "CUDA card (fails when there is none)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("fit", help="inverse rendering demo")
    _add_render_flags(p)
    p.add_argument("--params", default="albedo,centers",
                   help="comma list of centers,radii,albedo,fuzz,ior")
    p.add_argument("--perturb", type=float, default=0.1)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--batch-pixels", type=int, default=4096)
    p.add_argument("--fit-spp", type=int, default=4)
    p.add_argument("--boundary-samples", type=int, default=0,
                   help="edge samples/sphere for silhouette gradients "
                        "(0 = interior AD only; needed to optimize "
                        "centers/radii through visibility changes)")
    p.add_argument("--secondary-samples", type=int, default=0,
                   help="silhouette angles/candidate for the one-bounce "
                        "(shadow/rough-reflection) boundary term (0 = off)")
    p.add_argument("--secondary-vertex-depths", type=int, default=1,
                   help="path-vertex depths the secondary boundary term "
                        "covers (1 = first hit only; n sums vertex "
                        "depths 0..n-1)")
    p.add_argument("--ad-engine", default="auto",
                   choices=["auto", "wavefront", "planar", "tiled"],
                   help="reverse-mode engine: 'auto' = by depth (planar up "
                        "to depth 32, or 28 with --rr-terminate; above it "
                        "the regenerative pool), 'planar' = fixed-depth "
                        "(R,128) planes with the closest-hit kernel, "
                        "'tiled' = the (N,3) engine, 'wavefront' = the "
                        "regenerative pool)")
    p.add_argument("--rr-grad", action="store_true",
                   help="add the dielectric Russian-roulette branch-flip "
                        "gradient term (needed for accurate ior "
                        "gradients; ops/branchprob.py)")
    p.add_argument("--rr-grad-arms", type=int, default=2,
                   help="internal-RR reflection arms per refract chain "
                        "in the delta-lobe term -- its cost-policy knob "
                        "(each arm one more side chain of probe traces; "
                        "needed only when internally-reflected content "
                        "is visible)")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--checkpoint-every", type=int, default=25)
    p.add_argument("--resume", default=None)
    p.set_defaults(fn=cmd_fit)
    return parser


def flag_defaults(cmd: str) -> dict:
    """The defaults of a subcommand's flags, by their dest (the render
    server's request keys come from these)."""
    args = build_parser().parse_args([cmd])
    return {k: v for k, v in vars(args).items() if k not in ("cmd", "fn")}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
