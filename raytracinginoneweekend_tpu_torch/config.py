"""Static render/trace configuration (pure Python).

The port's copy of ``raytracinginoneweekend_tpu/config.py``: the same
frozen dataclasses, the same accepted values and the same ``ValueError``s,
so a configuration written for one package reads the same in the other.

``TraceOptions`` carries the quirk-compat switches: defaults are the
*corrected* physics; the reference renderer's exact behaviours are
reproducible for validation via the presets below.

``TraceOptions`` accepts every value the JAX package accepts, and the
port's engines carry every one; a combination the JAX engine refuses
raises the same ``ValueError`` at the engine's entry (``ops/wavefront.py``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TraceOptions:
    """Semantics switches for the integrator (all static).

    Carried by every engine of the port: ``t_min``, ``scatter_sample``,
    ``sky``, ``refract``, ``sampling`` and the ``rr_*`` knobs. The
    wavefront engine carries every ``mega``, every ``hit_kernel`` (with
    ``sorted_rows`` and ``sorted_ladder``), both ``ownership`` layouts and
    every ``resolve`` value. The dual-pool engine reads the estimator
    switches only.
    The tiled engine (render.py, ops/integrate.py) carries
    ``sphere_block``, ``intersect`` and ``gather``; the wavefront and
    planar engines ignore those three, as
    the JAX package's do.
    """

    # Minimum hit distance epsilon (raytracer.hxx:98; cuda_impl.cu:176).
    t_min: float = 0.008
    # Random vector used by lambert/metal scatter: "unit" = normalized
    # (CUDA, cuda_impl.cu:206/220, true Lambertian) or "ball" = unnormalized
    # point in the unit sphere (CPU, raytracer.hxx:134/147; quirk Q3).
    scatter_sample: str = "unit"
    # Sky gradient parameter: "cuda" = .5*y+.5 (cuda_impl.cu:293, correct)
    # or "cpu" = .5*y+1 (main.cxx:71; quirk Q6, can overflow u8).
    sky: str = "cuda"
    # Refraction formula: "physical" (standard Snell) or "reference"
    # (math.hxx:304-308 scalar-broadcast expression).
    refract: str = "physical"
    # Tiled-engine knobs. sphere_block: spheres per streamed block of the
    # plain closest hit. intersect: "jnp" = the plain PyTorch closest hit,
    # "pallas" = the hand-written kernel (csrc/intersect.cu on CUDA
    # tensors); the names are the JAX package's, kept so that the two
    # packages' options stay interchangeable. gather: "onehot" and "take"
    # name one exact gather of the winner's parameters; the port indexes
    # the table for both.
    sphere_block: int = 512
    intersect: str = "jnp"
    gather: str = "onehot"
    # Wavefront engine fusion level: "fused" = closest-hit kernel + ONE
    # shade/state/regen kernel per iteration; "off" = the unrotated step,
    # regen-only, closest-hit and shade-only kernels; "bounce" = the
    # regen-only kernel, then the whole bounce in one (ops/cuda_mega.py).
    mega: str = "fused"
    # Closest-hit kernel: "sublane" = the per-ray loop over the whole
    # sphere table; "mxu" = the same loop with the dot products regrouped
    # as d.C and o.C (up to cuda_segment.MXU_MAX_SPHERES spheres);
    # "sorted" = spheres in per-block distance order with a staged early
    # exit. sorted_rows: rows of 128 lanes per cull block of the sorted
    # kernel and per tile-ownership block (0 = 64). sorted_ladder: the
    # chunk numbers (a chunk = 8 spheres) at which the exit is tested.
    hit_kernel: str = "sublane"
    sorted_rows: int = 0
    sorted_ladder: tuple = (4,)
    # Winning-sphere parameter resolve. The JAX package's three values
    # name three one-hot matmul forms of one exact gather, which give the
    # same frame; the port indexes the table directly for all three.
    resolve: str = "onehot"
    # Pixel-jitter sampling: "iid" (reference-faithful, the parity
    # default) or "stratified" (opt-in estimator change: pixel jitter,
    # thin-lens pair and first-bounce scatter pair are remapped through a
    # rotated-stratified / van-der-Corput scheme; unbiased -- ops/rng.py).
    sampling: str = "iid"
    # Wavefront task ownership layout: "strided" = lane l owns global
    # tasks l, l+P, ... ; "tile" = each block of lanes owns a contiguous
    # range of task ids in 32x32-pixel tile order (the coherent layout for
    # hit_kernel="sorted"). Same paths; frames bit-identical with the
    # plain versions, inside the frame rule on the card (ops/wavefront.py).
    ownership: str = "strided"
    # Russian-roulette PATH TERMINATION (opt-in estimator change; the
    # reference never terminates early). After a ray has completed
    # >= rr_start bounces it survives each further bounce with
    # q = clip(rr_scale * max-channel(attenuation), rr_qmin, 1) and
    # survivors are boosted by 1/q -- unbiased in expectation. Draw: one
    # extra threefry block per bounce at (TAG_BOUNCE + b, counter 2);
    # existing draws are untouched, so rr_terminate=False is bit-identical
    # to the contract without it.
    rr_terminate: bool = False
    rr_start: int = 3
    rr_qmin: float = 0.05
    rr_scale: float = 4.0

    def __post_init__(self):
        # Real raises (not asserts): these also validate strings arriving
        # from outside the program, and asserts vanish under `python -O`.
        def _choice(name, value, allowed):
            if value not in allowed:
                raise ValueError(
                    f"TraceOptions.{name}={value!r}; must be one of "
                    f"{allowed}")

        _choice("scatter_sample", self.scatter_sample, ("unit", "ball"))
        _choice("sky", self.sky, ("cuda", "cpu"))
        _choice("refract", self.refract, ("physical", "reference"))
        _choice("intersect", self.intersect, ("jnp", "pallas"))
        _choice("mega", self.mega, ("off", "bounce", "fused"))
        _choice("hit_kernel", self.hit_kernel, ("sublane", "mxu", "sorted"))
        _choice("gather", self.gather, ("onehot", "take"))
        _choice("resolve", self.resolve, ("onehot", "split", "f32"))
        _choice("ownership", self.ownership, ("strided", "tile"))
        _choice("sampling", self.sampling, ("iid", "stratified"))
        if not (self.rr_start >= 1 and 0.0 < self.rr_qmin <= 1.0
                and self.rr_scale > 0.0):
            raise ValueError(
                f"bad rr knobs: rr_start={self.rr_start} "
                f"rr_qmin={self.rr_qmin} rr_scale={self.rr_scale}")
        if self.sorted_rows < 0 or not all(
                int(c) > 0 for c in self.sorted_ladder):
            raise ValueError(
                f"bad sorted knobs: sorted_rows={self.sorted_rows} "
                f"sorted_ladder={self.sorted_ladder}")
        if self.sampling == "stratified" and self.mega == "bounce":
            # The whole-bounce kernel's state carries no task/sid planes,
            # so it cannot honor the first-bounce half of the stratified
            # estimator -- refusing beats silently rendering a different
            # image than every other engine.
            raise ValueError(
                "sampling='stratified' is not supported with "
                "mega='bounce' (the whole-bounce ablation kernel has no "
                "task/sid state for the first-bounce stratification); "
                "use mega='fused' or 'off'")


# The semantics of the reference's ACTIVE renderer (the CUDA path).
REFERENCE_CUDA = TraceOptions(scatter_sample="unit", sky="cuda",
                              refract="reference")
# The semantics of the reference's dead CPU renderer.
REFERENCE_CPU = TraceOptions(scatter_sample="ball", sky="cpu",
                             refract="reference")
# Corrected physics (framework default).
DEFAULT = TraceOptions()


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """A full render job (the analogue of app::data + cuda::data constants).

    width/height: main.cxx:25-31; spp: main.cxx:23 (16, CPU) and
    cuda_impl.cu:59 (48, CUDA); max_depth: raytracer.hxx:20 (64, CPU) and
    cuda_impl.cu:60 (32, CUDA).
    """

    width: int = 1920
    height: int = 1080
    spp: int = 48
    max_depth: int = 32
    camera_mode: str = "thinlens"  # see models/camera.py
    options: TraceOptions = DEFAULT
    # Upper bound on rays traced per wave of the tiled engine
    # (render.render chunks the image by it).
    rays_per_chunk: int = 1 << 20
