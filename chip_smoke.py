#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # every phase, with the verdict
    python3 chip_smoke.py --phases kernels  # build + the kernel checks only
    python3 chip_smoke.py --phases kernels,coherent_path

Needs one CUDA card, ``nvcc`` and this repository's checkout; imports only
``torch``, ``numpy`` and the port (``raytracinginoneweekend_tpu_torch``),
nothing of JAX. It exits non-zero -- and prints no ``"ok": true`` -- when
there is no CUDA device, when the port is not beside it, when a kernel does
not build, launch or agree with its plain PyTorch version, when the main
path did not go through a kernel, or when any phase's check fails.

Phases (one JSON object per line on standard output):
  closest_hit_build  for each K of the five split loops -- closest_hit,
                   closest_hit_sorted, mega_bounce, closest_hit_mxu and
                   closest_hit_list -- read from the built libraries
                   (cuobjdump -res-usage -sass):
                   registers, stack and local memory, the routines it
                   calls, among them any sqrt slow path, and whether every
                   sqrt of the sphere loop sits behind the disc >= 0 branch
                   (required). ptxas's own report (-Xptxas -v) goes to
                   standard error.
  intersect_build  the same facts for each K of the two t-space split
                   loops, intersect and closest_hit_grouped (K up to 16),
                   and whether every sqrt of the sphere loop sits behind
                   the disc > 0 branch (FSETP.GT; required).
  shade_regen_build  for each instantiation of kernel 2 (entry, lanes a
                   thread, camera-ray form), read from the built library:
                   registers, stack and spill bytes, local loads and stores.
  device           card, versions, the kernels' build time.
  kernels          each hand-written kernel against its plain PyTorch
                   version on the card: real mid-frame lane states of the
                   huge scene at the main path's pool shape, synthetic edge
                   cases for closest_hit (``ties_and_grazes`` on a table of
                   its own at every K: identical spheres in different
                   partitions of the split loop, an exact graze, a ray that
                   misses everything), closest_hit at every K (1 ... 32)
                   bit-equal with its plain version and timed (the K sweep)
                   at the two pools and the train shape, and shade_regen
                   stepped beside
                   its plain version for a few dozen iterations in five
                   configurations; kernel 2's three entries (shade_regen,
                   shade_only, regen_only) each against its plain version
                   at 32768 and 2^20 lanes and on the stratified + rr
                   arm's state, every launch shape and camera-ray form
                   with and without PDL bit-equal with the picked one,
                   shade_only then regen_only bit-equal with shade_regen,
                   with their times, the fused entry's launch-shape sweep
                   and the PDL A/B on the closest_hit -> shade_regen pair; closest_hit again as the training path
                   launches it (every lane of the planar AD engine's own
                   (1024, 128) ray planes, no active plane, at bounce 0
                   and after three bounces); intersect (the (N, 3) closest
                   hit) on
                   synthetic edge cases (``tspace_ties_and_grazes``: exact
                   tangents, planted ties across the split's partitions,
                   roots on t_min, a hollow shell) and on the huge scene's
                   real rays at bounce 0 and after three bounces, at the
                   training path's two shapes (960000 and 131072 rays),
                   at every K (1 ... 32) bit-equal with its plain version
                   (every synthetic case too) and timed on the mid-path
                   rays (its K sweep). The three
                   closest-hit siblings for coherent rays, each against its
                   plain version AND against closest_hit on the same rays:
                   closest_hit_list on the dual engine's primary pool in
                   mid-frame with its real candidate lists (2^20 and 16384
                   primary lanes) and on synthetic lists (full lists, a
                   40-sphere sublist against the sub-scene, empty lists,
                   inactive blocks; ``ties_and_grazes`` with lists whose
                   order runs against the ids), at every K (1 ... 32)
                   bit-equal with its plain version and timed on the real
                   lists (its K sweep); closest_hit_sorted on the single
                   pool's mid-frame state under strided and under tile
                   ownership with a sort state half an epoch old, ladders
                   (4,) and (1, 8), with the kernel's own count of the
                   chunks it skipped beside what a lane-by-lane exit could
                   skip (from the inputs), at every K (1 ... 32) bit-equal
                   with its plain version and timed (its K sweep, with the
                   share skipped at each K), and on synthetic rays (no ladder,
                   rays outside the slab heading away, dy = 0, inactive
                   lanes); closest_hit_mxu on the same states, at every
                   K bit-equal with its plain version and timed (its K
                   sweep), on closest_hit's synthetic cases and on
                   ``ties_and_grazes`` with its own table at every K.
                   shade_regen also under
                   tile ownership. Times:
                   ``ms`` is the kernel's device time (launches queued
                   behind other work, so the host's launch overhead is
                   out), ``call_ms`` what one call of the wrapper costs the
                   engine's loop (device or host, whichever is longer),
                   ``plain_ms`` the plain version, ``bound_ms`` the least
                   the card could take for what this run's inputs ask: the
                   bytes that must move (an inactive lane moves its flag
                   and its result, not its ray) or the operations (for the
                   list kernel the candidates of the issuing lanes, for the
                   sorted kernel the chunks no lane-by-lane exit could
                   skip).
  grad_vs_plain    the two closest-hit autograd.Functions -- forward through
                   the kernel, backward through the Function -- against
                   plain autograd through the plain forward, on the same
                   rays and cotangents; the per-sphere sum of the backward
                   timed as index_add_ and as a one-hot matrix product; a
                   render_loss gradient (240x160, depth 8), planar engine
                   against tiled and both against a float64 witness (the
                   tiled engine traced in float64), per leaf.
  frame_vs_plain   the whole engine, kernels against plain versions, at
                   240x160, 8 spp, depth 12 on the huge scene; the
                   tiled engine with the intersect kernel against the
                   plain closest hit in each of the four camera modes; and
                   the coherent engines at the same frame: tile ownership,
                   the sorted kernel (both ownerships) and the unfused
                   step (see ``coherent_frames`` for what is bit-equal
                   with what on the card; also on the wall scene), the mxu
                   kernel and the dual-pool engine (its kernels against
                   its plain versions, and against the single pool).
  frame_vs_golden  the kernel path against the committed frames that the
                   JAX package rendered (testdata/golden_*.npz), and the
                   main path's frame (render_wavefront, default options,
                   thin lens) on the card against the port's scalar NumPy
                   oracle (oracle/scalar.py) run on the host in this
                   process: the simple scene at 24x16, 4 spp, depth 8 and
                   the huge scene at 32x24, 2 spp, depth 6, under the frame
                   rule (golden.compare_frames).
  main_path        the full-width render -- huge scene, 1200x800, 100 spp,
                   depth 50, thin lens, default options -- through the CLI
                   (writes a PNG into the kernels' build directory) with the
                   launch counts read around it, then timed at two pool
                   sizes with the epoch replayed as a CUDA graph (the
                   engine's default) and eagerly, in turns: frames
                   bit-equal, launches equal to the iterations with the
                   replays counted, the host's microseconds an iteration
                   (an epoch enqueued eagerly and a replay, behind a long
                   matrix product) and the graph's programmatic (PDL)
                   edges; and timed for the two estimator arms.
  coherent_path    the coherent engines at full width (the same frame as
                   main_path), each once through the CLI with the launch
                   counts read around it, then timed in the process and
                   held against the default frame: ``--engine
                   wavefront-dual`` at a pool of 3 * 2^20 lanes (2^20
                   primary) and, cut to 2 spp, at its default pool;
                   ``--hit-kernel sorted --ownership tile``; ``--hit-kernel
                   sorted`` (both also timed eagerly, ``graph=False``, and
                   the frames whose epochs, sort state included, are
                   replayed as CUDA graphs held bit-equal to the eager
                   ones); ``--hit-kernel mxu``; ``--fusion off`` (at
                   2^20 lanes); the sorted and mxu kernels again at 2^20
                   lanes; the single pool shaded in plain PyTorch (the
                   unfused step with kernel 2's plain halves), which the
                   dual engine's frame is held against.
  grouped_path     the sphere-group kernel (closest_hit_grouped) on the
                   rays it was designed for: the camera rays of the full
                   frame's first pool (2^20 lanes, tile ownership), a
                   mid-frame state of that frame and the camera rays of
                   the default pool (32768 lanes), each through
                   trace_segment(group_params=...) with the launch counts
                   read around the three calls; against its plain version,
                   against closest_hit on the unsorted scene, its own count
                   of the group-tests it skipped beside what a lane-by-lane
                   cull could skip, times beside closest_hit's, and at
                   every K (1 ... 16) bit-equal with its plain version and
                   timed (its K sweep, with the share skipped at each K).
  mega_path        the whole-bounce kernel (mega_bounce) against its plain
                   version on the main frame's mid-frame state (32768 and
                   2^20 lanes), at every K of its split loop bit-equal
                   (every output plane) and timed (its K sweep);
                   mega="bounce" frames at 240x160 bit-equal
                   to the default frame and the unfused step's, and against
                   the plain frames; the full-width frame through ``render
                   --fusion bounce --pool-size 1048576`` with the launch
                   counts read around it, then in the process beside the
                   default frame, bit-equal, at pools of 2^20 and 2^15
                   lanes.
  scatter_path     the frame past the ledger cap -- huge scene, 1920x1080
                   @ 512 spp, depth 50, 66.4 M tasks -- twice through
                   ``render --engine auto`` (the float frame, the engine
                   and the frame's seconds read where the CLI gets them,
                   the launch counts around each run): ``auto`` must pick
                   deposit="scatter", both renders must hash the same (the
                   order-fixed flush), finite; epochs, graph or eager. Then
                   the main path's 1200x800 @ 100 frame with the scatter
                   deposit forced, against its ledger frame (which ``auto``
                   keeps), each timed twice in turns.
  train_path       the training path at full width -- huge scene, 1200x800
                   camera, thin lens, default options with
                   intersect="pallas": the target by render.render (tiled
                   engine, the intersect kernel) at 8 spp, depth 16, with
                   the intersect kernel's device time summed over its
                   launches (CUDA events around each), then
                   optim.fit on albedo and centers, 16384 pixels x 8 spp
                   a step, depth 16, engine "auto" (-> planar: the
                   closest_hit kernel under autograd), one warm-up step
                   and ten timed ones, with the launch counts read around
                   it; then one step split into forward, backward and
                   update, and one step of engine "tiled" on the same
                   batch. Then the same batch shape at depth 50, where
                   "auto" resolves to the regenerative AD pool
                   (ops/wavefront_ad.py): a fit of ten timed steps (the
                   eager regen once a step, never inside an epoch), a step
                   of the pool and of the planar engine taken apart, the
                   batch's iteration budget and a flat-budget step, and the
                   pool's pixels and gradients against the planar engine's.
                   The depth-16 fit's pixel batches are drawn on the card
                   (jax.random's choice: two stable sorts of 960000 u32
                   keys a step); its first two, recorded in an untimed
                   two-step run of the same fit, must equal, bit for bit,
                   the ones the JAX package drew on the CPU
                   (testdata/golden_fit_simple_cuda.npz); the draw alone
                   is timed beside a host torch.randperm of the same size
                   and its copy to the card.
  surrogate_path   the gradient surrogates (ops/silhouette.py,
                   ops/branchprob.py) on the card: each term's value and
                   gradient (centers, radii, ior) at the CPU tests' small
                   scenes against the same call on the CPU; the JAX
                   package's three finite-difference checks (boundary,
                   secondary, RR flip) through the port at their
                   configurations and tolerances; the JAX package's
                   flagship full-surrogate train step (huge scene, 1200x800
                   camera, 16384 px x 8 spp, depth 50 -> the AD pool,
                   boundary 512, secondary 4 at vertex depths 0 and 1,
                   rr_grad): one warm-up and three timed steps with the
                   launch counts, kernel 3's device time (CUDA events
                   around each launch) and the peak device memory, one
                   step taken apart into the interior and each term, and
                   one step under torch.profiler for the host's share.
  cli_fit          the JAX CLI's fit trajectory on the card: the port's CLI
                   ``fit`` with the flags of testdata/golden_fit_simple_cuda
                   .npz (simple-cuda, 48x32, 2 spp, depth 4, albedo and
                   centers, 8 steps of 512 pixels) held to what the JAX
                   CLI recorded on the CPU (golden.cli_fit_against_golden):
                   the perturbation and every step's pixel ids bit-equal,
                   the losses within golden.fit_tolerance, Adam replayed
                   over the run's own gradients equal to its parameters;
                   the final parameters of the same fit on this machine's
                   CPU, the control, within golden.fit_tolerance; the
                   card's reported against that compounded bound, and
                   each of its steps, taken alone
                   from JAX's state (the golden's parameters, and Adam's
                   moments rebuilt from JAX's recorded gradients), must
                   reach JAX's next parameters within the one-step bound
                   on every element (golden.fit_steps_from_jax); each
                   step's gradient against JAX's is reported
                   (golden.fit_gradient_gap). Then ``fit`` through the CLI
                   on the small scene (200x112,
                   20 steps, a checkpoint written, reloaded and resumed),
                   then once more with --rr-terminate at the CLI's depth
                   32, where --ad-engine auto is the regenerative AD pool,
                   and once (3 steps) with --boundary-samples 8 --rr-grad.
  adaptive_path    ``render --adaptive`` (adaptive.py, the planar engine:
                   kernel 1 on every lane of every bounce) at the main
                   path's full width (huge, 1200x800, spp_base 100, depth
                   50, thin lens), once through the CLI and once in this
                   process: stats (rays_stage1 96,000,000, rays_stage2
                   48,000,000, avg_spp 150), seconds, peak device memory,
                   kernel 1's launches (50 x 4, nothing else) and device
                   time (CUDA events around each launch), a finite image
                   and the CLI's PPM equal to the in-process frame's; at
                   240x160, spp_base 8, depth 12 the frame with kernel 1
                   against the frame with its plain version (the frame
                   rule) and the overlap of their tier sets; the
                   equal-budget grid of scripts/bench_adaptive.py (64x36,
                   two configs, 6 keys, a 512-spp truth) with each MSE
                   ratio held to docs/ADAPTIVE_r04.json's within 1%
                   relative.
  serve_path       the render server (serve.py) as a subprocess on the
                   card, logging to a file: socket mode 0600, ping (proto
                   1, device cuda), the main frame three times (request
                   seconds, reserved memory after each, which may not grow
                   by more than 5%; the PPM equal to the in-process
                   frame's, the launches counted by the server), the same
                   frame with adaptive on (its PPM equal to the in-process
                   adaptive frame's), a bench of 2 iterations, a 3-step fit
                   (simple-cuda, 200x112, depth 8, 1024 px x 2 spp), a bad
                   request (an error, the server still answering), render
                   --via from another process, shutdown (exit 0 within
                   30 s, the socket gone); beside it a fresh render
                   process of the main frame (what the server saves),
                   render --profile of the 240x160 frame (a trace that
                   names closest_hit_kernel and shade_regen_kernel) and
                   whether the native image codec built.
  sharded_path     the mesh of workers (parallel/mesh.py) at the main
                   path's full width, pool 1<<15 a worker: (a) the
                   one-card mesh bit-equal with render_wavefront's frame,
                   and render --engine wavefront-sharded through the CLI
                   writing that image; (b) four workers on the one card
                   within rtol 2e-4 / atol 2e-5 of it (the largest
                   difference printed, two runs hashing the same), tile
                   ownership + the sorted kernel over four workers
                   bit-equal with one worker's frame, and the tiled engine
                   (kernel 3) over four workers, render_image_sharded at
                   the training target's frame (1200x800 @ 8 spp, depth
                   16), bit-equal with render(); (c) two processes sharing the card (gloo), rank
                   0's frame bit-equal with the in-process 2-worker frame,
                   each rank's wall time; (d) the tail reserve
                   (reserve_frac 0.15) at one and four workers within 2e-6
                   of the reserve-off frames, s/frame and occupancy with
                   and without; (e) one train step (16384 px x 8 spp,
                   depth 16, planar) over two workers, its gradients
                   within rtol 2e-5 / atol 1e-7 of one device's; (f) the
                   dual engine over two workers against one (spp cut to
                   4, the width not), the frame rule; (g) kernel 2's fused
                   and regen-only entries on a mid-frame state of worker 1
                   of 4 (strided: first task P, stride 4P; tile:
                   worker_base > 0) against their plain versions. None of
                   this is a speed-up: the card box has one card.
Then the ``kernels`` line (``launches`` from the main path's run for
closest_hit, shade_regen and regen_only (once: the prologue), from the
coherent path's full-width frames for closest_hit_list,
closest_hit_sorted, closest_hit_mxu and shade_only, from the
training path's for intersect, from the grouped path's three calls for
closest_hit_grouped and from the full-width --fusion bounce frame for
mega_bounce, ``launches_train_path`` beside it, ``launches_scatter_path``
for closest_hit, shade_regen and regen_only, ``launches_surrogate_path``
for intersect and closest_hit, ``launches_adaptive_path`` for closest_hit
and ``launches_serve_path`` (one served main frame, counted by the server)
for closest_hit, shade_regen and regen_only, ``launches_sharded_path``
(the sharded path's frames, through the API and the CLI, and train step)
for closest_hit, shade_regen, regen_only, intersect, closest_hit_list and
closest_hit_sorted, every other number
measured
in this run), the card's name and power limit as
``nvidia-smi`` gives them, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Tolerances, and why:
  closest_hit   hit/sphere index equal on active lanes but for at most
                1e-4 of them, t within rtol 1e-6: kernel and plain version
                do the same IEEE float32 operations in the same order (the
                kernel is built with -fmad=false), so they agree to the
                bit; the allowance is for a compiler that orders one sum
                differently. In the K sweep and on ties_and_grazes: bit-
                equal on every lane (hit, sphere index, the bits of t), as
                the split loop's lexicographic reduce over (q, index)
                returns the one-thread loop's result for any K. The same
                for closest_hit_sorted's K sweep (its reduce is over (q,
                position in the sorted order); a skipped stage changes no
                result) and, every output plane, mega_bounce's.
  closest_hit_list, closest_hit_sorted, closest_hit_mxu
                against their plain versions: closest_hit's tolerance, for
                the same reason. Against closest_hit on the same rays: the
                list kernel bit-equal on every active lane (same
                arithmetic, ascending ids, and a cull that never drops a
                winner); the sorted kernel bit-equal except where two
                distinct spheres tie at exactly the same q (it keeps the
                earlier in sorted order; such lanes have bit-equal t and
                are counted); the mxu kernel the same winner on all but
                1e-3 of active lanes and, where the winner is the same, t
                within rtol 5e-3 / atol 2e-4 (the JAX package's own
                tolerance between its two kernels) on all but 1e-3 of
                active lanes: d.C - d.o rounds differently from d.(o - C),
                and on the r = 1000 ground sphere the regrouped c cancels
                terms of 1e6, so the small t of a restart on the ground
                moves by percents. Median, 99th percentile and largest
                relative difference are printed.
  shade_regen   stepped along a trajectory: integer planes (and the key
                words with them) equal on all but at most 1e-3 of lanes,
                float planes rtol 1e-5 / atol 1e-6 on the lanes whose
                integer planes agree, but for at most 1e-4 of lanes:
                sinf/cosf/powf of the kernel's and of PyTorch's builds may
                differ by an ulp, which flips a `u < probability` or
                `dot > 0` decision on a few lanes in a million; a flip that
                keeps the integers (reflect against refract) shows as a
                float outlier. Its three entries on one state each: the
                integer planes and key words bit-equal on every lane
                (within one step no float decision reads a sinf/cosf of
                the step's own), the floats as above; every launch shape
                and camera-ray form bit-equal with the picked one, and the
                two halves in turn with the fused entry.
  intersect     hit and sphere index equal on every ray, t within rtol
                1e-6: kernel and plain version do the same IEEE float32
                operations in the same order (ties keep the earliest
                sphere in both). In the K sweep and on every synthetic
                case: bit-equal on every ray (hit, index, the bits of t) at
                every K, by the reduce over (t, index).
  closest_hit_grouped
                bit-equal with its plain version (the t-space loop over the
                sorted table without the cull, which is conservative), at
                every K (its reduce is over (t, sorted index)).
                Against closest_hit on the unsorted scene the JAX package's
                own terms (tests/test_pallas_intersect.py): the same hit on
                every camera ray and on all but 1e-4 of the mid-frame lanes
                (the t-space window t > t_min and the q-space one of kernel
                1 round apart at a restart's t_min knife edge), on the lanes
                that hit the same sphere t within rtol 2e-4 / atol 1e-3 and
                the same material.
  mega_bounce   keep and depth equal on every lane; the float planes rtol
                1e-5 / atol 1e-6 but for at most 1e-4 of lanes:
                shade_regen's class (sinf/cosf of the kernel's and of
                PyTorch's builds may differ by an ulp). Its frames: against
                the default and the unfused frames the frame rule; the
                plain whole-bounce frame bit-equal to the plain unfused one
                (the same arithmetic).
  AD pool       pixels against the planar engine (the same draws) rtol
                1e-4 / atol 2e-5, the JAX package's own tolerance between
                the two engines; gradients by the render_loss rule below
                with the pool in the planar engine's place and the planar
                engine in the tiled one's.
  gradients     closest-hit Functions against plain autograd: per input,
                max |difference| <= 2e-3 of the largest |gradient|, with
                the cotangent zeroed on grazing rays (|cos| of the angle
                between ray and normal under 0.05: there the implicit
                formula's (p-c).d and autograd's sqrt(disc) cancel
                differently, and the JAX package's own check of its custom
                VJP stays away from them too).
  render_loss   planar against tiled, per leaf, on the pixels whose
                radiance agrees (all but at most 1%, the frame rule, and
                at most 1% more that hold a forked path, below; at most
                10% in all with the float64 witness, whose t_min window
                on the r = 1000 ground falls on other restarts). Every
                element's error is taken over the size of its own row
                (one sphere's or one material's gradient), so the small
                spheres weigh as much as the ground. An element-wise rtol
                1e-3 cannot be met here by ANY float32 engine: at depth 8
                on 489 spheres the paths are chaotic, and the plain tiled
                engine itself sits 1e-3 of a row's size (median; a few
                percent at the 90th percentile) from its own float64
                trace in centers, radii, fuzz and ior. So the bar is the
                witness: at the median and at the 90th percentile the
                difference between the two engines must be at most a
                quarter of the tiled engine's own float32 error (measured:
                a fortieth or less), and the planar engine must sit no
                more than twice as far from the witness as the tiled one
                (measured: 0.9 to 1.3 times). A wrong or missing term on
                any tenth of a leaf's elements moves the 90th percentile.
                Albedo scales a fixed path's radiance and is well
                conditioned: every element within rtol 1e-3 plus 1e-2 of
                its row's size, and 1e-4 of the largest |gradient|. The
                99th percentile and the largest difference are printed.
                Sums by atomic adds change in the last bits besides.
                Pixels that hold a path which the two engines trace
                differently are set aside, also those whose radiance stays
                inside the tolerance (found with every albedo set to 1,
                ``engine_gradients_raw``): such a path can be most of the
                row of a sphere that few paths see (without the probe, 1 to
                5 elements of ~1400 beyond the tolerance in 17 of 60
                seeded scenes; with it none, the largest at 0.23 of the
                tolerance; scripts/torch_grad_fork.py). Both checks run on
                seeded inputs (the scene as built; the training path's
                seeded perturbation), so every run compares the same paths.
  scatter       the scatter deposit's frame bit-equal between two renders
                (its flush sums a pixel's values in an order fixed by the
                inputs); against the ledger frame rtol 2e-4 / atol 2e-5,
                the JAX package's own bound between its two deposits (a
                pixel's tasks summed in flush order, not task order).
  surrogates    on the card against the CPU, every gradient element
                within 1e-3 of its leaf's largest |gradient| and the
                value within rtol 1e-3 (CUDA's and the CPU's sin, cos,
                sqrt, log differ by an ulp; the port against JAX on the
                CPU is held to 1e-4); the FD checks at the JAX tests' own
                tolerances (rtol 0.05-0.15, atol 9e-4 on near-zero
                components).
  adaptive      the frame with kernel 1 against the frame with its plain
                version: the frame rule (kernel 1 is bit-equal with its
                plain version, so the rankings agree); served and CLI PPMs
                equal to the in-process frame's to the byte (the same
                computation); the equal-budget MSE ratios within 1%
                relative of the CPU record (an estimator property: the
                RNG contract is the JAX package's).
  frames        the renderer's own rule (golden.compare_frames): at most
                1% knife-edge pixels, the rest atol 3e-5 / rtol 1e-4
                (atol 5e-4 against the JAX-made huge crop, whose XLA:CPU
                arithmetic contracts multiply-adds). Every camera ray and
                bounce draw comes from kernel 2's one arithmetic, so the
                sorted kernel's frame (either ownership), the unfused
                step's, the whole-bounce step's and a tile-ownership
                frame are bit-equal to the default frame (the sorted
                kernel but for exact ties; the unfused mxu step's to the
                fused mxu frame), at 240x160 and, for the sorted kernel
                and the unfused step, at full width; graph frames to
                eager ones (``coherent_frames``). An mxu frame against
                the default frame: at most 3% of pixels more than 1e-3
                away (relative, floor 1e-3), at
                240x160, depth 12 and at the JAX package's own test shape
                (``MXU_FRAME_SHARE``, with the readings: 2.30% and 1.04%,
                where the JAX package allows itself 1%).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import subprocess
import sys
import time

PHASES = ("kernels", "grad_vs_plain", "frame_vs_plain", "frame_vs_golden",
          "main_path", "coherent_path", "grouped_path", "mega_path",
          "scatter_path", "train_path", "surrogate_path", "cli_fit",
          "adaptive_path", "serve_path", "sharded_path")

# Published peaks of one H100 SXM (NVIDIA's data sheet): float32 outside the
# tensor cores and HBM bandwidth. The bounds below are stated against them.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# closest_hit: float operations per lane and sphere (3 sub, 6 mul + 4 add
# for b and |oc|^2, 1 sub for c, 3 for the discriminant, sqrt, negate, 2
# roots, 2 window compares + 2 selects, 1 compare + 2 selects for the min).
CH_FLOPS_PER_SPHERE = 27
# closest_hit's guarded loop: a pair whose discriminant is < 0 stops after
# it and the guard (3 sub, 5 for b, 6 for c, 3 for the discriminant, 1
# compare); only a pair with disc >= 0 goes on to the sqrt, the roots and
# the min. The bound from that count (closest_hit_needed) stands beside
# the one that charges every pair CH_FLOPS_PER_SPHERE.
CH_MISS_FLOPS = 18
CH_NEEDED = ("bound_needed_ms", "issue_ceiling_ms", "pairs",
             "pairs_disc_ge_0")
# The t-space kernels' guarded loop (intersect, closest_hit_grouped): the
# same 18 operations up to the guard (disc > 0); past it the sqrt, negate,
# 2 roots, 2 products with 1/a, 2 window compares + 2 selects, 1 compare +
# 2 selects for the min.
IX_HIT_FLOPS = 31
IX_NEEDED = ("bound_needed_ms", "issue_ceiling_ms", "pairs",
             "pairs_disc_gt_0")
# shade_regen: float operations per lane (surface point and normal, shade,
# sky, state update, camera ray): a generous count; the integer hashing is
# not in the float peak's table and the bound is the bytes anyway.
SR_FLOPS_PER_LANE = 400
# ... and of its two halves alone (the same generous count: the shade with
# its draws, the regen with the camera ray)
SR_SHADE_FLOPS_PER_LANE = 250
SR_REGEN_FLOPS_PER_LANE = 150

# The AD pool's shade op (csrc/ad_shade.cu): float operations per lane, a
# generous count as for kernel 2 (the draws' integer hashing is not in the
# float peak's table, and the bound is the bytes anyway): the forward's
# shade with its draws (its regen is selection); the adjoint's recomputed
# forward and its reverse sweep.
AS_FLOPS_PER_LANE = 250
AS_GRAD_FLOPS_PER_LANE = 500
AS_ENTRIES = ("ad_shade", "ad_shade_grad")

# intersect: float operations per ray and sphere (3 sub, 5 for b, 6 for c,
# 3 for the discriminant, 1 compare + 1 select under the sqrt, sqrt, negate,
# 2 roots, 2 products with 1/a, 2 window compares + 2 ands + 2 selects,
# 1 compare + 2 selects for the min).
IX_FLOPS_PER_SPHERE = 32
# bytes per ray: origin and direction in (24), t, index and hit flag out (9)
IX_BYTES_PER_RAY = 33
# closest_hit_grouped: float operations per lane and group for the bound
# test (3 sub, 5 for b, 6 for c, 3 for the discriminant, 3 compares, 2
# logic); each tested sphere costs intersect's IX_FLOPS_PER_SPHERE.
GROUP_TEST_FLOPS = 20
# closest_hit_mxu: float operations per lane and sphere (10 for d.C and o.C,
# 1 for -b, 3 for c, 3 for the discriminant, sqrt, 2 roots, 2 window compares
# + 2 selects, 1 compare + 2 selects for the min).
MX_FLOPS_PER_SPHERE = 27
# The dual-pool engine's lane budgets: three times 2^20 (2^20 primary lanes
# and two secondary copies) for the full-width frame, and its own default.
DUAL_POOL = 3 << 20
DUAL_POOL_DEFAULT = 1 << 16
DUAL_SPP_AT_DEFAULT_POOL = 2  # that host-bound run is cut to 2 spp
SORTED_LADDER = (4,)  # TraceOptions.sorted_ladder's default

MAIN = dict(scene="huge", width=1200, height=800, spp=100, depth=50)
SMALL = dict(width=240, height=160, spp=8, depth=12)
# The training path: the target's frame and the step's batch (the JAX
# package's own AD measurement shape: 16384 pixels x 8 spp).
TRAIN = dict(width=1200, height=800, target_spp=8, depth=16,
             batch_pixels=16384, spp=8, warmup_steps=1, timed_steps=10,
             lr=1e-2, perturb=0.1)  # the CLI's default perturbation
GRAD = dict(width=240, height=160, spp=2, depth=8, rays=32768)
AD_DEPTH = 50  # the regenerative AD pool's flagship depth (train_path)
CLI_FIT = dict(width=200, height=112, steps=20)
# The frame past the ledger cap: 1920x1080 @ 512 spp, 66.4 M tasks, whose
# ledger would be ~805 MB at 32768 lanes (scatter_path).
SCATTER = dict(scene="huge", width=1920, height=1080, spp=512, depth=50)
# The surrogates on the card against the CPU (surrogate_path): the tests'
# small scenes at this size; every gradient element within this share of
# its leaf's largest |gradient| (CUDA's and the CPU's sin/cos/sqrt/log
# differ by an ulp; kernel 3 is bit-equal with its plain version).
SURROGATE_SMALL = dict(width=48, height=32)
SURROGATE_CARD_SHARE = 1e-3
# The full-surrogate train step of the JAX package's flagship
# (docs/FIT_r05.json, "full_surrogate"): huge scene, 1200x800 camera,
# 16384 pixels x 8 spp, depth 50 (-> the AD pool), every surrogate.
SURROGATE_STEP = dict(width=1200, height=800, spp=8, depth=50,
                      batch_pixels=16384, boundary_samples=512,
                      secondary_samples=4, secondary_vertex_depths=2,
                      rr_grad=True, warmup_steps=1, timed_steps=3,
                      which=("albedo", "centers", "radii", "ior"))


class Failed(Exception):
    """A phase's check failed."""


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


# --------------------------------------------------------------------- #
# kernels phase
# --------------------------------------------------------------------- #

def make_engine(rt, torch, scene_name, camera_name, mode, options, *, width,
                height, spp, depth, pool_size, seed=0):
    from raytracinginoneweekend_tpu_torch import cli
    from raytracinginoneweekend_tpu_torch.ops import wavefront

    dev = torch.device("cuda")
    scene = cli._build_scene(scene_name, seed, dev)
    cam = cli._build_camera(camera_name, width, height, dev)
    return wavefront.build_engine(
        scene, cam, rt.key_words(seed), width=width, height=height, spp=spp,
        max_depth=depth, camera_mode=mode, options=options,
        pool_size=pool_size, device=dev)


def mid_frame_state(eng, n_steps: int):
    """A lane state captured from the engine in mid-frame: every lane's
    task queue is advanced to the middle of its sequence (under strided
    ownership the first rounds are the top rows, all sky), then the engine
    runs n_steps iterations, which mixes depths, hits, misses and
    re-issues as the steady state does."""
    from raytracinginoneweekend_tpu_torch.ops import cuda_fused, wavefront

    state = list(wavefront.engine_initial_state(eng))
    state[0] += (eng.n_k // 2) * eng.stride
    state = cuda_fused.regen(tuple(state), eng.camvec, eng.base_words,
                             **eng.regen_kw)
    for _ in range(n_steps):
        state = wavefront.engine_step(eng, state)
    return tuple(p.clone() for p in state)


def compare_closest_hit(torch, rays, geom, t_min, active, table=None,
                        kernel=None, plain=None):
    """Kernel against plain version on one input -> dict of errors.
    ``kernel`` and ``plain`` are callables ``(rays, active) -> (hit, t,
    sb)``; absent, closest_hit and its plain version."""
    from raytracinginoneweekend_tpu_torch.ops import cuda_segment as seg

    if kernel is None:
        hk, tk, sk = seg.segment_closest_hit(rays, *geom, t_min,
                                             active=active, table=table)
    else:
        hk, tk, sk = kernel(rays, active)
    if plain is None:
        hr, tr, sr = seg.segment_closest_hit_reference(rays, *geom, t_min,
                                                       active)
    else:
        hr, tr, sr = plain(rays, active)
    torch.cuda.synchronize()
    act = (active > 0) if active is not None else torch.ones_like(hk) > 0
    n_act = int(act.sum())
    hit_bad = act & (hk != hr)
    both = act & (hk > 0) & (hr > 0)
    sb_bad = both & (sk != sr)
    agree = both & ~sb_bad
    dt = (tk - tr).abs()[agree]
    rel = (dt / tr[agree].abs()) if dt.numel() else dt
    idle = ~act
    idle_ok = bool(((hk[idle] == 0) & (tk[idle] == 1e30)
                    & (sk[idle] == 0)).all())
    n_bad = int((hit_bad | sb_bad).sum())
    return {"active": n_act, "hits": int((act & (hk > 0)).sum()),
            "int_mismatch": n_bad,
            "max_abs_err": float(dt.max()) if dt.numel() else 0.0,
            "max_rel_err": float(rel.max()) if rel.numel() else 0.0,
            "idle_ok": idle_ok,
            "ok": idle_ok and n_bad <= 1e-4 * max(n_act, 1)
            and (not rel.numel() or float(rel.max()) <= 1e-6),
            "out": (hk, tk, sk)}


def closest_hit_needed(rays, geom, active, t_bytes: float) -> dict:
    """closest_hit's bound from the work this input needs
    (``needed_bound``) over every active lane and every sphere."""
    from raytracinginoneweekend_tpu_torch.closest_hit_checks import (
        disc_pairs)

    n_ge, n_pairs = disc_pairs(rays, *geom, active)
    return needed_bound(n_pairs, n_ge, t_bytes)


def synthetic_ties_and_grazes(torch, dev, what: str = "closest_hit"):
    """ties_and_grazes through closest_hit (or closest_hit_mxu, with its
    own table) at every K and through its plain version: each bit-equal
    with the exact expectation."""
    from raytracinginoneweekend_tpu_torch import closest_hit_checks as chk
    from raytracinginoneweekend_tpu_torch.ops import cuda_segment as seg

    kernel, plain = {
        "closest_hit": (seg.segment_closest_hit,
                        seg.segment_closest_hit_reference),
        "closest_hit_mxu": (seg.segment_closest_hit_mxu,
                            seg.segment_closest_hit_mxu_reference)}[what]
    rays, geom, t_min, want = chk.ties_and_grazes(dev)
    out = {"plain": chk.bit_diff(plain(rays, *geom, t_min), want)}
    for k in seg.CH_SPLITS:
        got = kernel(rays, *geom, t_min, split=k)
        torch.cuda.synchronize()
        out[f"K{k}"] = chk.bit_diff(got, want)
    for name, res in out.items():
        require(not any(res.values()), f"{what} ({name}) misses the "
                f"exact result of ties_and_grazes: {res}")
    return out


def k_sweep(torch, what: str, run, want, n_lanes: int,
            threads_per_sm: int) -> dict:
    """A split-loop kernel at every K (``CH_SPLITS``) against its plain
    version's ``want`` on one input, to the bit on every lane (hit, sphere
    index, the bits of t), and each K's device time -> {"K<k>": {...},
    "picked": the K that closest_hit_split aimed at ``threads_per_sm``
    gives ``n_lanes``}. ``run(k)`` launches the kernel at K = k."""
    from raytracinginoneweekend_tpu_torch.closest_hit_checks import bit_diff
    from raytracinginoneweekend_tpu_torch.ops import cuda_segment as seg

    out = {}
    for k in seg.CH_SPLITS:
        diff = bit_diff(run(k), want)
        require(not any(diff.values()), f"{what} at K = {k} is not "
                f"bit-equal with its plain version: {diff}")
        out[f"K{k}"] = dict(diff, ms=device_ms(functools.partial(run, k)))
    out["picked"] = seg.closest_hit_split(
        n_lanes, torch.cuda.get_device_properties(
            torch.cuda.current_device()).multi_processor_count,
        threads_per_sm)
    return out


def closest_hit_sweep(torch, rays, geom, t_min, active, table=None):
    """closest_hit's ``k_sweep`` on one input."""
    from raytracinginoneweekend_tpu_torch.ops import cuda_segment as seg

    return k_sweep(
        torch, "closest_hit",
        lambda k: seg.segment_closest_hit(rays, *geom, t_min, active=active,
                                          table=table, split=k),
        seg.segment_closest_hit_reference(rays, *geom, t_min, active),
        rays[0].numel(), seg.CH_THREADS_PER_SM)


def synthetic_closest_hit(torch, geom, t_min, lanes: int, kernel=None,
                          plain=None, what="closest_hit"):
    """Edge cases for closest_hit (or another whole-table kernel, see
    ``compare_closest_hit``) on the huge scene -> {name: result}; for
    closest_hit itself also ``ties_and_grazes`` at every K."""
    dev = geom[0].device
    cmp = functools.partial(compare_closest_hit, torch, kernel=kernel,
                            plain=plain)
    gen = torch.Generator(device="cpu").manual_seed(7)
    shape = (lanes // 128, 128)

    def rnd(*s):
        return torch.rand(*s, generator=gen, dtype=torch.float32)

    def unit():
        v = torch.randn(3, *shape, generator=gen, dtype=torch.float32)
        return v / v.norm(dim=0, keepdim=True)

    def planes(o, d):
        return tuple(x.contiguous().to(dev) for x in (*o, *d))

    ones = torch.ones(shape, dtype=torch.int32, device=dev)
    out = {}
    # every lane inactive: the (0, 1e30, 0) convention and nothing else
    d = unit()
    o = torch.stack([rnd(*shape) * 8 - 4, rnd(*shape) * 2, rnd(*shape) * 8])
    res = cmp(planes(o, d), geom, t_min, ones * 0)
    require(res["active"] == 0 and res["idle_ok"], "all-inactive lanes")
    out["all_inactive"] = res
    # rays that miss everything: far above the scene, pointing up
    o = torch.stack([rnd(*shape) * 20 - 10, 2000 + rnd(*shape),
                     rnd(*shape) * 20 - 10])
    d = unit()
    d[1] = d[1].abs() + 0.1
    res = cmp(planes(o, d), geom, t_min, ones)
    require(res["hits"] == 0, "rays pointing away must miss everything")
    out["miss_everything"] = res
    # rays starting inside the hollow glass (sphere 4, radius -0.99, inside
    # sphere 3): the negative-radius shell must be the first hit. The rays
    # point upward, away from the small spheres that overlap the glass.
    c = torch.tensor([-2.0, 1.0, 0.0]).reshape(3, 1, 1)
    o = c + unit() * (rnd(*shape) * 0.5)
    d = unit()
    d[1] = d[1].abs()
    res = cmp(planes(o, d), geom, t_min, ones)
    require(bool((res["out"][2] == 4).all()) and res["hits"] == lanes,
            "rays inside the hollow glass must hit the inner shell")
    out["inside_hollow_glass"] = res
    # a lambert restart on the r = 1000 ground sphere: the origin sits on
    # the surface to float32 rounding, the exit root straddles t_min
    gc = torch.tensor([0.0, -1000.125, 0.0]).reshape(3, 1, 1)
    n = torch.stack([rnd(*shape) * 0.02 - 0.01, torch.ones(shape),
                     rnd(*shape) * 0.02 - 0.01])
    n = n / n.norm(dim=0, keepdim=True)
    o = gc + n * 1000.0
    res = cmp(planes(o, n + unit()), geom, t_min, ones)
    out["ground_restart"] = res
    for name, res in out.items():
        require(res["ok"], f"{what} disagrees on {name}: "
                f"{ {k: v for k, v in res.items() if k != 'out'} }")
    out = {name: {k: v for k, v in res.items() if k != "out"}
           for name, res in out.items()}
    if kernel is None:
        out["ties_and_grazes"] = synthetic_ties_and_grazes(torch, dev)
    return out


INT_PLANES = (0, 1, 2, 3, 13)
KEY_PLANES = (17, 18)


def compare_states(torch, got, want, n_slots: int):
    """shade_regen's output against the plain version's -> error dict."""
    n_base = 19
    ints = list(INT_PLANES) + [n_base + 4 * j for j in range(n_slots)]
    floats = [i for i in range(len(got))
              if i not in ints and i not in KEY_PLANES]
    int_agree = torch.ones_like(got[0], dtype=torch.bool)
    for i in ints:
        int_agree &= got[i] == want[i]
    key_agree = torch.ones_like(int_agree)
    for i in KEY_PLANES:
        key_agree &= got[i] == want[i]
    flt_ok = torch.ones_like(int_agree)
    max_abs = 0.0
    bit_unequal = {}
    for i in floats:
        close = torch.isclose(got[i], want[i], rtol=1e-5, atol=1e-6,
                              equal_nan=True)
        flt_ok &= close
        n_bits = int((int_agree & (got[i].view(torch.int32)
                                   != want[i].view(torch.int32))).sum())
        if n_bits:
            bit_unequal[i] = n_bits
        sel = int_agree & close & torch.isfinite(want[i])
        if bool(sel.any()):
            max_abs = max(max_abs,
                          float((got[i] - want[i]).abs()[sel].max()))
    return {"int_mismatch": int((~int_agree).sum()),
            "key_mismatch": int((int_agree & ~key_agree).sum()),
            "float_outliers": int((int_agree & ~flt_ok).sum()),
            "max_abs_err": max_abs, "bit_unequal_by_plane": bit_unequal}


def step_shade_regen(torch, eng, steps: int, start_steps: int):
    """Step the kernel beside its plain version from the same state,
    re-synchronised each step so that a knife-edge flip does not compound.
    """
    from raytracinginoneweekend_tpu_torch.ops import cuda_fused, cuda_segment

    lanes = eng.lanes
    state = mid_frame_state(eng, start_steps)
    geom = eng.sphere_params[:4]
    tot = {"int_mismatch": 0, "key_mismatch": 0, "float_outliers": 0,
           "max_abs_err": 0.0, "worst_int_mismatch": 0,
           "worst_float_outliers": 0, "bit_unequal_by_plane": {}}
    for k in range(steps):
        hit, t, sb = cuda_segment.segment_closest_hit(
            tuple(state[4:10]), *geom, eng.t_min, active=state[3],
            table=eng.htable)
        got = cuda_fused.shade_regen(state, (hit, t, sb), eng.table,
                                     eng.camvec, eng.base_words,
                                     **eng.step_kw)
        want = cuda_fused.shade_regen_reference(
            state, (hit, t),
            cuda_segment.resolve_params(sb, eng.sphere_params), eng.camvec,
            eng.base_words, **eng.step_kw)
        if k == 0:
            # the in-place form the engine uses gives the same planes
            inplace = tuple(p.clone() for p in state)
            cuda_fused.shade_regen(inplace, (hit, t, sb), eng.table,
                                   eng.camvec, eng.base_words, out=inplace,
                                   **eng.step_kw)
            same = all(bool(((a == b) | ((a != a) & (b != b))).all())
                       for a, b in zip(inplace, got))
            require(same, "shade_regen in place differs from out of place")
        torch.cuda.synchronize()
        res = compare_states(torch, got, want, eng.n_slots)
        for key in ("int_mismatch", "key_mismatch", "float_outliers"):
            tot[key] += res[key]
        tot["max_abs_err"] = max(tot["max_abs_err"], res["max_abs_err"])
        for plane, n in res["bit_unequal_by_plane"].items():
            tot["bit_unequal_by_plane"][plane] = (
                tot["bit_unequal_by_plane"].get(plane, 0) + n)
        tot["worst_int_mismatch"] = max(tot["worst_int_mismatch"],
                                        res["int_mismatch"])
        tot["worst_float_outliers"] = max(tot["worst_float_outliers"],
                                          res["float_outliers"])
        state = got
    tot["steps"] = steps
    tot["lanes"] = lanes
    tot["ok"] = (tot["worst_int_mismatch"] <= 1e-3 * lanes
                 and tot["key_mismatch"] == 0
                 and tot["worst_float_outliers"] <= max(1, 1e-4 * lanes))
    return tot


SR_ENTRIES = ("shade_regen", "shade_only", "regen_only")
SR_TIMES = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
            "share_of_bound")


def bit_equal_states(torch, a, b) -> bool:
    """Two lane states equal to the bit, plane by plane (NaNs included)."""
    return len(a) == len(b) and all(
        torch.equal(x.view(torch.int32), y.view(torch.int32))
        for x, y in zip(a, b))


def shade_regen_entries(torch, eng, state, seg, timed: bool = True):
    """Kernel 2's three entries on one mid-frame lane state: each against
    its plain version (integers and key words bit-equal, floats within
    the rule), every block size of each entry, with and without PDL,
    bit-equal with the picked launch, and shade-only then regen-only
    bit-equal with the fused entry. With ``timed``: each entry's ``ms``
    (device), ``call_ms``, ``plain_ms`` and bound; the fused entry's
    block-size sweep; and the PDL A/B on the closest-hit -> shade_regen
    pair that the engine launches."""
    from raytracinginoneweekend_tpu_torch.ops import cuda_fused as cf
    from raytracinginoneweekend_tpu_torch.ops import cuda_segment

    lanes, n_state = eng.lanes, len(state)
    n_sph = eng.table.shape[0]
    hit, t, sb = seg
    params = cuda_segment.resolve_params(sb, eng.sphere_params)
    surf = cuda_segment.surface_from_params(tuple(state[4:10]), params, hit,
                                            t)
    outbuf = tuple(torch.empty_like(p) for p in state)
    shaded = tuple(p.clone() for p in cf.shade_update_reference(
        state, surf, eng.base_words, **eng.shade_kw))
    regen_buf = tuple(torch.empty_like(p) for p in state)
    run = {
        "shade_regen": (
            lambda **kw: cf.shade_regen(state, seg, eng.table, eng.camvec,
                                        eng.base_words, **eng.step_kw,
                                        **kw),
            lambda: cf.shade_regen_reference(state, (hit, t), params,
                                             eng.camvec, eng.base_words,
                                             **eng.step_kw)),
        "shade_only": (
            lambda **kw: cf.shade_update(state, seg, eng.table,
                                         eng.base_words, **eng.shade_kw,
                                         **kw),
            lambda: cf.shade_update_reference(state, surf, eng.base_words,
                                              **eng.shade_kw)),
        # the regen of the shaded state: its idle lanes regenerate
        "regen_only": (
            lambda **kw: cf.regen(shaded, eng.camvec, eng.base_words,
                                  **eng.regen_kw, **kw),
            lambda: cf.regen_reference(shaded, eng.camvec, eng.base_words,
                                       **eng.regen_kw)),
    }
    got = {name: fn() for name, (fn, _) in run.items()}
    out = {"lanes": lanes, "active": int((state[3] > 0).sum()),
           "threads": cf.shade_regen_threads(
               lanes, cuda_segment._sm_count(torch.cuda.current_device()))}
    for name, (_, plain) in run.items():
        want = plain()
        torch.cuda.synchronize()
        res = compare_states(torch, got[name], want, eng.n_slots)
        res["ok"] = (res["int_mismatch"] == 0 and res["key_mismatch"] == 0
                     and res["float_outliers"] <= max(1, 1e-4 * lanes))
        out[name] = res
    fused = got["shade_regen"]
    # lanes that took a camera ray in this step (their key changed)
    out["issued_lanes"] = int(((fused[17] != state[17])
                               | (fused[18] != state[18])).sum())
    out["shade_then_regen_bit_equal_to_fused"] = bit_equal_states(
        torch, cf.regen(got["shade_only"], eng.camvec, eng.base_words,
                        **eng.regen_kw), fused)
    same = True
    for name in SR_ENTRIES:
        for threads in cf.SR_THREADS:
            for pdl in (False, True):
                same &= bit_equal_states(
                    torch, run[name][0](threads=threads, pdl=pdl), got[name])
    out["launch_shapes_bit_equal"] = bool(same)
    if not timed:
        return out

    # bytes that must move: the fused entry reads hit, t, sb and every
    # state plane and writes every state plane; shade-only reads 18 state
    # planes (task, sid, 3..18) and hit, t, sb and writes planes 3..16;
    # regen-only reads and writes every state plane; plus the tables read
    flops = {"shade_regen": SR_FLOPS_PER_LANE,
             "shade_only": SR_SHADE_FLOPS_PER_LANE,
             "regen_only": SR_REGEN_FLOPS_PER_LANE}
    nbytes = {"shade_regen": lanes * 4 * (3 + 2 * n_state) + n_sph * 40
              + 19 * 4,
              "shade_only": lanes * 4 * (3 + 18 + 14) + n_sph * 40,
              "regen_only": lanes * 4 * 2 * n_state + 19 * 4}
    timed_run = {
        "shade_regen": lambda: run["shade_regen"][0](out=outbuf),
        "shade_only": lambda: run["shade_only"][0](),
        "regen_only": lambda: run["regen_only"][0](out=regen_buf)}
    for name, fn in timed_run.items():
        res = out[name]
        res.update(times(fn, run[name][1]))
        res.update(bound(lanes * flops[name], nbytes[name]))
        res["share_of_bound"] = res["bound_ms"] / res["ms"]
    out["sweep_ms"] = {
        f"t{threads}": device_ms(
            lambda threads=threads: run["shade_regen"][0](out=outbuf,
                                                          threads=threads))
        for threads in cf.SR_THREADS}
    geom = eng.sphere_params[:4]

    def pair(pdl):
        h = cuda_segment.segment_closest_hit(
            tuple(state[4:10]), *geom, eng.t_min, active=state[3],
            table=eng.htable)
        cf.shade_regen(state, h, eng.table, eng.camvec, eng.base_words,
                       out=outbuf, pdl=pdl, **eng.step_kw)

    out["pdl"] = {"closest_hit_then_shade_regen_ms_pdl_on": device_ms(
                      lambda: pair(True)),
                  "closest_hit_then_shade_regen_ms_pdl_off": device_ms(
                      lambda: pair(False)),
                  "shade_regen_ms_pdl_on": device_ms(
                      lambda: run["shade_regen"][0](out=outbuf, pdl=True))}
    out["pdl"]["pair_saved_ms"] = (
        out["pdl"]["closest_hit_then_shade_regen_ms_pdl_off"]
        - out["pdl"]["closest_hit_then_shade_regen_ms_pdl_on"])
    return out


def kernels_phase(rt, torch, nvidia_smi: str):
    from raytracinginoneweekend_tpu_torch.ops import (cuda_fused,
                                                      cuda_segment)
    from raytracinginoneweekend_tpu_torch.utils.timing import cuda_time_ms

    rr = dataclasses.replace(rt.DEFAULT, rr_terminate=True)
    strat = dataclasses.replace(rt.DEFAULT, sampling="stratified")
    strat_rr = dataclasses.replace(strat, rr_terminate=True)
    shape = dict(width=MAIN["width"], height=MAIN["height"],
                 spp=MAIN["spp"], depth=MAIN["depth"])
    ch, sr = {}, {}
    for pool in (1 << 15, 1 << 20):
        eng = make_engine(rt, torch, "huge", "cpu", "thinlens", rt.DEFAULT,
                          pool_size=pool, **shape)
        state = mid_frame_state(eng, 40)
        rays, act = tuple(state[4:10]), state[3]
        geom = eng.sphere_params[:4]
        res = compare_closest_hit(torch, rays, geom, eng.t_min, act,
                                  table=eng.htable)
        seg = res.pop("out")
        require(res["ok"], f"closest_hit disagrees on a real lane state "
                f"(pool {pool}): {res}")
        n_sph = geom[0].shape[0]
        def run_ch():
            cuda_segment.segment_closest_hit(rays, *geom, eng.t_min,
                                             active=act, table=eng.htable)

        ms = cuda_time_ms(run_ch, iters=20, queue_behind=True)
        call_ms = cuda_time_ms(run_ch, iters=20)
        plain_ms = cuda_time_ms(
            lambda: cuda_segment.segment_closest_hit_reference(
                rays, *geom, eng.t_min, act), warmup=1, iters=3)
        flops = res["active"] * n_sph * CH_FLOPS_PER_SPHERE
        nbytes = lane_bytes(eng.lanes, res["active"]) + n_sph * 16
        t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
        ch[pool] = dict(res, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                        bound_ms=max(t_ops, t_bytes) * 1e3,
                        bound_by="operations" if t_ops >= t_bytes
                        else "bytes", lanes=eng.lanes, spheres=n_sph,
                        **closest_hit_needed(rays, geom, act, t_bytes),
                        k_sweep=closest_hit_sweep(torch, rays, geom,
                                                  eng.t_min, act,
                                                  table=eng.htable))

        sr[pool] = shade_regen_entries(torch, eng, state, seg)
        if pool == 1 << 15:
            ch["synthetic"] = synthetic_closest_hit(torch, geom, eng.t_min,
                                                    eng.lanes)

    # the three entries again on the stratified + rr arm's state
    eng = make_engine(rt, torch, "huge", "cpu", "thinlens", strat_rr,
                      pool_size=1 << 15, **shape)
    state = mid_frame_state(eng, 40)
    seg = cuda_segment.segment_closest_hit(
        tuple(state[4:10]), *eng.sphere_params[:4], eng.t_min,
        active=state[3], table=eng.htable)
    sr["stratified_rr"] = shade_regen_entries(torch, eng, state, seg,
                                              timed=False)
    for arm, res in sr.items():
        for entry in SR_ENTRIES:
            require(res[entry]["ok"], f"{entry} disagrees with its plain "
                    f"version ({arm}): {res[entry]}")
        require(res["shade_then_regen_bit_equal_to_fused"]
                and res["launch_shapes_bit_equal"],
                f"kernel 2's entries or launch shapes disagree ({arm}): "
                f"{ {k: v for k, v in res.items() if k not in SR_ENTRIES} }")

    # shade_regen beside its plain version, five configurations
    stepped = {}
    configs = {
        "thinlens_iid": ("huge", "cpu", "thinlens", rt.DEFAULT),
        "thinlens_iid_rr": ("huge", "cpu", "thinlens", rr),
        "thinlens_stratified": ("huge", "cpu", "thinlens", strat),
        "thinlens_stratified_rr": ("huge", "cpu", "thinlens", strat_rr),
        "cuda_reference_cuda": ("simple-cuda", "cuda", "cuda",
                                rt.REFERENCE_CUDA),
        "thinlens_iid_tile_ownership": (
            "huge", "cpu", "thinlens",
            dataclasses.replace(rt.DEFAULT, ownership="tile")),
    }
    worst = {"int_mismatch": 0, "float_outliers": 0, "max_abs_err": 0.0}
    for name, (scn, camn, mode, options) in configs.items():
        eng = make_engine(rt, torch, scn, camn, mode, options,
                          pool_size=1 << 15, **shape)
        res = step_shade_regen(torch, eng, steps=24, start_steps=8)
        stepped[name] = res
        require(res["ok"], f"shade_regen disagrees with its plain version "
                f"({name}): {res}")
        worst["int_mismatch"] = max(worst["int_mismatch"],
                                    res["worst_int_mismatch"])
        worst["float_outliers"] = max(worst["float_outliers"],
                                      res["worst_float_outliers"])
        worst["max_abs_err"] = max(worst["max_abs_err"], res["max_abs_err"])

    ch["train_shape"] = closest_hit_train_shape(rt, torch)
    ad = {"default": ad_shade_entries(rt, torch, rt.DEFAULT),
          "stratified_rr": ad_shade_entries(rt, torch, strat_rr,
                                            timed=False)}
    for arm, res in ad.items():
        for entry in AS_ENTRIES:
            require(res[entry]["ok"], f"{entry} disagrees with its plain "
                    f"version on a pool state ({arm}): {res[entry]}")
    main_pool = 1 << 15
    line = [
        {"name": "closest_hit", "route": "cuda",
         "source": "raytracinginoneweekend_tpu_torch/csrc/closest_hit.cu",
         "replaces": "raytracinginoneweekend_tpu/ops/pallas_segment.py:55",
         "launches": None,
         "max_abs_err": ch[main_pool]["max_abs_err"],
         "max_rel_err": ch[main_pool]["max_rel_err"],
         "int_mismatch_lanes": ch[main_pool]["int_mismatch"],
         "ms": ch[main_pool]["ms"], "call_ms": ch[main_pool]["call_ms"],
         "plain_ms": ch[main_pool]["plain_ms"],
         "bound_ms": ch[main_pool]["bound_ms"],
         "bound_by": ch[main_pool]["bound_by"], "library_ms": None,
         **{k: ch[main_pool][k] for k in CH_NEEDED},
         "lanes": ch[main_pool]["lanes"],
         "active_lanes": ch[main_pool]["active"],
         "split": ch[main_pool]["k_sweep"]["picked"],
         "k_sweep_ms": {k: v["ms"] for k, v in
                        ch[main_pool]["k_sweep"].items() if k != "picked"},
         "at_pool_1m": {k: ch[1 << 20][k] for k in (
             "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "lanes",
             "active", *CH_NEEDED,
             "max_abs_err", "int_mismatch", "k_sweep")},
         "at_train_shape": {k: ch["train_shape"]["after_3_bounces"][k]
                            for k in ("ms", "call_ms", "plain_ms",
                                      "bound_ms", "bound_by", *CH_NEEDED,
                                      "lanes", "shape", "max_abs_err",
                                      "max_rel_err", "int_mismatch",
                                      "k_sweep")}},
    ]
    for entry in SR_ENTRIES:
        at_main, big = sr[main_pool][entry], sr[1 << 20][entry]
        arms = [sr[a][entry] for a in sr]
        k = {"name": entry, "route": "cuda",
             "source": "raytracinginoneweekend_tpu_torch/csrc/shade_regen.cu",
             "replaces": "raytracinginoneweekend_tpu/ops/pallas_fused.py:87",
             "launches": None,
             "max_abs_err": max(r["max_abs_err"] for r in arms),
             "int_mismatch_lanes": sum(r["int_mismatch"] for r in arms),
             "float_outlier_lanes": sum(r["float_outliers"] for r in arms),
             **{key: at_main[key] for key in SR_TIMES},
             "library_ms": None, "lanes": sr[main_pool]["lanes"],
             "at_pool_1m": {key: big[key] for key in SR_TIMES}}
        if entry == "shade_regen":
            k.update(
                stepped_int_mismatch_lanes=worst["int_mismatch"],
                stepped_float_outlier_lanes=worst["float_outliers"],
                stepped_max_abs_err=worst["max_abs_err"],
                threads=sr[main_pool]["threads"],
                launch_sweep_ms=sr[main_pool]["sweep_ms"],
                pdl=sr[main_pool]["pdl"],
                at_pool_1m=dict(k["at_pool_1m"],
                                threads=sr[1 << 20]["threads"],
                                launch_sweep_ms=sr[1 << 20]["sweep_ms"],
                                pdl=sr[1 << 20]["pdl"]))
        line.append(k)
    for entry in AS_ENTRIES:
        arms = [ad[a][entry] for a in ad]
        line.append(
            {"name": entry, "route": "cuda",
             "source": "raytracinginoneweekend_tpu_torch/csrc/ad_shade.cu",
             # no TPU kernel: the JAX package leaves this step to XLA
             "replaces": None, "launches": None,
             "max_abs_err": max(r["max_abs_err"] for r in arms),
             "max_err_share_of_scale": max(r["max_err_share_of_scale"]
                                           for r in arms),
             "int_mismatch_lanes": sum(r["int_mismatch"] for r in arms),
             "outliers": sum(r["outliers"] for r in arms),
             **{key: ad["default"][entry][key] for key in SR_TIMES},
             "library_ms": None, "lanes": ad["default"]["lanes"]})
    ix = intersect_checks(rt, torch)
    big, small = ix["rays_960000"], ix["rays_131072"]
    line.append(
        {"name": "intersect", "route": "cuda",
         "source": "raytracinginoneweekend_tpu_torch/csrc/intersect.cu",
         "replaces": "raytracinginoneweekend_tpu/ops/pallas_intersect.py:40",
         "launches": None,
         "max_abs_err": max(r["max_abs_err"] for r in ix.values()),
         "max_rel_err": max(r["max_rel_err"] for r in ix.values()),
         "int_mismatch_lanes": sum(r["int_mismatch"] for r in ix.values()),
         "ms": big["ms"], "call_ms": big["call_ms"],
         "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
         "bound_by": big["bound_by"], "library_ms": None,
         **{k: big[k] for k in IX_NEEDED},
         "rays": big["rays"], "spheres": big["spheres"],
         "split": big["k_sweep"]["picked"],
         "k_sweep_ms": {k: v["ms"] for k, v in big["k_sweep"].items()
                        if k != "picked"},
         "at_131072_rays": {k: small[k] for k in (
             "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
             *IX_NEEDED, "rays", "max_abs_err", "int_mismatch",
             "k_sweep")}})
    require(tuple(rt.DEFAULT.sorted_ladder) == SORTED_LADDER,
            "TraceOptions.sorted_ladder's default moved")
    lst = list_kernel_checks(rt, torch)
    srt = sorted_kernel_checks(rt, torch, shape)
    mxu = mxu_kernel_checks(rt, torch, shape)
    line += coherent_kernel_lines(lst, srt, mxu)
    emit({"phase": "kernels", "card": nvidia_smi, "closest_hit": ch,
          "shade_regen": sr, "shade_regen_stepped": stepped,
          "intersect": ix, "ad_shade": ad, "closest_hit_list": lst,
          "closest_hit_sorted": srt, "closest_hit_mxu": mxu})
    return line


# --------------------------------------------------------------------- #
# kernels phase: the three closest-hit siblings for coherent rays
# --------------------------------------------------------------------- #

@contextlib.contextmanager
def recorded_calls(module, name: str, synchronize=None):
    """Record (args, kwargs, result, seconds) of every call of
    ``module.name`` while the block runs (``synchronize`` is called before
    the clock stops): how a kernel's inputs are taken from inside an
    engine's step, at the shapes the engine gives them, and how a CLI
    run's frame and engine are read."""
    calls = []
    fn = getattr(module, name)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        res = fn(*args, **kwargs)
        if synchronize is not None:
            synchronize()
        calls.append((args, kwargs, res, time.perf_counter() - t0))
        return res

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def against_closest_hit(torch, got, want, active):
    """A sibling kernel's (hit, t, sb) against closest_hit's on the same
    rays, lane by lane on the active lanes."""
    hk, tk, sk = got
    h1, t1, s1 = want
    act = active > 0
    both = act & (hk > 0) & (h1 > 0)
    hit_differs = act & (hk != h1)
    sb_differs = both & (sk != s1)
    t_bits = tk.view(torch.int32) != t1.view(torch.int32)
    agree = both & ~sb_differs
    rel = ((tk - t1).abs() / t1.abs())[agree]
    # the JAX package's own tolerance for the mxu kernel against this one
    # (tests/test_pallas_intersect.py): rtol 5e-3, atol 2e-4 (near t_min
    # the cancellation noise is absolute)
    loose = agree & ((tk - t1).abs() > 2e-4 + 5e-3 * t1.abs())
    q = torch.quantile(rel[:1 << 24].double(), torch.tensor(
        [0.5, 0.99], dtype=torch.float64, device=rel.device)) \
        if rel.numel() else torch.zeros(2)
    n_act = int(act.sum())
    return {"active": n_act, "hit_differs": int(hit_differs.sum()),
            "winner_differs": int(sb_differs.sum()),
            # two distinct spheres at exactly the same q: the same t
            "winner_differs_on_exact_tie": int((sb_differs & ~t_bits).sum()),
            "t_bit_unequal_same_winner": int((agree & t_bits).sum()),
            "max_rel_err_same_winner":
                float(rel.max()) if rel.numel() else 0.0,
            "median_rel_err_same_winner": float(q[0]),
            "p99_rel_err_same_winner": float(q[1]),
            "t_beyond_rtol_5e-3_atol_2e-4": int(loose.sum()),
            "miss_sb_nonzero": int((act & (hk == 0) & (sk != 0)).sum())}


def require_bit_equal(res: dict, what: str) -> None:
    require(res["hit_differs"] == 0 and res["winner_differs"] == 0
            and res["t_bit_unequal_same_winner"] == 0
            and res["miss_sb_nonzero"] == 0,
            f"{what} is not bit-equal with closest_hit: {res}")


def require_equal_off_ties(res: dict, what: str) -> None:
    require(res["hit_differs"] == 0
            and res["winner_differs"] == res["winner_differs_on_exact_tie"]
            and res["t_bit_unequal_same_winner"] == 0
            and res["miss_sb_nonzero"] == 0,
            f"{what} differs from closest_hit off exact ties: {res}")


def bound(ops: float, nbytes: float) -> dict:
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def lane_bytes(lanes: int, active: int) -> int:
    """What a closest-hit kernel must move for its lanes: the active flag
    in and (hit, t, sphere) out for every lane, 16 bytes; the six ray
    planes, 24 bytes, for the active lanes only (an inactive lane's result
    does not depend on its ray)."""
    return lanes * 16 + active * 24


def sorted_lane_chunks(torch, rays, geom, t_min, act, sortstate, ladder,
                       rows: int) -> tuple:
    """The chunks of 8 spheres that closest_hit_sorted's contract makes
    the active lanes test, summed over lanes and computed from the INPUTS
    alone, in plain PyTorch: a lane must run a stage of the ladder unless
    the lane ITSELF is finished at the stage's first chunk (the kernel's
    own exit terms: block distance with its slack, slab exit, the best hit
    among the spheres sorted before the checkpoint). The kernel skips a
    stage only when a whole warp is finished, so it tests at least this
    much: the operations its bound is stated with. -> (those chunks, the
    (lane, sphere) pairs among them whose discriminant is >= 0: the pairs
    that go on to the square root, from which the needed bound is
    stated)."""
    from raytracinginoneweekend_tpu_torch.closest_hit_checks import (
        disc_pairs)
    from raytracinginoneweekend_tpu_torch.ops import cuda_segment as seg

    perm, suf, oc, yb = sortstate
    nb, n_chunks = perm.shape[0], perm.shape[1] // seg.UNROLL
    n_sph = geom[0].shape[0]
    active = (act > 0).reshape(nb, -1)
    pts = seg.ladder_points(ladder, n_chunks)
    ox, oy, oz, dx, dy, dz = (p.reshape(nb, rows * 128) for p in rays)
    a = dx * dx + dy * dy + dz * dz
    rsa = 1.0 / torch.sqrt(a)
    bl = torch.sqrt((ox - oc[:, 0:1]) ** 2 + (oy - oc[:, 1:2]) ** 2
                    + (oz - oc[:, 2:3]) ** 2)
    bl = bl + (bl * 5e-6 + 1e-4)
    going = dy.abs() > 0
    ex = ((torch.where(dy > 0, yb[0], yb[1]) - oy) * (a * rsa)
          / torch.where(going, dy, torch.ones_like(dy)))
    big = torch.full_like(ex, 1e30)
    dist_up = torch.where(going, ex + (ex.abs() * 5e-6 + 1e-4), big)
    table = seg.hit_table_padded(*geom)
    q_min = (torch.tensor(t_min, dtype=torch.float32) * a)[..., None]
    q_b, lo = big, 0
    chunks, n_ge = 0, 0
    for hi in pts + [n_chunks]:
        if pts:
            done = (dist_up <= 0) | (torch.minimum(q_b * rsa, dist_up) + bl
                                     <= suf[:, lo:lo + 1])
            need = active & ~done
        else:
            need = active
        chunks += int(need.sum()) * (hi - lo)
        for b in range(nb):
            lanes = need[b]
            ids = perm[b, lo * seg.UNROLL:hi * seg.UNROLL].to(torch.int64)
            ids = ids[ids < n_sph]  # the pad sphere's discriminant is < 0
            if bool(lanes.any()) and ids.numel():
                n_ge += disc_pairs(
                    tuple(p[b][lanes] for p in (ox, oy, oz, dx, dy, dz)),
                    *(g[ids] for g in geom))[0]
        if hi < n_chunks:  # the best hit among the spheres before `hi`
            cand = table[perm[:, lo * seg.UNROLL:hi * seg.UNROLL].to(
                torch.int64)][:, None]                  # (B, 1, k, 4)
            q = seg._candidates(
                *(p[..., None] for p in (ox, oy, oz, dx, dy, dz, a)), q_min,
                *(cand[..., k] for k in range(4)))
            q_b = torch.minimum(q_b, q.amin(dim=2))
        lo = hi
    return chunks, n_ge


def needed_bound(pairs: int, pairs_ge: int, t_bytes: float,
                 hit_flops: int = CH_FLOPS_PER_SPHERE, strict: bool = False,
                 other_ops: int = 0) -> dict:
    """The bound from the work an input needs: ``hit_flops``
    (CH_FLOPS_PER_SPHERE; IX_HIT_FLOPS for the t-space kernels) for each
    (lane, sphere) pair whose discriminant is >= 0 (> 0 with ``strict``,
    the t-space guard), CH_MISS_FLOPS for the rest, plus ``other_ops``
    (the grouped kernel's bound tests), against PEAK_F32_FLOPS ->
    bound_needed_ms; the same operations at the float32 issue rate that
    -fmad=false leaves (one instruction each: half the peak, which counts
    an FMA as two) -> issue_ceiling_ms. Either is the larger of that time
    and ``t_bytes``."""
    t_ops = (pairs_ge * hit_flops + (pairs - pairs_ge) * CH_MISS_FLOPS
             + other_ops) / PEAK_F32_FLOPS
    return {"pairs": pairs,
            "pairs_disc_gt_0" if strict else "pairs_disc_ge_0": pairs_ge,
            "bound_needed_ms": max(t_ops, t_bytes) * 1e3,
            "issue_ceiling_ms": max(2 * t_ops, t_bytes) * 1e3}


def sorted_sweep(torch, rays, geom, t_min, act, sortstate, rows, table):
    """closest_hit_sorted at every K of its split loop (``CH_SPLITS``)
    with the timed ladder, against its plain version on one input, to the
    bit on every lane (hit, sphere index, the bits of t); each K's device
    time and share of chunks skipped -> {"K<k>": {...}, "picked": the K
    that the wrapper picks for these lanes}."""
    from raytracinginoneweekend_tpu_torch.closest_hit_checks import bit_diff
    from raytracinginoneweekend_tpu_torch.ops import cuda_segment as seg

    want = seg.segment_closest_hit_sorted_reference(
        rays, *geom, sortstate, t_min, rows, act, SORTED_LADDER)
    out = {}
    for k in seg.CH_SPLITS:
        stats = torch.zeros(2, dtype=torch.int64, device=act.device)

        def run(k=k, stats=None):
            return seg.segment_closest_hit_sorted(
                rays, *geom, sortstate, t_min, rows=rows, active=act,
                ladder=SORTED_LADDER, table=table, stats=stats, split=k)

        diff = bit_diff(run(stats=stats), want)
        require(not any(diff.values()), f"closest_hit_sorted at K = {k} is "
                f"not bit-equal with its plain version: {diff}")
        skipped, total = (int(v) for v in stats.tolist())
        out[f"K{k}"] = dict(diff, ms=device_ms(run),
                            share_skipped=skipped / max(total, 1))
    out["picked"] = seg.closest_hit_split(
        rays[0].numel(), torch.cuda.get_device_properties(
            rays[0].device).multi_processor_count, seg.SPLIT_THREADS_PER_SM)
    return out


def ad_shade_entries(rt, torch, options, timed: bool = True) -> dict:
    """The AD pool's shade op (the shade and the regen) on a real pool
    state: the inputs of every forward launch of one pool render of the
    training batch (16384 pixels x 8 spp, depth AD_DEPTH, the pool's 32768
    lanes) are recorded, and on the fifth (every lane busy: depths 0-4,
    hits, misses and fresh rays; later launches run the tail of long paths
    on a few lanes) the forward kernel is held against the plain version,
    ``op_reference`` (integers equal; floats within rtol 1e-5 / atol 1e-6,
    no exception) and the adjoint kernel against autograd through it for
    one random weighting of the outputs (every gradient finite and within
    rtol 1e-4 / atol 1e-5 of its largest |value|, no exception); the
    lanes that acquire a ray there are counted (``acquiring``). With
    ``timed``: each kernel's ``ms`` (device), ``call_ms``, ``plain_ms``
    (the plain forward; autograd's backward through it) and bound."""
    from raytracinginoneweekend_tpu_torch import cli
    from raytracinginoneweekend_tpu_torch.ops import cuda_ad_shade as cas
    from raytracinginoneweekend_tpu_torch.ops import wavefront_ad
    from raytracinginoneweekend_tpu_torch.optim import inverse

    dev = torch.device("cuda")
    w, h = TRAIN["width"], TRAIN["height"]
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", w, h, dev)
    batch_key, render_key = inverse.step_keys(rt.key_words(7), 0)
    ids = inverse.draw_pixel_batch(batch_key, w * h, TRAIN["batch_pixels"],
                                   dev)
    with recorded_calls(cas, "ad_shade_cuda") as calls, torch.no_grad():
        wavefront_ad.render_pixels_wavefront_ad_impl(
            scene, cam, ids, render_key, width=w, height=h,
            spp=TRAIN["spp"], max_depth=AD_DEPTH, camera_mode="thinlens",
            options=options)
    torch.cuda.synchronize()
    n_calls, pick = len(calls), min(4, len(calls) - 1)
    args = calls[pick][0]
    del calls
    (table, t, planes, sb, hit_i, active, depth, nxtw, wcur, k0, k1, rays,
     spec) = args
    state = (nxtw, wcur, active, *planes, depth, k0, k1)
    lanes = t.numel()
    out = {"lanes": lanes, "calls": n_calls, "call_picked": pick,
           "active": int(active.sum()), "hit": int((hit_i > 0).sum()),
           "depth_max": int(depth.max())}

    got = cas.ad_shade_cuda(*args)
    nxt, deposit, cell, busy = cas.op_reference(table, state,
                                                (t, sb, hit_i), rays, spec)
    want = (*nxt[3:12], deposit, nxt[0], nxt[1], nxt[12], nxt[13], nxt[14],
            nxt[2], busy, cell)
    torch.cuda.synchronize()
    out["acquiring"] = int((nxt[1] != wcur).sum())
    flt = [(got[i], want[i]) for i in range(10)]
    fwd = {"int_mismatch": sum(int((got[i] != want[i]).sum())
                               for i in range(10, 18)),
           "float_bits_unequal": sum(
               int((a.view(torch.int32) != b.view(torch.int32)).sum())
               for a, b in flt),
           "outliers": sum(int((~torch.isclose(a, b, rtol=1e-5, atol=1e-6,
                                               equal_nan=True)).sum())
                           for a, b in flt),
           "max_abs_err": max(float((a - b).abs().nan_to_num().max())
                              for a, b in flt)}
    fwd["max_err_share_of_scale"] = max(
        float((a - b).abs().nan_to_num().max())
        / max(float(b.abs().nan_to_num().max()), 1e-30) for a, b in flt)
    fwd["ok"] = fwd["int_mismatch"] == 0 and fwd["outliers"] == 0

    gen = torch.Generator(device=dev).manual_seed(1)
    g_out = [torch.randn(t.shape, generator=gen, device=dev)
             for _ in range(9)]
    g_out.append(torch.randn((3, lanes), generator=gen, device=dev))
    leaves = [table.clone().requires_grad_(True),
              t.clone().requires_grad_(True),
              *(p.clone().requires_grad_(True) for p in planes)]
    lnxt, ldep, _, _ = cas.op_reference(
        leaves[0], (nxtw, wcur, active, *leaves[2:], depth, k0, k1),
        (leaves[1], sb, hit_i), rays, spec)
    outs = [*lnxt[3:12], ldep]
    plain_adj = torch.autograd.grad(outs, leaves, g_out, retain_graph=True)
    g_args = (table, t, planes, sb, hit_i, active, depth, nxtw, wcur, k0,
              k1, rays, g_out[:9], g_out[9], spec)
    g_planes, g_t, rows = cas.ad_shade_grad_cuda(*g_args)
    g_table = torch.zeros_like(table).index_add_(
        0, sb.reshape(-1).to(torch.int64), rows)
    torch.cuda.synchronize()
    adj = {"int_mismatch": 0, "outliers": 0, "non_finite": 0,
           "max_abs_err": 0.0, "max_err_share_of_scale": 0.0}
    for a, b in zip([g_table, g_t, *g_planes], plain_adj):
        fin = torch.isfinite(b)
        scale = float(b[fin].abs().max()) if bool(fin.any()) else 0.0
        err = float((a - b)[fin].abs().max()) if bool(fin.any()) else 0.0
        adj["non_finite"] += int((~torch.isfinite(a)).sum())
        adj["outliers"] += int((fin & ~torch.isclose(
            a, b, rtol=1e-4, atol=1e-5 * scale)).sum())
        adj["max_abs_err"] = max(adj["max_abs_err"], err)
        adj["max_err_share_of_scale"] = max(adj["max_err_share_of_scale"],
                                            err / max(scale, 1e-30))
    adj["ok"] = adj["outliers"] == 0 and adj["non_finite"] == 0
    out.update(ad_shade=fwd, ad_shade_grad=adj)
    if not timed:
        return out

    def nbytes(tensors) -> int:
        return sum(x.numel() * x.element_size() for x in tensors
                   if x is not None)

    # bytes that must move: each kernel's planes in and out once, the
    # table once (its rows are read by index and stay in cache), and an
    # acquiring lane's ray (6 floats and 2 key words) and, under
    # stratified sampling, a depth-0 lane's vector (3 floats) from the ray
    # tables
    ins = [*planes, t, sb, hit_i, active, depth, nxtw, wcur, k0, k1]
    stratified = rays.floats.shape[0] == 9
    fresh = int(((depth == 0) & active).sum()) if stratified else 0
    from_tables = 32 * out["acquiring"] + 12 * fresh
    runs = {
        "ad_shade": (lambda: cas.ad_shade_cuda(*args),
                     lambda: cas.op_reference(
                         table, state, (t, sb, hit_i), rays, spec),
                     AS_FLOPS_PER_LANE,
                     nbytes([*ins, *got, table]) + from_tables),
        "ad_shade_grad": (lambda: cas.ad_shade_grad_cuda(*g_args),
                          lambda: torch.autograd.grad(
                              outs, leaves, g_out, retain_graph=True),
                          AS_GRAD_FLOPS_PER_LANE,
                          nbytes([*ins, *g_out, *g_planes, g_t, rows,
                                  table]) + 12 * fresh)}
    for name, (run, plain, flops, moved) in runs.items():
        res = out[name]
        res.update(times(run, plain))
        res.update(bound(lanes * flops, moved), bytes=moved)
        res["share_of_bound"] = res["bound_ms"] / res["ms"]
    return out


def times(run, plain_run) -> dict:
    from raytracinginoneweekend_tpu_torch.utils.timing import cuda_time_ms

    return {"ms": cuda_time_ms(run, iters=20, queue_behind=True),
            "call_ms": cuda_time_ms(run, iters=20),
            "plain_ms": cuda_time_ms(plain_run, warmup=1, iters=3)}


def device_ms(run) -> float:
    from raytracinginoneweekend_tpu_torch.utils.timing import cuda_time_ms

    return cuda_time_ms(run, iters=20, queue_behind=True)


def random_rays(torch, dev, lanes: int, seed: int):
    """Rays among the huge scene's spheres: origins in its box, any
    direction -> (6 planes on ``dev``, the CPU generator for more)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    shape = (lanes // 128, 128)
    o = torch.stack([torch.rand(shape, generator=gen) * 16 - 8,
                     torch.rand(shape, generator=gen) * 1.5 + 0.05,
                     torch.rand(shape, generator=gen) * 16 - 8])
    d = torch.randn(3, *shape, generator=gen)
    d = d / d.norm(dim=0, keepdim=True) * (
        0.5 + torch.rand(shape, generator=gen))
    return tuple(x.contiguous().to(dev) for x in (*o, *d)), gen


def list_pairs_ge(rays, geom, counts, lists, act, rows: int) -> int:
    """The (active lane, list entry of its cull block) pairs whose
    discriminant is >= 0 -- the pairs that go on to the list kernel's
    square root -- with kernel 1's float32 arithmetic (the pad sphere's
    discriminant is < 0)."""
    from raytracinginoneweekend_tpu_torch.closest_hit_checks import (
        disc_pairs)

    nb, n_sph = counts.numel(), geom[0].shape[0]
    planes = [p.reshape(nb, rows * 128) for p in rays]
    live = (act > 0).reshape(nb, rows * 128)
    n_ge = 0
    for b, n in enumerate(counts.clamp(0, lists.shape[1]).tolist()):
        ids = lists[b, :n].long()
        ids = ids[ids < n_sph]
        if ids.numel() and bool(live[b].any()):
            n_ge += disc_pairs(tuple(p[b][live[b]] for p in planes),
                               *(g[ids] for g in geom))[0]
    return n_ge


def list_sweep(torch, rays, geom, counts, lists, t_min, rows, act, table,
               what: str) -> dict:
    """closest_hit_list's ``k_sweep`` on one input."""
    from raytracinginoneweekend_tpu_torch.ops import cuda_segment as seg

    return k_sweep(
        torch, what,
        lambda k: seg.segment_closest_hit_list(
            rays, *geom, counts, lists, t_min, rows=rows, active=act,
            table=table, split=k),
        seg.segment_closest_hit_list_reference(rays, *geom, counts, lists,
                                               t_min, rows, act),
        rays[0].numel(), seg.LIST_THREADS_PER_SM)


def list_kernel_checks(rt, torch):
    """closest_hit_list: the dual engine's primary pool in mid-frame at two
    pool sizes (its real counts and lists; at every K, its K sweep), and
    synthetic lists at every K."""
    from raytracinginoneweekend_tpu_torch import cli
    from raytracinginoneweekend_tpu_torch import closest_hit_checks as chk
    from raytracinginoneweekend_tpu_torch.ops import cuda_segment as seg
    from raytracinginoneweekend_tpu_torch.ops import wavefront_dual as dual

    dev = torch.device("cuda")
    w, h, spp, depth = (MAIN[k] for k in ("width", "height", "spp", "depth"))
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", w, h, dev)
    out = {}
    for pool in (DUAL_POOL, DUAL_POOL_DEFAULT):
        eng = dual.build_dual_engine(
            scene, cam, rt.key_words(0), width=w, height=h, spp=spp,
            max_depth=depth, camera_mode="thinlens", options=rt.DEFAULT,
            pool_size=pool, device=dev)
        state = dual.initial_dual_state(eng)
        for _ in range(24):
            state = dual.dual_step(eng, state)
        with recorded_calls(seg, "segment_closest_hit_list") as calls:
            dual.dual_step(eng, state)
        require(len(calls) == 1, "one list-kernel call per dual iteration")
        (rays, cx, cy, cz, r, counts, lists, t_min), kw = calls[0][:2]
        geom = (cx, cy, cz, r)
        rows, issue, table = kw["rows"], kw["active"].to(torch.int32), \
            kw["table"]

        def kernel(rays_, act_):
            return seg.segment_closest_hit_list(
                rays_, *geom, counts, lists, t_min, rows=rows, active=act_,
                table=table)

        def plain(rays_, act_):
            return seg.segment_closest_hit_list_reference(
                rays_, *geom, counts, lists, t_min, rows, act_)

        res = compare_closest_hit(torch, rays, geom, t_min, issue,
                                  kernel=kernel, plain=plain)
        got = res.pop("out")
        require(res["ok"] and res["int_mismatch"] == 0,
                f"closest_hit_list disagrees with its plain version on the "
                f"dual engine's primary pool (pool {pool}): {res}")
        # the cull is conservative, so the whole-table kernel agrees bitwise
        full = seg.segment_closest_hit(rays, *geom, t_min, active=issue,
                                       table=eng.htable)
        res["vs_closest_hit"] = against_closest_hit(torch, got, full, issue)
        require_bit_equal(res["vs_closest_hit"],
                          f"closest_hit_list on real lists (pool {pool})")
        lanes = rays[0].numel()
        per_block = issue.reshape(-1, rows * 128).sum(dim=1)
        cand_lane = int((per_block * counts).sum())  # candidates tested
        # list entries of the cull blocks that hold an issuing lane
        used = counts[per_block > 0]
        n_sph = geom[0].shape[0]
        nbytes = (lane_bytes(lanes, res["active"]) + counts.numel() * 4
                  + int(used.sum()) * 4
                  + int(lists[per_block > 0].unique().numel()) * 16)
        res.update(
            lanes=lanes, cull_blocks=int(counts.numel()), spheres=n_sph,
            list_len=int(lists.shape[1]),
            mean_list=float(counts[per_block > 0].float().mean())
            if res["active"] else 0.0,
            max_list=int(counts.max()),
            candidates_per_active_lane=cand_lane / max(res["active"], 1),
            **times(lambda: kernel(rays, issue), lambda: plain(rays, issue)),
            **bound(cand_lane * CH_FLOPS_PER_SPHERE, nbytes),
            **needed_bound(cand_lane, list_pairs_ge(rays, geom, counts,
                                                    lists, issue, rows),
                           nbytes / PEAK_BYTES_PER_S),
            k_sweep=list_sweep(torch, rays, geom, counts, lists, t_min, rows,
                               issue, table, f"closest_hit_list (pool "
                               f"{pool})"))
        res["closest_hit_ms_same_rays"] = device_ms(
            lambda: seg.segment_closest_hit(rays, *geom, t_min, active=issue,
                                            table=eng.htable))
        out[f"pool_{pool}"] = res

    # synthetic lists on four cull blocks of 64 rows, each at every K
    rows, nb = 64, 4
    lanes = nb * rows * 128
    rays, gen = random_rays(torch, dev, lanes, 21)
    ones = torch.ones((lanes // 128, 128), dtype=torch.int32, device=dev)
    n_sph = geom[0].shape[0]
    l_len = -(-n_sph // 4) * 4
    ids_full = torch.arange(l_len, dtype=torch.int32, device=dev).clamp(
        max=n_sph)
    full_lists = ids_full[None, :].repeat(nb, 1).contiguous()
    full_counts = torch.full((nb,), l_len, dtype=torch.int32, device=dev)
    want = seg.segment_closest_hit(rays, *geom, t_min, active=ones)
    for k in seg.CH_SPLITS:
        got = seg.segment_closest_hit_list(rays, *geom, full_counts,
                                           full_lists, t_min, rows=rows,
                                           active=ones, split=k)
        res = against_closest_hit(torch, got, want, ones)
        require_bit_equal(res, f"closest_hit_list on full lists, K = {k}")
        require(res["active"] == lanes and int(got[0].sum()) > lanes // 4,
                "the synthetic rays must hit")
        out[f"synthetic_full_lists_K{k}"] = res
    # a 40-sphere sublist is the 40-sphere sub-scene
    sub = torch.cat([torch.zeros(1, dtype=torch.int64), 1 + torch.randperm(
        n_sph - 1, generator=gen)[:39]]).sort().values.to(dev)
    sub_lists = torch.full((nb, l_len), n_sph, dtype=torch.int32, device=dev)
    sub_lists[:, :40] = sub.to(torch.int32)[None, :]
    sub_counts = torch.full((nb,), 40, dtype=torch.int32, device=dev)
    h_s, t_s, sb_s = seg.segment_closest_hit(
        rays, *(g[sub].contiguous() for g in geom), t_min, active=ones)
    mapped = torch.where(h_s > 0, sub[sb_s.to(torch.int64)].to(torch.int32),
                         torch.zeros_like(sb_s))
    for k in seg.CH_SPLITS:
        got = seg.segment_closest_hit_list(rays, *geom, sub_counts,
                                           sub_lists, t_min, rows=rows,
                                           active=ones, split=k)
        res = against_closest_hit(torch, got, (h_s, t_s, mapped), ones)
        require_bit_equal(res, f"closest_hit_list on a 40-sphere sublist, "
                          f"K = {k}")
        out[f"synthetic_sublist_40_K{k}"] = res
    # empty lists (blocks 0, 1) and all-inactive blocks (2, 3)
    counts = full_counts.clone()
    counts[:2] = 0
    act = ones.clone()
    act[2 * rows:] = 0
    for k in seg.CH_SPLITS:
        hk, tk, sk = seg.segment_closest_hit_list(
            rays, *geom, counts, full_lists, t_min, rows=rows, active=act,
            split=k)
        torch.cuda.synchronize()
        require(bool(((hk == 0) & (tk == 1e30) & (sk == 0)).all()),
                f"an empty list or an inactive block must give (0, 1e30, 0) "
                f"(K = {k})")
    out["synthetic_empty_and_inactive"] = {"ok": True, "lanes": lanes}
    # ties_and_grazes with lists whose order runs against the ids: the
    # earliest list position wins a tie
    t_rays, t_geom, t_tmin, _ = chk.ties_and_grazes(dev)
    t_counts, t_lists, t_act = chk.ties_and_grazes_lists(dev)
    res = list_sweep(torch, t_rays, t_geom, t_counts, t_lists, t_tmin, 2,
                     t_act, seg.hit_table_padded(*t_geom),
                     "closest_hit_list on ties_and_grazes")
    sb0 = seg.segment_closest_hit_list_reference(
        t_rays, *t_geom, t_counts, t_lists, t_tmin, 2, t_act)[2].reshape(
            4, -1)[0].cpu()
    kind = torch.arange(sb0.numel()) % 11
    on = (kind < 9) & (t_act.reshape(4, -1)[0].cpu() > 0)
    later = torch.tensor([p[1] for p in chk.TIE_PAIRS], dtype=torch.int32)
    require(bool((sb0[on] == later[kind[on]]).all()),
            "closest_hit_list's plain version must keep the earliest list "
            "position on ties_and_grazes")
    out["ties_and_grazes_lists"] = {k: v for k, v in res.items()
                                    if k != "picked"}
    return out


def sorted_kernel_checks(rt, torch, shape):
    """closest_hit_sorted: the single pool's mid-frame state under strided
    and under tile ownership with a sort state half an epoch old, at two
    pool sizes; and synthetic rays."""
    from raytracinginoneweekend_tpu_torch.ops import cuda_segment as seg
    from raytracinginoneweekend_tpu_torch.ops import wavefront

    dev = torch.device("cuda")
    rows = wavefront.ROWS_DEFAULT
    out = {}

    def run_case(rays, geom, t_min, act, sortstate, ladder, table=None):
        stats = torch.zeros(2, dtype=torch.int64, device=dev)

        def kernel(rays_, act_, stats_=stats):
            return seg.segment_closest_hit_sorted(
                rays_, *geom, sortstate, t_min, rows=rows, active=act_,
                ladder=ladder, table=table, stats=stats_)

        def plain(rays_, act_):
            return seg.segment_closest_hit_sorted_reference(
                rays_, *geom, sortstate, t_min, rows, act_, ladder)

        res = compare_closest_hit(torch, rays, geom, t_min, act,
                                  kernel=kernel, plain=plain)
        got = res.pop("out")
        skipped, total = (int(v) for v in stats.tolist())
        res.update(ladder=list(ladder), chunks_skipped=skipped,
                   chunks=total, share_skipped=skipped / max(total, 1))
        full = seg.segment_closest_hit(rays, *geom, t_min, active=act)
        res["vs_closest_hit"] = against_closest_hit(torch, got, full, act)
        return res, kernel, plain

    for pool in (1 << 15, 1 << 20):
        for own in ("strided", "tile"):
            options = dataclasses.replace(rt.DEFAULT, ownership=own)
            eng = make_engine(rt, torch, "huge", "cpu", "thinlens", options,
                              pool_size=pool, **shape)
            state = mid_frame_state(eng, 24)
            geom = eng.sphere_params[:4]
            sortstate = seg.sorted_cull_state(state[3], state[4:7], *geom,
                                              rows=rows)
            for _ in range(16):  # the engine sorts once per 32 iterations
                state = wavefront.engine_step(eng, state)
            rays, act = tuple(state[4:10]), state[3]
            table = seg.hit_table_padded(*geom)
            n_sph = geom[0].shape[0]
            case = {}
            for ladder in ((1, 8), SORTED_LADDER):  # the timed one last
                res, kernel, plain = run_case(rays, geom, eng.t_min, act,
                                              sortstate, ladder, table)
                what = (f"closest_hit_sorted (pool {pool}, {own}, ladder "
                        f"{ladder})")
                require(res["ok"], f"{what} disagrees with its plain "
                        f"version: {res}")
                require_equal_off_ties(res["vs_closest_hit"], what)
                case["ladder_" + "_".join(map(str, ladder))] = res
            # (the timed launches count nothing: stats=None)
            res.update(times(lambda: kernel(rays, act, None),
                             lambda: plain(rays, act)))
            res["closest_hit_ms_same_rays"] = device_ms(
                lambda: seg.segment_closest_hit(rays, *geom, eng.t_min,
                                                active=act))
            s_pad = sortstate[0].shape[1]
            # cull blocks that hold an active lane read their sort state
            live_blocks = int((act.reshape(-1, rows * 128).sum(dim=1)
                               > 0).sum())
            need, need_ge = sorted_lane_chunks(torch, rays, geom, eng.t_min,
                                               act, sortstate, SORTED_LADDER,
                                               rows)
            nbytes = (lane_bytes(eng.lanes, res["active"])
                      + live_blocks * (s_pad * 4 + (s_pad // 8 + 1) * 4 + 12)
                      + (n_sph + 1) * 16 + 8)
            res.update(
                lanes=eng.lanes, spheres=n_sph,
                # what a lane-by-lane exit could skip, beside what the
                # kernel's warp-wide one did (share_skipped)
                share_skippable_lane_by_lane=1.0 - need / max(
                    res["active"] * (s_pad // 8), 1),
                **bound(need * 8 * CH_FLOPS_PER_SPHERE, nbytes),
                **needed_bound(need * 8, need_ge,
                               nbytes / PEAK_BYTES_PER_S),
                k_sweep=sorted_sweep(torch, rays, geom, eng.t_min, act,
                                     sortstate, rows, table))
            out[f"pool_{pool}_{own}"] = case

    # synthetic rays on four cull blocks
    lanes = 4 * rows * 128
    rays, gen = random_rays(torch, dev, lanes, 22)
    ones = torch.ones((lanes // 128, 128), dtype=torch.int32, device=dev)
    t_min = rt.DEFAULT.t_min

    def synthetic(name, rays_, act_, ladders=((), (1, 8))):
        sortstate = seg.sorted_cull_state(act_, rays_[:3], *geom, rows=rows)
        for ladder in ladders:
            res, _, _ = run_case(rays_, geom, t_min, act_, sortstate, ladder)
            what = f"closest_hit_sorted on {name}, ladder {ladder}"
            require(res["ok"], f"{what} disagrees with its plain version: "
                    f"{res}")
            require_equal_off_ties(res["vs_closest_hit"], what)
            out[f"synthetic_{name}_ladder_{len(ladder)}"] = res
        return res

    synthetic("random_rays", rays, ones)
    require(out["synthetic_random_rays_ladder_0"]["chunks_skipped"] == 0,
            "an empty ladder must skip nothing")
    # outside the slab, heading away: finished before the first chunk
    up = list(rays)
    up[1] = up[1] + 2000.0
    up[4] = up[4].abs() + 0.1
    res = synthetic("outside_slab_heading_away", tuple(up), ones)
    require(res["hits"] == 0 and res["chunks_skipped"] == res["chunks"] > 0,
            f"rays that left the slab must skip every chunk: {res}")
    # dy == 0: no slab exit, the bound is the best hit alone
    flat = list(rays)
    flat[1] = flat[1] * 0.2
    flat[4] = torch.zeros_like(flat[4])
    res = synthetic("dy_zero", tuple(flat), ones)
    require(res["hits"] > lanes // 8, "horizontal rays must hit")
    # half the lanes inactive, and one block with no active lane
    act = (torch.rand((lanes // 128, 128), generator=gen) < 0.5).to(
        torch.int32).to(dev)
    act[:rows] = 0
    synthetic("half_inactive", rays, act)
    return out


def mxu_kernel_checks(rt, torch, shape):
    """closest_hit_mxu: the single pool's mid-frame state at two pool sizes
    (at every K, its K sweep), closest_hit's synthetic cases and
    ``ties_and_grazes`` with its own table at every K."""
    from raytracinginoneweekend_tpu_torch.closest_hit_checks import (
        disc_pairs)
    from raytracinginoneweekend_tpu_torch.ops import cuda_segment as seg

    out = {}
    for pool in (1 << 15, 1 << 20):
        eng = make_engine(rt, torch, "huge", "cpu", "thinlens", rt.DEFAULT,
                          pool_size=pool, **shape)
        state = mid_frame_state(eng, 40)
        rays, act = tuple(state[4:10]), state[3]
        geom = eng.sphere_params[:4]
        table = seg.mxu_table(*geom)
        n_sph = geom[0].shape[0]

        def kernel(rays_, act_):
            return seg.segment_closest_hit_mxu(rays_, *geom, eng.t_min,
                                               active=act_, table=table)

        def plain(rays_, act_):
            return seg.segment_closest_hit_mxu_reference(rays_, *geom,
                                                         eng.t_min, act_)

        res = compare_closest_hit(torch, rays, geom, eng.t_min, act,
                                  kernel=kernel, plain=plain)
        got = res.pop("out")
        require(res["ok"], f"closest_hit_mxu disagrees with its plain "
                f"version on a real lane state (pool {pool}): {res}")
        full = seg.segment_closest_hit(rays, *geom, eng.t_min, active=act,
                                       table=eng.htable)
        vs = against_closest_hit(torch, got, full, act)
        res["vs_closest_hit"] = vs
        # regrouped dot products: another rounding on knife-edge candidates,
        # and on the r = 1000 ground sphere c = (|o|^2 - 2 o.C) + (|C|^2 -
        # r^2) cancels terms of 1e6, so t of a restart there moves
        require(vs["hit_differs"] + vs["winner_differs"]
                <= 1e-3 * max(vs["active"], 1)
                and vs["t_beyond_rtol_5e-3_atol_2e-4"]
                <= 1e-3 * max(vs["active"], 1)
                and vs["miss_sb_nonzero"] == 0,
                f"closest_hit_mxu against closest_hit (pool {pool}): {vs}")
        nbytes = lane_bytes(eng.lanes, res["active"]) + n_sph * 16
        n_ge, n_pairs = disc_pairs(rays, *geom, act, regrouped=True)
        res.update(lanes=eng.lanes, spheres=n_sph,
                   **times(lambda: kernel(rays, act),
                           lambda: plain(rays, act)),
                   **bound(res["active"] * n_sph * MX_FLOPS_PER_SPHERE,
                           nbytes),
                   **needed_bound(n_pairs, n_ge, nbytes / PEAK_BYTES_PER_S),
                   k_sweep=k_sweep(
                       torch, "closest_hit_mxu",
                       lambda k: seg.segment_closest_hit_mxu(
                           rays, *geom, eng.t_min, active=act, table=table,
                           split=k),
                       plain(rays, act), eng.lanes, seg.MXU_THREADS_PER_SM))
        out[f"pool_{pool}"] = res
        if pool == 1 << 15:
            out["synthetic"] = synthetic_closest_hit(
                torch, geom, eng.t_min, eng.lanes, kernel=kernel,
                plain=plain, what="closest_hit_mxu")
            out["ties_and_grazes"] = synthetic_ties_and_grazes(
                torch, act.device, "closest_hit_mxu")
    return out


def coherent_kernel_lines(lst, srt, mxu):
    """The ``kernels`` line's entries of the three siblings."""
    pkg = "raytracinginoneweekend_tpu_torch/csrc/"
    jax_src = "raytracinginoneweekend_tpu/ops/pallas_segment.py:"
    keys = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "lanes",
            "active", "max_abs_err", "int_mismatch")

    def entry(name, line, main, **more):
        return {"name": name, "route": "cuda", "source": f"{pkg}{name}.cu",
                "replaces": jax_src + line, "launches": None,
                "max_abs_err": main["max_abs_err"],
                "max_rel_err": main["max_rel_err"],
                "int_mismatch_lanes": main["int_mismatch"],
                "ms": main["ms"], "call_ms": main["call_ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": None,
                "lanes": main["lanes"], "active_lanes": main["active"],
                "vs_closest_hit": main["vs_closest_hit"], **more}

    lad = "ladder_" + "_".join(map(str, SORTED_LADDER))
    l_main, l_def = (lst[f"pool_{p}"] for p in (DUAL_POOL,
                                                DUAL_POOL_DEFAULT))
    s_main = srt[f"pool_{1 << 15}_tile"][lad]
    m_main, m_big = (mxu[f"pool_{p}"] for p in (1 << 15, 1 << 20))
    list_keys = keys + ("mean_list", "candidates_per_active_lane",
                        "closest_hit_ms_same_rays", *CH_NEEDED, "k_sweep")

    def split_keys(main):
        return {"split": main["k_sweep"]["picked"],
                "k_sweep_ms": {k: v["ms"] for k, v in
                               main["k_sweep"].items() if k != "picked"},
                **{k: main[k] for k in CH_NEEDED}}

    sort_keys = keys + ("share_skipped", "share_skippable_lane_by_lane",
                        "closest_hit_ms_same_rays", *CH_NEEDED, "k_sweep")
    return [
        entry("closest_hit_list", "132", l_main,
              **{k: l_main[k] for k in ("mean_list",
                                        "candidates_per_active_lane",
                                        "closest_hit_ms_same_rays")},
              **split_keys(l_main),
              at_default_pool={k: l_def[k] for k in list_keys}),
        entry("closest_hit_sorted", "247", s_main,
              ownership="tile", ladder=list(SORTED_LADDER),
              share_skipped=s_main["share_skipped"],
              share_skippable_lane_by_lane=s_main[
                  "share_skippable_lane_by_lane"],
              closest_hit_ms_same_rays=s_main["closest_hit_ms_same_rays"],
              **{k: s_main[k] for k in CH_NEEDED},
              split=s_main["k_sweep"]["picked"],
              k_sweep_ms={k: v["ms"] for k, v in s_main["k_sweep"].items()
                          if k != "picked"},
              k_sweep_share_skipped={
                  k: v["share_skipped"]
                  for k, v in s_main["k_sweep"].items() if k != "picked"},
              **{f"at_pool_{p}_{own}": {
                  k: srt[f"pool_{p}_{own}"][lad][k] for k in sort_keys}
                 for p in (1 << 15, 1 << 20) for own in ("strided", "tile")
                 if (p, own) != (1 << 15, "tile")}),
        entry("closest_hit_mxu", "555", m_main, **split_keys(m_main),
              at_pool_1m={k: m_big[k] for k in (*keys, *CH_NEEDED,
                                                 "k_sweep")}),
    ]


# --------------------------------------------------------------------- #
# kernels phase: intersect, the (N, 3) closest hit
# --------------------------------------------------------------------- #

def compare_intersect(torch, o, d, centers, radii, t_min, split=None):
    """Kernel (at K = ``split``, or the picked K) against plain version on
    one input -> (dict of errors, the kernel's (t, idx, hit)); ``ok`` by
    the stated tolerance, ``bit_equal`` on every ray (hit, idx, the bits
    of t)."""
    from raytracinginoneweekend_tpu_torch.ops.cuda_intersect import (
        closest_hit_cuda)
    from raytracinginoneweekend_tpu_torch.ops.intersect import closest_hit

    tk, ik, hk = closest_hit_cuda(o, d, centers, radii, t_min, split=split)
    tr, ir, hr = closest_hit(o, d, centers, radii, t_min)
    torch.cuda.synchronize()
    bad = (hk != hr) | (ik != ir)
    agree = hk & hr & ~bad
    dt = (tk - tr).abs()[agree]
    rel = dt / tr[agree].abs()
    miss_ok = bool(((tk[~hk] == 1e30) & (ik[~hk] == 0)).all())
    res = {"rays": o.shape[0], "spheres": centers.shape[0],
           "hits": int(hk.sum()), "int_mismatch": int(bad.sum()),
           "t_bits_differ": int((tk.view(torch.int32)
                                 != tr.view(torch.int32)).sum()),
           "max_abs_err": float(dt.max()) if dt.numel() else 0.0,
           "max_rel_err": float(rel.max()) if rel.numel() else 0.0,
           "miss_convention_ok": miss_ok}
    res["ok"] = (miss_ok and res["int_mismatch"] == 0
                 and res["max_rel_err"] <= 1e-6)
    res["bit_equal"] = res["int_mismatch"] == 0 and res["t_bits_differ"] == 0
    return res, (tk, ik, hk)


def intersect_sweep(torch, o, d, centers, radii, t_min, what: str,
                    timed: bool = True) -> dict:
    """intersect at every K (``CH_SPLITS``) against its plain version on
    one input, to the bit on every ray, with each K's device time ->
    {"K<k>": {...}, "picked": the K the wrapper picks for these rays}."""
    from raytracinginoneweekend_tpu_torch.ops import cuda_segment as seg
    from raytracinginoneweekend_tpu_torch.ops.cuda_intersect import (
        closest_hit_cuda)

    out = {}
    for k in seg.CH_SPLITS:
        res, _ = compare_intersect(torch, o, d, centers, radii, t_min,
                                   split=k)
        require(res["bit_equal"], f"intersect at K = {k} is not bit-equal "
                f"with its plain version ({what}): {res}")
        out[f"K{k}"] = {key: res[key] for key in ("int_mismatch",
                                                  "t_bits_differ")}
        if timed:
            out[f"K{k}"]["ms"] = device_ms(functools.partial(
                closest_hit_cuda, o, d, centers, radii, t_min, split=k))
    out["picked"] = seg.picked_split(o.shape[0], o.device.index,
                                     seg.IX_THREADS_PER_SM)
    return out


def synthetic_intersect(torch, scene, t_min):
    """Edge cases for intersect, each at every K bit-equal with the plain
    version -> {name: result}."""
    from raytracinginoneweekend_tpu_torch import closest_hit_checks as chk

    dev = scene.centers.device
    gen = torch.Generator(device="cpu").manual_seed(11)
    n = 4096 + 77  # not a multiple of the block

    def rnd(*s):
        return torch.rand(*s, generator=gen, dtype=torch.float32)

    def unit(k=n):
        v = torch.randn(k, 3, generator=gen, dtype=torch.float32)
        return v / v.norm(dim=1, keepdim=True)

    def run(name, o, d, centers=scene.centers, radii=scene.radii, tm=t_min):
        o, d = o.contiguous().to(dev), d.contiguous().to(dev)
        res, got = compare_intersect(torch, o, d, centers, radii, tm)
        res["k_sweep"] = intersect_sweep(torch, o, d, centers, radii, tm,
                                         name, timed=False)
        out[name] = res
        return got

    out = {}
    # rays far above the scene, pointing up: nothing is hit
    o = torch.stack([rnd(n) * 20 - 10, 2000 + rnd(n), rnd(n) * 20 - 10], 1)
    d = unit()
    d[:, 1] = d[:, 1].abs() + 0.1
    run("miss_everything", o, d)
    require(out["miss_everything"]["hits"] == 0,
            "rays pointing away must miss everything")
    # inside the hollow glass (sphere 4, radius -0.99, inside sphere 3):
    # the far root of the negative-radius shell is the first hit
    o = torch.tensor([-2.0, 1.0, 0.0]) + unit() * (rnd(n, 1) * 0.5)
    d = unit()
    d[:, 1] = d[:, 1].abs()
    _, idx, _ = run("inside_hollow_glass", o, d)
    require(bool((idx == 4).all())
            and out["inside_hollow_glass"]["hits"] == n,
            "rays inside the hollow glass must hit the inner shell")
    # a restart on the r = 1000 ground sphere: the origin sits on the
    # surface to float32 rounding, the exit root straddles t_min
    nrm = torch.stack([rnd(n) * 0.02 - 0.01, torch.ones(n),
                       rnd(n) * 0.02 - 0.01], 1)
    nrm = nrm / nrm.norm(dim=1, keepdim=True)
    o = torch.tensor([0.0, -1000.125, 0.0]) + nrm * 1000.0
    run("ground_restart", o, nrm + unit())
    # a wide t_min window: near roots inside it are refused for far ones
    o = torch.stack([rnd(n) * 8 - 4, rnd(n) * 2, rnd(n) * 8], 1)
    run("t_min_window_0.5", o, unit(), tm=0.5)
    # exact ties: every sphere twice, 41 places apart (an odd offset: the
    # copies lie in two threads' partitions at every K > 1); the earlier
    # copy must win
    c2 = torch.cat([scene.centers[:41], scene.centers[:41]])
    r2 = torch.cat([scene.radii[:41], scene.radii[:41]])
    _, idx, _ = run("exact_ties", o, unit() * 3.0, centers=c2, radii=r2)
    require(bool((idx < 41).all()) and out["exact_ties"]["hits"] > 0,
            "a tie must keep the earliest sphere")
    # one ray, one sphere
    t, _, _ = run("one_ray_one_sphere", torch.zeros(1, 3),
                  torch.tensor([[0.0, 0.0, -4.0]]),
                  centers=torch.tensor([[0.0, 0.0, -2.0]], device=dev),
                  radii=torch.tensor([1.0], device=dev))
    require(abs(float(t[0]) - 0.25) < 1e-6, "t is in units of |d|")
    # exact tangents (disc == 0: a miss in t-space), planted ties 1 to 32
    # places apart, roots below, on and above t_min, a hollow shell: the
    # exact answers (closest_hit_checks.tspace_ties_and_grazes)
    o, d, c3, r3, tm, want = chk.tspace_ties_and_grazes(dev)
    got = run("tspace_ties_and_grazes", o, d, centers=c3, radii=r3, tm=tm)
    exact = chk.bit_diff((got[2], got[0], got[1]),
                         (want[2], want[0], want[1]))
    out["tspace_ties_and_grazes"]["vs_exact"] = exact
    require(not any(exact.values()), "intersect misses the exact answers "
            f"of tspace_ties_and_grazes: {exact}")
    for name, res in out.items():
        require(res["ok"], f"intersect disagrees on {name}: {res}")
    return out


def training_rays(rt, torch, scene, cam, pixel_ids, spp, bounces):
    """The tiled engine's real rays: primary rays of ``pixel_ids`` x spp,
    then ``bounces`` steps of the engine -> [(origin, direction), ...] at
    bounce 0 and after the last step."""
    import importlib

    from raytracinginoneweekend_tpu_torch.ops import integrate

    prender = importlib.import_module(
        "raytracinginoneweekend_tpu_torch.render")
    pids = torch.repeat_interleave(pixel_ids, spp)
    sids = torch.arange(spp, dtype=torch.int32,
                        device=pixel_ids.device).repeat(pixel_ids.shape[0])
    with torch.no_grad():
        o, d, keys = prender.make_primary_rays(
            cam, pids, sids, rt.key_words(0), TRAIN["width"],
            TRAIN["height"], "thinlens")
        out = [(o.contiguous(), d.contiguous())]
        state = integrate._init_state(o, d, keys)
        options = dataclasses.replace(rt.DEFAULT, intersect="pallas")
        for b in range(bounces):
            state = integrate._bounce_step(scene, options, state, b,
                                           allow_pallas=True)
        out.append((state[0].contiguous(), state[1].contiguous()))
    return out


def planar_training_planes(rt, torch, scene, cam, pixel_ids, spp, bounces):
    """The planar AD engine's own ray planes, as trace_planar hands them to
    closest_hit: the camera rays of ``pixel_ids`` x spp on (R, 128) planes,
    then ``bounces`` steps of the engine -> [6 planes, ...] at bounce 0 and
    after the last step."""
    from raytracinginoneweekend_tpu_torch.ops import integrate_planar as ip
    from raytracinginoneweekend_tpu_torch.ops import planar

    dev = pixel_ids.device
    pid = torch.repeat_interleave(pixel_ids, spp).reshape(-1, ip.LANES)
    sid = torch.arange(spp, dtype=torch.int32, device=dev).repeat(
        pixel_ids.shape[0]).reshape(-1, ip.LANES)
    with torch.no_grad():
        *rays, rk0, rk1 = planar.camera_rays(
            cam, pid, sid, rt.key_words(0), TRAIN["width"], TRAIN["height"],
            "thinlens", sampling="iid", spp=spp)
        one, zero = torch.ones_like(rays[0]), torch.zeros_like(rays[0])
        state = (*rays, one, one, one, zero, zero, zero, one > 0, rk0, rk1)
        out = [tuple(rays)]
        table = ip._material_table(scene)
        for b in range(bounces):
            khit = ip.closest_hit_planar(state[:6], (scene.centers,
                                                     scene.radii),
                                         rt.DEFAULT.t_min)
            state = ip._shade_step_planar(table, rt.DEFAULT, state, khit, b)
        out.append(tuple(p.contiguous() for p in state[:6]))
    return out


def closest_hit_train_shape(rt, torch):
    """closest_hit as the training path launches it: every lane of the
    planar engine's (1024, 128) ray planes, no active plane, the table
    built by the wrapper -- against its plain version, and timed."""
    from raytracinginoneweekend_tpu_torch import cli
    from raytracinginoneweekend_tpu_torch.ops import cuda_segment
    from raytracinginoneweekend_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", TRAIN["width"], TRAIN["height"], dev)
    t_min = rt.DEFAULT.t_min
    gen = torch.Generator(device="cpu").manual_seed(3)
    batch = torch.randperm(TRAIN["width"] * TRAIN["height"],
                           generator=gen)[:TRAIN["batch_pixels"]]
    planes = planar_training_planes(rt, torch, scene, cam,
                                    batch.to(torch.int32).to(dev),
                                    TRAIN["spp"], bounces=3)
    geom = cuda_segment.sphere_params_from_scene(scene)[:4]
    n_sph = geom[0].shape[0]
    out = {}
    for tag, rays in zip(("bounce_0", "after_3_bounces"), planes):
        res = compare_closest_hit(torch, rays, geom, t_min, None)
        del res["out"]
        require(res["ok"] and res["int_mismatch"] == 0, "closest_hit "
                f"disagrees on the training path's planes ({tag}): {res}")
        def run():
            cuda_segment.segment_closest_hit(rays, *geom, t_min)

        res["ms"] = cuda_time_ms(run, iters=20, queue_behind=True)
        res["call_ms"] = cuda_time_ms(run, iters=20)
        res["k_sweep"] = closest_hit_sweep(torch, rays, geom, t_min, None)
        res["plain_ms"] = cuda_time_ms(
            lambda: cuda_segment.segment_closest_hit_reference(
                rays, *geom, t_min, None), warmup=1, iters=3)
        lanes = rays[0].numel()
        t_ops = lanes * n_sph * CH_FLOPS_PER_SPHERE / PEAK_F32_FLOPS
        t_bytes = (lanes * 36 + n_sph * 16) / PEAK_BYTES_PER_S
        res.update(lanes=lanes, shape=list(rays[0].shape), spheres=n_sph,
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   **closest_hit_needed(rays, geom, None, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        out[tag] = res
    return out


def intersect_checks(rt, torch):
    """intersect on synthetic cases and on the tiled engine's real rays of
    the huge scene at the training path's two shapes (960000 and 131072
    rays), at bounce 0 and after three bounces: against its plain version,
    at every K bit-equal, and timed on the mid-path rays with its bounds."""
    from raytracinginoneweekend_tpu_torch import cli
    from raytracinginoneweekend_tpu_torch.closest_hit_checks import (
        disc_pairs)
    from raytracinginoneweekend_tpu_torch.ops.cuda_intersect import (
        closest_hit_cuda)
    from raytracinginoneweekend_tpu_torch.ops.intersect import closest_hit
    from raytracinginoneweekend_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", TRAIN["width"], TRAIN["height"], dev)
    t_min = rt.DEFAULT.t_min
    out = {f"synthetic_{k}": v
           for k, v in synthetic_intersect(torch, scene, t_min).items()}
    n_pix = TRAIN["width"] * TRAIN["height"]
    gen = torch.Generator(device="cpu").manual_seed(3)
    batch = torch.randperm(n_pix, generator=gen)[:TRAIN["batch_pixels"]]
    shapes = {
        n_pix: (torch.arange(n_pix, dtype=torch.int32, device=dev), 1),
        TRAIN["batch_pixels"] * TRAIN["spp"]: (
            batch.to(torch.int32).to(dev), TRAIN["spp"]),
    }
    n_sph = scene.centers.shape[0]
    geom = (*scene.centers.unbind(1), scene.radii)
    for n, (ids, spp) in shapes.items():
        rays = training_rays(rt, torch, scene, cam, ids, spp, bounces=3)
        for tag, (o, d) in zip(("", "_after_3_bounces"), rays):
            res, _ = compare_intersect(torch, o, d, scene.centers,
                                       scene.radii, t_min)
            require(res["ok"], f"intersect disagrees on real rays "
                    f"({n}{tag}): {res}")
            out[f"rays_{n}{tag}"] = res
        o, d = rays[1]  # mid-path rays: hits, misses and restarts mixed

        def run():
            closest_hit_cuda(o, d, scene.centers, scene.radii, t_min)

        res = out[f"rays_{n}"]
        res["ms"] = cuda_time_ms(run, iters=20, queue_behind=True)
        res["call_ms"] = cuda_time_ms(run, iters=20)
        res["plain_ms"] = cuda_time_ms(
            lambda: closest_hit(o, d, scene.centers, scene.radii, t_min),
            warmup=1, iters=3)
        t_ops = n * n_sph * IX_FLOPS_PER_SPHERE / PEAK_F32_FLOPS
        t_bytes = (n * IX_BYTES_PER_RAY + n_sph * 16) / PEAK_BYTES_PER_S
        res["bound_ms"] = max(t_ops, t_bytes) * 1e3
        res["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        n_gt, n_pairs = disc_pairs(tuple(o.unbind(1)) + tuple(d.unbind(1)),
                                   *geom, strict=True)
        res.update(needed_bound(n_pairs, n_gt, t_bytes,
                                hit_flops=IX_HIT_FLOPS, strict=True))
        res["k_sweep"] = intersect_sweep(torch, o, d, scene.centers,
                                         scene.radii, t_min, f"{n} rays")
    return out


# --------------------------------------------------------------------- #
# grad_vs_plain phase
# --------------------------------------------------------------------- #

def _rel_to_largest(got, want):
    """max |got - want| over the largest |want| (0 when both vanish)."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    norm = float(want.norm())
    d = (got - want).abs()
    return {"max_abs_err": err, "largest": scale,
            "rel_to_largest": err / scale if scale > 0 else err,
            "rel_l2": float(d.norm()) / norm if norm > 0
            else float(d.norm()),
            "share_beyond_1e-3_of_largest":
                float((d > 1e-3 * scale).float().mean()),
            "share_beyond_1e-2_of_largest":
                float((d > 1e-2 * scale).float().mean())}


def to_float64(scene, cam, params):
    """The scene's float leaves, the camera and the parameters in float64:
    the tiled engine then traces the same paths (the random draws stay the
    float32 ones) with float64 arithmetic -- the witness the two float32
    engines' gradients are held against."""
    import torch

    f64 = torch.float64
    scene = scene._replace(**{k: getattr(scene, k).to(f64) for k in (
        "centers", "radii", "albedo", "fuzz", "ior")})
    return (scene, type(cam)(*(t.to(f64) for t in cam)),
            {k: v.to(f64) for k, v in params.items()})


def engine_gradients_raw(torch, rt, params, scene, cam, target, ids, key,
                         engines=("planar", "tiled"), **kw):
    """render_loss gradients of two float32 engines (the planar engine and
    the tiled engine, or ``engines``) and the float64 witness (the tiled
    engine in float64) on the pixels where the three runs trace the same
    paths -> ({run: {leaf: gradient}}, counts of the pixels set aside).

    A path in a thousand crosses a t_min or a Schlick knife edge in one
    run only and then is another path; the renderer's own frame rule sets
    such pixels aside (at most 1%), and so does this comparison: the loss's
    cotangent is zeroed on them, in all three runs. Radiance alone does not
    find them all: a path that goes another way after many bounces carries
    little weight, its pixel stays inside the tolerance, and yet it can be
    most of the albedo gradient of a sphere that few paths of the batch
    see. So the two float32 engines are also compared with EVERY ALBEDO SET
    TO 1 (the same paths, albedo steers none; a path's radiance is then
    the sky it reaches, however deep), and a pixel that differs there holds
    a forked path (scripts/torch_grad_fork.py: 1 to 5 albedo elements beyond
    the tolerance in 17 of 60 seeded scenes without this probe, none in any
    of them with it).
    """
    from raytracinginoneweekend_tpu_torch import optim
    from raytracinginoneweekend_tpu_torch.optim import inverse

    held = {k: v.detach() for k, v in params.items()}
    ea, eb = engines
    runs = {ea: (ea, scene, cam, held), eb: (eb, scene, cam, held),
            "witness": ("tiled", *to_float64(scene, cam, held))}

    def frames(names, **leaves):
        with torch.no_grad():
            return {name: inverse._render_batch(
                optim.scene_with_params(sc, {**p, **leaves}), cm, ids, key,
                engine=e, **kw).to(torch.float32)
                for name, (e, sc, cm, p) in runs.items() if name in names}

    def near(a, b):
        return torch.isclose(a, b, rtol=1e-4, atol=3e-5).all(dim=-1)

    px = frames(runs)
    white = frames(engines, albedo=torch.ones_like(scene.albedo))
    apart = ~near(px[ea], px[eb])
    forked = ~apart & ~near(white[ea], white[eb])
    agree = ~apart & ~forked & near(px["witness"], px[eb])
    cot = 2.0 * (px[eb] - target) / target.numel() * agree[:, None]
    grads = {}
    for name, (e, sc, cm, p) in runs.items():
        p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        grads[name], _ = optim.render_pixels_vjp(
            p, sc, cm, cot, ids, key, engine=e, **kw)
    return grads, {"pixels": int(agree.numel()),
                   "knife_edge_pixels": int(apart.sum()),
                   "forked_path_pixels": int(forked.sum()),
                   "witness_knife_edge_pixels": int((~agree).sum()),
                   "engines": list(engines),
                   "pixels_bit_equal": bool(torch.equal(px[ea], px[eb])),
                   "pixels_max_abs_diff":
                       float((px[ea] - px[eb]).abs().max()),
                   "pixels_within_rtol_1e-4_atol_2e-5": bool(torch.allclose(
                       px[ea], px[eb], rtol=1e-4, atol=2e-5))}


def _spread(err, scale, live):
    """Quantiles of err / scale over the live elements."""
    import torch

    r = (err / scale.clamp_min(1e-300))[live]
    q = torch.quantile(r, torch.tensor([0.5, 0.9, 0.99], dtype=r.dtype,
                                       device=r.device))
    return {"median": float(q[0]), "p90": float(q[1]), "p99": float(q[2]),
            "max": float(r.max())}


def engine_gradients(torch, rt, params, scene, cam, target, ids, key,
                     engines=("planar", "tiled"), **kw):
    """The per-leaf record behind ``engine_gradients_agree``: the first
    engine (planar) against the second (tiled), and each against the
    float64 witness, element by element, every error over the size of its
    own row (one sphere's or one material's gradient: the witness's
    largest |element| there), so that the small spheres count as much as
    the ground. The keys keep the names planar / tiled for the first and
    second engine."""
    grads, pixels = engine_gradients_raw(
        torch, rt, params, scene, cam, target, ids, key, engines=engines,
        **kw)
    out = {}
    for k in params:
        p, t, w = (grads[e][k].to(torch.float64).reshape(
            grads[e][k].shape[0], -1) for e in (*engines, "witness"))
        scale = w.abs().amax(dim=1, keepdim=True).expand_as(w)
        live = scale > 0
        res = _rel_to_largest(p, t)
        res["finite"] = bool(torch.isfinite(p).all()
                             and torch.isfinite(t).all())
        res["elements"] = int(live.sum())
        res["planar_vs_tiled"] = _spread((p - t).abs(), scale, live)
        res["tiled_vs_witness"] = _spread((t - w).abs(), scale, live)
        res["planar_vs_witness"] = _spread((p - w).abs(), scale, live)
        own = t.abs().amax(dim=1, keepdim=True)
        res["elements_beyond_rtol_1e-3_atol_1e-2_of_row"] = int(
            ((p - t).abs() > 1e-3 * t.abs() + 1e-2 * own).sum())
        out[k] = res
    return out, pixels


def engine_gradients_agree(leaf: str, res: dict) -> bool:
    """The bar for one leaf of ``engine_gradients`` (see the tolerances in
    the module's docstring)."""
    pt, tw, pw = (res[k] for k in ("planar_vs_tiled", "tiled_vs_witness",
                                   "planar_vs_witness"))
    ok = res["finite"] and res["largest"] > 0 and res["elements"] > 0
    for q in ("median", "p90"):
        ok = ok and pt[q] <= 0.25 * tw[q] and pw[q] <= 2.0 * tw[q]
    if leaf == "albedo":
        ok = (ok and res["rel_to_largest"] <= 1e-4
              and res["elements_beyond_rtol_1e-3_atol_1e-2_of_row"] == 0)
    return ok


def engine_pixels_agree(px: dict):
    """[(condition, message)] for the pixels ``engine_gradients`` set
    aside: the frame rule's 1% between the two float32 engines, as many
    again whose radiance agrees but which hold a forked path (read on an
    NVIDIA H100 over 60 seeded batches of 16384 pixels: 30 to 81 and 54 to
    134), 10% in all with those that differ from the float64 witness
    (whose t_min window on the r = 1000 ground sphere falls on other
    restarts than float32's)."""
    n = px["pixels"]
    return [(px["knife_edge_pixels"] <= 0.01 * n,
             f"{px['knife_edge_pixels']} of {n} pixels differ between the "
             "planar and the tiled engine"),
            (px["forked_path_pixels"] <= 0.01 * n,
             f"{px['forked_path_pixels']} of {n} pixels hold a path that "
             "the planar and the tiled engine trace differently"),
            (px["witness_knife_edge_pixels"] <= 0.10 * n,
             f"{px['witness_knife_edge_pixels']} of {n} pixels differ "
             "between the float32 engines and the float64 witness")]


def closest_hit_grads(torch, fn, o, d, centers, radii, cot):
    """d sum(cot * t) / d (origin, direction, centers, radii) through
    ``fn(o, d, centers, radii) -> (t, hit)``."""
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (o, d, centers, radii)]
    t, hit = fn(*leaves)
    torch.sum(torch.where(hit, t, torch.zeros_like(t)) * cot).backward()
    return [x.grad for x in leaves]


def grad_vs_plain_phase(rt, torch, nvidia_smi: str):
    from raytracinginoneweekend_tpu_torch import cli, kernels, optim
    from raytracinginoneweekend_tpu_torch.ops import integrate_planar
    from raytracinginoneweekend_tpu_torch.ops import intersect
    from raytracinginoneweekend_tpu_torch.utils.timing import cuda_time_ms

    dev = torch.device("cuda")
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", TRAIN["width"], TRAIN["height"], dev)
    t_min = rt.DEFAULT.t_min
    n_pix = TRAIN["width"] * TRAIN["height"]
    gen = torch.Generator(device="cpu").manual_seed(5)
    n = GRAD["rays"]
    ids = torch.randperm(n_pix, generator=gen)[:n // TRAIN["spp"]]
    rays = training_rays(rt, torch, scene, cam,
                         ids.to(torch.int32).to(dev), TRAIN["spp"],
                         bounces=2)
    out = {}
    launches0 = dict(kernels.LAUNCHES)
    for tag, (o, d) in zip(("bounce_0", "after_2_bounces"), rays):
        # cotangent: random, zero on grazing rays (see the tolerances)
        with torch.no_grad():
            t, idx, hit = intersect.closest_hit(o, d, scene.centers,
                                                scene.radii, t_min)
            p, nrm = intersect.hit_surface(o, d, t, idx, hit,
                                           scene.centers, scene.radii)
            cos = (nrm * d).sum(-1) / d.norm(dim=-1)
            keep = hit & (cos.abs() > 0.05)
        cot = torch.rand(n, generator=gen).to(dev) * keep

        def plain(o_, d_, c_, r_):
            t_, _i, h_ = intersect.closest_hit(o_, d_, c_, r_, t_min)
            return t_, h_

        def diff(o_, d_, c_, r_):
            t_, _i, h_ = intersect.closest_hit_diff(o_, d_, c_, r_, t_min,
                                                    use_pallas=True)
            return t_, h_

        def planar(o_, d_, c_, r_):
            planes = tuple(o_[:, k].reshape(-1, 128) for k in range(3)) \
                + tuple(d_[:, k].reshape(-1, 128) for k in range(3))
            t_, _sb, hit_i = integrate_planar.closest_hit_planar(
                planes, (c_, r_), t_min)
            return t_.reshape(-1), hit_i.reshape(-1) > 0

        want = closest_hit_grads(torch, plain, o, d, scene.centers,
                                 scene.radii, cot)
        for name, fn in (("closest_hit_diff", diff),
                         ("closest_hit_planar", planar)):
            got = closest_hit_grads(torch, fn, o, d, scene.centers,
                                    scene.radii, cot)
            res = {k: _rel_to_largest(g, w) for k, g, w in zip(
                ("origin", "direction", "centers", "radii"), got, want)}
            res["rays"] = n
            res["rays_with_cotangent"] = int(keep.sum())
            out[f"{name}_{tag}"] = res
    torch.cuda.synchronize()
    used = {k: kernels.LAUNCHES[k] - launches0[k]
            for k in ("closest_hit", "intersect")}
    require(used["closest_hit"] >= 2 and used["intersect"] >= 2,
            f"the Functions' forwards did not launch the kernels: {used}")

    # the backward's per-sphere sum, both ways, at the step's shape
    n_step = TRAIN["batch_pixels"] * TRAIN["spp"]
    with torch.no_grad():
        big = training_rays(
            rt, torch, scene, cam,
            torch.randperm(n_pix, generator=gen)[:TRAIN["batch_pixels"]]
            .to(torch.int32).to(dev), TRAIN["spp"], bounces=2)[1]
        _t, idx, _h = intersect.closest_hit_diff(
            *big, scene.centers, scene.radii, t_min, use_pallas=True)
    idx64 = idx.to(torch.int64)
    rows = torch.rand(n_step, 4, generator=gen).to(dev)
    n_sph = scene.centers.shape[0]
    sphere_ids = torch.arange(n_sph, device=dev)

    def by_index_add():  # the port's: a float64 accumulator, rounded once
        return intersect.sum_by_winner(idx64, rows, n_sph)

    def by_index_add_f32():  # a float32 running sum, for comparison
        return torch.zeros((n_sph, 4), device=dev).index_add_(0, idx64, rows)

    def by_onehot_matmul():
        onehot = (idx64[:, None] == sphere_ids[None, :]).to(torch.float32)
        return onehot.T @ rows

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    sums = {"rays": n_step, "spheres": n_sph,
            "share_of_rays_on_sphere_0": float((idx64 == 0).float().mean()),
            "forms_agree": _rel_to_largest(by_index_add(),
                                           by_onehot_matmul()),
            "f32_sum_vs_f64": _rel_to_largest(by_index_add_f32(),
                                              by_index_add())}
    sums["index_add_ms"] = cuda_time_ms(by_index_add, iters=20,
                                        queue_behind=True)
    sums["index_add_f32_ms"] = cuda_time_ms(by_index_add_f32, iters=20,
                                            queue_behind=True)
    sums["onehot_matmul_ms"] = cuda_time_ms(by_onehot_matmul, iters=20,
                                            queue_behind=True)
    torch.backends.cuda.matmul.allow_tf32 = tf32

    # render_loss gradients, planar against tiled, per leaf
    w, h = GRAD["width"], GRAD["height"]
    cam_s = cli._build_camera("cpu", w, h, dev)
    ids = torch.arange(w * h, dtype=torch.int32, device=dev)
    target = torch.rand(w * h, 3, generator=gen).to(dev)
    kw = dict(width=w, height=h, spp=GRAD["spp"], max_depth=GRAD["depth"],
              camera_mode="thinlens", options=rt.DEFAULT)
    leaf, px = engine_gradients(
        torch, rt, optim.params_from_scene(scene), scene, cam_s, target,
        ids, rt.key_words(1), **kw)
    emit({"phase": "grad_vs_plain", "card": nvidia_smi,
          "closest_hit_functions": out, "per_sphere_sum": sums,
          "render_loss": {"width": w, "height": h, "spp": GRAD["spp"],
                          "depth": GRAD["depth"], **px, "leaves": leaf}})
    for name, res in out.items():
        for k in ("origin", "direction", "centers", "radii"):
            require(res[k]["rel_to_largest"] <= 2e-3 and res[k]["largest"]
                    > 0, f"{name}: gradient of {k} differs from plain "
                    f"autograd: {res[k]}")
    require(sums["forms_agree"]["rel_to_largest"] <= 1e-5,
            f"index_add_ and the one-hot product disagree: {sums}")
    for cond, what in engine_pixels_agree(px):
        require(cond, what)
    for k, res in leaf.items():
        require(engine_gradients_agree(k, res),
                f"render_loss gradient of {k}, planar vs tiled: {res}")
    return sums


# --------------------------------------------------------------------- #
# frame phases
# --------------------------------------------------------------------- #

def render(rt, torch, options, *, width, height, spp, depth,
           pool_size=1 << 15, plain=False, stats=False, scene=None,
           cam=None, graph=True):
    from raytracinginoneweekend_tpu_torch import cli

    dev = torch.device("cuda")
    scene = scene or cli._build_scene("huge", 0, dev)
    cam = cam or cli._build_camera("cpu", width, height, dev)
    return rt.render_wavefront(
        scene, cam, rt.key_words(0), width=width, height=height, spp=spp,
        max_depth=depth, camera_mode="thinlens", options=options,
        pool_size=pool_size, plain=plain, return_stats=stats, graph=graph,
        device=dev)


def render_dual(rt, torch, options, *, width, height, spp, depth,
                pool_size=DUAL_POOL_DEFAULT, plain=False, metrics=False,
                scene=None, cam=None):
    from raytracinginoneweekend_tpu_torch import cli
    from raytracinginoneweekend_tpu_torch.ops import wavefront_dual

    dev = torch.device("cuda")
    scene = scene or cli._build_scene("huge", 0, dev)
    cam = cam or cli._build_camera("cpu", width, height, dev)
    return wavefront_dual.render_wavefront_dual(
        scene, cam, rt.key_words(0), width=width, height=height, spp=spp,
        max_depth=depth, camera_mode="thinlens", options=options,
        pool_size=pool_size, plain=plain, with_metrics=metrics, device=dev)


def coherent_variants(rt):
    """The single pool's options of this slice -> {name: TraceOptions}."""
    rep = dataclasses.replace
    return {
        "tile": rep(rt.DEFAULT, ownership="tile"),
        "sorted": rep(rt.DEFAULT, hit_kernel="sorted"),
        "sorted_tile": rep(rt.DEFAULT, hit_kernel="sorted",
                           ownership="tile"),
        "fusion_off": rep(rt.DEFAULT, mega="off"),
        "fusion_off_tile": rep(rt.DEFAULT, mega="off", ownership="tile"),
        "fusion_off_sorted_tile": rep(rt.DEFAULT, mega="off",
                                      hit_kernel="sorted",
                                      ownership="tile"),
        "mxu": rep(rt.DEFAULT, hit_kernel="mxu"),
        "fusion_off_mxu": rep(rt.DEFAULT, mega="off", hit_kernel="mxu"),
    }


def mxu_frame_share(img, ref) -> float:
    """The measure of the JAX package's own rule for an mxu frame against
    the default frame (tests/test_wavefront.py): the share of pixels more
    than 1e-3 away, relative with a floor of 1e-3."""
    err = (img - ref).abs() / (ref.abs() + 1e-3)
    return float((err.amax(dim=-1) > 1e-3).float().mean())


# The mxu kernel's frame. The JAX package asks for at most 1% of pixels
# beyond 1e-3 of the default frame on 24x16 frames at depth 6; the regrouped
# c of the r = 1000 ground sphere moves t of every restart there by ~1e-4
# (closest_hit_mxu's p99 against closest_hit), which chaotic paths amplify
# with depth. The frames are deterministic; read on an NVIDIA H100 80GB HBM3
# (four runs, the same numbers each): at 240x160, 8 spp, depth 12, 2.30% of
# pixels beyond 1e-3 of the default frame (the default frame sits 0.55% from
# its own plain frame by that measure), and 389 of 38400 pixels (1.01%)
# outside the frame rule's tolerance against the mxu engine's own plain
# frame; at the JAX package's shape 4 of 384 pixels (1.04%). The limits
# leave a toolchain's other rounding of sinf/cosf room and no more: 3% and
# 2%. What holds the KERNEL over a whole frame is bit-equality of the
# unfused mxu frame with the plain mxu frame (``coherent_frames``).
MXU_FRAME_SHARE = 0.03
MXU_PLAIN_SHARE = 0.02


def coherent_frames(rt, torch, default_img, plain_img):
    """This slice's engines at the small frame.

    What must agree to the bit on the card, and with what (every camera
    ray and bounce draw comes from kernel 2's one arithmetic: its fused,
    shade-only and regen-only entries):
      * the sorted kernel, under either ownership, with the default frame;
      * tile ownership with strided ownership, iid and stratified, through
        the kernels and between ``plain=True`` frames;
      * the unfused step (regen-only, closest hit, shade-only), under
        either ownership and with the sublane or sorted kernel, with the
        default frame, and with the mxu kernel with the fused mxu frame;
      * the mxu kernel with its plain version on every lane of every
        iteration of a whole frame (``mxu_frame_against_plain``).
    The mxu kernel's fused frame: against its plain frame by
    ``MXU_PLAIN_SHARE`` and against the default frame by
    ``MXU_FRAME_SHARE`` at this frame, and by the JAX package's own 1% at
    the shape where the JAX package holds it (``mxu_at_jax_shape``). The
    dual-pool engine: its kernels against its plain versions (bit-equal
    closest hits, plain shading either way) and against the plain single
    pool, under the frame rule. The ownerships and the sorted kernel again
    on the wall scene (the sorted kernel's own workload).
    """
    from raytracinginoneweekend_tpu_torch import cli, kernels
    from raytracinginoneweekend_tpu_torch.golden import compare_frames

    dev = torch.device("cuda")
    variants = coherent_variants(rt)
    out = {}

    def held(img, ref, exact: bool, before=None):
        res = compare_frames(img.cpu().numpy(), ref.cpu().numpy())
        res["bit_equal"] = bool(torch.equal(img, ref))
        res["must_be_bit_equal"] = exact
        if before is not None:
            res["launches"] = {k: v - before[k]
                               for k, v in kernels.LAUNCHES.items()
                               if v != before[k]}
        return res

    plain_mxu = render(rt, torch, variants["mxu"], plain=True, **SMALL)
    mxu_img = None
    for name, options in variants.items():
        before = dict(kernels.LAUNCHES)
        img = render(rt, torch, options, **SMALL)
        if name == "fusion_off_mxu":
            out[name + "_vs_mxu"] = held(img, mxu_img, True, before)
        elif name.startswith("fusion_off"):
            out[name + "_vs_default"] = held(img, default_img, True, before)
        elif name == "mxu":
            mxu_img = img
            # The two frames differ only through shade_regen's sinf/cosf
            # ulps, as the default frame does from its plain frame, but the
            # regrouped arithmetic amplifies them on the ground sphere.
            res = held(img, plain_mxu, False, before)
            res["frame_rule_ok"] = res["ok"]
            res["ok"] = (bool(torch.isfinite(img).all()) and res["n_bad"]
                         <= MXU_PLAIN_SHARE * res["n_pixels"])
            out["mxu_vs_plain_mxu"] = res
            share = mxu_frame_share(img, default_img)
            out["mxu_vs_default"] = {
                "share_beyond_1e-3": share, "ok": share <= MXU_FRAME_SHARE,
                # the same measure between the default frame and ITS plain
                # frame: what shade_regen's ulps alone do
                "share_beyond_1e-3_default_vs_plain_default":
                    mxu_frame_share(default_img, plain_img),
                "frame_rule": compare_frames(img.cpu().numpy(),
                                             default_img.cpu().numpy())}
        else:
            out[name + "_vs_default"] = held(img, default_img, True, before)
    out["mxu_kernel_vs_plain_every_iteration"] = mxu_frame_against_plain(
        rt, torch, variants["mxu"], **SMALL)
    out["mxu_at_jax_shape"] = mxu_at_jax_shape(rt, torch)
    # One arithmetic for every camera ray: the ownerships agree to the bit,
    # through the kernels and between plain frames. Stratified sampling
    # reads the pixel of the CURRENT task at bounce 0, the tile de-swizzle
    # inside the stratified branch.
    strat = dataclasses.replace(rt.DEFAULT, sampling="stratified",
                                rr_terminate=True)
    strat_tile = dataclasses.replace(strat, ownership="tile")
    out["plain_tile_vs_plain_default"] = held(
        render(rt, torch, variants["tile"], plain=True, **SMALL), plain_img,
        True)
    out["plain_stratified_rr_tile_vs_strided"] = held(
        render(rt, torch, strat_tile, plain=True, **SMALL),
        render(rt, torch, strat, plain=True, **SMALL), True)
    out["stratified_rr_tile_vs_strided"] = held(
        render(rt, torch, strat_tile, **SMALL),
        render(rt, torch, strat, **SMALL), True)
    dual_k, met = render_dual(rt, torch, rt.DEFAULT, metrics=True, **SMALL)
    dual_p = render_dual(rt, torch, rt.DEFAULT, plain=True, **SMALL)
    out["dual_vs_plain_dual"] = held(dual_k, dual_p, False)
    out["dual_vs_plain_single_pool"] = held(dual_k, plain_img, False)
    out["dual_vs_single_pool"] = held(dual_k, default_img, False)
    out["dual_metrics"] = met
    # the wall scene, as the JAX package's test of it frames it
    w, h = SMALL["width"], SMALL["height"]
    scene = cli._build_scene("wall", 0, dev)
    cam = rt.make_camera((0.0, 11.0, 4.0), (0.0, 11.0, 0.0), (0, 1, 0),
                         w / h, 60.0, 0.0, 4.0, device=dev)
    kw = dict(width=w, height=h, spp=4, max_depth=4, camera_mode="pinhole",
              pool_size=1 << 15, device=dev)

    def wall(options, plain=False):
        return rt.render_wavefront(scene, cam, rt.key_words(1),
                                   options=options, plain=plain, **kw)

    base = wall(rt.DEFAULT)
    out["wall_sorted_vs_default"] = held(wall(variants["sorted"]), base,
                                         True)
    for name in ("tile", "sorted_tile"):
        out[f"wall_{name}_vs_default"] = held(wall(variants[name]), base,
                                              True)
    out["wall_plain_tile_vs_plain_default"] = held(
        wall(variants["tile"], plain=True), wall(rt.DEFAULT, plain=True),
        True)
    return out


def mxu_frame_against_plain(rt, torch, options, **frame):
    """Render one frame through the mxu kernel (eagerly) with its plain
    version run beside it on the same rays in EVERY iteration -> the
    active lane-iterations and those where the two disagree in hit,
    sphere or the bits of t. The mxu kernel's whole-frame check: the
    plain version does the kernel's float32 operations in its order. The
    engine's closest hit is replaced by name for the frame; that it ran
    at every iteration is required."""
    from raytracinginoneweekend_tpu_torch.ops import cuda_segment as seg
    from raytracinginoneweekend_tpu_torch.ops import wavefront

    dev = torch.device("cuda")
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    kernel = wavefront.closest_hit_planar
    calls = [0]

    def both(rays, cx, cy, cz, r, t_min, active=None, **kw):
        calls[0] += 1
        hk, tk, sk = kernel(rays, cx, cy, cz, r, t_min, active=active, **kw)
        hp, tp, sp = seg.segment_closest_hit_mxu_reference(
            rays, cx, cy, cz, r, t_min, active)
        act = active > 0
        differ = act & ((hk != hp) | (sk != sp)
                        | (tk.view(torch.int32) != tp.view(torch.int32)))
        counts.add_(torch.stack([act.sum(), differ.sum()]))
        return hk, tk, sk

    wavefront.closest_hit_planar = both
    try:
        _, st = render(rt, torch, options, graph=False, stats=True, **frame)
    finally:
        wavefront.closest_hit_planar = kernel
    require(calls[0] == st["iters"] > 0,
            f"mxu frame: the compared closest hit ran {calls[0]} times in "
            f"{st['iters']} iterations")
    lanes, differ = (int(v) for v in counts.tolist())
    return {"active_lane_iterations": lanes, "lanes_differing": differ,
            "iterations": st["iters"],
            "ok": lanes > 0 and differ == 0, "must_be_bit_equal": False}


def mxu_at_jax_shape(rt, torch):
    """The mxu kernel's frame against the sublane kernel's at the shape
    where the JAX package holds its own (tests/test_wavefront.py: huge
    scene, 24x16, 4 spp, depth 6, key 7, fused and unfused step) by its
    measure, pixels more than 1e-3 away. The JAX package allows itself 1%,
    3 of these 384 pixels; the port's regrouped float32 arithmetic reads 4
    on an NVIDIA H100 (1.04%, either step), one more, and is held to
    ``MXU_FRAME_SHARE`` as at the larger frame."""
    from raytracinginoneweekend_tpu_torch import cli

    dev = torch.device("cuda")
    w, h = 24, 16
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", w, h, dev)
    kw = dict(width=w, height=h, spp=4, max_depth=6, camera_mode="thinlens",
              pool_size=1 << 12, device=dev)
    out = {"ok": True}
    for mega in ("fused", "off"):
        base = dataclasses.replace(rt.DEFAULT, mega=mega)
        a, b = (rt.render_wavefront(scene, cam, rt.key_words(7), options=o,
                                    **kw)
                for o in (base, dataclasses.replace(base, hit_kernel="mxu")))
        share = mxu_frame_share(b, a)
        out[mega] = {"share_beyond_1e-3": share, "pixels": w * h,
                     "within_the_jax_packages_1_percent": share <= 0.01}
        out["ok"] = out["ok"] and bool(torch.isfinite(b).all()) \
            and share <= MXU_FRAME_SHARE
    return out


def require_coherent_frames(frames: dict) -> None:
    for name, res in frames.items():
        if name == "dual_metrics":
            continue
        require(res["ok"], f"{name}: the frames are too far apart: {res}")
        if res.get("must_be_bit_equal"):
            require(res["bit_equal"], f"{name}: the frames are not "
                    f"bit-equal: {res}")


def tiled_modes(rt, torch):
    """The tiled engine on the card in each camera mode, the intersect
    kernel against the plain closest hit ("cuda" and "pinhole" hand the
    engine one origin expanded over the rays, not dense rows)."""
    import importlib

    from raytracinginoneweekend_tpu_torch import cli, kernels
    from raytracinginoneweekend_tpu_torch.golden import compare_frames

    prender = importlib.import_module(
        "raytracinginoneweekend_tpu_torch.render")
    dev = torch.device("cuda")
    w, h = SMALL["width"], SMALL["height"]
    out = {}
    for mode, scn, camn, preset in (
            ("thinlens", "huge", "cpu", rt.DEFAULT),
            ("pinhole", "huge", "cpu", rt.DEFAULT),
            ("cpu", "huge", "cpu", rt.REFERENCE_CPU),
            ("cuda", "simple-cuda", "cuda", rt.REFERENCE_CUDA)):
        scene = cli._build_scene(scn, 0, dev)
        cam = cli._build_camera(camn, w, h, dev)
        frames = {}
        before = kernels.LAUNCHES["intersect"]
        for how in ("pallas", "jnp"):
            cfg = rt.RenderConfig(
                width=w, height=h, spp=4, max_depth=8, camera_mode=mode,
                options=dataclasses.replace(preset, intersect=how))
            frames[how] = prender.render(scene, cam, cfg, rt.key_words(0),
                                         device=dev)
        res = compare_frames(frames["pallas"].reshape(-1, 3).cpu().numpy(),
                             frames["jnp"].reshape(-1, 3).cpu().numpy())
        res["intersect_launches"] = kernels.LAUNCHES["intersect"] - before
        res["max_abs_diff"] = float((frames["pallas"]
                                     - frames["jnp"]).abs().max())
        out[mode] = res
    return out


def frame_vs_plain_phase(rt, torch, nvidia_smi: str):
    from raytracinginoneweekend_tpu_torch.golden import compare_frames

    img_k, st_k = render(rt, torch, rt.DEFAULT, stats=True, **SMALL)
    img_p, st_p = render(rt, torch, rt.DEFAULT, stats=True, plain=True,
                         **SMALL)
    cmp = compare_frames(img_k.cpu().numpy(), img_p.cpu().numpy())
    seg_rel = abs(st_k["segments"] - st_p["segments"]) / st_p["segments"]
    res = {"phase": "frame_vs_plain", "card": nvidia_smi, **SMALL,
           "kernels": st_k, "plain": st_p, "compare": cmp,
           "segments_rel_diff": seg_rel,
           "mean": float(img_k.mean()), "tiled_modes": tiled_modes(rt, torch),
           "coherent": coherent_frames(rt, torch, img_k, img_p)}
    emit(res)
    require_coherent_frames(res["coherent"])
    for mode, r in res["tiled_modes"].items():
        require(r["ok"] and r["intersect_launches"] > 0,
                f"tiled engine, camera mode {mode}: the kernel's frame "
                f"differs from the plain closest hit's: {r}")
    require(cmp["ok"], f"kernel frame differs from plain frame: {cmp}")
    require(st_k["iters"] == st_p["iters"], "iters differ")
    require(seg_rel <= 5e-3, f"segments differ by {seg_rel}")
    return float(img_k.mean())


# the main path's frame against the port's scalar oracle (frame_vs_golden):
# (scene, width, height, spp, depth, seed); the huge scene at the golden
# crop, where the 1% rule has room for its knife edges
ORACLE_FRAMES = (("simple-cpu", 24, 16, 4, 8, 0), ("huge", 32, 24, 2, 6, 0))
ORACLE_CAM = dict(position=(-4.0, 3.2, 5.0), lookat=(0.0, 1.0, 0.0),
                  up=(0.0, 1.0, 0.0), vfov=42.0, aperture=0.0625,
                  focus=math.dist((-4.0, 3.2, 5.0), (0.0, 1.0, 0.0)))


def oracle_frames(rt, torch) -> dict:
    """The main path (render_wavefront, default options, thin lens) on the
    card against the port's oracle on the host -> {name: record}."""
    from raytracinginoneweekend_tpu_torch import golden, kernels
    from raytracinginoneweekend_tpu_torch.models import camera
    from raytracinginoneweekend_tpu_torch.models import scene as scenes
    from raytracinginoneweekend_tpu_torch.oracle import render_oracle

    dev = torch.device("cuda")
    out = {}
    for name, w, h, spp, depth, seed in ORACLE_FRAMES:
        scn = (scenes.simple_scene_cpu(dev) if name == "simple-cpu"
               else scenes.huge_scene(seed, dev))
        c = ORACLE_CAM
        cam = camera.make_camera(c["position"], c["lookat"], c["up"], w / h,
                                 c["vfov"], c["aperture"], c["focus"],
                                 device=dev)
        kernels.reset_launches()
        got = rt.render_wavefront(
            scn, cam, rt.key_words(seed), width=w, height=h, spp=spp,
            max_depth=depth, camera_mode="thinlens", options=rt.DEFAULT,
            pool_size=4096, device=dev)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        want = render_oracle(scn, c, w, h, spp, depth, rt.key_words(seed),
                             camera_mode="thinlens", options=rt.DEFAULT)
        oracle_s = time.perf_counter() - t0
        atol = 5e-4 if name == "huge" else 3e-5
        out[f"{name}_{w}x{h}_{spp}spp_d{depth}"] = dict(
            golden.compare_frames(got.cpu().numpy(), want, atol=atol),
            atol=atol, oracle_seconds=oracle_s,
            launches={k: v for k, v in launches.items() if v})
    return out


def frame_vs_golden_phase(rt, torch, nvidia_smi: str):
    from raytracinginoneweekend_tpu_torch import golden

    out = {}
    for name in golden.GOLDEN_NAMES:
        want, flags = golden.load_golden(name)
        got = golden.render_golden(flags, device=torch.device("cuda"))
        atol = 5e-4 if flags["scene"] == "huge" else 3e-5
        out[name] = dict(golden.compare_frames(got.cpu().numpy(), want,
                                               atol=atol), atol=atol)
    oracle = oracle_frames(rt, torch)
    emit({"phase": "frame_vs_golden", "card": nvidia_smi, "frames": out,
          "against_oracle": oracle})
    for name, cmp in out.items():
        require(cmp["ok"], f"{name}: the card's frame differs from the "
                f"JAX-made golden frame: {cmp}")
    for name, cmp in oracle.items():
        require(cmp["ok"], f"{name}: the card's frame differs from the "
                f"port's scalar oracle: {cmp}")
        require(cmp["launches"].get("closest_hit", 0) > 0
                and cmp["launches"].get("shade_regen", 0) > 0,
                f"{name}: the frame did not go through the kernels: "
                f"{cmp['launches']}")


def require_fused_launches(launches: dict, iters: int, what: str) -> None:
    """The fused engine's frame: closest_hit and shade_regen once an
    iteration, regen_only once (the prologue), nothing else."""
    for name, n in launches.items():
        want = {"closest_hit": iters, "shade_regen": iters,
                "regen_only": 1}.get(name, 0)
        require(n == want and iters > 0,
                f"kernel {name} was launched {n} times on {what}; the "
                f"engine ran {iters} iterations and should launch it {want} "
                "times")


def epoch_host_us(rt, torch, pool: int) -> dict:
    """Host microseconds an iteration costs the main path's loop at
    ``pool``: one epoch enqueued eagerly, and one replay of its CUDA
    graph, each behind a long matrix product so that the host never waits
    for the card (best of three, divided by the epoch's iterations); and
    the programmatic (PDL) edges the captured graph kept, or None where
    this PyTorch cannot hand out the captured cudaGraph_t."""
    from raytracinginoneweekend_tpu_torch import kernels
    from raytracinginoneweekend_tpu_torch.ops import wavefront

    eng = make_engine(rt, torch, "huge", "cpu", "thinlens", rt.DEFAULT,
                      pool_size=pool, **{k: MAIN[k] for k in (
                          "width", "height", "spp", "depth")})
    ledger = wavefront.new_ledger(eng)
    state = wavefront.engine_epoch(eng, wavefront.engine_prologue(eng),
                                   ledger)
    before = dict(kernels.LAUNCHES)
    edges = None
    try:
        graph, _ = wavefront.capture_epoch(eng, state, ledger,
                                           keep_graph=True)
        edges = kernels.entry("rtw_graph_programmatic_edges")(
            graph.raw_cuda_graph())
    except TypeError:  # CUDAGraph(keep_graph=...) is newer than this torch
        graph, _ = wavefront.capture_epoch(eng, state, ledger)
    big = torch.ones((8192, 8192), device="cuda")

    def enqueue_s(fn) -> float:
        torch.cuda.synchronize()
        for _ in range(3):
            big @ big  # ~0.1 s of device work to hide behind
        t0 = time.perf_counter()
        fn()
        sec = time.perf_counter() - t0
        torch.cuda.synchronize()
        return sec

    per = 1e6 / eng.flush_every
    out = {"eager": per * min(enqueue_s(
               lambda: wavefront.engine_epoch(eng, state, ledger))
               for _ in range(3)),
           "graph": per * min(enqueue_s(graph.replay) for _ in range(3)),
           "programmatic_edges": edges}
    kernels.LAUNCHES.update(before)
    return out


def main_path_phase(rt, torch, nvidia_smi: str, small_mean, arm_spp: int):
    from raytracinginoneweekend_tpu_torch import cli, kernels
    from raytracinginoneweekend_tpu_torch.golden import compare_frames
    from raytracinginoneweekend_tpu_torch.utils.timing import time_fn

    w, h, spp, depth = (MAIN[k] for k in ("width", "height", "spp", "depth"))
    out_png = os.path.join(kernels.BUILD_DIR, "chip_smoke_cover.png")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    if os.path.exists(out_png):
        os.remove(out_png)
    argv = ["render", "--scene", "huge", "--width", str(w), "--height",
            str(h), "--spp", str(spp), "--depth", str(depth), "--stats",
            "--out", out_png]
    err, said = io.StringIO(), io.StringIO()
    kernels.reset_launches()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(said):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    require(rc == 0, f"cli render returned {rc}")
    stats = json.loads(err.getvalue().strip().splitlines()[-1])
    require(os.path.getsize(out_png) > 10000, "the PNG was not written")
    require_fused_launches(launches, stats["iters"], "the main path")

    dev = torch.device("cuda")
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", w, h, dev)
    rays = w * h * spp

    def timed(options, pool, n_spp, iters, graph=True):
        sec, img = time_fn(
            lambda: render(rt, torch, options, width=w, height=h, spp=n_spp,
                           depth=depth, pool_size=pool, scene=scene,
                           cam=cam, graph=graph),
            warmup=1, iters=iters, device=dev)
        return sec, img

    # the epoch replayed as a CUDA graph (the engine's default) against the
    # eager loop, in turns, at both pools: frames bit-equal, launches equal
    # to the iterations with the replays counted
    runs = {}
    images = {}
    for pool in (1 << 15, 1 << 20):
        host = epoch_host_us(rt, torch, pool)
        for graph in (True, False, True, False):
            key = f"pool_{pool}" + ("" if graph else "_eager")
            sec, img = timed(rt.DEFAULT, pool, spp, 1, graph)
            if key in runs:  # the second turn: keep the faster
                runs[key]["seconds_per_frame_turns"].append(sec)
                runs[key]["seconds_per_frame"] = min(
                    runs[key]["seconds_per_frame_turns"])
                continue
            kernels.reset_launches()
            _, st = render(rt, torch, rt.DEFAULT, width=w, height=h,
                           spp=spp, depth=depth, pool_size=pool,
                           scene=scene, cam=cam, stats=True, graph=graph)
            torch.cuda.synchronize()
            counted = dict(kernels.LAUNCHES)
            require_fused_launches(counted, st["iters"],
                                   f"the frame at pool {pool}, graph={graph}")
            images[(pool, graph)] = img
            runs[key] = {
                "graph": graph, "seconds_per_frame": sec,
                "seconds_per_frame_turns": [sec], **st,
                "occupancy": st["segments"] / (st["iters"] * st["lanes"]),
                "launches": counted, "mean": float(img.mean()),
                "host_us_per_iteration": host["graph" if graph
                                              else "eager"]}
        for graph in (True, False):
            r = runs[f"pool_{pool}" + ("" if graph else "_eager")]
            sec = r["seconds_per_frame"]
            r.update(camera_rays_per_s=rays / sec,
                     segments_per_s=r["segments"] / sec,
                     wall_us_per_iteration=sec / r["iters"] * 1e6)
        runs[f"pool_{pool}"]["graph_bit_equal_to_eager"] = bool(
            torch.equal(images[(pool, True)], images[(pool, False)]))
        runs[f"pool_{pool}"]["programmatic_edges_in_graph"] = host[
            "programmatic_edges"]
        require(runs[f"pool_{pool}"]["graph_bit_equal_to_eager"],
                f"pool {pool}: the replayed frame differs from the eager "
                "frame")
    require(runs[f"pool_{1 << 15}"]["iters"] == stats["iters"],
            "the CLI's run and the timed run took different iterations")
    images = {pool: images[(pool, True)] for pool in (1 << 15, 1 << 20)}
    img = images[1 << 15]
    require(bool(torch.isfinite(img).all()), "non-finite pixels")
    require(tuple(img.shape) == (w * h, 3), f"image shape {img.shape}")
    cmp = compare_frames(images[1 << 20].cpu().numpy(), img.cpu().numpy())
    require(cmp["ok"], f"pool sizes disagree: {cmp}")
    mean_diff = abs(float(img.mean()) - small_mean) \
        if small_mean is not None else None

    arms = {}
    rr = dataclasses.replace(rt.DEFAULT, rr_terminate=True)
    strat_rr = dataclasses.replace(rr, sampling="stratified")
    for name, options in (("rr_terminate", rr),
                          ("stratified_rr", strat_rr)):
        sec, aimg = timed(options, 1 << 15, arm_spp, 1)
        require(bool(torch.isfinite(aimg).all()), f"{name}: non-finite")
        arms[name] = {"spp": arm_spp, "seconds_per_frame": sec,
                      "camera_rays_per_s": w * h * arm_spp / sec,
                      "mean": float(aimg.mean()),
                      "mean_diff_vs_default":
                          abs(float(aimg.mean()) - float(img.mean()))}
        # an unbiased estimator change: the image mean must not move
        require(arms[name]["mean_diff_vs_default"] < 2e-3,
                f"{name}: image mean moved by "
                f"{arms[name]['mean_diff_vs_default']}")
    emit({"phase": "main_path", "card": nvidia_smi, **MAIN,
          "cli_stats": stats, "cli_said": said.getvalue().strip(),
          "launches": launches, "png": out_png,
          "runs": runs, "pool_compare": cmp,
          "mean_diff_vs_small_frame": mean_diff, "arms": arms,
          "arm_spp_cut": arm_spp != spp})
    if mean_diff is not None:
        require(mean_diff < MEAN_TOL, f"image mean differs from the small "
                f"frame's by {mean_diff}")
    return launches


# --------------------------------------------------------------------- #
# coherent_path phase
# --------------------------------------------------------------------- #

def cli_render(torch, name: str, flags: list, spp: int):
    """One full-width frame through the CLI with ``--stats`` -> (its
    stats, the launch counts of that run, seconds of the whole command)."""
    from raytracinginoneweekend_tpu_torch import cli, kernels

    w, h, depth = (MAIN[k] for k in ("width", "height", "depth"))
    out_png = os.path.join(kernels.BUILD_DIR, f"chip_smoke_{name}.png")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    if os.path.exists(out_png):
        os.remove(out_png)
    argv = ["render", "--scene", "huge", "--width", str(w), "--height",
            str(h), "--spp", str(spp), "--depth", str(depth), "--stats",
            "--out", out_png, *flags]
    err, said = io.StringIO(), io.StringIO()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(said):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    require(rc == 0, f"cli render {flags} returned {rc}")
    require(os.path.getsize(out_png) > 10000,
            f"{name}: the PNG was not written")
    stats = json.loads(err.getvalue().strip().splitlines()[-1])
    return stats, launches, seconds, argv


def sorted_frame_against_closest_hit(rt, torch, options, **frame):
    """Render one frame through the sorted kernel with closest_hit run
    beside it on the same rays in EVERY iteration -> lanes (summed over
    the frame) where the two disagree, how many of those are not an exact
    tie (same hit flag and bit-equal t, another sphere), and the kernel's
    own count of the chunk-stages its exit skipped over the frame."""
    from raytracinginoneweekend_tpu_torch.ops import cuda_segment as seg
    from raytracinginoneweekend_tpu_torch.ops import wavefront

    dev = torch.device("cuda")
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    chunks = torch.zeros(2, dtype=torch.int64, device=dev)
    sorted_kernel = wavefront.segment_closest_hit_sorted

    def both(rays, cx, cy, cz, r, sortstate, t_min, **kw):
        hk, tk, sk = sorted_kernel(rays, cx, cy, cz, r, sortstate, t_min,
                                   stats=chunks, **kw)
        h1, t1, s1 = seg.segment_closest_hit(rays, cx, cy, cz, r, t_min,
                                             active=kw["active"])
        differ = (hk != h1) | (sk != s1) | (tk.view(torch.int32)
                                            != t1.view(torch.int32))
        tie = (hk == h1) & (tk.view(torch.int32) == t1.view(torch.int32))
        counts.add_(torch.stack([(kw["active"] > 0).sum(), differ.sum(),
                                 (differ & ~tie).sum()]))
        return hk, tk, sk

    wavefront.segment_closest_hit_sorted = both
    try:  # eagerly: the kernel's stats= counter stays outside a graph
        img = render(rt, torch, options, graph=False, **frame)
    finally:
        wavefront.segment_closest_hit_sorted = sorted_kernel
    lanes, differ, not_tie = (int(v) for v in counts.tolist())
    skipped, total = (int(v) for v in chunks.tolist())
    return img, {"active_lane_iterations": lanes, "lanes_differing": differ,
                 "lanes_differing_not_on_an_exact_tie": not_tie,
                 "sorted_chunks_skipped": skipped, "sorted_chunks": total,
                 "share_skipped": skipped / max(total, 1)}


def plain_shading_frame(rt, torch, options, **frame):
    """A frame of the unrotated step with the closest-hit kernel and the
    plain versions of kernel 2's two halves (regen_reference,
    shade_update_reference), eagerly: the single pool shaded in the plain
    arithmetic that the dual-pool engine shades in. The engine's regen and
    shade are replaced by name for the frame; that both ran at every
    iteration is required."""
    from raytracinginoneweekend_tpu_torch.ops import cuda_fused, wavefront

    calls = {"regen": 0, "shade": 0}

    def regen(state, camvec, base_words, out=None, pdl=False, **kw):
        calls["regen"] += 1
        return cuda_fused.regen_reference(state, camvec, base_words, **kw)

    def shade(state, seg, table, base_words, out=None, pdl=False, **kw):
        calls["shade"] += 1
        cols = table.unbind(dim=1)
        params = wavefront.resolve_params(
            seg[2], cols[:4] + (cols[4].to(torch.int32),) + cols[5:])
        surf = cuda_fused.surface_from_params(tuple(state[4:10]), params,
                                              seg[0], seg[1])
        return cuda_fused.shade_update_reference(state, surf, base_words,
                                                 **kw)

    kept = wavefront.regen, wavefront.shade_update
    wavefront.regen, wavefront.shade_update = regen, shade
    try:
        img, st = render(rt, torch, options, graph=False, stats=True,
                         **frame)
    finally:
        wavefront.regen, wavefront.shade_update = kept
    require(calls["regen"] == calls["shade"] == st["iters"] > 0,
            f"plain shading frame: regen and shade ran {calls} times in "
            f"{st['iters']} iterations")
    return img


def coherent_path_phase(rt, torch, nvidia_smi: str):
    """This slice's path at full width: the dual-pool engine, the sorted
    kernel under both ownerships, the mxu kernel and the unfused step, each
    once through the CLI with the launch counts read around it, then (but
    for the cut run) once more in the process for its frame, which is held
    against the default frame."""
    from raytracinginoneweekend_tpu_torch import cli
    from raytracinginoneweekend_tpu_torch.golden import compare_frames
    from raytracinginoneweekend_tpu_torch.utils.timing import time_fn

    w, h, spp, depth = (MAIN[k] for k in ("width", "height", "spp", "depth"))
    dev = torch.device("cuda")
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", w, h, dev)
    variants = coherent_variants(rt)
    small, big = 1 << 15, 1 << 20
    frame = dict(width=w, height=h, depth=depth, scene=scene, cam=cam)

    def single(name, pool):
        return lambda: render(rt, torch, variants[name], spp=spp,
                              pool_size=pool, **frame)

    def once(fn):
        """One run, no warm-up (the slow engines): seconds by the host's
        clock around work that ends in a synchronise."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, img

    def twice(fn):
        return time_fn(fn, warmup=1, iters=1, device=dev)

    list_kernels = ("closest_hit_list", "closest_hit")
    # name -> (CLI flags, spp, kernels launched once per iteration, the
    #          frame in the process (None: the CLI run is the only one),
    #          the default frame's pool it is held against)
    runs = {
        "dual_pool_3m": (
            ["--engine", "wavefront-dual", "--pool-size", str(DUAL_POOL)],
            spp, list_kernels,
            lambda: once(lambda: render_dual(
                rt, torch, rt.DEFAULT, spp=spp, pool_size=DUAL_POOL,
                **frame)), big),
        "dual_default_pool_cut_spp": (
            ["--engine", "wavefront-dual", "--pool-size",
             str(DUAL_POOL_DEFAULT)],
            DUAL_SPP_AT_DEFAULT_POOL, list_kernels, None, None),
        "sorted_tile": (
            ["--hit-kernel", "sorted", "--ownership", "tile"], spp,
            ("closest_hit_sorted", "shade_regen"),
            lambda: twice(single("sorted_tile", small)), small),
        "sorted": (
            ["--hit-kernel", "sorted"], spp,
            ("closest_hit_sorted", "shade_regen"),
            lambda: twice(single("sorted", small)), small),
        "mxu": (
            ["--hit-kernel", "mxu"], spp, ("closest_hit_mxu", "shade_regen"),
            lambda: twice(single("mxu", small)), small),
        "fusion_off_pool_1m": (
            ["--fusion", "off", "--pool-size", str(big)], spp,
            ("closest_hit", "shade_only", "regen_only"),
            lambda: once(single("fusion_off", big)), big),
    }
    # the default single pool at both pool sizes: what the others are held
    # against (and timed beside, in the same process on the same card)
    base = {}
    for pool in (small, big):
        sec, img = twice(lambda: render(rt, torch, rt.DEFAULT, spp=spp,
                                        pool_size=pool, **frame))
        base[pool] = {"seconds_per_frame": sec, "image": img,
                      "camera_rays_per_s": w * h * spp / sec}
    out, launches_by_kernel, images = {}, {}, {}
    for name, (flags, n_spp, per_iter, in_process, pool) in runs.items():
        stats, launches, cli_seconds, argv = cli_render(torch, name, flags,
                                                        n_spp)
        iters = stats["iterations" if "iterations" in stats else "iters"]
        for k, n in launches.items():
            # the fused step's prologue is one regen-only launch
            want = iters if k in per_iter else int(
                k == "regen_only" and "shade_regen" in per_iter)
            require(n == want and iters > 0,
                    f"{name}: kernel {k} was launched {n} times; the engine "
                    f"ran {iters} iterations and should launch it {want} "
                    "times")
        for k in per_iter:
            launches_by_kernel.setdefault(k, launches[k])
        res = {"argv": argv, "spp": n_spp, "cli_stats": stats,
               "launches": launches,
               # the whole command: scene, frame, PNG
               "cli_seconds": cli_seconds}
        if in_process is not None:
            sec, img = in_process()
            require(bool(torch.isfinite(img).all())
                    and tuple(img.shape) == (w * h, 3),
                    f"{name}: the frame's shape or values")
            ref = base[pool]["image"]
            images[name] = img
            res.update(
                seconds_per_frame=sec,
                camera_rays_per_s=w * h * n_spp / sec,
                mean=float(img.mean()),
                vs_default=compare_frames(img.cpu().numpy(),
                                          ref.cpu().numpy()),
                bit_equal_to_default=bool(torch.equal(img, ref)),
                pixels_differing_from_default=int(
                    (img != ref).any(dim=1).sum()),
                share_beyond_1e_3_of_default=mxu_frame_share(img, ref),
                mean_diff_vs_default=abs(float(img.mean())
                                         - float(ref.mean())))
        out[name] = res
    # the dual engine shades in plain PyTorch: held against the single pool
    # with the plain shading and regen (the unfused step as it was before
    # kernel 2 took it), whose frame differs from it by the order of the
    # sums alone
    sec, plain_shaded = once(lambda: plain_shading_frame(
        rt, torch, variants["fusion_off"], spp=spp, pool_size=big, **frame))
    out["plain_shading_pool_1m"] = {
        "seconds_per_frame": sec, "mean": float(plain_shaded.mean()),
        "mean_diff_vs_default": abs(float(plain_shaded.mean())
                                    - float(base[big]["image"].mean()))}
    out["dual_pool_3m"]["vs_plain_shading"] = compare_frames(
        images["dual_pool_3m"].cpu().numpy(), plain_shaded.cpu().numpy())
    # the device-bound regime: the same kernels at 2^20 lanes
    for name in ("sorted_tile", "sorted", "mxu"):
        sec, img = twice(single(name, big))
        _, st = render(rt, torch, variants[name], spp=spp, pool_size=big,
                       stats=True, **frame)
        ref = base[big]["image"]
        out[name + "_pool_1m"] = {
            "spp": spp, "seconds_per_frame": sec,
            "camera_rays_per_s": w * h * spp / sec, "stats": st,
            "vs_default": compare_frames(img.cpu().numpy(),
                                         ref.cpu().numpy()),
            "bit_equal_to_default": bool(torch.equal(img, ref)),
            "pixels_differing_from_default": int(
                (img != ref).any(dim=1).sum())}
    # the sorted frames' epochs are replayed as CUDA graphs, their sort
    # state computed inside each: against the same frames run eagerly
    for name in ("sorted", "sorted_tile"):
        sec, img = twice(lambda: render(rt, torch, variants[name], spp=spp,
                                        pool_size=small, graph=False,
                                        **frame))
        out[name]["eager_seconds_per_frame"] = sec
        out[name]["graph_bit_equal_to_eager"] = bool(
            torch.equal(img, images[name]))
    # the sorted kernel beside closest_hit through a whole frame, with the
    # kernel's count of the chunk-stages it skipped
    for name in ("sorted", "sorted_tile"):
        for pool, key in ((small, name), (big, name + "_pool_1m")):
            img, res = sorted_frame_against_closest_hit(
                rt, torch, variants[name], spp=spp, pool_size=pool, **frame)
            out[key]["against_closest_hit_whole_frame"] = res
    emit({"phase": "coherent_path", "card": nvidia_smi, **MAIN,
          "default_single_pool": {
              f"pool_{p}": {k: v for k, v in b.items() if k != "image"}
              for p, b in base.items()},
          "runs": out})
    for name, res in out.items():
        if "mean_diff_vs_default" in res:
            require(res["mean_diff_vs_default"] < MEAN_TOL,
                    f"{name}: the image mean differs from the default "
                    f"frame's by {res['mean_diff_vs_default']}")
        ahead = res.get("against_closest_hit_whole_frame")
        if ahead is not None:
            require(ahead["lanes_differing_not_on_an_exact_tie"] == 0,
                    f"{name}: the sorted kernel differs from closest_hit "
                    f"off exact ties: {ahead}")
        # (what can be bit-equal on the card: ``coherent_frames``) the
        # sorted kernel under strided ownership traces the default frame's
        # very paths unless two spheres tie exactly
        # (one arithmetic for every camera ray: the ownerships too)
        if name in ("sorted", "sorted_pool_1m", "sorted_tile",
                    "sorted_tile_pool_1m"):
            ties = (ahead or {}).get("lanes_differing", 0)
            require(res["vs_default"]["ok"]
                    and (res["bit_equal_to_default"] or 0 < ties),
                    f"{name}: the full-width frame differs from the "
                    f"default frame and no exact tie explains it: {res}")
        if "graph_bit_equal_to_eager" in res:
            require(res["graph_bit_equal_to_eager"],
                    f"{name}: the frame replayed as CUDA graphs is not "
                    f"bit-equal to the eager frame: {res}")
        # the unfused step through kernel 2's two halves traces the
        # default frame's very paths
        if name == "fusion_off_pool_1m":
            require(res["bit_equal_to_default"],
                    f"{name}: the full-width frame is not bit-equal to the "
                    f"default frame: {res}")
    require(out["dual_pool_3m"]["vs_plain_shading"]["ok"],
            "the dual engine's frame and the single pool's with the plain "
            f"shading differ: {out['dual_pool_3m']['vs_plain_shading']}")
    return launches_by_kernel


# --------------------------------------------------------------------- #
# grouped_path phase: the sphere-group kernel on coherent rays
# --------------------------------------------------------------------- #

def group_lane_candidates(torch, rays, geom_s, groups, act) -> tuple:
    """The sorted spheres that closest_hit_grouped's contract makes the
    active lanes test, from the INPUTS alone, in plain PyTorch: a lane
    must test a group whose bound it might hit itself (the kernel's own
    test); the kernel skips a group only when a whole warp need not, so it
    tests at least this much -- the operations its bound is stated with.
    -> (those (lane, sphere) pairs, the pairs among them whose
    discriminant is > 0: the pairs that go on to the square root, from
    which the needed bound is stated)."""
    from raytracinginoneweekend_tpu_torch.ops import cuda_segment as seg

    ox, oy, oz, dx, dy, dz = (p.reshape(-1, 1) for p in rays)
    gx, gy, gz, gr = (g[None, :] for g in groups)
    cx, cy, cz, r = (g[None, :] for g in geom_s)
    a = dx * dx + dy * dy + dz * dz
    total, total_gt = 0, 0
    live = (act > 0).reshape(-1)
    for lo in range(0, ox.shape[0], 1 << 16):
        sl = slice(lo, lo + (1 << 16))
        ocx, ocy, ocz = ox[sl] - gx, oy[sl] - gy, oz[sl] - gz
        b = ocx * dx[sl] + ocy * dy[sl] + ocz * dz[sl]
        c = ocx * ocx + ocy * ocy + ocz * ocz - gr * gr
        might = (b * b - a[sl] * c > 0) & ((b < 0) | (c < 0))
        might &= live[sl, None]
        total += int(might.sum())
        ocx, ocy, ocz = ox[sl] - cx, oy[sl] - cy, oz[sl] - cz
        b = ocx * dx[sl] + ocy * dy[sl] + ocz * dz[sl]
        c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        gt = (b * b - a[sl] * c > 0).reshape(b.shape[0], -1, seg.GROUP)
        total_gt += int((gt & might[..., None]).sum())
    return total * seg.GROUP, total_gt


def grouped_checks(torch, name, rays, act, eng, sorted_params, groups,
                   perm, seg_out):
    """closest_hit_grouped on one set of rays: its output through
    trace_segment (``seg_out``) against its plain version (bit-equal),
    against closest_hit on the unsorted scene in the terms of the JAX
    package's test (tests/test_pallas_intersect.py: the same hit, t within
    rtol 2e-4 / atol 1e-3, the same material), its own count of the
    group-tests it skipped, its times beside closest_hit's, its bounds,
    and its K sweep (every K of ``GROUPED_SPLITS`` bit-equal with the
    plain version, timed, with the share of group tests skipped)."""
    from raytracinginoneweekend_tpu_torch.closest_hit_checks import bit_diff
    from raytracinginoneweekend_tpu_torch.ops import cuda_segment as seg

    geom_s = sorted_params[:4]
    stats = torch.zeros(2, dtype=torch.int64, device=act.device)
    hk, tk, sk = seg.segment_closest_hit_grouped(rays, *geom_s, groups,
                                                 eng.t_min, active=act,
                                                 stats=stats)
    hr, tr, sr = seg.segment_closest_hit_grouped_reference(
        rays, *geom_s, groups, eng.t_min, active=act)
    h1, t1, s1 = seg.segment_closest_hit(rays, *eng.sphere_params[:4],
                                         eng.t_min, active=act,
                                         table=eng.htable)
    torch.cuda.synchronize()
    live = act > 0
    bit_equal = bool(torch.equal(hk, hr) and torch.equal(sk, sr)
                     and torch.equal(tk.view(torch.int32),
                                     tr.view(torch.int32)))
    via_trace = bool(torch.equal(seg_out["hit"], hk)
                     and torch.equal(seg_out["t"], tk))
    both = live & (hk > 0) & (h1 > 0)
    orig = perm[sk.to(torch.int64).clamp(max=perm.numel() - 1)].to(
        torch.int32)
    same = both & (orig == s1)
    t_ok = (tk - t1).abs() <= 1e-3 + 2e-4 * t1.abs()
    mats = ("mt", "ar", "ag", "ab", "fz", "io")
    mat_same = same.clone()
    for k, p in zip(mats, seg.resolve_params(s1, eng.sphere_params)[4:]):
        mat_same &= seg_out[k] == p
    n_act = int(live.sum())
    n_g = groups[0].numel()
    tested, tested_gt = group_lane_candidates(torch, rays, geom_s, groups,
                                              act)
    hits = live & (hk > 0) & (hr > 0)
    skipped, in_all = (int(v) for v in stats.tolist())
    res = {"rays": name, "lanes": act.numel(), "active": n_act,
           "bit_equal_to_plain": bit_equal,
           "trace_segment_is_the_kernel": via_trace,
           "hit_differs_from_closest_hit": int((live & (hk != h1)).sum()),
           "winner_differs": int((both & ~same).sum()),
           "t_beyond_rtol_2e-4_atol_1e-3": int((same & ~t_ok).sum()),
           "material_differs_same_winner": int((same & ~mat_same).sum()),
           "group_tests_skipped": skipped, "group_tests": in_all,
           "share_skipped": skipped / max(in_all, 1),
           "share_skippable_lane_by_lane":
               1.0 - tested / (seg.GROUP * max(n_act, 1) * n_g),
           "max_abs_err": float((tk - tr).abs()[hits].max())
           if bool(hits.any()) else 0.0,
           "int_mismatch": int((live & ((hk != hr) | (sk != sr))).sum())}
    res.update(times(
        lambda: seg.segment_closest_hit_grouped(rays, *geom_s, groups,
                                                eng.t_min, active=act),
        lambda: seg.segment_closest_hit_grouped_reference(
            rays, *geom_s, groups, eng.t_min, active=act)))
    res["closest_hit_ms_same_rays"] = device_ms(
        lambda: seg.segment_closest_hit(rays, *eng.sphere_params[:4],
                                        eng.t_min, active=act,
                                        table=eng.htable))
    nbytes = (lane_bytes(act.numel(), n_act) + geom_s[0].numel() * 16
              + n_g * 16)
    group_ops = n_act * n_g * GROUP_TEST_FLOPS
    res.update(bound(group_ops + tested * IX_FLOPS_PER_SPHERE, nbytes))
    res.update(needed_bound(tested, tested_gt, nbytes / PEAK_BYTES_PER_S,
                            hit_flops=IX_HIT_FLOPS, strict=True,
                            other_ops=group_ops))
    sweep = {}
    for k in seg.GROUPED_SPLITS:
        st = torch.zeros(2, dtype=torch.int64, device=act.device)

        def run(k=k, stats=None):
            return seg.segment_closest_hit_grouped(
                rays, *geom_s, groups, eng.t_min, active=act, stats=stats,
                split=k)

        diff = bit_diff(run(stats=st), (hr, tr, sr))
        require(not any(diff.values()), f"closest_hit_grouped at K = {k} "
                f"is not bit-equal with its plain version ({name}): {diff}")
        sk_, tot = (int(v) for v in st.tolist())
        sweep[f"K{k}"] = dict(diff, ms=device_ms(run),
                              share_skipped=sk_ / max(tot, 1))
    sweep["picked"] = seg.picked_grouped_split(act.numel(),
                                               act.device.index)
    res["split"] = sweep["picked"]
    res["k_sweep"] = sweep
    res["ok"] = (bit_equal and via_trace
                 and res["hit_differs_from_closest_hit"] <= 1e-4 * n_act
                 and res["winner_differs"] <= 1e-4 * n_act
                 and res["t_beyond_rtol_2e-4_atol_1e-3"] == 0
                 and res["material_differs_same_winner"] == 0)
    return res


def grouped_path_phase(rt, torch, nvidia_smi: str):
    """The sphere-group kernel on the rays it was designed for: the camera
    rays of a full-width frame's first pool (2^20 lanes, tile ownership:
    neighbouring lanes on neighbouring pixels), a mid-frame state of the
    same frame and the camera rays of the default pool (32768 lanes), each
    through ``trace_segment(group_params=...)`` with the launch counts read
    around those three calls; then the checks of ``grouped_checks``. No
    engine of the port calls this kernel (nor does the JAX package's)."""
    from raytracinginoneweekend_tpu_torch import kernels
    from raytracinginoneweekend_tpu_torch.ops import cuda_segment as seg
    from raytracinginoneweekend_tpu_torch.ops import wavefront

    shape = dict(width=MAIN["width"], height=MAIN["height"],
                 spp=MAIN["spp"], depth=MAIN["depth"])
    tile = dataclasses.replace(rt.DEFAULT, ownership="tile")
    eng = make_engine(rt, torch, "huge", "cpu", "thinlens", tile,
                      pool_size=1 << 20, **shape)
    small = make_engine(rt, torch, "huge", "cpu", "thinlens", tile,
                        pool_size=1 << 15, **shape)
    states = {"camera_rays": (eng, wavefront.engine_prologue(eng)),
              "mid_frame": (eng, mid_frame_state(eng, 40)),
              "camera_rays_32768": (small, wavefront.engine_prologue(small))}
    sorted_params, groups = seg.group_scene(eng.sphere_params)
    perm = seg.group_order(eng.sphere_params)
    kernels.reset_launches()
    torch.cuda.synchronize()
    segs = {name: seg.trace_segment(tuple(st[4:10]), sorted_params,
                                    e.t_min, active=st[3],
                                    group_params=groups)
            for name, (e, st) in states.items()}
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    require(launches["closest_hit_grouped"] == len(states)
            and sum(launches.values()) == len(states),
            f"trace_segment(group_params=...) launched {launches}")
    out = {name: grouped_checks(torch, name, tuple(st[4:10]), st[3], e,
                                sorted_params, groups, perm, segs[name])
           for name, (e, st) in states.items()}
    emit({"phase": "grouped_path", "card": nvidia_smi, **shape,
          "pool": eng.lanes, "groups": groups[0].numel(),
          "launches": launches, "checks": out})
    for name, res in out.items():
        require(res["ok"], f"closest_hit_grouped on the {name}: {res}")
    for name in ("camera_rays", "camera_rays_32768"):
        require(out[name]["hit_differs_from_closest_hit"] == 0,
                "closest_hit_grouped and closest_hit disagree on a camera "
                f"ray ({name})")
    main = out["camera_rays"]
    keys = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by", *IX_NEEDED,
            "lanes", "active", "share_skipped",
            "share_skippable_lane_by_lane", "closest_hit_ms_same_rays",
            "hit_differs_from_closest_hit", "winner_differs", "split")
    entry = {"name": "closest_hit_grouped", "route": "cuda",
             "source": "raytracinginoneweekend_tpu_torch/csrc/"
                       "closest_hit_grouped.cu",
             "replaces": "raytracinginoneweekend_tpu/ops/"
                         "pallas_segment.py:484",
             "launches": launches["closest_hit_grouped"],
             "max_abs_err": max(r["max_abs_err"] for r in out.values()),
             "int_mismatch_lanes": sum(r["int_mismatch"]
                                       for r in out.values()),
             **{k: main[k] for k in keys}, "library_ms": None,
             "rays": "camera rays of the first pool, tile ownership",
             "k_sweep_ms": {k: v["ms"] for k, v in main["k_sweep"].items()
                            if k != "picked"},
             "at_mid_frame": {k: out["mid_frame"][k]
                              for k in (*keys, "k_sweep")},
             "at_32768_camera_rays": {k: out["camera_rays_32768"][k]
                                      for k in (*keys, "k_sweep")}}
    return entry


# --------------------------------------------------------------------- #
# mega_path phase: the whole-bounce kernel
# --------------------------------------------------------------------- #

def mega_kernel_checks(rt, torch, shape):
    """mega_bounce against its plain version on the main frame's mid-frame
    lane state at two pool sizes (32768 and 2^20 lanes), and timed."""
    from raytracinginoneweekend_tpu_torch.ops import cuda_mega, wavefront

    out = {}
    for pool in (1 << 15, 1 << 20):
        eng = make_engine(rt, torch, "huge", "cpu", "thinlens", rt.DEFAULT,
                          pool_size=pool, **shape)
        state = mid_frame_state(eng, 40)
        planes, kw = wavefront.mega_planes(state), wavefront.mega_kw(eng)
        tables = cuda_mega.mega_tables(eng.sphere_params)
        got = cuda_mega.mega_bounce(planes, eng.sphere_params,
                                    tables=tables, **kw)
        want = cuda_mega.mega_bounce_reference(planes, eng.sphere_params,
                                               **kw)
        torch.cuda.synchronize()
        int_agree = (got[12] == want[12]) & (got[13] == want[13])
        outliers = torch.zeros_like(int_agree)
        max_abs, bits = 0.0, 0
        for g, w in zip(got[:12], want[:12]):
            close = torch.isclose(g, w, rtol=1e-5, atol=1e-6, equal_nan=True)
            outliers |= int_agree & ~close
            bits += int((int_agree & (g.view(torch.int32)
                                      != w.view(torch.int32))).sum())
            sel = int_agree & close & torch.isfinite(w)
            if bool(sel.any()):
                max_abs = max(max_abs, float((g - w).abs()[sel].max()))
        active = int((planes[0] > 0).sum())
        n_sph = eng.sphere_params[0].shape[0]
        res = {"lanes": eng.lanes, "active": active,
               "int_mismatch": int((~int_agree).sum()),
               "float_outliers": int(outliers.sum()),
               "bit_unequal_float_elements": bits, "max_abs_err": max_abs,
               "kept": int((got[12] > 0).sum())}
        res.update(times(
            lambda: cuda_mega.mega_bounce(planes, eng.sphere_params,
                                          tables=tables, **kw),
            lambda: cuda_mega.mega_bounce_reference(
                planes, eng.sphere_params, **kw)))
        res["closest_hit_ms_same_rays"] = device_ms(
            lambda: wavefront.engine_closest_hit(eng, state))
        nbytes = eng.lanes * (16 + 14) * 4 + n_sph * 56
        res.update(bound(active * n_sph * CH_FLOPS_PER_SPHERE, nbytes))
        res.update(closest_hit_needed(
            tuple(planes[1:7]), eng.sphere_params[:4], planes[0],
            nbytes / PEAK_BYTES_PER_S))
        res["ok"] = (res["int_mismatch"] == 0
                     and res["float_outliers"] <= max(1, 1e-4 * eng.lanes))
        res["k_sweep"] = mega_sweep(torch, planes, eng.sphere_params, tables,
                                    kw, want)
        out[f"pool_{pool}"] = res
    return out


def mega_sweep(torch, planes, sphere_params, tables, kw, want):
    """mega_bounce at every K of its split loop (``CH_SPLITS``) against its
    plain version's 14 output planes, every plane to the bit on every lane
    (the floats by their bits), and each K's device time -> {"K<k>":
    {...}, "picked": the K that the wrapper picks for these lanes}."""
    from raytracinginoneweekend_tpu_torch.ops import cuda_mega
    from raytracinginoneweekend_tpu_torch.ops import cuda_segment as seg

    out = {}
    for k in seg.CH_SPLITS:
        def run(k=k):
            return cuda_mega.mega_bounce(planes, sphere_params,
                                         tables=tables, split=k, **kw)

        got = run()
        bad = {}
        for n, (g, w) in enumerate(zip(got, want)):
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            m = int((g != w).sum())
            if m:
                bad[f"plane_{n}"] = m
        require(not bad, f"mega_bounce at K = {k} is not bit-equal with its "
                f"plain version (lanes that differ, by plane): {bad}")
        out[f"K{k}"] = {"planes_differing": 0, "ms": device_ms(run)}
    out["picked"] = seg.closest_hit_split(
        planes[1].numel(), torch.cuda.get_device_properties(
            planes[1].device).multi_processor_count, seg.SPLIT_THREADS_PER_SM)
    return out


def mega_path_phase(rt, torch, nvidia_smi: str):
    """``mega="bounce"`` (``render --fusion bounce``): the kernel against
    its plain version; frames at 240x160 against the default frame, the
    unfused step and its own plain frame; then the full-width frame
    through the CLI at a pool of 2^20 lanes with the launch counts read
    around it, and once more in the process beside the default frame."""
    from raytracinginoneweekend_tpu_torch import cli, kernels
    from raytracinginoneweekend_tpu_torch.golden import compare_frames
    from raytracinginoneweekend_tpu_torch.utils.timing import time_fn

    w, h, spp, depth = (MAIN[k] for k in ("width", "height", "spp", "depth"))
    shape = dict(width=w, height=h, spp=spp, depth=depth)
    checks = mega_kernel_checks(rt, torch, shape)
    bounce = dataclasses.replace(rt.DEFAULT, mega="bounce")
    off = dataclasses.replace(rt.DEFAULT, mega="off")

    def held(img, ref):
        res = compare_frames(img.cpu().numpy(), ref.cpu().numpy())
        res["bit_equal"] = bool(torch.equal(img, ref))
        return res

    small = {"bounce": render(rt, torch, bounce, **SMALL),
             "default": render(rt, torch, rt.DEFAULT, **SMALL),
             "off": render(rt, torch, off, **SMALL),
             "plain_bounce": render(rt, torch, bounce, plain=True, **SMALL),
             "plain_off": render(rt, torch, off, plain=True, **SMALL)}
    frames = {f"bounce_vs_{k}": held(small["bounce"], small[k])
              for k in ("default", "off", "plain_bounce")}
    frames["off_vs_default"] = held(small["off"], small["default"])
    frames["plain_bounce_vs_plain_off"] = held(small["plain_bounce"],
                                               small["plain_off"])

    pool = 1 << 20
    stats, launches, cli_seconds, argv = cli_render(
        torch, "mega_bounce", ["--fusion", "bounce", "--pool-size",
                               str(pool)], spp)
    iters = stats["iters"]
    dev = torch.device("cuda")
    frame = dict(width=w, height=h, depth=depth, spp=spp, pool_size=pool,
                 scene=cli._build_scene("huge", 0, dev),
                 cam=cli._build_camera("cpu", w, h, dev))
    sec_d, img_d = time_fn(lambda: render(rt, torch, rt.DEFAULT, **frame),
                           warmup=1, iters=1, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img_b = render(rt, torch, bounce, **frame)  # built and warm: the CLI's
    torch.cuda.synchronize()
    sec_b = time.perf_counter() - t0
    rays = w * h * spp
    full = {"argv": argv, "cli_stats": stats, "launches": launches,
            "cli_seconds": cli_seconds, "seconds_per_frame": sec_b,
            "camera_rays_per_s": rays / sec_b,
            "iterations": iters, "occupancy": stats["occupancy"],
            "default_seconds_per_frame": sec_d,
            "default_camera_rays_per_s": rays / sec_d,
            "vs_default": compare_frames(img_b.cpu().numpy(),
                                         img_d.cpu().numpy()),
            "bit_equal_to_default": bool(torch.equal(img_b, img_d)),
            "mean_diff_vs_default": abs(float(img_b.mean())
                                        - float(img_d.mean())),
            "finite": bool(torch.isfinite(img_b).all())}
    # the CLI's default pool, where the kernel's split loop runs K = 8
    small_pool = dict(frame, pool_size=1 << 15)
    sec_d, img_d = time_fn(lambda: render(rt, torch, rt.DEFAULT,
                                          **small_pool),
                           warmup=1, iters=1, device=dev)
    sec_b, img_b = time_fn(lambda: render(rt, torch, bounce, **small_pool),
                           warmup=1, iters=1, device=dev)
    full["at_pool_32768"] = {
        "seconds_per_frame": sec_b, "camera_rays_per_s": rays / sec_b,
        "default_seconds_per_frame": sec_d,
        "vs_default": compare_frames(img_b.cpu().numpy(),
                                     img_d.cpu().numpy()),
        "bit_equal_to_default": bool(torch.equal(img_b, img_d)),
        "finite": bool(torch.isfinite(img_b).all())}
    emit({"phase": "mega_path", "card": nvidia_smi, **MAIN,
          "kernel": checks, "frames_240x160": frames, "full_width": full})
    for name, res in checks.items():
        require(res["ok"], f"mega_bounce disagrees with its plain version "
                f"({name}): {res}")
    for name, res in frames.items():
        require(res["ok"], f"mega='bounce' frames, {name}: {res}")
    require(frames["plain_bounce_vs_plain_off"]["bit_equal"],
            "the plain whole-bounce frame differs from the plain unfused "
            "frame")
    # every camera ray and bounce draw from kernel 2's one arithmetic (the
    # whole-bounce kernel draws and shades with the same device functions,
    # and its closest hit is closest_hit's to the bit): the three steps'
    # frames are one frame
    for name in ("bounce_vs_default", "bounce_vs_off", "off_vs_default"):
        require(frames[name]["bit_equal"],
                f"mega='bounce' frames, {name}: not bit-equal: "
                f"{frames[name]}")
    require(launches["mega_bounce"] == iters and iters > 0
            and launches["regen_only"] == iters
            and sum(launches.values()) == 2 * iters,
            f"--fusion bounce launched {launches} in {iters} iterations")
    require(full["finite"] and full["mean_diff_vs_default"] < MEAN_TOL
            and full["vs_default"]["ok"] and full["bit_equal_to_default"],
            f"the full-width mega='bounce' frame: {full}")
    at_small = full["at_pool_32768"]
    require(at_small["finite"] and at_small["bit_equal_to_default"],
            f"the full-width mega='bounce' frame at 32768 lanes: {at_small}")
    main = checks[f"pool_{1 << 15}"]
    keys = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "lanes",
            "active", "max_abs_err", "int_mismatch",
            "closest_hit_ms_same_rays", *CH_NEEDED, "k_sweep")
    return {"name": "mega_bounce", "route": "cuda",
            "source": "raytracinginoneweekend_tpu_torch/csrc/mega_bounce.cu",
            "replaces": "raytracinginoneweekend_tpu/ops/pallas_mega.py:155",
            "launches": launches["mega_bounce"],
            "max_abs_err": max(r["max_abs_err"] for r in checks.values()),
            "int_mismatch_lanes": sum(r["int_mismatch"]
                                      for r in checks.values()),
            "float_outlier_lanes": sum(r["float_outliers"]
                                       for r in checks.values()),
            **{k: main[k] for k in keys[:7]},
            "closest_hit_ms_same_rays": main["closest_hit_ms_same_rays"],
            **{k: main[k] for k in CH_NEEDED},
            "split": main["k_sweep"]["picked"],
            "k_sweep_ms": {k: v["ms"] for k, v in main["k_sweep"].items()
                           if k != "picked"},
            "library_ms": None,
            "at_pool_1m": {k: checks[f"pool_{1 << 20}"][k] for k in keys}}


# --------------------------------------------------------------------- #
# train_path and cli_fit phases
# --------------------------------------------------------------------- #

def train_path_phase(rt, torch, nvidia_smi: str):
    import importlib
    import statistics

    from raytracinginoneweekend_tpu_torch import cli, golden, kernels, optim
    from raytracinginoneweekend_tpu_torch.optim import inverse

    prender = importlib.import_module(
        "raytracinginoneweekend_tpu_torch.render")
    dev = torch.device("cuda")
    w, h, depth = TRAIN["width"], TRAIN["height"], TRAIN["depth"]
    options = dataclasses.replace(rt.DEFAULT, intersect="pallas")
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", w, h, dev)
    cfg = rt.RenderConfig(width=w, height=h, spp=TRAIN["target_spp"],
                          max_depth=depth, camera_mode="thinlens",
                          options=options)
    which = ("albedo", "centers")
    gen = torch.Generator(device="cpu").manual_seed(1)
    perturbed = scene
    for name in which:
        leaf = getattr(scene, name)
        noise = TRAIN["perturb"] * torch.randn(leaf.shape, generator=gen)
        perturbed = perturbed._replace(**{name: leaf + noise.to(dev)})
    n_steps = TRAIN["warmup_steps"] + TRAIN["timed_steps"]
    kw = dict(width=w, height=h, spp=TRAIN["spp"], max_depth=depth,
              camera_mode="thinlens", options=options)

    # The loss on a fixed batch, rendered with the TARGET's key and sample
    # ids: at the true parameters it is exactly 0 (the same paths), so it
    # reads the parameters' error without the Monte-Carlo floor that the
    # steps' own losses (fresh keys, fresh batches) sit on.
    require(TRAIN["spp"] == TRAIN["target_spp"],
            "the probe loss needs the target's sample ids")
    probe_ids = inverse.draw_pixel_batch((9, 9), w * h,
                                         TRAIN["batch_pixels"], dev)

    def probe_loss(params, target):
        with torch.no_grad():
            return float(optim.render_loss(
                params, scene, cam,
                target.reshape(-1, 3)[probe_ids.to(torch.int64)],
                probe_ids, rt.key_words(0), engine="tiled", **kw))

    stamps = []

    def callback(i, params, optimizer, loss):
        stamps.append(time.perf_counter())  # fit has just read the loss

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    torch.cuda.synchronize()
    with timed_entry(torch, "rtw_closest_hit_n3") as intersect_ms:
        t0 = time.perf_counter()
        target = prender.render(scene, cam, cfg, rt.key_words(0),
                                device=dev)
        torch.cuda.synchronize()
        target_seconds = time.perf_counter() - t0
    after_target = dict(kernels.LAUNCHES)
    peak_target = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stamps.append(time.perf_counter())
    _, params, opt, losses = optim.fit(
        perturbed, cam, target, cfg, which=which, steps=n_steps,
        learning_rate=TRAIN["lr"], batch_pixels=TRAIN["batch_pixels"],
        spp=TRAIN["spp"], engine="auto", callback=callback, device=dev)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak_fit = torch.cuda.max_memory_allocated()
    # the same fit's first two steps again, untimed, with each step's
    # pixel batch recorded
    with golden.record_fit() as drawn:
        optim.fit(perturbed, cam, target, cfg, which=which, steps=2,
                  learning_rate=TRAIN["lr"],
                  batch_pixels=TRAIN["batch_pixels"], spp=TRAIN["spp"],
                  engine="auto", device=dev)
    draws = full_width_draws(torch, inverse, golden, drawn["ids"], w * h)

    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    timed = step_s[TRAIN["warmup_steps"]:]
    rays_per_step = TRAIN["batch_pixels"] * TRAIN["spp"]
    require(bool(torch.isfinite(target).all())
            and tuple(target.shape) == (h, w, 3), "the target frame")
    require(all(x == x and abs(x) != float("inf") for x in losses),
            f"non-finite loss: {losses}")
    require(all(bool(torch.isfinite(p).all()) for p in params.values()),
            "non-finite parameters after fit")
    require(after_target["intersect"] > 0
            and after_target["closest_hit"] == 0,
            f"the target render's launches: {after_target}")
    require(launches["intersect"] == after_target["intersect"],
            "the AD trace launched the intersect kernel")
    require(len(intersect_ms) == after_target["intersect"],
            f"{len(intersect_ms)} intersect launches timed in the target "
            f"render, {after_target['intersect']} counted")
    require(launches["closest_hit"] == depth * n_steps,
            f"closest_hit was launched {launches['closest_hit']} times in "
            f"{n_steps} steps of depth {depth}: backward must not launch it "
            f"again")

    start = optim.params_from_scene(perturbed, which)
    loss_before = probe_loss(start, target)
    loss_after = probe_loss(params, target)
    # (checked after the record is printed, so a failure shows its numbers)
    pending = [(loss_after <= loss_before,
                f"the probe loss rose: {loss_before} -> {loss_after}")]

    # one step taken apart, and the two engines on one batch
    batch_key, render_key = inverse.step_keys(rt.key_words(7), n_steps)
    ids = inverse.draw_pixel_batch(batch_key, w * h, TRAIN["batch_pixels"],
                                   dev)
    tb = target.reshape(-1, 3)[ids.to(torch.int64)]
    parts = {}
    for engine in ("planar", "tiled"):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        adam = inverse.make_adam(p, TRAIN["lr"])
        for rep in range(2):  # the second pass is the timed one
            adam.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = optim.render_loss(p, perturbed, cam, tb, ids, render_key,
                                     engine=engine, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss.backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            adam.step()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
        parts[engine] = {"forward_s": t1 - t0, "backward_s": t2 - t1,
                         "adam_s": t3 - t2, "loss": float(loss.detach())}
    # At the SEEDED starting parameters, not at the fit's result: that one
    # differs from run to run in its last bits (the backward's sums are
    # atomic adds), and which pixels hold a knife-edge path depends on
    # them. Seeded inputs compare the same paths in every run.
    diff, px = engine_gradients(
        torch, rt, start, perturbed, cam, tb, ids, render_key, **kw)
    pending.extend(engine_pixels_agree(px))
    for k in which:
        pending.append((engine_gradients_agree(k, diff[k]),
                        f"gradient of {k}, planar vs tiled: {diff[k]}"))
    # a whole step of the tiled engine through make_train_step
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    tiled_step = optim.make_train_step(inverse.make_adam(p, TRAIN["lr"]),
                                       engine="tiled", **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tiled_loss = float(tiled_step(p, perturbed, cam, tb, ids, render_key))
    torch.cuda.synchronize()
    tiled_step_s = time.perf_counter() - t0

    emit({"phase": "train_path", "card": nvidia_smi, **TRAIN,
          "which": which, "engine": "auto -> " + inverse.resolve_ad_engine(
              depth, options.rr_terminate),
          "target_seconds": target_seconds,
          "target_intersect_seconds": sum(intersect_ms) / 1e3,
          "target_intersect_launches_timed": len(intersect_ms),
          "target_camera_rays": w * h * TRAIN["target_spp"],
          "launches_target": after_target, "launches": launches,
          "rays_per_step": rays_per_step,
          "step_seconds": step_s,
          "step_seconds_median": statistics.median(timed),
          "step_seconds_min": min(timed), "step_seconds_max": max(timed),
          "rays_per_second": rays_per_step / statistics.median(timed),
          "losses": losses, "probe_loss_before": loss_before,
          "probe_loss_after": loss_after,
          "peak_bytes_target": peak_target, "peak_bytes_fit": peak_fit,
          "one_step_parts": parts, "tiled_step_seconds": tiled_step_s,
          "tiled_step_loss": tiled_loss,
          "grad_planar_vs_tiled": diff, "grad_pixels": px,
          "pixel_draws": draws})
    pending.append((draws["fit_draws_equal_jax"] and draws["draw_equal_jax"],
                    f"fit's pixel batches differ from the JAX package's: "
                    f"{draws}"))
    for cond, what in pending:
        require(cond, what)
    pool = train_pool_path(rt, torch, nvidia_smi, scene, perturbed, cam,
                           which, options)
    return {"planar": launches, "pool": pool}


def full_width_draws(torch, inverse, golden, fit_ids, n_pixels: int) -> dict:
    """fit's pixel batches at full width against the JAX package's: the
    batches the fit drew on the card (``fit_ids``, its first steps) and
    the golden's (drawn by JAX on the CPU at the same base key and size),
    bit for bit; then the draw alone timed on the card against the host
    draw it replaces (torch.randperm of n_pixels from a torch.Generator,
    then the copy of the batch to the card), medians of ``reps``."""
    import statistics

    import numpy as np

    from raytracinginoneweekend_tpu_torch.ops.threefry import key_words

    g = golden.load_fit_golden()
    want = g["full_width_ids"]
    require(int(g["full_width_width"]) * int(g["full_width_height"])
            == n_pixels and want.shape[1] == TRAIN["batch_pixels"],
            f"the golden's full-width draw is not this fit's: {want.shape}")
    equal = len(fit_ids) >= len(want) and all(
        np.array_equal(a, b) for a, b in zip(fit_ids, want))
    dev = torch.device("cuda")
    base, batch, reps = key_words(int(g["full_width_base_seed"])), \
        TRAIN["batch_pixels"], 20

    def device_draw(i):
        return inverse.draw_pixel_batch(inverse.step_keys(base, i)[0],
                                        n_pixels, batch, dev)

    def host_draw(i):
        gen = torch.Generator(device="cpu").manual_seed(1000 + i)
        perm = torch.randperm(n_pixels, generator=gen)[:batch]
        return perm.to(torch.int32).to(dev)

    times = {}
    for name, fn in (("device", device_draw), ("host_randperm", host_draw)):
        fn(0)  # warm
        torch.cuda.synchronize()
        ms = []
        for i in range(reps):
            t0 = time.perf_counter()
            fn(i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        times[name] = {"median_ms": statistics.median(ms),
                       "min_ms": min(ms), "max_ms": max(ms)}
    again = [device_draw(i).cpu().numpy() for i in range(len(want))]
    return {"fit_draws_equal_jax": bool(equal),
            "draw_equal_jax": all(np.array_equal(a, b)
                                  for a, b in zip(again, want)),
            "steps_checked": len(want), "n_pixels": n_pixels,
            "batch_pixels": batch, "draw_ms": times}


@contextlib.contextmanager
def timed_entry(torch, name: str):
    """CUDA events around every call of the C entry ``name`` while the
    block runs, recorded on the current stream right before and after the
    launch (the wrapper's own work outside them) -> a list that, after the
    block, holds each launch's device milliseconds. Event records do not
    synchronise, so the timed work runs as it would."""
    from raytracinginoneweekend_tpu_torch import kernels

    fn = kernels.entry(name)
    pairs, out = [], []

    def wrapper(*args):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        err = fn(*args)
        stop.record()
        pairs.append((start, stop))
        return err

    kernels._fns[name] = wrapper
    try:
        yield out
    finally:
        kernels._fns[name] = fn
    torch.cuda.synchronize()
    out.extend(a.elapsed_time(b) for a, b in pairs)


def step_apart(torch, optim, inverse, params, scene, cam, tb, ids, key,
               engine, **kw):
    """One train step taken apart (the second of two passes is timed):
    forward, backward and update seconds, the loss, and the closest-hit
    launches of the timed pass (and every kernel's, ``launches``)."""
    from raytracinginoneweekend_tpu_torch import kernels

    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    adam = inverse.make_adam(p, TRAIN["lr"])
    losses, launches = [], []
    for _ in range(2):
        adam.zero_grad(set_to_none=True)
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = optim.render_loss(p, scene, cam, tb, ids, key, engine=engine,
                                 **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        adam.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        losses.append(float(loss.detach()))
        launches.append(kernels.LAUNCHES["closest_hit"])
    # the first pass starts from ``params`` (the second from an update
    # whose atomic sums differ in their last bits from run to run)
    return {"forward_s": t1 - t0, "backward_s": t2 - t1, "adam_s": t3 - t2,
            "step_s": t3 - t0, "loss_at_params": losses[0],
            "closest_hit_launches_at_params": launches[0],
            "closest_hit_launches": launches[1],
            "launches": dict(kernels.LAUNCHES)}


def train_pool_path(rt, torch, nvidia_smi, scene, perturbed, cam, which,
                    options):
    """The training path at the regenerative AD pool's flagship depth: the
    same batch shape (16384 pixels x 8 spp) at depth AD_DEPTH, where
    engine "auto" resolves to the pool (ops/wavefront_ad.py). optim.fit on
    a target of the same depth (the forward wavefront engine: the same
    estimator), one warm-up and ten timed steps with the launch counts and
    the peak memory read around them; one step of the pool and one of the
    planar engine taken apart on one batch; the budget the batch needs
    (``wavefront_ad_budget``), ``wavefront_ad_done`` at it and a step in
    the flat-budget mode (remat "auto"); the pool's pixels against the
    planar engine's (the same draws) and its gradients by the render_loss
    rule (``engine_gradients_agree``, the float64 witness)."""
    import statistics

    from raytracinginoneweekend_tpu_torch import kernels, optim
    from raytracinginoneweekend_tpu_torch.ops import cuda_ad_shade
    from raytracinginoneweekend_tpu_torch.ops import wavefront_ad
    from raytracinginoneweekend_tpu_torch.optim import inverse

    dev = torch.device("cuda")
    w, h, depth = TRAIN["width"], TRAIN["height"], AD_DEPTH
    engine = inverse.resolve_ad_engine(depth, options.rr_terminate)
    require(engine == "wavefront",
            f"engine 'auto' resolves to {engine!r} at depth {depth}")
    kw = dict(width=w, height=h, spp=TRAIN["spp"], max_depth=depth,
              camera_mode="thinlens", options=options)
    target = rt.render_wavefront(
        scene, cam, rt.key_words(0), width=w, height=h,
        spp=TRAIN["target_spp"], max_depth=depth, camera_mode="thinlens",
        options=options, pool_size=1 << 20, device=dev).reshape(h, w, 3)
    cfg = rt.RenderConfig(width=w, height=h, spp=TRAIN["target_spp"],
                          max_depth=depth, camera_mode="thinlens",
                          options=options)
    n_steps = TRAIN["warmup_steps"] + TRAIN["timed_steps"]
    stamps = []

    def callback(i, params, optimizer, loss):
        stamps.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    with recorded_calls(cuda_ad_shade, "regen_reference") as regens:
        _, params, _opt, losses = optim.fit(
            perturbed, cam, target, cfg, which=which, steps=n_steps,
            learning_rate=TRAIN["lr"], batch_pixels=TRAIN["batch_pixels"],
            spp=TRAIN["spp"], engine="auto", callback=callback, device=dev)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    n_regens = len(regens)
    del regens
    peak = torch.cuda.max_memory_allocated()
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    timed = step_s[TRAIN["warmup_steps"]:]

    batch_key, render_key = inverse.step_keys(rt.key_words(7), n_steps)
    ids = inverse.draw_pixel_batch(batch_key, w * h, TRAIN["batch_pixels"],
                                   dev)
    tb = target.reshape(-1, 3)[ids.to(torch.int64)]
    start = optim.params_from_scene(perturbed, which)
    parts = {e: step_apart(torch, optim, inverse, start, perturbed, cam, tb,
                           ids, render_key, e, **kw)
             for e in ("wavefront", "planar")}
    budget = wavefront_ad.wavefront_ad_budget(perturbed, cam, ids,
                                              render_key, **kw)
    done = wavefront_ad.wavefront_ad_done(perturbed, cam, ids, render_key,
                                          iters=budget, **kw)
    pid_waves, _sid, _rows, _n = wavefront_ad._wave_layout(
        ids, TRAIN["spp"], 1 << 15)
    lanes = pid_waves.shape[1] * pid_waves.shape[2]
    remat = ("none" if budget * lanes * wavefront_ad._RES_BYTES_PER_LANE_ITER
             <= wavefront_ad._NOREMAT_CAP_BYTES else "step")
    torch.cuda.reset_peak_memory_stats()
    flat = step_apart(torch, optim, inverse, start, perturbed, cam, tb, ids,
                      render_key, "wavefront",
                      engine_opts={"iters": budget, "remat": "auto"}, **kw)
    flat["peak_bytes"] = torch.cuda.max_memory_allocated()
    diff, px = engine_gradients(torch, rt, start, perturbed, cam, tb, ids,
                                render_key, engines=("wavefront", "planar"),
                                **kw)
    rays = TRAIN["batch_pixels"] * TRAIN["spp"]
    emit({"phase": "train_path", "part": "ad_pool", "card": nvidia_smi,
          **TRAIN, "depth": depth, "which": which,
          "engine": "auto -> " + engine, "pool_lanes": lanes,
          "waves": pid_waves.shape[0], "launches": launches,
          "eager_regens": n_regens,
          "closest_hit_launches_per_step": launches["closest_hit"] / n_steps,
          "step_seconds": step_s,
          "step_seconds_median": statistics.median(timed),
          "rays_per_second": rays / statistics.median(timed),
          "losses": losses, "peak_bytes_fit": peak,
          "one_step_parts": parts, "budget_iterations": budget,
          "done_at_budget": done, "remat_auto_at_budget": remat,
          "flat_budget_step": flat,
          "grad_pool_vs_planar": diff, "grad_pixels": px})
    require(all(x == x and abs(x) != float("inf") for x in losses),
            f"non-finite loss: {losses}")
    # an iteration launches the closest hit once, the shade op's forward
    # as the forward runs it and again as the backward recomputes it, and
    # its adjoint once; nothing else
    n_iter = launches["closest_hit"]
    require(n_iter > 0 and launches["ad_shade"] == 2 * n_iter
            and launches["ad_shade_grad"] == n_iter
            and sum(launches.values()) == 4 * n_iter,
            f"the pool's steps launched {launches}")
    # the eager regen runs once a trace, before its first iteration: never
    # inside an epoch
    require(n_regens == n_steps,
            f"{n_steps} pool steps ran the eager regen {n_regens} times")
    require(parts["planar"]["launches"]["ad_shade"] == 0,
            f"the planar engine's step ran the pool's shade op: "
            f"{parts['planar']['launches']}")
    n_first = parts["wavefront"]["closest_hit_launches_at_params"]
    require(n_first == budget and done,
            f"one pool step launched closest_hit {n_first} times; the batch "
            f"needs {budget} iterations (done: {done}); backward must not "
            "launch it again")
    require(flat["loss_at_params"] == parts["wavefront"]["loss_at_params"],
            f"the flat budget's loss {flat['loss_at_params']} differs from "
            f"the epoch mode's {parts['wavefront']['loss_at_params']}")
    require(px["pixels_within_rtol_1e-4_atol_2e-5"],
            f"the pool's pixels differ from the planar engine's: {px}")
    for cond, what in engine_pixels_agree(px):
        require(cond, what)
    for k in which:
        require(engine_gradients_agree(k, diff[k]),
                f"gradient of {k}, pool vs planar: {diff[k]}")
    return launches


def cli_fit_phase(rt, torch, nvidia_smi: str):
    from raytracinginoneweekend_tpu_torch import cli, golden, kernels, optim

    # The JAX CLI's fit trajectory (recorded on the CPU) through the port's
    # CLI, on the card and, as the control, on this machine's host: ids
    # and perturbation bit-equal, every loss within its rtol, and Adam
    # replayed on the CPU over the run's own gradients giving its
    # parameters bit for bit, on both; the final parameters within the
    # compounded bound on the host, and on the card reported against it
    # (rounding that Adam carries can leave it there). Each step, taken
    # alone from JAX's own state, must reach JAX's next parameters within
    # the one-step bound on every element, on the card and on the host
    # (golden.fit_steps_from_jax); each step's gradient against JAX's (on
    # the host, on the card, with the host's sines and cosines, and with
    # those and the host's target) says where the two part.
    import numpy as np

    host = golden.cli_fit_against_golden("cpu")
    kernels.reset_launches()
    t0 = time.perf_counter()
    traj = golden.cli_fit_against_golden()
    traj.update(seconds=time.perf_counter() - t0,
                launches={k: v for k, v in kernels.LAUNCHES.items() if v})
    card_rec, host_rec = traj.pop("record"), host.pop("record")
    traj["card_vs_host_max_abs"] = {
        k[len("final_"):]: float(np.abs(card_rec[k] - host_rec[k]).max())
        for k in card_rec if k.startswith("final_")}
    steps = {"card": golden.fit_steps_from_jax(),
             "host": golden.fit_steps_from_jax("cpu")}
    gap = golden.fit_gradient_gap()
    emit({"phase": "cli_fit", "part": "jax_trajectory", "card": nvidia_smi,
          **traj, "host": host, "steps_from_jax": steps,
          "gradient_gap": gap})
    require(host["ok"], f"the CLI's fit on the host left the JAX "
            f"trajectory: {host['checks']} {host['outside']}")
    require(all(v for k, v in traj["checks"].items() if k != "params"),
            f"the CLI's fit on the card left the JAX trajectory: "
            f"{traj['checks']}")
    for where, res in steps.items():
        require(res["ok"], f"a fit step on the {where}, taken from JAX's "
                f"state, left JAX's step: {res['checks']} {res['outside']}")
    require(traj["launches"].get("intersect", 0) > 0
            and traj["launches"].get("closest_hit", 0) > 0,
            f"the golden fit did not go through the kernels: "
            f"{traj['launches']}")

    ckpt = os.path.join(kernels.BUILD_DIR, "chip_smoke_fit.npz")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    if os.path.exists(ckpt):
        os.remove(ckpt)
    argv = ["fit", "--scene", "simple-cuda", "--width",
            str(CLI_FIT["width"]), "--height", str(CLI_FIT["height"]),
            "--params", "albedo,centers", "--steps", str(CLI_FIT["steps"]),
            "--ad-engine", "auto", "--checkpoint", ckpt]
    said = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(said):
        rc = cli.main(argv)
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    require(rc == 0, f"cli fit returned {rc}")
    require(os.path.exists(ckpt), "the checkpoint was not written")
    dev = torch.device("cuda")
    scene = cli._build_scene("simple-cuda", 0, dev)
    tmpl = optim.params_from_scene(scene, ("albedo", "centers"))
    params, opt_state, step = optim.load_checkpoint(ckpt, tmpl)
    require(step == CLI_FIT["steps"]
            and int(opt_state["count"]) == CLI_FIT["steps"],
            f"checkpoint at step {step}, Adam count {opt_state['count']}")
    require(all(bool(torch.isfinite(p).all()) for p in params.values()),
            "non-finite parameters in the checkpoint")
    resumed = io.StringIO()
    with contextlib.redirect_stdout(resumed):
        rc = cli.main([*argv[:argv.index("--steps")], "--steps", "2",
                       *argv[argv.index("--steps") + 2:], "--resume", ckpt])
    require(rc == 0 and f"at step {CLI_FIT['steps']}" in resumed.getvalue(),
            "the resumed run")
    _p, _o, step2 = optim.load_checkpoint(ckpt, tmpl)
    require(step2 == CLI_FIT["steps"] + 2, f"resumed to step {step2}")
    lines = said.getvalue().strip().splitlines()
    # the CLI's defaults with Russian roulette: depth 32 > 28, so engine
    # "auto" is the regenerative AD pool
    from raytracinginoneweekend_tpu_torch.ops import wavefront_ad

    rr_argv = argv[:argv.index("--checkpoint")] + ["--rr-terminate"]
    rr_said = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with recorded_calls(wavefront_ad, "trace_wavefront_ad") as pool_calls, \
            contextlib.redirect_stdout(rr_said):
        rc_rr = cli.main(rr_argv)
    rr = {"argv": rr_argv, "seconds": time.perf_counter() - t0,
          "launches": dict(kernels.LAUNCHES), "pool_traces": len(pool_calls),
          "said": rr_said.getvalue().strip().splitlines()[-3:]}
    emit({"phase": "cli_fit", "card": nvidia_smi, "argv": argv,
          "seconds": seconds, "launches": launches,
          "said": lines[-3:], "checkpoint_step": step,
          "resumed_to_step": step2, "rr_terminate_run": rr})
    require(launches["intersect"] > 0 and launches["closest_hit"] > 0,
            f"the CLI's fit did not go through the kernels: {launches}")
    require(rc_rr == 0 and rr["pool_traces"] == CLI_FIT["steps"]
            and rr["launches"]["closest_hit"] > 0,
            f"fit --rr-terminate did not train through the pool: {rr}")
    # the gradient surrogates through the CLI
    sur_argv = (argv[:argv.index("--steps")] + ["--steps", "3"]
                + argv[argv.index("--steps") + 2:argv.index("--checkpoint")]
                + ["--boundary-samples", "8", "--rr-grad"])
    sur_said = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sur_said):
        rc_sur = cli.main(sur_argv)
    sur = {"argv": sur_argv, "seconds": time.perf_counter() - t0,
           "launches": dict(kernels.LAUNCHES),
           "said": sur_said.getvalue().strip().splitlines()[-3:]}
    emit({"phase": "cli_fit", "part": "surrogates", "card": nvidia_smi,
          **sur})
    require(rc_sur == 0 and sur["launches"]["intersect"] > 0,
            f"fit with the surrogates: {sur}")


# --------------------------------------------------------------------- #
# scatter_path phase: the deposit of frames past the ledger cap
# --------------------------------------------------------------------- #

def frame_sha256(img) -> str:
    import hashlib

    return hashlib.sha256(img.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


def scatter_cli_frame(rt, torch, run: int) -> dict:
    """The SCATTER frame through ``render --engine auto`` once: its float
    frame (read where the CLI gets it), the engine ``auto`` built, the
    frame's seconds (render_wavefront, synchronised) and the launches."""
    from raytracinginoneweekend_tpu_torch import cli, kernels
    from raytracinginoneweekend_tpu_torch.ops import wavefront

    w, h, spp, depth = (SCATTER[k] for k in ("width", "height", "spp",
                                              "depth"))
    out_png = os.path.join(kernels.BUILD_DIR, f"chip_smoke_scatter{run}.png")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    if os.path.exists(out_png):
        os.remove(out_png)
    argv = ["render", "--scene", "huge", "--engine", "auto", "--width",
            str(w), "--height", str(h), "--spp", str(spp), "--depth",
            str(depth), "--stats", "--out", out_png]
    err, said = io.StringIO(), io.StringIO()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded_calls(wavefront, "build_engine") as engines, \
            recorded_calls(wavefront, "render_wavefront",
                           torch.cuda.synchronize) as frames, \
            contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(said):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    command_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    require(rc == 0, f"cli render (scatter frame) returned {rc}")
    require(os.path.getsize(out_png) > 10000, "the PNG was not written")
    require(len(engines) == 1 and len(frames) == 1,
            f"{len(engines)} engines, {len(frames)} frames in one render")
    eng = engines[0][2]
    (img, st), frame_s = frames[0][2:]
    stats = json.loads(err.getvalue().strip().splitlines()[-1])
    return {"argv": argv, "img": img, "deposit": eng.deposit,
            "ledger_bytes_would_be": 3 * 4 * eng.n_k * eng.lanes,
            "graph": wavefront.epoch_graphable(eng),
            "seconds_per_frame": frame_s, "command_seconds": command_s,
            "iters": st["iters"], "epochs": st["iters"] // eng.flush_every,
            "stats": stats, "launches": launches, "sha256": frame_sha256(img),
            "lanes": eng.lanes, "tpp": eng.tpp}


def scatter_path_phase(rt, torch, nvidia_smi: str):
    from raytracinginoneweekend_tpu_torch import cli, kernels
    from raytracinginoneweekend_tpu_torch.ops import wavefront

    w, h, spp = (SCATTER[k] for k in ("width", "height", "spp"))
    runs = [scatter_cli_frame(rt, torch, i) for i in (1, 2)]
    first = runs[0]
    img = first["img"]
    for r in runs:
        require(r["deposit"] == "scatter" and r["ledger_bytes_would_be"]
                > wavefront.LEDGER_CAP_BYTES,
                f"auto did not pick the scatter deposit past the cap: "
                f"{r['deposit']}, {r['ledger_bytes_would_be']} bytes")
        require_fused_launches(r["launches"], r["iters"],
                               "the scatter frame")
    require(bool(torch.isfinite(img).all())
            and tuple(img.shape) == (w * h, 3), "the scatter frame")
    same_hash = runs[0]["sha256"] == runs[1]["sha256"]

    # the default frame forced onto the scatter deposit, against its
    # ledger frame: parent order L, S, S, L, each timed alone
    dev = torch.device("cuda")
    mw, mh, mspp, mdepth = (MAIN[k] for k in ("width", "height", "spp",
                                              "depth"))
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", mw, mh, dev)
    main_frames, main_s, deposits = {}, {"ledger": [], "scatter": []}, {}
    for dep in ("ledger", "scatter", "scatter", "ledger"):
        with recorded_calls(wavefront, "build_engine") as engines:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = rt.render_wavefront(
                scene, cam, rt.key_words(0), width=mw, height=mh, spp=mspp,
                max_depth=mdepth, camera_mode="thinlens", options=rt.DEFAULT,
                deposit=None if dep == "ledger" else "scatter", device=dev)
            torch.cuda.synchronize()
            main_s[dep].append(time.perf_counter() - t0)
        deposits.setdefault(dep, engines[0][2].deposit)
        main_frames.setdefault(dep, out)
    require(deposits == {"ledger": "ledger", "scatter": "scatter"},
            f"the default frame's deposits: {deposits}")
    led, sca = main_frames["ledger"], main_frames["scatter"]
    close = bool(torch.allclose(sca, led, rtol=2e-4, atol=2e-5))
    emit({"phase": "scatter_path", "card": nvidia_smi, **SCATTER,
          "camera_rays": w * h * spp,
          "runs": [{k: v for k, v in r.items() if k != "img"}
                   for r in runs],
          "same_hash_both_renders": same_hash, "mean": float(img.mean()),
          "default_frame": {
              **MAIN, "seconds_per_frame": main_s,
              "scatter_vs_ledger_max_abs": float((sca - led).abs().max()),
              "scatter_vs_ledger_within_2e-4_2e-5": close,
              "sha256": {k: frame_sha256(v)
                         for k, v in main_frames.items()}}})
    require(same_hash, "two renders of the scatter frame differ: "
            f"{runs[0]['sha256']} against {runs[1]['sha256']}")
    require(close, "the scatter deposit moved the default frame beyond "
            "rtol 2e-4 / atol 2e-5 of its ledger frame")
    return first["launches"]


# --------------------------------------------------------------------- #
# surrogate_path phase: the gradient surrogates on the card
# --------------------------------------------------------------------- #

def small_scene(rt, torch, name: str, dev):
    """The surrogate tests' small scenes (tests/test_torch_silhouette.py,
    tests/test_branchprob.py, tests/test_silhouette.py)."""
    from raytracinginoneweekend_tpu_torch.models import scene as scenes

    L, M, D = scenes.LAMBERT, scenes.METAL, scenes.DIELECTRIC
    spec = {
        "black_and_glass": ([[0.0, 0.0, -1.5], [0.6, 0.2, -2.5]],
                            [0.5, 0.4], [L, D], [[0, 0, 0], [1, 1, 1]],
                            [0, 0], [1.0, 1.5]),
        "shadow_mix": ([[0.0, -100.5, -1.0], [0.0, 1.5, -1.0],
                        [0.5, 0.0, -2.0], [-0.6, 0.1, -1.8]],
                       [100.0, 0.4, 0.5, 0.45], [L, L, M, D],
                       [[0.5, 0.5, 0.5], [0, 0, 0], [0.8, 0.7, 0.6],
                        [1, 1, 1]], [0, 0, 0.3, 0], [1, 1, 1, 1.5]),
        "black_sphere": ([[0.0, 0.0, -1.5]], [0.5], [L], [[0, 0, 0]], [0],
                         [1.0]),
        "floating_occluder": ([[0.0, -100.5, -1.0], [0.0, 1.5, -1.0]],
                              [100.0, 0.4], [L, L],
                              [[0.5, 0.5, 0.5], [0, 0, 0]], [0, 0], [1, 1]),
        "lone_glass": ([[0.0, 0.0, -2.0]], [0.6], [D], [[1, 1, 1]], [0],
                       [1.5]),
    }[name]
    c, r, mt, alb, fz, ior = spec
    n = len(r)
    return scenes.scene_from_numpy(c, r, list(range(n)), mt, alb, fz, ior,
                                   device=dev)


def surrogate_terms(rt, torch, dev) -> dict:
    """Each surrogate's value and gradient (centers, radii, ior) on ``dev``
    at the tests' small configurations, seeded."""
    import numpy as np

    from raytracinginoneweekend_tpu_torch.models import camera as cameras
    from raytracinginoneweekend_tpu_torch.ops import branchprob, silhouette

    w, h = SURROGATE_SMALL["width"], SURROGATE_SMALL["height"]
    options = dataclasses.replace(rt.DEFAULT, intersect="pallas")
    g = np.random.default_rng(0)
    cot_img = torch.from_numpy(
        g.normal(size=(w * h, 3)).astype(np.float32)).to(dev)
    ids = torch.from_numpy(g.permutation(w * h)[:400].astype(np.int32)
                           ).to(dev)
    cot = torch.from_numpy(g.normal(size=(400, 3)).astype(np.float32)
                           ).to(dev)
    key = rt.key_words(5)
    out = {}

    def run(name, scene, fn):
        leaves = {k: getattr(scene, k).clone().requires_grad_(True)
                  for k in ("centers", "radii", "ior")}
        value = fn(scene._replace(**leaves))
        value.backward()
        out[name] = {"value": float(value.detach()),
                     **{k: (v.grad.detach().cpu() if v.grad is not None
                            else torch.zeros(v.shape))
                        for k, v in leaves.items()}}

    cam_lens = cameras.make_camera((0, 0.3, 0.5), (0, 0, -1.5), (0, 1, 0),
                                   w / h, 60.0, 0.1, 1.5, device=dev)
    cam = cameras.make_camera((0, 0.3, 0.5), (0, 0, -1.5), (0, 1, 0),
                              w / h, 60.0, 0.0, 1.5, device=dev)
    run("boundary", small_scene(rt, torch, "black_and_glass", dev),
        lambda s: silhouette.boundary_surrogate(
            s, cam_lens, "thinlens", cot_img, w, h, key, 4, options,
            n_angles=64))
    mix = small_scene(rt, torch, "shadow_mix", dev)
    for vd in (0, 1):
        run(f"secondary_vd{vd}", mix,
            lambda s, vd=vd: silhouette.secondary_boundary_surrogate(
                s, cam, "pinhole", cot, ids, w, h, key, 5, options,
                n_angles=8, n_spheres=2, vertex_depth=vd))
        run(f"branchprob_vd{vd}", mix,
            lambda s, vd=vd: branchprob.branch_probability_surrogate(
                s, cam, "pinhole", cot, ids, w, h, key, 5, options,
                vertex_depth=vd))
    return out


def surrogate_fd_checks(rt, torch, dev) -> list:
    """The JAX package's finite-difference checks of the three terms
    (tests/test_silhouette.py::test_boundary_grad_matches_finite_differences,
    ::test_secondary_boundary_grad_matches_finite_differences,
    tests/test_branchprob.py::test_rr_branch_flip_matches_finite_differences)
    through the port, at their configurations and tolerances."""
    from raytracinginoneweekend_tpu_torch import optim
    from raytracinginoneweekend_tpu_torch.models import camera as cameras
    from raytracinginoneweekend_tpu_torch.render import render_pixels_impl

    options = dataclasses.replace(rt.DEFAULT, intersect="pallas")
    results = []

    def check(name, scene, cam, w, h, spp, depth, leaves, checks, eps,
              surrogate, fd_keys=(3,)):
        key = rt.key_words(3)
        ids = torch.arange(w * h, dtype=torch.int32, device=dev)
        base = render_pixels_impl(scene, cam, ids, key, width=w, height=h,
                                  spp=spp, wave_spp=spp, max_depth=depth,
                                  camera_mode="pinhole", options=options)
        target = base - 0.5

        def loss_of(params, on, k=key):
            return optim.render_loss(
                params, scene, cam, target, ids, k, width=w, height=h,
                spp=spp, max_depth=depth, camera_mode="pinhole",
                options=options, **(surrogate if on else {}))

        params = optim.params_from_scene(scene, leaves)
        loss_of(params, True).backward()
        for leaf, idx, rtol, atol in checks:
            fds = []
            for kk in fd_keys:
                with torch.no_grad():
                    up = {k: v.detach().clone() for k, v in params.items()}
                    dn = {k: v.detach().clone() for k, v in params.items()}
                    up[leaf][idx] += eps
                    dn[leaf][idx] -= eps
                    k2 = rt.key_words(kk)
                    fds.append(float((loss_of(up, False, k2)
                                      - loss_of(dn, False, k2))
                                     / (2 * eps)))
            fd = sum(fds) / len(fds)
            ad = float(params[leaf].grad[idx])
            ok = (fd != 0.0 and abs(ad - fd) <= rtol * abs(fd)
                  if rtol is not None else abs(ad - fd) < atol)
            results.append({"test": name, "leaf": leaf, "index": list(idx),
                            "ad": ad, "fd": fd, "fd_per_key": fds,
                            "rtol": rtol, "atol": atol, "ok": ok})

    w, h = 96, 72
    pin = cameras.make_camera((0, 0, 0), (0, 0, -1), (0, 1, 0), w / h, 60.0,
                              0.0, 1.0, device=dev)
    check("test_silhouette.py::test_boundary_grad_matches_finite_"
          "differences", small_scene(rt, torch, "black_sphere", dev), pin,
          w, h, 64, 2, ("centers", "radii"),
          [("centers", (0, 1), 0.12, None), ("centers", (0, 2), 5e-2, None),
           ("radii", (0,), 5e-2, None)], 0.015,
          {"boundary_samples": 2048})
    check("test_silhouette.py::test_secondary_boundary_grad_matches_finite_"
          "differences", small_scene(rt, torch, "floating_occluder", dev),
          pin, w, h, 64, 2, ("centers", "radii"),
          [("centers", (1, 1), 0.15, None), ("radii", (1,), 0.08, None),
           ("centers", (1, 0), None, 9e-4), ("centers", (1, 2), None, 9e-4)],
          0.02, {"secondary_samples": 64, "secondary_spheres": 1})
    w, h = 64, 48
    cam40 = cameras.make_camera((0, 0, 0), (0, 0, -1), (0, 1, 0), w / h,
                                40.0, 0.0, 1.0, device=dev)
    check("test_branchprob.py::test_rr_branch_flip_matches_finite_"
          "differences", small_scene(rt, torch, "lone_glass", dev), cam40,
          w, h, 64, 2, ("ior",), [("ior", (0,), 0.12, None)], 0.01,
          {"rr_grad": True}, fd_keys=(3, 5, 7))
    return results


def surrogate_step_phases(rt, torch, inverse, optim, params, scene, cam,
                          tb, ids, key, kw) -> dict:
    """One batch's full-surrogate step taken apart: the interior (the AD
    engine's forward and backward) and each surrogate's forward and
    backward alone, each synchronised, with kernel 3's launches."""
    from raytracinginoneweekend_tpu_torch import kernels

    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    full = inverse.scene_with_params(scene, p)
    out = {}
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    loss = optim.render_loss(p, scene, cam, tb, ids, key, **kw)
    loss.backward()
    torch.cuda.synchronize()
    out["interior"] = {"seconds": time.perf_counter() - t0,
                       "launches": kernels.launch_delta(
                           before, kernels.LAUNCHES)}
    with torch.no_grad():  # the cotangent the step hands the surrogates
        rendered = inverse._render_batch(
            full, cam, ids, key, width=kw["width"], height=kw["height"],
            spp=kw["spp"], max_depth=kw["max_depth"],
            camera_mode=kw["camera_mode"], options=kw["options"],
            engine="auto")
    diff = rendered - tb
    cot = 2.0 * diff / diff.numel()
    off = dict(boundary_samples=0, secondary_samples=0, rr_grad=False,
               secondary_spheres=2, secondary_vertex_depths=2,
               rr_grad_arms=2)
    for name, on in (("boundary", {"boundary_samples": 512}),
                     ("secondary", {"secondary_samples": 4}),
                     ("rr_grad", {"rr_grad": True})):
        for v in p.values():
            v.grad = None
        torch.cuda.synchronize()
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        value = inverse._attach_surrogates(
            torch.zeros((), device=cot.device), cot, full, cam,
            kw["camera_mode"], ids, key, width=kw["width"],
            height=kw["height"], max_depth=kw["max_depth"],
            options=kw["options"], **{**off, **on})
        value.backward()
        torch.cuda.synchronize()
        out[name] = {"seconds": time.perf_counter() - t0,
                     "launches": kernels.launch_delta(before,
                                                      kernels.LAUNCHES)}
    return out


def device_busy(torch, run) -> dict:
    """``run()`` once under torch.profiler, device activity only (the
    host's operator events of an eager step take minutes to collect): the
    device's busy seconds (the sum of its kernels' times) against the
    wall, or "not measured" when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    t_all = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        busy += float(dev_us) * 1e-6
    collect = time.perf_counter() - t_all - wall
    if busy <= 0:
        return {"wall_seconds_under_profiler": wall,
                "profiler_collect_seconds": collect,
                "device_time": "not measured: the profiler reported no "
                               "device time"}
    return {"wall_seconds_under_profiler": wall,
            "profiler_collect_seconds": collect,
            "device_busy_seconds": busy,
            "host_share": max(0.0, 1.0 - busy / wall)}


def surrogate_path_phase(rt, torch, nvidia_smi: str):
    import statistics

    from raytracinginoneweekend_tpu_torch import cli, kernels, optim
    from raytracinginoneweekend_tpu_torch.optim import inverse

    dev = torch.device("cuda")
    seconds = {}
    # 1. each term on the card against the same call on the CPU
    t0 = time.perf_counter()
    kernels.reset_launches()
    card = surrogate_terms(rt, torch, dev)
    terms_launches = dict(kernels.LAUNCHES)
    seconds["terms_card"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = surrogate_terms(rt, torch, torch.device("cpu"))
    seconds["terms_cpu"] = time.perf_counter() - t0
    term_cmp, pending = {}, []
    for name, got in card.items():
        want = host[name]
        rec = {"value": got["value"], "value_cpu": want["value"]}
        for leaf in ("centers", "radii", "ior"):
            scale = float(want[leaf].abs().max())
            err = float((got[leaf] - want[leaf]).abs().max())
            rec[leaf] = {"max_abs_grad": scale, "max_abs_err": err}
            pending.append((err <= SURROGATE_CARD_SHARE * scale,
                            f"{name}: {leaf} gradient on the card off the "
                            f"CPU's by {err} (largest {scale})"))
        pending.append((abs(got["value"] - want["value"])
                        <= 1e-3 * abs(want["value"]) + 1e-6,
                        f"{name}: value {got['value']} on the card, "
                        f"{want['value']} on the CPU"))
        term_cmp[name] = rec
    pending.append((all(float(card[n]["centers"].abs().max()) > 0
                        for n in card), "a term gave no centers gradient"))
    pending.append((terms_launches["intersect"] > 0,
                    f"the terms did not launch kernel 3: {terms_launches}"))

    # 2. the JAX package's finite-difference checks, through the port
    t0 = time.perf_counter()
    kernels.reset_launches()
    fd = surrogate_fd_checks(rt, torch, dev)
    fd_launches = dict(kernels.LAUNCHES)
    seconds["fd_checks"] = time.perf_counter() - t0
    pending.extend((r["ok"], f"FD check failed: {r}") for r in fd)

    # 3. the flagship full-surrogate train step
    t0 = time.perf_counter()
    f = SURROGATE_STEP
    w, h, depth = f["width"], f["height"], f["depth"]
    options = dataclasses.replace(rt.DEFAULT, intersect="pallas")
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", w, h, dev)
    target = rt.render_wavefront(scene, cam, rt.key_words(0), width=w,
                                 height=h, spp=f["spp"], max_depth=depth,
                                 camera_mode="thinlens", options=rt.DEFAULT,
                                 device=dev)
    gen = torch.Generator(device="cpu").manual_seed(1)
    perturbed = scene
    for name in ("albedo", "centers"):
        leaf = getattr(scene, name)
        noise = TRAIN["perturb"] * torch.randn(leaf.shape, generator=gen)
        perturbed = perturbed._replace(**{name: leaf + noise.to(dev)})
    params = optim.params_from_scene(perturbed, f["which"])
    kw = dict(width=w, height=h, spp=f["spp"], max_depth=depth,
              camera_mode="thinlens", options=options)
    sur = dict(boundary_samples=f["boundary_samples"],
               secondary_samples=f["secondary_samples"],
               secondary_vertex_depths=f["secondary_vertex_depths"],
               rr_grad=f["rr_grad"])
    step = optim.make_train_step(inverse.make_adam(params, TRAIN["lr"]),
                                 engine="auto", **kw, **sur)
    seconds["step_setup_and_target"] = time.perf_counter() - t0

    def batch(i):
        bk, rk = inverse.step_keys(rt.key_words(7), i)
        ids = inverse.draw_pixel_batch(bk, w * h, f["batch_pixels"], dev)
        return target[ids.to(torch.int64)], ids, rk

    n_steps = f["warmup_steps"] + f["timed_steps"]
    step_s, losses = [], []
    for i in range(n_steps):
        tb, ids, rk = batch(i)
        if i == f["warmup_steps"]:
            kernels.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            timed = timed_entry(torch, "rtw_closest_hit_n3")
            ix_ms = timed.__enter__()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(params, perturbed, cam, tb, ids, rk)))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    timed.__exit__(None, None, None)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    timed_s = step_s[f["warmup_steps"]:]
    per_step = {k: v / f["timed_steps"] for k, v in launches.items() if v}
    tb, ids, rk = batch(n_steps)
    parts = surrogate_step_phases(rt, torch, inverse, optim, params,
                                  perturbed, cam, tb, ids, rk,
                                  dict(kw, engine="auto"))
    busy = device_busy(torch, lambda: step(params, perturbed, cam, tb, ids,
                                           rk))
    if "device_busy_seconds" in busy:  # against the step without it
        busy["host_share_of_median_step"] = max(
            0.0, 1.0 - busy["device_busy_seconds"]
            / statistics.median(timed_s))
    seconds["step_part"] = time.perf_counter() - t0 - seconds[
        "step_setup_and_target"]
    emit({"phase": "surrogate_path", "card": nvidia_smi,
          "phase_seconds": seconds,
          "terms_card_vs_cpu": term_cmp, "terms_launches": terms_launches,
          "fd_checks": fd, "fd_launches": fd_launches,
          "step": {**f, "engine": "auto -> " + inverse.resolve_ad_engine(
                       depth, options.rr_terminate),
                   "rays_per_step": f["batch_pixels"] * f["spp"],
                   "step_seconds": step_s,
                   "step_seconds_median": statistics.median(timed_s),
                   "losses": losses, "launches_per_step": per_step,
                   "intersect_ms_per_step": sum(ix_ms) / f["timed_steps"],
                   "intersect_launches_timed": len(ix_ms),
                   "peak_bytes": peak, "phases": parts, "profile": busy}})
    pending.append((launches["intersect"] > 0,
                    "the full-surrogate step launched no kernel 3"))
    pending.append((all(x == x and abs(x) != float("inf") for x in losses),
                    f"non-finite loss: {losses}"))
    pending.append((all(bool(torch.isfinite(p).all())
                        for p in params.values()),
                    "non-finite parameters after the steps"))
    for cond, what in pending:
        require(cond, what)
    return launches


# --------------------------------------------------------------------- #
# adaptive_path phase: render --adaptive on the planar engine
# --------------------------------------------------------------------- #

# The equal-budget grid of scripts/bench_adaptive.py, whose CPU record is
# docs/ADAPTIVE_r04.json: 64x36, two configs, 6 keys, a 512-spp truth,
# spp_base 8, {uniform, adaptive} x {iid, stratified}. Its MSE ratios are a
# property of the estimator and the port's RNG contract is the JAX
# package's, so each ratio is held to the record within this share.
ADAPTIVE_GRID = dict(width=64, height=36, keys=6, truth_spp=512,
                     spp_base=8)
ADAPTIVE_GRID_REL = 0.01
ADAPTIVE_ARMS = ("uniform_iid", "uniform_stratified", "adaptive_iid",
                 "adaptive_stratified")


def adaptive_expected_stats(width, height, spp) -> dict:
    """The stats the JAX package's render_adaptive reports for a whole
    frame with the default tiers (its arithmetic, independent of the
    port's)."""
    p = width * height
    tiers = [[int(p * 0.0625), 4 * spp], [int(p * 0.25), spp]]
    extra = sum(n * e for n, e in tiers)
    return {"spp_base": spp, "tiers": tiers, "rays_stage1": p * spp,
            "rays_stage2": extra, "avg_spp": (p * spp + extra) / p}


def adaptive_in_process(rt, torch, *, width, height, spp, depth,
                        plain=False):
    """render_adaptive on the huge scene in this process (thin lens,
    default options) -> its frame, stats, seconds, peak device memory, the
    launches, kernel 1's device ms summed over its launches, and the
    stage-1 ranking. ``plain`` swaps kernel 1 for its plain version (on
    the card's tensors) inside the planar engine."""
    from raytracinginoneweekend_tpu_torch import adaptive, cli, kernels
    from raytracinginoneweekend_tpu_torch.ops import (cuda_segment,
                                                      integrate_planar)

    dev = torch.device("cuda")
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", width, height, dev)
    hit = integrate_planar.segment_closest_hit
    if plain:
        integrate_planar.segment_closest_hit = \
            cuda_segment.segment_closest_hit_reference
    try:
        kernels.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with recorded_calls(adaptive, "noise_order") as orders, \
                timed_entry(torch, "rtw_closest_hit") as ms:
            t0 = time.perf_counter()
            img, stats = adaptive.render_adaptive(
                scene, cam, rt.key_words(0), width=width, height=height,
                spp_base=spp, max_depth=depth, camera_mode="thinlens",
                options=cli._options("default", device=dev),
                return_stats=True)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    finally:
        integrate_planar.segment_closest_hit = hit
    return {"img": img.reshape(height, width, 3), "stats": stats,
            "seconds": seconds,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "launches": dict(kernels.LAUNCHES),
            "closest_hit_ms": sum(ms), "closest_hit_timed": len(ms),
            "order": orders[0][2]}


@contextlib.contextmanager
def kept_calls(torch, module, name: str, keep):
    """Record (call index, args, result) of the calls of ``module.name``
    whose index (from 0) is in ``keep``, every tensor cloned as the call
    saw it and returned it; the other calls pass through unrecorded (a
    whole adaptive frame's kernel-1 inputs would not fit on the card)."""
    kept, count = [], [0]
    fn = getattr(module, name)

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, (tuple, list)):
            return type(x)(clone(v) for v in x)
        return x

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        i = count[0]
        count[0] += 1
        saw = clone(args) if i in keep else None
        res = fn(*args, **kwargs)
        if saw is not None:
            kept.append((i, saw, kwargs, clone(res)))
        return res

    setattr(module, name, wrapper)
    try:
        yield kept
    finally:
        setattr(module, name, fn)


def kept_against_plain(torch, kept, label) -> dict:
    """Each kept closest_hit call of the planar engine (``kept_calls``)
    against segment_closest_hit_reference on the same card tensors, to
    the bit on every lane -> {label[i]: {lanes, hits, bit_diff, ...}}."""
    from raytracinginoneweekend_tpu_torch.closest_hit_checks import bit_diff
    from raytracinginoneweekend_tpu_torch.ops import cuda_segment as seg

    out = {}
    for i, args, kwargs, res in kept:
        require(kwargs.get("active") is None and len(args) == 6,
                "the planar engine's closest_hit call changed its form")
        t0 = time.perf_counter()
        want = seg.segment_closest_hit_reference(*args)
        torch.cuda.synchronize()
        diff = bit_diff(res, want)
        out[label[i]] = {"call": i, "lanes": int(args[0][0].numel()),
                         "rows": int(args[0][0].shape[0]),
                         "hits": int((res[0] > 0).sum()), **diff,
                         "max_abs_err": float(
                             (res[1] - want[1]).abs().max()),
                         "plain_seconds": time.perf_counter() - t0}
        require(not any(diff.values()), f"closest_hit at the adaptive "
                f"frame's {label[i]} ({args[0][0].numel()} lanes) is not "
                f"bit-equal with its plain version: {diff}")
    return out


def adaptive_cli(torch, out_ppm: str, *, width, height, spp, depth,
                 keep=()):
    """``render --adaptive`` of the huge scene through the CLI in this
    process -> (the stats line, launches, seconds of the command, the
    kernel-1 calls of the planar engine kept by index, ``kept_calls``)."""
    from raytracinginoneweekend_tpu_torch import cli, kernels
    from raytracinginoneweekend_tpu_torch.ops import integrate_planar

    argv = ["render", "--adaptive", "--scene", "huge", "--width",
            str(width), "--height", str(height), "--spp", str(spp),
            "--depth", str(depth), "--out", out_ppm]
    err, said = io.StringIO(), io.StringIO()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(said), \
            kept_calls(torch, integrate_planar, "segment_closest_hit",
                       set(keep)) as kept:
        rc = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    require(rc == 0, f"{argv} returned {rc}")
    lines = [ln for ln in err.getvalue().splitlines()
             if ln.startswith('{"adaptive"')]
    require(len(lines) == 1, f"render --adaptive printed no stats line: "
            f"{err.getvalue()[-2000:]}")
    return (json.loads(lines[0])["adaptive"], dict(kernels.LAUNCHES),
            seconds, kept)


def tier_sets(order, tiers) -> list:
    out, start = [], 0
    for n, _e in tiers:
        out.append(set(order[start:start + n].tolist()))
        start += n
    return out


def adaptive_grid(rt, torch, dev) -> dict:
    """scripts/bench_adaptive.py's equal-budget grid through the port on
    ``dev`` -> its rows, in the record's layout (ratios unrounded)."""
    import numpy as np
    from raytracinginoneweekend_tpu_torch.adaptive import render_adaptive
    from raytracinginoneweekend_tpu_torch.ops.integrate_planar import (
        render_pixels_planar)

    g = ADAPTIVE_GRID
    w, h, spp = g["width"], g["height"], g["spp_base"]
    strat = dataclasses.replace(rt.DEFAULT, sampling="stratified")
    wide = rt.make_camera((-4, 3.2, 5), (0, 1, 0), (0, 1, 0), w / h, 42.0,
                          0.5, float(np.linalg.norm((-4, 2.2, 5))),
                          device=dev)
    ids = torch.arange(w * h, dtype=torch.int32, device=dev)
    rows = []
    for label, scene, cam, depth in (
            ("simple/thinlens-wide (aperture .5) d6",
             rt.simple_scene_cuda(dev), wide, 6),
            ("huge/thinlens cover d8", rt.huge_scene(0, dev),
             rt.reference_cpu_camera(w, h, dev), 8)):
        kw = dict(width=w, height=h, max_depth=depth,
                  camera_mode="thinlens")
        with torch.no_grad():
            truth = render_pixels_planar(scene, cam, ids, rt.key_words(999),
                                         spp=g["truth_spp"],
                                         options=rt.DEFAULT, **kw)
            mses = {k: [] for k in ADAPTIVE_ARMS}
            for k in range(g["keys"]):
                key = rt.key_words(10 + k)
                img_ad, stats = render_adaptive(
                    scene, cam, key, spp_base=spp, return_stats=True,
                    options=rt.DEFAULT, **kw)
                img_ast = render_adaptive(scene, cam, key, spp_base=spp,
                                          options=strat, **kw)
                spp_match = int(np.ceil(stats["avg_spp"]))
                img_un = render_pixels_planar(scene, cam, ids, key,
                                              spp=spp_match,
                                              options=rt.DEFAULT, **kw)
                img_ust = render_pixels_planar(scene, cam, ids, key,
                                               spp=spp_match, options=strat,
                                               **kw)
                for name, img in zip(ADAPTIVE_ARMS,
                                     (img_un, img_ust, img_ad, img_ast)):
                    mses[name].append(float(((img - truth) ** 2).mean()))
        base = float(np.mean(mses["uniform_iid"]))
        rows.append({"config": label, "avg_spp_adaptive": stats["avg_spp"],
                     "spp_uniform": spp_match,
                     "mse": {k: float(np.mean(v)) for k, v in mses.items()},
                     "mse_ratio_vs_uniform_iid": {
                         k: float(np.mean(v)) / base
                         for k, v in mses.items()}})
    return {"rows": rows}


def adaptive_grid_against_record(grid: dict) -> dict:
    """Each config's MSE ratios beside docs/ADAPTIVE_r04.json's (the
    record rounds them to 4 decimals) -> {config: {arm: (ours, record,
    relative difference)}}."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "docs", "ADAPTIVE_r04.json")) as f:
        rec = {r["config"]: r for r in json.load(f)["rows"]}
    out = {}
    for row in grid["rows"]:
        want = rec[row["config"]]["mse_ratio_vs_uniform_iid"]
        out[row["config"]] = {
            arm: (got, want[arm], abs(got - want[arm]) / want[arm])
            for arm, got in row["mse_ratio_vs_uniform_iid"].items()}
    return out


def planar_tier_breakdown(rt, torch) -> dict:
    """Where the adaptive frame's time goes: its first stage-2 tier alone
    (60,000 pixels x 400 spp at full width: 24 M lanes through the planar
    engine, 50 bounces) under torch.profiler, device activity only ->
    wall, device busy, kernel 1's share, the top device ops."""
    from torch.profiler import ProfilerActivity, profile
    from raytracinginoneweekend_tpu_torch import cli
    from raytracinginoneweekend_tpu_torch.ops.integrate_planar import (
        render_pixels_planar)

    dev = torch.device("cuda")
    w, h, spp, depth = (MAIN[k] for k in ("width", "height", "spp",
                                          "depth"))
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", w, h, dev)
    ids = torch.arange(int(w * h * 0.0625), dtype=torch.int32, device=dev)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_pixels_planar(scene, cam, ids, rt.key_words(0), width=w,
                             height=h, spp=4 * spp, max_depth=depth,
                             camera_mode="thinlens", options=rt.DEFAULT,
                             sample_offset=spp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        by_name[ev.key] = (by_name.get(ev.key, (0.0, 0))[0] + us * 1e-6,
                           by_name.get(ev.key, (0.0, 0))[1] + ev.count)
    busy = sum(s for s, _n in by_name.values())
    if busy <= 0:
        return {"wall_seconds": wall, "device_time": "not measured: the "
                "profiler reported no device time"}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    hit = sum(s for k, (s, _n) in by_name.items()
              if "closest_hit_kernel" in k)
    return {"lanes": int(ids.numel()) * 4 * spp, "wall_seconds": wall,
            "device_busy_seconds": busy,
            "host_share": max(0.0, 1.0 - busy / wall),
            "closest_hit_share_of_busy": hit / busy,
            "device_kernels": sum(n for _s, n in by_name.values()),
            "top": [{"name": k[:80], "seconds": s, "count": n}
                    for k, (s, n) in top]}


def adaptive_path_phase(rt, torch, nvidia_smi: str):
    """render --adaptive at full width, through the CLI and in this
    process; at the small frame against the plain closest hit; the
    equal-budget grid against its CPU record."""
    from raytracinginoneweekend_tpu_torch import kernels
    from raytracinginoneweekend_tpu_torch.golden import compare_frames
    from raytracinginoneweekend_tpu_torch.io.image import read_ppm

    frame = {k: MAIN[k] for k in ("width", "height", "spp", "depth")}
    want_stats = adaptive_expected_stats(frame["width"], frame["height"],
                                         frame["spp"])
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    out_ppm = os.path.join(kernels.BUILD_DIR, "chip_smoke_adaptive.ppm")
    # Kernel 1 at the shapes this frame gives it, against its plain
    # version: the second bounce of stage 1's first half (48 M lanes) and
    # of the first tier (24 M lanes). The planar engine calls it once a
    # bounce: the halves, then each tier, ``depth`` calls each.
    label = {1: "stage1_half_a_bounce_2",
             2 * frame["depth"] + 1: "tier_1_bounce_2"}
    cli_stats, cli_launches, cli_s, kept = adaptive_cli(
        torch, out_ppm, keep=label, **frame)
    require(sorted(i for i, *_ in kept) == sorted(label),
            f"kept calls {[i for i, *_ in kept]}, want {sorted(label)}")
    at_shape = kept_against_plain(torch, kept, label)
    del kept
    full = adaptive_in_process(rt, torch, **frame)
    img = full["img"]
    u8 = rt.to_u8(img).cpu().numpy()
    n_launch = frame["depth"] * (2 + len(want_stats["tiers"]))
    stats = json.loads(json.dumps(full["stats"]))  # tuples as lists

    small = {k: SMALL[k] for k in ("width", "height", "spp", "depth")}
    k_run = adaptive_in_process(rt, torch, **small)
    p_run = adaptive_in_process(rt, torch, plain=True, **small)
    cmp = compare_frames(k_run["img"].cpu().numpy(),
                         p_run["img"].cpu().numpy())
    overlap = [len(a & b) / max(len(a), 1) for a, b in zip(
        tier_sets(k_run["order"], k_run["stats"]["tiers"]),
        tier_sets(p_run["order"], p_run["stats"]["tiers"]))]

    breakdown = planar_tier_breakdown(rt, torch)
    t0 = time.perf_counter()
    grid = adaptive_grid(rt, torch, torch.device("cuda"))
    grid_s = time.perf_counter() - t0
    against = adaptive_grid_against_record(grid)
    worst = max(d for row in against.values() for _g, _w, d in row.values())
    emit({"phase": "adaptive_path", "card": nvidia_smi, "scene": "huge",
          **frame,
          "cli": {"seconds": cli_s, "stats": cli_stats,
                  "launches": cli_launches},
          "in_process": {
              "seconds_per_frame": full["seconds"], "stats": stats,
              "peak_device_bytes": full["peak_bytes"],
              "launches": full["launches"],
              "closest_hit_device_seconds": full["closest_hit_ms"] / 1e3,
              "closest_hit_launches_timed": full["closest_hit_timed"],
              "finite": bool(torch.isfinite(img).all()),
              "mean": float(img.mean())},
          "cli_ppm_equals_in_process": bool((read_ppm(out_ppm) == u8).all()),
          "closest_hit_at_frame_shapes_vs_plain": at_shape,
          "first_tier_profiled": breakdown,
          "vs_plain": {**small, "compare": cmp, "tier_overlap": overlap,
                       "kernel_seconds": k_run["seconds"],
                       "plain_seconds": p_run["seconds"],
                       "stats_equal": k_run["stats"] == p_run["stats"]},
          "grid": {**ADAPTIVE_GRID, "seconds": grid_s, "rows": grid["rows"],
                   "against_ADAPTIVE_r04": against,
                   "worst_relative_difference": worst}})
    require(cli_stats == want_stats and stats == want_stats,
            f"adaptive stats {cli_stats} / {stats}, want {want_stats}")
    for run in (cli_launches, full["launches"]):
        require(run == {**dict.fromkeys(kernels.LAUNCHES, 0),
                        "closest_hit": n_launch},
                f"the adaptive frame's launches: {run}, want closest_hit "
                f"{n_launch} and nothing else")
    require(bool(torch.isfinite(img).all()), "the adaptive frame is not "
            "finite")
    require(read_ppm(out_ppm).shape == u8.shape
            and bool((read_ppm(out_ppm) == u8).all()),
            "render --adaptive wrote another image than render_adaptive")
    require(cmp["ok"] and k_run["stats"] == p_run["stats"],
            f"the adaptive frame with kernel 1 differs from its plain "
            f"version's: {cmp}")
    require(worst <= ADAPTIVE_GRID_REL,
            f"equal-budget MSE ratios leave docs/ADAPTIVE_r04.json by "
            f"{worst:.4f} relative: {against}")
    return {"img": img, "launches": full["launches"]}


# --------------------------------------------------------------------- #
# serve_path phase: the render server on the card
# --------------------------------------------------------------------- #

SERVE_FIT = dict(scene="simple-cuda", width=200, height=112, depth=8,
                 spp=2, params="albedo,centers", steps=3, fit_spp=2,
                 batch_pixels=1024)
SERVE_RESERVED_GROWTH = 0.05  # third served main frame against the first
SERVE_SHUTDOWN_S = 30


def port_command(*args) -> list:
    return [sys.executable, "-m", "raytracinginoneweekend_tpu_torch",
            *args]


def port_env() -> dict:
    repo = os.path.dirname(os.path.abspath(__file__))
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=repo + (os.pathsep + path
                                               if path else ""))


def serve_socket_path() -> str:
    """<build dir>/rtw.sock, or a fresh temporary directory's where that
    path is too long for a Unix socket."""
    import tempfile
    from raytracinginoneweekend_tpu_torch import kernels

    path = os.path.join(kernels.BUILD_DIR, "rtw.sock")
    if len(os.fsencode(path)) > 100:
        path = os.path.join(tempfile.mkdtemp(prefix="rtw"), "rtw.sock")
    return path


def timed_request(serve, sock: str, req: dict, timeout: float):
    t0 = time.perf_counter()
    resp = serve.request(sock, req, timeout=timeout)
    return resp, time.perf_counter() - t0


def trace_names(log_dir: str) -> str:
    """The text of the one trace file in ``log_dir``."""
    files = [f for f in os.listdir(log_dir) if f.endswith(".json")]
    require(len(files) == 1, f"{log_dir} holds {files}")
    with open(os.path.join(log_dir, files[0])) as f:
        return f.read()


def writer_seconds(u8, build: str) -> dict:
    """io/image's PPM and PNG writers on one frame through the native
    codec and through the Python fallback -> the best of three seconds
    each, and whether the two wrote the same bytes."""
    from raytracinginoneweekend_tpu_torch import native
    from raytracinginoneweekend_tpu_torch.io import image

    out = {}
    for ext in ("ppm", "png"):
        write, nat = getattr(image, f"write_{ext}"), getattr(native,
                                                             f"write_{ext}")
        written = {}
        for route in ("native", "python"):
            path = os.path.join(build, f"chip_smoke_writer_{route}.{ext}")
            if route == "python":
                setattr(native, f"write_{ext}", lambda p, a: False)
            try:
                secs = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    write(path, u8)
                    secs.append(time.perf_counter() - t0)
            finally:
                setattr(native, f"write_{ext}", nat)
            out[f"{ext}_{route}_seconds"] = min(secs)
            with open(path, "rb") as f:
                written[route] = f.read()
        out[f"{ext}_bytes"] = len(written["native"])
        out[f"{ext}_same_bytes"] = written["native"] == written["python"]
    return out


def serve_path_phase(rt, torch, nvidia_smi: str, adaptive_img=None):
    """The render server as a subprocess on the card: ping, the main frame
    three times, the adaptive frame, a bench, a small fit, a bad request,
    render --via from another process, shutdown; beside it a fresh
    render process, render --profile and the native codec."""
    import shutil
    from raytracinginoneweekend_tpu_torch import cli, kernels, native, serve
    from raytracinginoneweekend_tpu_torch.io.image import read_ppm

    build = kernels.BUILD_DIR
    os.makedirs(build, exist_ok=True)
    frame = {k: MAIN[k] for k in ("scene", "width", "height", "spp",
                                  "depth")}
    main_img = render(rt, torch, rt.DEFAULT, **{k: frame[k] for k in (
        "width", "height", "spp", "depth")})
    main_u8 = rt.to_u8(main_img.reshape(frame["height"], frame["width"],
                                        3)).cpu().numpy()
    if adaptive_img is None:
        adaptive_img = adaptive_in_process(
            rt, torch, **{k: frame[k] for k in ("width", "height", "spp",
                                                "depth")})["img"]
    adaptive_u8 = rt.to_u8(adaptive_img).cpu().numpy()

    sock = serve_socket_path()
    log_path = os.path.join(build, "chip_smoke_serve.log")
    res = {"phase": "serve_path", "card": nvidia_smi, "socket": sock}
    t_start = time.perf_counter()
    with open(log_path, "wb") as log:
        # The log is a file, never a pipe: an undrained pipe fills and
        # blocks the server mid-request.
        proc = subprocess.Popen(port_command("serve", "--socket", sock),
                                env=port_env(), stdout=log,
                                stderr=subprocess.STDOUT)
    try:
        deadline = time.perf_counter() + 180
        while True:  # the socket file appears at bind, before listen
            require(proc.poll() is None and time.perf_counter() < deadline,
                    f"the server did not come up: {open(log_path).read()}")
            try:
                ping = serve.request(sock, {"cmd": "ping"}, timeout=30)
                break
            except (FileNotFoundError, ConnectionRefusedError):
                time.sleep(0.1)
        res["startup_seconds"] = time.perf_counter() - t_start
        res["socket_mode"] = oct(os.stat(sock).st_mode & 0o777)
        res["ping"] = ping
        require(res["socket_mode"] == "0o600", f"socket mode "
                f"{res['socket_mode']}")
        require(ping.get("ok") and ping.get("proto") == 1
                and ping.get("device") == "cuda", f"ping: {ping}")

        mains = []
        for i in range(3):
            out = os.path.join(build, f"chip_smoke_serve_main{i}.ppm")
            resp, wall = timed_request(serve, sock, dict(
                cmd="render", out=out, **frame), timeout=300)
            require(resp.get("ok"), f"served main frame {i}: {resp}")
            mains.append({"request_seconds": wall,
                          "server_seconds": resp["seconds"],
                          "memory_reserved": resp.get("memory_reserved"),
                          "launches": resp["launches"],
                          "ppm_equals_in_process": bool(
                              (read_ppm(out) == main_u8).all())})
        res["main_frames"] = mains
        reserved = [m["memory_reserved"] for m in mains]
        growth = (reserved[2] / reserved[0] - 1) if reserved[0] else None
        res["reserved_growth_third_vs_first"] = growth

        out = os.path.join(build, "chip_smoke_serve_adaptive.ppm")
        resp, wall = timed_request(serve, sock, dict(
            cmd="render", out=out, adaptive=True, **frame), timeout=600)
        require(resp.get("ok"), f"served adaptive frame: {resp}")
        res["adaptive_frame"] = {
            "request_seconds": wall, "server_seconds": resp["seconds"],
            "memory_reserved": resp.get("memory_reserved"),
            "launches": resp["launches"],
            "ppm_equals_in_process": bool((read_ppm(out) == adaptive_u8)
                                          .all())}

        resp, wall = timed_request(serve, sock, dict(
            cmd="bench", iters=2, **frame), timeout=600)
        require(resp.get("ok"), f"bench request: {resp}")
        res["bench"] = {**resp, "request_seconds": wall}

        resp, wall = timed_request(serve, sock, dict(cmd="fit", **SERVE_FIT),
                                   timeout=600)
        require(resp.get("ok"), f"fit request: {resp}")
        res["fit"] = {**resp, "request_seconds": wall}

        bad = serve.request(sock, {"cmd": "render", "scene": "nope"},
                            timeout=60)
        res["bad_request"] = bad
        require(not bad.get("ok") and "error" in bad
                and serve.request(sock, {"cmd": "ping"}, timeout=30)["ok"],
                f"a bad request: {bad}")

        out = os.path.join(build, "chip_smoke_via.ppm")
        small = ["--scene", "huge", "--width", str(SMALL["width"]),
                 "--height", str(SMALL["height"]), "--spp",
                 str(SMALL["spp"]), "--depth", str(SMALL["depth"])]
        t0 = time.perf_counter()
        via = subprocess.run(port_command("render", "--via", sock, *small,
                                          "--out", out),
                             env=port_env(), capture_output=True, text=True,
                             timeout=300)
        res["via"] = {"rc": via.returncode, "seconds": time.perf_counter()
                      - t0, "stdout": via.stdout.strip()[-500:]}
        require(via.returncode == 0, f"render --via: {via.stdout[-2000:]}"
                f"{via.stderr[-2000:]}")

        resp = serve.request(sock, {"cmd": "shutdown"}, timeout=30)
        t0 = time.perf_counter()
        rc = proc.wait(timeout=SERVE_SHUTDOWN_S)
        res["shutdown"] = {"response": resp, "rc": rc,
                           "seconds": time.perf_counter() - t0,
                           "socket_gone": not os.path.exists(sock)}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(log_path) as f:
        res["server_log_tail"] = f.read()[-1500:]

    # a fresh process for the same frame: what the server saves
    out = os.path.join(build, "chip_smoke_cold.ppm")
    t0 = time.perf_counter()
    cold = subprocess.run(port_command(
        "render", *(f"--{k}={v}" for k, v in frame.items()), "--out", out),
        env=port_env(), capture_output=True, text=True, timeout=300)
    res["fresh_process"] = {
        "rc": cold.returncode, "seconds": time.perf_counter() - t0,
        "stdout": cold.stdout.strip()[-300:],
        "ppm_equals_in_process": cold.returncode == 0 and bool(
            (read_ppm(out) == main_u8).all())}
    require(cold.returncode == 0, f"a fresh render: {cold.stderr[-2000:]}")

    # render --profile of the small frame: a trace that names the kernels
    prof_dir = os.path.join(build, "chip_smoke_profile")
    shutil.rmtree(prof_dir, ignore_errors=True)
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        prof_rc = cli.main(["render", "--scene", "huge", "--width",
                       str(SMALL["width"]), "--height", str(SMALL["height"]),
                       "--spp", str(SMALL["spp"]), "--depth",
                       str(SMALL["depth"]), "--profile", prof_dir, "--out",
                       os.path.join(build, "chip_smoke_profile.ppm")])
    text = trace_names(prof_dir)
    res["profile"] = {"rc": prof_rc, "trace_bytes": len(text), **{
        f"names_{sym}": sym in text
        for sym in ("closest_hit_kernel", "shade_regen_kernel")}}

    lib = native.lib()
    res["native_codec"] = {"built": lib is not None,
                           "why_not": None if lib else native.build_error,
                           **(writer_seconds(main_u8, build) if lib else {})}
    emit(res)
    require(all(m["ppm_equals_in_process"] for m in mains),
            f"a served main frame differs from the in-process one: {mains}")
    require(growth is not None and growth <= SERVE_RESERVED_GROWTH,
            f"reserved memory over three served frames: {reserved}")
    require(res["adaptive_frame"]["ppm_equals_in_process"],
            "the served adaptive frame differs from the in-process one")
    require(res["bench"]["seconds_per_frame"] > 0, "bench")
    import math
    require(math.isfinite(res["fit"]["loss_end"]), f"fit: {res['fit']}")
    require(res["shutdown"]["rc"] == 0 and res["shutdown"]["socket_gone"],
            f"shutdown: {res['shutdown']}")
    n_adaptive = MAIN["depth"] * 4  # stage 1's two halves, two tiers
    require(all(m["launches"] == mains[0]["launches"] for m in mains)
            and all(mains[0]["launches"].get(k, 0) > 0
                    for k in ("closest_hit", "shade_regen", "regen_only")),
            f"the served main frames' launches: {mains}")
    require(res["adaptive_frame"]["launches"] == {"closest_hit":
                                                  n_adaptive},
            f"the served adaptive frame's launches: "
            f"{res['adaptive_frame']['launches']}")
    require(res["fresh_process"]["ppm_equals_in_process"],
            "a fresh render process wrote another main frame")
    require(res["profile"]["names_closest_hit_kernel"]
            and res["profile"]["names_shade_regen_kernel"],
            f"the profile's trace does not name the kernels: "
            f"{res['profile']}")
    require(prof_rc == 0, f"render --profile returned {prof_rc}")
    require(not lib or (res["native_codec"]["ppm_same_bytes"]
                        and res["native_codec"]["png_same_bytes"]),
            f"the native codec wrote other bytes: {res['native_codec']}")
    return mains[0]["launches"]


# --------------------------------------------------------------------- #
# sharded_path phase: the mesh of workers and the tail reserve
# --------------------------------------------------------------------- #

# The sharded path's bounds: a strided multi-worker frame against the
# one-worker frame (the JAX package's tests/test_parallel.py, a pixel's
# tasks added in another order), the reserve frame against the reserve-off
# frame (its tests/test_wavefront.py) and a sharded train step's gradients
# against one device's (its tests/test_parallel.py).
SHARD_RTOL, SHARD_ATOL = 2e-4, 2e-5
RESERVE_TOL = 2e-6
GRAD_RTOL, GRAD_ATOL = 2e-5, 1e-7
RESERVE_FRAC = 0.15
SHARD_WORKERS = 4
DUAL_SHARD_SPP = 4  # the host-bound dual frames, cut in spp (not width)
# the kernels the sharded path must launch (its launch counts in the
# kernels line): 1, 2 (fused and regen-only), 3 (the tiled engine), 4, 5
SHARDED_KERNELS = ("closest_hit", "shade_regen", "regen_only", "intersect",
                   "closest_hit_list", "closest_hit_sorted")

SHARD_RANK = r"""
import json, sys, time
import numpy as np
import torch
coord, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
t_start = time.perf_counter()
from raytracinginoneweekend_tpu_torch.parallel import distributed
distributed.initialize_distributed(coord, 2, rank, backend="gloo")
import raytracinginoneweekend_tpu_torch as rt
from raytracinginoneweekend_tpu_torch import cli, parallel
w, h, spp, depth, pool = (int(a) for a in sys.argv[4:9])
dev = torch.device("cuda")
scene = cli._build_scene("huge", 0, dev)
cam = cli._build_camera("cpu", w, h, dev)
mesh = parallel.make_mesh()
assert (mesh.size, mesh.first) == (2, rank), mesh
secs = []
for _ in range(2):  # the first loads the kernels and captures the graph
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = parallel.render_wavefront_sharded(
        scene, cam, rt.key_words(0), mesh=mesh, width=w, height=h, spp=spp,
        max_depth=depth, camera_mode="thinlens", options=rt.DEFAULT,
        pool_size=pool)
    torch.cuda.synchronize()
    secs.append(time.perf_counter() - t0)
if rank == 0:
    np.save(out, img.cpu().numpy())
torch.distributed.destroy_process_group()
print(json.dumps({"rank": rank, "frame_seconds": secs,
                  "process_seconds": time.perf_counter() - t_start}))
"""


def frame_hash(img) -> str:
    import hashlib

    return hashlib.sha256(img.cpu().numpy().tobytes()).hexdigest()


def close_frames(torch, got, want, rtol: float, atol: float) -> dict:
    """got against want elementwise: the largest difference and whether
    every element is within rtol / atol."""
    diff = (got - want).abs()
    return {"max_abs_diff": float(diff.max()),
            "within": bool((diff <= atol + rtol * want.abs()).all()),
            "bit_equal": bool(torch.equal(got, want))}


def occupancy(stats_list) -> float:
    """Traced lane-iterations over the lanes' iterations, all workers."""
    return (sum(s["segments"] for s in stats_list)
            / sum(s["iters"] * s["lanes"] for s in stats_list))


def two_rank_frames(torch, frame: dict, pool: int) -> list:
    """Two processes on the one card, each one worker of a 2-worker mesh
    under a gloo process group -> [each rank's record], rank 0's frame
    under its "img". A rank that fails fails the phase."""
    import socket
    import tempfile

    import numpy as np

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = os.path.join(tempfile.mkdtemp(prefix="rtw"), "rank0.npy")
    args = [str(frame[k]) for k in ("width", "height", "spp", "depth")]
    procs = [subprocess.Popen(
        [sys.executable, "-c", SHARD_RANK, f"127.0.0.1:{port}", str(rank),
         out, *args, str(pool)], env=port_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(2)]
    recs = []
    try:
        for rank, p in enumerate(procs):
            said, err = p.communicate(timeout=300)
            require(p.returncode == 0,
                    f"rank {rank} returned {p.returncode}: {err[-3000:]}")
            recs.append(json.loads(said.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs[0]["img"] = torch.from_numpy(np.load(out)).to("cuda")
    return recs


def sharded_train_step(rt, torch, mesh) -> dict:
    """One train step's gradients at train_path's shape (huge scene, the
    1200x800 camera, 16384 px x 8 spp, depth 16, the planar engine) from
    perturbed parameters, one device against ``mesh``."""
    from raytracinginoneweekend_tpu_torch import cli, optim
    from raytracinginoneweekend_tpu_torch.optim import inverse

    dev = torch.device("cuda")
    w, h, depth = TRAIN["width"], TRAIN["height"], TRAIN["depth"]
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", w, h, dev)
    gen = torch.Generator(device="cpu").manual_seed(1)
    perturbed = scene
    for name in ("albedo", "centers"):
        leaf = getattr(scene, name)
        noise = TRAIN["perturb"] * torch.randn(leaf.shape, generator=gen)
        perturbed = perturbed._replace(**{name: leaf + noise.to(dev)})
    ids = inverse.draw_pixel_batch((9, 9), w * h, TRAIN["batch_pixels"],
                                   dev)
    kw = dict(width=w, height=h, spp=TRAIN["spp"], max_depth=depth,
              camera_mode="thinlens", options=rt.DEFAULT)
    with torch.no_grad():
        target = rt.render_pixels(scene, cam, ids, rt.key_words(0),
                                  wave_spp=TRAIN["spp"], **kw)
    out = {}
    for key, m in (("one_device", None), ("mesh", mesh)):
        params = optim.params_from_scene(perturbed, ("albedo", "centers"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = optim.render_loss(params, perturbed, cam, target, ids,
                                 rt.key_words(1), engine="planar", mesh=m,
                                 **kw)
        loss.backward()
        torch.cuda.synchronize()
        out[key] = {"seconds": time.perf_counter() - t0,
                    "loss": float(loss.detach()),
                    "grads": {k: v.grad for k, v in params.items()}}
    res = {"workers": mesh.size, "batch_pixels": TRAIN["batch_pixels"],
           "spp": TRAIN["spp"], "depth": depth,
           "seconds_one_device": out["one_device"]["seconds"],
           "seconds_mesh": out["mesh"]["seconds"],
           "loss_one_device": out["one_device"]["loss"],
           "loss_mesh": out["mesh"]["loss"], "leaves": {}}
    ok = True
    for k, want in out["one_device"]["grads"].items():
        got = out["mesh"]["grads"][k]
        diff = (got - want).abs()
        within = bool((diff <= GRAD_ATOL + GRAD_RTOL * want.abs()).all())
        res["leaves"][k] = {
            "max_abs_diff": float(diff.max()),
            "max_abs_grad": float(want.abs().max()),
            "outside": int((diff > GRAD_ATOL + GRAD_RTOL * want.abs()).sum()),
            "within": within}
        ok &= within and bool(torch.isfinite(got).all())
    res["ok"] = ok
    return res


def worker_offset_kernel2(rt, torch) -> dict:
    """Kernel 2's fused and regen-only entries on a mid-frame state of
    worker 1 of SHARD_WORKERS (strided: first task P, stride 4P; tile:
    worker_base > 0), each against its plain version as in ``kernels``."""
    from raytracinginoneweekend_tpu_torch.ops import cuda_segment, wavefront

    w, h, spp, depth = (MAIN[k] for k in ("width", "height", "spp",
                                          "depth"))
    out = {}
    for name, options in (
            ("strided", rt.DEFAULT),
            ("tile", dataclasses.replace(rt.DEFAULT, ownership="tile"))):
        eng = wavefront.build_engine(
            *eng_scene(rt, torch, w, h), width=w, height=h, spp=spp,
            max_depth=depth, camera_mode="thinlens", options=options,
            pool_size=1 << 15, worker_index=1, n_workers=SHARD_WORKERS,
            device=torch.device("cuda"))
        state = mid_frame_state(eng, 8)
        seg = cuda_segment.segment_closest_hit(
            tuple(state[4:10]), *eng.sphere_params[:4], eng.t_min,
            active=state[3], table=eng.htable)
        res = shade_regen_entries(torch, eng, state, seg, timed=False)
        res["stride"], res["worker_base"] = eng.stride, eng.base
        res["first_task"] = int(wavefront.engine_initial_state(eng)[0][0, 0])
        out[name] = res
        for entry in ("shade_regen", "regen_only"):
            require(res[entry]["ok"]
                    and res[entry]["max_abs_err"] <= RESERVE_TOL,
                    f"{entry} at worker 1 of {SHARD_WORKERS} ({name}) "
                    f"disagrees with its plain version: {res[entry]}")
        require(res["launch_shapes_bit_equal"],
                f"kernel 2 at worker 1 ({name}): a launch shape differs")
    return out


def sharded_cli_frame(rt, torch, want, pool: int) -> dict:
    """``render --engine wavefront-sharded`` through the CLI at the main
    frame (a mesh of every local card) -> its seconds and whether its PPM
    is ``want`` quantized, as the CLI quantizes."""
    from raytracinginoneweekend_tpu_torch import cli, kernels
    from raytracinginoneweekend_tpu_torch.io.image import read_ppm

    w, h, spp, depth = (MAIN[k] for k in ("width", "height", "spp",
                                          "depth"))
    out_ppm = os.path.join(kernels.BUILD_DIR, "chip_smoke_sharded.ppm")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    if os.path.exists(out_ppm):
        os.remove(out_ppm)
    argv = ["render", "--scene", "huge", "--width", str(w), "--height",
            str(h), "--spp", str(spp), "--depth", str(depth), "--engine",
            "wavefront-sharded", "--pool-size", str(pool), "--out", out_ppm]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(argv)
    seconds = time.perf_counter() - t0
    require(rc == 0, f"{argv} returned {rc}")
    u8 = rt.to_u8(want.reshape(h, w, 3)).cpu().numpy()
    return {"argv": argv, "seconds": seconds,
            "ppm_equals_one_card_mesh": bool((read_ppm(out_ppm) == u8).all())}


def eng_scene(rt, torch, w, h):
    from raytracinginoneweekend_tpu_torch import cli

    dev = torch.device("cuda")
    return (cli._build_scene("huge", 0, dev),
            cli._build_camera("cpu", w, h, dev), rt.key_words(0))


def sharded_path_phase(rt, torch, nvidia_smi: str):
    from raytracinginoneweekend_tpu_torch import golden, kernels, parallel
    from raytracinginoneweekend_tpu_torch.ops import wavefront_dual

    w, h, spp, depth = (MAIN[k] for k in ("width", "height", "spp",
                                          "depth"))
    pool = 1 << 15
    dev = torch.device("cuda")
    scene, cam, key = eng_scene(rt, torch, w, h)
    frame = dict(width=w, height=h, spp=spp, max_depth=depth,
                 camera_mode="thinlens", pool_size=pool)
    one = parallel.make_mesh()
    four = parallel.make_mesh([dev] * SHARD_WORKERS)
    two = parallel.make_mesh([dev] * 2)
    require(one.size == 1 and four.size == SHARD_WORKERS,
            f"the meshes: {one}, {four}")
    tile_sorted = dataclasses.replace(rt.DEFAULT, ownership="tile",
                                      hit_kernel="sorted")

    def sharded(mesh, options=rt.DEFAULT, **kw):
        return parallel.render_wavefront_sharded(
            scene, cam, key, mesh=mesh, options=options, **frame, **kw)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    res = {}
    kernels.reset_launches()
    # (a) the one-card mesh against the unsharded frame
    _, (base, base_st) = timed(lambda: rt.render_wavefront(
        scene, cam, key, options=rt.DEFAULT, return_stats=True,
        device=dev, **frame))
    sec_base, _ = timed(lambda: rt.render_wavefront(
        scene, cam, key, options=rt.DEFAULT, device=dev, **frame))
    sharded(one)
    sec_one, img_one = timed(lambda: sharded(one))
    res["a_one_card_mesh"] = {
        "seconds_per_frame": sec_one,
        "unsharded_seconds_per_frame": sec_base,
        **close_frames(torch, img_one, base, 0.0, 0.0)}
    # (b) four workers on the one card; two runs hash the same
    sec_four, (img_four, st4) = timed(lambda: sharded(four,
                                                      return_stats=True))
    img_four2 = sharded(four)
    res["b_four_workers"] = {
        "seconds_per_frame_first": sec_four,
        **close_frames(torch, img_four, img_one, SHARD_RTOL, SHARD_ATOL),
        "hash": frame_hash(img_four), "hash_again": frame_hash(img_four2),
        "occupancy": occupancy(st4["workers"]),
        "iters_by_worker": [s["iters"] for s in st4["workers"]]}
    res["b_four_workers"]["seconds_per_frame"], _ = timed(
        lambda: sharded(four))
    # tile ownership + the sorted kernel: bit-equal with one worker
    t1 = rt.render_wavefront(scene, cam, key, options=tile_sorted,
                             device=dev, **frame)
    t4 = sharded(four, tile_sorted)
    res["b_tile_sorted"] = {**close_frames(torch, t4, t1, 0.0, 0.0),
                            "seconds_per_frame": timed(
                                lambda: sharded(four, tile_sorted))[0]}
    # the tiled engine (kernel 3) over four workers against render(), at
    # the training target's frame; rays_per_chunk is one worker's pixels,
    # so render()'s chunks trace the same waves as the workers' shards
    tcfg = rt.RenderConfig(
        width=w, height=h, spp=TRAIN["target_spp"], max_depth=TRAIN["depth"],
        camera_mode="thinlens", rays_per_chunk=w * h // SHARD_WORKERS,
        options=dataclasses.replace(rt.DEFAULT, intersect="pallas"))
    sec_t1, tiled1 = timed(lambda: rt.render(scene, cam, tcfg, key,
                                             device=dev))
    ix0 = kernels.LAUNCHES["intersect"]
    sec_t4, tiled4 = timed(lambda: parallel.render_image_sharded(
        scene, cam, tcfg, key, mesh=four))
    res["b_tiled_four_workers"] = {
        "spp": tcfg.spp, "depth": tcfg.max_depth,
        "rays_per_chunk": tcfg.rays_per_chunk,
        "seconds_unsharded": sec_t1, "seconds_four_workers": sec_t4,
        "intersect_launches": kernels.LAUNCHES["intersect"] - ix0,
        **close_frames(torch, tiled4, tiled1, 0.0, 0.0)}
    # the CLI's sharded engine over every local card (the one H100): (a)
    res["a_cli"] = sharded_cli_frame(rt, torch, img_one, pool)
    # (d) the tail reserve at one and at four workers
    _, (r1, r1_st) = timed(lambda: rt.render_wavefront(
        scene, cam, key, options=rt.DEFAULT, reserve_frac=RESERVE_FRAC,
        return_stats=True, device=dev, **frame))
    sec_r1, _ = timed(lambda: rt.render_wavefront(
        scene, cam, key, options=rt.DEFAULT, reserve_frac=RESERVE_FRAC,
        device=dev, **frame))
    r4, r4_st = sharded(four, reserve_frac=RESERVE_FRAC, return_stats=True)
    sec_r4, _ = timed(lambda: sharded(four, reserve_frac=RESERVE_FRAC))
    res["d_reserve"] = {
        "reserve_frac": RESERVE_FRAC,
        "one_worker": {**close_frames(torch, r1, base, RESERVE_TOL,
                                      RESERVE_TOL),
                       "seconds_per_frame": sec_r1,
                       "seconds_per_frame_off": sec_base,
                       "occupancy": occupancy([r1_st]),
                       "occupancy_off": occupancy([base_st]),
                       "iters": r1_st["iters"], "iters_off": base_st["iters"],
                       "segments": r1_st["segments"],
                       "segments_off": base_st["segments"]},
        "four_workers": {**close_frames(torch, r4, img_four, RESERVE_TOL,
                                        RESERVE_TOL),
                         "seconds_per_frame": sec_r4,
                         "seconds_per_frame_off":
                             res["b_four_workers"]["seconds_per_frame"],
                         "occupancy": occupancy(r4_st["workers"]),
                         "occupancy_off": occupancy(st4["workers"])}}
    # (f) the dual engine over two workers against one (spp cut)
    dkw = dict(width=w, height=h, spp=DUAL_SHARD_SPP, max_depth=depth,
               camera_mode="thinlens", options=rt.DEFAULT,
               pool_size=DUAL_POOL)
    sec_d1, d1 = timed(lambda: wavefront_dual.render_wavefront_dual(
        scene, cam, key, device=dev, **dkw))
    sec_d2, d2 = timed(lambda: parallel.render_wavefront_dual_sharded(
        scene, cam, key, mesh=two, **dkw))
    dcmp = golden.compare_frames(d2.cpu().numpy(), d1.cpu().numpy(),
                                 atol=5e-4)
    res["f_dual_two_workers"] = {
        "spp": DUAL_SHARD_SPP, "pool_size_per_worker": DUAL_POOL,
        "seconds_per_frame_one_worker": sec_d1,
        "seconds_per_frame_two_workers": sec_d2, "frame_rule": dcmp,
        "max_abs_diff": float((d2 - d1).abs().max())}
    # (e) one train step's gradients over two workers against one device
    res["e_train_step"] = sharded_train_step(rt, torch, two)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    # (c) two processes sharing the card, against the in-process frame
    img_two = sharded(two)
    ranks = two_rank_frames(torch, dict(width=w, height=h, spp=spp,
                                        depth=depth), pool)
    res["c_two_processes"] = {
        "ranks": [{k: v for k, v in r.items() if k != "img"}
                  for r in ranks],
        **close_frames(torch, ranks[0]["img"], img_two, 0.0, 0.0)}
    # (g) kernel 2 at worker 1 of 4
    res["g_kernel2_worker_offset"] = worker_offset_kernel2(rt, torch)
    emit({"phase": "sharded_path", "card": nvidia_smi, **MAIN,
          "pool_size_per_worker": pool, "launches": launches, **res})

    require(res["a_one_card_mesh"]["bit_equal"],
            f"(a) the one-card mesh's frame is not the unsharded frame: "
            f"{res['a_one_card_mesh']}")
    require(res["a_cli"]["ppm_equals_one_card_mesh"],
            f"(a) render --engine wavefront-sharded wrote another image: "
            f"{res['a_cli']}")
    require(res["b_tiled_four_workers"]["bit_equal"]
            and res["b_tiled_four_workers"]["intersect_launches"] > 0,
            f"(b) the tiled engine over four workers is not render()'s "
            f"frame: {res['b_tiled_four_workers']}")
    b = res["b_four_workers"]
    require(b["within"] and b["hash"] == b["hash_again"]
            and bool(torch.isfinite(img_four).all()),
            f"(b) four workers on the card: {b}")
    require(res["b_tile_sorted"]["bit_equal"],
            f"(b) tile + sorted over four workers is not the one-worker "
            f"frame: {res['b_tile_sorted']}")
    require(res["c_two_processes"]["bit_equal"],
            f"(c) rank 0's frame is not the in-process 2-worker frame: "
            f"{res['c_two_processes']}")
    d = res["d_reserve"]
    require(d["one_worker"]["within"] and d["four_workers"]["within"]
            and d["one_worker"]["segments"] == d["one_worker"][
                "segments_off"],
            f"(d) the reserve frames: {d}")
    require(res["e_train_step"]["ok"],
            f"(e) the sharded step's gradients: {res['e_train_step']}")
    require(dcmp["ok"], f"(f) the dual engine over two workers: {dcmp}")
    for name in SHARDED_KERNELS:
        require(launches[name] > 0,
                f"the sharded path launched no {name}: {launches}")
    return {"launches": launches}


# The full frame's mean against the 240x160 @ 8 spp frame's: two Monte-Carlo
# estimates of nearly the same integral (the small one stops at depth 12).
MEAN_TOL = 1e-3


def split_loop_sass(lib: str, kernel: str, loop_only: bool,
                    splits=(1, 2, 4, 8, 16, 32), guard: str = "ge") -> dict:
    """Facts of a split-loop kernel (closest_hit_kernel,
    closest_hit_sorted_kernel, mega_bounce_kernel, closest_hit_mxu_kernel,
    closest_hit_list_kernel, intersect_kernel or
    closest_hit_grouped_kernel, instantiated at each K of ``splits``), read
    from its built library with cuobjdump: for each K, registers, stack and
    local memory (-res-usage; a spill would show as local memory), and from
    the SASS its instruction count, its CALLs, the sqrt slow-path calls
    among them (a CALL within 8 instructions after a MUFU.RSQ: the IEEE
    sqrtf leaves its fast path for arguments outside the normal range, a
    negative one included), and ``sqrt_only_where_disc_ge_0`` (with
    ``guard="gt"``, for the t-space kernels, ``sqrt_only_where_disc_gt_0``):
    for every MUFU.RSQ of the sphere loop, the nearest branch before it is
    ``@!Pn BRA`` and Pn was last set by ``FSETP.GE ... Rx, RZ``
    (``FSETP.GT``) on the register Rx that the MUFU.RSQ takes -- a negative
    discriminant
    (with ``gt`` a zero one too) branches around the sqrt and its slow
    path. The sphere loop is the whole of closest_hit_kernel;
    with ``loop_only`` it is the code from the first 128-bit shared-memory
    load (LDS.128: the loop reads the sphere table as float4s) to the last
    branch back to one of them (the loop's back edge), which leaves out
    the sorted kernel's exit terms (1 / sqrt(a) and |o - oc|, before the
    loop), the whole-bounce kernel's shade (after it) and the mxu kernel's
    true division t = q / a, whose slow-path routine holds a MUFU.RSQ of
    a NaN constant."""
    import re
    from raytracinginoneweekend_tpu_torch import kernels

    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")

    def dump(flag):
        return subprocess.run([cuobjdump, flag, lib], capture_output=True,
                              text=True, check=True).stdout

    def key(name):
        k = re.search(rf"{kernel}ILi(\d+)E", name)
        return f"K{k.group(1)}" if k else None

    out, cur = {}, None
    for line in dump("-res-usage").splitlines():
        m = re.search(r"Function (\S+?):?\s*$", line)
        if m:
            cur = key(m.group(1))
            continue
        if cur is not None and "REG:" in line:
            use = dict(re.findall(r"(\w+):(\d+)", line))
            out[cur] = {"registers": int(use["REG"]),
                        "stack_bytes": int(use["STACK"]),
                        "local_bytes": int(use["LOCAL"])}
            cur = None
    code, addr, cur = {}, {}, None
    for line in dump("-sass").splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = key(m.group(1))
            cur = code.setdefault(k, []) if k else None
            at = addr.setdefault(k, []) if k else None
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if cur is not None and m:
            at.append(int(m.group(1), 16))
            cur.append(m.group(2))

    def guarded(ins, r):
        src = re.match(r"MUFU\.RSQ R\d+, (R\d+)", ins[r])
        bra = next((i for i in range(r - 1, -1, -1)
                    if re.search(r"\bBRA\b", ins[i])), None)
        if src is None or bra is None:
            return False
        p = re.match(r"@!(P\d) BRA", ins[bra])
        if p is None:
            return False
        setp = next((i for i in range(bra - 1, -1, -1)
                     if re.match(rf"\S+ {p.group(1)},", ins[i])), None)
        return setp is not None and re.match(
            rf"FSETP\.{guard.upper()}U?\.AND {p.group(1)}, PT, "
            rf"{src.group(1)}, RZ", ins[setp]) is not None

    for name, ins in code.items():
        rsq = [i for i, x in enumerate(ins) if x.startswith("MUFU.RSQ")]
        slow = {i for r in rsq for i in range(r + 1, min(r + 9, len(ins)))
                if ins[i].startswith("CALL")}
        lds = [i for i, x in enumerate(ins) if x.startswith("LDS.128")]
        end = lds[-1] if lds else -1
        for i, x in enumerate(ins):  # the last back edge into the loop
            b = re.search(r"\bBRA\b.*?0x([0-9a-f]+)$", x)
            if b and lds and addr[name][lds[0]] <= int(b.group(1), 16) \
                    <= addr[name][lds[-1]] and i > end:
                end = i
        loop = [r for r in rsq if not loop_only
                or (lds and lds[0] < r < end)]
        out.setdefault(name, {}).update(
            sass_instructions=len(ins),
            calls=sum(x.startswith("CALL") for x in ins),
            mufu_rsq=len(rsq), mufu_rsq_sphere_loop=len(loop),
            sqrt_slow_path_calls=len(slow),
            **{f"sqrt_only_where_disc_{guard}_0": bool(loop) and all(
                guarded(ins, r) for r in loop)})
    require(sorted(out) == sorted(f"K{k}" for k in splits)
            and all("registers" in v and "mufu_rsq" in v
                    for v in out.values()),
            f"cuobjdump report of {kernel} incomplete: {out}")
    return out


def shade_regen_sass(lib: str) -> dict:
    """Facts of kernel 2's three instantiations (one an entry), read from a
    built library with cuobjdump: registers, stack and
    spill (local) bytes (-res-usage), and the local-memory loads and stores
    in the SASS -- those of the sinf/cosf slow path's reduction table are
    expected; an indexed lane array would add many more."""
    import re
    from raytracinginoneweekend_tpu_torch import kernels

    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    modes = {"1": "shade_only", "2": "regen_only", "3": "shade_regen"}

    def key(name):
        m = re.search(r"shade_regen_kernelILi(\d)EE", name)
        return modes[m.group(1)] if m else None

    def dump(flag):
        return subprocess.run([cuobjdump, flag, lib], capture_output=True,
                              text=True, check=True).stdout

    out, cur = {}, None
    for line in dump("-res-usage").splitlines():
        m = re.search(r"Function (\S+?):?\s*$", line)
        if m:
            cur = key(m.group(1))
            continue
        if cur is not None and "REG:" in line:
            use = dict(re.findall(r"(\w+):(\d+)", line))
            out[cur] = {"registers": int(use["REG"]),
                        "stack_bytes": int(use["STACK"]),
                        "local_bytes": int(use["LOCAL"]), "ldl": 0, "stl": 0}
            cur = None
    for line in dump("-sass").splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = key(m.group(1))
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?P\d\s+)?(LDL|STL)\b",
                      line)
        if cur in out and m:
            out[cur][m.group(1).lower()] += 1
    require(sorted(out) == sorted(modes.values()),
            f"cuobjdump report of shade_regen_kernel "
            f"incomplete: {out}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of " + ", ".join(PHASES))
    ap.add_argument("--arm-spp", type=int, default=MAIN["spp"],
                    help="samples per pixel of the two estimator arms "
                         "(cut this first if the run nears its time limit)")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in PHASES:
            ap.error(f"unknown phase {p!r}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script checks the port on the card and does "
              "not fall back to the CPU", file=sys.stderr)
        return 1

    import raytracinginoneweekend_tpu_torch as rt
    from raytracinginoneweekend_tpu_torch import kernels
    from raytracinginoneweekend_tpu_torch.ops import cuda_segment as seg

    t_start = time.perf_counter()
    nvidia_smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = kernels.build(verbose=True)
    for name in kernels.ENTRIES:
        kernels.entry(name)
    try:
        sass = {name: split_loop_sass(
                    libs[f"{name}.cu"], f"{name}_kernel",
                    loop_only=name != "closest_hit")
                for name in ("closest_hit", "closest_hit_sorted",
                             "mega_bounce", "closest_hit_mxu",
                             "closest_hit_list")}
        emit({"phase": "closest_hit_build", "kernels": sass["closest_hit"],
              **{name: facts for name, facts in sass.items()
                 if name != "closest_hit"}})
        for name, facts in sass.items():
            require(all(v["sqrt_only_where_disc_ge_0"]
                        for v in facts.values()),
                    f"{name}_kernel takes a sqrt in its sphere loop that a "
                    f"negative discriminant can reach: {facts}")
            require(all(v["local_bytes"] == 0 for v in facts.values()),
                    f"{name}_kernel spills to local memory: {facts}")
        tsass = {name: split_loop_sass(
                     libs[f"{name}.cu"], f"{name}_kernel", loop_only=True,
                     splits=splits, guard="gt")
                 for name, splits in (
                     ("intersect", seg.CH_SPLITS),
                     ("closest_hit_grouped", seg.GROUPED_SPLITS))}
        emit({"phase": "intersect_build", **tsass})
        for name, facts in tsass.items():
            require(all(v["sqrt_only_where_disc_gt_0"]
                        for v in facts.values()),
                    f"{name}_kernel takes a sqrt in its sphere loop that a "
                    f"discriminant <= 0 can reach: {facts}")
            require(all(v["local_bytes"] == 0 for v in facts.values()),
                    f"{name}_kernel spills to local memory: {facts}")
        emit({"phase": "shade_regen_build",
              "kernels": shade_regen_sass(libs["shade_regen.cu"])})
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    emit({"phase": "device", "card": nvidia_smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "nvcc_flags": list(kernels.NVCC_FLAGS),
          "kernel_build_seconds": kernels.build_seconds})

    out = {}
    runs = {
        "kernels": lambda: kernels_phase(rt, torch, nvidia_smi),
        "grad_vs_plain": lambda: grad_vs_plain_phase(rt, torch, nvidia_smi),
        "frame_vs_plain": lambda: frame_vs_plain_phase(rt, torch,
                                                       nvidia_smi),
        "frame_vs_golden": lambda: frame_vs_golden_phase(rt, torch,
                                                         nvidia_smi),
        "main_path": lambda: main_path_phase(
            rt, torch, nvidia_smi, out.get("frame_vs_plain"), args.arm_spp),
        "coherent_path": lambda: coherent_path_phase(rt, torch, nvidia_smi),
        "grouped_path": lambda: grouped_path_phase(rt, torch, nvidia_smi),
        "mega_path": lambda: mega_path_phase(rt, torch, nvidia_smi),
        "scatter_path": lambda: scatter_path_phase(rt, torch, nvidia_smi),
        "train_path": lambda: train_path_phase(rt, torch, nvidia_smi),
        "surrogate_path": lambda: surrogate_path_phase(rt, torch,
                                                       nvidia_smi),
        "cli_fit": lambda: cli_fit_phase(rt, torch, nvidia_smi),
        "adaptive_path": lambda: adaptive_path_phase(rt, torch, nvidia_smi),
        "serve_path": lambda: serve_path_phase(
            rt, torch, nvidia_smi,
            (out.get("adaptive_path") or {}).get("img")),
        "sharded_path": lambda: sharded_path_phase(rt, torch, nvidia_smi),
    }
    try:
        for phase in PHASES:
            if phase in phases:
                t0 = time.perf_counter()
                out[phase] = runs[phase]()
                print(f"chip_smoke: {phase} took "
                      f"{time.perf_counter() - t0:.1f} s", file=sys.stderr,
                      flush=True)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    line, launches, train = (out.get(k) for k in (
        "kernels", "main_path", "train_path"))
    coherent_launches = out.get("coherent_path")

    if phases != list(PHASES):
        print(f"chip_smoke: ran only {phases}; no verdict", file=sys.stderr)
        return 5
    line += [out["grouped_path"], out["mega_path"]]
    train_launches, pool_launches = train["planar"], train["pool"]
    for k in line:
        # each kernel's count on the path that runs it: the forward render
        # for closest_hit, shade_regen and regen_only (its prologue), the
        # coherent engines' full-width frames for the list, sorted and mxu
        # kernels and shade_only (--fusion off), the training path
        # for intersect (and closest_hit again, under autograd), the
        # grouped path's three trace_segment(group_params=...) calls, the
        # full-width --fusion bounce frame for mega_bounce (both set by
        # their phases), and the AD pool's fit steps at depth AD_DEPTH for
        # the pool's shade op
        name = k["name"]
        if name in AS_ENTRIES:
            k["launches"] = pool_launches[name]
        elif name in ("closest_hit_list", "closest_hit_sorted",
                      "closest_hit_mxu", "shade_only"):
            k["launches"] = coherent_launches[name]
        elif name not in ("closest_hit_grouped", "mega_bounce"):
            k["launches"] = (train_launches if name == "intersect"
                             else launches)[name]
        k["launches_train_path"] = train_launches[name]
        k["launches_pool_path"] = pool_launches[name]
        if name in ("closest_hit", "shade_regen", "regen_only"):
            # the frame past the ledger cap (its own main path)
            k["launches_scatter_path"] = out["scatter_path"][name]
        if name in ("intersect", "closest_hit", *AS_ENTRIES):
            # the full-surrogate step: kernel 3 in the probe traces and
            # attached hops, kernel 1 and the shade op in the AD pool
            k["launches_surrogate_path"] = out["surrogate_path"][name]
        if name == "closest_hit":
            # the full-width render --adaptive (the planar engine)
            k["launches_adaptive_path"] = \
                out["adaptive_path"]["launches"][name]
        if name in ("closest_hit", "shade_regen", "regen_only"):
            # one served main frame, counted by the server
            k["launches_serve_path"] = out["serve_path"].get(name, 0)
        if name in SHARDED_KERNELS:
            # the mesh's frames through the API and the CLI, the
            # reserve's, the tiled and the dual engine over workers and
            # the sharded train step (sharded_path)
            k["launches_sharded_path"] = \
                out["sharded_path"]["launches"][name]
        if k["launches"] <= 0:
            print(f"chip_smoke: FAILED: kernel {name} was launched on no "
                  "path", file=sys.stderr)
            return 1
    emit({"kernels": line})
    print(nvidia_smi, flush=True)
    emit({"seconds": time.perf_counter() - t_start})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
