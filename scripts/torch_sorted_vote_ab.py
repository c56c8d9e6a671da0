#!/usr/bin/env python3
"""Does closest_hit_sorted's stage vote gain from reducing a ray's q first?

The sorted kernel (``csrc/closest_hit_sorted.cu``) splits a ray's sphere
loop over K threads and, at each checkpoint of its ladder, lets every
thread test the exit on its own partial q; the warp skips the stage when
all of its threads are finished. The alternative takes the min of the
group's partials first (log2 K warp shuffles a checkpoint), so that the
vote is each ray's own and fires more often. This script builds that
alternative from the checkout's source (the reduce inserted before the
exit test) beside the kernel as it is, and on the serving frame's
mid-frame lane states (huge scene, 1200x800, 100 spp, depth 50; strided
and tile ownership at pools of 2^15 and 2^20 lanes, a sort state half an
epoch old, ladder (4,), the wrapper's own K) holds both bit-equal with the
plain version and prints, for each, the device time (CUDA events around
20 launches queued behind a long matrix product, the two forms in turns,
twice) and the share of chunk-stages skipped; then the card's name and
power limit.

Run on a machine with a CUDA card and nvcc:
    python3 scripts/torch_sorted_vote_ab.py
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import subprocess
import sys

W, H, SPP, DEPTH = 1200, 800, 100, 50
LADDER = (4,)
VOTE = "            const float qd = rtw_min(q_b * rsa, dist_up);\n"
GROUP_VOTE = """            float q_ray = q_b;  // the group's min
#pragma unroll
            for (int off = K / 2; off > 0; off >>= 1) {
                const float oq = __shfl_xor_sync(CS_FULL_MASK, q_ray, off);
                q_ray = (oq < q_ray) ? oq : q_ray;
            }
            const float qd = rtw_min(q_ray * rsa, dist_up);
"""


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    if not torch.cuda.is_available():
        print("torch_sorted_vote_ab: no CUDA device", file=sys.stderr)
        return 1
    import raytracinginoneweekend_tpu_torch as rt
    from raytracinginoneweekend_tpu_torch import cli, kernels
    from raytracinginoneweekend_tpu_torch.closest_hit_checks import bit_diff
    from raytracinginoneweekend_tpu_torch.ops import (cuda_fused,
                                                      cuda_segment as seg,
                                                      wavefront)
    from raytracinginoneweekend_tpu_torch.utils.timing import cuda_time_ms

    name = "rtw_closest_hit_sorted"
    kernels.entry(name)
    thread_vote = kernels._fns[name]
    src = open(os.path.join(kernels.CSRC_DIR, "closest_hit_sorted.cu")).read()
    if src.count(VOTE) != 1:
        print("torch_sorted_vote_ab: the vote line moved", file=sys.stderr)
        return 1
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    alt = os.path.join(kernels.BUILD_DIR, "closest_hit_sorted_group_vote.cu")
    with open(alt, "w") as f:
        f.write(src.replace(VOTE, GROUP_VOTE))
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                    kernels.CSRC_DIR, "-o", alt[:-3] + ".so", alt],
                   check=True)
    group_vote = getattr(ctypes.CDLL(alt[:-3] + ".so"), name)
    group_vote.argtypes = kernels.ENTRIES[name][1]
    group_vote.restype = ctypes.c_int

    dev = torch.device("cuda")
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", W, H, dev)
    rows = wavefront.ROWS_DEFAULT
    for pool in (1 << 15, 1 << 20):
        for own in ("strided", "tile"):
            eng = wavefront.build_engine(
                scene, cam, rt.key_words(0), width=W, height=H, spp=SPP,
                max_depth=DEPTH, camera_mode="thinlens",
                options=dataclasses.replace(rt.DEFAULT, ownership=own),
                pool_size=pool, device=dev)
            state = list(wavefront.engine_initial_state(eng))
            state[0] += (eng.n_k // 2) * eng.stride
            state = cuda_fused.regen(tuple(state), eng.camvec,
                                     eng.base_words, **eng.regen_kw)
            for _ in range(24):
                state = wavefront.engine_step(eng, state)
            geom = eng.sphere_params[:4]
            ss = seg.sorted_cull_state(state[3], state[4:7], *geom,
                                       rows=rows)
            for _ in range(16):
                state = wavefront.engine_step(eng, state)
            rays, act = tuple(state[4:10]), state[3]
            table = seg.hit_table_padded(*geom)
            want = seg.segment_closest_hit_sorted_reference(
                rays, *geom, ss, eng.t_min, rows, act, LADDER)

            def run(stats=None):
                return seg.segment_closest_hit_sorted(
                    rays, *geom, ss, eng.t_min, rows=rows, active=act,
                    ladder=LADDER, table=table, stats=stats)

            out = {"lanes": eng.lanes, "ownership": own,
                   "split": seg.picked_split(eng.lanes, dev.index,
                                             seg.SPLIT_THREADS_PER_SM)}
            for turn in range(2):
                for form, fn in (("thread_vote", thread_vote),
                                 ("group_vote", group_vote)):
                    kernels._fns[name] = fn
                    try:
                        stats = torch.zeros(2, dtype=torch.int64, device=dev)
                        diff = bit_diff(run(stats), want)
                        if any(diff.values()):
                            print(f"torch_sorted_vote_ab: {form} is not "
                                  f"bit-equal: {diff}", file=sys.stderr)
                            return 1
                        skipped, total = (int(v) for v in stats.tolist())
                        rec = out.setdefault(form, {"ms": []})
                        rec["ms"].append(cuda_time_ms(run, iters=20,
                                                      queue_behind=True))
                        rec["share_skipped"] = skipped / max(total, 1)
                    finally:
                        kernels._fns[name] = thread_vote
            print(json.dumps(out), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
