#!/usr/bin/env python3
"""Would the regrouped-products closest hit (kernel 7) gain from putting its
dot products on the tensor cores?

The mxu kernel (``csrc/closest_hit_mxu.cu``) computes d.C and o.C for every
(ray, sphere) pair on the FP32 units, K threads a ray, bit-equal with its
plain version. The TPU kernel it replaces puts those products on its
matrix unit. This script builds a tensor-core form from the source held
below: per warp, ``mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32``
with A's rows 0-7 the directions of 8 rays and rows 8-15 their origins,
as (x, y, z, 0), and B the (x, y, z, 0) of 8 spheres, so that each thread
gets d.C and o.C of one ray for two spheres; a 3xTF32 split (lo*hi +
hi*lo + hi*hi, the table split once into shared memory) comes near
float32; the rest of the candidate is the kernel's FP32 arithmetic with
the guarded square root, each thread keeps a running min over its own
columns, and a quad reduce over (q, sphere index) ends it.

On the serving frame's mid-frame lane states (huge scene, 1200x800, 100
spp, depth 50, pools of 2^15 and 2^20 lanes) it prints, for each pool: the
device time of the split kernel (the wrapper's own K) and of the
tensor-core form (CUDA events around 20 launches queued behind a long
matrix product, the two in turns, twice), and the tensor-core form's
hit and winner differences and t error quantiles against the plain mxu
version and against closest_hit, with whether it stays inside the
tolerance ``chip_smoke.py`` holds the mxu kernel to against closest_hit
(hit and winner differences, and t beyond rtol 5e-3 / atol 2e-4, each on
at most 1e-3 of the active lanes; no miss with a sphere index); then the
card's name and power limit. Nothing in the package calls this form.

Run on a machine with a CUDA card and nvcc:
    python3 scripts/torch_mxu_tensor_core_ab.py
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

W, H, SPP, DEPTH = 1200, 800, 100, 50

SOURCE = r"""
#include <cstdint>
#include "rtw_common.cuh"

#define TC_THREADS 256
#define TC_FULL_MASK 0xffffffffu

__device__ __forceinline__ uint32_t tc_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// D += A (16x4, rows 0-7 directions, 8-15 origins) * B (4x8, spheres)
__device__ __forceinline__ void tc_mma(float (&d)[4], uint32_t a0,
                                       uint32_t a1, uint32_t b0) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ void tc_candidate(
        float dC, float oC, float ccr, float a, float d_o, float o_o,
        float q_min, int s, float& q_b, int& s_b) {
    const float bneg = dC - d_o;
    const float c = (o_o - (oC + oC)) + ccr;
    const float disc = bneg * bneg - a * c;
    if (disc >= 0.0f) {
        const float sq = sqrtf(disc);
        const float q0 = bneg - sq;
        const float q1 = bneg + sq;
        const float q = (q0 > q_min) ? q0 : ((q1 > q_min) ? q1 : RTW_BIG);
        if (q < q_b) {
            q_b = q;
            s_b = s;
        }
    }
}

__global__ void __launch_bounds__(TC_THREADS)
closest_hit_mxu_tc_kernel(const int* __restrict__ act,
                          const float* __restrict__ ox,
                          const float* __restrict__ oy,
                          const float* __restrict__ oz,
                          const float* __restrict__ dx,
                          const float* __restrict__ dy,
                          const float* __restrict__ dz,
                          const float4* __restrict__ table,
                          int* __restrict__ hit, float* __restrict__ t,
                          int* __restrict__ sb, int n_lanes, int n_spheres,
                          float t_min) {
    extern __shared__ uint32_t tsm[];
    const int s_pad = (n_spheres + 7) & ~7;
    uint32_t* hi = tsm;                        // [s_pad][4] tf32 high parts
    uint32_t* lo = tsm + s_pad * 4;            // [s_pad][4] tf32 low parts
    float* ccr = (float*)(tsm + s_pad * 8);    // [s_pad] |C|^2 - r^2
    for (int s = threadIdx.x; s < s_pad; s += TC_THREADS) {
        // a pad sphere (0, 0, 0, ccr 1) has disc < 0 for every ray
        const float4 c4 = s < n_spheres ? table[s]
                                        : make_float4(0.f, 0.f, 0.f, 1.f);
        const float v[4] = {c4.x, c4.y, c4.z, 0.0f};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const uint32_t h = tc_tf32(v[k]);
            hi[s * 4 + k] = h;
            lo[s * 4 + k] = tc_tf32(v[k] - __uint_as_float(h));
        }
        ccr[s] = c4.w;
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;    // the warp's ray (A's row) / sphere (B's col)
    const int tig = lane & 3;   // the coordinate (k) / the column pair
    const int i = blockIdx.x * (TC_THREADS / 4) + (threadIdx.x >> 5) * 8 + g;
    const int il = min(i, n_lanes - 1);
    const bool live = i < n_lanes && act[i] > 0;
    const float x = ox[il], y = oy[il], z = oz[il];
    const float vx = dx[il], vy = dy[il], vz = dz[il];
    const float a = vx * vx + vy * vy + vz * vz;
    const float d_o = vx * x + vy * y + vz * z;
    const float o_o = x * x + y * y + z * z;
    const float q_min = t_min * a;
    const float dk = tig == 0 ? vx : (tig == 1 ? vy : (tig == 2 ? vz : 0.f));
    const float ok = tig == 0 ? x : (tig == 1 ? y : (tig == 2 ? z : 0.f));
    const uint32_t ad_hi = tc_tf32(dk);
    const uint32_t ad_lo = tc_tf32(dk - __uint_as_float(ad_hi));
    const uint32_t ao_hi = tc_tf32(ok);
    const uint32_t ao_lo = tc_tf32(ok - __uint_as_float(ao_hi));

    float q_b = RTW_BIG;
    int s_b = 0;
    if (__any_sync(TC_FULL_MASK, live)) {
        for (int tile = 0; tile < s_pad; tile += 8) {
            const int n = tile + g;
            const uint32_t b_hi = hi[n * 4 + tig];
            const uint32_t b_lo = lo[n * 4 + tig];
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
            tc_mma(acc, ad_lo, ao_lo, b_hi);
            tc_mma(acc, ad_hi, ao_hi, b_lo);
            tc_mma(acc, ad_hi, ao_hi, b_hi);
            if (live) {
                const int s0 = tile + 2 * tig;
                const float2 cc = *(const float2*)(ccr + s0);
                tc_candidate(acc[0], acc[2], cc.x, a, d_o, o_o, q_min, s0,
                             q_b, s_b);
                tc_candidate(acc[1], acc[3], cc.y, a, d_o, o_o, q_min,
                             s0 + 1, q_b, s_b);
            }
        }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        const float oq = __shfl_xor_sync(TC_FULL_MASK, q_b, off);
        const int os = __shfl_xor_sync(TC_FULL_MASK, s_b, off);
        if (oq < q_b || (oq == q_b && os < s_b)) {
            q_b = oq;
            s_b = os;
        }
    }
    if (tig == 0 && i < n_lanes) {
        const bool h = q_b < RTW_BIG;
        hit[i] = h ? 1 : 0;
        t[i] = h ? q_b / a : RTW_BIG;
        sb[i] = s_b;
    }
}

extern "C" int rtw_closest_hit_mxu_tc(const void* act, const void* ox,
                                      const void* oy, const void* oz,
                                      const void* dx, const void* dy,
                                      const void* dz, const void* table,
                                      void* hit, void* t, void* sb,
                                      int n_lanes, int n_spheres,
                                      float t_min, void* stream) {
    const int s_pad = (n_spheres + 7) & ~7;
    const size_t smem = (size_t)s_pad * 36;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            closest_hit_mxu_tc_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int rays_per_block = TC_THREADS / 4;
    const int blocks = (n_lanes + rays_per_block - 1) / rays_per_block;
    closest_hit_mxu_tc_kernel<<<blocks, TC_THREADS, smem,
                                (cudaStream_t)stream>>>(
        (const int*)act, (const float*)ox, (const float*)oy,
        (const float*)oz, (const float*)dx, (const float*)dy,
        (const float*)dz, (const float4*)table, (int*)hit, (float*)t,
        (int*)sb, n_lanes, n_spheres, t_min);
    return (int)cudaGetLastError();
}
"""


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_mxu_tensor_core_ab: no CUDA device", file=sys.stderr)
        return 1
    import raytracinginoneweekend_tpu_torch as rt
    from chip_smoke import against_closest_hit
    from raytracinginoneweekend_tpu_torch import cli, kernels
    from raytracinginoneweekend_tpu_torch.ops import (cuda_fused,
                                                      cuda_segment as seg,
                                                      wavefront)
    from raytracinginoneweekend_tpu_torch.utils.timing import cuda_time_ms

    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    src = os.path.join(kernels.BUILD_DIR, "closest_hit_mxu_tc.cu")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
                    "-I", kernels.CSRC_DIR, "-o", src[:-3] + ".so", src],
                   check=True)
    tc = ctypes.CDLL(src[:-3] + ".so").rtw_closest_hit_mxu_tc
    _p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tc.argtypes = [_p] * 11 + [_i, _i, _f, _p]
    tc.restype = ctypes.c_int

    dev = torch.device("cuda")
    scene = cli._build_scene("huge", 0, dev)
    cam = cli._build_camera("cpu", W, H, dev)
    for pool in (1 << 15, 1 << 20):
        eng = wavefront.build_engine(
            scene, cam, rt.key_words(0), width=W, height=H, spp=SPP,
            max_depth=DEPTH, camera_mode="thinlens", options=rt.DEFAULT,
            pool_size=pool, device=dev)
        # mid-frame (chip_smoke.mid_frame_state)
        state = list(wavefront.engine_initial_state(eng))
        state[0] += (eng.n_k // 2) * eng.stride
        state = cuda_fused.regen(tuple(state), eng.camvec, eng.base_words,
                                 **eng.regen_kw)
        for _ in range(40):
            state = wavefront.engine_step(eng, state)
        rays, act = tuple(state[4:10]), state[3]
        geom = eng.sphere_params[:4]
        table = seg.mxu_table(*geom)
        n = rays[0].numel()

        def split():
            return seg.segment_closest_hit_mxu(rays, *geom, eng.t_min,
                                               active=act, table=table)

        def tensor_cores():
            out = tuple(torch.empty_like(p) for p in (act, rays[0], act))
            err = tc(act.data_ptr(), *(p.data_ptr() for p in rays),
                     table.data_ptr(), *(o.data_ptr() for o in out), n,
                     geom[0].shape[0], float(eng.t_min),
                     torch.cuda.current_stream(dev).cuda_stream)
            kernels.check(err, "closest_hit_mxu_tc")
            return out

        got = tensor_cores()
        plain = seg.segment_closest_hit_mxu_reference(rays, *geom,
                                                      eng.t_min, act)
        full = seg.segment_closest_hit(rays, *geom, eng.t_min, active=act,
                                       table=eng.htable)
        vs_plain = against_closest_hit(torch, got, plain, act)
        vs_ch = against_closest_hit(torch, got, full, act)
        n_act = max(vs_ch["active"], 1)
        out = {"lanes": n, "split_ms": [], "tensor_core_ms": [],
               "vs_plain_mxu": vs_plain, "vs_closest_hit": vs_ch,
               "inside_mxu_tolerance_vs_closest_hit": (
                   vs_ch["hit_differs"] + vs_ch["winner_differs"]
                   <= 1e-3 * n_act
                   and vs_ch["t_beyond_rtol_5e-3_atol_2e-4"] <= 1e-3 * n_act
                   and vs_ch["miss_sb_nonzero"] == 0)}
        for _ in range(2):
            out["split_ms"].append(cuda_time_ms(split, iters=20,
                                                queue_behind=True))
            out["tensor_core_ms"].append(cuda_time_ms(
                tensor_cores, iters=20, queue_behind=True))
        out["speedup"] = min(out["split_ms"]) / min(out["tensor_core_ms"])
        print(json.dumps(out), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
