// closest_hit: per ray, the closest hit over all S spheres.
//
// Replaces the Pallas TPU kernel raytracinginoneweekend_tpu/ops/
// pallas_segment.py::_kernel (reached through segment_closest_hit). Plain
// PyTorch version: ops/cuda_segment.segment_closest_hit_reference.
//
// What bounds it: float32 arithmetic. A lane moves 40 bytes (7 planes in,
// 3 out) and does about 27 operations for each of the S spheres, so at
// S = 489 the arithmetic outweighs the traffic by two orders of magnitude.
//
// Design: one thread per lane. The sphere table (cx, cy, cz, r*r as one
// float4 per sphere, about 8 KB at S = 489) is staged in shared memory
// once per block -- the counterpart of the TPU kernel's scalar prefetch --
// and every thread of a warp reads the same sphere at the same time, which
// shared memory serves as one broadcast. The loop is a plain ascending
// running min with strict `<`, so the earliest sphere wins ties; the TPU
// kernel's 8-way tournament only reorders the same comparisons. An
// inactive lane writes (hit 0, t 1e30, sb 0) and leaves before the loop; a
// warp whose lanes are all inactive costs nothing more.
//
// Kept exactly from the TPU kernel: candidates are compared in q-space
// (q = t * |d|^2) and t = q_best * (1 / a); sqrtf of a negative
// discriminant is NaN and every comparison with NaN is false, so a miss
// falls through to the 1e30 sentinel without a mask; the window is
// q > t_min * a; near root first, far root as fallback.

#include "rtw_common.cuh"

#define CH_THREADS 128

__global__ void __launch_bounds__(CH_THREADS)
closest_hit_kernel(const int* __restrict__ act,
                   const float* __restrict__ ox, const float* __restrict__ oy,
                   const float* __restrict__ oz, const float* __restrict__ dx,
                   const float* __restrict__ dy, const float* __restrict__ dz,
                   const float4* __restrict__ table,  // (S) cx cy cz rr
                   int* __restrict__ hit, float* __restrict__ t,
                   int* __restrict__ sb, int n_lanes, int n_spheres,
                   float t_min) {
    extern __shared__ float4 sph[];
    for (int s = threadIdx.x; s < n_spheres; s += blockDim.x)
        sph[s] = table[s];
    __syncthreads();

    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_lanes) return;
    if (act[i] <= 0) {
        hit[i] = 0;
        t[i] = RTW_BIG;
        sb[i] = 0;
        return;
    }
    const float x = ox[i], y = oy[i], z = oz[i];
    const float vx = dx[i], vy = dy[i], vz = dz[i];
    const float a = vx * vx + vy * vy + vz * vz;
    const float inv_a = 1.0f / a;
    const float q_min = t_min * a;

    float q_b = RTW_BIG;
    int s_b = 0;
#pragma unroll 4
    for (int s = 0; s < n_spheres; ++s) {
        const float q = rtw_candidate(x, y, z, vx, vy, vz, a, q_min, sph[s]);
        if (q < q_b) {
            q_b = q;
            s_b = s;
        }
    }
    const bool h = q_b < RTW_BIG;
    hit[i] = h ? 1 : 0;
    t[i] = h ? q_b * inv_a : RTW_BIG;
    sb[i] = s_b;
}

// C entry. Pointers are device pointers; `table` is (S, 4) float32
// (cx, cy, cz, r*r). Launches on `stream`, does not synchronise, and
// returns cudaGetLastError().
extern "C" int rtw_closest_hit(const void* act, const void* ox,
                               const void* oy, const void* oz,
                               const void* dx, const void* dy,
                               const void* dz, const void* table, void* hit,
                               void* t, void* sb, int n_lanes, int n_spheres,
                               float t_min, void* stream) {
    const size_t smem = (size_t)n_spheres * sizeof(float4);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            closest_hit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int blocks = (n_lanes + CH_THREADS - 1) / CH_THREADS;
    closest_hit_kernel<<<blocks, CH_THREADS, smem, (cudaStream_t)stream>>>(
        (const int*)act, (const float*)ox, (const float*)oy,
        (const float*)oz, (const float*)dx, (const float*)dy,
        (const float*)dz, (const float4*)table, (int*)hit, (float*)t,
        (int*)sb, n_lanes, n_spheres, t_min);
    return (int)cudaGetLastError();
}
