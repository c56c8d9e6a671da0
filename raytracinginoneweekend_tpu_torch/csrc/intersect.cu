// intersect: per ray of an (N, 3) wavefront, the closest hit over all S
// spheres, in t-space.
//
// Replaces the Pallas TPU kernel raytracinginoneweekend_tpu/ops/
// pallas_intersect.py::_kernel (reached through closest_hit_pallas). Plain
// PyTorch version: ops/intersect.closest_hit.
//
// What bounds it: float32 arithmetic. A ray moves 33 bytes (two 3-vectors
// in; t, index and the hit flag out) and does about 32 operations for each
// of the S spheres, so at S = 489 the arithmetic outweighs the traffic by
// two orders of magnitude.
//
// Design: one thread per ray, any N (a bounds check, no padding). The
// sphere table arrives as (S, 4) rows (cx, cy, cz, r) and is staged once
// per block in shared memory as (cx, cy, cz, r*r) -- the counterpart of
// the TPU kernel's scalar prefetch; every thread of a warp reads the same
// sphere at the same time, which shared memory serves as one broadcast.
// The loop is a plain ascending running min with strict `<`, so the
// earliest sphere wins ties and the index stays 0 where nothing was hit.
// The 12-byte strided ray loads are not coalesced per instruction, but a
// warp's three loads together use every byte of the lines they touch.
//
// Shared with closest_hit.cu: the loop and the shared-memory table. NOT
// shared: the candidate. This kernel keeps the TPU kernel's t-space form
// in its operation order (rtw_candidate_t in rtw_common.cuh, shared with
// closest_hit_grouped.cu) -- disc = b*b - a*c; pos = disc > 0;
// sq = sqrt(pos ? disc : 1); t0 = (-b - sq) * (1/a); t1 = (-b + sq) * (1/a);
// each root tested `> t_min`; miss = 1e30 -- where closest_hit.cu compares
// in q-space with a NaN-tolerant sqrt.

#include "rtw_common.cuh"

#define IX_THREADS 128

__global__ void __launch_bounds__(IX_THREADS)
intersect_kernel(const float* __restrict__ origin,     // (N, 3)
                 const float* __restrict__ direction,  // (N, 3)
                 const float4* __restrict__ table,     // (S) cx cy cz r
                 float* __restrict__ t_out, int* __restrict__ idx_out,
                 unsigned char* __restrict__ hit_out, int n_rays,
                 int n_spheres, float t_min) {
    extern __shared__ float4 sph[];
    for (int s = threadIdx.x; s < n_spheres; s += blockDim.x) {
        float4 c4 = table[s];
        c4.w = c4.w * c4.w;
        sph[s] = c4;
    }
    __syncthreads();

    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_rays) return;
    const float ox = origin[3 * i], oy = origin[3 * i + 1],
                oz = origin[3 * i + 2];
    const float dx = direction[3 * i], dy = direction[3 * i + 1],
                dz = direction[3 * i + 2];
    const float a = dx * dx + dy * dy + dz * dz;
    const float inv_a = 1.0f / a;

    float t_best = RTW_BIG;
    int i_best = 0;
#pragma unroll 4
    for (int s = 0; s < n_spheres; ++s) {
        const float tc =
            rtw_candidate_t(ox, oy, oz, dx, dy, dz, a, inv_a, t_min, sph[s]);
        if (tc < t_best) {
            t_best = tc;
            i_best = s;
        }
    }
    t_out[i] = t_best;
    idx_out[i] = i_best;
    hit_out[i] = t_best < RTW_BIG ? 1 : 0;
}

// C entry. Pointers are device pointers; `origin`/`direction` are
// contiguous (N, 3) float32, `table` is (S, 4) float32 (cx, cy, cz, r),
// `hit` one byte per ray. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError().
extern "C" int rtw_closest_hit_n3(const void* origin, const void* direction,
                                  const void* table, void* t, void* idx,
                                  void* hit, int n_rays, int n_spheres,
                                  float t_min, void* stream) {
    const size_t smem = (size_t)n_spheres * sizeof(float4);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            intersect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int blocks = (n_rays + IX_THREADS - 1) / IX_THREADS;
    intersect_kernel<<<blocks, IX_THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)origin, (const float*)direction, (const float4*)table,
        (float*)t, (int*)idx, (unsigned char*)hit, n_rays, n_spheres, t_min);
    return (int)cudaGetLastError();
}
