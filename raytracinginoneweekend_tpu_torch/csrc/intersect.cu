// intersect: per ray of an (N, 3) wavefront, the closest hit over all S
// spheres, in t-space.
//
// Replaces the Pallas TPU kernel raytracinginoneweekend_tpu/ops/
// pallas_intersect.py::_kernel (reached through closest_hit_pallas). Plain
// PyTorch version: ops/intersect.closest_hit.
//
// What bounds it on this card: instruction issue. A ray moves 33 bytes
// (two 3-vectors in; t, index and the hit flag out) and does about 18
// float operations for each of the S spheres where the discriminant is not
// positive (99.7% of the pairs on the tiled engine's rays of the huge
// scene) and 31 where it is, each its own instruction under -fmad=false;
// so the reachable ceiling is the FP32 issue rate, half of the 67 TFLOP/s
// peak. The one-thread-per-ray form stayed at a third of the all-pairs
// bound: it took sqrtf(pos ? disc : 1) on every pair, and at 131,072 rays
// its 1024 blocks of 128 threads left the card's warp slots half empty.
//
// Design (closest_hit.cu's split loop over the t-space candidate):
//   * K threads per ray (a template argument, a power of two from 1 to
//     32, picked by the wrapper, ops/cuda_intersect.closest_hit_cuda, with
//     closest_hit's picker aimed at IX_THREADS_PER_SM). Thread j of a
//     ray's group loads the ray itself (the K threads read the same 24
//     bytes: one transaction) and scans spheres j, j + K, j + 2K, ... of
//     the shared table (cx, cy, cz, r*r), staged once per block of
//     IX_THREADS threads; every thread of a warp reads one sphere at a
//     time, which shared memory serves as a broadcast.
//   * rtw_closest_t_guarded (rtw_common.cuh) takes the square root and the
//     roots only where disc > 0 -- strict, as the TPU kernel counts a
//     tangent as a miss -- and compares in t, bit-equal with the unguarded
//     form of the plain version.
//   * Each thread keeps its own partial (t, s) with strict `<`, starting at
//     (RTW_BIG, 0); rtw_reduce_min reduces the K partials with
//     __shfl_xor_sync lexicographically over (t, sphere index): the
//     ascending loop's answer for any K, so the earliest sphere wins ties
//     and the index stays 0 where nothing was hit.
//   * Threads past N run no loop but take part in the shuffles (a
//     predicate, no early return): any N, no padding.
// The (N, 3) array-of-structs ray loads stay: the K threads of a ray share
// them, and a warp's loads together use every byte of the lines they touch.

#include "rtw_common.cuh"

#define IX_THREADS 256

template <int K>
__global__ void __launch_bounds__(IX_THREADS)
intersect_kernel(const float* __restrict__ origin,     // (N, 3)
                 const float* __restrict__ direction,  // (N, 3)
                 const float4* __restrict__ table,     // (S) cx cy cz r
                 float* __restrict__ t_out, int* __restrict__ idx_out,
                 unsigned char* __restrict__ hit_out, int n_rays,
                 int n_spheres, float t_min) {
    static_assert(K >= 1 && K <= 32 && (K & (K - 1)) == 0,
                  "K is a power of two from 1 to 32");
    extern __shared__ float4 sph[];
    for (int s = threadIdx.x; s < n_spheres; s += IX_THREADS) {
        float4 c4 = table[s];
        c4.w = c4.w * c4.w;
        sph[s] = c4;
    }
    __syncthreads();

    const int j = threadIdx.x & (K - 1);
    const int i = blockIdx.x * (IX_THREADS / K) + threadIdx.x / K;
    float t_b = RTW_BIG;
    int s_b = 0;
    if (i < n_rays) {
        const float ox = origin[3 * i], oy = origin[3 * i + 1],
                    oz = origin[3 * i + 2];
        const float dx = direction[3 * i], dy = direction[3 * i + 1],
                    dz = direction[3 * i + 2];
        const float a = dx * dx + dy * dy + dz * dz;
        const float inv_a = 1.0f / a;
#pragma unroll 4
        for (int s = j; s < n_spheres; s += K)
            rtw_closest_t_guarded(ox, oy, oz, dx, dy, dz, a, inv_a, t_min,
                                  sph[s], s, t_b, s_b);
    }
    rtw_reduce_min<K>(t_b, s_b);
    if (j == 0 && i < n_rays) {
        t_out[i] = t_b;
        idx_out[i] = s_b;
        hit_out[i] = t_b < RTW_BIG ? 1 : 0;
    }
}

template <int K>
static int launch(const void* origin, const void* direction,
                  const void* table, void* t, void* idx, void* hit,
                  int n_rays, int n_spheres, float t_min,
                  cudaStream_t stream) {
    const size_t smem = (size_t)n_spheres * sizeof(float4);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            intersect_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int rays_per_block = IX_THREADS / K;
    const int blocks = (n_rays + rays_per_block - 1) / rays_per_block;
    intersect_kernel<K><<<blocks, IX_THREADS, smem, stream>>>(
        (const float*)origin, (const float*)direction, (const float4*)table,
        (float*)t, (int*)idx, (unsigned char*)hit, n_rays, n_spheres, t_min);
    return (int)cudaGetLastError();
}

// C entry. Pointers are device pointers; `origin`/`direction` are
// contiguous (N, 3) float32, `table` is (S, 4) float32 (cx, cy, cz, r),
// `hit` one byte per ray; `split` is K, the threads per ray (1, 2, 4, 8,
// 16 or 32; anything else returns cudaErrorInvalidValue). Launches on
// `stream`, does not synchronise, and returns cudaGetLastError().
extern "C" int rtw_closest_hit_n3(const void* origin, const void* direction,
                                  const void* table, void* t, void* idx,
                                  void* hit, int n_rays, int n_spheres,
                                  float t_min, int split, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
#define IX_CASE(k)                                                       \
    case k:                                                              \
        return launch<k>(origin, direction, table, t, idx, hit, n_rays,  \
                         n_spheres, t_min, st);
    switch (split) {
        IX_CASE(1) IX_CASE(2) IX_CASE(4) IX_CASE(8) IX_CASE(16) IX_CASE(32)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef IX_CASE
}
