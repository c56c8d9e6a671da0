// closest_hit: per ray, the closest hit over all S spheres.
//
// Replaces the Pallas TPU kernel raytracinginoneweekend_tpu/ops/
// pallas_segment.py::_kernel (reached through segment_closest_hit). Plain
// PyTorch version: ops/cuda_segment.segment_closest_hit_reference.
//
// What bounds it on this card: instruction issue. A lane moves 40 bytes
// (7 planes in, 3 out) and does about 27 float operations for each of the
// S spheres (18 where the discriminant is negative: most of them), so at
// S = 489 the arithmetic outweighs the traffic by two orders of magnitude.
// Built with -fmad=false every operation is its own instruction, so the
// reachable ceiling is the FP32 issue rate, half of the 67 TFLOP/s peak
// (which counts an FMA as two). Two things kept the
// one-thread-per-lane design from it: at the default pool (32768 lanes)
// 256 blocks of 128 threads are 8 warps an SM, 2 a scheduler, too few to
// hide the candidate's chain of dependent operations; and the IEEE sqrtf
// of a negative discriminant -- most sphere tests miss -- leaves MUFU.RSQ's
// fast path for a slow-path subroutine.
//
// Design:
//   * K threads per ray (a template argument, a power of two from 1 to
//     32, picked by the wrapper, ops/cuda_segment.closest_hit_split, so
//     that n_lanes * K threads fill the card). Thread j of a ray's group
//     scans spheres j, j + K, j + 2K, ...: in each step a warp reads K
//     consecutive float4s of the shared table, which its 32 / K groups
//     share as a broadcast (one conflict-free access for K <= 8).
//   * Each thread keeps its own partial (q, s) with strict `<`; the group
//     reduces them with __shfl_xor_sync over offsets K/2 ... 1, keeping the
//     smaller q and, on equal q, the smaller index. That lexicographic min
//     over (q, s) is what the ascending strict-`<` running min returns (the
//     earliest sphere wins ties) for any partition of the spheres, so the
//     result is the one-thread loop's to the bit. Every partial starts at
//     (RTW_BIG, 0), so a ray that misses everything gets sb 0.
//   * rtw_closest_guarded (rtw_common.cuh) takes the square root and the
//     two roots only where the discriminant is >= 0 and leaves the running
//     min alone elsewhere; bit-equal with the unguarded form.
//   * The sphere table (cx, cy, cz, r*r as one float4 per sphere, about
//     8 KB at S = 489) is staged in shared memory once per block of 256
//     threads -- the counterpart of the TPU kernel's scalar prefetch.
//   * Lanes past n_lanes and inactive lanes run no loop but still take
//     part in the shuffles (a predicate, no early return: a full-mask
//     shuffle needs every lane of the warp). An inactive lane writes
//     (hit 0, t 1e30, sb 0).
//
// Kept exactly from the TPU kernel: candidates are compared in q-space
// (q = t * |d|^2) and t = q_best * (1 / a); the window is q > t_min * a;
// near root first, far root as fallback; an exact graze (disc == 0) hits.

#include "rtw_common.cuh"

#define CH_THREADS 256
#define CH_FULL_MASK 0xffffffffu

template <int K>
__global__ void __launch_bounds__(CH_THREADS)
closest_hit_kernel(const int* __restrict__ act,
                   const float* __restrict__ ox, const float* __restrict__ oy,
                   const float* __restrict__ oz, const float* __restrict__ dx,
                   const float* __restrict__ dy, const float* __restrict__ dz,
                   const float4* __restrict__ table,  // (S) cx cy cz rr
                   int* __restrict__ hit, float* __restrict__ t,
                   int* __restrict__ sb, int n_lanes, int n_spheres,
                   float t_min) {
    static_assert(K >= 1 && K <= 32 && (K & (K - 1)) == 0,
                  "K is a power of two from 1 to 32");
    extern __shared__ float4 sph[];
    for (int s = threadIdx.x; s < n_spheres; s += CH_THREADS)
        sph[s] = table[s];
    __syncthreads();

    const int j = threadIdx.x & (K - 1);
    const int i = blockIdx.x * (CH_THREADS / K) + threadIdx.x / K;
    const bool live = i < n_lanes && act[i] > 0;
    float q_b = RTW_BIG;
    int s_b = 0;
    float inv_a = 0.0f;
    if (live) {
        const float x = ox[i], y = oy[i], z = oz[i];
        const float vx = dx[i], vy = dy[i], vz = dz[i];
        const float a = vx * vx + vy * vy + vz * vz;
        inv_a = 1.0f / a;
        const float q_min = t_min * a;
#pragma unroll 4
        for (int s = j; s < n_spheres; s += K)
            rtw_closest_guarded(x, y, z, vx, vy, vz, a, q_min, sph[s], s,
                                q_b, s_b);
    }
#pragma unroll
    for (int off = K / 2; off > 0; off >>= 1) {
        const float oq = __shfl_xor_sync(CH_FULL_MASK, q_b, off);
        const int os = __shfl_xor_sync(CH_FULL_MASK, s_b, off);
        if (oq < q_b || (oq == q_b && os < s_b)) {
            q_b = oq;
            s_b = os;
        }
    }
    if (j == 0 && i < n_lanes) {
        const bool h = q_b < RTW_BIG;
        hit[i] = h ? 1 : 0;
        t[i] = h ? q_b * inv_a : RTW_BIG;
        sb[i] = s_b;
    }
}

template <int K>
static int launch(const void* act, const void* ox, const void* oy,
                  const void* oz, const void* dx, const void* dy,
                  const void* dz, const void* table, void* hit, void* t,
                  void* sb, int n_lanes, int n_spheres, float t_min,
                  cudaStream_t stream) {
    const size_t smem = (size_t)n_spheres * sizeof(float4);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            closest_hit_kernel<K>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int rays_per_block = CH_THREADS / K;
    const int blocks = (n_lanes + rays_per_block - 1) / rays_per_block;
    closest_hit_kernel<K><<<blocks, CH_THREADS, smem, stream>>>(
        (const int*)act, (const float*)ox, (const float*)oy,
        (const float*)oz, (const float*)dx, (const float*)dy,
        (const float*)dz, (const float4*)table, (int*)hit, (float*)t,
        (int*)sb, n_lanes, n_spheres, t_min);
    return (int)cudaGetLastError();
}

// C entry. Pointers are device pointers; `table` is (S, 4) float32
// (cx, cy, cz, r*r); `split` is K, the threads per ray (1, 2, 4, 8, 16 or
// 32; anything else returns cudaErrorInvalidValue). Launches on `stream`,
// does not synchronise, and returns cudaGetLastError().
extern "C" int rtw_closest_hit(const void* act, const void* ox,
                               const void* oy, const void* oz,
                               const void* dx, const void* dy,
                               const void* dz, const void* table, void* hit,
                               void* t, void* sb, int n_lanes, int n_spheres,
                               float t_min, int split, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
#define CH_CASE(k)                                                        \
    case k:                                                               \
        return launch<k>(act, ox, oy, oz, dx, dy, dz, table, hit, t, sb,  \
                         n_lanes, n_spheres, t_min, st);
    switch (split) {
        CH_CASE(1) CH_CASE(2) CH_CASE(4) CH_CASE(8) CH_CASE(16) CH_CASE(32)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef CH_CASE
}
