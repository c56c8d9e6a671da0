// closest_hit_mxu: per ray, the closest hit over all S spheres with the
// two dot products regrouped as d.C and o.C.
//
// Replaces the Pallas TPU kernel raytracinginoneweekend_tpu/ops/
// pallas_segment.py::_kernel_mxu (reached through
// segment_closest_hit_mxu). Plain PyTorch version:
// ops/cuda_segment.segment_closest_hit_mxu_reference.
//
// The TPU kernel lays the spheres along its lanes so that d.C and o.C for
// a whole block of rays become two (rays, 8) @ (8, spheres) products on
// its matrix unit, in its own body; what is left per candidate is
//     -b = d.C - d.o,   c = (|o|^2 - 2 o.C) + (|C|^2 - r^2)
// the roots, the window and the min. This kernel computes the same
// REGROUPED arithmetic -- the per-ray scalars a = |d|^2, d.o, |o|^2 once,
// then per sphere the two three-term products against a shared-memory
// table (cx, cy, cz, |C|^2 - r^2) in plain float32 in a fixed order
// (rtw_mxu_guarded, rtw_common.cuh) -- so it is bit-equal with its plain
// version, and NOT bit-equal with closest_hit: d.o - d.C rounds
// differently from d.(o - C) on knife-edge candidates (same magnitude of
// cancellation noise, terms ~|o||C|). The winner is the strict-< min over
// (q, sphere index), which keeps the earliest index on exact ties, as the
// TPU kernel's lane min + least-matching-index does. t = q_b / a by true
// division; sb = 0 on a miss.
//
// What bounds it on this card: instruction issue. A lane moves 40 bytes
// and does about 27 float operations for each of the S spheres (18 where
// the discriminant is negative: most of them), every one its own
// instruction under -fmad=false, so the reachable ceiling is the FP32
// issue rate, half of the 67 TFLOP/s peak. The one-thread-per-lane form
// (kernel 1's before its redesign) stayed far from it: 256 blocks of 128
// threads at the default pool, too few warps to hide the candidate's
// dependent chain, and the IEEE sqrtf of every negative discriminant in its
// slow-path subroutine.
//
// Design (closest_hit.cu's split loop over the regrouped candidate):
//   * K threads per ray (a template argument, a power of two from 1 to
//     32, picked by the wrapper, ops/cuda_segment.segment_closest_hit_mxu,
//     with closest_hit's picker). Thread j of a ray's group computes the
//     ray's scalars itself and scans spheres j, j + K, j + 2K, ... of the
//     shared table, which is staged once per block of 256 threads.
//   * Each thread keeps its own partial (q, s) with strict `<`, starting at
//     (RTW_BIG, 0); the group reduces them with __shfl_xor_sync over
//     offsets K/2 ... 1, lexicographically over (q, s) -- the ascending
//     running min's answer for any partition of the spheres.
//   * rtw_mxu_guarded takes the square root and the roots only where the
//     discriminant is >= 0; bit-equal with the unguarded form.
//   * Lanes past n_lanes and inactive lanes run no loop but take part in
//     the shuffles (a predicate, no early return). An inactive lane writes
//     (hit 0, t 1e30, sb 0).
// Why the dot products stay on the FP32 units: the tensor cores take no
// float32 operands. A 3xTF32 split (hi*hi + hi*lo + lo*hi) comes near
// float32 but rounds otherwise, which would end the bit-equality with the
// plain version, and the products are 10 of the 27 operations a pair; the
// rest stays on the FP32 units either way. scripts/torch_mxu_tensor_core_ab.py
// measures such a form beside this one (PERF.md).

#include "rtw_common.cuh"

#define CM_THREADS 256
#define CM_FULL_MASK 0xffffffffu

template <int K>
__global__ void __launch_bounds__(CM_THREADS)
closest_hit_mxu_kernel(const int* __restrict__ act,
                       const float* __restrict__ ox,
                       const float* __restrict__ oy,
                       const float* __restrict__ oz,
                       const float* __restrict__ dx,
                       const float* __restrict__ dy,
                       const float* __restrict__ dz,
                       const float4* __restrict__ table,  // (S) cx cy cz ccr
                       int* __restrict__ hit, float* __restrict__ t,
                       int* __restrict__ sb, int n_lanes, int n_spheres,
                       float t_min) {
    static_assert(K >= 1 && K <= 32 && (K & (K - 1)) == 0,
                  "K is a power of two from 1 to 32");
    extern __shared__ float4 sph[];
    for (int s = threadIdx.x; s < n_spheres; s += CM_THREADS)
        sph[s] = table[s];
    __syncthreads();

    const int j = threadIdx.x & (K - 1);
    const int i = blockIdx.x * (CM_THREADS / K) + threadIdx.x / K;
    const bool live = i < n_lanes && act[i] > 0;
    float q_b = RTW_BIG;
    int s_b = 0;
    float a = 1.0f;
    if (live) {
        const float x = ox[i], y = oy[i], z = oz[i];
        const float vx = dx[i], vy = dy[i], vz = dz[i];
        a = vx * vx + vy * vy + vz * vz;
        const float d_o = vx * x + vy * y + vz * z;
        const float o_o = x * x + y * y + z * z;
        const float q_min = t_min * a;
#pragma unroll 4
        for (int s = j; s < n_spheres; s += K)
            rtw_mxu_guarded(x, y, z, vx, vy, vz, a, d_o, o_o, q_min, sph[s],
                            s, q_b, s_b);
    }
#pragma unroll
    for (int off = K / 2; off > 0; off >>= 1) {
        const float oq = __shfl_xor_sync(CM_FULL_MASK, q_b, off);
        const int os = __shfl_xor_sync(CM_FULL_MASK, s_b, off);
        if (oq < q_b || (oq == q_b && os < s_b)) {
            q_b = oq;
            s_b = os;
        }
    }
    if (j == 0 && i < n_lanes) {
        const bool h = q_b < RTW_BIG;
        hit[i] = h ? 1 : 0;
        t[i] = h ? q_b / a : RTW_BIG;
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
            closest_hit_mxu_kernel<K>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int rays_per_block = CM_THREADS / K;
    const int blocks = (n_lanes + rays_per_block - 1) / rays_per_block;
    closest_hit_mxu_kernel<K><<<blocks, CM_THREADS, smem, stream>>>(
        (const int*)act, (const float*)ox, (const float*)oy,
        (const float*)oz, (const float*)dx, (const float*)dy,
        (const float*)dz, (const float4*)table, (int*)hit, (float*)t,
        (int*)sb, n_lanes, n_spheres, t_min);
    return (int)cudaGetLastError();
}

// C entry. Pointers are device pointers; `table` is (S, 4) float32
// (cx, cy, cz, cx*cx + cy*cy + cz*cz - r*r); `split` is K, the threads per
// ray (1, 2, 4, 8, 16 or 32; anything else returns cudaErrorInvalidValue).
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
extern "C" int rtw_closest_hit_mxu(const void* act, const void* ox,
                                   const void* oy, const void* oz,
                                   const void* dx, const void* dy,
                                   const void* dz, const void* table,
                                   void* hit, void* t, void* sb, int n_lanes,
                                   int n_spheres, float t_min, int split,
                                   void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
#define CM_CASE(k)                                                        \
    case k:                                                               \
        return launch<k>(act, ox, oy, oz, dx, dy, dz, table, hit, t, sb,  \
                         n_lanes, n_spheres, t_min, st);
    switch (split) {
        CM_CASE(1) CM_CASE(2) CM_CASE(4) CM_CASE(8) CM_CASE(16) CM_CASE(32)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef CM_CASE
}
