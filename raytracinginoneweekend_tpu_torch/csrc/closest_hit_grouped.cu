// closest_hit_grouped: per ray, the closest hit over spheres sorted into
// groups of 16, each with a bounding sphere; a warp skips a group that no
// active lane of it might hit.
//
// Replaces the Pallas TPU kernel raytracinginoneweekend_tpu/ops/
// pallas_segment.py::_kernel_grouped (reached through
// trace_segment(group_params=...)). Plain PyTorch version:
// ops/cuda_segment.segment_closest_hit_grouped_reference.
//
// The caller sorts the scene with ops/cuda_segment.group_scene: spheres in
// (z-cell, x-cell) order, padded to a multiple of 16 with r = 0 copies of
// the last centre (their discriminant is never positive), and per group g
// the bounding sphere (gx, gy, gz, gr). For every group each lane tests
// the bound (~20 operations):
//     might = disc > 0 && (b < 0 || c < 0)
// (the ray's line meets the bound, and the bound is not wholly behind an
// origin outside it); when no active lane of the WARP might hit, the warp
// skips the group's 16 spheres. The TPU kernel takes the vote over its
// whole block of 16384 lanes; the bound is conservative, so the width of
// the vote changes speed only, never the result, and a warp is this card's
// natural width. The candidate is the t-space form of the TPU intersect
// kernel (rtw_closest_t_guarded: sqrt only where disc > 0, the compare in
// t), so results are those of the unculled t-space loop over the sorted
// table; sphere indices are into the SORTED order.
//
// What bounds it on this card: instruction issue, ~20 operations per lane
// and group for the bound test plus, for each sphere of a group the warp
// runs, 18 where the discriminant is not positive (nearly all) and 31
// where it is, each its own instruction under -fmad=false. The one-thread
// form took sqrtf(pos ? disc : 1) on every tested pair and lost to kernel
// 1 (which tests every sphere, guarded) on the same rays; a split that
// repeated the bound test on each of a ray's K threads lost to it at the
// default pool, where K > 1 fills the card.
//
// Design (the split loop of closest_hit.cu inside each group):
//   * K threads per ray (a template argument, a power of two from 1 to
//     16, picked by the wrapper, ops/cuda_segment.segment_closest_hit_
//     grouped, with closest_hit's picker aimed at GROUPED_THREADS_PER_SM).
//     The K threads of a ray all load the ray. They take the groups K at a
//     time: thread j tests the bound of group g0 + j, and one
//     __ballot_sync gives the warp's vote on all K groups (group g0 + m
//     runs when any lane with j == m might hit it), so no thread repeats
//     another's bound test. The vote keeps its meaning; it now covers 32 /
//     K rays, which can only skip more groups, never change a result.
//     Thread j tests spheres lo + j, lo + j + K, ... of a group that runs
//     (16 / K of them).
//   * Each thread keeps its own partial (t, s) with strict `<`; after the
//     groups, rtw_reduce_min reduces the K partials lexicographically over
//     (t, sorted sphere index): the one-thread loop's answer for any K.
//   * 128 threads a block; the sorted table (cx, cy, cz, r*r) and the
//     bounds (gx, gy, gz, gr*gr) in shared memory (8.4 KB on the huge
//     scene), read as broadcasts. A thread block with no active lane
//     writes (0, 1e30, 0) and leaves; an inactive lane, or a lane past the
//     end, votes "no", runs no sphere and takes part in the shuffles, and
//     an inactive lane writes (0, 1e30, 0).
// `stats`, when given, counts (warps with an active lane) x (groups
// skipped, groups in all).

#include "rtw_common.cuh"

#define CG_THREADS 128
#define CG_GROUP 16
#define CG_FULL_MASK 0xffffffffu

// The lanes of a warp that are thread 0 of their ray's K: 0, K, 2K, ...
template <int K>
__device__ constexpr unsigned cg_lane_pattern() {
    unsigned p = 0u;
    for (int lane = 0; lane < 32; lane += K) p |= 1u << lane;
    return p;
}

template <int K>
__global__ void __launch_bounds__(CG_THREADS)
closest_hit_grouped_kernel(const int* __restrict__ act,
                           const float* __restrict__ ox,
                           const float* __restrict__ oy,
                           const float* __restrict__ oz,
                           const float* __restrict__ dx,
                           const float* __restrict__ dy,
                           const float* __restrict__ dz,
                           const float4* __restrict__ table,   // (S_pad) r
                           const float4* __restrict__ bounds,  // (G) gr
                           int* __restrict__ hit, float* __restrict__ t,
                           int* __restrict__ sb,
                           unsigned long long* __restrict__ stats,
                           int n_lanes, int n_groups, float t_min) {
    static_assert(K >= 1 && K <= CG_GROUP && (K & (K - 1)) == 0,
                  "K is a power of two from 1 to 16");
    extern __shared__ float4 smem[];
    const int s_pad = n_groups * CG_GROUP;
    float4* sph = smem;           // [s_pad] cx cy cz r*r
    float4* grp = smem + s_pad;   // [n_groups] gx gy gz gr*gr

    const int j = threadIdx.x & (K - 1);
    const int i = blockIdx.x * (CG_THREADS / K) + threadIdx.x / K;
    const bool active = i < n_lanes && act[i] > 0;
    if (__syncthreads_or(active) == 0) {
        if (j == 0 && i < n_lanes) {
            hit[i] = 0;
            t[i] = RTW_BIG;
            sb[i] = 0;
        }
        return;
    }
    for (int s = threadIdx.x; s < s_pad; s += CG_THREADS) {
        float4 c4 = table[s];
        c4.w = c4.w * c4.w;
        sph[s] = c4;
    }
    for (int g = threadIdx.x; g < n_groups; g += CG_THREADS) {
        float4 g4 = bounds[g];
        g4.w = g4.w * g4.w;
        grp[g] = g4;
    }
    __syncthreads();

    // Lanes past the end or inactive stay in the warp votes, voting "no".
    const int il = min(i, n_lanes - 1);
    const float x = ox[il], y = oy[il], z = oz[il];
    const float vx = dx[il], vy = dy[il], vz = dz[il];
    const float a = vx * vx + vy * vy + vz * vz;
    const float inv_a = 1.0f / a;

    float t_b = RTW_BIG;
    int s_b = 0;
    int skipped = 0;
    for (int g0 = 0; g0 < n_groups; g0 += K) {
        // thread j of a ray tests the bound of group g0 + j ...
        bool might = false;
        if (g0 + j < n_groups) {
            const float4 g4 = grp[g0 + j];
            const float ocx = x - g4.x;
            const float ocy = y - g4.y;
            const float ocz = z - g4.z;
            const float b = ocx * vx + ocy * vy + ocz * vz;
            const float c = ocx * ocx + ocy * ocy + ocz * ocz - g4.w;
            might = active && (b * b - a * c > 0.0f) &&
                    (b < 0.0f || c < 0.0f);
        }
        // ... and one ballot holds the warp's vote on all K groups: group
        // g0 + m runs when a lane of the threads j == m might hit it.
        const unsigned vote = __ballot_sync(CG_FULL_MASK, might);
#pragma unroll
        for (int m = 0; m < K; ++m) {
            const int g = g0 + m;
            if (g >= n_groups) break;
            if ((vote & (cg_lane_pattern<K>() << m)) == 0u) {
                ++skipped;
                continue;
            }
            if (active) {
                const int lo = g * CG_GROUP + j;
#pragma unroll
                for (int q = 0; q < CG_GROUP / K; ++q)
                    rtw_closest_t_guarded(x, y, z, vx, vy, vz, a, inv_a,
                                          t_min, sph[lo + q * K],
                                          lo + q * K, t_b, s_b);
            }
        }
    }
    rtw_reduce_min<K>(t_b, s_b);
    const bool warp_active = __any_sync(CG_FULL_MASK, active);
    if (stats != nullptr && (threadIdx.x & 31) == 0 && warp_active) {
        atomicAdd(&stats[0], (unsigned long long)skipped);
        atomicAdd(&stats[1], (unsigned long long)n_groups);
    }
    if (j != 0 || i >= n_lanes) return;
    hit[i] = (active && t_b < RTW_BIG) ? 1 : 0;
    t[i] = active ? t_b : RTW_BIG;
    sb[i] = active ? s_b : 0;
}

template <int K>
static int launch(const void* act, const void* ox, const void* oy,
                  const void* oz, const void* dx, const void* dy,
                  const void* dz, const void* table, const void* bounds,
                  void* hit, void* t, void* sb, void* stats, int n_lanes,
                  int n_groups, float t_min, cudaStream_t stream) {
    const size_t smem = (size_t)n_groups * (CG_GROUP + 1) * sizeof(float4);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            closest_hit_grouped_kernel<K>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int rays_per_block = CG_THREADS / K;
    const int blocks = (n_lanes + rays_per_block - 1) / rays_per_block;
    closest_hit_grouped_kernel<K><<<blocks, CG_THREADS, smem, stream>>>(
        (const int*)act, (const float*)ox, (const float*)oy,
        (const float*)oz, (const float*)dx, (const float*)dy,
        (const float*)dz, (const float4*)table, (const float4*)bounds,
        (int*)hit, (float*)t, (int*)sb, (unsigned long long*)stats,
        n_lanes, n_groups, t_min);
    return (int)cudaGetLastError();
}

// C entry. Pointers are device pointers; `table` is (S_pad, 4) float32
// (cx, cy, cz, r) of the SORTED scene, S_pad = 16 * n_groups; `bounds` is
// (n_groups, 4) float32 (gx, gy, gz, gr); `stats` is two uint64 counters
// or null; `split` is K, the threads per ray (1, 2, 4, 8 or 16; anything
// else returns cudaErrorInvalidValue). Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int rtw_closest_hit_grouped(
        const void* act, const void* ox, const void* oy, const void* oz,
        const void* dx, const void* dy, const void* dz, const void* table,
        const void* bounds, void* hit, void* t, void* sb, void* stats,
        int n_lanes, int n_groups, float t_min, int split, void* stream) {
    if (n_lanes < 1 || n_groups < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define CG_CASE(k)                                                        \
    case k:                                                               \
        return launch<k>(act, ox, oy, oz, dx, dy, dz, table, bounds, hit, \
                         t, sb, stats, n_lanes, n_groups, t_min, st);
    switch (split) {
        CG_CASE(1) CG_CASE(2) CG_CASE(4) CG_CASE(8) CG_CASE(16)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef CG_CASE
}
