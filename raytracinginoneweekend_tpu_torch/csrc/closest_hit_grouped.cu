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
// the bound (~14 operations):
//     might = disc > 0 && (b < 0 || c < 0)
// (the ray's line meets the bound, and the bound is not wholly behind an
// origin outside it); when no active lane of the WARP might hit, the warp
// skips the group's 16 spheres. The TPU kernel takes the vote over its
// whole block of 16384 lanes; the bound is conservative, so the width of
// the vote changes speed only, never the result, and a warp is this card's
// natural width. The candidate is the t-space form of the TPU intersect
// kernel (rtw_candidate_t, guarded disc > 0), so results are those of the
// unculled t-space loop over the sorted table; sphere indices are into the
// SORTED order.
//
// What bounds it: float32 arithmetic, 32 operations per lane and tested
// sphere plus 14 per lane and group; where groups are skipped it falls
// towards the 40 bytes a lane moves. Coherent rays (a warp's lanes on
// neighbouring pixels) are the workload it was designed for.
//
// Design: 128 threads, one lane each; the sorted table (cx, cy, cz, r*r)
// and the bounds (gx, gy, gz, gr*gr) in shared memory (8.4 KB on the huge
// scene), read as broadcasts. A thread block with no active lane writes
// (0, 1e30, 0) and leaves; an inactive lane writes the same and votes
// "no". `stats`, when given, counts (warps with an active lane) x (groups
// skipped, groups in all).

#include "rtw_common.cuh"

#define CG_THREADS 128
#define CG_GROUP 16

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
    extern __shared__ float4 smem[];
    const int s_pad = n_groups * CG_GROUP;
    float4* sph = smem;           // [s_pad] cx cy cz r*r
    float4* grp = smem + s_pad;   // [n_groups] gx gy gz gr*gr

    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool active = i < n_lanes && act[i] > 0;
    if (__syncthreads_or(active) == 0) {
        if (i < n_lanes) {
            hit[i] = 0;
            t[i] = RTW_BIG;
            sb[i] = 0;
        }
        return;
    }
    for (int s = threadIdx.x; s < s_pad; s += blockDim.x) {
        float4 c4 = table[s];
        c4.w = c4.w * c4.w;
        sph[s] = c4;
    }
    for (int g = threadIdx.x; g < n_groups; g += blockDim.x) {
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
    for (int g = 0; g < n_groups; ++g) {
        const float4 g4 = grp[g];
        const float ocx = x - g4.x;
        const float ocy = y - g4.y;
        const float ocz = z - g4.z;
        const float b = ocx * vx + ocy * vy + ocz * vz;
        const float c = ocx * ocx + ocy * ocy + ocz * ocz - g4.w;
        const bool might =
            active && (b * b - a * c > 0.0f) && (b < 0.0f || c < 0.0f);
        if (!__any_sync(0xffffffffu, might)) {
            ++skipped;
            continue;
        }
        if (active) {
            const int lo = g * CG_GROUP;
#pragma unroll 4
            for (int s = lo; s < lo + CG_GROUP; ++s) {
                const float tc = rtw_candidate_t(x, y, z, vx, vy, vz, a,
                                                 inv_a, t_min, sph[s]);
                if (tc < t_b) {
                    t_b = tc;
                    s_b = s;
                }
            }
        }
    }
    const bool warp_active = __any_sync(0xffffffffu, active);
    if (stats != nullptr && (threadIdx.x & 31) == 0 && warp_active) {
        atomicAdd(&stats[0], (unsigned long long)skipped);
        atomicAdd(&stats[1], (unsigned long long)n_groups);
    }
    if (i >= n_lanes) return;
    const bool h = active && (t_b < RTW_BIG);
    hit[i] = h ? 1 : 0;
    t[i] = active ? t_b : RTW_BIG;
    sb[i] = active ? s_b : 0;
}

// C entry. Pointers are device pointers; `table` is (S_pad, 4) float32
// (cx, cy, cz, r) of the SORTED scene, S_pad = 16 * n_groups; `bounds` is
// (n_groups, 4) float32 (gx, gy, gz, gr); `stats` is two uint64 counters
// or null. Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int rtw_closest_hit_grouped(
        const void* act, const void* ox, const void* oy, const void* oz,
        const void* dx, const void* dy, const void* dz, const void* table,
        const void* bounds, void* hit, void* t, void* sb, void* stats,
        int n_lanes, int n_groups, float t_min, void* stream) {
    if (n_lanes < 1 || n_groups < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)n_groups * (CG_GROUP + 1) * sizeof(float4);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            closest_hit_grouped_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int blocks = (n_lanes + CG_THREADS - 1) / CG_THREADS;
    closest_hit_grouped_kernel<<<blocks, CG_THREADS, smem,
                                 (cudaStream_t)stream>>>(
        (const int*)act, (const float*)ox, (const float*)oy,
        (const float*)oz, (const float*)dx, (const float*)dy,
        (const float*)dz, (const float4*)table, (const float4*)bounds,
        (int*)hit, (float*)t, (int*)sb, (unsigned long long*)stats,
        n_lanes, n_groups, t_min);
    return (int)cudaGetLastError();
}
