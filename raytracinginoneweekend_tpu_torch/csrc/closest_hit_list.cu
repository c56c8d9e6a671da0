// closest_hit_list: per ray, the closest hit over its cull block's
// candidate list.
//
// Replaces the Pallas TPU kernel raytracinginoneweekend_tpu/ops/
// pallas_segment.py::_kernel_list (reached through
// segment_closest_hit_list). Plain PyTorch version:
// ops/cuda_segment.segment_closest_hit_list_reference.
//
// A CULL BLOCK is `block_lanes` consecutive lanes (rows * 128, the
// granularity at which ops/cull.py bounds the rays by a cone); block b
// tests only lists[b, :counts[b]], sphere ids in ascending order chosen by
// a conservative cull. The candidate arithmetic is closest_hit's
// (rtw_candidate), the list is ascending and the running min is strict,
// so the result is bit-identical with closest_hit wherever the list holds
// the true winner. Entries that index the pad sphere (id S, r*r = -1) can
// never win; they are accepted and tested like any other.
//
// What bounds it: bytes, at the list lengths a coherent block has (a lane
// moves 40 bytes and does about 27 operations per candidate; a few
// candidates per lane leave the arithmetic below the traffic).
//
// Design: the cull block is the contract's, the thread block is this
// kernel's own -- 128 threads, one lane each, all of one cull block
// (block_lanes is a multiple of 128). Each thread block loads counts[b]
// and gathers its block's candidates (cx, cy, cz, r*r and the id) into
// shared memory once -- the counterpart of the TPU kernel's scalar
// prefetch -- then runs closest_hit's loop over them, every warp reading
// one candidate at a time as a broadcast. An empty list, or a thread
// block whose lanes are all inactive, gathers nothing. An inactive lane
// always gets (hit 0, t 1e30, sb 0).

#include "rtw_common.cuh"

#define CL_THREADS 128

__global__ void __launch_bounds__(CL_THREADS)
closest_hit_list_kernel(const int* __restrict__ counts,
                        const int* __restrict__ lists,
                        const int* __restrict__ act,
                        const float* __restrict__ ox,
                        const float* __restrict__ oy,
                        const float* __restrict__ oz,
                        const float* __restrict__ dx,
                        const float* __restrict__ dy,
                        const float* __restrict__ dz,
                        const float4* __restrict__ table,  // (S + 1)
                        int* __restrict__ hit, float* __restrict__ t,
                        int* __restrict__ sb, int n_lanes, int n_spheres,
                        int block_lanes, int list_len, float t_min) {
    extern __shared__ float4 smem[];
    float4* sph = smem;                        // [list_len]
    int* ids = (int*)(smem + list_len);        // [list_len]

    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool active = i < n_lanes && act[i] > 0;
    const int b = (blockIdx.x * blockDim.x) / block_lanes;
    const int n = min(max(counts[b], 0), list_len);
    const bool any_active = __syncthreads_or(active) != 0;
    if (any_active && n > 0) {
        rtw_gather_candidates(lists + (size_t)b * list_len, n, table,
                              n_spheres, sph, ids);
        __syncthreads();
    }
    if (i >= n_lanes) return;
    if (!active) {
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
    for (int k = 0; k < n; ++k) {
        const float q = rtw_candidate(x, y, z, vx, vy, vz, a, q_min, sph[k]);
        if (q < q_b) {
            q_b = q;
            s_b = ids[k];
        }
    }
    const bool h = q_b < RTW_BIG;
    hit[i] = h ? 1 : 0;
    t[i] = h ? q_b * inv_a : RTW_BIG;
    sb[i] = s_b;
}

// C entry. Pointers are device pointers; `table` is (S + 1, 4) float32
// (cx, cy, cz, r*r), its last row the pad sphere (0, 0, 0, -1); `counts`
// is (B,) and `lists` (B, list_len) int32 with B = n_lanes / block_lanes.
// Launches on `stream`, does not synchronise, returns cudaGetLastError()
// (cudaErrorInvalidValue for a block size that is no multiple of 128).
extern "C" int rtw_closest_hit_list(
        const void* counts, const void* lists, const void* act,
        const void* ox, const void* oy, const void* oz, const void* dx,
        const void* dy, const void* dz, const void* table, void* hit,
        void* t, void* sb, int n_lanes, int n_spheres, int block_lanes,
        int list_len, float t_min, void* stream) {
    if (block_lanes <= 0 || block_lanes % CL_THREADS != 0 || list_len < 0
            || n_spheres < 1)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)list_len * (sizeof(float4) + sizeof(int));
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            closest_hit_list_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int blocks = (n_lanes + CL_THREADS - 1) / CL_THREADS;
    closest_hit_list_kernel<<<blocks, CL_THREADS, smem,
                              (cudaStream_t)stream>>>(
        (const int*)counts, (const int*)lists, (const int*)act,
        (const float*)ox, (const float*)oy, (const float*)oz,
        (const float*)dx, (const float*)dy, (const float*)dz,
        (const float4*)table, (int*)hit, (float*)t, (int*)sb, n_lanes,
        n_spheres, block_lanes, list_len, t_min);
    return (int)cudaGetLastError();
}
