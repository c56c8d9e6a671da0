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
// (rtw_closest_guarded), the list is ascending and the min keeps the
// earliest list position on exact ties, so the result is bit-identical
// with closest_hit wherever the list holds the true winner. Entries that
// index the pad sphere (id S, r*r = -1) can never win; they are accepted
// and tested like any other.
//
// What bounds it: bytes, at the list lengths a coherent block has (a lane
// moves 40 bytes and does about 27 operations per candidate, 18 where the
// discriminant is negative; a few dozen candidates per lane leave the
// arithmetic near the traffic). What kept the one-thread-per-lane form
// from it: 128 blocks of 128 threads at the dual engine's default pool
// (16384 primary lanes) for 132 SMs; the IEEE sqrtf of every negative
// discriminant in its slow-path subroutine; and a chain of dependent round
// trips before a block's first ray load (act, the block vote, counts[b],
// the list, the table gather, the barrier), which 64 thread blocks of one
// cull block each repeat.
//
// Design:
//   * K threads per ray (a template argument, a power of two from 1 to
//     32, picked by the wrapper with closest_hit's picker). Thread j of a
//     ray's group tests list positions j, j + K, j + 2K, ... with
//     rtw_closest_guarded (the sqrt only where the discriminant is >= 0)
//     and keeps its own partial (q, POSITION IN THE LIST) with strict
//     `<`, starting at (RTW_BIG, 0). The group reduces the partials with
//     __shfl_xor_sync lexicographically over (q, position), and only then
//     maps the winning position through ids[]: that is the one-thread
//     loop's earliest-position rule for any partition, whatever the list's
//     id order.
//   * The thread block (CL_THREADS = 128 threads: faster than 256 at 2^20
//     lanes and level at 16384, scripts/torch_mxu_list_ab.py --block-ab,
//     PERF.md) lies inside one cull block -- a larger CL_THREADS falls back
//     to 128 where CL_THREADS / K rays would not divide one -- and gathers
//     that block's list (cx, cy, cz, r*r and the id) into shared memory
//     once, the counterpart of the TPU kernel's scalar prefetch; every
//     warp then reads K consecutive candidates at a time as a broadcast.
//   * The prologue issues counts[b], the lane's act and, for an active
//     lane, its ray before the block vote, so the ray loads are in flight
//     during the vote and the list gather.
//   * An empty list, or a thread block whose lanes are all inactive,
//     gathers nothing. Past-the-end and inactive lanes run no candidate
//     but take part in the shuffles (a predicate, no early return); an
//     inactive lane writes (hit 0, t 1e30, sb 0).

#include "rtw_common.cuh"

#define CL_THREADS 128
#define CL_FULL_MASK 0xffffffffu

template <int K>
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
    static_assert(K >= 1 && K <= 32 && (K & (K - 1)) == 0,
                  "K is a power of two from 1 to 32");
    extern __shared__ float4 smem[];
    float4* sph = smem;                        // [list_len]
    int* ids = (int*)(smem + list_len);        // [list_len]

    const int rays_per_block = blockDim.x / K;
    const int j = threadIdx.x & (K - 1);
    const int i = blockIdx.x * rays_per_block + threadIdx.x / K;
    const int b = (blockIdx.x * rays_per_block) / block_lanes;
    const int n = min(max(counts[b], 0), list_len);
    const bool active = i < n_lanes && act[i] > 0;
    float x = 0.0f, y = 0.0f, z = 0.0f, vx = 0.0f, vy = 0.0f, vz = 0.0f;
    if (active) {
        x = ox[i];
        y = oy[i];
        z = oz[i];
        vx = dx[i];
        vy = dy[i];
        vz = dz[i];
    }
    if (__syncthreads_or(active) != 0 && n > 0) {
        rtw_gather_candidates(lists + (size_t)b * list_len, n, table,
                              n_spheres, sph, ids);
        __syncthreads();
    }
    float q_b = RTW_BIG;
    int p_b = 0;  // position in the list of this thread's best
    float inv_a = 0.0f;
    if (active) {
        const float a = vx * vx + vy * vy + vz * vz;
        inv_a = 1.0f / a;
        const float q_min = t_min * a;
#pragma unroll 4
        for (int k = j; k < n; k += K)
            rtw_closest_guarded(x, y, z, vx, vy, vz, a, q_min, sph[k], k,
                                q_b, p_b);
    }
#pragma unroll
    for (int off = K / 2; off > 0; off >>= 1) {
        const float oq = __shfl_xor_sync(CL_FULL_MASK, q_b, off);
        const int op = __shfl_xor_sync(CL_FULL_MASK, p_b, off);
        if (oq < q_b || (oq == q_b && op < p_b)) {
            q_b = oq;
            p_b = op;
        }
    }
    if (j != 0 || i >= n_lanes) return;
    const bool h = q_b < RTW_BIG;
    hit[i] = h ? 1 : 0;
    t[i] = h ? q_b * inv_a : RTW_BIG;
    sb[i] = h ? ids[p_b] : 0;
}

template <int K>
static int launch(const void* counts, const void* lists, const void* act,
                  const void* ox, const void* oy, const void* oz,
                  const void* dx, const void* dy, const void* dz,
                  const void* table, void* hit, void* t, void* sb,
                  int n_lanes, int n_spheres, int block_lanes, int list_len,
                  float t_min, cudaStream_t stream) {
    const size_t smem = (size_t)list_len * (sizeof(float4) + sizeof(int));
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            closest_hit_list_kernel<K>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    // a thread block must lie inside one cull block
    const int threads =
        ((size_t)block_lanes * K) % CL_THREADS == 0 ? CL_THREADS : 128;
    const int rays_per_block = threads / K;
    const int blocks = (n_lanes + rays_per_block - 1) / rays_per_block;
    closest_hit_list_kernel<K><<<blocks, threads, smem, stream>>>(
        (const int*)counts, (const int*)lists, (const int*)act,
        (const float*)ox, (const float*)oy, (const float*)oz,
        (const float*)dx, (const float*)dy, (const float*)dz,
        (const float4*)table, (int*)hit, (float*)t, (int*)sb, n_lanes,
        n_spheres, block_lanes, list_len, t_min);
    return (int)cudaGetLastError();
}

// C entry. Pointers are device pointers; `table` is (S + 1, 4) float32
// (cx, cy, cz, r*r), its last row the pad sphere (0, 0, 0, -1); `counts`
// is (B,) and `lists` (B, list_len) int32 with B = n_lanes / block_lanes;
// `split` is K, the threads per ray (1, 2, 4, 8, 16 or 32). Launches on
// `stream`, does not synchronise, returns cudaGetLastError()
// (cudaErrorInvalidValue for a block size that is no multiple of 128 or
// another split).
extern "C" int rtw_closest_hit_list(
        const void* counts, const void* lists, const void* act,
        const void* ox, const void* oy, const void* oz, const void* dx,
        const void* dy, const void* dz, const void* table, void* hit,
        void* t, void* sb, int n_lanes, int n_spheres, int block_lanes,
        int list_len, float t_min, int split, void* stream) {
    if (block_lanes <= 0 || block_lanes % 128 != 0 || list_len < 0
            || n_spheres < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define CL_CASE(k)                                                         \
    case k:                                                                \
        return launch<k>(counts, lists, act, ox, oy, oz, dx, dy, dz,       \
                         table, hit, t, sb, n_lanes, n_spheres,            \
                         block_lanes, list_len, t_min, st);
    switch (split) {
        CL_CASE(1) CL_CASE(2) CL_CASE(4) CL_CASE(8) CL_CASE(16) CL_CASE(32)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef CL_CASE
}
