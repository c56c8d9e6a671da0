// closest_hit_sorted: per ray, the closest hit with the spheres taken in
// its cull block's DISTANCE order and a staged early exit.
//
// Replaces the Pallas TPU kernel raytracinginoneweekend_tpu/ops/
// pallas_segment.py::_kernel_sorted (reached through
// segment_closest_hit_sorted). Plain PyTorch version:
// ops/cuda_segment.segment_closest_hit_sorted_reference.
//
// Per cull block b (`block_lanes` consecutive lanes) the caller supplies
// (ops/cuda_segment.sorted_cull_state): perm[b, :] = sphere ids sorted by
// a conservative lower bound key_j on any lane's hit distance on sphere j
// (measured from the block's origin centroid oc[b]), padded to a multiple
// of 8 with the pad sphere's id; suf[b, i] = the least key from chunk i on
// (a chunk = 8 consecutive entries of perm); and the slab planes yb =
// (ymax, ymin) that contain every sphere. A lane is FINISHED at chunk i
// when
//     min(dist_best, dist_exit) + bl <= suf[b, i]
// where bl = |o - oc[b]| and dist_exit is where the ray leaves the slab:
// every sphere from chunk i on is then provably farther than what the
// lane already has (or than the slab's end), so it could never win the
// strict-< running min. Every bound carries explicit slack (SORT_REL,
// SORT_ABS here, the key margin on the caller's side), so skipping
// changes NO result. A ray already outside the slab heading away, and an
// inactive lane, are finished from the start.
//
// The sphere loop is cut at the `ladder` checkpoints (chunk numbers) into
// stages; a stage is skipped when every lane of the WARP is finished at
// the stage's first chunk. (The TPU kernel takes the consensus over its
// whole 8192-lane block; since a skipped sphere could not have won, the
// width of the consensus changes speed only, never the result, and a warp
// is this card's natural width -- 32 neighbouring lanes are also the most
// coherent.) Finished-ness is monotone in the checkpoint, so a check
// stays sound after earlier stages were skipped. No ladder = no checks.
//
// Candidate arithmetic is closest_hit's (rtw_candidate); the running min
// keeps the earliest sphere in the SORTED order on exact q ties -- the one
// observable difference from closest_hit. t = q_best * (1 / a) does not
// depend on any of the exit terms.
//
// What bounds it: float32 arithmetic when nothing is skipped (closest_hit's
// 27 operations per lane and sphere), falling towards the 40 bytes a lane
// as the exit fires.
//
// Design: 128 threads, one lane each, all of one cull block. The thread
// block gathers its cull block's spheres IN perm ORDER into shared memory
// once (cx, cy, cz, r*r and the id), so the loop reads consecutive shared
// memory as a broadcast; a thread block with no active lane gathers
// nothing. `stats`, when given, counts (warps with an active lane) x
// (chunks skipped, chunks in all): the measure of how often the exit
// fires.

#include "rtw_common.cuh"

#define CS_THREADS 128
#define CS_CHUNK 8
#define CS_MAX_LADDER 16
#define CS_SORT_REL 5e-6f
#define CS_SORT_ABS 1e-4f

struct SortedLadder {
    int n;                    // checkpoints in use
    int at[CS_MAX_LADDER];    // ascending chunk numbers in (0, n_chunks)
};

__global__ void __launch_bounds__(CS_THREADS)
closest_hit_sorted_kernel(const SortedLadder ladder,
                          const int* __restrict__ perm,   // (B, n_chunks*8)
                          const float* __restrict__ suf,  // (B, n_chunks+1)
                          const float* __restrict__ oc,   // (B, 3)
                          const float* __restrict__ yb,   // (2,)
                          const int* __restrict__ act,
                          const float* __restrict__ ox,
                          const float* __restrict__ oy,
                          const float* __restrict__ oz,
                          const float* __restrict__ dx,
                          const float* __restrict__ dy,
                          const float* __restrict__ dz,
                          const float4* __restrict__ table,  // (S + 1)
                          int* __restrict__ hit, float* __restrict__ t,
                          int* __restrict__ sb,
                          unsigned long long* __restrict__ stats,
                          int n_lanes, int n_spheres, int block_lanes,
                          int n_chunks, float t_min) {
    extern __shared__ float4 smem[];
    const int s_pad = n_chunks * CS_CHUNK;
    float4* sph = smem;                     // [s_pad], in perm order
    int* ids = (int*)(smem + s_pad);        // [s_pad]

    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool active = i < n_lanes && act[i] > 0;
    const int b = (blockIdx.x * blockDim.x) / block_lanes;
    if (__syncthreads_or(active) == 0) {
        if (i < n_lanes) {
            hit[i] = 0;
            t[i] = RTW_BIG;
            sb[i] = 0;
        }
        return;
    }
    rtw_gather_candidates(perm + (size_t)b * s_pad, s_pad, table, n_spheres,
                          sph, ids);
    __syncthreads();

    // Lanes past the end or inactive stay in the warp votes as finished.
    const int il = min(i, n_lanes - 1);
    const float x = ox[il], y = oy[il], z = oz[il];
    const float vx = dx[il], vy = dy[il], vz = dz[il];
    const float a = vx * vx + vy * vy + vz * vz;
    const float inv_a = 1.0f / a;
    const float q_min = t_min * a;
    const float rsa = 1.0f / sqrtf(a);      // dist = q * rsa = t * |d|

    const float blx = x - oc[3 * b + 0];
    const float bly = y - oc[3 * b + 1];
    const float blz = z - oc[3 * b + 2];
    float bl = sqrtf(blx * blx + bly * bly + blz * blz);
    bl = bl + (bl * CS_SORT_REL + CS_SORT_ABS);
    // The ray leaves the all-spheres slab (ymin <= y <= ymax) at dist_up:
    // ascending rays through the top plane, descending through the bottom;
    // dy == 0 rays never leave (no bound). |d| = a * rsa.
    const bool going = fabsf(vy) > 0.0f;
    const float yexit = (vy > 0.0f) ? yb[0] : yb[1];
    const float ex = ((yexit - y) * (a * rsa)) / (going ? vy : 1.0f);
    const float dist_up =
        going ? ex + (fabsf(ex) * CS_SORT_REL + CS_SORT_ABS) : RTW_BIG;
    const bool sky_done = !active || (dist_up <= 0.0f);
    const float* __restrict__ suf_b = suf + (size_t)b * (n_chunks + 1);

    float q_b = RTW_BIG;
    int s_b = 0;
    int lo = 0;
    int skipped = 0;
    for (int stage = 0; stage <= ladder.n; ++stage) {
        const int hi = (stage < ladder.n) ? ladder.at[stage] : n_chunks;
        bool run = true;
        if (ladder.n > 0) {
            const float qd = rtw_min(q_b * rsa, dist_up);
            const bool done = sky_done || (qd + bl <= suf_b[lo]);
            run = !__all_sync(0xffffffffu, done);
        }
        if (run) {
            if (active) {
                for (int k = lo * CS_CHUNK; k < hi * CS_CHUNK; ++k) {
                    const float q = rtw_candidate(x, y, z, vx, vy, vz, a,
                                                  q_min, sph[k]);
                    if (q < q_b) {
                        q_b = q;
                        s_b = ids[k];
                    }
                }
            }
        } else {
            skipped += hi - lo;
        }
        lo = hi;
    }
    const bool warp_active = __any_sync(0xffffffffu, active);
    if (stats != nullptr && (threadIdx.x & 31) == 0 && warp_active) {
        atomicAdd(&stats[0], (unsigned long long)skipped);
        atomicAdd(&stats[1], (unsigned long long)n_chunks);
    }
    if (i >= n_lanes) return;
    const bool h = active && (q_b < RTW_BIG);
    hit[i] = h ? 1 : 0;
    t[i] = h ? q_b * inv_a : RTW_BIG;
    sb[i] = active ? s_b : 0;
}

// C entry. Pointers are device pointers (`ladder` and `n_ladder` describe a
// HOST array of ascending chunk numbers in (0, n_chunks)); `table` is
// (S + 1, 4) float32, its last row the pad sphere (0, 0, 0, -1); `stats`
// is two uint64 counters or null. Launches on `stream`, does not
// synchronise, returns cudaGetLastError() (cudaErrorInvalidValue for a
// block size that is no multiple of 128 or a ladder that is too long).
extern "C" int rtw_closest_hit_sorted(
        const int* ladder, int n_ladder, const void* perm, const void* suf,
        const void* oc, const void* yb, const void* act, const void* ox,
        const void* oy, const void* oz, const void* dx, const void* dy,
        const void* dz, const void* table, void* hit, void* t, void* sb,
        void* stats, int n_lanes, int n_spheres, int block_lanes,
        int n_chunks, float t_min, void* stream) {
    if (block_lanes <= 0 || block_lanes % CS_THREADS != 0 || n_chunks < 1
            || n_spheres < 1 || n_ladder < 0 || n_ladder > CS_MAX_LADDER
            || n_lanes < 1)
        return (int)cudaErrorInvalidValue;
    SortedLadder lad = {};
    lad.n = n_ladder;
    for (int k = 0; k < n_ladder; ++k) {
        lad.at[k] = ladder[k];
        if (lad.at[k] <= (k ? lad.at[k - 1] : 0) || lad.at[k] >= n_chunks)
            return (int)cudaErrorInvalidValue;
    }
    const size_t smem =
        (size_t)n_chunks * CS_CHUNK * (sizeof(float4) + sizeof(int));
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            closest_hit_sorted_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int blocks = (n_lanes + CS_THREADS - 1) / CS_THREADS;
    closest_hit_sorted_kernel<<<blocks, CS_THREADS, smem,
                                (cudaStream_t)stream>>>(
        lad, (const int*)perm, (const float*)suf, (const float*)oc,
        (const float*)yb, (const int*)act, (const float*)ox,
        (const float*)oy, (const float*)oz, (const float*)dx,
        (const float*)dy, (const float*)dz, (const float4*)table, (int*)hit,
        (float*)t, (int*)sb, (unsigned long long*)stats, n_lanes, n_spheres,
        block_lanes, n_chunks, t_min);
    return (int)cudaGetLastError();
}
