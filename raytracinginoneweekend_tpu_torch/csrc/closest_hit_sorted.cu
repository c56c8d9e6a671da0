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
// stages; a stage is skipped when every ray of the WARP (32 / K rays, see
// below) is finished at the stage's first chunk. (The TPU kernel takes
// the consensus over its whole 8192-lane block; since a skipped sphere
// could not have won, the width of the consensus changes speed only,
// never the result, and a warp is this card's natural width -- its
// neighbouring lanes are also the most coherent.) Finished-ness is
// monotone in the checkpoint, so a check stays sound after earlier stages
// were skipped. No ladder = no checks.
//
// Candidate arithmetic is closest_hit's (rtw_closest_guarded, bit-equal
// with the unguarded form); the running min keeps the earliest sphere in the
// SORTED order on exact q ties -- the one observable difference from
// closest_hit. t = q_best * (1 / a) does not depend on any of the exit
// terms.
//
// What bounds it: float32 instruction issue when nothing is skipped
// (closest_hit's 27 operations per lane and sphere, 18 where the
// discriminant is negative, one instruction each under -fmad=false),
// falling towards the 40 bytes a lane as the exit fires. What kept the
// one-thread-per-lane form from it is closest_hit's story: 8 warps an SM
// at the default pool, too few to hide the candidate's dependent chain,
// and the IEEE sqrtf of every negative discriminant.
//
// Design (closest_hit.cu's split loop, in perm order):
//   * K threads per ray (a template argument, a power of two from 1 to
//     32, picked by the wrapper with closest_hit's picker aimed at half
//     its threads an SM: cuda_segment.SPLIT_THREADS_PER_SM). Within each
//     stage thread j of a ray's group scans perm POSITIONS lo*8 + j,
//     lo*8 + j + K, ... with rtw_closest_guarded (the sqrt only where the
//     discriminant is >= 0) and keeps its own partial (q, position) with
//     strict `<`. After the last stage the group reduces the partials
//     with __shfl_xor_sync, lexicographically over (q, POSITION IN perm),
//     and only then maps the winning position through ids[]: that is the
//     ascending strict-`<` running min over perm for any partition, so
//     ties keep the earliest sphere in sorted order at every K. (A reduce
//     over (q, sphere id) would keep the lowest id instead.)
//   * The stage vote: before each checkpoint every thread tests the exit
//     on its OWN partial q, which is no less than the ray's best so far,
//     so a thread that is finished is right to be; the warp (32 / K rays,
//     every thread of each) skips the stage when all of its threads are.
//     Skipping changes no result at any width. (Reducing the group's q
//     first, log2 K shuffles a checkpoint, makes the vote the ray's own
//     and skips more, but measured no faster on the serving frame's
//     mid-frame states: scripts/torch_sorted_vote_ab.py, PERF.md.)
//     Finished-ness only grows from one checkpoint to the next
//     (suf does not fall, q does not rise), so once a stage is skipped
//     every later one is: the positions a skip leaves out all come after
//     those run.
//   * The thread block (256 threads, or 128 where 256 / K rays would not
//     divide a cull block) lies inside one cull block and gathers that
//     block's spheres IN perm ORDER into shared memory once (cx, cy, cz,
//     r*r and the id); in each step a warp reads K consecutive float4s,
//     which its 32 / K groups share as a broadcast. A thread block with no
//     active lane gathers nothing and writes (0, 1e30, 0).
//   * Past-the-end and inactive lanes run no sphere test but take part in
//     every shuffle and vote (a predicate, no early return; they vote
//     finished). `stats`, when given, counts (warps with an active lane) x
//     (chunks skipped, chunks in all): how often the exit fires.

#include "rtw_common.cuh"

#define CS_THREADS 256
#define CS_CHUNK 8
#define CS_MAX_LADDER 16
#define CS_SORT_REL 5e-6f
#define CS_SORT_ABS 1e-4f
#define CS_FULL_MASK 0xffffffffu

struct SortedLadder {
    int n;                    // checkpoints in use
    int at[CS_MAX_LADDER];    // ascending chunk numbers in (0, n_chunks)
};

template <int K>
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
    static_assert(K >= 1 && K <= 32 && (K & (K - 1)) == 0,
                  "K is a power of two from 1 to 32");
    extern __shared__ float4 smem[];
    const int s_pad = n_chunks * CS_CHUNK;
    float4* sph = smem;                     // [s_pad], in perm order
    int* ids = (int*)(smem + s_pad);        // [s_pad]

    const int rays_per_block = blockDim.x / K;
    const int j = threadIdx.x & (K - 1);
    const int i = blockIdx.x * rays_per_block + threadIdx.x / K;
    const bool active = i < n_lanes && act[i] > 0;
    const int b = (blockIdx.x * rays_per_block) / block_lanes;
    if (__syncthreads_or(active) == 0) {
        if (j == 0 && i < n_lanes) {
            hit[i] = 0;
            t[i] = RTW_BIG;
            sb[i] = 0;
        }
        return;
    }
    rtw_gather_candidates(perm + (size_t)b * s_pad, s_pad, table, n_spheres,
                          sph, ids);
    __syncthreads();

    // Lanes past the end or inactive stay in the shuffles and votes as
    // finished.
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
    int p_b = 0;  // position in perm of this thread's best
    int lo = 0;
    int skipped = 0;
    for (int stage = 0; stage <= ladder.n; ++stage) {
        const int hi = (stage < ladder.n) ? ladder.at[stage] : n_chunks;
        bool run = true;
        if (ladder.n > 0) {
            // this thread's partial q is no less than the ray's best so
            // far: where the thread is finished, so is the ray
            const float qd = rtw_min(q_b * rsa, dist_up);
            const bool done = sky_done || (qd + bl <= suf_b[lo]);
            run = !__all_sync(CS_FULL_MASK, done);
        }
        if (run) {
            if (active) {
#pragma unroll 4
                for (int k = lo * CS_CHUNK + j; k < hi * CS_CHUNK; k += K)
                    rtw_closest_guarded(x, y, z, vx, vy, vz, a, q_min,
                                        sph[k], k, q_b, p_b);
            }
        } else {
            skipped += hi - lo;
        }
        lo = hi;
    }
#pragma unroll
    for (int off = K / 2; off > 0; off >>= 1) {
        const float oq = __shfl_xor_sync(CS_FULL_MASK, q_b, off);
        const int op = __shfl_xor_sync(CS_FULL_MASK, p_b, off);
        if (oq < q_b || (oq == q_b && op < p_b)) {
            q_b = oq;
            p_b = op;
        }
    }
    const bool warp_active = __any_sync(CS_FULL_MASK, active);
    if (stats != nullptr && (threadIdx.x & 31) == 0 && warp_active) {
        atomicAdd(&stats[0], (unsigned long long)skipped);
        atomicAdd(&stats[1], (unsigned long long)n_chunks);
    }
    if (j != 0 || i >= n_lanes) return;
    const bool h = active && (q_b < RTW_BIG);
    hit[i] = h ? 1 : 0;
    t[i] = h ? q_b * inv_a : RTW_BIG;
    sb[i] = h ? ids[p_b] : 0;
}

template <int K>
static int launch(const SortedLadder& lad, const void* perm, const void* suf,
                  const void* oc, const void* yb, const void* act,
                  const void* ox, const void* oy, const void* oz,
                  const void* dx, const void* dy, const void* dz,
                  const void* table, void* hit, void* t, void* sb,
                  void* stats, int n_lanes, int n_spheres, int block_lanes,
                  int n_chunks, float t_min, cudaStream_t stream) {
    const size_t smem =
        (size_t)n_chunks * CS_CHUNK * (sizeof(float4) + sizeof(int));
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            closest_hit_sorted_kernel<K>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    // a thread block must lie inside one cull block
    const int threads =
        ((size_t)block_lanes * K) % CS_THREADS == 0 ? CS_THREADS : 128;
    const int rays_per_block = threads / K;
    const int blocks = (n_lanes + rays_per_block - 1) / rays_per_block;
    closest_hit_sorted_kernel<K><<<blocks, threads, smem, stream>>>(
        lad, (const int*)perm, (const float*)suf, (const float*)oc,
        (const float*)yb, (const int*)act, (const float*)ox,
        (const float*)oy, (const float*)oz, (const float*)dx,
        (const float*)dy, (const float*)dz, (const float4*)table, (int*)hit,
        (float*)t, (int*)sb, (unsigned long long*)stats, n_lanes, n_spheres,
        block_lanes, n_chunks, t_min);
    return (int)cudaGetLastError();
}

// C entry. Pointers are device pointers (`ladder` and `n_ladder` describe a
// HOST array of ascending chunk numbers in (0, n_chunks)); `table` is
// (S + 1, 4) float32, its last row the pad sphere (0, 0, 0, -1); `stats`
// is two uint64 counters or null; `split` is K, the threads per ray (1, 2,
// 4, 8, 16 or 32). Launches on `stream`, does not synchronise, returns
// cudaGetLastError() (cudaErrorInvalidValue for a block size that is no
// multiple of 128, a ladder that is too long or another split).
extern "C" int rtw_closest_hit_sorted(
        const int* ladder, int n_ladder, const void* perm, const void* suf,
        const void* oc, const void* yb, const void* act, const void* ox,
        const void* oy, const void* oz, const void* dx, const void* dy,
        const void* dz, const void* table, void* hit, void* t, void* sb,
        void* stats, int n_lanes, int n_spheres, int block_lanes,
        int n_chunks, float t_min, int split, void* stream) {
    if (block_lanes <= 0 || block_lanes % 128 != 0 || n_chunks < 1
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
    cudaStream_t st = (cudaStream_t)stream;
#define CS_CASE(k)                                                         \
    case k:                                                                \
        return launch<k>(lad, perm, suf, oc, yb, act, ox, oy, oz, dx, dy,  \
                         dz, table, hit, t, sb, stats, n_lanes, n_spheres, \
                         block_lanes, n_chunks, t_min, st);
    switch (split) {
        CS_CASE(1) CS_CASE(2) CS_CASE(4) CS_CASE(8) CS_CASE(16) CS_CASE(32)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef CS_CASE
}
