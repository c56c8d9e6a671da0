// mega_bounce: one whole wavefront bounce per lane -- closest hit, the
// winner's parameters, the bounce's threefry draws, the material shade and
// the lane-state update -- in one pass.
//
// Replaces the Pallas TPU kernel raytracinginoneweekend_tpu/ops/
// pallas_mega.py::_kernel_mega (reached through mega_bounce). Plain
// PyTorch version: ops/cuda_mega.mega_bounce_reference.
//
// In: 16 planes (active i32, ox oy oz dx dy dz ax ay az accr accg accb
// f32, depth i32, k0 k1 the key words). Out: 14 planes (the 12 f32 planes
// after the bounce, keep i32 0/1, depth i32).
//
// What bounds it: float32 instruction issue. The closest hit is
// closest_hit.cu's loop (about 27 operations per active lane and sphere,
// 18 where the discriminant is negative -- most pairs -- one instruction
// each under -fmad=false; 489 spheres on the huge scene); the rest -- two
// threefry blocks, one sinf/cosf pair, the shade -- is a few hundred
// operations a lane, and the traffic is 30 words a lane. The design keeps
// everything a lane needs after its own 16 words on chip: the (cx, cy, cz,
// r*r) float4 table AND the (S, 10) parameter table in shared memory (56 B
// a sphere, 27 KB on the huge scene), so the winner's row is a direct read
// where the TPU kernel resolves it with a transposed one-hot product on
// its matrix unit.
//
// Design: closest_hit.cu's split loop, then one thread a lane for the
// rest. K threads share a ray's sphere loop (a template argument, a power
// of two from 1 to 32, picked by the wrapper with closest_hit's picker
// aimed at half its threads an SM: cuda_segment.SPLIT_THREADS_PER_SM):
// thread j of the group scans spheres j, j + K, ... with
// rtw_closest_guarded (the sqrt only where the discriminant is >= 0,
// bit-equal with the unguarded form) and keeps its own partial (q, s); the
// group reduces the K partials with __shfl_xor_sync lexicographically
// over (q, sphere index), which is the ascending strict-`<` running min
// (the earliest sphere wins ties, as the TPU kernel's 8-way tournament
// does) for any partition, so every K gives the one-thread result to the
// bit. Thread 0 of the group then reads the lane's other planes and does
// the winner lookup, the draws, the shade and the writes: t_safe = hit ?
// q_best * (1/a) : 1, the normal is (p - c) * (1/r) with r = 1 for
// r == 0, and the draws and shade are rtw_bounce_draws / rtw_shade, the
// device copies of the plain versions' ops/planar.py functions. Every
// plane is its own array, so a warp reads and writes neighbouring
// addresses. An inactive lane copies its state through and writes keep =
// 0: the TPU kernel masks every output with `active`, so this is the same
// result without its work. Past-the-end and inactive lanes take part in
// the shuffles (a predicate, no early return). In place: every thread of
// a group has read the lane's ray (and used it) before the shuffles that
// thread 0 waits on, and thread 0 writes only after them.

#include "rtw_common.cuh"

#define MB_THREADS 256
#define MB_N_IN 16
#define MB_N_OUT 14
#define MB_TABLE_COLS 10
#define MB_FULL_MASK 0xffffffffu

struct MegaPtrs {
    const void* in[MB_N_IN];
    void* out[MB_N_OUT];
};

template <int K>
__global__ void __launch_bounds__(MB_THREADS)
mega_bounce_kernel(const MegaPtrs p, const float4* __restrict__ table4,
                   const float* __restrict__ table10, int n_lanes,
                   int n_spheres, float t_min, int max_depth,
                   int unit_sample, int phys_refract, float sky_bias) {
    static_assert(K >= 1 && K <= 32 && (K & (K - 1)) == 0,
                  "K is a power of two from 1 to 32");
    extern __shared__ float4 smem[];
    float4* sph = smem;                          // [S] cx cy cz r*r
    float* par = (float*)(smem + n_spheres);     // [S * 10]
    for (int s = threadIdx.x; s < n_spheres; s += MB_THREADS)
        sph[s] = table4[s];
    for (int k = threadIdx.x; k < n_spheres * MB_TABLE_COLS;
         k += MB_THREADS)
        par[k] = table10[k];
    __syncthreads();

    const int j = threadIdx.x & (K - 1);
    const int i = blockIdx.x * (MB_THREADS / K) + threadIdx.x / K;
    const int il = min(i, n_lanes - 1);
#define LDI(k) (((const int*)p.in[k])[il])
#define LDF(k) (((const float*)p.in[k])[il])
#define LDU(k) (((const uint32_t*)p.in[k])[il])
#define STI(k, v) (((int*)p.out[k])[il] = (v))
#define STF(k, v) (((float*)p.out[k])[il] = (v))

    // ---- 1. closest-hit min loop (closest_hit.cu) ---------------------
    const bool active = i < n_lanes && LDI(0) > 0;
    const float ox = LDF(1), oy = LDF(2), oz = LDF(3);
    const float dx = LDF(4), dy = LDF(5), dz = LDF(6);
    const float a = dx * dx + dy * dy + dz * dz;
    float q_b = RTW_BIG;
    int s_b = 0;
    if (active) {
        const float q_min = t_min * a;
#pragma unroll 4
        for (int s = j; s < n_spheres; s += K)
            rtw_closest_guarded(ox, oy, oz, dx, dy, dz, a, q_min, sph[s],
                                s, q_b, s_b);
    }
#pragma unroll
    for (int off = K / 2; off > 0; off >>= 1) {
        const float oq = __shfl_xor_sync(MB_FULL_MASK, q_b, off);
        const int os = __shfl_xor_sync(MB_FULL_MASK, s_b, off);
        if (oq < q_b || (oq == q_b && os < s_b)) {
            q_b = oq;
            s_b = os;
        }
    }
    if (j != 0 || i >= n_lanes) return;

    const float ax = LDF(7), ay = LDF(8), az = LDF(9);
    const float ar = LDF(10), ag = LDF(11), ab = LDF(12);
    const int dep = LDI(13);
    float nox = ox, noy = oy, noz = oz, ndx = dx, ndy = dy, ndz = dz;
    float nax = ax, nay = ay, naz = az, nar = ar, nag = ag, nab = ab;
    bool keep = false;
    if (active) {
        const bool hit = q_b < RTW_BIG;
        const float t_safe = hit ? q_b * (1.0f / a) : 1.0f;

        // ---- 2. the winner's parameters, by index ---------------------
        const float* row = par + s_b * MB_TABLE_COLS;
        const float chx = row[0], chy = row[1], chz = row[2], rh = row[3];
        const int mt = (int)row[4];
        const float alr = row[5], alg = row[6], alb = row[7];
        const float fz = row[8], io = row[9];
        const float px = ox + t_safe * dx;
        const float py = oy + t_safe * dy;
        const float pz = oz + t_safe * dz;
        const float inv_r = 1.0f / ((rh != 0.0f) ? rh : 1.0f);
        const float nx = (px - chx) * inv_r;
        const float ny = (py - chy) * inv_r;
        const float nz = (pz - chz) * inv_r;

        // ---- 3 + 4. the bounce's draws and the shade ------------------
        float rvx, rvy, rvz, ru;
        rtw_bounce_draws(LDU(14), LDU(15), dep, unit_sample != 0, rvx, rvy,
                         rvz, ru);
        const RtwShade sh = rtw_shade(dx, dy, dz, nx, ny, nz, mt, fz, io,
                                      rvx, rvy, rvz, ru, phys_refract != 0,
                                      sky_bias);

        // ---- 5. the state update (ops/wavefront.segment) --------------
        const bool miss_now = !hit;
        const bool scatter_now = hit && sh.valid;
        keep = scatter_now && !(dep + 1 >= max_depth);
        if (miss_now) {
            nar = ar + ax * sh.sky_r;
            nag = ag + ay * sh.sky_g;
            nab = ab + az * sh.sky_b;
        }
        if (keep) {
            nox = px; noy = py; noz = pz;
            ndx = sh.sdx; ndy = sh.sdy; ndz = sh.sdz;
            nax = ax * alr; nay = ay * alg; naz = az * alb;
        }
    }
    STF(0, nox); STF(1, noy); STF(2, noz);
    STF(3, ndx); STF(4, ndy); STF(5, ndz);
    STF(6, nax); STF(7, nay); STF(8, naz);
    STF(9, nar); STF(10, nag); STF(11, nab);
    STI(12, keep ? 1 : 0);
    STI(13, keep ? dep + 1 : dep);
#undef LDI
#undef LDF
#undef LDU
#undef STI
#undef STF
}

template <int K>
static int launch(const MegaPtrs& ptrs, const void* table4,
                  const void* table10, int n_lanes, int n_spheres,
                  float t_min, int max_depth, int unit_sample,
                  int phys_refract, float sky_bias, cudaStream_t stream) {
    const size_t smem = (size_t)n_spheres
                        * (sizeof(float4) + MB_TABLE_COLS * sizeof(float));
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            mega_bounce_kernel<K>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int rays_per_block = MB_THREADS / K;
    const int blocks = (n_lanes + rays_per_block - 1) / rays_per_block;
    mega_bounce_kernel<K><<<blocks, MB_THREADS, smem, stream>>>(
        ptrs, (const float4*)table4, (const float*)table10, n_lanes,
        n_spheres, t_min, max_depth, unit_sample, phys_refract, sky_bias);
    return (int)cudaGetLastError();
}

// C entry. `state_in` and `state_out` are HOST arrays of 16 and 14 device
// pointers (the planes above, in that order).
// `table4` is (S, 4) float32 (cx, cy, cz, r*r), `table10` the (S, 10)
// float32 parameter table (cx cy cz r mtype ar ag ab fuzz ior); `split`
// is K, the threads per ray (1, 2, 4, 8, 16 or 32; anything else returns
// cudaErrorInvalidValue). Launches on `stream`, does not synchronise,
// returns cudaGetLastError().
extern "C" int rtw_mega_bounce(const void* const* state_in,
                               void* const* state_out, const void* table4,
                               const void* table10, int n_lanes,
                               int n_spheres, float t_min, int max_depth,
                               int unit_sample, int phys_refract,
                               float sky_bias, int split, void* stream) {
    if (n_lanes < 1 || n_spheres < 1 || max_depth < 1)
        return (int)cudaErrorInvalidValue;
    MegaPtrs ptrs = {};
    for (int k = 0; k < MB_N_IN; ++k) ptrs.in[k] = state_in[k];
    for (int k = 0; k < MB_N_OUT; ++k) ptrs.out[k] = state_out[k];
    cudaStream_t st = (cudaStream_t)stream;
#define MB_CASE(k)                                                         \
    case k:                                                                \
        return launch<k>(ptrs, table4, table10, n_lanes, n_spheres, t_min, \
                         max_depth, unit_sample, phys_refract, sky_bias,   \
                         st);
    switch (split) {
        MB_CASE(1) MB_CASE(2) MB_CASE(4) MB_CASE(8) MB_CASE(16) MB_CASE(32)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef MB_CASE
}
