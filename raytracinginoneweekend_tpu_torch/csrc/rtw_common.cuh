// Shared device code of the wavefront kernels: threefry2x32 and the draw
// contract, the stratified remaps, the material shade and the camera ray.
//
// This header is the CUDA copy of the plain PyTorch functions in
// ops/threefry.py, ops/rng.py and ops/planar.py; each function below names
// its counterpart and keeps its OPERATION ORDER, because the kernels are
// held against those plain versions lane by lane.
//
// Arithmetic rules (compiled with -fmad=false, never -use_fast_math):
//   * integer divisions FLOOR (rtw_floordiv): task and pixel ids are -1 on
//     lanes without a task, and C's `/` truncates where Python floors;
//   * max/min/clip PROPAGATE NaN (rtw_max/rtw_min), as torch.maximum and
//     jnp.maximum do; fmaxf/fminf would return the other operand;
//   * x**2 and x**5 are explicit products (x*x, x*(x2*x2)); u**(1/3) is
//     powf with the float32 exponent, not cbrtf;
//   * every x / n is a true division, never a multiply by a reciprocal;
//   * sinf/cosf/powf/sqrtf, never the __-prefixed approximations.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define RTW_BIG 1e30f
#define RTW_TWO_PI 6.283185307179586f
#define RTW_THIRD (1.0f / 3.0f)
#define RTW_FLT_MIN 1.17549435e-38f

#define RTW_TAG_JITTER 0u
#define RTW_TAG_LENS 1u
#define RTW_TAG_BOUNCE 2u

#define RTW_METAL 1
#define RTW_DIELECTRIC 2

// Floor division for b > 0 (Python's //).
__device__ __forceinline__ int rtw_floordiv(int a, int b) {
    int q = a / b;
    return (a % b < 0) ? q - 1 : q;
}

// NaN-propagating max/min.
__device__ __forceinline__ float rtw_max(float a, float b) {
    return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float rtw_min(float a, float b) {
    return (a < b || a != a) ? a : b;
}

// ---- ops/cuda_segment.py: the closest-hit candidate --------------------

// One sphere's candidate for one ray, in q-space (q = t * |d|^2), folded
// into the strict-`<` running min (q_b, s_b) of sphere s (an index: a
// sphere id, or a position in closest_hit_sorted's perm order or in
// closest_hit_list's list): the loop of closest_hit, closest_hit_list,
// closest_hit_sorted and mega_bounce. (x, y, z) origin, (vx, vy, vz)
// direction, a = |d|^2, q_min = t_min * a, c4 = (cx, cy, cz, r*r); a pad
// sphere (r*r = -1) can never give a candidate.
// The contract is the UNGUARDED form of the plain version
// (cuda_segment._candidates): sqrt(b*b - a*c) on every pair, NaN where
// the discriminant is negative, every comparison with NaN false, so a
// miss falls through to RTW_BIG. This form takes the square root only
// where disc >= 0 and is bit-equal with it: where disc >= 0 (an exact
// graze, disc == 0 or -0, included, as in the TPU kernel) it does the same
// operations in the same order; where disc < 0 or is NaN the unguarded
// roots are NaN, the window yields RTW_BIG, which can never pass a strict
// `<` against q_b <= RTW_BIG -- so skipping the update is exact.
// What it saves: an IEEE sqrtf (-fmad=false, no fast math) of a negative
// argument leaves MUFU.RSQ's fast path for a slow-path subroutine, and
// most sphere tests miss.
__device__ __forceinline__ void rtw_closest_guarded(
        float x, float y, float z, float vx, float vy, float vz, float a,
        float q_min, float4 c4, int s, float& q_b, int& s_b) {
    const float ocx = x - c4.x;
    const float ocy = y - c4.y;
    const float ocz = z - c4.z;
    const float b = ocx * vx + ocy * vy + ocz * vz;
    const float c = ocx * ocx + ocy * ocy + ocz * ocz - c4.w;
    const float disc = b * b - a * c;
    if (disc >= 0.0f) {
        const float sq = sqrtf(disc);
        const float nb = -b;
        const float q0 = nb - sq;
        const float q1 = nb + sq;
        const float q = (q0 > q_min) ? q0 : ((q1 > q_min) ? q1 : RTW_BIG);
        if (q < q_b) {
            q_b = q;
            s_b = s;
        }
    }
}

// The regrouped candidate of closest_hit_mxu folded into the strict-`<`
// running min (q_b, s_b) of sphere s, with the square root taken only
// where disc = bneg*bneg - a*c >= 0 (plain version:
// cuda_segment.segment_closest_hit_mxu_reference). The per-ray scalars are
// a = |d|^2, d_o = d.o, o_o = |o|^2 and q_min = t_min * a; c4 = (cx, cy,
// cz, |C|^2 - r^2). Per sphere
//     -b = d.C - d.o,   c = (|o|^2 - 2 o.C) + (|C|^2 - r^2)
// in this fixed order, then the roots, the window and the min. Bit-equal
// with the unguarded form (sqrtf(disc) on every pair, NaN below 0) by
// rtw_closest_guarded's argument: where disc >= 0 the same operations in
// the same order; where disc < 0 or is NaN the unguarded roots are NaN,
// the window yields RTW_BIG, and RTW_BIG never passes the strict `<`.
__device__ __forceinline__ void rtw_mxu_guarded(
        float x, float y, float z, float vx, float vy, float vz, float a,
        float d_o, float o_o, float q_min, float4 c4, int s, float& q_b,
        int& s_b) {
    const float dC = vx * c4.x + vy * c4.y + vz * c4.z;
    const float oC = x * c4.x + y * c4.y + z * c4.z;
    const float bneg = dC - d_o;                 // -b = d.C - d.o
    const float c = (o_o - (oC + oC)) + c4.w;
    const float disc = bneg * bneg - a * c;
    if (disc >= 0.0f) {
        const float sq = sqrtf(disc);
        const float q0 = bneg - sq;
        const float q1 = bneg + sq;
        const float q = (q0 > q_min) ? q0 : ((q1 > q_min) ? q1 : RTW_BIG);
        if (q < q_b) {
            q_b = q;
            s_b = s;
        }
    }
}

// One sphere's candidate for one ray in t-space, folded into the
// strict-`<` running min (t_b, s_b) of sphere s: the loop of intersect.cu
// and closest_hit_grouped.cu (s a sphere id, or a position in the grouped
// kernel's sorted table). The TPU intersect kernel's formula in its
// operation order (plain version: ops/intersect._block_candidates):
// disc = b*b - a*c; where disc > 0, t0 = (-b - sqrt(disc)) * inv_a and
// t1 = (-b + sqrt(disc)) * inv_a, the near root if it is past t_min, else
// the far root if it is, else RTW_BIG. inv_a = 1 / |d|^2, c4 = (cx, cy,
// cz, r*r).
// The contract is the form that takes sqrt(pos ? disc : 1) on every pair
// and refuses both roots where !pos. This form takes the square root and
// the roots only inside `disc > 0`, and is bit-equal with it: inside the
// branch it does the same operations in the same order; outside it, where
// disc <= 0 or is NaN, the contract's candidate is RTW_BIG, which can
// never pass the strict `<` against t_b <= RTW_BIG. Two things keep it so:
// the guard is STRICT (disc == 0, a tangent, is a miss in t-space, as in
// the TPU kernel; kernel 1's q-space guard is >= 0), and the compare stays
// in t (`t > t_min` on (-b -/+ sq) * inv_a, then `t < t_b`): in q = t*a the
// window's knife edge and exact ties round otherwise.
__device__ __forceinline__ void rtw_closest_t_guarded(
        float x, float y, float z, float vx, float vy, float vz, float a,
        float inv_a, float t_min, float4 c4, int s, float& t_b, int& s_b) {
    const float ocx = x - c4.x;
    const float ocy = y - c4.y;
    const float ocz = z - c4.z;
    const float b = ocx * vx + ocy * vy + ocz * vz;
    const float c = ocx * ocx + ocy * ocy + ocz * ocz - c4.w;
    const float disc = b * b - a * c;
    if (disc > 0.0f) {
        const float sq = sqrtf(disc);
        const float nb = -b;
        const float t0 = (nb - sq) * inv_a;
        const float t1 = (nb + sq) * inv_a;
        const float tc = (t0 > t_min) ? t0 : ((t1 > t_min) ? t1 : RTW_BIG);
        if (tc < t_b) {
            t_b = tc;
            s_b = s;
        }
    }
}

// The lexicographic min over (t, s) of the K partials of one ray: the K
// threads of a ray are K consecutive lanes of a warp (K a power of two up
// to 32), and every lane of the warp takes part. The ascending strict-`<`
// running min's answer for any partition of the scan (the one-thread
// loop's, ties to the smallest s).
template <int K>
__device__ __forceinline__ void rtw_reduce_min(float& t_b, int& s_b) {
#pragma unroll
    for (int off = K / 2; off > 0; off >>= 1) {
        const float ot = __shfl_xor_sync(0xffffffffu, t_b, off);
        const int os = __shfl_xor_sync(0xffffffffu, s_b, off);
        if (ot < t_b || (ot == t_b && os < s_b)) {
            t_b = ot;
            s_b = os;
        }
    }
}

// A thread block's candidate list into shared memory: sph[k] = table[id],
// ids[k] = id for the n entries of `list` (ids clamped to the table, whose
// last row `pad_id` is the pad sphere, so a bad id cannot become a wild
// read). The caller synchronises.
__device__ __forceinline__ void rtw_gather_candidates(
        const int* __restrict__ list, int n,
        const float4* __restrict__ table, int pad_id, float4* sph,
        int* ids) {
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
        const int id = min(max(list[k], 0), pad_id);
        ids[k] = id;
        sph[k] = table[id];
    }
}

// ---- ops/threefry.py --------------------------------------------------

__device__ __forceinline__ uint32_t rtw_rotl(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

// threefry2x32: hash (x0, x1) under key (k0, k1); results in x0, x1.
__device__ __forceinline__ void rtw_threefry(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
    const uint32_t ks0 = k0, ks1 = k1, ks2 = k0 ^ k1 ^ 0x1BD11BDAu;
    x0 += ks0;
    x1 += ks1;
#define RTW_ROUND(r) x0 += x1; x1 = rtw_rotl(x1, r); x1 ^= x0;
    RTW_ROUND(13) RTW_ROUND(15) RTW_ROUND(26) RTW_ROUND(6)
    x0 += ks1; x1 += ks2 + 1u;
    RTW_ROUND(17) RTW_ROUND(29) RTW_ROUND(16) RTW_ROUND(24)
    x0 += ks2; x1 += ks0 + 2u;
    RTW_ROUND(13) RTW_ROUND(15) RTW_ROUND(26) RTW_ROUND(6)
    x0 += ks0; x1 += ks1 + 3u;
    RTW_ROUND(17) RTW_ROUND(29) RTW_ROUND(16) RTW_ROUND(24)
    x0 += ks1; x1 += ks2 + 4u;
    RTW_ROUND(13) RTW_ROUND(15) RTW_ROUND(26) RTW_ROUND(6)
    x0 += ks2; x1 += ks0 + 5u;
#undef RTW_ROUND
}

// fold_in_words: new key = hash(0, data).
__device__ __forceinline__ void rtw_fold_in(uint32_t k0, uint32_t k1,
                                            uint32_t data, uint32_t& o0,
                                            uint32_t& o1) {
    o0 = 0u;
    o1 = data;
    rtw_threefry(k0, k1, o0, o1);
}

// uniform_from_bits: mantissa fill, [0, 1).
__device__ __forceinline__ float rtw_uniform(uint32_t bits) {
    return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// draw_uniform2: two uniforms from the hash of (tag, j).
__device__ __forceinline__ void rtw_draw2(uint32_t k0, uint32_t k1,
                                          uint32_t tag, uint32_t j,
                                          float& u0, float& u1) {
    uint32_t x0 = tag, x1 = j;
    rtw_threefry(k0, k1, x0, x1);
    u0 = rtw_uniform(x0);
    u1 = rtw_uniform(x1);
}

// ---- ops/rng.py -------------------------------------------------------

__device__ __forceinline__ void rtw_unit_from_uv(float u0, float u1,
                                                 float& x, float& y,
                                                 float& z) {
    z = 2.0f * u0 - 1.0f;
    const float rho = sqrtf(rtw_max(1.0f - z * z, 0.0f));
    const float phi = RTW_TWO_PI * u1;
    x = rho * cosf(phi);
    y = rho * sinf(phi);
}

// Base-2 van der Corput of sid, top 24 bits (rng._vdc).
__device__ __forceinline__ float rtw_vdc(int sid) {
    return (float)(__brev((uint32_t)sid) >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ void rtw_stratify_uv(float ju, float rot_v,
                                                int sid, int spp, float& u,
                                                float& v) {
    u = ((float)sid + ju) / (float)spp;
    const float w = rtw_vdc(sid) + rot_v;
    v = w - floorf(w);
}

__device__ __forceinline__ void rtw_stratify_lens_uv(
        float lu0, float rot_u, float rot_v, int sid, int spp, float& u,
        float& v) {
    const float a = ((float)sid + lu0) / (float)spp + rot_u;
    const float w = rtw_vdc(sid) + rot_v;
    u = a - floorf(a);
    v = w - floorf(w);
}

// ---- ops/planar.py ----------------------------------------------------

// bounce_draws: scatter vector + reflect uniform at bounce `depth`.
__device__ __forceinline__ void rtw_bounce_draws(
        uint32_t k0, uint32_t k1, int depth, bool unit_sample, float& x,
        float& y, float& z, float& ru) {
    const uint32_t tag = RTW_TAG_BOUNCE + (uint32_t)depth;
    float u0, u1, u2;
    rtw_draw2(k0, k1, tag, 0u, u0, u1);
    rtw_draw2(k0, k1, tag, 1u, u2, ru);
    rtw_unit_from_uv(u0, u1, x, y, z);
    if (!unit_sample) {
        const float r = powf(u2, RTW_THIRD);
        x = x * r; y = y * r; z = z * r;
    }
}

// strat0_scatter_planes: the stratified first-bounce scatter vector.
__device__ __forceinline__ void rtw_strat0_scatter(
        uint32_t k0, uint32_t k1, int pid, int sid, uint32_t b0,
        uint32_t b1, int spp, bool unit_sample, float& x, float& y,
        float& z) {
    uint32_t pk0, pk1, zk0, zk1;
    rtw_fold_in(b0, b1, (uint32_t)pid, pk0, pk1);
    rtw_fold_in(pk0, pk1, 0u, zk0, zk1);
    float ru_, rv_, u0, unused, su, sv;
    rtw_draw2(zk0, zk1, RTW_TAG_BOUNCE, 3u, ru_, rv_);
    rtw_draw2(k0, k1, RTW_TAG_BOUNCE, 0u, u0, unused);
    rtw_stratify_lens_uv(u0, ru_, rv_, sid, spp, su, sv);
    rtw_unit_from_uv(su, sv, x, y, z);
    if (!unit_sample) {
        float u2;
        rtw_draw2(k0, k1, RTW_TAG_BOUNCE, 1u, u2, unused);
        const float r = powf(u2, RTW_THIRD);
        x = x * r; y = y * r; z = z * r;
    }
}

struct RtwShade {
    float sdx, sdy, sdz;       // scattered direction
    bool valid;                // false: metal absorb
    float sky_r, sky_g, sky_b; // unattenuated sky radiance of a miss
};

// bounce_planar: material scatter + sky. (rvx, rvy, rvz, ru) are the
// bounce draws (after the optional bounce-0 substitution).
__device__ __forceinline__ RtwShade rtw_shade(
        float dx, float dy, float dz, float nx, float ny, float nz, int mt,
        float fz, float io, float rvx, float rvy, float rvz, float ru,
        bool phys_refract, float sky_bias) {
    RtwShade o;
    // normalize3 (FLT_MIN guard)
    const float l = sqrtf(dx * dx + dy * dy + dz * dz);
    const bool good = l > RTW_FLT_MIN;
    const float inv = 1.0f / (good ? l : 1.0f);
    const float ux = good ? dx * inv : dx;
    const float uy = good ? dy * inv : dy;
    const float uz = good ? dz * inv : dz;
    // lambert
    const float ldx = nx + rvx, ldy = ny + rvy, ldz = nz + rvz;
    // metal
    const float du = ux * nx + uy * ny + uz * nz;
    const float rfx = ux - 2.0f * du * nx;
    const float rfy = uy - 2.0f * du * ny;
    const float rfz = uz - 2.0f * du * nz;
    const float mdx = rfx + rvx * fz;
    const float mdy = rfy + rvy * fz;
    const float mdz = rfz + rvz * fz;
    const bool metal_ok = (mdx * nx + mdy * ny + mdz * nz) > 0.0f;
    // dielectric
    const bool entering = du <= 0.0f;
    const float sgn = entering ? 1.0f : -1.0f;
    const float owx = nx * sgn, owy = ny * sgn, owz = nz * sgn;
    const float ri = entering ? 1.0f / io : io;
    const float cosab = fabsf(du);
    const float cos_i = owx * ux + owy * uy + owz * uz;
    const float kk = 1.0f - ri * ri * (1.0f - cos_i * cos_i);
    const bool tir = kk < 0.0f;
    const float sq = sqrtf(rtw_max(kk, 0.0f));
    float tx, ty, tz;
    if (phys_refract) {
        tx = ri * ux - (ri * cos_i + sq) * owx;
        ty = ri * uy - (ri * cos_i + sq) * owy;
        tz = ri * uz - (ri * cos_i + sq) * owz;
    } else {
        // math.hxx:304-308: dot*eta broadcast-added per component.
        tx = ux * ri - (owx * sq + cos_i * ri);
        ty = uy * ri - (owy * sq + cos_i * ri);
        tz = uz * ri - (owz * sq + cos_i * ri);
    }
    if (tir) { tx = 0.0f; ty = 0.0f; tz = 0.0f; }
    float r0 = (1.0f - ri) / (1.0f + ri);
    r0 = r0 * r0;
    const float c1 = 1.0f - cosab;
    const float c2 = c1 * c1;
    const float schlick = r0 + (1.0f - r0) * (c1 * (c2 * c2));
    const float prob = tir ? 1.0f : schlick;
    const bool refl = ru < prob;
    const float gdx = refl ? rfx : tx;
    const float gdy = refl ? rfy : ty;
    const float gdz = refl ? rfz : tz;

    const bool is_metal = mt == RTW_METAL;
    const bool is_diel = mt == RTW_DIELECTRIC;
    o.sdx = is_diel ? gdx : (is_metal ? mdx : ldx);
    o.sdy = is_diel ? gdy : (is_metal ? mdy : ldy);
    o.sdz = is_diel ? gdz : (is_metal ? mdz : ldz);
    o.valid = metal_ok || !is_metal;

    // sky: white*(1-t) + blue*t, unclamped.
    const float tsky = 0.5f * uy + sky_bias;
    o.sky_r = 1.0f * (1.0f - tsky) + 0.5f * tsky;
    o.sky_g = 1.0f * (1.0f - tsky) + 0.7f * tsky;
    o.sky_b = 1.0f * (1.0f - tsky) + 1.0f * tsky;
    return o;
}

// Camera modes (ops/cuda_fused.CAMERA_MODES).
#define RTW_CAM_CUDA 0
#define RTW_CAM_PINHOLE 1
#define RTW_CAM_CPU 2
#define RTW_CAM_THINLENS 3

// camera_rays for one (pid, sid): origin, direction and the ray key.
// cam is the (19,) vector of ops/cuda_fused.pack_camera: origin 0..2,
// lower_left 3..5, horizontal 6..8, vertical 9..11, basis_u 12..14,
// basis_v 15..17, lens_radius 18.
__device__ __forceinline__ void rtw_camera_ray(
        const float* __restrict__ cam, uint32_t b0, uint32_t b1, int pid,
        int sid, int width, int height, int spp, int camera_mode,
        bool stratified, float* o, float* d, uint32_t& nk0, uint32_t& nk1) {
    uint32_t pk0, pk1, zk0 = 0u, zk1 = 0u;
    rtw_fold_in(b0, b1, (uint32_t)pid, pk0, pk1);
    rtw_fold_in(pk0, pk1, (uint32_t)sid, nk0, nk1);
    float jux, juy;
    rtw_draw2(nk0, nk1, RTW_TAG_JITTER, 0u, jux, juy);
    if (stratified) {
        // Per-PIXEL rotation from the (pid, sid=0) key.
        rtw_fold_in(pk0, pk1, 0u, zk0, zk1);
        float unused, rot_v;
        rtw_draw2(zk0, zk1, RTW_TAG_JITTER, 0u, unused, rot_v);
        rtw_stratify_uv(jux, rot_v, sid, spp, jux, juy);
    }
    const int yp = rtw_floordiv(pid, width);
    const int xp = pid - yp * width;
    const float u = ((float)xp + jux) / (float)width;
    const float v = ((float)yp + juy) / (float)height;
    const float og0 = cam[0], og1 = cam[1], og2 = cam[2];
    const float fx = cam[3] + cam[6] * u + cam[9] * (1.0f - v);
    const float fy = cam[4] + cam[7] * u + cam[10] * (1.0f - v);
    const float fz = cam[5] + cam[8] * u + cam[11] * (1.0f - v);
    const float lens_r = cam[18];
    if (camera_mode == RTW_CAM_CUDA) {
        o[0] = og0; o[1] = og1; o[2] = og2;
        d[0] = fx; d[1] = fy; d[2] = fz;  // quirk Q11: no -origin
    } else if (camera_mode == RTW_CAM_PINHOLE) {
        o[0] = og0; o[1] = og1; o[2] = og2;
        d[0] = fx - og0; d[1] = fy - og1; d[2] = fz - og2;
    } else if (camera_mode == RTW_CAM_CPU) {
        // camera.hxx:51-56 (quirks Q2 + Q11).
        float lu0, lu1, lu2, unused, sx, sy, sz;
        rtw_draw2(nk0, nk1, RTW_TAG_LENS, 0u, lu0, lu1);
        rtw_draw2(nk0, nk1, RTW_TAG_LENS, 1u, lu2, unused);
        rtw_unit_from_uv(lu0, lu1, sx, sy, sz);
        const float sr = powf(lu2, RTW_THIRD);
        const float rdx = sx * sr, rdy = sy * sr;
        const float offx = u * rdx * lens_r;
        const float offy = v * rdy * lens_r;
        o[0] = og0 + offx; o[1] = og1 + offy; o[2] = og2;
        d[0] = fx - offx; d[1] = fy - offy; d[2] = fz;
    } else {  // thinlens
        float lu0, lu1;
        rtw_draw2(nk0, nk1, RTW_TAG_LENS, 0u, lu0, lu1);
        if (stratified) {
            float lr_u, lr_v;
            rtw_draw2(zk0, zk1, RTW_TAG_LENS, 2u, lr_u, lr_v);
            rtw_stratify_lens_uv(lu0, lr_u, lr_v, sid, spp, lu0, lu1);
        }
        const float theta = RTW_TWO_PI * lu0;
        const float rd = sqrtf(lu1);
        const float r0 = cosf(theta) * rd * lens_r;
        const float r1 = sinf(theta) * rd * lens_r;
        const float offx = cam[12] * r0 + cam[15] * r1;
        const float offy = cam[13] * r0 + cam[16] * r1;
        const float offz = cam[14] * r0 + cam[17] * r1;
        o[0] = og0 + offx; o[1] = og1 + offy; o[2] = og2 + offz;
        d[0] = fx - og0 - offx;
        d[1] = fy - og1 - offy;
        d[2] = fz - og2 - offz;
    }
}
