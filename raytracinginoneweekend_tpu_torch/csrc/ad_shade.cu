// ad_shade: the regenerative AD pool's shade step and regen, forward and
// adjoint.
//
// Replaces no TPU kernel: the JAX package leaves this step of its
// ops/wavefront_ad.py to XLA, which fuses it. Plain PyTorch versions:
// ops/cuda_ad_shade.ad_shade_reference (the shade's eager chain) followed
// by regen_reference (the regen's); the forward is held against the pair
// lane by lane, the adjoint against autograd through it.
//
// One pool iteration downstream of the closest hit, one thread a lane over
// the (R, 128) planes:
//   * ad_shade_kernel: the winner's ten parameters from the (S, 10) table
//     by the sphere index; the hit point and normal (t and r guarded off
//     a miss, r = 0 guarded); the bounce draws at the lane's depth, with
//     the bounce-0 stratified vector read from the ray table at the lane's
//     own ray; the scatter of integrate_planar.scatter_planar_ad (ior = 0
//     and the root guarded); the sky; the throughput and Russian roulette;
//     the deposit's three values and each lane's ledger cell; then the
//     regen: a lane left idle takes its next strided ray from the ray
//     tables (or, its next ray in the last wave's pad, parks), and the
//     kernel writes the whole next lane state;
//   * ad_shade_grad_kernel: the same forward values recomputed in
//     registers from the same inputs, the gradients of the nine planes a
//     lane's acquire overwrote set to zero, then the reverse sweep: the
//     gradients of the nine float state planes and of t, and one row of
//     the table's gradient a lane (summed by sphere outside, with
//     index_add_).
// Autograd's rules are the contract of the adjoint: a select passes a
// gradient to the branch it took and nothing to the other (an `if`, so
// whatever the other branch holds cannot leak); Russian roulette's q is a
// constant; the material type, draws, depth, keys, masks and the ray
// tables carry none.
//
// What bounds it: latency. At the pool's 32768 lanes a thread runs two or
// three threefry blocks of 20 rounds and the shade in one serial chain;
// the forward moves ~120 bytes a lane and the adjoint ~180, 4-6 MB a
// launch, about 1-2 us of the card's bandwidth. What the kernels remove is
// the host's cost: one launch forward and one backward in place of the
// shade's and the regen's eager chains and autograd nodes. The design:
// plane-per-quantity arrays, so a warp's accesses are coalesced; all reads
// of the lane's state before any write; the table row read by index (a few
// KB, it stays in cache); an acquiring lane's ray read from the tables by
// its ray id, which strided ownership makes consecutive across a warp.
//
// Arithmetic: the plain forward's operations in its order, under the
// package's flags (-fmad=false, no fast math), so the forward's integer
// and boolean planes are the plain version's and its floats differ only
// where sinf/cosf/powf of the two builds do.

#include "rtw_common.cuh"

#define AS_THREADS 128
#define AS_TABLE_COLS 10
#define AS_N_IN 20    // ox oy oz dx dy dz ax ay az t | sb hit active depth
                      // wcur k0 k1 nxtw | the ray tables: floats (6 or 9,
                      // w_cells: origin, direction[, stratified bounce-0
                      // vector]) and key words (2, w_cells)
#define AS_N_OUT 4    // floats (12, L): ox..az, the deposit's r g b | ints
                      // (5, L): nxtw wcur depth k0 k1 | bools (2, L):
                      // active, busy | cell (L,) int64
#define AS_N_GIN 10   // gradients of ox..az | of the deposit (3, L)
#define AS_N_GOUT 2   // gradients (10, L): of ox..az, of t | table rows
                      // (L, 10)

// Mirrors ops/cuda_ad_shade._Config (ctypes), field for field. The pool
// holds n_waves waves of n_lanes rays (w_cells = n_waves * n_lanes, the
// ledger's wave cells and the ray tables' length); n_rays of them are
// real, the rest of the last wave is pad.
struct AdShadeConfig {
    int n_lanes, n_spheres, w_cells, max_depth, unit_sample, phys_refract,
        rr_terminate, rr_start, stratified, n_rays, n_waves;
    float sky_bias, rr_qmin, rr_scale;
};

struct AsIn { const void* p[AS_N_IN]; };
struct AsOut { void* p[AS_N_OUT]; };
struct AsGin { const void* p[AS_N_GIN]; };
struct AsGout { void* p[AS_N_GOUT]; };

// One lane's inputs.
struct AsLane {
    float ox, oy, oz, dx, dy, dz, ax, ay, az, t;
    float cx, cy, cz, r, alr, alg, alb, fz, io;
    int dep, mt, s, wcur, nxtw;
    bool hit, active;
    uint32_t k0, k1;
};

// The forward's values that the adjoint reads.
struct AsFwd {
    float t_safe, px, py, pz, inv_r, ex, ey, ez, nx, ny, nz;
    float rvx, rvy, rvz;
    float l, inv, ux, uy, uz, du, sgn, owx, owy, owz, rec, ri, cos_i,
        bterm, sq, big_a;
    float ndx, ndy, ndz, sr, sg, sb, ax1, ay1, az1, boost;
    bool r_ok, good, entering, pos, tir, refl, is_metal, is_diel, miss,
        keep0, keep;
};

__device__ __forceinline__ void as_load(const AdShadeConfig& c,
                                        const AsIn& in,
                                        const float* __restrict__ table,
                                        int i, AsLane& L) {
#define LDF(k) (((const float*)in.p[k])[i])
#define LDI(k) (((const int*)in.p[k])[i])
    L.ox = LDF(0); L.oy = LDF(1); L.oz = LDF(2);
    L.dx = LDF(3); L.dy = LDF(4); L.dz = LDF(5);
    L.ax = LDF(6); L.ay = LDF(7); L.az = LDF(8);
    L.t = LDF(9);
    // The winner's parameters, by index (clamped: an index outside the
    // table must not become a wild read).
    L.s = min(max(LDI(10), 0), c.n_spheres - 1);
    L.hit = LDI(11) > 0;
    L.active = ((const bool*)in.p[12])[i];
    L.dep = LDI(13);
    L.wcur = LDI(14);
    L.k0 = ((const uint32_t*)in.p[15])[i];
    L.k1 = ((const uint32_t*)in.p[16])[i];
    L.nxtw = LDI(17);
#undef LDF
#undef LDI
    const float* row = table + (size_t)L.s * AS_TABLE_COLS;
    L.cx = row[0]; L.cy = row[1]; L.cz = row[2]; L.r = row[3];
    L.mt = (int)row[4];
    L.alr = row[5]; L.alg = row[6]; L.alb = row[7];
    L.fz = row[8]; L.io = row[9];
}

// A lane's ray id in the ray tables, clamped into the real rays as
// regen_reference clamps its gather.
__device__ __forceinline__ size_t as_ray_at(const AdShadeConfig& c,
                                            long long ray) {
    return (size_t)(ray < 0 ? 0 : (ray >= c.n_rays ? c.n_rays - 1 : ray));
}

// regen_reference's acquire: the lane is idle after the shade, has waves
// left, and its next ray is not in the last wave's pad.
__device__ __forceinline__ bool as_acquires(const AdShadeConfig& c,
                                            const AsLane& L, bool keep,
                                            int i) {
    return !keep && L.nxtw < c.n_waves
           && (long long)L.nxtw * c.n_lanes + i < c.n_rays;
}

// The forward: ad_shade_reference's operations in its order.
__device__ __forceinline__ void as_forward(const AdShadeConfig& c,
                                           const AsIn& in, int i,
                                           const AsLane& L, AsFwd& f) {
    // integrate_planar.shade_geometry_planar
    f.t_safe = L.hit ? L.t : 1.0f;
    f.px = L.ox + f.t_safe * L.dx;
    f.py = L.oy + f.t_safe * L.dy;
    f.pz = L.oz + f.t_safe * L.dz;
    const float r_safe = L.hit ? L.r : 1.0f;
    f.r_ok = r_safe != 0.0f;
    f.inv_r = 1.0f / (f.r_ok ? r_safe : 1.0f);
    f.ex = f.px - L.cx;
    f.ey = f.py - L.cy;
    f.ez = f.pz - L.cz;
    f.nx = f.ex * f.inv_r;
    f.ny = f.ey * f.inv_r;
    f.nz = f.ez * f.inv_r;

    // planar.bounce_draws at the lane's depth; the stratified bounce-0
    // vector substituted
    float ru;
    rtw_bounce_draws(L.k0, L.k1, L.dep, c.unit_sample != 0, f.rvx, f.rvy,
                     f.rvz, ru);
    if (c.stratified && L.dep == 0) {
        // a lane at depth 0 traces the ray it acquired, wcur * L + lane
        const float* rays = (const float*)in.p[18];
        const size_t at = as_ray_at(c, (long long)L.wcur * c.n_lanes + i);
        f.rvx = rays[6 * (size_t)c.w_cells + at];
        f.rvy = rays[7 * (size_t)c.w_cells + at];
        f.rvz = rays[8 * (size_t)c.w_cells + at];
    }

    // integrate_planar.scatter_planar_ad
    f.l = sqrtf(L.dx * L.dx + L.dy * L.dy + L.dz * L.dz);
    f.good = f.l > RTW_FLT_MIN;
    f.inv = 1.0f / (f.good ? f.l : 1.0f);
    f.ux = f.good ? L.dx * f.inv : L.dx;
    f.uy = f.good ? L.dy * f.inv : L.dy;
    f.uz = f.good ? L.dz * f.inv : L.dz;
    // lambert
    const float ldx = f.nx + f.rvx, ldy = f.ny + f.rvy, ldz = f.nz + f.rvz;
    // metal
    f.du = f.ux * f.nx + f.uy * f.ny + f.uz * f.nz;
    const float rfx = f.ux - 2.0f * f.du * f.nx;
    const float rfy = f.uy - 2.0f * f.du * f.ny;
    const float rfz = f.uz - 2.0f * f.du * f.nz;
    const float mdx = rfx + f.rvx * L.fz;
    const float mdy = rfy + f.rvy * L.fz;
    const float mdz = rfz + f.rvz * L.fz;
    const bool metal_ok = (mdx * f.nx + mdy * f.ny + mdz * f.nz) > 0.0f;
    // dielectric, the root and 1 / ior guarded
    f.entering = f.du <= 0.0f;
    f.sgn = f.entering ? 1.0f : -1.0f;
    f.owx = f.nx * f.sgn;
    f.owy = f.ny * f.sgn;
    f.owz = f.nz * f.sgn;
    f.rec = 1.0f / ((L.io != 0.0f) ? L.io : 1.0f);
    f.ri = f.entering ? f.rec : L.io;
    const float cosab = fabsf(f.du);
    f.cos_i = f.owx * f.ux + f.owy * f.uy + f.owz * f.uz;
    f.bterm = 1.0f - f.cos_i * f.cos_i;
    const float kk = 1.0f - f.ri * f.ri * f.bterm;
    f.pos = kk > 0.0f;
    f.sq = f.pos ? sqrtf(kk) : 0.0f;
    f.tir = kk < 0.0f;
    float tx, ty, tz;
    f.big_a = 0.0f;
    if (c.phys_refract) {
        f.big_a = f.ri * f.cos_i + f.sq;
        tx = f.ri * f.ux - f.big_a * f.owx;
        ty = f.ri * f.uy - f.big_a * f.owy;
        tz = f.ri * f.uz - f.big_a * f.owz;
    } else {
        // math.hxx:304-308: dot*eta broadcast-added per component.
        tx = f.ux * f.ri - (f.owx * f.sq + f.cos_i * f.ri);
        ty = f.uy * f.ri - (f.owy * f.sq + f.cos_i * f.ri);
        tz = f.uz * f.ri - (f.owz * f.sq + f.cos_i * f.ri);
    }
    if (f.tir) { tx = 0.0f; ty = 0.0f; tz = 0.0f; }
    float r0 = (1.0f - f.ri) / (1.0f + f.ri);
    r0 = r0 * r0;
    const float c1 = 1.0f - cosab;
    const float c2 = c1 * c1;
    const float schlick = r0 + (1.0f - r0) * (c1 * (c2 * c2));
    const float prob = f.tir ? 1.0f : schlick;
    f.refl = ru < prob;
    const float gdx = f.refl ? rfx : tx;
    const float gdy = f.refl ? rfy : ty;
    const float gdz = f.refl ? rfz : tz;
    f.is_metal = L.mt == RTW_METAL;
    f.is_diel = L.mt == RTW_DIELECTRIC;
    f.ndx = f.is_diel ? gdx : (f.is_metal ? mdx : ldx);
    f.ndy = f.is_diel ? gdy : (f.is_metal ? mdy : ldy);
    f.ndz = f.is_diel ? gdz : (f.is_metal ? mdz : ldz);
    const bool valid = metal_ok || !f.is_metal;

    f.miss = L.active && !L.hit;
    f.keep0 = L.active && L.hit && valid && (L.dep + 1 < c.max_depth);

    // sky: white*(1-t) + blue*t, unclamped.
    const float tsky = 0.5f * f.uy + c.sky_bias;
    f.sr = 1.0f * (1.0f - tsky) + 0.5f * tsky;
    f.sg = 1.0f * (1.0f - tsky) + 0.7f * tsky;
    f.sb = 1.0f * (1.0f - tsky) + 1.0f * tsky;

    // throughput, then Russian roulette (rng.rr_terminate_update):
    // survivors boost 1/q, casualties die like absorb.
    f.ax1 = f.keep0 ? L.ax * L.alr : L.ax;
    f.ay1 = f.keep0 ? L.ay * L.alg : L.ay;
    f.az1 = f.keep0 ? L.az * L.alb : L.az;
    f.boost = 1.0f;
    f.keep = f.keep0;
    if (c.rr_terminate) {
        float u_rr, unused;
        rtw_draw2(L.k0, L.k1, RTW_TAG_BOUNCE + (uint32_t)L.dep, 2u, u_rr,
                  unused);
        const float q = rtw_min(
            rtw_max(c.rr_scale * rtw_max(f.ax1, rtw_max(f.ay1, f.az1)),
                    c.rr_qmin), 1.0f);
        const bool consider = f.keep0 && (L.dep + 1 >= c.rr_start);
        const bool surv = consider && (u_rr < q);
        f.boost = surv ? 1.0f / q : 1.0f;
        f.keep = f.keep0 && (!consider || surv);
    }
}

__global__ void __launch_bounds__(AS_THREADS)
ad_shade_kernel(const AdShadeConfig c, const AsIn in, const AsOut out,
                const float* __restrict__ table) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= c.n_lanes) return;
    AsLane L;
    as_load(c, in, table, i, L);
    AsFwd f;
    as_forward(c, in, i, L, f);
    const float mf = f.miss ? 1.0f : 0.0f;
    const float cr = mf * L.ax * f.sr;
    const float cg = mf * L.ay * f.sg;
    const float cb = mf * L.az * f.sb;
    float ax = f.ax1, ay = f.ay1, az = f.az1;
    if (c.rr_terminate) {
        ax = ax * f.boost; ay = ay * f.boost; az = az * f.boost;
    }
    float o[9] = {f.keep0 ? f.px : L.ox, f.keep0 ? f.py : L.oy,
                  f.keep0 ? f.pz : L.oz, f.keep0 ? f.ndx : L.dx,
                  f.keep0 ? f.ndy : L.dy, f.keep0 ? f.ndz : L.dz,
                  ax, ay, az};
    int nxtw = L.nxtw, wcur = L.wcur, dep = f.keep ? L.dep + 1 : L.dep;
    uint32_t k0 = L.k0, k1 = L.k1;

    // regen_reference: a lane left idle takes its next strided ray,
    // nxtw * L + lane, from the ray tables; one whose next ray is in the
    // last wave's pad is out of work for good and parks nxtw at n_waves.
    const long long ray = (long long)L.nxtw * c.n_lanes + i;
    const bool can = L.nxtw < c.n_waves;
    const bool acquire = as_acquires(c, L, f.keep, i);
    if (acquire) {
        const float* rays = (const float*)in.p[18];
        const uint32_t* keys = (const uint32_t*)in.p[19];
        const size_t at = (size_t)ray, wc = (size_t)c.w_cells;
#pragma unroll
        for (int k = 0; k < 6; ++k) o[k] = rays[k * wc + at];
        o[6] = 1.0f; o[7] = 1.0f; o[8] = 1.0f;
        wcur = L.nxtw;
        nxtw = L.nxtw + 1;
        dep = 0;
        k0 = keys[at];
        k1 = keys[wc + at];
    } else if (!f.keep && can) {
        nxtw = c.n_waves;
    }

    const size_t n = (size_t)c.n_lanes;
    float* fo = (float*)out.p[0];
#pragma unroll
    for (int k = 0; k < 9; ++k) fo[k * n + i] = o[k];
    fo[9 * n + i] = cr;
    fo[10 * n + i] = cg;
    fo[11 * n + i] = cb;
    int* io = (int*)out.p[1];
    io[i] = nxtw;
    io[n + i] = wcur;
    io[2 * n + i] = dep;
    io[3 * n + i] = (int)k0;
    io[4 * n + i] = (int)k1;
    bool* bo = (bool*)out.p[2];
    bo[i] = f.keep || acquire;
    // what the pool's drain test reads: the lane was tracing, or had
    // waves left, before the regen
    bo[n + i] = f.keep || can;
    ((long long*)out.p[3])[i] =
        f.miss ? (long long)L.wcur * c.n_lanes + i : (long long)c.w_cells + i;
}

__global__ void __launch_bounds__(AS_THREADS)
ad_shade_grad_kernel(const AdShadeConfig c, const AsIn in, const AsGin gin,
                     const AsGout gout, const float* __restrict__ table) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= c.n_lanes) return;
    AsLane L;
    as_load(c, in, table, i, L);
#define LDG(k) (((const float*)gin.p[k])[i])
    float gox2 = LDG(0), goy2 = LDG(1), goz2 = LDG(2);
    float gdx2 = LDG(3), gdy2 = LDG(4), gdz2 = LDG(5);
    float gax1 = LDG(6), gay1 = LDG(7), gaz1 = LDG(8);
#undef LDG
    const float* gdep = (const float*)gin.p[9];
    const float gcr = gdep[i], gcg = gdep[c.n_lanes + i],
                gcb = gdep[2 * c.n_lanes + i];
    AsFwd f;
    as_forward(c, in, i, L, f);

    // regen's selects: an acquiring lane's nine planes were overwritten by
    // its new ray, so the shade's outputs there get no gradient.
    if (as_acquires(c, L, f.keep, i)) {
        gox2 = 0.0f; goy2 = 0.0f; goz2 = 0.0f;
        gdx2 = 0.0f; gdy2 = 0.0f; gdz2 = 0.0f;
        gax1 = 0.0f; gay1 = 0.0f; gaz1 = 0.0f;
    }

    // Russian roulette: the boost is a constant factor.
    if (c.rr_terminate) {
        gax1 = gax1 * f.boost; gay1 = gay1 * f.boost; gaz1 = gaz1 * f.boost;
    }
    float gox = gox2, goy = goy2, goz = goz2;
    float gdx = gdx2, gdy = gdy2, gdz = gdz2;
    float gax = gax1, gay = gay1, gaz = gaz1, gt = 0.0f;
    float gcx = 0.0f, gcy = 0.0f, gcz = 0.0f, gr = 0.0f;
    float galr = 0.0f, galg = 0.0f, galb = 0.0f, gfz = 0.0f, gio = 0.0f;
    float gux = 0.0f, guy = 0.0f, guz = 0.0f;
    if (f.keep0) {
        // throughput: a' = a * albedo
        gax = gax1 * L.alr; gay = gay1 * L.alg; gaz = gaz1 * L.alb;
        galr = gax1 * L.ax; galg = gay1 * L.ay; galb = gaz1 * L.az;
        // the scattered direction, by material
        float gnx = 0.0f, gny = 0.0f, gnz = 0.0f;
        bool reflect = false;
        if (f.is_diel) {
            if (f.refl) {
                reflect = true;
            } else if (!f.tir) {
                float gri, gcos, gsq, gowx, gowy, gowz;
                if (c.phys_refract) {
                    // t = ri * u - (ri * cos_i + sq) * ow
                    const float gba =
                        -(gdx2 * f.owx + gdy2 * f.owy + gdz2 * f.owz);
                    gri = (gdx2 * f.ux + gdy2 * f.uy + gdz2 * f.uz)
                          + gba * f.cos_i;
                    gowx = -gdx2 * f.big_a;
                    gowy = -gdy2 * f.big_a;
                    gowz = -gdz2 * f.big_a;
                    gcos = gba * f.ri;
                    gsq = gba;
                } else {
                    // t = u * ri - (ow * sq + cos_i * ri)
                    const float gs = -(gdx2 + gdy2 + gdz2);
                    gri = (gdx2 * f.ux + gdy2 * f.uy + gdz2 * f.uz)
                          + gs * f.cos_i;
                    gowx = -gdx2 * f.sq;
                    gowy = -gdy2 * f.sq;
                    gowz = -gdz2 * f.sq;
                    gcos = gs * f.ri;
                    gsq = -(gdx2 * f.owx + gdy2 * f.owy + gdz2 * f.owz);
                }
                gux = gdx2 * f.ri; guy = gdy2 * f.ri; guz = gdz2 * f.ri;
                // sq = pos ? sqrt(kk) : 0; kk = 1 - ri*ri*(1 - cos_i^2)
                if (f.pos) {
                    const float gkk = gsq / (2.0f * f.sq);
                    const float grr = -gkk * f.bterm;
                    const float gb = -gkk * (f.ri * f.ri);
                    gri = gri + (grr * f.ri + grr * f.ri);
                    gcos = gcos + (-gb * f.cos_i + -gb * f.cos_i);
                }
                // cos_i = ow . u
                gowx = gowx + gcos * f.ux;
                gowy = gowy + gcos * f.uy;
                gowz = gowz + gcos * f.uz;
                gux = gux + gcos * f.owx;
                guy = guy + gcos * f.owy;
                guz = guz + gcos * f.owz;
                // ri = entering ? 1 / io : io (io = 0 guarded)
                if (!f.entering) gio = gri;
                else if (L.io != 0.0f) gio = -gri * (f.rec * f.rec);
                // ow = n * sgn
                gnx = gowx * f.sgn; gny = gowy * f.sgn; gnz = gowz * f.sgn;
            }
        } else if (f.is_metal) {
            // d = rf + rv * fz
            reflect = true;
            gfz = gdx2 * f.rvx + gdy2 * f.rvy + gdz2 * f.rvz;
        } else {
            // lambert: d = n + rv
            gnx = gdx2; gny = gdy2; gnz = gdz2;
        }
        if (reflect) {
            // rf = u - (2 du) n;  du = u . n
            const float gdu = 2.0f * -(gdx2 * f.nx + gdy2 * f.ny
                                       + gdz2 * f.nz);
            const float two_du = 2.0f * f.du;
            gux = gdx2 + gdu * f.nx;
            guy = gdy2 + gdu * f.ny;
            guz = gdz2 + gdu * f.nz;
            gnx = -gdx2 * two_du + gdu * f.ux;
            gny = -gdy2 * two_du + gdu * f.uy;
            gnz = -gdz2 * two_du + gdu * f.uz;
        }
        // hit point and normal: n = (o + t_safe * d - c) * inv_r
        const float gex = gnx * f.inv_r, gey = gny * f.inv_r,
                    gez = gnz * f.inv_r;
        if (f.r_ok)
            gr = -(gnx * f.ex + gny * f.ey + gnz * f.ez)
                 * (f.inv_r * f.inv_r);
        gcx = -gex; gcy = -gey; gcz = -gez;
        const float gpx = gox2 + gex, gpy = goy2 + gey, gpz = goz2 + gez;
        gox = gpx; goy = gpy; goz = gpz;
        gt = gpx * L.dx + gpy * L.dy + gpz * L.dz;
        gdx = gpx * f.t_safe; gdy = gpy * f.t_safe; gdz = gpz * f.t_safe;
    } else if (f.miss) {
        // the deposit: a * sky, sky = white * (1 - tsky) + blue * tsky
        gax = gax + gcr * f.sr;
        gay = gay + gcg * f.sg;
        gaz = gaz + gcb * f.sb;
        const float gsr = gcr * L.ax, gsg = gcg * L.ay, gsb = gcb * L.az;
        const float gtsky = (-gsr + gsr * 0.5f) + (-gsg + gsg * 0.7f)
                            + (-gsb + gsb * 1.0f);
        guy = gtsky * 0.5f;
    }
    // u = |d| > FLT_MIN ? d / |d| : d
    if (f.good) {
        const float ginv = gux * L.dx + guy * L.dy + guz * L.dz;
        const float gl2 = -ginv * (f.inv * f.inv) / (2.0f * f.l);
        gdx = gdx + gux * f.inv + (gl2 * L.dx + gl2 * L.dx);
        gdy = gdy + guy * f.inv + (gl2 * L.dy + gl2 * L.dy);
        gdz = gdz + guz * f.inv + (gl2 * L.dz + gl2 * L.dz);
    } else {
        gdx = gdx + gux; gdy = gdy + guy; gdz = gdz + guz;
    }
#define STG(k, v) (((float*)gout.p[0])[(k) * (size_t)c.n_lanes + i] = (v))
    STG(0, gox); STG(1, goy); STG(2, goz);
    STG(3, gdx); STG(4, gdy); STG(5, gdz);
    STG(6, gax); STG(7, gay); STG(8, gaz);
    STG(9, gt);
#undef STG
    float* row = (float*)gout.p[1] + (size_t)i * AS_TABLE_COLS;
    row[0] = gcx; row[1] = gcy; row[2] = gcz; row[3] = gr; row[4] = 0.0f;
    row[5] = galr; row[6] = galg; row[7] = galb; row[8] = gfz; row[9] = gio;
}

// ---- C entries ---------------------------------------------------------

static bool as_config_ok(const AdShadeConfig& c, const void* const* in) {
    for (int k = 0; k < AS_N_IN; ++k)
        if (!in[k]) return false;
    return c.n_lanes >= 1 && c.n_spheres >= 1 && c.n_waves >= 1
           && (long long)c.n_waves * c.n_lanes == c.w_cells
           && c.n_rays >= 1 && c.n_rays <= c.w_cells;
}

// C entries. `cfg`, `in`, `out`, `gin` and `gout` are HOST pointers: the
// config struct and arrays of device pointers (AS_N_IN, AS_N_OUT,
// AS_N_GIN, AS_N_GOUT of them, in the orders above). `table` is the
// (S, 10) float32 table on the device. Launches on `stream`, does not
// synchronise, returns the launch's error or cudaGetLastError()
// (cudaErrorInvalidValue for a configuration the kernels do not take).
extern "C" int rtw_ad_shade(const void* cfg_p, const void* const* in_p,
                            void* const* out_p, const void* table,
                            void* stream) {
    const AdShadeConfig c = *(const AdShadeConfig*)cfg_p;
    if (!as_config_ok(c, in_p)) return (int)cudaErrorInvalidValue;
    AsIn in = {};
    AsOut out = {};
    for (int k = 0; k < AS_N_IN; ++k) in.p[k] = in_p[k];
    for (int k = 0; k < AS_N_OUT; ++k) out.p[k] = out_p[k];
    const int blocks = (c.n_lanes + AS_THREADS - 1) / AS_THREADS;
    ad_shade_kernel<<<blocks, AS_THREADS, 0, (cudaStream_t)stream>>>(
        c, in, out, (const float*)table);
    return (int)cudaGetLastError();
}

extern "C" int rtw_ad_shade_grad(const void* cfg_p, const void* const* in_p,
                                 const void* const* gin_p,
                                 void* const* gout_p, const void* table,
                                 void* stream) {
    const AdShadeConfig c = *(const AdShadeConfig*)cfg_p;
    if (!as_config_ok(c, in_p)) return (int)cudaErrorInvalidValue;
    AsIn in = {};
    AsGin gin = {};
    AsGout gout = {};
    for (int k = 0; k < AS_N_IN; ++k) in.p[k] = in_p[k];
    for (int k = 0; k < AS_N_GIN; ++k) gin.p[k] = gin_p[k];
    for (int k = 0; k < AS_N_GOUT; ++k) gout.p[k] = gout_p[k];
    const int blocks = (c.n_lanes + AS_THREADS - 1) / AS_THREADS;
    ad_shade_grad_kernel<<<blocks, AS_THREADS, 0, (cudaStream_t)stream>>>(
        c, in, gin, gout, (const float*)table);
    return (int)cudaGetLastError();
}
