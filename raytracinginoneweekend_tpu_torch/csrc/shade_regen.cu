// shade_regen: the wavefront engine's whole per-lane tier in one pass.
//
// Replaces the Pallas TPU kernel raytracinginoneweekend_tpu/ops/
// pallas_fused.py::_kernel_shade_regen (reached through shade_regen).
// Plain PyTorch version: ops/cuda_fused.shade_regen_reference.
//
// Per lane: hit point and normal of the segment just traced, the bounce's
// threefry draws, lambert/metal/dielectric scatter and sky, the optional
// bounce-0 stratified substitution, Russian roulette, the depth cap, the
// sky deposit into the task accumulators, the move of a finished task into
// a free pending slot, the acquisition of the next task (strided or tile
// ownership), and the camera ray (four modes, iid or stratified) of a
// re-issued lane.
//
// What bounds it: bytes. A lane reads 3 + 19 + 4*n_slots words and writes
// 19 + 4*n_slots; the arithmetic (at most 9 threefry blocks and a handful
// of sinf/cosf/powf) is small beside that traffic at the card's rates.
//
// Design: one thread per lane; every plane is its own array, so the
// threads of a warp read and write neighbouring addresses. All of a
// lane's state is read into registers before anything is written, so the
// output planes may be the input planes (the engine updates in place).
// The winner's ten parameters are read straight from the (S, 10) table
// by the sphere index the closest-hit kernel wrote: the table is a few
// KB and stays in cache. (The TPU package resolves them with a one-hot
// matrix product before its kernel because per-ray gathers are slow
// there; that product has no counterpart here.) Draws for Russian
// roulette, the stratified substitution and the camera ray are computed
// only by the lanes that use them; the TPU kernel computes them on every
// lane and masks, which gives the same values.

#include "rtw_common.cuh"

#define SR_THREADS 128
#define SR_N_BASE 19
#define SR_MAX_SLOTS 4
#define SR_MAX_STATE (SR_N_BASE + 4 * SR_MAX_SLOTS)
#define SR_TABLE_COLS 10

// Mirrors ops/cuda_fused._Config (ctypes), field for field.
struct ShadeRegenConfig {
    int max_depth, unit_sample, phys_refract, width, height, spp,
        task_samples, tpp, n_tasks, n_slots, stride, camera_mode,
        rr_terminate, rr_start, stratified,
        own_bl, t_b, tiles_x, worker_base;  // tile ownership (own_bl > 0)
    float sky_bias, rr_qmin, rr_scale;
    uint32_t b0, b1;  // base-key words
};

// A task's virtual pixel -> row-major pixel id: itself under strided
// ownership; under tile ownership (own_bl > 0) the 32x32 tile de-swizzle
// of ops/cull.tile_pixel in integer arithmetic, an out-of-image virtual
// pixel giving pixel 0 (it traces like any other and drops at the
// engine's fold).
#define SR_TILE 32
__device__ __forceinline__ int sr_task_pixel(const ShadeRegenConfig& cfg,
                                             int vp) {
    if (!cfg.own_bl) return vp;
    const int vp_c = max(vp, 0);
    const int t_id = vp_c / (SR_TILE * SR_TILE);
    const int o = vp_c - t_id * (SR_TILE * SR_TILE);
    const int ty = t_id / cfg.tiles_x;
    const int tx = t_id - ty * cfg.tiles_x;
    const int oy_t = o / SR_TILE;
    const int ox_t = o - oy_t * SR_TILE;
    const int yp = ty * SR_TILE + oy_t;
    const int xp = tx * SR_TILE + ox_t;
    return (xp < cfg.width && yp < cfg.height) ? yp * cfg.width + xp : 0;
}

struct StatePtrs {
    void* p[SR_MAX_STATE];
};

__global__ void __launch_bounds__(SR_THREADS)
shade_regen_kernel(const ShadeRegenConfig cfg, const StatePtrs in,
                   const StatePtrs out, const int* __restrict__ hit_p,
                   const float* __restrict__ t_p,
                   const int* __restrict__ sb_p,
                   const float* __restrict__ table,
                   const float* __restrict__ cam, int n_lanes,
                   int n_spheres) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_lanes) return;
#define LDI(k) (((const int*)in.p[k])[i])
#define LDF(k) (((const float*)in.p[k])[i])
#define LDU(k) (((const uint32_t*)in.p[k])[i])
#define STI(k, v) (((int*)out.p[k])[i] = (v))
#define STF(k, v) (((float*)out.p[k])[i] = (v))
#define STU(k, v) (((uint32_t*)out.p[k])[i] = (v))

    // ---- read the whole lane (outputs may alias inputs) ---------------
    int nxt = LDI(0), task = LDI(1), sid = LDI(2);
    const bool active = LDI(3) > 0;
    float ox = LDF(4), oy = LDF(5), oz = LDF(6);
    float dx = LDF(7), dy = LDF(8), dz = LDF(9);
    float ax = LDF(10), ay = LDF(11), az = LDF(12);
    int dep = LDI(13);
    float acr = LDF(14), acg = LDF(15), acb = LDF(16);
    const uint32_t k0 = LDU(17), k1 = LDU(18);
    int pt[SR_MAX_SLOTS];
    float pr[SR_MAX_SLOTS], pg[SR_MAX_SLOTS], pb[SR_MAX_SLOTS];
#pragma unroll
    for (int j = 0; j < SR_MAX_SLOTS; ++j) {
        if (j < cfg.n_slots) {
            pt[j] = LDI(SR_N_BASE + 4 * j);
            pr[j] = LDF(SR_N_BASE + 4 * j + 1);
            pg[j] = LDF(SR_N_BASE + 4 * j + 2);
            pb[j] = LDF(SR_N_BASE + 4 * j + 3);
        }
    }
    const bool hit = hit_p[i] > 0;
    const float t_safe = hit ? t_p[i] : 1.0f;
    // The winner's parameters, by index (clamped: an index outside the
    // table must not become a wild read).
    const int s = min(max(sb_p[i], 0), n_spheres - 1);
    const float* __restrict__ row = table + (size_t)s * SR_TABLE_COLS;
    const float chx = row[0], chy = row[1], chz = row[2], rh = row[3];
    const int mt = (int)row[4];
    const float alr = row[5], alg = row[6], alb = row[7];
    const float fz = row[8], io = row[9];

    // ---- shade the segment just traced --------------------------------
    const float px = ox + t_safe * dx;
    const float py = oy + t_safe * dy;
    const float pz = oz + t_safe * dz;
    const float inv_r = 1.0f / ((rh != 0.0f) ? rh : 1.0f);
    const float nx = (px - chx) * inv_r;
    const float ny = (py - chy) * inv_r;
    const float nz = (pz - chz) * inv_r;

    float rvx, rvy, rvz, ru;
    rtw_bounce_draws(k0, k1, dep, cfg.unit_sample != 0, rvx, rvy, rvz, ru);
    if (cfg.stratified && dep == 0) {
        // First-bounce stratified scatter: the CURRENT ray's pixel from
        // its task (same arithmetic as the regeneration below).
        const int pid_cur =
            sr_task_pixel(cfg, rtw_floordiv(max(task, 0), cfg.tpp));
        rtw_strat0_scatter(k0, k1, pid_cur, sid, cfg.b0, cfg.b1, cfg.spp,
                           cfg.unit_sample != 0, rvx, rvy, rvz);
    }
    const RtwShade sh = rtw_shade(dx, dy, dz, nx, ny, nz, mt, fz, io, rvx,
                                  rvy, rvz, ru, cfg.phys_refract != 0,
                                  cfg.sky_bias);

    const bool miss_now = active && !hit;
    const bool scatter_now = active && hit && sh.valid;
    const bool depth_out = scatter_now && (dep + 1 >= cfg.max_depth);
    bool keep = scatter_now && !depth_out;

    // Sky accumulates into the lane's task registers.
    if (miss_now) {
        acr = acr + ax * sh.sky_r;
        acg = acg + ay * sh.sky_g;
        acb = acb + az * sh.sky_b;
    }
    if (keep) {
        ox = px; oy = py; oz = pz;
        dx = sh.sdx; dy = sh.sdy; dz = sh.sdz;
        ax = ax * alr; ay = ay * alg; az = az * alb;
    }
    if (cfg.rr_terminate) {
        // Russian roulette (ops/rng.rr_terminate_update): word 0 of
        // (TAG_BOUNCE + depth, j=2); survivors boost 1/q, casualties die
        // like absorb.
        const bool consider = keep && (dep + 1 >= cfg.rr_start);
        if (consider) {
            float u_rr, unused;
            rtw_draw2(k0, k1, RTW_TAG_BOUNCE + (uint32_t)dep, 2u, u_rr,
                      unused);
            const float q = rtw_min(
                rtw_max(cfg.rr_scale * rtw_max(ax, rtw_max(ay, az)),
                        cfg.rr_qmin), 1.0f);
            const bool surv = u_rr < q;
            const float boost = surv ? 1.0f / q : 1.0f;
            ax = ax * boost; ay = ay * boost; az = az * boost;
            keep = surv;
        }
    }
    if (keep) dep = dep + 1;

    // ---- regenerate for the NEXT iteration ----------------------------
    const bool idle = !keep;
    const bool has_task = task >= 0;
    const int pid_old = rtw_floordiv(task, cfg.tpp);
    const int run_end_old = min(
        (task - pid_old * cfg.tpp) * cfg.task_samples + cfg.task_samples,
        cfg.spp);

    // A completed task moves (task id, rgb) into the first FREE pending
    // slot; with every slot full the lane idles until the epoch flush.
    const bool task_done = idle && has_task && (sid + 1 >= run_end_old);
    bool remaining = task_done;
#pragma unroll
    for (int j = 0; j < SR_MAX_SLOTS; ++j) {
        if (j < cfg.n_slots) {
            const bool mv = remaining && (pt[j] < 0);
            if (mv) {
                pt[j] = task; pr[j] = acr; pg[j] = acg; pb[j] = acb;
            }
            remaining = remaining && !mv;
        }
    }
    const bool moved = task_done && !remaining;
    if (moved) {
        acr = 0.0f; acg = 0.0f; acb = 0.0f;
        task = -1;
    }

    // The end of the lane's own task sequence: the whole frame under
    // strided ownership, its ownership block's range under tile ownership.
    const int block_end =
        cfg.own_bl ? cfg.worker_base + (i / cfg.own_bl + 1) * cfg.t_b
                   : cfg.n_tasks;
    const bool acquire = idle && (task < 0) && (nxt < block_end);
    if (acquire) {
        task = nxt;
        nxt = nxt + cfg.stride;
    }

    const int vp = rtw_floordiv(task, cfg.tpp);
    const int run_start = (task - vp * cfg.tpp) * cfg.task_samples;
    const int pid = sr_task_pixel(cfg, vp);
    const bool next_sample =
        idle && has_task && (sid + 1 < run_end_old) && !task_done;
    sid = acquire ? run_start : (next_sample ? sid + 1 : sid);
    const bool issue = acquire || next_sample;

    uint32_t nk0 = k0, nk1 = k1;
    if (issue) {
        float o[3], d[3];
        rtw_camera_ray(cam, cfg.b0, cfg.b1, pid, sid, cfg.width, cfg.height,
                       cfg.spp, cfg.camera_mode, cfg.stratified != 0, o, d,
                       nk0, nk1);
        ox = o[0]; oy = o[1]; oz = o[2];
        dx = d[0]; dy = d[1]; dz = d[2];
        ax = 1.0f; ay = 1.0f; az = 1.0f;
        dep = 0;
    }

    STI(0, nxt); STI(1, task); STI(2, sid);
    STI(3, (keep || issue) ? 1 : 0);
    STF(4, ox); STF(5, oy); STF(6, oz);
    STF(7, dx); STF(8, dy); STF(9, dz);
    STF(10, ax); STF(11, ay); STF(12, az);
    STI(13, dep);
    STF(14, acr); STF(15, acg); STF(16, acb);
    STU(17, nk0); STU(18, nk1);
#pragma unroll
    for (int j = 0; j < SR_MAX_SLOTS; ++j) {
        if (j < cfg.n_slots) {
            STI(SR_N_BASE + 4 * j, pt[j]);
            STF(SR_N_BASE + 4 * j + 1, pr[j]);
            STF(SR_N_BASE + 4 * j + 2, pg[j]);
            STF(SR_N_BASE + 4 * j + 3, pb[j]);
        }
    }
}

// C entry. `cfg`, `state_in` and `state_out` are HOST pointers: the config
// struct and two arrays of 19 + 4*n_slots device pointers (the lane-state
// planes; out may equal in). The other pointers are device pointers.
// Launches on `stream`, does not synchronise, returns cudaGetLastError()
// (cudaErrorInvalidValue for a slot count the kernel does not take).
extern "C" int rtw_shade_regen(const void* cfg_p, const void* const* state_in,
                               void* const* state_out, const void* hit,
                               const void* t, const void* sb,
                               const void* table, const void* cam,
                               int n_lanes, int n_spheres, void* stream) {
    const ShadeRegenConfig cfg = *(const ShadeRegenConfig*)cfg_p;
    if (cfg.n_slots < 1 || cfg.n_slots > SR_MAX_SLOTS || n_spheres < 1
            || cfg.own_bl < 0 || (cfg.own_bl > 0 && cfg.tiles_x < 1))
        return (int)cudaErrorInvalidValue;
    StatePtrs in = {}, out = {};
    const int n_state = SR_N_BASE + 4 * cfg.n_slots;
    for (int k = 0; k < n_state; ++k) {
        in.p[k] = (void*)state_in[k];
        out.p[k] = state_out[k];
    }
    const int blocks = (n_lanes + SR_THREADS - 1) / SR_THREADS;
    shade_regen_kernel<<<blocks, SR_THREADS, 0, (cudaStream_t)stream>>>(
        cfg, in, out, (const int*)hit, (const float*)t, (const int*)sb,
        (const float*)table, (const float*)cam, n_lanes, n_spheres);
    return (int)cudaGetLastError();
}
