// shade_regen: the wavefront engine's per-lane tier, in three entries.
//
// Replaces the Pallas TPU kernel raytracinginoneweekend_tpu/ops/
// pallas_fused.py::_kernel_shade_regen (reached through shade_regen).
// Plain PyTorch versions: ops/cuda_fused.shade_regen_reference (fused),
// shade_update_reference (shade only) and regen_reference (regen only).
//
// The work of a lane splits in two halves, each a device function below:
//   * SHADE (sr_shade): hit point and normal of the segment just traced,
//     the bounce's threefry draws, lambert/metal/dielectric scatter and
//     sky, the optional bounce-0 stratified substitution, Russian
//     roulette, the depth cap, the sky deposit into the task accumulators;
//   * REGEN (sr_plan + sr_apply): the move of a finished task into a free
//     pending slot, the acquisition of the next task (strided or tile
//     ownership), and the camera ray (four modes, iid or stratified) of a
//     re-issued lane.
// Three C entries launch them: rtw_shade_regen (shade then regen: the
// fused engine's step), rtw_shade_only (the unrotated step's shading,
// mega="off") and rtw_regen_only (the engine's prologue and the unrotated
// steps' regeneration). All three share ShadeRegenConfig and the plane
// layout, so every camera ray and every bounce draw on the card comes from
// this one arithmetic. Each reads all of a lane's planes before it writes
// any, so the output planes may be the input planes (in-place update).
//
// What bounds it: at the default pool (32768 lanes, a grid of at most a
// few blocks an SM) latency and the grid's fixed cost, not bytes: a thread
// runs serial chains -- ~40 loads, then the winner's row, up to 9 threefry
// blocks of 20 rounds, the shade, the camera ray -- that wait on one
// another. At 2^20 lanes it is bytes (3 + 19 + 4*n_slots words read and
// 19 + 4*n_slots written a lane; the arithmetic is small beside that
// traffic).
//
// Design against that:
//   * Programmatic dependent launch (PDL). An entry may be launched with
//     cudaLaunchAttributeProgrammaticStreamSerialization (`pdl`): its
//     launch then overlaps the drain of the kernel before it in the stream
//     (the closest hit, whose blocks trigger implicitly at exit), and its
//     lane-state loads go out before griddepcontrol.wait (the closest hit
//     never writes the state); hit, t and sb are read right after the
//     wait, so both rounds of loads are in flight together. The
//     regen-only entry reads nothing but the state, which the kernel
//     before it writes, so it waits first. Without the attribute the wait
//     returns at once. With `pdl` the caller promises that the stream's
//     previous kernel writes no plane of the lane state. A CUDA graph
//     captured from the stream keeps these as programmatic edges.
//   * Independent draws early. The regen half's task, sample and pixel
//     depend on (task, sid, nxt, slots) and on whether the lane idles;
//     computed as if it idles (sr_plan) they are known before the shade,
//     so every lane runs its candidate camera ray's threefry chains, and
//     the roulette draw, beside the bounce draws while the loads land, and
//     masks the result afterwards (the TPU kernel's way: the same values).
//     Computing the camera ray on issuing lanes only, after the shade, was
//     no faster at 32768 lanes and 6-11% slower at 2^20 (PERF.md).
//   * Grid shape: one lane a thread, `threads` a block (a multiple of 32,
//     up to 512), chosen by ops/cuda_fused.shade_regen_threads from
//     chip_smoke.py's sweep. A warp's accesses are coalesced.
//   * No index into the slot arrays: the slot a finished task moves into
//     is a bit mask, so the lane stays in registers (an index put the
//     whole lane in local memory).
//
// The winner's ten parameters are read straight from the (S, 10) table by
// the sphere index the closest-hit kernel wrote: the table is a few KB and
// stays in cache. (The TPU package resolves them with a one-hot matrix
// product before its kernel because per-ray gathers are slow there; that
// product has no counterpart here.)

#include "rtw_common.cuh"

#define SR_N_BASE 19
#define SR_MAX_SLOTS 4
#define SR_MAX_STATE (SR_N_BASE + 4 * SR_MAX_SLOTS)
#define SR_TABLE_COLS 10
#define SR_MAX_THREADS 512

// The halves a kernel runs.
#define SR_SHADE 1
#define SR_REGEN 2
#define SR_FUSED (SR_SHADE | SR_REGEN)

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

// One lane's state in registers.
struct SrLane {
    int nxt, task, sid, dep;
    bool active;
    float ox, oy, oz, dx, dy, dz, ax, ay, az, acr, acg, acb;
    uint32_t k0, k1;
    int pt[SR_MAX_SLOTS];
    float pr[SR_MAX_SLOTS], pg[SR_MAX_SLOTS], pb[SR_MAX_SLOTS];
};

// The regen half's decisions for a lane that idles after this step.
struct SrPlan {
    int nxt, task, sid, pid;
    unsigned move;  // bit j: the finished task moves into slot j
    bool issue;
};

// A camera ray and its key.
struct SrRay {
    float ox, oy, oz, dx, dy, dz;
    uint32_t k0, k1;
};

// What the shade half draws before it knows the hit (u_rr only under
// Russian roulette).
struct SrDraws {
    float rvx, rvy, rvz, ru, u_rr;
};

__device__ __forceinline__ void sr_wait_prior_grid() {
    asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The planes a half reads: the shade half the ray, throughput, depth,
// accumulators, key and (for the stratified substitution) task and sid;
// the regen half all of them.
template <int MODE>
__device__ __forceinline__ void sr_load(const ShadeRegenConfig& cfg,
                                        const StatePtrs& in, int i,
                                        SrLane& L) {
#define LDI(k) (((const int*)in.p[k])[i])
#define LDF(k) (((const float*)in.p[k])[i])
#define LDU(k) (((const uint32_t*)in.p[k])[i])
    L.task = LDI(1);
    L.sid = LDI(2);
    L.active = LDI(3) > 0;
    L.ox = LDF(4); L.oy = LDF(5); L.oz = LDF(6);
    L.dx = LDF(7); L.dy = LDF(8); L.dz = LDF(9);
    L.ax = LDF(10); L.ay = LDF(11); L.az = LDF(12);
    L.dep = LDI(13);
    L.acr = LDF(14); L.acg = LDF(15); L.acb = LDF(16);
    L.k0 = LDU(17); L.k1 = LDU(18);
    if (MODE & SR_REGEN) {
        L.nxt = LDI(0);
#pragma unroll
        for (int j = 0; j < SR_MAX_SLOTS; ++j) {
            if (j < cfg.n_slots) {
                L.pt[j] = LDI(SR_N_BASE + 4 * j);
                L.pr[j] = LDF(SR_N_BASE + 4 * j + 1);
                L.pg[j] = LDF(SR_N_BASE + 4 * j + 2);
                L.pb[j] = LDF(SR_N_BASE + 4 * j + 3);
            }
        }
    }
#undef LDI
#undef LDF
#undef LDU
}

// The planes a half writes: the shade half planes 3..16 (the others are
// its inputs unchanged), the regen half all of them.
template <int MODE>
__device__ __forceinline__ void sr_store(const ShadeRegenConfig& cfg,
                                         const StatePtrs& out, int i,
                                         const SrLane& L) {
#define STI(k, v) (((int*)out.p[k])[i] = (v))
#define STF(k, v) (((float*)out.p[k])[i] = (v))
#define STU(k, v) (((uint32_t*)out.p[k])[i] = (v))
    if (MODE & SR_REGEN) {
        STI(0, L.nxt); STI(1, L.task); STI(2, L.sid);
    }
    STI(3, L.active ? 1 : 0);
    STF(4, L.ox); STF(5, L.oy); STF(6, L.oz);
    STF(7, L.dx); STF(8, L.dy); STF(9, L.dz);
    STF(10, L.ax); STF(11, L.ay); STF(12, L.az);
    STI(13, L.dep);
    STF(14, L.acr); STF(15, L.acg); STF(16, L.acb);
    if (MODE & SR_REGEN) {
        STU(17, L.k0); STU(18, L.k1);
#pragma unroll
        for (int j = 0; j < SR_MAX_SLOTS; ++j) {
            if (j < cfg.n_slots) {
                STI(SR_N_BASE + 4 * j, L.pt[j]);
                STF(SR_N_BASE + 4 * j + 1, L.pr[j]);
                STF(SR_N_BASE + 4 * j + 2, L.pg[j]);
                STF(SR_N_BASE + 4 * j + 3, L.pb[j]);
            }
        }
    }
#undef STI
#undef STF
#undef STU
}

// ---- shade half --------------------------------------------------------

// The draws of the bounce at the lane's depth: scatter vector and reflect
// uniform (with the bounce-0 stratified substitution), and -- under
// Russian roulette -- its uniform. None depends on the hit.
__device__ __forceinline__ SrDraws sr_draws(const ShadeRegenConfig& cfg,
                                            const SrLane& L) {
    SrDraws w;
    rtw_bounce_draws(L.k0, L.k1, L.dep, cfg.unit_sample != 0, w.rvx, w.rvy,
                     w.rvz, w.ru);
    if (cfg.stratified && L.dep == 0) {
        // First-bounce stratified scatter: the CURRENT ray's pixel from
        // its task (the regen half's arithmetic).
        const int pid_cur =
            sr_task_pixel(cfg, rtw_floordiv(max(L.task, 0), cfg.tpp));
        rtw_strat0_scatter(L.k0, L.k1, pid_cur, L.sid, cfg.b0, cfg.b1,
                           cfg.spp, cfg.unit_sample != 0, w.rvx, w.rvy,
                           w.rvz);
    }
    w.u_rr = 0.0f;
    if (cfg.rr_terminate) {
        // ops/rng.rr_terminate_update: word 0 of (TAG_BOUNCE + depth, 2).
        float unused;
        rtw_draw2(L.k0, L.k1, RTW_TAG_BOUNCE + (uint32_t)L.dep, 2u, w.u_rr,
                  unused);
    }
    return w;
}

// Shade the segment just traced and update the lane; returns whether the
// lane keeps tracing.
__device__ __forceinline__ bool sr_shade(const ShadeRegenConfig& cfg,
                                         SrLane& L, const SrDraws& w,
                                         bool hit, float t_safe,
                                         const float* __restrict__ row) {
    const float chx = row[0], chy = row[1], chz = row[2], rh = row[3];
    const int mt = (int)row[4];
    const float alr = row[5], alg = row[6], alb = row[7];
    const float fz = row[8], io = row[9];
    const float px = L.ox + t_safe * L.dx;
    const float py = L.oy + t_safe * L.dy;
    const float pz = L.oz + t_safe * L.dz;
    const float inv_r = 1.0f / ((rh != 0.0f) ? rh : 1.0f);
    const float nx = (px - chx) * inv_r;
    const float ny = (py - chy) * inv_r;
    const float nz = (pz - chz) * inv_r;
    const RtwShade sh = rtw_shade(L.dx, L.dy, L.dz, nx, ny, nz, mt, fz, io,
                                  w.rvx, w.rvy, w.rvz, w.ru,
                                  cfg.phys_refract != 0, cfg.sky_bias);

    const bool miss_now = L.active && !hit;
    const bool scatter_now = L.active && hit && sh.valid;
    const bool depth_out = scatter_now && (L.dep + 1 >= cfg.max_depth);
    bool keep = scatter_now && !depth_out;

    // Sky accumulates into the lane's task registers.
    if (miss_now) {
        L.acr = L.acr + L.ax * sh.sky_r;
        L.acg = L.acg + L.ay * sh.sky_g;
        L.acb = L.acb + L.az * sh.sky_b;
    }
    if (keep) {
        L.ox = px; L.oy = py; L.oz = pz;
        L.dx = sh.sdx; L.dy = sh.sdy; L.dz = sh.sdz;
        L.ax = L.ax * alr; L.ay = L.ay * alg; L.az = L.az * alb;
    }
    if (cfg.rr_terminate) {
        // Russian roulette (ops/rng.rr_terminate_update): survivors boost
        // 1/q, casualties die like absorb.
        const bool consider = keep && (L.dep + 1 >= cfg.rr_start);
        if (consider) {
            const float q = rtw_min(
                rtw_max(cfg.rr_scale * rtw_max(L.ax, rtw_max(L.ay, L.az)),
                        cfg.rr_qmin), 1.0f);
            const bool surv = w.u_rr < q;
            const float boost = surv ? 1.0f / q : 1.0f;
            L.ax = L.ax * boost; L.ay = L.ay * boost; L.az = L.az * boost;
            keep = surv;
        }
    }
    if (keep) L.dep = L.dep + 1;
    L.active = keep;
    return keep;
}

// ---- regen half --------------------------------------------------------

// What the regen half does to lane i IF it idles: a completed task moves
// (task id, rgb) into the first FREE pending slot (with every slot full
// the lane idles until the epoch flush); a taskless lane acquires the next
// task of its own sequence; the sample id advances. Reads task, sid, nxt
// and the slots' task ids, which the shade half never changes, so it can
// run before the shade.
__device__ __forceinline__ SrPlan sr_plan(const ShadeRegenConfig& cfg,
                                          int i, const SrLane& L) {
    SrPlan p;
    const bool has_task = L.task >= 0;
    const int pid_old = rtw_floordiv(L.task, cfg.tpp);
    const int run_end_old = min(
        (L.task - pid_old * cfg.tpp) * cfg.task_samples + cfg.task_samples,
        cfg.spp);
    const bool task_done = has_task && (L.sid + 1 >= run_end_old);
    // A bit a slot, never a slot index: an index into the slot arrays
    // would put them (and the whole lane) in local memory.
    p.move = 0u;
    bool remaining = task_done;
#pragma unroll
    for (int j = 0; j < SR_MAX_SLOTS; ++j) {
        if (j < cfg.n_slots) {
            const bool mv = remaining && (L.pt[j] < 0);
            if (mv) p.move |= 1u << j;
            remaining = remaining && !mv;
        }
    }
    int task = p.move ? -1 : L.task;

    // The end of the lane's own task sequence: the whole frame under
    // strided ownership, its ownership block's range under tile ownership.
    const int block_end =
        cfg.own_bl ? cfg.worker_base + (i / cfg.own_bl + 1) * cfg.t_b
                   : cfg.n_tasks;
    const bool acquire = (task < 0) && (L.nxt < block_end);
    p.nxt = L.nxt;
    if (acquire) {
        task = L.nxt;
        p.nxt = L.nxt + cfg.stride;
    }
    const int vp = rtw_floordiv(task, cfg.tpp);
    const int run_start = (task - vp * cfg.tpp) * cfg.task_samples;
    p.pid = sr_task_pixel(cfg, vp);
    const bool next_sample =
        has_task && (L.sid + 1 < run_end_old) && !task_done;
    p.sid = acquire ? run_start : (next_sample ? L.sid + 1 : L.sid);
    p.issue = acquire || next_sample;
    p.task = task;
    return p;
}

__device__ __forceinline__ SrRay sr_camera(const ShadeRegenConfig& cfg,
                                           const float* __restrict__ cam,
                                           const SrPlan& p) {
    SrRay r;
    float o[3], d[3];
    rtw_camera_ray(cam, cfg.b0, cfg.b1, p.pid, p.sid, cfg.width, cfg.height,
                   cfg.spp, cfg.camera_mode, cfg.stratified != 0, o, d,
                   r.k0, r.k1);
    r.ox = o[0]; r.oy = o[1]; r.oz = o[2];
    r.dx = d[0]; r.dy = d[1]; r.dz = d[2];
    return r;
}

// Carry out the plan on a lane that idles (`keep` false); an issued lane
// takes camera ray `r`, computed for every lane beforehand.
__device__ __forceinline__ void sr_apply(SrLane& L, const SrPlan& p,
                                         bool keep, const SrRay& r) {
    if (keep) return;
#pragma unroll
    for (int j = 0; j < SR_MAX_SLOTS; ++j) {
        if (p.move & (1u << j)) {
            L.pt[j] = L.task; L.pr[j] = L.acr; L.pg[j] = L.acg;
            L.pb[j] = L.acb;
        }
    }
    if (p.move) {
        L.acr = 0.0f; L.acg = 0.0f; L.acb = 0.0f;
    }
    L.task = p.task;
    L.nxt = p.nxt;
    L.sid = p.sid;
    if (p.issue) {
        L.ox = r.ox; L.oy = r.oy; L.oz = r.oz;
        L.dx = r.dx; L.dy = r.dy; L.dz = r.dz;
        L.ax = 1.0f; L.ay = 1.0f; L.az = 1.0f;
        L.dep = 0;
        L.k0 = r.k0; L.k1 = r.k1;
        L.active = true;
    }
}

// ---- the kernel --------------------------------------------------------

template <int MODE>
__global__ void __launch_bounds__(SR_MAX_THREADS)
shade_regen_kernel(const ShadeRegenConfig cfg, const StatePtrs in,
                   const StatePtrs out, const int* __restrict__ hit_p,
                   const float* __restrict__ t_p,
                   const int* __restrict__ sb_p,
                   const float* __restrict__ table,
                   const float* __restrict__ cam, int n_lanes,
                   int n_spheres) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    // Loads first: the lane state (which the closest hit never writes),
    // then -- once the previous kernel is done -- hit, t and sb, so that
    // both rounds are in flight together. The regen-only entry reads
    // nothing but the state, which the kernel before it writes: it waits
    // first.
    if (MODE == SR_REGEN) sr_wait_prior_grid();
    const bool ok = i < n_lanes;
    SrLane L;
    if (ok) sr_load<MODE>(cfg, in, i, L);
    int hv = 0, sv = 0;
    float tv = 0.0f;
    if (MODE & SR_SHADE) {
        sr_wait_prior_grid();
        if (ok) {
            hv = hit_p[i];
            tv = t_p[i];
            sv = sb_p[i];
        }
    }
    if (!ok) return;
    // What depends on the state alone, while those loads land: the regen
    // plan, the bounce draws, the camera ray and the roulette draw.
    SrPlan plan;
    SrRay ray;
    SrDraws w;
    if (MODE & SR_REGEN) {
        plan = sr_plan(cfg, i, L);
        ray = sr_camera(cfg, cam, plan);
    }
    if (MODE & SR_SHADE) w = sr_draws(cfg, L);
    bool keep = L.active;
    if (MODE & SR_SHADE) {
        const bool hit = hv > 0;
        const float t_safe = hit ? tv : 1.0f;
        // The winner's parameters, by index (clamped: an index outside the
        // table must not become a wild read).
        const int s = min(max(sv, 0), n_spheres - 1);
        keep = sr_shade(cfg, L, w, hit, t_safe,
                        table + (size_t)s * SR_TABLE_COLS);
    }
    if (MODE & SR_REGEN) sr_apply(L, plan, keep, ray);
    sr_store<MODE>(cfg, out, i, L);
}

// ---- C entries ---------------------------------------------------------

template <int MODE>
static int sr_launch(const ShadeRegenConfig& cfg, const void* const* state_in,
                     void* const* state_out, const void* hit, const void* t,
                     const void* sb, const void* table, const void* cam,
                     int n_lanes, int n_spheres, int threads, int pdl,
                     void* stream) {
    if (cfg.n_slots < 1 || cfg.n_slots > SR_MAX_SLOTS || n_lanes < 1
            || n_spheres < 1 || cfg.own_bl < 0
            || (cfg.own_bl > 0 && cfg.tiles_x < 1) || threads < 32
            || threads > SR_MAX_THREADS || threads % 32)
        return (int)cudaErrorInvalidValue;
    StatePtrs in = {}, out = {};
    const int n_state = SR_N_BASE + 4 * cfg.n_slots;
    for (int k = 0; k < n_state; ++k) {
        in.p[k] = (void*)state_in[k];
        out.p[k] = state_out[k];
    }
    cudaLaunchConfig_t lc = {};
    lc.gridDim = dim3((n_lanes + threads - 1) / threads);
    lc.blockDim = dim3(threads);
    lc.dynamicSmemBytes = 0;
    lc.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    lc.attrs = attr;
    lc.numAttrs = pdl ? 1 : 0;
    const cudaError_t e = cudaLaunchKernelEx(
        &lc, shade_regen_kernel<MODE>, cfg, in, out, (const int*)hit,
        (const float*)t, (const int*)sb, (const float*)table,
        (const float*)cam, n_lanes, n_spheres);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// C entries. `cfg`, `state_in` and `state_out` are HOST pointers: the
// config struct and two arrays of 19 + 4*n_slots device pointers (the
// lane-state planes; out may equal in; rtw_shade_only writes planes 3..16
// only). The other pointers are device pointers. `threads` is the block
// size (a multiple of 32, at most 512), `pdl` 1 to launch with
// programmatic stream serialization. Launches on `stream`, does not
// synchronise, returns the launch's error or cudaGetLastError()
// (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int rtw_shade_regen(const void* cfg_p, const void* const* state_in,
                               void* const* state_out, const void* hit,
                               const void* t, const void* sb,
                               const void* table, const void* cam,
                               int n_lanes, int n_spheres, int threads,
                               int pdl, void* stream) {
    return sr_launch<SR_FUSED>(*(const ShadeRegenConfig*)cfg_p, state_in,
                               state_out, hit, t, sb, table, cam, n_lanes,
                               n_spheres, threads, pdl, stream);
}

extern "C" int rtw_shade_only(const void* cfg_p, const void* const* state_in,
                              void* const* state_out, const void* hit,
                              const void* t, const void* sb,
                              const void* table, int n_lanes, int n_spheres,
                              int threads, int pdl, void* stream) {
    return sr_launch<SR_SHADE>(*(const ShadeRegenConfig*)cfg_p, state_in,
                               state_out, hit, t, sb, table, nullptr,
                               n_lanes, n_spheres, threads, pdl, stream);
}

extern "C" int rtw_regen_only(const void* cfg_p, const void* const* state_in,
                              void* const* state_out, const void* cam,
                              int n_lanes, int threads, int pdl,
                              void* stream) {
    return sr_launch<SR_REGEN>(*(const ShadeRegenConfig*)cfg_p, state_in,
                               state_out, nullptr, nullptr, nullptr, nullptr,
                               cam, n_lanes, 1, threads, pdl, stream);
}

// Programmatic (PDL) edges of a CUDA graph: how many of its edges carry
// cudaGraphDependencyTypeProgrammatic -- whether stream capture kept the
// dependent launches. Returns the count, or -1 - the error.
extern "C" int rtw_graph_programmatic_edges(void* graph) {
#if CUDART_VERSION >= 12030
#if CUDART_VERSION >= 13000
#define SR_GET_EDGES cudaGraphGetEdges
#else
#define SR_GET_EDGES cudaGraphGetEdges_v2
#endif
    size_t n = 0;
    cudaError_t e = SR_GET_EDGES((cudaGraph_t)graph, nullptr, nullptr,
                                 nullptr, &n);
    if (e != cudaSuccess) return -1 - (int)e;
    if (n == 0) return 0;
    cudaGraphNode_t* from = new cudaGraphNode_t[n];
    cudaGraphNode_t* to = new cudaGraphNode_t[n];
    cudaGraphEdgeData* data = new cudaGraphEdgeData[n];
    e = SR_GET_EDGES((cudaGraph_t)graph, from, to, data, &n);
#undef SR_GET_EDGES
    int count = 0;
    if (e == cudaSuccess)
        for (size_t k = 0; k < n; ++k)
            count += data[k].type == cudaGraphDependencyTypeProgrammatic;
    delete[] from;
    delete[] to;
    delete[] data;
    return e == cudaSuccess ? count : -1 - (int)e;
#else
    return -1 - (int)cudaErrorNotSupported;
#endif
}
