// closest_hit_mxu: per ray, the closest hit over all S spheres with the
// two dot products regrouped as d.C and o.C.
//
// Replaces the Pallas TPU kernel raytracinginoneweekend_tpu/ops/
// pallas_segment.py::_kernel_mxu (reached through
// segment_closest_hit_mxu). Plain PyTorch version:
// ops/cuda_segment.segment_closest_hit_mxu_reference.
//
// The TPU kernel lays the spheres along its lanes so that d.C and o.C for
// a whole block of rays become two (rays, 8) @ (8, spheres) products on
// its matrix unit, in its own body; what is left per candidate is
//     -b = d.C - d.o,   c = (|o|^2 - 2 o.C) + (|C|^2 - r^2)
// the roots, the window and the min. This kernel computes the same
// REGROUPED arithmetic -- the per-ray scalars a = |d|^2, d.o, |o|^2 once,
// then per sphere the two three-term products against a shared-memory
// table (cx, cy, cz, |C|^2 - r^2) in plain float32 in a fixed order -- so
// it is bit-equal with its plain version, and NOT bit-equal with
// closest_hit: d.o - d.C rounds differently from d.(o - C) on knife-edge
// candidates (same magnitude of cancellation noise, terms ~|o||C|).
// The winner is the running strict-< min, which keeps the earliest index
// on exact ties, as the TPU kernel's lane min + least-matching-index
// does. t = q_min / a by true division; sb = 0 on a miss.
//
// What bounds it: float32 arithmetic, about 28 operations per lane and
// sphere against 40 bytes per lane. The card's tensor cores take no
// float32 inputs (a split into three TF32 products would be needed), so
// the products run on the ordinary float32 units.
//
// Design: closest_hit's -- one thread per lane, the table staged in
// shared memory once per block and read as a broadcast; an inactive lane
// writes (hit 0, t 1e30, sb 0) and leaves before the loop.

#include "rtw_common.cuh"

#define CM_THREADS 128

__global__ void __launch_bounds__(CM_THREADS)
closest_hit_mxu_kernel(const int* __restrict__ act,
                       const float* __restrict__ ox,
                       const float* __restrict__ oy,
                       const float* __restrict__ oz,
                       const float* __restrict__ dx,
                       const float* __restrict__ dy,
                       const float* __restrict__ dz,
                       const float4* __restrict__ table,  // (S) cx cy cz ccr
                       int* __restrict__ hit, float* __restrict__ t,
                       int* __restrict__ sb, int n_lanes, int n_spheres,
                       float t_min) {
    extern __shared__ float4 sph[];
    for (int s = threadIdx.x; s < n_spheres; s += blockDim.x)
        sph[s] = table[s];
    __syncthreads();

    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_lanes) return;
    if (act[i] <= 0) {
        hit[i] = 0;
        t[i] = RTW_BIG;
        sb[i] = 0;
        return;
    }
    const float x = ox[i], y = oy[i], z = oz[i];
    const float vx = dx[i], vy = dy[i], vz = dz[i];
    const float a = vx * vx + vy * vy + vz * vz;
    const float d_o = vx * x + vy * y + vz * z;
    const float o_o = x * x + y * y + z * z;
    const float q_min = t_min * a;

    float q_b = RTW_BIG;
    int s_b = 0;
#pragma unroll 4
    for (int s = 0; s < n_spheres; ++s) {
        const float4 c4 = sph[s];
        const float dC = vx * c4.x + vy * c4.y + vz * c4.z;
        const float oC = x * c4.x + y * c4.y + z * c4.z;
        const float bneg = dC - d_o;                 // -b = d.C - d.o
        const float c = (o_o - (oC + oC)) + c4.w;
        const float sq = sqrtf(bneg * bneg - a * c);  // NaN when disc < 0
        const float q0 = bneg - sq;
        const float q1 = bneg + sq;
        const float q = (q0 > q_min) ? q0 : ((q1 > q_min) ? q1 : RTW_BIG);
        if (q < q_b) {
            q_b = q;
            s_b = s;
        }
    }
    const bool h = q_b < RTW_BIG;
    hit[i] = h ? 1 : 0;
    t[i] = h ? q_b / a : RTW_BIG;
    sb[i] = h ? s_b : 0;
}

// C entry. Pointers are device pointers; `table` is (S, 4) float32
// (cx, cy, cz, cx*cx + cy*cy + cz*cz - r*r). Launches on `stream`, does
// not synchronise, and returns cudaGetLastError().
extern "C" int rtw_closest_hit_mxu(const void* act, const void* ox,
                                   const void* oy, const void* oz,
                                   const void* dx, const void* dy,
                                   const void* dz, const void* table,
                                   void* hit, void* t, void* sb, int n_lanes,
                                   int n_spheres, float t_min,
                                   void* stream) {
    const size_t smem = (size_t)n_spheres * sizeof(float4);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            closest_hit_mxu_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int blocks = (n_lanes + CM_THREADS - 1) / CM_THREADS;
    closest_hit_mxu_kernel<<<blocks, CM_THREADS, smem,
                             (cudaStream_t)stream>>>(
        (const int*)act, (const float*)ox, (const float*)oy,
        (const float*)oz, (const float*)dx, (const float*)dy,
        (const float*)dz, (const float4*)table, (int*)hit, (float*)t,
        (int*)sb, n_lanes, n_spheres, t_min);
    return (int)cudaGetLastError();
}
