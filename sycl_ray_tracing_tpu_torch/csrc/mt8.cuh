// Moller-Trumbore of one ray against one triangle lane of a cluster tile,
// and the cp.async helpers that stage tiles in shared memory, shared by
// the list-tracer kernels (listtrace.cu) and the probe kernels
// (probes.cu).
//
// Arithmetic follows _mt8 (sycl_ray_tracing_tpu/ops/pallas/listtrace.py:
// 165-194) operation for operation, with an IEEE 1.0f/a.  Every file that
// includes this header is built with -fmad=false, so no multiply-add is
// contracted and t is bit-identical to the plain torch version (whose
// elementwise ops never contract either).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace srt {

constexpr int kLanes = 128;     // triangles per cluster tile (T_CLUSTER)
constexpr int kMaxc = 128;      // candidate slots at most (winner packing)
constexpr float kEps = 1e-7f;   // safe_math.EPS
constexpr float kBigT = 3.0e38f;

struct Lane {
  float ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z;
};

// Lane `lane` of tile `cluster` of tris f32 [K2+1, 9, 128] (planar rows
// ax ay az bx by bz cx cy cz), with its two edges formed.
__device__ __forceinline__ Lane load_lane(const float* __restrict__ tris,
                                          int cluster, int lane) {
  const float* p = tris + (size_t)cluster * 9 * kLanes + lane;
  Lane L;
  L.ax = p[0 * kLanes];
  L.ay = p[1 * kLanes];
  L.az = p[2 * kLanes];
  L.e1x = p[3 * kLanes] - L.ax;
  L.e1y = p[4 * kLanes] - L.ay;
  L.e1z = p[5 * kLanes] - L.az;
  L.e2x = p[6 * kLanes] - L.ax;
  L.e2y = p[7 * kLanes] - L.ay;
  L.e2z = p[8 * kLanes] - L.az;
  return L;
}

// _mt8 for one (ray, lane): t of a valid hit below tl, else BIG_T.
__device__ __forceinline__ float mt8(const Lane& L, float ox, float oy,
                                     float oz, float dx, float dy, float dz,
                                     float tl) {
  const float hx = dy * L.e2z - dz * L.e2y;
  const float hy = dz * L.e2x - dx * L.e2z;
  const float hz = dx * L.e2y - dy * L.e2x;
  const float a = L.e1x * hx + L.e1y * hy + L.e1z * hz;
  const bool parallel = fabsf(a) < kEps;
  const float f = 1.0f / (parallel ? 1.0f : a);
  const float sx = ox - L.ax, sy = oy - L.ay, sz = oz - L.az;
  const float u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * L.e1z - sz * L.e1y;
  const float qy = sz * L.e1x - sx * L.e1z;
  const float qz = sx * L.e1y - sy * L.e1x;
  const float v = f * (dx * qx + dy * qy + dz * qz);
  const float t = f * (L.e2x * qx + L.e2y * qy + L.e2z * qz);
  const bool ok = !parallel && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                  u + v <= 1.0f && t > kEps && t < tl;
  return ok ? t : kBigT;
}

// Minimum of v over the 32 lanes of a warp; every lane gets it.
__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// 16 bytes global -> shared, asynchronously; through L2 only (.cg), or
// through L1 too (.ca, kL1) where blocks of an SM name the same tiles.
template <bool kL1 = false>
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (kL1)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

}  // namespace srt
