// Moller-Trumbore of one ray against one triangle lane of a cluster tile,
// shared by the list-tracer kernels (listtrace.cu) and the probe kernels
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

// Minimum of v over the 128 threads of a block (4 warps); every thread
// gets it.  `scratch` holds 4 floats of shared memory; the caller makes
// sure no thread still reads it from an earlier call.
__device__ __forceinline__ float block_min128(float v, float* scratch) {
  v = warp_min(v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  return fminf(fminf(scratch[0], scratch[1]), fminf(scratch[2], scratch[3]));
}

}  // namespace srt
