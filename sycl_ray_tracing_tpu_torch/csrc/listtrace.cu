// List-tracer kernels for Hopper (sm_90a), bound to PyTorch through a
// plain C interface loaded with ctypes (ops/kernels/listtrace.py).
//
// Both kernels walk precomputed nearest-first candidate-cluster lists and
// run Moller-Trumbore of one ray against the 128 triangles ("lanes") of a
// cluster tile per round.  Each emits the per-(ray, lane) minimum t over
// all rounds, starting at the ray's t_lim, and the round that produced it
// (strict '<', so the earliest round wins a tie within a lane).  The
// per-ray lane reduction, winner packing and certificates stay in torch
// (_run_once's tail), exactly as the Pallas kernels left them to XLA.
//
// Inputs
//   cand  i32 [rows_or_blocks, maxc]  cluster id per round; the dummy id
//                                     K2 marks an empty slot
//   rays  f32 [rays, 8]               o3 d3 t_lim anyhit_flag
//   tris  f32 [K2+1, 9, 128]          planar tiles (ax ay az bx .. cz);
//                                     row K2 is the all-zero dummy
// Outputs
//   at    f32 [rays, 128], ar i32 [rays, 128]
//
// What bounds them on an H100: the 200k-triangle scene's tiles are
// 1601 x 9 x 128 x 4 B = 7.4 MB, resident in the 50 MB L2, and one round
// of the block kernel reads 4.6 KB of tile for 32 x 128 = 4096 ray-triangle
// tests of ~40 FP32 operations each.  So the work is bound by FP32 ALU and
// instruction issue, not by memory.  The design answers that with reuse:
// a thread owns one triangle lane, loads its 9 floats once per round
// (coalesced across the block), forms the two edges once, and reuses them
// for all 32 rays, whose fields sit in shared memory and are read as
// broadcasts; the 32 running (t, round) pairs live in registers.
//
// Arithmetic follows _mt8 (sycl_ray_tracing_tpu/ops/pallas/listtrace.py:
// 165-194) operation for operation, with an IEEE 1.0f/a.  Built with
// -fmad=false, so no multiply-add is contracted and t is bit-identical to
// the plain torch version (whose elementwise ops never contract either).
//
// Round skipping: a kernel skips ONLY rounds whose candidate is the dummy
// id K2 (its zero tile makes every ray parallel, so such a round never
// updates anything).  The Pallas usefulness guard, any-hit early exit and
// count-chunk gates are later performance work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;     // triangles per cluster tile (T_CLUSTER)
constexpr int kRbShare = 32;    // rays per block-shared list (RB_SHARE)
constexpr int kMaxc = 128;      // candidate slots at most (winner packing)
constexpr float kEps = 1e-7f;   // safe_math.EPS
constexpr float kBigT = 3.0e38f;

struct Lane {
  float ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z;
};

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

// Replaces _block_kernel_impl (listtrace.py:298-352): one CUDA block per
// block of 32 sorted rays sharing one candidate list; thread = lane.
__global__ void __launch_bounds__(kLanes)
block_tiles_kernel(const int32_t* __restrict__ cand,
                   const float* __restrict__ rays,
                   const float* __restrict__ tris, float* __restrict__ at_out,
                   int32_t* __restrict__ ar_out, int maxc, int dummy) {
  __shared__ float sray[kRbShare][8];
  __shared__ int32_t scand[kMaxc];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  for (int i = lane; i < kRbShare * 8; i += kLanes)
    sray[i / 8][i % 8] = rays[(size_t)b * kRbShare * 8 + i];
  for (int i = lane; i < maxc; i += kLanes)
    scand[i] = cand[(size_t)b * maxc + i];
  __syncthreads();

  float at[kRbShare];
  int32_t ar[kRbShare];
#pragma unroll
  for (int i = 0; i < kRbShare; ++i) {
    at[i] = sray[i][6];
    ar[i] = -1;
  }
  for (int r = 0; r < maxc; ++r) {
    const int c = scand[r];
    if (c == dummy) continue;  // uniform across the block
    const Lane L = load_lane(tris, c, lane);
#pragma unroll
    for (int i = 0; i < kRbShare; ++i) {
      const float t = mt8(L, sray[i][0], sray[i][1], sray[i][2], sray[i][3],
                          sray[i][4], sray[i][5], sray[i][6]);
      if (t < at[i]) {
        at[i] = t;
        ar[i] = r;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRbShare; ++i) {
    const size_t o = ((size_t)b * kRbShare + i) * kLanes + lane;
    at_out[o] = at[i];
    ar_out[o] = ar[i];
  }
}

// Replaces _list_kernel_impl (listtrace.py:245-295): one CUDA block per
// ray walking its OWN list; thread = lane.
__global__ void __launch_bounds__(kLanes)
list_tiles_kernel(const int32_t* __restrict__ cand,
                  const float* __restrict__ rays,
                  const float* __restrict__ tris, float* __restrict__ at_out,
                  int32_t* __restrict__ ar_out, int maxc, int dummy) {
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  const float* ray = rays + (size_t)row * 8;
  const float ox = ray[0], oy = ray[1], oz = ray[2];
  const float dx = ray[3], dy = ray[4], dz = ray[5], tl = ray[6];
  const int32_t* crow = cand + (size_t)row * maxc;
  float at = tl;
  int32_t ar = -1;
  for (int r = 0; r < maxc; ++r) {
    const int c = crow[r];
    if (c == dummy) continue;  // uniform across the block
    const float t = mt8(load_lane(tris, c, lane), ox, oy, oz, dx, dy, dz, tl);
    if (t < at) {
      at = t;
      ar = r;
    }
  }
  at_out[(size_t)row * kLanes + lane] = at;
  ar_out[(size_t)row * kLanes + lane] = ar;
}

}  // namespace

extern "C" {

// Each entry point launches on the caller's stream and returns
// cudaGetLastError() (0 on success); it never synchronises.
int srt_block_tiles(const void* cand, const void* rays, const void* tris,
                    void* at, void* ar, int nblocks, int maxc, int dummy,
                    void* stream) {
  if (maxc < 1 || maxc > kMaxc) return (int)cudaErrorInvalidValue;
  if (nblocks > 0)
    block_tiles_kernel<<<nblocks, kLanes, 0, (cudaStream_t)stream>>>(
        (const int32_t*)cand, (const float*)rays, (const float*)tris,
        (float*)at, (int32_t*)ar, maxc, dummy);
  return (int)cudaGetLastError();
}

int srt_list_tiles(const void* cand, const void* rays, const void* tris,
                   void* at, void* ar, int nrays, int maxc, int dummy,
                   void* stream) {
  if (maxc < 1 || maxc > kMaxc) return (int)cudaErrorInvalidValue;
  if (nrays > 0)
    list_tiles_kernel<<<nrays, kLanes, 0, (cudaStream_t)stream>>>(
        (const int32_t*)cand, (const float*)rays, (const float*)tris,
        (float*)at, (int32_t*)ar, maxc, dummy);
  return (int)cudaGetLastError();
}

}  // extern "C"
