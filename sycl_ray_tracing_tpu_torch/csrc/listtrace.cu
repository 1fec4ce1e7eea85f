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
// tests of ~54 FP32 operations each.  So the work is bound by FP32 ALU and
// instruction issue, not by memory.  The design answers that with reuse:
// a thread owns one triangle lane, loads its 9 floats once per round
// (coalesced across the block), forms the two edges once, and reuses them
// for all 32 rays, whose fields sit in shared memory and are read as
// broadcasts; the 32 running (t, round) pairs live in registers.
//
// Arithmetic: mt8.cuh, built with -fmad=false (bit-identical to the plain
// torch versions).
//
// Round skipping: a kernel skips ONLY rounds whose candidate is the dummy
// id K2 (its zero tile makes every ray parallel, so such a round never
// updates anything).  The Pallas usefulness guard, any-hit early exit and
// count-chunk gates are later performance work.

#include "mt8.cuh"

namespace {

using srt::kLanes;
using srt::kMaxc;

constexpr int kRbShare = 32;    // rays per block-shared list (RB_SHARE)

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
    const srt::Lane L = srt::load_lane(tris, c, lane);
#pragma unroll
    for (int i = 0; i < kRbShare; ++i) {
      const float t = srt::mt8(L, sray[i][0], sray[i][1], sray[i][2],
                               sray[i][3], sray[i][4], sray[i][5], sray[i][6]);
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
// ray walking its OWN list; thread = lane.  The main path's shape.
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
    const float t = srt::mt8(srt::load_lane(tris, c, lane), ox, oy, oz, dx,
                             dy, dz, tl);
    if (t < at) {
      at = t;
      ar = r;
    }
  }
  at_out[(size_t)row * kLanes + lane] = at;
  ar_out[(size_t)row * kLanes + lane] = ar;
}

// The per-ray kernel with kRays rays per CUDA block: the TPU kernel's RB
// (rays per grid step, swept by scratch/kernel_shape_bench.py:117).  Each
// round walks the block's kRays rays, each against its OWN tile, so a
// thread issues kRays independent lane loads per round instead of one;
// the rays' fields and lists sit in shared memory and their (t, round)
// pairs in registers.  Outputs are bit-identical to list_tiles_kernel.
// Bound on an H100: FP32 issue, as list_tiles_kernel; the extra loads in
// flight do not pay for the larger register state (the probes time it
// at 1.5-2.4x list_tiles_kernel per ray, PERF.md), so the main path
// keeps one ray per block.
template <int kRays>
__global__ void __launch_bounds__(kLanes)
list_tiles_rays_kernel(const int32_t* __restrict__ cand,
                       const float* __restrict__ rays,
                       const float* __restrict__ tris,
                       float* __restrict__ at_out,
                       int32_t* __restrict__ ar_out, int nrays, int maxc,
                       int dummy) {
  __shared__ float sray[kRays][8];
  __shared__ int32_t scand[kRays][kMaxc];
  const int row0 = blockIdx.x * kRays;
  const int lane = threadIdx.x;
  const int nr = min(kRays, nrays - row0);  // the ragged last block
  for (int i = lane; i < kRays * 8; i += kLanes)
    sray[i / 8][i % 8] = i / 8 < nr ? rays[(size_t)row0 * 8 + i] : 0.0f;
  for (int i = lane; i < kRays * maxc; i += kLanes) {
    const int k = i / maxc, r = i % maxc;
    scand[k][r] = k < nr ? cand[(size_t)(row0 + k) * maxc + r] : dummy;
  }
  __syncthreads();

  float at[kRays];
  int32_t ar[kRays];
#pragma unroll
  for (int i = 0; i < kRays; ++i) {
    at[i] = sray[i][6];
    ar[i] = -1;
  }
  for (int r = 0; r < maxc; ++r) {
#pragma unroll
    for (int i = 0; i < kRays; ++i) {
      const int c = scand[i][r];
      if (c == dummy) continue;  // uniform across the block
      const float t = srt::mt8(srt::load_lane(tris, c, lane), sray[i][0],
                               sray[i][1], sray[i][2], sray[i][3], sray[i][4],
                               sray[i][5], sray[i][6]);
      if (t < at[i]) {
        at[i] = t;
        ar[i] = r;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRays; ++i) {
    if (i < nr) {
      const size_t o = ((size_t)row0 + i) * kLanes + lane;
      at_out[o] = at[i];
      ar_out[o] = ar[i];
    }
  }
}

template <int kRays>
void launch_list_rays(const void* cand, const void* rays, const void* tris,
                      void* at, void* ar, int nrays, int maxc, int dummy,
                      cudaStream_t stream) {
  const int grid = (nrays + kRays - 1) / kRays;
  list_tiles_rays_kernel<kRays><<<grid, kLanes, 0, stream>>>(
      (const int32_t*)cand, (const float*)rays, (const float*)tris,
      (float*)at, (int32_t*)ar, nrays, maxc, dummy);
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

// list_tiles with rays_per_block in {8, 16, 32} rays per CUDA block.
int srt_list_tiles_rays(const void* cand, const void* rays, const void* tris,
                        void* at, void* ar, int nrays, int maxc, int dummy,
                        int rays_per_block, void* stream) {
  if (maxc < 1 || maxc > kMaxc) return (int)cudaErrorInvalidValue;
  if (nrays > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (rays_per_block) {
      case 8:
        launch_list_rays<8>(cand, rays, tris, at, ar, nrays, maxc, dummy, s);
        break;
      case 16:
        launch_list_rays<16>(cand, rays, tris, at, ar, nrays, maxc, dummy, s);
        break;
      case 32:
        launch_list_rays<32>(cand, rays, tris, at, ar, nrays, maxc, dummy, s);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
