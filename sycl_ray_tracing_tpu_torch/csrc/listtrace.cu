// List-tracer kernels for Hopper (sm_90a), bound to PyTorch through a
// plain C interface loaded with ctypes (ops/kernels/listtrace.py).
//
// Both kernels walk precomputed nearest-first candidate-cluster lists and
// run Moller-Trumbore of one ray against the 128 triangles ("lanes") of a
// cluster tile per round.  Each emits the per-(ray, lane) minimum t over
// the rounds it runs, starting at the ray's t_lim, and the round that
// produced it (strict '<', so the earliest round wins a tie within a
// lane).  The per-ray lane reduction, winner packing and certificates stay
// in torch (_run_once's tail), exactly as the Pallas kernels left them to
// XLA.
//
// Inputs
//   cand  i32 [rows_or_blocks, maxc]  cluster id per round; the dummy id
//                                     K2 marks an empty slot
//   ctn   f32 [blocks, maxc]          entry-t per slot, ascending along a
//                                     list (block kernel only)
//   rays  f32 [rays, 8]               o3 d3 t_lim anyhit_flag
//   tris  f32 [K2+1, 9, 128]          planar tiles (ax ay az bx .. cz);
//                                     row K2 is the all-zero dummy
// Outputs
//   at    f32 [rays, 128], ar i32 [rays, 128]
//   stop  i32 [blocks]                first round a block did not run
//                                     (maxc if its guard never fired)
//
// Arithmetic: mt8.cuh, built with -fmad=false (bit-identical to the plain
// torch versions).  Tensor cores do not apply: the work is FP32 cross
// products, a reciprocal and compares per (ray, triangle), not a matrix
// product, and TF32 would break the bit-identity.
//
// Round skipping: both kernels skip rounds whose candidate is the dummy id
// K2 (its zero tile makes every ray parallel, so such a round never
// updates anything).  The block kernel also runs the TPU kernel's tail
// guard; the per-ray kernel does not yet.

#include "mt8.cuh"

namespace {

using srt::kLanes;
using srt::kMaxc;

constexpr int kRbShare = 32;     // rays per block-shared list (RB_SHARE)
constexpr int kGroup = 8;        // rounds before the first guard (GROUP)
constexpr int kChunk = 16;       // rounds between guards (CHUNK)
constexpr int kTileFloats = 9 * kLanes;
constexpr int kTilePieces = kTileFloats / 4;  // 16-byte cp.async pieces
constexpr int kStages = 3;       // tiles in the shared-memory ring
constexpr int kRpt = 8;          // rays per thread of the block kernel
constexpr int kBlockThreads = kLanes * kRbShare / kRpt;  // 512

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
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

// Replaces _block_kernel_impl (sycl_ray_tracing_tpu/ops/pallas/
// listtrace.py:298-352) and its _tail_guard (:197-242): one CUDA block
// per list of 32 sorted rays; thread = (triangle lane, group of kRpt = 8
// rays), so a block has 512 threads.
//
// What bounds it on an H100: FP32 issue.  The 200k-triangle scene's tiles
// (7.4 MB) stay in the 50 MB L2, and one round reads a 4.6 KB tile for
// 32 x 128 ray-triangle tests of ~54 FP32 operations each; under
// -fmad=false each operation takes an issue slot, so the kernel can reach
// about half of the 67 TFLOP/s peak.  What the design does about the four
// things that held the first version back:
//  1. Registers.  A thread carries only its 8 rays' (at, ar), not all
//     32, and reads each ray's fields as two shared-memory broadcasts
//     (float4) per round: no spill, 16 warps per SM.  A long list gets 4
//     times the threads of the one-thread-per-lane version on its rounds.
//     16 rays per thread (256 threads, 2 blocks per SM) measured slower
//     (PERF.md).
//  2. Tile loads.  Warp 0 first compacts the list's live (non-dummy)
//     slots; then tiles go through a 3-stage shared-memory ring filled
//     with cp.async, 16 B a thread, one live round ahead of the one being
//     computed, so one __syncthreads a round suffices.  Every ray group
//     reads its lane's 9 floats from the ring (consecutive lanes: no bank
//     conflicts) and forms the two edges itself.
//  3. Imbalance.  The grid takes lists longest first (list_count_kernel
//     and longest_first_kernel, a counting sort on the card), so the
//     lists of 128 rounds start in the first wave instead of setting the
//     launch's length in the last, and the short ones fill in behind
//     them.  ptxas may use 66 registers, so
//     one block of 16 warps runs per SM and a long list has its SM to
//     itself.  Outputs are written in place, so the order changes
//     nothing.
//  4. The tail guard of the TPU kernel.  Rounds 0..GROUP-1 always run;
//     before each chunk starting at c0 = GROUP + k*CHUNK below the list's
//     count, bt[i] = min over lanes of at[i, :] (a warp min, then a
//     shared-memory min across the 4 lane warps, one __syncthreads), and
//     the block stops at c0 unless some ray is useful: ctn[c0] < bt[i] and
//     not (any-hit and bt[i] < t_lim).  Entry-t ascends along a list, so no
//     later round can improve a closest-hit ray that is not useful.  The
//     TPU checked once, at GROUP (each check serialised its pipeline); here
//     a check is one block reduction, so it is made at every chunk.
__global__ void __launch_bounds__(kBlockThreads, 1)
block_tiles_kernel(const int32_t* __restrict__ cand,
                   const float* __restrict__ ctn,
                   const float* __restrict__ rays,
                   const float* __restrict__ tris,
                   const int32_t* __restrict__ order,
                   float* __restrict__ at_out, int32_t* __restrict__ ar_out,
                   int32_t* __restrict__ stop_out, int maxc, int dummy) {
  constexpr int kLaneWarps = kLanes / 32;
  __shared__ __align__(16) float stile[kStages][kTileFloats];
  __shared__ __align__(16) float sray[kRbShare][8];
  __shared__ int32_t slive[kMaxc];   // cluster id of the k-th live round
  __shared__ int32_t sround[kMaxc];  // and its round index
  __shared__ float sctn[kMaxc];
  __shared__ float swmin[kLaneWarps][kRbShare];  // guard: per-warp minima
  __shared__ int snlive;

  const int b = order[blockIdx.x];
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int ray0 = (tid / kLanes) * kRpt;
  const int wlane = tid & 31;
  for (int i = tid; i < kRbShare * 8; i += kBlockThreads)
    sray[i / 8][i % 8] = rays[(size_t)b * kRbShare * 8 + i];
  for (int i = tid; i < maxc; i += kBlockThreads)
    sctn[i] = ctn[(size_t)b * maxc + i];
  if (tid < 32) {  // warp 0 compacts the live slots, in round order
    int n = 0;
    for (int r0 = 0; r0 < maxc; r0 += 32) {
      const int r = r0 + wlane;
      const int c = r < maxc ? cand[(size_t)b * maxc + r] : dummy;
      const unsigned live = __ballot_sync(0xffffffffu, c != dummy);
      if (c != dummy) {
        const int k = n + __popc(live & ((1u << wlane) - 1u));
        slive[k] = c;
        sround[k] = r;
      }
      n += __popc(live);
    }
    if (wlane == 0) snlive = n;
  }
  __syncthreads();

  const int nlive = snlive;
  float at[kRpt];
  int32_t ar[kRpt];
#pragma unroll
  for (int j = 0; j < kRpt; ++j) {
    at[j] = sray[ray0 + j][6];
    ar[j] = -1;
  }
  int stop = maxc;
  auto fetch = [&](int k, int stage) {
    const float* src = tris + (size_t)slive[k] * kTileFloats;
    for (int i = tid; i < kTilePieces; i += kBlockThreads)
      cp_async16(&stile[stage][4 * i], src + 4 * i);
  };
  if (nlive > 0) fetch(0, 0);
  cp_async_commit();
  int next_c0 = kGroup;
  for (int k = 0, cur = 0; k < nlive; ++k) {
    const int r = sround[k];
    if (r >= next_c0) {
      // the guard at every chunk start c0 <= r (no live round lies
      // between them, so they share one bt)
#pragma unroll
      for (int j = 0; j < kRpt; ++j) {
        float v = at[j];
        for (int off = 16; off > 0; off >>= 1)
          v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
        if (wlane == j) swmin[lane / 32][ray0 + j] = v;
      }
      __syncthreads();
      float bt = swmin[0][wlane];  // every warp evaluates all 32 rays
#pragma unroll
      for (int w = 1; w < kLaneWarps; ++w) bt = fminf(bt, swmin[w][wlane]);
      const bool done = sray[wlane][7] > 0.0f && bt < sray[wlane][6];
      for (; next_c0 <= r; next_c0 += kChunk) {
        if (!__any_sync(0xffffffffu, sctn[next_c0] < bt && !done)) {
          stop = next_c0;
          break;
        }
      }
      if (stop < maxc) break;  // uniform: every warp saw the same rays
    }
    const int nxt = cur + 1 == kStages ? 0 : cur + 1;
    if (k + 1 < nlive) fetch(k + 1, nxt);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's pieces of tile k have landed
    __syncthreads();     // and everyone's; nobody still reads tile k-2
    const srt::Lane L = srt::load_lane(stile[cur], 0, lane);
#pragma unroll
    for (int j = 0; j < kRpt; ++j) {
      const float4 p = reinterpret_cast<const float4*>(sray[ray0 + j])[0];
      const float4 q = reinterpret_cast<const float4*>(sray[ray0 + j])[1];
      const float t = srt::mt8(L, p.x, p.y, p.z, p.w, q.x, q.y, q.z);
      if (t < at[j]) {
        at[j] = t;
        ar[j] = r;
      }
    }
    cur = nxt;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < kRpt; ++j) {
    const size_t o = ((size_t)b * kRbShare + ray0 + j) * kLanes + lane;
    at_out[o] = at[j];
    ar_out[o] = ar[j];
  }
  if (tid == 0) stop_out[b] = stop;
}

// The live-slot count of each list (one warp a list) and their histogram
// hist[0..maxc], which the caller zeroes.
__global__ void __launch_bounds__(256)
list_count_kernel(const int32_t* __restrict__ cand, int32_t* __restrict__ count,
                  int32_t* __restrict__ hist, int nblocks, int maxc,
                  int dummy) {
  const int b = blockIdx.x * 8 + threadIdx.x / 32;
  const int wlane = threadIdx.x & 31;
  if (b >= nblocks) return;  // the whole warp
  int n = 0;
  for (int r0 = 0; r0 < maxc; r0 += 32) {
    const int r = r0 + wlane;
    const bool live = r < maxc && cand[(size_t)b * maxc + r] != dummy;
    n += __popc(__ballot_sync(0xffffffffu, live));
  }
  if (wlane == 0) {
    count[b] = n;
    atomicAdd(&hist[n], 1);
  }
}

// order = the lists by count, descending: a counting sort by one block.
// Within one count the order is the atomics' order, which changes
// nothing in block_tiles' outputs.
__global__ void __launch_bounds__(1024)
longest_first_kernel(const int32_t* __restrict__ count,
                     const int32_t* __restrict__ hist,
                     int32_t* __restrict__ order, int nblocks, int maxc) {
  __shared__ int32_t next[kMaxc + 1];
  for (int n = threadIdx.x; n <= maxc; n += blockDim.x) next[n] = hist[n];
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t start = 0;
    for (int n = maxc; n >= 0; --n) {
      const int32_t h = next[n];
      next[n] = start;
      start += h;
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x)
    order[atomicAdd(&next[count[b]], 1)] = b;
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

// Each launching entry point launches on the caller's stream and returns
// cudaGetLastError() (0 on success); it never synchronises.

// block_tiles, the lists longest first: a memset and two small kernels
// sort them on the card into `scratch` (i32 [2 * nblocks + maxc + 1]),
// then the block kernel runs in that order.
int srt_block_tiles(const void* cand, const void* ctn, const void* rays,
                    const void* tris, void* scratch, void* at, void* ar,
                    void* stop, int nblocks, int maxc, int dummy,
                    void* stream) {
  if (maxc < 1 || maxc > kMaxc) return (int)cudaErrorInvalidValue;
  if (nblocks > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    int32_t* count = (int32_t*)scratch;
    int32_t* order = count + nblocks;
    int32_t* hist = order + nblocks;
    cudaError_t e = cudaMemsetAsync(hist, 0, (maxc + 1) * sizeof(int32_t), s);
    if (e != cudaSuccess) return (int)e;
    list_count_kernel<<<(nblocks + 7) / 8, 256, 0, s>>>(
        (const int32_t*)cand, count, hist, nblocks, maxc, dummy);
    longest_first_kernel<<<1, 1024, 0, s>>>(count, hist, order, nblocks,
                                           maxc);
    block_tiles_kernel<<<nblocks, kBlockThreads, 0, s>>>(
        (const int32_t*)cand, (const float*)ctn, (const float*)rays,
        (const float*)tris, order, (float*)at, (int32_t*)ar, (int32_t*)stop,
        maxc, dummy);
  }
  return (int)cudaGetLastError();
}

// info[0..3] = the block kernel's registers per thread, local (spill)
// bytes per thread, resident blocks per SM, threads per block.
int srt_block_tiles_info(int* info) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, block_tiles_kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, block_tiles_kernel, kBlockThreads, 0);
  if (e != cudaSuccess) return (int)e;
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = blocks;
  info[3] = kBlockThreads;
  return 0;
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
