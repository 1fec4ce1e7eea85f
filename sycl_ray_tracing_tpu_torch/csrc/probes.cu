// Probe kernels for Hopper (sm_90a): the Hopper counterparts of the TPU
// kernels that the list tracer's cost-law probes launch (scratch/*.py),
// bound to PyTorch through a plain C interface loaded with ctypes
// (ops/kernels/probes.py).  No program path calls them; the probe entry
// point (python -m sycl_ray_tracing_tpu_torch.probes) and the card tests do.
//
// Built with -fmad=false like listtrace.cu, so every kernel here is
// bit-identical to its plain torch version.

#include "mt8.cuh"

namespace {

using srt::cp_async16;
using srt::cp_async_commit;
using srt::cp_async_wait;
using srt::kLanes;
using srt::kMaxc;

constexpr int kTileFloats = 9 * kLanes;
constexpr int kTilePieces = kTileFloats / 4;  // 16-byte cp.async pieces
constexpr int kTileBytes = kTileFloats * (int)sizeof(float);
constexpr int kLpt = kLanes / 32;     // lanes a thread holds: wlane + 32 j
constexpr int kSlots = kMaxc / 32;    // list slots a lane holds
constexpr int kMaxShared = 232448;    // the most a block may ask for

// Allow a kernel the dynamic shared memory it takes beyond the 48 KB
// default; fails above the card's limit.
template <typename K>
cudaError_t allow_shared(K kernel, int bytes) {
  if (bytes > kMaxShared) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// info[0..4] = registers per thread, local (spill) bytes per thread,
// resident blocks per SM, threads per block, shared bytes per block.
template <typename K>
int kernel_info(K kernel, int threads, int dyn_bytes, int* info) {
  cudaError_t e = allow_shared(kernel, dyn_bytes);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    dyn_bytes);
  if (e != cudaSuccess) return (int)e;
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = blocks;
  info[3] = threads;
  info[4] = (int)a.sharedSizeBytes + dyn_bytes;
  return 0;
}

// ---------------------------------------------------------------------
// list_tiles_min
//
// Replaces the in-kernel-reduction probe of scratch/kernel_shape_bench.py:
// 83-115 (_list_kernel_impl plus jnp.min over lanes, output (B, 1)): for
// each ray, min(t_lim, min over every (tile, lane) its list names of
// _mt8's t), every live slot, no tail guard.
//
// What bounds it on an H100: FP32 issue by the bound's count (~60
// operations per ray, lane and live round, one issue slot each under
// -fmad=false).  The first version (one 128-thread block per ray, a
// dependent load of each slot's id and then of its tile) re-read each
// ray's 4,608-byte tile in every live round: at 98,304 sorted rays and
// maxc 32, 6.49 GB through L1/L2 a call for 7.4 MB of distinct tiles.
// The design is a union walk, which stages each tile a block needs once:
//  1. A block takes kMinRays = 8 consecutive (sorted) rays, one warp a
//     ray (8 measured faster than 16 and 32 on an H100, PERF.md); a
//     thread holds 4 of the 128 lanes (wlane + 32 j: consecutive threads
//     read consecutive floats) and their running minima in registers.
//  2. The block marks the tiles its rays' lists name in a shared bitset
//     over the K2+1 tile ids (dummy slots unmarked; a tile named twice
//     is marked once) and compacts it into the ascending list of its
//     distinct tiles.
//  3. Each distinct tile is staged once, into a kMinStages-deep
//     shared-memory ring, by one 4,608-byte TMA bulk copy onto the
//     stage's "full" mbarrier, issued as soon as every warp has released
//     the stage ("empty"), by a producer warp of its own.  No
//     __syncthreads in the walk: a
//     warp waits only for its next tile to land, so warps whose lists
//     name few of the block's tiles run up to kMinStages tiles ahead of
//     one that tests many.
//  4. A warp tests a staged tile only if its own ray's list names it: the
//     list is held across the warp's lanes (kSlots slots a lane) and a
//     ballot tests membership.  A tile outside the list is never tested:
//     the lists are cut at maxc, so an unlisted cluster may hold a nearer
//     hit.
//  5. Each ray is reduced once, at the end, with a warp shuffle.
// A float min is exact and independent of order, so walking the tiles in
// union order gives the per-ray walk's bits.
//
// On the card this is slower than the first version (PERF.md): sorted
// neighbours share fewer tiles than hoped (2-3.5 times fewer staged at
// 8-32 rays a block), the tile bytes were not what held the first
// version back, and a block pays a serial prologue (its lists, the
// bitset, the first copy) and lasts as long as its longest list.  A
// cp.async ring with a __syncthreads a tile, per-block balancing of the
// (ray, tile) pairs, and a producer that arrives for the warps that do
// not name a tile all measured slower still and were not kept.
constexpr int kMinRays = 8;  // LIST_MIN_RAYS in ops/kernels/probes.py
constexpr int kMinThreads = (kMinRays + 1) * 32;  // + the producer warp
constexpr int kMinStages = 8;

int min_words(int ntiles) { return (ntiles + 31) / 32; }

// dynamic shared bytes: the ring, the distinct tiles, the bitset
int min_shared_bytes(int maxc, int ntiles) {
  return kMinStages * kTileBytes + 4 * kMinRays * maxc +
         4 * min_words(ntiles);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// One TMA bulk copy global -> shared of `bytes` (a multiple of 16, both
// addresses 16-byte aligned), completing on `bar`, which this thread
// first arms with the bytes to expect.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__global__ void __launch_bounds__(kMinThreads)
list_tiles_min_kernel(const int32_t* __restrict__ cand,
                      const float* __restrict__ rays,
                      const float* __restrict__ tris,
                      float* __restrict__ tmin_out, int nrays, int maxc,
                      int dummy, int nwords) {
  extern __shared__ __align__(16) float ring[];  // [kMinStages][tile]
  int32_t* utile = reinterpret_cast<int32_t*>(ring + kMinStages * kTileFloats);
  unsigned* bits = reinterpret_cast<unsigned*>(utile + kMinRays * maxc);
  __shared__ __align__(8) uint64_t full[kMinStages], empty[kMinStages];
  __shared__ int snu;
  const int tid = threadIdx.x;
  const int wlane = tid & 31;
  const int warp = tid / 32;
  const int row = blockIdx.x * kMinRays + warp;
  const bool real = warp < kMinRays && row < nrays;  // ragged: no list

  if (tid == 0) {
    for (int s = 0; s < kMinStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kMinRays);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int w = tid; w < nwords; w += kMinThreads) bits[w] = 0u;
  int c[kSlots];  // the warp's list: slot wlane + 32 j in c[j]
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int r = wlane + 32 * j;
    c[j] = real && r < maxc ? cand[(size_t)row * maxc + r] : dummy;
  }
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f, tl = 0.f;
  if (real) {
    const float* ray = rays + (size_t)row * 8;
    ox = ray[0], oy = ray[1], oz = ray[2];
    dx = ray[3], dy = ray[4], dz = ray[5], tl = ray[6];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
    if (c[j] != dummy) atomicOr(&bits[c[j] >> 5], 1u << (c[j] & 31));
  __syncthreads();
  if (warp == 0) {  // the bitset -> the distinct tiles, ascending
    int n = 0;
    for (int w0 = 0; w0 < nwords; w0 += 32) {
      unsigned word = w0 + wlane < nwords ? bits[w0 + wlane] : 0u;
      const int cnt = __popc(word);
      int inc = cnt;  // inclusive scan of the counts over the warp
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, inc, off);
        if (wlane >= off) inc += y;
      }
      for (int k = n + inc - cnt; word; word &= word - 1u)
        utile[k++] = (w0 + wlane) * 32 + __ffs(word) - 1;
      n += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (wlane == 0) snu = n;
  }
  __syncthreads();  // the last block-wide barrier
  const int nu = snu;

  if (warp == kMinRays) {  // the producer warp: tile k into its stage
    for (int k = 0; wlane == 0 && k < nu; ++k) {
      const int s = k % kMinStages;
      if (k >= kMinStages)  // every warp is done with tile k - S
        mbar_wait(&empty[s], (k / kMinStages - 1) & 1);
      bulk_copy(ring + s * kTileFloats, tris + (size_t)utile[k] * kTileFloats,
                kTileBytes, &full[s]);
    }
    return;
  }
  float at[kLpt];
#pragma unroll
  for (int j = 0; j < kLpt; ++j) at[j] = tl;
  for (int k = 0; k < nu; ++k) {
    const int s = k % kMinStages;
    const int u = utile[k];
    bool listed = false;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) listed = listed || c[j] == u;
    // every warp waits for every tile, so none releases a stage twice
    // before the producer refills it
    mbar_wait(&full[s], (k / kMinStages) & 1);
    if (__any_sync(0xffffffffu, listed)) {  // uniform over the warp
      const float* tile = ring + s * kTileFloats;
#pragma unroll
      for (int j = 0; j < kLpt; ++j) {
        const float t = srt::mt8(srt::load_lane(tile, 0, wlane + 32 * j), ox,
                                 oy, oz, dx, dy, dz, tl);
        at[j] = t < at[j] ? t : at[j];
      }
    }
    __syncwarp();
    if (wlane == 0) mbar_arrive(&empty[s]);
  }
  float m = at[0];
#pragma unroll
  for (int j = 1; j < kLpt; ++j) m = fminf(m, at[j]);
  m = srt::warp_min(m);
  if (real && wlane == 0) tmin_out[row] = m;
}

// ---------------------------------------------------------------------
// round_probe
//
// Replaces the synthetic-round kernels of scratch/micro_copy.py:19-51
// (variants dyncopy / statcopy / mtonly / dynmt, 8 rays per grid step)
// and scratch/micro_super.py:16-39 (dynmt without the t > EPS test, 1 / 8
// / 32 sub-blocks of 8 rays per grid step).  Per sub-block of kRb = 8 rays
// and per round, the copy variants stage each ray's whole tile (its own
// cand entry, or tile 7) and add its plane 0, lane 0 to the ray's output;
// the MT variants run the probes' synthetic Moller-Trumbore on the staged
// tile (the tile's own planes stand in for the ray) and keep min(out, t)
// over lanes and rounds.  Every output starts at `init`.  At the probes'
// 0 the MT outputs are identically 0 (t > EPS or 1e30; without the EPS
// test t is the same plane offset as u >= 0, so >= 0 up to rounding), on
// the TPU too; at +inf they are the least t over lanes and rounds, which
// the checks hold against the plain version (probes/micro_round.py).
// mtonly reads a staged tile that is zeroed once (the TPU kernel's
// scratch was never written).
//
// What bounds it on an H100: the MT variants by FP32 issue (~46
// operations per ray, lane and round); the copy variants by the tiles
// they stage (4,096 x 8 x 16 x 4,608 B = 2.42 GB through L2 a call),
// although their output reads only plane 0, lane 0 of each.  The first
// version carried the TPU's grid step over block by block: the 8 rays of
// a sub-block in turn in one 128-thread block, 72 scalar loads a thread
// into a shared stack, three __syncthreads and eight 128-lane min
// reductions a round, copy and MT one after the other, and sub-blocks in
// turn (at 32 sub-blocks, 128 blocks of 4 warps on 132 SMs).  The design:
//  1. A warp a ray, a thread holding 4 lanes.  Each warp stages its ray's
//     tiles through its own kRoundStages-deep ring with 16-byte cp.async
//     (2 rounds x 8 tiles x 4,608 B = 73.7 KB a sub-block, dynamic shared
//     memory), so round r+1's tiles are in flight while round r runs; a
//     warp waits on its own copies and a __syncwarp, never on the block.
//  2. The MT variants keep each lane's running min in registers and
//     reduce once per ray, at the end of its sub-block (a warp shuffle):
//     the same bits as a reduction every round, the min being exact.
//  3. A block runs up to kRoundTeams sub-blocks at once (a team of 8 warps
//     each) and walks its `subblocks` sub-blocks as a persistent loop,
//     team t taking sub-blocks t, t + teams, ...; each warp's ring runs
//     on across its sub-block boundaries.  So at 32 sub-blocks a block
//     each of 128 SMs still holds 24 warps.
constexpr int kRb = 8;
constexpr int kRoundStages = 2;
constexpr int kRoundTeams = 3;
constexpr int kStaticTile = 7;
constexpr int kRoundWarpFloats = kRoundStages * kTileFloats;
enum Variant { kDynCopy = 0, kStatCopy = 1, kMtOnly = 2, kDynMt = 3,
               kDynMtNoEps = 4 };

int round_teams(int subblocks) {
  return subblocks < kRoundTeams ? subblocks : kRoundTeams;
}

int round_shared_bytes(int teams) {
  return teams * kRb * kRoundWarpFloats * (int)sizeof(float);
}

template <int V>
__device__ __forceinline__ float synth_mt(const float* __restrict__ tile,
                                          int lane) {
  const float p0 = tile[0 * kLanes + lane], p1 = tile[1 * kLanes + lane],
              p2 = tile[2 * kLanes + lane], p3 = tile[3 * kLanes + lane],
              p4 = tile[4 * kLanes + lane], p5 = tile[5 * kLanes + lane],
              p6 = tile[6 * kLanes + lane], p7 = tile[7 * kLanes + lane],
              p8 = tile[8 * kLanes + lane];
  const float e1x = p3 - p0, e1y = p4 - p1, e1z = p5 - p2;
  const float e2x = p6 - p0, e2y = p7 - p1, e2z = p8 - p2;
  const float hx = e1y * e2z - e1z * e2y;
  const float hy = e1z * e2x - e1x * e2z;
  const float hz = e1x * e2y - e1y * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  const float f = 1.0f / (fabsf(a) < srt::kEps ? 1.0f : a);
  const float u = f * (p0 * hx + p1 * hy + p2 * hz);
  const float v = f * (p3 * hx + p4 * hy + p5 * hz);
  const float t = f * (p6 * hx + p7 * hy + p8 * hz);
  bool ok = u >= 0.0f && v >= 0.0f && u + v <= 1.0f;
  if (V != kDynMtNoEps) ok = ok && t > srt::kEps;
  return ok ? t : 1e30f;
}

template <int V>
__global__ void __launch_bounds__(kRoundTeams * kRb * 32, 1)
round_probe_kernel(const int32_t* __restrict__ cand,
                   const float* __restrict__ tris, float* __restrict__ out,
                   int rounds, int subblocks, float init) {
  constexpr bool kMt = V == kMtOnly || V == kDynMt || V == kDynMtNoEps;
  constexpr bool kCopy = V != kMtOnly;
  extern __shared__ __align__(16) float ring[];  // [warp][stage][tile]
  const int warp = threadIdx.x / 32;
  const int wlane = threadIdx.x & 31;
  const int teams = blockDim.x / (kRb * 32);
  const int team = warp / kRb;
  const int i = warp % kRb;  // the warp's ray within its sub-block
  float* stage = ring + warp * kRoundWarpFloats;
  // the team's sub-blocks team, team + teams, ..., `rounds` steps each
  const int steps = (subblocks - team + teams - 1) / teams * rounds;
  auto row_of = [&](int q) {
    const int s = team + q / rounds * teams;
    return ((size_t)blockIdx.x * subblocks + s) * kRb + i;
  };
  auto fetch = [&](int q) {  // step q's tile into stage q % kRoundStages
    if (kCopy && q < steps) {
      const int k = V == kStatCopy ? kStaticTile
                                   : cand[row_of(q) * rounds + q % rounds];
      const float* src = tris + (size_t)k * kTileFloats;
      float* dst = stage + (q % kRoundStages) * kTileFloats;
      for (int e = wlane; e < kTilePieces; e += 32)
        cp_async16<true>(dst + 4 * e, src + 4 * e);
    }
    cp_async_commit();  // one group a call, empty or not
  };
  if (V == kMtOnly) {
    for (int e = wlane; e < kTileFloats; e += 32) stage[e] = 0.0f;
    __syncwarp();
  }
  for (int q = 0; q < kRoundStages - 1; ++q) fetch(q);
  float m[kLpt];
#pragma unroll
  for (int j = 0; j < kLpt; ++j) m[j] = init;
  float o = init;
  for (int q = 0, r = 0; q < steps; ++q) {
    fetch(q + kRoundStages - 1);  // into step q-1's stage, read by now
    cp_async_wait<kRoundStages - 1>();  // this thread's pieces of step q
    __syncwarp();                       // and the warp's
    const float* tile =
        kCopy ? stage + (q % kRoundStages) * kTileFloats : stage;
    if (kMt) {
#pragma unroll
      for (int j = 0; j < kLpt; ++j)
        m[j] = fminf(m[j], synth_mt<V>(tile, wlane + 32 * j));
    } else {
      o = o + tile[0];
    }
    if (++r == rounds) {  // the end of a sub-block: its ray's output
      r = 0;
      if (kMt) {
        o = m[0];
#pragma unroll
        for (int j = 1; j < kLpt; ++j) o = fminf(o, m[j]);
        o = srt::warp_min(o);
#pragma unroll
        for (int j = 0; j < kLpt; ++j) m[j] = init;
      }
      if (wlane == 0) out[row_of(q)] = o;
      o = init;
    }
    __syncwarp();  // the warp is done with step q's stage
  }
  cp_async_wait<0>();
}

template <int V>
int launch_round_probe(const int32_t* cand, const float* tris, float* out,
                       int grid, int rounds, int subblocks, float init,
                       cudaStream_t s) {
  const int teams = round_teams(subblocks);
  const int bytes = round_shared_bytes(teams);
  const cudaError_t e = allow_shared(round_probe_kernel<V>, bytes);
  if (e != cudaSuccess) return (int)e;
  round_probe_kernel<V><<<grid, teams * kRb * 32, bytes, s>>>(
      cand, tris, out, rounds, subblocks, init);
  return (int)cudaGetLastError();
}

template <int V>
int round_probe_info(int subblocks, int* info) {
  const int teams = round_teams(subblocks);
  return kernel_info(round_probe_kernel<V>, teams * kRb * 32,
                     round_shared_bytes(teams), info);
}

// ---------------------------------------------------------------------
// smoke_gather
//
// Replaces scratch/pallas_smoke.py:30-46: grid step b gathers table row
// cid[b] (a scalar-prefetched index) and writes, for each of its 64 rays,
// rays[:, 0] times the sum over lanes of that row, plus 4 (a 4-trip loop
// whose pl.when branch does nothing).  The lanes are added in order, as
// the plain version adds them: each ray's 128 products form one chain of
// dependent FP32 adds.  That chain is the semantics; a tree is not.
//
// What bounds it on an H100: the launch (a few KB and ~2,000 operations
// a block).  The first version staged the row by scalar loads behind a
// second read of cid[b] and read cid[0..3] for the no-op loop.  The
// design: a block of 64 threads (a thread a ray) a step b.  A thread
// issues its ray's column-0 load first (a 32-byte stride: the script's
// layout); 32 threads read cid[b] once and stage the 512-byte row by one
// 16-byte load each; behind one __syncthreads every thread reads the row
// back 16 bytes at a time (broadcasts) into its 128-step chain.  The loop
// count is the exact 4.0f, so the no-op loop reads nothing.
//
// On the card this takes 1.8-1.9x the empty kernel's device time
// (PERF.md): the ladder's two dependent reads and its 128-add chain,
// which the semantics keep, add up to 1.7x.  Row loads straight from
// global memory into the chain, or into registers first, and one block
// of 512 threads measured slower.
constexpr int kRt = 64;
constexpr int kRowPieces = kLanes / 4;  // 16-byte pieces of a table row
constexpr float kSmokeTrips = 4.0f;

__global__ void __launch_bounds__(kRt)
smoke_gather_kernel(const int32_t* __restrict__ cid,
                    const float* __restrict__ table,
                    const float* __restrict__ rays, float* __restrict__ out) {
  __shared__ float4 row[kRowPieces];
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const float x = rays[((size_t)b * kRt + j) * 8];
  if (j < kRowPieces)
    row[j] = reinterpret_cast<const float4*>(
        table + (size_t)cid[b] * kLanes)[j];
  __syncthreads();
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kRowPieces; ++k) {
    const float4 v = row[k];
    acc = acc + x * v.x;
    acc = acc + x * v.y;
    acc = acc + x * v.z;
    acc = acc + x * v.w;
  }
  out[(size_t)b * kRt + j] = acc + kSmokeTrips;
}

// ---------------------------------------------------------------------
// smoke_rank_select
//
// Replaces scratch/pallas_smoke2.py:24-51: the sum of table[c, 0, :] over
// the columns c of mask [8, 128] that hold any value > 0.5, in ascending
// c.  The TPU kernel ranks the set columns with a triangular matmul
// (cumsum has no Mosaic lowering) and adds one dynamically indexed table
// row a fori_loop step.  Each output lane's adds are one chain of
// dependent FP32 adds, from 0.0f in ascending c, as the plain version adds
// them: that chain is the semantics; a tree or a split accumulator is not.
//
// What bounds it on an H100: the launch and its dependent steps, not
// bytes (4 KB of mask and n rows of 512 bytes in, 512 bytes out: 7.5 ns at
// 3.35 TB/s on the probe's mask).  The first version read the mask in a
// short-circuit loop, ranked by a shuffle scan and read one table entry
// from global memory a step of the sum.  The design leaves one read of
// global memory, two barriers and the n-add chain on the path:
//  1. The 128 output lanes are split over kRankBlocks blocks of 128
//     threads, kRankLanes (one 16-byte slice of a row) a block.  A lane's
//     chain stays in one thread in ascending c, so the bits are the plain
//     version's: no block splits a lane's sum, and each reads all the mask.
//  2. Thread c issues its mask column's 8 loads and the slice of table row
//     c at once: every row the mask may select is read beside the mask, not
//     behind it (a block reads 6 KB; the grid reads the table once).
//  3. A warp's __ballot_sync holds its 32 column flags, the lowest column
//     in the lowest bit; one __syncthreads publishes the four.  Thread c of
//     a set column stores its slice at its rank (the set columns below it),
//     16 bytes apart; a second __syncthreads publishes them.
//  4. kRankLanes threads add the ranked slices in rank order from 0.0f,
//     kRankBatch shared loads ahead of their adds; one store each.
//
// On the card this takes 1.39 us on the probe's mask, 1.68x the empty
// kernel's, and 1.17-1.66 us from no set column to all 128 (PERF.md).
// Slower in development: one block that staged the set rows by cp.async
// (whole rows into one SM) or TMA bulk copies (issued lane by lane),
// ranks by a walk of the set bits per thread, one warp a block, 8-32
// lanes a block, and the slice read after the ranks.
constexpr int kMaskRows = 8;
constexpr int kRankLanes = 4;  // output lanes a block: one 16-byte slice
constexpr int kRankBlocks = kLanes / kRankLanes;
constexpr int kRankBatch = 16;  // ranked slices loaded ahead of their adds

// A 16-byte load issued where it stands.  A coherent load may not cross a
// barrier, so it stays beside the mask's loads; a read-only (.nc) load was
// sunk behind the barrier into the branch that uses its value.
__device__ __forceinline__ float4 load_here(const float* p) {
  float4 v;
  asm volatile("ld.global.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__global__ void __launch_bounds__(kLanes)
smoke_rank_select_kernel(const float* __restrict__ mask,
                         const float* __restrict__ table,
                         float* __restrict__ out) {
  // the slice of the j-th set row at j * kRankLanes
  __shared__ __align__(16) float ranked[kLanes * kRankLanes];
  __shared__ __align__(16) unsigned word[kLanes / 32];
  const int c = threadIdx.x;
  const int w = c / 32, l = c % 32;
  const int lane0 = blockIdx.x * kRankLanes;
  float m[kMaskRows];
#pragma unroll
  for (int i = 0; i < kMaskRows; ++i) m[i] = mask[i * kLanes + c];
  const float4 slice = load_here(table + c * kLanes + lane0);
  bool hit = false;
#pragma unroll
  for (int i = 0; i < kMaskRows; ++i) hit |= m[i] > 0.5f;
  const unsigned bits = __ballot_sync(0xffffffffu, hit);
  if (l == 0) word[w] = bits;
  __syncthreads();
  const uint4 ws = *reinterpret_cast<const uint4*>(word);
  const int p0 = __popc(ws.x), p1 = __popc(ws.y), p2 = __popc(ws.z);
  const int n = p0 + p1 + p2 + __popc(ws.w);
  if (hit) {
    const int below = (w > 0 ? p0 : 0) + (w > 1 ? p1 : 0) +
                      (w > 2 ? p2 : 0) + __popc(bits & ((1u << l) - 1u));
    *reinterpret_cast<float4*>(ranked + below * kRankLanes) = slice;
  }
  __syncthreads();
  if (c >= kRankLanes) return;
  float acc = 0.0f;
#pragma unroll
  for (int j0 = 0; j0 < kLanes; j0 += kRankBatch) {
    if (j0 >= n) break;
    float v[kRankBatch];
#pragma unroll
    for (int k = 0; k < kRankBatch; ++k)
      v[k] = ranked[(j0 + k) * kRankLanes + c];
#pragma unroll
    for (int k = 0; k < kRankBatch; ++k)
      if (j0 + k < n) acc = acc + v[k];
  }
  out[lane0 + c] = acc;
}

// ---------------------------------------------------------------------
// mosaic_probe
//
// Replaces scratch/probe_mosaic.py:19-52, which probed one Mosaic feature
// at a time over x [8, 128]: a data-dependent while loop (ns[0] rounds,
// stopping after the first round whose column max is <= -1), a dynamic
// column x[:, r], a scalar extracted from a computed vector as a
// predicate, and a per-row predicate read from cand at a dynamic round.
//
// What bounds it on an H100: the launch (8 KB in, 4 KB out, a few
// thousand FP32 operations; the rounds are serial by their semantics).
// The first version (a thread a column holding 8 rows, x staged by scalar
// loads, the feature tested at run time) read ns[0] and, with `when`, 8
// words of cand from global memory in every round, inside the round's
// dependent chain.  The design leaves one read of global memory on the
// path and only shared-memory broadcasts in the round loop:
//  1. A thread per 4 lanes of a row (the row is the warp).  Every read of
//     global memory is issued at once: ns[0]; the thread's 16-byte pieces
//     of x (its acc) and of cand, staged into shared memory where ds or
//     `when` read them by round; and, for thread r < 128 where while or
//     extract need it, column r of x.
//  2. Thread r packs what round r decides for the whole block into one
//     word: the column's 8-value max > -1 (the while loop goes on) and
//     the extract predicate col[3] + 1 > 0.  One __syncthreads publishes
//     the words and the staged rows.
//  3. Each round reads its word, the row's `when` entry and (with ds) its
//     column value as broadcasts; the while loop breaks on its word.  The
//     output leaves by one 16-byte store a thread.
// The feature is a template argument, so each of the five kernels holds
// only its own code (one build; the C entry dispatches on the bit mask).
// The per-element arithmetic is the plain version's, in its order.
//
// On the card this takes 1.6x the empty kernel's device time for `all`
// (PERF.md): the ladder's one read alone is 1.2x; the rest is the
// decisions before the barrier and each round's branch on its word.  A
// ballot that finds the stopping round before the loop, decisions read
// inline from shared memory, branch-free rounds, loads hoisted four rounds
// ahead, and the feature as a run-time argument all measured slower.
enum Feature { kWhile = 1, kDs = 2, kExtract = 4, kWhen = 8 };
constexpr int kMosaicRows = 8;
constexpr int kMosaicThreads = kMosaicRows * kLanes / 4;
// a round's word: the while loop goes on; extract adds
constexpr unsigned kGoOn = 1u, kExtractAdds = 2u;

template <int F>
__global__ void __launch_bounds__(kMosaicThreads)
mosaic_probe_kernel(const int32_t* __restrict__ ns,
                    const int32_t* __restrict__ cand,
                    const float* __restrict__ x, float* __restrict__ out) {
  constexpr bool kW = F & kWhile, kD = F & kDs, kE = F & kExtract,
                 kN = F & kWhen;
  __shared__ __align__(16) float sx[kMosaicRows][kLanes];
  __shared__ __align__(16) int32_t sc[kMosaicRows][kLanes];
  __shared__ unsigned word[kLanes];
  const int t = threadIdx.x;
  const int i = t / 32;  // the thread's row; its lanes 4 (t % 32) + 0..3
  const int n = kW ? ns[0] : 4;
  const float4 xv = reinterpret_cast<const float4*>(x)[t];
  if (kD) reinterpret_cast<float4*>(&sx[0][0])[t] = xv;
  if (kN)
    reinterpret_cast<int4*>(&sc[0][0])[t] =
        reinterpret_cast<const int4*>(cand)[t];
  if ((kW || kE) && t < kLanes) {  // round t's decisions
    float col[kMosaicRows];
#pragma unroll
    for (int k = 0; k < kMosaicRows; ++k)
      col[k] = kD ? x[k * kLanes + t] : x[k * kLanes] + (float)t;
    float mx = col[0];
#pragma unroll
    for (int k = 1; k < kMosaicRows; ++k) mx = fmaxf(mx, col[k]);
    word[t] = (mx > -1.0f ? kGoOn : 0u) |
              (col[3] + 1.0f > 0.0f ? kExtractAdds : 0u);
  }
  __syncthreads();
  // without while, 4 rounds; with it, round 0 if ns[0] > 0, then on while
  // r < ns[0] and the last round's max was > -1
  const int rounds = kW ? min(n, kLanes) : 4;
  const float x0 = __shfl_sync(0xffffffffu, xv.x, 0);  // x[i][0]
  float acc[4] = {xv.x, xv.y, xv.z, xv.w};
  float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (int r = 0; r < rounds; ++r) {
    const unsigned w = kW || kE ? word[r] : 0u;
    const float col = kD ? sx[i][r] : x0 + (float)r;
    if (kN && sc[i][r] > 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = acc[j] * 1.0001f;
    }
    if (kE) {
      if (w & kExtractAdds) {
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = o[j] + acc[j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = o[j] + acc[j] + col;
    }
    if (kW && !(w & kGoOn)) break;
  }
  reinterpret_cast<float4*>(out)[t] = make_float4(o[0], o[1], o[2], o[3]);
}

template <int F>
int launch_mosaic_probe(const void* ns, const void* cand, const void* x,
                        void* out, cudaStream_t s) {
  mosaic_probe_kernel<F><<<1, kMosaicThreads, 0, s>>>(
      (const int32_t*)ns, (const int32_t*)cand, (const float*)x,
      (float*)out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// null_launch and the floor's ladder
//
// Measurement references, not ports of TPU kernels, at the smallest
// probe launch (one block of 128 threads).  The empty kernel's device
// time (the profiler's) is the card's floor for one launch; its wrapper's
// host time is the floor of the port's ctypes launch path.  The ladder
// adds, rung by rung, what the smoke kernels cannot leave out: 1, one
// read of global memory (and a store); 2, two dependent reads (an index,
// then the row it names: smoke_gather's gather); 3, one read, then a
// chain of 128 dependent adds (smoke_gather's lane order).
__global__ void __launch_bounds__(kLanes) null_launch_kernel() {}

template <int R>
__global__ void __launch_bounds__(kLanes)
floor_rung_kernel(const int32_t* __restrict__ idx,
                  const float* __restrict__ src, float* __restrict__ out) {
  const int t = threadIdx.x;
  float v = R == 2 ? src[(size_t)idx[0] * kLanes + t] : src[t];
  if (R == 3) {
    const float x = v;
    v = 0.0f;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) v = v + x * (float)l;
  }
  out[t] = v;
}

}  // namespace

extern "C" {

// Each launching entry point launches on the caller's stream and returns
// cudaGetLastError() (0 on success); it never synchronises.
// dummy = K2, the last tile's id.
int srt_list_tiles_min(const void* cand, const void* rays, const void* tris,
                       void* tmin, int nrays, int maxc, int dummy,
                       void* stream) {
  if (maxc < 1 || maxc > kMaxc || dummy < 0)
    return (int)cudaErrorInvalidValue;
  if (nrays < 1) return (int)cudaGetLastError();
  const int ntiles = dummy + 1;
  const int bytes = min_shared_bytes(maxc, ntiles);
  const cudaError_t e = allow_shared(list_tiles_min_kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  const int grid = (nrays + kMinRays - 1) / kMinRays;
  list_tiles_min_kernel<<<grid, kMinThreads, bytes, (cudaStream_t)stream>>>(
      (const int32_t*)cand, (const float*)rays, (const float*)tris,
      (float*)tmin, nrays, maxc, dummy, min_words(ntiles));
  return (int)cudaGetLastError();
}

// info[0..4] as kernel_info, for lists of maxc slots over ntiles tiles.
int srt_list_tiles_min_info(int maxc, int ntiles, int* info) {
  if (maxc < 1 || maxc > kMaxc || ntiles < 1)
    return (int)cudaErrorInvalidValue;
  return kernel_info(list_tiles_min_kernel, kMinThreads,
                     min_shared_bytes(maxc, ntiles), info);
}

// variant: 0 dyncopy, 1 statcopy, 2 mtonly, 3 dynmt, 4 dynmt without the
// t > EPS test; rows = grid * subblocks * 8; every output starts at init.
int srt_round_probe(const void* cand, const void* tris, void* out, int grid,
                    int rounds, int subblocks, int variant, float init,
                    void* stream) {
  if (grid < 0 || rounds < 1 || subblocks < 1)
    return (int)cudaErrorInvalidValue;
  if (grid == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* c = (const int32_t*)cand;
  const float* t = (const float*)tris;
  float* o = (float*)out;
  switch (variant) {
    case kDynCopy:
      return launch_round_probe<kDynCopy>(c, t, o, grid, rounds, subblocks,
                                          init, s);
    case kStatCopy:
      return launch_round_probe<kStatCopy>(c, t, o, grid, rounds, subblocks,
                                           init, s);
    case kMtOnly:
      return launch_round_probe<kMtOnly>(c, t, o, grid, rounds, subblocks,
                                         init, s);
    case kDynMt:
      return launch_round_probe<kDynMt>(c, t, o, grid, rounds, subblocks,
                                        init, s);
    case kDynMtNoEps:
      return launch_round_probe<kDynMtNoEps>(c, t, o, grid, rounds,
                                             subblocks, init, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// info[0..4] as kernel_info, for the variant at `subblocks` sub-blocks a
// block.
int srt_round_probe_info(int variant, int subblocks, int* info) {
  if (subblocks < 1) return (int)cudaErrorInvalidValue;
  switch (variant) {
    case kDynCopy:
      return round_probe_info<kDynCopy>(subblocks, info);
    case kStatCopy:
      return round_probe_info<kStatCopy>(subblocks, info);
    case kMtOnly:
      return round_probe_info<kMtOnly>(subblocks, info);
    case kDynMt:
      return round_probe_info<kDynMt>(subblocks, info);
    case kDynMtNoEps:
      return round_probe_info<kDynMtNoEps>(subblocks, info);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// table 16-byte aligned.
int srt_smoke_gather(const void* cid, const void* table, const void* rays,
                     void* out, int nb, void* stream) {
  // the TPU kernel's loop reads cid[0:4]
  if (nb < 4) return (int)cudaErrorInvalidValue;
  smoke_gather_kernel<<<nb, kRt, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cid, (const float*)table, (const float*)rays,
      (float*)out);
  return (int)cudaGetLastError();
}

// table 16-byte aligned.
int srt_smoke_rank_select(const void* mask, const void* table, void* out,
                          void* stream) {
  smoke_rank_select_kernel<<<kRankBlocks, kLanes, 0, (cudaStream_t)stream>>>(
      (const float*)mask, (const float*)table, (float*)out);
  return (int)cudaGetLastError();
}

// feat: bit mask of 1 while, 2 ds, 4 extract, 8 when (one of the five
// features probe_mosaic.py names: while, ds, extract, when, all); cand,
// x and the output 16-byte aligned.
int srt_mosaic_probe(const void* ns, const void* cand, const void* x,
                     void* out, int feat, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (feat) {
    case kWhile:
      return launch_mosaic_probe<kWhile>(ns, cand, x, out, s);
    case kDs:
      return launch_mosaic_probe<kDs>(ns, cand, x, out, s);
    case kExtract:
      return launch_mosaic_probe<kExtract>(ns, cand, x, out, s);
    case kWhen:
      return launch_mosaic_probe<kWhen>(ns, cand, x, out, s);
    case kWhile | kDs | kExtract | kWhen:
      return launch_mosaic_probe<kWhile | kDs | kExtract | kWhen>(
          ns, cand, x, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The empty kernel at <<<1, 128>>>.
int srt_null_launch(void* stream) {
  null_launch_kernel<<<1, kLanes, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// Rung 1-3 of the floor's ladder at <<<1, 128>>>: idx[0] names a row of
// src [rows, 128]; out [128].
int srt_floor_rung(int rung, const void* idx, const void* src, void* out,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* i = (const int32_t*)idx;
  const float* v = (const float*)src;
  float* o = (float*)out;
  switch (rung) {
    case 1:
      floor_rung_kernel<1><<<1, kLanes, 0, s>>>(i, v, o);
      break;
    case 2:
      floor_rung_kernel<2><<<1, kLanes, 0, s>>>(i, v, o);
      break;
    case 3:
      floor_rung_kernel<3><<<1, kLanes, 0, s>>>(i, v, o);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
