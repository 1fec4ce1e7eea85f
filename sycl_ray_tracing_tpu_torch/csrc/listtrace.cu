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
//   cand  i32 [lists, maxc]   cluster id per round; the dummy id K2 marks
//                             an empty slot
//   ctn   f32 [lists, maxc]   entry-t per slot, ascending along a list
//   rays  f32 [rays, 8]       o3 d3 t_lim anyhit_flag
//   tris  f32 [K2+1, 9, 128]  planar tiles (ax ay az bx .. cz); row K2 is
//                             the all-zero dummy
// A list is a block of 32 rays' shared list (block kernel) or one ray's
// own (per-ray kernel).
// Outputs
//   at    f32 [rays, 128], ar i32 [rays, 128]
//   stop  i32 [lists]         first round a list did not run (maxc if its
//                             guard never fired)
//
// Arithmetic: mt8.cuh, built with -fmad=false (bit-identical to the plain
// torch versions).  Tensor cores do not apply: the work is FP32 cross
// products, a reciprocal and compares per (ray, triangle), not a matrix
// product, and TF32 would break the bit-identity.
//
// Round skipping: both kernels skip rounds whose candidate is the dummy id
// K2 (its zero tile makes every ray parallel, so such a round never
// updates anything), and both run the TPU kernel's tail guard: rounds
// 0..GROUP-1 always run; before each chunk start c0 = GROUP + k*CHUNK
// below the list's count, bt = min over lanes of at, and the list stops
// at c0 unless a ray of it is useful: ctn[c0] < bt and not (any-hit and
// bt < t_lim).  Entry-t ascends along a list, so no later round can
// improve a closest-hit ray that is not useful.  The TPU checked once, at
// GROUP (each check serialised its pipeline); here each check is one
// reduction, so it is made at every chunk start.

#include "mt8.cuh"

namespace {

using srt::cp_async16;
using srt::cp_async_commit;
using srt::cp_async_wait;
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
constexpr int kListGroups = 4;   // per-ray kernel: warp groups of 128 lanes
constexpr int kListThreads = kListGroups * kLanes;        // 512
constexpr int kListAhead = 2;    // live rounds a group fetches ahead
constexpr int kListStages = kListAhead + 1;  // tiles in a group's ring
constexpr int kMaxChecks = (kMaxc - kGroup + kChunk - 1) / kChunk;  // 8
constexpr int kListRingBytes =
    kListGroups * kListStages * kTileFloats * (int)sizeof(float);  // 55 KB

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One warp compacts a list's live (non-dummy) slots, in round order: the
// k-th live slot's cluster id into live[k] and its round into rounds[k].
// Returns their count, in every lane.
__device__ __forceinline__ int compact_list(const int32_t* __restrict__ crow,
                                            int maxc, int dummy,
                                            int32_t* live, int32_t* rounds) {
  const int wlane = threadIdx.x & 31;
  int n = 0;
  for (int r0 = 0; r0 < maxc; r0 += 32) {
    const int r = r0 + wlane;
    const int c = r < maxc ? crow[r] : dummy;
    const unsigned on = __ballot_sync(0xffffffffu, c != dummy);
    if (c != dummy) {
      const int k = n + __popc(on & ((1u << wlane) - 1u));
      live[k] = c;
      rounds[k] = r;
    }
    n += __popc(on);
  }
  return n;
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
//  4. The tail guard of the TPU kernel (see the top of this file), with
//     bt[i] for each of the 32 rays: a warp min, then a shared-memory min
//     across the 4 lane warps, one __syncthreads; the block stops when
//     none of its rays is useful.
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
    const int n = compact_list(cand + (size_t)b * maxc, maxc, dummy, slive,
                               sround);
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
        const float v = srt::warp_min(at[j]);
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

// Replaces _list_kernel_impl (sycl_ray_tracing_tpu/ops/pallas/
// listtrace.py:245-295) with its _tail_guard (:197-242): each ray walks its
// OWN list.  A CUDA block of 512 threads (4 warp groups of 128 lanes)
// holds kRays rays; kRays = 1 on the main path (the escalation pass), 8 /
// 16 / 32 (the TPU kernel's RB) for the probes.  Outputs do not depend on
// kRays.
//
// What bounds it on an H100: latency, not FP32 issue.  The escalation
// launch is a few hundred rays, one block each on 132 SMs, with lists of
// up to 128 rounds; a round is 128 lanes x ~60 operations, so a warp
// group computes one in well under the ~600 cycles of an L2 tile load,
// and the first version (one 128-thread block per ray walking every slot,
// with a dependent load of the slot's id and then of the lane's tile
// data) took ~700 cycles a slot.  What the design does about it:
//  1. One read of the list.  The team's first warp compacts the ray's
//     live (non-dummy) slots into shared memory with a ballot, and stages
//     the ray and the entry-t of each chunk start; no round waits on a
//     load of its id.
//  2. A ray's rounds split across warp groups.  With one ray per block
//     the 4 groups (a "team") take its live rounds in turn (group g the
//     k-th with k % 4 == g), so a list of 128 live rounds is 32 rounds
//     deep per group.  Each group keeps its lanes' (t, round) with a
//     strict '<' over its own rounds, in order; at the end the groups'
//     pairs are merged by least t, then least round, which is the
//     in-order walk's answer bit for bit (the earliest round wins a tie).
//     With 8 or more rays per block each group is a team of its own and
//     walks kRays / 4 rays one after another.
//  3. Tiles staged ahead.  Each group fetches its next kListAhead = 2
//     live rounds' tiles into its own 3-stage shared-memory ring with
//     cp.async (16 B a thread), so a round's tile was asked for two of the
//     group's rounds earlier; one 128-thread named barrier a round.  The
//     copies go through L1 (.ca): sorted neighbouring rays name the same
//     tiles, and at 98,304 rays the L2-only path (.cg) took 1.5x as long.
//     Fetching 4 rounds ahead, or running the fetches on from one ray of
//     a group into the next, measured no faster (PERF.md).
//  4. The tail guard, per ray.  bt only needs the least t over the team's
//     lanes, which is the merge's t (min is associative), so a check is a
//     warp min and one team barrier; every group arrives at the check for
//     c0 only after its live rounds below c0 (its rounds are in order), so
//     all see the serial walk's bt and stop at the same c0.  The check is
//     per ray (the TPU gated its 8-ray block on "any ray useful"), so the
//     outputs do not depend on kRays.
// The ring is 55 KB of dynamic shared memory.  At 40 registers three
// blocks fit an SM but ptxas spilled; at up to 64, two blocks (32 warps)
// run per SM with no spill, and measured faster (PERF.md).
//
// At 98,304 rays with ~10 rounds each (the probes) the first version, 16
// blocks of 4 warps per SM with no barrier, was faster: there many rays
// hide the latency, and the per-ray compaction, barriers and merge of
// this design cost more than they save (PERF.md).
template <int kRays>
__global__ void __launch_bounds__(kListThreads, 2)
list_tiles_kernel(const int32_t* __restrict__ cand,
                  const float* __restrict__ ctn,
                  const float* __restrict__ rays,
                  const float* __restrict__ tris, float* __restrict__ at_out,
                  int32_t* __restrict__ ar_out, int32_t* __restrict__ stop_out,
                  int nrays, int maxc, int dummy) {
  static_assert(kRays == 1 || kRays % kListGroups == 0, "rays per block");
  constexpr int kSplit = kRays == 1 ? kListGroups : 1;  // groups per ray
  constexpr int kTeams = kListGroups / kSplit;          // rays at once
  constexpr int kTeamThreads = kSplit * kLanes;
  constexpr int kTeamWarps = kTeamThreads / 32;
  extern __shared__ __align__(16) float ring[];  // [group][stage][tile]
  __shared__ int32_t slive[kTeams][kMaxc];   // cluster id of the k-th live round
  __shared__ int32_t sround[kTeams][kMaxc];  // and its round index
  __shared__ __align__(16) float sray[kTeams][8];
  __shared__ float sck[kTeams][kMaxChecks];  // entry-t at each chunk start
  __shared__ float swmin[2][kTeams][kTeamWarps];  // guard: per-warp minima
  __shared__ float smt[kSplit][kLanes];      // merge: the groups' (t, round)
  __shared__ int32_t smr[kSplit][kLanes];
  __shared__ int snlive[kTeams];

  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int group = tid / kLanes;
  const int team = group / kSplit;
  const int sub = group % kSplit;  // the group takes live rounds k % kSplit == sub
  const int ttid = tid % kTeamThreads;
  const int wlane = tid & 31;
  float* stile = ring + group * kListStages * kTileFloats;
  auto group_sync = [&] { bar_sync(1 + group, kLanes); };
  auto team_sync = [&] {
    if (kSplit == 1)
      group_sync();
    else
      __syncthreads();
  };
  const int32_t* live = slive[team];
  const int32_t* rounds = sround[team];
  const float* ray = sray[team];

  for (int j = team; j < kRays; j += kTeams) {
    const int row = blockIdx.x * kRays + j;
    if (row >= nrays) break;  // the ragged last block; uniform over the team
    if (ttid < 32) {  // the team's first warp compacts the list, in order
      const int n = compact_list(cand + (size_t)row * maxc, maxc, dummy,
                                 slive[team], sround[team]);
      if (wlane == 0) snlive[team] = n;
      if (wlane < 8) sray[team][wlane] = rays[(size_t)row * 8 + wlane];
      if (wlane < kMaxChecks && kGroup + wlane * kChunk < maxc)
        sck[team][wlane] = ctn[(size_t)row * maxc + kGroup + wlane * kChunk];
    }
    team_sync();

    const int nlive = snlive[team];
    const int count = nlive > 0 ? rounds[nlive - 1] + 1 : 0;
    float at = ray[6];
    int32_t ar = -1;
    int stop = maxc;
    auto fetch = [&](int i) {  // the group's i-th live round into its ring
      const int k = sub + i * kSplit;
      if (k < nlive) {
        const float* src = tris + (size_t)live[k] * kTileFloats;
        float* dst = stile + (i % kListStages) * kTileFloats;
        for (int e = lane; e < kTilePieces; e += kLanes)
          cp_async16<true>(dst + 4 * e, src + 4 * e);
      }
      cp_async_commit();  // one group a call, empty or not
    };
    for (int i = 0; i < kListAhead; ++i) fetch(i);
    int next_c0 = kGroup;
    for (int i = 0;; ++i) {
      const int k = sub + i * kSplit;
      const int r = k < nlive ? rounds[k] : count;
      // the guard at each chunk start c0 <= r below the count: the whole
      // team has run its live rounds below c0, so every group sees one bt
      for (; next_c0 <= r && next_c0 < count; next_c0 += kChunk) {
        // consecutive checks of a ray write alternate halves of swmin,
        // so one barrier a check suffices
        const int check = (next_c0 - kGroup) / kChunk;
        const float v = srt::warp_min(at);
        if (wlane == 0) swmin[check & 1][team][ttid / 32] = v;
        team_sync();
        float bt = swmin[check & 1][team][0];
#pragma unroll
        for (int w = 1; w < kTeamWarps; ++w)
          bt = fminf(bt, swmin[check & 1][team][w]);
        const bool done = ray[7] > 0.0f && bt < ray[6];
        if (!(sck[team][check] < bt) || done) {
          stop = next_c0;
          break;
        }
      }
      if (stop < maxc || k >= nlive) break;
      cp_async_wait<kListAhead - 1>();  // this thread's pieces of round i
      group_sync();  // everyone's; nobody still reads round i-1's stage
      fetch(i + kListAhead);            // into round i-1's stage
      const srt::Lane L =
          srt::load_lane(stile + (i % kListStages) * kTileFloats, 0, lane);
      const float4 p = reinterpret_cast<const float4*>(ray)[0];
      const float4 q = reinterpret_cast<const float4*>(ray)[1];
      const float t = srt::mt8(L, p.x, p.y, p.z, p.w, q.x, q.y, q.z);
      if (t < at) {
        at = t;
        ar = r;
      }
    }
    cp_async_wait<0>();

    if (kSplit > 1) {  // merge: least t, then least round
      if (sub > 0) {
        smt[sub][lane] = at;
        smr[sub][lane] = ar;
      }
      team_sync();
    }
    if (sub == 0) {
#pragma unroll
      for (int g = 1; g < kSplit; ++g) {
        const float t = smt[g][lane];
        const int32_t r = smr[g][lane];
        if (t < at || (t == at && r < ar)) {
          at = t;
          ar = r;
        }
      }
      at_out[(size_t)row * kLanes + lane] = at;
      ar_out[(size_t)row * kLanes + lane] = ar;
      if (lane == 0) stop_out[row] = stop;
    }
    // the next ray reuses the team's list, ring and guard minima (its
    // first check writes swmin[0] again)
    team_sync();
  }
}

// The per-ray kernel's instance for kRays rays per block, its ring's
// shared memory allowed once (above the 48 KB default).
template <int kRays>
cudaError_t list_tiles_prepare() {
  static const cudaError_t e = cudaFuncSetAttribute(
      list_tiles_kernel<kRays>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kListRingBytes);
  return e;
}

template <int kRays>
int launch_list_tiles(const void* cand, const void* ctn, const void* rays,
                      const void* tris, void* at, void* ar, void* stop,
                      int nrays, int maxc, int dummy, cudaStream_t stream) {
  cudaError_t e = list_tiles_prepare<kRays>();
  if (e != cudaSuccess) return (int)e;
  const int grid = (nrays + kRays - 1) / kRays;
  list_tiles_kernel<kRays><<<grid, kListThreads, kListRingBytes, stream>>>(
      (const int32_t*)cand, (const float*)ctn, (const float*)rays,
      (const float*)tris, (float*)at, (int32_t*)ar, (int32_t*)stop, nrays,
      maxc, dummy);
  return (int)cudaGetLastError();
}

template <int kRays>
int list_tiles_info(int* info) {
  cudaError_t e = list_tiles_prepare<kRays>();
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, list_tiles_kernel<kRays>);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, list_tiles_kernel<kRays>, kListThreads, kListRingBytes);
  if (e != cudaSuccess) return (int)e;
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = blocks;
  info[3] = kListThreads;
  info[4] = (int)a.sharedSizeBytes + kListRingBytes;
  return 0;
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

// info[0..4] = the block kernel's registers per thread, local (spill)
// bytes per thread, resident blocks per SM, threads per block, shared
// bytes per block.
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
  info[4] = (int)a.sharedSizeBytes;
  return 0;
}

// list_tiles with rays_per_block in {1, 8, 16, 32} rays per CUDA block.
int srt_list_tiles(const void* cand, const void* ctn, const void* rays,
                   const void* tris, void* at, void* ar, void* stop,
                   int nrays, int maxc, int dummy, int rays_per_block,
                   void* stream) {
  if (maxc < 1 || maxc > kMaxc) return (int)cudaErrorInvalidValue;
  if (nrays < 1) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (rays_per_block) {
    case 1:
      return launch_list_tiles<1>(cand, ctn, rays, tris, at, ar, stop, nrays,
                                  maxc, dummy, s);
    case 8:
      return launch_list_tiles<8>(cand, ctn, rays, tris, at, ar, stop, nrays,
                                  maxc, dummy, s);
    case 16:
      return launch_list_tiles<16>(cand, ctn, rays, tris, at, ar, stop,
                                   nrays, maxc, dummy, s);
    case 32:
      return launch_list_tiles<32>(cand, ctn, rays, tris, at, ar, stop,
                                   nrays, maxc, dummy, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// info[0..4] = the per-ray kernel's instance for rays_per_block: registers
// per thread, local (spill) bytes per thread, resident blocks per SM,
// threads per block, shared bytes per block (static + the ring).
int srt_list_tiles_info(int rays_per_block, int* info) {
  switch (rays_per_block) {
    case 1:
      return list_tiles_info<1>(info);
    case 8:
      return list_tiles_info<8>(info);
    case 16:
      return list_tiles_info<16>(info);
    case 32:
      return list_tiles_info<32>(info);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
