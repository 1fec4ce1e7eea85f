// The supercluster candidate build for Hopper (sm_90a), fused into one
// kernel, bound to PyTorch through a plain C interface loaded with ctypes
// (ops/cluster.py candidate_clusters_hier; built into one library with
// listtrace.cu by ops/kernels/cuda_lib.py).
//
// It replaces no TPU kernel: the JAX package builds the lists in plain XLA
// (sycl_ray_tracing_tpu/ops/cluster.py:784-919), and the port's plain
// version, _hier_rows (ops/cluster.py), chains ~130 torch launches a row
// chunk that write every [rays, maxs * 64] intermediate of the slab test,
// the key packing, the sort and the certificate to device memory.  The
// kernel computes what candidate_clusters_hier(grouped=True) returns, bit
// for bit: per block of `group` rays the list (cand, ctn), the overflow
// flag and, with ray_cert, the per-ray membership certificate.
//
// Inputs
//   sc_box      f32 [K1, 8]        supercluster boxes (min3 max3 0 0)
//   cl_box_rows f32 [K1, 8 * 64]   each supercluster's 64 child boxes,
//                                  planar (min x * 64 | min y * 64 | ...)
//   ray_o, ray_d f32 [rays, 3], t_lim f32 [rays], each with a row stride
// Outputs
//   cand i32 [blocks, maxc], ctn f32 [blocks, maxc], covered u8 [rays]
//   (optional), flag u8 [blocks] (the block's SC overflow or full row)
//
// What bounds it on an H100: FP32 issue.  A block tests its 32 rays
// against K1 <= 128 supercluster boxes and then against the <= maxs * 64
// child boxes of the superclusters it keeps (2,688 at maxs 42), ~25
// operations a (ray, box); every other step is integer work on <= 2,688
// keys in shared memory.  The bytes are few: the rays, the kept
// superclusters' child rows (2 KB each, L2-resident) and the lists.
// The design, one CTA of 256 threads a block of rays:
//  1. Rays to shared memory, with 1/d formed as inv_dir forms it.  A
//     thread takes a supercluster box and loops over the rays: the block
//     union of hits and the block minimum of clamp_min(tnear, 0) give its
//     threshold-min key; a rank count over <= 128 keys keeps the maxs
//     least (keys are unique: the id is in their low bits).
//  2. A thread takes a child column, holds its six planes in registers and
//     loops over the rays: the union, the minimum entry-t and the bit mask
//     of the rays that hit it; one packed key and one mask a column go to
//     shared memory (<= 21.5 KB at maxs 42).  Columns of superclusters the
//     block did not keep are never tested.
//  3. The maxc least keys: a radix select of the maxc-th key (8 bits a
//     pass, a shared histogram, warp-aggregated atomics), the keys at or
//     below it compacted, then sorted by a rank count over <= 128 keys.
//     Local ids map to global cluster ids through the kept superclusters.
//  4. The certificate: the OR of the masks of the hit columns whose key
//     lies above the last kept key gives the rays that hit a dropped
//     column; no slab test is run again.
// Nothing per ray or per column reaches device memory.
//
// Arithmetic: each (plane - o) * inv one IEEE sub and one mul (built with
// -fmad=false, like listtrace.cu); fminf / fmaxf equal torch.minimum /
// maximum wherever no operand is NaN, and a ray with a non-finite origin
// or direction (the only way to a NaN product: the planes are finite and
// 1/d is finite and non-zero for a finite d) takes torch's rule, under
// which a NaN fails every compare.  Keys are pack_keys': entry-t clipped,
// its sign bit cleared, its low id bits replaced by the column id.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mt8.cuh"

namespace {

constexpr int kThreads = 256;       // 8 warps; also the radix histogram's bins
constexpr int kMaxGroup = 32;       // rays a block: one bit of a ray mask each
constexpr int kMaxK1 = 128;         // superclusters (MAX_CLUSTERS / 64)
constexpr int kMaxSlots = 128;      // maxs and maxc
constexpr int kS = 64;              // clusters a supercluster (S_CLUSTER)
constexpr int kRowFloats = 8 * kS;  // a supercluster's planar child row
constexpr int kMaxCols = kMaxK1 * kS;
constexpr int kMaxDynBytes = kMaxCols * 8;  // a key and a mask a column
constexpr int32_t kDead = 0x7F800000;  // +inf bits: above every live key
constexpr float kTMax = 1e30f;      // pack_keys' clip of the exact keys
constexpr float kInvFloor = 1e-30f;  // inv_dir's floor on |d|
static_assert(kThreads >= kMaxK1 && kThreads >= kMaxSlots,
              "a thread a supercluster and a kept key");
static_assert(kThreads == 256, "the radix histogram has a bin a thread");

// NaN and finiteness by compares (kept under -O3: no fast-math)
__device__ __forceinline__ bool is_nan(float x) { return x != x; }
__device__ __forceinline__ bool is_finite(float x) {
  return fabsf(x) <= 3.402823466e38f;
}

struct Ray {
  float4 p;  // o x, y, z, t_lim
  float4 q;  // 1/d x, y, z
};

// inv_dir on one axis as torch forms it: sign / clamp_min(|d|, 1e-30),
// where clamp_min passes a NaN through and the division is IEEE.
__device__ __forceinline__ float inv_axis(float d) {
  const float a = fabsf(d);
  const float m = is_nan(a) ? a : fmaxf(a, kInvFloor);
  return (d < 0.0f ? -1.0f : 1.0f) / m;
}

// _slab_test on one (box, ray).  kNanRule: the ray may give a NaN
// product, and then, as under torch's NaN-passing min / max, it misses.
template <bool kNanRule>
__device__ __forceinline__ bool slab(const float (&b)[6], const Ray& r,
                                     float& tnear) {
  const float x0 = (b[0] - r.p.x) * r.q.x;
  const float y0 = (b[1] - r.p.y) * r.q.y;
  const float z0 = (b[2] - r.p.z) * r.q.z;
  const float x1 = (b[3] - r.p.x) * r.q.x;
  const float y1 = (b[4] - r.p.y) * r.q.y;
  const float z1 = (b[5] - r.p.z) * r.q.z;
  tnear = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1));
  const float tfar = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)),
                           fmaxf(z0, z1));
  bool hit = tnear <= tfar && tfar > srt::kEps && tnear < r.p.w;
  if (kNanRule && hit)
    hit = !(is_nan(x0) || is_nan(y0) || is_nan(z0) || is_nan(x1) ||
            is_nan(y1) || is_nan(z1));
  return hit;
}

// One box against the block's rays: the mask of the rays that hit it and
// the least clamp_min(tnear, 0) over them (BIG_T if none), as the torch
// version's where(hit, clamp_min(tnear, 0), BIG_T).amin over the block.
// A NaN rule applies to the rays whose bit of `safe` is clear.
template <bool kNanRule>
__device__ __forceinline__ uint32_t test_box(const float (&b)[6],
                                             const Ray* rays, int group,
                                             uint32_t safe, float& tmin) {
  uint32_t mask = 0;
  float acc = srt::kBigT;
  for (int r = 0; r < group; ++r) {
    const Ray ray = rays[r];
    float tn;
    const bool hit = (kNanRule && !((safe >> r) & 1u))
                         ? slab<true>(b, ray, tn)
                         : slab<false>(b, ray, tn);
    if (hit) {
      mask |= 1u << r;
      acc = fminf(acc, fmaxf(tn, 0.0f));
    }
  }
  tmin = acc;
  return mask;
}

// pack_keys on a block-minimum entry-t t >= 0 (or -0.0): t clipped at
// t_max, its sign bit cleared, the low id bits replaced by `id`.
__device__ __forceinline__ int32_t pack_key(float t, float t_max,
                                            int32_t id_mask, int32_t id) {
  return ((__float_as_int(fminf(t, t_max)) & 0x7FFFFFFF) & ~id_mask) | id;
}

// The key of rank k (from 0) among the live keys (< kDead) of keys[0, n):
// an MSB radix select, 8 bits a pass, each pass a shared histogram of the
// live keys that share the digits found so far.  Keys are unique, so the
// last pass leaves exactly one key.  Every thread of the block calls it.
__device__ int32_t radix_select(const int32_t* keys, int n, int k,
                                int32_t* hist, int32_t* found) {
  const int tid = threadIdx.x;
  const int wlane = tid & 31;
  uint32_t prefix = 0, pmask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    hist[tid] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += kThreads) {  // whole warps
      const int l = base + tid;
      const uint32_t key = l < n ? (uint32_t)keys[l] : (uint32_t)kDead;
      const bool in = key < (uint32_t)kDead && (key & pmask) == prefix;
      const int bin = in ? (int)((key >> shift) & 255u) : 256;
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      if (in && wlane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
    }
    __syncthreads();
    if (tid < 32) {  // the bin holding rank k: a warp scan of 8 bins a lane
      int c[8];
      int s = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i] = hist[8 * tid + i];
        s += c[i];
      }
      int incl = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, off);
        if (wlane >= off) incl += v;
      }
      int below = incl - s;
      if (k >= below && k < incl) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (k < below + c[i]) {
            found[0] = 8 * tid + i;
            found[1] = below;
            break;
          }
          below += c[i];
        }
      }
    }
    __syncthreads();
    prefix |= (uint32_t)found[0] << shift;
    pmask |= 255u << shift;
    k -= found[1];
  }
  return (int32_t)prefix;
}

__global__ void __launch_bounds__(kThreads, 4)
hier_build_kernel(const float* __restrict__ sc_box,
                  const float* __restrict__ cl_box_rows,
                  const float* __restrict__ ray_o, int o_stride,
                  const float* __restrict__ ray_d, int d_stride,
                  const float* __restrict__ t_lim, int t_stride,
                  int32_t* __restrict__ cand_out, float* __restrict__ ctn_out,
                  uint8_t* __restrict__ covered_out,
                  uint8_t* __restrict__ flag_out, int k1, int maxs, int maxc,
                  int group, int exact, int sc_id_bits, int id_bits) {
  extern __shared__ __align__(16) int32_t dyn[];  // key[cols], mask[cols]
  __shared__ Ray sray[kMaxGroup];
  __shared__ int32_t sckey[kMaxK1];     // supercluster keys
  __shared__ int32_t sscand[kMaxSlots];  // kept superclusters, nearest first
  __shared__ int32_t shist[kThreads];
  __shared__ int32_t skept[kMaxSlots];   // the kept keys, in any order
  __shared__ int32_t ssorted[kMaxSlots];  // and sorted
  __shared__ int32_t sfound[2];
  __shared__ uint32_t s_safe, s_drop;
  __shared__ int32_t s_ncol, s_nkept;

  const int tid = threadIdx.x;
  const int wlane = tid & 31;
  const int b = blockIdx.x;
  const int cols = min(maxs, k1) * kS;
  int32_t* skey = dyn;
  uint32_t* smask = reinterpret_cast<uint32_t*>(dyn + cols);

  // the rays, 1/d and which of them cannot give a NaN product
  bool safe = false;
  if (tid < group) {
    const size_t r = (size_t)b * group + tid;
    const float* o = ray_o + r * o_stride;
    const float* d = ray_d + r * d_stride;
    sray[tid].p = make_float4(o[0], o[1], o[2], t_lim[r * t_stride]);
    sray[tid].q = make_float4(inv_axis(d[0]), inv_axis(d[1]),
                              inv_axis(d[2]), 0.0f);
    safe = is_finite(o[0]) && is_finite(o[1]) && is_finite(o[2]) &&
           is_finite(d[0]) && is_finite(d[1]) && is_finite(d[2]);
  }
  if (tid < 32) {
    const uint32_t s = __ballot_sync(0xffffffffu, safe);
    if (tid == 0) {
      s_safe = s;
      s_drop = 0;
      s_ncol = 0;
      s_nkept = 0;
    }
  }
  __syncthreads();
  const uint32_t safe_mask = s_safe;
  const uint32_t all = group == 32 ? 0xffffffffu : (1u << group) - 1u;
  const bool all_safe = safe_mask == all;

  // 1. the superclusters' threshold-min keys (pack_keys with t_max = inf)
  int32_t sckey_mine = kDead;
  if (tid < k1) {
    float box[6];
#pragma unroll
    for (int p = 0; p < 6; ++p) box[p] = sc_box[(size_t)tid * 8 + p];
    float tn;
    const uint32_t hit =
        all_safe ? test_box<false>(box, sray, group, safe_mask, tn)
                 : test_box<true>(box, sray, group, safe_mask, tn);
    if (hit)
      sckey_mine = pack_key(tn, __int_as_float(0x7F800000),
                            (1 << sc_id_bits) - 1, tid);
    sckey[tid] = sckey_mine;
  }
  const int n_sc = __syncthreads_count(sckey_mine != kDead);
  // 2. the maxs least keys, nearest first (extract_candidates_min)
  if (sckey_mine != kDead) {
    int rank = 0;
    for (int j = 0; j < k1; ++j) rank += sckey[j] < sckey_mine;
    if (rank < maxs) sscand[rank] = tid;
  }
  const bool sc_of = n_sc > maxs;  // the block may miss nearer clusters
  const int nsc = min(n_sc, maxs);
  const int ncols = nsc * kS;  // the kept superclusters' columns
  __syncthreads();

  // 3. the child columns: union mask, block-minimum entry-t, packed key
  const int32_t id_mask = (1 << id_bits) - 1;
  int mine = 0;
  for (int l = tid; l < ncols; l += kThreads) {
    const float* row =
        cl_box_rows + (size_t)sscand[l / kS] * kRowFloats + (l % kS);
    float box[6];
#pragma unroll
    for (int p = 0; p < 6; ++p) box[p] = __ldg(row + p * kS);
    float tn;
    const uint32_t hit =
        all_safe ? test_box<false>(box, sray, group, safe_mask, tn)
                 : test_box<true>(box, sray, group, safe_mask, tn);
    int32_t key = kDead;
    if (hit) {
      key = pack_key(tn, kTMax, id_mask, l);
      ++mine;
    }
    skey[l] = key;
    smask[l] = hit;
  }
  mine = __reduce_add_sync(0xffffffffu, mine);
  if (wlane == 0 && mine) atomicAdd(&s_ncol, mine);
  __syncthreads();
  const int ncol = s_ncol;  // hit columns: the row's count

  // 4. the maxc least keys (extract_candidates), sorted
  const int kept = min(ncol, maxc);
  const int32_t thr =
      ncol > maxc ? radix_select(skey, ncols, maxc - 1, shist, sfound)
                  : kDead - 1;
  for (int base = 0; base < ncols; base += kThreads) {  // whole warps
    const int l = base + tid;
    const bool take = l < ncols && skey[l] <= thr;
    const unsigned bal = __ballot_sync(0xffffffffu, take);
    int pos = 0;
    if (wlane == 0 && bal) pos = atomicAdd(&s_nkept, __popc(bal));
    pos = __shfl_sync(0xffffffffu, pos, 0);
    if (take) skept[pos + __popc(bal & ((1u << wlane) - 1u))] = skey[l];
  }
  __syncthreads();
  if (tid < kept) {
    const int32_t k = skept[tid];
    int rank = 0;
    for (int j = 0; j < kept; ++j) rank += skept[j] < k;
    ssorted[rank] = k;
  }
  __syncthreads();

  // the last slot as extract_candidates leaves it: a full row (count >
  // maxc) is poisoned without `exact`.  Its other rule (a row kept short
  // of min(count, maxc)) never fires, here or in the torch version: every
  // hit key is live, so a row keeps min(count, maxc) keys.
  const bool over = ncol > maxc;
  int last_cl = -1;
  float last_t = srt::kBigT;
  if (kept == maxc) {
    last_cl = ssorted[maxc - 1] & id_mask;
    last_t = __int_as_float(ssorted[maxc - 1] & ~id_mask);
  }
  if (!exact && over) last_t = -srt::kBigT;

  // 5. the certificate (membership_cert): a ray of a full row is exact
  // unless it hits a column whose key lies above the last kept key;
  // poisoned rows and SC-overflow blocks never certify
  if (covered_out != nullptr) {
    const bool full = last_cl >= 0;
    const bool poisoned = last_t < 0.0f;
    const int32_t last_key =
        full ? ((__float_as_int(last_t) & ~id_mask) | last_cl) : kDead;
    uint32_t drop = 0;
    for (int l = tid; l < ncols; l += kThreads)
      if (skey[l] > last_key) drop |= smask[l];
    drop = __reduce_or_sync(0xffffffffu, drop);
    if (wlane == 0 && drop) atomicOr(&s_drop, drop);
    __syncthreads();
    if (tid < group)
      covered_out[(size_t)b * group + tid] =
          !((s_drop >> tid) & 1u) && !poisoned && !sc_of;
  }

  // 6. the list: local ids to global cluster ids; SC-overflow blocks
  // poison their last slot (cluster 0 fills an empty one)
  for (int i = tid; i < maxc; i += kThreads) {
    int32_t cl = -1;
    float t = srt::kBigT;
    if (i == maxc - 1) {
      cl = last_cl;
      t = last_t;
    } else if (i < kept) {
      cl = ssorted[i] & id_mask;
      t = __int_as_float(ssorted[i] & ~id_mask);
    }
    int32_t g = cl >= 0 ? sscand[cl / kS] * kS + cl % kS : -1;
    if (i == maxc - 1 && sc_of) {
      if (g < 0) g = 0;
      t = -srt::kBigT;
    }
    cand_out[(size_t)b * maxc + i] = g;
    ctn_out[(size_t)b * maxc + i] = t;
  }
  if (tid == 0) flag_out[b] = sc_of || over;
}

cudaError_t hier_build_prepare() {
  static const cudaError_t e = cudaFuncSetAttribute(
      hier_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxDynBytes);
  return e;
}

}  // namespace

extern "C" {

// candidate_clusters_hier(grouped=True) over nblocks blocks of `group`
// rays, on the caller's stream; returns cudaGetLastError() (0 on
// success), cudaErrorInvalidValue for a shape past the kernel's arrays.
// covered may be null (no certificate).
int srt_hier_build(const void* sc_box, const void* cl_box_rows,
                   const void* ray_o, int o_stride, const void* ray_d,
                   int d_stride, const void* t_lim, int t_stride, void* cand,
                   void* ctn, void* covered, void* flag, int nblocks, int k1,
                   int maxs, int maxc, int group, int exact, int sc_id_bits,
                   int id_bits, void* stream) {
  if (k1 < 1 || k1 > kMaxK1 || maxs < 1 || maxs > kMaxSlots || maxc < 1 ||
      maxc > kMaxSlots || group < 1 || group > kMaxGroup || id_bits < 1 ||
      id_bits > 30 || sc_id_bits < 1 || sc_id_bits > 30)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = hier_build_prepare();
  if (e != cudaSuccess) return (int)e;
  if (nblocks > 0) {
    const int cols = (maxs < k1 ? maxs : k1) * kS;
    hier_build_kernel<<<nblocks, kThreads, cols * 8, (cudaStream_t)stream>>>(
        (const float*)sc_box, (const float*)cl_box_rows, (const float*)ray_o,
        o_stride, (const float*)ray_d, d_stride, (const float*)t_lim,
        t_stride, (int32_t*)cand, (float*)ctn, (uint8_t*)covered,
        (uint8_t*)flag, k1, maxs, maxc, group, exact, sc_id_bits, id_bits);
  }
  return (int)cudaGetLastError();
}

// info[0..4] = the kernel's registers per thread, local (spill) bytes per
// thread, resident blocks per SM, threads per block, shared bytes per
// block (static + a key and a mask for each of `cols` columns).
int srt_hier_build_info(int cols, int* info) {
  if (cols < 0 || cols > kMaxCols) return (int)cudaErrorInvalidValue;
  cudaError_t e = hier_build_prepare();
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, hier_build_kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, hier_build_kernel, kThreads, cols * 8);
  if (e != cudaSuccess) return (int)e;
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = blocks;
  info[3] = kThreads;
  info[4] = (int)a.sharedSizeBytes + cols * 8;
  return 0;
}

}  // extern "C"
