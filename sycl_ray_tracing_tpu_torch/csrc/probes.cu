// Probe kernels for Hopper (sm_90a): the Hopper counterparts of the TPU
// kernels that the list tracer's cost-law probes launch (scratch/*.py),
// bound to PyTorch through a plain C interface loaded with ctypes
// (ops/kernels/probes.py).  No program path calls them; the probe entry
// point (python -m sycl_ray_tracing_tpu_torch.probes) and chip_smoke.py do.
//
// Built with -fmad=false like listtrace.cu, so every kernel here is
// bit-identical to its plain torch version.

#include "mt8.cuh"

namespace {

using srt::kLanes;

// ---------------------------------------------------------------------
// list_tiles_min
//
// Replaces the in-kernel-reduction probe of scratch/kernel_shape_bench.py:
// 83-115 (_list_kernel_impl plus jnp.min over lanes, output (B, 1)).
// One CUDA block per ray, thread = lane, walking every live slot with no
// tail guard (the per-ray kernel's first shape; listtrace.cu's
// list_tiles_kernel has since been redesigned); after the rounds a
// warp-shuffle + shared-memory min over the 128 lanes gives the ray's t.
// Bound on an H100: FP32 issue (~60 operations per ray, lane and live
// round); what the design removes is the [rays, 128] x 2 output (1 KB per
// ray written, 4 B instead).
__global__ void __launch_bounds__(kLanes)
list_tiles_min_kernel(const int32_t* __restrict__ cand,
                      const float* __restrict__ rays,
                      const float* __restrict__ tris,
                      float* __restrict__ tmin_out, int maxc, int dummy) {
  __shared__ float red[4];
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  const float* ray = rays + (size_t)row * 8;
  const float ox = ray[0], oy = ray[1], oz = ray[2];
  const float dx = ray[3], dy = ray[4], dz = ray[5], tl = ray[6];
  const int32_t* crow = cand + (size_t)row * maxc;
  float at = tl;
  for (int r = 0; r < maxc; ++r) {
    const int c = crow[r];
    if (c == dummy) continue;  // uniform across the block
    const float t = srt::mt8(srt::load_lane(tris, c, lane), ox, oy, oz, dx,
                             dy, dz, tl);
    at = t < at ? t : at;
  }
  const float m = srt::block_min128(at, red);
  if (lane == 0) tmin_out[row] = m;
}

// ---------------------------------------------------------------------
// round_probe
//
// Replaces the synthetic-round kernels of scratch/micro_copy.py:19-51
// (variants dyncopy / statcopy / mtonly / dynmt, 8 rays per grid step)
// and scratch/micro_super.py:16-39 (dynmt without the t > EPS test, 1 / 8
// / 32 sub-blocks of 8 rays per grid step).  Per sub-block of kRb = 8 rays
// and per round, the copy variants stack each ray's tile (its own cand
// entry, or tile 7) into a [9, 8, 128] shared-memory tile and add plane 0
// lane 0 to the ray's output; the MT variants run the probes' synthetic
// Moller-Trumbore on the stacked tile (the tile's own planes stand in for
// the ray) and keep min(out, lane-min of t).  Every output starts at 0,
// so the MT outputs are identically 0 (t > EPS or 1e30; without the EPS
// test t is the same plane offset as u >= 0, so >= 0 up to rounding), on
// the TPU too: the work is checked in the SASS (probes/micro_round.py),
// not in the output.  mtonly reads a stacked tile that is zeroed once per
// block (the TPU kernel's scratch was never written).
//
// Bound on an H100: the MT variants by FP32 issue (~46 operations per
// ray, lane and round plus the lane min); the copy variants by the
// launch (a few MB of tiles, all L2-resident).  The design keeps the
// TPU's shape (a thread per lane, rays of a sub-block in turn) so the
// probe measures the same per-round work; sub-blocks run in turn in one
// CUDA block, as the TPU's grid step ran them.
constexpr int kRb = 8;
enum Variant { kDynCopy = 0, kStatCopy = 1, kMtOnly = 2, kDynMt = 3,
               kDynMtNoEps = 4 };

template <int V>
__device__ __forceinline__ float synth_mt(const float (*stk)[kRb][kLanes],
                                          int i, int lane) {
  const float p0 = stk[0][i][lane], p1 = stk[1][i][lane],
              p2 = stk[2][i][lane], p3 = stk[3][i][lane],
              p4 = stk[4][i][lane], p5 = stk[5][i][lane],
              p6 = stk[6][i][lane], p7 = stk[7][i][lane],
              p8 = stk[8][i][lane];
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
__global__ void __launch_bounds__(kLanes)
round_probe_kernel(const int32_t* __restrict__ cand,
                   const float* __restrict__ tris, float* __restrict__ out,
                   int rounds, int subblocks) {
  __shared__ float stk[9][kRb][kLanes];
  __shared__ float red[kRb][4];
  constexpr bool kCopyDyn = V == kDynCopy || V == kDynMt || V == kDynMtNoEps;
  constexpr bool kMt = V == kMtOnly || V == kDynMt || V == kDynMtNoEps;
  const int lane = threadIdx.x;
  if (V == kMtOnly) {
    for (int c = 0; c < 9; ++c)
      for (int i = 0; i < kRb; ++i) stk[c][i][lane] = 0.0f;
  }
  for (int s = 0; s < subblocks; ++s) {
    const size_t row0 = ((size_t)blockIdx.x * subblocks + s) * kRb;
    float o = 0.0f;  // thread i < kRb holds ray row0 + i
    for (int r = 0; r < rounds; ++r) {
      if (kCopyDyn || V == kStatCopy) {
#pragma unroll
        for (int i = 0; i < kRb; ++i) {
          const int k = V == kStatCopy ? 7 : cand[(row0 + i) * rounds + r];
          const float* tile = tris + (size_t)k * 9 * kLanes + lane;
#pragma unroll
          for (int c = 0; c < 9; ++c) stk[c][i][lane] = tile[c * kLanes];
        }
      }
      __syncthreads();
      if (kMt) {
#pragma unroll
        for (int i = 0; i < kRb; ++i) {
          float m = synth_mt<V>(stk, i, lane);
          for (int off = 16; off > 0; off >>= 1)
            m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
          if ((lane & 31) == 0) red[i][lane >> 5] = m;
        }
        __syncthreads();
        if (lane < kRb)
          o = fminf(o, fminf(fminf(red[lane][0], red[lane][1]),
                             fminf(red[lane][2], red[lane][3])));
      } else if (lane < kRb) {
        o = o + stk[0][lane][0];
      }
      __syncthreads();  // the next round overwrites stk and red
    }
    if (lane < kRb) out[row0 + lane] = o;
  }
}

// ---------------------------------------------------------------------
// smoke_gather
//
// Replaces scratch/pallas_smoke.py:30-46: grid step b gathers table row
// cid[b] (a scalar-prefetched index) and writes, for each of its 64 rays,
// rays[:, 0] * sum over lanes of that row, plus 4 (a 4-trip loop whose
// pl.when branch does nothing).  One CUDA block per b, a thread per ray;
// the block loads its own index (Hopper has no scalar prefetch).  Bound:
// the launch (a few KB).
constexpr int kRt = 64;

__global__ void __launch_bounds__(kRt)
smoke_gather_kernel(const int32_t* __restrict__ cid,
                    const float* __restrict__ table,
                    const float* __restrict__ rays, float* __restrict__ out) {
  __shared__ float row[kLanes];
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  for (int l = j; l < kLanes; l += kRt)
    row[l] = table[(size_t)cid[b] * kLanes + l];
  __syncthreads();
  const float x = rays[((size_t)b * kRt + j) * 8];
  float acc = 0.0f;
  for (int l = 0; l < kLanes; ++l) acc = acc + x * row[l];
  float n = 0.0f;
  for (int i = 0; i < 4; ++i) {
    if (cid[i] >= 0) {
      // the TPU kernel's pl.when(c >= 0) branch: a no-op
    }
    n = n + 1.0f;
  }
  out[(size_t)b * kRt + j] = acc + n;
}

// ---------------------------------------------------------------------
// smoke_rank_select
//
// Replaces scratch/pallas_smoke2.py:24-51: the sum of table[c, 0, :] over
// the columns c of mask [8, 128] that hold any value > 0.5, in ascending
// c.  The TPU kernel ranks the set columns with a triangular matmul
// (cumsum has no Mosaic lowering) and a per-step count; here a thread per
// column, a warp scan of the column flags gives each set column its rank,
// which indexes a shared-memory list of set columns.  One block.  Bound:
// the launch.
__global__ void __launch_bounds__(kLanes)
smoke_rank_select_kernel(const float* __restrict__ mask,
                         const float* __restrict__ table,
                         float* __restrict__ out) {
  __shared__ int wsum[4];
  __shared__ int sel[kLanes];
  const int lane = threadIdx.x;
  bool hit = false;
  for (int i = 0; i < 8; ++i) hit = hit || mask[i * kLanes + lane] > 0.5f;
  int cum = hit ? 1 : 0;  // inclusive scan within the warp
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, cum, off);
    if ((lane & 31) >= off) cum += y;
  }
  if ((lane & 31) == 31) wsum[lane >> 5] = cum;
  __syncthreads();
  for (int w = 0; w < (lane >> 5); ++w) cum += wsum[w];
  if (hit) sel[cum - 1] = lane;  // rank select: the (cum-1)-th set column
  const int n = wsum[0] + wsum[1] + wsum[2] + wsum[3];
  __syncthreads();
  float acc = 0.0f;
  for (int j = 0; j < n; ++j) {
    // the TPU kernel's pl.when(c < 128) branch: a no-op
    acc = acc + table[(size_t)sel[j] * kLanes + lane];
  }
  out[lane] = acc;
}

// ---------------------------------------------------------------------
// mosaic_probe
//
// Replaces scratch/probe_mosaic.py:19-52, which probed one Mosaic feature
// at a time over x [8, 128]: a data-dependent while loop (ns[0] rounds,
// stopping early when the round's max is <= -1), a dynamic column
// x[:, r], a scalar extracted from a computed vector as a predicate, and
// a per-row predicate read from cand at a dynamic round.  The feature is
// a bit mask here (all five run on one build).  One block, a thread per
// column holding its 8 rows in registers.  Bound: the launch.
enum Feature { kWhile = 1, kDs = 2, kExtract = 4, kWhen = 8 };

__global__ void __launch_bounds__(kLanes)
mosaic_probe_kernel(const int32_t* __restrict__ ns,
                    const int32_t* __restrict__ cand,
                    const float* __restrict__ x, float* __restrict__ out,
                    int feat) {
  __shared__ float sx[8][kLanes];
  const int lane = threadIdx.x;
  float acc[8], o[8];
  for (int i = 0; i < 8; ++i) {
    sx[i][lane] = x[i * kLanes + lane];
    acc[i] = sx[i][lane];
    o[i] = 0.0f;
  }
  __syncthreads();
  auto round_body = [&](int r) -> bool {
    float col[8];
    for (int i = 0; i < 8; ++i)
      col[i] = (feat & kDs) ? sx[i][r] : sx[i][0] + (float)r;
    if (feat & kWhen) {
      for (int i = 0; i < 8; ++i)
        if (cand[i * kLanes + r] > 0) acc[i] = acc[i] * 1.0001f;
    }
    if (feat & kExtract) {
      const float s = col[3] + 1.0f;
      if (s > 0.0f)
        for (int i = 0; i < 8; ++i) o[i] = o[i] + acc[i];
    } else {
      for (int i = 0; i < 8; ++i) o[i] = o[i] + acc[i] + col[i];
    }
    float mx = col[0];
    for (int i = 1; i < 8; ++i) mx = fmaxf(mx, col[i]);
    return mx > -1.0f;
  };
  if (feat & kWhile) {
    int r = 0;
    bool go = ns[0] > 0;
    while (go) {
      const bool ok = round_body(r);
      r += 1;
      go = r < ns[0] && ok;
    }
  } else {
    for (int r = 0; r < 4; ++r) round_body(r);
  }
  for (int i = 0; i < 8; ++i) out[i * kLanes + lane] = o[i];
}

}  // namespace

extern "C" {

// Each entry point launches on the caller's stream and returns
// cudaGetLastError() (0 on success); it never synchronises.
int srt_list_tiles_min(const void* cand, const void* rays, const void* tris,
                       void* tmin, int nrays, int maxc, int dummy,
                       void* stream) {
  if (maxc < 1 || maxc > srt::kMaxc) return (int)cudaErrorInvalidValue;
  if (nrays > 0)
    list_tiles_min_kernel<<<nrays, kLanes, 0, (cudaStream_t)stream>>>(
        (const int32_t*)cand, (const float*)rays, (const float*)tris,
        (float*)tmin, maxc, dummy);
  return (int)cudaGetLastError();
}

// variant: 0 dyncopy, 1 statcopy, 2 mtonly, 3 dynmt, 4 dynmt without the
// t > EPS test; rows = grid * subblocks * 8.
int srt_round_probe(const void* cand, const void* tris, void* out, int grid,
                    int rounds, int subblocks, int variant, void* stream) {
  if (grid < 0 || rounds < 1 || subblocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* c = (const int32_t*)cand;
  const float* t = (const float*)tris;
  float* o = (float*)out;
  if (grid > 0) {
    switch (variant) {
      case kDynCopy:
        round_probe_kernel<kDynCopy><<<grid, kLanes, 0, s>>>(c, t, o, rounds,
                                                             subblocks);
        break;
      case kStatCopy:
        round_probe_kernel<kStatCopy><<<grid, kLanes, 0, s>>>(c, t, o, rounds,
                                                              subblocks);
        break;
      case kMtOnly:
        round_probe_kernel<kMtOnly><<<grid, kLanes, 0, s>>>(c, t, o, rounds,
                                                            subblocks);
        break;
      case kDynMt:
        round_probe_kernel<kDynMt><<<grid, kLanes, 0, s>>>(c, t, o, rounds,
                                                           subblocks);
        break;
      case kDynMtNoEps:
        round_probe_kernel<kDynMtNoEps><<<grid, kLanes, 0, s>>>(
            c, t, o, rounds, subblocks);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

int srt_smoke_gather(const void* cid, const void* table, const void* rays,
                     void* out, int nb, void* stream) {
  if (nb < 4) return (int)cudaErrorInvalidValue;  // the loop reads cid[0:4]
  smoke_gather_kernel<<<nb, kRt, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cid, (const float*)table, (const float*)rays,
      (float*)out);
  return (int)cudaGetLastError();
}

int srt_smoke_rank_select(const void* mask, const void* table, void* out,
                          void* stream) {
  smoke_rank_select_kernel<<<1, kLanes, 0, (cudaStream_t)stream>>>(
      (const float*)mask, (const float*)table, (float*)out);
  return (int)cudaGetLastError();
}

// feat: bit mask of 1 while, 2 ds, 4 extract, 8 when.
int srt_mosaic_probe(const void* ns, const void* cand, const void* x,
                     void* out, int feat, void* stream) {
  mosaic_probe_kernel<<<1, kLanes, 0, (cudaStream_t)stream>>>(
      (const int32_t*)ns, (const int32_t*)cand, (const float*)x, (float*)out,
      feat);
  return (int)cudaGetLastError();
}

}  // extern "C"
