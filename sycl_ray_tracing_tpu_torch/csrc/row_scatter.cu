// The gradient of a row gather from a small table, out[r] = sum of
// grad[i] over the rays i with idx[i] == r, for Hopper (sm_90a), bound to
// PyTorch through a plain C interface loaded with ctypes
// (ops/kernels/rows.py row_sum; built into one library with listtrace.cu
// and hier_build.cu by ops/kernels/cuda_lib.py).
//
// It replaces no TPU kernel: in the JAX package this sum is XLA's
// transpose of the gathers `mat_packed[mid]` and `light_rows[pick]` (as
// the supercluster build of hier_build.cu is XLA there).  On the card
// torch's backward of such a gather is index_put_ with accumulate=True:
// it sorts the indices and then sums each run of equal indices serially,
// one thread a column, so a 262,144-ray gather from a 4-row table is 8
// threads walking ~65k duplicates each.  The kernel spreads that walk
// over the whole card.
//
// Inputs
//   grad f32 [W, C] (rows contiguous), idx i32 or i64 [W]: a negative
//   index counts from the end, as in the gather; an index outside the
//   table adds nothing (the gather refused it already)
// Outputs
//   out f32 [R, C]; partials f32 [G, R, C] scratch when G > 1
//
// The order of the sums is fixed and does not depend on the card or on
// the schedule (no float atomics): rays in chunks of kChunk in ray order,
// G = ceil(W / kChunk); inside a chunk each row's rays, in ray order,
// summed by a pairwise tree over their rank k in the row (at step h = 1,
// 2, 4, ... the partial at rank k, k a multiple of 2h, adds the one at
// k + h); a row with no ray in the chunk reads 0.  The chunk partials
// are then summed in chunk order, from chunk 0's.  row_sum_plain
// (ops/kernels/rows.py) repeats that order with torch ops, and the kernel
// equals it bit for bit.
//
// What bounds it on an H100: bytes.  Each ray's grad row and index are
// read once, W * (4C + 4 or 8) bytes (9.4 MB at W = 262,144, C = 8: ~2.8
// us at 3.35 TB/s); the adds are W * C.  The design, one CTA of 256
// threads a chunk (128 CTAs at that width, one wave):
//  1. The chunk's indices, 8 consecutive a thread, ranked by a stable
//     block radix sort (CUB's, over the index's bits only: one 4-bit pass
//     for a table of up to 15 rows), so each row's rays lie together in
//     ray order; a row's first and last slot go to two small tables.
//  2. The chunk's grad rows (one contiguous range) are read once, in ray
//     order, coalesced, each into its ray's sorted slot in shared memory.
//  3. The tree runs in shared memory, a barrier a step, the steps as many
//     as the longest row needs (at most 11); then each row's sum is
//     written as the chunk's partial, or as out itself when G == 1.
//  4. A second kernel adds the G partials of each (row, column) in chunk
//     order, a thread an output; its loads are independent of the sum,
//     so they are issued ahead of it.
// Nothing per ray is written to device memory.  It does not reach the
// bound: at 262,144 rays the two kernels take ~0.034 + ~0.005 ms on an
// H100 (700 W), ~14x the bound, and about as long at 32,768 rays.  With
// at most one wave of CTAs the time is one CTA's serial path (the sort,
// the read, up to 11 barrier-separated tree steps), not the bytes; it is
// ~1 ms of a trainer step, against ~305 ms for torch's backward.

#include <cub/block/block_radix_sort.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                     // rays a thread in the sort
constexpr int kChunk = kThreads * kItems;     // rays a CTA (ROW_SUM_CHUNK)
constexpr int kMaxRows = 4096;                // ROW_SUM_MAX_ROWS
constexpr int kMaxCols = 16;                  // ROW_SUM_MAX_COLS
static_assert(kChunk <= 65535 && kMaxRows < 65535,
              "slots and rows are held as 16-bit values");
static_assert(kChunk <= 2048 && kMaxCols <= 16,
              "the ray index's multiply-shift is exact and fits 32 bits");

using Sort = cub::BlockRadixSort<unsigned int, kThreads, kItems, int>;

// Shared bytes of the chunk kernel: the sort's storage and then, in the
// same bytes, the chunk's sorted grad rows; each slot's row id and each
// ray's slot; each row's first and end slot.
__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

__host__ __device__ constexpr size_t union_bytes(int cols) {
  return align16(sizeof(Sort::TempStorage) >
                         (size_t)kChunk * cols * sizeof(float)
                     ? sizeof(Sort::TempStorage)
                     : (size_t)kChunk * cols * sizeof(float));
}

__host__ __device__ constexpr size_t chunk_shared_bytes(int rows, int cols) {
  return union_bytes(cols) + 2 * kChunk * sizeof(uint16_t) +
         align16(2 * (size_t)(rows + 1) * sizeof(uint16_t));
}

// The row id bits a sort needs: ids 0..rows (rows: past the table).
__host__ __device__ inline int key_bits(int rows) {
  int b = 1;
  while ((1 << b) <= rows) ++b;
  return b;
}

// (kThreads, 1): at kThreads alone ptxas held the kernel to 64 registers
// and spilled; it needs ~76.
template <typename Idx>
__global__ void __launch_bounds__(kThreads, 1)
    row_scatter_chunk_kernel(const float* __restrict__ grad,
                             const Idx* __restrict__ idx, int width, int rows,
                             int cols, float* __restrict__ dst) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t ub = union_bytes(cols);
  auto& sort_tmp = *reinterpret_cast<Sort::TempStorage*>(smem);
  float* v = reinterpret_cast<float*>(smem);
  uint16_t* skey = reinterpret_cast<uint16_t*>(smem + ub);
  uint16_t* sslot = skey + kChunk;  // each ray's sorted slot
  uint16_t* sfirst = sslot + kChunk;
  uint16_t* send = sfirst + (rows + 1);

  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * kChunk;
  const int n = (int)min((long long)kChunk, (long long)width - base);

  for (int r = tid; r <= rows; r += kThreads) {
    sfirst[r] = 0;
    send[r] = 0;
  }
  // 1. a stable sort of the chunk's rays by row (blocked: thread t holds
  // rays 8t .. 8t + 7, so equal rows keep ray order)
  unsigned int keys[kItems];
  int rays[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int p = tid * kItems + j;
    long long r = rows;
    if (p < n) {
      r = (long long)idx[base + p];
      if (r < 0) r += rows;
      if (r < 0 || r >= rows) r = rows;
    }
    keys[j] = (unsigned int)r;
    rays[j] = p;
  }
  Sort(sort_tmp).Sort(keys, rays, 0, key_bits(rows));
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    skey[tid * kItems + j] = (uint16_t)keys[j];
    sslot[rays[j]] = (uint16_t)(tid * kItems + j);
  }
  __syncthreads();
  // each row's first and end slot (a row not in the chunk keeps 0, 0)
  for (int p = tid; p < kChunk; p += kThreads) {
    const int k = skey[p];
    if (k >= rows) continue;
    if (p == 0 || skey[p - 1] != k) sfirst[k] = (uint16_t)p;
    if (p == kChunk - 1 || skey[p + 1] != k) send[k] = (uint16_t)(p + 1);
  }
  // 2. the chunk's grad rows, read in ray order (coalesced, 8 loads a
  // thread in flight), each stored at its ray's sorted slot (the sort's
  // storage is free: the barrier above follows its last read)
  const float* src = grad + (size_t)base * cols;
  const int total = n * cols;
  // i / cols as a multiply and a shift: exact for i < kChunk * cols
  const unsigned magic = ((1u << 20) + cols - 1) / cols;
  for (int i0 = tid; i0 < total; i0 += kThreads * kItems) {
    float x[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int i = i0 + u * kThreads;
      if (i < total) x[u] = src[i];
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int i = i0 + u * kThreads;
      if (i < total) {
        const int ray = (int)(((unsigned)i * magic) >> 20);
        v[sslot[ray] * cols + (i - ray * cols)] = x[u];
      }
    }
  }
  __syncthreads();
  // 3. the tree: slot p at rank k of a row of len slots adds slot p + h
  // when k is a multiple of 2h and k + h < len
  int rank[kItems], len[kItems];
  int longest = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int p = tid + j * kThreads;
    const int k = skey[p];
    rank[j] = 0;
    len[j] = 0;
    if (k < rows) {
      rank[j] = p - sfirst[k];
      len[j] = send[k] - sfirst[k];
    }
    longest = max(longest, len[j]);
  }
  for (int h = 1; __syncthreads_or(h < longest); h <<= 1) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if ((rank[j] & (2 * h - 1)) == 0 && rank[j] + h < len[j]) {
        float* a = v + (tid + j * kThreads) * cols;
        const float* b = a + h * cols;
#pragma unroll 4
        for (int c = 0; c < cols; ++c) a[c] += b[c];
      }
    }
  }
  // the last __syncthreads_or was the barrier after the last step
  float* out = dst + (size_t)blockIdx.x * rows * cols;
  for (int q = tid; q < rows * cols; q += kThreads) {
    const int r = q / cols;
    const int s = sfirst[r];
    out[q] = send[r] > s ? v[s * cols + (q - r * cols)] : 0.0f;
  }
}

// 4. out[o] = partials[0][o] + partials[1][o] + ... in chunk order
__global__ void __launch_bounds__(kThreads)
    row_scatter_combine_kernel(const float* __restrict__ partials,
                               int chunks, int outputs,
                               float* __restrict__ out) {
  const int o = blockIdx.x * kThreads + threadIdx.x;
  if (o >= outputs) return;
  float acc = partials[o];
#pragma unroll 8
  for (int g = 1; g < chunks; ++g) acc += partials[(size_t)g * outputs + o];
  out[o] = acc;
}

template <typename Idx>
cudaError_t chunk_prepare() {
  static const cudaError_t e = cudaFuncSetAttribute(
      row_scatter_chunk_kernel<Idx>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)chunk_shared_bytes(kMaxRows, kMaxCols));
  return e;
}

template <typename Idx>
int launch(const float* grad, const Idx* idx, int width, int rows, int cols,
           float* partials, float* out, cudaStream_t stream) {
  cudaError_t e = chunk_prepare<Idx>();
  if (e != cudaSuccess) return (int)e;
  const int chunks = (int)(((long long)width + kChunk - 1) / kChunk);
  row_scatter_chunk_kernel<Idx>
      <<<chunks, kThreads, chunk_shared_bytes(rows, cols), stream>>>(
          grad, idx, width, rows, cols, chunks > 1 ? partials : out);
  e = cudaGetLastError();
  if (e != cudaSuccess || chunks == 1) return (int)e;
  const int outputs = rows * cols;
  row_scatter_combine_kernel<<<(outputs + kThreads - 1) / kThreads, kThreads,
                               0, stream>>>(partials, chunks, outputs, out);
  return (int)cudaGetLastError();
}

template <typename Idx>
int info_of(int rows, int cols, int* info) {
  cudaError_t e = chunk_prepare<Idx>();
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, row_scatter_chunk_kernel<Idx>);
  if (e != cudaSuccess) return (int)e;
  const size_t shared = chunk_shared_bytes(rows, cols);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, row_scatter_chunk_kernel<Idx>, kThreads, shared);
  if (e != cudaSuccess) return (int)e;
  info[0] = a.numRegs;
  info[1] = (int)a.localSizeBytes;
  info[2] = blocks;
  info[3] = kThreads;
  info[4] = (int)(a.sharedSizeBytes + shared);
  return 0;
}

}  // namespace

extern "C" {

// out[R, C] = the row sums of grad[W, C] by idx[W] (int64 when idx64), in
// the order above, on the caller's stream: the chunk kernel, then, when W
// > kChunk, the combine kernel over partials[ceil(W / kChunk), R, C].
// Returns cudaGetLastError() (0 on success), cudaErrorInvalidValue for a
// shape past the kernel's arrays.
int srt_row_sum(const void* grad, const void* idx, int idx64, int width,
                int rows, int cols, void* partials, void* out, void* stream) {
  if (width < 1 || rows < 1 || rows > kMaxRows || cols < 1 ||
      cols > kMaxCols || (width > kChunk && partials == nullptr))
    return (int)cudaErrorInvalidValue;
  if (idx64)
    return launch((const float*)grad, (const int64_t*)idx, width, rows, cols,
                  (float*)partials, (float*)out, (cudaStream_t)stream);
  return launch((const float*)grad, (const int32_t*)idx, width, rows, cols,
                (float*)partials, (float*)out, (cudaStream_t)stream);
}

// info[0..4] = the chunk kernel's registers per thread, local (spill)
// bytes per thread, resident blocks per SM, threads per block and shared
// bytes per block at R rows and C columns, for an int32 (idx64 0) or an
// int64 index.
int srt_row_sum_info(int idx64, int rows, int cols, int* info) {
  if (rows < 1 || rows > kMaxRows || cols < 1 || cols > kMaxCols)
    return (int)cudaErrorInvalidValue;
  return idx64 ? info_of<int64_t>(rows, cols, info)
               : info_of<int32_t>(rows, cols, info);
}

}  // extern "C"
