// Facet histograms of the pruned tier's phase B for NVIDIA Hopper (sm_90a).
//
// Replaces the jitted JAX functions oramacore_tpu/ops/pruned.py::
// _facet_hist_core (single-valued columns) and _facet_hist_multi_core
// (multi-valued columns). Their input is phase A's run-end reps: docs
// int32[N] and a 0/1 flag rep f32[N], one set flag per distinct matched
// doc. The TPU has no fast scatter, so JAX counts with a scan of
// 262,144-row bf16 one-hot matmuls into f32 (exact only below 2^24).
//
// Here a count is a histogram of G int32 counters. Each block keeps its
// own in dynamic shared memory (atomicAdd on shared memory), walks its
// share of the entries with a grid-stride loop, and adds each nonzero
// counter to the global counts with one atomic at the end. The counts are
// exact in int32.
//
// What bounds it: device-memory bytes. Every entry reads 8 bytes (doc and
// rep), and each kept rep gathers its doc's value: one 4-byte word of the
// column (one 32-byte sector), or a binary search into the doc-sorted
// pair table and at most M probes of it. Entries with rep == 0 gather
// nothing, so sentinel docs (== cap, past the column) are never read.
//
// - facet_hist, categorical: add 1 at bucket[doc] when 0 <= v < G (-1 and
//   ids >= G count nowhere, as the one-hot drops them).
// - facet_hist, numeric: add 1 for every inclusive range [from, to] that
//   holds v; ranges may overlap; NaN matches none.
// - facet_hist_multi: per kept rep, lower_bound(pair_docs, doc), then up
//   to M probes of the doc's rows (pair_docs ends with a sentinel row
//   larger than any doc). Categorical adds once per probe row whose value
//   is in range (pairs are distinct: value_counts); numeric ORs the probes
//   per range and adds once per range (range_counts).
//
// Shared memory: G counters (4 B each), and for numeric columns the G
// ranges (8 B each) read once per block. The wrapper refuses what one
// block cannot hold (232,448 bytes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 4;   // four blocks an SM
constexpr int64_t kEntriesPerThread = 4;  // at least, before the grid caps

// Counters (and ranges) of one block, zeroed / loaded before the walk.
__device__ __forceinline__ void init_shared(int32_t* hist, float* lo,
                                            float* hi, const float* bounds,
                                            int G, int numeric) {
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    hist[g] = 0;
    if (numeric) {
      lo[g] = bounds[2 * g];
      hi[g] = bounds[2 * g + 1];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void flush_shared(const int32_t* hist, int G,
                                             int32_t* out) {
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const int32_t c = hist[g];
    if (c != 0) atomicAdd(out + g, c);
  }
}

__global__ void __launch_bounds__(kThreads) facet_hist_kernel(
    const int32_t* __restrict__ docs,   // [n]
    const float* __restrict__ rep,      // [n] 0/1
    int64_t n,
    const void* __restrict__ column,    // int32 ids or f32 values [n_col]
    int64_t n_col,
    const float* __restrict__ bounds,   // [G, 2] inclusive (numeric)
    int G, int numeric,
    int32_t* __restrict__ out) {        // [G], zeroed
  extern __shared__ int32_t smem[];
  int32_t* hist = smem;
  float* lo = reinterpret_cast<float*>(smem + G);
  float* hi = lo + G;
  init_shared(hist, lo, hi, bounds, G, numeric);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (__ldg(rep + i) == 0.0f) continue;
    int64_t d = __ldg(docs + i);
    d = d < 0 ? 0 : (d >= n_col ? n_col - 1 : d);
    if (numeric) {
      const float v = __ldg(reinterpret_cast<const float*>(column) + d);
      for (int g = 0; g < G; ++g) {
        if (v >= lo[g] && v <= hi[g]) atomicAdd(hist + g, 1);
      }
    } else {
      const int32_t v = __ldg(reinterpret_cast<const int32_t*>(column) + d);
      if (v >= 0 && v < G) atomicAdd(hist + v, 1);
    }
  }
  flush_shared(hist, G, out);
}

// First index p in [0, P] with pair_docs[p] >= d.
__device__ __forceinline__ int64_t lower_bound(const int32_t* pair_docs,
                                               int64_t P, int32_t d) {
  int64_t lo = 0, len = P;
  while (len > 0) {
    const int64_t half = len >> 1;
    if (__ldg(pair_docs + lo + half) < d) {
      lo += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads) facet_hist_multi_kernel(
    const int32_t* __restrict__ docs,       // [n]
    const float* __restrict__ rep,          // [n] 0/1
    int64_t n,
    const int32_t* __restrict__ pair_docs,  // [P] ascending, sentinel last
    const void* __restrict__ pair_vals,     // int32 ids or f32 values [P]
    int64_t P,
    const float* __restrict__ bounds,       // [G, 2] inclusive (numeric)
    int G, int M, int numeric,
    int32_t* __restrict__ out) {            // [G], zeroed
  extern __shared__ int32_t smem[];
  int32_t* hist = smem;
  float* lo = reinterpret_cast<float*>(smem + G);
  float* hi = lo + G;
  init_shared(hist, lo, hi, bounds, G, numeric);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (__ldg(rep + i) == 0.0f) continue;
    const int32_t d = __ldg(docs + i);
    const int64_t pos = lower_bound(pair_docs, P, d);
    // the doc's rows: pair_docs is sorted, so they are contiguous from pos
    int run = 0;
    while (run < M && pos + run < P && __ldg(pair_docs + pos + run) == d) {
      ++run;
    }
    if (numeric) {
      const float* vals = reinterpret_cast<const float*>(pair_vals) + pos;
      for (int g = 0; g < G; ++g) {
        for (int j = 0; j < run; ++j) {
          const float v = __ldg(vals + j);
          if (v >= lo[g] && v <= hi[g]) {
            atomicAdd(hist + g, 1);
            break;
          }
        }
      }
    } else {
      const int32_t* vals = reinterpret_cast<const int32_t*>(pair_vals) + pos;
      for (int j = 0; j < run; ++j) {
        const int32_t v = __ldg(vals + j);
        if (v >= 0 && v < G) atomicAdd(hist + v, 1);
      }
    }
  }
  flush_shared(hist, G, out);
}

size_t smem_bytes(int64_t G, int64_t numeric) {
  return (size_t)G * (numeric ? 12 : 4);
}

int64_t grid_for(int64_t n) {
  int64_t blocks = (n + kThreads * kEntriesPerThread - 1) /
                   (kThreads * kEntriesPerThread);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : blocks;
}

// Zeroes `out` and prepares a launch of `kernel` with `smem` bytes of
// dynamic shared memory; returns 0 or the CUDA error.
template <typename Kernel>
int prepare(Kernel kernel, size_t smem, void* out, int64_t G,
            cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)G * 4, stream);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// Each launcher zeroes `out` (int32[G]) and enqueues one kernel on
// `stream` (always, even for n == 0), and returns cudaGetLastError() (0 on
// success): a refused launch never runs, so the caller must check it. The
// caller checks types, shapes and the shared-memory size.
extern "C" int facet_hist_launch(
    const void* docs, const void* rep, int64_t n,
    const void* column, int64_t n_col, const void* bounds,
    int64_t G, int64_t numeric, void* out, void* stream) {
  const size_t smem = smem_bytes(G, numeric);
  const int err = prepare(facet_hist_kernel, smem, out, G,
                          (cudaStream_t)stream);
  if (err) return err;
  facet_hist_kernel<<<(unsigned)grid_for(n), kThreads, smem,
                      (cudaStream_t)stream>>>(
      (const int32_t*)docs, (const float*)rep, n, column, n_col,
      (const float*)bounds, (int)G, (int)numeric, (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int facet_hist_multi_launch(
    const void* docs, const void* rep, int64_t n,
    const void* pair_docs, const void* pair_vals, int64_t P,
    const void* bounds, int64_t G, int64_t M, int64_t numeric, void* out,
    void* stream) {
  const size_t smem = smem_bytes(G, numeric);
  const int err = prepare(facet_hist_multi_kernel, smem, out, G,
                          (cudaStream_t)stream);
  if (err) return err;
  facet_hist_multi_kernel<<<(unsigned)grid_for(n), kThreads, smem,
                            (cudaStream_t)stream>>>(
      (const int32_t*)docs, (const float*)rep, n, (const int32_t*)pair_docs,
      pair_vals, P, (const float*)bounds, (int)G, (int)M, (int)numeric,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
