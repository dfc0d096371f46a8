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
// own in dynamic shared memory, walks its warps' share of the entries and
// adds each nonzero counter to the global counts with one atomic at the
// end. The counts are exact in int32.
//
// What bounds them: device-memory bytes, and at phase B's sizes (2.1M
// entries, 1.1M kept) the latency of the loads that depend on a doc id.
// Both kernels read docs and rep 16 bytes a lane (int4 / float4 where both
// views are 16-byte aligned, else word by word) and issue every gather of
// the kept entries a lane holds before any of them is used. Entries with
// rep == 0 gather nothing, so sentinel docs (== cap, past the column) are
// never read.
//
// - facet_hist: a lane takes 8 entries a step (two 16-byte loads of each
//   array, 128 entries apart across the warp) and gathers the column word
//   of each kept one; then it adds them. Categorical: bucket v when
//   0 <= v < G (-1 and ids >= G count nowhere), one shared atomic a kept
//   rep (aggregating a warp's equal buckets with __match_any_sync first
//   took 25% longer on an H100 at 2.1M entries, G = 64). Numeric: every
//   inclusive range [from, to] holding v counts (ranges may overlap, NaN
//   matches none); up to kWarpSumRanges ranges, one warp sum and one atomic
//   per range, above that one atomic per hit.
// - facet_hist_multi: no search. row_ptr int32[L + 1], row_ptr[d] =
//   lower_bound(pair_docs, d) over the doc-sorted pair table, gives doc d's
//   rows [row_ptr[d], min(row_ptr[d + 1], row_ptr[d] + M)), the rows JAX's
//   M probes keep; a doc outside [0, L) counts nothing. A warp loads 128
//   entries a tile (the next tile's loads go out before this one is used),
//   compacts the kept docs by ballot into a ring of 256 in shared memory,
//   and takes up to 128 of them a round, 4 a lane, so no lane idles on an
//   unkept entry: their 8 row_ptr loads, then the first kPreRows value
//   loads of each, then the adds. Categorical adds once per row whose
//   value is in range (pairs are distinct: value_counts); numeric ORs a
//   doc's rows per range and adds once per range (range_counts),
//   warp-summed up to kWarpSumRanges ranges.
//
// Shared memory: G counters (4 B each), for numeric columns the G ranges
// (8 B each), and for facet_hist_multi each warp's ring (1 KiB). The
// wrapper refuses what one block cannot hold (232,448 bytes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kVec = 4;                  // entries of one 16-byte load
constexpr int kTile = 32 * kVec;         // entries a warp loads at once
constexpr int kStep = 2 * kTile;         // facet_hist: entries a warp step
constexpr int kRing = 256;               // facet_hist_multi: ring of a warp
constexpr int kSlots = 4;                // kept docs a lane carries a round
constexpr int kRound = 32 * kSlots;
constexpr int kPreRows = 4;              // rows a doc loads before its adds
constexpr int kWarpSumRanges = 32;       // numeric G summed per warp
// grids (an H100 at 2.1M entries): facet_hist two steps a warp,
// at most eight blocks an SM; facet_hist_multi one tile a warp, at most
// sixteen blocks an SM (more, shorter blocks beat a longer ring walk)
constexpr int64_t kStepsPerWarp = 2;
constexpr int64_t kMaxBlocks = 132 * 8;
constexpr int64_t kTilesPerWarp = 1;
constexpr int64_t kMaxBlocksMulti = 132 * 16;

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

// Entries i .. i + 3 (i % 4 == 0): keep[k] = rep != 0, and d[k] the doc
// where kept. 16-byte loads where both arrays are 16-byte aligned (`vec`)
// and all four lie inside n, else word loads of those inside.
__device__ __forceinline__ void load4(const int32_t* __restrict__ docs,
                                      const float* __restrict__ rep,
                                      int64_t n, int64_t i, bool vec,
                                      int32_t (&d)[kVec], bool (&keep)[kVec]) {
  if (vec && i + kVec <= n) {
    const int4 dv = __ldg(reinterpret_cast<const int4*>(docs + i));
    const float4 rv = __ldg(reinterpret_cast<const float4*>(rep + i));
    d[0] = dv.x; d[1] = dv.y; d[2] = dv.z; d[3] = dv.w;
    keep[0] = rv.x != 0.0f; keep[1] = rv.y != 0.0f;
    keep[2] = rv.z != 0.0f; keep[3] = rv.w != 0.0f;
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      keep[k] = i + k < n && __ldg(rep + i + k) != 0.0f;
      d[k] = keep[k] ? __ldg(docs + i + k) : 0;
    }
  }
}

#define kNaN __int_as_float(0x7fc00000)   // in no range

__device__ __forceinline__ bool in_range(float v, float lo, float hi) {
  return v >= lo && v <= hi;   // false for NaN
}

__global__ void __launch_bounds__(kThreads) facet_hist_kernel(
    const int32_t* __restrict__ docs,   // [n]
    const float* __restrict__ rep,      // [n] 0/1
    int64_t n, int vec,
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
  const int lane = threadIdx.x & 31;
  const int64_t steps = (n + kStep - 1) / kStep;
  const int64_t n_warps = (int64_t)gridDim.x * kWarps;
  // warp-uniform loop: the warp collectives below need all 32 lanes
  for (int64_t s = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       s < steps; s += n_warps) {
    int32_t d[2][kVec];
    bool keep[2][kVec];
    const int64_t base = s * kStep + lane * kVec;
    load4(docs, rep, n, base, vec, d[0], keep[0]);
    load4(docs, rep, n, base + kTile, vec, d[1], keep[1]);
    if (numeric) {
      const float* col = reinterpret_cast<const float*>(column);
      float v[2 * kVec];
#pragma unroll
      for (int k = 0; k < 2 * kVec; ++k) {
        int64_t x = d[k / kVec][k % kVec];
        x = x < 0 ? 0 : (x >= n_col ? n_col - 1 : x);
        v[k] = keep[k / kVec][k % kVec] ? __ldg(col + x) : kNaN;
      }
      if (G <= kWarpSumRanges) {
        for (int g = 0; g < G; ++g) {
          const float a = lo[g], b = hi[g];
          unsigned c = 0;
#pragma unroll
          for (int k = 0; k < 2 * kVec; ++k) c += in_range(v[k], a, b);
          c = __reduce_add_sync(kAll, c);
          if (lane == 0 && c != 0) atomicAdd(hist + g, (int32_t)c);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 2 * kVec; ++k) {
          if (v[k] != v[k]) continue;   // NaN or not kept
          for (int g = 0; g < G; ++g) {
            if (in_range(v[k], lo[g], hi[g])) atomicAdd(hist + g, 1);
          }
        }
      }
    } else {
      const int32_t* col = reinterpret_cast<const int32_t*>(column);
      int32_t bucket[2 * kVec];
#pragma unroll
      for (int k = 0; k < 2 * kVec; ++k) {
        int64_t x = d[k / kVec][k % kVec];
        x = x < 0 ? 0 : (x >= n_col ? n_col - 1 : x);
        const int32_t v = keep[k / kVec][k % kVec] ? __ldg(col + x) : -1;
        bucket[k] = (v >= 0 && v < G) ? v : -1;
      }
#pragma unroll
      for (int k = 0; k < 2 * kVec; ++k) {
        if (bucket[k] >= 0) atomicAdd(hist + bucket[k], 1);
      }
    }
  }
  flush_shared(hist, G, out);
}

// One round of facet_hist_multi: the `count` (<= kRound) kept docs at
// ring[head ...], kSlots a lane. Entered by all 32 lanes of the warp.
__device__ __forceinline__ void multi_round(
    const int32_t* ring, unsigned head, unsigned count, int lane,
    const int32_t* __restrict__ row_ptr, int64_t L,
    const void* __restrict__ pair_vals, int64_t P,
    int32_t* hist, const float* lo, const float* hi, int G, int M,
    int numeric) {
  int32_t d[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const unsigned pos = lane + 32 * s;
    d[s] = pos < count ? ring[(head + pos) & (kRing - 1)] : -1;
  }
  __syncwarp();   // the next append may overwrite the slots just read
  int32_t r0[kSlots], cnt[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const bool in = d[s] >= 0 && d[s] < L;
    r0[s] = in ? __ldg(row_ptr + d[s]) : 0;
    cnt[s] = in ? __ldg(row_ptr + d[s] + 1) : 0;
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    int64_t c = (int64_t)cnt[s] - r0[s];
    c = c < M ? c : M;
    c = c < P - r0[s] ? c : P - r0[s];   // a malformed table reads no row
    cnt[s] = (r0[s] < 0 || c < 0) ? 0 : (int32_t)c;
  }
  if (!numeric) {
    const int32_t* vals = reinterpret_cast<const int32_t*>(pair_vals);
    int32_t v[kSlots][kPreRows];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
#pragma unroll
      for (int j = 0; j < kPreRows; ++j) {
        v[s][j] = j < cnt[s] ? __ldg(vals + r0[s] + j) : -1;
      }
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
#pragma unroll
      for (int j = 0; j < kPreRows; ++j) {
        if (v[s][j] >= 0 && v[s][j] < G) atomicAdd(hist + v[s][j], 1);
      }
      for (int j = kPreRows; j < cnt[s]; ++j) {
        const int32_t x = __ldg(vals + r0[s] + j);
        if (x >= 0 && x < G) atomicAdd(hist + x, 1);
      }
    }
    return;
  }
  const float* vals = reinterpret_cast<const float*>(pair_vals);
  float v[kSlots][kPreRows];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
#pragma unroll
    for (int j = 0; j < kPreRows; ++j) {
      v[s][j] = j < cnt[s] ? __ldg(vals + r0[s] + j) : kNaN;
    }
  }
  if (G <= kWarpSumRanges) {
    // the doc's G-bit membership, OR over its rows, in registers
    unsigned member[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) member[s] = 0;
    for (int g = 0; g < G; ++g) {
      const float a = lo[g], b = hi[g];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        bool hit = false;
#pragma unroll
        for (int j = 0; j < kPreRows; ++j) hit |= in_range(v[s][j], a, b);
        member[s] |= (unsigned)hit << g;
      }
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      for (int j = kPreRows; j < cnt[s]; ++j) {
        const float x = __ldg(vals + r0[s] + j);
        for (int g = 0; g < G; ++g) {
          member[s] |= (unsigned)in_range(x, lo[g], hi[g]) << g;
        }
      }
    }
    for (int g = 0; g < G; ++g) {
      unsigned c = 0;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) c += (member[s] >> g) & 1u;
      c = __reduce_add_sync(kAll, c);
      if (lane == 0 && c != 0) atomicAdd(hist + g, (int32_t)c);
    }
    return;
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (cnt[s] == 0) continue;
    for (int g = 0; g < G; ++g) {
      const float a = lo[g], b = hi[g];
      bool hit = false;
#pragma unroll
      for (int j = 0; j < kPreRows; ++j) hit |= in_range(v[s][j], a, b);
      for (int j = kPreRows; j < cnt[s] && !hit; ++j) {
        hit = in_range(__ldg(vals + r0[s] + j), a, b);
      }
      if (hit) atomicAdd(hist + g, 1);
    }
  }
}

__global__ void __launch_bounds__(kThreads) facet_hist_multi_kernel(
    const int32_t* __restrict__ docs,       // [n]
    const float* __restrict__ rep,          // [n] 0/1
    int64_t n, int vec,
    const int32_t* __restrict__ row_ptr,    // [L + 1] first row of each doc
    int64_t L,
    const void* __restrict__ pair_vals,     // int32 ids or f32 values [P]
    int64_t P,
    const float* __restrict__ bounds,       // [G, 2] inclusive (numeric)
    int G, int M, int numeric,
    int32_t* __restrict__ out) {            // [G], zeroed
  extern __shared__ int32_t smem[];
  int32_t* hist = smem;
  float* lo = reinterpret_cast<float*>(smem + G);
  float* hi = lo + G;
  int32_t* ring = smem + (numeric ? 3 : 1) * G + (threadIdx.x >> 5) * kRing;
  init_shared(hist, lo, hi, bounds, G, numeric);
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t n_warps = (int64_t)gridDim.x * kWarps;
  // warp-uniform state: head and tail count the docs ever read / written
  unsigned head = 0, tail = 0;
  int32_t d[kVec];
  bool keep[kVec] = {false, false, false, false};
  int64_t t = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t < tiles) load4(docs, rep, n, t * kTile + lane * kVec, vec, d, keep);
  while (t < tiles) {
    const int64_t tn = t + n_warps;
    int32_t dn[kVec];
    bool kn[kVec] = {false, false, false, false};
    if (tn < tiles) load4(docs, rep, n, tn * kTile + lane * kVec, vec, dn, kn);
    // append the kept docs of tile t: slot k's after those of slots < k
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const unsigned ballot = __ballot_sync(kAll, keep[k]);
      if (keep[k]) ring[(tail + __popc(ballot & below)) & (kRing - 1)] = d[k];
      tail += __popc(ballot);
    }
    __syncwarp();
    if (tail - head >= (unsigned)kRound) {   // < kRound stay buffered
      multi_round(ring, head, kRound, lane, row_ptr, L, pair_vals, P, hist,
                  lo, hi, G, M, numeric);
      head += kRound;
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      d[k] = dn[k];
      keep[k] = kn[k];
    }
    t = tn;
  }
  while (tail != head) {
    const unsigned c = tail - head < (unsigned)kRound ? tail - head : kRound;
    multi_round(ring, head, c, lane, row_ptr, L, pair_vals, P, hist, lo, hi,
                G, M, numeric);
    head += c;
  }
  flush_shared(hist, G, out);
}

size_t smem_bytes(int64_t G, int64_t numeric, bool multi) {
  return (size_t)G * (numeric ? 12 : 4) +
         (multi ? (size_t)kWarps * kRing * 4 : 0);
}

// Blocks for `units` units of warp work: `per_warp` a warp, at most
// `most` blocks.
int64_t grid_for(int64_t units, int64_t per_warp, int64_t most) {
  int64_t blocks = (units + kWarps * per_warp - 1) / (kWarps * per_warp);
  if (blocks > most) blocks = most;
  return blocks < 1 ? 1 : blocks;
}

bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
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
  const size_t smem = smem_bytes(G, numeric, false);
  const int err = prepare(facet_hist_kernel, smem, out, G,
                          (cudaStream_t)stream);
  if (err) return err;
  const int64_t grid = grid_for((n + kStep - 1) / kStep, kStepsPerWarp,
                                kMaxBlocks);
  facet_hist_kernel<<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)docs, (const float*)rep, n, (int)aligned16(docs, rep),
      column, n_col, (const float*)bounds, (int)G, (int)numeric,
      (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int facet_hist_multi_launch(
    const void* docs, const void* rep, int64_t n,
    const void* row_ptr, int64_t L, const void* pair_vals, int64_t P,
    const void* bounds, int64_t G, int64_t M, int64_t numeric, void* out,
    void* stream) {
  const size_t smem = smem_bytes(G, numeric, true);
  const int err = prepare(facet_hist_multi_kernel, smem, out, G,
                          (cudaStream_t)stream);
  if (err) return err;
  const int64_t grid = grid_for((n + kTile - 1) / kTile, kTilesPerWarp,
                                kMaxBlocksMulti);
  facet_hist_multi_kernel<<<(unsigned)grid, kThreads, smem,
                            (cudaStream_t)stream>>>(
      (const int32_t*)docs, (const float*)rep, n, (int)aligned16(docs, rep),
      (const int32_t*)row_ptr, L, pair_vals, P, (const float*)bounds, (int)G,
      (int)M, (int)numeric, (int32_t*)out);
  return (int)cudaGetLastError();
}
