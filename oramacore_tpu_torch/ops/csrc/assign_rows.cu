// Each query's own term rows, saturated by BM25 and added into its dense
// score and match-count rows, for NVIDIA Hopper (sm_90a).
//
// Replaces the assignment products of the jitted shared-path functions
// oramacore_tpu/ops/bm25.py:528 `bm25_shared_partial` and its twins at
// :609 `bm25_shared_champions`, :645 `bm25_shared_champions_masked` and
// :692 `bm25_shared_partial_masked`. There, each chunk of unique terms
// has a dense accumulator acc (rows, cap); the per-row saturation
//
//     sat = idf * (k1 + 1) * acc / (k1 + acc),   present = acc > 0
//
// makes (rows, cap) tensors, and a (B, rows) matrix A of slot counts
// carries them to the queries as two MXU matmuls, scores += A @ sat and
// matched += A @ present. A query holds a few terms, so A is almost all
// zeros, yet each product reads and rewrites the whole (B, cap) pair of
// accumulators for every chunk.
//
// Here one launch per chunk adds, for each query b and each slot t of b
// whose term lies in the chunk (row r = token_map[b, t] - row0 in
// [0, rows)), sat(r) into scores[b] and present(r) into matched[b], in
// slot order; a term held twice adds twice, as A's counts do, and slots
// outside the chunk (padding included) add nothing. The kernel takes df,
// not idf: per row, or per (row, query) by two strides (the filtered
// twins' df product), and computes
//
//     idf = ln(1 + (N - max(df, 1) + 0.5) / (max(df, 1) + 0.5))
//
// for each slot it adds, as a scalar the whole block shares. The
// arithmetic keeps ops/bm25.py's operand order with the round-to-nearest
// intrinsics and CUDA's log1pf (which torch.log1p calls), so each term's
// sat equals PyTorch's bit for bit, and the sums run in slot order
// (deterministic).
//
// A second entry point, count_present, gives each row's df = the number
// of its docs with acc > 0 (the JAX functions' present.sum(1)): one block
// per row, 16-byte loads, one read of the chunk. Beside the assignment it
// replaces PyTorch's compare, cast, sum, clamp and the four launches of
// the idf, which left the card idle between them.
//
// What bounds it. Device-memory bytes: a few operations per 4-byte
// element. Each touched (query, chunk) pair reads and writes its two rows
// of cap f32 once, and each row of acc that a slot names is read; the
// least the launch must move is (4 * pairs + rows read) * cap * 4 bytes
// at 3.35 TB/s. A query with no slot in the chunk moves no bytes.
// count_present reads rows * cap * 4 bytes.
//
// The design, for that bound:
// * One block per tile of kTile docs, all of the chunk's queries inside
//   the block. The acc tiles of the chunk's rows (rows * kTile * 4 bytes,
//   256 KiB at 64 rows) are read once from device memory and then hit in
//   L1 / L2 for every further query that holds the term.
// * Each block finds its queries from the slot map itself: a coalesced
//   pass over kRound queries' slots marks the queries with a slot in the
//   chunk, and those are compacted into a list in shared memory. No
//   block per (query, tile), no host-built pair list, no device-to-host
//   sync. The list's order follows shared-memory atomics, but every
//   query owns its rows, so the result does not depend on it.
// * 16-byte loads and stores of scores, matched and acc where cap is a
//   multiple of 4 and the three arrays are 16-byte aligned; otherwise
//   the same walk element by element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecsPerThread = 2;
constexpr int64_t kTile = (int64_t)kThreads * 4 * kVecsPerThread;  // docs
constexpr int kRound = 2048;  // queries a block examines at once

constexpr int kCountThreads = 1024;
constexpr int kCountUnroll = 4;

// sat = ((idf * (k1 + 1)) * a) / (k1 + a), bm25.py's operand order
__device__ __forceinline__ float saturate(float w, float a, float k1) {
  return __fdiv_rn(__fmul_rn(w, a), __fadd_rn(k1, a));
}

// bm25.py's _idf of df clamped to 1: log1p((n - df + 0.5) / (df + 0.5))
__device__ __forceinline__ float idf_of(float n_docs, float df) {
  const float d = fmaxf(df, 1.0f);
  return log1pf(__fdiv_rn(__fadd_rn(__fsub_rn(n_docs, d), 0.5f),
                          __fadd_rn(d, 0.5f)));
}

// df[r] = the number of docs of row r with acc > 0; one block a row.
template <bool kVec>
__global__ void __launch_bounds__(kCountThreads) count_present_kernel(
    const float* __restrict__ acc, int64_t cap, float* __restrict__ df) {
  __shared__ int s_warp[kCountThreads / 32];
  const float* row = acc + (int64_t)blockIdx.x * cap;
  int n = 0;
  if (kVec) {
    // kCountUnroll independent 16-byte loads in flight per thread: one
    // block streams a whole row, so it needs them to keep the SM busy
    const float4* v = reinterpret_cast<const float4*>(row);
    const int64_t nv = cap / 4;
    int64_t i = threadIdx.x;
    for (; i + (kCountUnroll - 1) * kCountThreads < nv;
         i += kCountUnroll * kCountThreads) {
      float4 a[kCountUnroll];
#pragma unroll
      for (int u = 0; u < kCountUnroll; ++u) a[u] = v[i + u * kCountThreads];
#pragma unroll
      for (int u = 0; u < kCountUnroll; ++u)
        n += (a[u].x > 0.0f) + (a[u].y > 0.0f) + (a[u].z > 0.0f) +
             (a[u].w > 0.0f);
    }
    for (; i < nv; i += kCountThreads) {
      const float4 a = v[i];
      n += (a.x > 0.0f) + (a.y > 0.0f) + (a.z > 0.0f) + (a.w > 0.0f);
    }
  } else {
    for (int64_t i = threadIdx.x; i < cap; i += kCountThreads)
      n += row[i] > 0.0f;
  }
  for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(0xffffffffu, n, o);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = n;
  __syncthreads();
  if (threadIdx.x < 32) {
    n = threadIdx.x < kCountThreads / 32 ? s_warp[threadIdx.x] : 0;
    for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(0xffffffffu, n, o);
    if (threadIdx.x == 0) df[blockIdx.x] = (float)n;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) assign_rows_accumulate_kernel(
    const float* __restrict__ acc,         // [rows, cap]
    int64_t rows,
    int64_t row0,
    const float* __restrict__ df,          // df[r * df_rs + b * df_qs]
    int64_t df_rs,
    int64_t df_qs,
    float n_docs,
    const int32_t* __restrict__ token_map, // [B, T]
    int64_t n_queries,
    int64_t n_slots,
    float k1,
    float k1p1,                            // k1 + 1, rounded as PyTorch does
    float* __restrict__ scores,            // [B, cap]
    float* __restrict__ matched,           // [B, cap]
    int64_t cap) {
  __shared__ int s_query[kRound];
  __shared__ unsigned char s_hit[kRound];
  __shared__ int s_count;
  const int64_t tile0 = (int64_t)blockIdx.x * kTile;

  for (int64_t q0 = 0; q0 < n_queries; q0 += kRound) {
    const int64_t nq = n_queries - q0 < kRound ? n_queries - q0 : kRound;
    for (int i = threadIdx.x; i < nq; i += kThreads) s_hit[i] = 0;
    if (threadIdx.x == 0) s_count = 0;
    __syncthreads();
    // the round's slots, read in order: mark each query with a slot here
    const int32_t* map = token_map + q0 * n_slots;
    for (int64_t j = threadIdx.x; j < nq * n_slots; j += kThreads) {
      const int64_t r = (int64_t)map[j] - row0;
      if (r >= 0 && r < rows) s_hit[j / n_slots] = 1;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nq; i += kThreads)
      if (s_hit[i]) s_query[atomicAdd(&s_count, 1)] = (int)(q0 + i);
    __syncthreads();
    const int n = s_count;

    for (int p = 0; p < n; ++p) {
      const int64_t b = s_query[p];
      float* s_row = scores + b * cap;
      float* m_row = matched + b * cap;
      const int32_t* slots = token_map + b * n_slots;
      float s[kVecsPerThread][4] = {}, m[kVecsPerThread][4] = {};
#pragma unroll
      for (int k = 0; k < kVecsPerThread; ++k) {
        const int64_t d = tile0 + 4 * ((int64_t)k * kThreads + threadIdx.x);
        if (kVec) {
          if (d < cap) {
            const float4 sv = *reinterpret_cast<const float4*>(s_row + d);
            const float4 mv = *reinterpret_cast<const float4*>(m_row + d);
            s[k][0] = sv.x; s[k][1] = sv.y; s[k][2] = sv.z; s[k][3] = sv.w;
            m[k][0] = mv.x; m[k][1] = mv.y; m[k][2] = mv.z; m[k][3] = mv.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (d + e < cap) {
              s[k][e] = s_row[d + e];
              m[k][e] = m_row[d + e];
            }
          }
        }
      }
      for (int64_t t = 0; t < n_slots; ++t) {
        const int64_t r = (int64_t)slots[t] - row0;
        if (r < 0 || r >= rows) continue;  // padding, or another chunk's term
        const float w =
            __fmul_rn(idf_of(n_docs, df[r * df_rs + b * df_qs]), k1p1);
        const float* a_row = acc + r * cap;
#pragma unroll
        for (int k = 0; k < kVecsPerThread; ++k) {
          const int64_t d = tile0 + 4 * ((int64_t)k * kThreads + threadIdx.x);
          float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (kVec) {
            if (d < cap) {
              const float4 av = *reinterpret_cast<const float4*>(a_row + d);
              a[0] = av.x; a[1] = av.y; a[2] = av.z; a[3] = av.w;
            }
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (d + e < cap) a[e] = a_row[d + e];
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (a[e] > 0.0f) {
              s[k][e] = __fadd_rn(s[k][e], saturate(w, a[e], k1));
              m[k][e] = __fadd_rn(m[k][e], 1.0f);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kVecsPerThread; ++k) {
        const int64_t d = tile0 + 4 * ((int64_t)k * kThreads + threadIdx.x);
        if (kVec) {
          if (d < cap) {
            *reinterpret_cast<float4*>(s_row + d) =
                make_float4(s[k][0], s[k][1], s[k][2], s[k][3]);
            *reinterpret_cast<float4*>(m_row + d) =
                make_float4(m[k][0], m[k][1], m[k][2], m[k][3]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (d + e < cap) {
              s_row[d + e] = s[k][e];
              m_row[d + e] = m[k][e];
            }
          }
        }
      }
    }
    __syncthreads();  // the list is read before the next round rewrites it
  }
}

}  // namespace

// Each launcher enqueues on `stream` and returns cudaGetLastError() (0 on
// success); a refused launch never runs, so the caller must check it.

extern "C" int assign_rows_accumulate_launch(
    const void* acc, int64_t rows, int64_t row0, const void* df,
    int64_t df_rs, int64_t df_qs, float n_docs, const void* token_map,
    int64_t n_queries, int64_t n_slots, float k1, float k1p1, void* scores,
    void* matched, int64_t cap, void* stream) {
  if (rows <= 0 || n_queries <= 0 || n_slots <= 0 || cap <= 0) return 0;
  const int64_t blocks = (cap + kTile - 1) / kTile;
  const bool vec = cap % 4 == 0 &&
      (((uintptr_t)acc | (uintptr_t)scores | (uintptr_t)matched) & 15) == 0;
  auto kernel = vec ? assign_rows_accumulate_kernel<true>
                    : assign_rows_accumulate_kernel<false>;
  kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)acc, rows, row0, (const float*)df, df_rs, df_qs, n_docs,
      (const int32_t*)token_map, n_queries, n_slots, k1, k1p1,
      (float*)scores, (float*)matched, cap);
  return (int)cudaGetLastError();
}

extern "C" int count_present_launch(const void* acc, int64_t rows,
                                    int64_t cap, void* df, void* stream) {
  if (rows <= 0) return 0;
  const bool vec = cap % 4 == 0 && ((uintptr_t)acc & 15) == 0;
  auto kernel = vec ? count_present_kernel<true> : count_present_kernel<false>;
  kernel<<<(unsigned)rows, kCountThreads, 0, (cudaStream_t)stream>>>(
      (const float*)acc, cap, (float*)df);
  return (int)cudaGetLastError();
}
