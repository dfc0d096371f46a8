// BM25F posting-range scoring for NVIDIA Hopper (sm_90a).
//
// Replaces oramacore_tpu/ops/pallas_score.py::score_windows (the Pallas
// kernel at :34, its pallas_call at :114), which DMAs (doc, tf, flen)
// posting windows into VMEM and computes the normalized term frequency
//
//     ntf = weight * tf / max((1 - b) + (b / avg) * flen, 1e-9)
//
// Two entry points share this source:
//
// * score_windows keeps the Pallas kernel's contract: NS windows of width
//   w at given starts, written out as docs int32[NS, w] and ntf f32[NS, w].
//   The TPU needed 1024-aligned starts (a Mosaic DMA rule); any start is
//   accepted here. One grid-stride loop over the NS * w slots.
// * score_ranges_accumulate is the form the search path runs. It walks
//   each (row, range) pair for exactly `len` postings, drops postings with
//   tf <= 0 or a doc outside [0, cap), and atomically adds ntf into the
//   caller's dense accumulator acc f32[R, cap]. On the TPU this was two
//   stages (window gather, then a one-hot MXU matmul or a scatter into the
//   dense doc space, ops/bm25.py:_aggregate_dense) because the TPU has no
//   fast scatter; on Hopper a global atomic add is the scatter.
//
// What bounds score_ranges_accumulate. Device-memory bytes: each posting
// reads 12 bytes (doc, tf, flen), and every 32-byte sector of acc that a
// call touches must come from device memory once and go back once (an acc
// row is 4 MiB at cap = 2^20, so R rows are far beyond the 50 MB L2): 12 B
// per posting plus 64 B per touched sector. But each posting is also one
// atomic add, and the L2's atomic rate is the nearer limit: on an NVIDIA
// H100 80GB HBM3 at 700 W, 67.7M adds that all land in L2 take 0.83 ms,
// twice the byte bound (0.39 ms) of the same call, while reading and
// scoring the postings without adding takes 0.41 ms (ranges_bench's
// limit cases; PERF.md). Calls of the search path are small (a B=1024
// batch makes 35 launches of 8-64 rows of one range each, 7k-360k
// postings), so there a launch's fixed latency counts as much as either.
//
// The design, for those limits:
// * A work list, not a grid sized for the longest range. Each pair's
//   postings are cut into tiles of kTileVecs 16-byte vectors; the
//   inclusive cumsum of tile counts over the R * NR pairs in row-major
//   order is the list. A call of up to kLocalPairs pairs (every call of
//   the shared search path) has each block scan it into shared memory, so
//   it is one launch; a larger call has one block of work_list_kernel
//   write it to `work` first. Empty and short ranges cost no blocks.
// * Rows kept L2-resident. A persistent grid (the SMs times the blocks
//   that fit on one) walks the tiles in list order, block b taking tiles
//   b, b + grid, ...; a block finds a tile's pair by binary search in the
//   list. The tiles in flight cover a band of about one row (4 MiB of acc
//   at cap = 2^20), so the atomics hit L2 and each acc sector goes to
//   device memory about once. Posting loads are marked evict-first
//   (ld.global.cs) and the adds carry an evict-last L2 policy, so the
//   stream of postings does not push the band out.
// * 16-byte loads. doc, tf and flen are read as int4 / float4 from the
//   16-byte boundary at or below the range start; lanes outside the range
//   are masked, and a vector that crosses the end of the slab (or a slab
//   whose columns are not 16-byte aligned) is read element by element.
// * Updates are reductions (red.global.add.f32: an atomic add that
//   returns nothing). Each warp computes ntf in the vector layout, then
//   passes (doc, ntf) through shared memory so that the 32 lanes of one
//   reduction update 32 consecutive postings of the range.
//
// Arithmetic uses the round-to-nearest intrinsics so the compiler fuses
// nothing into an FMA: results match the plain PyTorch version's operand
// order (ops/score_windows.py) up to the order of the atomic sums.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kWindowBlocks = 132 * 16;  // 16 resident blocks per SM

// score_ranges_accumulate: a tile is kTileVecs 16-byte vectors of postings
constexpr int kVecsPerThread = 2;
constexpr int64_t kTileVecs = (int64_t)kThreads * kVecsPerThread;
// calls of up to kLocalPairs (row, range) pairs scan their work list in
// every block (the shared path's chunks have 8-64 rows of one range, or a
// few ranges); larger ones in one block of kScanThreads ahead of them. A
// larger local list costs the big calls time (measured on the H100).
constexpr int kLocalPairs = 1024;
// resident blocks per SM the kernel is compiled for (at most 64 registers)
constexpr int kMinBlocks = 4;
constexpr int kScanThreads = 1024;

__global__ void score_windows_kernel(
    const int32_t* __restrict__ p_doc,
    const float* __restrict__ p_tf,
    const float* __restrict__ p_flen,
    int64_t n_postings,
    const int32_t* __restrict__ starts,   // [ns]
    const float* __restrict__ params,     // [ns, 4]: weight, 1-b, b/avg, _
    int64_t ns,
    int64_t w,
    int32_t* __restrict__ docs_out,       // [ns, w]
    float* __restrict__ ntf_out) {        // [ns, w]
  const int64_t total = ns * w;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t row = i / w;
    const int64_t p = (int64_t)starts[row] + (i - row * w);
    int32_t d = 0;
    float v = 0.0f;
    if (p >= 0 && p < n_postings) {  // outside the slab reads as (0, 0)
      const float wt = params[row * 4 + 0];
      const float one_minus_b = params[row * 4 + 1];
      const float b_over_avg = params[row * 4 + 2];
      const float denom = __fadd_rn(one_minus_b, __fmul_rn(b_over_avg, p_flen[p]));
      d = p_doc[p];
      v = __fdiv_rn(__fmul_rn(wt, p_tf[p]), fmaxf(denom, 1e-9f));
    }
    docs_out[i] = d;
    ntf_out[i] = v;
  }
}

// Tiles of one pair: its postings [start, start + len) as 16-byte vectors
// counted from the aligned slab index start - (start & 3).
__device__ __forceinline__ long long tiles_of(int32_t start, int32_t len) {
  if (len <= 0) return 0;
  const long long vecs = ((long long)(start & 3) + len + 3) >> 2;
  return (vecs + kTileVecs - 1) / kTileVecs;
}

// The work list, by the kThreadsScan threads of one block: out[i] = tiles
// of pairs 0..i (inclusive), i < n_pairs, in row-major pair order.
// `warp_total` is shared scratch of kThreadsScan / 32 entries.
template <int kThreadsScan, typename T>
__device__ void scan_tiles(const int32_t* __restrict__ starts,
                           const int32_t* __restrict__ lens, int64_t n_pairs,
                           T* __restrict__ out, long long* warp_total) {
  const int64_t per = (n_pairs + kThreadsScan - 1) / kThreadsScan;
  const int64_t first = (int64_t)threadIdx.x * per;
  const int64_t lo = first < n_pairs ? first : n_pairs;
  const int64_t hi = lo + per < n_pairs ? lo + per : n_pairs;
  long long own = 0;
  for (int64_t i = lo; i < hi; ++i) own += tiles_of(starts[i], lens[i]);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long incl = own;  // inclusive scan of `own` within the warp
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {  // inclusive scan of the warp totals
    long long wsum = lane < kThreadsScan / 32 ? warp_total[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, wsum, o);
      if (lane >= o) wsum += y;
    }
    if (lane < kThreadsScan / 32) warp_total[lane] = wsum;
  }
  __syncthreads();
  long long run = incl - own + (warp > 0 ? warp_total[warp - 1] : 0);
  for (int64_t i = lo; i < hi; ++i) {
    run += tiles_of(starts[i], lens[i]);
    out[i] = (T)run;
  }
}

// The work list of a call with more than kLocalPairs pairs, in device
// memory, by one block ahead of the main kernel.
__global__ void __launch_bounds__(kScanThreads) work_list_kernel(
    const int32_t* __restrict__ starts,    // [n_pairs]
    const int32_t* __restrict__ lens,      // [n_pairs]
    int64_t n_pairs,
    long long* __restrict__ cum) {         // [n_pairs]
  __shared__ long long warp_total[kScanThreads / 32];
  scan_tiles<kScanThreads>(starts, lens, n_pairs, cum, warp_total);
}

// Postings [q, q + 4) into registers, element by element: a lane outside
// [start, end) or outside the slab reads tf 0, which drops it.
__device__ __forceinline__ void load_lanes(
    const int32_t* __restrict__ p_doc, const float* __restrict__ p_tf,
    const float* __restrict__ p_flen, int64_t n_postings, int64_t q,
    int64_t start, int64_t end, int4& d, float4& t, float4& f) {
  int dv[4] = {0, 0, 0, 0};
  float tv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float fv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int64_t p = q + e;
    if (p >= start && p < end && p >= 0 && p < n_postings) {
      tv[e] = p_tf[p];
      dv[e] = p_doc[p];
      fv[e] = p_flen[p];
    }
  }
  d = make_int4(dv[0], dv[1], dv[2], dv[3]);
  t = make_float4(tv[0], tv[1], tv[2], tv[3]);
  f = make_float4(fv[0], fv[1], fv[2], fv[3]);
}

// An L2 policy that keeps the lines it touches over evict-first ones.
__device__ __forceinline__ unsigned long long evict_last_policy() {
  unsigned long long pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(pol));
  return pol;
}

// *p += v, as a reduction (no result) under L2 policy `pol`.
__device__ __forceinline__ void red_add_keep(float* p, float v,
                                             unsigned long long pol) {
  asm volatile("red.global.add.L2::cache_hint.f32 [%0], %1, %2;"
               :: "l"(p), "f"(v), "l"(pol) : "memory");
}

// A persistent grid over the work list. kVec: the three posting columns
// are 16-byte aligned, so whole vectors inside the slab load as int4 /
// float4. kLocal: every block scans the work list into shared memory
// itself (n_pairs <= kLocalPairs); else it reads `cum` from the
// work_list_kernel.
template <bool kVec, bool kLocal>
__global__ void __launch_bounds__(kThreads, kMinBlocks) score_ranges_accumulate_kernel(
    const int32_t* __restrict__ p_doc,
    const float* __restrict__ p_tf,        // tf or exact_tf, chosen by the caller
    const float* __restrict__ p_flen,
    int64_t n_postings,
    const int32_t* __restrict__ starts,    // [R, NR]
    const int32_t* __restrict__ lens,      // [R, NR]
    const float* __restrict__ weight,      // [R, NR]
    const float* __restrict__ field_b,     // [R, NR]
    const float* __restrict__ avg,         // [R, NR]
    int64_t n_pairs,
    int64_t n_ranges,
    const long long* __restrict__ cum,     // [R * NR] unless kLocal
    float* __restrict__ acc,               // [R, cap]
    int64_t cap) {
  // the local work list: under kLocalPairs * 2^20 tiles (len < 2^31), so int32
  __shared__ int s_cum[kLocal ? kLocalPairs : 1];
  __shared__ long long s_warp_total[kThreads / 32];
  // per warp and vector slot: the (doc, ntf) of its 128 postings, written
  // as vectors and read back with lane l on posting 32 j + l
  __shared__ int4 s_doc[kThreads / 32][kVecsPerThread][32];
  __shared__ float4 s_ntf[kThreads / 32][kVecsPerThread][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned long long keep = evict_last_policy();
  if (kLocal) {
    scan_tiles<kThreads>(starts, lens, n_pairs, s_cum, s_warp_total);
    __syncthreads();
  }
  auto list = [&](int64_t i) -> long long {
    return kLocal ? (long long)s_cum[i] : cum[i];
  };
  const long long total = list(n_pairs - 1);
  for (long long item = blockIdx.x; item < total; item += gridDim.x) {
    // the item's pair: the first whose inclusive tile count passes it
    int64_t lo = 0, hi = n_pairs - 1;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (list(mid) > item) hi = mid; else lo = mid + 1;
    }
    const int64_t pair = lo;
    const long long tile = item - (pair > 0 ? list(pair - 1) : 0);
    const int32_t s32 = starts[pair];
    const int64_t start = s32;
    const int64_t end = start + lens[pair];
    const int64_t base = start - (s32 & 3);  // a 16-byte boundary of the slab
    const float wt = weight[pair];
    const float b = field_b[pair];
    const float one_minus_b = __fsub_rn(1.0f, b);
    const float avg_c = fmaxf(avg[pair], 1e-9f);
    // 64-bit row offset: R * cap passes 2^31 at R=4096, cap=2^20
    float* acc_row = acc + (pair / n_ranges) * cap;
    const int64_t q0 = base + 4 * (tile * kTileVecs + threadIdx.x);

    int4 d[kVecsPerThread];
    float4 t[kVecsPerThread];
    float4 f[kVecsPerThread];
#pragma unroll
    for (int k = 0; k < kVecsPerThread; ++k) {
      const int64_t q = q0 + 4 * (int64_t)k * kThreads;
      if (kVec && q >= 0 && q + 4 <= n_postings && q < end) {
        d[k] = __ldcs(reinterpret_cast<const int4*>(p_doc + q));
        t[k] = __ldcs(reinterpret_cast<const float4*>(p_tf + q));
        f[k] = __ldcs(reinterpret_cast<const float4*>(p_flen + q));
      } else {
        load_lanes(p_doc, p_tf, p_flen, n_postings, q, start, end,
                   d[k], t[k], f[k]);
      }
    }
    __syncwarp();  // the previous item's reads of s_doc / s_ntf are done
#pragma unroll
    for (int k = 0; k < kVecsPerThread; ++k) {
      const int64_t q = q0 + 4 * (int64_t)k * kThreads;
      int dv[4] = {d[k].x, d[k].y, d[k].z, d[k].w};
      const float tv[4] = {t[k].x, t[k].y, t[k].z, t[k].w};
      const float fv[4] = {f[k].x, f[k].y, f[k].z, f[k].w};
      float nv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t p = q + e;
        const float denom =
            __fadd_rn(one_minus_b, __fdiv_rn(__fmul_rn(b, fv[e]), avg_c));
        nv[e] = __fdiv_rn(__fmul_rn(wt, tv[e]), fmaxf(denom, 1e-9f));
        if (p < start || p >= end || !(tv[e] > 0.0f) || dv[e] < 0 ||
            (int64_t)dv[e] >= cap)
          dv[e] = -1;  // dropped
      }
      s_doc[warp][k][lane] = make_int4(dv[0], dv[1], dv[2], dv[3]);
      s_ntf[warp][k][lane] = make_float4(nv[0], nv[1], nv[2], nv[3]);
    }
    __syncwarp();
    // lane l takes postings 32 j + l of the warp's 128 per slot, so the
    // 32 lanes of each atomic instruction update 32 consecutive postings
    const int* w_doc = reinterpret_cast<const int*>(s_doc[warp]);
    const float* w_ntf = reinterpret_cast<const float*>(s_ntf[warp]);
#pragma unroll
    for (int j = 0; j < 4 * kVecsPerThread; ++j) {
      const int dj = w_doc[32 * j + lane];
      if (dj >= 0) red_add_keep(acc_row + dj, w_ntf[32 * j + lane], keep);
    }
  }
}

// The persistent grid: SMs times resident blocks of the kernel, per device.
int resident_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, score_ranges_accumulate_kernel<true, true>, kThreads, 0);
    cached[dev] = (sms > 0 ? sms : 132) * (per_sm > 0 ? per_sm : 1);
  }
  return cached[dev];
}

}  // namespace

// Each launcher enqueues on `stream` and returns cudaGetLastError() (0 on
// success); a refused launch never runs, so the caller must check it.

extern "C" int score_windows_launch(
    const void* p_doc, const void* p_tf, const void* p_flen,
    int64_t n_postings, const void* starts, const void* params,
    int64_t ns, int64_t w, void* docs_out, void* ntf_out, void* stream) {
  const int64_t total = ns * w;
  if (total <= 0) return 0;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kWindowBlocks) blocks = kWindowBlocks;
  score_windows_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)p_doc, (const float*)p_tf, (const float*)p_flen,
      n_postings, (const int32_t*)starts, (const float*)params, ns, w,
      (int32_t*)docs_out, (float*)ntf_out);
  return (int)cudaGetLastError();
}

// The work list alone, as the kernel sees it: work[i] = inclusive tile
// count of pairs 0..i.
extern "C" int score_ranges_work_list_launch(
    const void* starts, const void* lens, int64_t n_pairs, void* work,
    void* stream) {
  if (n_pairs <= 0) return 0;
  work_list_kernel<<<1, kScanThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)starts, (const int32_t*)lens, n_pairs,
      (long long*)work);
  return (int)cudaGetLastError();
}

// `work` is int64[n_rows * n_ranges] scratch for the work list of a call
// of more than kLocalPairs pairs. `max_len` bounds the lens (the plan's
// length bucket); it only caps the grid of a small call, so a low bound
// costs speed, not results.
extern "C" int score_ranges_accumulate_launch(
    const void* p_doc, const void* p_tf, const void* p_flen,
    int64_t n_postings, const void* starts, const void* lens,
    const void* weight, const void* field_b, const void* avg,
    int64_t n_rows, int64_t n_ranges, int64_t max_len,
    void* acc, int64_t cap, void* work, void* stream) {
  const int64_t pairs = n_rows * n_ranges;
  if (pairs <= 0 || max_len <= 0) return 0;
  const bool local = pairs <= kLocalPairs;
  if (!local) {
    const int err =
        score_ranges_work_list_launch(starts, lens, pairs, work, stream);
    if (err != 0) return err;
  }
  const int64_t tiles_per_pair =
      ((max_len + 6) / 4 + kTileVecs - 1) / kTileVecs;  // start & 3 <= 3
  int64_t blocks = resident_blocks();
  if (pairs * tiles_per_pair < blocks) blocks = pairs * tiles_per_pair;
  const bool vec = (((uintptr_t)p_doc | (uintptr_t)p_tf | (uintptr_t)p_flen)
                    & 15) == 0;
  auto kernel = vec ? (local ? score_ranges_accumulate_kernel<true, true>
                             : score_ranges_accumulate_kernel<true, false>)
                    : (local ? score_ranges_accumulate_kernel<false, true>
                             : score_ranges_accumulate_kernel<false, false>);
  kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)p_doc, (const float*)p_tf, (const float*)p_flen,
      n_postings, (const int32_t*)starts, (const int32_t*)lens,
      (const float*)weight, (const float*)field_b, (const float*)avg,
      pairs, n_ranges, (const long long*)work, (float*)acc, cap);
  return (int)cudaGetLastError();
}
