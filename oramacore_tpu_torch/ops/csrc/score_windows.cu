// BM25F posting-window scoring for NVIDIA Hopper (sm_90a).
//
// Replaces oramacore_tpu/ops/pallas_score.py::score_windows, the Pallas
// kernel that DMAs (doc, tf, flen) posting windows into VMEM and computes
// the normalized term frequency
//
//     ntf = weight * tf / max((1 - b) + (b / avg) * flen, 1e-9)
//
// Two entry points share this source:
//
// * score_windows keeps the Pallas kernel's contract: NS windows of width
//   w at given starts, written out as docs int32[NS, w] and ntf f32[NS, w].
//   The TPU needed 1024-aligned starts (a Mosaic DMA rule); any start is
//   accepted here.
// * score_ranges_accumulate is the form the search path runs. It walks
//   each (row, range) posting range for exactly `len` slots, drops slots
//   with tf <= 0 or a doc outside [0, cap), and atomically adds ntf into
//   the caller's dense accumulator acc f32[R, cap]. On the TPU this was
//   two stages (window gather, then a one-hot MXU matmul or scatter into
//   the dense doc space, ops/bm25.py:_aggregate_dense) because the TPU has
//   no fast scatter; on Hopper a global atomic add is the scatter.
//
// What bounds it: device-memory bytes. Each posting reads 12 bytes (doc,
// tf, flen) and issues one 4-byte atomic into a row of up to 4 MiB, with
// no arithmetic worth counting. The design keeps the reads coalesced:
// consecutive threads take consecutive postings of one range, and a long
// range is split across several blocks (grid.y) so a few long ranges
// still fill the card. The atomics land wherever the doc ids point; with
// doc-sorted ranges neighbouring threads hit neighbouring words.
//
// Arithmetic uses the round-to-nearest intrinsics so the compiler fuses
// nothing into an FMA: results match the plain PyTorch version's operand
// order (ops/score_windows.py) up to the order of the atomic sums.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// slots per thread per block along a range before the next block takes over
constexpr int kSlotsPerThread = 8;
constexpr int64_t kMaxGridX = 2147483647;
constexpr int64_t kMaxGridY = 65535;
constexpr int64_t kWindowBlocks = 132 * 16;  // 16 resident blocks per SM

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

// grid.x: one (row, range) pair each; grid.y: slices of that range
__global__ void score_ranges_accumulate_kernel(
    const int32_t* __restrict__ p_doc,
    const float* __restrict__ p_tf,        // tf or exact_tf, chosen by the caller
    const float* __restrict__ p_flen,
    int64_t n_postings,
    const int32_t* __restrict__ starts,    // [R, NR]
    const int32_t* __restrict__ lens,      // [R, NR]
    const float* __restrict__ weight,      // [R, NR]
    const float* __restrict__ field_b,     // [R, NR]
    const float* __restrict__ avg,         // [R, NR]
    int64_t n_ranges,
    float* __restrict__ acc,               // [R, cap]
    int64_t cap) {
  const int64_t rr = blockIdx.x;
  const int64_t len = lens[rr];
  const int64_t stride = (int64_t)gridDim.y * blockDim.x;
  int64_t j = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= len) return;
  const int64_t start = starts[rr];
  const float wt = weight[rr];
  const float b = field_b[rr];
  const float one_minus_b = __fsub_rn(1.0f, b);
  const float avg_c = fmaxf(avg[rr], 1e-9f);
  // 64-bit row offset: R * cap passes 2^31 at B=4096, cap=2^20
  float* acc_row = acc + (rr / n_ranges) * cap;
  for (; j < len; j += stride) {
    const int64_t p = start + j;
    if (p < 0 || p >= n_postings) continue;
    const float tf = p_tf[p];
    if (!(tf > 0.0f)) continue;
    const int32_t d = p_doc[p];
    if (d < 0 || (int64_t)d >= cap) continue;
    const float denom =
        __fadd_rn(one_minus_b, __fdiv_rn(__fmul_rn(b, p_flen[p]), avg_c));
    atomicAdd(acc_row + d, __fdiv_rn(__fmul_rn(wt, tf), fmaxf(denom, 1e-9f)));
  }
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

extern "C" int score_ranges_accumulate_launch(
    const void* p_doc, const void* p_tf, const void* p_flen,
    int64_t n_postings, const void* starts, const void* lens,
    const void* weight, const void* field_b, const void* avg,
    int64_t n_rows, int64_t n_ranges, int64_t max_len,
    void* acc, int64_t cap, void* stream) {
  const int64_t pairs = n_rows * n_ranges;
  if (pairs <= 0 || max_len <= 0) return 0;
  if (pairs > kMaxGridX) return (int)cudaErrorInvalidConfiguration;
  const int64_t per_block = (int64_t)kThreads * kSlotsPerThread;
  int64_t slices = (max_len + per_block - 1) / per_block;
  if (slices > kMaxGridY) slices = kMaxGridY;
  const dim3 grid((unsigned)pairs, (unsigned)slices);
  score_ranges_accumulate_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)p_doc, (const float*)p_tf, (const float*)p_flen,
      n_postings, (const int32_t*)starts, (const int32_t*)lens,
      (const float*)weight, (const float*)field_b, (const float*)avg,
      n_ranges, (float*)acc, cap);
  return (int)cudaGetLastError();
}
