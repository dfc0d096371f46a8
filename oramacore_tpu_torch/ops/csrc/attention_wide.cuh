// Shared pieces of the attention kernels for head widths above 128
// (`encoder_attention_kernel(WideArgs)` in encoder_attention.cu, and the
// `attention_dq_kernel` / `attention_dkv_kernel` templates on a WideArgs in
// encoder_attention_backward.cu), whose tensor-core instances for widths
// up to 128 hold a warp's 16 x hd output in registers (64 a thread at hd
// 128); a wider head would not fit.
// - WideArgs, the column pointers of a (b, h) (q_of, k_of, v_of, do_of)
//   and the warp reductions serve all three kernels.
// - The rest serves the forward, which runs in f32 on the CUDA cores
//   (FFMA) with the head's columns walked in chunks of kChunk = 128: a
//   block of kThreadsW = 128 threads owns a tile of 16 query rows of one
//   (b, h); each score (q . k over the head width) runs tile against tile,
//   16 query rows against 32 keys, both staged through shared memory a
//   chunk of columns at a time (`dot_tile`), each thread summing 4 (row,
//   row) pairs in column order; the row of scores over all L keys stays in
//   shared memory, so O = P V reads each row of V once from device memory,
//   thread t owning column chunk + t.
// The backward kernels run their products on the tensor cores in 3xTF32
// and sum in another order, so their scores agree with the forward's to
// about an ulp, not to the bit; nothing relies on more.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace wide {

constexpr int kThreadsW = 128;
constexpr int kChunk = 128;      // head columns a shared-memory stage holds
constexpr int kRowsA = 16;       // rows of the tile's own side
constexpr int kRowsB = 32;       // rows of the other side a stage holds
constexpr int kPairs = kRowsA * kRowsB / kThreadsW;   // 4 a thread
constexpr float kMasked = -1e9f;

struct WideArgs {
  const float* qkv;      // (B, L, 3D): Q | K | V, head h at h * hd
  const int32_t* mask;   // (B, L) key mask
  const float* dctx;     // (B, L, D) (backward)
  float* out;            // ctx (B, L, D) or dqkv (B, L, 3D)
  float* stats;          // (B * H * L, 4): max, sum, delta per query row
  int B, L, H, hd;
  float div;
};

// floats of shared memory a tile stage takes: A rows (16 x 128), B rows
// (32 x 129, padded so a warp's reads of one column fall on 32 banks)
constexpr int kStageFloats = kRowsA * kChunk + kRowsB * (kChunk + 1);

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[p] = sum over the head's hd columns of A[ra] . B[rb] for the
// thread's pairs p (e = tid + 128 p, ra = e / 32, rb = e % 32: a warp
// shares its A row). Row r of A is a_base + (a0 + r) * a_stride, valid
// for a0 + r < L (zero otherwise); likewise B.
__device__ __forceinline__ void dot_tile(const float* a_base, int a0,
                                         int a_stride, const float* b_base,
                                         int b0, int b_stride, int L, int hd,
                                         float* As, float* Bs,
                                         float acc[kPairs]) {
  const int tid = threadIdx.x;
  for (int p = 0; p < kPairs; ++p) acc[p] = 0.f;
  for (int c0 = 0; c0 < hd; c0 += kChunk) {
    __syncthreads();
    for (int e = tid; e < kRowsA * kChunk; e += kThreadsW) {
      const int r = e / kChunk, c = e % kChunk;
      const int row = a0 + r, col = c0 + c;
      As[r * kChunk + c] = (row < L && col < hd)
          ? a_base[(size_t)row * a_stride + col] : 0.f;
    }
    for (int e = tid; e < kRowsB * kChunk; e += kThreadsW) {
      const int r = e / kChunk, c = e % kChunk;
      const int row = b0 + r, col = c0 + c;
      Bs[r * (kChunk + 1) + c] = (row < L && col < hd)
          ? b_base[(size_t)row * b_stride + col] : 0.f;
    }
    __syncthreads();
    const int n = min(kChunk, hd - c0);
    for (int p = 0; p < kPairs; ++p) {
      const int e = tid + kThreadsW * p;
      const float* a = As + (e / kRowsB) * kChunk;
      const float* b = Bs + (e % kRowsB) * (kChunk + 1);
      float s = acc[p];
      for (int d = 0; d < n; ++d) s = fmaf(a[d], b[d], s);
      acc[p] = s;
    }
  }
}

// pointers of (b, h)'s Q, K, V columns in the fused (B, L, 3D) layout and
// of its dO columns in (B, L, D)
__device__ __forceinline__ const float* q_of(const WideArgs& a, int b,
                                             int h) {
  return a.qkv + (size_t)b * a.L * 3 * a.H * a.hd + (size_t)h * a.hd;
}

__device__ __forceinline__ const float* k_of(const WideArgs& a, int b,
                                             int h) {
  return q_of(a, b, h) + (size_t)a.H * a.hd;
}

__device__ __forceinline__ const float* v_of(const WideArgs& a, int b,
                                             int h) {
  return q_of(a, b, h) + 2 * (size_t)a.H * a.hd;
}

__device__ __forceinline__ const float* do_of(const WideArgs& a, int b,
                                              int h) {
  return a.dctx + (size_t)b * a.L * a.H * a.hd + (size_t)h * a.hd;
}

// s / div + bias, as the tensor-core kernels form a score
__device__ __forceinline__ float score_of(float dot, float div,
                                          int32_t mask) {
  return __fdiv_rn(dot, div) + (mask > 0 ? 0.f : kMasked);
}

// the length of a row of scores in shared memory: L rounded up to whole
// tiles of 32 rows of the other side
__host__ __device__ __forceinline__ int padded_len(int L) {
  return (L + kRowsB - 1) / kRowsB * kRowsB;
}

}  // namespace wide
