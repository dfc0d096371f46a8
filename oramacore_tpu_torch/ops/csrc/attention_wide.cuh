// Shared pieces of the attention kernels for head widths above 128: the
// forward (`encoder_attention_kernel<C, MT>` in encoder_attention.cu) and
// the gradient's `attention_dq_kernel<C>` / `attention_dkv_kernel<C>`
// (encoder_attention_backward.cu), whose tensor-core instances for widths
// up to 128 hold a warp's 16 x hd output in registers (64 a thread at hd
// 128); a wider head would not fit.
//
// All three run their products on the tensor cores in 3xTF32 (mma3,
// tf32_mma.cuh) and keep nothing of width hd in registers. A block of
// kWideWarps = 8 warps owns R rows of its side of one (b, h) (queries in
// the forward and in dq, keys in dkv) and keeps those rows' scores against
// all L rows of the other side in shared memory, in rows of
// `score_stride(L)` floats. Phase A forms them: the other side comes in
// tiles of kTile = 128 rows, a warp an n-slice of 16, and the head's
// columns in chunks of C through a two-stage cp.async ring (`stage_rows`)
// in rows of C + 4 floats, so a warp's fragment reads fall on 32 banks.
// Phase C multiplies the score rows with the other side's rows: the
// head's columns in passes of at most kPass = 128 (`Passes`), a warp an
// eighth of a pass, the other side's rows through the same ring in tiles
// of `tc` rows of kStrideC = 136 floats (a warp's reads down a column fall
// on 32 banks). Operands sit raw in shared memory and are split into tf32
// hi and lo as a fragment is read (`frag_a`, `frag_b_rows`,
// `frag_b_cols`).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace wide {

constexpr int kWideWarps = 8;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kTile = 16 * kWideWarps;    // phase A: other-side rows a tile
constexpr int kPass = 128;                // phase C: head columns a pass
constexpr int kStrideC = kPass + 8;       // phase C: floats a staged row

struct WideArgs {
  const float* qkv;      // (B, L, 3D): Q | K | V, head h at h * hd
  const int32_t* mask;   // (B, L) key mask
  const float* dctx;     // (B, L, D) (backward)
  float* out;            // ctx (B, L, D) or dqkv (B, L, 3D)
  float* stats;          // (B * H * L, 4): max, sum, delta per query row
  int B, L, H, hd;
  float div;
};

// floats a row of scores takes: L rounded up to whole tiles, plus 4 (an A
// fragment's reads of 8 rows x 4 columns fall on 32 banks)
__host__ __device__ constexpr int score_stride(int L) {
  return (L + kTile - 1) / kTile * kTile + 4;
}

// The shared memory of a block that owns R rows with OPS operands a side
// (the forward: Q against K, then V; the gradient: two of each) and keeps
// OPS score arrays of R rows: a ring of 2 stages, each a chunk of C
// columns of the own rows' operands and of the tile's.
template <int C, int R, int OPS>
struct TileLayout {
  static constexpr int kStrideA = C + 4;               // phase A row
  static constexpr int kStage = OPS * (R + kTile) * kStrideA;
  // phase C: other-side rows a stage holds with `ops` operands of a pass,
  // the largest power of 2 up to kTile that fits a stage
  __host__ __device__ static constexpr int tc(int ops) {
    int t = kTile;
    while (ops * t * kStrideC > kStage) t /= 2;
    return t;
  }
  __host__ __device__ static constexpr int floats(int L) {
    return OPS * R * score_stride(L) + 2 * kStage;
  }
};

// rows r0 .. r0 + n - 1 (zero from L on) and head columns c0 .. c0 + w - 1
// (zero from hd on) of `src` (row stride ld) into dst (row stride sd) by
// the block's threads through cp.async: 16 bytes a copy where `vec` (hd a
// multiple of 4, the operands 16-byte aligned), else 4
__device__ __forceinline__ void stage_rows(float* dst, int sd,
                                           const float* src, int64_t ld,
                                           int r0, int n, int L, int c0,
                                           int w, int hd, bool vec) {
  if (vec) {
    const int nv = w / 4;
    for (int e = threadIdx.x; e < n * nv; e += kWideThreads) {
      const int r = e / nv, c = 4 * (e % nv);
      const bool ok = r0 + r < L && c0 + c < hd;
      cp_async16(dst + r * sd + c,
                 ok ? src + (int64_t)(r0 + r) * ld + c0 + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < n * w; e += kWideThreads) {
      const int r = e / w, c = e % w;
      const bool ok = r0 + r < L && c0 + c < hd;
      cp_async4(dst + r * sd + c,
                ok ? src + (int64_t)(r0 + r) * ld + c0 + c : src, ok);
    }
  }
}

__device__ __forceinline__ float4 split2(float b0, float b1) {
  float4 r;
  split(b0, r.x, r.z);
  split(b1, r.y, r.w);
  return r;
}

// the A fragment of 16 rows x 8 columns at p (row stride ld), split
__device__ __forceinline__ void frag_a(const float* p, int ld, int g, int t,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const float x[4] = {p[g * ld + t], p[(g + 8) * ld + t], p[g * ld + t + 4],
                      p[(g + 8) * ld + t + 4]};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float hi, lo;
    split(x[e], hi, lo);
    ah[e] = __float_as_uint(hi);
    al[e] = __float_as_uint(lo);
  }
}

// the B fragment (n 8 x k 8) of mma3 from 8 rows n holding k along them
__device__ __forceinline__ float4 frag_b_rows(const float* p, int ld, int g,
                                              int t) {
  return split2(p[g * ld + t], p[g * ld + t + 4]);
}

// ... from 8 rows k holding n along them
__device__ __forceinline__ float4 frag_b_cols(const float* p, int ld, int g,
                                              int t) {
  return split2(p[t * ld + g], p[(t + 4) * ld + g]);
}

// phase C's columns: passes of at most kPass, a warp `wc` of them (whole
// n8 steps, at most kNt)
constexpr int kNt = kPass / (8 * kWideWarps);
struct Passes {
  int n, wc;
  __device__ explicit Passes(int hd) {
    n = (hd + kPass - 1) / kPass;
    wc = ((hd + n - 1) / n + 8 * kWideWarps - 1) / (8 * kWideWarps) * 8;
  }
};

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

// The grid, the row tiles and the shared memory come from the caller; the
// dynamic shared-memory attribute of `kernel` is raised to the largest
// size asked of it so far (`allowed`, the caller's own for the kernel).
template <typename Kernel>
int allow_smem(Kernel kernel, int64_t smem, int64_t& allowed) {
  if (smem <= allowed) return (int)cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) allowed = smem;
  return (int)err;
}

}  // namespace wide
