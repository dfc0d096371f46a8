// Encoder self-attention for NVIDIA Hopper (sm_90a).
//
// Replaces the attention of each layer of the jitted JAX function
// oramacore_tpu/embeddings/flax_encoder.py::bert_forward (its body at
// :97-105, no pallas_call): q, k, v reshaped to (B, L, H, hd), then
// einsum -> / sqrt(hd) -> + (0 or -1e9 from the key mask) -> softmax ->
// einsum, reshaped to (B, L, D). In eager PyTorch that is five launches a
// layer that send a (B, H, L, L) f32 score tensor through device memory
// three times (134 MB a layer at B=1024, L=64, H=8).
//
// Here one kernel reads Q, K and V straight from the (B, L, 3D) output of
// the fused projection (head h's columns at h * hd, D + h * hd and
// 2D + h * hd of a row) and writes ctx as (B, L, D): no reshape or
// transpose is materialized and no score leaves the chip.
//
// Per (b, h, query row i) it computes, in f32 FFMA:
//   s_j = (q_i . k_j) / div + bias_j,  div = f32(sqrt(hd)), a true IEEE
//         division as JAX divides; bias_j = 0 where mask[b, j] > 0, else
//         -1e9 added (never skipped, never -inf)
//   ctx_i = sum_j softmax(s)_j v_j
// A row whose keys are all masked thus sees every s_j - 1e9 rounded to
// the same f32 (ulp 64 there) and gets the mean of V, as in JAX; keys
// past L do not exist and weigh exactly 0. Query rows past the true
// length are computed too, as JAX computes them.
//
// What bounds it: at SemanticBase's B=1024, L=64 (H=8, hd=32) device
// memory, 4 * B * L * D * 4 bytes of Q, K, V and ctx (268 MB, 80 us at
// 3.35 TB/s) against 4 * B * H * L^2 * hd FLOP (4.3 G, 64 us at the
// 66.9 TFLOP/s f32 FFMA peak); at BGEBase's geometry (H=12, hd=64) with
// L=512, the FLOPs. Tensor cores are not used: TF32 would break the
// port's no-TF32 rule for f32 products.
//
// Design (simple first): a block of 128 threads takes one (b, h) and
// 128 / S query rows; S lanes (neighbours in a warp) share a query row
// and split its keys, so short batches still fill the card (the wrapper
// picks S in {1, 2, 4, 8}). A thread keeps its q row and its ctx
// accumulator in registers. K and V are staged 64 keys at a time in
// shared memory, rows padded to hd + 4 floats so the S rows a warp reads
// at once fall on distinct banks (16-byte loads, broadcast to the lanes
// of a row). A thread takes its keys 8 at a time: 8 dot products as 8
// independent FFMA chains, one online-softmax rescale of the accumulator
// per 8 keys, then 8 rank-1 updates. The S partial (max, sum, ctx) of a
// row are merged with warp shuffles at the end.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kKeyTile = 64;     // keys staged in shared memory at once
constexpr int kChunk = 8;        // keys a thread scores between rescales
constexpr float kMasked = -1e9f;
constexpr unsigned kAll = 0xffffffffu;

template <int HD, int S>
__global__ void __launch_bounds__(kThreads)
encoder_attention_kernel(const float* __restrict__ qkv,     // [B, L, 3D]
                         const int32_t* __restrict__ mask,  // [B, L]
                         float* __restrict__ ctx,           // [B, L, D]
                         int L, int H, int q_tiles, float div) {
  static_assert(HD % 4 == 0, "head width in 16-byte chunks");
  static_assert((kKeyTile / S) % kChunk == 0, "whole chunks per tile");
  constexpr int kRows = kThreads / S;   // query rows of a block
  constexpr int kStride = HD + 4;       // padded shared-memory row, floats
  constexpr int kVecs = HD / 4;
  __shared__ __align__(16) float k_s[kKeyTile * kStride];
  __shared__ __align__(16) float v_s[kKeyTile * kStride];
  __shared__ float bias_s[kKeyTile];

  const int b = blockIdx.x / q_tiles;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int s = tid % S;
  const int qi = (blockIdx.x % q_tiles) * kRows + tid / S;
  const int D = H * HD;
  const int64_t row_stride = 3 * (int64_t)D;
  const float* base = qkv + (int64_t)b * L * row_stride + (int64_t)h * HD;

  float q[HD];
  {
    const float4* qp = reinterpret_cast<const float4*>(
        base + (int64_t)min(qi, L - 1) * row_stride);
#pragma unroll
    for (int c = 0; c < kVecs; ++c) {
      const float4 t = __ldg(qp + c);
      q[4 * c] = t.x; q[4 * c + 1] = t.y; q[4 * c + 2] = t.z; q[4 * c + 3] = t.w;
    }
  }
  float o[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) o[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int t0 = 0; t0 < L; t0 += kKeyTile) {
    const int nk = min(kKeyTile, L - t0);
    // stage the tile's K and V rows; rows past L are zeros (weight 0)
    for (int e = tid; e < kKeyTile * kVecs; e += kThreads) {
      const int j = e / kVecs, c = e % kVecs;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (j < nk) {
        const float* rp = base + (int64_t)(t0 + j) * row_stride;
        kk = __ldg(reinterpret_cast<const float4*>(rp + D) + c);
        vv = __ldg(reinterpret_cast<const float4*>(rp + 2 * D) + c);
      }
      *reinterpret_cast<float4*>(&k_s[j * kStride + 4 * c]) = kk;
      *reinterpret_cast<float4*>(&v_s[j * kStride + 4 * c]) = vv;
    }
    for (int j = tid; j < kKeyTile; j += kThreads) {
      bias_s[j] = (j < nk && mask[(int64_t)b * L + t0 + j] > 0) ? 0.f
                                                                  : kMasked;
    }
    __syncthreads();

    // this thread's keys of the tile: s, s + S, s + 2S, ... below nk
    const int mine = (nk - s + S - 1) / S;
    for (int c0 = 0; c0 < mine; c0 += kChunk) {
      float sc[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) sc[u] = 0.f;
#pragma unroll
      for (int c = 0; c < kVecs; ++c) {
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const float4 kk = *reinterpret_cast<const float4*>(
              &k_s[(s + (c0 + u) * S) * kStride + 4 * c]);
          sc[u] = fmaf(q[4 * c], kk.x, sc[u]);
          sc[u] = fmaf(q[4 * c + 1], kk.y, sc[u]);
          sc[u] = fmaf(q[4 * c + 2], kk.z, sc[u]);
          sc[u] = fmaf(q[4 * c + 3], kk.w, sc[u]);
        }
      }
      float cmax = -INFINITY;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float x = sc[u] / div + bias_s[s + (c0 + u) * S];
        sc[u] = (c0 + u < mine) ? x : -INFINITY;
        cmax = fmaxf(cmax, sc[u]);
      }
      // cmax is finite: key c0 of this thread is in the tile
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);   // 0 while m is -inf
      l *= alpha;
#pragma unroll
      for (int d = 0; d < HD; ++d) o[d] *= alpha;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float p = expf(sc[u] - m_new);   // 0 for keys past the tile
        l += p;
        const float* vr = &v_s[(s + (c0 + u) * S) * kStride];
#pragma unroll
        for (int c = 0; c < kVecs; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + 4 * c);
          o[4 * c] = fmaf(p, vv.x, o[4 * c]);
          o[4 * c + 1] = fmaf(p, vv.y, o[4 * c + 1]);
          o[4 * c + 2] = fmaf(p, vv.z, o[4 * c + 2]);
          o[4 * c + 3] = fmaf(p, vv.w, o[4 * c + 3]);
        }
      }
      m = m_new;
    }
    __syncthreads();
  }

  // merge the S partial softmaxes of a row (lanes s = 0..S-1 of it)
#pragma unroll
  for (int off = S / 2; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(kAll, m, off);
    const float l2 = __shfl_xor_sync(kAll, l, off);
    const float mn = fmaxf(m, m2);
    const float a1 = (m == -INFINITY) ? 0.f : expf(m - mn);
    const float a2 = (m2 == -INFINITY) ? 0.f : expf(m2 - mn);
    l = l * a1 + l2 * a2;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      const float o2 = __shfl_xor_sync(kAll, o[d], off);
      o[d] = o[d] * a1 + o2 * a2;
    }
    m = mn;
  }

  if (qi < L) {
    float4* out = reinterpret_cast<float4*>(
        ctx + ((int64_t)b * L + qi) * D + (int64_t)h * HD);
#pragma unroll
    for (int c = 0; c < kVecs; ++c) {
      if (c % S == s) {
        out[c] = make_float4(o[4 * c] / l, o[4 * c + 1] / l,
                             o[4 * c + 2] / l, o[4 * c + 3] / l);
      }
    }
  }
}

template <int HD, int S>
int launch(const float* qkv, const int32_t* mask, float* ctx, int B, int L,
           int H, float div, cudaStream_t stream) {
  constexpr int kRows = kThreads / S;
  const int q_tiles = (L + kRows - 1) / kRows;
  const int64_t blocks = (int64_t)B * q_tiles;
  if (blocks > 2147483647LL || H > 65535) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const dim3 grid((unsigned)blocks, (unsigned)H);
  encoder_attention_kernel<HD, S><<<grid, kThreads, 0, stream>>>(
      qkv, mask, ctx, L, H, q_tiles, div);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(int S, const float* qkv, const int32_t* mask, float* ctx,
              int B, int L, int H, float div, cudaStream_t stream) {
  switch (S) {
    case 1: return launch<HD, 1>(qkv, mask, ctx, B, L, H, div, stream);
    case 2: return launch<HD, 2>(qkv, mask, ctx, B, L, H, div, stream);
    case 4: return launch<HD, 4>(qkv, mask, ctx, B, L, H, div, stream);
    case 8: return launch<HD, 8>(qkv, mask, ctx, B, L, H, div, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Enqueues on `stream` and returns cudaGetLastError() (0 on success); a
// refused launch never runs, so the caller must check it. The caller
// guarantees contiguous f32 qkv [B, L, 3 * H * hd] and ctx [B, L, H * hd],
// both 16-byte aligned, int32 mask [B, L], 1 <= L, hd in {32, 64} and
// S in {1, 2, 4, 8}.
extern "C" int encoder_attention_launch(const void* qkv, const void* mask,
                                        void* ctx, int64_t B, int64_t L,
                                        int64_t H, int64_t hd, int64_t S,
                                        float div, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (L > 2147483647LL || B > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  const float* q = (const float*)qkv;
  const int32_t* mk = (const int32_t*)mask;
  float* out = (float*)ctx;
  cudaStream_t st = (cudaStream_t)stream;
  if (hd == 32) return launch_hd<32>((int)S, q, mk, out, (int)B, (int)L, (int)H, div, st);
  if (hd == 64) return launch_hd<64>((int)S, q, mk, out, (int)B, (int)L, (int)H, div, st);
  return (int)cudaErrorInvalidValue;
}
