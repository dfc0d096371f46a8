// The gradient of the encoder's self-attention, for NVIDIA Hopper (sm_90a).
//
// Replaces what JAX's autodiff derives from the attention lines of
// oramacore_tpu/embeddings/flax_encoder.py::bert_forward (:97-105) inside
// the jitted `train_step` of scripts/train_semantic_encoder_v2.py (:304):
// the vjp of
//   s_ij = (q_i . k_j) / div + bias_j,  P = softmax_j(s),  o_i = sum_j P_ij v_j
// with div = f32(sqrt(hd)) and bias_j = 0 where mask[b, j] > 0, else -1e9
// added. Given dO (the cotangent of ctx), per (b, h):
//   dV_j = sum_i P_ij dO_i
//   dP_ij = dO_i . v_j
//   delta_i = sum_j P_ij dP_ij
//   dS_ij = P_ij (dP_ij - delta_i)
//   dQ_i = sum_j (dS_ij / div) k_j,   dK_j = sum_i (dS_ij / div) q_i
// Divisions are IEEE quotients (__fdiv_rn), as JAX divides by sqrt(hd) and
// as its softmax divides by the row sum; the -1e9 is added, never skipped,
// so a batch row whose keys are all masked sees every s_ij round to -1e9
// (f32 ulp 64 there): P is uniform over its L keys and dS is not zero, as
// in JAX's autodiff.
//
// Inputs are the forward's: qkv f32[B, L, 3D] (Q, K, V side by side, head
// h at columns h * hd of each), mask int32[B, L], and dctx f32[B, L, D];
// the output dqkv f32[B, L, 3D] is in the same fused layout, so the
// projection's backward takes it as it stands.
//
// Two entry points, in stream order (FlashAttention-2's split):
// - attention_dq_kernel takes query rows. Pass 1 over the keys recomputes
//   each row's max m and sum l of exp(s - m) online, and delta beside them
//   as sum_j exp(s_ij - m) dP_ij rescaled with l (then / l): delta comes
//   from P and dP, JAX's own softmax vjp, so the kernels need no saved
//   ctx. Pass 2 recomputes P = exp(s - m) / l and dP, and sums dQ. It
//   stores (m, l, delta) of every row in a scratch the wrapper allocates.
// - attention_dkv_kernel takes key rows: it walks the query rows,
//   recomputes P from the stored (m, l) and dP, and sums dK and dV.
// Both score with the same lanes, dims and shuffle tree, so they see the
// same s_ij to the bit.
//
// What bounds it on the H100: its FLOPs, 2 hd a product per (b, h, i, j)
// (S and dP in both kernels, dQ in one, dK and dV in the other: 14 hd a
// pair in all) at the f32 FFMA rate; the bytes (qkv, dctx, dqkv, the
// mask and the statistics) only at B=1024, L=16. This first design is
// simple SIMT f32 (no tensor core, so no TF32): G = hd / 8 neighbouring
// lanes share a row and hold 8 of its dims each (q, dO and the dQ sums;
// or k, v and the dK and dV sums), and each dot product ends with log2(G)
// shuffles. The other side's rows are staged 32 at a time in shared
// memory, padded to hd + 4 floats, and read as 16-byte broadcasts.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kDims = 8;         // dims of a row a lane holds
constexpr int kTile = 32;        // rows of the other side staged at once
constexpr float kMasked = -1e9f;
constexpr unsigned kAll = 0xffffffffu;

template <int HD>
struct Geometry {
  static constexpr int G = HD / kDims;      // lanes of a row
  static constexpr int R = kThreads / G;    // rows a block
  static constexpr int kStride = HD + 4;    // padded shared-memory row
  static constexpr int kVecs = HD / 4;      // float4 a row
  static_assert(HD % 16 == 0 && G <= 32 && (32 % G) == 0, "lanes a row");
};

__device__ __forceinline__ void load8(const float* p, float (&x)[kDims]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&x)[kDims]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// x . (8 floats of shared memory), d ascending
__device__ __forceinline__ float dot8(const float (&x)[kDims],
                                      const float* s) {
  const float4 a = *reinterpret_cast<const float4*>(s);
  const float4 b = *reinterpret_cast<const float4*>(s + 4);
  float acc = 0.f;
  acc = fmaf(x[0], a.x, acc); acc = fmaf(x[1], a.y, acc);
  acc = fmaf(x[2], a.z, acc); acc = fmaf(x[3], a.w, acc);
  acc = fmaf(x[4], b.x, acc); acc = fmaf(x[5], b.y, acc);
  acc = fmaf(x[6], b.z, acc); acc = fmaf(x[7], b.w, acc);
  return acc;
}

// y += a * (8 floats of shared memory)
__device__ __forceinline__ void axpy8(float a, const float* s,
                                      float (&y)[kDims]) {
  const float4 u = *reinterpret_cast<const float4*>(s);
  const float4 w = *reinterpret_cast<const float4*>(s + 4);
  y[0] = fmaf(a, u.x, y[0]); y[1] = fmaf(a, u.y, y[1]);
  y[2] = fmaf(a, u.z, y[2]); y[3] = fmaf(a, u.w, y[3]);
  y[4] = fmaf(a, w.x, y[4]); y[5] = fmaf(a, w.y, y[5]);
  y[6] = fmaf(a, w.z, y[6]); y[7] = fmaf(a, w.w, y[7]);
}

// the sums of a row's G lanes, on every one of them
template <int G>
__device__ __forceinline__ void row_sum2(float& x, float& y) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    x += __shfl_xor_sync(kAll, x, off);
    y += __shfl_xor_sync(kAll, y, off);
  }
}

// rows [r0, r0 + kTile) of two (L, *) row sets into shared memory (row
// stride `gstride` floats in device memory; rows past L are zeros)
template <int HD>
__device__ __forceinline__ void stage2(const float* a, const float* b,
                                       int64_t gstride, int r0, int L,
                                       float* a_s, float* b_s) {
  using Geo = Geometry<HD>;
  for (int e = threadIdx.x; e < kTile * Geo::kVecs; e += kThreads) {
    const int r = e / Geo::kVecs, c = e % Geo::kVecs;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (r0 + r < L) {
      x = __ldg(reinterpret_cast<const float4*>(a + (r0 + r) * gstride) + c);
      y = __ldg(reinterpret_cast<const float4*>(b + (r0 + r) * gstride) + c);
    }
    *reinterpret_cast<float4*>(a_s + r * Geo::kStride + 4 * c) = x;
    *reinterpret_cast<float4*>(b_s + r * Geo::kStride + 4 * c) = y;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_dq_kernel(const float* __restrict__ qkv,     // [B, L, 3D]
                    const int32_t* __restrict__ mask,  // [B, L]
                    const float* __restrict__ dctx,    // [B, L, D]
                    float* __restrict__ dqkv,          // [B, L, 3D]
                    float4* __restrict__ stats,        // [B * H, L]
                    int L, int H, int q_tiles, float div) {
  using Geo = Geometry<HD>;
  constexpr int G = Geo::G;
  __shared__ __align__(16) float k_s[kTile * Geo::kStride];
  __shared__ __align__(16) float v_s[kTile * Geo::kStride];
  __shared__ float bias_s[kTile];

  const int bh = blockIdx.x / q_tiles;
  const int b = bh / H, h = bh % H;
  const int c = threadIdx.x % G;                 // dims 8c .. 8c + 7
  const int qi = (blockIdx.x % q_tiles) * Geo::R + threadIdx.x / G;
  const int row = min(qi, L - 1);                // rows past L repeat L - 1
  const int D = H * HD;
  const int64_t rs = 3 * (int64_t)D;
  const float* base = qkv + (int64_t)b * L * rs + (int64_t)h * HD;
  const int32_t* mrow = mask + (int64_t)b * L;

  float q[kDims], dout[kDims];
  load8(base + row * rs + kDims * c, q);
  load8(dctx + ((int64_t)b * L + row) * D + (int64_t)h * HD + kDims * c, dout);

  auto stage = [&](int t0) {
    stage2<HD>(base + D, base + 2 * D, rs, t0, L, k_s, v_s);
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
      bias_s[j] = (t0 + j < L && mrow[t0 + j] > 0) ? 0.f : kMasked;
    }
    __syncthreads();
  };
  // s and dP of key j of the staged tile
  auto score = [&](int j, float& s, float& dp) {
    float ps = dot8(q, k_s + j * Geo::kStride + kDims * c);
    dp = dot8(dout, v_s + j * Geo::kStride + kDims * c);
    row_sum2<G>(ps, dp);
    s = __fdiv_rn(ps, div) + bias_s[j];
  };

  // pass 1: m, l and delta, online
  float m = -INFINITY, l = 0.f, dt = 0.f;
  for (int t0 = 0; t0 < L; t0 += kTile) {
    stage(t0);
    const int nk = min(kTile, L - t0);
    for (int j = 0; j < nk; ++j) {
      float s, dp;
      score(j, s, dp);
      if (s > m) {
        const float a = expf(m - s);   // 0 at the first key
        l = fmaf(l, a, 1.f);
        dt = fmaf(dt, a, dp);
        m = s;
      } else {
        const float p = expf(s - m);
        l += p;
        dt = fmaf(p, dp, dt);
      }
    }
    __syncthreads();
  }
  const float delta = __fdiv_rn(dt, l);

  // pass 2: dQ
  float dq[kDims];
#pragma unroll
  for (int d = 0; d < kDims; ++d) dq[d] = 0.f;
  for (int t0 = 0; t0 < L; t0 += kTile) {
    stage(t0);
    const int nk = min(kTile, L - t0);
    for (int j = 0; j < nk; ++j) {
      float s, dp;
      score(j, s, dp);
      const float p = __fdiv_rn(expf(s - m), l);
      const float t = __fdiv_rn(p * (dp - delta), div);
      axpy8(t, k_s + j * Geo::kStride + kDims * c, dq);
    }
    __syncthreads();
  }
  if (qi < L) {
    store8(dqkv + ((int64_t)b * L + qi) * rs + (int64_t)h * HD + kDims * c,
           dq);
    if (c == 0) stats[(int64_t)bh * L + qi] = make_float4(m, l, delta, 0.f);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_dkv_kernel(const float* __restrict__ qkv,     // [B, L, 3D]
                     const int32_t* __restrict__ mask,  // [B, L]
                     const float* __restrict__ dctx,    // [B, L, D]
                     const float4* __restrict__ stats,  // [B * H, L]
                     float* __restrict__ dqkv,          // [B, L, 3D]
                     int L, int H, int k_tiles, float div) {
  using Geo = Geometry<HD>;
  constexpr int G = Geo::G;
  __shared__ __align__(16) float q_s[kTile * Geo::kStride];
  __shared__ __align__(16) float do_s[kTile * Geo::kStride];
  __shared__ float4 st_s[kTile];

  const int bh = blockIdx.x / k_tiles;
  const int b = bh / H, h = bh % H;
  const int c = threadIdx.x % G;
  const int kj = (blockIdx.x % k_tiles) * Geo::R + threadIdx.x / G;
  const int key = min(kj, L - 1);
  const int D = H * HD;
  const int64_t rs = 3 * (int64_t)D;
  const float* base = qkv + (int64_t)b * L * rs + (int64_t)h * HD;

  float k[kDims], v[kDims];
  load8(base + key * rs + D + kDims * c, k);
  load8(base + key * rs + 2 * D + kDims * c, v);
  const float bias = mask[(int64_t)b * L + key] > 0 ? 0.f : kMasked;
  float dk[kDims], dv[kDims];
#pragma unroll
  for (int d = 0; d < kDims; ++d) dk[d] = dv[d] = 0.f;

  for (int i0 = 0; i0 < L; i0 += kTile) {
    // Q rows (stride 3D) and dO rows (stride D) of the tile, with the
    // rows' statistics
    for (int e = threadIdx.x; e < kTile * Geo::kVecs; e += kThreads) {
      const int r = e / Geo::kVecs, cc = e % Geo::kVecs;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
      if (i0 + r < L) {
        x = __ldg(reinterpret_cast<const float4*>(base + (i0 + r) * rs) + cc);
        y = __ldg(reinterpret_cast<const float4*>(
                      dctx + ((int64_t)b * L + i0 + r) * D + (int64_t)h * HD) +
                  cc);
      }
      *reinterpret_cast<float4*>(q_s + r * Geo::kStride + 4 * cc) = x;
      *reinterpret_cast<float4*>(do_s + r * Geo::kStride + 4 * cc) = y;
    }
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      st_s[r] = i0 + r < L ? stats[(int64_t)bh * L + i0 + r]
                           : make_float4(0.f, 1.f, 0.f, 0.f);
    }
    __syncthreads();
    const int ni = min(kTile, L - i0);
    for (int i = 0; i < ni; ++i) {
      const float* qr = q_s + i * Geo::kStride + kDims * c;
      const float* dor = do_s + i * Geo::kStride + kDims * c;
      float ps = dot8(k, qr), dp = dot8(v, dor);
      row_sum2<G>(ps, dp);
      const float s = __fdiv_rn(ps, div) + bias;
      const float4 st = st_s[i];   // (m, l, delta, 0) of query row i0 + i
      const float p = __fdiv_rn(expf(s - st.x), st.y);
      axpy8(p, dor, dv);
      const float t = __fdiv_rn(p * (dp - st.z), div);
      axpy8(t, qr, dk);
    }
    __syncthreads();
  }
  if (kj < L) {
    float* out = dqkv + ((int64_t)b * L + kj) * rs + (int64_t)h * HD +
                 kDims * c;
    store8(out + D, dk);
    store8(out + 2 * D, dv);
  }
}

template <int HD>
int64_t tiles_of(int64_t L) {
  return (L + Geometry<HD>::R - 1) / Geometry<HD>::R;
}

template <int HD>
int launch_dq(const float* qkv, const int32_t* mask, const float* dctx,
              float* dqkv, float4* stats, int64_t B, int64_t L, int64_t H,
              float div, cudaStream_t stream) {
  const int64_t tiles = tiles_of<HD>(L);
  const int64_t blocks = B * H * tiles;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  attention_dq_kernel<HD><<<(unsigned)blocks, kThreads, 0, stream>>>(
      qkv, mask, dctx, dqkv, stats, (int)L, (int)H, (int)tiles, div);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(const float* qkv, const int32_t* mask, const float* dctx,
               const float4* stats, float* dqkv, int64_t B, int64_t L,
               int64_t H, float div, cudaStream_t stream) {
  const int64_t tiles = tiles_of<HD>(L);
  const int64_t blocks = B * H * tiles;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  attention_dkv_kernel<HD><<<(unsigned)blocks, kThreads, 0, stream>>>(
      qkv, mask, dctx, stats, dqkv, (int)L, (int)H, (int)tiles, div);
  return (int)cudaGetLastError();
}

bool valid(int64_t B, int64_t L, int64_t H, int64_t hd, float div) {
  return B > 0 && H > 0 && L >= 1 && L <= 512 &&
         B * L <= 2147483647LL &&
         (hd == 16 || hd == 32 || hd == 64 || hd == 128) &&
         div == (float)sqrt((double)hd);
}

}  // namespace

// Both enqueue on `stream` and return cudaGetLastError() (0 on success);
// a refused launch never runs, so the caller must check it. The caller
// guarantees contiguous f32 qkv and dqkv [B, L, 3 * H * hd] and dctx
// [B, L, H * hd], all 16-byte aligned, int32 mask [B, L], f32 stats
// [B * H * L * 4] 16-byte aligned, 1 <= L <= 512, hd in {16, 32, 64, 128}
// and div = f32(sqrt(hd)). dq writes dQ (the first D columns of dqkv) and
// the stats; dkv, launched after it on the same stream, reads the stats
// and writes dK and dV.
extern "C" int encoder_attention_backward_dq_launch(
    const void* qkv, const void* mask, const void* dctx, void* dqkv,
    void* stats, int64_t B, int64_t L, int64_t H, int64_t hd, float div,
    void* stream) {
  if (!valid(B, L, H, hd, div)) return (int)cudaErrorInvalidValue;
  const float* q = (const float*)qkv;
  const int32_t* mk = (const int32_t*)mask;
  const float* g = (const float*)dctx;
  float* out = (float*)dqkv;
  float4* st = (float4*)stats;
  cudaStream_t s = (cudaStream_t)stream;
  if (hd == 16) return launch_dq<16>(q, mk, g, out, st, B, L, H, div, s);
  if (hd == 32) return launch_dq<32>(q, mk, g, out, st, B, L, H, div, s);
  if (hd == 64) return launch_dq<64>(q, mk, g, out, st, B, L, H, div, s);
  return launch_dq<128>(q, mk, g, out, st, B, L, H, div, s);
}

extern "C" int encoder_attention_backward_dkv_launch(
    const void* qkv, const void* mask, const void* dctx, const void* stats,
    void* dqkv, int64_t B, int64_t L, int64_t H, int64_t hd, float div,
    void* stream) {
  if (!valid(B, L, H, hd, div)) return (int)cudaErrorInvalidValue;
  const float* q = (const float*)qkv;
  const int32_t* mk = (const int32_t*)mask;
  const float* g = (const float*)dctx;
  const float4* st = (const float4*)stats;
  float* out = (float*)dqkv;
  cudaStream_t s = (cudaStream_t)stream;
  if (hd == 16) return launch_dkv<16>(q, mk, g, st, out, B, L, H, div, s);
  if (hd == 32) return launch_dkv<32>(q, mk, g, st, out, B, L, H, div, s);
  if (hd == 64) return launch_dkv<64>(q, mk, g, st, out, B, L, H, div, s);
  return launch_dkv<128>(q, mk, g, st, out, B, L, H, div, s);
}
