// Encoder self-attention for NVIDIA Hopper (sm_90a), on the tensor cores.
//
// Replaces the attention of each layer of the jitted JAX function
// oramacore_tpu/embeddings/flax_encoder.py::bert_forward (its body at
// :97-105, no pallas_call): q, k, v reshaped to (B, L, H, hd), then
// einsum -> / sqrt(hd) -> + (0 or -1e9 from the key mask) -> softmax ->
// einsum, reshaped to (B, L, D). One kernel reads Q, K and V straight from
// the (B, L, 3D) output of the fused projection (head h's columns at
// h * hd, D + h * hd and 2D + h * hd of a row) and writes ctx as
// (B, L, D): no reshape or transpose is materialized and no score leaves
// the chip.
//
// Per (b, h, query row i):
//   s_j = (q_i . k_j) / div + bias_j,  div = f32(sqrt(hd)), the correctly
//         rounded quotient as JAX divides (see div_rn; at hd 16 and 64,
//         div = 4 and 8 are powers of two and the product by 0.25 or
//         0.125 is that quotient, the kExactDiv instances); a caller that
//         zero-pads narrower heads to hd passes its true width's divisor,
//         which takes div_rn at every hd;
//         bias_j = 0 where mask[b, j] > 0, else -1e9 added (never
//         skipped, never -inf)
//   ctx_i = sum_j softmax(s)_j v_j
// A row whose keys are all masked thus sees every s_j - 1e9 rounded to
// the same f32 (ulp 64 there) and gets the mean of V, as in JAX; keys
// past L do not exist and weigh exactly 0 (their scores are -inf). Query
// rows past the true length are computed too, as JAX computes them.
//
// Products: both S = Q K^T and O = P V run on the tensor cores as
// mma.sync.m16n8k8 with tf32 operands and f32 accumulation, split 3xTF32
// so they keep f32 accuracy: each f32 operand x becomes hi = tf32(x) and
// lo = tf32(x - hi), rounded as cvt.rna.tf32.f32 rounds (to 10 mantissa
// bits, ties away from zero; done here by adding half a tf32 ulp to the
// bits and cutting, which is that rounding for every finite x and +-inf,
// in two integer operations without the cvt's NaN test), and
// D += a_lo b_hi; D += a_hi b_lo; D += a_hi b_hi (small terms first; the
// dropped a_lo b_lo is below 2^-22 of the product). A single tf32 pass
// keeps about three decimal digits and is never used.
//
// What bounds it on the H100: at the bundled checkpoints' B=1024 (hd 32,
// L <= 64) device memory, 4 B L D f32 of Q, K, V and ctx; at BGEBase's
// geometry (12 heads of 64, L = 512) the 3xTF32 products, 3 x 4 B H L^2 hd
// tensor-core FLOP at the published 495 TFLOP/s TF32 rate. What limits it
// in fact, at every case (the bench's limit cases, bytes only and math
// only): the math. mma.sync reaches the tensor cores at a fraction of the
// wgmma rate, and the splits, the division and the softmax add a few
// instructions to each mma.sync.
//
// Design (FlashAttention-2's shape). A block has 4 warps; each warp owns
// 16 query rows of one (b, h) and keeps their Q fragments in registers
// (split once up to hd 64; at hd 128 raw, split at each use), its O
// accumulator (16 x hd) and its rows' running max and sum.
// W warps share one (b, h) (W = 4 for L > 32: 64 query rows a block;
// W = 2 and 1 below, so a block serves 2 or 4 (b, h) pairs and short
// sequences waste no tile). The warps of a (b, h) walk its keys in tiles
// of KT (64 at hd 16 and 32, 32 at hd 64, 16 at hd 128, so a block's
// stages fit beside another block's), brought by 16-byte cp.async (4-byte
// for the mask) into a ring of two raw stages, zero-filled past L, so
// tile t + 1 is in flight while tile t is computed. Each landed tile is
// split once for the block into a split stage (hi and lo side by side,
// in the order the fragments read them) with the mask turned into the
// bias, so the W warps that read it do not split it W times. Then per
// warp: S with the 3xTF32 MMA, the division and the bias, the online
// softmax per row (row max and sum across the quad by two shuffles), and
// O += P V with the 3xTF32 MMA.
//
// Fragment layouts. m16n8k8's A fragment holds (row g, col t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4) for lane = 4g + t; its C fragment holds
// (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1). A product sums over
// k, so any relabeling of k that A and B share leaves it unchanged:
// - Q K^T: k-step s's columns t and t + 4 stand for d = 8s + 2t and
//   8s + 2t + 1, so a lane reads its Q as float2 and its K fragment as one
//   float4 (hi d, hi d + 1, lo d, lo d + 1); split K rows are padded to
//   2 hd + 16 floats, so a quarter-warp's 16-byte reads fall on 32 banks.
// - P V: key step s's columns t and t + 4 stand for keys 8s + 2t and
//   8s + 2t + 1, which is where the C fragment of S already holds them:
//   the S registers are P's A fragment as they stand, with no shuffle or
//   shared-memory bounce. Split V is stored by key pairs: one float4
//   (hi key 2p, hi key 2p + 1, lo 2p, lo 2p + 1) per d, rows of 4 hd + 8
//   floats, so B's fragment is one conflict-free 16-byte read.
//
// Three switches for the bench's limit cases (mode): 1 moves the bytes
// only (Q, K, V in, ctx out, no math), 2 does the math only (no load from
// device memory), 3 runs the mma.sync sequence only (no load, no split
// pass, no softmax: the products of S and P V with their dependences, on
// operands held in registers). The main path always runs mode 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_wide.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kMasked = -1e9f;
constexpr unsigned kAll = 0xffffffffu;

template <int HD, int KT>
struct Tile {
  // a raw stage, as cp.async lands it: K [KT][HD], V [KT][HD], mask [KT]
  static constexpr int kRaw = 2 * KT * HD + KT;
  // the split stage: K rows of HD / 2 float4 (hi d, hi d + 1, lo d,
  // lo d + 1); V rows of key pairs, HD float4 (hi 2p, hi 2p + 1, lo 2p,
  // lo 2p + 1); the bias of each key
  static constexpr int kStrideK = 2 * HD + 16;
  static constexpr int kStrideV = 4 * HD + 8;
  static constexpr int kSplitV = KT * kStrideK;
  static constexpr int kBias = kSplitV + KT / 2 * kStrideV;
  static constexpr int kSplit = kBias + KT;
  // floats of one (b, h) group with `stages` raw stages
  __host__ __device__ static constexpr int floats(int stages) {
    return stages * kRaw + kSplit;
  }
};

// blocks an SM the launch bound asks for: 3 (up to 168 registers a thread;
// ptxas: 160 at hd 32 with no spill, 168 at hd 64 with a few words
// spilled), and 2 at hd 128 (up to 255), whose O accumulator alone is 64
// registers a thread
template <int HD>
constexpr int min_blocks() {
  return HD == 128 ? 2 : 3;
}

template <int HD, int W, int KT, bool kExactDiv>
__global__ void __launch_bounds__(kThreads, min_blocks<HD>())
encoder_attention_kernel(const float* __restrict__ qkv,     // [B, L, 3D]
                         const int32_t* __restrict__ mask,  // [B, L]
                         float* __restrict__ ctx,           // [B, L, D]
                         int BH, int L, int H, int q_tiles, int stages,
                         float div, int mode) {
  static_assert(HD % 16 == 0 && KT % 16 == 0, "whole fragments");
  static_assert(kWarps % W == 0, "whole (b, h) groups a block");
  static_assert(!kExactDiv || HD == 16 || HD == 64, "a power-of-two div");
  using T = Tile<HD, KT>;
  constexpr int G = kWarps / W;          // (b, h) pairs a block
  constexpr int kRows = 16 * W;          // query rows of a (b, h) a block
  constexpr int kVecs = HD / 4;          // float4 a head row
  constexpr int NK = KT / 8;             // 8-key steps a tile
  constexpr int ND = HD / 8;             // 8-wide d steps
  constexpr int kGroup = 32 * W;         // threads of a (b, h) group
  extern __shared__ __align__(16) float smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int grp = warp / W, wi = warp % W;
  const int lt = wi * 32 + lane;         // thread of its (b, h) group
  int bh = (blockIdx.x / q_tiles) * G + grp;
  const bool live = bh < BH;             // a ragged last block repeats a pair
  bh = min(bh, BH - 1);
  const int b = bh / H, h = bh % H;
  const int q0 = (blockIdx.x % q_tiles) * kRows + wi * 16;
  const int D = H * HD;
  const int64_t row_stride = 3 * (int64_t)D;
  const float* base = qkv + (int64_t)b * L * row_stride + (int64_t)h * HD;
  const int32_t* mrow = mask + (int64_t)b * L;
  float* raw = smem + grp * T::floats(stages);
  float* sk = raw + stages * T::kRaw;    // the split stage
  float* sv = sk + T::kSplitV;
  float* sbias = sk + T::kBias;
  const int n_tiles = (L + KT - 1) / KT;
  // kExactDiv (hd 16 and 64 at div = 4 or 8): the reciprocal is exact,
  // so the product by it is the quotient; else RN(1 / div) for div_rn
  const float rdiv = !kExactDiv ? __frcp_rn(div) : HD == 16 ? 0.25f : 0.125f;
  // hd <= 64 keeps Q split (hi and lo) in registers for the whole call; at
  // hd 128 that would take 128 registers a thread beside O's 64, so Q stays
  // raw there (in qh) and is split again at each use
  constexpr bool kQSplit = HD <= 64;
  constexpr int NQL = kQSplit ? ND : 1;

  auto load_tile = [&](int tile, int stage) {
    float* ks = raw + stage * T::kRaw;
    float* vs = ks + KT * HD;
    int32_t* ms = reinterpret_cast<int32_t*>(vs + KT * HD);
    for (int e = lt; e < KT * kVecs; e += kGroup) {
      const int j = e / kVecs, c = e % kVecs;
      const int key = tile * KT + j;
      const float* rp = base + (int64_t)min(key, L - 1) * row_stride + 4 * c;
      cp_async16(ks + 4 * e, rp + D, key < L);
      cp_async16(vs + 4 * e, rp + 2 * D, key < L);
    }
    for (int j = lt; j < KT; j += kGroup) {
      const int key = tile * KT + j;
      cp_async4(ms + j, mrow + min(key, L - 1), key < L);
    }
  };

  const bool loads = mode <= 1;
  if (loads) {
    load_tile(0, 0);
  } else if (mode == 2) {   // math only: small finite values, mask all ones
    for (int i = lt; i < stages * T::kRaw; i += kGroup) {
      raw[i] = (i % T::kRaw) < 2 * KT * HD ? 0.0625f * (float)(i % 7)
                                           : __int_as_float(1);
    }
  }
  cp_async_commit();

  // this warp's Q rows q0 + g and q0 + g + 8 (clamped to L - 1), split
  const int r0 = min(q0 + g, L - 1), r1 = min(q0 + g + 8, L - 1);
  uint32_t qh[ND][4], ql[NQL][4];
  float o[ND][4];
  {
    const float* p0 = base + (int64_t)r0 * row_stride + 2 * t;
    const float* p1 = base + (int64_t)r1 * row_stride + 2 * t;
#pragma unroll
    for (int s = 0; s < ND; ++s) {
      float2 x0 = make_float2(1.f, 1.f), x1 = x0;
      if (loads) {
        x0 = __ldg(reinterpret_cast<const float2*>(p0 + 8 * s));
        x1 = __ldg(reinterpret_cast<const float2*>(p1 + 8 * s));
      }
      const float xs[4] = {x0.x, x1.x, x0.y, x1.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kQSplit) {
          float hi, lo;
          split(xs[e], hi, lo);
          qh[s][e] = __float_as_uint(hi);
          ql[s][e] = __float_as_uint(lo);
        } else {
          qh[s][e] = __float_as_uint(xs[e]);
        }
      }
      if (mode == 1) {   // bytes only: carry Q to the output
        o[s][0] = x0.x; o[s][1] = x0.y; o[s][2] = x1.x; o[s][3] = x1.y;
      } else {
        o[s][0] = o[s][1] = o[s][2] = o[s][3] = 0.f;
      }
    }
  }
  // k-step s's A fragments of Q, hi and lo
  auto q_frag = [&](int s, uint32_t (&ah)[4], uint32_t (&al)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kQSplit) {
        ah[e] = qh[s][e];
        al[e] = ql[s][e];
      } else {
        // an empty asm makes the raw value opaque, so the compiler cannot
        // hoist the split out of the key loop (which would bring back the
        // 128 registers of a split Q)
        uint32_t x = qh[s][e];
        asm volatile("" : "+r"(x));
        float hi, lo;
        split(__uint_as_float(x), hi, lo);
        ah[e] = __float_as_uint(hi);
        al[e] = __float_as_uint(lo);
      }
    }
  };
  float m0 = -INFINITY, m1 = -INFINITY;   // running max of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;               // this lane's share of their sums

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles && loads) {
      load_tile(tile + 1, (tile + 1) % stages);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();   // the raw stage has landed; the split stage is free
    const float* ks = raw + (tile % stages) * T::kRaw;
    const float* vs = ks + KT * HD;
    const int32_t* ms = reinterpret_cast<const int32_t*>(vs + KT * HD);

    if (mode == 1) {
      // bytes only: fold one value of each raw row into the output so the
      // copies count
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        o[d][0] += ks[(lane % KT) * HD + 8 * d];
        o[d][3] += vs[(lane % KT) * HD + 8 * d] + (float)ms[lane % KT];
      }
      __syncthreads();   // before the stage is refilled
      continue;
    }
    if (mode == 3) {
      // mma only: S = Q K^T and O += P V on a register operand that
      // changes with the tile, S fed to P as the main path feeds it
      const float x = 1e-3f * (float)tile;
      const float4 kv = make_float4(x, x, x, x);
      float sc[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int s = 0; s < ND; ++s) {
        uint32_t ah[4], al[4];
        q_frag(s, ah, al);
#pragma unroll
        for (int j = 0; j < NK; ++j) mma3(sc[j], ah, al, kv);
      }
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const uint32_t p[4] = {
            __float_as_uint(sc[j][0]), __float_as_uint(sc[j][2]),
            __float_as_uint(sc[j][1]), __float_as_uint(sc[j][3])};
#pragma unroll
        for (int d = 0; d < ND; ++d) mma3(o[d], p, p, kv);
      }
      continue;
    }

    // split the tile once for the group
    for (int e = lt; e < KT * kVecs; e += kGroup) {
      const int j = e / kVecs, c = e % kVecs;
      const float4 x = *reinterpret_cast<const float4*>(ks + 4 * e);
      float4 a, z;
      split(x.x, a.x, a.z);
      split(x.y, a.y, a.w);
      split(x.z, z.x, z.z);
      split(x.w, z.y, z.w);
      float* dst = sk + j * T::kStrideK + 8 * c;
      *reinterpret_cast<float4*>(dst) = a;
      *reinterpret_cast<float4*>(dst + 4) = z;
    }
    for (int e = lt; e < KT / 2 * kVecs; e += kGroup) {
      const int p = e / kVecs, c = e % kVecs;
      const float4 x = *reinterpret_cast<const float4*>(vs + 2 * p * HD + 4 * c);
      const float4 y =
          *reinterpret_cast<const float4*>(vs + (2 * p + 1) * HD + 4 * c);
      const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
      float* dst = sv + p * T::kStrideV + 16 * c;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4 v;
        split(xs[i], v.x, v.z);
        split(ys[i], v.y, v.w);
        *reinterpret_cast<float4*>(dst + 4 * i) = v;
      }
    }
    for (int j = lt; j < KT; j += kGroup) {
      sbias[j] = tile * KT + j >= L ? -INFINITY : (ms[j] > 0 ? 0.f : kMasked);
    }
    __syncthreads();   // the split stage is ready; the raw stage is free

    // S = Q K^T, 16 rows x KT keys; C layout: sc[j] holds keys 8j + 2t,
    // 8j + 2t + 1 of rows g (0, 1) and g + 8 (2, 3)
    float sc[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int s = 0; s < ND; ++s) {
      uint32_t ah[4], al[4];
      q_frag(s, ah, al);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(
            sk + (8 * j + g) * T::kStrideK + 16 * s + 4 * t);
        mma3(sc[j], ah, al, kk);
      }
    }
    // scale, bias, and the tile's row max
    float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const float2 bj = *reinterpret_cast<const float2*>(sbias + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float q = kExactDiv ? sc[j][e] * rdiv
                                  : div_rn(sc[j][e], div, rdiv);
        sc[j][e] = q + ((e & 1) ? bj.y : bj.x);
      }
      x0 = fmaxf(x0, fmaxf(sc[j][0], sc[j][1]));
      x1 = fmaxf(x1, fmaxf(sc[j][2], sc[j][3]));
    }
    x0 = fmaxf(x0, __shfl_xor_sync(kAll, x0, 1));
    x0 = fmaxf(x0, __shfl_xor_sync(kAll, x0, 2));
    x1 = fmaxf(x1, __shfl_xor_sync(kAll, x1, 1));
    x1 = fmaxf(x1, __shfl_xor_sync(kAll, x1, 2));
    // finite: key tile * KT < L is in every tile
    const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
    const float a0 = __expf(m0 - n0), a1 = __expf(m1 - n1);   // 0 at first
    m0 = n0;
    m1 = n1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      o[d][0] *= a0; o[d][1] *= a0; o[d][2] *= a1; o[d][3] *= a1;
    }
    // O += P V, key step j: P's A fragment is sc[j] reordered
    // (rows g, g + 8 x keys 8j + 2t, 8j + 2t + 1)
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const float p[4] = {__expf(sc[j][0] - n0), __expf(sc[j][2] - n1),
                          __expf(sc[j][1] - n0), __expf(sc[j][3] - n1)};
      l0 += p[0] + p[2];
      l1 += p[1] + p[3];
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float hi, lo;
        split(p[e], hi, lo);
        ph[e] = __float_as_uint(hi);
        pl[e] = __float_as_uint(lo);
      }
      const float* vr = sv + (4 * j + t) * T::kStrideV + 4 * g;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        mma3(o[d], ph, pl, *reinterpret_cast<const float4*>(vr + 32 * d));
      }
    }
  }

  if (mode == 1 || mode == 3) {
    l0 = l1 = 1.f;
  } else {
    l0 += __shfl_xor_sync(kAll, l0, 1);
    l0 += __shfl_xor_sync(kAll, l0, 2);
    l1 += __shfl_xor_sync(kAll, l1, 1);
    l1 += __shfl_xor_sync(kAll, l1, 2);
  }
  // ctx = O / l as O times RN(1 / l): one rounding more than a quotient
  // (JAX's softmax rounds a quotient per weight instead)
  l0 = __frcp_rn(l0);
  l1 = __frcp_rn(l1);
  if (!live) return;
  float* out = ctx + (int64_t)b * L * D + (int64_t)h * HD + 2 * t;
  if (q0 + g < L) {
    float* p = out + (int64_t)(q0 + g) * D;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      *reinterpret_cast<float2*>(p + 8 * d) =
          make_float2(o[d][0] * l0, o[d][1] * l0);
    }
  }
  if (q0 + g + 8 < L) {
    float* p = out + (int64_t)(q0 + g + 8) * D;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      *reinterpret_cast<float2*>(p + 8 * d) =
          make_float2(o[d][2] * l1, o[d][3] * l1);
    }
  }
}

template <int HD, int W, int KT, bool EXACT>
int launch(const float* qkv, const int32_t* mask, float* ctx, int B, int L,
           int H, int stages, float div, int mode, cudaStream_t stream) {
  constexpr int G = kWarps / W;
  const int q_tiles = (L + 16 * W - 1) / (16 * W);
  const int64_t BH = (int64_t)B * H;
  const int64_t blocks = (BH + G - 1) / G * q_tiles;
  if (blocks > 2147483647LL || BH > 2147483647LL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const size_t smem =
      (size_t)G * Tile<HD, KT>::floats(stages) * sizeof(float);
  static bool attr_set = false;   // one attribute call per instantiation
  if (!attr_set) {
    // W < 4 tiles cover L with one key tile, so they run one stage
    const cudaError_t err = cudaFuncSetAttribute(
        encoder_attention_kernel<HD, W, KT, EXACT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(G * Tile<HD, KT>::floats(W == 4 ? 2 : 1) * sizeof(float)));
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  encoder_attention_kernel<HD, W, KT, EXACT><<<(unsigned)blocks, kThreads,
                                               smem, stream>>>(
      qkv, mask, ctx, (int)BH, L, H, q_tiles, stages, div, mode);
  return (int)cudaGetLastError();
}

template <int HD, int KT_LONG, bool EXACT>
int launch_hd(int W, int KT, const float* qkv, const int32_t* mask,
              float* ctx, int B, int L, int H, int stages, float div,
              int mode, cudaStream_t stream) {
  if (W == 1 && KT == 16)
    return launch<HD, 1, 16, EXACT>(qkv, mask, ctx, B, L, H, stages, div,
                                    mode, stream);
  if (W == 2 && KT == 32)
    return launch<HD, 2, 32, EXACT>(qkv, mask, ctx, B, L, H, stages, div,
                                    mode, stream);
  if (W == 4 && KT == KT_LONG)
    return launch<HD, 4, KT_LONG, EXACT>(qkv, mask, ctx, B, L, H, stages,
                                         div, mode, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Enqueues on `stream` and returns cudaGetLastError() (0 on success); a
// refused launch never runs, so the caller must check it. The caller
// guarantees contiguous f32 qkv [B, L, 3 * H * hd] and ctx [B, L, H * hd],
// both 16-byte aligned, int32 mask [B, L], 1 <= L, hd in {16, 32, 64, 128}
// with div = f32(sqrt(hd)), or f32(sqrt(w)) for heads of a true width
// w < hd zero-padded to hd (any positive finite div is taken), the tiling (warps a (b, h) W, key tile KT) in
// {(1, 16), (2, 32), (4, 64 at hd 16 and 32, 32 at hd 64, 16 at hd 128)}
// with 16 W >= L unless W = 4, and stages in {1, 2} (1 only when one key
// tile covers L, so always 1 when W < 4).
// mode is 0 on the main path (1: bytes only, 2: math only, 3: mma only,
// for the bench's limit cases).
extern "C" int encoder_attention_launch(const void* qkv, const void* mask,
                                        void* ctx, int64_t B, int64_t L,
                                        int64_t H, int64_t hd, int64_t W,
                                        int64_t KT, int64_t stages,
                                        float div, int64_t mode,
                                        void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (L > 2147483647LL || B > 2147483647LL || stages < 1 || stages > 2 ||
      mode < 0 || mode > 3 || !(div > 0.f && div < INFINITY) ||
      (W < 4 && stages != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* q = (const float*)qkv;
  const int32_t* mk = (const int32_t*)mask;
  float* out = (float*)ctx;
  cudaStream_t st = (cudaStream_t)stream;
  if (hd == 16 && div == 4.f)
    return launch_hd<16, 64, true>((int)W, (int)KT, q, mk, out, (int)B,
                                   (int)L, (int)H, (int)stages, div,
                                   (int)mode, st);
  if (hd == 16)
    return launch_hd<16, 64, false>((int)W, (int)KT, q, mk, out, (int)B,
                                    (int)L, (int)H, (int)stages, div,
                                    (int)mode, st);
  if (hd == 32)
    return launch_hd<32, 64, false>((int)W, (int)KT, q, mk, out, (int)B,
                                    (int)L, (int)H, (int)stages, div,
                                    (int)mode, st);
  if (hd == 64 && div == 8.f)
    return launch_hd<64, 32, true>((int)W, (int)KT, q, mk, out, (int)B,
                                   (int)L, (int)H, (int)stages, div,
                                   (int)mode, st);
  if (hd == 64)
    return launch_hd<64, 32, false>((int)W, (int)KT, q, mk, out, (int)B,
                                    (int)L, (int)H, (int)stages, div,
                                    (int)mode, st);
  if (hd == 128)
    return launch_hd<128, 16, false>((int)W, (int)KT, q, mk, out, (int)B,
                                     (int)L, (int)H, (int)stages, div,
                                     (int)mode, st);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Head widths above 128 (any hd >= 1 is taken): 3xTF32 mma.sync with the
// head's columns streamed, on the machinery that the wide gradient kernels
// share (attention_wide.cuh; encoder_attention_backward.cu's
// attention_dq_kernel<C> runs the same three phases with dP beside S).
//
// The instances above keep a warp's 16 x hd O accumulator in registers,
// which no width above 128 fits. Here a block of kWideWarps = 8 warps owns
// R = 16 MT query rows of one (b, h) (MT = 1 or 2 m16 tiles, every warp
// taking all of them) and keeps their scores against all L keys in shared
// memory, one float a pair, in rows of score_stride(L) floats.
// - Phase A, S = Q K^T. Keys come in tiles of kTile = 128, a warp an
//   n-slice of 16, and the head's columns in chunks of C = 16 or 32: a
//   chunk of the block's Q rows and of the tile's K rows lands raw through
//   the two-stage cp.async ring (16-byte copies; chunk s + 1 is copied
//   while chunk s is multiplied) in rows of C + 4 floats. Each chunk's
//   products are summed from 0 and added to the tile's sums in rounded f32,
//   so no sum goes through more than 3 C / 8 truncating steps on the tensor
//   core (benches/attention_bench.wide_attention_tf32 models both). When a
//   tile's sums are complete, s = sum / div + bias (an IEEE quotient; -1e9
//   added for a masked key) goes to the score rows, and 0 for keys past L.
// - Phase B, a warp a row: the row's max m over its L keys, e = exp(s - m)
//   in place and their sum l, then P = e / l (an IEEE quotient). A row
//   whose keys are all masked holds L equal scores and gets P = 1 / L: the
//   mean of V, as JAX's f32 softmax gives it.
// - Phase C, O = P V. The head's columns go in passes of at most kPass =
//   128, a warp an eighth of a pass (up to 2 n8 steps); V's rows of the
//   pass come through the same ring in tiles of TC rows of kStrideC floats;
//   A fragments come from the score rows. Each 8-key step's products are
//   summed from 0 and added in rounded f32 (mma3_add), so the sum over up
//   to 512 keys does not drift towards 0 as an accumulator on the tensor
//   core would.
// With MT = 2 each split fragment of K (phase A) and V (phase C) feeds two
// products, and a block re-reads its (b, h)'s K and V from L2 half as
// often. Query rows past L are computed (from zero rows) and not stored.
//
// What bounds it on the H100 (ops/attention.attention_work): at hd 256,
// B = 8, L = 512, H = 4 the products, 8.6 GFLOP at the 3xTF32 rate
// (52.1 us); at the shorter WIDTH_CASES (hd 160, 320, 130) the bytes. It
// replaces an f32 FFMA kernel of the same entry point (0ed7058, this file
// :541-640) that reached 3.5% of that bound at hd 256.
//
// Tiling (ops/attention.wide_tiles_for, which the wrapper passes in): the
// rows R and chunk C (a WIDE_FWD_INSTANCE), the row tiles, the grid and
// the shared memory; the entry point refuses a launch whose shared memory
// is not the instance's TileLayout for L.
// ---------------------------------------------------------------------------

namespace {

using wide::frag_a;
using wide::frag_b_cols;
using wide::frag_b_rows;
using wide::kNt;
using wide::kStrideC;
using wide::kTile;
using wide::kWideThreads;
using wide::kWideWarps;
using wide::Passes;
using wide::score_stride;
using wide::stage_rows;

// a block's shared memory: one score array, one operand a side
template <int C, int MT>
using WideFwdTile = wide::TileLayout<C, 16 * MT, 1>;

// Phase A's products of one ring stage (Q's R rows at st, the tile's K
// rows after them): s = Q K^T over the stage's C columns for this warp's
// 16 keys, summed from 0 and added in rounded f32, or taken as they are on
// the first chunk of a tile
template <int C, int MT>
__device__ __forceinline__ void chunk_scores(const float* st, int warp,
                                             int g, int t, bool first,
                                             float (&s)[MT][2][4]) {
  constexpr int SA = WideFwdTile<C, MT>::kStrideA;
  const float* y = st + (16 * MT + 16 * warp) * SA;
  float cs[MT][2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) cs[m][n][e] = 0.f;
    }
  }
#pragma unroll
  for (int k = 0; k < C; k += 8) {
    float4 bk[2];
#pragma unroll
    for (int n = 0; n < 2; ++n)
      bk[n] = frag_b_rows(y + 8 * n * SA + k, SA, g, t);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      uint32_t ah[4], al[4];
      frag_a(st + 16 * m * SA + k, SA, g, t, ah, al);
#pragma unroll
      for (int n = 0; n < 2; ++n) mma3(cs[m][n], ah, al, bk[n]);
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[m][n][e] = first ? cs[m][n][e] : s[m][n][e] + cs[m][n][e];
    }
  }
}

// blocks an SM the launch bound asks for: with MT = 1 shared memory fits 3
// at every L (74 KB a block at L = 512, C = 32), with MT = 2 two
template <int MT>
constexpr int wide_min_blocks() {
  return MT == 1 ? 3 : 2;
}

template <int C, int MT>
__global__ void __launch_bounds__(kWideThreads, wide_min_blocks<MT>())
encoder_attention_wide_kernel(wide::WideArgs a, int row_tiles, bool vec) {
  using Y = WideFwdTile<C, MT>;
  constexpr int R = 16 * MT, SA = Y::kStrideA, TC = Y::tc(1);
  static_assert(TC >= 8, "a phase-C stage holds a k-step");
  extern __shared__ __align__(16) float smem[];
  const int L = a.L, hd = a.hd, Ls = score_stride(L);
  float* Sb = smem;              // [R][Ls]: s, then P
  float* ring = Sb + R * Ls;     // 2 stages
  const int bh = blockIdx.x / row_tiles, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x % row_tiles * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t rs = 3 * (int64_t)a.H * hd, os = (int64_t)a.H * hd;
  const float* Q = wide::q_of(a, b, h);
  const float* K = wide::k_of(a, b, h);
  const float* V = wide::v_of(a, b, h);
  const int32_t* mk = a.mask + (int64_t)b * L;

  // phase A: step s takes key tile s / nch, head columns chunk s % nch
  const int nch = (hd + C - 1) / C;
  const int nA = (L + kTile - 1) / kTile * nch;
  auto stage_a = [&](int s) {
    float* st = ring + (s & 1) * Y::kStage;
    const int k0 = s / nch * kTile, c0 = s % nch * C;
    stage_rows(st, SA, Q, rs, q0, R, L, c0, C, hd, vec);
    stage_rows(st + R * SA, SA, K, rs, k0, kTile, L, c0, C, hd, vec);
  };
  float sc[MT][2][4];
  stage_a(0);
  cp_async_commit();
  for (int s = 0; s < nA; ++s) {
    if (s + 1 < nA) stage_a(s + 1);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    chunk_scores<C, MT>(ring + (s & 1) * Y::kStage, warp, g, t,
                        s % nch == 0, sc);
    if (s % nch == nch - 1) {   // the tile's sums are complete
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int j = s / nch * kTile + 16 * warp + 8 * n + 2 * t;
        const bool in0 = j < L, in1 = j + 1 < L;
        const float b0 = in0 && mk[j] > 0 ? 0.f : kMasked;
        const float b1 = in1 && mk[j + 1] > 0 ? 0.f : kMasked;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float x0 = in0 ? __fdiv_rn(sc[m][n][2 * u], a.div) + b0
                                 : 0.f;
            const float x1 = in1 ? __fdiv_rn(sc[m][n][2 * u + 1], a.div) + b1
                                 : 0.f;
            *reinterpret_cast<float2*>(Sb + (16 * m + g + 8 * u) * Ls + j) =
                make_float2(x0, x1);
          }
        }
      }
    }
    __syncthreads();
  }

  // phase C's first stage is copied while phase B runs
  const Passes ps(hd);
  const int nkc = (L + TC - 1) / TC, nC = ps.n * nkc, nt = ps.wc / 8;
  auto stage_c = [&](int s) {
    stage_rows(ring + (s & 1) * Y::kStage, kStrideC, V, rs, s % nkc * TC, TC,
               L, s / nkc * kWideWarps * ps.wc, kWideWarps * ps.wc, hd, vec);
  };
  stage_c(0);
  cp_async_commit();

  // phase B: a warp a row
  for (int r = warp; r < R; r += kWideWarps) {
    float* row = Sb + r * Ls;
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, row[j]);
    m = wide::warp_max(m);
    float l = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      l += e;
    }
    l = wide::warp_sum(l);
    for (int j = lane; j < L; j += 32) row[j] = __fdiv_rn(row[j], l);
  }

  // phase C: O = P V, this warp's columns of each pass
  float acc[MT][kNt][4];
  for (int s = 0; s < nC; ++s) {
    if (s + 1 < nC) stage_c(s + 1);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const int kc = s % nkc;
    if (kc == 0) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int n = 0; n < kNt; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
        }
      }
    }
    const float* vst = ring + (s & 1) * Y::kStage + warp * ps.wc;
#pragma unroll
    for (int k = 0; k < TC; k += 8) {
      float4 bv[kNt];
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        bv[n] = n < nt ? frag_b_cols(vst + k * kStrideC + 8 * n, kStrideC,
                                     g, t)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t ah[4], al[4];
        frag_a(Sb + 16 * m * Ls + kc * TC + k, Ls, g, t, ah, al);
#pragma unroll
        for (int n = 0; n < kNt; ++n) {
          if (n < nt) mma3_add(acc[m][n], ah, al, bv[n]);
        }
      }
    }
    if (kc == nkc - 1) {
      const int c0 = s / nkc * kWideWarps * ps.wc + warp * ps.wc + 2 * t;
      float* out = a.out + (int64_t)b * L * os + (int64_t)h * hd;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int n = 0; n < kNt; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = q0 + 16 * m + g + (e >= 2 ? 8 : 0);
            const int col = c0 + 8 * n + (e & 1);
            if (n < nt && row < L && col < hd)
              out[(int64_t)row * os + col] = acc[m][n][e];
          }
        }
      }
    }
    __syncthreads();
  }
}

template <int C, int MT>
int launch_wide(const wide::WideArgs& a, int64_t row_tiles, int64_t grid,
                int64_t smem, bool vec, cudaStream_t stream) {
  if (smem != (int64_t)WideFwdTile<C, MT>::floats(a.L) *
                  (int64_t)sizeof(float))
    return (int)cudaErrorInvalidValue;
  static int64_t allowed = 0;   // one attribute call per larger size
  const int err =
      wide::allow_smem(encoder_attention_wide_kernel<C, MT>, smem, allowed);
  if (err != (int)cudaSuccess) return err;
  encoder_attention_wide_kernel<C, MT><<<(unsigned)grid, kWideThreads, smem,
                                         stream>>>(a, (int)row_tiles, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// The (chunk, rows) pairs ops/attention.wide_tiles_for picks;
// tests/test_torch_attention_wide_forward.py holds the tiling to this list.
#define WIDE_FWD_INSTANCE(C_, R_)                                        \
  if (chunk == C_ && rows == R_)                                         \
    return launch_wide<C_, R_ / 16>(a, row_tiles, grid, smem, vec,       \
                                    (cudaStream_t)stream);

// Head widths above 128 (any hd >= 1 is taken; the wrapper sends those
// above 128, zero-padded to a multiple of 4), 1 <= L <= 512, div =
// f32(sqrt(w)) of the true width w; contiguous f32 qkv [B, L, 3 H hd], ctx
// [B, L, H hd], int32 mask [B, L], and the tiling of
// ops/attention.wide_tiles_for: the rows and chunk of a WIDE_FWD_INSTANCE,
// row_tiles = ceil(L / rows), grid = B H row_tiles, smem the instance's
// TileLayout for L (refused otherwise). Enqueues on `stream`; returns
// cudaGetLastError() (0 on success), a refused launch never running.
extern "C" int encoder_attention_wide_launch(
    const void* qkv, const void* mask, void* ctx, int64_t B, int64_t L,
    int64_t H, int64_t hd, int64_t rows, int64_t chunk, int64_t row_tiles,
    int64_t grid, int64_t smem, float div, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (L > 512 || H <= 0 || hd <= 0 || B * H > 2147483647LL ||
      B * L * 3 * H * hd > (int64_t)1 << 40 ||
      !(div > 0.f && div < INFINITY) || (rows != 16 && rows != 32) ||
      row_tiles != (L + rows - 1) / rows || grid != B * H * row_tiles ||
      grid > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  wide::WideArgs a{(const float*)qkv, (const int32_t*)mask, nullptr,
                   (float*)ctx, nullptr, (int)B, (int)L, (int)H, (int)hd,
                   div};
  const bool vec = hd % 4 == 0 && (uintptr_t)qkv % 16 == 0;
  WIDE_FWD_INSTANCE(32, 32)
  WIDE_FWD_INSTANCE(16, 32)
  WIDE_FWD_INSTANCE(32, 16)
  WIDE_FWD_INSTANCE(16, 16)
  return (int)cudaErrorInvalidValue;
}
