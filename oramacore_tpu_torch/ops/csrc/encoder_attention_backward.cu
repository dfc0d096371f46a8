// The gradient of the encoder's self-attention, for NVIDIA Hopper (sm_90a),
// on the tensor cores.
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
// Divisions are IEEE quotients (div_rn, correctly rounded, as JAX divides
// by sqrt(hd) and as its softmax divides by the row sum; at hd 16 and 64
// div is 4 or 8 and the product by its exact reciprocal is the quotient);
// the -1e9 is added, never skipped, so a batch row whose keys are all
// masked sees every s_ij round to -1e9 (f32 ulp 64 there): P is uniform
// over its L keys and dS is not zero, as in JAX's autodiff. Keys past L
// do not exist and weigh exactly 0 (score -inf); query rows past the true
// length are computed, as JAX computes them.
//
// Inputs are the forward's: qkv f32[B, L, 3D] (Q, K, V side by side, head
// h at columns h * hd of each), mask int32[B, L], and dctx f32[B, L, D];
// the output dqkv f32[B, L, 3D] is in the same fused layout, so the
// projection's backward takes it as it stands.
//
// Two entry points, in stream order (FlashAttention-2's split):
// - attention_dq_kernel: a warp owns 16 query rows, W warps share a
//   (b, h). A statistics pass over the keys computes S and dP and, online
//   as the forward does, each row's max m, its sum l of exp(s - m), and
//   delta = sum_j exp(s_ij - m) dP_ij rescaled with it (then / l): delta
//   comes from P and dP, JAX's own softmax vjp, so the kernels need no
//   saved ctx (the alternative, delta = rowsum(dO * ctx), would drop dP
//   from this pass, 2 hd of the 18 hd a pair the two kernels execute, at
//   the cost of a ctx kept from the forward and passed in). A second pass
//   recomputes S, P = exp(s - m) / l and dP, and sums dQ += dS K. It
//   stores (m, l, delta, 0) of every row in a scratch the wrapper
//   allocates.
// - attention_dkv_kernel: a warp owns 16 key rows and walks the query
//   rows: S^T = K Q^T, P^T from the stored (m, l), dP^T = V dO^T,
//   dV += P^T dO and dK += dS^T Q. At hd 128 its dK and dV accumulators
//   (128 registers a thread) leave no room for K and V, so the walk runs
//   twice, each for half of the head width of dK and dV (S^T and dP^T
//   computed in both).
// The two kernels' scores of a pair are the same products summed in
// another order, so they agree to about an ulp, not to the bit.
//
// Products: all five run on the tensor cores as 3xTF32
// mma.sync.m16n8k8 (tf32_mma.cuh), which keeps f32 accuracy. Operands of
// 16 rows a warp (Q and dO in dq; K and V in dkv) sit in registers as A
// fragments (split once up to hd 32; raw at hd 64 and 128, split at each
// use behind an empty asm so the compiler cannot hoist the split and
// bring back twice the registers). The other side's rows come in tiles
// (T keys in dq, T queries in dkv) through a two-stage cp.async ring,
// zero-filled past L, so tile t + 1 is copied while tile t is computed;
// each landed tile is split once for the block into the layouts its
// products read as B fragments, each one conflict-free 16-byte read:
// - d-major (rows of 2 hd + 16 floats; float4 (hi d, hi d + 1, lo d,
//   lo d + 1)) for the products summed over d: S and dP (K, V in dq; Q, dO
//   in dkv);
// - row-pair-major (rows of 4 hd + 8 floats; per d, float4 (hi row 2p,
//   hi row 2p + 1, lo 2p, lo 2p + 1)) for the products summed over keys
//   (dQ += dS K) or queries (dV += P^T dO, dK += dS^T Q).
// The C fragment of a score tile (rows g, g + 8; columns 2t, 2t + 1 of
// each 8-column step) is the A fragment of the next product as it stands
// (the forward's P V trick), so P, P^T, dS and dS^T never leave registers.
// The exp and the two divisions are done once for each score element, in
// the lane that holds it. dQ, dK and dV, sums over up to 512 keys or
// queries, are not accumulated on the tensor core, which truncates what
// it adds into its accumulator: a tile's products (dQ) or a query step's
// (dK, dV, mma3_add) are summed from 0 and added in rounded f32; S and
// dP, sums over d, accumulate on the tensor core (mma3).
//
// What bounds it on the H100 (benches/train_bench.backward_work): at
// BGEBase's geometry (12 heads of 64, L = 512) and hd 128 the products,
// 10 hd FLOPs a pair (S, dP, dQ, dK, dV) for the whole gradient, at the
// 3xTF32 rate (495 / 3 TFLOP/s); at B = 1024, L <= 64 (SemanticBase, hd
// 16) and at the training call the bytes (qkv, dctx, dqkv, the mask and
// the statistics). The kernels execute more than that: dq 10 hd a pair
// (S and dP in both passes, dQ), dkv 8 hd (12 hd at hd 128), plus their
// exp and divisions; registers (up to 255 a thread, 2 blocks an SM) cap
// how many independent products a warp keeps in flight.
//
// Tiling (ops/attention.backward_tiles_for, which the wrapper passes in):
// W = 1, 2 or 4 warps a (b, h) (16, 32 or more rows), G (b, h) pairs a
// block, tiles of T = min(16 W, 64 at hd 16 and 32, 32 at hd 64, 16 at
// hd 128) rows of the other side, and a ring of 2 stages, 1 when one tile
// covers L (then both of dq's passes use one split tile). Each instance
// needs at most 113 KB of shared memory, so 2 blocks fit an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr float kMasked = -1e9f;
constexpr unsigned kAll = 0xffffffffu;

// the split layouts of a head row (HD floats)
template <int HD>
struct Layout {
  static constexpr int kStrideD = 2 * HD + 16;   // d-major row
  static constexpr int kStrideP = 4 * HD + 8;    // row-pair row
  static constexpr int kVecs = HD / 4;           // float4 a raw row
};

// R rows of a raw tile (row stride HD) into the d-major split layout,
// by the n threads numbered lt of a group
template <int HD>
__device__ __forceinline__ void split_dmajor(const float* raw, float* dst,
                                             int R, int lt, int n) {
  using Y = Layout<HD>;
  for (int e = lt; e < R * Y::kVecs; e += n) {
    const int r = e / Y::kVecs, c = e % Y::kVecs;
    const float4 x = *reinterpret_cast<const float4*>(raw + 4 * e);
    float4 a, z;
    split(x.x, a.x, a.z);
    split(x.y, a.y, a.w);
    split(x.z, z.x, z.z);
    split(x.w, z.y, z.w);
    float* p = dst + r * Y::kStrideD + 8 * c;
    *reinterpret_cast<float4*>(p) = a;
    *reinterpret_cast<float4*>(p + 4) = z;
  }
}

// R rows (R even) of a raw tile into the row-pair-major split layout
template <int HD>
__device__ __forceinline__ void split_pmajor(const float* raw, float* dst,
                                             int R, int lt, int n) {
  using Y = Layout<HD>;
  for (int e = lt; e < R / 2 * Y::kVecs; e += n) {
    const int p = e / Y::kVecs, c = e % Y::kVecs;
    const float4 x = *reinterpret_cast<const float4*>(raw + 2 * p * HD + 4 * c);
    const float4 y =
        *reinterpret_cast<const float4*>(raw + (2 * p + 1) * HD + 4 * c);
    const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
    float* dp = dst + p * Y::kStrideP + 16 * c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 v;
      split(xs[i], v.x, v.z);
      split(ys[i], v.y, v.w);
      *reinterpret_cast<float4*>(dp + 4 * i) = v;
    }
  }
}

// The A fragments of 16 rows of one head (rows g and g + 8 of lane
// 4g + t): k-step s's columns t and t + 4 stand for d = 8s + 2t and
// 8s + 2t + 1, so a lane reads each row as float2. Kept split (hi, lo)
// when SPLIT, else raw and split at each use.
template <int HD, bool SPLIT>
struct RowFrags {
  static constexpr int ND = HD / 8;
  uint32_t h[ND][4];
  uint32_t l[SPLIT ? ND : 1][4];

  __device__ __forceinline__ void load(const float* p0, const float* p1,
                                       int t) {
#pragma unroll
    for (int s = 0; s < ND; ++s) {
      const float2 x0 = __ldg(reinterpret_cast<const float2*>(p0 + 8 * s + 2 * t));
      const float2 x1 = __ldg(reinterpret_cast<const float2*>(p1 + 8 * s + 2 * t));
      const float xs[4] = {x0.x, x1.x, x0.y, x1.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (SPLIT) {
          float hi, lo;
          split(xs[e], hi, lo);
          h[s][e] = __float_as_uint(hi);
          l[s][e] = __float_as_uint(lo);
        } else {
          h[s][e] = __float_as_uint(xs[e]);
        }
      }
    }
  }

  __device__ __forceinline__ void frag(int s, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (SPLIT) {
        ah[e] = h[s][e];
        al[e] = l[s][e];
      } else {
        uint32_t x = h[s][e];
        asm volatile("" : "+r"(x));
        float hi, lo;
        split(__uint_as_float(x), hi, lo);
        ah[e] = __float_as_uint(hi);
        al[e] = __float_as_uint(lo);
      }
    }
  }
};

// a C fragment (rows g, g + 8 x columns 2t, 2t + 1) as the A fragment of
// the next product (columns t, t + 4 standing for 2t, 2t + 1), split
__device__ __forceinline__ void c_as_a(const float (&c)[4], uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float hi, lo;
    split(x[e], hi, lo);
    ah[e] = __float_as_uint(hi);
    al[e] = __float_as_uint(lo);
  }
}

// d += a b in 3xTF32 as mma3 does, but the three products summed from 0
// and added to d by one rounded f32 add an element. The tensor core
// truncates each sum it takes into its accumulator to f32, so a sum over
// hundreds of keys or queries taken into d by mma3 drifts towards 0 by up
// to an ulp of d a step (5e-5 in dK and dV at BGEBase's L = 512); here
// the truncations fall on one step's small sum and d's roundings err
// both ways.
__device__ __forceinline__ void mma3_add(float (&d)[4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], float4 b) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(p, ah, al, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += p[e];
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kAll, x, 1));
  return fmaxf(x, __shfl_xor_sync(kAll, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kAll, x, 1);
  return x + __shfl_xor_sync(kAll, x, 2);
}

// x / div, the IEEE quotient, from r = RN(1 / div): where div is 4 or 8
// (hd 16 and 64 at their own width: the kExactDiv instances) the
// reciprocal is exact, so the product by it is the quotient; else div_rn
// (every other hd, and heads zero-padded to hd with their true width's
// divisor)
template <bool kExactDiv>
__device__ __forceinline__ float by_div(float x, float div, float r) {
  return kExactDiv ? x * r : div_rn(x, div, r);
}

// the reciprocal of div by_div takes
template <int HD, bool kExactDiv>
__device__ __forceinline__ float recip_div(float div) {
  static_assert(!kExactDiv || HD == 16 || HD == 64, "a power-of-two div");
  return !kExactDiv ? __frcp_rn(div) : HD == 16 ? 0.25f : 0.125f;
}

// rows a warp holds in registers stay split up to hd 32
template <int HD>
constexpr bool kSplitRows = HD <= 32;

// dq: one (b, h) group's shared memory, in floats. A raw stage holds K
// [T][HD], V [T][HD] and the mask [T]; the split stage K d-major, K
// key-pair-major, V d-major and the bias of each key.
template <int HD, int T>
struct DqTile {
  using Y = Layout<HD>;
  static constexpr int kRaw = 2 * T * HD + T;
  static constexpr int kKp = T * Y::kStrideD;
  static constexpr int kVd = kKp + T / 2 * Y::kStrideP;
  static constexpr int kBias = kVd + T * Y::kStrideD;
  static constexpr int kSplit = kBias + T;
  __host__ __device__ static constexpr int floats(int stages) {
    return stages * kRaw + kSplit;
  }
};

// dkv: a raw stage holds Q [T][HD], dO [T][HD] and the rows' statistics
// [T] (float4); the split stage Q d-major, Q query-pair-major, dO
// d-major, dO query-pair-major and the statistics (m, l, delta, 1 / l)
template <int HD, int T>
struct DkvTile {
  using Y = Layout<HD>;
  static constexpr int kRaw = 2 * T * HD + 4 * T;
  static constexpr int kQp = T * Y::kStrideD;
  static constexpr int kOd = kQp + T / 2 * Y::kStrideP;
  static constexpr int kOp = kOd + T * Y::kStrideD;
  static constexpr int kStats = kOp + T / 2 * Y::kStrideP;
  static constexpr int kSplit = kStats + 4 * T;
  __host__ __device__ static constexpr int floats(int stages) {
    return stages * kRaw + kSplit;
  }
};

template <int HD, int W, int G, int T, bool kExactDiv>
__global__ void __launch_bounds__(32 * W * G, 2)
attention_dq_kernel(const float* __restrict__ qkv,     // [B, L, 3D]
                    const int32_t* __restrict__ mask,  // [B, L]
                    const float* __restrict__ dctx,    // [B, L, D]
                    float* __restrict__ dqkv,          // [B, L, 3D]
                    float4* __restrict__ stats,        // [B * H, L]
                    int BH, int L, int H, int q_tiles, int stages,
                    float div) {
  static_assert(HD % 16 == 0 && T % 16 == 0, "whole fragments");
  using Y = Layout<HD>;
  using S = DqTile<HD, T>;
  constexpr int kGroup = 32 * W;         // threads of a (b, h) group
  constexpr int NK = T / 8;              // 8-key steps a tile
  constexpr int ND = HD / 8;             // 8-wide d steps
  extern __shared__ __align__(16) float smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int grp = warp / W, wi = warp % W;
  const int lt = wi * 32 + lane;
  int bh = (blockIdx.x / q_tiles) * G + grp;
  const bool live = bh < BH;             // a ragged last block repeats a pair
  bh = min(bh, BH - 1);
  const int b = bh / H, h = bh % H;
  const int q0 = (blockIdx.x % q_tiles) * (16 * W) + wi * 16;
  const int D = H * HD;
  const int64_t rs = 3 * (int64_t)D;
  const float* base = qkv + (int64_t)b * L * rs + (int64_t)h * HD;
  const float* gout = dctx + (int64_t)b * L * D + (int64_t)h * HD;
  const int32_t* mrow = mask + (int64_t)b * L;
  float* raw = smem + grp * S::floats(stages);
  float* sp = raw + stages * S::kRaw;    // the split stage
  const int n_tiles = (L + T - 1) / T;
  const float rdiv = recip_div<HD, kExactDiv>(div);

  auto load_tile = [&](int tile, int stage) {
    float* ks = raw + stage * S::kRaw;
    float* vs = ks + T * HD;
    int32_t* ms = reinterpret_cast<int32_t*>(vs + T * HD);
    for (int e = lt; e < T * Y::kVecs; e += kGroup) {
      const int j = e / Y::kVecs, c = e % Y::kVecs;
      const int key = tile * T + j;
      const float* rp = base + (int64_t)min(key, L - 1) * rs + 4 * c;
      cp_async16(ks + 4 * e, rp + D, key < L);
      cp_async16(vs + 4 * e, rp + 2 * D, key < L);
    }
    for (int j = lt; j < T; j += kGroup) {
      const int key = tile * T + j;
      cp_async4(ms + j, mrow + min(key, L - 1), key < L);
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  // this warp's rows q0 + g and q0 + g + 8 (clamped to L - 1)
  const int r0 = min(q0 + g, L - 1), r1 = min(q0 + g + 8, L - 1);
  RowFrags<HD, kSplitRows<HD>> qf, of;
  qf.load(base + (int64_t)r0 * rs, base + (int64_t)r1 * rs, t);
  of.load(gout + (int64_t)r0 * D, gout + (int64_t)r1 * D, t);

  float m0 = -INFINITY, m1 = -INFINITY;   // running max of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;               // this lane's share of their sums
  float e0 = 0.f, e1 = 0.f;               // ... and of sum_j p_j dP_j
  float rl0 = 0.f, rl1 = 0.f, dl0 = 0.f, dl1 = 0.f;   // 1 / l, delta
  float dq[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;

  // pass 1 (steps 0 .. n - 1): the statistics; pass 2: dQ
  for (int step = 0; step < 2 * n_tiles; ++step) {
    const int tile = step % n_tiles;
    const bool grads = step >= n_tiles;
    if (n_tiles > 1 || step == 0) {
      if (n_tiles > 1 && step + 1 < 2 * n_tiles) {
        load_tile((step + 1) % n_tiles, (step + 1) % stages);
      }
      cp_async_commit();
      cp_async_wait_prior();
      __syncthreads();   // the raw stage has landed; the split stage is free
      const float* ks = raw + (step % stages) * S::kRaw;
      const float* vs = ks + T * HD;
      const int32_t* ms = reinterpret_cast<const int32_t*>(vs + T * HD);
      split_dmajor<HD>(ks, sp, T, lt, kGroup);
      split_dmajor<HD>(vs, sp + S::kVd, T, lt, kGroup);
      if (grads || n_tiles == 1) split_pmajor<HD>(ks, sp + S::kKp, T, lt, kGroup);
      for (int j = lt; j < T; j += kGroup) {
        sp[S::kBias + j] =
            tile * T + j >= L ? -INFINITY : (ms[j] > 0 ? 0.f : kMasked);
      }
      __syncthreads();   // the split stage is ready; the raw stage is free
    }
    if (step == n_tiles) {   // the rows' statistics are complete
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      e0 = quad_sum(e0);
      e1 = quad_sum(e1);
      rl0 = __frcp_rn(l0);
      rl1 = __frcp_rn(l1);
      dl0 = div_rn(e0, l0, rl0);
      dl1 = div_rn(e1, l1, rl1);
    }

    // S = Q K^T and dP = dO V^T, 16 rows x T keys; C layout: [j] holds
    // keys 8j + 2t, 8j + 2t + 1 of rows g (0, 1) and g + 8 (2, 3)
    float sc[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int s = 0; s < ND; ++s) {
      uint32_t ah[4], al[4], oh[4], ol[4];
      qf.frag(s, ah, al);
      of.frag(s, oh, ol);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float* row = sp + (8 * j + g) * Y::kStrideD + 16 * s + 4 * t;
        mma3(sc[j], ah, al, *reinterpret_cast<const float4*>(row));
        mma3(dp[j], oh, ol,
             *reinterpret_cast<const float4*>(row + S::kVd));
      }
    }
    // scale and bias
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const float2 bj =
          *reinterpret_cast<const float2*>(sp + S::kBias + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = by_div<kExactDiv>(sc[j][e], div, rdiv) +
                   ((e & 1) ? bj.y : bj.x);
      }
    }

    if (!grads) {
      // the online max, sum and delta sum; finite: key tile * T < L is in
      // every tile
      float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        x0 = fmaxf(x0, fmaxf(sc[j][0], sc[j][1]));
        x1 = fmaxf(x1, fmaxf(sc[j][2], sc[j][3]));
      }
      const float n0 = fmaxf(m0, quad_max(x0)), n1 = fmaxf(m1, quad_max(x1));
      const float a0 = __expf(m0 - n0), a1 = __expf(m1 - n1);   // 0 at first
      m0 = n0;
      m1 = n1;
      l0 *= a0;
      e0 *= a0;
      l1 *= a1;
      e1 *= a1;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float p[4] = {__expf(sc[j][0] - n0), __expf(sc[j][1] - n0),
                            __expf(sc[j][2] - n1), __expf(sc[j][3] - n1)};
        l0 += p[0] + p[1];
        l1 += p[2] + p[3];
        e0 = fmaf(p[0], dp[j][0], fmaf(p[1], dp[j][1], e0));
        e1 = fmaf(p[2], dp[j][2], fmaf(p[3], dp[j][3], e1));
      }
      continue;
    }

    // dS = P (dP - delta) / div, as A fragments (key step j: dS's C
    // fragment reordered)
    uint32_t sh[NK][4], sl[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e >= 2;
        const float p = div_rn(__expf(sc[j][e] - (lo ? m1 : m0)),
                               lo ? l1 : l0, lo ? rl1 : rl0);
        ds[e] = by_div<kExactDiv>(p * (dp[j][e] - (lo ? dl1 : dl0)), div,
                                  rdiv);
      }
      c_as_a(ds, sh[j], sl[j]);
    }
    // dQ += dS K: each d step's products over the tile's keys summed from
    // 0, then added to dQ rounded (see mma3_add)
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        mma3(p, sh[j], sl[j], *reinterpret_cast<const float4*>(
            sp + S::kKp + (4 * j + t) * Y::kStrideP + 4 * g + 32 * d));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[d][e] += p[e];
    }
  }

  if (!live) return;
  float* out = dqkv + (int64_t)b * L * rs + (int64_t)h * HD + 2 * t;
  float4* st = stats + (int64_t)bh * L;
  if (q0 + g < L) {
    float* p = out + (int64_t)(q0 + g) * rs;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      *reinterpret_cast<float2*>(p + 8 * d) = make_float2(dq[d][0], dq[d][1]);
    }
    if (t == 0) st[q0 + g] = make_float4(m0, l0, dl0, 0.f);
  }
  if (q0 + g + 8 < L) {
    float* p = out + (int64_t)(q0 + g + 8) * rs;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      *reinterpret_cast<float2*>(p + 8 * d) = make_float2(dq[d][2], dq[d][3]);
    }
    if (t == 0) st[q0 + g + 8] = make_float4(m1, l1, dl1, 0.f);
  }
}

// halves of the head width of dK and dV a dkv warp sums per walk
template <int HD>
constexpr int kHalves = HD == 128 ? 2 : 1;

template <int HD, int W, int G, int T, bool kExactDiv>
__global__ void __launch_bounds__(32 * W * G, 2)
attention_dkv_kernel(const float* __restrict__ qkv,     // [B, L, 3D]
                     const int32_t* __restrict__ mask,  // [B, L]
                     const float* __restrict__ dctx,    // [B, L, D]
                     const float4* __restrict__ stats,  // [B * H, L]
                     float* __restrict__ dqkv,          // [B, L, 3D]
                     int BH, int L, int H, int k_tiles, int stages,
                     float div) {
  static_assert(HD % 16 == 0 && T % 16 == 0, "whole fragments");
  using Y = Layout<HD>;
  using S = DkvTile<HD, T>;
  constexpr int kGroup = 32 * W;
  constexpr int NQ = T / 8;                  // 8-query steps a tile
  constexpr int ND = HD / 8;
  constexpr int NH = kHalves<HD>;
  constexpr int NDH = ND / NH;               // d steps of dK, dV a walk
  extern __shared__ __align__(16) float smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int grp = warp / W, wi = warp % W;
  const int lt = wi * 32 + lane;
  int bh = (blockIdx.x / k_tiles) * G + grp;
  const bool live = bh < BH;
  bh = min(bh, BH - 1);
  const int b = bh / H, h = bh % H;
  const int j0 = (blockIdx.x % k_tiles) * (16 * W) + wi * 16;
  const int D = H * HD;
  const int64_t rs = 3 * (int64_t)D;
  const float* base = qkv + (int64_t)b * L * rs + (int64_t)h * HD;
  const float* gout = dctx + (int64_t)b * L * D + (int64_t)h * HD;
  const float4* srow = stats + (int64_t)bh * L;
  float* raw = smem + grp * S::floats(stages);
  float* sp = raw + stages * S::kRaw;
  const int n_tiles = (L + T - 1) / T;
  const float rdiv = recip_div<HD, kExactDiv>(div);

  auto load_tile = [&](int tile, int stage) {
    float* qs = raw + stage * S::kRaw;
    float* os = qs + T * HD;
    float* ss = os + T * HD;
    for (int e = lt; e < T * Y::kVecs; e += kGroup) {
      const int i = e / Y::kVecs, c = e % Y::kVecs;
      const int row = min(tile * T + i, L - 1);
      const bool ok = tile * T + i < L;
      cp_async16(qs + 4 * e, base + (int64_t)row * rs + 4 * c, ok);
      cp_async16(os + 4 * e, gout + (int64_t)row * D + 4 * c, ok);
    }
    for (int i = lt; i < T; i += kGroup) {
      const int row = tile * T + i;
      cp_async16(ss + 4 * i, srow + min(row, L - 1), row < L);
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  // this warp's keys j0 + g and j0 + g + 8 (clamped to L - 1); keys past
  // L get a -inf bias, so their P^T and dS^T are 0 (they are not stored)
  const int k0 = j0 + g, k1 = j0 + g + 8;
  const int r0 = min(k0, L - 1), r1 = min(k1, L - 1);
  RowFrags<HD, kSplitRows<HD>> kf, vf;
  kf.load(base + (int64_t)r0 * rs + D, base + (int64_t)r1 * rs + D, t);
  vf.load(base + (int64_t)r0 * rs + 2 * D, base + (int64_t)r1 * rs + 2 * D, t);
  const int32_t* mrow = mask + (int64_t)b * L;
  const float bias0 = k0 >= L ? -INFINITY : (mrow[r0] > 0 ? 0.f : kMasked);
  const float bias1 = k1 >= L ? -INFINITY : (mrow[r1] > 0 ? 0.f : kMasked);
  float* out = dqkv + (int64_t)b * L * rs + (int64_t)h * HD + 2 * t;

  for (int half = 0; half < NH; ++half) {
    float dk[NDH][4], dvv[NDH][4];
#pragma unroll
    for (int d = 0; d < NDH; ++d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[d][e] = dvv[d][e] = 0.f;
    }
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int step = half * n_tiles + tile;
      if (n_tiles > 1 || step == 0) {
        if (n_tiles > 1 && step + 1 < NH * n_tiles) {
          load_tile((step + 1) % n_tiles, (step + 1) % stages);
        }
        cp_async_commit();
        cp_async_wait_prior();
        __syncthreads();
        const float* qs = raw + (step % stages) * S::kRaw;
        const float* os = qs + T * HD;
        const float4* ss = reinterpret_cast<const float4*>(os + T * HD);
        split_dmajor<HD>(qs, sp, T, lt, kGroup);
        split_pmajor<HD>(qs, sp + S::kQp, T, lt, kGroup);
        split_dmajor<HD>(os, sp + S::kOd, T, lt, kGroup);
        split_pmajor<HD>(os, sp + S::kOp, T, lt, kGroup);
        for (int i = lt; i < T; i += kGroup) {
          // query rows past L: (0, 1, 0) with Q and dO zero, so they add 0
          const float4 x = tile * T + i < L ? ss[i]
                                            : make_float4(0.f, 1.f, 0.f, 0.f);
          reinterpret_cast<float4*>(sp + S::kStats)[i] =
              make_float4(x.x, x.y, x.z, __frcp_rn(x.y));
        }
        __syncthreads();
      }

      // S^T = K Q^T and dP^T = V dO^T, 16 keys x T queries
      float sc[NQ][4], dp[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
      }
#pragma unroll
      for (int s = 0; s < ND; ++s) {
        uint32_t ah[4], al[4], vh[4], vl[4];
        kf.frag(s, ah, al);
        vf.frag(s, vh, vl);
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const float* row = sp + (8 * j + g) * Y::kStrideD + 16 * s + 4 * t;
          mma3(sc[j], ah, al, *reinterpret_cast<const float4*>(row));
          mma3(dp[j], vh, vl,
               *reinterpret_cast<const float4*>(row + S::kOd));
        }
      }
      // P^T from each query's (m, l), dS^T; then dV += P^T dO and
      // dK += dS^T Q (query step j)
      const float4* st = reinterpret_cast<const float4*>(sp + S::kStats);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float4 qa = st[8 * j + 2 * t], qb = st[8 * j + 2 * t + 1];
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4& q = (e & 1) ? qb : qa;
          const float s =
              by_div<kExactDiv>(sc[j][e], div, rdiv) +
              (e >= 2 ? bias1 : bias0);
          p[e] = div_rn(__expf(s - q.x), q.y, q.w);
          ds[e] = by_div<kExactDiv>(p[e] * (dp[j][e] - q.z), div, rdiv);
        }
        uint32_t ph[4], pl[4], dh[4], dl[4];
        c_as_a(p, ph, pl);
        c_as_a(ds, dh, dl);
        const float* orow = sp + S::kOp + (4 * j + t) * Y::kStrideP + 4 * g +
                            32 * half * NDH;
        const float* qrow = sp + S::kQp + (4 * j + t) * Y::kStrideP + 4 * g +
                            32 * half * NDH;
#pragma unroll
        for (int d = 0; d < NDH; ++d) {
          mma3_add(dvv[d], ph, pl,
                   *reinterpret_cast<const float4*>(orow + 32 * d));
          mma3_add(dk[d], dh, dl,
                   *reinterpret_cast<const float4*>(qrow + 32 * d));
        }
      }
    }
    if (live) {
      const int c0 = 8 * half * NDH;
      if (k0 < L) {
        float* p = out + (int64_t)k0 * rs + c0;
#pragma unroll
        for (int d = 0; d < NDH; ++d) {
          *reinterpret_cast<float2*>(p + D + 8 * d) =
              make_float2(dk[d][0], dk[d][1]);
          *reinterpret_cast<float2*>(p + 2 * D + 8 * d) =
              make_float2(dvv[d][0], dvv[d][1]);
        }
      }
      if (k1 < L) {
        float* p = out + (int64_t)k1 * rs + c0;
#pragma unroll
        for (int d = 0; d < NDH; ++d) {
          *reinterpret_cast<float2*>(p + D + 8 * d) =
              make_float2(dk[d][2], dk[d][3]);
          *reinterpret_cast<float2*>(p + 2 * D + 8 * d) =
              make_float2(dvv[d][2], dvv[d][3]);
        }
      }
    }
  }
}

// The grid, the row tiles and the shared memory come from the caller
// (ops/attention.backward_tiles_for); the shared memory must be the
// instance's layout for `stages` (G groups of DqTile / DkvTile floats), or
// the launch is refused. The attribute is raised to the largest size asked
// of the instance so far.
template <typename Kernel>
int allow_smem(Kernel kernel, int64_t smem, int64_t& allowed) {
  if (smem <= allowed) return (int)cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) allowed = smem;
  return (int)err;
}

template <int HD, int W, int G, int T, bool EXACT>
int launch_dq(const float* qkv, const int32_t* mask, const float* dctx,
              float* dqkv, float4* stats, int64_t B, int64_t L, int64_t H,
              int stages, int64_t row_tiles, int64_t grid, int64_t smem,
              float div, cudaStream_t stream) {
  if (smem != (int64_t)(G * DqTile<HD, T>::floats(stages) * sizeof(float))) {
    return (int)cudaErrorInvalidValue;
  }
  static int64_t allowed = 0;   // one attribute call per larger size
  const int err =
      allow_smem(attention_dq_kernel<HD, W, G, T, EXACT>, smem, allowed);
  if (err != (int)cudaSuccess) return err;
  attention_dq_kernel<HD, W, G, T, EXACT><<<(unsigned)grid, 32 * W * G, smem,
                                            stream>>>(
      qkv, mask, dctx, dqkv, stats, (int)(B * H), (int)L, (int)H,
      (int)row_tiles, stages, div);
  return (int)cudaGetLastError();
}

template <int HD, int W, int G, int T, bool EXACT>
int launch_dkv(const float* qkv, const int32_t* mask, const float* dctx,
               const float4* stats, float* dqkv, int64_t B, int64_t L,
               int64_t H, int stages, int64_t row_tiles, int64_t grid,
               int64_t smem, float div, cudaStream_t stream) {
  if (smem !=
      (int64_t)(G * DkvTile<HD, T>::floats(stages) * sizeof(float))) {
    return (int)cudaErrorInvalidValue;
  }
  static int64_t allowed = 0;
  const int err =
      allow_smem(attention_dkv_kernel<HD, W, G, T, EXACT>, smem, allowed);
  if (err != (int)cudaSuccess) return err;
  attention_dkv_kernel<HD, W, G, T, EXACT><<<(unsigned)grid, 32 * W * G,
                                             smem, stream>>>(
      qkv, mask, dctx, stats, dqkv, (int)(B * H), (int)L, (int)H,
      (int)row_tiles, stages, div);
  return (int)cudaGetLastError();
}

bool valid(int64_t B, int64_t L, int64_t H, int64_t hd, float div,
           int64_t W, int64_t T, int64_t stages, int64_t row_tiles,
           int64_t grid) {
  return B > 0 && H > 0 && L >= 1 && L <= 512 && B * L <= 2147483647LL &&
         B * H <= 2147483647LL && row_tiles >= 1 && grid >= 1 &&
         grid <= 2147483647LL &&
         (hd == 16 || hd == 32 || hd == 64 || hd == 128) &&
         div > 0.f && div < INFINITY && (W == 4 || 16 * W >= L) &&
         (stages == 2 || (stages == 1 && T >= L));
}

// hd 16 and 64 at their own width's divisor (4, 8): the kExactDiv
// instances
bool exact_div(int64_t hd, float div) {
  return (hd == 16 && div == 4.f) || (hd == 64 && div == 8.f);
}

}  // namespace

// The instances ops/attention.backward_tiles_for picks: (hd, W warps a
// (b, h), G pairs a block, tile T); tests/test_torch_attention_grad_split.py
// holds the tiling to this list.
#define DQ_INSTANCE(HD_, W_, G_, T_)                                       \
  if (hd == HD_ && W == W_ && G == G_ && T == T_)                          \
    return exact_div(hd, div)                                              \
        ? launch_dq<HD_, W_, G_, T_, HD_ == 16 || HD_ == 64>(              \
              q, mk, g, out, st, B, L, H, (int)stages, row_tiles, grid,    \
              smem, div, s)                                                \
        : launch_dq<HD_, W_, G_, T_, false>(q, mk, g, out, st, B, L, H,    \
                                            (int)stages, row_tiles, grid,  \
                                            smem, div, s);
#define DKV_INSTANCE(HD_, W_, G_, T_)                                      \
  if (hd == HD_ && W == W_ && G == G_ && T == T_)                          \
    return exact_div(hd, div)                                              \
        ? launch_dkv<HD_, W_, G_, T_, HD_ == 16 || HD_ == 64>(             \
              q, mk, g, st, out, B, L, H, (int)stages, row_tiles, grid,    \
              smem, div, s)                                                \
        : launch_dkv<HD_, W_, G_, T_, false>(q, mk, g, st, out, B, L, H,   \
                                             (int)stages, row_tiles, grid, \
                                             smem, div, s);

// Both enqueue on `stream` and return cudaGetLastError() (0 on success);
// a refused launch never runs, so the caller must check it. The caller
// guarantees contiguous f32 qkv and dqkv [B, L, 3 * H * hd] and dctx
// [B, L, H * hd], all 16-byte aligned, int32 mask [B, L], f32 stats
// [B * H * L * 4] 16-byte aligned, 1 <= L <= 512, hd in {16, 32, 64, 128},
// div = f32(sqrt(hd)), or f32(sqrt(w)) for heads of a true width w < hd
// zero-padded to hd (any positive finite div is taken), and the tiling
// (W, G, T, stages, row_tiles, grid, smem) of
// ops/attention.backward_tiles_for: an instance of the lists
// below, 16 W >= L unless W = 4, stages 1 only where one tile covers L,
// row_tiles * 16 W >= L, grid = ceil(B H / G) row_tiles, and smem the
// instance's layout for `stages` (refused otherwise). dq writes
// dQ (the first D columns of dqkv) and the stats; dkv, launched after it
// on the same stream, reads the stats and writes dK and dV.
extern "C" int encoder_attention_backward_dq_launch(
    const void* qkv, const void* mask, const void* dctx, void* dqkv,
    void* stats, int64_t B, int64_t L, int64_t H, int64_t hd, int64_t W,
    int64_t G, int64_t T, int64_t stages, int64_t row_tiles, int64_t grid,
    int64_t smem, float div, void* stream) {
  if (!valid(B, L, H, hd, div, W, T, stages, row_tiles, grid)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* q = (const float*)qkv;
  const int32_t* mk = (const int32_t*)mask;
  const float* g = (const float*)dctx;
  float* out = (float*)dqkv;
  float4* st = (float4*)stats;
  cudaStream_t s = (cudaStream_t)stream;
  DQ_INSTANCE(16, 1, 4, 16)
  DQ_INSTANCE(16, 2, 2, 32)
  DQ_INSTANCE(16, 4, 1, 64)
  DQ_INSTANCE(32, 1, 4, 16)
  DQ_INSTANCE(32, 2, 2, 32)
  DQ_INSTANCE(32, 4, 1, 64)
  DQ_INSTANCE(64, 1, 2, 16)
  DQ_INSTANCE(64, 2, 1, 32)
  DQ_INSTANCE(64, 4, 1, 32)
  DQ_INSTANCE(128, 1, 1, 16)
  DQ_INSTANCE(128, 2, 1, 16)
  DQ_INSTANCE(128, 4, 1, 16)
  return (int)cudaErrorInvalidValue;
}

extern "C" int encoder_attention_backward_dkv_launch(
    const void* qkv, const void* mask, const void* dctx, const void* stats,
    void* dqkv, int64_t B, int64_t L, int64_t H, int64_t hd, int64_t W,
    int64_t G, int64_t T, int64_t stages, int64_t row_tiles, int64_t grid,
    int64_t smem, float div, void* stream) {
  if (!valid(B, L, H, hd, div, W, T, stages, row_tiles, grid)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* q = (const float*)qkv;
  const int32_t* mk = (const int32_t*)mask;
  const float* g = (const float*)dctx;
  const float4* st = (const float4*)stats;
  float* out = (float*)dqkv;
  cudaStream_t s = (cudaStream_t)stream;
  DKV_INSTANCE(16, 1, 4, 16)
  DKV_INSTANCE(16, 2, 2, 32)
  DKV_INSTANCE(16, 4, 1, 64)
  DKV_INSTANCE(32, 1, 4, 16)
  DKV_INSTANCE(32, 2, 2, 32)
  DKV_INSTANCE(32, 4, 1, 64)
  DKV_INSTANCE(64, 1, 2, 16)
  DKV_INSTANCE(64, 2, 1, 32)
  DKV_INSTANCE(64, 4, 1, 32)
  DKV_INSTANCE(128, 1, 1, 16)
  DKV_INSTANCE(128, 2, 1, 16)
  DKV_INSTANCE(128, 4, 1, 16)
  return (int)cudaErrorInvalidValue;
}
