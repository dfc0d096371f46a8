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

#include "attention_wide.cuh"
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
using wide::allow_smem;

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

// ---------------------------------------------------------------------------
// Head widths above 128 (any hd >= 1 is taken): 3xTF32 mma.sync with the
// head's columns streamed.
//
// The instances above keep a warp's 16 x hd accumulators in registers (dQ;
// dK and dV): 128 and 256 floats a thread at hd 256, which no width above
// 128 fits. These keep nothing of width hd in registers, and run every
// product on the tensor cores as the instances above do (mma3: a_lo b_hi,
// a_hi b_lo, a_hi b_hi; tf32_mma.cuh). They replace f32 FFMA kernels of
// the same entry points (a3966e4, this file :868-1077) that reached 1.5%
// of the 3xTF32 bound at hd 256, B = 8, L = 512.
//
// A block of kWideWarps = 8 warps owns kRows = 16 rows of its side of one
// (b, h) (queries in dq, keys in dkv). Those rows' scores against all L
// rows of the other side stay in shared memory, two floats a pair (dq: S,
// then P; dP, then dS. dkv: P^T and dS^T), in rows of `score_stride(L)`
// floats.
// - Phase A forms them. The other side comes in tiles of kTile = 128 rows
//   (keys in dq, queries in dkv), a warp an n-slice of 16, and the head's
//   columns in chunks of C = 16 or 32: a chunk of the block's own rows
//   (Q and dO in dq; K and V in dkv) and of the tile's rows lands raw
//   through a two-stage cp.async ring (chunk s + 1 is copied while chunk s
//   is multiplied), in rows of C + 4 floats so a warp's fragment reads fall
//   on 32 banks. S and dP sum over d on the tensor core: a chunk's
//   products from 0, added to the tile's sums in rounded f32, so no sum
//   is taken into the accumulator more than 3 C / 8 times (a whole head of
//   320 would take 120 truncating steps; under the truncation model of
//   benches/train_bench.wide_backward_tf32 that drifts 3-5 times further).
// - dq's phase B, a warp a row: each row's max m, sum l and delta =
//   sum_j P_ij dP_ij, then P and dS = P (dP - delta) / div in place (the
//   FFMA design's code); (m, l, delta, 0) go to `stats`. dkv forms P^T =
//   exp(s - m) / l and dS^T from the stats as each tile of its scores
//   completes.
// - Phase C: dQ = dS K in dq, dK = dS^T Q and dV = P^T dO in dkv. The
//   head's columns go in passes of at most kPass = 128, a warp an eighth
//   of a pass (up to 2 n8 steps, rounded up to whole steps); A fragments
//   come from the score rows, the other side's rows of the pass through
//   the same ring in tiles of `tc` rows (rows of kStrideC = 136 floats, so
//   a warp's reads down a column fall on 32 banks). These sums run over up
//   to 512 rows: each 8-row k-step's products are summed from 0 and added
//   in rounded f32 (mma3_add), as in the instances above.
// Operands sit raw in shared memory and are split into tf32 hi and lo as
// a fragment is read. Keys past L weigh 0 (score -inf, rows zero-filled);
// query rows past L are computed and not stored. The two kernels form a
// pair's score from the same products in the same order, but nothing
// relies on that: the gate is BWD_TOL against f64.
//
// What bounds them on the H100 (benches/train_bench.backward_work): at
// hd 256, B = 8, L = 512, H = 4 the products at the 3xTF32 rate (78.1 us
// dq, 104.1 us dkv). They execute about what that counts (dq: S, dP, dQ;
// dkv: S, dP, dK, dV), plus a hi / lo split of 5 integer and float
// operations for every element of a fragment read, issued beside the
// tensor cores' work by the same warp schedulers, and they wait on shared
// memory and on L2 (each block reads its (b, h)'s other side once). At
// L = 512 the score rows take 66 KB of a block's 110 KB (C = 16), so 2
// blocks of 8 warps fit an SM: 16 warps to hide that latency, where 4-warp
// blocks over tiles of 64 rows (this design's first form) had 8. On the
// card the 8-warp blocks ran every case of benches/encoder_bench.
// WIDTH_CASES faster than the 4-warp ones, and slower at L <= 16 (a tile
// of 128 rows is then mostly padding) and at hd 256, B = 32, L = 128
// against 32 rows a 4-warp block (PERF.md §6). Slower still,
// and not kept: 32 rows in one block an SM at L = 512; tiles of 128 rows
// with 4 n8 steps a warp; n8 steps past L skipped behind a branch, dS
// split once in phase B and a staging loop specialised to the chunk.
//
// The ring, the fragments and the passes are attention_wide.cuh's, which
// the wide forward (encoder_attention.cu) shares.
//
// Tiling (ops/attention.wide_backward_tiles_for, which the wrapper passes
// in): 16 rows a block, the chunk C (a WIDE_INSTANCE), the row tiles, the
// grid and the shared memory; the entry points refuse a shared-memory size
// other than the instance's WideTile layout for L.
// ---------------------------------------------------------------------------

namespace {

using wide::frag_a;
using wide::frag_b_cols;
using wide::frag_b_rows;
using wide::kNt;
using wide::kPass;
using wide::kStrideC;
using wide::kTile;
using wide::kWideThreads;
using wide::kWideWarps;
using wide::Passes;
using wide::score_stride;
using wide::stage_rows;

constexpr int kRows = 16;                 // own rows a block: one m16 tile

// a block's shared memory: two score arrays, two operands a side
template <int C>
using WideTile = wide::TileLayout<C, kRows, 2>;

// Phase A's products of one ring stage (own rows: operands x0 at st, x1 at
// st + kRows rows; the tile: y0 at st + 2 kRows rows, y1 at st + (2 kRows
// + kTile) rows): s += x0 y0^T, d += x1 y1^T over the stage's C columns
// for this warp's 16 tile rows, summed from 0 and added in rounded f32, or
// taken as they are on the first chunk of a tile
template <int C>
__device__ __forceinline__ void chunk_products(const float* st, int warp,
                                               int g, int t, bool first,
                                               float (&s)[2][4],
                                               float (&d)[2][4]) {
  constexpr int SA = WideTile<C>::kStrideA;
  const float* y0 = st + (2 * kRows + 16 * warp) * SA;
  const float* y1 = y0 + kTile * SA;
  float cs[2][4], cd[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) cs[n][e] = cd[n][e] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < C; k += 8) {
    float4 b0[2], b1[2];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      b0[n] = frag_b_rows(y0 + 8 * n * SA + k, SA, g, t);
      b1[n] = frag_b_rows(y1 + 8 * n * SA + k, SA, g, t);
    }
    uint32_t ah[4], al[4];
    frag_a(st + k, SA, g, t, ah, al);
#pragma unroll
    for (int n = 0; n < 2; ++n) mma3(cs[n], ah, al, b0[n]);
    frag_a(st + kRows * SA + k, SA, g, t, ah, al);
#pragma unroll
    for (int n = 0; n < 2; ++n) mma3(cd[n], ah, al, b1[n]);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = first ? cs[n][e] : s[n][e] + cs[n][e];
      d[n][e] = first ? cd[n][e] : d[n][e] + cd[n][e];
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kWideThreads, 2)
attention_dq_kernel(wide::WideArgs a, int row_tiles, bool vec) {
  using Y = WideTile<C>;
  constexpr int R = kRows, SA = Y::kStrideA, TC = Y::tc(1);
  static_assert(TC >= 8, "a phase-C stage holds a k-step");
  extern __shared__ __align__(16) float smem[];
  const int L = a.L, hd = a.hd, Ls = score_stride(L);
  float* Sb = smem;              // [R][Ls]: s, then P
  float* Db = Sb + R * Ls;       // [R][Ls]: dP, then dS
  float* ring = Db + R * Ls;     // 2 stages
  const int bh = blockIdx.x / row_tiles, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x % row_tiles * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t rs = 3 * (int64_t)a.H * hd, os = (int64_t)a.H * hd;
  const float* Q = wide::q_of(a, b, h);
  const float* K = wide::k_of(a, b, h);
  const float* V = wide::v_of(a, b, h);
  const float* dO = wide::do_of(a, b, h);
  const int32_t* mk = a.mask + (int64_t)b * L;

  // phase A: step s takes key tile s / nch, head columns chunk s % nch
  const int nch = (hd + C - 1) / C;
  const int nA = (L + kTile - 1) / kTile * nch;
  auto stage_a = [&](int s) {
    float* st = ring + (s & 1) * Y::kStage;
    const int k0 = s / nch * kTile, c0 = s % nch * C;
    stage_rows(st, SA, Q, rs, q0, R, L, c0, C, hd, vec);
    stage_rows(st + R * SA, SA, dO, os, q0, R, L, c0, C, hd, vec);
    stage_rows(st + 2 * R * SA, SA, K, rs, k0, kTile, L, c0, C, hd, vec);
    stage_rows(st + (2 * R + kTile) * SA, SA, V, rs, k0, kTile, L, c0, C,
               hd, vec);
  };
  float sc[2][4], dp[2][4];
  stage_a(0);
  cp_async_commit();
  for (int s = 0; s < nA; ++s) {
    if (s + 1 < nA) stage_a(s + 1);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    chunk_products<C>(ring + (s & 1) * Y::kStage, warp, g, t, s % nch == 0,
                      sc, dp);
    if (s % nch == nch - 1) {   // the tile's S and dP are complete
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int j = s / nch * kTile + 16 * warp + 8 * n + 2 * t;
        const float b0 = j >= L ? -INFINITY : mk[j] > 0 ? 0.f : kMasked;
        const float b1 = j + 1 >= L ? -INFINITY
                                    : mk[j + 1] > 0 ? 0.f : kMasked;
        *reinterpret_cast<float2*>(Sb + g * Ls + j) =
            make_float2(__fdiv_rn(sc[n][0], a.div) + b0,
                        __fdiv_rn(sc[n][1], a.div) + b1);
        *reinterpret_cast<float2*>(Sb + (g + 8) * Ls + j) =
            make_float2(__fdiv_rn(sc[n][2], a.div) + b0,
                        __fdiv_rn(sc[n][3], a.div) + b1);
        *reinterpret_cast<float2*>(Db + g * Ls + j) =
            make_float2(dp[n][0], dp[n][1]);
        *reinterpret_cast<float2*>(Db + (g + 8) * Ls + j) =
            make_float2(dp[n][2], dp[n][3]);
      }
    }
    __syncthreads();
  }

  // phase C's first stage is copied while phase B runs
  const Passes ps(hd);
  const int nkc = (L + TC - 1) / TC, nC = ps.n * nkc;
  auto stage_c = [&](int s) {
    stage_rows(ring + (s & 1) * Y::kStage, kStrideC, K, rs, s % nkc * TC, TC,
               L, s / nkc * kWideWarps * ps.wc, kWideWarps * ps.wc, hd, vec);
  };
  stage_c(0);
  cp_async_commit();

  // phase B: a warp a row; rows past L keep dS = dP = 0
  for (int r = warp; r < R; r += kWideWarps) {
    if (q0 + r >= L) continue;
    float* prow = Sb + r * Ls;
    float* drow = Db + r * Ls;
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, prow[j]);
    m = wide::warp_max(m);
    float l = 0.f;
    for (int j = lane; j < L; j += 32) l += expf(prow[j] - m);
    l = wide::warp_sum(l);
    float delta = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float pj = __fdiv_rn(expf(prow[j] - m), l);
      prow[j] = pj;
      delta = fmaf(pj, drow[j], delta);
    }
    delta = wide::warp_sum(delta);
    for (int j = lane; j < L; j += 32)
      drow[j] = __fdiv_rn(prow[j] * (drow[j] - delta), a.div);
    if (lane == 0) {
      reinterpret_cast<float4*>(a.stats)[(int64_t)bh * L + q0 + r] =
          make_float4(m, l, delta, 0.f);
    }
  }

  // phase C: dQ = dS K, this warp's columns of each pass
  const int nt = ps.wc / 8;
  float acc[kNt][4];
  for (int s = 0; s < nC; ++s) {
    if (s + 1 < nC) stage_c(s + 1);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const int kc = s % nkc;
    if (kc == 0) {
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      }
    }
    const float* kst = ring + (s & 1) * Y::kStage + warp * ps.wc;
#pragma unroll
    for (int k = 0; k < TC; k += 8) {
      uint32_t ah[4], al[4];
      frag_a(Db + kc * TC + k, Ls, g, t, ah, al);
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        if (n < nt) {
          const float4 bk = frag_b_cols(kst + k * kStrideC + 8 * n, kStrideC,
                                        g, t);
          mma3_add(acc[n], ah, al, bk);
        }
      }
    }
    if (kc == nkc - 1) {
      const int c0 = s / nkc * kWideWarps * ps.wc + warp * ps.wc + 2 * t;
      float* out = a.out + (int64_t)b * L * rs + (int64_t)h * hd;
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q0 + g + (e >= 2 ? 8 : 0);
          const int col = c0 + 8 * n + (e & 1);
          if (n < nt && row < L && col < hd)
            out[(int64_t)row * rs + col] = acc[n][e];
        }
      }
    }
    __syncthreads();
  }
}

template <int C>
__global__ void __launch_bounds__(kWideThreads, 2)
attention_dkv_kernel(wide::WideArgs a, int row_tiles, bool vec) {
  using Y = WideTile<C>;
  constexpr int R = kRows, SA = Y::kStrideA, TC = Y::tc(2);
  static_assert(TC >= 8, "a phase-C stage holds a k-step");
  extern __shared__ __align__(16) float smem[];
  const int L = a.L, hd = a.hd, Ls = score_stride(L);
  float* Pb = smem;              // [R keys][Ls queries]: P^T
  float* Db = Pb + R * Ls;       // [R][Ls]: dS^T
  float* ring = Db + R * Ls;
  const int bh = blockIdx.x / row_tiles, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x % row_tiles * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int64_t rs = 3 * (int64_t)a.H * hd, os = (int64_t)a.H * hd;
  const float* Q = wide::q_of(a, b, h);
  const float* K = wide::k_of(a, b, h);
  const float* V = wide::v_of(a, b, h);
  const float* dO = wide::do_of(a, b, h);
  const int32_t* mk = a.mask + (int64_t)b * L;
  const float4* stats = reinterpret_cast<const float4*>(a.stats) +
                        (int64_t)bh * L;

  // the biases of this lane's keys (rows g and g + 8)
  float bias[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = k0 + g + 8 * u;
    bias[u] = j >= L ? -INFINITY : mk[j] > 0 ? 0.f : kMasked;
  }

  // phase A: step s takes query tile s / nch, head columns chunk s % nch
  const int nch = (hd + C - 1) / C;
  const int nA = (L + kTile - 1) / kTile * nch;
  auto stage_a = [&](int s) {
    float* st = ring + (s & 1) * Y::kStage;
    const int i0 = s / nch * kTile, c0 = s % nch * C;
    stage_rows(st, SA, K, rs, k0, R, L, c0, C, hd, vec);
    stage_rows(st + R * SA, SA, V, rs, k0, R, L, c0, C, hd, vec);
    stage_rows(st + 2 * R * SA, SA, Q, rs, i0, kTile, L, c0, C, hd, vec);
    stage_rows(st + (2 * R + kTile) * SA, SA, dO, os, i0, kTile, L, c0, C,
               hd, vec);
  };
  float sc[2][4], dp[2][4];
  stage_a(0);
  cp_async_commit();
  for (int s = 0; s < nA; ++s) {
    if (s + 1 < nA) stage_a(s + 1);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    chunk_products<C>(ring + (s & 1) * Y::kStage, warp, g, t, s % nch == 0,
                      sc, dp);
    if (s % nch == nch - 1) {   // S^T and dP^T of the tile: P^T, dS^T
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int i = s / nch * kTile + 16 * warp + 8 * n + 2 * t;
        const float4 z = make_float4(0.f, 1.f, 0.f, 0.f);
        const float4 st[2] = {i < L ? stats[i] : z,
                              i + 1 < L ? stats[i + 1] : z};
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4& q = st[e & 1];
          const float x = __fdiv_rn(sc[n][e], a.div) + bias[e >> 1];
          p[e] = __fdiv_rn(expf(x - q.x), q.y);
          ds[e] = __fdiv_rn(p[e] * (dp[n][e] - q.z), a.div);
          if (i + (e & 1) >= L) p[e] = ds[e] = 0.f;   // no such query
        }
        *reinterpret_cast<float2*>(Pb + g * Ls + i) = make_float2(p[0], p[1]);
        *reinterpret_cast<float2*>(Pb + (g + 8) * Ls + i) =
            make_float2(p[2], p[3]);
        *reinterpret_cast<float2*>(Db + g * Ls + i) =
            make_float2(ds[0], ds[1]);
        *reinterpret_cast<float2*>(Db + (g + 8) * Ls + i) =
            make_float2(ds[2], ds[3]);
      }
    }
    __syncthreads();
  }

  // phase C: dV = P^T dO, dK = dS^T Q, this warp's columns of each pass;
  // a stage holds TC rows of Q, then TC of dO
  const Passes ps(hd);
  const int nkc = (L + TC - 1) / TC, nC = ps.n * nkc, nt = ps.wc / 8;
  auto stage_c = [&](int s) {
    float* st = ring + (s & 1) * Y::kStage;
    const int i0 = s % nkc * TC, c0 = s / nkc * kWideWarps * ps.wc;
    stage_rows(st, kStrideC, Q, rs, i0, TC, L, c0, kWideWarps * ps.wc, hd,
               vec);
    stage_rows(st + TC * kStrideC, kStrideC, dO, os, i0, TC, L, c0,
               kWideWarps * ps.wc, hd, vec);
  };
  stage_c(0);
  cp_async_commit();
  float dk[kNt][4], dv[kNt][4];
  for (int s = 0; s < nC; ++s) {
    if (s + 1 < nC) stage_c(s + 1);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const int kc = s % nkc;
    if (kc == 0) {
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
      }
    }
    const float* qst = ring + (s & 1) * Y::kStage + warp * ps.wc;
    const float* ost = qst + TC * kStrideC;
#pragma unroll
    for (int k = 0; k < TC; k += 8) {
      uint32_t ph[4], pl[4], dh[4], dl[4];
      frag_a(Pb + kc * TC + k, Ls, g, t, ph, pl);
      frag_a(Db + kc * TC + k, Ls, g, t, dh, dl);
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        if (n < nt) {
          const float4 bo = frag_b_cols(ost + k * kStrideC + 8 * n, kStrideC,
                                        g, t);
          const float4 bq = frag_b_cols(qst + k * kStrideC + 8 * n, kStrideC,
                                        g, t);
          mma3_add(dv[n], ph, pl, bo);
          mma3_add(dk[n], dh, dl, bq);
        }
      }
    }
    if (kc == nkc - 1) {
      const int c0 = s / nkc * kWideWarps * ps.wc + warp * ps.wc + 2 * t;
      float* out = a.out + (int64_t)b * L * rs + (int64_t)h * hd;
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = k0 + g + (e >= 2 ? 8 : 0);
          const int col = c0 + 8 * n + (e & 1);
          if (n < nt && row < L && col < hd) {
            out[(int64_t)row * rs + os + col] = dk[n][e];
            out[(int64_t)row * rs + 2 * os + col] = dv[n][e];
          }
        }
      }
    }
    __syncthreads();
  }
}

template <int C>
int launch_wide(bool dq, const wide::WideArgs& a, int64_t row_tiles,
                int64_t grid, int64_t smem, bool vec, cudaStream_t stream) {
  if (smem != (int64_t)WideTile<C>::floats(a.L) * (int64_t)sizeof(float))
    return (int)cudaErrorInvalidValue;
  void (*kernel)(wide::WideArgs, int, bool) =
      dq ? attention_dq_kernel<C> : attention_dkv_kernel<C>;
  static int64_t allowed[2] = {0, 0};   // one attribute call per larger size
  const int err = allow_smem(kernel, smem, allowed[dq]);
  if (err != (int)cudaSuccess) return err;
  kernel<<<(unsigned)grid, kWideThreads, smem, stream>>>(a, (int)row_tiles,
                                                          vec);
  return (int)cudaGetLastError();
}

// The chunks ops/attention.wide_backward_tiles_for picks;
// tests/test_torch_attention_wide_split.py holds the tiling to this list.
#define WIDE_INSTANCE(C_) \
  if (chunk == C_) return launch_wide<C_>(dq, a, row_tiles, grid, smem, vec, s);

int wide_backward_launch(bool dq, const void* qkv, const void* mask,
                         const void* dctx, void* dqkv, void* stats,
                         int64_t B, int64_t L, int64_t H, int64_t hd,
                         int64_t rows, int64_t chunk, int64_t row_tiles,
                         int64_t grid, int64_t smem, float div,
                         void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (L > 512 || H <= 0 || hd <= 0 || B * H > 2147483647LL ||
      B * L * 3 * H * hd > (int64_t)1 << 40 ||
      !(div > 0.f && div < INFINITY) || rows != kRows ||
      row_tiles != (L + rows - 1) / rows || grid != B * H * row_tiles ||
      grid > 2147483647LL || (uintptr_t)stats % 16) {
    return (int)cudaErrorInvalidValue;
  }
  wide::WideArgs a{(const float*)qkv, (const int32_t*)mask,
                   (const float*)dctx, (float*)dqkv, (float*)stats, (int)B,
                   (int)L, (int)H, (int)hd, div};
  const bool vec = hd % 4 == 0 &&
      ((uintptr_t)qkv | (uintptr_t)dctx) % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  WIDE_INSTANCE(32)
  WIDE_INSTANCE(16)
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Head widths above 128 (any hd >= 1 is taken), 1 <= L <= 512, div =
// f32(sqrt(hd)); contiguous f32 qkv [B, L, 3 H hd], dctx [B, L, H hd],
// dqkv [B, L, 3 H hd], stats [B H L, 4] (16-byte aligned), int32 mask
// [B, L], and the tiling of ops/attention.wide_backward_tiles_for: rows
// = 16, the chunk of a WIDE_INSTANCE, row_tiles = ceil(L / 16), grid = B H
// row_tiles, smem the instance's WideTile layout for L (refused
// otherwise). The dq launch fills dQ and stats; the dkv launch, after it
// in stream order, reads stats and fills dK and dV. Each returns
// cudaGetLastError().
extern "C" int encoder_attention_backward_dq_wide_launch(
    const void* qkv, const void* mask, const void* dctx, void* dqkv,
    void* stats, int64_t B, int64_t L, int64_t H, int64_t hd, int64_t rows,
    int64_t chunk, int64_t row_tiles, int64_t grid, int64_t smem, float div,
    void* stream) {
  return wide_backward_launch(true, qkv, mask, dctx, dqkv, stats, B, L, H,
                              hd, rows, chunk, row_tiles, grid, smem, div,
                              stream);
}

extern "C" int encoder_attention_backward_dkv_wide_launch(
    const void* qkv, const void* mask, const void* dctx, const void* stats,
    void* dqkv, int64_t B, int64_t L, int64_t H, int64_t hd, int64_t rows,
    int64_t chunk, int64_t row_tiles, int64_t grid, int64_t smem, float div,
    void* stream) {
  return wide_backward_launch(false, qkv, mask, dctx, dqkv, (void*)stats, B,
                              L, H, hd, rows, chunk, row_tiles, grid, smem,
                              div, stream);
}
