// Exact candidate rescores of the pruned full-text tier, for NVIDIA Hopper
// (sm_90a). Two kernels, each replacing a jitted JAX function of
// oramacore_tpu/ops/pruned.py (XLA code, no Pallas kernel):
//
// rescore_bsearch replaces _rescore_bsearch, phase 2 of the default (v4)
// route. JAX vectorizes a uniform binary search over (B, T, NR, C) with
// `bs_steps` rounds of gathers. Here one thread owns one (query,
// candidate) pair: for each token and each of its doc-sorted ranges it
// binary-searches the candidate's doc id, inside the bucket window
// [flat[base + j], flat[base + j + 1]) with j = cand >> shift when the
// static offset tables are given (else [0, len)), gathers tf and flen on a
// hit, sums ntf over the ranges in order and saturates per token with the
// host idf. What bounds it: the latency of the dependent loads (one per
// round), not bytes; the tables cut the rounds to log2 of the largest
// bucket. Pairs are independent, so a grid of B * C threads keeps many
// chains in flight.
//
// rescore_worklist replaces _rescore_worklist, phase 2 of the filtered,
// exact-tf, multi-field and tolerance (v3) routes. JAX streams each
// worklist entry's postings (a chunk of at most lch of one token's range),
// prefix-sums their ntf and takes each candidate's contribution as a
// difference of two binary-searched prefix sums, because the TPU has no
// fast scatter. Here one block takes one entry: it loads the entry's query's
// C candidates into shared memory, each thread walks postings with a
// stride, looks the doc up by binary search in shared memory and, on a
// hit, adds ntf with an atomic into acc[b*T + t][c] (no prefix sums, so no
// cancellation). The same pass counts the entry's df (tf > 0, inside the
// filter mask) less the postings whose doc an earlier span of the token
// holds (a bs_steps-round binary search per earlier span), reduced in the
// block and added once. What bounds it: device-memory bytes of the
// postings (coalesced 4-byte loads); the candidate lookups stay in shared
// memory and hits are rare. The saturation tail is torch code.
//
// Arithmetic keeps the plain versions' operand order with round-to-nearest
// intrinsics (no FMA contraction):
//   denom = (1 - b) + (b * flen) / max(avg, 1e-9)
//   ntf   = (w * tf) / max(denom, 1e-9)
//   sat   = ((idf * 2.2) * acc) / (1.2 + acc)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kK1 = 1.2f;
constexpr float kK1p1 = 2.2f;  // K1 + 1.0, rounded to f32 as in the plain code

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float ntf_of(float w, float fb, float av, float tf,
                                        float fl) {
  const float denom = __fadd_rn(1.0f - fb,
                                __fdiv_rn(__fmul_rn(fb, fl), fmaxf(av, 1e-9f)));
  return __fdiv_rn(__fmul_rn(w, tf), fmaxf(denom, 1e-9f));
}

// ---------------------------------------------------------------------------
// rescore_bsearch
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) rescore_bsearch_kernel(
    const int32_t* __restrict__ p_doc, const float* __restrict__ p_tf,
    const float* __restrict__ p_flen, int64_t n,
    const int32_t* __restrict__ rng_st, const int32_t* __restrict__ rng_ln,
    const float* __restrict__ rng_w, const float* __restrict__ rng_fb,
    const float* __restrict__ rng_av, const float* __restrict__ idf,
    const int32_t* __restrict__ cand, int64_t B, int64_t T, int64_t NR,
    int64_t C, int bs_steps,
    const int32_t* __restrict__ flat, int64_t n_flat,
    const int32_t* __restrict__ b_base, const int32_t* __restrict__ b_shift,
    float* __restrict__ scores, float* __restrict__ matched) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int64_t b = i / C;
  const int32_t q = cand[i];
  float score = 0.0f, nm = 0.0f;
  for (int64_t t = 0; t < T; ++t) {
    float acc = 0.0f;
    for (int64_t r = 0; r < NR; ++r) {
      const int64_t o = (b * T + t) * NR + r;
      const int64_t ln = rng_ln[o];
      if (ln <= 0) continue;  // an empty range adds +0.0
      const int64_t s0 = rng_st[o];
      int64_t pos = 0, hi = ln;
      if (flat != nullptr) {
        const int sh = min(max(b_shift[o], 0), 31);
        const int64_t at_j = (int64_t)b_base[o] + (int64_t)((uint32_t)q >> sh);
        pos = flat[clamp64(at_j, 0, n_flat - 1)];
        hi = flat[clamp64(at_j + 1, 0, n_flat - 1)];
      }
      for (int64_t step = int64_t(1) << (bs_steps - 1); step >= 1; step >>= 1) {
        const int64_t probe = pos + step;
        if (probe <= hi && p_doc[clamp64(s0 + probe - 1, 0, n - 1)] < q) {
          pos = probe;
        }
      }
      const int64_t at = clamp64(s0 + pos, 0, n - 1);
      const bool hit = pos < ln && p_doc[at] == q;
      const float tf = hit ? p_tf[at] : 0.0f;
      acc = __fadd_rn(acc, ntf_of(rng_w[o], rng_fb[o], rng_av[o], tf,
                                  p_flen[at]));
    }
    if (acc > 0.0f) {
      const float sat = __fdiv_rn(__fmul_rn(__fmul_rn(idf[b * T + t], kK1p1),
                                            acc),
                                  __fadd_rn(kK1, acc));
      score = __fadd_rn(score, sat);
      nm += 1.0f;
    }
  }
  scores[i] = score;
  matched[i] = nm;
}

// ---------------------------------------------------------------------------
// rescore_worklist
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) rescore_worklist_kernel(
    const int32_t* __restrict__ p_doc, const float* __restrict__ p_tf,
    const float* __restrict__ p_flen, int64_t n,
    const int32_t* __restrict__ wl_i, const float* __restrict__ wl_f,
    int64_t W, const int32_t* __restrict__ cand, int64_t C, int64_t T,
    int64_t lch, const int32_t* __restrict__ wl_prev, int64_t nre,
    int bs_steps, const float* __restrict__ fmask, int64_t n_mask,
    float* __restrict__ acc, int32_t* __restrict__ df) {
  extern __shared__ int32_t s_cand[];
  __shared__ int s_warp_df[kThreads / 32];
  const int64_t e = blockIdx.x;
  const int64_t ln = wl_i[3 * W + e];
  if (ln <= 0) return;  // padding entry: the whole block leaves
  const int64_t b = wl_i[e], t = wl_i[W + e], st = wl_i[2 * W + e];
  const float w = wl_f[e], fb = wl_f[W + e], av = wl_f[2 * W + e];
  for (int64_t c = threadIdx.x; c < C; c += blockDim.x) {
    s_cand[c] = cand[b * C + c];
  }
  __syncthreads();
  // JAX's dynamic_slice clamps the start: slot j is posting s_eff + j
  const int64_t s_eff = clamp64(st, 0, n - lch > 0 ? n - lch : 0);
  float* acc_row = acc + (b * T + t) * C;
  int my_df = 0;
  for (int64_t j = threadIdx.x; j < ln; j += blockDim.x) {
    const int64_t p = s_eff + j;
    if (p >= n) break;
    const float tf = p_tf[p];
    if (!(tf > 0.0f)) continue;
    const int32_t d = p_doc[p];
    if (fmask != nullptr && !(fmask[clamp64(d, 0, n_mask - 1)] > 0.0f)) {
      continue;
    }
    ++my_df;
    if (nre > 0) {  // union df: the doc already counted in an earlier span
      bool seen = false;
      for (int64_t k = 0; k < nre && !seen; ++k) {
        const int64_t st_e = wl_prev[e * nre + k];
        const int64_t ln_e = wl_prev[(W + e) * nre + k];
        if (ln_e <= 0) continue;
        int64_t pos = 0;
        for (int64_t step = int64_t(1) << (bs_steps - 1); step >= 1;
             step >>= 1) {
          const int64_t cp = pos + step;
          if (cp <= ln_e && p_doc[clamp64(st_e + cp - 1, 0, n - 1)] < d) {
            pos = cp;
          }
        }
        const int64_t at = clamp64(st_e + pos, 0, n - 1);
        seen = pos < ln_e && p_doc[at] == d && p_tf[at] > 0.0f;
      }
      if (seen) --my_df;
    }
    // lower bound of d in the sorted candidate table
    int64_t lo = 0, hi = C;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (s_cand[mid] < d) lo = mid + 1; else hi = mid;
    }
    if (lo < C && s_cand[lo] == d) {
      atomicAdd(acc_row + lo, ntf_of(w, fb, av, tf, p_flen[p]));
    }
  }
  // block sum of the df counts, one atomic per entry
  for (int off = 16; off > 0; off >>= 1) {
    my_df += __shfl_down_sync(0xffffffffu, my_df, off);
  }
  if ((threadIdx.x & 31) == 0) s_warp_df[threadIdx.x >> 5] = my_df;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < (int)(blockDim.x >> 5); ++k) total += s_warp_df[k];
    if (total != 0) atomicAdd(df + b * T + t, total);
  }
}

}  // namespace

// Each launcher enqueues on `stream` and returns cudaGetLastError() (0 on
// success); a refused launch never runs, so the caller must check it.

// scores and matched are f32[B, C]; flat / b_base / b_shift are null for a
// search without bucket tables.
extern "C" int rescore_bsearch_launch(
    const void* p_doc, const void* p_tf, const void* p_flen, int64_t n,
    const void* rng_st, const void* rng_ln, const void* rng_w,
    const void* rng_fb, const void* rng_av, const void* idf, const void* cand,
    int64_t B, int64_t T, int64_t NR, int64_t C, int64_t bs_steps,
    const void* flat, int64_t n_flat, const void* b_base, const void* b_shift,
    void* scores, void* matched, void* stream) {
  const int64_t pairs = B * C;
  if (pairs <= 0) return 0;
  if (bs_steps < 1 || bs_steps > 31 || n <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t blocks = (pairs + kThreads - 1) / kThreads;
  if (blocks > 2147483647) return (int)cudaErrorInvalidConfiguration;
  rescore_bsearch_kernel<<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)p_doc, (const float*)p_tf, (const float*)p_flen, n,
      (const int32_t*)rng_st, (const int32_t*)rng_ln, (const float*)rng_w,
      (const float*)rng_fb, (const float*)rng_av, (const float*)idf,
      (const int32_t*)cand, B, T, NR, C, (int)bs_steps,
      (const int32_t*)flat, n_flat, (const int32_t*)b_base,
      (const int32_t*)b_shift, (float*)scores, (float*)matched);
  return (int)cudaGetLastError();
}

// acc is f32[B*T, C] and df int32[B*T], both zeroed by the caller and
// added into; wl_prev (int32[2, W, nre]) is null when nre == 0, fmask
// (f32[n_mask]) null for an unfiltered search.
extern "C" int rescore_worklist_launch(
    const void* p_doc, const void* p_tf, const void* p_flen, int64_t n,
    const void* wl_i, const void* wl_f, int64_t W,
    const void* cand, int64_t C, int64_t T, int64_t lch,
    const void* wl_prev, int64_t nre, int64_t bs_steps,
    const void* fmask, int64_t n_mask,
    void* acc, void* df, void* stream) {
  if (W <= 0 || C <= 0) return 0;
  if (n <= 0 || lch <= 0 || (nre > 0 && (bs_steps < 1 || bs_steps > 31)) ||
      (fmask != nullptr && n_mask <= 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (W > 2147483647) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)C * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rescore_worklist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rescore_worklist_kernel<<<(unsigned)W, kThreads, smem,
                            (cudaStream_t)stream>>>(
      (const int32_t*)p_doc, (const float*)p_tf, (const float*)p_flen, n,
      (const int32_t*)wl_i, (const float*)wl_f, W, (const int32_t*)cand, C, T,
      lch, (const int32_t*)wl_prev, nre, (int)bs_steps, (const float*)fmask,
      n_mask, (float*)acc, (int32_t*)df);
  return (int)cudaGetLastError();
}
