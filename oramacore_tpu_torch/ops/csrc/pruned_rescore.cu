// Exact candidate rescores of the pruned full-text tier, for NVIDIA Hopper
// (sm_90a). Two entry points, each replacing a jitted JAX function of
// oramacore_tpu/ops/pruned.py (XLA code, no Pallas kernel).
//
// rescore_bsearch replaces _rescore_bsearch, phase 2 of the default (v4)
// route: for each (query, candidate), each token and each of its
// doc-sorted ranges, find the candidate's doc id inside the bucket window
// [flat[base + j], flat[base + j + 1]) with j = cand >> shift (else
// [0, len)), gather tf and flen on a hit, sum ntf over the ranges in order
// and saturate per token with the host idf. JAX runs a uniform binary
// search of `bs_steps` rounds of gathers over (B, T, NR, C).
//   What bounds it: chains of dependent loads, not bytes (a few MB a
//   call). A thread per (query, candidate) walking T x NR searches of
//   bs_steps rounds each is a chain of 24-36 loads. Here one thread takes
//   one (query, candidate, token, range) search, so a pair's searches run
//   side by side, and the window is read in one round: a chunk of kChunk
//   postings from a 16-byte boundary as 4 int4 loads issued together,
//   placed where the doc would sit if the bucket's docs were spread
//   evenly (the buckets of the 10M-doc tier hold 13-26 postings, too many
//   for one chunk: a chunk of all of them would take the registers of
//   two thirds of the threads). If the doc lies outside that chunk, the
//   rest of the window (and a window without bucket tables) narrows by
//   rounds of kProbes independent probes to one chunk. The chain is the
//   descriptors, the bucket pair, the chunk, and tf / flen on a hit, in
//   few enough registers that most of a B=64 call's searches are resident
//   at once. A block holds the searches of
//   kThreads / (T * NR) pairs and sums them through shared memory in the
//   plain version's order (ranges in r order inside a token, tokens in t
//   order).
//
// rescore_worklist replaces _rescore_worklist, phase 2 of the filtered,
// exact-tf, multi-field and tolerance (v3) routes. JAX streams each
// worklist entry's postings (a chunk of at most lch of one token's range),
// prefix-sums their ntf and takes each candidate's contribution as a
// difference of two binary-searched prefix sums, because the TPU has no
// fast scatter. Here the scatter is an atomic add: acc[b*T + t][c] sums
// the ntf of the entry postings whose doc is candidate slot c (the first
// slot holding it), with no prefix sums and so no cancellation.
//   What bounds it: device-memory bytes of the postings (8 B each) and,
//   under a filter, one gather of the mask per posting. The design:
//   * Tiles, not entries. An entry's postings are cut into tiles of
//     kTileVecs 16-byte vectors (2,048 postings), shared out among a few
//     blocks of the (entry, block) grid; a block of a short or padding
//     entry with no tile leaves at once. Each warp takes 256 contiguous
//     postings of a tile, 8 a lane.
//   * Loads without registers. A block streams its tiles through a ring
//     of kStages tiles in shared memory (32 KB), each filled a tile ahead
//     by cp.async (16-byte copies, evict-first in L2), so the mask
//     gathers, lookups and adds of one tile overlap the loads of the
//     next. The ring is short so that 5 blocks fit an SM: on the H100 more
//     resident warps beat a deeper ring with fewer blocks.
//   * The filter as a bitmap. Given `fbits` (1 bit a doc, 1.3 MB at 10.49M
//     docs) the gather reads a word that stays in L2 (evict-last policy);
//     the f32 mask (42 MB) still works for every caller that has no bitmap.
//   * The candidate table in shared memory (cp.async, under the posting
//     loads). For each tile each warp narrows it to the slots between its
//     kept docs' min and max, by two rounds of a 32-wide probe and ballot;
//     a posting then searches only that span (usually 0-2 slots).
//   * df once per block: the kept postings (tf > 0, inside the filter),
//     less those whose doc an earlier span of the token holds (nre > 0: a
//     bs_steps-round binary search per earlier span and posting; the
//     10M-doc tier's one-field corpus never runs it), reduced in the block
//     and added with one atomic.
//   * The tail in a second small kernel of the same entry point: each
//     slot reads its first slot's sums (repeated candidates), df -> idf,
//     saturation summed over tokens in t order, and the matched count.
//
// Arithmetic keeps the plain versions' operand order with round-to-nearest
// intrinsics (no FMA contraction):
//   denom = (1 - b) + (b * flen) / max(avg, 1e-9)
//   ntf   = (w * tf) / max(denom, 1e-9)
//   idf   = log1p(((n_docs - df) + 0.5) / (df + 0.5))
//   sat   = ((idf * 2.2) * acc) / (1.2 + acc)

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kK1 = 1.2f;
constexpr float kK1p1 = 2.2f;  // K1 + 1.0, rounded to f32 as in the plain code

// rescore_bsearch: postings of a chunk read in one round (4 int4 loads),
// and the probes of each round that narrows a wider window
constexpr int kChunk = 16;
constexpr int kProbes = 8;

// rescore_worklist: vectors a lane loads, and the tile (vectors of a block)
constexpr int kVecsPerLane = 2;
constexpr int kPerLane = 4 * kVecsPerLane;
constexpr int64_t kTileVecs = (int64_t)kThreads * kVecsPerLane;
constexpr int kStages = 2;  // tiles in a block's shared-memory ring

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float ntf_of(float w, float fb, float av, float tf,
                                        float fl) {
  const float denom = __fadd_rn(1.0f - fb,
                                __fdiv_rn(__fmul_rn(fb, fl), fmaxf(av, 1e-9f)));
  return __fdiv_rn(__fmul_rn(w, tf), fmaxf(denom, 1e-9f));
}

// An L2 policy for a stream read once: its lines go first.
__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(pol));
  return pol;
}

// An L2 policy that keeps the lines it touches over evict-first ones.
__device__ __forceinline__ unsigned long long evict_last_policy() {
  unsigned long long pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(pol));
  return pol;
}

// A 4-byte load under L2 policy `pol`.
__device__ __forceinline__ uint32_t ld_keep(const void* p,
                                            unsigned long long pol) {
  uint32_t v;
  asm("ld.global.L2::cache_hint.b32 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

// ---------------------------------------------------------------------------
// rescore_bsearch
// ---------------------------------------------------------------------------

// The count of entries of the chunk [c0, c0 + take) below q, read in one
// round from the chunk's 16-byte boundary (int4 loads when kVec: p_doc is
// 16-byte aligned; take <= kChunk - (s0 + c0) % 4); `hit` says whether
// one of them is q. Entries read p_doc[clamp(s0 + j)], as the plain
// version's probes do.
template <bool kVec>
__device__ __forceinline__ int64_t read_chunk(
    const int32_t* __restrict__ p_doc, int64_t n, int64_t s0, int64_t c0,
    int64_t take, int32_t q, bool& hit) {
  const int64_t a = s0 + c0;
  const int64_t head = a & 3;
  const int64_t base = a - head;
  const int nv = (int)((head + take + 3) >> 2);
  int32_t e[kChunk];
  if (kVec && a >= 0 && base + 4 * nv <= n) {
#pragma unroll
    for (int k = 0; k < kChunk / 4; ++k) {
      const int4 v = k < nv ? __ldg(reinterpret_cast<const int4*>(p_doc + base) + k)
                            : make_int4(INT_MAX, INT_MAX, INT_MAX, INT_MAX);
      e[4 * k] = v.x; e[4 * k + 1] = v.y; e[4 * k + 2] = v.z; e[4 * k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      e[j] = j >= head && j < head + take
                 ? __ldg(p_doc + clamp64(base + j, 0, n - 1)) : INT_MAX;
    }
  }
  int64_t cnt = 0;
  hit = false;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const bool in = j >= head && j < head + take;
    cnt += (in && e[j] < q) ? 1 : 0;
    hit |= in && e[j] == q;
  }
  return cnt;
}

// Where the binary search of the plain version ends on a doc-sorted
// window: lo plus the count of entries j in [lo, hi) with
// p_doc[clamp(s0 + j)] < q. `eq` is 1 if the entry there is q, 0 if not,
// -1 where no chunk read it (the caller reads it). A window wider than one
// chunk is first read at `est`, q's place if the bucket's docs were even
// (no guess: est < 0); if q lies outside that chunk, the rest narrows by
// rounds of kProbes independent probes down to one chunk.
template <bool kVec>
__device__ __forceinline__ int64_t window_search(
    const int32_t* __restrict__ p_doc, int64_t n, int64_t s0, int64_t lo,
    int64_t hi, int32_t q, int64_t est, int& eq) {
  eq = -1;
  bool hit;
  if (est >= 0 && hi - lo > kChunk - 3) {
    const int64_t c0 = clamp64(est - kChunk / 2, lo, hi - (kChunk - 3));
    const int64_t take = min(hi - c0, (int64_t)kChunk - ((s0 + c0) & 3));
    const int64_t cnt = read_chunk<kVec>(p_doc, n, s0, c0, take, q, hit);
    if (cnt == take) {
      lo = c0 + take;            // every entry read is below q
    } else if (cnt > 0 || c0 == lo) {
      eq = hit ? 1 : 0;          // the first entry >= q was read
      return c0 + cnt;
    } else {
      hi = c0;                   // q is at or before the chunk's start
    }
  }
  while (hi - lo > kChunk - 3) {
    // probes at lo + (i + 1) * step - 1: those below q are a prefix, and
    // the answer lies in the step after it
    const int64_t step = (hi - lo + kProbes - 1) / kProbes;
    int32_t v[kProbes];
#pragma unroll
    for (int i = 0; i < kProbes; ++i) {
      const int64_t idx = lo + (i + 1) * step - 1;
      v[i] = idx < hi ? __ldg(p_doc + clamp64(s0 + idx, 0, n - 1)) : INT_MAX;
    }
    int64_t k = 0;
#pragma unroll
    for (int i = 0; i < kProbes; ++i) k += (v[i] < q) ? 1 : 0;
    const int64_t nlo = lo + k * step;
    hi = min(hi, lo + (k + 1) * step - 1);
    lo = nlo;
  }
  if (hi > lo) {  // at most kChunk - 3 entries: one chunk
    const int64_t take = hi - lo;
    const int64_t cnt = read_chunk<kVec>(p_doc, n, s0, lo, take, q, hit);
    if (cnt < take) eq = hit ? 1 : 0;
    lo += cnt;
  }
  return lo;
}

// One block: the searches of `ppb` consecutive (query, candidate) pairs,
// one thread each (pair-major, then t, then r), then one thread per pair
// sums them. Shared memory holds each search's ntf and its token's idf
// (2 * ppb * T * NR floats).
template <bool kVec>
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
    int64_t ppb, float* __restrict__ scores, float* __restrict__ matched) {
  extern __shared__ float s_ntf[];
  // the launcher keeps B * C and B * T * NR below 2^31: 32-bit indices
  const uint32_t TN = (uint32_t)(T * NR);
  float* s_idf = s_ntf + ppb * TN;
  const uint32_t pair0 = blockIdx.x * (uint32_t)ppb;
  const uint32_t n_pairs = (uint32_t)min(ppb, B * C - pair0);
  // the farthest the plain version's bs_steps rounds reach past lo
  const int64_t reach = ((int64_t)1 << bs_steps) - 1;
  for (uint32_t i = threadIdx.x; i < n_pairs * TN; i += blockDim.x) {
    const uint32_t pair = pair0 + i / TN;
    const uint32_t o = (pair / (uint32_t)C) * TN + i % TN;  // (b*T + t)*NR + r
    // every load of the chain's first step at once, the range's length too
    const int64_t ln = rng_ln[o];
    const int32_t q = cand[pair];
    const int64_t s0 = rng_st[o];
    s_idf[i] = idf[o / (uint32_t)NR];  // b * T + t, read by the sums
    int sh = 0, bb = 0;
    if (flat != nullptr) {
      sh = min(max(b_shift[o], 0), 31);
      bb = b_base[o];
    }
    float ntf = 0.0f;  // an empty range or a miss adds +0.0
    if (ln > 0) {
      int64_t lo = 0, hi = ln;
      if (flat != nullptr) {
        const int64_t at_j = (int64_t)bb + (int64_t)((uint32_t)q >> sh);
        lo = flat[clamp64(at_j, 0, n_flat - 1)];
        hi = flat[clamp64(at_j + 1, 0, n_flat - 1)];
      }
      hi = min(hi, lo + reach);
      // q's place if the bucket's docs were spread evenly over its span
      const int64_t est = flat == nullptr ? -1 : lo + ((int64_t)(
          (uint32_t)q & ((1u << sh) - 1u)) * (hi - lo) >> sh);
      int eq;
      const int64_t pos = window_search<kVec>(p_doc, n, s0, lo, hi, q, est, eq);
      const int64_t at = clamp64(s0 + pos, 0, n - 1);
      // an entry the last chunk did not hold (past the window's end, or
      // pinned by the probe rounds) is read here, as the plain version does
      if (pos < ln && (eq >= 0 ? eq == 1 : __ldg(p_doc + at) == q)) {
        ntf = ntf_of(rng_w[o], rng_fb[o], rng_av[o], p_tf[at], p_flen[at]);
      }
    }
    s_ntf[i] = ntf;
  }
  __syncthreads();
  for (int64_t j = threadIdx.x; j < n_pairs; j += blockDim.x) {
    const int64_t pair = pair0 + j;
    const float* v = s_ntf + j * TN;
    const float* v_idf = s_idf + j * TN;
    float score = 0.0f, nm = 0.0f;
    for (int64_t t = 0; t < T; ++t) {
      float acc = 0.0f;
      for (int64_t r = 0; r < NR; ++r) acc = __fadd_rn(acc, v[t * NR + r]);
      if (acc > 0.0f) {
        const float sat = __fdiv_rn(
            __fmul_rn(__fmul_rn(v_idf[t * NR], kK1p1), acc),
            __fadd_rn(kK1, acc));
        score = __fadd_rn(score, sat);
        nm += 1.0f;
      }
    }
    scores[pair] = score;
    matched[pair] = nm;
  }
}

// ---------------------------------------------------------------------------
// rescore_worklist
// ---------------------------------------------------------------------------

// The first slot in [0, C) of the sorted table s with s[slot] >= v, or C;
// every lane of the warp passes the same v and gets the same answer. Each
// round probes 32 evenly spaced slots and keeps the step after the last
// one below v: two rounds at C = 1024.
__device__ __forceinline__ int warp_lower_bound(const int32_t* s, int C,
                                                int32_t v, int lane) {
  int lo = 0, hi = C;  // the answer lies in [lo, hi]
  while (hi > lo) {
    const int step = (hi - lo + 31) >> 5;
    const int idx = lo + (lane + 1) * step - 1;
    const unsigned below = __ballot_sync(0xffffffffu, idx < hi && s[idx] < v);
    const int k = __popc(below);
    const int nlo = lo + k * step;
    hi = min(hi, lo + (k + 1) * step - 1);
    lo = nlo;
  }
  return lo;
}

// Copies one lane's postings of a tile into its slots of a pipeline
// stage: vector k (postings q0 + 128 k ..) into s_d[32 k], s_t[32 k].
// kVec (p_doc and tf_src 16-byte aligned): cp.async of 16 bytes under the
// evict-first policy `stream_pol`, those past the slab's end or the
// entry's zero-filled; else element by element (slots outside
// [lo_p, hi_p) read tf 0).
template <bool kVec>
__device__ __forceinline__ void fetch_tile(
    const int32_t* __restrict__ p_doc, const float* __restrict__ p_tf,
    int64_t n, int64_t lo_p, int64_t hi_p, int64_t q0, int4* s_d,
    float4* s_t, unsigned long long stream_pol) {
#pragma unroll
  for (int k = 0; k < kVecsPerLane; ++k) {
    const int64_t q = q0 + 128 * k;
    if (kVec) {
      const int bytes = q >= hi_p ? 0 : (int)(4 * clamp64(n - q, 0, 4));
      const unsigned dd = (unsigned)__cvta_generic_to_shared(s_d + 32 * k);
      const unsigned dt = (unsigned)__cvta_generic_to_shared(s_t + 32 * k);
      asm volatile(
          "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;"
          :: "r"(dd), "l"(bytes ? p_doc + q : p_doc), "r"(bytes),
             "l"(stream_pol) : "memory");
      asm volatile(
          "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;"
          :: "r"(dt), "l"(bytes ? p_tf + q : p_tf), "r"(bytes),
             "l"(stream_pol) : "memory");
    } else {
      int dv[4];
      float tv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int64_t p = q + u;
        const bool in = p >= lo_p && p < hi_p;
        dv[u] = in ? __ldcs(p_doc + p) : 0;
        tv[u] = in ? __ldcs(p_tf + p) : 0.0f;
      }
      s_d[32 * k] = make_int4(dv[0], dv[1], dv[2], dv[3]);
      s_t[32 * k] = make_float4(tv[0], tv[1], tv[2], tv[3]);
    }
  }
}

// The grid is (entry, block of the entry): block g walks the entry's
// tiles g, g + gridDim.y, ... through a ring of kStages tiles in shared
// memory that cp.async fills kStages - 1 tiles ahead. Each lane reads
// back only the vectors it copied, so a stage needs no barrier. Dynamic
// shared memory: the ring (kStages * kTileVecs int4 docs, then as many
// float4 tf), then the C candidates. acc f32[B*T, C] and df int32[B*T]
// are zeroed and added into.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) rescore_worklist_kernel(
    const int32_t* __restrict__ p_doc, const float* __restrict__ p_tf,
    const float* __restrict__ p_flen, int64_t n,
    const int32_t* __restrict__ wl_i, const float* __restrict__ wl_f,
    int64_t W, const int32_t* __restrict__ cand, int64_t C, int64_t T,
    int64_t lch, const int32_t* __restrict__ wl_prev, int64_t nre,
    int bs_steps, const float* __restrict__ fmask,
    const uint32_t* __restrict__ fbits, int64_t n_mask,
    float* __restrict__ acc, int32_t* __restrict__ df) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* s_doc = reinterpret_cast<int4*>(smem);
  float4* s_tf = reinterpret_cast<float4*>(s_doc + kStages * kTileVecs);
  int32_t* s_cand = reinterpret_cast<int32_t*>(s_tf + kStages * kTileVecs);
  __shared__ int s_warp_df[kWarps];
  const int64_t e = blockIdx.x;
  const int64_t ln = wl_i[3 * W + e];
  if (ln <= 0) return;  // padding entry: the whole block leaves
  // JAX's dynamic_slice clamps the start: slot j is posting s_eff + j
  const int64_t s_eff = clamp64(wl_i[2 * W + e], 0, n - lch > 0 ? n - lch : 0);
  const int64_t head = s_eff & 3;
  const int64_t n_tiles = (((head + ln + 3) >> 2) + kTileVecs - 1) / kTileVecs;
  const int64_t tile0 = blockIdx.y, G = gridDim.y;
  if (tile0 >= n_tiles) return;  // past the entry's end
  const int64_t b = wl_i[e], t = wl_i[W + e];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the query's candidates into shared memory, in the first copy group
  const int32_t* row = cand + b * C;
  if ((C & 3) == 0 && ((uintptr_t)cand & 15) == 0) {
    for (int64_t c = 4 * threadIdx.x; c < C; c += 4 * kThreads) {
      const unsigned dst = (unsigned)__cvta_generic_to_shared(s_cand + c);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                   :: "r"(dst), "l"(row + c) : "memory");
    }
  } else {
    for (int64_t c = threadIdx.x; c < C; c += kThreads) {
      const unsigned dst = (unsigned)__cvta_generic_to_shared(s_cand + c);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                   :: "r"(dst), "l"(row + c) : "memory");
    }
  }

  // postings [lo_p, hi_p) of the entry inside the slab; in a tile, warp w
  // takes 128 * kVecsPerLane consecutive postings: lane l's vectors are
  // the tile's lane_v = 32 kVecsPerLane w + l, lane_v + 32, ..., at
  // postings base + 4 tile * kTileVecs and 128 further each
  const int64_t lo_p = s_eff, hi_p = min(s_eff + ln, n);
  const int n_in = (int)(hi_p - lo_p);
  const int mask_last = (int)min(n_mask - 1, (int64_t)INT_MAX);
  const int lane_v = 32 * kVecsPerLane * warp + lane;
  const int64_t base = s_eff - head + 4 * lane_v;
  const unsigned long long stream_pol = evict_first_policy();
  // group s holds tile tile0 + s * G (empty groups past the last tile)
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    const int64_t ts = tile0 + s * G;
    if (ts < n_tiles) {
      fetch_tile<kVec>(p_doc, p_tf, n, lo_p, hi_p, base + 4 * ts * kTileVecs,
                       s_doc + s * kTileVecs + lane_v,
                       s_tf + s * kTileVecs + lane_v, stream_pol);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  const float w = wl_f[e], fb = wl_f[W + e], av = wl_f[2 * W + e];
  float* acc_row = acc + (b * T + t) * C;
  const bool filtered = fbits != nullptr || fmask != nullptr;
  const unsigned long long pol = evict_last_policy();
  int my_df = 0;
  int k = 0;
  for (int64_t tile = tile0; tile < n_tiles; tile += G, ++k) {
    const int64_t ahead = tile + (kStages - 1) * G;
    if (ahead < n_tiles) {
      const int s = (k + kStages - 1) % kStages;
      fetch_tile<kVec>(p_doc, p_tf, n, lo_p, hi_p,
                       base + 4 * ahead * kTileVecs,
                       s_doc + s * kTileVecs + lane_v,
                       s_tf + s * kTileVecs + lane_v, stream_pol);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    // every group up to this tile's has landed
    asm volatile("cp.async.wait_group %0;" :: "n"(kStages - 1) : "memory");
    if (k == 0) __syncthreads();  // the candidate table, copied by all
    const int s = k % kStages;
    const int64_t q0 = base + 4 * tile * kTileVecs;
    // slot of the lane's first posting in the entry (32-bit: < lch + 4)
    const int j0 = (int)(q0 - lo_p);
    int32_t d[kPerLane];
    float tf[kPerLane];
#pragma unroll
    for (int v = 0; v < kVecsPerLane; ++v) {
      const int4 dv = s_doc[s * kTileVecs + lane_v + 32 * v];
      const float4 tv = s_tf[s * kTileVecs + lane_v + 32 * v];
      d[4 * v] = dv.x; d[4 * v + 1] = dv.y; d[4 * v + 2] = dv.z; d[4 * v + 3] = dv.w;
      tf[4 * v] = tv.x; tf[4 * v + 1] = tv.y; tf[4 * v + 2] = tv.z; tf[4 * v + 3] = tv.w;
    }
    bool keep[kPerLane];
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int j = j0 + 128 * (u >> 2) + (u & 3);
      keep[u] = j >= 0 && j < n_in && tf[u] > 0.0f;
    }
    if (filtered) {
      uint32_t m[kPerLane];
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        const int dc = min(max(d[u], 0), mask_last);
        m[u] = !keep[u] ? 0u
               : fbits != nullptr ? ld_keep(fbits + (dc >> 5), pol)
                                  : ld_keep(fmask + dc, pol);
      }
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        const int dc = min(max(d[u], 0), mask_last);
        keep[u] = keep[u] && (fbits != nullptr
                                  ? ((m[u] >> (dc & 31)) & 1u) != 0u
                                  : __uint_as_float(m[u]) > 0.0f);
      }
    }
    int32_t mn = INT_MAX, mx = INT_MIN;
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      if (!keep[u]) continue;
      ++my_df;
      mn = min(mn, d[u]);
      mx = max(mx, d[u]);
    }
    if (nre > 0) {  // union df: the doc already counted in an earlier span
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        if (!keep[u]) continue;
        bool seen = false;
        for (int64_t r = 0; r < nre && !seen; ++r) {
          const int64_t st_e = wl_prev[e * nre + r];
          const int64_t ln_e = wl_prev[(W + e) * nre + r];
          if (ln_e <= 0) continue;
          int64_t pos = 0;
          for (int64_t step = int64_t(1) << (bs_steps - 1); step >= 1;
               step >>= 1) {
            const int64_t cp = pos + step;
            if (cp <= ln_e && p_doc[clamp64(st_e + cp - 1, 0, n - 1)] < d[u]) {
              pos = cp;
            }
          }
          const int64_t at = clamp64(st_e + pos, 0, n - 1);
          seen = pos < ln_e && p_doc[at] == d[u] && p_tf[at] > 0.0f;
        }
        if (seen) --my_df;
      }
    }
    // the warp's candidate span: the slots holding a doc in [mn, mx]
    mn = __reduce_min_sync(0xffffffffu, mn);
    mx = __reduce_max_sync(0xffffffffu, mx);
    if (mn <= mx) {
      const int clo = warp_lower_bound(s_cand, (int)C, mn, lane);
      const int chi = mx == INT_MAX
                          ? (int)C : warp_lower_bound(s_cand, (int)C, mx + 1, lane);
#pragma unroll
      for (int u = 0; u < kPerLane; ++u) {
        // lower bound of d[u] in [clo, chi), the same steps on every lane
        int first = clo;
        int cnt = chi - clo;
        while (cnt > 1) {
          const int half = cnt >> 1;
          first = s_cand[first + half] < d[u] ? first + half : first;
          cnt -= half;
        }
        if (cnt == 1 && s_cand[first] < d[u]) ++first;
        if (keep[u] && first < chi && s_cand[first] == d[u]) {
          const int64_t p = q0 + 128 * (u >> 2) + (u & 3);
          atomicAdd(acc_row + first, ntf_of(w, fb, av, tf[u], p_flen[p]));
        }
      }
    }
  }
  // block sum of the df counts, one atomic per block
  my_df = __reduce_add_sync(0xffffffffu, my_df);
  if (lane == 0) s_warp_df[warp] = my_df;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int r = 0; r < kWarps; ++r) total += s_warp_df[r];
    if (total != 0) atomicAdd(df + b * T + t, total);
  }
}

// The saturation tail, one thread per (query, slot): a repeated candidate
// reads its first slot's sums (where the pass added them), df -> idf.
__global__ void __launch_bounds__(kThreads) worklist_tail_kernel(
    const float* __restrict__ acc, const int32_t* __restrict__ df,
    const int32_t* __restrict__ cand, const float* __restrict__ n_docs,
    int64_t B, int64_t T, int64_t C, float* __restrict__ scores,
    float* __restrict__ matched) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int64_t b = i / C, c = i - b * C;
  const int32_t* row = cand + b * C;
  const int32_t v = row[c];
  int64_t first = c;
  if (c > 0 && row[c - 1] == v) {
    int64_t lo = 0, hi = c;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (row[mid] < v) lo = mid + 1; else hi = mid;
    }
    first = lo;
  }
  const float nd = n_docs[b];
  float score = 0.0f, nm = 0.0f;
  for (int64_t t = 0; t < T; ++t) {
    const float a = acc[(b * T + t) * C + first];
    if (a > 0.0f) {
      const float d = fmaxf((float)df[b * T + t], 1.0f);
      const float idf = log1pf(__fdiv_rn(__fadd_rn(__fsub_rn(nd, d), 0.5f),
                                         __fadd_rn(d, 0.5f)));
      const float sat = __fdiv_rn(__fmul_rn(__fmul_rn(idf, kK1p1), a),
                                  __fadd_rn(kK1, a));
      score = __fadd_rn(score, sat);
      nm += 1.0f;
    }
  }
  scores[i] = score;
  matched[i] = nm;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Opens dynamic shared memory above 48 KB for `kernel` when asked.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// Each launcher enqueues on `stream` and returns cudaGetLastError() (0 on
// success); a refused launch never runs, so the caller must check it.

// scores and matched are f32[B, C]; flat / b_base / b_shift are null for a
// search without bucket tables. A block takes `ppb` pairs (the wrapper's
// `bsearch_pairs_per_block`): ppb * T * NR searches of at most kThreads,
// or one pair.
extern "C" int rescore_bsearch_launch(
    const void* p_doc, const void* p_tf, const void* p_flen, int64_t n,
    const void* rng_st, const void* rng_ln, const void* rng_w,
    const void* rng_fb, const void* rng_av, const void* idf, const void* cand,
    int64_t B, int64_t T, int64_t NR, int64_t C, int64_t bs_steps,
    const void* flat, int64_t n_flat, const void* b_base, const void* b_shift,
    int64_t ppb, void* scores, void* matched, void* stream) {
  const int64_t pairs = B * C;
  if (pairs <= 0) return 0;
  const int64_t TN = T * NR;
  if (bs_steps < 1 || bs_steps > 31 || n <= 0 || T <= 0 || NR <= 0 ||
      ppb < 1 || (ppb > 1 && ppb * TN > kThreads)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)(2 * ppb * TN) * sizeof(float);
  const int64_t blocks = (pairs + ppb - 1) / ppb;
  if (pairs > 2147483647 || B * TN > 2147483647 || smem > 227 * 1024) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const bool vec = aligned16(p_doc);
  cudaError_t err = vec ? allow_smem(rescore_bsearch_kernel<true>, smem)
                        : allow_smem(rescore_bsearch_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  auto kernel = vec ? rescore_bsearch_kernel<true> : rescore_bsearch_kernel<false>;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)p_doc, (const float*)p_tf, (const float*)p_flen, n,
      (const int32_t*)rng_st, (const int32_t*)rng_ln, (const float*)rng_w,
      (const float*)rng_fb, (const float*)rng_av, (const float*)idf,
      (const int32_t*)cand, B, T, NR, C, (int)bs_steps,
      (const int32_t*)flat, n_flat, (const int32_t*)b_base,
      (const int32_t*)b_shift, ppb, (float*)scores, (float*)matched);
  return (int)cudaGetLastError();
}

// `work` is B*T*C f32 sums followed by B*T int32 df counts; scores and
// matched f32[B, C]. wl_prev (int32[2, W, nre]) is null when nre == 0;
// fmask (f32[n_mask]) and fbits (its bitmap, int32[ceil(n_mask / 32)],
// bit d % 32 of word d / 32) are null for an unfiltered search, and fbits
// is read in place of fmask when given. The grid is W x `blocks` (the
// wrapper's `worklist_blocks`: an entry's tiles of kTileVecs vectors are
// shared out among that many blocks; any number from 1 is correct).
// `parts` selects the stages, for timing them apart: 1 zeroes `work`, 2
// runs the pass, 4 the tail.
extern "C" int rescore_worklist_launch(
    const void* p_doc, const void* p_tf, const void* p_flen, int64_t n,
    const void* wl_i, const void* wl_f, int64_t W, const void* n_docs,
    const void* cand, int64_t B, int64_t C, int64_t T, int64_t lch,
    const void* wl_prev, int64_t nre, int64_t bs_steps,
    const void* fmask, const void* fbits, int64_t n_mask, int64_t blocks,
    void* work, void* scores, void* matched, int64_t parts, void* stream) {
  if (B <= 0 || C <= 0 || T <= 0) return 0;
  if (n <= 0 || lch <= 0 || (nre > 0 && (bs_steps < 1 || bs_steps > 31)) ||
      ((fmask != nullptr || fbits != nullptr) && n_mask <= 0) ||
      C >= INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  float* acc = (float*)work;
  int32_t* df = (int32_t*)(acc + B * T * C);
  if (parts & 1) {
    const cudaError_t err = cudaMemsetAsync(
        work, 0, (size_t)(B * T * C + B * T) * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
  }
  if ((parts & 2) && W > 0) {
    if (W > 2147483647 || blocks < 1 || blocks > 65535) {
      return (int)cudaErrorInvalidConfiguration;
    }
    const size_t smem = (size_t)kStages * kTileVecs * 32 + (size_t)C * 4;
    const bool vec = aligned16(p_doc) && aligned16(p_tf);
    cudaError_t err = vec ? allow_smem(rescore_worklist_kernel<true>, smem)
                          : allow_smem(rescore_worklist_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    auto kernel = vec ? rescore_worklist_kernel<true>
                      : rescore_worklist_kernel<false>;
    kernel<<<dim3((unsigned)W, (unsigned)blocks), kThreads, smem, s>>>(
        (const int32_t*)p_doc, (const float*)p_tf, (const float*)p_flen, n,
        (const int32_t*)wl_i, (const float*)wl_f, W, (const int32_t*)cand, C,
        T, lch, (const int32_t*)wl_prev, nre, (int)bs_steps,
        (const float*)fmask, (const uint32_t*)fbits, n_mask, acc, df);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (parts & 4) {
    const int64_t blocks = (B * C + kThreads - 1) / kThreads;
    if (blocks > 2147483647) return (int)cudaErrorInvalidConfiguration;
    worklist_tail_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        acc, df, (const int32_t*)cand, (const float*)n_docs, B, T, C,
        (float*)scores, (float*)matched);
  }
  return (int)cudaGetLastError();
}
