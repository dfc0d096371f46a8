// The 3xTF32 tensor-core arithmetic and the cp.async copies that the
// encoder attention's kernels share (encoder_attention.cu, the forward;
// encoder_attention_backward.cu, its gradient), for sm_90a.
//
// An f32 operand x becomes hi = tf32(x) and lo = tf32(x - hi), rounded as
// cvt.rna.tf32.f32 rounds; a product runs as three mma.sync.m16n8k8 with
// tf32 operands and f32 accumulation, small terms first
// (D += a_lo b_hi; D += a_hi b_lo; D += a_hi b_hi), which keeps f32
// accuracy (the dropped a_lo b_lo is below 2^-22 of the product). A single
// tf32 pass keeps about three decimal digits and is never used.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; zero-filled when !valid (src must still
// be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every committed group but the newest one has landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// cvt.rna.tf32.f32 for finite x and +-inf: half a tf32 ulp added to the
// magnitude's bits (a carry rounds up into the exponent), the 13 low bits
// cut
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// x / d correctly rounded (the IEEE quotient, as __fdiv_rn gives it) from
// r = RN(1 / d): q = RN(x r) is within 1.5 ulp of x / d, one FMA
// correction makes it faithful, and a second one from a faithful q rounds
// correctly (Markstein's theorem). Holds for quotients of normal
// magnitude; __fdiv_rn spends a reciprocal, a range check and a branch
// on every call, where this spends three FMA and a product.
__device__ __forceinline__ float div_rn(float x, float d, float r) {
  float q = x * r;
  q = fmaf(fmaf(-q, d, x), r, q);
  return fmaf(fmaf(-q, d, x), r, q);
}

// x = hi + lo to 2^-22 of x, both tf32
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
}

// d += a b in 3xTF32, small terms first; b = (hi b0, hi b1, lo b0, lo b1)
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float4 b) {
  mma_tf32(d, al, b.x, b.y);
  mma_tf32(d, ah, b.z, b.w);
  mma_tf32(d, ah, b.x, b.y);
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

}  // namespace
