// Tensor-core helpers for sm_90a: mma.sync.m16n8k8 TF32 with hi/lo operand
// splits (3xTF32) and cp.async copies.
// With a = a_hi + a_lo and b = b_hi + b_lo, a*b ~ a_lo b_hi + a_hi b_lo +
// a_hi b_hi in fp32 (the dropped a_lo b_lo is ~2^-22 relative), so a product
// keeps fp32 accuracy.  The tensor cores add into their accumulator rounding
// toward zero: each k-step's three products go to a fresh accumulator (mma3)
// that is added to the running sum in fp32.  (Three fresh accumulators, one a
// product, were neither more accurate nor faster: frontend_kernel_probe.py.)
//
// Fragment layout of m16n8k8 (.row.col), g = lane / 4, q = lane % 4:
//   A (16 x 8, row-major):  a0 = A[g][q], a1 = A[g+8][q], a2 = A[g][q+4], a3 = A[g+8][q+4]
//   B (8 x 8, k x n):       b0 = B[q][g], b1 = B[q+4][g]
//   C (16 x 8):             c0 = C[g][2q], c1 = C[g][2q+1], c2 = C[g+8][2q], c3 = C[g+8][2q+1]

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// x rounded to TF32 (10 explicit mantissa bits, nearest, ties away from zero:
// cvt.rna.tf32.f32) with integer operations
__device__ __forceinline__ uint32_t tf32_hi(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi = tf32(x); lo = x - hi, exact in fp32 (the mma reads lo's top 10 mantissa bits)
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_hi(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A B for one k-step in 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi in
// a fresh accumulator
__device__ __forceinline__ void mma3(float (&acc)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(c, alo, bh0, bh1);
  mma_tf32(c, ahi, bl0, bl1);
  mma_tf32(c, ahi, bh0, bh1);
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] += c[j];
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
