// Hopper (sm_90a) building blocks: warpgroup matrix products (wgmma) in
// bf16 with fp32 accumulators, shared-memory matrix descriptors for the
// 128-byte swizzle, mbarriers, and bulk (TMA) copies of contiguous bytes.
// Each helper names the PTX ISA section it follows.  The host lays out the
// shared-memory images (ops/wgmma_layout.py), so no CUtensorMap is needed.
//
// Register fragments of wgmma .m64nNk16 (PTX ISA, "Register Fragments and
// Shared Memory Matrix Layouts"), warp w of the warpgroup owning rows
// [16w, 16w + 16), g = lane / 4, q = lane % 4:
//   D (64 x N, fp32): d[4j + 2h + e] = D[16w + g + 8h][8j + 2q + e]
//   A (64 x 16, bf16, 4 registers of two values, the lower k in the low half):
//     a[r] = {A[16w + g + 8(r & 1)][2q + 8(r >> 1)], the same at k + 1}
// so the accumulator of a product is the register A operand of the next:
// A's k-step s is a[r] = bf16x2(d[8s + 2r], d[8s + 2r + 1]).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace wg {

// {lo, hi} rounded to bf16 (nearest even, as JAX's astype(bfloat16)), lo in
// the low 16 bits: one register of an A fragment
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- matrix descriptor (PTX ISA, "Matrix Descriptor Format") --------------
// bits 0-13 start address >> 4, 16-29 leading-dimension byte offset >> 4,
// 32-45 stride-dimension byte offset >> 4, 49-51 base offset (0: the image's
// atoms start on 1,024-byte boundaries), 62-63 swizzle mode (1: 128 bytes).
// K-major (one 128-byte row per M or N index, 64 K values): LBO is unused
// (a k-step of 16 stays inside the row; set to 16 bytes), SBO = 1,024 bytes
// from one 8-row atom to the next; k-step s of a 64-wide K block starts 32 s
// bytes into the row.  MN-major (the same image read transposed, one row
// per K index, 64 M or N values contiguous): LBO = the bytes from one
// 64-wide M/N block to the next, SBO = 1,024 bytes from one group of 8 K rows
// to the next.  A k-step moves the start address; the hardware applies the
// swizzle to the address bits.
__device__ __forceinline__ uint64_t desc_sw128(const void* smem, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(smem) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// A descriptor moved by `bytes` (a multiple of 16) through the image
__device__ __forceinline__ uint64_t desc_advance(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

// ---- ordering (PTX ISA, "wgmma.fence", "wgmma.commit_group", "wgmma.wait_group") ----
// fence: register writes (accumulators, A fragments) before it are seen by
// the wgmma after it; commit: close a group of issued wgmma; wait<N>: at most
// N groups of this warpgroup still in flight
__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The accumulators as written by the asynchronous products: after wait(),
// keeps the compiler from reading them before the wait (no instruction)
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D8(i)                                                                          \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), \
      "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define WG_D128                                                                              \
  WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56),     \
      WG_D8(64), WG_D8(72), WG_D8(80), WG_D8(88), WG_D8(96), WG_D8(104), WG_D8(112), \
      WG_D8(120)
#define WG_D128_STR                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "   \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "   \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "   \
  "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "   \
  "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "   \
  "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "       \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "     \
  "%124, %125, %126, %127}"

// ---- products (PTX ISA, "wgmma.mma_async"), dense, m64n256k16, bf16 x bf16 -> fp32 ----
// d = A B + (accumulate ? d : 0), issued asynchronously by the warpgroup.
// B from shared memory through desc_b, K-major (TRANS_B = 0) or MN-major
// (TRANS_B = 1).  A from registers (one k-step of the fragment above) ...
template <int TRANS_B>
__device__ __forceinline__ void mma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t desc_b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WG_D128_STR
      ", {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : WG_D128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(TRANS_B));
}

// ... or A from shared memory through desc_a (K-major)
template <int TRANS_B>
__device__ __forceinline__ void mma_ss(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WG_D128_STR
      ", %128, %129, p, 1, 1, 0, %131;\n}\n"
      : WG_D128
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

#undef WG_D8
#undef WG_D128
#undef WG_D128_STR

// ---- mbarrier (PTX ISA, "mbarrier.init", "mbarrier.expect_tx" / "mbarrier.arrive",
// "mbarrier.test_wait/try_wait") ----
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  // the initialised barrier visible to the asynchronous proxy (the bulk copies)
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of bulk-copy transactions this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// spin until the phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// ---- bulk copies (PTX ISA, "cp.async.bulk", "cp.async.bulk.prefetch") ----
// `bytes` (a multiple of 16) from global to shared memory, both 16-byte
// aligned, by the TMA unit; completion counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// `bytes` (a multiple of 16) of global memory from a 16-byte aligned address into L2
__device__ __forceinline__ void bulk_prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}

}  // namespace wg
