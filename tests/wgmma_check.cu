// One warpgroup's product through the helpers of
// closed_loop_seeg_speech_synthesis_tpu_torch/csrc/wgmma.cuh, for
// tests/test_torch_cuda.py::test_wgmma_helpers_match_matmul (built there
// beside a copy of the header): D = A M or A M^T, A (64 x 256) and M
// (256 x 256) in bf16, fp32 accumulators over the 16 k-steps of one chain.
//   mode 0: A from registers, M's image read K-major:  D = A M
//   mode 1: A from registers, M's image read MN-major: D = A M^T
//   mode 2: A from its own image in shared memory:     D = A M
//   mode 3: mode 0, then its accumulators as the register A operand of
//           mode 1:                                    D = bf16(A M) M^T
// img_m is ops/wgmma_layout.sw128_image(M), img_a sw128_image(A^T).

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int M_BYTES = 256 * 256 * 2, A_BYTES = 256 * 64 * 2, COPY = 16384;
constexpr int SMEM = 1024 + M_BYTES + A_BYTES;

__global__ void __launch_bounds__(128) check_kernel(const float* A, const uint8_t* img_m,
                                                    const uint8_t* img_a, float* D, int mode) {
  extern __shared__ __align__(16) uint8_t raw[];
  __shared__ uint64_t bar;
  uint8_t* sm = raw + ((1024 - (wg::smem_addr(raw) & 1023)) & 1023);
  uint8_t* sa = sm + M_BYTES;
  const int t = threadIdx.x, warp = t >> 5, g = (t & 31) >> 2, q = t & 3;
  if (t == 0) {
    wg::mbar_init(&bar, 1);
    wg::mbar_arrive_expect_tx(&bar, M_BYTES + A_BYTES);
    for (int c = 0; c < M_BYTES; c += COPY) wg::bulk_copy(sm + c, img_m + c, COPY, &bar);
    for (int c = 0; c < A_BYTES; c += COPY) wg::bulk_copy(sa + c, img_a + c, COPY, &bar);
  }
  __syncthreads();
  wg::mbar_wait(&bar, 0);
  float d[128];
  uint32_t a[16][4];
#pragma unroll
  for (int s = 0; s < 16; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* row = A + (16 * warp + g + 8 * (r & 1)) * 256 + 16 * s + 8 * (r >> 1) + 2 * q;
      a[s][r] = wg::bf16x2(row[0], row[1]);
    }
  const uint64_t kdesc = wg::desc_sw128(sm, 16, 1024);
  const uint64_t mdesc = wg::desc_sw128(sm, 64 * 256 * 2, 1024);
  wg::fence();
  if (mode == 2) {
    const uint64_t adesc = wg::desc_sw128(sa, 16, 1024);
#pragma unroll
    for (int s = 0; s < 16; ++s)
      wg::mma_ss<0>(d, wg::desc_advance(adesc, (s >> 2) * A_BYTES / 4 + (s & 3) * 32),
                    wg::desc_advance(kdesc, (s >> 2) * M_BYTES / 4 + (s & 3) * 32), s > 0);
  } else if (mode == 1) {
#pragma unroll
    for (int s = 0; s < 16; ++s) wg::mma_rs<1>(d, a[s], wg::desc_advance(mdesc, s * 2048), s > 0);
  } else {
#pragma unroll
    for (int s = 0; s < 16; ++s)
      wg::mma_rs<0>(d, a[s], wg::desc_advance(kdesc, (s >> 2) * M_BYTES / 4 + (s & 3) * 32),
                    s > 0);
  }
  wg::commit();
  wg::wait<0>();
  wg::fence_regs(d);
  if (mode == 3) {
#pragma unroll
    for (int s = 0; s < 16; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[s][r] = wg::bf16x2(d[8 * s + 2 * r], d[8 * s + 2 * r + 1]);
    wg::fence();
#pragma unroll
    for (int s = 0; s < 16; ++s) wg::mma_rs<1>(d, a[s], wg::desc_advance(mdesc, s * 2048), s > 0);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(d);
  }
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(D + (16 * warp + g + 8 * h) * 256 + 8 * j + 2 * q) =
          make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
}

}  // namespace

extern "C" int wgmma_check(const float* A, const void* img_m, const void* img_a, float* D,
                           int mode, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM);
  if (err != cudaSuccess) return (int)err;
  check_kernel<<<1, 128, SMEM, stream>>>(A, static_cast<const uint8_t*>(img_m),
                                         static_cast<const uint8_t*>(img_a), D, mode);
  return (int)cudaGetLastError();
}
