// Griffin-Lim block inits: JAX's threefry2x32 uniform draws, bit for bit.
//
// Row r of the output is jax.random.uniform(jax.random.fold_in(key,
// max(ids[r], 0)), (n,), dtype), the draw of the JAX package's
// ops/griffinlim.py:158 (default_rand_init) and runtime/pipeline.py:541
// (the online step).  It replaces no Pallas kernel: it is the XLA code of
// jax._src.prng (_threefry_fold_in, _threefry_random_bits_partitionable,
// threefry_2x32) and jax.random.uniform, written as one launch.  The plain
// version is ops/cuda_prng.block_inits_plain (ops/prng.py).
//
// Bound: integer operations.  One threefry2x32 is 20 rounds of add, rotate
// and xor on two 32-bit words plus 5 key injections; a sample needs one, a
// row one more for its key.  The rotates and xors issue only on the 64
// INT32 lanes per SM (the adds also on the FMA pipe); the write, 4 (8) bytes
// a sample, takes about half that time at the card's memory rate
// (chip_smoke.py computes both).  Design: a thread draws 8 consecutive
// samples of one row, so the row's key (fold_in) is computed once for 8
// draws, and writes them with 16-byte stores; a grid-stride loop covers any
// number of rows.  Rotations are funnel shifts (one SHF each).  Nothing is read from the host and
// nothing is allocated, so a captured CUDA graph records it as one node.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int PER_THREAD = 8;  // samples a thread draws; the row length is a multiple
constexpr int THREADS = 256;
constexpr int MAX_CTAS = 132 * 32;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// jax._src.prng.threefry_2x32: Threefry-2x32, 20 rounds
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define ROUND(r) x0 += x1; x1 = rotl(x1, r) ^ x0;
  x0 += k0; x1 += k1;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)  x0 += k1; x1 += k2 + 1u;
  ROUND(17) ROUND(29) ROUND(16) ROUND(24) x0 += k2; x1 += k0 + 2u;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)  x0 += k0; x1 += k1 + 3u;
  ROUND(17) ROUND(29) ROUND(16) ROUND(24) x0 += k1; x1 += k2 + 4u;
  ROUND(13) ROUND(15) ROUND(26) ROUND(6)  x0 += k2; x1 += k0 + 5u;
#undef ROUND
  return make_uint2(x0, x1);
}

// jax.random.uniform's mantissa fill of 32 (float) or 64 (double) random bits
__device__ __forceinline__ float to_uniform(uint2 w, float) {
  return __uint_as_float(((w.x ^ w.y) >> 9) | 0x3F800000u) - 1.0f;
}
__device__ __forceinline__ double to_uniform(uint2 w, double) {
  const unsigned long long bits = ((static_cast<unsigned long long>(w.x) << 32) | w.y) >> 12;
  return __longlong_as_double(static_cast<long long>(bits | 0x3FF0000000000000ull)) - 1.0;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(double* p, const double* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i) reinterpret_cast<double2*>(p)[i] = make_double2(v[2 * i], v[2 * i + 1]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
block_inits_kernel(const long long* __restrict__ ids, long long rows, int n, uint32_t k0, uint32_t k1,
                   T* __restrict__ out) {
  const int groups = n / PER_THREAD;
  const long long total = rows * groups;
  for (long long t = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x; t < total;
       t += static_cast<long long>(gridDim.x) * THREADS) {
    const long long r = t / groups;
    const int j0 = static_cast<int>(t - r * groups) * PER_THREAD;
    const long long id = ids[r];
    // fold_in(key, max(id, 0)): the id as uint32, as jnp.uint32 converts it
    const uint2 key = threefry2x32(k0, k1, 0u, static_cast<uint32_t>(id < 0 ? 0 : id));
    T v[PER_THREAD];
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i)
      v[i] = to_uniform(threefry2x32(key.x, key.y, 0u, static_cast<uint32_t>(j0 + i)), T());
    store8(out + r * n + j0, v);
  }
}

}  // namespace

// ids (rows,) int64 on the device, out (rows, n) float32 (f64 = 0) or
// float64 (f64 = 1), contiguous and 16-byte aligned, n a multiple of 8.
extern "C" int block_inits(const long long* ids, void* out, long long rows, int n, uint32_t k0,
                           uint32_t k1, int f64, cudaStream_t stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  const long long total = rows * (n / PER_THREAD);
  const int ctas = static_cast<int>(total / THREADS + 1 < MAX_CTAS ? total / THREADS + 1 : MAX_CTAS);
  if (f64)
    block_inits_kernel<double><<<ctas, THREADS, 0, stream>>>(ids, rows, n, k0, k1,
                                                              static_cast<double*>(out));
  else
    block_inits_kernel<float><<<ctas, THREADS, 0, stream>>>(ids, rows, n, k0, k1,
                                                             static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
