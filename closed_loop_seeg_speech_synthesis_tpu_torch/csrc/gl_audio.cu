// Vocoder, two entry points, sm_90a.
//   gl_audio: logMel frames (B+1, n_mel) + block inits (B, 480) -> int16
//     audio (B*160,): Griffin-Lim (one of the two kernels below), then
//     ola_kernel and lowpass_kernel.
//     Replaces closed_loop_seeg_speech_synthesis_tpu/ops/pallas_gl.py:153
//     _gl_audio_kernel (entry gl_audio_pallas).
//   gl_blocks: the same inputs -> Griffin-Lim blocks (B, 480) before the
//     overlap-add, with either phase estimator; the Griffin-Lim launch alone.
//     The split vocoder (180,000 blocks at 30 minutes) and the online step
//     (1-4 blocks a packet) call it.
//     Replaces closed_loop_seeg_speech_synthesis_tpu/ops/pallas_gl.py:141
//     _gl_kernel (entry gl_blocks_pallas).
//   Both take bf16 = 1 for the kernels' bf16=True branch (DecoderConfig.gl_bf16;
//   pallas_gl._gl_loop with mm_t = bfloat16), below.  Tensor-core helpers:
//   tf32_mma.cuh (mma.sync, 3xTF32) and wgmma.cuh (wgmma, mbarrier, bulk copies).
//
// Work.  Each iteration of each 480-sample block windows its two frames
// (samples [0, 256) and [160, 416)), takes their forward 256-point real DFT
// as a (2, 256) x (256, 256) product with make_rdft's [cos | sin] matrix
// without the Nyquist bin (pallas_gl._split_nyquist), the Nyquist bin as a
// +-1 dot product, the phase step per bin (exp(angle) with DC/Nyquist forced
// to 0 or pi, phase_bug=1; or the unit phasor), the inverse as a (2, K) x
// (K, 256) product (K = 128 under exp(angle), whose imaginary part is 0,
// else 256) plus the Nyquist row, windows it and overlaps the two frames
// into the block; the target magnitude is exp(logmel) @ Minv with
// non-finite values scrubbed to 0.  The DFT operands are make_rdft's f32
// bytes: a 256-entry cos table indexed by n*k mod 256 differs from them in
// ~900 elements per matrix (the f64 angle 2*pi*n*k/256 is rounded before
// the cos), and the exp(angle) iteration is chaotic, so another operand is
// another result.
//
// What bounds it on an H100, and the two regimes (the caller picks one by B:
// ops/cuda_gl.regime):
//   * Large B (replay: 180,000 blocks, 283 G FMA at 8 iterations under
//     exp(angle), against 2 x 0.35 GB of inits and blocks): arithmetic,
//     8.5 ms at the fp32 FMA peak (67 TFLOP/s), 3.4 ms at the 3xTF32 rate of
//     the tensor cores (495/3 TFLOP/s).  gl_mma_kernel runs both products on
//     the tensor cores with mma.sync.m16n8k8 TF32 in 3xTF32: with a = a_hi +
//     a_lo and b = b_hi + b_lo, a*b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi in
//     fp32 accumulators (the dropped a_lo b_lo is ~2^-22 relative), so the
//     products keep fp32 accuracy; single-pass TF32 is not used.  A CTA holds
//     32 blocks (64 frames, the M of both products) in shared memory for all
//     iterations.  Each of its 8 warps owns 16 bins of the forward product
//     (their cos and sin columns, so the phase step runs on the accumulators
//     in registers) and 32 output samples of the inverse.  The operands'
//     hi/lo split is built once on the host (ops/cuda_gl.py) in mma fragment
//     order; each warp streams its own k-slabs through a 4-stage cp.async
//     ring in shared memory (a product's first slabs are issued before the
//     barrier that precedes it), so every operand element leaves L2 once per
//     64 frames (the fp32 kernel this replaces read it once per 16).  Frames
//     are split in registers.  The tensor cores add into their accumulator
//     rounding toward zero; summed over all k-steps in one accumulator, that
//     puts the blocks 3-4x further from float64 than an fp32 product's
//     (gl_kernel_probe.py).  So each k-step's three products go to a fresh
//     accumulator that is added to the running sum in fp32.  The phase step, the Nyquist
//     bin and the overlap-add stay fp32 on the CUDA cores.
//   * Small B (the online step: 1-4 blocks, 8 frames, ~0.8 M FMA an
//     iteration): latency.  One CTA on one SM walks 8 iterations of dependent
//     L2 reads of 512 KB of operands.  gl_cluster_kernel spreads a group of
//     4 blocks over a thread-block cluster of 8 CTAs on 8 SMs: CTA r loads its
//     slices of the f32 operands into shared memory once per launch (the cos
//     and sin columns of bins [16r, 16r+16), 32 KB; the inverse rows times
//     output samples [32r, 32r+32), <= 32 KB) and computes them in fp32 FMA.
//     Each iteration the phase-corrected bins and the output samples are
//     exchanged through distributed shared memory, with a cluster barrier
//     after each product; no operand is read from L2 after the first.
//   * bf16 (DecoderConfig.gl_bf16, the JAX kernels' bf16=True branch): the
//     128 clean-bin DFT products take bf16 operands (round to nearest even,
//     as JAX's astype(bfloat16)) and accumulate in fp32: the windowed frames
//     before the forward product, zr (and zi with the converging estimator)
//     before the inverse, and the four DFT matrices, which the host rounds
//     once.  Unrounded: exp(logmel) @ Minv, the Nyquist bin (from the
//     unrounded frames) and its inverse row, the phase step and everything
//     after.  A product of two bf16 values is exact in fp32.  Above
//     CLUSTER_MAX_B_BF16 blocks (ops/cuda_gl.regime) gl_wgmma_kernel; at or
//     below it gl_cluster_kernel<true>, its fp32 FMA on the rounded operands.
//     Bound at the replay (180,000 blocks, 8 iterations, exp(angle)): the
//     products, 5.7e11 FLOP at the bf16 tensor-core rate (989 TFLOP/s),
//     0.57 ms, plus the fp32 target magnitudes and Nyquist bins, 0.67 ms; the
//     0.69 GB of inits and blocks take 0.21 ms.  gl_wgmma_kernel keeps every
//     operand on chip.  One persistent CTA an SM, two warpgroups each walking
//     its own tiles of 32 blocks (64 frames, the M of wgmma m64n256k16),
//     holds the bf16 forward operand [cos | sin] as one 128 KB image in
//     shared memory (128-byte swizzle, ops/wgmma_layout.py), loaded once by
//     bulk copies (TMA) counted on an mbarrier.  The inverse reads the same
//     image through MN-major descriptors: make_rdft's I_cos[k] = w_k cos /
//     256 and I_sin[k] = -w_k sin / 256 (w_0 = 1, else 2) are the forward
//     columns transposed times powers of two, exact in f32 and bf16, so Z is
//     scaled by them before its rounding and the inverse's own 128 KB, which
//     would not fit beside the forward's, is never needed.  Frames, Z and
//     output samples stay in registers.  The forward's accumulators hold a
//     bin's cos and sin columns in one thread, so the phase step runs on
//     them; Z, scaled and rounded, is the inverse's register A operand (the
//     m64 accumulator fragment is the m64k16 A fragment); the inverse's
//     accumulators hold both frames of the thread's block (rows g, g + 8) at
//     samples n and n +- 160 (columns j, j +- 20), so the overlap-add is
//     thread-local and its result, rounded, is the next forward's A operand.
//     Each product sums its 16 k-steps (8 under exp(angle), whose zi is 0)
//     in one fp32 accumulator: the operands' bf16 rounding (2^-9) dwarfs the
//     tensor cores' truncating adder (tests/test_torch_cuda.py::
//     test_gl_bf16_kernel_tracks_float64; gl_kernel_probe.py's "grouped"
//     variant, a fresh accumulator every 4 k-steps, is slower).  A tile's
//     target magnitudes (33 log-mel rows: a block's second frame is the
//     next one's first) are computed once in fp32 into shared memory; the
//     next tile's inits and rows are prefetched into L2
//     (cp.async.bulk.prefetch; a staging buffer for them would not fit).
//     What bounds it now is the fp32 phase step on the CUDA cores, not the
//     products (gl_kernel_probe.py's clock64 stamps): under exp(angle) it
//     takes the JAX kernels' own atan2 (Cephes) with fast reciprocals, which
//     cut the phase step from 77% of an iteration's cycles (libdevice's
//     atan2f) to 60% (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).  Resources (nvcc -Xptxas -v, sm_90a): 255
//     registers a thread, 88 / 228 bytes of spill stores (exp(angle) /
//     converging; ptxas serializes the converging instantiation's wgmma for
//     want of registers); 171,080 bytes of dynamic shared memory a CTA (the
//     image 131,072, 2 x 33 x 136 target-magnitude floats, the window and
//     the Nyquist column and row, the barrier, up to 1,024 of alignment).
// The tail of gl_audio:
//   ola: chunk b = (G[b][0:160] + G[b-1][160:320] + G[b-2][320:480]) times
//     the window-sum reciprocal (rows 0 and 1 have partial sums), and the
//     low-pass input term q_b = Pmat chunk_b.
//   lowpass: the state before row b is the 16-term truncated power sum
//     sum_p (A^160)^p q_{b-1-p} (spectral radius 0.988^160 ~ 0.145, so the
//     truncation is ~4e-14), which makes every row independent; then
//     y = Cpow s_b + Tmat chunk_b, clip, scale, truncate to int16.
// Every C entry point returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int FFT = 256;
constexpr int HOP = 160;
constexpr int BLK = 480;
constexpr int NBIN = FFT / 2;  // 128 bins besides Nyquist
constexpr int MAX_S = 32;
constexpr float PI_F = 3.14159265358979323846f;

// Phase step of one bin: exp(angle(x)) without the 1j (GriffinLim.py:93),
// the DC bin being exactly real (angle 0 or pi), or the unit phasor.
__device__ __forceinline__ void phase_step(float xr, float xi, float sp, bool dc, int phase_bug,
                                           float& zr, float& zi) {
  if (phase_bug) {
    const float ang = dc ? (xr < 0.f ? PI_F : 0.f) : atan2f(xi, xr);
    zr = sp * expf(ang);
    zi = 0.f;
  } else {
    const float r = sqrtf(xr * xr + xi * xi);
    const bool safe = r > 0.f;
    const float inv = safe ? 1.f / r : 0.f;
    zr = sp * (safe ? xr * inv : 1.f);
    zi = sp * (xi * inv);
  }
}

// atan2(y, x) as the JAX kernels compute it (pallas_gl._atan2 / _atan_01:
// Cephes' atanf polynomial on [0, 1] after the reduction at tan(pi/8), ~1e-7
// relative), its two divisions as fast reciprocals
__device__ __forceinline__ float atan2_cephes(float y, float x) {
  const float ay = fabsf(y), ax = fabsf(x), mx = fmaxf(ax, ay), mn = fminf(ax, ay);
  const float r = __fdividef(mn, mx > 0.f ? mx : 1.f);
  const bool reduce = r > 0.4142135623730951f;  // tan(pi/8)
  const float v = reduce ? __fdividef(r - 1.f, r + 1.f) : r, z = v * v;
  float p = 8.05374449538e-2f;
  p = fmaf(p, z, -1.38776856032e-1f);
  p = fmaf(p, z, 1.99777106478e-1f);
  p = fmaf(p, z, -3.33329491539e-1f);
  float a = fmaf(v * z, p, v);
  if (reduce) a += 0.7853981633974483f;
  if (ay > ax) a = 1.5707963267948966f - a;
  if (x < 0.f) a = PI_F - a;
  if (mx == 0.f) a = 0.f;
  return y < 0.f ? -a : a;
}

// phase_step with the exp(angle) estimator's atan2 in fewer instructions
// (atan2_cephes; gl_kernel_probe.py times the "atan2f" variant, libdevice's,
// beside it); the unit phasor as phase_step
template <bool BUG>
__device__ __forceinline__ void phase_step_fast(float xr, float xi, float sp, bool dc, float& zr,
                                                float& zi) {
  if (BUG) {
    zr = sp * expf(dc ? (xr < 0.f ? PI_F : 0.f) : atan2_cephes(xi, xr));
    zi = 0.f;
  } else {
    phase_step(xr, xi, sp, dc, 0, zr, zi);
  }
}

// The Nyquist bin is exactly real: angle 0 or pi.
__device__ __forceinline__ float nyquist_phase(float x, float sp, int phase_bug) {
  return phase_bug ? sp * expf(x < 0.f ? PI_F : 0.f) : sp * (x < 0.f ? -1.f : 1.f);
}

// ---- large B: 3xTF32 tensor-core products -----------------------------------

constexpr int MB = 32;             // audio blocks per CTA
constexpr int MF = 2 * MB;         // frames per CTA: the M of both products
constexpr int MWARPS = 8;
constexpr int MTHREADS = 32 * MWARPS;
constexpr int AS = FFT + 4;        // frame-buffer row stride: A fragment loads hit 32 banks
constexpr int SS = NBIN + 4;       // target-magnitude row stride (129 used)
constexpr int NT = 4;              // n-tiles of 8 columns per warp
constexpr int MTL = MF / 16;       // m-tiles of 16 frames
constexpr int STAGES = 4;          // cp.async ring depth per warp
constexpr int KSTEPS = FFT / 8;    // k-steps of 8 (m16n8k8)
static_assert(MTHREADS == FFT, "one thread per window sample");

// The operand of a product is (KSTEPS, NT, 32 lanes) float4s, exactly each
// lane's B fragments, so a lane copies and reads only its own ring slots (no
// warp barrier): slot nt holds (hi[k][n], hi[k+4][n], lo[k][n], lo[k+4][n])
// with k = 8 ks + lane%4 and n the tile's column lane/4.  mma_prefetch issues
// a product's first STAGES-1 k-slabs; it runs ahead of the barrier before the
// product, once the previous product has read the ring.
__device__ __forceinline__ void mma_prefetch(const float4* __restrict__ bpk, float4* ring,
                                             int lane) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
      cp_async16(ring + (s * NT + j) * 32 + lane, bpk + (s * NT + j) * 32 + lane);
    cp_async_commit();
  }
}

// acc[mt][nt] = a[16 mt .. 16 mt + 16, 0 .. 8 ksteps) x this warp's packed
// operand, n-tile nt, after mma_prefetch(bpk, ring, lane).
__device__ __forceinline__ void mma_product(const float* __restrict__ a,
                                            const float4* __restrict__ bpk, float4* ring,
                                            int ksteps, float (&acc)[MTL][NT][4], int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MTL; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;
  for (int ks = 0; ks < ksteps; ++ks) {
    cp_async_wait<STAGES - 2>();  // k-step ks has landed
    const int nx = ks + STAGES - 1;  // refill the slot that k-step ks-1 used
    if (nx < ksteps)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        cp_async16(ring + ((nx % STAGES) * NT + j) * 32 + lane, bpk + (nx * NT + j) * 32 + lane);
    cp_async_commit();
    float4 b[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) b[j] = ring[((ks % STAGES) * NT + j) * 32 + lane];
    const float* ak = a + g * AS + 8 * ks + q;
#pragma unroll
    for (int mt = 0; mt < MTL; ++mt) {
      const float* r = ak + 16 * mt * AS;
      const float v[4] = {r[0], r[8 * AS], r[4], r[8 * AS + 4]};
      uint32_t hi[4], lo[4];  // the mma reads lo's top 10 mantissa bits
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hi[i] = tf32_hi(v[i]);
        lo[i] = __float_as_uint(v[i] - __uint_as_float(hi[i]));
      }
      // the tensor cores add into their accumulator rounding toward zero:
      // each k-step sums into a fresh one, added to acc rounding to nearest
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t bh0 = __float_as_uint(b[nt].x), bh1 = __float_as_uint(b[nt].y);
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(c, lo, bh0, bh1);
        mma_tf32(c, hi, __float_as_uint(b[nt].z), __float_as_uint(b[nt].w));
        mma_tf32(c, hi, bh0, bh1);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] += c[j];
      }
    }
  }
}

constexpr size_t MMA_SMEM = (size_t)(4 * MWARPS * STAGES * NT * 32 + MF * AS + MF * SS + 3 * FFT +
                                     2 * MF) * sizeof(float);

// The DFT products in 3xTF32 (fpk / ipk the operands' hi/lo fragments); the
// target magnitudes, the Nyquist bin, the phase step and the overlap-add fp32.
__global__ void __launch_bounds__(MTHREADS, 1) gl_mma_kernel(
    const float* __restrict__ lm, const float* __restrict__ rnd, const float* __restrict__ minv,
    const float4* __restrict__ fpk, const float4* __restrict__ ipk,
    const float* __restrict__ fnyq, const float* __restrict__ inyq,
    const float* __restrict__ win, float* __restrict__ G, int B, int NM, int iterations,
    int phase_bug) {
  extern __shared__ __align__(16) float smem[];
  float4* ring = reinterpret_cast<float4*>(smem);  // (MWARPS, STAGES, NT, 32)
  float* a = smem + 4 * MWARPS * STAGES * NT * 32; // (MF, AS): frames, Z, Y
  float* spec = a + MF * AS;                       // (MF, SS) target magnitudes
  float* w = spec + MF * SS;                       // (FFT) window
  float* wn = w + FFT;                             // (FFT) forward Nyquist column
  float* wi = wn + FFT;                            // (FFT) inverse Nyquist row
  float* xn = wi + FFT;                            // (MF) Nyquist bin
  float* zn = xn + MF;                             // (MF) Nyquist bin, phase-corrected
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int b0 = blockIdx.x * MB;
  if (iterations == 0) {
    for (int i = t; i < MB * BLK; i += MTHREADS) {
      const int b = b0 + i / BLK;
      if (b < B) G[(size_t)b * BLK + i % BLK] = rnd[(size_t)b * BLK + i % BLK];
    }
    return;
  }
  // the frames as 16-byte copies, all in flight while the target magnitudes
  // are computed (exp(logmel) staged in the ring, free until the first product)
  for (int i = t; i < MF * (FFT / 4); i += MTHREADS) {
    const int f = i / (FFT / 4), c = 4 * (i % (FFT / 4)), b = b0 + (f >> 1);
    if (b < B)
      cp_async16(a + f * AS + c, rnd + (size_t)b * BLK + (f & 1) * HOP + c);
    else
      *reinterpret_cast<float4*>(a + f * AS + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_commit();
  w[t] = win[t];
  wn[t] = fnyq[t];
  wi[t] = inyq[t];
  float* ex = reinterpret_cast<float*>(ring);  // (NM, MF), NM <= 256
  for (int i = t; i < MF * NM; i += MTHREADS) {
    const int f = i % MF, m = i / MF, b = b0 + (f >> 1);  // frame f: block f/2, mel row block + f%2
    ex[i] = b < B ? expf(lm[(size_t)(b + (f & 1)) * NM + m]) : 0.f;
  }
  __syncthreads();
  {  // thread (half, k): bin k of 32 frames, one Minv load per 32 FMAs;
     // threads t < MF also the Nyquist bin of frame t
    const int k = t & (NBIN - 1), f0 = (t >> 7) * (MF / 2);
    float sk[MF / 2], sn = 0.f;
#pragma unroll
    for (int j = 0; j < MF / 2; ++j) sk[j] = 0.f;
    for (int m = 0; m < NM; ++m) {
      const float mv = __ldg(minv + m * (NBIN + 1) + k);
      const float4* e4 = reinterpret_cast<const float4*>(ex + m * MF + f0);
#pragma unroll
      for (int j = 0; j < MF / 8; ++j) {
        const float4 v = e4[j];
        sk[4 * j] = fmaf(v.x, mv, sk[4 * j]);
        sk[4 * j + 1] = fmaf(v.y, mv, sk[4 * j + 1]);
        sk[4 * j + 2] = fmaf(v.z, mv, sk[4 * j + 2]);
        sk[4 * j + 3] = fmaf(v.w, mv, sk[4 * j + 3]);
      }
      if (t < MF) sn = fmaf(ex[m * MF + t], __ldg(minv + m * (NBIN + 1) + NBIN), sn);
    }
#pragma unroll
    for (int j = 0; j < MF / 2; ++j) spec[(f0 + j) * SS + k] = isfinite(sk[j]) ? sk[j] : 0.f;
    if (t < MF) spec[t * SS + NBIN] = isfinite(sn) ? sn : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = t; i < MF * FFT; i += MTHREADS) a[(i / FFT) * AS + i % FFT] *= w[i % FFT];
  __syncthreads();
  float acc[MTL][NT][4];
  float4* wring = ring + warp * STAGES * NT * 32;
  const float4* wfpk = fpk + (size_t)warp * KSTEPS * NT * 32;
  const float4* wipk = ipk + (size_t)warp * KSTEPS * NT * 32;
  mma_prefetch(wfpk, wring, lane);
  for (int it = 0; it < iterations; ++it) {
    // forward: bins [16 warp, 16 warp + 16), cos columns in n-tiles 0-1, sin in 2-3
    mma_product(a, wfpk, wring, KSTEPS, acc, lane);
    mma_prefetch(wipk, wring, lane);
    {  // Nyquist bin: 4 lanes per frame
      const int f = t >> 2, part = t & 3;
      float s = 0.f;
      for (int n = part; n < FFT; n += 4) s = fmaf(a[f * AS + n], wn[n], s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (part == 0) xn[f] = s;
    }
    __syncthreads();
    // phase step on the accumulators; Z = [zr | zi] replaces the frames
#pragma unroll
    for (int mt = 0; mt < MTL; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int f = 16 * mt + g + 8 * (j >> 1);
          const int k = 16 * warp + 8 * h + 2 * q + (j & 1);
          float zr, zi;
          phase_step(acc[mt][h][j], -acc[mt][h + 2][j], spec[f * SS + k], k == 0, phase_bug, zr,
                     zi);
          a[f * AS + k] = zr;
          if (!phase_bug) a[f * AS + NBIN + k] = zi;
        }
    if (t < MF) zn[t] = nyquist_phase(xn[t], spec[t * SS + NBIN], phase_bug);
    __syncthreads();
    // inverse: output samples [32 warp, 32 warp + 32); the sin rows vanish under phase_bug
    mma_product(a, wipk, wring, phase_bug ? KSTEPS / 2 : KSTEPS, acc, lane);
    if (it + 1 < iterations) mma_prefetch(wfpk, wring, lane);
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < MTL; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int f = 16 * mt + g + 8 * (j >> 1);
          const int n = 32 * warp + 8 * nt + 2 * q + (j & 1);
          a[f * AS + n] = (acc[mt][nt][j] + zn[f] * wi[n]) * w[n];
        }
    __syncthreads();
    // overlap-add within each block (warp-local): the next windowed frames,
    // or after the last iteration the block itself (samples [416, 480) are 0)
    for (int bl = warp; bl < MB; bl += MWARPS) {
      float* y0 = a + 2 * bl * AS;
      float* y1 = y0 + AS;
      if (it + 1 < iterations) {
        float n0[FFT / 32], n1[FFT / 32];
#pragma unroll
        for (int i = 0; i < FFT / 32; ++i) {
          const int n = lane + 32 * i;
          n0[i] = (y0[n] + (n >= HOP ? y1[n - HOP] : 0.f)) * w[n];
          n1[i] = ((n < FFT - HOP ? y0[n + HOP] : 0.f) + y1[n]) * w[n];
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < FFT / 32; ++i) {
          y0[lane + 32 * i] = n0[i];
          y1[lane + 32 * i] = n1[i];
        }
      } else if (b0 + bl < B) {
        for (int s = lane; s < BLK; s += 32) {
          float v = 0.f;
          if (s < FFT) v += y0[s];
          if (s >= HOP && s < HOP + FFT) v += y1[s - HOP];
          G[(size_t)(b0 + bl) * BLK + s] = v;
        }
      }
    }
    __syncthreads();
  }
}

// ---- small B: one thread-block cluster per 4 blocks ------------------------

constexpr int CL = 8;                  // CTAs per cluster (the portable maximum)
constexpr int CB = 4;                  // audio blocks per cluster
constexpr int CF = 2 * CB;             // frames per cluster
constexpr int CBIN = NBIN / CL;        // forward bins per CTA
constexpr int CCOL = FFT / CL;         // inverse output samples per CTA
constexpr int CTHREADS = CF * 2 * CBIN;
constexpr int CSS = CBIN + 1;          // own bins + the Nyquist bin
static_assert(CTHREADS == FFT && CF * CCOL == CTHREADS && CF * 32 == CTHREADS,
              "one thread per (frame, own column); one warp per frame");

constexpr size_t cluster_smem(int NM) {
  return (size_t)(FFT * 2 * CBIN + FFT * CCOL + 2 * CF * FFT + CB * BLK + 2 * CF * 2 * CBIN +
                  CF * CCOL + 2 * FFT + 2 * CF + CF * CSS + CF * NM) * sizeof(float);
}

// BF16: the same fp32 FMA products on bf16-rounded operands (fm, im rounded
// on the host; frames and Z rounded as they are staged); the Nyquist bin
// from the unrounded frames.
template <bool BF16>
__global__ void __launch_bounds__(CTHREADS) gl_cluster_kernel(
    const float* __restrict__ lm, const float* __restrict__ rnd, const float* __restrict__ minv,
    const float* __restrict__ fm, const float* __restrict__ im, const float* __restrict__ fnyq,
    const float* __restrict__ inyq, const float* __restrict__ win, float* __restrict__ G, int B,
    int NM, int iterations, int phase_bug) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  float* fs = smem;                  // (FFT, 2 CBIN) cos | sin columns of own bins
  float* is = fs + FFT * 2 * CBIN;   // (FFT, CCOL) inverse rows x own output samples
  float* frm = is + FFT * CCOL;      // (CF, FFT) windowed frames
  float* zf = frm + CF * FFT;        // (CF, FFT) the cluster's phase-corrected bins [zr | zi]
  float* wav = zf + CF * FFT;        // (CB, BLK) blocks
  float* xl = wav + CB * BLK;        // (CF, 2 CBIN) forward product, own columns
  float* zl = xl + CF * 2 * CBIN;    // (CF, 2 CBIN) own phase-corrected bins (read by the cluster)
  float* yl = zl + CF * 2 * CBIN;    // (CF, CCOL) own output samples (read by the cluster)
  float* w = yl + CF * CCOL;         // (FFT) window
  float* wn = w + FFT;               // (FFT) forward Nyquist column
  float* xn = wn + FFT;              // (CF) Nyquist bin
  float* zn = xn + CF;               // (CF) Nyquist bin, phase-corrected
  float* spec = zn + CF;             // (CF, CSS) target magnitudes of own bins + Nyquist
  float* ex = spec + CF * CSS;       // (CF, NM) exp(logmel)
  const int r = (int)cluster.block_rank();
  const int t = threadIdx.x;
  const int b0 = (blockIdx.x / CL) * CB;
  const int kin = phase_bug ? NBIN : FFT;
  for (int i = t; i < CB * BLK; i += CTHREADS) {
    const int b = b0 + i / BLK;
    wav[i] = b < B ? rnd[(size_t)b * BLK + i % BLK] : 0.f;
  }
  if (iterations > 0) {  // operand slices: 16-byte copies, all in flight at once
    for (int i = t; i < FFT * 2 * CBIN / 4; i += CTHREADS) {
      const int n = i / (CBIN / 2), j = 4 * (i % (CBIN / 2));
      cp_async16(fs + 4 * i, fm + n * FFT + (j < CBIN ? 0 : NBIN) + CBIN * r + j % CBIN);
    }
    for (int i = t; i < kin * CCOL / 4; i += CTHREADS)
      cp_async16(is + 4 * i, im + (i / (CCOL / 4)) * FFT + CCOL * r + 4 * (i % (CCOL / 4)));
    cp_async_commit();
    w[t] = win[t];
    wn[t] = fnyq[t];
    for (int i = t; i < CF * NM; i += CTHREADS) {
      const int f = i / NM, b = b0 + (f >> 1);
      ex[i] = b < B ? expf(lm[(size_t)(b + (f & 1)) * NM + i % NM]) : 0.f;
    }
    __syncthreads();
    for (int i = t; i < CF * CSS; i += CTHREADS) {
      const int f = i / CSS, j = i % CSS, k = j < CBIN ? CBIN * r + j : NBIN;
      float s = 0.f;
      for (int m = 0; m < NM; ++m) s = fmaf(ex[f * NM + m], __ldg(minv + m * (NBIN + 1) + k), s);
      spec[i] = isfinite(s) ? s : 0.f;
    }
    cp_async_wait<0>();
  }
  const int f = t >> 5, lane = t & 31;  // warp f owns frame f
  for (int it = 0; it < iterations; ++it) {
    __syncthreads();
    for (int i = t; i < CF * FFT; i += CTHREADS) {
      const int ff = i / FFT, n = i % FFT;
      const float v = wav[(ff >> 1) * BLK + (ff & 1) * HOP + n] * w[n];
      frm[i] = BF16 ? bf16_round(v) : v;
    }
    __syncthreads();
    {  // forward: thread (f, lane) = own column lane of frame f
      const float4* x4 = reinterpret_cast<const float4*>(frm + f * FFT);
      float s = 0.f;
      for (int n4 = 0; n4 < FFT / 4; ++n4) {
        const float4 v = x4[n4];
        const float* col = fs + 4 * n4 * 2 * CBIN + lane;
        s = fmaf(v.x, col[0], s);
        s = fmaf(v.y, col[2 * CBIN], s);
        s = fmaf(v.z, col[4 * CBIN], s);
        s = fmaf(v.w, col[6 * CBIN], s);
      }
      xl[f * 2 * CBIN + lane] = s;
      float sn = 0.f;  // Nyquist bin of frame f
      for (int n = lane; n < FFT; n += 32)
        sn = fmaf(BF16 ? wav[(f >> 1) * BLK + (f & 1) * HOP + n] * w[n] : frm[f * FFT + n], wn[n],
                  sn);
      for (int off = 16; off > 0; off >>= 1) sn += __shfl_xor_sync(0xffffffffu, sn, off);
      if (lane == 0) xn[f] = sn;
    }
    __syncthreads();
    if (t < CF * CBIN) {
      const int ff = t / CBIN, kl = t % CBIN;
      float zr, zi;
      phase_step(xl[ff * 2 * CBIN + kl], -xl[ff * 2 * CBIN + CBIN + kl], spec[ff * CSS + kl],
                 CBIN * r + kl == 0, phase_bug, zr, zi);
      zl[ff * 2 * CBIN + kl] = zr;
      zl[ff * 2 * CBIN + CBIN + kl] = zi;
    }
    if (t < CF) zn[t] = nyquist_phase(xn[t], spec[t * CSS + CBIN], phase_bug);
    cluster.sync();  // every CTA's zl is written
    for (int i = t; i < CF * kin; i += CTHREADS) {
      const int ff = i / kin, kk = i % kin, k = kk % NBIN;
      const float* src = cluster.map_shared_rank(zl, k / CBIN);
      const float z = src[ff * 2 * CBIN + (kk / NBIN) * CBIN + k % CBIN];
      zf[ff * FFT + kk] = BF16 ? bf16_round(z) : z;
    }
    __syncthreads();
    {  // inverse: thread (f, lane) = own output sample lane of frame f
      const float4* z4 = reinterpret_cast<const float4*>(zf + f * FFT);
      float s = 0.f;
      for (int k4 = 0; k4 < kin / 4; ++k4) {
        const float4 v = z4[k4];
        const float* col = is + 4 * k4 * CCOL + lane;
        s = fmaf(v.x, col[0], s);
        s = fmaf(v.y, col[CCOL], s);
        s = fmaf(v.z, col[2 * CCOL], s);
        s = fmaf(v.w, col[3 * CCOL], s);
      }
      const int n = CCOL * r + lane;
      yl[f * CCOL + lane] = (s + zn[f] * __ldg(inyq + n)) * w[n];
    }
    cluster.sync();  // every CTA's yl is written; every zl read
    for (int i = t; i < CB * BLK; i += CTHREADS) {  // overlap-add from the cluster's samples
      const int bl = i / BLK, s = i % BLK;
      float v = 0.f;
      if (s < FFT) v += cluster.map_shared_rank(yl, s / CCOL)[2 * bl * CCOL + s % CCOL];
      if (s >= HOP && s < HOP + FFT)
        v += cluster.map_shared_rank(yl, (s - HOP) / CCOL)[(2 * bl + 1) * CCOL + (s - HOP) % CCOL];
      wav[i] = v;
    }
    // the next writes of zl and yl follow the next cluster barrier, which
    // every CTA reaches only after these reads
  }
  cluster.sync();  // no CTA leaves while the cluster still reads its yl
  for (int i = t; i < CB * (BLK / CL); i += CTHREADS) {  // CTA r writes samples [60 r, 60 r + 60)
    const int bl = i / (BLK / CL), s = (BLK / CL) * r + i % (BLK / CL);
    if (b0 + bl < B) G[(size_t)(b0 + bl) * BLK + s] = wav[bl * BLK + s];
  }
}

// ---- large B, bf16: wgmma on operands resident in shared memory -------------

constexpr int WB = 32;               // audio blocks a warpgroup tile: 64 frames, the M of wgmma
constexpr int WROWS = WB + 1;        // log-mel rows a tile reads (frame 1 of block b is b + 1's frame 0)
constexpr int WGS = 2;               // warpgroups a CTA, each walking its own tiles
constexpr int WTHREADS = 128 * WGS;
constexpr int SPS = NBIN + 8;        // target-magnitude row stride: 129 used; float2 loads of 4 rows hit 32 banks
constexpr int MEL_CHUNK = 128;       // mel bins of exp(logmel) staged at a time
constexpr int IMAGE_BYTES = FFT * FFT * 2;  // the forward [cos | sin] operand in bf16
constexpr int KBLOCK_BYTES = 64 * FFT * 2;  // one 64-sample K block of every column of the image
constexpr int COPY_BYTES = 16384;    // one bulk copy of the image
constexpr int KSTEPS16 = FFT / 16;   // wgmma k-steps of a product over 256
constexpr size_t WGMMA_SMEM =
    1024 + IMAGE_BYTES + (size_t)(WGS * WROWS * SPS + 3 * FFT) * sizeof(float) + sizeof(uint64_t);
static_assert(MEL_CHUNK <= SPS, "exp(logmel) is staged in the target-magnitude rows");
static_assert(WGMMA_SMEM <= 232448, "one CTA an SM");

// barrier of one warpgroup (named barrier 1 + wgi, 128 threads)
__device__ __forceinline__ void wg_sync(int wgi) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
}

// A thread's frames, fp32 in the accumulator layout (f[4j + 2h + e]: frame h
// of its block, sample 8j + 2q + e), into the forward product's A operand
// (bf16) and their Nyquist bins xn (fp32, unrounded; summed over the quad)
__device__ __forceinline__ void pack_frames(const float (&f)[128], const float* wn, int q,
                                            uint32_t (&a)[KSTEPS16][4], float (&xn)[2]) {
  xn[0] = xn[1] = 0.f;
#pragma unroll
  for (int j = 0; j < FFT / 8; ++j) {
    const float2 c = *reinterpret_cast<const float2*>(wn + 8 * j + 2 * q);
#pragma unroll
    for (int h = 0; h < 2; ++h) xn[h] = fmaf(f[4 * j + 2 * h + 1], c.y, fmaf(f[4 * j + 2 * h], c.x, xn[h]));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    xn[h] += __shfl_xor_sync(0xffffffffu, xn[h], 1);
    xn[h] += __shfl_xor_sync(0xffffffffu, xn[h], 2);
  }
#pragma unroll
  for (int s = 0; s < KSTEPS16; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[s][r] = wg::bf16x2(f[8 * s + 2 * r], f[8 * s + 2 * r + 1]);
}

// d = A x B over the KS k-steps of A's register fragments, B the image
// through `desc`: K-major (TRANS_B = 0: the forward operand, k-step s in K
// block s / 4, 32 bytes a k-step into its rows) or MN-major (TRANS_B = 1:
// the operand transposed, k-step s at rows 16 s).  One fp32 accumulator over
// the whole K: the operands' bf16 rounding (2^-9) dwarfs the truncation of
// the tensor cores' adder (gl_kernel_probe.py's "grouped" variant adds a
// fresh accumulator every 4 k-steps in fp32 instead).
template <int TRANS_B, int KS>
__device__ __forceinline__ void product(float (&d)[128], const uint32_t (&a)[KS][4],
                                        uint64_t desc) {
  wg::fence();
#pragma unroll
  for (int s = 0; s < KS; ++s)
    wg::mma_rs<TRANS_B>(
        d, a[s],
        wg::desc_advance(desc, TRANS_B ? s * 16 * 128 : (s >> 2) * KBLOCK_BYTES + (s & 3) * 32),
        s > 0);
  wg::commit();
  wg::wait<0>();
  wg::fence_regs(d);
}

// [lo, hi) bytes of a global array of `total` bytes into L2, cut to 16-byte bounds
__device__ __forceinline__ void prefetch_bytes(const void* base, size_t lo, size_t hi,
                                               size_t total) {
  lo &= ~size_t(15);
  hi = (hi + 15 < total ? hi + 15 : total) & ~size_t(15);
  if (hi > lo) wg::bulk_prefetch_l2(static_cast<const uint8_t*>(base) + lo, (uint32_t)(hi - lo));
}

// BUG: the exp(angle) estimator (phase_bug), else the unit phasor.  image:
// the forward operand's shared-memory image (ops/wgmma_layout.py), bf16.
template <bool BUG>
__global__ void __launch_bounds__(WTHREADS, 1) gl_wgmma_kernel(
    const float* __restrict__ lm, const float* __restrict__ rnd, const float* __restrict__ minv,
    const uint8_t* __restrict__ image, const float* __restrict__ fnyq,
    const float* __restrict__ inyq, const float* __restrict__ win, float* __restrict__ G, int B,
    int NM, int iterations) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* img = smem_raw + ((1024 - (wg::smem_addr(smem_raw) & 1023)) & 1023);  // 1,024-aligned
  float* specs = reinterpret_cast<float*>(img + IMAGE_BYTES);  // (WGS, WROWS, SPS)
  float* w = specs + WGS * WROWS * SPS;  // (FFT) window
  float* wn = w + FFT;                   // (FFT) forward Nyquist column
  float* wi = wn + FFT;                  // (FFT) inverse Nyquist row
  uint64_t* bar = reinterpret_cast<uint64_t*>(wi + FFT);
  const int t = threadIdx.x, wgi = t >> 7, tw = t & 127, warp = tw >> 5;
  const int lane = t & 31, g = lane >> 2, q = lane & 3;
  if (iterations == 0) {
    for (size_t i = (size_t)blockIdx.x * WTHREADS + t; i < (size_t)B * BLK;
         i += (size_t)gridDim.x * WTHREADS)
      G[i] = rnd[i];
    return;
  }
  if (t == 0) {  // the image, once a CTA, by the TMA unit
    wg::mbar_init(bar, 1);
    wg::mbar_arrive_expect_tx(bar, IMAGE_BYTES);
    for (int c = 0; c < IMAGE_BYTES; c += COPY_BYTES)
      wg::bulk_copy(img + c, image + c, COPY_BYTES, bar);
  }
  for (int i = t; i < FFT; i += WTHREADS) {
    w[i] = win[i];
    wn[i] = fnyq[i];
    wi[i] = inyq[i];
  }
  __syncthreads();
  wg::mbar_wait(bar, 0);
  float* spec = specs + wgi * WROWS * SPS;  // this warpgroup's target magnitudes (WROWS, 129)
  const uint64_t fdesc = wg::desc_sw128(img, 16, 1024);            // forward: K-major
  const uint64_t idesc = wg::desc_sw128(img, KBLOCK_BYTES, 1024);  // inverse: transposed, MN-major
  const int bl = 8 * warp + g;  // the thread's block in a tile: its frames are rows g, g + 8 of its warp
  const int tiles = (B + WB - 1) / WB;
  const size_t lm_bytes = (size_t)(B + 1) * NM * sizeof(float);
  float d[128];                 // accumulators: X, then Y
  uint32_t a[KSTEPS16][4];      // the frames, bf16: the forward's A operand
  float xn[2];                  // their Nyquist bins
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  for (int tile = blockIdx.x * WGS + wgi; tile < tiles; tile += gridDim.x * WGS) {
    const int b0 = tile * WB, b = b0 + bl, next = tile + gridDim.x * WGS;
    if (tw == 0 && next < tiles) {  // the next tile's inits and log-mel rows into L2
      const size_t nb0 = (size_t)next * WB, nb1 = nb0 + WB < (size_t)B ? nb0 + WB : (size_t)B;
      prefetch_bytes(rnd, nb0 * BLK * 4, nb1 * BLK * 4, (size_t)B * BLK * 4);
      prefetch_bytes(lm, nb0 * NM * 4, (nb1 + 1) * NM * 4, lm_bytes);
    }
    float f[128];  // the inits, in flight while the target magnitudes are computed
#pragma unroll
    for (int j = 0; j < FFT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2 v = make_float2(0.f, 0.f);
        if (b < B)
          v = __ldg(reinterpret_cast<const float2*>(rnd + (size_t)b * BLK + HOP * h + 8 * j + 2 * q));
        f[4 * j + 2 * h] = v.x;
        f[4 * j + 2 * h + 1] = v.y;
      }
    // target magnitudes exp(logmel) @ Minv of the tile's WROWS rows, fp32:
    // thread tw owns bin tw of every row, threads < WROWS also row tw's
    // Nyquist bin; exp(logmel) staged in spec as (mel, row), MEL_CHUNK at a time
    wg_sync(wgi);  // the previous tile's phase steps are done with spec
    float sk[WROWS], sn = 0.f;
#pragma unroll
    for (int r = 0; r < WROWS; ++r) sk[r] = 0.f;
    for (int m0 = 0; m0 < NM; m0 += MEL_CHUNK) {
      const int mc = min(MEL_CHUNK, NM - m0);
      for (int i = tw; i < WROWS * mc; i += 128) {
        const int r = i / mc, m = i % mc;
        spec[m * WROWS + r] = b0 + r <= B ? expf(lm[(size_t)(b0 + r) * NM + m0 + m]) : 0.f;
      }
      wg_sync(wgi);
      for (int m = 0; m < mc; ++m) {
        const float* ex = spec + m * WROWS;
        const float mv = __ldg(minv + (m0 + m) * (NBIN + 1) + tw);
#pragma unroll
        for (int r = 0; r < WROWS; ++r) sk[r] = fmaf(ex[r], mv, sk[r]);
        if (tw < WROWS) sn = fmaf(ex[tw], __ldg(minv + (m0 + m) * (NBIN + 1) + NBIN), sn);
      }
      wg_sync(wgi);
    }
#pragma unroll
    for (int r = 0; r < WROWS; ++r) spec[r * SPS + tw] = isfinite(sk[r]) ? sk[r] : 0.f;
    if (tw < WROWS) spec[tw * SPS + NBIN] = isfinite(sn) ? sn : 0.f;
#pragma unroll
    for (int j = 0; j < FFT / 8; ++j) {  // the windowed frames
      const float2 c = *reinterpret_cast<const float2*>(w + 8 * j + 2 * q);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        f[4 * j + 2 * h] *= c.x;
        f[4 * j + 2 * h + 1] *= c.y;
      }
    }
    pack_frames(f, wn, q, a, xn);
    wg_sync(wgi);  // spec written
    for (int it = 0; it < iterations; ++it) {
      product<0>(d, a, fdesc);  // forward: X = frames x [cos | sin]
      // phase step on the accumulators: bin k = 8j + 2q + e of frame h has its
      // cos column in d[4j + 2h + e] and its sin column in d[4(j + 16) + 2h + e].
      // Z times the inverse's weights (1 at DC, else 2, over 256: powers of
      // two, exact) is the inverse's A operand in the same places, bf16
      float zn[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) zn[h] = nyquist_phase(xn[h], spec[(bl + h) * SPS + NBIN], BUG);
      uint32_t z[BUG ? KSTEPS16 / 2 : KSTEPS16][4];
#pragma unroll
      for (int s = 0; s < KSTEPS16 / 2; ++s)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 2 * s + (r >> 1), h = r & 1, k = 8 * j + 2 * q;
          const float2 sp = *reinterpret_cast<const float2*>(spec + (bl + h) * SPS + k);
          float zr0, zi0, zr1, zi1;
          phase_step_fast<BUG>(d[4 * j + 2 * h], -d[4 * (j + 16) + 2 * h], sp.x, k == 0, zr0,
                               zi0);
          phase_step_fast<BUG>(d[4 * j + 2 * h + 1], -d[4 * (j + 16) + 2 * h + 1], sp.y, false,
                               zr1, zi1);
          const float c0 = k == 0 ? 1.f / FFT : 2.f / FFT, c1 = 2.f / FFT;
          z[s][r] = wg::bf16x2(zr0 * c0, zr1 * c1);
          if constexpr (!BUG) z[KSTEPS16 / 2 + s][r] = wg::bf16x2(-zi0 * c0, -zi1 * c1);
        }
      // inverse: Y = Z x [I_cos; I_sin], the image read transposed (I_cos =
      // weights x F_cos^T, I_sin = -weights x F_sin^T); under the quirk zi = 0
      // and its k-steps are skipped
      product<1>(d, z, idesc);
#pragma unroll
      for (int j = 0; j < FFT / 8; ++j) {  // + the Nyquist row, times the window: frame h's samples
        const float2 c = *reinterpret_cast<const float2*>(w + 8 * j + 2 * q);
        const float2 r = *reinterpret_cast<const float2*>(wi + 8 * j + 2 * q);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          d[4 * j + 2 * h] = (d[4 * j + 2 * h] + zn[h] * r.x) * c.x;
          d[4 * j + 2 * h + 1] = (d[4 * j + 2 * h + 1] + zn[h] * r.y) * c.y;
        }
      }
      // overlap-add within the block (thread-local: sample n and n -+ 160
      // are columns j and j -+ 20): the next windowed frames, or after the
      // last iteration the block itself (samples [416, 480) are 0)
      if (it + 1 < iterations) {
#pragma unroll
        for (int j = 0; j < FFT / 8; ++j) {
          const float2 c = *reinterpret_cast<const float2*>(w + 8 * j + 2 * q);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float ce = e ? c.y : c.x;
            f[4 * j + e] = (d[4 * j + e] + (j >= 20 ? d[4 * (j - 20) + 2 + e] : 0.f)) * ce;
            f[4 * j + 2 + e] = ((j < 12 ? d[4 * (j + 20) + e] : 0.f) + d[4 * j + 2 + e]) * ce;
          }
        }
        pack_frames(f, wn, q, a, xn);
      } else if (b < B) {
#pragma unroll
        for (int j = 0; j < BLK / 8; ++j) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = (j < 32 ? d[4 * j + e] : 0.f) + (j >= 20 && j < 52 ? d[4 * (j - 20) + 2 + e] : 0.f);
          *reinterpret_cast<float2*>(G + (size_t)b * BLK + 8 * j + 2 * q) = make_float2(v[0], v[1]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(HOP) ola_kernel(
    const float* __restrict__ G, const float* __restrict__ winv, const float* __restrict__ pmatT,
    float* __restrict__ CH, float* __restrict__ Q, int S) {
  __shared__ float ch[HOP];
  const int b = blockIdx.x;
  const int n = threadIdx.x;
  float acc = G[(size_t)b * BLK + n];
  if (b >= 1) acc += G[(size_t)(b - 1) * BLK + HOP + n];
  if (b >= 2) acc += G[(size_t)(b - 2) * BLK + 2 * HOP + n];
  const float v = acc * winv[(b < 2 ? b : 2) * HOP + n];
  CH[(size_t)b * HOP + n] = v;
  ch[n] = v;
  __syncthreads();
  if (n < S) {
    float s = 0.f;
    for (int j = 0; j < HOP; ++j) s = fmaf(pmatT[j * S + n], ch[j], s);
    Q[(size_t)b * S + n] = s;
  }
}

__global__ void __launch_bounds__(HOP) lowpass_kernel(
    const float* __restrict__ CH, const float* __restrict__ Q, const float* __restrict__ apow,
    const float* __restrict__ cpow, const float* __restrict__ h, short* __restrict__ out,
    int S, int n_pow, float denom) {
  __shared__ float ch[HOP], hs[HOP], st[MAX_S];
  const int b = blockIdx.x;
  const int n = threadIdx.x;
  ch[n] = CH[(size_t)b * HOP + n];
  hs[n] = h[n];
  if (n < S) {
    float s = 0.f;
    for (int p = 0; p < n_pow && b - 1 - p >= 0; ++p) {
      const float* qr = Q + (size_t)(b - 1 - p) * S;
      const float* ar = apow + ((size_t)p * S + n) * S;
      for (int j = 0; j < S; ++j) s = fmaf(ar[j], qr[j], s);
    }
    st[n] = s;
  }
  __syncthreads();
  float y = 0.f;
  for (int s = 0; s < S; ++s) y = fmaf(cpow[n * S + s], st[s], y);
  for (int j = 0; j <= n; ++j) y = fmaf(hs[n - j], ch[j], y);
  const float v = fminf(fmaxf(y / denom, -0.99f), 0.99f) * 32767.f;
  out[(size_t)b * HOP + n] = (short)(int)v;  // C conversion truncates toward zero
}

// The cluster kernel on B blocks, 8 CTAs per 4 blocks; its bf16 variant when
// BF16 (fm, im the operands rounded to bf16).
template <bool BF16>
cudaError_t launch_cluster(const float* lm, const float* rnd, const float* minv, const float* fm,
                           const float* im, const float* fnyq, const float* inyq, const float* win,
                           float* G, int B, int NM, int iterations, int phase_bug,
                           cudaStream_t stream) {
  cudaError_t err;
  const size_t smem = cluster_smem(NM);
  if ((err = cudaFuncSetAttribute(gl_cluster_kernel<BF16>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * ((B + CB - 1) / CB));
  cfg.blockDim = dim3(CTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, gl_cluster_kernel<BF16>, lm, rnd, minv, fm, im, fnyq, inyq,
                                win, G, B, NM, iterations, phase_bug)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

// The bf16 wgmma kernel on B blocks: one persistent CTA an SM (fewer when
// there are fewer tiles), its warpgroups walking tiles of 32 blocks.
template <bool BUG>
cudaError_t launch_wgmma(const float* lm, const float* rnd, const float* minv,
                         const uint8_t* image, const float* fnyq, const float* inyq,
                         const float* win, float* G, int B, int NM, int iterations,
                         cudaStream_t stream) {
  cudaError_t err;
  int dev, sms;
  if ((err = cudaFuncSetAttribute(gl_wgmma_kernel<BUG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)WGMMA_SMEM)) != cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int pairs = ((B + WB - 1) / WB + WGS - 1) / WGS;
  gl_wgmma_kernel<BUG><<<sms < pairs ? sms : pairs, WTHREADS, WGMMA_SMEM, stream>>>(
      lm, rnd, minv, image, fnyq, inyq, win, G, B, NM, iterations);
  return cudaGetLastError();
}

// Griffin-Lim of B blocks into G: the cluster kernel when use_cluster, else
// the tensor-core kernel (float32: gl_mma_kernel, 32 blocks a CTA; bf16:
// gl_wgmma_kernel).
cudaError_t launch_gl_blocks(const float* lm, const float* rnd, const float* minv,
                             const float* fm, const float* im, const float* fpk, const float* ipk,
                             const float* fnyq, const float* inyq, const float* win, float* G,
                             int B, int NM, int iterations, int phase_bug, int use_cluster,
                             int bf16, cudaStream_t stream) {
  if (use_cluster)
    return bf16 ? launch_cluster<true>(lm, rnd, minv, fm, im, fnyq, inyq, win, G, B, NM,
                                       iterations, phase_bug, stream)
                : launch_cluster<false>(lm, rnd, minv, fm, im, fnyq, inyq, win, G, B, NM,
                                        iterations, phase_bug, stream);
  if (bf16) {
    const uint8_t* image = reinterpret_cast<const uint8_t*>(fpk);
    return phase_bug ? launch_wgmma<true>(lm, rnd, minv, image, fnyq, inyq, win, G, B, NM,
                                          iterations, stream)
                     : launch_wgmma<false>(lm, rnd, minv, image, fnyq, inyq, win, G, B, NM,
                                           iterations, stream);
  }
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(gl_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)MMA_SMEM)) != cudaSuccess)
    return err;
  gl_mma_kernel<<<(B + MB - 1) / MB, MTHREADS, MMA_SMEM, stream>>>(
      lm, rnd, minv, reinterpret_cast<const float4*>(fpk), reinterpret_cast<const float4*>(ipk),
      fnyq, inyq, win, G, B, NM, iterations, phase_bug);
  return cudaGetLastError();
}

}  // namespace

// bf16 = 0: fm / im the f32 DFT operands, fpk / ipk their 3xTF32 fragments;
// bf16 = 1: fm / im the operands rounded to bf16 (as f32, the cluster
// kernel's), fpk the forward operand's shared-memory image in bf16 (the
// wgmma kernel's), ipk unused (ops/cuda_gl.make_gl_audio_ops builds both sets).
extern "C" int gl_blocks(const float* lm, const float* rnd, const float* minv, const float* fm,
                         const float* im, const float* fnyq, const float* inyq, const float* win,
                         const float* fpk, const float* ipk, float* G, int B, int NM,
                         int iterations, int phase_bug, int use_cluster, int bf16,
                         cudaStream_t stream) {
  return (int)launch_gl_blocks(lm, rnd, minv, fm, im, fpk, ipk, fnyq, inyq, win, G, B, NM,
                               iterations, phase_bug, use_cluster, bf16, stream);
}

extern "C" int gl_audio(const float* lm, const float* rnd, const float* minv, const float* fm,
                        const float* im, const float* fnyq, const float* inyq, const float* win,
                        const float* fpk, const float* ipk, const float* winv,
                        const float* pmatT, const float* apow, const float* cpow, const float* h,
                        float* G, float* CH, float* Q, short* out, int B, int NM, int S,
                        int n_pow, int iterations, int phase_bug, int use_cluster, int bf16,
                        float denom, cudaStream_t stream) {
  cudaError_t err = launch_gl_blocks(lm, rnd, minv, fm, im, fpk, ipk, fnyq, inyq, win, G, B, NM,
                                     iterations, phase_bug, use_cluster, bf16, stream);
  if (err != cudaSuccess) return (int)err;
  ola_kernel<<<B, HOP, 0, stream>>>(G, winv, pmatT, CH, Q, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  lowpass_kernel<<<B, HOP, 0, stream>>>(CH, Q, apow, cpow, h, out, S, n_pow, denom);
  return (int)cudaGetLastError();
}
