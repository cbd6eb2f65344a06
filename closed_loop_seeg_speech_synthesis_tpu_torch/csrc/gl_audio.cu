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
//   pallas_gl._gl_loop with mm_t = bfloat16), below.  Helpers: tf32_mma.cuh
//   (cp.async) and wgmma.cuh (wgmma, mbarrier, bulk copies).
//
// Work.  Each iteration of each 480-sample block windows its two frames
// (samples [0, 256) and [160, 416)), takes their forward 256-point real DFT,
// the phase step per bin (exp(angle) with DC/Nyquist forced to 0 or pi,
// phase_bug=1; or the unit phasor), the inverse real DFT (under exp(angle)
// the spectrum's imaginary part is 0), windows it and overlaps the two
// frames into the block; the target magnitude is exp(logmel) @ Minv with
// non-finite values scrubbed to 0.  The cluster kernel takes the DFTs as
// products with make_rdft's f32 [cos | sin] matrices without the Nyquist
// bin (pallas_gl._split_nyquist), the Nyquist bin as a +-1 dot product and
// (K = 128 under exp(angle), else 256) inverse rows plus the Nyquist row;
// the large-B float32 kernel as FFTs.  The exp(angle) iteration is chaotic:
// another operand, or another order of summation, is another trajectory,
// held to float64 by the tests' and the benchmark's gates.
//
// What bounds it on an H100, and the kernels: float32 has two regimes (the
// caller picks one by B: ops/cuda_gl.regime), bf16 one kernel at every B:
//   * Large B (replay: 180,000 blocks, 8 iterations): arithmetic.  As dense
//     products the DFTs are 283 G FMA under exp(angle), 8.5 ms at the fp32
//     FMA peak (67 TFLOP/s), 3.4 ms at the 3xTF32 rate of the tensor cores;
//     as FFTs about a twentieth of that.  gl_fft_kernel gives each block one
//     warp, 8 blocks a CTA, and keeps it in registers and a 2 KB exchange
//     buffer of the warp's own for all iterations (tests/gl_fft_plan.py emulates
//     the plan step for step).  A block's result reads nothing but its own
//     two log-mel rows and init, so a launch over any B consecutive blocks
//     gives those rows of a launch over the whole session bit for bit.  The
//     block's two windowed frames are one 256-point complex FFT, z = f0 +
//     i f1: X0[k] = (Z[k] + conj Z[256-k])/2 and X1[k] = (Z[k] - conj
//     Z[256-k])/2i are both frames' bins 0..128, the
//     Nyquist bin included; the inverse takes W = Y0 + i Y1 of the corrected
//     spectra extended Hermitian (make_rdft's weights w_k / 256 are that
//     extension's), frame 0 its real part and frame 1 its imaginary part.
//     The FFT is 8 x 8 x 4 in decimation in frequency, 8 complex values a
//     lane: an 8-point DFT and twiddles in registers, an exchange through
//     the buffer, again, another exchange, a 4-point DFT; the inverse is the
//     same backwards (its adjoint).  The buffer's slots keep every exchange
//     free of bank conflicts, and the last state gives each lane a bin's
//     partner 256 - k with the bin, so unpacking, the phase step and packing
//     stay in the lane; the first state holds samples n = lane + 32 b, so
//     the in-block overlap-add (160 = 5 x 32) does too.  The twiddles are one
//     table of cos and sin of 2 pi j / 256 rounded once from float64 (as the
//     benchmark's reference computes its DFTs), not make_rdft's f32 matrix
//     bytes.  The float32 FFT's rounding grows like log N where a dense
//     product's grows like sqrt N, but at a bin near zero the two are alike,
//     and there the phase step divides by the bin: where it is
//     ill-conditioned (a bin small beside the block's norm, or under
//     exp(angle) at the branch cut) those rare bins are summed again
//     from the frames kept before their window in a second 2 KB buffer, in
//     twice the precision (exact_bin; tests/test_torch_cuda.py::
//     test_gl_kernel_tracks_float64 holds the kernel to float64).  No
//     barrier but __syncwarp runs inside the iterations: the phase step's
//     MUFU latency is hidden by the warps resident on an SM, not by barriers.
//     The phase step is libdevice's atan2f and expf, as the cluster kernel's;
//     the target magnitudes, exp(logmel) @ Minv in fp32, are computed once a
//     block.  Resources (nvcc -Xptxas -v, sm_90a): 126-128 registers, no
//     spills, 36,608 bytes of static shared memory a CTA: 2 CTAs (16 warps)
//     an SM.  The phase step takes ~74% of an iteration's cycles
//     (gl_kernel_probe.py's clock64 stamps; PERF.md).
//   * Small B (the online step: 1-4 blocks, 8 frames, ~0.8 M FMA an
//     iteration): latency.  One CTA on one SM walks 8 iterations of dependent
//     L2 reads of 512 KB of operands.  gl_cluster_kernel spreads a group of
//     4 blocks over a thread-block cluster of 8 CTAs on 8 SMs: CTA r loads its
//     slices of the f32 operands into shared memory once per launch (the cos
//     and sin columns of bins [16r, 16r+16), 32 KB; the inverse rows times
//     output samples [32r, 32r+32), <= 32 KB) and computes them in fp32 FMA.
//     Each iteration the phase-corrected bins and the output samples are
//     exchanged through distributed shared memory, with a cluster barrier
//     after each product; no operand is read from L2 after the first.  The
//     FFT kernel is the faster at every B from 1 to 8 (PERF.md); this one
//     stays for the online step because its products, in the plain
//     version's operands and order of summation, keep the plain version's
//     exp(angle) trajectories, which chip_smoke.py holds the online audio to.
//   * bf16 (DecoderConfig.gl_bf16, the JAX kernels' bf16=True branch): the
//     128 clean-bin DFT products take bf16 operands (round to nearest even,
//     as JAX's astype(bfloat16)) and accumulate in fp32: the windowed frames
//     before the forward product, zr (and zi with the converging estimator)
//     before the inverse, and the four DFT matrices, which the host rounds
//     once.  Unrounded: exp(logmel) @ Minv, the Nyquist bin (from the
//     unrounded frames) and its inverse row, the phase step and everything
//     after.  A product of two bf16 values is exact in fp32.  gl_wgmma_kernel
//     at every B.  Bound at the replay (180,000 blocks, 8 iterations,
//     exp(angle)): the products, 5.7e11 FLOP at the bf16 tensor-core rate
//     (989 TFLOP/s), 0.57 ms, plus the fp32 target magnitudes and Nyquist bins, 0.67 ms; the
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

// ---- large B: one warp a block, its DFTs as 256-point FFTs in fp32 ----------

constexpr int FWARPS = 8;                  // warps a CTA, one audio block each
constexpr int FTHREADS = 32 * FWARPS;
constexpr int XSLOTS = 36 * 7 + 31 + 1;    // float2 slots of a warp's exchange buffer (gl_fft_plan.SLOTS)
static_assert(2 * 256 <= 2 * XSLOTS, "exp(logmel) of two rows of up to 256 mel bins fits it");

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }

// a e^(-i theta), or a e^(+i theta) when INV; w = (cos theta, sin theta)
template <bool INV>
__device__ __forceinline__ float2 twiddle(float2 a, float2 w) {
  return INV ? make_float2(fmaf(a.x, w.x, -a.y * w.y), fmaf(a.y, w.x, a.x * w.y))
             : make_float2(fmaf(a.x, w.x, a.y * w.y), fmaf(a.y, w.x, -a.x * w.y));
}

// a times -i, or +i when INV
template <bool INV>
__device__ __forceinline__ float2 quarter(float2 a) {
  return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

// 4-point DFT (inverse when INV, not divided by 4) in place
template <bool INV>
__device__ __forceinline__ void dft4(float2& y0, float2& y1, float2& y2, float2& y3) {
  const float2 e0 = cadd(y0, y2), e1 = csub(y0, y2), e2 = cadd(y1, y3),
               e3 = quarter<INV>(csub(y1, y3));
  y0 = cadd(e0, e2);
  y1 = cadd(e1, e3);
  y2 = csub(e0, e2);
  y3 = csub(e1, e3);
}

// 8-point DFT in place: a radix-2 step, the odd half times e^(-+i pi n / 4),
// then 4-point DFTs of the even and the odd bins
template <bool INV>
__device__ __forceinline__ void dft8(float2 (&v)[8]) {
  constexpr float C = 0.70710678118654752f;  // cos(pi / 4), the twiddle table's entry 32
  float2 a[4], d[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    a[n] = cadd(v[n], v[n + 4]);
    d[n] = csub(v[n], v[n + 4]);
  }
  d[1] = INV ? make_float2(C * (d[1].x - d[1].y), C * (d[1].x + d[1].y))
             : make_float2(C * (d[1].x + d[1].y), C * (d[1].y - d[1].x));
  d[2] = quarter<INV>(d[2]);
  d[3] = INV ? make_float2(-C * (d[3].x + d[3].y), C * (d[3].x - d[3].y))
             : make_float2(C * (d[3].y - d[3].x), -C * (d[3].x + d[3].y));
  dft4<INV>(a[0], a[1], a[2], a[3]);
  dft4<INV>(d[0], d[1], d[2], d[3]);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    v[2 * m] = a[m];
    v[2 * m + 1] = d[m];
  }
}

// A lane's constants of the FFT plan (tests/gl_fft_plan.py): its twiddles in state
// A (W256^(lane kb)) and B (W32^(ap kc), lane = ap + 4 kb), and its first
// slots in the exchanges: B's (36 kb + ap, then + 4 b'; B -> C: 4 kb + ap,
// then + 33 kc) and C's two groups' (4 kb + 33 kc, then + ka)
struct FftLane {
  float2 w1[8], w2[8];  // [0] (1, 0) is never read
  int ab, bc, c0, c1;
};

// z (state A: v[b] = z[lane + 32 b]) -> Z (state C: v[4 g + ka] = Z[kb_g + 8 kc_g + 64 ka])
__device__ __forceinline__ void fft_forward(float2 (&v)[8], float2* buf, const FftLane& f,
                                            int lane) {
  dft8<false>(v);
#pragma unroll
  for (int k = 1; k < 8; ++k) v[k] = twiddle<false>(v[k], f.w1[k]);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8; ++k) buf[lane + 36 * k] = v[k];
  __syncwarp();
#pragma unroll
  for (int b = 0; b < 8; ++b) v[b] = buf[f.ab + 4 * b];
  dft8<false>(v);
#pragma unroll
  for (int k = 1; k < 8; ++k) v[k] = twiddle<false>(v[k], f.w2[k]);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8; ++k) buf[f.bc + 33 * k] = v[k];
  __syncwarp();
#pragma unroll
  for (int ka = 0; ka < 4; ++ka) {
    v[ka] = buf[f.c0 + ka];
    v[4 + ka] = buf[f.c1 + ka];
  }
  dft4<false>(v[0], v[1], v[2], v[3]);
  dft4<false>(v[4], v[5], v[6], v[7]);
}

// The adjoint: W (state C) -> sum_k W[k] e^(2 pi i n k / 256) (state A), not divided by 256
__device__ __forceinline__ void fft_inverse(float2 (&v)[8], float2* buf, const FftLane& f,
                                            int lane) {
  dft4<true>(v[0], v[1], v[2], v[3]);
  dft4<true>(v[4], v[5], v[6], v[7]);
  __syncwarp();
#pragma unroll
  for (int ka = 0; ka < 4; ++ka) {
    buf[f.c0 + ka] = v[ka];
    buf[f.c1 + ka] = v[4 + ka];
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = buf[f.bc + 33 * k];
#pragma unroll
  for (int k = 1; k < 8; ++k) v[k] = twiddle<true>(v[k], f.w2[k]);
  dft8<true>(v);
  __syncwarp();
#pragma unroll
  for (int b = 0; b < 8; ++b) buf[f.ab + 4 * b] = v[b];
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = buf[lane + 36 * k];
#pragma unroll
  for (int k = 1; k < 8; ++k) v[k] = twiddle<true>(v[k], f.w1[k]);
  dft8<true>(v);
}

// s + c += x (th + tl), the product split exactly by an FMA and the sum by an
// error-free addition (Ogita, Rump and Oishi's Dot2): the rounding intrinsics
// keep the compiler from fusing what the splits take apart
__device__ __forceinline__ void dot2_add(float x, float th, float tl, float& s, float& c) {
  const float p = __fmul_rn(x, th);
  const float pe = fmaf(x, th, -p);
  const float t = __fadd_rn(s, p), z = __fsub_rn(t, s);
  const float se = __fadd_rn(__fsub_rn(s, __fsub_rn(t, z)), __fsub_rn(p, z));
  s = t;
  c += se + fmaf(x, tl, pe);
}

// (s, c) of every lane summed over the warp in the same way; every lane ends
// with the same pair (an error-free addition does not depend on its order)
__device__ __forceinline__ void dot2_reduce(float& s, float& c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float so = __shfl_xor_sync(0xffffffffu, s, off), co = __shfl_xor_sync(0xffffffffu, c, off);
    const float t = __fadd_rn(s, so), z = __fsub_rn(t, s);
    const float e = __fadd_rn(__fsub_rn(s, __fsub_rn(t, z)), __fsub_rn(so, z));
    s = t;
    c = c + co + e;
  }
}

// Bin k of frame h of the warp's block as if computed in twice the precision
// and rounded: sum_n u[n] w[n] e^(-2 pi i k n / 256) over the 256 samples,
// n = lane + 32 b, from the frame before its window (frm: x frame 0, y frame
// 1) and the lane's window values wn, each u w split exactly by an FMA, with
// the twiddles' float32 parts and their remainders (twid: cos, sin,
// cos - cos_f32, sin - sin_f32).  All lanes return it.
__device__ __forceinline__ float2 exact_bin(const float2* frm, const float (&wn)[8],
                                            const float4* __restrict__ twid, int k, int h,
                                            int lane) {
  float sr = 0.f, cr = 0.f, si = 0.f, ci = 0.f;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const int n = lane + 32 * b;
    const float u = h ? frm[n].y : frm[n].x;
    const float x = __fmul_rn(u, wn[b]), xe = fmaf(u, wn[b], -x);
    const float4 t = __ldg(twid + ((k * n) & (FFT - 1)));
    dot2_add(x, t.x, t.z, sr, cr);
    dot2_add(-x, t.y, t.w, si, ci);
    cr = fmaf(xe, t.x, cr);
    ci = fmaf(-xe, t.y, ci);
  }
  dot2_reduce(sr, cr);
  dot2_reduce(si, ci);
  return make_float2(sr + cr, si + ci);
}

// Bins whose phase the float32 FFT leaves ill-conditioned are summed again by
// exact_bin: |X| below 2^-12 of the block's norm sqrt(sum |z|^2) (the FFT's
// rounding, ~1e-7 of the norm and 1e-6 at most, is then at most ~1e-3 of the
// bin), and under exp(angle) those within 2^-18 of the norm of the branch
// cut (X real and negative: angle +-pi, e^angle 23 or 0.04); DC and Nyquist,
// whose angle is their sign, by the first rule.  Squares against the
// squared norm; the unpacked bins are twice the frames' (TQ1, TQ2 say so).
// Random inits put about 1 bin in 10^7 below the first; under exp(angle)
// the spectra come out nearly real, and about 1 in 7,000 lie at the cut
// (tests/gl_fft_plan.py emulates the rule).
constexpr float TQ1 = 0x1p-22f, TQ2 = 0x1p-34f;

// Griffin-Lim of one block a warp.  BUG: the exp(angle) estimator, else the
// unit phasor.  twid: (256, 4) cos and sin of 2 pi j / 256 and their
// remainders (ops/cuda_gl.twiddle_table).
template <bool BUG>
__global__ void __launch_bounds__(FTHREADS, 2) gl_fft_kernel(
    const float* __restrict__ lm, const float* __restrict__ rnd, const float* __restrict__ minv,
    const float4* __restrict__ twid, const float* __restrict__ win, float* __restrict__ G, int B,
    int NM, int iterations) {
  __shared__ float2 tw[FFT];
  __shared__ float2 xbuf[FWARPS][XSLOTS];
  __shared__ float2 fbuf[FWARPS][FFT];  // the iteration's frames before the window, for exact_bin
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * FWARPS + warp;
  const float* init = rnd + (size_t)b * BLK;
  if (iterations == 0) {
    if (b < B)
      for (int s = lane; s < BLK; s += 32) G[(size_t)b * BLK + s] = init[s];
    return;
  }
  for (int i = threadIdx.x; i < FFT; i += FTHREADS) {
    const float4 t = twid[i];
    tw[i] = make_float2(t.x, t.y);
  }
  __syncthreads();
  if (b >= B) return;
  float2* buf = xbuf[warp];
  float2* frm = fbuf[warp];
  // the frames of the inits (state A), in flight while the target magnitudes are computed
  float wn[8], f0[8], f1[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    wn[j] = __ldg(win + lane + 32 * j);
    f0[j] = __ldg(init + lane + 32 * j);
    f1[j] = __ldg(init + HOP + lane + 32 * j);
  }
  FftLane f;
  {
    const int kb = lane >> 2, ap = lane & 3;
    f.ab = 36 * kb + ap;
    f.bc = 4 * kb + ap;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      f.w1[k] = tw[lane * k];
      f.w2[k] = tw[8 * ap * k];
    }
  }
  // state C: group 0 and its partner, whose bins are 256 - k of group 0's
  int kb0 = (lane >> 2) & 3, kb1;
  const int kc0 = (lane & 3) + 4 * (lane >> 4);
  if (lane >= 16 && kb0 == 0) kb0 = 4;
  int kc1;
  if (kb0 == 0 && kc0 == 0) {
    kb1 = 0;
    kc1 = 4;
  } else if (kb0 == 0 || kb0 == 4) {
    kb1 = kb0;
    kc1 = (kb0 == 0 ? 8 : 7) - kc0;
  } else {
    kb1 = 8 - kb0;
    kc1 = 7 - kc0;
  }
  f.c0 = 4 * kb0 + 33 * kc0;
  f.c1 = 4 * kb1 + 33 * kc1;
  // the lane's 4 bins k < 128, at positions 0, 1, 5 and 4 of state C (gl_fft_plan.LO):
  // group 0's ka = 0, 1 and group 1's ka = 1, 0
  const int k0 = kb0 + 8 * kc0, k1 = kb1 + 8 * kc1;
  const int bin[4] = {k0, k0 + 64, k1 + 64, k1};
  // target magnitudes exp(logmel) @ Minv of the lane's bins and of Nyquist, both
  // frames (log-mel rows b and b + 1); exp(logmel) staged in the exchange buffer
  float* ex = reinterpret_cast<float*>(buf);
  for (int i = lane; i < 2 * NM; i += 32) ex[i] = expf(lm[(size_t)b * NM + i]);
  __syncwarp();
  float sp0[4], sp1[4], sn0 = 0.f, sn1 = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) sp0[j] = sp1[j] = 0.f;
  for (int m = 0; m < NM; ++m) {
    const float e0 = ex[m], e1 = ex[NM + m];
    const float* row = minv + m * (NBIN + 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float mv = __ldg(row + bin[j]);
      sp0[j] = fmaf(e0, mv, sp0[j]);
      sp1[j] = fmaf(e1, mv, sp1[j]);
    }
    const float mn = __ldg(row + NBIN);
    sn0 = fmaf(e0, mn, sn0);
    sn1 = fmaf(e1, mn, sn1);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sp0[j] = isfinite(sp0[j]) ? sp0[j] : 0.f;
    sp1[j] = isfinite(sp1[j]) ? sp1[j] : 0.f;
  }
  sn0 = isfinite(sn0) ? sn0 : 0.f;
  sn1 = isfinite(sn1) ? sn1 : 0.f;
  float2 v[8];  // the frames z = f0 + i f1 in state A, u w
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    frm[lane + 32 * j] = make_float2(f0[j], f1[j]);
    v[j] = make_float2(f0[j] * wn[j], f1[j] * wn[j]);
  }
  const bool l0 = lane == 0;  // DC and Nyquist (group (0, 0)) and bins 64, 96, 32
  for (int it = 0; it < iterations; ++it) {
    float e = 0.f;  // sum |z|^2 over the block
#pragma unroll
    for (int j = 0; j < 8; ++j) e = fmaf(v[j].x, v[j].x, fmaf(v[j].y, v[j].y, e));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) e += __shfl_xor_sync(0xffffffffu, e, off);
    fft_forward(v, buf, f, lane);
    // slot j: bin k (lo) and its partner 256 - k (hi, gl_fft_plan.HI; lane 0's
    // slot 0 is DC, whose hi is itself).  Twice both frames' bins, frame h
    // at 2 j + h: X0 = lo + conj hi, X1 = -i (lo - conj hi); the phase step
    // is blind to the factor 2.  Nyquist (lane 0) is Z[128] itself
    const float2 lo[4] = {v[0], v[1], v[5], v[4]};
    const float2 hi[4] = {l0 ? v[0] : v[7], l0 ? v[3] : v[6], l0 ? v[6] : v[2],
                          l0 ? v[7] : v[3]};
    float xr[8], xi[8], xn[2] = {v[2].x, v[2].y};
    unsigned flags = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      xr[2 * j] = lo[j].x + hi[j].x;
      xi[2 * j] = lo[j].y - hi[j].y;
      xr[2 * j + 1] = lo[j].y + hi[j].y;
      xi[2 * j + 1] = hi[j].x - lo[j].x;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const bool small = fmaf(xr[q], xr[q], xi[q] * xi[q]) < TQ1 * e;
      const bool cut = BUG && !(l0 && q < 2) && xr[q] < 0.f && xi[q] * xi[q] < TQ2 * e;
      flags |= (small || cut) ? 1u << q : 0u;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) flags |= l0 && 4.f * xn[h] * xn[h] < TQ1 * e ? 1u << (8 + h) : 0u;
    for (unsigned owners = __ballot_sync(0xffffffffu, flags != 0); owners; owners &= owners - 1) {
      const int src = __ffs(owners) - 1;
      for (unsigned fl = __shfl_sync(0xffffffffu, flags, src); fl; fl &= fl - 1) {
        const int q = __ffs(fl) - 1, j = (q >> 1) & 3, h = q & 1;
        const int kq = q >= 8 ? FFT / 2 : j == 0 ? k0 : j == 1 ? k0 + 64 : j == 2 ? k1 + 64 : k1;
        const float2 x = exact_bin(frm, wn, twid, __shfl_sync(0xffffffffu, kq, src), h, lane);
        if (lane == src) {
#pragma unroll
          for (int r = 0; r < 8; ++r)
            if (q == r) {
              xr[r] = 2.f * x.x;
              xi[r] = 2.f * x.y;
            }
          if (q == 8) xn[0] = x.x;
          if (q == 9) xn[1] = x.x;
        }
      }
    }
    // the phase step on both frames; W = Y0 + i Y1 at k and conj Y0 + i conj Y1 at 256 - k
    float2 wl[4], wh[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float zr0, zi0, zr1, zi1;
      phase_step(xr[2 * j], xi[2 * j], sp0[j], l0 && j == 0, BUG, zr0, zi0);
      phase_step(xr[2 * j + 1], xi[2 * j + 1], sp1[j], l0 && j == 0, BUG, zr1, zi1);
      wl[j] = make_float2(zr0 - zi1, zi0 + zr1);
      wh[j] = make_float2(zr0 + zi1, zr1 - zi0);
    }
    const float2 wnyq = make_float2(nyquist_phase(xn[0], sn0, BUG), nyquist_phase(xn[1], sn1, BUG));
    v[0] = wl[0];
    v[1] = wl[1];
    v[5] = wl[2];
    v[4] = wl[3];
    v[7] = l0 ? wh[3] : wh[0];
    v[6] = l0 ? wh[2] : wh[1];
    v[2] = l0 ? wnyq : wh[2];
    v[3] = l0 ? wh[1] : wh[3];
    fft_inverse(v, buf, f, lane);
    // both frames times the window over 256 (a power of two: exact), then the
    // in-block overlap-add (sample n of frame 1 is n + 160 of the block): the
    // next windowed frames, or after the last iteration the block itself
    // (samples [416, 480) are 0)
    float t0[8], t1[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      t0[j] = v[j].x * wn[j] * (1.f / FFT);
      t1[j] = v[j].y * wn[j] * (1.f / FFT);
    }
    if (it + 1 < iterations) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 u = make_float2(t0[j] + (j >= 5 ? t1[j - 5] : 0.f),
                                     (j < 3 ? t0[j + 5] : 0.f) + t1[j]);
        frm[lane + 32 * j] = u;
        v[j] = make_float2(u.x * wn[j], u.y * wn[j]);
      }
    } else {
      float* out = G + (size_t)b * BLK + lane;
#pragma unroll
      for (int j = 0; j < BLK / 32; ++j)
        out[32 * j] = (j < 8 ? t0[j] : 0.f) + (j >= 5 && j < 13 ? t1[j - 5] : 0.f);
    }
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
      frm[i] = v;
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
      for (int n = lane; n < FFT; n += 32) sn = fmaf(frm[f * FFT + n], wn[n], sn);
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
      zf[ff * FFT + kk] = z;
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

// The cluster kernel on B blocks, 8 CTAs per 4 blocks.
cudaError_t launch_cluster(const float* lm, const float* rnd, const float* minv, const float* fm,
                           const float* im, const float* fnyq, const float* inyq, const float* win,
                           float* G, int B, int NM, int iterations, int phase_bug,
                           cudaStream_t stream) {
  cudaError_t err;
  const size_t smem = cluster_smem(NM);
  if ((err = cudaFuncSetAttribute(gl_cluster_kernel,
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
  if ((err = cudaLaunchKernelEx(&cfg, gl_cluster_kernel, lm, rnd, minv, fm, im, fnyq, inyq,
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

// The FFT kernel on B blocks, 8 blocks a CTA.
template <bool BUG>
cudaError_t launch_fft(const float* lm, const float* rnd, const float* minv, const float4* twid,
                       const float* win, float* G, int B, int NM, int iterations,
                       cudaStream_t stream) {
  gl_fft_kernel<BUG><<<(B + FWARPS - 1) / FWARPS, FTHREADS, 0, stream>>>(lm, rnd, minv, twid, win,
                                                                         G, B, NM, iterations);
  return cudaGetLastError();
}

// Griffin-Lim of B blocks into G: float32, the cluster kernel when
// use_cluster, else gl_fft_kernel (`large` its twiddle table); bf16,
// gl_wgmma_kernel (`large` the forward operand's image; use_cluster is
// refused).
cudaError_t launch_gl_blocks(const float* lm, const float* rnd, const float* minv,
                             const float* fm, const float* im, const float* fnyq,
                             const float* inyq, const float* win, const void* large, float* G,
                             int B, int NM, int iterations, int phase_bug, int use_cluster,
                             int bf16, cudaStream_t stream) {
  if (use_cluster)
    return bf16 ? cudaErrorInvalidValue
                : launch_cluster(lm, rnd, minv, fm, im, fnyq, inyq, win, G, B, NM, iterations,
                                 phase_bug, stream);
  if (bf16) {
    const uint8_t* image = static_cast<const uint8_t*>(large);
    return phase_bug ? launch_wgmma<true>(lm, rnd, minv, image, fnyq, inyq, win, G, B, NM,
                                          iterations, stream)
                     : launch_wgmma<false>(lm, rnd, minv, image, fnyq, inyq, win, G, B, NM,
                                           iterations, stream);
  }
  const float4* twid = static_cast<const float4*>(large);
  return phase_bug ? launch_fft<true>(lm, rnd, minv, twid, win, G, B, NM, iterations, stream)
                   : launch_fft<false>(lm, rnd, minv, twid, win, G, B, NM, iterations, stream);
}

}  // namespace

// fm / im: the cluster kernel's forward and inverse DFT operands (f32);
// large: the FFT's twiddle table (f32) or the bf16 forward operand's
// shared-memory image (ops/cuda_gl.make_gl_audio_ops builds them all).
extern "C" int gl_blocks(const float* lm, const float* rnd, const float* minv, const float* fm,
                         const float* im, const float* fnyq, const float* inyq, const float* win,
                         const void* large, float* G, int B, int NM, int iterations,
                         int phase_bug, int use_cluster, int bf16, cudaStream_t stream) {
  return (int)launch_gl_blocks(lm, rnd, minv, fm, im, fnyq, inyq, win, large, G, B, NM,
                               iterations, phase_bug, use_cluster, bf16, stream);
}

extern "C" int gl_audio(const float* lm, const float* rnd, const float* minv, const float* fm,
                        const float* im, const float* fnyq, const float* inyq, const float* win,
                        const void* large, const float* winv, const float* pmatT,
                        const float* apow, const float* cpow, const float* h, float* G, float* CH,
                        float* Q, short* out, int B, int NM, int S, int n_pow, int iterations,
                        int phase_bug, int use_cluster, int bf16, float denom,
                        cudaStream_t stream) {
  cudaError_t err = launch_gl_blocks(lm, rnd, minv, fm, im, fnyq, inyq, win, large, G, B, NM,
                                     iterations, phase_bug, use_cluster, bf16, stream);
  if (err != cudaSuccess) return (int)err;
  ola_kernel<<<B, HOP, 0, stream>>>(G, winv, pmatT, CH, Q, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  lowpass_kernel<<<B, HOP, 0, stream>>>(CH, Q, apow, cpow, h, out, S, n_pow, denom);
  return (int)cudaGetLastError();
}
