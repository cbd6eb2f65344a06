// Vocoder, two entry points.  Plain float32 FMA (no TF32, no mma), sm_90a.
//   gl_audio: logMel frames (B+1, n_mel) + block inits (B, 480) -> int16
//     audio (B*160,); launches 1-3 below.
//     Replaces closed_loop_seeg_speech_synthesis_tpu/ops/pallas_gl.py
//     _gl_audio_kernel (entry gl_audio_pallas).
//   gl_blocks: the same inputs -> reconstructed blocks (B, 480) before the
//     overlap-add; launch 1 alone, with either phase estimator.  The split
//     vocoder and the online step (B = 4 blocks a packet) call it.
//     Replaces closed_loop_seeg_speech_synthesis_tpu/ops/pallas_gl.py
//     _gl_kernel (entry gl_blocks_pallas).
//
// What bounds it on an H100: fp32 arithmetic in the Griffin-Lim loop, and
// the L2 traffic of its DFT operands.  Each iteration of each 480-sample
// block is a forward and an inverse 256-point real DFT of two frames, ~262 k
// FMAs; at 8 iterations over the 180,000 blocks of a 30-minute session that
// is ~380 G FMA, against ~350 MB of inits read once.  The tail (overlap-add,
// low-pass, int16) is ~2.5 G FMA and streams the blocks once more.
//
// Design.  The TPU kernel walks block tiles in order and carries the
// overlap-add tails and the low-pass state in scratch.  Here:
//   1. gl_blocks: one CUDA block runs all iterations for 8 audio blocks (16
//      frames) resident in shared memory.  The four f32 DFT operands of
//      pallas_gl._split_nyquist (cos|sin forward, 256x256; cos;sin inverse,
//      256x256) are 512 KB and do not fit in shared memory, so they stream
//      from L2: thread j owns output column j, reads one matrix element per
//      step, coalesced, and applies it to all 16 frames held in registers
//      (frames are n-major in shared memory, read as broadcast float4s).
//      A 256-entry cos/sin table indexed by n*k mod 256 was rejected: it
//      differs from make_rdft's f32 matrices in ~900 elements per matrix
//      (the f64 angle 2*pi*n*k/256 is rounded before the cos), and the
//      exp(angle) iteration is chaotic, so the operands must be the same
//      bytes.  The Nyquist bin is exactly real and is a 16-lane reduction.
//      Phase: atan2f with DC/Nyquist forced to 0 or pi (phase_bug=1), or the
//      unit phasor (phase_bug=0).  Blocks go to a (B, 480) scratch.
//   2. ola: chunk b = (G[b][0:160] + G[b-1][160:320] + G[b-2][320:480]) times
//      the window-sum reciprocal (rows 0 and 1 have partial sums), and the
//      low-pass input term q_b = Pmat chunk_b.
//   3. lowpass: the state before row b is the 16-term truncated power sum
//      sum_p (A^160)^p q_{b-1-p} (spectral radius 0.988^160 ~ 0.145, so the
//      truncation is ~4e-14), which makes every row independent; then
//      y = Cpow s_b + Tmat chunk_b, clip, scale, truncate to int16.
// Every C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int FFT = 256;
constexpr int HOP = 160;
constexpr int BLK = 480;
constexpr int NBIN = FFT / 2;  // 128 bins besides Nyquist
constexpr int NB = 8;           // audio blocks per CUDA block
constexpr int NF = 2 * NB;      // frames per CUDA block
constexpr int XS = NF + 4;      // padded row of the spectrum buffer
constexpr int MAX_S = 32;
constexpr float PI_F = 3.14159265358979323846f;

__global__ void __launch_bounds__(FFT) gl_blocks_kernel(
    const float* __restrict__ lm, const float* __restrict__ rnd, const float* __restrict__ minv,
    const float* __restrict__ fm, const float* __restrict__ im, const float* __restrict__ fnyq,
    const float* __restrict__ inyq, const float* __restrict__ win, float* __restrict__ G,
    int B, int NM, int iterations, int phase_bug) {
  extern __shared__ __align__(16) float smem[];
  float* wav = smem;                     // (NB, BLK)
  float* frt = wav + NB * BLK;           // (FFT, NF) windowed frames, then z = [zr; zi]
  float* xs = frt + FFT * NF;            // (FFT, XS) forward spectrum, then (NF, FFT) frames out
  float* spec = xs + FFT * XS;           // (NF, NBIN + 1) target magnitudes
  float* ex = spec + NF * (NBIN + 1);    // (NF, NM) exp(logmel)
  float* w = ex + NF * NM;               // (FFT) window
  float* xn = w + FFT;                   // (NF) Nyquist bin
  float* zn = xn + NF;                   // (NF) Nyquist phase-corrected
  const int b0 = blockIdx.x * NB;
  const int t = threadIdx.x;
  w[t] = win[t];
  for (int i = t; i < NB * BLK; i += FFT) {
    const int b = b0 + i / BLK;
    wav[i] = b < B ? rnd[(size_t)b * BLK + i % BLK] : 0.f;
  }
  for (int i = t; i < NF * NM; i += FFT) {
    const int f = i / NM, b = b0 + (f >> 1);  // frame f: block f/2, mel row block + f%2
    ex[i] = b < B ? expf(lm[(size_t)(b + (f & 1)) * NM + i % NM]) : 0.f;
  }
  __syncthreads();
  // target magnitude exp(logmel) @ Minv, non-finite values scrubbed to 0
  for (int i = t; i < NF * (NBIN + 1); i += FFT) {
    const int f = i / (NBIN + 1), k = i % (NBIN + 1);
    float s = 0.f;
    for (int m = 0; m < NM; ++m) s = fmaf(ex[f * NM + m], __ldg(minv + m * (NBIN + 1) + k), s);
    spec[i] = isfinite(s) ? s : 0.f;
  }
  __syncthreads();
  for (int it = 0; it < iterations; ++it) {
    for (int i = t; i < FFT * NF; i += FFT) {
      const int n = i / NF, f = i % NF;
      frt[i] = wav[(f >> 1) * BLK + (f & 1) * HOP + n] * w[n];
    }
    __syncthreads();
    {  // forward DFT: column t of [F_cos | F_sin] for all frames
      float acc[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) acc[f] = 0.f;
      for (int n = 0; n < FFT; ++n) {
        const float m = __ldg(fm + n * FFT + t);
        const float4* v4 = reinterpret_cast<const float4*>(frt + n * NF);
#pragma unroll
        for (int q = 0; q < NF / 4; ++q) {
          const float4 v = v4[q];
          acc[4 * q] = fmaf(v.x, m, acc[4 * q]);
          acc[4 * q + 1] = fmaf(v.y, m, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v.z, m, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v.w, m, acc[4 * q + 3]);
        }
      }
      float4* xo = reinterpret_cast<float4*>(xs + t * XS);
#pragma unroll
      for (int q = 0; q < NF / 4; ++q)
        xo[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
    {  // Nyquist bin (exactly real): 16 lanes per frame
      const int f = t >> 4, part = t & 15;
      float s = 0.f;
      for (int n = part; n < FFT; n += 16) s = fmaf(frt[n * NF + f], __ldg(fnyq + n), s);
      for (int off = 8; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (part == 0) xn[f] = s;
    }
    __syncthreads();
    {  // phase: thread owns bin t&127 of 8 frames
      const int k = t & (NBIN - 1), fg = t >> 7;
      for (int f = fg * (NF / 2); f < (fg + 1) * (NF / 2); ++f) {
        const float xr = xs[k * XS + f];
        const float xi = -xs[(NBIN + k) * XS + f];
        const float sp = spec[f * (NBIN + 1) + k];
        float zr, zi;
        if (phase_bug) {
          // exp(angle(x)) without the 1j (GriffinLim.py:93); the DC bin is
          // exactly real, so its angle is 0 or pi
          const float ang = (k == 0) ? (xr < 0.f ? PI_F : 0.f) : atan2f(xi, xr);
          zr = sp * expf(ang);
          zi = 0.f;
        } else {
          const float r = sqrtf(xr * xr + xi * xi);
          const bool safe = r > 0.f;
          const float inv = safe ? 1.f / r : 0.f;
          zr = sp * (safe ? xr * inv : 1.f);
          zi = sp * (xi * inv);
        }
        frt[k * NF + f] = zr;
        frt[(NBIN + k) * NF + f] = zi;
      }
      if (t < NF) {
        const float sp = spec[t * (NBIN + 1) + NBIN];
        const float s = xn[t];
        zn[t] = phase_bug ? sp * expf(s < 0.f ? PI_F : 0.f) : sp * (s < 0.f ? -1.f : 1.f);
      }
    }
    __syncthreads();
    {  // inverse DFT: column t of [I_cos; I_sin] (the sin rows vanish when phase_bug)
      float acc[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) acc[f] = 0.f;
      const int kmax = phase_bug ? NBIN : FFT;
      for (int kk = 0; kk < kmax; ++kk) {
        const float m = __ldg(im + kk * FFT + t);
        const float4* z4 = reinterpret_cast<const float4*>(frt + kk * NF);
#pragma unroll
        for (int q = 0; q < NF / 4; ++q) {
          const float4 v = z4[q];
          acc[4 * q] = fmaf(v.x, m, acc[4 * q]);
          acc[4 * q + 1] = fmaf(v.y, m, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v.z, m, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v.w, m, acc[4 * q + 3]);
        }
      }
      const float ny = __ldg(inyq + t), wn = w[t];
#pragma unroll
      for (int f = 0; f < NF; ++f) xs[f * FFT + t] = (acc[f] + zn[f] * ny) * wn;
    }
    __syncthreads();
    for (int i = t; i < NB * BLK; i += FFT) {
      const int g = i / BLK, r = i % BLK;
      float v = 0.f;
      if (r < FFT) v += xs[(2 * g) * FFT + r];
      if (r >= HOP && r < HOP + FFT) v += xs[(2 * g + 1) * FFT + r - HOP];
      wav[i] = v;
    }
    __syncthreads();
  }
  for (int i = t; i < NB * BLK; i += FFT) {
    const int b = b0 + i / BLK;
    if (b < B) G[(size_t)b * BLK + i % BLK] = wav[i];
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

cudaError_t launch_gl_blocks(const float* lm, const float* rnd, const float* minv,
                             const float* fm, const float* im, const float* fnyq,
                             const float* inyq, const float* win, float* G, int B, int NM,
                             int iterations, int phase_bug, cudaStream_t stream) {
  const size_t smem = (size_t)(NB * BLK + FFT * NF + FFT * XS + NF * (NBIN + 1) + NF * NM +
                               FFT + 2 * NF) * sizeof(float);
  cudaFuncSetAttribute(gl_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  gl_blocks_kernel<<<(B + NB - 1) / NB, FFT, smem, stream>>>(lm, rnd, minv, fm, im, fnyq, inyq,
                                                             win, G, B, NM, iterations, phase_bug);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gl_blocks(const float* lm, const float* rnd, const float* minv, const float* fm,
                         const float* im, const float* fnyq, const float* inyq, const float* win,
                         float* G, int B, int NM, int iterations, int phase_bug,
                         cudaStream_t stream) {
  return (int)launch_gl_blocks(lm, rnd, minv, fm, im, fnyq, inyq, win, G, B, NM, iterations,
                               phase_bug, stream);
}

extern "C" int gl_audio(const float* lm, const float* rnd, const float* minv, const float* fm,
                        const float* im, const float* fnyq, const float* inyq, const float* win,
                        const float* winv, const float* pmatT, const float* apow,
                        const float* cpow, const float* h, float* G, float* CH, float* Q,
                        short* out, int B, int NM, int S, int n_pow, int iterations,
                        int phase_bug, float denom, cudaStream_t stream) {
  cudaError_t err = launch_gl_blocks(lm, rnd, minv, fm, im, fnyq, inyq, win, G, B, NM,
                                     iterations, phase_bug, stream);
  if (err != cudaSuccess) return (int)err;
  ola_kernel<<<B, HOP, 0, stream>>>(G, winv, pmatT, CH, Q, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  lowpass_kernel<<<B, HOP, 0, stream>>>(CH, Q, apow, cpow, h, out, S, n_pow, denom);
  return (int)cudaGetLastError();
}
