// Replay front end, two entry points.  Plain float32 FMA (no TF32, no mma),
// sm_90a.
//   frontend_decode_mels: raw sEEG (T, C) -> dequantized, smoothed logMel
//     frames (n_frames, B); launches 1-4 below.
//     Replaces closed_loop_seeg_speech_synthesis_tpu/ops/pallas_frontend.py
//     _make_decode_kernel (entry frontend_decode_mels).
//   frontend_logpower: raw sEEG (T, C) -> log-power features (n_frames, C),
//     the split front end; launches 1-3 below, the same code.
//     Replaces closed_loop_seeg_speech_synthesis_tpu/ops/pallas_frontend.py
//     _frontend_kernel (entry frontend_logpower).
//
// What bounds it on an H100: arithmetic.  At 128 channels the filter chain's
// per-period Toeplitz product (Ls^2/2 FMAs per channel), the state input
// q_k = Pmat u_k (48 Ls per channel) and the LDA epilogue (5 C x 360 FMAs per
// frame) are ~85 G FMA for a 30-minute session, against 0.94 GB of sEEG read
// once: far above the fp32 ridge of the card.  Besides that, the filter's
// block-boundary recurrence s_{k+1} = A^L s_k + q_k is sequential over the
// 7,200 periods of a 30-minute session at 1024 Hz: a latency floor.
//
// Design.  The TPU kernel walks periods in order on one core and carries the
// filter state, the previous chunk and the feature history in scratch.  GPU
// blocks run in no order, so the time axis is split into four launches:
//   1. period_inputs: q_k = Pmat u_k for every period and channel (parallel);
//   2. boundary_scan: s_{k+1} = A^L s_k + q_k, sequential over k and parallel
//      over (state row, channel); the only serial part, 48 FMAs a step;
//   3. features: one block per (period, 16-channel tile) rebuilds y_k =
//      Tmat u_k + Cpow s_k and the tail of y_{k-1} that the period's first
//      windows reach back into (period 0 reads the zero-fill prefix), then
//      writes log(window sum of y^2 + 0.01) for the period's P frames;
//   4. epilogue: one block per 64 frames computes the LDA scores with the
//      5-tap context folded into the product (tap m of frame j reads feature
//      row j - depth + m*step; rows before the session are zero), the
//      first-max over the 9 class slots, the median select and the sigma-0.5
//      smoothing matrix, and writes only the (64, B) mel rows.
// The (n_frames, C) features pass through device memory once between
// launches 3 and 4 (92 MB at 30 min / 128 ch), so the history rows of
// period k-1 are read back, not recomputed.  Every C entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int QCT = 32;   // channels per block, launch 1
constexpr int QSG = 8;    // state groups per block, launch 1
constexpr int QMAXS = 8;  // states per thread, launch 1 (S <= QSG * QMAXS)
constexpr int SCT = 4;    // channels per block, launch 2
constexpr int FCT = 16;   // channels per block, launch 3
constexpr int FRG = 16;   // row groups per block, launch 3
constexpr int EF = 64;    // frames per block, launch 4
constexpr int EFG = 8;    // frames per thread, launch 4
constexpr int ECK = 8;    // channels per shared-memory chunk, launch 4
constexpr int KS = 9;     // class slots per mel bin

// q[k][s][c] = sum_j Pmat[s][j] u[k*Ls + j][c]
__global__ void period_inputs_kernel(const float* __restrict__ u, const float* __restrict__ pmatT,
                                     float* __restrict__ q, int Ls, int S, int C) {
  extern __shared__ float smem[];
  float* us = smem;             // (Ls, QCT)
  float* ps = smem + Ls * QCT;  // (Ls, S) = Pmat^T
  const int k = blockIdx.x;
  const int c0 = blockIdx.y * QCT;
  const int tid = threadIdx.x;
  for (int idx = tid; idx < Ls * QCT; idx += blockDim.x) {
    const int j = idx / QCT, c = c0 + idx % QCT;
    us[idx] = c < C ? u[((size_t)k * Ls + j) * C + c] : 0.f;
  }
  for (int idx = tid; idx < Ls * S; idx += blockDim.x) ps[idx] = pmatT[idx];
  __syncthreads();
  const int cc = tid % QCT, g = tid / QCT;
  float acc[QMAXS];
#pragma unroll
  for (int i = 0; i < QMAXS; ++i) acc[i] = 0.f;
  for (int j = 0; j < Ls; ++j) {
    const float x = us[j * QCT + cc];
    const float* pr = ps + j * S;
#pragma unroll
    for (int i = 0; i < QMAXS; ++i) {
      const int s = g + QSG * i;
      if (s < S) acc[i] = fmaf(pr[s], x, acc[i]);
    }
  }
  const int c = c0 + cc;
  if (c < C) {
#pragma unroll
    for (int i = 0; i < QMAXS; ++i) {
      const int s = g + QSG * i;
      if (s < S) q[((size_t)k * S + s) * C + c] = acc[i];
    }
  }
}

// sb[k] = state before period k: s_0 = s0, s_{k+1} = A_L s_k + q_k
__global__ void boundary_scan_kernel(const float* __restrict__ q, const float* __restrict__ s0,
                                     const float* __restrict__ aT, float* __restrict__ sb,
                                     int K, int S, int C) {
  extern __shared__ float smem[];
  float* at = smem;          // (S, S): at[t*S + s] = A_L[s][t]
  float* st = at + S * S;    // 2 x (S, SCT) double buffer
  const int tid = threadIdx.x;
  const int s = tid % S, cl = tid / S;
  const int c = blockIdx.x * SCT + cl;
  const bool active = c < C;
  for (int idx = tid; idx < S * S; idx += blockDim.x) at[idx] = aT[idx];
  st[s * SCT + cl] = active ? s0[s * C + c] : 0.f;
  __syncthreads();
  int cur = 0;
  float qn = (active && K > 0) ? q[(size_t)s * C + c] : 0.f;
  for (int k = 0; k < K; ++k) {
    const float qk = qn;
    if (active && k + 1 < K) qn = q[((size_t)(k + 1) * S + s) * C + c];
    const float* sc = st + cur * S * SCT;
    if (active) sb[((size_t)k * S + s) * C + c] = sc[s * SCT + cl];
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    int t = 0;
    for (; t + 3 < S; t += 4) {
      a0 = fmaf(at[t * S + s], sc[t * SCT + cl], a0);
      a1 = fmaf(at[(t + 1) * S + s], sc[(t + 1) * SCT + cl], a1);
      a2 = fmaf(at[(t + 2) * S + s], sc[(t + 2) * SCT + cl], a2);
      a3 = fmaf(at[(t + 3) * S + s], sc[(t + 3) * SCT + cl], a3);
    }
    for (; t < S; ++t) a0 = fmaf(at[t * S + s], sc[t * SCT + cl], a0);
    st[(1 - cur) * S * SCT + s * SCT + cl] = ((a0 + a1) + (a2 + a3)) + qk;
    __syncthreads();
    cur = 1 - cur;
  }
}

// F[k*P + i][c] = log(sum over window i of span^2 + 0.01), span = [y_{k-1}, y_k]
__global__ void features_kernel(const float* __restrict__ u, const float* __restrict__ sb,
                                const float* __restrict__ h, const float* __restrict__ cpow,
                                const float* __restrict__ prefix, const int* __restrict__ starts,
                                float* __restrict__ F, int Ls, int S, int C, int P, int win,
                                int tail) {
  extern __shared__ float smem[];
  float* hs = smem;                       // (Ls) impulse response, Tmat[t][j] = h[t-j]
  float* uc = hs + Ls;                    // (Ls, FCT) current chunk
  float* up = uc + Ls * FCT;              // (Ls, FCT) previous chunk
  float* ys = up + Ls * FCT;              // (tail + Ls, FCT) span^2 from span index Ls - tail
  float* sc = ys + (tail + Ls) * FCT;     // (S, FCT) state before period k
  float* sp = sc + S * FCT;               // (S, FCT) state before period k-1
  const int k = blockIdx.x;
  const int c0 = blockIdx.y * FCT;
  const int tid = threadIdx.x;
  const int cc = tid % FCT, rg = tid / FCT;
  const int c = c0 + cc;
  for (int idx = tid; idx < Ls; idx += blockDim.x) hs[idx] = h[idx];
  for (int idx = tid; idx < Ls * FCT; idx += blockDim.x) {
    const int j = idx / FCT, ci = c0 + idx % FCT;
    uc[idx] = ci < C ? u[((size_t)k * Ls + j) * C + ci] : 0.f;
    up[idx] = (ci < C && k > 0 && tail > 0) ? u[((size_t)(k - 1) * Ls + j) * C + ci] : 0.f;
  }
  for (int idx = tid; idx < S * FCT; idx += blockDim.x) {
    const int s = idx / FCT, ci = c0 + idx % FCT;
    sc[idx] = ci < C ? sb[((size_t)k * S + s) * C + ci] : 0.f;
    sp[idx] = (ci < C && k > 0) ? sb[((size_t)(k - 1) * S + s) * C + ci] : 0.f;
  }
  __syncthreads();
  for (int t = rg; t < Ls; t += FRG) {
    float acc = 0.f;
    const float* cr = cpow + (size_t)t * S;
    for (int s = 0; s < S; ++s) acc = fmaf(__ldg(cr + s), sc[s * FCT + cc], acc);
    for (int j = 0; j <= t; ++j) acc = fmaf(hs[t - j], uc[j * FCT + cc], acc);
    ys[(tail + t) * FCT + cc] = acc * acc;
  }
  for (int r = rg; r < tail; r += FRG) {
    const int t = Ls - tail + r;
    float y;
    if (k == 0) {
      y = prefix[t];
    } else {
      y = 0.f;
      const float* cr = cpow + (size_t)t * S;
      for (int s = 0; s < S; ++s) y = fmaf(__ldg(cr + s), sp[s * FCT + cc], y);
      for (int j = 0; j <= t; ++j) y = fmaf(hs[t - j], up[j * FCT + cc], y);
    }
    ys[r * FCT + cc] = y * y;
  }
  __syncthreads();
  if (c >= C) return;
  for (int i = rg; i < P; i += FRG) {
    const int base = starts[i] - (Ls - tail);
    float sum = 0.f;
    for (int w = 0; w < win; ++w) sum += ys[(base + w) * FCT + cc];
    F[((size_t)k * P + i) * C + c] = logf(sum + 0.01f);
  }
}

// mel[j] = smoothM^T med_slot[first argmax_kk score(j, kk, b), b]
__global__ void epilogue_kernel(const float* __restrict__ F, const float* __restrict__ W5,
                                const float* __restrict__ bm, const float* __restrict__ med,
                                const float* __restrict__ smoothM, float* __restrict__ mel,
                                int n_rows, int C, int B, int M, int step) {
  extern __shared__ float smem[];
  const int KB = KS * B;
  const int depth = (M - 1) * step;
  float* ws = smem;                        // (M, ECK, KB) W5 chunk
  float* fs = ws + M * ECK * KB;           // (EF + depth, ECK) feature chunk
  float* ds = fs + (EF + depth) * ECK;     // (EF, B) dequantized values
  float* sms = ds + EF * B;                // (B, B) smoothing matrix
  const int row0 = blockIdx.x * EF;
  const int tid = threadIdx.x;
  const int b = tid % B, fg = tid / B;
  for (int idx = tid; idx < B * B; idx += blockDim.x) sms[idx] = smoothM[idx];
  float acc[EFG][KS];
#pragma unroll
  for (int i = 0; i < EFG; ++i)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) acc[i][kk] = 0.f;
  for (int c0 = 0; c0 < C; c0 += ECK) {
    __syncthreads();
    for (int idx = tid; idx < M * ECK * KB; idx += blockDim.x) {
      const int m = idx / (ECK * KB), rem = idx % (ECK * KB);
      const int ci = c0 + rem / KB, col = rem % KB;
      ws[idx] = ci < C ? W5[((size_t)m * C + ci) * KB + col] : 0.f;
    }
    for (int idx = tid; idx < (EF + depth) * ECK; idx += blockDim.x) {
      const int row = row0 - depth + idx / ECK, ci = c0 + idx % ECK;
      fs[idx] = (row >= 0 && row < n_rows && ci < C) ? F[(size_t)row * C + ci] : 0.f;
    }
    __syncthreads();
    for (int m = 0; m < M; ++m) {
      for (int cc = 0; cc < ECK; ++cc) {
        float a[EFG], w[KS];
#pragma unroll
        for (int i = 0; i < EFG; ++i) a[i] = fs[(fg * EFG + i + m * step) * ECK + cc];
        const float* wr = ws + (m * ECK + cc) * KB + b;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) w[kk] = wr[kk * B];
#pragma unroll
        for (int i = 0; i < EFG; ++i)
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) acc[i][kk] = fmaf(a[i], w[kk], acc[i][kk]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < EFG; ++i) {
    float best = acc[i][0] + bm[b];
    int bi = 0;
#pragma unroll
    for (int kk = 1; kk < KS; ++kk) {
      const float v = acc[i][kk] + bm[kk * B + b];
      if (v > best) { best = v; bi = kk; }  // strict: ties keep the first slot
    }
    ds[(fg * EFG + i) * B + b] = med[bi * B + b];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < EFG; ++i) {
    const int r = fg * EFG + i;
    float o = 0.f;
    for (int bb = 0; bb < B; ++bb) o = fmaf(ds[r * B + bb], sms[bb * B + b], o);
    if (row0 + r < n_rows) mel[(size_t)(row0 + r) * B + b] = o;
  }
}

// Launches 1-3: F (Kp*P, C) from u (Kp*Ls, C); q and sb are scratch.
cudaError_t launch_logpower(const float* u, const float* s0, const float* pmatT, const float* aT,
                            const float* h, const float* cpow, const float* prefix,
                            const int* starts, float* q, float* sb, float* F, int Kp, int Ls,
                            int S, int C, int P, int win, int tail, cudaStream_t stream) {
  cudaError_t err;
  const size_t q_smem = (size_t)Ls * (QCT + S) * sizeof(float);
  cudaFuncSetAttribute(period_inputs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem);
  period_inputs_kernel<<<dim3(Kp, (C + QCT - 1) / QCT), QCT * QSG, q_smem, stream>>>(
      u, pmatT, q, Ls, S, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t s_smem = (size_t)(S * S + 2 * S * SCT) * sizeof(float);
  boundary_scan_kernel<<<(C + SCT - 1) / SCT, S * SCT, s_smem, stream>>>(q, s0, aT, sb, Kp, S, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t f_smem = (size_t)(Ls + 2 * Ls * FCT + (tail + Ls) * FCT + 2 * S * FCT) * sizeof(float);
  cudaFuncSetAttribute(features_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)f_smem);
  features_kernel<<<dim3(Kp, (C + FCT - 1) / FCT), FCT * FRG, f_smem, stream>>>(
      u, sb, h, cpow, prefix, starts, F, Ls, S, C, P, win, tail);
  return cudaGetLastError();
}

}  // namespace

extern "C" int frontend_logpower(
    const float* u, const float* s0, const float* pmatT, const float* aT, const float* h,
    const float* cpow, const float* prefix, const int* starts, float* q, float* sb, float* F,
    int Kp, int Ls, int S, int C, int P, int win, int tail, cudaStream_t stream) {
  return (int)launch_logpower(u, s0, pmatT, aT, h, cpow, prefix, starts, q, sb, F, Kp, Ls, S, C,
                              P, win, tail, stream);
}

extern "C" int frontend_decode_mels(
    const float* u, const float* s0, const float* pmatT, const float* aT, const float* h,
    const float* cpow, const float* prefix, const int* starts, const float* W5, const float* bm,
    const float* med, const float* smoothM, float* q, float* sb, float* F, float* mel,
    int Kp, int Ls, int S, int C, int P, int win, int tail, int B, int M, int step,
    cudaStream_t stream) {
  cudaError_t err = launch_logpower(u, s0, pmatT, aT, h, cpow, prefix, starts, q, sb, F, Kp, Ls,
                                    S, C, P, win, tail, stream);
  if (err != cudaSuccess) return (int)err;
  const int n_rows = Kp * P;
  const int depth = (M - 1) * step;
  const size_t e_smem =
      (size_t)(M * ECK * KS * B + (EF + depth) * ECK + EF * B + B * B) * sizeof(float);
  cudaFuncSetAttribute(epilogue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)e_smem);
  epilogue_kernel<<<(n_rows + EF - 1) / EF, B * (EF / EFG), e_smem, stream>>>(
      F, W5, bm, med, smoothM, mel, n_rows, C, B, M, step);
  return (int)cudaGetLastError();
}
