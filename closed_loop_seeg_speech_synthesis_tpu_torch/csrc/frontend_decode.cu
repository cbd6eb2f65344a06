// Replay front end, two entry points, sm_90a.
//   frontend_decode_mels: raw sEEG (T, C) -> dequantized, smoothed logMel
//     frames (n_frames, B); launches 1-4 below.
//     Replaces closed_loop_seeg_speech_synthesis_tpu/ops/pallas_frontend.py:195
//     _make_decode_kernel (entry frontend_decode_mels).
//   frontend_logpower: raw sEEG (T, C) -> log-power features (n_frames, C),
//     the split front end; launches 1-3 below, the same code.
//     Replaces closed_loop_seeg_speech_synthesis_tpu/ops/pallas_frontend.py:94
//     _frontend_kernel (entry frontend_logpower).
//
// Work per period of Ls samples (Kp periods; 7,200 at 30 min / 1024 Hz,
// Ls = 256) and channel: y_k = Tmat u_k + Cpow s_k (the causal Toeplitz
// product, Ls (Ls + 1) / 2 FMAs, and S Ls), s_{k+1} = A_L s_k + Pmat u_k (S Ls
// and S^2), then log(window sum of [y_{k-1}; y_k]^2 + 0.01) for the period's
// P frames; K1 adds the LDA scores (5 taps x C x 9 B per frame), the
// first-max over the 9 class slots, the median select and the (B, B)
// smoothing.  At 128 channels that is ~94 G FMA against 0.94 GB of sEEG read
// once: arithmetic bounds it.  The products (~94% of the FMAs) run on the
// tensor cores in 3xTF32 (tf32_mma.cuh: fp32 accuracy at a third of the TF32
// rate, 495/3 TFLOP/s); at that rate and with the rest in fp32 FMA the bound
// is ~1.25 ms for K1 and ~0.75 ms for K3 (chip_smoke.frontend_bound).
// Besides that, the boundary recurrence is sequential over the periods.
//
// Launches:
//   1. chunk_scan: one CTA per chunk of R consecutive periods (R =
//      ceil(sqrt(Kp)) up to 64, cuda_frontend.scan_chunk: 64 at 30 min) and
//      128 channels.  Each warp scans 8 channels on its own (no CTA barrier
//      in the loop): l_{k+1} = Pmat u_k + A_L l_k from l = 0 as one
//      accumulation on the tensor cores (Pmat and A_L staged once per CTA;
//      the warp's u columns streamed through its own 3-stage cp.async ring),
//      writing l_k, the chunk-local state before each period, and the
//      chunk's end state.  R serial steps.
//   2. carry_scan: the only other serial part, over the Kp / R chunks (113
//      at 30 min): S_{c+1} = A_L^R S_c + (end state of chunk c) from s_0, in
//      fp32; ceil(Kp / R) - 1 steps.  So R + ceil(Kp / R) - 1 serial steps
//      (176 at 30 min) instead of the Kp (7,200) of a sequential scan.
//   3. features: one CTA (16 warps) per run of 16 periods and a 32-channel
//      tile (16 at Ls = 512, for shared memory).  Per period the fix-up s_k =
//      A_L^i S_c + l_k (i = k - cR; the power table A_L^0..A_L^R is built on
//      the host in float64) on the tensor cores, then y_k: the Toeplitz A
//      operand comes from h = Tmat[:, 0] (tile (i, kk) holds h[16i - 8kk +
//      r - c]; Tmat is never read), split hi/lo on the host, the all-zero
//      tiles above the diagonal skipped (~47% of the dense product); each
//      warp takes an m-tile pair (j, Ls/16 - 1 - j) of equal work, whose two
//      tiles share every B fragment, and 2 of the tile's n-tiles; Cpow s_k
//      joins the same accumulators (Cpow staged once per CTA).  y_k^2 stays
//      in shared memory, so the last `tail` rows of y_{k-1} that the windows
//      reach back into are recomputed only for the run's first period
//      (period 0 reads the zero-fill prefix).  The window sums and the log
//      are fp32.  The next period's u tile, A_L^i and l_k are copied with
//      cp.async while the window sums run.  (Writing Y0 = Tmat u to device
//      memory and adding Cpow s_k in a second pass was not taken: it moves
//      ~1.9 GB more, ~0.56 ms at 3.35 TB/s, to save a tail recompute that
//      is ~2% of the Toeplitz work at 16 periods a run.)
//   4. lda_epilogue: one CTA per 64 frames.  Scores (64, 9 B) = sum over the
//      5 taps of F[rows shifted by m * step] (64, C) x W5_m (C, 9 B) on the
//      tensor cores: the A fragments are row-shifted loads from one staged
//      (64 + 20, 128) slab of F's channels at a time (one slab at up to 128
//      channels; so any C fits); W5's hi/lo split is packed once per call on
//      the host in fragment order, slab by slab
//      (cuda_frontend.pack_lda_weights), and each
//      warp streams its 6 n-tiles of k-slabs from L2 through a 4-stage
//      cp.async ring, as gl_mma_kernel (gl_audio.cu) streams its DFT
//      matrices.  Then the first-max over the 9 slots (strict >: ties keep
//      the first slot; bm holds -1e30 on invalid slots), the median select
//      and the smoothing, in fp32.
// Between launches 3 and 4 the (Kp P, C) features pass through device memory
// (92 MB at 30 min / 128 ch).  What holds the launches back on an H100
// (PERF.md; clock64 phases from frontend_kernel_probe.py): the rate at which
// the products issue mma.sync, not bytes.  In features the product phase
// runs at about a quarter of an m16n8k8 a cycle per SM, and the fix-up and
// the windows leave the tensor cores idle for a quarter of each period (one
// CTA an SM); chunk_scan's 16 warps, one n-tile each, reach about a sixth.
// Any period length Ls up to 2048 works: launch 1 zero-fills a period's last,
// ragged slab of u, launch 3 rounds Ls up to whole m-tiles with zero rows.
// Periods over 512 samples (4096 and 8192 Hz) do not fit shared memory as
// above, so what grows with Ls is streamed: launch 1 reads Pmat's A
// fragments through L1 in place of staging Pmat, and launch 3 runs as
// features_slab_kernel, which computes y_k in slabs of YROWS rows (u staged
// in k-slabs of UROWS rows, Cpow's A fragments read through L1) and keeps
// y^2 in a ring of YROWS + max(tail, win) rows, summing each window once the
// slab that holds its last row is written.  Periods up to 512 samples take
// the single-slab kernels unchanged.
// Every C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int MAX_S = 64;        // filter states the kernels take
constexpr int US_PAD = 8;        // u tile row stride CT + 8: B fragment loads hit 32 banks
constexpr int QWARPS = 16;       // launch 1: one n-tile of 8 channels per warp
constexpr int QCT = 8 * QWARPS;  // channels per CTA, launch 1
constexpr int QSLAB = 8;         // k-steps (64 rows of u) per ring stage, launch 1
constexpr int QSTAGES = 3;       // ring depth per warp, launch 1 (226.5 KB at Ls = 512)
constexpr int MAX_MT = MAX_S / 16;
constexpr int SCT = 4;           // channels per CTA, launch 2
constexpr int FWARPS = 16;       // launch 3
constexpr int FTHREADS = 32 * FWARPS;
constexpr int FRUN = 16;         // periods per CTA, launch 3
constexpr int HPAD = 16;         // zeros before h[0] in shared memory
constexpr int YROWS = 256;       // rows of y a slab, features_slab_kernel (16 m-tiles)
constexpr int UROWS = 64;        // rows of u a staged k-slab, features_slab_kernel
constexpr int EF = 64;           // frames per CTA, launch 4
constexpr int EMT = EF / 16;
constexpr int EWARPS = 16;
constexpr int ENT = 3;           // n-tiles of 8 score columns per warp and pass
constexpr int EPASS = EWARPS * ENT * 8;  // score columns per pass (384 >= 9 x 40)
constexpr int ESC = EPASS + 4;   // score row stride
constexpr int KS = 9;            // class slots per mel bin
constexpr int ECK = 128;         // channels of F staged at a time, launch 4
constexpr int ESCORES = EF * ESC;

// Launch 4's ring (ESTAGES k-slabs per warp) and the scores over it, floats
__host__ __device__ constexpr int epilogue_region(int ESTAGES) {
  return EWARPS * ESTAGES * ENT * 32 * 4 > ESCORES ? EWARPS * ESTAGES * ENT * 32 * 4 : ESCORES;
}

// dst[r * ds + c] = src[(row0 + r) * C + c0 + c] for r < rows, c < CT (0 past
// C): 16-byte cp.async copies when vec (rows 16-byte aligned, the tile inside
// C), else plain loads.  The caller commits the group, waits and syncs.
template <int CT>
__device__ __forceinline__ void load_tile(float* dst, int ds, const float* __restrict__ src,
                                          size_t row0, int rows, int C, int c0, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < rows * (CT / 4); i += blockDim.x) {
      const int r = i / (CT / 4), c = 4 * (i % (CT / 4));
      cp_async16(dst + r * ds + c, src + (row0 + r) * C + c0 + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * CT; i += blockDim.x) {
      const int r = i / CT, c = i % CT;
      dst[r * ds + c] = c0 + c < C ? __ldg(src + (row0 + r) * C + c0 + c) : 0.f;
    }
  }
}

__device__ __forceinline__ bool tile_vec(const float* u, int C, int c0, int CT) {
  return C % 4 == 0 && c0 + CT <= C && reinterpret_cast<uintptr_t>(u) % 16 == 0;
}

// Launch 1.  L[k] = chunk-local state before period k (0 at the chunk's
// start), lend[chunk] = the state after its last period; apow[1] = A_L.
// Warp w scans channels c0 + [8w, 8w + 8) on its own (its n-tile, every
// m-tile of states), its u columns streamed through its own cp.async ring of
// QSLAB k-steps a stage, its state l in its own shared memory.  PSMEM: Pmat
// staged in shared memory (periods up to 512 samples), else its A fragments
// are read through L1 (longer periods, whose Pmat does not fit beside the rings).
template <bool PSMEM>
__global__ void __launch_bounds__(QWARPS * 32, 1) chunk_scan_kernel(
    const float* __restrict__ u, const float* __restrict__ pmat, const float* __restrict__ apow,
    float* __restrict__ L, float* __restrict__ lend, int Kp, int Ls, int S, int C, int R) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RING = QSTAGES * QSLAB * 8 * 8;  // floats per warp: (stage, 8 QSLAB rows, 8 ch)
  const int SM = (S + 15) / 16 * 16;  // states padded to m-tiles
  const int S8 = (S + 7) / 8 * 8;
  const int nsl = (Ls + 8 * QSLAB - 1) / (8 * QSLAB);  // slabs a period, the last one ragged
  const int PS = nsl * 8 * QSLAB + 4;  // Pmat row stride: A fragment loads hit 32 banks
  const int AS = S8 + 4;              // A_L row stride, the same
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  float* pm = smem;                               // (SM, PS) Pmat, zeros past S (PSMEM)
  float* al = pm + (PSMEM ? SM * PS : 0);         // (SM, AS) A_L, zeros past S
  float* ring = al + SM * AS + warp * (RING + S8 * 8);  // this warp's u ring
  float* lw = ring + RING;                        // (S8, 8) this warp's local state
  const int chunk = blockIdx.x, cw = blockIdx.y * QCT + 8 * warp;
  const int k0 = chunk * R, k1 = min(Kp, k0 + R);
  // Pmat[s][j], 0 past S and Ls
  auto pmat_at = [&](int s, int j) { return (s < S && j < Ls) ? __ldg(pmat + s * Ls + j) : 0.f; };
  if (PSMEM)
    for (int i = t; i < SM * PS; i += blockDim.x) pm[i] = pmat_at(i / PS, i % PS);
  for (int i = t; i < SM * AS; i += blockDim.x) {
    const int s = i / AS, j = i % AS;
    al[i] = (s < S && j < S) ? apow[S * S + s * S + j] : 0.f;
  }
  __syncthreads();
  if (cw >= C) return;  // no channel of this warp; nothing below syncs the CTA
  for (int i = lane; i < S8 * 8; i += 32) lw[i] = 0.f;
  const bool vec = C % 4 == 0 && cw + 8 <= C && reinterpret_cast<uintptr_t>(u) % 16 == 0;
  const int nf = (k1 - k0) * nsl;          // slabs of the chunk
  // slab f: rows [8 QSLAB (f % nsl), +8 QSLAB) of period k0 + f / nsl, into stage f % QSTAGES;
  // rows past the period's Ls are zeros (Pmat's columns there are zeros too)
  auto issue = [&](int f) {
    if (f < nf) {
      float* dst = ring + (f % QSTAGES) * QSLAB * 64;
      const int r0 = (f % nsl) * 8 * QSLAB, rows = min(8 * QSLAB, Ls - r0);
      const size_t row0 = (size_t)(k0 + f / nsl) * Ls + r0;
      if (vec) {
        for (int i = lane; i < QSLAB * 16; i += 32) {
          if (i / 2 < rows)
            cp_async16(dst + 4 * i, u + (row0 + i / 2) * C + cw + 4 * (i % 2));
          else
            *reinterpret_cast<float4*>(dst + 4 * i) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        for (int i = lane; i < QSLAB * 64; i += 32) {
          const int c = cw + i % 8;
          dst[i] = (c < C && i / 8 < rows) ? __ldg(u + (row0 + i / 8) * C + c) : 0.f;
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < QSTAGES - 1; ++s) issue(s);
  int f = 0;
  for (int k = k0; k < k1; ++k) {
    float acc[MAX_MT][4];
#pragma unroll
    for (int mt = 0; mt < MAX_MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][j] = 0.f;
    for (int j = 0; j < nsl; ++j, ++f) {
      cp_async_wait<QSTAGES - 2>();
      __syncwarp();  // slab f landed for every lane; slab f - 1 read by every lane
      issue(f + QSTAGES - 1);
      const float* rs = ring + (f % QSTAGES) * QSLAB * 64;
#pragma unroll 2
      for (int kk = 0; kk < QSLAB; ++kk) {  // q_k = Pmat u_k
        uint32_t bh0, bl0, bh1, bl1;
        tf32_split(rs[(8 * kk + q4) * 8 + g], bh0, bl0);
        tf32_split(rs[(8 * kk + q4 + 4) * 8 + g], bh1, bl1);
        const int col = 8 * (QSLAB * j + kk) + q4;
#pragma unroll
        for (int mt = 0; mt < MAX_MT; ++mt) {
          if (16 * mt >= SM) continue;
          float v[4];
          if (PSMEM) {
            const float* ar = pm + (16 * mt + g) * PS + col;
            v[0] = ar[0], v[1] = ar[8 * PS], v[2] = ar[4], v[3] = ar[8 * PS + 4];
          } else {
            const int s = 16 * mt + g;
            v[0] = pmat_at(s, col), v[1] = pmat_at(s + 8, col);
            v[2] = pmat_at(s, col + 4), v[3] = pmat_at(s + 8, col + 4);
          }
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) tf32_split(v[i], ahi[i], alo[i]);
          mma3(acc[mt], ahi, alo, bh0, bh1, bl0, bl1);
        }
      }
    }
    for (int ks = 0; ks < S8 / 8; ++ks) {  // + A_L l_k
      uint32_t bh0, bl0, bh1, bl1;
      tf32_split(lw[(8 * ks + q4) * 8 + g], bh0, bl0);
      tf32_split(lw[(8 * ks + q4 + 4) * 8 + g], bh1, bl1);
#pragma unroll
      for (int mt = 0; mt < MAX_MT; ++mt) {
        if (16 * mt >= SM) continue;
        const float* ar = al + (16 * mt + g) * AS + 8 * ks + q4;
        const float v[4] = {ar[0], ar[8 * AS], ar[4], ar[8 * AS + 4]};
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) tf32_split(v[i], ahi[i], alo[i]);
        mma3(acc[mt], ahi, alo, bh0, bh1, bl0, bl1);
      }
    }
    for (int i = lane; i < S * 8; i += 32)
      if (cw + i % 8 < C) L[((size_t)k * S + i / 8) * C + cw + i % 8] = lw[i];
    __syncwarp();  // l_k read
#pragma unroll
    for (int mt = 0; mt < MAX_MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = 16 * mt + g + 8 * (j >> 1);
        if (s < S) lw[s * 8 + 2 * q4 + (j & 1)] = acc[mt][j];
      }
    __syncwarp();  // l_{k+1} written
  }
  for (int i = lane; i < S * 8; i += 32)
    if (cw + i % 8 < C) lend[((size_t)chunk * S + i / 8) * C + cw + i % 8] = lw[i];
}

// Launch 2.  sb[k] = state before step k, k < K: s_0 = s0, s_{k+1} = A s_k +
// q_k, A row-major; K - 1 sequential steps, parallel over (state row, channel).
__global__ void carry_scan_kernel(const float* __restrict__ q, const float* __restrict__ s0,
                                  const float* __restrict__ A, float* __restrict__ sb, int K,
                                  int S, int C) {
  extern __shared__ float smem[];
  float* at = smem;          // (S, S): at[t*S + s] = A[s][t]
  float* st = at + S * S;    // 2 x (S, SCT) double buffer
  const int tid = threadIdx.x;
  const int s = tid % S, cl = tid / S;
  const int c = blockIdx.x * SCT + cl;
  const bool active = c < C;
  for (int idx = tid; idx < S * S; idx += blockDim.x) at[idx] = A[(idx % S) * S + idx / S];
  st[s * SCT + cl] = active ? s0[s * C + c] : 0.f;
  __syncthreads();
  int cur = 0;
  float qn = (active && K > 0) ? q[(size_t)s * C + c] : 0.f;
  for (int k = 0; k < K; ++k) {
    const float qk = qn;
    if (active && k + 1 < K) qn = q[((size_t)(k + 1) * S + s) * C + c];
    const float* sc = st + cur * S * SCT;
    if (active) sb[((size_t)k * S + s) * C + c] = sc[s * SCT + cl];
    if (k + 1 == K) break;  // the state after the last step is not needed
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

// Shared memory of launch 3 (floats) for CT channels a CTA; L16 = Ls rounded
// up to whole m-tiles of 16 rows.
__host__ __device__ constexpr int features_smem_floats(int CT, int L16, int S, int tail) {
  return L16 * (CT + US_PAD)                         // us
         + L16 * ((S + 7) / 8 * 8 + 4)               // cps
         + (tail + L16) * CT                         // ys
         + 2 * (HPAD + L16)                          // hh, hl
         + 2 * ((S + 7) / 8 * 8) * (CT + US_PAD)     // ss, scs
         + (S + 15) / 16 * 16 * ((S + 7) / 8 * 8 + 4)  // ais
         + S * CT;                                   // lsm
}

// Launch 3.  F[k*P + i][c] = log(sum over window i of span^2 + 0.01), span =
// [y_{k-1}, y_k], y_k = Tmat u_k + Cpow s_k, s_k = L[k] + A_L^(k - cR) Sc[c].
// The inputs of period k + 1 (its u tile, power A_L^i and chunk-local state)
// are copied with cp.async while period k's windows run.
template <int CT>
__global__ void __launch_bounds__(FTHREADS, 1) features_kernel(
    const float* __restrict__ u, const float* __restrict__ L, const float* __restrict__ Sc,
    const float* __restrict__ apow, const float* __restrict__ hpk, const float* __restrict__ cpow,
    const float* __restrict__ prefix, const int* __restrict__ starts, float* __restrict__ F,
    int Kp, int Ls, int S, int C, int P, int win, int tail, int R) {
  constexpr int NT = CT / 8;
  constexpr int NSPLIT = NT / 2;         // warps a pair of m-tiles: 2 n-tiles each
  constexpr int US = CT + US_PAD;
  extern __shared__ __align__(16) float smem[];
  const int S8 = (S + 7) / 8 * 8, SM = (S + 15) / 16 * 16;
  const int CS = S8 + 4;                // Cpow and A_L^i row stride: A fragment loads hit 32 banks
  const int L16 = (Ls + 15) / 16 * 16;  // rows of y computed: whole m-tiles, those past Ls unread
  float* us = smem;                     // (L16, US) u tile, zero rows past Ls
  float* cps = us + L16 * US;           // (L16, CS) Cpow, zeros past S and Ls
  float* ys = cps + L16 * CS;           // (tail + L16, CT) y^2 over span [Ls - tail, 2 Ls)
  float* hh = ys + (tail + L16) * CT;   // (HPAD + L16) tf32 hi of h, zeros before h[0] and past Ls
  float* hl = hh + HPAD + L16;          // (HPAD + L16) lo
  float* ss = hl + HPAD + L16;          // (S8, US) state before the period, zero rows past S
  float* scs = ss + S8 * US;            // (S8, US) state before the period's scan chunk
  float* ais = scs + S8 * US;           // (SM, CS) A_L^i, zeros past S
  float* lsm = ais + SM * CS;           // (S, CT) chunk-local state before the period
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int c0 = blockIdx.y * CT;
  const int k0 = blockIdx.x * FRUN, k1 = min(Kp, k0 + FRUN);
  const int NM = L16 / 16, NK = (Ls + 7) / 8;  // m-tiles, k-steps (zero rows past Ls)
  const bool vec = tile_vec(u, C, c0, CT);
  const bool avec = S % 4 == 0 && reinterpret_cast<uintptr_t>(apow) % 16 == 0;
  const bool lvec = vec && reinterpret_cast<uintptr_t>(L) % 16 == 0;
  // u_k, A_L^(k - cR) and L[k] into shared memory; the caller commits
  auto prefetch = [&](int k) {
    load_tile<CT>(us, US, u, (size_t)k * Ls, Ls, C, c0, vec);
    load_tile<CT>(lsm, CT, L, (size_t)k * S, S, C, c0, lvec);
    const float* Ai = apow + (size_t)(k % R) * S * S;
    if (avec) {
      for (int i = t; i < S * S / 4; i += FTHREADS)
        cp_async16(ais + (4 * i / S) * CS + 4 * i % S, Ai + 4 * i);
    } else {
      for (int i = t; i < S * S; i += FTHREADS) ais[(i / S) * CS + i % S] = Ai[i];
    }
  };
  const int kfirst = k0 > 0 ? k0 - 1 : 0;  // the run's first period recomputes y_{k0-1}'s tail
  for (int i = t; i < SM * CS; i += FTHREADS) ais[i] = 0.f;
  for (int i = t; i < 2 * S8 * US; i += FTHREADS) ss[i] = 0.f;  // ss and scs
  for (int i = Ls * US + t; i < L16 * US; i += FTHREADS) us[i] = 0.f;
  __syncthreads();
  prefetch(kfirst);
  cp_async_commit();
  for (int i = t; i < L16 * CS; i += FTHREADS) {
    const int j = i % CS, r = i / CS;
    cps[i] = (j < S && r < Ls) ? cpow[r * S + j] : 0.f;
  }
  for (int i = t; i < HPAD + L16; i += FTHREADS) {
    const bool in = i >= HPAD && i < HPAD + Ls;
    hh[i] = in ? hpk[i - HPAD] : 0.f;
    hl[i] = in ? hpk[Ls + i - HPAD] : 0.f;
  }
  if (k0 == 0)
    for (int i = t; i < tail * CT; i += FTHREADS) {
      const float y = prefix[Ls - tail + i / CT];
      ys[i] = y * y;
    }
  int chunk = -1;
  for (int k = kfirst; k < k1; ++k) {
    const bool pre = k < k0;  // y_{k0-1}: only the rows the windows reach
    const int kc = k / R;
    if (kc != chunk) {  // the previous fix-up's reads of scs precede the last barrier
      chunk = kc;
      for (int i = t; i < S * CT; i += FTHREADS) {
        const int cc = c0 + i % CT;
        scs[(i / CT) * US + i % CT] = cc < C ? Sc[((size_t)kc * S + i / CT) * C + cc] : 0.f;
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // u_k, A_L^i, L[k] and scs in shared memory
    // fix-up on the tensor cores: s_k = A_L^i S_kc + L[k], one (16, 8) tile a warp
    for (int tile = warp; tile < (SM / 16) * NT; tile += FWARPS) {
      const int mt = tile / NT, nt = tile % NT;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int ks = 0; ks < S8 / 8; ++ks) {
        const float* ar = ais + (16 * mt + g) * CS + 8 * ks + q4;
        const float v[4] = {ar[0], ar[8 * CS], ar[4], ar[8 * CS + 4]};
        uint32_t ahi[4], alo[4], bh0, bl0, bh1, bl1;
#pragma unroll
        for (int j = 0; j < 4; ++j) tf32_split(v[j], ahi[j], alo[j]);
        const float* br = scs + (8 * ks + q4) * US + 8 * nt + g;
        tf32_split(br[0], bh0, bl0);
        tf32_split(br[4 * US], bh1, bl1);
        mma3(acc, ahi, alo, bh0, bh1, bl0, bl1);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = 16 * mt + g + 8 * (j >> 1), col = 8 * nt + 2 * q4 + (j & 1);
        if (s < S) ss[s * US + col] = c0 + col < C ? acc[j] + lsm[s * CT + col] : 0.f;
      }
    }
    __syncthreads();  // s_k written
    // y_k: warp w takes n-tiles [2 (w % NSPLIT), +2) of the m-tile pairs
    // (ma, mb) = (j, NM - 1 - j), j = w / NSPLIT, w / NSPLIT + FWARPS / NSPLIT, ...;
    // the k-steps of ma are a prefix of mb's, so both share each B fragment
    const int mt_lo = pre ? (Ls - tail) / 16 : 0;
    const int ybase = tail - (pre ? Ls : 0);  // span row of y_k row 0
    const int n0 = 16 * (warp % NSPLIT);      // first column of the warp's two n-tiles
    for (int jp = warp / NSPLIT; 2 * jp < NM; jp += FWARPS / NSPLIT) {
      const int mtile[2] = {jp, NM - 1 - jp};
      const bool on[2] = {jp >= mt_lo, mtile[1] > jp && mtile[1] >= mt_lo};
      if (!on[0] && !on[1]) continue;
      float acc[2][2][4];
#pragma unroll
      for (int side = 0; side < 2; ++side)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[side][nt][j] = 0.f;
      // Toeplitz: tile (mt, kk) = h[16 mt - 8 kk + r - c]; tiles past the diagonal are 0.
      // With d = 16 mt - 8 kk + g - q the fragment is h[d, d + 8, d - 4, d + 4]: k-step
      // kk + 1 reuses h[d] and h[d - 4] as its second and fourth values (nx)
      const int na = min(2 * mtile[0] + 2, NK);
      const int nk = on[1] ? min(2 * mtile[1] + 2, NK) : na;
      uint32_t nx[2][4];  // (hi, lo) of the next k-step's h[d + 8], h[d + 4]
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const int d = HPAD + 16 * mtile[side] + g - q4;
        nx[side][0] = __float_as_uint(hh[d + 8]);
        nx[side][1] = __float_as_uint(hl[d + 8]);
        nx[side][2] = __float_as_uint(hh[d + 4]);
        nx[side][3] = __float_as_uint(hl[d + 4]);
      }
#pragma unroll 4
      for (int kk = 0; kk < nk; ++kk) {
        uint32_t bh[2][2], bl[2][2];
        const float* br = us + (8 * kk + q4) * US + n0 + g;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          tf32_split(br[8 * nt], bh[nt][0], bl[nt][0]);
          tf32_split(br[4 * US + 8 * nt], bh[nt][1], bl[nt][1]);
        }
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          if (!on[side] || (side == 0 && kk >= na)) continue;
          const int d = HPAD + 16 * mtile[side] - 8 * kk + g - q4;
          const uint32_t ahi[4] = {__float_as_uint(hh[d]), nx[side][0], __float_as_uint(hh[d - 4]),
                                   nx[side][2]};
          const uint32_t alo[4] = {__float_as_uint(hl[d]), nx[side][1], __float_as_uint(hl[d - 4]),
                                   nx[side][3]};
          nx[side][0] = ahi[0];
          nx[side][1] = alo[0];
          nx[side][2] = ahi[2];
          nx[side][3] = alo[2];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            mma3(acc[side][nt], ahi, alo, bh[nt][0], bh[nt][1], bl[nt][0], bl[nt][1]);
        }
      }
      // Cpow s_k into the same accumulators
      for (int ks = 0; ks < S8 / 8; ++ks) {
        uint32_t bh[2][2], bl[2][2];
        const float* br = ss + (8 * ks + q4) * US + n0 + g;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          tf32_split(br[8 * nt], bh[nt][0], bl[nt][0]);
          tf32_split(br[4 * US + 8 * nt], bh[nt][1], bl[nt][1]);
        }
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          if (!on[side]) continue;
          const float* ar = cps + (16 * mtile[side] + g) * CS + 8 * ks + q4;
          const float v[4] = {ar[0], ar[8 * CS], ar[4], ar[8 * CS + 4]};
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) tf32_split(v[j], ahi[j], alo[j]);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            mma3(acc[side][nt], ahi, alo, bh[nt][0], bh[nt][1], bl[nt][0], bl[nt][1]);
        }
      }
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        if (!on[side]) continue;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int row = ybase + 16 * mtile[side] + g + 8 * (j >> 1);
            if (row >= 0)
              ys[row * CT + n0 + 8 * nt + 2 * q4 + (j & 1)] = acc[side][nt][j] * acc[side][nt][j];
          }
      }
    }
    __syncthreads();  // ys written; u_k, A_L^i, L[k] and s_k read
    if (k + 1 < k1) prefetch(k + 1);
    cp_async_commit();
    if (!pre) {
      for (int i = t; i < P * CT; i += FTHREADS) {
        const int fi = i / CT, cc = i % CT, c = c0 + cc;
        if (c >= C) continue;
        const float* yr = ys + (starts[fi] - (Ls - tail)) * CT + cc;
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
        int w = 0;
        for (; w + 3 < win; w += 4) {
          s0 += yr[w * CT];
          s1 += yr[(w + 1) * CT];
          s2 += yr[(w + 2) * CT];
          s3 += yr[(w + 3) * CT];
        }
        for (; w < win; ++w) s0 += yr[w * CT];
        F[((size_t)k * P + fi) * C + c] = logf(((s0 + s1) + (s2 + s3)) + 0.01f);
      }
      __syncthreads();  // windows read
      for (int i = t; i < tail * CT; i += FTHREADS) ys[i] = ys[Ls * CT + i];  // y_k's tail
    }
  }
}

// Shared memory of features_slab_kernel (floats), 16 channels a CTA; H rows
// of y^2 in the ring.
__host__ __device__ constexpr int features_slab_smem_floats(int L16, int S, int H) {
  return 2 * UROWS * (16 + US_PAD)                   // us: two k-slabs of u
         + 2 * (HPAD + L16)                          // hh, hl
         + H * 16                                    // yr
         + 2 * ((S + 7) / 8 * 8) * (16 + US_PAD)     // ss, scs
         + (S + 15) / 16 * 16 * ((S + 7) / 8 * 8 + 4)  // ais
         + S * 16;                                   // lsm
}

// Launch 3 at periods too long for features_kernel's shared memory (Ls >
// 512): the same F.  One CTA (16 warps) per run of FRUN periods and 16
// channels.  Per period the fix-up s_k = A_L^i S_c + L[k] as in
// features_kernel, then y_k in slabs of YROWS rows (16 m-tiles): warp w takes
// n-tile w % 2 and the m-tile pair (j, 15 - j), j = w / 2, of equal work in
// each slab, the pair sharing every B fragment; u's rows [0, slab end) are
// staged UROWS at a time (two buffers, cp.async), the Toeplitz A fragments
// come from h's hi/lo split (the zero tiles above the diagonal skipped) and
// Cpow's through L1.  y^2 goes to a ring of H = YROWS + max(tail, win) rows:
// row r of y_k sits at ring row ((k - k0 + 1) Ls + r) % H, so span row p of
// period k is ring row ((k - k0) Ls + p) % H.  After each slab the windows
// whose last row it wrote are summed (in features_kernel's order); the
// oldest row such a window reads is at most H - YROWS rows before the slab.
// The run's first period recomputes only the rows of y_{k0-1} the windows
// reach (or reads the zero-fill prefix at k0 = 0).
__global__ void __launch_bounds__(FTHREADS, 1) features_slab_kernel(
    const float* __restrict__ u, const float* __restrict__ L, const float* __restrict__ Sc,
    const float* __restrict__ apow, const float* __restrict__ hpk, const float* __restrict__ cpow,
    const float* __restrict__ prefix, const int* __restrict__ starts, float* __restrict__ F,
    int Kp, int Ls, int S, int C, int P, int win, int tail, int R, int H) {
  constexpr int CT = 16, US = CT + US_PAD;
  extern __shared__ __align__(16) float smem[];
  const int S8 = (S + 7) / 8 * 8, SM = (S + 15) / 16 * 16;
  const int CS = S8 + 4;                 // A_L^i row stride: A fragment loads hit 32 banks
  const int L16 = (Ls + 15) / 16 * 16;
  float* us = smem;                      // (2, UROWS, US) k-slabs of u_k, zero rows past Ls
  float* hh = us + 2 * UROWS * US;       // (HPAD + L16) tf32 hi of h, zeros before h[0] and past Ls
  float* hl = hh + HPAD + L16;           // (HPAD + L16) lo
  float* yr = hl + HPAD + L16;           // (H, CT) ring of y^2 rows
  float* ss = yr + H * CT;               // (S8, US) state before the period, zero rows past S
  float* scs = ss + S8 * US;             // (S8, US) state before the period's scan chunk
  float* ais = scs + S8 * US;            // (SM, CS) A_L^i, zeros past S
  float* lsm = ais + SM * CS;            // (S, CT) chunk-local state before the period
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int c0 = blockIdx.y * CT;
  const int k0 = blockIdx.x * FRUN, k1 = min(Kp, k0 + FRUN);
  const int n0 = 8 * (warp & 1), jp = warp >> 1;
  const bool vec = tile_vec(u, C, c0, CT);
  const bool avec = S % 4 == 0 && reinterpret_cast<uintptr_t>(apow) % 16 == 0;
  const bool lvec = vec && reinterpret_cast<uintptr_t>(L) % 16 == 0;
  // Cpow[r][c], 0 past Ls and S
  auto cpow_at = [&](int r, int c) { return (r < Ls && c < S) ? __ldg(cpow + r * S + c) : 0.f; };
  // rows [UROWS kb, +UROWS) of u_k into buffer b, zeros past Ls; the caller commits
  auto stage = [&](int k, int kb, int b) {
    float* dst = us + b * UROWS * US;
    const int r0 = UROWS * kb, rows = min(UROWS, Ls - r0);
    load_tile<CT>(dst, US, u, (size_t)k * Ls + r0, rows, C, c0, vec);
    for (int i = rows * CT + t; i < UROWS * CT; i += FTHREADS) dst[(i / CT) * US + i % CT] = 0.f;
  };
  for (int i = t; i < SM * CS; i += FTHREADS) ais[i] = 0.f;
  for (int i = t; i < 2 * S8 * US; i += FTHREADS) ss[i] = 0.f;  // ss and scs
  for (int i = t; i < HPAD + L16; i += FTHREADS) {
    const bool in = i >= HPAD && i < HPAD + Ls;
    hh[i] = in ? hpk[i - HPAD] : 0.f;
    hl[i] = in ? hpk[Ls + i - HPAD] : 0.f;
  }
  if (k0 == 0)
    for (int i = t; i < tail * CT; i += FTHREADS) {
      const int r = Ls - tail + i / CT;  // ring row of prefix row r: r
      const float y = prefix[r];
      yr[(r % H) * CT + i % CT] = y * y;
    }
  const int kfirst = k0 > 0 ? k0 - 1 : 0;
  int chunk = -1;
  for (int k = kfirst; k < k1; ++k) {
    const bool pre = k < k0;  // y_{k0-1}: only the rows the windows reach
    const int kc = k / R;
    __syncthreads();  // the previous period's fix-up and products are done with its inputs
    if (kc != chunk) {
      chunk = kc;
      for (int i = t; i < S * CT; i += FTHREADS) {
        const int cc = c0 + i % CT;
        scs[(i / CT) * US + i % CT] = cc < C ? Sc[((size_t)kc * S + i / CT) * C + cc] : 0.f;
      }
    }
    load_tile<CT>(lsm, CT, L, (size_t)k * S, S, C, c0, lvec);
    const float* Ai = apow + (size_t)(k % R) * S * S;
    if (avec) {
      for (int i = t; i < S * S / 4; i += FTHREADS)
        cp_async16(ais + (4 * i / S) * CS + 4 * i % S, Ai + 4 * i);
    } else {
      for (int i = t; i < S * S; i += FTHREADS) ais[(i / S) * CS + i % S] = Ai[i];
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // A_L^i, L[k] and scs staged
    for (int tile = warp; tile < (SM / 16) * (CT / 8); tile += FWARPS) {
      const int mt = tile / (CT / 8), nt = tile % (CT / 8);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int ks = 0; ks < S8 / 8; ++ks) {
        const float* ar = ais + (16 * mt + g) * CS + 8 * ks + q4;
        const float v[4] = {ar[0], ar[8 * CS], ar[4], ar[8 * CS + 4]};
        uint32_t ahi[4], alo[4], bh0, bl0, bh1, bl1;
#pragma unroll
        for (int j = 0; j < 4; ++j) tf32_split(v[j], ahi[j], alo[j]);
        const float* br = scs + (8 * ks + q4) * US + 8 * nt + g;
        tf32_split(br[0], bh0, bl0);
        tf32_split(br[4 * US], bh1, bl1);
        mma3(acc, ahi, alo, bh0, bh1, bl0, bl1);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = 16 * mt + g + 8 * (j >> 1), col = 8 * nt + 2 * q4 + (j & 1);
        if (s < S) ss[s * US + col] = c0 + col < C ? acc[j] + lsm[s * CT + col] : 0.f;
      }
    }
    // (the first k-slab barrier below orders these writes of s_k before its reads)
    const int ylo = pre ? Ls - tail : 0;  // the first row of y_k to compute
    const int base = (k - k0 + 1) * Ls;   // ring row of y_k's row 0, before the modulo
    for (int m0 = ylo / YROWS * YROWS; m0 < Ls; m0 += YROWS) {
      const int mtile[2] = {m0 / 16 + jp, m0 / 16 + 15 - jp};
      const bool on[2] = {16 * mtile[0] < Ls && 16 * mtile[0] + 16 > ylo,
                          16 * mtile[1] < Ls && 16 * mtile[1] + 16 > ylo};
      float acc[2][4];
#pragma unroll
      for (int side = 0; side < 2; ++side)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[side][j] = 0.f;
      const int nkb = (min(m0 + YROWS, Ls) + UROWS - 1) / UROWS;  // k-slabs the slab reaches
      stage(k, 0, 0);
      cp_async_commit();
      for (int kb = 0; kb < nkb; ++kb) {
        if (kb + 1 < nkb) stage(k, kb + 1, (kb + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();  // k-slab kb staged (and, at kb = 0, s_k written)
        const float* ub = us + (kb & 1) * UROWS * US;
#pragma unroll 2
        for (int kk = 0; kk < UROWS / 8; ++kk) {
          const int K = kb * (UROWS / 8) + kk;  // the k-step within the period
          uint32_t bh0, bl0, bh1, bl1;
          const float* br = ub + (8 * kk + q4) * US + n0 + g;
          tf32_split(br[0], bh0, bl0);
          tf32_split(br[4 * US], bh1, bl1);
#pragma unroll
          for (int side = 0; side < 2; ++side) {
            if (!on[side] || K > 2 * mtile[side] + 1) continue;  // zero tile
            // Toeplitz tile (mt, K) = h[16 mt - 8 K + r - c]: h[d, d + 8, d - 4, d + 4]
            const int d = HPAD + 16 * mtile[side] - 8 * K + g - q4;
            const uint32_t ahi[4] = {__float_as_uint(hh[d]), __float_as_uint(hh[d + 8]),
                                     __float_as_uint(hh[d - 4]), __float_as_uint(hh[d + 4])};
            const uint32_t alo[4] = {__float_as_uint(hl[d]), __float_as_uint(hl[d + 8]),
                                     __float_as_uint(hl[d - 4]), __float_as_uint(hl[d + 4])};
            mma3(acc[side], ahi, alo, bh0, bh1, bl0, bl1);
          }
        }
        __syncthreads();  // k-slab kb read: its buffer may be staged again
      }
      // Cpow s_k into the same accumulators
      for (int ks = 0; ks < S8 / 8; ++ks) {
        uint32_t bh0, bl0, bh1, bl1;
        const float* br = ss + (8 * ks + q4) * US + n0 + g;
        tf32_split(br[0], bh0, bl0);
        tf32_split(br[4 * US], bh1, bl1);
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          if (!on[side]) continue;
          const int r = 16 * mtile[side] + g, c = 8 * ks + q4;
          const float v[4] = {cpow_at(r, c), cpow_at(r + 8, c), cpow_at(r, c + 4),
                              cpow_at(r + 8, c + 4)};
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) tf32_split(v[j], ahi[j], alo[j]);
          mma3(acc[side], ahi, alo, bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        if (!on[side]) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = 16 * mtile[side] + g + 8 * (j >> 1);
          if (row < Ls && row >= ylo)
            yr[((base + row) % H) * CT + n0 + 2 * q4 + (j & 1)] = acc[side][j] * acc[side][j];
        }
      }
      __syncthreads();  // the slab's y^2 in the ring
      if (pre) continue;
      // the windows whose last span row, Ls + e - 1, lies in this slab (at the
      // first slab, also those ending in y_{k-1})
      const int hi = Ls + min(m0 + YROWS, Ls);
      for (int i = t; i < P * CT; i += FTHREADS) {
        const int fi = i / CT, cc = i % CT, c = c0 + cc;
        const int e = starts[fi] + win;
        if (c >= C || e > hi || (m0 > 0 && e <= Ls + m0)) continue;
        const int r0 = ((k - k0) * Ls + starts[fi]) % H;
        auto y2 = [&](int w) { const int r = r0 + w; return yr[(r < H ? r : r - H) * CT + cc]; };
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
        int w = 0;
        for (; w + 3 < win; w += 4) {
          s0 += y2(w);
          s1 += y2(w + 1);
          s2 += y2(w + 2);
          s3 += y2(w + 3);
        }
        for (; w < win; ++w) s0 += y2(w);
        F[((size_t)k * P + fi) * C + c] = logf(((s0 + s1) + (s2 + s3)) + 0.01f);
      }
      // the next slab's ring writes follow its first k-slab barrier
    }
  }
}

// Launch 4.  mel[j] = smoothM^T med_slot[first argmax_kk score(j, kk, b), b];
// wpk: W5's 3xTF32 B fragments (pass, warp, k-step, n-tile, lane) as float4
// (hi[k][n], hi[k+4][n], lo[k][n], lo[k+4][n]), the k-steps in the order the
// kernel walks them: by slab of ECK channels (the last one ragged), then tap,
// then channel (cuda_frontend.pack_lda_weights).  Only one slab of F is in
// shared memory at a time, so any C fits.
template <int ESTAGES>
__global__ void __launch_bounds__(EWARPS * 32, 1) lda_epilogue_kernel(
    const float* __restrict__ F, const float4* __restrict__ wpk, const float* __restrict__ bm,
    const float* __restrict__ med, const float* __restrict__ smoothM, float* __restrict__ mel,
    int n_rows, int C, int B, int M, int step) {
  extern __shared__ __align__(16) float smem[];
  const int C8 = (C + 7) / 8 * 8, CK = min(C8, ECK);
  const int FS = CK + 4;  // FS: A fragment loads hit 32 banks
  const int depth = (M - 1) * step;
  const int KB = KS * B, npass = (KB + EPASS - 1) / EPASS;
  const int ksteps = M * C8 / 8;
  float4* ring = reinterpret_cast<float4*>(smem);  // (EWARPS, ESTAGES, ENT, 32)
  float* sc = smem;                                // (EF, ESC) one pass's scores, over the ring
  float* fs = smem + epilogue_region(ESTAGES);     // (EF + depth, FS) feature rows
  float* best = fs + (EF + depth) * FS;            // (EF, B) best score so far, then med
  int* bidx = reinterpret_cast<int*>(best + EF * B);  // (EF, B) its slot
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int row0 = blockIdx.x * EF;
  int staged = -1;  // the slab of F in fs
  float4* wring = ring + warp * ESTAGES * ENT * 32;
  for (int p = 0; p < npass; ++p) {
    const float4* wp = wpk + (size_t)(p * EWARPS + warp) * ksteps * ENT * 32;
#pragma unroll
    for (int s = 0; s < ESTAGES - 1; ++s) {
      if (s < ksteps)
#pragma unroll
        for (int nt = 0; nt < ENT; ++nt)
          cp_async16(wring + (s * ENT + nt) * 32 + lane, wp + (s * ENT + nt) * 32 + lane);
      cp_async_commit();
    }
    float acc[EMT][ENT][4];
#pragma unroll
    for (int mt = 0; mt < EMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < ENT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;
    // k-step ks: channel k-step kc of tap m in slab `slab`, whose taps have w8 k-steps
    for (int ks = 0, slab = 0, m = 0, kc = 0, w8 = CK / 8; ks < ksteps; ++ks) {
      if (slab != staged) {  // the same at every thread
        __syncthreads();     // every warp is done with the previous slab
        for (int i = t; i < (EF + depth) * FS; i += EWARPS * 32) {
          const int rr = i / FS, c = CK * slab + i % FS, row = row0 - depth + rr;
          fs[i] = (row >= 0 && row < n_rows && i % FS < CK && c < C)
                      ? __ldg(F + (size_t)row * C + c) : 0.f;
        }
        __syncthreads();  // the slab staged
        staged = slab;
      }
      cp_async_wait<ESTAGES - 2>();  // k-step ks has landed
      const int nx = ks + ESTAGES - 1;  // refill the slot that k-step ks-1 used
      if (nx < ksteps)
#pragma unroll
        for (int nt = 0; nt < ENT; ++nt)
          cp_async16(wring + ((nx % ESTAGES) * ENT + nt) * 32 + lane,
                     wp + (nx * ENT + nt) * 32 + lane);
      cp_async_commit();
      float4 b[ENT];
#pragma unroll
      for (int nt = 0; nt < ENT; ++nt) b[nt] = wring[((ks % ESTAGES) * ENT + nt) * 32 + lane];
      const float* ak = fs + (g + m * step) * FS + 8 * kc + q4;  // tap m: rows shifted by m step
#pragma unroll
      for (int mt = 0; mt < EMT; ++mt) {
        const float* r = ak + 16 * mt * FS;
        const float v[4] = {r[0], r[8 * FS], r[4], r[8 * FS + 4]};
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) tf32_split(v[j], ahi[j], alo[j]);
#pragma unroll
        for (int nt = 0; nt < ENT; ++nt)
          mma3(acc[mt][nt], ahi, alo, __float_as_uint(b[nt].x), __float_as_uint(b[nt].y),
               __float_as_uint(b[nt].z), __float_as_uint(b[nt].w));
      }
      if (++kc == w8) {  // the next tap; after the last one, the next slab
        kc = 0;
        if (++m == M) {
          m = 0;
          ++slab;
          w8 = min(CK, C8 - CK * slab) / 8;
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with its ring: the scores overwrite it
#pragma unroll
    for (int mt = 0; mt < EMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < ENT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sc[(16 * mt + g + 8 * (j >> 1)) * ESC + 8 * (ENT * warp + nt) + 2 * q4 + (j & 1)] =
              acc[mt][nt][j];
    __syncthreads();
    // running first-max over the slots, in slot order
    for (int i = t; i < EF * B; i += EWARPS * 32) {
      const int f = i / B, b = i % B;
      float bv = best[i];
      int bi = bidx[i];
      for (int kk = 0; kk < KS; ++kk) {
        const int col = kk * B + b - p * EPASS;
        if (col < 0 || col >= EPASS) continue;
        const float v = sc[f * ESC + col] + bm[kk * B + b];
        if (kk == 0 || v > bv) {  // strict: ties keep the first slot
          bv = v;
          bi = kk;
        }
      }
      best[i] = bv;
      bidx[i] = bi;
    }
    __syncthreads();  // the scores are read: the next pass's ring may overwrite them
  }
  for (int i = t; i < EF * B; i += EWARPS * 32) best[i] = med[bidx[i] * B + i % B];
  __syncthreads();
  for (int i = t; i < EF * B; i += EWARPS * 32) {
    const int f = i / B, b = i % B;
    if (row0 + f >= n_rows) continue;
    float o = 0.f;
    for (int bb = 0; bb < B; ++bb) o = fmaf(best[f * B + bb], __ldg(smoothM + bb * B + b), o);
    mel[(size_t)(row0 + f) * B + b] = o;
  }
}

// Launches 1-3: F (Kp*P, C) from u (Kp*Ls, C); L, lend and Sc are scratch.
cudaError_t launch_logpower(const float* u, const float* s0, const float* pmat,
                            const float* apow, const float* hpk, const float* cpow,
                            const float* prefix, const int* starts, float* L, float* lend,
                            float* Sc, float* F, int Kp, int Ls, int S, int C, int P, int win,
                            int tail, int R, cudaStream_t stream) {
  cudaError_t err;
  const int nchunks = (Kp + R - 1) / R;
  const int SM = (S + 15) / 16 * 16, S8 = (S + 7) / 8 * 8;
  const int L64 = (Ls + 8 * QSLAB - 1) / (8 * QSLAB) * 8 * QSLAB;
  const size_t q_rest = (size_t)(SM * (S8 + 4) + QWARPS * (QSTAGES * QSLAB * 64 + S8 * 8)) *
                        sizeof(float);
  const size_t q_smem = q_rest + (size_t)SM * (L64 + 4) * sizeof(float);
  const dim3 q_grid(nchunks, (C + QCT - 1) / QCT);
  if (q_smem <= 227 * 1024) {  // Pmat in shared memory (Ls <= 512)
    if ((err = cudaFuncSetAttribute(chunk_scan_kernel<true>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_smem)) !=
        cudaSuccess)
      return err;
    chunk_scan_kernel<true><<<q_grid, QWARPS * 32, q_smem, stream>>>(u, pmat, apow, L, lend, Kp,
                                                                    Ls, S, C, R);
  } else {
    if ((err = cudaFuncSetAttribute(chunk_scan_kernel<false>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_rest)) !=
        cudaSuccess)
      return err;
    chunk_scan_kernel<false><<<q_grid, QWARPS * 32, q_rest, stream>>>(u, pmat, apow, L, lend, Kp,
                                                                     Ls, S, C, R);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t s_smem = (size_t)(S * S + 2 * S * SCT) * sizeof(float);
  carry_scan_kernel<<<(C + SCT - 1) / SCT, S * SCT, s_smem, stream>>>(
      lend, s0, apow + (size_t)R * S * S, Sc, nchunks, S, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 32 channels a CTA where that fits in shared memory (Ls <= 256), else 16;
  // periods where neither fits (Ls > 512) stream y_k in slabs
  const int L16 = (Ls + 15) / 16 * 16;
  const size_t f32 = (size_t)features_smem_floats(32, L16, S, tail) * sizeof(float);
  const size_t f16 = (size_t)features_smem_floats(16, L16, S, tail) * sizeof(float);
  if (f16 > 227 * 1024) {
    const int H = YROWS + (tail > win ? tail : win);
    const size_t fs = (size_t)features_slab_smem_floats(L16, S, H) * sizeof(float);
    if ((err = cudaFuncSetAttribute(features_slab_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fs)) !=
        cudaSuccess)
      return err;
    features_slab_kernel<<<dim3((Kp + FRUN - 1) / FRUN, (C + 15) / 16), FTHREADS, fs, stream>>>(
        u, L, Sc, apow, hpk, cpow, prefix, starts, F, Kp, Ls, S, C, P, win, tail, R, H);
  } else if (f32 <= 227 * 1024) {
    if ((err = cudaFuncSetAttribute(features_kernel<32>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)f32)) !=
        cudaSuccess)
      return err;
    features_kernel<32><<<dim3((Kp + FRUN - 1) / FRUN, (C + 31) / 32), FTHREADS, f32, stream>>>(
        u, L, Sc, apow, hpk, cpow, prefix, starts, F, Kp, Ls, S, C, P, win, tail, R);
  } else {
    if ((err = cudaFuncSetAttribute(features_kernel<16>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)f16)) !=
        cudaSuccess)
      return err;
    features_kernel<16><<<dim3((Kp + FRUN - 1) / FRUN, (C + 15) / 16), FTHREADS, f16, stream>>>(
        u, L, Sc, apow, hpk, cpow, prefix, starts, F, Kp, Ls, S, C, P, win, tail, R);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int frontend_logpower(
    const float* u, const float* s0, const float* pmat, const float* apow, const float* hpk,
    const float* cpow, const float* prefix, const int* starts, float* L, float* lend, float* Sc,
    float* F, int Kp, int Ls, int S, int C, int P, int win, int tail, int R,
    cudaStream_t stream) {
  return (int)launch_logpower(u, s0, pmat, apow, hpk, cpow, prefix, starts, L, lend, Sc, F, Kp,
                              Ls, S, C, P, win, tail, R, stream);
}

extern "C" int frontend_decode_mels(
    const float* u, const float* s0, const float* pmat, const float* apow, const float* hpk,
    const float* cpow, const float* prefix, const int* starts, const float* wpk, const float* bm,
    const float* med, const float* smoothM, float* L, float* lend, float* Sc, float* F,
    float* mel, int Kp, int Ls, int S, int C, int P, int win, int tail, int R, int B, int M,
    int step, cudaStream_t stream) {
  cudaError_t err = launch_logpower(u, s0, pmat, apow, hpk, cpow, prefix, starts, L, lend, Sc, F,
                                    Kp, Ls, S, C, P, win, tail, R, stream);
  if (err != cudaSuccess) return (int)err;
  const int n_rows = Kp * P;
  const int depth = (M - 1) * step;
  const int CK = (C + 7) / 8 * 8 < ECK ? (C + 7) / 8 * 8 : ECK;
  // a 6-stage ring where it fits in shared memory (any C at 40 mel bins), else 4
  const size_t e_rest = (size_t)((EF + depth) * (CK + 4) + 2 * EF * B) * sizeof(float);
  const size_t e6 = epilogue_region(6) * sizeof(float) + e_rest;
  const size_t e4 = epilogue_region(4) * sizeof(float) + e_rest;
  const dim3 grid((n_rows + EF - 1) / EF);
  const float4* wpk4 = reinterpret_cast<const float4*>(wpk);
  if (e6 <= 227 * 1024) {
    if ((err = cudaFuncSetAttribute(lda_epilogue_kernel<6>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)e6)) !=
        cudaSuccess)
      return (int)err;
    lda_epilogue_kernel<6><<<grid, EWARPS * 32, e6, stream>>>(F, wpk4, bm, med, smoothM, mel,
                                                              n_rows, C, B, M, step);
  } else {
    if ((err = cudaFuncSetAttribute(lda_epilogue_kernel<4>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)e4)) !=
        cudaSuccess)
      return (int)err;
    lda_epilogue_kernel<4><<<grid, EWARPS * 32, e4, stream>>>(F, wpk4, bm, med, smoothM, mel,
                                                              n_rows, C, B, M, step);
  }
  return (int)cudaGetLastError();
}
