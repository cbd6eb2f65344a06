#!/usr/bin/env python3
"""Measurements behind the design of the Griffin-Lim kernel that K2 and K4
share (``closed_loop_seeg_speech_synthesis_tpu_torch/csrc/gl_audio.cu``), on
one NVIDIA GPU.  Run from the repository root:

    python3 gl_kernel_probe.py

1. Accuracy against float64: the f32 plain version, the cluster kernel and
   the FFT kernel on the same blocks (converging estimator).  In bf16 (one iteration, both estimators, against the bf16 branch in
   float64): the plain bf16 version, the wgmma kernel (one fp32 accumulator
   over each product's 16 k-steps), its "grouped" variant (a fresh
   accumulator every 4 k-steps, added in fp32) and its "atan2f" variant
   (libdevice's atan2f in the exp(angle) phase step).
2. The regime threshold: both kernels timed at B = 4 .. 4,224 blocks
   (``cuda_gl.CLUSTER_MAX_B`` is where they cross), in float32 and in bf16,
   and the large-B kernels at 180,000 blocks (30 minutes) with both
   estimators, the wgmma kernel beside its "grouped" and "atan2f" variants.
3. Where each kernel's time goes: a copy of the source with clock64 stamps
   at its phase boundaries (CTA 0, thread 0), the FFT kernel at 180,000
   blocks (block 0, in the first full wave), the cluster kernel at the
   online step's B = 4, the bf16 wgmma kernel at 180,000 blocks (the last
   tile of CTA 0's first warpgroup; its set-up is the tiles before it).

The variants are copies of the source edited here (``variants``; its
anchors are held to the source by tests/test_torch_gl_split.py) and built
by ``probe_tools`` with the same nvcc flags into build/kernels/; the
package's own build is untouched.
Prints the card's name and power limit first.  Without a CUDA device it
exits 1.
"""

import concurrent.futures
import contextlib
import ctypes
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import probe_tools  # noqa: E402

SRC = "closed_loop_seeg_speech_synthesis_tpu_torch/csrc/gl_audio.cu"
HEADERS = ("closed_loop_seeg_speech_synthesis_tpu_torch/csrc/tf32_mma.cuh",  # included by SRC
           "closed_loop_seeg_speech_synthesis_tpu_torch/csrc/wgmma.cuh")
# gl_wgmma_kernel's exp(angle) phase step with libdevice's atan2f for the JAX
# kernels' Cephes atan2 with fast reciprocals
ATAN2F = (" : atan2_cephes(xi, xr));", " : atan2f(xi, xr));")
# gl_wgmma_kernel's products (bf16, one fp32 accumulator over the 16 k-steps)
# -> a fresh accumulator every 4 k-steps, added to the sum in fp32
GROUPED = ('''  wg::fence();
#pragma unroll
  for (int s = 0; s < KS; ++s)
    wg::mma_rs<TRANS_B>(
        d, a[s],
        wg::desc_advance(desc, TRANS_B ? s * 16 * 128 : (s >> 2) * KBLOCK_BYTES + (s & 3) * 32),
        s > 0);
  wg::commit();
  wg::wait<0>();
  wg::fence_regs(d);''', '''  float part[128];
#pragma unroll
  for (int g4 = 0; g4 < KS / 4; ++g4) {
    wg::fence();
#pragma unroll
    for (int s = 4 * g4; s < 4 * g4 + 4; ++s)
      wg::mma_rs<TRANS_B>(
          part, a[s],
          wg::desc_advance(desc, TRANS_B ? s * 16 * 128 : (s >> 2) * KBLOCK_BYTES + (s & 3) * 32),
          s > 4 * g4);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(part);
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = g4 ? d[i] + part[i] : part[i];
  }''')
# (text the stamp follows, stamp) in each kernel; slot = 8 * iteration + stamp
FFT_STAMPS = [("  for (int it = 0; it < iterations; ++it) {\n", 0),
              ("    fft_forward(v, buf, f, lane);\n", 1),
              ("    v[3] = l0 ? wh[1] : wh[3];\n", 2),
              ("    fft_inverse(v, buf, f, lane);\n", 3),
              ("        out[32 * j] = (j < 8 ? t0[j] : 0.f) + (j >= 5 && j < 13 ? t1[j - 5] : 0.f);\n"
               "    }\n", 4)]
FFT_PHASES = ["forward FFT", "unpack + phase step + pack", "inverse FFT",
              "window + overlap-add"]
WGMMA_STAMPS = [("    for (int it = 0; it < iterations; ++it) {\n", 0),
                ("      product<0>(d, a, fdesc);  // forward: X = frames x [cos | sin]\n", 1),
                ("          if constexpr (!BUG) z[KSTEPS16 / 2 + s][r] = wg::bf16x2(-zi0 * c0, -zi1 * c1);\n"
                 "        }\n", 2),
                ("      product<1>(d, z, idesc);\n", 3),
                ("          *reinterpret_cast<float2*>(G + (size_t)b * BLK + 8 * j + 2 * q) = "
                 "make_float2(v[0], v[1]);\n        }\n      }\n", 4)]
WGMMA_PHASES = ["forward product", "phase step", "inverse product", "epilogue + overlap-add"]
CLUSTER_STAMPS = [("  for (int it = 0; it < iterations; ++it) {\n    __syncthreads();\n", 0),
                  ("      frm[i] = BF16 ? bf16_round(v) : v;\n    }\n    __syncthreads();\n", 1),
                  ("      if (lane == 0) xn[f] = sn;\n    }\n    __syncthreads();\n", 2),
                  ("    cluster.sync();  // every CTA's zl is written\n", 3),
                  ("      zf[ff * FFT + kk] = BF16 ? bf16_round(z) : z;\n    }\n    __syncthreads();\n", 4),
                  ("    cluster.sync();  // every CTA's yl is written; every zl read\n", 5),
                  ("      wav[i] = v;\n    }\n", 6)]
CLUSTER_PHASES = ["frames + barrier", "forward + Nyquist + barrier", "phase + cluster barrier",
                  "gather Z + barrier", "inverse + cluster barrier", "overlap-add gather"]
SLOTS = 8 * 16


def stamped(src, kernel, stamps):
    """``src`` with clock64 stamps after each anchor inside ``kernel``."""
    start = src.index(f" {kernel}(")
    end = src.index("\n}\n", start)
    body = src[start:end]
    for anchor, k in stamps:
        stamp = "    __syncthreads();\n" if kernel == "gl_cluster_kernel" and k == 6 else ""
        body = probe_tools.swap(body, anchor, anchor + stamp + f"    STAMP(8 * it + {k});\n")
    body = body.replace("{\n", "{\n  int it = 0;\n  STAMP(127);\n", 1)
    body = body.replace("for (int it = 0;", "for (it = 0;")
    return src[:start] + body + src[end:]


def variants(src):
    """The probe's copies of gl_audio.cu: "grouped" gives gl_wgmma_kernel's
    products a fresh accumulator every 4 k-steps, added in fp32; "atan2f"
    gives its exp(angle) phase step libdevice's atan2f;
    "stamps" records clock64 at the phase boundaries of the three
    Griffin-Lim kernels and adds ``probe_stamps_read``."""
    grouped = probe_tools.swap(src, *GROUPED)
    libdevice = probe_tools.swap(src, *ATAN2F)
    prelude = ("namespace {\n__device__ long long probe_stamps[%d];\n#define STAMP(i) do { if "
               "(blockIdx.x == 0 && threadIdx.x == 0) probe_stamps[(i)] = clock64(); } while (0)\n"
               % SLOTS)
    timed = src.replace("namespace {\n", prelude, 1)
    for kernel, stamps in (("gl_fft_kernel", FFT_STAMPS), ("gl_cluster_kernel", CLUSTER_STAMPS),
                           ("gl_wgmma_kernel", WGMMA_STAMPS)):
        timed = stamped(timed, kernel, stamps)
    return {"grouped": grouped, "atan2f": libdevice,
            "stamps": timed + probe_tools.reader("probe_stamps", "probe_stamps_read")}


@contextlib.contextmanager
def regime_threshold(cuda_gl, cluster_max_b):
    """Launches of B <= cluster_max_b blocks take the cluster kernel."""
    saved = cuda_gl.CLUSTER_MAX_B, cuda_gl.CLUSTER_MAX_B_BF16
    cuda_gl.CLUSTER_MAX_B = cuda_gl.CLUSTER_MAX_B_BF16 = cluster_max_b
    try:
        yield
    finally:
        cuda_gl.CLUSTER_MAX_B, cuda_gl.CLUSTER_MAX_B_BF16 = saved


def build_variants(src):
    """name -> library of each copy in ``variants(src)``, built together,
    each beside the package's headers."""
    root = os.path.dirname(os.path.abspath(__file__))
    headers = {os.path.basename(h): open(os.path.join(root, h)).read() for h in HEADERS}
    return probe_tools.build_all({name: {"gl_audio.cu": text, **headers}
                                  for name, text in variants(src).items()})


def main():
    import torch

    if not torch.cuda.is_available():
        print("gl_kernel_probe: no CUDA device", file=sys.stderr)
        return 1
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import _build, cuda_gl
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import filter_design as fd
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import griffinlim as gl
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import iir

    card = probe_tools.card()
    print(card, flush=True)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # the package's build beside the copies'
        kernel = pool.submit(_build.load, "gl_audio")
        libs = build_variants(open(SRC).read())
        libs["kernel"] = kernel.result()
    load = _build.load

    def use(name):
        _build.load = (lambda _: libs[name]) if name != "kernel" else load

    dev = torch.device("cuda")
    lp = iir.sos_to_statespace(fd.gl_output_lowpass_sos())
    ops = cuda_gl.make_gl_audio_ops(gl.make_streaming_gl_ops(40, 16000.0, torch.float32, dev), lp,
                                    torch.float32, dev)
    ops64 = cuda_gl.make_gl_audio_ops(gl.make_streaming_gl_ops(40, 16000.0, torch.float64), lp,
                                      torch.float64)
    rs = np.random.RandomState(0)

    def frames(B):  # log-mels as a mean-reverting walk, uniform inits
        x, e = np.zeros((B + 1, 40)), rs.randn(B + 1, 40) * 0.3
        for i in range(1, B + 1):
            x[i] = 0.95 * x[i - 1] + e[i]
        return (torch.as_tensor(x - 1.0, dtype=torch.float32, device=dev),
                torch.as_tensor(rs.rand(B, 480), dtype=torch.float32, device=dev))

    def ms(fn, n):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    big = 10**9
    print("== accuracy against float64, converging estimator, 8 iterations "
          "(max and 99.9th percentile of |error|)", flush=True)
    for B in (4, 203, 1001):
        lm, rand = frames(B)
        ref = cuda_gl.gl_blocks_plain(lm.cpu().double(), rand.cpu().double(), ops64, 8, False)
        runs = [("plain f32", None), ("cluster", big), ("fft", 0)]
        line = []
        for name, threshold in runs:
            if threshold is None:
                out = cuda_gl.gl_blocks_plain(lm, rand, ops, 8, False)
            else:
                with regime_threshold(cuda_gl, threshold):
                    out = cuda_gl.gl_blocks(lm, rand, ops, 8, False)
            e = (out.cpu().double() - ref).abs().reshape(-1)
            line.append(f"{name} {e.max().item():.3e} / {torch.quantile(e, 0.999).item():.3e}")
        print(f"  B = {B}: " + "; ".join(line), flush=True)
    print("== bf16, 1 iteration, against the bf16 branch in float64 (max and 99.9th percentile "
          "of |error|)", flush=True)
    lm, rand = frames(4224)
    for bug in (False, True):
        ref = cuda_gl._gl_loop_plain(lm, rand, ops, 1, bug, torch.float64)
        line = []
        for name in ("plain bf16", "wgmma", "wgmma, grouped", "wgmma, atan2f"):
            use(name.split(", ")[1] if ", " in name else "kernel")
            with regime_threshold(cuda_gl, 0):
                out = (cuda_gl.gl_blocks_plain(lm, rand, ops, 1, bug, bf16=True) if "plain" in name
                       else cuda_gl.gl_blocks(lm, rand, ops, 1, bug, bf16=True))
            e = (out.double() - ref).abs().reshape(-1)
            line.append(f"{name} {e.max().item():.3e} / {torch.quantile(e, 0.999).item():.3e}")
        use("kernel")
        print(f"  B = 4224, phase_bug={bug}: " + "; ".join(line), flush=True)

    print(f"== time a launch, phase_bug, 8 iterations (CUDA events) [{card}]", flush=True)
    for B in (4, 8, 12, 16, 24, 32, 48, 64, 128, 136, 192, 256, 384, 448, 512, 640, 1024, 4224):
        lm, rand = frames(B)
        n = 200 if B <= 1024 else 20
        with regime_threshold(cuda_gl, big):
            t_c = ms(lambda: cuda_gl.gl_blocks(lm, rand, ops, 8, True), n)
        with regime_threshold(cuda_gl, 0):
            t_m = ms(lambda: cuda_gl.gl_blocks(lm, rand, ops, 8, True), n)
        with regime_threshold(cuda_gl, big):
            t_c16 = ms(lambda: cuda_gl.gl_blocks(lm, rand, ops, 8, True, bf16=True), n)
        with regime_threshold(cuda_gl, 0):
            t_w16 = ms(lambda: cuda_gl.gl_blocks(lm, rand, ops, 8, True, bf16=True), n)
        print(f"  B = {B}: cluster {t_c * 1e3:.2f} us, fft {t_m * 1e3:.2f} us; bf16: "
              f"cluster {t_c16 * 1e3:.2f} us, wgmma {t_w16 * 1e3:.2f} us; picked: "
              f"{cuda_gl.regime(B)}, bf16 {cuda_gl.regime(B, True)}", flush=True)
    lm, rand = frames(180_000)
    for bug in (True, False):
        t16 = {}
        for name in ("kernel", "grouped", "atan2f"):
            use(name)
            t16[name] = ms(lambda: cuda_gl.gl_blocks(lm, rand, ops, 8, bug, bf16=True), 5)
        use("kernel")
        print(f"  B = 180000, phase_bug={bug}: fft "
              f"{ms(lambda: cuda_gl.gl_blocks(lm, rand, ops, 8, bug), 5):.3f} ms; bf16 wgmma "
              f"{t16['kernel']:.3f} ms, grouped {t16['grouped']:.3f} ms, atan2f "
              f"{t16['atan2f']:.3f} ms", flush=True)

    print("== cycles by phase (clock64, CTA 0, mean over iterations 0-6)", flush=True)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    use("stamps")
    for label, B, cmax, bf16, phases in (
            ("fft, 180000 blocks (block 0)", 180_000, 0, False, FFT_PHASES),
            ("cluster, 4 blocks", 4, big, False, CLUSTER_PHASES),
            ("bf16 wgmma, 180000 blocks (CTA 0's last tile)", 180_000, 0, True, WGMMA_PHASES)):
        lm, rand = frames(B)
        with regime_threshold(cuda_gl, cmax):
            for _ in range(3):
                cuda_gl.gl_blocks(lm, rand, ops, 8, True, bf16=bf16)
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * SLOTS)()
        libs["stamps"].probe_stamps_read(buf)
        st = np.array(buf[:], np.float64)
        n = len(phases) + 1  # stamps an iteration
        it = st[: 8 * 8].reshape(8, 8)[:, :n]
        per_it = np.diff(it[:, 0]).mean()
        parts = np.diff(it, axis=1)[:7].mean(axis=0)
        print(f"  {label}: launch {st[n - 1 + 8 * 7] - st[127]:.0f} cycles, set-up "
              f"{it[0, 0] - st[127]:.0f}, an iteration {per_it:.0f}: "
              + ", ".join(f"{p} {v:.0f} ({100 * v / per_it:.1f}%)" for p, v in zip(phases, parts)),
              flush=True)
    use("kernel")
    print(f"  SM clock during the run: {clock}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
