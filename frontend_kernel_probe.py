#!/usr/bin/env python3
"""Measurements behind the design of the front-end kernels K1 and K3
(``closed_loop_seeg_speech_synthesis_tpu_torch/csrc/frontend_decode.cu``),
on one NVIDIA GPU, at 30 minutes of 128-channel sEEG at 1024 Hz.  Run from
the repository root:

    python3 frontend_kernel_probe.py [--baseline DIR]

1. Where the time goes: a copy of the source with clock64 stamps at the
   phase boundaries of the per-period loop of ``features_kernel`` (thread 0
   of every CTA) and ``chunk_scan_kernel`` (lane 0 of every warp), summed
   over the launch and printed as cycles a period.
2. Variants of the source, each timed (CUDA events, K1 and K3, median of 5)
   and held against the plain version in float64: K3's features on the
   first minute (p99.9 of the error) and K1's mel frames over the 30
   minutes (label flips, entries outside rtol 1e-4 / atol 1e-5, beside the
   plain float32 version's, and chip_smoke.py's K1 gate on them: at most
   twice the plain version's plus 1e-5).  The variants: as built;
   ``1xtf32``, one TF32 pass (hi x hi) in place of three in every product,
   the tensor cores' single-pass rate and accuracy; ``1xtf32 lda``, the
   same in K1's LDA epilogue only; ``three accumulators``, each of a
   k-step's three products in a fresh accumulator of its own instead of one
   shared by the three.

3. With ``--baseline DIR``: K1 and K3 as built against the
   ``frontend_decode.cu`` and ``tf32_mma.cuh`` in DIR (another version with
   the same C entry points), timed in the order baseline, as built, as
   built, baseline in one process.

The variants are copies of the source and header edited here (``variants``;
its anchors are held to the sources by tests/test_torch_frontend_scan.py)
and built by ``probe_tools`` with the same nvcc flags into build/kernels/;
the package's own build is untouched.  Prints the card's name and power
limit first.  Without a CUDA device it exits 1.
"""

import argparse
import ctypes
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import probe_tools  # noqa: E402

CSRC = "closed_loop_seeg_speech_synthesis_tpu_torch/csrc"
SRC, HEADER = f"{CSRC}/frontend_decode.cu", f"{CSRC}/tf32_mma.cuh"
MMA3 = '''  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(c, alo, bh0, bh1);
  mma_tf32(c, ahi, bl0, bl1);
  mma_tf32(c, ahi, bh0, bh1);
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] += c[j];'''
HEADER_EDITS = {
    "1xtf32": (MMA3, '''  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(c, ahi, bh0, bh1);
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] += c[j];'''),
    "three accumulators": (MMA3, '''  float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f}, c2[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(c0, alo, bh0, bh1);
  mma_tf32(c1, ahi, bl0, bl1);
  mma_tf32(c2, ahi, bh0, bh1);
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] += (c0[j] + c1[j]) + c2[j];'''),
}
# lda_epilogue_kernel's product of a k-step: 3xTF32, and one TF32 pass in a fresh accumulator
LDA_MMA3 = '''          mma3(acc[mt][nt], ahi, alo, __float_as_uint(b[nt].x), __float_as_uint(b[nt].y),
               __float_as_uint(b[nt].z), __float_as_uint(b[nt].w));'''
SOURCE_EDITS = {
    "1xtf32 lda": (LDA_MMA3, '''          {
            float c[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(c, ahi, __float_as_uint(b[nt].x), __float_as_uint(b[nt].y));
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[mt][nt][j] += c[j];
          }'''),
}
ADD = "atomicAdd(&probe_cycles[{}], (unsigned long long)({} - {})); "
# (anchor, text before it, text after it) for the stamped copy
FEATURE_PHASES = ["wait for the inputs", "fix-up", "barrier", "Toeplitz + Cpow s products",
                  "barrier", "windows + prefetch issue", "barrier"]
STAMPS = [
    ("namespace {\n", "__device__ unsigned long long probe_cycles[16];\n", ""),
    ("    cp_async_wait<0>();\n    __syncthreads();  // u_k, A_L^i, L[k] and scs in shared memory\n",
     "    long long t0 = clock64();\n", "    long long t1 = clock64();\n"),
    ("    __syncthreads();  // s_k written\n", "    long long t2 = clock64();\n",
     "    long long t3 = clock64();\n"),
    ("    __syncthreads();  // ys written; u_k, A_L^i, L[k] and s_k read\n",
     "    long long t4 = clock64();\n", "    long long t5 = clock64();\n"),
    ("      __syncthreads();  // windows read\n", "      long long t6 = clock64();\n",
     "      if (threadIdx.x == 0) { " + "".join(ADD.format(i, f"t{i + 1}", f"t{i}") for i in range(6))
     + ADD.format(6, "clock64()", "t6") + "atomicAdd(&probe_cycles[7], 1ull); }\n"),
    ("    for (int j = 0; j < nsl; ++j, ++f) {\n", "    long long p0 = clock64();\n", ""),
    ("      cp_async_wait<QSTAGES - 2>();\n", "      long long w0 = clock64();\n", ""),
    ("      __syncwarp();  // slab f landed for every lane; slab f - 1 read by every lane\n", "",
     "      if (lane == 0) " + ADD.format(8, "clock64()", "w0") + "\n"),
    ("    __syncwarp();  // l_{k+1} written\n", "",
     "    if (lane == 0) { " + ADD.format(9, "clock64()", "p0") + "atomicAdd(&probe_cycles[10], 1ull); }\n"),
]
READ = probe_tools.reader("probe_cycles", "probe_read")


def variants(src: str, header: str) -> dict:
    """name -> (source, header) of each build this script times; "stamped"
    is the source with the clock64 stamps."""
    out = {"as built": (src, header)}
    for name, (old, new) in HEADER_EDITS.items():
        out[name] = (src, probe_tools.swap(header, old, new))
    for name, (old, new) in SOURCE_EDITS.items():
        out[name] = (probe_tools.swap(src, old, new), header)
    stamped = src
    for anchor, before, after in STAMPS:
        stamped = probe_tools.swap(stamped, anchor, before + anchor + after)
    out["stamped"] = (stamped + READ, header)
    return out


def build_variants(src: str, header: str) -> dict:
    """name -> library of each copy in ``variants``, built together."""
    return probe_tools.build_all({name: {"frontend_decode.cu": s, "tf32_mma.cuh": h}
                                  for name, (s, h) in variants(src, header).items()})


def main(argv=None):
    ap = argparse.ArgumentParser(description="Measurements behind the front-end kernels K1 and K3.")
    ap.add_argument("--baseline", help="directory with another frontend_decode.cu and "
                    "tf32_mma.cuh to time K1 and K3 against")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("frontend_kernel_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from closed_loop_seeg_speech_synthesis_tpu_torch.cli import decode as cli
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import _build, cuda_frontend, framing
    from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params, pipeline

    card = probe_tools.card()
    print(card, flush=True)
    with open(SRC) as f, open(HEADER) as h:
        libs = build_variants(f.read(), h.read())
    if args.baseline:
        libs["baseline"] = probe_tools.build("baseline", {
            name: open(os.path.join(args.baseline, name)).read()
            for name in ("frontend_decode.cu", "tf32_mma.cuh")})

    dev = torch.device("cuda")
    sr, C = 1024, 128
    loaded = params.from_arrays(**cs.session_arrays(np.random.RandomState(0), C),
                                dtype=torch.float32, device=dev)
    T = sr * 60 * 30
    eeg = torch.randn((T, C), generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    cfg, dec = cli._build_decoder(loaded, sr, C, 10.0, torch.float32, dev)
    consts = cuda_frontend.epilogue_constants(dec.lda_coef_full, dec.lda.intercept, dec.lda.valid,
                                              dec.lda.classes, dec.medians, dec.gauss_kernel, C)
    frames = lambda n: len(framing.streaming_frame_ends(50, 10, sr, n + cfg.prefill))
    s0 = pipeline._initial_state(dec, eeg).contiguous()
    nf = frames(T)
    k1 = lambda: cuda_frontend.frontend_decode_mels(dec.frontend_ops, eeg, s0, *consts, nf)
    k3 = lambda: cuda_frontend.frontend_logpower(dec.frontend_ops, eeg, s0, nf)
    head = (dec.frontend_ops, eeg[: 60 * sr], s0, frames(60 * sr))
    mel_args = (dec.frontend_ops, eeg, s0, *consts, nf)
    mel64 = cuda_frontend.frontend_decode_mels_plain(dec.frontend_ops, eeg.double(), s0.double(),
                                                     *consts, nf)
    _, flips_32, _ = cs.mel_agreement(torch, cuda_frontend.frontend_decode_mels_plain(*mel_args)
                                      .double(), mel64)
    load = _build.load
    try:
        print(f"== variants at 30 min, 128 ch, 1024 Hz [{card}]")
        for name, lib in libs.items():
            if name in ("stamped", "baseline"):
                continue
            _build.load = lambda _name, lib=lib: lib
            k1(), k3()
            torch.cuda.synchronize()
            err, err_plain = cs.float64_tracking(torch, cuda_frontend.frontend_logpower,
                                                 cuda_frontend.frontend_logpower_plain, head)
            _, flips_k, _ = cs.mel_agreement(torch, k1().double(), mel64)
            gate = "passes" if cs.float64_flips_ok(flips_k, flips_32) else "FAILS"
            print(f"  {name}: K1 {cs.cuda_ms(torch, k1, 5):.3f} ms, K3 {cs.cuda_ms(torch, k3, 5):.3f} ms; "
                  f"first 60 s features p99.9 |error| against float64 {err:.3e} (plain float32 "
                  f"{err_plain:.3e}); K1 label flips against float64 over 30 min {flips_k:.3e} "
                  f"(plain float32 {flips_32:.3e}): {gate} K1's float64 gate", flush=True)
        lib = libs["stamped"]
        _build.load = lambda _name: lib
        k3()
        torch.cuda.synchronize()
        got = (ctypes.c_ulonglong * 16)()
        if lib.probe_read(got) != 0:
            raise SystemExit("frontend_kernel_probe: reading the stamps failed")
        print(f"== cycles a period, one K3 call, stamped copy [{card}]")
        print(f"  features_kernel ({got[7]} periods, thread 0 of each CTA): "
              + ", ".join(f"{name} {got[i] / got[7]:.0f}" for i, name in enumerate(FEATURE_PHASES)))
        print(f"  chunk_scan_kernel ({got[10]} warp-periods, lane 0 of each warp): "
              f"{got[9] / got[10]:.0f} a period, of which waiting for u slabs {got[8] / got[10]:.0f}")
        if args.baseline:
            print(f"== as built against {args.baseline} (CUDA events, median of 5) [{card}]")
            for name in ("baseline", "as built", "as built", "baseline"):
                _build.load = lambda _name, lib=libs[name]: lib
                k1(), k3()
                print(f"  {name}: K1 {cs.cuda_ms(torch, k1, 5):.3f} ms, K3 "
                      f"{cs.cuda_ms(torch, k3, 5):.3f} ms", flush=True)
    finally:
        _build.load = load
    return 0


if __name__ == "__main__":
    sys.exit(main())
