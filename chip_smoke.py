#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (closed_loop_seeg_speech_synthesis_tpu_torch)
on one NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

1. Prints the card's name and power limit and the torch/CUDA versions.
2. Builds both CUDA kernels from ``csrc/`` and prints the build seconds.
3. Holds each kernel against its plain torch version on the card, at the
   shapes of the main path: K1 (sEEG -> mel frames) on a 30-minute
   128-channel 1024 Hz session and on 60 s at 2048 Hz; K2 (mel frames ->
   int16 audio) without iterations, with the converging phase estimator and
   with the reference's exp(angle) estimator (quality-gated, it is chaotic).
4. Drives the main path, the offline replay decode, through
   ``cli.decode.perform_offline_decoding`` at 128 ch / 1024 Hz / 30 min with
   both launch counters set to 0 first, checks that both kernels launched
   and that the outputs are finite and shaped right, and times the kernel
   path against the plain torch path with CUDA events.
5. Decodes the session's first minute on the card and through the float64
   CPU path (the one held bit-equal to the JAX package by the tests) and
   holds the card inside the f32 label-flip budget.
6. Runs ``cli.decode.main`` end to end on files in a temporary directory
   when h5py is installed.

Any failure exits nonzero.  The line before the last is the kernels' JSON
record, the last line ``{"ok": true, "device": {...}}``.  Without a CUDA
device it exits 1 and prints no result.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

SR, C, MINUTES, MINUTES_2048 = 1024, 128, 30, 1
N_FEATS, GL_NORM = 150, 10.0
AGREE_RTOL, AGREE_ATOL, AGREE_MIN = 1e-5, 1e-6, 0.999   # tests/test_pallas_kernels.py:125-126
FLIP_RTOL, FLIP_ATOL, FLIP_MAX = 1e-4, 1e-5, 0.02       # tests/test_f32_error_budget.py:51-53


def say(*args):
    print(*args, flush=True)


def check(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")
    say(f"  ok: {what}")


def cuda_ms(torch, fn, reps=3):
    """Median CUDA-event milliseconds of ``fn()`` over ``reps`` calls."""
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def session_arrays(rs, n_channels):
    """Random LDA / medians / select at the published widths (40 bins, 9
    classes, 150 selected features), from a seed."""
    return dict(lda_coef=rs.randn(40, 9, N_FEATS) * 0.1, lda_intercept=rs.randn(40, 9),
                lda_classes=np.tile(np.arange(9, dtype=np.int32), (40, 1)),
                lda_valid=np.ones((40, 9), bool), medians=np.sort(rs.randn(40, 9), axis=1),
                select=rs.permutation(5 * n_channels)[:N_FEATS], bad_channels=np.zeros(0, int))


def mel_agreement(torch, a, b):
    agree = torch.isclose(a, b, rtol=AGREE_RTOL, atol=AGREE_ATOL).double().mean().item()
    flips = 1.0 - torch.isclose(a, b, rtol=FLIP_RTOL, atol=FLIP_ATOL).double().mean().item()
    return agree, flips, (a - b).abs().max().item()


def hop_energy(torch, audio):
    x = audio.double().reshape(-1, 160)
    return torch.sqrt((x * x).mean(dim=1) + 1e-6)


def attainment(torch, audio, log_mels, gl_ops):
    """||a |STFT(audio)| - target|| / ||target||, a fitted: audio samples
    [160 j, 160 j + 256) carry block j's first frame, whose target is mel j."""
    x = audio.double() / 32767.0
    frames = x.unfold(0, 256, 160)
    win = gl_ops.window.double()
    mag = torch.fft.rfft(frames * win, dim=1).abs()
    target = torch.exp(log_mels[: frames.shape[0]].double()) @ gl_ops.Minv.double()
    alpha = (mag * target).sum() / (mag * mag).sum()
    return ((alpha * mag - target).norm() / target.norm()).item()


def corr(torch, a, b):
    return torch.corrcoef(torch.stack([a, b]))[0, 1].item()


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from closed_loop_seeg_speech_synthesis_tpu_torch.cli import decode as cli
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import _build, cuda_frontend, cuda_gl, framing
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import griffinlim as gl
    from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params, pipeline

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    say(card)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")

    say("== build")
    for name in ("frontend_decode", "gl_audio"):
        _build.load(name)
        say(f"  {name}: built in {_build.build_info[name]['seconds']:.2f} s "
            f"({_build.build_info[name]['library']})")

    rs = np.random.RandomState(0)
    arrs = session_arrays(rs, C)
    loaded = params.from_arrays(**arrs, dtype=torch.float32, device=dev)
    T = SR * 60 * MINUTES
    g = torch.Generator(device=dev).manual_seed(0)
    eeg = torch.randn((T, C), generator=g, device=dev)
    cfg, dec = cli._build_decoder(loaded, SR, C, GL_NORM, torch.float32, dev)
    n_frames = len(framing.streaming_frame_ends(cfg.frame_len_ms, cfg.frame_shift_ms, SR,
                                                T + cfg.prefill))
    say(f"session: {T} samples x {C} ch @ {SR} Hz ({MINUTES} min), {n_frames} frames")

    # ---- K1: kernel vs plain at the main path's shapes --------------------
    say("== K1 frontend_decode_mels vs plain")

    def k1_inputs(d, c, x):
        s0 = pipeline._initial_state(d, x).contiguous()
        consts = cuda_frontend.epilogue_constants(d.lda_coef_full, d.lda.intercept, d.lda.valid,
                                                  d.lda.classes, d.medians, d.gauss_kernel,
                                                  c.n_channels, c.model_order)
        nf = len(framing.streaming_frame_ends(c.frame_len_ms, c.frame_shift_ms, c.sr,
                                              x.shape[0] + c.prefill))
        return (d.frontend_ops, x, s0, *consts, nf, c.model_order, c.step_size)

    k1_args = k1_inputs(dec, cfg, eeg)
    mel_k = cuda_frontend.frontend_decode_mels(*k1_args)
    torch.cuda.synchronize()
    mel_p = cuda_frontend.frontend_decode_mels_plain(*k1_args)
    agree, flips, k1_err = mel_agreement(torch, mel_k, mel_p)
    say(f"  1024 Hz, {MINUTES} min: agreement {agree:.6f}, flip rate {flips:.6f}, max abs err {k1_err:.3e}")
    check(mel_k.shape == (n_frames, 40) and bool(torch.isfinite(mel_k).all()), "K1 shape, finite")
    check(agree >= AGREE_MIN and flips < FLIP_MAX, "K1 1024 Hz agreement and label flips")
    cfg2, dec2 = cli._build_decoder(loaded, 2048, C, GL_NORM, torch.float32, dev)
    eeg2 = torch.randn((2048 * 60 * MINUTES_2048, C), generator=g, device=dev)
    k1_args2 = k1_inputs(dec2, cfg2, eeg2)
    agree2, flips2, err2 = mel_agreement(torch, cuda_frontend.frontend_decode_mels(*k1_args2),
                                         cuda_frontend.frontend_decode_mels_plain(*k1_args2))
    say(f"  2048 Hz, {MINUTES_2048} min: agreement {agree2:.6f}, flip rate {flips2:.6f}, max abs err {err2:.3e}")
    check(agree2 >= AGREE_MIN and flips2 < FLIP_MAX, "K1 2048 Hz agreement and label flips")
    k1_ms = cuda_ms(torch, lambda: cuda_frontend.frontend_decode_mels(*k1_args))
    k1_plain_ms = cuda_ms(torch, lambda: cuda_frontend.frontend_decode_mels_plain(*k1_args))
    say(f"  time at {MINUTES} min: kernel {k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms")

    # ---- K2: kernel vs plain at the main path's shapes --------------------
    say("== K2 gl_audio vs plain")
    lm = mel_k.contiguous()
    rand = gl.default_rand_init(n_frames - 1, torch.Generator(device=dev).manual_seed(0),
                                torch.float32, dev)
    ops = dec.gl_audio_ops
    # without iterations the block's sample 0 meets the Blackman end value
    # (-1.4e-17) unwindowed: zero that one init sample (tests/test_torch_kernels.py)
    rand0 = rand.clone()
    rand0[0, 0] = 0.0
    d0 = (cuda_gl.gl_audio(lm, rand0, ops, GL_NORM, 0, True).long()
          - cuda_gl.gl_audio_plain(lm, rand0, ops, GL_NORM, 0, True).long()).abs()
    k2_err = int(d0.max())
    say(f"  iterations=0: max |diff| {k2_err} LSB")
    check(k2_err <= 1, "K2 iterations=0 within 1 LSB")
    d1 = (cuda_gl.gl_audio(lm, rand, ops, GL_NORM, 8, False).long()
          - cuda_gl.gl_audio_plain(lm, rand, ops, GL_NORM, 8, False).long()).abs()
    within = (d1 <= 1).double().mean().item()
    say(f"  phase_bug=False, 8 iterations: {within:.6f} of samples within 1 LSB, max {int(d1.max())}")
    check(within >= 0.999, "K2 phase_bug=False within 1 LSB on >= 99.9% of samples")
    a_k = cuda_gl.gl_audio(lm, rand, ops, GL_NORM, 8, True)
    a_p = cuda_gl.gl_audio_plain(lm, rand, ops, GL_NORM, 8, True)
    att_k, att_p = attainment(torch, a_k, lm, dec.gl_ops), attainment(torch, a_p, lm, dec.gl_ops)
    r_energy = corr(torch, hop_energy(torch, a_k), hop_energy(torch, a_p))
    identical = (a_k == a_p).double().mean().item()
    say(f"  phase_bug=True, 8 iterations: attainment kernel {att_k:.4f} plain {att_p:.4f}, "
        f"per-hop energy r {r_energy:.4f}, identical samples {identical:.4f}")
    check(att_k <= 1.1 * att_p and r_energy > 0.9, "K2 phase_bug=True quality gate")
    k2_ms = cuda_ms(torch, lambda: cuda_gl.gl_audio(lm, rand, ops, GL_NORM, 8, True))
    k2_plain_ms = cuda_ms(torch, lambda: cuda_gl.gl_audio_plain(lm, rand, ops, GL_NORM, 8, True))
    say(f"  time at {MINUTES} min: kernel {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms")

    # ---- the main path --------------------------------------------------
    say(f"== main path: cli.decode.perform_offline_decoding, {C} ch, {SR} Hz, {MINUTES} min")
    torch.cuda.synchronize()
    cuda_frontend.frontend_decode_mels.launches = 0
    cuda_gl.gl_audio.launches = 0
    spec, audio, _, _ = cli.perform_offline_decoding(loaded, eeg, SR, GL_NORM, device=dev)
    torch.cuda.synchronize()
    launches = {"frontend_decode_mels": cuda_frontend.frontend_decode_mels.launches,
                "gl_audio": cuda_gl.gl_audio.launches}
    say(f"  launches: {launches}")
    check(all(n >= 1 for n in launches.values()), "both kernels launched on the main path")
    N = spec.shape[0]
    check(N == n_frames and spec.shape == (N, 40) and audio.shape == ((N - 1) * 160,),
          f"shapes spec {tuple(spec.shape)} audio {tuple(audio.shape)}")
    check(audio.dtype == torch.int16 and bool(torch.isfinite(spec).all()), "finite spec, int16 audio")

    cfg_plain = dataclasses.replace(cfg, use_cuda_frontend=False, use_cuda_gl=False)
    runs = {"plain": [], "kernel": []}
    outs = {}
    for which in ("plain", "kernel", "kernel", "plain"):
        c = cfg_plain if which == "plain" else cfg
        holder = {}
        ms = cuda_ms(torch, lambda: holder.update(out=pipeline.offline_decode(dec, c, eeg)), reps=1)
        runs[which].append(ms)
        outs[which] = holder["out"]
    path_ms = {k: float(np.mean(v)) for k, v in runs.items()}
    duration_s = T / SR
    say(f"  decode time (CUDA events, params built): kernel path {runs['kernel']} ms, "
        f"plain path {runs['plain']} ms")
    say(f"  xRT: kernel path {duration_s / (path_ms['kernel'] / 1e3):.1f}, "
        f"plain path {duration_s / (path_ms['plain'] / 1e3):.1f}")
    check(torch.equal(outs["kernel"][0], spec), "main path repeats bit-identically")
    agree_m, flips_m, _ = mel_agreement(torch, outs["kernel"][0], outs["plain"][0])
    r_m = corr(torch, hop_energy(torch, outs["kernel"][1]), hop_energy(torch, outs["plain"][1]))
    say(f"  kernel vs plain path: mel agreement {agree_m:.6f}, flips {flips_m:.6f}, "
        f"audio per-hop energy r {r_m:.4f}")
    check(agree_m >= AGREE_MIN and flips_m < FLIP_MAX and r_m > 0.9,
          "kernel path agrees with the plain path")
    say(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the float64 CPU path is the one held bit-equal to the JAX package
    # (tests/test_torch_pipeline.py): the card's f32 output must stay inside
    # the f32 label-flip budget against it on the session's first minute
    say("== reference: the first 60 s through the float64 CPU path")
    head = eeg[: 60 * SR]
    n_head = len(framing.streaming_frame_ends(cfg.frame_len_ms, cfg.frame_shift_ms, SR,
                                              head.shape[0] + cfg.prefill))
    ref_spec, ref_audio, _, _ = cli.perform_offline_decoding(
        loaded, head.cpu(), SR, GL_NORM, rand_init=rand[: n_head - 1].cpu())
    card_spec, card_audio, _, _ = cli.perform_offline_decoding(
        loaded, head, SR, GL_NORM, rand_init=rand[: n_head - 1])
    _, flips_ref, _ = mel_agreement(torch, card_spec.double().cpu(), ref_spec)
    r_ref = corr(torch, hop_energy(torch, card_audio.cpu()), hop_energy(torch, ref_audio))
    say(f"  card f32 vs CPU f64: label flips {flips_ref:.6f}, audio per-hop energy r {r_ref:.4f}")
    check(card_spec.shape == ref_spec.shape and flips_ref < FLIP_MAX and r_ref > 0.9,
          "card output within the f32 budget of the float64 path")

    # ---- the CLI end to end -----------------------------------------------
    try:
        import h5py
    except ImportError:
        say("== CLI: h5py is not installed, cli.decode.main skipped")
    else:
        say("== CLI: cli.decode.main on a fabricated 60 s session")
        with tempfile.TemporaryDirectory() as tmp:
            session = os.path.join(tmp, "storage", "demo")
            os.makedirs(session)
            with h5py.File(os.path.join(session, "params.h5"), "w") as hf:
                hf.create_dataset("bad_channels", data=np.zeros(0, np.int64))
                hf.create_dataset("medians_array", data=arrs["medians"])
                hf.create_dataset("select", data=np.asarray(arrs["select"], np.int64))
                for name in ("lda_coef", "lda_intercept", "lda_classes", "lda_valid"):
                    hf.create_dataset(name, data=arrs[name])
            seeg_file = os.path.join(tmp, "replay.hdf")
            with h5py.File(seeg_file, "w") as hf:
                hf.create_dataset("sEEG", data=eeg[: 60 * SR].cpu().numpy())
                hf.create_dataset("sEEG_sr", data=SR, dtype=np.int32)
            cfg_path = os.path.join(tmp, "experiment.ini")
            with open(cfg_path, "w") as f:
                f.write(f"[General]\nstorage_dir = {os.path.join(tmp, 'storage')}\nsession = demo\n"
                        "[Decoding]\nstream_name = x\ngriffin_lim_norm = 10\nrun = smoke\n")
            cuda_frontend.frontend_decode_mels.launches = 0
            cuda_gl.gl_audio.launches = 0
            run_dir = cli.main([cfg_path, "--seeg_file", seeg_file, "--device", "cuda"])
            cli_spec = np.load(os.path.join(run_dir, "spectrogram.npy"))
            check(all(os.path.exists(os.path.join(run_dir, f))
                      for f in ("audio.wav", "sEEG.hdf", "spectrogram.npy", "decode.ini")),
                  "CLI artifacts written")
            check(cli_spec.shape[1] == 40 and np.isfinite(cli_spec).all(), "CLI spectrogram")
            check(cuda_frontend.frontend_decode_mels.launches >= 1 and cuda_gl.gl_audio.launches >= 1,
                  "both kernels launched under the CLI")

    kernels = [
        {"name": "frontend_decode_mels", "route": "cuda",
         "source": "closed_loop_seeg_speech_synthesis_tpu_torch/csrc/frontend_decode.cu",
         "replaces": "closed_loop_seeg_speech_synthesis_tpu/ops/pallas_frontend.py:195",
         "launches": launches["frontend_decode_mels"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "gl_audio", "route": "cuda",
         "source": "closed_loop_seeg_speech_synthesis_tpu_torch/csrc/gl_audio.cu",
         "replaces": "closed_loop_seeg_speech_synthesis_tpu/ops/pallas_gl.py:153",
         "launches": launches["gl_audio"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
