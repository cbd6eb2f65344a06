#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (closed_loop_seeg_speech_synthesis_tpu_torch)
on one NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

1. Prints the card's name and power limit and the torch/CUDA versions.
2. Builds the four CUDA sources from ``csrc/`` (in parallel, one nvcc
   each) and prints the build seconds.
3. Holds each of the four kernels against its plain torch version on the
   card, at the shapes of its path: K1 (sEEG -> mel frames) and K3 (sEEG ->
   log-power features) on a 30-minute 128-channel 1024 Hz session and on
   60 s at 2048, 4096 and 8192 Hz (periods of 1,024 and 2,048 samples, which
   the kernels stream in slabs); K2 (mel frames -> int16 audio) and K4 (mel frames ->
   Griffin-Lim blocks) without iterations, with the converging phase
   estimator and with the reference's exp(angle) estimator (quality-gated,
   it is chaotic); K4's two regimes (the FFT kernel above
   ``cuda_gl.CLUSTER_MAX_B`` blocks, the thread-block cluster at or below)
   against each other on the session's first 2,048 blocks.  Each kernel's
   bound (the least time for its work: fp32 FMA at 67 TFLOP/s, 3xTF32 at
   495/3 TFLOP/s, bytes at 3.35 TB/s; the FFT kernel's DFTs at the FFT's
   5 N log2 N operations) is computed from its shapes, and the
   8 iterations' DFT products at 30 min are timed as fp32 ``torch.matmul``
   (TF32 off) for reference, as are K1's and K3's products (the Toeplitz
   Tmat u and Pmat u per period, K1's LDA).  For K1 and K3 it also prints
   the serial length of their two-level boundary scan, holds the kernel and
   the plain float32 version against the plain version in float64 on the
   session's first minute (the kernel's p99.9 error within twice the plain
   version's) and, for K1, over the 30 minutes (its label flips within
   twice the plain version's plus 1e-5: the gate that a single-pass TF32
   LDA epilogue fails, frontend_kernel_probe.py), and profiles one call of
   each, naming its launches.
3b. Holds the Griffin-Lim block inits' kernel (``csrc/prng.cu``: the JAX
   package's threefry ``uniform(fold_in(key, b), (480,))`` rows; not a TPU
   kernel, it replaces XLA's ``jax.random`` work) against its plain version,
   drawn on the CPU, bit for bit, float32 and float64: on the replay's
   whole table, on ids up to 2^31 - 1 with negatives (clamped to block 0),
   and recorded in a CUDA graph and replayed on other ids; times it at the replay's table beside its bound (its shifts and
   logic at 64 INT32 lanes per SM, a quarter of the fp32 rate, all its
   integer operations at twice that, or the bytes written).
4. Drives the offline replay decode through
   ``cli.decode.perform_offline_decoding`` at 128 ch / 1024 Hz / 30 min with
   the launch counters set to 0 first, checks that K1 and K2 launched (and
   the block inits' kernel once, for the whole table) and
   that the outputs are finite and shaped right, times the kernel path
   against the plain torch path with CUDA events, and profiles one decode
   (device busy and idle share, the heaviest kernels).
5. Decodes the session's first minute on the card and through the float64
   CPU path (the one held bit-equal to the JAX package by the tests) and
   holds the card inside the f32 label-flip budget.
6. Drives the split replay decode (``use_cuda_epilogue=False,
   use_cuda_gl_tail=False``) the same way: K3 and K4 launch, K1 and K2 do
   not, and the output stays inside the f32 budget of the fused path.
6b. The bf16 variants of K4 and K2 (``DecoderConfig.gl_bf16``, the JAX
   kernels' ``bf16=True`` branch; on the tensor cores ``gl_wgmma_kernel``,
   whose SASS must hold HGMMA instructions, cuobjdump, while the float32
   ``gl_fft_kernel`` holds none): each against its
   plain bf16 version on the replay's mel frames and inits, K4 at B = 4,
   64-65 (the cluster and the bf16 crossing), 199, 447-449 and 179,999, K2
   at 199 and 179,999,
   under the ``BF16_*`` gates (one iteration, both estimators: max |diff|
   within 1e-3 of the blocks' max, from 199 blocks on 99% of samples within
   2e-5 of it, the f32 kernel outside; K2 within 1 LSB on 99.9%; 8
   iterations: converging 99.5% within 1e-3, the quirk by attainment and
   envelope r; K2 within 1 LSB of the plain tail on K4's bf16 blocks); times
   each at 64, 199 and 179,999 blocks beside the f32 kernel in the same call,
   with the bound at the bf16 rate (989 TFLOP/s) and the DFT products as
   bf16 ``torch.matmul``; then the fused and the split replay through
   ``pipeline.offline_decode`` with ``gl_bf16=True``, counts set to 0 just
   before each: only K2's (K4's) bf16 variant runs, the spectrogram is
   bit-identical to the f32 decode's, the audio attains the target within
   1.1x of the f32 decode's and tracks the plain bf16 vocoder (envelope
   r > 0.9); decode times beside the f32 decode's, one profile.
7. Feeds 60 s of the session packet by packet (32 samples) through
   ``runtime.online.OnlineDecoder`` at full width, which replays the step
   recorded as a CUDA graph once a packet (``chunk_steps=4``: once per 4
   packets): the same 1,920 packets through a plain eager loop of
   ``pipeline.make_online_step`` give the reference, and the decoder's
   spectrogram and audio must be bit-identical to it with K = 1 and 4, each
   plain and ``pipelined``.  K4 and the block inits' kernel launch once a
   packet (the wrappers count at capture, so their launches are the graph
   replays times the nodes each graph recorded); the output has the offline
   decode's shapes and stays inside its f32 budget; prints the per-packet
   latency percentiles beside the eager loop's and gates p99 < 10 ms, the
   closed loop's limit.  Holds K4 against its plain version at
   the step's own shapes (1-4 blocks, one cluster) on the session's mel
   frames, times K4 at B = 4 over 1,000 launches, profiles 200 packets
   (1 ``cudaGraphLaunch`` and no host kernel launch a packet, device time a
   packet), and holds the online audio against
   runs of the same packets with the plain Griffin-Lim: with the converging
   estimator within 1 LSB on >= 99.9% of samples, under the exp(angle)
   quirk (chaotic in f32) within 1 LSB on >= 99% with no run of off hops
   longer than one block's 3, and by K2's quality gate
   (``k4_vs_plain_audio``).
8. Closes the loop over the native NSX transport:
   ``cli.dev_streamer.stream_eeg`` feeds 20 s, paced in real time, to
   ``cli.decode.perform_online_decoding`` in a thread; the received sEEG
   equals what was sent and the output equals a direct ``OnlineDecoder``
   run of the same packets.
8b. Runs the persistent loop (``runtime.online.PersistentOnlineDecoder``,
   ``csrc/persistent_loop.cu``) on phase 7's decoder and packets: the 1,920
   packets queued before ``warmup()``, one ``run_until_stopped()``; the
   session is one graph launch of 1,921 iterations (the STOP included) and
   its output is bit-identical to phase 7's ``OnlineDecoder``; the
   captured step holds one node of the block inits' kernel.  A profiled
   100-packet session counts 1 ``cudaGraphLaunch`` and 101
   ``gl_cluster_kernel`` runs (K4's wrapper counts only at capture: the
   kernels line gives K4's persistent launches as iterations times its
   nodes in the captured step).  Sessions with the plain Griffin-Lim are
   held as in step 7 (``k4_vs_plain_audio``), under the quirk with the
   inits of threefry keys 0-4; packets fed 2 ms apart give the
   latency percentiles beside phase 7's; a 20 s real-time NSX loopback
   through ``perform_online_decoding(persistent=True)`` receives every
   packet and equals a direct persistent run; a feeder that raises after 2
   packets returns its error; a matmul on another stream completes while a
   loop waits and after it is aborted.
9. After step 11, drives the CLIs end to end on files that the port's own
   HDF5 codec (``io/hdf5.py``; the card's machine has neither h5py nor
   sklearn) writes in a temporary directory, each stage's wall time printed:
   the codec's write and read MB/s on the 30-min 128-ch training recording
   (1.9 GB of float64 sEEG), its sEEG read beside ``np.fromfile`` of the
   same bytes; (a) ``cli.train.main`` on a 60 s recording, its params.h5
   equal to ``trainer.train`` + ``store_training`` on the same arrays, and
   its LDAs.pkl (the estimators blob) read by the restricted unpickler
   carrying the same arrays; (b) ``cli.decode.main`` offline with that model
   and with the seed-0 published-width one: K1, K2 and the inits' kernel
   launch, spectrogram.npy bit-identical and audio.wav equal to
   ``perform_offline_decoding`` on the same arrays, sEEG.hdf read back
   equal; (c) ``--vocoder exact-host`` (audio byte-equal to
   ``ops/host_vocoder`` on the same spectrogram and inits) and ``--profile``
   (the trace names ``gl_fft_kernel`` and K1's kernels); (d) decodes with
   the committed h5py-written fixtures (the JAX package's params.h5, the
   reference's blob-only one, a gzip-chunked recording), equal to the
   arrays' decode; (e) ``cli.dev_streamer.main`` streaming 20 s in real time
   over NSX to the online decode CLI (every packet received, sEEG.hdf equal
   to the streamed samples, markers logged); (f) the 100-word protocol
   session through ``cli.train.main`` and ``cli.evaluate.main`` exp4 and
   exp1 (one chance run), its proposed mean r within 0.01 of step 11's.
10. Trains: a word-locked synthetic session (600 trials of 3 s: a 120 Hz
   burst on half the channels and a voiced harmonic stack in 48 kHz audio
   during each trial's first 2 s) at 128 ch / 1024 Hz / 30 min goes through
   ``runtime.trainer.train`` on the card in float32 and float64, with the
   time and peak device memory of each stage.  The two models agree (the
   selected features as a set, the training-set predictions, the missing
   intervals, the quantizer's medians and borders within 5e-3); each decodes the first 5 minutes through
   ``perform_offline_decoding`` (K1 and K2 launch), the two LDAs' decodes
   (with the same medians) agree inside the f32 label-flip budget, and the
   two models' mean per-bin Pearson r against the training target agree.
   A 60 s slice trains on the card in float64 and through the float64 CPU
   path (the one the tests hold to the JAX package): the same features,
   coefficients within rtol 1e-6.
11. Runs experiment 1 on the card: the protocol session of
   ``benchmarks/exp1_protocol.py`` (100 words, 128 ch, 1024 Hz, 48 kHz
   audio, seed 0; ``io.session.make_synthetic_session``) trains its model,
   then ``eval.exp1.Experiment1`` from arrays (``RandomState(0)``) in float32
   runs the 10-fold proposed method (K1 and K2 launch once a fold) and
   ``EXP1_RUNS`` chance runs of 10 folds (K1 once a fold, no K2); prints the
   proposed mean per-bin r beside the TPU record's, the chance runs' r and
   the time of one chance run by stage.  Gates: proposed r >= 0.9 and above
   every chance run's; one fold in f32 through K1 + K2 against the same fold
   in float64 within the label-flip budget and 0.02 of its r.  K1 and K2 are
   held against their plain versions at a fold's shapes (K1's scan there
   has a ragged last chunk) under step 3's gates and timed there; the
   kernels line records the launches counted in one fold, in the proposed
   method and per chance fold.
12. Runs experiments 2-4 on the card at ``benchmarks/eval_full.py``'s
   operating point: a 100-word 64-ch session (``make_synthetic_session``,
   seed 0) trains its model in f32; the whisper and imagine runs are the
   session's sEEG decoded through ``perform_offline_decoding`` (K1 and K2
   once each) and go into ``DecodingRun.from_arrays``; for each run
   ``eval.exp2.Experiment2`` (``RandomState(1)``, 120 s of ``RandomState(3)``
   other-task noise) scores the matched trials and ``EXP2_RUNS`` chance
   segments of 2 s (``chance_level_batched``: K1 once a segment, no K2; the
   protocol's 1,000: ``exp2_protocol_torch.py``); then ``Experiment3`` on both
   runs and ``Experiment4`` on the model.  Gates: matched median r > 3 x
   max(chance median, 0.01) per run; speech inside the trials > 0 and >
   outside; finite activations, max |a| > 0; the sequential twin
   ``chance_level`` (K1 and K2 a segment) equal to the batched chance level
   on ``EXP2_SEQ`` segments; one segment in f32 through K1 against the
   float64 path inside the label-flip budget and 0.02 of its r; K1 at a
   segment's shapes (200 frames) and K2 on its 199 blocks, the cluster
   regime, against their plain versions under step 3's gates (K2 through
   ``k2_agreement``).  Prints exp2's time by stage (the segments' staging,
   K1 decodes, spectrograms, DTW on the host, correlations), exp3's and
   exp4's, and K1's and K2's CUDA-event times and bounds at a segment's
   shapes; skips the figure drawings, on a line that says so, where
   matplotlib is not installed.

13. Runs the parallel phase (``parallel.distributed``) on the one card at
   full width (128 ch, 1024 Hz, 40 bins, 9 classes, 150 features, f32) on
   the training step's word-locked session, with two gloo ranks spawned by
   the dryruns (the inputs written once, each rank maps its sessions):
   first, in this process, K1 and K2 on one 5-min session (1,200 periods,
   a ragged scan chunk of 35) and K3 on its 64-channel block against their
   plain versions, under step 3's gates and ``k2_agreement``; then the
   data-parallel replay of 4 sessions of 5 min, 2 a rank (each rank's K1
   and K2 launches equal its sessions; the gathered shards against the
   parent's ``offline_decode`` of the same sessions and inits, the spectra
   inside the f32 budget, the audio within 1 LSB); the channel-sharded
   decode of one 5-min session, 64 channels a rank (K3 once a rank, K2 once
   a rank, both ranks' outputs identical; against the unsharded split
   decode, the spectra inside the f32 budget and the audio within 1 LSB,
   which also holds each rank's Griffin-Lim inits); one model fitted from 4
   sessions of 7.5 min (30 min pooled, 16 kHz audio) split over the ranks
   (the replicas identical; against the parent's single-process step on
   the pooled batch: the select equal, medians within 1e-5, coefficients
   within rtol 1e-3, atol 1e-4); one ``distributed_replay`` on an NCCL world
   of 1 in this process (an NCCL all-reduce, the decode equal to the
   parent's).  Prints each run's time by stage (spawn + init, compute,
   collectives) and each rank's launches.

``python3 chip_smoke.py --bf16`` runs step 6b alone (after the build, on
the same session, with the float32 fused and split decodes as its
references) and ends with the card's line.

Any failure exits nonzero.  The line before the last is the kernels' JSON
record, the last line ``{"ok": true, "device": {...}}``.  Without a CUDA
device it exits 1 and prints no result.
"""

import argparse
import concurrent.futures
import configparser
import contextlib
import dataclasses
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

SR, C, MINUTES, MINUTES_2048 = 1024, 128, 30, 1
LONG_RATES, LONG_S = (4096, 8192), 60  # periods over 512 samples: K1/K3 stream them in slabs
EXP1_WORDS, EXP1_RUNS, EXP1_FOLDS = 100, 20, 10  # benchmarks/exp1_protocol.py's session; chance runs
EXP1_R_MIN, EXP1_R_DIFF = 0.9, 0.02  # proposed mean r (TPU record 0.935); f32 vs f64 fold
TPU_EXP1_R, TPU_CHANCE_MAX = 0.935, 0.4609  # benchmarks/recorded/exp1_protocol_128ch.json
# exp2-exp4: benchmarks/eval_full.py's operating point (:78, :113-114, :176):
# 100 words at 64 ch, 120 s of RandomState(3) other-task noise, chance draws
# from RandomState(1), 20 chance segments a run (the protocol's 1,000:
# exp2_protocol_torch.py); the sequential twin against the batched chance
# level on EXP2_SEQ segments
EXP2_WORDS, EXP2_C, EXP2_OTHER_S, EXP2_RUNS, EXP2_SEQ = 100, 64, 120, 20, 4
EXP2_R_DIFF, SEGMENT_REPS = 0.02, 200  # f32 vs f64 segment score; K1/K2 launches timed at a segment
EXP2_RUNS_DECODED = ("whisper", "imagine")
VAD = {"vad_energy_threshold": "0.5", "vad_energy_mean_scale": "1", "vad_frames_context": "5",
       "vad_proportion_threshold": "0.6"}  # benchmarks/eval_full.py's Experiment3 section
# the TPU record on this operating point (BENCHMARKS.md:350-363): matched-trial
# median r, chance median r; speech seconds inside / outside the trials
TPU_EXP2 = {"whisper": (0.101, 0.011), "imagine": (0.100, 0.011)}
TPU_EXP3 = (196.3, 5.6)
ONLINE_S, LOOP_S, PACKET = 60, 20, 32
N_FEATS, GL_NORM = 150, 10.0
AGREE_RTOL, AGREE_ATOL, AGREE_MIN = 1e-5, 1e-6, 0.999   # tests/test_pallas_kernels.py:125-126
FLIP_RTOL, FLIP_ATOL, FLIP_MAX = 1e-4, 1e-5, 0.02       # tests/test_f32_error_budget.py:51-53
K3_ATOL, K4_ATOL, WITHIN_MIN = 1e-4, 2e-4, 0.999         # tests/test_pallas_kernels.py:76, :24
F64_FLIP_FLOOR = 1e-5  # K1's flips against float64 allowed beyond twice the plain f32 version's
AUDIO_SR, TRIAL_S, TRAIN_DECODE_MIN, TRAIN_SLICE_S = 48000, 3, 5, 60
# the CLI phase: packets the online decode CLI takes from the dev streamer's
# LOOP_S s (10 s of them); its exp1 against phase 11's on the same session,
# whose dither the CLI draws from an unseeded RandomState() as the JAX CLI does
CLI_ONLINE_PACKETS, CLI_EXP1_R_DIFF = 320, 0.01
SELECT_MIN, PREDICT_MIN, R_DIFF_MAX, R_MIN, COEF_RTOL = 0.95, 0.98, 0.02, 0.15, 1e-6
QUANT_MAX = 5e-3  # log-mel; a quarter of docs/NUMERICS.md:155's max 2e-2 for f32 targets
# H100 SXM peaks (NVIDIA's data sheet, dense): fp32 FMA outside the tensor
# cores, TF32 tensor cores (3xTF32 takes three passes), bf16 tensor cores, HBM3
FP32_FLOPS, TF32_FLOPS, BF16_FLOPS, HBM_BYTES_S = 67e12, 495e12, 989e12, 3.35e12
# 32-bit integer operations: shifts and logic issue only on the 64 INT32
# lanes per SM a clock (a quarter of the fp32 rate's 128 lanes x 2, NVIDIA's
# Hopper white paper), adds also as IMAD on the FMA pipe, so at most twice
# that.  threefry2x32 is 72 operations (2 + 20 rounds of add, rotate, xor +
# 5 key injections of 2 adds), 40 of them rotates and xors; uniform's
# mantissa fill 4 (xor, shift, or, subtract), 3 of them shift and logic
INT32_OPS, THREEFRY_OPS, THREEFRY_ALU, UNIFORM_OPS, UNIFORM_ALU = FP32_FLOPS / 4, 72, 40, 4, 3
K4_ONLINE_LAUNCHES, PR3_K4_B4_MS = 1000, 0.656  # PR 3's K4 at B = 4 (PERF.md)
# the parallel phase: gloo ranks on the one card, sessions of the replay
# and of the training (4 x 7.5 min = the 30-min training session)
PAR_RANKS, PAR_SESSIONS, PAR_REPLAY_S, PAR_TRAIN_S = 2, 4, 300, 450
PAR_MEDIANS_ATOL, PAR_COEF_RTOL, PAR_COEF_ATOL = 1e-5, 1e-3, 1e-4  # tests/test_distributed.py:73-77
REGIME_BLOCKS = 2048
PROFILE_PACKETS = 200
# The profiled persistent session: 101 iterations of ~190 kernels, ~19k CUPTI
# activity records.  At 200 packets (~38k) one call's profile missed ~4.7
# iterations' records of every kernel alike while the loop ran all 201 (the
# output bit-identical, the loop's own counter exact; PERF.md).
PERSISTENT_PROFILE_PACKETS = 100
P99_LIMIT_MS = 10.0  # the closed loop's per-packet p99 limit (BASELINE.md, PERF.md section 2)
PERSISTENT_GAP_S = 0.002  # the persistent phase's latency run: packets 2 ms apart
# online audio under the reference's exp(angle) quirk, K4 against the plain
# Griffin-Lim: the share of samples within 1 LSB, and the longest run of
# HOP-sample hops with a sample off by more than 1 LSB (a decohered block of
# 480 samples touches its own 3 hops).  Over the threefry keys 0 ..
# QUIRK_KEYS - 1 the share read 0.994601-0.996570, each run at most 3 hops
# (PERF.md); the persistent phase holds every key, phase 7 key 0.
QUIRK_WITHIN_MIN, QUIRK_MAX_RUN, QUIRK_KEYS, HOP = 0.99, 3, 5, 160
# The bf16 variants of K2 / K4 (DecoderConfig.gl_bf16): K4 in the cluster
# regime and across its bf16 threshold (cuda_gl.CLUSTER_MAX_B_BF16 = 64), at
# 447-449, K2 at exp2's sequential twin's 199 blocks, both at
# the replay's blocks on the wgmma kernel.  One iteration: a bf16
# kernel and its plain version differ only where another summation order
# moves a frame or Z value across a bf16 rounding boundary (one bf16 step of
# it times an inverse-DFT entry): max |diff| within BF16_ONE_MAX of the
# blocks' max |value| (the f32 kernel is 0.4-34% off, PERF.md), and from 199
# blocks on >= BF16_ONE_SHARE of the samples within BF16_ONE_ATOL of it.
# 8 iterations, converging: tests/test_torch_gl_bf16.py's gate; under the
# quirk, test_gl_bf16_quality's (attainment <= 1.1x, envelope r > 0.9).
BF16_K4_BLOCKS, BF16_K2_BLOCKS = (4, 64, 65, 199, 447, 448, 449), (199,)
BF16_ONE_MAX, BF16_ONE_ATOL, BF16_ONE_SHARE = 1e-3, 2e-5, 0.99
BF16_CONV_ATOL, BF16_CONV_MIN, BF16_ATTAIN, BF16_R = 1e-3, 0.995, 1.1, 0.9


def say(*args):
    print(*args, flush=True)


def check(ok, what):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")
    say(f"  ok: {what}")


def bound(fp32_flops, nbytes, tf32x3_flops=0.0, int32_ops=0.0, bf16_flops=0.0):
    """(ms, "operations" or "bytes"): the least time for the work on one H100."""
    t_ops = (fp32_flops / FP32_FLOPS + 3 * tf32x3_flops / TF32_FLOPS + int32_ops / INT32_OPS
             + bf16_flops / BF16_FLOPS)
    t_mem = nbytes / HBM_BYTES_S
    return max(t_ops, t_mem) * 1e3, "operations" if t_ops >= t_mem else "bytes"


@contextlib.contextmanager
def regime_threshold(cuda_gl, cluster_max_b):
    """Force the Griffin-Lim regime: launches of B <= cluster_max_b blocks
    take the cluster kernel, larger ones the large-B kernel."""
    saved = cuda_gl.CLUSTER_MAX_B, cuda_gl.CLUSTER_MAX_B_BF16
    cuda_gl.CLUSTER_MAX_B = cuda_gl.CLUSTER_MAX_B_BF16 = cluster_max_b
    try:
        yield
    finally:
        cuda_gl.CLUSTER_MAX_B, cuda_gl.CLUSTER_MAX_B_BF16 = saved


def gl_bound(cuda_gl, B, NM, iterations, phase_bug, ops, tail=False, bf16=False):
    """Bound of K4 (or, with ``tail``, K2) on B blocks in the regime its
    launch picks, all in fp32 FMA: the dense DFT products in the cluster
    regime, two 256-point complex FFTs (5 N log2 N operations each) a block
    and iteration above CLUSTER_MAX_B; with ``bf16`` (threshold
    CLUSTER_MAX_B_BF16) the products at the bf16 tensor-core rate in either
    regime (one pass on bf16 operands).  The target magnitudes,
    the Nyquist bin and K2's overlap-add and low-pass in fp32 FMA.  Bytes:
    the mel frames and inits read once, the blocks (K4) or int16 audio (K2)
    written once, and the constants (bf16: the DFT operands as bf16)."""
    frames, kin = 2 * B, 128 if phase_bug else 256
    large = cuda_gl.regime(B, bf16) != "cluster"
    if large and not bf16:
        dft = 2.0 * B * iterations * 5 * 256 * 8
    else:
        dft = 2.0 * frames * iterations * 256 * (256 + kin)
    other = 2.0 * (frames * NM * 129 + frames * iterations * 2 * 256)
    # the operands the regime reads: the twiddle table or the f32 DFTs
    consts = sum(t.numel() * 4 for t in (ops.gl_f32[:1] + ops.gl_f32[3:] + (ops.gl_twiddles,)
                                         if large else ops.gl_f32))
    if bf16:  # the wgmma kernel reads the bf16 image, the cluster kernel the rounded f32 operands
        consts = sum(t.numel() * t.element_size() for t in ops.gl_f32[:1] + ops.gl_f32[3:]
                     + (ops.gl_bf16[2:] if large else ops.gl_bf16[:2]))
    nbytes = (B + 1) * NM * 4 + B * 480 * 4 + consts
    if tail:
        S, n_pow = ops.lp.dim, ops.n_pow
        other += 2.0 * B * (S * 160 + n_pow * S * S + 160 * S + 160 * 161 / 2)
        nbytes += B * 160 * 2 + sum(t.numel() * 4 for t in ops.tail_f32)
    else:
        nbytes += B * 480 * 4
    if bf16:
        return bound(other, nbytes, bf16_flops=dft)
    return bound(other + dft, nbytes)


def frontend_bound(fops, T, C, n_frames, W5=None):
    """Bound of K1 (with the epilogue's LDA weights ``W5``) or K3, the
    products at the 3xTF32 rate, as the kernels run them: per period of Ls
    samples and channel the causal Toeplitz product Ls (Ls + 1) / 2, Cpow s
    and Pmat u 2 S Ls; K1's LDA (5C, 9 x 40) per frame.  In fp32: the
    boundary step S^2 per period and channel, the windowed power win per
    frame and channel, K1's smoothing per frame.  Bytes: the sEEG read once,
    mel frames or features written once."""
    Ls, S = fops.Ls, fops.A_L.shape[0]
    periods = -(-T // Ls)
    products = periods * C * (Ls * (Ls + 1) / 2 + 2 * S * Ls)
    fma = periods * C * S * S + n_frames * C * fops.win
    nbytes = T * C * 4
    if W5 is None:
        nbytes += n_frames * C * 4
    else:
        n_out = W5.shape[1] // 9
        products += n_frames * W5.numel()
        fma += n_frames * n_out * n_out
        nbytes += n_frames * n_out * 4 + W5.numel() * 4
    return bound(2.0 * fma, nbytes, 2.0 * products)


def inits_bound(B, itemsize):
    """Bound of the block inits' kernel on B rows of 480: one threefry for
    each row's key (fold_in) and one plus the mantissa fill for each sample,
    its shifts and logic at the INT32 rate, all its operations at twice it;
    bytes: the ids read once, the rows written once."""
    alu = B * THREEFRY_ALU + B * 480 * (THREEFRY_ALU + UNIFORM_ALU)
    ops = B * THREEFRY_OPS + B * 480 * (THREEFRY_OPS + UNIFORM_OPS)
    return bound(0.0, B * 8 + B * 480 * itemsize, int32_ops=max(alu, ops / 2))


def block_inits_phase(torch, dev, card, B):
    """csrc/prng.cu against its plain version, drawn on the CPU, bit for bit
    (the replay's table of B rows, wide and negative ids, a captured graph),
    and its time at the table beside its bound.  Returns the figures of its
    kernels line."""
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import cuda_prng, prng
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import griffinlim as gl

    n = gl.BLOCK_SAMPLES
    table = torch.arange(B, device=dev)
    wide = torch.tensor([-2**40, -7, -1, 0, 1, 479, 181_000, 2**31 - 2, 2**31 - 1], device=dev)
    err = 0.0
    for dt in (torch.float32, torch.float64):
        for name, ids in (("table", table), ("wide ids", wide)):
            for key in (0, prng.fold_in(0, 3)):
                k = cuda_prng.block_inits(ids, key, n, dt)
                p = cuda_prng.block_inits_plain(ids, key, n, dt)
                torch.cuda.synchronize()
                err = max(err, (k.double() - p.double()).abs().max().item())
                check(torch.equal(k, p), f"block inits {dt}, {name} ({ids.shape[0]} rows), key "
                      f"{key}: kernel bit-equal to its plain version on the CPU")
    ids = torch.arange(4, device=dev)
    graph = torch.cuda.CUDAGraph()
    before = cuda_prng.block_inits.launches
    with torch.cuda.graph(graph):
        out = gl.block_rand(ids, 0, torch.float32)
    nodes = cuda_prng.block_inits.launches - before
    replays_ok = []
    for first in (0, 1000, B - 4, -2):
        ids.copy_(torch.arange(first, first + 4, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        replays_ok.append(torch.equal(out, cuda_prng.block_inits_plain(ids, 0, n, torch.float32)))
    check(nodes == 1 and all(replays_ok), "block inits recorded as one graph node, bit-equal to "
          "the plain version on each replay")
    ms = cuda_ms(torch, lambda: cuda_prng.block_inits(table, 0, n, torch.float32))
    plain_ms = cuda_ms(torch, lambda: cuda_prng.block_inits_plain(table, 0, n, torch.float32))
    rand_ms = cuda_ms(torch, lambda: torch.rand((B, n), device=dev))
    bnd = inits_bound(B, 4)
    say(f"  time at the replay's table ({B} x {n} f32): kernel {ms:.4f} ms, plain (on the CPU, "
        f"then copied to the card) {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}); for reference torch.rand (Philox, another "
        f"function) {rand_ms:.4f} ms [{card}]")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound": bnd,
            "reference_torch_rand_ms": rand_ms, "graph_nodes": nodes}


def float64_tracking(torch, kernel, plain, args):
    """p99.9 |error| of the kernel and of the plain float32 version against
    the plain version in float64 on the same inputs: (kernel, plain f32)."""
    ops, x, s0, *rest = args
    ref = plain(ops, x.double(), s0.double(), *rest).double()
    p999 = lambda out: (out.double() - ref).abs().flatten().quantile(0.999).item()
    return p999(kernel(*args)), p999(plain(*args))


def float64_flips_ok(flips_kernel, flips_plain):
    """K1's float64 gate: the kernel's label-flip rate against the plain
    version in float64 at most twice the plain float32 version's, plus
    F64_FLIP_FLOOR (a few flips of near-ties, which both make at random)."""
    return flips_kernel <= 2 * flips_plain + F64_FLIP_FLOOR


def profile(torch, fn, units, unit, top=6):
    """Run ``fn`` once under torch.profiler: wall and device-busy ms, the
    idle share, the heaviest device kernels, and kernel and graph launches
    per ``unit`` (``units`` of them in the run); returns the totals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    events = prof.key_averages()
    # device-side events only (kernels, copies): a host op's device time
    # repeats that of the kernels it launched
    dev = {e.key: e.self_device_time_total / 1e3 for e in events
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    busy = sum(dev.values())
    launches = sum(e.count for e in events if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    graph_launches = sum(e.count for e in events if e.key.startswith("cudaGraphLaunch"))
    say(f"  profile: {wall:.3f} ms (CUDA events), device busy {busy:.3f} ms, idle share "
        f"{1 - busy / wall:.3f}; {launches / units:.1f} kernel launches and "
        f"{graph_launches / units:.2f} cudaGraphLaunch a {unit}")
    for name, ms in sorted(dev.items(), key=lambda kv: -kv[1])[:top]:
        say(f"    {ms:9.3f} ms  {100 * ms / busy:5.1f}%  {ms * 1e3 / units:9.2f} us a {unit}  {name[:90]}")
    return {"wall_ms": wall, "busy_ms": busy, "kernel_launches": launches,
            "graph_launches": graph_launches}


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


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def launch_counters(torch):
    """(zero_counts, read_counts) over the kernel wrappers' launch counts
    (K2's and K4's bf16 variants apart), each synchronized with the card."""
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import cuda_frontend, cuda_gl, cuda_prng

    counters = {"frontend_decode_mels": (cuda_frontend.frontend_decode_mels, "launches"),
                "frontend_logpower": (cuda_frontend.frontend_logpower, "launches"),
                "gl_audio": (cuda_gl.gl_audio, "launches"),
                "gl_blocks": (cuda_gl.gl_blocks, "launches"),
                "block_inits": (cuda_prng.block_inits, "launches"),
                "gl_audio_bf16": (cuda_gl.gl_audio, "launches_bf16"),
                "gl_blocks_bf16": (cuda_gl.gl_blocks, "launches_bf16")}

    def zero_counts():
        torch.cuda.synchronize()
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read_counts():
        torch.cuda.synchronize()
        return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}

    return zero_counts, read_counts


def k1_inputs(d, c, x):
    """K1's arguments for decoder params ``d``, config ``c`` and sEEG x (T, C)."""
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import cuda_frontend, framing
    from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import pipeline

    s0 = pipeline._initial_state(d, x).contiguous()
    consts = cuda_frontend.epilogue_constants(d.lda_coef_full, d.lda.intercept, d.lda.valid,
                                              d.lda.classes, d.medians, d.gauss_kernel,
                                              c.n_channels, c.model_order)
    nf = len(framing.streaming_frame_ends(c.frame_len_ms, c.frame_shift_ms, c.sr,
                                          x.shape[0] + c.prefill))
    return (d.frontend_ops, x, s0, *consts, nf, c.model_order, c.step_size)


def k3_agreement(torch, args, label):
    """K3 against its plain version on the same inputs (ops, x, s0,
    n_frames): shape, finite, within K3_ATOL on WITHIN_MIN of the features.
    Returns the max |diff|."""
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import cuda_frontend

    F_k = cuda_frontend.frontend_logpower(*args)
    F_p = cuda_frontend.frontend_logpower_plain(*args)
    err = (F_k - F_p).abs()
    within = (err <= K3_ATOL).double().mean().item()
    say(f"  {label}: {within:.6f} of features within {K3_ATOL}, max abs err {err.max().item():.3e}")
    check(F_k.shape == F_p.shape == (args[3], args[1].shape[1])
          and bool(torch.isfinite(F_k).all()), f"K3 {label} shape, finite")
    check(within >= WITHIN_MIN, f"K3 {label} within atol {K3_ATOL} on >= 99.9%")
    return err.max().item()


def k2_agreement(cuda_gl, lm, rand, ops, label):
    """K2 against its plain version on the same inputs: without iterations
    within 1 LSB everywhere, with 8 converging iterations within 1 LSB on
    WITHIN_MIN of the samples.  Without iterations a block's sample 0 meets
    the Blackman end value (-1.4e-17) unwindowed, so that one init sample is
    zeroed (tests/test_torch_kernels.py).  Returns the max |diff| without
    iterations, in LSB."""
    rand0 = rand.clone()
    rand0[0, 0] = 0.0
    lsb = lambda r, iterations, phase_bug: (
        cuda_gl.gl_audio(lm, r, ops, GL_NORM, iterations, phase_bug).long()
        - cuda_gl.gl_audio_plain(lm, r, ops, GL_NORM, iterations, phase_bug).long()).abs()
    d0, d1 = lsb(rand0, 0, True), lsb(rand, 8, False)
    err, within = int(d0.max()), (d1 <= 1).double().mean().item()
    say(f"  {label}, B = {lm.shape[0] - 1}: iterations=0 max |diff| {err} LSB; phase_bug=False, "
        f"8 iterations: {within:.6f} of samples within 1 LSB, max {int(d1.max())}")
    check(err <= 1, f"K2 {label} iterations=0 within 1 LSB")
    check(within >= WITHIN_MIN, f"K2 {label} phase_bug=False within 1 LSB on >= {WITHIN_MIN} of samples")
    return err


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


def hop_runs(d):
    """Lengths of the runs of consecutive HOP-sample hops of |diff| ``d``
    that hold a sample off by more than 1 LSB."""
    off = np.flatnonzero(d[: len(d) // HOP * HOP].reshape(-1, HOP).max(1) > 1)
    if not len(off):
        return []
    ends = np.flatnonzero(np.diff(off) > 1) + 1
    return np.diff(np.concatenate([[0], ends, [len(off)]])).tolist()


def k4_vs_plain_audio(torch, label, audio_k, audio_p, spec, gl_ops, converging):
    """int16 audio of K4 runs against the plain Griffin-Lim runs of the same
    packets.  With the converging estimator the two agree as K4's blocks
    do: within 1 LSB on >= WITHIN_MIN of the samples.  Under the reference's
    exp(angle) quirk float32 Griffin-Lim is chaotic (docs/NUMERICS.md): a
    rounding difference at a near-zero bin flips its angle and decoheres
    the block, and how many blocks do depends on the inits.  There the
    audio is held within 1 LSB on >= QUIRK_WITHIN_MIN of the samples, with
    no run of off hops longer than QUIRK_MAX_RUN (one decohered block's),
    and by the quality gate K2 and K4 take under the quirk: attainment
    within 1.1x of the plain run's, per-hop energy r > 0.9.  Returns the
    share within 1 LSB and the longest run (0 when converging)."""
    d = np.abs(audio_k.astype(np.int64) - audio_p.astype(np.int64))
    within = float((d <= 1).mean())
    msg = f"  {label}: {within:.6f} of samples within 1 LSB, max {int(d.max())} LSB"
    if converging:
        say(msg)
        check(within >= WITHIN_MIN, f"{label}: within 1 LSB on >= 99.9% of samples")
        return within, 0
    runs = hop_runs(d)
    longest = max(runs, default=0)
    dev = gl_ops.window.device
    a_k, a_p = (torch.as_tensor(a, device=dev) for a in (audio_k, audio_p))
    lm = torch.as_tensor(spec, device=dev)
    att_k, att_p = attainment(torch, a_k, lm, gl_ops), attainment(torch, a_p, lm, gl_ops)
    r = corr(torch, hop_energy(torch, a_k), hop_energy(torch, a_p))
    say(f"{msg}, {len(runs)} runs of hops off by > 1 LSB (longest {longest}); attainment K4 "
        f"{att_k:.4f} plain {att_p:.4f}, per-hop energy r {r:.4f}")
    check(within >= QUIRK_WITHIN_MIN and longest <= QUIRK_MAX_RUN,
          f"{label}: within 1 LSB on >= {QUIRK_WITHIN_MIN} of samples, no run of off hops "
          f"longer than {QUIRK_MAX_RUN}")
    check(att_k <= 1.1 * att_p and r > 0.9, f"{label}: the exp(angle) quality gate")
    return within, longest


def corr(torch, a, b):
    return torch.corrcoef(torch.stack([a, b]))[0, 1].item()


def blocks_attainment(torch, re, log_mels, gl_ops):
    """tests/test_pallas_kernels.py::test_gl_bf16_quality's attainment of
    Griffin-Lim blocks: ||(|rfft(first frame)| - target)|| / ||target||."""
    target = torch.exp(log_mels[: re.shape[0]].double()) @ gl_ops.Minv.double()
    mag = torch.fft.rfft(re[:, :256].double() * gl_ops.window.double(), dim=1).abs()
    return ((mag - target).norm() / target.norm()).item()


def sass_counts(_build, name, mnemonic):
    """{kernel function (mangled): number of ``mnemonic`` instructions} in the
    SASS of the built csrc/<name>.cu (cuobjdump beside nvcc)."""
    lib = _build.BUILD_DIR / _build.build_info[name]["library"]
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and mnemonic in line:
            counts[fn] += 1
    return counts


def bf16_phase(torch, card, dec, cfg, eeg, lm, rand, refs, zero_counts, read_counts):
    """K2's and K4's bf16 variants against their plain bf16 versions on the
    replay's mel frames and inits, under the BF16_* gates; the fused and the
    split replay with ``gl_bf16=True`` (``refs``: the float32 decodes'
    (spectrogram, audio), fused and split), each driven with the counts set
    to 0 just before it; the times beside the float32 kernels' in this call.
    Returns the figures of the two kernels lines."""
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import _build, cuda_gl
    from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import pipeline

    ops, B_gl, NM = dec.gl_audio_ops, rand.shape[0], lm.shape[1]
    k4, k2 = {}, {}
    say(f"== bf16 variants of K4 / K2 (DecoderConfig.gl_bf16) vs their plain bf16 versions")
    hgmma = sass_counts(_build, "gl_audio", "HGMMA")
    wgmma = [v for f, v in hgmma.items() if "gl_wgmma_kernel" in f]
    fft = [v for f, v in hgmma.items() if "gl_fft_kernel" in f]
    say(f"  SASS (cuobjdump -sass): HGMMA instructions in the two gl_wgmma_kernel instantiations "
        f"{wgmma}, in the two gl_fft_kernel ones {fft}")
    check(len(wgmma) == 2 and min(wgmma) > 0 and fft == [0, 0],
          "gl_wgmma_kernel issues wgmma (HGMMA) in both estimators; gl_fft_kernel, float32, "
          "none")
    for fig in (k4, k2):
        fig["kernel"] = "gl_wgmma_kernel"
        fig["hgmma_instructions"] = wgmma
    for B in BF16_K4_BLOCKS + (B_gl,):
        l, r = lm[: B + 1].contiguous(), rand[:B].contiguous()
        label = f"K4 bf16, B = {B} ({cuda_gl.regime(B, True)})"
        for bug in (False, True):
            k = cuda_gl.gl_blocks(l, r, ops, 1, bug, bf16=True)
            p = cuda_gl.gl_blocks_plain(l, r, ops, 1, bug, bf16=True)
            err, scale = (k - p).abs(), p.abs().max().item()
            rel = err.max().item() / scale
            share = (err <= BF16_ONE_ATOL * scale).double().mean().item()
            f32_rel = (cuda_gl.gl_blocks(l, r, ops, 1, bug) - p).abs().max().item() / scale
            say(f"  {label}, phase_bug={bug}, 1 iteration: max |diff| {rel:.3e} of the blocks' "
                f"max |value| {scale:.4f} (the f32 kernel: {f32_rel:.3e}); {share:.6f} of samples "
                f"within {BF16_ONE_ATOL} of it")
            big = B >= 199
            check(bool(torch.isfinite(k).all()) and rel <= BF16_ONE_MAX
                  and (not big or (share >= BF16_ONE_SHARE and f32_rel > BF16_ONE_MAX)),
                  f"{label}, phase_bug={bug}, 1 iteration: max |diff| <= {BF16_ONE_MAX} of the "
                  f"blocks' max" + (f", >= {BF16_ONE_SHARE} within {BF16_ONE_ATOL} of it, the "
                                    "f32 kernel outside" if big else ""))
            if B == B_gl:
                k4[f"one_iteration_{'quirk' if bug else 'converging'}"] = {
                    "max_abs_err": err.max().item(), "max_rel": rel, "share_within": share,
                    "f32_kernel_max_rel": f32_rel}
        e8 = (cuda_gl.gl_blocks(l, r, ops, 8, False, bf16=True)
              - cuda_gl.gl_blocks_plain(l, r, ops, 8, False, bf16=True)).abs()
        within = (e8 <= BF16_CONV_ATOL).double().mean().item()
        kq, fq = cuda_gl.gl_blocks(l, r, ops, 8, True, bf16=True), cuda_gl.gl_blocks(l, r, ops, 8, True)
        att_k, att_f = (blocks_attainment(torch, x, l, dec.gl_ops) for x in (kq, fq))
        r_q = corr(torch, hop_energy(torch, kq), hop_energy(torch, fq))
        say(f"  {label}, 8 iterations: converging {within:.6f} of samples within {BF16_CONV_ATOL}; "
            f"quirk attainment bf16 {att_k:.4f} f32 kernel {att_f:.4f}, per-hop envelope r {r_q:.4f}")
        check(within >= BF16_CONV_MIN and att_k <= BF16_ATTAIN * att_f and r_q > BF16_R,
              f"{label}, 8 iterations: converging >= {BF16_CONV_MIN} within {BF16_CONV_ATOL}; quirk "
              f"attainment <= {BF16_ATTAIN}x the f32 kernel's, envelope r > {BF16_R}")
        if B == B_gl:
            k4.update(converging_within=within, quirk_attainment=(att_k, att_f), quirk_r=r_q)
    for B in BF16_K2_BLOCKS + (B_gl,):
        l, r = lm[: B + 1].contiguous(), rand[:B].contiguous()
        label = f"K2 bf16, B = {B} ({cuda_gl.regime(B, True)})"
        for bug in (False, True):
            d = (cuda_gl.gl_audio(l, r, ops, GL_NORM, 1, bug, bf16=True).long()
                 - cuda_gl.gl_audio_plain(l, r, ops, GL_NORM, 1, bug, bf16=True).long()).abs()
            a = cuda_gl.gl_audio(l, r, ops, GL_NORM, 8, bug, bf16=True)
            tail = cuda_gl.audio_tail_plain(cuda_gl.gl_blocks(l, r, ops, 8, bug, bf16=True), ops,
                                            GL_NORM)
            d_tail = int((a.long() - tail.long()).abs().max())
            a_f = cuda_gl.gl_audio(l, r, ops, GL_NORM, 8, bug)
            a_p = cuda_gl.gl_audio_plain(l, r, ops, GL_NORM, 8, bug, bf16=True)
            att_k, att_f = (attainment(torch, x, l, dec.gl_ops) for x in (a, a_f))
            r_p = corr(torch, hop_energy(torch, a), hop_energy(torch, a_p))
            r_f = corr(torch, hop_energy(torch, a), hop_energy(torch, a_f))
            within = (d <= 1).double().mean().item()
            say(f"  {label}, phase_bug={bug}: 1 iteration {within:.6f} of samples within 1 LSB "
                f"(max {int(d.max())}); 8 iterations: max {d_tail} LSB from the plain tail on K4's "
                f"bf16 blocks, attainment bf16 {att_k:.4f} f32 kernel {att_f:.4f}, per-hop "
                f"envelope r {r_p:.4f} against the plain bf16 version, {r_f:.4f} against the f32 "
                "kernel")
            check(within >= WITHIN_MIN and d_tail <= 1 and att_k <= BF16_ATTAIN * att_f
                  and r_p > BF16_R,
                  f"{label}, phase_bug={bug}: 1 iteration within 1 LSB on >= {WITHIN_MIN}; 8 "
                  f"iterations within 1 LSB of the plain tail on K4's bf16 blocks, attainment "
                  f"<= {BF16_ATTAIN}x the f32 kernel's, envelope r > {BF16_R} against the plain "
                  "bf16 version")
            if B == B_gl and not bug:
                k2["max_abs_err"] = int(d.max())
            if B == B_gl:
                k2[f"eight_iterations_{'quirk' if bug else 'converging'}"] = {
                    "attainment": (att_k, att_f), "r_plain_bf16": r_p, "r_f32_kernel": r_f}

    say("  times (median of 3 CUDA-event runs, 8 iterations, exp(angle)), each beside the f32 "
        "kernel in this call:")
    for name, fig, tail in (("gl_blocks", k4, False), ("gl_audio", k2, True)):
        kernel, plain = getattr(cuda_gl, name), getattr(cuda_gl, name + "_plain")
        args = (GL_NORM,) if tail else ()
        for B in (cuda_gl.CLUSTER_MAX_B_BF16, BF16_K2_BLOCKS[0], B_gl):
            l, r = lm[: B + 1].contiguous(), rand[:B].contiguous()
            t = {"ms": cuda_ms(torch, lambda: kernel(l, r, ops, *args, 8, True, bf16=True)),
                 "f32_ms": cuda_ms(torch, lambda: kernel(l, r, ops, *args, 8, True)),
                 "plain_ms": cuda_ms(torch, lambda: plain(l, r, ops, *args, 8, True, bf16=True)),
                 "bound": gl_bound(cuda_gl, B, NM, 8, True, ops, tail=tail, bf16=True),
                 "regime": cuda_gl.regime(B, True)}
            say(f"    {name} bf16, B = {B} ({t['regime']}): {t['ms']:.4f} ms, f32 kernel "
                f"{t['f32_ms']:.4f} ms, plain bf16 {t['plain_ms']:.3f} ms, bound "
                f"{t['bound'][0]:.4f} ms ({t['bound'][1]}, products at 989 TFLOP/s) [{card}]")
            if B == B_gl:
                t["ms_converging"] = cuda_ms(torch, lambda: kernel(l, r, ops, *args, 8, False,
                                                                   bf16=True))
                say(f"    {name} bf16, B = {B}, converging estimator: {t['ms_converging']:.4f} ms")
                fig.update(t)
            else:
                fig[f"B{B}"] = t
    # for reference the DFT products alone as bf16 torch.matmul (library_ms)
    g = torch.Generator(device=lm.device).manual_seed(1)
    frames16 = torch.randn((2 * B_gl, 256), generator=g, device=lm.device).to(torch.bfloat16)
    fwd16, inv16 = ops.gl_bf16[0].to(torch.bfloat16), ops.gl_bf16[1][:128].to(torch.bfloat16)

    def bf16_products():
        for _ in range(8):
            (frames16 @ fwd16)[:, :128] @ inv16

    lib_ms = cuda_ms(torch, bf16_products)
    del frames16
    say(f"    library: torch.matmul bf16, the 8 iterations' forward ({2 * B_gl} x 256 x 256) and "
        f"inverse ({2 * B_gl} x 128 x 256) products: {lib_ms:.3f} ms [{card}]")
    for fig in (k4, k2):
        fig["library_ms"] = lib_ms

    split = dict(use_cuda_epilogue=False, use_cuda_gl_tail=False)
    cfg16 = dataclasses.replace(cfg, gl_bf16=True)
    for path, c, (spec32, audio32), name in (
            ("fused", cfg16, refs[0], "gl_audio_bf16"),
            ("split", dataclasses.replace(cfg16, **split), refs[1], "gl_blocks_bf16")):
        say(f"== bf16 {path} replay: pipeline.offline_decode(gl_bf16=True), {C} ch, {SR} Hz, "
            f"{MINUTES} min")
        zero_counts()
        spec16, audio16 = pipeline.offline_decode(dec, c, eeg)
        counts = read_counts()
        say(f"  launches: {counts}")
        others = [k for k in ("gl_audio", "gl_blocks", "gl_audio_bf16", "gl_blocks_bf16") if k != name]
        check(counts[name] == 1 and all(counts[k] == 0 for k in others)
              and counts["block_inits"] == 1,
              f"the {path} bf16 replay launched {name} once and no other Griffin-Lim kernel")
        (k2 if name == "gl_audio_bf16" else k4)["launches"] = counts[name]
        audio_p = cuda_gl.gl_audio_plain(spec16, rand, ops, GL_NORM, 8, True, bf16=True)
        att16, att32 = attainment(torch, audio16, spec16, dec.gl_ops), attainment(torch, audio32, spec32, dec.gl_ops)
        r_p = corr(torch, hop_energy(torch, audio16), hop_energy(torch, audio_p))
        r_32 = corr(torch, hop_energy(torch, audio16), hop_energy(torch, audio32))
        say(f"  spectrogram bit-identical to the f32 decode's: {torch.equal(spec16, spec32)}; audio "
            f"attainment bf16 {att16:.4f} f32 {att32:.4f}, per-hop envelope r {r_p:.4f} against the "
            f"plain bf16 vocoder on the same frames, {r_32:.4f} against the f32 decode")
        check(torch.equal(spec16, spec32) and audio16.shape == audio32.shape
              and att16 <= BF16_ATTAIN * att32 and r_p > BF16_R,
              f"bf16 {path} replay: spectrogram bit-identical to the f32 decode's, attainment <= "
              f"{BF16_ATTAIN}x its, envelope r > {BF16_R} against the plain bf16 vocoder")
        runs = {"f32": [], "bf16": []}
        for which in ("f32", "bf16", "bf16", "f32"):
            cc = c if which == "bf16" else dataclasses.replace(c, gl_bf16=False)
            runs[which].append(cuda_ms(torch, lambda: pipeline.offline_decode(dec, cc, eeg), reps=1))
        say(f"  decode time (CUDA events): bf16 {runs['bf16']} ms, f32 {runs['f32']} ms [{card}]")
        (k2 if name == "gl_audio_bf16" else k4)["replay_ms"] = runs
        if path == "fused":
            profile(torch, lambda: pipeline.offline_decode(dec, c, eeg), 1, "decode", top=6)
    return k4, k2


def synthetic_session(torch, noise, sr, seed=0):
    """A word-locked session on top of sEEG noise (examples/demo.py:22-55):
    every 3 s trial carries, during its first 2 s, a 120 Hz burst on half
    the channels (gain 1.0-2.6 by word) and a voiced harmonic stack in the
    audio (f0 150-270 Hz by word); the audio has N(0, 1e-4) dither, as
    cli.train adds.  Returns (sEEG on noise's device, audio (host, f64))."""
    T, C = noise.shape
    n_trials = T // (TRIAL_S * sr)
    env = np.zeros(T)
    t_a = np.arange(2 * AUDIO_SR) / AUDIO_SR
    voices = []
    for wid in range(5):
        v = sum((0.4 / h) * np.sin(2 * np.pi * h * (150 + 30 * wid) * t_a) for h in range(1, 26))
        voices.append(0.3 * v / np.abs(v).max())
    audio = np.random.RandomState(seed).normal(0, 1e-4, T // sr * AUDIO_SR)
    for i in range(n_trials):
        env[i * TRIAL_S * sr : i * TRIAL_S * sr + 2 * sr] = 1.0 + 0.4 * (i % 5)
        audio[i * TRIAL_S * AUDIO_SR : i * TRIAL_S * AUDIO_SR + 2 * AUDIO_SR] += voices[i % 5]
    burst = env * np.sin(2 * np.pi * 120 * np.arange(T) / sr)
    eeg = noise.clone()
    eeg[:, : C // 2] += torch.as_tensor(burst, dtype=eeg.dtype, device=eeg.device)[:, None]
    return eeg, audio


def mean_pearson(torch, a, b):
    """Mean over bins of the per-bin Pearson r of two (N, 40) spectrograms."""
    a, b = a.double() - a.double().mean(0), b.double() - b.double().mean(0)
    return ((a * b).sum(0) / torch.sqrt((a * a).sum(0) * (b * b).sum(0))).mean().item()


def training_phase(torch, dev, noise, sr, zero_counts, read_counts):
    """Step 10 of the module docstring; returns the session (sEEG, audio)."""
    import scipy.signal

    from closed_loop_seeg_speech_synthesis_tpu_torch.cli import decode as cli
    from closed_loop_seeg_speech_synthesis_tpu_torch.models import lda
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import iir
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops.spectrogram import compute_spectrogram
    from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params, trainer

    T, C = noise.shape
    eeg, audio = synthetic_session(torch, noise, sr)
    say(f"  session: {T} samples x {C} ch @ {sr} Hz, {len(audio)} audio samples @ {AUDIO_SR} Hz, "
        f"{T // (TRIAL_S * sr)} trials")
    # the feature stage's host loop over filter blocks, timed inside each
    # train call (CUDA events around each walk; the walk's own synchronize
    # is counted in the stage)
    walk, loop_ms = iir._boundary_states, []

    def timed_walk(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = walk(*args)
        end.record()
        end.synchronize()
        loop_ms.append(start.elapsed_time(end))
        return res

    results = {}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        timings = {}
        loop_ms.clear()
        iir._boundary_states = timed_walk
        try:
            results[name] = r = trainer.train(eeg, audio, sr, AUDIO_SR, [], dtype=dtype, device=dev,
                                              timings=timings)
        finally:
            iir._boundary_states = walk
        peak = torch.cuda.max_memory_allocated() - resident
        say(f"  train {name}: " + ", ".join(f"{k} {v:.2f} ms" for k, v in timings.items())
            + f"; total {sum(timings.values()):.2f} ms; peak device memory above the resident "
            f"{resident / 2**30:.2f} GiB: {peak / 2**30:.2f} GiB")
        say(f"  train {name} feature stage: block loop of {-(-T // 256)} blocks in {len(loop_ms)} "
            f"walk(s) {sum(loop_ms):.2f} ms, {100 * sum(loop_ms) / timings['features']:.1f}% "
            f"of the same call's stage")
        check(r.lda.coef.dtype == dtype and r.lda.coef.device.type == dev.type
              and r.x_train.shape == (len(r.y_train), N_FEATS) and r.lda.coef.shape == (40, 9, N_FEATS)
              and bool(torch.isfinite(r.lda.coef).all()), f"{name} model on the card, shapes, finite")

    r32, r64 = results["f32"], results["f64"]
    overlap = len(set(r32.select.tolist()) & set(r64.select.tolist())) / N_FEATS
    p32 = lda.predict(r32.lda, torch.as_tensor(r32.x_train, device=dev))
    p64 = lda.predict(r64.lda, torch.as_tensor(r64.x_train, device=dev))
    agree = (p32 == p64).double().mean().item()
    say(f"  f32 vs f64: selected features overlap {overlap:.4f}, training-set label agreement "
        f"{agree:.6f}, bins missing intervals {len(r32.missing)} / {len(r64.missing)}")
    check(overlap >= SELECT_MIN, f"f32 and f64 select >= {SELECT_MIN:.0%} of the same features")
    check(agree >= PREDICT_MIN, f"f32 and f64 models agree on >= {PREDICT_MIN:.0%} of labels")
    check(r32.missing == r64.missing, "f32 and f64 find the same missing intervals")
    # the quantizer in f32 against f64: a per-bin shift of the medians or
    # borders leaves the labels and Pearson r alone, so they have a limit of
    # their own (a quarter of docs/NUMERICS.md's max 2e-2 on f32 targets)
    med_err = np.abs(r32.medians - r64.medians).max(axis=1)
    bord_err = np.abs(r32.borders - r64.borders).max(axis=1)
    say(f"  quantizer f32 vs f64: max |median diff| {med_err.max():.3e} (bin {int(med_err.argmax())}), "
        f"> 1e-4 in {int((med_err > 1e-4).sum())} of 40 bins; max |border diff| "
        f"{bord_err.max():.3e} (bin {int(bord_err.argmax())})")
    check(med_err.max() < QUANT_MAX and bord_err.max() < QUANT_MAX,
          f"f32 medians and borders within {QUANT_MAX} log-mel of f64")

    # each model decodes the first minutes through the kernels
    head = eeg[: TRAIN_DECODE_MIN * 60 * sr]
    a16 = np.ascontiguousarray(scipy.signal.decimate(audio[: TRAIN_DECODE_MIN * 60 * AUDIO_SR], 3))
    target = compute_spectrogram(torch.as_tensor(a16, device=dev), 16000, 0.016, 0.01)

    def decode(r, medians, name):
        loaded = params.from_arrays(r.lda.coef.cpu().numpy(), r.lda.intercept.cpu().numpy(),
                                    r.lda.classes.cpu().numpy(), r.lda.valid.cpu().numpy(),
                                    medians, r.select, [], dtype=torch.float32, device=dev)
        zero_counts()
        spec, audio_out, _, _ = cli.perform_offline_decoding(loaded, head, sr, GL_NORM, device=dev)
        launches = read_counts()
        check(launches["frontend_decode_mels"] >= 1 and launches["gl_audio"] >= 1,
              f"K1 and K2 launched decoding {name}: {launches}")
        check(bool(torch.isfinite(spec).all()) and audio_out.shape == ((spec.shape[0] - 1) * 160,),
              f"{name} decode: finite, shapes")
        return spec

    specs, rs = {}, {}
    for name, r in results.items():
        specs[name] = decode(r, r.medians, f"the {name} model")
        n = min(specs[name].shape[0], target.shape[0])
        rs[name] = mean_pearson(torch, specs[name][:n], target[:n])
    # the medians are float32 and float64 evaluations of the same sigmoid
    # over each bin's range: decoding the f32 LDA with the f64 medians
    # leaves only the labels to differ
    specs["f32 LDA, f64 medians"] = decode(r32, r64.medians, "the f32 LDA with the f64 medians")
    _, flips, _ = mel_agreement(torch, specs["f32 LDA, f64 medians"], specs["f64"])
    _, differ, _ = mel_agreement(torch, specs["f32"], specs["f64"])
    say(f"  decode of the first {TRAIN_DECODE_MIN} min: f32 vs f64 LDA label flips {flips:.6f}; "
        f"entries outside rtol 1e-4 of the f64 model's decode with the f32 model's own medians "
        f"{differ:.6f}")
    say(f"  mean per-bin Pearson r against the training target: f32 {rs['f32']:.4f}, "
        f"f64 {rs['f64']:.4f}")
    check(flips < FLIP_MAX, "the two LDAs' decodes inside the f32 label-flip budget")
    check(abs(rs["f32"] - rs["f64"]) < R_DIFF_MAX, f"Pearson r of the two models within {R_DIFF_MAX}")
    check(min(rs.values()) > R_MIN, f"both decodes beat chance: r > {R_MIN} (examples/demo.py:123)")

    # the card's float64 training against the CPU path the tests hold to JAX
    n_slice = TRAIN_SLICE_S * sr
    card = trainer.train(eeg[:n_slice], audio[: TRAIN_SLICE_S * AUDIO_SR], sr, AUDIO_SR, [],
                         dtype=torch.float64, device=dev)
    host = trainer.train(eeg[:n_slice].cpu(), audio[: TRAIN_SLICE_S * AUDIO_SR], sr, AUDIO_SR, [],
                         device="cpu")
    c_card, c_host = card.lda.coef.cpu().numpy(), host.lda.coef.numpy()
    coef_err = float(np.abs(c_card - c_host).max() / np.abs(c_host).max())
    say(f"  {TRAIN_SLICE_S} s slice, card f64 vs CPU f64: select equal "
        f"{np.array_equal(card.select, host.select)}, labels equal "
        f"{np.array_equal(card.y_train, host.y_train)}, max coef error / max |coef| {coef_err:.3e}")
    check(np.array_equal(card.select, host.select), "card and CPU select the same features")
    check(np.allclose(c_card, c_host, rtol=COEF_RTOL, atol=COEF_RTOL * np.abs(c_host).max()),
          f"card and CPU coefficients within rtol {COEF_RTOL}")
    return eeg, audio


def exp1_phase(torch, dev, card, zero_counts, read_counts, runs=EXP1_RUNS):
    """Step 11 of the module docstring, with ``runs`` chance runs
    (exp1_protocol_torch.py runs the protocol's 100).  Returns the launches
    counted in the proposed method, in the chance level and in one f32 fold,
    the fold's runner and staged inputs (K1's and K2's arguments at a fold's
    shapes), and the figures printed."""
    import time

    from closed_loop_seeg_speech_synthesis_tpu_torch.eval import exp1, exp1_batched, metrics
    from closed_loop_seeg_speech_synthesis_tpu_torch.io import session as session_mod
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import prng
    from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import trainer

    t0 = time.perf_counter()
    eeg, audio, words, _ = session_mod.make_synthetic_session(EXP1_WORDS, SR, AUDIO_SR, C, seed=0)
    say(f"  session: {len(words)} words, {eeg.shape[0]} samples x {C} ch @ {SR} Hz, "
        f"{len(audio)} audio samples @ {AUDIO_SR} Hz, built in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    model = trainer.train(eeg, audio, SR, AUDIO_SR, [], device=dev)
    say(f"  session model (trainer.train, f32 on the card): {time.perf_counter() - t0:.2f} s, "
        f"{len(model.select)} features")
    rng = np.random.RandomState(0)
    sess = session_mod.Session.from_arrays(eeg, SR, audio, AUDIO_SR, words, downsample_audio=False,
                                           rng=rng)
    config = configparser.ConfigParser()
    config["Experiment1"] = {"griffin_lim_norm": str(int(GL_NORM))}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        e = exp1.Experiment1(config, None, tmp, rng=rng, device=dev, session=sess, bad_channels=[])
        t0 = time.perf_counter()
        args = e._construct_datasets_for_run(EXP1_FOLDS)
        stage_s = time.perf_counter() - t0
        say(f"  fold staging (_construct_datasets_for_run, {EXP1_FOLDS} folds, host threads): "
            f"{stage_s:.3f} s")

        zero_counts()
        t0 = time.perf_counter()
        timings = {}
        pm_mean, _ = e.proposed_method(nb_folds=EXP1_FOLDS, args=args, timings=timings)
        pm_s = time.perf_counter() - t0
        out["proposed_launches"] = launches = read_counts()
        pm_r = float(np.mean(pm_mean))
        say(f"  proposed method: {pm_s:.3f} s for {EXP1_FOLDS} retrain+decodes; stages (ms, "
            f"summed): " + ", ".join(f"{k} {v:.1f}" for k, v in timings.items()) + f" [{card}]")
        say(f"  proposed launches: {launches}")
        check(launches["frontend_decode_mels"] == EXP1_FOLDS and launches["gl_audio"] == EXP1_FOLDS,
              f"K1 and K2 launched {EXP1_FOLDS} times each in proposed_method")
        say(f"  proposed mean per-bin Pearson r {pm_r:.4f} (the JAX package's TPU record on this "
            f"session: {TPU_EXP1_R}; a quality figure, not a time)")
        check(pm_r >= EXP1_R_MIN, f"proposed mean r >= {EXP1_R_MIN}")

        zero_counts()
        timings = {}
        t0 = time.perf_counter()
        rc_mean, rc_std = e.chance_level_batched(nb_runs=runs, nb_folds=EXP1_FOLDS,
                                                 batch_size=runs, base_args=args, timings=timings)
        chance_s = time.perf_counter() - t0
        out["chance_launches"] = read_counts()
        orig = np.load(os.path.join(tmp, "orig.npy"))
        run_r = []
        for i in range(1, runs + 1):
            rc = np.load(os.path.join(tmp, f"rc_reco_i={i:03}.npy"))
            n = min(len(rc), len(orig))
            run_r.append(float(metrics.pearson_correlation(orig[:n], rc[:n])[0]))
        targets_ms = timings.pop("fold_targets")
        per_run = {k: v / runs for k, v in timings.items()}
        run_ms = (chance_s * 1e3 - targets_ms) / runs
        say(f"  chance level: {runs} runs x {EXP1_FOLDS} folds in {chance_s:.3f} s, of which "
            f"the folds' targets (decimate, spectrogram, quantizer on the host; once a fold a "
            f"call) {targets_ms:.1f} ms; one chance run ({EXP1_FOLDS} retrain+decodes) "
            f"{run_ms:.1f} ms: " + ", ".join(f"{k} {v:.1f} ms" for k, v in per_run.items())
            + f", other host work {run_ms - sum(per_run.values()):.1f} ms; the folds' staging "
            f"before both {stage_s * 1e3:.1f} ms [{card}]")
        say(f"  chance launches: {out['chance_launches']}")
        chance_r = (float(np.mean(rc_mean)), float(np.mean(rc_std)))
        say(f"  chance level r over the runs: mean {chance_r[0]:.4f}, std {chance_r[1]:.4f} "
            f"(per-bin, averaged over bins); chance runs' mean r: min {min(run_r):.4f}, median "
            f"{float(np.median(run_r)):.4f}, max {max(run_r):.4f} (TPU record's largest of "
            f"100: {TPU_CHANCE_MAX})")
        check(out["chance_launches"]["frontend_decode_mels"] == runs * EXP1_FOLDS
              and out["chance_launches"]["gl_audio"] == 0,
              "K1 launched once per chance fold, K2 not at all")
        check(pm_r > max(run_r), "proposed mean r above every chance run's")
        out["figures"] = {"proposed_s": pm_s, "proposed_mean_r": pm_r, "chance_runs": runs,
                          "chance_s": chance_s, "chance_run_ms": run_ms,
                          "chance_run_stage_ms": per_run, "fold_targets_ms": targets_ms,
                          "fold_staging_s": stage_s, "chance_mean_r": chance_r[0],
                          "chance_std_r": chance_r[1], "chance_run_r_min": min(run_r),
                          "chance_run_r_median": float(np.median(run_r)),
                          "chance_run_r_max": max(run_r)}

    # one fold in f32 through K1 + K2 against the same fold in float64 (the
    # plain path, on the card)
    k, x_train, y_train, x_test, y_test, *_ = args[0]
    specs = {}
    q, medians, y_mean = exp1_batched.fold_targets(y_train)
    for dtype in (torch.float32, torch.float64):
        fr = exp1_batched.FoldRunner(len(x_train), len(x_test), C, SR, GL_NORM,
                                     nb_feats=min(N_FEATS, 5 * C), dtype=dtype, device=dev)
        fold = (fr.put(x_train), fr.put(x_test), fr.put(q, torch.int64), fr.put(y_mean),
                fr.put(medians))
        zero_counts()
        specs[dtype] = fr.run(*fold, seed=prng.fold_in(0, k))
        counts = read_counts()
        check((counts["frontend_decode_mels"], counts["gl_audio"]) ==
              ((1, 1) if dtype == torch.float32 else (0, 0)),
              f"fold {k} in {dtype}: K1 and K2 launched {counts}")
        if dtype == torch.float32:
            out["fold"], out["fold_launches"] = (fr, fold), counts
    s32, s64 = specs[torch.float32][0], specs[torch.float64][0]
    _, flips, _ = mel_agreement(torch, s32.double(), s64)
    y = torch.as_tensor(y_test, device=dev)
    n = min(len(y), len(s32))
    r32, r64 = mean_pearson(torch, s32[:n], y[:n]), mean_pearson(torch, s64[:n], y[:n])
    say(f"  fold {k}, f32 through K1 + K2 vs float64 plain: label flips {flips:.6f}, mean r "
        f"{r32:.4f} vs {r64:.4f}")
    check(flips < FLIP_MAX and abs(r32 - r64) <= EXP1_R_DIFF,
          f"fold {k}: f32 within the label-flip budget and {EXP1_R_DIFF} r of float64")
    out["figures"].update(fold_f32_vs_f64_flips=flips, fold_r_f32=r32, fold_r_f64=r64)
    return out


def exp2_phase(torch, dev, card, zero_counts, read_counts, runs=EXP2_RUNS):
    """Step 12 of the module docstring, with ``runs`` chance segments a
    decoding run (exp2_protocol_torch.py runs the protocol's 1,000).
    Returns the launches counted (the runs' decodes, each run's batched
    chance level, the sequential twin), K1's and K2's figures at a chance
    segment's shapes, and the figures printed."""
    import time

    from closed_loop_seeg_speech_synthesis_tpu_torch.cli import decode as cli
    from closed_loop_seeg_speech_synthesis_tpu_torch.eval import exp2, exp3, exp4, figures
    from closed_loop_seeg_speech_synthesis_tpu_torch.io import session as session_mod
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import cuda_frontend, cuda_gl
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import griffinlim as gl
    from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import pipeline, trainer

    out = {"figures": {}}
    fig = out["figures"]
    t_phase = t0 = time.perf_counter()
    eeg, audio, words, _ = session_mod.make_synthetic_session(EXP2_WORDS, SR, AUDIO_SR, EXP2_C,
                                                              seed=0)
    other = np.random.RandomState(3).randn(EXP2_OTHER_S * SR, EXP2_C).astype(np.float32)
    say(f"  session: {len(words)} words, {eeg.shape[0]} samples x {EXP2_C} ch @ {SR} Hz, "
        f"{len(audio)} audio samples @ {AUDIO_SR} Hz; other-task sEEG {other.shape[0]} samples; "
        f"built in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    res = trainer.train(eeg, audio, SR, AUDIO_SR, [], device=dev)
    fig["train_s"] = time.perf_counter() - t0
    model = {"lda": res.lda, "medians": res.medians, "select": res.select,
             "bad_channels": np.zeros(0, int)}
    say(f"  model (trainer.train, f32 on the card): {fig['train_s']:.2f} s, "
        f"{len(res.select)} features")

    # the whisper and imagine runs: the session's sEEG decoded through K1 + K2
    dec_runs = {}
    zero_counts()
    t0 = time.perf_counter()
    for i, run in enumerate(EXP2_RUNS_DECODED):
        _, wav, _, _ = cli.perform_offline_decoding(model, eeg, SR, GL_NORM, device=dev, seed=i)
        dec_runs[run] = session_mod.DecodingRun.from_arrays(
            wav.cpu().numpy(), 16000, eeg, SR, 3.0 * np.arange(len(words)), words, run_dir=run)
    fig["run_decodes_s"] = time.perf_counter() - t0
    out["decode_launches"] = launches = read_counts()
    say(f"  decoding runs {', '.join(EXP2_RUNS_DECODED)} ({eeg.shape[0] / SR:.0f} s each, "
        f"perform_offline_decoding): {fig['run_decodes_s']:.2f} s; launches {launches}")
    check(launches["frontend_decode_mels"] == 2 and launches["gl_audio"] == 2,
          "K1 and K2 launched once per decoding run")

    config = configparser.ConfigParser()
    config["Experiment2"] = {"griffin_lim_norm": str(int(GL_NORM))}
    config["Experiment3"] = {"decoding_runs": ",".join(EXP2_RUNS_DECODED), **VAD}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    os.makedirs(os.path.join(tmp, "exp2"))
    out["chance_launches"] = {}
    for run in EXP2_RUNS_DECODED:
        rng = np.random.RandomState(1)
        t0 = time.perf_counter()
        sess = session_mod.Session.from_arrays(eeg, SR, audio, AUDIO_SR, words, rng=rng)
        e = exp2.Experiment2(config, None, run, [], os.path.join(tmp, "exp2"), rng=rng,
                             device=dev, session=sess, dec_run=dec_runs[run],
                             other_tasks_eeg=other, model=model)
        setup_s = time.perf_counter() - t0
        timings = {}
        t0 = time.perf_counter()
        pm = np.asarray(e.matching_trials(timings=timings))
        pm_s = time.perf_counter() - t0
        zero_counts()
        t0 = time.perf_counter()
        chance = e.chance_level_batched(runs=runs, timings=timings)
        chance_s = time.perf_counter() - t0
        out["chance_launches"][run] = counts = read_counts()
        check(counts["frontend_decode_mels"] == runs and counts["gl_audio"] == 0,
              f"{run}: K1 launched once per chance segment ({runs}), K2 not at all")
        np.save(os.path.join(tmp, "exp2", f"exp2_{run}_chance.npy"), chance[~np.isnan(chance)])
        np.save(os.path.join(tmp, "exp2", f"exp2_{run}_pm.npy"), pm)
        finite = chance[np.isfinite(chance)]
        pm_med, ch_med = float(np.median(pm)), float(np.median(finite))
        say(f"  exp2 {run}: matched median r {pm_med:.4f} over {len(pm)} words, chance median r "
            f"{ch_med:.4f} over {len(finite)} of {runs} finite segments (TPU record "
            f"{TPU_EXP2[run][0]} vs {TPU_EXP2[run][1]}; the port's inits are the JAX package's "
            f"threefry draws, its front end the same)")
        say(f"  exp2 {run} time: session (decimate + dither) {setup_s * 1e3:.1f} ms, matching "
            f"trials {pm_s * 1e3:.1f} ms, chance level {chance_s * 1e3:.1f} ms; by stage (ms, "
            f"summed over both): " + ", ".join(f"{k} {v:.1f}" for k, v in timings.items())
            + f"; per chance segment: K1 decode {timings['decode'] / runs:.3f} ms, DTW "
            f"{timings['dtw'] / (runs + len(pm)):.1f} ms a pair [{card}]")
        check(pm_med > 3 * max(ch_med, 0.01),
              f"{run}: matched median r > 3 x max(chance median, 0.01) (benchmarks/eval_full.py:183)")
        fig[run] = {"matched_median_r": pm_med, "chance_median_r": ch_med,
                    "chance_finite": int(len(finite)), "matched_words": int(len(pm)),
                    "setup_s": setup_s, "matching_s": pm_s, "chance_s": chance_s,
                    "stage_ms": timings}

    # the sequential twin (offline_decode per segment: K1 and K2) against
    # the batched chance level on the same segments
    twins = []
    for method in ("chance_level", "chance_level_batched"):
        e = exp2.Experiment2(config, None, "whisper", [], tmp, rng=np.random.RandomState(5),
                             device=dev, session=sess, dec_run=dec_runs["whisper"],
                             other_tasks_eeg=other, model=model)
        zero_counts()
        twins.append(getattr(e, method)(runs=EXP2_SEQ))
        if method == "chance_level":
            out["sequential_launches"] = read_counts()
    say(f"  sequential twin on {EXP2_SEQ} segments: launches {out['sequential_launches']}; scores "
        f"{np.round(twins[0], 6).tolist()} vs batched {np.round(twins[1], 6).tolist()}")
    check(out["sequential_launches"]["frontend_decode_mels"] == EXP2_SEQ
          and out["sequential_launches"]["gl_audio"] == EXP2_SEQ,
          "sequential twin: K1 and K2 launched once per segment")
    check(np.array_equal(twins[0], twins[1], equal_nan=True),
          "chance_level (K1 + K2 a segment) equals chance_level_batched (K1 a segment)")

    # one segment in f32 through K1 against the float64 path on the card
    mask, cfg32, dec32 = e._decoder()
    e64 = exp2.Experiment2(config, None, "whisper", [], tmp, device=dev, dtype=torch.float64,
                           session=sess, dec_run=dec_runs["whisper"], other_tasks_eeg=other,
                           model=model)
    _, cfg64, dec64 = e64._decoder()
    T = 2 * SR
    pick = np.random.RandomState(7)
    for _ in range(20):  # the first segment whose score is finite in float64
        c = pick.randint(0, len(other) - T)
        seg = other[c : c + T][:, mask]
        s32, s64 = pipeline._mel_frames(dec32, cfg32, seg), pipeline._mel_frames(dec64, cfg64, seg)
        r32 = e._scorer(trainer.StageClock(None, dev))(0, s32.cpu().numpy())
        r64 = e64._scorer(trainer.StageClock(None, dev))(0, s64.cpu().numpy())
        if np.isfinite(r64):
            break
    _, flips, _ = mel_agreement(torch, s32.double(), s64)
    say(f"  one chance segment (cut {c}), f32 through K1 vs float64 plain: label flips {flips:.6f}, "
        f"DTW r {r32:.4f} vs {r64:.4f}")
    check(flips < FLIP_MAX and abs(r32 - r64) <= EXP2_R_DIFF,
          f"segment: f32 within the label-flip budget and {EXP2_R_DIFF} r of float64")
    fig.update(segment_f32_vs_f64_flips=flips, segment_r_f32=float(r32), segment_r_f64=float(r64))

    # K1 at a segment's shapes, the plan built once (the batched path), and
    # K2 on its frames: B = nf - 1 blocks, the FFT regime
    x = torch.as_tensor(seg, dtype=torch.float32, device=dev).contiguous()
    plan = pipeline.mel_plan(dec32, cfg32, T)
    *consts, packed = plan.k1
    k1_args = (dec32.frontend_ops, x, pipeline._initial_state(dec32, x).contiguous(), *consts,
               plan.n_frames, cfg32.model_order, cfg32.step_size)
    mel_k = cuda_frontend.frontend_decode_mels(*k1_args, packed=packed)
    torch.cuda.synchronize()
    agree, flips_k, k1_err = mel_agreement(torch, mel_k, cuda_frontend.frontend_decode_mels_plain(*k1_args))
    say(f"  K1 at a segment's shapes ({T} samples x {EXP2_C} ch, {plan.n_frames} frames, "
        f"{-(-plan.n_frames // dec32.frontend_ops.P)} periods): agreement {agree:.6f}, flip rate "
        f"{flips_k:.6f}, max abs err {k1_err:.3e}")
    check(mel_k.shape == (plan.n_frames, 40) and bool(torch.isfinite(mel_k).all()),
          "K1 at a segment: shape, finite")
    check(agree >= AGREE_MIN and flips_k < FLIP_MAX, "K1 at a segment: agreement and label flips")
    B = plan.n_frames - 1
    check(cuda_gl.regime(B) == "fft", f"K2 at a segment's B = {B} takes the FFT regime")
    rand = gl.default_rand_init(B, 0, 0, torch.float32, dev)
    k2_args = (mel_k.contiguous(), rand, dec32.gl_audio_ops, GL_NORM, 8, True)
    k2_err = k2_agreement(cuda_gl, mel_k.contiguous(), rand, dec32.gl_audio_ops,
                          "at a chance segment's shapes (FFT regime)")
    per = lambda fn, reps: cuda_ms(torch, lambda: [fn() for _ in range(reps)]) / reps
    out["k1"] = {"max_abs_err": k1_err,
                 "ms": per(lambda: cuda_frontend.frontend_decode_mels(*k1_args, packed=packed),
                           SEGMENT_REPS),
                 "ms_packing_per_call": per(lambda: cuda_frontend.frontend_decode_mels(*k1_args),
                                            SEGMENT_REPS),
                 "plain_ms": per(lambda: cuda_frontend.frontend_decode_mels_plain(*k1_args), 20),
                 "bound": frontend_bound(dec32.frontend_ops, T, EXP2_C, plan.n_frames, consts[0])}
    out["k2"] = {"max_abs_err": k2_err, "regime": cuda_gl.regime(B),
                 "ms": per(lambda: cuda_gl.gl_audio(*k2_args), SEGMENT_REPS),
                 "plain_ms": per(lambda: cuda_gl.gl_audio_plain(*k2_args), 20),
                 "bound": gl_bound(cuda_gl, B, 40, 8, True, dec32.gl_audio_ops, tail=True)}
    for name, k in (("K1", out["k1"]), ("K2", out["k2"])):
        say(f"  {name} at a segment's shapes: kernel {k['ms']:.4f} ms a launch (over "
            f"{SEGMENT_REPS}), plain {k['plain_ms']:.4f} ms, bound {k['bound'][0]:.5f} ms "
            f"({k['bound'][1]}) [{card}]")
    say(f"  K1 at a segment with its LDA fragments packed per call (the sequential path): "
        f"{out['k1']['ms_packing_per_call']:.4f} ms a launch [{card}]")
    profile(torch, lambda: [cuda_frontend.frontend_decode_mels(*k1_args, packed=packed)
                            for _ in range(50)], 50, "K1 call at a segment", top=4)
    profile(torch, lambda: [cuda_gl.gl_audio(*k2_args) for _ in range(50)], 50,
            "K2 call at a segment", top=3)
    # a training word's spectrogram (exp2's spectrogram stage): the device's
    # share, and the host's constants (DFT and mel matrices) built per call
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import mel, stft

    word = sess.audio[: 2 * sess.audio_sr]
    profile(torch, lambda: [e._spectrogram(word, sess.audio_sr) for _ in range(10)], 10,
            "spectrogram", top=4)
    t0 = time.perf_counter()
    for _ in range(10):
        stft.rdft_matrices(256)
        mel.mel_matrices(129, 40, 16000)
    say(f"  spectrogram constants (rdft_matrices(256) + mel_matrices) on the host: "
        f"{(time.perf_counter() - t0) * 1e2:.3f} ms a call [{card}]")

    # exp3 on both runs, exp4 on the model
    t0 = time.perf_counter()
    res3 = exp3.run_experiment3(config, None, os.path.join(tmp, "exp3"), dec_runs=dec_runs,
                                rng=np.random.RandomState(0))
    fig["exp3_s"] = time.perf_counter() - t0
    for run, (inside, outside) in res3.items():
        say(f"  exp3 {run}: speech {inside:.2f} s inside the trials, {outside:.2f} s outside "
            f"(TPU record {TPU_EXP3[0]} / {TPU_EXP3[1]})")
        check(inside > 0 and inside > outside, f"exp3 {run}: speech inside the trials > 0 and > outside")
        fig[f"exp3_{run}"] = [float(inside), float(outside)]
    names = [f"LA{i + 1}" for i in range(EXP2_C)]
    t0 = time.perf_counter()
    e4 = exp4.Experiment4(None, names, model=model, training_features=res.x_train)
    matrix = e4.compute_activations()
    fig["exp4_s"] = time.perf_counter() - t0
    say(f"  exp3 {fig['exp3_s'] * 1e3:.1f} ms for both runs (VAD on the host); exp4 (Haufe "
        f"transform, float64 numpy on the host) {fig['exp4_s'] * 1e3:.1f} ms; activations "
        f"{matrix.shape}, max |a| {np.abs(matrix).max():.4e} [{card}]")
    check(np.isfinite(matrix).all() and np.abs(matrix).max() > 0, "exp4 activations finite, max |a| > 0")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        say("  figures: matplotlib is not installed, the drawings (exp4's maps, figure_4) skipped")
    else:
        e4.plot(matrix, os.path.join(tmp, "activations.png"))
        e4.plot_activation_map(matrix, os.path.join(tmp, "activation_map.png"))
        figures.figure_4(tmp, tmp, os.path.join(tmp, "figure_4.png"))
        check(all(os.path.getsize(os.path.join(tmp, f)) > 0
                  for f in ("activations.png", "activation_map.png", "figure_4.png")),
              "exp4's maps and figure_4 drawn")
    shutil.rmtree(tmp)
    fig["phase_s"] = time.perf_counter() - t_phase
    say(f"  exp2-exp4 phase: {fig['phase_s']:.1f} s in all [{card}]")
    return out


def parallel_phase(torch, dev, card, eeg, audio, arrs, zero_counts, read_counts):
    """Step 13 of the module docstring.  ``eeg`` (T, C) on the card and
    ``audio`` (48 kHz, host) are the training step's session, ``arrs`` the
    random model of the replay.  Returns each kernel's launches in the
    phase (all ranks and the NCCL run together) and the max |diff| of K1,
    K2 and K3 against their plain versions at the phase's shapes."""
    import time

    import scipy.signal
    import torch.distributed as tdist

    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import cuda_frontend, cuda_gl
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import griffinlim as gl
    from closed_loop_seeg_speech_synthesis_tpu_torch.parallel import distributed as dist
    from closed_loop_seeg_speech_synthesis_tpu_torch.parallel import sharded
    from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params, pipeline

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    C = eeg.shape[1]
    T_r = PAR_REPLAY_S * SR
    cfg = pipeline.DecoderConfig(sr=float(SR), n_channels=C, dtype=torch.float32)
    loaded = params.from_arrays(**arrs, dtype=torch.float32, device=dev)
    dec = pipeline.build_decoder_params(cfg, loaded["lda"], loaded["medians"], loaded["select"],
                                        device=dev)
    sessions = eeg[: PAR_SESSIONS * T_r].reshape(PAR_SESSIONS, T_r, C)
    nf = pipeline.mel_plan(dec, cfg, T_r).n_frames
    rand = torch.stack([gl.default_rand_init(nf - 1, 0, i, torch.float32, dev)
                        for i in range(PAR_SESSIONS)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refs = [pipeline.offline_decode(dec, cfg, sessions[i], rand[i]) for i in range(PAR_SESSIONS)]
    torch.cuda.synchronize()
    say(f"  one process, the {PAR_SESSIONS} sessions' offline_decode (params built): "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms [{card}]")

    # the kernels against their plain versions at the shapes the ranks give
    # them: a 5-min session (K1, K2), its block of C / PAR_RANKS channels (K3)
    k1_args = k1_inputs(dec, cfg, sessions[0])
    mel_k = cuda_frontend.frontend_decode_mels(*k1_args)
    agree, flips, k1_err = mel_agreement(torch, mel_k,
                                         cuda_frontend.frontend_decode_mels_plain(*k1_args))
    kp = -(-k1_args[-3] // dec.frontend_ops.P)
    say(f"  K1 at a {PAR_REPLAY_S} s session ({kp} periods, scan chunk "
        f"{cuda_frontend.scan_chunk(dec.frontend_ops, kp)}): agreement {agree:.6f}, flip rate "
        f"{flips:.6f}, max abs err {k1_err:.3e}")
    check(mel_k.shape == (nf, 40) and bool(torch.isfinite(mel_k).all())
          and agree >= AGREE_MIN and flips < FLIP_MAX,
          f"K1 at a {PAR_REPLAY_S} s session: shape, finite, agreement and label flips")
    k2_err = k2_agreement(cuda_gl, mel_k.contiguous(), rand[0], dec.gl_audio_ops,
                          f"at a {PAR_REPLAY_S} s session")
    block = sessions[0][:, : C // PAR_RANKS].contiguous()
    k3_err = k3_agreement(torch, (dec.frontend_ops, block,
                                  pipeline._initial_state(dec, block).contiguous(), nf),
                          f"a {C // PAR_RANKS}-channel block of a {PAR_REPLAY_S} s session")
    errs = {"frontend_decode_mels": k1_err, "gl_audio": k2_err, "frontend_logpower": k3_err}
    del mel_k, block
    model = {k: arrs[k] for k in dist.LDA_ARRAYS}
    total = dict.fromkeys(read_counts(), 0)

    def run(label, dryrun, **kwargs):
        t0 = time.perf_counter()
        out, _ = dryrun(PAR_RANKS, backend="gloo", device="cuda", workdir=tmp, timeout=300,
                        **kwargs)
        wall = time.perf_counter() - t0
        say(f"  {label}: {wall:.2f} s in all; spawn + init {max(r['ready_s'] for r in out):.2f} s, "
            f"compute {max(r['compute_ms'] - r['collectives_ms'] for r in out):.1f} ms, "
            f"collectives {max(r['collectives_ms'] for r in out):.1f} ms (the slowest rank's) "
            f"[{card}]")
        for r in out:
            say(f"    rank {r['rank']}: mesh {r['mesh']}, sessions {r['sessions']}, "
                f"launches {r['launches']}")
            for k, n in r["launches"].items():
                total[k] += n
        return out

    with tempfile.TemporaryDirectory() as tmp:
        say(f"  data-parallel replay: {PAR_SESSIONS} sessions of {PAR_REPLAY_S} s, {C} ch, "
            f"{PAR_RANKS} gloo ranks on one card")
        inputs = dist.write_inputs(os.path.join(tmp, "replay"), eeg=sessions.cpu().numpy(),
                                   rand=rand.cpu().numpy(), sr=float(SR), **model)
        shards = run("replay", dist.dryrun_dcn, inputs=inputs)
        local = PAR_SESSIONS // PAR_RANKS
        check(all(r["launches"]["frontend_decode_mels"] == r["launches"]["gl_audio"] == local
                  for r in shards), f"each rank launched K1 and K2 once per session ({local})")
        spec_p = torch.as_tensor(np.concatenate([r["spec"] for r in shards]))
        audio_p = torch.as_tensor(np.concatenate([r["audio"] for r in shards]))
        spec_r = torch.stack([s for s, _ in refs]).cpu()
        audio_r = torch.stack([a for _, a in refs]).cpu()
        _, flips, err = mel_agreement(torch, spec_p.double(), spec_r.double())
        lsb = int((audio_p.long() - audio_r.long()).abs().max())
        say(f"  gathered shards vs this process's offline_decode: max |diff| spec {err:.3e}, audio "
            f"{lsb} LSB, label flips {flips:.6f}, bit-identical "
            f"{torch.equal(spec_p, spec_r) and torch.equal(audio_p, audio_r)}")
        check(spec_p.shape == spec_r.shape and audio_p.shape == audio_r.shape
              and flips < FLIP_MAX and lsb <= 1,
              "data-parallel replay: spectra inside the f32 budget of one process, audio within "
              "1 LSB")

        say(f"  channel-sharded decode: one {PAR_REPLAY_S} s session, {C // PAR_RANKS} ch a rank")
        inputs = dist.write_inputs(os.path.join(tmp, "sharded"), eeg=sessions[:1].cpu().numpy(),
                                   rand=rand[:1].cpu().numpy(), sr=float(SR), **model)
        shards = run("channel-sharded decode", dist.dryrun_dcn, model_axis=PAR_RANKS,
                     inputs=inputs)
        check(all(r["launches"]["frontend_logpower"] == 1 and r["launches"]["gl_audio"] == 1
                  and r["launches"]["frontend_decode_mels"] == 0 for r in shards),
              "each rank launched K3 once and K2 once, K1 not")
        check(all(np.array_equal(r[k], shards[0][k]) for r in shards for k in ("spec", "audio")),
              "the ranks' outputs identical")
        spec_u, audio_u = pipeline.offline_decode(
            dec, dataclasses.replace(cfg, use_cuda_epilogue=False), sessions[0], rand[0])
        spec_s = torch.as_tensor(shards[0]["spec"][0])
        audio_s = torch.as_tensor(shards[0]["audio"][0])
        _, flips, err = mel_agreement(torch, spec_s.double(), spec_u.cpu().double())
        lsb = int((audio_s.long() - audio_u.cpu().long()).abs().max())
        say(f"  vs the unsharded split decode: max |diff| spec {err:.3e}, label flips {flips:.6f}, "
            f"audio {lsb} LSB")
        check(spec_s.shape == spec_u.shape and audio_s.shape == audio_u.shape
              and flips < FLIP_MAX and lsb <= 1,
              "channel-sharded decode: spectra inside the f32 budget of the unsharded split "
              "decode, audio within 1 LSB")

        T_t, Ta = PAR_TRAIN_S * SR, PAR_TRAIN_S * 16000
        say(f"  distributed training: {PAR_SESSIONS} sessions of {PAR_TRAIN_S} s, {C} ch, 16 kHz "
            f"audio, {PAR_RANKS} gloo ranks")
        audio16 = scipy.signal.decimate(audio[: PAR_SESSIONS * PAR_TRAIN_S * AUDIO_SR], 3)
        train_eeg = eeg[: PAR_SESSIONS * T_t].reshape(PAR_SESSIONS, T_t, C)
        train_audio = audio16[: PAR_SESSIONS * Ta].reshape(PAR_SESSIONS, Ta).astype(np.float32)
        inputs = dist.write_inputs(os.path.join(tmp, "train"), eeg=train_eeg.cpu().numpy(),
                                   audio=train_audio)
        reps = run("training", dist.dryrun_dcn_train, inputs=inputs,
                   config={"nb_feats": N_FEATS, "iir_block": 128})
        check(all(np.array_equal(r[k], reps[0][k]) for r in reps
                  for k in ("coef", "intercept", "classes", "valid", "select", "medians")),
              "the ranks' replicas identical")
        t0 = time.perf_counter()
        p1, s1, m1 = dist.distributed_train(
            None, sharded.ShardedTrainConfig(dtype=torch.float32, nb_feats=N_FEATS, iir_block=128),
            train_eeg, train_audio, device=dev)
        say(f"  one process on the pooled batch: {time.perf_counter() - t0:.2f} s; select equal "
            f"{np.array_equal(s1, reps[0]['select'])}, max |diff| medians "
            f"{np.abs(m1 - reps[0]['medians']).max():.3e}, coef "
            f"{np.abs(p1.coef.numpy() - reps[0]['coef']).max():.3e}")
        check(np.array_equal(s1, reps[0]["select"])
              and np.allclose(m1, reps[0]["medians"], rtol=0, atol=PAR_MEDIANS_ATOL)
              and np.allclose(p1.coef.numpy(), reps[0]["coef"], rtol=PAR_COEF_RTOL,
                              atol=PAR_COEF_ATOL),
              "distributed model equals the single-process step on the pooled batch")

        say("  NCCL, a world of 1 (this process): distributed_replay of session 0")
        dist.initialize("file://" + os.path.join(tmp, "nccl-rendezvous"), 1, 0, backend="nccl")
        try:
            x = torch.ones(4, device=dev)
            tdist.all_reduce(x)
            zero_counts()
            spec_n, audio_n = dist.distributed_replay(dist.global_mesh(1), cfg, dec, sessions[:1],
                                                      rand[:1])
            for k, n in read_counts().items():
                total[k] += n
        finally:
            tdist.destroy_process_group()
        check(bool((x.cpu() == 1).all()) and np.array_equal(spec_n[0], refs[0][0].cpu().numpy())
              and np.array_equal(audio_n[0], refs[0][1].cpu().numpy()),
              "NCCL all-reduce of one rank, and its replay equal to this process's decode")
    say(f"  parallel phase: {time.perf_counter() - t_phase:.1f} s in all, launches {total} [{card}]")
    return total, errs


def persistent_phase(torch, dev, card, cli, online, cuda_gl, cfg_on, dec_on, packets, loaded,
                     per_packet, reference):
    """The persistent loop (``runtime.online.PersistentOnlineDecoder``) at
    phase 7's width and packets: one graph launch a session, K4 in every
    iteration, outputs bit-identical to phase 7's ``OnlineDecoder``
    (``reference``: its spectrogram and audio), the plain Griffin-Lim
    session within 1 LSB, latency beside phase 7's (``per_packet``: its
    p50/p95/p99/max in ms), a real-time NSX loopback through
    ``perform_online_decoding(persistent=True)``, a feeder error and an
    abort that return and leave the card usable.  Returns the figures of
    the kernels line."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from closed_loop_seeg_speech_synthesis_tpu_torch.cli import dev_streamer
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import cuda_loop

    spec_on, audio_on = reference
    n_pkts = len(packets)

    def session(d, pkts):
        for p in pkts:
            d.feed_packet(p)
        d.feed_stop()
        return d.run_until_stopped()

    # one session of all 60 s, queued before warmup
    pd = online.PersistentOnlineDecoder(cfg_on, dec_on)
    for p in packets:
        pd.feed_packet(p)
    pd.feed_stop()
    t0 = time.perf_counter()
    pd.warmup()
    warm_s = time.perf_counter() - t0
    check(pd.spec_frames == [] and pd.audio_chunks == [] and pd._queue.qsize() == n_pkts + 1,
          "warmup emitted nothing and left the queued packets queued")
    cuda_gl.gl_blocks.launches = 0
    cuda_loop.sessions = cuda_loop.iterations = 0
    t0 = time.perf_counter()
    spec_p, audio_p, recv_p = pd.run_until_stopped()
    run_s = time.perf_counter() - t0
    sessions, iterations = cuda_loop.sessions, cuda_loop.iterations
    k4_nodes = pd._captured.k4_nodes
    say(f"  warmup (capture, graph, one stop-only session) {warm_s:.2f} s; session of {n_pkts} "
        f"queued packets {run_s * 1e3:.1f} ms; graph launches {sessions}, loop iterations "
        f"{iterations}; K4 nodes in this decoder's recorded step {k4_nodes}, so K4 launches "
        f"{iterations * k4_nodes}; K4 wrapper calls during the session "
        f"{cuda_gl.gl_blocks.launches} (the wrapper counts at capture only, where it recorded "
        "the node that runs once an iteration)")
    check(sessions == 1 and iterations == n_pkts + 1 and k4_nodes >= 1,
          f"one graph launch ran the session's {n_pkts + 1} iterations (the STOP included), "
          "K4 recorded in the step")
    init_nodes = pd._captured.init_nodes
    check(init_nodes == 1, f"the block inits' kernel recorded as one node of the step "
          f"({init_nodes}), so it runs {iterations * init_nodes} times in the session")
    check(np.array_equal(spec_p, spec_on) and np.array_equal(audio_p, audio_on)
          and np.array_equal(recv_p, packets.reshape(-1, packets.shape[-1])),
          f"persistent output {spec_p.shape} / {audio_p.shape} bit-identical to OnlineDecoder's")

    # a profiled session of PERSISTENT_PROFILE_PACKETS packets: one graph launch, K4 in
    # every iteration
    pf = online.PersistentOnlineDecoder(cfg_on, dec_on)
    pf.warmup()
    for p in packets[:PERSISTENT_PROFILE_PACKETS]:
        pf.feed_packet(p)
    pf.feed_stop()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pf.run_until_stopped()
        prof_s = time.perf_counter() - t0
    events = prof.key_averages()
    graph_launches = sum(e.count for e in events if e.key.startswith("cudaGraphLaunch"))
    kernel_launches = sum(e.count for e in events
                          if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    dev_ev = {e.key: (e.count, e.self_device_time_total / 1e3) for e in events
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    k4_runs = sum(c for k, (c, _) in dev_ev.items() if "gl_cluster_kernel" in k)
    waits = sum(ms for k, (_, ms) in dev_ev.items() if "wait_packet_kernel" in k)
    step_ms = sum(ms for k, (_, ms) in dev_ev.items() if "wait_packet_kernel" not in k)
    per_iter = step_ms / (PERSISTENT_PROFILE_PACKETS + 1)
    say(f"  profile of a {PERSISTENT_PROFILE_PACKETS}-packet session: {prof_s * 1e3:.1f} ms; "
        f"{graph_launches} cudaGraphLaunch, {kernel_launches} kernel launches by the host, gl_cluster_kernel ran "
        f"{k4_runs} times; device time an iteration without the wait {per_iter * 1e3:.1f} us "
        f"(the wait kernel's spin {waits:.1f} ms in all) [{card}]")
    for name, (cnt, ms) in sorted(dev_ev.items(), key=lambda kv: -kv[1][1])[:6]:
        say(f"    {ms:9.3f} ms  {cnt:6d} runs  {name[:90]}")
    check(graph_launches == 1
          and k4_runs == (PERSISTENT_PROFILE_PACKETS + 1) * pf._captured.k4_nodes,
          f"profiler: 1 cudaGraphLaunch and {PERSISTENT_PROFILE_PACKETS + 1} iterations x "
          f"{pf._captured.k4_nodes} recorded K4 node(s) = gl_cluster_kernel runs")

    # the same packets with the plain Griffin-Lim in the captured step, under
    # the exp(angle) quirk and with the converging estimator
    pg = online.PersistentOnlineDecoder(dataclasses.replace(cfg_on, use_cuda_gl=False), dec_on)
    spec_g, audio_g, _ = session(pg, packets)
    check(np.array_equal(spec_g, spec_p) and audio_g.shape == audio_p.shape
          and pg._captured.k4_nodes == 0,
          "plain Griffin-Lim session: same spectrogram, no K4 node in its step")
    quirk = [k4_vs_plain_audio(torch, "persistent K4 vs plain Griffin-Lim, exp(angle), key 0",
                               audio_p, audio_g, spec_p, dec_on.gl_ops, converging=False)]
    plain_cfg = dataclasses.replace(cfg_on, use_cuda_gl=False)
    for key in range(1, QUIRK_KEYS):  # the same packets under other init tables
        _, a_k, _ = session(online.PersistentOnlineDecoder(cfg_on, dec_on, rand_source=key), packets)
        _, a_g, _ = session(online.PersistentOnlineDecoder(plain_cfg, dec_on, rand_source=key),
                            packets)
        quirk.append(k4_vs_plain_audio(torch, f"persistent K4 vs plain Griffin-Lim, exp(angle), "
                                       f"key {key}", a_k, a_g, spec_p, dec_on.gl_ops,
                                       converging=False))
    shares = [w for w, _ in quirk]
    say(f"  exp(angle), keys 0-{QUIRK_KEYS - 1}: {min(shares):.6f}-{max(shares):.6f} of samples "
        f"within 1 LSB, longest run of off hops {max(n for _, n in quirk)}")
    conv = dataclasses.replace(cfg_on, phase_bug=False)
    _, audio_cv, _ = session(online.PersistentOnlineDecoder(conv, dec_on), packets)
    _, audio_cvp, _ = session(online.PersistentOnlineDecoder(
        dataclasses.replace(conv, use_cuda_gl=False), dec_on), packets)
    k4_vs_plain_audio(torch, "persistent K4 vs plain Griffin-Lim, converging estimator",
                      audio_cv, audio_cvp, spec_p, dec_on.gl_ops, converging=True)

    # latency: packets fed PERSISTENT_GAP_S apart, so each finds the loop waiting
    pl = online.PersistentOnlineDecoder(cfg_on, dec_on)
    pl.warmup()

    def paced():
        start = time.perf_counter()
        for i, p in enumerate(packets):
            while time.perf_counter() < start + i * PERSISTENT_GAP_S:
                time.sleep(0.0002)
            pl.feed_packet(p)
        pl.feed_stop()

    feeder = threading.Thread(target=paced)
    feeder.start()
    spec_l, audio_l, _ = pl.run_until_stopped()
    feeder.join()
    lat = pl.tracer.latencies("packet_in", "step_done") * 1e3
    pct = {q: float(np.percentile(lat, q)) for q in (50, 95, 99)}
    pct["max"] = float(lat.max())
    say(f"  latency (packet_in -> outputs on the host), packets {PERSISTENT_GAP_S * 1e3:.0f} ms "
        f"apart: persistent p50 {pct[50]:.3f} ms, p95 {pct[95]:.3f} ms, p99 {pct[99]:.3f} ms, max "
        f"{pct['max']:.3f} ms over {len(lat)} packets; per-packet OnlineDecoder (phase 7, this "
        f"call) p50 {per_packet[0]:.3f}, p95 {per_packet[1]:.3f}, p99 {per_packet[2]:.3f}, max "
        f"{per_packet[3]:.3f} ms [{card}]")
    check(len(lat) == n_pkts and np.array_equal(spec_l, spec_on) and np.array_equal(audio_l, audio_on),
          "paced session: every packet timed, output bit-identical to OnlineDecoder's")

    # the closed loop over NSX through the CLI path, persistent
    n_loop = LOOP_S * SR // PACKET
    sent = packets[:n_loop].reshape(-1, packets.shape[-1])
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["NSX_REGISTRY_DIR"] = tmp
        config = configparser.ConfigParser()
        config["Decoding"] = {"stream_name": "smoke_pers", "griffin_lim_norm": str(int(GL_NORM))}
        result, error = {}, []

        def decode():
            try:
                result["out"] = cli.perform_online_decoding(
                    config, loaded, GL_NORM, tmp, max_packets=n_loop, backend="nsx", device=dev,
                    persistent=True)
            except BaseException as e:  # reported below; the phase fails
                error.append(e)

        t = threading.Thread(target=decode)
        t.start()
        dev_streamer.stream_eeg(sent, SR, "smoke_pers", backend="nsx", wait_for_consumers=60.0)
        t.join(timeout=300)
        check(not t.is_alive() and not error, f"persistent decode over NSX finished {error}")
    spec_n, audio_n, recv_n, sr_n = result["out"]
    check(sr_n == SR and np.array_equal(recv_n, sent), "persistent loopback: received sEEG equals "
          "what was sent")
    direct = session(online.PersistentOnlineDecoder(
        *cli._build_decoder(loaded, SR, packets.shape[-1], GL_NORM, torch.float32, dev, PACKET)),
        packets[:n_loop])
    check(np.array_equal(spec_n, direct[0]) and np.array_equal(audio_n, direct[1]),
          f"persistent loopback output {spec_n.shape} equals a direct persistent run")

    # release: a feeder error returns; an abort leaves the card usable
    class Broken:
        channels, nominal_srate, calls = packets.shape[-1], SR, 0

        def pull_chunk(self, max_samples=64, timeout=0.25):
            self.calls += 1
            if self.calls > 2:
                raise OSError("amplifier link dropped")
            return packets[self.calls - 1], 1.0

    pe = online.PersistentOnlineDecoder(cfg_on, dec_on)
    pe.warmup()
    t0 = time.perf_counter()
    try:
        pe.run_stream(Broken(), max_packets=n_pkts)
        raised = None
    except OSError as e:
        raised = e
    back_s = time.perf_counter() - t0
    check(raised is not None and back_s < 10 and len(pe.received) == 2,
          f"a feeder error after 2 packets returned in {back_s:.2f} s with 2 packets received")
    # nothing may allocate device memory while a loop waits (an allocation
    # can wait for the device, which waits for the host): the matmul's
    # cuBLAS workspace on its stream and its output block come first
    side = torch.cuda.Stream(dev)
    a = torch.randn(1024, 1024, device=dev)
    expected = (a.double() @ a.double()).float()
    with torch.cuda.stream(side):
        a @ a
    torch.cuda.synchronize()
    errors = []

    def waiting():
        try:
            pe.run_until_stopped()
        except RuntimeError as e:
            errors.append(e)

    runner = threading.Thread(target=waiting)
    runner.start()
    time.sleep(0.5)  # the loop spins in wait_packet_kernel
    ok = []
    for _ in range(2):
        with torch.cuda.stream(side):
            b = a @ a
            done = torch.cuda.Event()
            done.record(side)
        deadline = time.perf_counter() + 10
        while not done.query() and time.perf_counter() < deadline:
            time.sleep(0.001)
        completed = done.query()
        if runner.is_alive():
            pe._loop.abort()
            runner.join(timeout=10)
        ok.append(completed and torch.allclose(b, expected, rtol=1e-3, atol=1e-2))
    check(all(ok) and not runner.is_alive() and len(errors) == 1,
          "a matmul on another stream completed while the loop waited and after its abort; the "
          "aborted session raised")
    more = session(pe, packets[:PROFILE_PACKETS])
    check(len(more[0]) > 0, "the aborted decoder decodes its next session")
    return {"persistent_sessions": sessions, "persistent_iterations": iterations,
            "persistent_launches": iterations * k4_nodes, "persistent_profile_k4_runs": k4_runs,
            "persistent_init_launches": iterations * init_nodes,
            "persistent_ms_per_iteration": per_iter, "persistent_latency_ms": pct}


def _write_ini(path, sections):
    config = configparser.ConfigParser()
    for name, values in sections.items():
        config[name] = values
    with open(path, "w") as f:
        config.write(f)
    return path


def codec_rates(torch, card, eeg, audio, tmp):
    """The HDF5 codec on the training step's 30-min 128-ch recording (sEEG
    float64, audio 48 kHz): ``loaders.save_hdf5`` and ``load_hdf5`` MB/s, and
    the sEEG alone through the codec against a plain ``np.fromfile`` of the
    same bytes (both files just written, in the page cache).  Returns the
    figures."""
    from closed_loop_seeg_speech_synthesis_tpu_torch.io import hdf5, loaders

    eeg64 = eeg.double().cpu().numpy()
    path, raw = os.path.join(tmp, "speech_30min.hdf"), os.path.join(tmp, "sEEG.raw")
    mb = (eeg64.nbytes + audio.nbytes) / 1e6
    t0 = time.perf_counter()
    loaders.save_hdf5(path, eeg64, SR, audio, AUDIO_SR)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = loaders.load_hdf5(path)
    load_s = time.perf_counter() - t0
    check(np.array_equal(back[0], eeg64) and np.array_equal(back[2], audio) and back[1] == SR,
          f"load_hdf5 reads back the {mb / 1e3:.2f} GB recording equal")
    del back
    t0 = time.perf_counter()
    with hdf5.File(path, "r") as hf:
        codec = hf["sEEG"][:]
    codec_s = time.perf_counter() - t0
    os.remove(path)
    del codec
    eeg64.tofile(raw)
    t0 = time.perf_counter()
    plain = np.fromfile(raw, np.float64)
    plain_s = time.perf_counter() - t0
    os.remove(raw)
    check(np.array_equal(plain.reshape(eeg64.shape), eeg64), "np.fromfile reads the raw sEEG equal")
    del plain
    seeg_mb = eeg64.nbytes / 1e6
    fig = {"recording_mb": mb, "save_hdf5_mb_s": mb / write_s, "load_hdf5_mb_s": mb / load_s,
           "seeg_mb": seeg_mb, "codec_seeg_read_mb_s": seeg_mb / codec_s,
           "np_fromfile_mb_s": seeg_mb / plain_s, "codec_over_fromfile_time": codec_s / plain_s}
    say(f"  codec: save_hdf5 {mb:.1f} MB (sEEG {eeg64.shape} f64 + audio {audio.shape} f64) in "
        f"{write_s:.3f} s = {fig['save_hdf5_mb_s']:.1f} MB/s; load_hdf5 {load_s:.3f} s = "
        f"{fig['load_hdf5_mb_s']:.1f} MB/s; sEEG alone {codec_s:.3f} s = "
        f"{fig['codec_seeg_read_mb_s']:.1f} MB/s against np.fromfile of the same bytes "
        f"{plain_s:.3f} s = {fig['np_fromfile_mb_s']:.1f} MB/s ({fig['codec_over_fromfile_time']:.2f}x "
        f"its time; page cache warm) [{card}]")
    return fig


def cli_phase(torch, dev, card, arrs, train_eeg, train_audio, exp1_r, zero_counts, read_counts):
    """Step 9 of the module docstring: the CLIs end to end on files the
    port's codec writes.  Returns the stages' wall seconds, the codec's
    rates and the launches counted under the offline decode CLI."""
    from scipy.io import wavfile

    from closed_loop_seeg_speech_synthesis_tpu_torch.cli import decode as cli
    from closed_loop_seeg_speech_synthesis_tpu_torch.cli import dev_streamer, evaluate
    from closed_loop_seeg_speech_synthesis_tpu_torch.cli import train as train_cli
    from closed_loop_seeg_speech_synthesis_tpu_torch.io import hdf5, loaders
    from closed_loop_seeg_speech_synthesis_tpu_torch.io import session as session_mod
    from closed_loop_seeg_speech_synthesis_tpu_torch.io.utils import squeeze_audio_to_float64
    from closed_loop_seeg_speech_synthesis_tpu_torch.models import lda
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import griffinlim as gl
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import host_vocoder
    from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params, trainer

    out = {"stage_s": {}}

    def timed(name, fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out["stage_s"][name] = s = time.perf_counter() - t0
        say(f"  {name}: {s:.2f} s wall [{card}]")
        return res

    def read(path, *names):
        with hdf5.File(path, "r") as hf:
            return {n: hf[n][()] for n in (names or hf.keys())}

    with tempfile.TemporaryDirectory() as tmp:
        storage = os.path.join(tmp, "storage")
        out["codec"] = codec_rates(torch, card, train_eeg, train_audio, tmp)

        # (a) the train CLI on a 60 s recording, against trainer.train +
        # store_training on the same arrays
        eeg60 = train_eeg[: TRAIN_SLICE_S * SR].cpu().numpy()
        audio60 = train_audio[: TRAIN_SLICE_S * AUDIO_SR]
        rec = os.path.join(tmp, "speech.hdf")
        loaders.save_hdf5(rec, eeg60, SR, audio60, AUDIO_SR)
        cfg = _write_ini(os.path.join(tmp, "train.ini"), {
            "General": {"storage_dir": storage, "session": "trained"},
            "Training": {"file": rec, "overwrite_on_rerun": "True"}})
        path = timed(f"(a) cli.train.main, {TRAIN_SLICE_S} s x {C} ch",
                     lambda: train_cli.main([cfg, "--device", "cuda"], rng=np.random.RandomState(0)))
        session = os.path.dirname(path)
        check(all(os.path.exists(os.path.join(session, f)) for f in
                  ("params.h5", "LDAs.pkl", "training_features.npy", "train.ini", "train.log")),
              "train CLI artifacts written")
        eeg_r, _, audio_r, _, _ = loaders.load_hdf5(rec)
        audio_r = squeeze_audio_to_float64(audio_r)
        audio_r = audio_r + np.random.RandomState(0).normal(0, 0.0001, len(audio_r))
        result = trainer.train(eeg_r.astype(np.float64), audio_r, SR, AUDIO_SR, [], device=dev)
        ref_path = params.store_training(os.path.join(tmp, "arrays"), result, [])
        cli_h5, ref_h5 = read(path), read(ref_path)
        same = [n for n in ("lda_coef", "lda_intercept", "lda_classes", "lda_valid", "select",
                            "medians_array", "borders_array", "bad_channels")
                if np.array_equal(cli_h5[n], ref_h5[n]) and cli_h5[n].dtype == ref_h5[n].dtype]
        check(len(same) == 8, f"train CLI's params.h5 equals trainer.train + store_training "
                              f"on the same arrays (equal: {same})")
        with open(os.path.join(session, "LDAs.pkl"), "rb") as f:
            pkl = f.read()
        check(pkl == cli_h5["estimators"].tobytes(), "LDAs.pkl is params.h5's estimators blob")
        back = lda.from_sklearn_estimators(lda.load_estimators(pkl))
        coef, icpt = cli_h5["lda_coef"].copy(), cli_h5["lda_intercept"].copy()
        valid = cli_h5["lda_valid"]
        two = valid.sum(axis=1) == 2  # sklearn's binary convention: one row, class1 - class0
        coef[two, 1], icpt[two, 1] = coef[two, 1] - coef[two, 0], icpt[two, 1] - icpt[two, 0]
        coef[two, 0], icpt[two, 0] = 0.0, 0.0
        check(np.array_equal(back.valid.numpy(), valid)
              and np.array_equal(back.classes.numpy()[valid], cli_h5["lda_classes"][valid])
              and np.array_equal(back.coef.numpy()[valid], coef[valid])
              and np.array_equal(back.intercept.numpy()[valid], icpt[valid]),
              f"the pickled estimators (restricted unpickler, no sklearn) carry params.h5's "
              f"lda_* arrays ({int(two.sum())} binary bins)")

        # (b) the decode CLI, offline, on the same recording: the trained
        # model and the seed-0 published-width model, against the arrays
        published = os.path.join(storage, "published")
        os.makedirs(published)
        with hdf5.File(os.path.join(published, "params.h5"), "w") as hf:
            hf.create_dataset("bad_channels", data=np.zeros(0, np.int64))
            hf.create_dataset("medians_array", data=arrs["medians"])
            hf.create_dataset("select", data=np.asarray(arrs["select"], np.int64))
            for name in ("lda_coef", "lda_intercept", "lda_classes", "lda_valid"):
                hf.create_dataset(name, data=arrs[name])
        dcfg = _write_ini(os.path.join(tmp, "decode.ini"), {
            "General": {"storage_dir": storage, "session": "published"},
            "Decoding": {"stream_name": "x", "griffin_lim_norm": str(int(GL_NORM))}})
        models = {"trained": params.from_arrays(
                      result.lda.coef.cpu().numpy(), result.lda.intercept.cpu().numpy(),
                      result.lda.classes.cpu().numpy(), result.lda.valid.cpu().numpy(),
                      result.medians, result.select, [], dtype=torch.float32, device=dev),
                  "published": params.from_arrays(**arrs, dtype=torch.float32, device=dev)}
        runs = {}
        for name, loaded in models.items():
            zero_counts()
            run_dir = timed(f"(b) cli.decode.main offline, {name} model, {TRAIN_SLICE_S} s",
                            lambda: cli.main([dcfg, "--session", name, "--seeg_file", rec,
                                              "--run", "device", "--device", "cuda"]))
            launches = read_counts()
            if name == "published":
                out["decode_cli_launches"] = launches
            say(f"  launches under the decode CLI ({name}): {launches}")
            check(launches["frontend_decode_mels"] >= 1 and launches["gl_audio"] >= 1
                  and launches["block_inits"] >= 1, "K1, K2 and the inits' kernel launched "
                                                    "under the CLI")
            check(all(os.path.exists(os.path.join(run_dir, f))
                      for f in ("audio.wav", "sEEG.hdf", "spectrogram.npy", "decode.ini",
                                "decode.log")), f"decode CLI artifacts written ({name})")
            spec_cli = np.load(os.path.join(run_dir, "spectrogram.npy"))
            wav_sr, audio_cli = wavfile.read(os.path.join(run_dir, "audio.wav"))
            spec_a, audio_a, _, _ = cli.perform_offline_decoding(loaded, eeg60, SR, GL_NORM,
                                                                 device=dev)
            check(spec_cli.shape[1] == 40 and np.isfinite(spec_cli).all()
                  and np.array_equal(spec_cli, spec_a.cpu().numpy()),
                  f"{name}: the CLI's spectrogram.npy {spec_cli.shape} bit-identical to "
                  f"perform_offline_decoding on the same arrays")
            check(wav_sr == 16000 and np.array_equal(audio_cli, audio_a.cpu().numpy()
                                                     .astype(np.int16)),
                  f"{name}: the CLI's audio.wav equal to the arrays' decode")
            seeg = read(os.path.join(run_dir, "sEEG.hdf"))
            check(np.array_equal(seeg["sEEG"], eeg60) and seeg["sEEG_sr"] == SR,
                  f"{name}: sEEG.hdf reads back equal")
            runs[name] = (run_dir, spec_cli)

        # (c) the decode CLI's extra modes
        run_dir = timed(f"(c) cli.decode.main --vocoder exact-host, {TRAIN_SLICE_S} s",
                        lambda: cli.main([dcfg, "--seeg_file", rec, "--run", "exact",
                                          "--device", "cuda", "--vocoder", "exact-host"]))
        spec_x = np.load(os.path.join(run_dir, "spectrogram.npy"))
        _, audio_x = wavfile.read(os.path.join(run_dir, "audio.wav"))
        rows = gl.default_rand_init(spec_x.shape[0] - 1, 0, 0, torch.float64, "cpu").numpy()
        audio_h = host_vocoder.decode_audio_exact(spec_x.astype(np.float64), rows,
                                                  norm_factor=GL_NORM)
        check(np.array_equal(spec_x, runs["published"][1]), "exact-host: the device decode's "
                                                            "spectrogram")
        check(audio_x.tobytes() == audio_h.tobytes(), f"exact-host audio.wav ({len(audio_x)} "
              "samples) equals ops/host_vocoder on the same spectrogram and inits, byte for byte")
        prof = os.path.join(tmp, "profile")
        timed(f"(c) cli.decode.main --profile, {TRAIN_SLICE_S} s",
              lambda: cli.main([dcfg, "--seeg_file", rec, "--run", "profiled", "--device", "cuda",
                                "--profile", prof]))
        with open(os.path.join(prof, "trace.json")) as f:
            trace = f.read()
        names = ("gl_fft_kernel", "chunk_scan_kernel", "carry_scan_kernel", "features_kernel",
                 "lda_epilogue_kernel")
        say(f"  --profile: trace.json {len(trace) / 1e6:.1f} MB, kernels named: "
            f"{[n for n in names if n in trace]}")
        check(all(n in trace for n in names), "--profile's trace names gl_fft_kernel and K1's "
                                               "four kernels")

        # (d) files that h5py wrote: the committed fixtures
        fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                "fixtures_torch")
        rec_fx = os.path.join(fixtures, "recording_gzip.hdf")
        seeg_fx = read(rec_fx, "sEEG", "sEEG_sr")
        for name in ("params_jax.h5", "params_reference.h5"):
            sess = os.path.join(storage, name.split(".")[0])
            os.makedirs(sess)
            shutil.copyfile(os.path.join(fixtures, name), os.path.join(sess, "params.h5"))
            run_dir = timed(f"(d) cli.decode.main on h5py's {name} and gzip-chunked recording",
                            lambda: cli.main([dcfg, "--session", os.path.basename(sess),
                                              "--seeg_file", rec_fx, "--run", "fixture",
                                              "--device", "cuda"]))
            h5 = read(os.path.join(fixtures, name))
            if "lda_coef" in h5:
                loaded = params.from_arrays(h5["lda_coef"], h5["lda_intercept"], h5["lda_classes"],
                                            h5["lda_valid"], h5["medians_array"], h5["select"],
                                            h5["bad_channels"], dtype=torch.float32, device=dev)
            else:
                loaded = {"medians": h5["medians_array"], "select": h5["select"],
                          "bad_channels": h5["bad_channels"],
                          "lda": lda.from_sklearn_estimators(
                              lda.load_estimators(h5["estimators"].tobytes()),
                              dtype=torch.float32, device=dev)}
            spec_a, _, _, _ = cli.perform_offline_decoding(loaded, seeg_fx["sEEG"],
                                                           int(seeg_fx["sEEG_sr"]), GL_NORM,
                                                           device=dev)
            spec_cli = np.load(os.path.join(run_dir, "spectrogram.npy"))
            check(np.array_equal(spec_cli, spec_a.cpu().numpy()),
                  f"{name}: the CLI's spectrogram {spec_cli.shape} equals the arrays' decode")

        # (e) online through the CLIs: the dev streamer's main against the
        # decode CLI's online mode over NSX, paced in real time
        live = os.path.join(tmp, "live.hdf")
        eeg_live = train_eeg[: LOOP_S * SR].cpu().numpy()
        loaders.save_hdf5(live, eeg_live, SR, train_audio[: LOOP_S * AUDIO_SR], AUDIO_SR)
        os.environ["NSX_REGISTRY_DIR"] = os.path.join(tmp, "nsx")
        os.makedirs(os.environ["NSX_REGISTRY_DIR"])
        ocfg = _write_ini(os.path.join(tmp, "online.ini"), {
            "General": {"storage_dir": storage, "session": "published"},
            "Decoding": {"stream_name": "cli_sEEG", "griffin_lim_norm": str(int(GL_NORM)),
                         "marker_stream_name": "cli_markers", "run": "live"},
            "Development": {"file": live}})
        streamer = threading.Thread(target=dev_streamer.main, args=(
            [ocfg, "--stream_name", "cli_sEEG", "--backend", "nsx", "--markers"],), daemon=True)
        t_stream = time.perf_counter()
        streamer.start()
        run_dir = timed(f"(e) cli.decode.main online --backend nsx --max_packets "
                        f"{CLI_ONLINE_PACKETS}",
                        lambda: cli.main([ocfg, "--backend", "nsx", "--max_packets",
                                          str(CLI_ONLINE_PACKETS), "--device", "cuda"]))
        streamer.join(timeout=LOOP_S + 60)
        say(f"  dev_streamer.main streamed {LOOP_S} s in {time.perf_counter() - t_stream:.2f} s wall "
            f"[{card}]")
        check(not streamer.is_alive(), "dev_streamer.main finished")
        check(all(os.path.exists(os.path.join(run_dir, f))
                  for f in ("audio.wav", "sEEG.hdf", "spectrogram.npy", "decode.ini", "decode.log",
                            "first_timestamp.npy", "markers.csv")), "online CLI artifacts written")
        received = read(os.path.join(run_dir, "sEEG.hdf"))["sEEG"]
        sent = eeg_live.astype(np.float32)
        starts = [k for k in range(0, len(sent) - len(received) + 1, PACKET)
                  if np.array_equal(sent[k], received[0])]
        check(len(received) == CLI_ONLINE_PACKETS * PACKET and len(starts) == 1
              and np.array_equal(received, sent[starts[0] : starts[0] + len(received)]),
              f"every packet received: sEEG.hdf {received.shape} equals the streamed samples "
              f"from sample {starts[:1]} on")
        spec_live = np.load(os.path.join(run_dir, "spectrogram.npy"))
        with open(os.path.join(run_dir, "markers.csv")) as f:
            n_markers = sum(1 for line in f if ",start;" in line)
        say(f"  online: {CLI_ONLINE_PACKETS} packets from sample {starts[0]}, spectrogram "
            f"{spec_live.shape}, {n_markers} word markers logged")
        check(np.isfinite(spec_live).all() and spec_live.shape[1] == 40 and n_markers >= 1,
              "online spectrogram finite, markers logged")

        # (f) the evaluate CLI on the protocol session, written by the codec
        eeg_p, audio_p, words, markers = session_mod.make_synthetic_session(
            EXP1_WORDS, SR, AUDIO_SR, C, seed=0)
        protocol = os.path.join(storage, "protocol")
        os.makedirs(protocol)
        speech1 = os.path.join(protocol, "speech1.hdf")
        loaders.save_hdf5(speech1, eeg_p, SR, audio_p, AUDIO_SR,
                          ch_names=[f"ch_{i:03d}" for i in range(C)], markers=markers)
        pcfg = _write_ini(os.path.join(tmp, "protocol.ini"), {
            "General": {"storage_dir": storage, "session": "protocol",
                        "temp_dir": os.path.join(tmp, "evaluation")},
            "Training": {"file": speech1, "overwrite_on_rerun": "True"},
            "Experiment1": {"nb_randomization_runs": "1", "griffin_lim_norm": str(int(GL_NORM))}})
        timed(f"(f) cli.train.main on the {EXP1_WORDS}-word session",
              lambda: train_cli.main([pcfg, "--device", "cuda"], rng=np.random.RandomState(0)))
        act = timed("(f) cli.evaluate.main exp4",
                    lambda: evaluate.main([pcfg, "exp4", "--device", "cuda"]))
        check(np.isfinite(act).all() and np.abs(act).max() > 0 and os.path.exists(os.path.join(
            tmp, "evaluation", "protocol", "exp4", "activations.npy")),
            f"exp4 activations {act.shape} finite, nonzero, written")
        pm, _ = timed("(f) cli.evaluate.main exp1, 1 chance run",
                      lambda: evaluate.main([pcfg, "exp1", "--device", "cuda"]))
        out["exp1_cli_r"] = r_cli = float(np.mean(pm[0]))
        say(f"  exp1 through the CLI: proposed mean r {r_cli:.4f}; phase 11's Experiment1 from "
            f"arrays on the same session {exp1_r:.4f} (the CLI draws the dither from an unseeded "
            f"RandomState(), as the JAX CLI does)")
        check(abs(r_cli - exp1_r) <= CLI_EXP1_R_DIFF,
              f"exp1 CLI's proposed mean r within {CLI_EXP1_R_DIFF} of phase 11's")
    # each CLI points the root logger at its run's log file and stdout
    logging.basicConfig(level=logging.WARNING, force=True)
    return out


def main(argv=None):
    import torch

    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU")
    parser.add_argument("--bf16", action="store_true",
                        help="run only step 6b, the bf16 variants of K2/K4 and the bf16 replays")
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from closed_loop_seeg_speech_synthesis_tpu_torch.cli import decode as cli
    from closed_loop_seeg_speech_synthesis_tpu_torch.cli import dev_streamer
    from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import online
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import _build, cuda_frontend, cuda_gl, framing
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import griffinlim as gl
    from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params, pipeline

    dev = torch.device("cuda", 0)
    card = card_line()
    say(card)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")

    say("== build")
    sources = ("frontend_decode", "gl_audio", "persistent_loop", "prng")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, together
        list(pool.map(_build.load, sources))
    for name in sources:
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
    if args.bf16:  # step 6b alone, against this session's float32 decodes
        zero_counts, read_counts = launch_counters(torch)
        split = dict(use_cuda_epilogue=False, use_cuda_gl_tail=False)
        refs = tuple(pipeline.offline_decode(dec, c, eeg)
                     for c in (cfg, dataclasses.replace(cfg, **split)))
        bf16_phase(torch, card, dec, cfg, eeg, refs[0][0].contiguous(),
                   gl.default_rand_init(n_frames - 1, 0, 0, torch.float32, dev), refs,
                   zero_counts, read_counts)
        say(card)
        return 0

    # ---- K1: kernel vs plain at the main path's shapes --------------------
    say("== K1 frontend_decode_mels vs plain")

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
    # periods of 1,024 and 2,048 samples: the launches that stream y in slabs
    long_args = {}
    long_times = {"frontend_decode_mels": {}, "frontend_logpower": {}}

    def timed(kernel, plain, args, bnd):
        return {"ms": cuda_ms(torch, lambda: kernel(*args)),
                "plain_ms": cuda_ms(torch, lambda: plain(*args)), "bound_ms": bnd[0]}
    for sr_l in LONG_RATES:
        cfg_l, dec_l = cli._build_decoder(loaded, sr_l, C, GL_NORM, torch.float32, dev)
        eeg_l = torch.randn((sr_l * LONG_S, C), generator=g, device=dev)
        long_args[sr_l] = args_l = k1_inputs(dec_l, cfg_l, eeg_l)
        agree_l, flips_l, err_l = mel_agreement(torch, cuda_frontend.frontend_decode_mels(*args_l),
                                                cuda_frontend.frontend_decode_mels_plain(*args_l))
        say(f"  {sr_l} Hz (period {dec_l.frontend_ops.Ls} samples), {LONG_S} s: agreement "
            f"{agree_l:.6f}, flip rate {flips_l:.6f}, max abs err {err_l:.3e}")
        check(agree_l >= AGREE_MIN and flips_l < FLIP_MAX, f"K1 {sr_l} Hz agreement and label flips")
        long_times["frontend_decode_mels"][sr_l] = t_l = timed(
            cuda_frontend.frontend_decode_mels, cuda_frontend.frontend_decode_mels_plain, args_l,
            frontend_bound(dec_l.frontend_ops, eeg_l.shape[0], C, args_l[7], args_l[3]))
        say(f"  time at {sr_l} Hz, {LONG_S} s: kernel {t_l['ms']:.3f} ms, plain {t_l['plain_ms']:.3f} "
            f"ms, bound {t_l['bound_ms']:.3f} ms [{card}]")
        profile(torch, lambda: cuda_frontend.frontend_decode_mels(*args_l), 1, "call", top=4)
    k1_ms = cuda_ms(torch, lambda: cuda_frontend.frontend_decode_mels(*k1_args))
    k1_plain_ms = cuda_ms(torch, lambda: cuda_frontend.frontend_decode_mels_plain(*k1_args))
    k1_bound = frontend_bound(dec.frontend_ops, T, C, n_frames, k1_args[3])
    say(f"  time at {MINUTES} min: kernel {k1_ms:.3f} ms (fp32 design: 31.26), plain {k1_plain_ms:.3f} ms, "
        f"bound {k1_bound[0]:.3f} ms ({k1_bound[1]}, products in 3xTF32) [{card}]")
    fops = dec.frontend_ops
    Kp = -(-n_frames // fops.P)
    R = cuda_frontend.scan_chunk(fops, Kp)
    scan_steps = cuda_frontend.serial_scan_steps(fops, Kp)

    head_k1 = k1_inputs(dec, cfg, eeg[: 60 * SR])  # the session's first minute
    mel64 = cuda_frontend.frontend_decode_mels_plain(k1_args[0], eeg.double(), k1_args[2].double(),
                                                     *k1_args[3:])
    k1_flips = [mel_agreement(torch, m.double(), mel64)[1] for m in (mel_k, mel_p)]
    del mel64
    say(f"  label flips against the plain version in float64 over {MINUTES} min: kernel "
        f"{k1_flips[0]:.3e}, plain float32 {k1_flips[1]:.3e}")
    check(float64_flips_ok(*k1_flips), f"K1's label flips against float64 within twice the plain "
          f"float32 version's plus {F64_FLIP_FLOOR}")

    def frontend_checks(name, kernel, plain, args, head_args):
        """The scan's serial length, the float64 comparison on the first
        minute, and one profiled call naming the launches."""
        say(f"  boundary scan: {scan_steps} serial steps over {Kp} periods ({R} chunk-local + "
            f"{-(-Kp // R) - 1} carry; Kp / R + R = {Kp / R + R:.1f}; a sequential scan: {Kp})")
        err_k, err_32 = float64_tracking(torch, kernel, plain, head_args)
        say(f"  first 60 s against the plain version in float64: p99.9 |error| kernel {err_k:.3e}, "
            f"plain float32 {err_32:.3e}")
        check(err_k <= 2 * err_32, f"{name} within twice the plain float32 version's p99.9 error")
        profile(torch, lambda: kernel(*args), 1, "call", top=5)
        return err_k, err_32

    k1_f64 = frontend_checks("K1", cuda_frontend.frontend_decode_mels,
                             cuda_frontend.frontend_decode_mels_plain, k1_args, head_k1)
    # the same products as fp32 torch.matmul (TF32 off), for reference: the
    # dense Toeplitz Tmat u and Pmat u of every period, K1's LDA (not a
    # library_ms: no one call computes K1's or K3's function)
    need = Kp * fops.Ls
    u3 = (eeg[:need] if T >= need else torch.nn.functional.pad(eeg, (0, 0, 0, need - T))).view(
        Kp, fops.Ls, C)
    f_stack = torch.randn((n_frames, k1_args[3].shape[0]), generator=g, device=dev)

    def frontend_products(lda):
        fops.Tmat @ u3
        fops.Pmat @ u3
        if lda:
            f_stack @ k1_args[3]

    k1_mm_ms = cuda_ms(torch, lambda: frontend_products(True))
    k3_mm_ms = cuda_ms(torch, lambda: frontend_products(False))
    say(f"  reference: torch.matmul fp32, Tmat @ u ({Kp} x {fops.Ls} x {fops.Ls} x {C}), Pmat @ u "
        f"and the LDA ({n_frames} x {k1_args[3].shape[0]} x {k1_args[3].shape[1]}): "
        f"{k1_mm_ms:.3f} ms; all of K1: {k1_ms:.3f} ms [{card}]")
    del f_stack

    # ---- K3: kernel vs plain at the split path's shapes -------------------
    say("== K3 frontend_logpower vs plain")

    k3_args = k1_args[:3] + (n_frames,)
    k3_err = k3_agreement(torch, k3_args, f"1024 Hz, {MINUTES} min")
    k3_agreement(torch, k1_args2[:3] + (k1_args2[7],), f"2048 Hz, {MINUTES_2048} min")
    for sr_l, args_l in long_args.items():
        a3 = args_l[:3] + (args_l[7],)
        k3_agreement(torch, a3, f"{sr_l} Hz, {LONG_S} s")
        long_times["frontend_logpower"][sr_l] = t_l = timed(
            cuda_frontend.frontend_logpower, cuda_frontend.frontend_logpower_plain, a3,
            frontend_bound(args_l[0], args_l[1].shape[0], C, args_l[7]))
        say(f"  time at {sr_l} Hz, {LONG_S} s: kernel {t_l['ms']:.3f} ms, plain {t_l['plain_ms']:.3f} "
            f"ms, bound {t_l['bound_ms']:.3f} ms [{card}]")
    del long_args
    k3_ms = cuda_ms(torch, lambda: cuda_frontend.frontend_logpower(*k3_args))
    k3_plain_ms = cuda_ms(torch, lambda: cuda_frontend.frontend_logpower_plain(*k3_args))
    k3_bound = frontend_bound(dec.frontend_ops, T, C, n_frames)
    say(f"  time at {MINUTES} min: kernel {k3_ms:.3f} ms (fp32 design: 25.82), plain {k3_plain_ms:.3f} ms, "
        f"bound {k3_bound[0]:.3f} ms ({k3_bound[1]}, products in 3xTF32) [{card}]")
    k3_f64 = frontend_checks("K3", cuda_frontend.frontend_logpower,
                             cuda_frontend.frontend_logpower_plain, k3_args,
                             head_k1[:3] + (head_k1[7],))
    say(f"  reference: torch.matmul fp32, Tmat @ u and Pmat @ u: {k3_mm_ms:.3f} ms; all of K3: "
        f"{k3_ms:.3f} ms [{card}]")
    del u3

    B_gl = n_frames - 1
    # ---- the block inits: kernel vs plain at the replay's table -----------
    say(f"== block inits (csrc/prng.cu) vs plain: JAX's threefry uniform rows, B = {B_gl}")
    inits = block_inits_phase(torch, dev, card, B_gl)

    # ---- K2: kernel vs plain at the main path's shapes --------------------
    say(f"== K2 gl_audio vs plain: B = {B_gl} blocks, Griffin-Lim regime {cuda_gl.regime(B_gl)}")
    lm = mel_k.contiguous()
    rand = gl.default_rand_init(B_gl, 0, 0, torch.float32, dev)
    ops = dec.gl_audio_ops
    k2_err = k2_agreement(cuda_gl, lm, rand, ops, f"{MINUTES} min")
    rand0 = rand.clone()  # K4 without iterations below: sample 0 zeroed as in k2_agreement
    rand0[0, 0] = 0.0
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
    k2_bound = gl_bound(cuda_gl, B_gl, lm.shape[1], 8, True, ops, tail=True)
    say(f"  time at {MINUTES} min: kernel {k2_ms:.3f} ms (PR 3: 42.72), plain {k2_plain_ms:.3f} ms, "
        f"bound {k2_bound[0]:.3f} ms ({k2_bound[1]}) [{card}]")

    # ---- K4: kernel vs plain at the split path's shapes -------------------
    say("== K4 gl_blocks vs plain")
    gops = dec.gl_audio_ops
    e0 = (cuda_gl.gl_blocks(lm, rand0, gops, 0, True) - cuda_gl.gl_blocks_plain(lm, rand0, gops, 0, True)).abs()
    say(f"  iterations=0: max abs err {e0.max().item():.3e}")
    check(e0.max().item() <= K4_ATOL, f"K4 iterations=0 within atol {K4_ATOL}")
    e1 = (cuda_gl.gl_blocks(lm, rand, gops, 8, False) - cuda_gl.gl_blocks_plain(lm, rand, gops, 8, False)).abs()
    within4 = (e1 <= K4_ATOL).double().mean().item()
    k4_err = e1.max().item()
    say(f"  phase_bug=False, 8 iterations: {within4:.6f} of samples within {K4_ATOL}, max abs err {k4_err:.3e}")
    check(within4 >= WITHIN_MIN, f"K4 phase_bug=False within atol {K4_ATOL} on >= 99.9%")
    ola_k = gl.overlap_add_stream(cuda_gl.gl_blocks(lm, rand, gops, 8, True), gops.gl)
    ola_p = gl.overlap_add_stream(cuda_gl.gl_blocks_plain(lm, rand, gops, 8, True), gops.gl)
    att4_k, att4_p = attainment(torch, ola_k, lm, gops.gl), attainment(torch, ola_p, lm, gops.gl)
    r4 = corr(torch, hop_energy(torch, ola_k), hop_energy(torch, ola_p))
    say(f"  phase_bug=True, 8 iterations: attainment kernel {att4_k:.4f} plain {att4_p:.4f}, "
        f"per-hop energy r {r4:.4f}")
    check(att4_k <= 1.1 * att4_p and r4 > 0.9, "K4 phase_bug=True quality gate")
    k4_ms = cuda_ms(torch, lambda: cuda_gl.gl_blocks(lm, rand, gops, 8, True))
    k4_plain_ms = cuda_ms(torch, lambda: cuda_gl.gl_blocks_plain(lm, rand, gops, 8, True))
    k4_bound = gl_bound(cuda_gl, B_gl, lm.shape[1], 8, True, gops)
    say(f"  time at {MINUTES} min: kernel {k4_ms:.3f} ms (PR 3: 41.32), plain {k4_plain_ms:.3f} ms, "
        f"bound {k4_bound[0]:.3f} ms ({k4_bound[1]}) [{card}]")

    # the two regimes on the same blocks: the FFT kernel (threshold 0)
    # against the cluster kernel (threshold REGIME_BLOCKS)
    say(f"== K4 regimes on the session's first {REGIME_BLOCKS} blocks: FFT (fp32) vs "
        f"cluster (fp32)")
    lm_r = lm[: REGIME_BLOCKS + 1].contiguous()

    def regimes(r, its, bug):
        out = []
        for threshold in (0, REGIME_BLOCKS):
            with regime_threshold(cuda_gl, threshold):
                out.append(cuda_gl.gl_blocks(lm_r, r[:REGIME_BLOCKS].contiguous(), gops, its, bug))
        return out

    m0, c0 = regimes(rand0, 0, True)
    check(torch.equal(m0, c0), "K4 regimes identical without iterations")
    for name, bug in (("phase_bug=False", False), ("phase_bug=True", True)):
        m1, c1 = regimes(rand, 8, bug)
        e_r = (m1 - c1).abs()
        within_r = (e_r <= K4_ATOL).double().mean().item()
        say(f"  {name}, 8 iterations: {within_r:.6f} of samples within {K4_ATOL}, max abs err "
            f"{e_r.max().item():.3e}")
        if not bug:
            check(within_r >= WITHIN_MIN, f"K4 regimes agree within atol {K4_ATOL} on >= 99.9% "
                  "(converging estimator)")

    # the same products as fp32 torch.matmul, for reference (not a library_ms:
    # no one call computes K4's function)
    check(not torch.backends.cuda.matmul.allow_tf32, "torch.matmul in full fp32 (TF32 off)")
    frames_r = torch.randn((2 * B_gl, 256), generator=g, device=dev)
    fwd_op, inv_op = gops.gl_f32[1], gops.gl_f32[2][:128].contiguous()

    def dft_products():
        for _ in range(8):
            (frames_r @ fwd_op)[:, :128] @ inv_op

    mm_ms = cuda_ms(torch, dft_products)
    say(f"  reference: torch.matmul fp32, the 8 iterations' forward ({2 * B_gl} x 256 x 256) and "
        f"inverse ({2 * B_gl} x 128 x 256) products: {mm_ms:.3f} ms; all of K4: {k4_ms:.3f} ms [{card}]")
    del frames_r

    # ---- the main path --------------------------------------------------
    say(f"== main path: cli.decode.perform_offline_decoding, {C} ch, {SR} Hz, {MINUTES} min")
    zero_counts, read_counts = launch_counters(torch)
    zero_counts()
    spec, audio, _, _ = cli.perform_offline_decoding(loaded, eeg, SR, GL_NORM, device=dev)
    launches = read_counts()
    say(f"  launches: {launches}")
    check(launches["frontend_decode_mels"] >= 1 and launches["gl_audio"] >= 1,
          "K1 and K2 launched on the fused replay path")
    check(launches["block_inits"] == 1, "the replay drew its Griffin-Lim inits with one launch "
          "of the block inits' kernel")
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
    profile(torch, lambda: pipeline.offline_decode(dec, cfg, eeg), 1, "decode", top=10)

    # the float64 CPU path is the one held bit-equal to the JAX package
    # (tests/test_torch_pipeline.py): the card's f32 output must stay inside
    # the f32 label-flip budget against it on the session's first minute
    say("== reference: the first 60 s through the float64 CPU path")
    head = eeg[: 60 * SR]
    n_head = len(framing.streaming_frame_ends(cfg.frame_len_ms, cfg.frame_shift_ms, SR,
                                              head.shape[0] + cfg.prefill))
    ref_spec, ref_audio, _, _ = cli.perform_offline_decoding(
        loaded, head.cpu(), SR, GL_NORM, device="cpu", rand_init=rand[: n_head - 1].cpu())
    card_spec, card_audio, _, _ = cli.perform_offline_decoding(
        loaded, head, SR, GL_NORM, rand_init=rand[: n_head - 1])
    _, flips_ref, _ = mel_agreement(torch, card_spec.double().cpu(), ref_spec)
    r_ref = corr(torch, hop_energy(torch, card_audio.cpu()), hop_energy(torch, ref_audio))
    say(f"  card f32 vs CPU f64: label flips {flips_ref:.6f}, audio per-hop energy r {r_ref:.4f}")
    check(card_spec.shape == ref_spec.shape and flips_ref < FLIP_MAX and r_ref > 0.9,
          "card output within the f32 budget of the float64 path")

    # ---- the split replay path --------------------------------------------
    say(f"== split path: perform_offline_decoding(use_cuda_epilogue=False, use_cuda_gl_tail=False), "
        f"{C} ch, {SR} Hz, {MINUTES} min")
    split = dict(use_cuda_epilogue=False, use_cuda_gl_tail=False)
    zero_counts()
    spec_s, audio_s, _, _ = cli.perform_offline_decoding(loaded, eeg, SR, GL_NORM, device=dev, **split)
    split_launches = read_counts()
    say(f"  launches: {split_launches}")
    check(split_launches["frontend_logpower"] >= 1 and split_launches["gl_blocks"] >= 1
          and split_launches["frontend_decode_mels"] == 0 and split_launches["gl_audio"] == 0,
          "K3 and K4 launched on the split path, K1 and K2 not")
    check(split_launches["block_inits"] == 1, "the split replay drew its inits with one launch")
    check(spec_s.shape == spec.shape and audio_s.shape == audio.shape
          and bool(torch.isfinite(spec_s).all()), "split path shapes, finite")
    _, flips_s, _ = mel_agreement(torch, spec_s, spec)
    r_s = corr(torch, hop_energy(torch, audio_s), hop_energy(torch, audio))
    say(f"  split vs fused: label flips {flips_s:.6f}, audio per-hop energy r {r_s:.4f}")
    check(flips_s < FLIP_MAX and r_s > 0.9, "split path within the f32 budget of the fused path")
    cfg_split = dataclasses.replace(cfg, **split)
    split_runs = {"fused": [], "split": []}
    for which in ("fused", "split", "split", "fused"):
        c = cfg_split if which == "split" else cfg
        split_runs[which].append(cuda_ms(torch, lambda: pipeline.offline_decode(dec, c, eeg), reps=1))
    split_ms = {k: float(np.mean(v)) for k, v in split_runs.items()}
    say(f"  decode time (CUDA events, params built): split {split_runs['split']} ms, "
        f"fused {split_runs['fused']} ms")
    say(f"  xRT: split {duration_s / (split_ms['split'] / 1e3):.1f}, "
        f"fused {duration_s / (split_ms['fused'] / 1e3):.1f}")
    check(launches["gl_audio_bf16"] == launches["gl_blocks_bf16"] == 0
          and split_launches["gl_audio_bf16"] == split_launches["gl_blocks_bf16"] == 0,
          "no bf16 variant launched on the float32 replays")

    # ---- the bf16 variants and the bf16 replays ---------------------------
    k4_bf16, k2_bf16 = bf16_phase(torch, card, dec, cfg, eeg, lm, rand,
                                  ((spec, audio), (spec_s, audio_s)), zero_counts, read_counts)

    # ---- the online step --------------------------------------------------
    say(f"== online: OnlineDecoder.process_packet, {C} ch, {SR} Hz, {PACKET}-sample packets, "
        f"{ONLINE_S} s")
    n_pkts = ONLINE_S * SR // PACKET
    head_on = eeg[: n_pkts * PACKET]
    packets = head_on.cpu().numpy().reshape(n_pkts, PACKET, C)
    cfg_on, dec_on = cli._build_decoder(loaded, SR, C, GL_NORM, torch.float32, dev, PACKET, **split)

    def run_online(chunk_steps, c=cfg_on, pipelined=False):
        d = online.OnlineDecoder(c, dec_on, chunk_steps=chunk_steps, pipelined=pipelined)
        d.warmup()
        zero_counts()
        for p in packets:
            d.process_packet(p)
        out = d.results()
        counts = read_counts()
        # the wrappers count at capture only (in warmup): each replay runs
        # its graph's recorded K4 and block-init nodes
        counts["gl_blocks"] += sum(n * d.programs[k].k4_nodes for k, n in d.replays.items())
        counts["block_inits"] += sum(n * d.programs[k].init_nodes for k, n in d.replays.items())
        return d, out, counts

    def run_eager(c=cfg_on):
        """The reference: a plain loop of the eager step, each packet moved
        to the card and its four outputs read back as the per-packet
        decoder did before it replayed a graph; per-packet ms."""
        step = pipeline.make_online_step(dec_on, c)
        carry = pipeline.init_online_carry(dec_on, c)
        step(carry, torch.zeros((PACKET, C), dtype=c.dtype, device=dev))
        torch.cuda.synchronize()
        specs, chunks, ms = [], [], []
        for p in packets:
            t0 = time.perf_counter()
            carry, out = step(carry, torch.as_tensor(p).to(device=dev, dtype=c.dtype))
            host = {k: v.cpu().numpy() for k, v in out.items()}
            ms.append((time.perf_counter() - t0) * 1e3)
            specs.append(host["spec"][host["spec_valid"]])
            chunks.append(host["audio"][host["audio_valid"]])
        return np.concatenate(specs), np.concatenate(chunks).reshape(-1), np.asarray(ms)

    def pcts(lat):
        return tuple(float(np.percentile(lat, q)) for q in (50, 95, 99)) + (float(lat.max()),)

    spec_e, audio_e, lat_e = run_eager()
    dec1, (spec_on, audio_on, recv_on), on_launches = run_online(1)
    say(f"  launches: {on_launches} (K4 and block inits: graph replays x recorded nodes); graph "
        f"replays {dec1.replays}")
    check(on_launches["gl_blocks"] >= n_pkts and on_launches["gl_blocks_bf16"] == 0,
          f"K4 (f32) launched on every one of {n_pkts} packets, its bf16 variant never")
    check(on_launches["block_inits"] == n_pkts, f"the block inits' kernel launched once in each "
          f"of {n_pkts} packets")
    check(dec1.replays == {1: n_pkts} and dec1.programs[1].k4_nodes == 1,
          f"one graph replay a packet ({dec1.replays}), K4 one node of the recorded step")
    per_packet = pcts(dec1.tracer.latencies("packet_in", "step_done") * 1e3)
    eager_pct = pcts(lat_e)
    say(f"  per-packet latency (packet_in -> outputs on the host), graph replay: p50 "
        f"{per_packet[0]:.3f} ms, p95 {per_packet[1]:.3f} ms, p99 {per_packet[2]:.3f} ms, max "
        f"{per_packet[3]:.3f} ms over {n_pkts} packets; eager step loop: p50 {eager_pct[0]:.3f} ms, "
        f"p95 {eager_pct[1]:.3f} ms, p99 {eager_pct[2]:.3f} ms, max {eager_pct[3]:.3f} ms [{card}]")
    check(per_packet[2] < P99_LIMIT_MS, f"per-packet p99 {per_packet[2]:.3f} ms < {P99_LIMIT_MS} ms")
    check(np.array_equal(spec_on, spec_e) and np.array_equal(audio_on, audio_e)
          and np.array_equal(recv_on, packets.reshape(-1, C)),
          f"graph decoder (K=1) bit-identical to the eager step loop, spec {spec_on.shape} audio "
          f"{audio_on.shape}")
    spec_ref, audio_ref = pipeline.offline_decode(dec_on, cfg_on, head_on)
    check(spec_on.shape == tuple(spec_ref.shape) and audio_on.shape == tuple(audio_ref.shape),
          f"online shapes spec {spec_on.shape} audio {audio_on.shape} == offline's")
    _, flips_on, _ = mel_agreement(torch, torch.as_tensor(spec_on), spec_ref.cpu())
    r_on = corr(torch, hop_energy(torch, torch.as_tensor(audio_on)), hop_energy(torch, audio_ref.cpu()))
    say(f"  online vs offline split path: label flips {flips_on:.6f}, audio per-hop energy r {r_on:.4f}")
    check(flips_on < FLIP_MAX and r_on > 0.9, "online step within the f32 budget of the offline decode")
    modes = {}
    for k, pl in ((1, True), (4, False), (4, True)):
        dk, (spec_k, audio_k, _), counts_k = run_online(k, pipelined=pl)
        modes[f"K={k}{' pipelined' if pl else ''}"] = pcts(dk.tracer.latencies("packet_in", "step_done") * 1e3)
        check(np.array_equal(spec_k, spec_e) and np.array_equal(audio_k, audio_e),
              f"graph decoder (K={k}, pipelined={pl}) bit-identical to the eager step loop")
        check(dk.replays == {**({1: 0} if k > 1 else {}), k: n_pkts // k}
              and counts_k["gl_blocks"] == n_pkts and dk.programs[k].k4_nodes == k,
              f"K={k}, pipelined={pl}: {dk.replays} graph replays, {k} K4 node(s) a replay, "
              f"{counts_k['gl_blocks']} K4 launches")
    check(np.array_equal(spec_k, spec_on) and np.array_equal(audio_k, audio_on),
          "chunk_steps=4 bit-identical to chunk_steps=1")
    for name, q in modes.items():
        say(f"  {name}: packet_in -> outputs on the host p50 {q[0]:.3f} ms, p95 {q[1]:.3f} ms, "
            f"p99 {q[2]:.3f} ms, max {q[3]:.3f} ms (a chunk's latency counts from its last packet)")
    d_prof = online.OnlineDecoder(cfg_on, dec_on)
    d_prof.warmup()
    for p in packets[:PROFILE_PACKETS]:  # past the start-up packets
        d_prof.process_packet(p)
    on_prof = profile(torch, lambda: [d_prof.process_packet(p)
                                      for p in packets[PROFILE_PACKETS : 2 * PROFILE_PACKETS]],
                      PROFILE_PACKETS, "packet")
    check(on_prof["graph_launches"] == PROFILE_PACKETS and on_prof["kernel_launches"] == 0,
          f"profiler: {on_prof['graph_launches']} cudaGraphLaunch and "
          f"{on_prof['kernel_launches']} host kernel launches over {PROFILE_PACKETS} packets")

    # K4 at the step's own shapes: B = 1..4 blocks of consecutive mel frames
    # of this session with their block-indexed inits, one cluster of 4
    # blocks with the ragged blocks masked
    gops_on = dec_on.gl_audio_ops
    small = {"iterations=0": [], "phase_bug=False": [], "phase_bug=True": []}
    for k in range(0, spec_ref.shape[0] - 5, 59):
        for B in range(1, 5):
            lm_b = spec_ref[k : k + B + 1].contiguous()
            r_b = gl.block_rand(torch.arange(k, k + B, device=dev), 0, torch.float32)
            for name, its, bug in (("iterations=0", 0, True), ("phase_bug=False", 8, False),
                                   ("phase_bug=True", 8, True)):
                small[name].append((cuda_gl.gl_blocks(lm_b, r_b, gops_on, its, bug)
                                    - cuda_gl.gl_blocks_plain(lm_b, r_b, gops_on, its, bug))
                                   .abs().reshape(-1))
    small = {name: torch.cat(v) for name, v in small.items()}
    for name, e in small.items():
        say(f"  K4 at B = 1..4, {name}: {(e <= K4_ATOL).double().mean().item():.6f} of "
            f"{e.numel()} samples within {K4_ATOL}, max abs err {e.max().item():.3e}")
    check(small["iterations=0"].max().item() <= K4_ATOL,
          f"K4 at B = 1..4 iterations=0 within atol {K4_ATOL}")
    for name in ("phase_bug=False", "phase_bug=True"):
        check((small[name] <= K4_ATOL).double().mean().item() >= WITHIN_MIN,
              f"K4 at B = 1..4 {name} within atol {K4_ATOL} on >= 99.9%")
    lm4, r4 = spec_ref[:5].contiguous(), gl.block_rand(torch.arange(4, device=dev), 0, torch.float32)
    cuda_gl.gl_blocks(lm4, r4, gops_on, 8, True)
    k4_b4_ms = cuda_ms(torch, lambda: [cuda_gl.gl_blocks(lm4, r4, gops_on, 8, True)
                                       for _ in range(K4_ONLINE_LAUNCHES)]) / K4_ONLINE_LAUNCHES
    k4_b4_bound = gl_bound(cuda_gl, 4, lm4.shape[1], 8, True, gops_on)
    say(f"  K4 at B = 4 ({cuda_gl.regime(4)} regime: one cluster of 8 CTAs, cudaLaunchKernelEx): "
        f"{k4_b4_ms * 1e3:.2f} us a launch over {K4_ONLINE_LAUNCHES} launches (PR 3: "
        f"{PR3_K4_B4_MS * 1e3:.0f} us), bound {k4_b4_bound[0] * 1e3:.3f} us ({k4_b4_bound[1]}) [{card}]")
    check(cuda_gl.regime(4) == "cluster", "the online step's K4 launches as a cluster")

    # the same packets with the plain Griffin-Lim in the step, under the
    # reference's exp(angle) quirk (the decoder's default) and with the
    # converging estimator
    _, (spec_pg, audio_pg, _), pg_launches = run_online(
        1, dataclasses.replace(cfg_on, use_cuda_gl=False))
    say(f"  plain Griffin-Lim run: K4 launches {pg_launches['gl_blocks']}")
    check(pg_launches["gl_blocks"] == 0 and np.array_equal(spec_pg, spec_on)
          and audio_pg.shape == audio_on.shape, "plain Griffin-Lim run: no K4, same spectrogram")
    k4_vs_plain_audio(torch, "online K4 vs plain Griffin-Lim, exp(angle)", audio_on, audio_pg,
                      spec_on, dec_on.gl_ops, converging=False)
    conv = dataclasses.replace(cfg_on, phase_bug=False)
    _, (_, audio_cv, _), _ = run_online(1, conv)
    _, (_, audio_cvp, _), _ = run_online(1, dataclasses.replace(conv, use_cuda_gl=False))
    k4_vs_plain_audio(torch, "online K4 vs plain Griffin-Lim, converging estimator", audio_cv,
                      audio_cvp, spec_on, dec_on.gl_ops, converging=True)

    # ---- the closed loop over the NSX transport ----------------------------
    say(f"== loopback: dev_streamer.stream_eeg -> perform_online_decoding over NSX, {LOOP_S} s")
    n_loop = LOOP_S * SR // PACKET
    sent = packets[:n_loop].reshape(-1, C)
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["NSX_REGISTRY_DIR"] = tmp
        config = configparser.ConfigParser()
        config["Decoding"] = {"stream_name": "smoke_sEEG", "griffin_lim_norm": str(int(GL_NORM))}
        result, error = {}, []

        def decode():
            try:
                result["out"] = cli.perform_online_decoding(
                    config, loaded, GL_NORM, tmp, max_packets=n_loop, backend="nsx", device=dev)
            except BaseException as e:  # reported below; the phase fails
                error.append(e)

        t = threading.Thread(target=decode)
        t.start()
        # paced in real time, as an amplifier sends: the decoder subscribes
        # before it builds its parameters, and an unpaced sender fills the
        # socket and drops a subscriber that has not read for 1 s
        # (native/nsx.cpp's send budget), losing the packets after that
        dev_streamer.stream_eeg(sent, SR, "smoke_sEEG", backend="nsx", wait_for_consumers=60.0)
        t.join(timeout=300)
        check(not t.is_alive() and not error, f"online decode over NSX finished {error}")
    spec_l, audio_l, recv_l, sr_l = result["out"]
    check(sr_l == SR and np.array_equal(recv_l, sent), "received sEEG equals what was sent")
    d_ref = online.OnlineDecoder(*cli._build_decoder(loaded, SR, C, GL_NORM, torch.float32, dev, PACKET))
    for p in packets[:n_loop]:
        d_ref.process_packet(p)
    spec_d, audio_d, _ = d_ref.results()
    check(np.array_equal(spec_l, spec_d) and np.array_equal(audio_l, audio_d),
          f"loopback output {spec_l.shape} equals a direct OnlineDecoder run")

    # ---- the persistent loop -------------------------------------------------
    say(f"== persistent: PersistentOnlineDecoder, one graph launch a session, {C} ch, {SR} Hz, "
        f"{PACKET}-sample packets, {ONLINE_S} s")
    pers = persistent_phase(torch, dev, card, cli, online, cuda_gl, cfg_on, dec_on, packets, loaded,
                            per_packet, (spec_on, audio_on))
    pers_inits = pers.pop("persistent_init_launches")

    # ---- training -----------------------------------------------------------
    say(f"== training: runtime.trainer.train, {C} ch, {SR} Hz, {MINUTES} min, f32 and f64")
    train_eeg, train_audio = training_phase(torch, dev, eeg, SR, zero_counts, read_counts)

    # ---- exp1 ---------------------------------------------------------------
    say(f"== exp1 on the card: Experiment1 from arrays, {EXP1_WORDS} words, {C} ch, {SR} Hz, "
        f"{EXP1_FOLDS} folds, {EXP1_RUNS} chance runs, f32")
    ex = exp1_phase(torch, dev, card, zero_counts, read_counts)
    # K1 and K2 at a fold's shapes (30 s held out, its trained model)
    fr, (xt, xe, q, ym, med) = ex["fold"]
    fold_params = fr.fit(xt, q, ym, med)
    k1_fold = k1_inputs(fold_params, fr.cfg, xe)
    mel_f = cuda_frontend.frontend_decode_mels(*k1_fold)
    torch.cuda.synchronize()
    # a fold's scan runs ragged chunks (scan_chunk of its periods), which the
    # 30-min and 60 s shapes above do not
    agree_f, flips_f, k1_fold_err = mel_agreement(torch, mel_f,
                                                  cuda_frontend.frontend_decode_mels_plain(*k1_fold))
    kp_f = -(-k1_fold[-3] // fold_params.frontend_ops.P)
    say(f"  K1 at a fold's shapes ({xe.shape[0]} samples, {kp_f} periods, scan chunk "
        f"{cuda_frontend.scan_chunk(fold_params.frontend_ops, kp_f)}): agreement {agree_f:.6f}, "
        f"flip rate {flips_f:.6f}, max abs err {k1_fold_err:.3e}")
    check(agree_f >= AGREE_MIN and flips_f < FLIP_MAX, "K1 at a fold's shapes: agreement and label flips")
    rand_f = gl.default_rand_init(mel_f.shape[0] - 1, 0, 0, torch.float32, dev)
    k2_fold_err = k2_agreement(cuda_gl, mel_f.contiguous(), rand_f, fold_params.gl_audio_ops,
                               "at a fold's shapes")
    k2_fold = (mel_f.contiguous(), rand_f, fold_params.gl_audio_ops, GL_NORM, 8, True)
    exp1_times = {
        "frontend_decode_mels": (cuda_ms(torch, lambda: cuda_frontend.frontend_decode_mels(*k1_fold)),
                                 cuda_ms(torch, lambda: cuda_frontend.frontend_decode_mels_plain(*k1_fold)),
                                 frontend_bound(fold_params.frontend_ops, xe.shape[0], C,
                                                mel_f.shape[0], k1_fold[3])),
        "gl_audio": (cuda_ms(torch, lambda: cuda_gl.gl_audio(*k2_fold)),
                     cuda_ms(torch, lambda: cuda_gl.gl_audio_plain(*k2_fold)),
                     gl_bound(cuda_gl, mel_f.shape[0] - 1, mel_f.shape[1], 8, True,
                              fold_params.gl_audio_ops, tail=True)),
    }
    for name, (ms, plain_ms, bnd) in exp1_times.items():
        say(f"  {name} at a fold's shapes ({xe.shape[0]} samples, {mel_f.shape[0]} frames): kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}) [{card}]")
    profile(torch, lambda: cuda_frontend.frontend_decode_mels(*k1_fold), 1, "call", top=4)

    exp1_errs = {"frontend_decode_mels": k1_fold_err, "gl_audio": k2_fold_err}

    # ---- the CLIs on files ----------------------------------------------------
    say(f"== CLIs: train -> decode (offline, exact-host, profile, h5py's files, online over NSX) "
        f"-> evaluate, on files the port's HDF5 codec writes, {C} ch, {SR} Hz")
    clis = cli_phase(torch, dev, card, arrs, train_eeg, train_audio,
                     ex["figures"]["proposed_mean_r"], zero_counts, read_counts)

    # ---- exp2-exp4 ------------------------------------------------------------
    say(f"== exp2-exp4 on the card: {EXP2_WORDS} words, {EXP2_C} ch, {SR} Hz, runs "
        f"{' and '.join(EXP2_RUNS_DECODED)}, {EXP2_RUNS} chance segments a run, f32")
    e2 = exp2_phase(torch, dev, card, zero_counts, read_counts)

    # ---- the parallel phase -----------------------------------------------------
    say(f"== parallel: parallel.distributed, {PAR_RANKS} ranks on one card, {C} ch, {SR} Hz, f32")
    par, par_errs = parallel_phase(torch, dev, card, train_eeg, train_audio, arrs, zero_counts,
                                   read_counts)

    def exp2_extra(name):
        # launches as counted: K1 once per chance segment of each run's
        # batched chance level, K2 once per segment of the sequential twin;
        # both once per decoding run; the figures at a segment's shapes
        k = e2["k1" if name == "frontend_decode_mels" else "k2"]
        extra = {"exp2_launches_run_decodes": e2["decode_launches"][name],
                 "exp2_launches_chance": sum(c[name] for c in e2["chance_launches"].values()),
                 "exp2_launches_per_chance_segment":
                     sum(c[name] for c in e2["chance_launches"].values())
                     / (EXP2_RUNS * len(EXP2_RUNS_DECODED)),
                 "exp2_launches_sequential_per_segment": e2["sequential_launches"][name] / EXP2_SEQ,
                 "exp2_max_abs_err": k["max_abs_err"], "exp2_ms": k["ms"],
                 "exp2_plain_ms": k["plain_ms"], "exp2_bound_ms": k["bound"][0],
                 "exp2_bound_by": k["bound"][1]}
        if name == "gl_audio":
            extra["exp2_regime"] = k["regime"]
        return extra

    def exp1_extra(name):
        # launches as counted: in one f32 fold, in the proposed method, and
        # in the chance level over its runs and folds
        ms, plain_ms, bnd = exp1_times[name]
        return {"exp1_launches_per_fold": ex["fold_launches"][name],
                "exp1_launches_proposed": ex["proposed_launches"][name],
                "exp1_launches_per_chance_fold":
                    ex["chance_launches"][name] / (EXP1_RUNS * EXP1_FOLDS),
                "exp1_max_abs_err": exp1_errs[name],
                "exp1_ms": ms, "exp1_plain_ms": plain_ms, "exp1_bound_ms": bnd[0]}

    def row(name, src, replaces, launches, err, ms, plain_ms, bnd, regime, **extra):
        return {"name": name, "route": "cuda",
                "source": f"closed_loop_seeg_speech_synthesis_tpu_torch/csrc/{src}",
                "replaces": f"closed_loop_seeg_speech_synthesis_tpu/ops/{replaces}",
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None, "regime": regime,
                **extra}

    def bf16_row(name, replaces, f, err):
        # launches: the bf16 replay's (fused: K2, split: K4); max_abs_err: one
        # iteration at the replay's blocks (K2 in LSB), the converging estimator
        extra = {k: v for k, v in f.items() if k not in ("launches", "ms", "plain_ms", "bound",
                                                         "regime", "library_ms")}
        return {**row(name, "gl_audio.cu", replaces, f["launches"], err, f["ms"], f["plain_ms"],
                      f["bound"], f["regime"], branch="bf16=True (DecoderConfig.gl_bf16)",
                      library_call="8 x (frames @ [cos | sin], zr @ I_cos[:128]), torch.matmul "
                                   "bf16: the DFT products alone", **extra),
                "library_ms": f["library_ms"]}

    kernels = [
        row("frontend_decode_mels", "frontend_decode.cu", "pallas_frontend.py:195",
            launches["frontend_decode_mels"], k1_err, k1_ms, k1_plain_ms, k1_bound, "3xtf32",
            serial_scan_steps=scan_steps, reference_matmul_ms=k1_mm_ms, float64_p999=k1_f64,
            float64_flips=k1_flips, long_period=long_times["frontend_decode_mels"],
            cli_launches=clis["decode_cli_launches"]["frontend_decode_mels"],
            parallel_launches=par["frontend_decode_mels"], parallel_max_abs_err=par_errs["frontend_decode_mels"],
            **exp1_extra("frontend_decode_mels"), **exp2_extra("frontend_decode_mels")),
        row("gl_audio", "gl_audio.cu", "pallas_gl.py:153", launches["gl_audio"], k2_err, k2_ms,
            k2_plain_ms, k2_bound, cuda_gl.regime(B_gl), reference_matmul_ms=mm_ms,
            cli_launches=clis["decode_cli_launches"]["gl_audio"], parallel_launches=par["gl_audio"], parallel_max_abs_err=par_errs["gl_audio"], **exp1_extra("gl_audio"),
            **exp2_extra("gl_audio")),
        row("frontend_logpower", "frontend_decode.cu", "pallas_frontend.py:94",
            split_launches["frontend_logpower"], k3_err, k3_ms, k3_plain_ms, k3_bound, "3xtf32",
            serial_scan_steps=scan_steps, reference_matmul_ms=k3_mm_ms, float64_p999=k3_f64,
            long_period=long_times["frontend_logpower"],
            parallel_launches=par["frontend_logpower"], parallel_max_abs_err=par_errs["frontend_logpower"]),
        row("gl_blocks", "gl_audio.cu", "pallas_gl.py:141",
            split_launches["gl_blocks"] + on_launches["gl_blocks"] + pers["persistent_launches"],
            k4_err, k4_ms, k4_plain_ms,
            k4_bound, cuda_gl.regime(B_gl), reference_matmul_ms=mm_ms,
            online_launches=on_launches["gl_blocks"], online_graph_replays=dec1.replays[1],
            online_latency_ms=dict(zip(("p50", "p95", "p99", "max"), per_packet)),
            online_eager_latency_ms=dict(zip(("p50", "p95", "p99", "max"), eager_pct)),
            online_ms=k4_b4_ms,
            online_bound_ms=k4_b4_bound[0], online_regime=cuda_gl.regime(4),
            parallel_launches=par["gl_blocks"], **pers),
        bf16_row("gl_audio_bf16", "pallas_gl.py:153", k2_bf16, k2_bf16["max_abs_err"]),
        bf16_row("gl_blocks_bf16", "pallas_gl.py:141", k4_bf16,
                 k4_bf16["one_iteration_converging"]["max_abs_err"]),
        row("block_inits", "prng.cu", "griffinlim.py:158",
            launches["block_inits"] + split_launches["block_inits"]
            + on_launches["block_inits"] + pers_inits,
            inits["max_abs_err"], inits["ms"], inits["plain_ms"], inits["bound"], "threefry",
            replay_launches=launches["block_inits"], split_launches=split_launches["block_inits"],
            online_launches=on_launches["block_inits"], persistent_launches=pers_inits,
            graph_nodes=inits["graph_nodes"], cli_launches=clis["decode_cli_launches"]["block_inits"],
            reference_torch_rand_ms=inits["reference_torch_rand_ms"],
            not_a_tpu_kernel="replaces XLA's jax.random work (fold_in + uniform)"),
    ]
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
