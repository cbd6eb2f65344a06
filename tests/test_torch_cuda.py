"""The CUDA kernels against their plain torch versions, and the training
path against its float64 CPU run, on the card.

Imports no jax, so that it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX).  Each test skips where
``torch.cuda.is_available()`` is false.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import gl_fft_plan as plan

from closed_loop_seeg_speech_synthesis_tpu_torch.models import lda
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import cuda_frontend, cuda_gl
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import filter_design as fd
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import framing
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import griffinlim as gl
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import iir
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import pipeline
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import trainer


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels build with nvcc for sm_90a)")
    return torch.device("cuda")


@pytest.fixture
def rs():
    return np.random.RandomState(1234)


# (channels, seconds): 4 s is one run of 16 periods and a ragged one inside
# one scan chunk; 70 s is 17.6 runs and 4.4 chunks of 64 periods at 1024 Hz;
# the LDA epilogue stages F in slabs of 128 channels: 256 takes two, 400 four
# (the last one ragged)
FRONTEND_SHAPES = [(16, 4), (16, 70), (128, 70), (256, 20), (400, 4)]
# 1152 and 1920 Hz have periods of 288 and 96 samples, not whole 64-row
# slabs of u (launch 1) nor, at 1920 Hz, whole 16-row m-tiles of y (launch 3);
# 4096 and 8192 Hz periods of 1,024 and 2,048 samples, which launch 1 and 3
# stream in slabs (Pmat through L1, y in slabs of 256 rows and a ring)
FRONTEND_RATES = [1024.0, 2048.0, 1152.0, 1920.0, 4096.0, 8192.0]


@pytest.mark.cuda
@pytest.mark.parametrize("C,seconds", FRONTEND_SHAPES)
@pytest.mark.parametrize("sr", FRONTEND_RATES)
def test_frontend_kernel_matches_plain(rs, cuda_device, sr, C, seconds):
    """f32 kernel vs f32 plain version: >= 99.9% of entries within rtol 1e-5 /
    atol 1e-6 (other summation orders flip rare near-tie labels)."""
    valid = np.ones((40, 9), bool)
    valid[3, :5] = False
    loaded = params.from_arrays(rs.randn(40, 9, 20) * 0.3, rs.randn(40, 9),
                                np.tile(np.arange(9, dtype=np.int32), (40, 1)), valid,
                                np.sort(rs.randn(40, 9), axis=1), rs.permutation(5 * C)[:20], [],
                                dtype=torch.float32, device=cuda_device)
    cfg = pipeline.DecoderConfig(sr=sr, n_channels=C, dtype=torch.float32)
    dec = pipeline.build_decoder_params(cfg, loaded["lda"], loaded["medians"], loaded["select"],
                                        device=cuda_device)
    x = torch.as_tensor(rs.randn(int(sr * seconds) + 77, C), dtype=torch.float32,
                        device=cuda_device)
    nf = len(framing.streaming_frame_ends(50, 10, sr, x.shape[0] + cfg.prefill))
    consts = cuda_frontend.epilogue_constants(dec.lda_coef_full, dec.lda.intercept, dec.lda.valid,
                                              dec.lda.classes, dec.medians, dec.gauss_kernel, C)
    s0 = pipeline._initial_state(dec, x).contiguous()
    before = cuda_frontend.frontend_decode_mels.launches
    mel_k = cuda_frontend.frontend_decode_mels(dec.frontend_ops, x, s0, *consts, nf)
    torch.cuda.synchronize()
    assert cuda_frontend.frontend_decode_mels.launches == before + 1
    mel_p = cuda_frontend.frontend_decode_mels_plain(dec.frontend_ops, x, s0, *consts, nf)
    assert mel_k.shape == mel_p.shape == (nf, 40)
    off = int((~torch.isclose(mel_k, mel_p, rtol=1e-5, atol=1e-6)).sum())
    assert off < 0.001 * mel_k.numel(), off


@pytest.mark.cuda
@pytest.mark.parametrize("iterations,phase_bug", [(0, True), (8, False)])
@pytest.mark.parametrize("B,walk", [(203, "centred"), (203, "ar1"), (1001, "ar1")])
def test_gl_audio_kernel_matches_plain(rs, cuda_device, B, walk, iterations, phase_bug):
    """Without iterations every sample within 1 LSB; with the converging
    (phase_bug=False) estimator >= 99.9% of samples within 1 LSB.  B = 203
    and 1001 in the regimes their launches pick (B = 1001 the FFT kernel;
    neither is a multiple of the cluster's 4 blocks or the FFT kernel's 8 a
    CTA).  Frames from either walk of _gl_inputs; the centred one only up to
    203 blocks."""
    lm, rand = _gl_inputs(rs, B, cuda_device, walk)
    rand[0, 0] = 0.0  # see test_torch_kernels.test_gl_audio_plain_matches_pallas_f32_no_iterations
    ops = _gl_ops(cuda_device)
    before = cuda_gl.gl_audio.launches
    a_k = cuda_gl.gl_audio(lm, rand, ops, 10.0, iterations, phase_bug)
    torch.cuda.synchronize()
    assert cuda_gl.gl_audio.launches == before + 1
    a_p = cuda_gl.gl_audio_plain(lm, rand, ops, 10.0, iterations, phase_bug)
    assert a_k.dtype == torch.int16 and a_k.shape == a_p.shape == (B * 160,)
    off = int(((a_k.long() - a_p.long()).abs() > 1).sum())
    assert off <= (0 if iterations == 0 else 0.001 * B * 160), off


def _decoder(rs, device, sr, C, dtype=torch.float32, **options):
    valid = np.ones((40, 9), bool)
    valid[3, :5] = False
    loaded = params.from_arrays(rs.randn(40, 9, 20) * 0.3, rs.randn(40, 9),
                                np.tile(np.arange(9, dtype=np.int32), (40, 1)), valid,
                                np.sort(rs.randn(40, 9), axis=1), rs.permutation(5 * C)[:20], [],
                                dtype=dtype, device=device)
    cfg = pipeline.DecoderConfig(sr=sr, n_channels=C, packet_size=64 if sr == 2048 else 32,
                                 dtype=dtype, **options)
    return cfg, pipeline.build_decoder_params(cfg, loaded["lda"], loaded["medians"],
                                              loaded["select"], device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("C,seconds", FRONTEND_SHAPES)
@pytest.mark.parametrize("sr", FRONTEND_RATES)
def test_logpower_kernel_matches_plain(rs, cuda_device, sr, C, seconds):
    """K3 vs its plain version in f32: features within atol 1e-4 (the JAX
    package's gate for its kernel, tests/test_pallas_kernels.py:76)."""
    cfg, dec = _decoder(rs, cuda_device, sr, C)
    x = torch.as_tensor(rs.randn(int(sr * seconds) + 77, C), dtype=torch.float32,
                        device=cuda_device)
    nf = len(framing.streaming_frame_ends(50, 10, sr, x.shape[0] + cfg.prefill))
    s0 = pipeline._initial_state(dec, x).contiguous()
    before = cuda_frontend.frontend_logpower.launches
    F_k = cuda_frontend.frontend_logpower(dec.frontend_ops, x, s0, nf)
    torch.cuda.synchronize()
    assert cuda_frontend.frontend_logpower.launches == before + 1
    F_p = cuda_frontend.frontend_logpower_plain(dec.frontend_ops, x, s0, nf)
    assert F_k.shape == F_p.shape == (nf, C)
    assert float((F_k - F_p).abs().max()) < 1e-4


def _p999(a, b):
    return float((a.double() - b.double()).abs().flatten().quantile(0.999))


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["frontend_logpower", "frontend_decode_mels"])
@pytest.mark.parametrize("sr", [1024.0, 2048.0])
def test_frontend_kernel_tracks_float64(rs, cuda_device, sr, entry):
    """The error budget of the kernels' 3xTF32 products and two-level scan:
    against the plain version in float64 (the same float32 constants), the
    kernel's p99.9 error is at most twice the plain float32 version's, for
    the features (K3) and the mel frames (K1), at 128 channels over 5
    minutes.  K1's p99.9 is set by the dequantized labels, so its LDA
    products are held by the label flips too (entries outside rtol 1e-4 /
    atol 1e-5): at most twice the plain version's plus 1e-5, chip_smoke.py's
    gate, which a single-pass TF32 epilogue fails (frontend_kernel_probe.py)."""
    C = 128
    cfg, dec = _decoder(rs, cuda_device, sr, C)
    x = torch.as_tensor(rs.randn(int(sr * 300) + 77, C), dtype=torch.float32, device=cuda_device)
    nf = len(framing.streaming_frame_ends(50, 10, sr, x.shape[0] + cfg.prefill))
    s0 = pipeline._initial_state(dec, x).contiguous()
    args = ()
    if entry == "frontend_decode_mels":
        args = cuda_frontend.epilogue_constants(dec.lda_coef_full, dec.lda.intercept, dec.lda.valid,
                                                dec.lda.classes, dec.medians, dec.gauss_kernel, C)
    kernel = getattr(cuda_frontend, entry)
    plain = getattr(cuda_frontend, entry + "_plain")
    out_k = kernel(dec.frontend_ops, x, s0, *args, nf)
    out_32 = plain(dec.frontend_ops, x, s0, *args, nf)
    out_64 = plain(dec.frontend_ops, x.double(), s0.double(), *args, nf)
    assert out_64.dtype == torch.float64
    err_k, err_32 = _p999(out_k, out_64), _p999(out_32, out_64)
    assert err_k <= 2 * err_32, (err_k, err_32)
    if entry == "frontend_decode_mels":
        flips = lambda out: 1.0 - torch.isclose(out.double(), out_64, rtol=1e-4,
                                                atol=1e-5).double().mean().item()
        f_k, f_32 = flips(out_k), flips(out_32)
        assert f_k <= 2 * f_32 + 1e-5, (f_k, f_32)


def _attainment(re, log_mels, ops):
    """||a |STFT(overlap-added blocks)| - target|| / ||target||, a fitted;
    audio frames at hop 160 carry the mel frames in order."""
    x = gl.overlap_add_stream(re.double(), ops)
    frames = x.unfold(0, 256, 160)
    mag = torch.fft.rfft(frames * ops.window.double(), dim=1).abs()
    target = torch.exp(log_mels[: frames.shape[0]].double()) @ ops.Minv.double()
    alpha = (mag * target).sum() / (mag * mag).sum()
    return ((alpha * mag - target).norm() / target.norm()).item()


def _gl_inputs(rs, B, device, walk="ar1"):
    """Log-mel frames and uniform inits, float32.  "centred": a random walk
    with its mean moved to -1; its range grows as sqrt(B) (+-5.3 around -1
    at 203 blocks, +-11 at 1,001, where exp(log-mel) reaches outputs at
    which 1 LSB or 2e-4 is below f32 resolution).  "ar1": a mean-reverting
    walk (coefficient 0.95, standard deviation 0.48) that stays within +-2
    of -1 at any B."""
    if walk == "centred":
        x = np.cumsum(rs.randn(B + 1, 40) * 0.15, axis=0)
        x -= x.mean()
    else:
        x = np.zeros((B + 1, 40))
        e = rs.randn(B + 1, 40) * 0.15
        for i in range(1, B + 1):
            x[i] = 0.95 * x[i - 1] + e[i]
    lm = torch.as_tensor(x - 1.0, dtype=torch.float32, device=device)
    return lm, torch.as_tensor(rs.rand(B, 480), dtype=torch.float32, device=device)


def _gl_ops(device):
    return cuda_gl.make_gl_audio_ops(gl.make_streaming_gl_ops(40, 16000.0, torch.float32, device),
                                     iir.sos_to_statespace(fd.gl_output_lowpass_sos()),
                                     torch.float32, device)


_T = cuda_gl.CLUSTER_MAX_B


@pytest.mark.cuda
@pytest.mark.parametrize("iterations,phase_bug", [(0, True), (8, False), (8, True)])
@pytest.mark.parametrize("B,walk", [(B, w) for B in (1, 2, 3, 4, 8, 203) for w in ("centred", "ar1")]
                         + [(B, "ar1") for B in sorted({_T - 1, _T, _T + 1, 1001}
                                                       - {1, 2, 3, 4, 8, 203})])
def test_gl_blocks_kernel_matches_plain(rs, cuda_device, B, walk, iterations, phase_bug):
    """K4 vs its plain version in f32, in the regime its launch picks: the
    online step's 1-4 blocks, one cluster of 4 blocks and a ragged one, both
    sides of the regime threshold and a ragged 1,001 (the FFT kernel; the
    launch counted in ``launches_fft`` too); frames
    from both walks of _gl_inputs up to 203 blocks, the "ar1" one above.
    Without iterations the inits come back exactly.  The converging
    estimator: within atol 2e-4 (the JAX package's gate,
    tests/test_pallas_kernels.py:24) up to 203 blocks; above, where the f32
    plain version itself leaves it on ~2e-4 of samples, on >= 99.9% of
    samples.  The exp(angle) quirk: within 2e-4 up to 8 blocks; above, the
    iteration is chaotic in f32 and a few blocks drift apart: >= 99% of
    samples within 2e-4, per-block energy r > 0.9, and attainment of the
    target spectrogram within 10% of the plain version's."""
    lm, rand = _gl_inputs(rs, B, cuda_device, walk)
    ops = _gl_ops(cuda_device)
    before = (cuda_gl.gl_blocks.launches, cuda_gl.gl_blocks.launches_fft)
    re_k = cuda_gl.gl_blocks(lm, rand, ops, iterations, phase_bug)
    torch.cuda.synchronize()
    fft = int(cuda_gl.regime(B) == "fft")
    assert (cuda_gl.gl_blocks.launches, cuda_gl.gl_blocks.launches_fft) == (before[0] + 1,
                                                                          before[1] + fft)
    re_p = cuda_gl.gl_blocks_plain(lm, rand, ops, iterations, phase_bug)
    assert re_k.shape == re_p.shape == (B, 480)
    err = (re_k - re_p).abs()
    if iterations == 0:
        assert torch.equal(re_k, rand)
    elif phase_bug and B > 8:
        assert (err < 2e-4).double().mean().item() >= 0.99
        e_k, e_p = (re_k.double() ** 2).sum(1), (re_p.double() ** 2).sum(1)
        assert torch.corrcoef(torch.stack([e_k, e_p]))[0, 1].item() > 0.9
        assert _attainment(re_k, lm, ops.gl) <= 1.1 * _attainment(re_p, lm, ops.gl)
    elif B > 203:
        assert (err <= 2e-4).double().mean().item() >= 0.999
    else:
        assert float(err.max()) < 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4, 1001])
def test_gl_blocks_regimes_agree(rs, cuda_device, monkeypatch, B):
    """The FFT kernel (CLUSTER_MAX_B = 0) and the cluster kernel
    (CLUSTER_MAX_B = B) on the same blocks: identical without iterations;
    the converging estimator within 2e-4 on >= 99.9% of samples."""
    lm, rand = _gl_inputs(rs, B, cuda_device)
    ops = _gl_ops(cuda_device)
    for iterations, phase_bug in ((0, True), (8, False)):
        monkeypatch.setattr(cuda_gl, "CLUSTER_MAX_B", 0)
        fft = cuda_gl.gl_blocks(lm, rand, ops, iterations, phase_bug)
        monkeypatch.setattr(cuda_gl, "CLUSTER_MAX_B", B)
        cluster = cuda_gl.gl_blocks(lm, rand, ops, iterations, phase_bug)
        if iterations == 0:
            assert torch.equal(fft, cluster)
        else:
            assert ((fft - cluster).abs() <= 2e-4).double().mean().item() >= 0.999


# The bf16 variants (DecoderConfig.gl_bf16): the online step's 1-4 blocks,
# both sides of the bf16 threshold, exp2's sequential twin's 199 and the
# float32 threshold, a ragged 1,001 on the wgmma kernel
_T16 = cuda_gl.CLUSTER_MAX_B_BF16
BF16_BLOCKS = [1, 2, 4, _T16 - 1, _T16, _T16 + 1, 199, _T - 1, _T, _T + 1, 1001]
BF16_RUNS = [(0, True), (1, False), (1, True), (8, False), (8, True)]


def _first_frame_attainment(re, log_mels, ops):
    """tests/test_pallas_kernels.py::test_gl_bf16_quality's attainment:
    ||(|rfft(first frame of each block)| - target)|| / ||target||."""
    target = torch.exp(log_mels[: re.shape[0]].double()) @ ops.Minv.double()
    mag = torch.fft.rfft(re[:, :256].double() * ops.window.double(), dim=1).abs()
    return ((mag - target).norm() / target.norm()).item()


def _hop_envelope_r(a, b):
    """Pearson r of the two runs' RMS per 160-sample hop."""
    e = lambda x: torch.sqrt((x.double().reshape(-1, 160) ** 2).mean(1) + 1e-6)
    return torch.corrcoef(torch.stack([e(a), e(b)]))[0, 1].item()


def _bf16_blocks_ok(re_k, re_p, re_32, lm, rand, ops, iterations, phase_bug):
    """The bf16 kernel's blocks ``re_k`` against the plain bf16 version's
    ``re_p`` (and, under the quirk, the f32 kernel's ``re_32``).  Without
    iterations the inits come back.  One iteration: the two differ only
    where another summation order moves a frame or Z value across a bf16
    rounding boundary, by one bf16 step of it times an inverse-DFT entry:
    max |diff| <= 1e-3 of the blocks' max |value| (the f32 kernel is 0.4-34%
    off), and from 199 blocks on >= 99% of samples within 2e-5 of it.
    8 iterations, converging: >= 99.5% of samples within 1e-3.  8 iterations,
    quirk (chaotic): attainment <= 1.1x the f32 kernel's and per-hop
    envelope r > 0.9 against it (test_gl_bf16_quality's gate)."""
    B = re_k.shape[0]
    assert re_k.shape == re_p.shape == (B, 480) and bool(torch.isfinite(re_k).all())
    err = (re_k - re_p).abs()
    if iterations == 0:
        assert torch.equal(re_k, rand)
    elif iterations == 1:
        scale = re_p.abs().max().item()
        assert err.max().item() <= 1e-3 * scale, (err.max().item(), scale)
        if B >= 199:
            assert (err <= 2e-5 * scale).double().mean().item() >= 0.99
    elif not phase_bug:
        assert (err <= 1e-3).double().mean().item() >= 0.995
    else:
        assert _first_frame_attainment(re_k, lm, ops.gl) <= 1.1 * _first_frame_attainment(
            re_32, lm, ops.gl)
        assert _hop_envelope_r(re_k, re_32) > 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("iterations,phase_bug", BF16_RUNS)
@pytest.mark.parametrize("B", BF16_BLOCKS)
def test_gl_blocks_bf16_kernel_matches_plain(rs, cuda_device, B, iterations, phase_bug):
    """K4's bf16 variant against the plain bf16 version (``_bf16_blocks_ok``),
    in the regime its launch picks; counted in ``launches_bf16`` only."""
    lm, rand = _gl_inputs(rs, B, cuda_device)
    ops = _gl_ops(cuda_device)
    before = (cuda_gl.gl_blocks.launches, cuda_gl.gl_blocks.launches_bf16)
    re_k = cuda_gl.gl_blocks(lm, rand, ops, iterations, phase_bug, bf16=True)
    torch.cuda.synchronize()
    assert (cuda_gl.gl_blocks.launches, cuda_gl.gl_blocks.launches_bf16) == (before[0],
                                                                           before[1] + 1)
    re_p = cuda_gl.gl_blocks_plain(lm, rand, ops, iterations, phase_bug, bf16=True)
    re_32 = cuda_gl.gl_blocks(lm, rand, ops, iterations, phase_bug)
    _bf16_blocks_ok(re_k, re_p, re_32, lm, rand, ops, iterations, phase_bug)


@pytest.mark.cuda
@pytest.mark.parametrize("iterations,phase_bug", BF16_RUNS)
@pytest.mark.parametrize("B", BF16_BLOCKS)
def test_gl_audio_bf16_kernel_matches_plain(rs, cuda_device, B, iterations, phase_bug):
    """K2's bf16 variant.  0 and 1 iterations against the plain bf16 version:
    within 1 LSB everywhere without iterations (init sample 0 zeroed, see
    test_gl_audio_kernel_matches_plain), on >= 99.9% of samples after one.
    Any iterations: within 1 LSB everywhere of the plain tail applied to K4's
    bf16 blocks (the same Griffin-Lim launch), which
    test_gl_blocks_bf16_kernel_matches_plain holds to the plain version."""
    lm, rand = _gl_inputs(rs, B, cuda_device)
    rand[0, 0] = 0.0
    ops = _gl_ops(cuda_device)
    before = (cuda_gl.gl_audio.launches, cuda_gl.gl_audio.launches_bf16)
    a_k = cuda_gl.gl_audio(lm, rand, ops, 10.0, iterations, phase_bug, bf16=True)
    torch.cuda.synchronize()
    assert (cuda_gl.gl_audio.launches, cuda_gl.gl_audio.launches_bf16) == (before[0],
                                                                         before[1] + 1)
    assert a_k.dtype == torch.int16 and a_k.shape == (B * 160,)
    lsb = lambda a: (a_k.long() - a.long()).abs()
    if iterations <= 1:
        d = lsb(cuda_gl.gl_audio_plain(lm, rand, ops, 10.0, iterations, phase_bug, bf16=True))
        assert (d <= 1).double().mean().item() >= (1.0 if iterations == 0 else 0.999)
    re_k = cuda_gl.gl_blocks(lm, rand, ops, iterations, phase_bug, bf16=True)
    assert int(lsb(cuda_gl.audio_tail_plain(re_k, ops, 10.0)).max()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4, 1001])
def test_gl_blocks_bf16_regimes_agree(rs, cuda_device, monkeypatch, B):
    """The bf16 variants of the wgmma kernel (CLUSTER_MAX_B_BF16 = 0)
    and the cluster kernel (CLUSTER_MAX_B_BF16 = B) on the same blocks:
    identical without iterations, within ``_bf16_blocks_ok``'s one-iteration
    gate of each other after one."""
    lm, rand = _gl_inputs(rs, B, cuda_device)
    ops = _gl_ops(cuda_device)
    for iterations in (0, 1):
        monkeypatch.setattr(cuda_gl, "CLUSTER_MAX_B_BF16", 0)
        mma = cuda_gl.gl_blocks(lm, rand, ops, iterations, False, bf16=True)
        monkeypatch.setattr(cuda_gl, "CLUSTER_MAX_B_BF16", B)
        cluster = cuda_gl.gl_blocks(lm, rand, ops, iterations, False, bf16=True)
        _bf16_blocks_ok(mma, cluster, None, lm, rand, ops, iterations, False)


@pytest.mark.cuda
@pytest.mark.parametrize("phase_bug", [False, True])
@pytest.mark.parametrize("B", [4224, 179_999])
def test_gl_bf16_kernel_tracks_float64(rs, cuda_device, B, phase_bug):
    """The error budget of the wgmma kernel's bf16 products (one fp32
    accumulator over each product's 16 k-steps, the inverse read from the
    forward operand's image transposed): one iteration against the bf16
    branch evaluated in float64 on the same bf16-rounded operands
    (``_gl_loop_plain(..., torch.float64)``); the kernel's max and p99.9
    |error| at most twice the plain bf16 version's (float32)."""
    lm, rand = _gl_inputs(rs, B, cuda_device)
    ops = _gl_ops(cuda_device)
    assert cuda_gl.regime(B, bf16=True) == "wgmma"
    ref = cuda_gl._gl_loop_plain(lm, rand, ops, 1, phase_bug, torch.float64)

    def errors(out):
        e = (out.double() - ref).abs().flatten().sort().values
        return e[-1].item(), e[int(0.999 * (e.numel() - 1))].item()

    (max_k, p999_k), (max_p, p999_p) = (
        errors(cuda_gl.gl_blocks(lm, rand, ops, 1, phase_bug, bf16=True)),
        errors(cuda_gl.gl_blocks_plain(lm, rand, ops, 1, phase_bug, bf16=True)))
    print(f"B = {B}, phase_bug={phase_bug}: |error| against float64, kernel max {max_k:.3e} "
          f"p99.9 {p999_k:.3e}; plain bf16 max {max_p:.3e} p99.9 {p999_p:.3e}")
    assert max_k <= 2 * max_p and p999_k <= 2 * p999_p, (max_k, p999_k, max_p, p999_p)


@pytest.mark.cuda
@pytest.mark.parametrize("iterations,phase_bug", [(1, True), (1, False), (8, False)])
@pytest.mark.parametrize("B", [4224, 179_999])
@pytest.mark.parametrize("seed", [1234, 1, plan.CUT_SEED])
def test_gl_kernel_tracks_float64(cuda_device, seed, B, iterations, phase_bug):
    """The error budget of the FFT kernel (float32 FMA, its twiddles the
    exact angles rounded once): against Griffin-Lim in float64 on the same
    float32 inputs, Minv and window (``_gl_loop_plain(..., torch.float64,
    bf16=False)``: the exact DFT), the kernel's max and p99.9 |error| at most
    1.5x the plain float32 version's (the dense products with make_rdft's
    float32 matrices); one iteration under both estimators, and 8 of the
    converging one (exp(angle) is chaotic beyond the first).  Three seeds:
    under exp(angle) the max is set by bins at the branch cut, which the
    kernel sums again (seed 2 holds one that its FFT alone gets wrong:
    test_gl_fft_kernel_matches_its_plan)."""
    lm, rand = _gl_inputs(np.random.RandomState(seed), B, cuda_device)
    ops = _gl_ops(cuda_device)
    assert cuda_gl.regime(B) == "fft"
    ref = cuda_gl._gl_loop_plain(lm, rand, ops, iterations, phase_bug, torch.float64, bf16=False)

    def errors(out):
        e = (out.double() - ref).abs().flatten().sort().values
        return e[-1].item(), e[int(0.999 * (e.numel() - 1))].item()

    before = cuda_gl.gl_blocks.launches_fft
    out_k = cuda_gl.gl_blocks(lm, rand, ops, iterations, phase_bug)
    assert cuda_gl.gl_blocks.launches_fft == before + 1
    (max_k, p999_k), (max_p, p999_p) = (
        errors(out_k), errors(cuda_gl.gl_blocks_plain(lm, rand, ops, iterations, phase_bug)))
    print(f"B = {B}, {iterations} iteration(s), phase_bug={phase_bug}: |error| against float64, "
          f"kernel max {max_k:.3e} p99.9 {p999_k:.3e}; plain f32 max {max_p:.3e} "
          f"p99.9 {p999_p:.3e}")
    assert max_k <= 1.5 * max_p and p999_k <= 1.5 * p999_p, (max_k, p999_k, max_p, p999_p)


@pytest.mark.cuda
@pytest.mark.parametrize("phase_bug", [True, False])
def test_gl_fft_kernel_matches_its_plan(cuda_device, phase_bug):
    """The FFT kernel's own blocks against its plan emulated step for step
    (tests/gl_fft_plan.py) and against Griffin-Lim in float64, one
    iteration, on the 32 blocks around a bin of the error-budget inputs that
    lies at the branch cut (seed 2, block 61,350, where the FFT alone puts it
    on the wrong side and is 2.3e-2 off): both within 2e-6 of the largest
    |sample|, so the kernel sums that bin again as the plan does."""
    lo = plan.CUT_BLOCK - 16
    lm, rand = plan.walk_inputs(plan.CUT_SEED, plan.CUT_B, lo, 32)
    ops = _gl_ops(cuda_device)
    assert cuda_gl.regime(32) == "fft"
    out = cuda_gl.gl_blocks(lm.to(cuda_device), rand.to(cuda_device), ops, 1, phase_bug).cpu()
    cpu_ops = _gl_ops(torch.device("cpu"))
    minv, win = cpu_ops.gl_f32[0], cpu_ops.gl_f32[5]
    emu = plan.gl_blocks(lm, rand, minv, win, cuda_gl.twiddle_table(), 1, phase_bug)
    ref = cuda_gl._gl_loop_plain(lm, rand, cpu_ops, 1, phase_bug, torch.float64, bf16=False)
    top = ref.abs().max().item()
    rel = lambda a, b: ((a.double() - b.double()).abs().max() / top).item()
    print(f"phase_bug={phase_bug}: kernel against float64 {rel(out, ref):.3e}, against the "
          f"plan {rel(out, emu):.3e}; the plan against float64 {rel(emu, ref):.3e} "
          f"(relative to max |sample| {top:.3f})")
    assert rel(out, ref) < 2e-6 and rel(out, emu) < 2e-6


@pytest.mark.cuda
def test_gl_bf16_launch_error_raises(rs, cuda_device, monkeypatch):
    """A bf16 launch whose C entry reports an error raises, and is not
    counted; nothing falls back to the plain version or to float32."""
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import _build

    lm, rand = _gl_inputs(rs, 4, cuda_device)
    ops = _gl_ops(cuda_device)
    flags = []

    def failing_bind(lib, name, *sig):
        def fn(*args):
            flags.append(args[-2] if name == "gl_blocks" else args[-3])  # the bf16 flag
            return 1  # cudaErrorInvalidValue
        return fn

    monkeypatch.setattr(_build, "bind", failing_bind)
    counts = lambda: (cuda_gl.gl_blocks.launches_bf16, cuda_gl.gl_audio.launches_bf16,
                      cuda_gl.gl_blocks.launches, cuda_gl.gl_audio.launches)
    before = counts()
    with pytest.raises(RuntimeError, match="gl_blocks failed"):
        cuda_gl.gl_blocks(lm, rand, ops, 8, True, bf16=True)
    with pytest.raises(RuntimeError, match="gl_audio failed"):
        cuda_gl.gl_audio(lm, rand, ops, 10.0, 8, True, bf16=True)
    assert counts() == before and flags == [1, 1]


def _audio_attainment(audio, log_mels, ops):
    """||a |STFT(audio)| - target|| / ||target||, a fitted: audio samples
    [160 j, 160 j + 256) carry block j's first frame, whose target is mel j."""
    frames = (audio.double() / 32767.0).unfold(0, 256, 160)
    mag = torch.fft.rfft(frames * ops.window.double(), dim=1).abs()
    target = torch.exp(log_mels[: frames.shape[0]].double()) @ ops.Minv.double()
    alpha = (mag * target).sum() / (mag * mag).sum()
    return ((alpha * mag - target).norm() / target.norm()).item()


@pytest.mark.cuda
def test_offline_decode_gl_bf16_launches_the_bf16_variants(rs, cuda_device):
    """``DecoderConfig(gl_bf16=True)``: the fused offline decode launches K2's
    bf16 variant, the split one K4's, and neither a float32 K2/K4; the
    spectrogram is bit-identical to the float32 decode's.  The audio (the
    exp(angle) quirk, 8 iterations) attains the target within 1.1x of the
    float32 decode's, and against the plain bf16 vocoder on the same frames
    and inits its per-hop envelope r > 0.9.  (Against the float32 decode
    the envelope r of these rough decoded frames is 0.68-0.81 on the plain
    versions alone: bf16 picks another waveform.)"""
    import dataclasses

    C = 16
    cfg, dec = _decoder(rs, cuda_device, 1024.0, C)
    eeg = torch.as_tensor(rs.randn(20 * 1024, C), dtype=torch.float32, device=cuda_device)
    counts = lambda: {w: (fn.launches, fn.launches_bf16)
                      for w, fn in (("k2", cuda_gl.gl_audio), ("k4", cuda_gl.gl_blocks))}
    for split in ({}, dict(use_cuda_epilogue=False, use_cuda_gl_tail=False)):
        c = dataclasses.replace(cfg, **split)
        spec_32, audio_32 = pipeline.offline_decode(dec, c, eeg)
        before = counts()
        spec_16, audio_16 = pipeline.offline_decode(dec, dataclasses.replace(c, gl_bf16=True), eeg)
        torch.cuda.synchronize()
        after = counts()
        which, other = ("k4", "k2") if split else ("k2", "k4")
        assert after[which] == (before[which][0], before[which][1] + 1), (before, after)
        assert after[other] == before[other]
        assert torch.equal(spec_16, spec_32) and audio_16.shape == audio_32.shape
        rand = gl.default_rand_init(spec_16.shape[0] - 1, 0, 0, torch.float32, cuda_device)
        audio_p = cuda_gl.gl_audio_plain(spec_16, rand, dec.gl_audio_ops, c.gl_norm, 8, True,
                                         bf16=True)
        assert _audio_attainment(audio_16, spec_16, dec.gl_ops) <= 1.1 * _audio_attainment(
            audio_32, spec_32, dec.gl_ops)
        assert _hop_envelope_r(audio_16, audio_p) > 0.9


@pytest.mark.cuda
def test_online_step_ignores_gl_bf16(rs, cuda_device):
    """The online step stays float32 (the JAX online step runs plain
    Griffin-Lim without bf16): with ``gl_bf16=True`` OnlineDecoder's recorded
    step holds one float32 K4 node and no bf16 launch, and decodes
    bit-identically to the ``gl_bf16=False`` decoder."""
    import dataclasses

    from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import online

    C = 16
    cfg, dec = _decoder(rs, cuda_device, 1024.0, C)
    packets = [rs.randn(32, C).astype(np.float32) * 10 for _ in range(60)]
    outs = []
    for bf16 in (False, True):
        before = (cuda_gl.gl_blocks.launches, cuda_gl.gl_blocks.launches_bf16)
        d = online.OnlineDecoder(dataclasses.replace(cfg, gl_bf16=bf16), dec)
        d.warmup()
        assert d.programs[1].k4_nodes == 1
        assert cuda_gl.gl_blocks.launches_bf16 == before[1]
        assert cuda_gl.gl_blocks.launches > before[0]
        for p in packets:
            d.process_packet(p)
        outs.append(d.results())
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_gl_wrappers_reject_misaligned_inits(rs, cuda_device):
    """The kernels copy the inits in 16-byte pieces: a view that starts off a
    16-byte boundary is refused, not read wrong."""
    lm, rand = _gl_inputs(rs, 4, cuda_device)
    off = torch.empty(4 * 480 + 1, device=cuda_device)[1:].view(4, 480)
    off.copy_(rand)
    ops = _gl_ops(cuda_device)
    for launch in (lambda: cuda_gl.gl_blocks(lm, off, ops), lambda: cuda_gl.gl_audio(lm, off, ops, 10.0)):
        with pytest.raises(ValueError, match="16-byte"):
            launch()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_wgmma_helpers_match_matmul(cuda_device, mode):
    """csrc/wgmma.cuh through tests/wgmma_check.cu: one warpgroup's bf16
    product of A (64 x 256) and M (256 x 256) from M's shared-memory image
    (ops/wgmma_layout), loaded by bulk copies: mode 0 A M with A from
    registers; 1 A M^T, the image read MN-major; 2 A M with A from its own
    image; 3 bf16(A M) M^T, the accumulators as the next register A operand.
    Against float64 products of the bf16 values: within 1e-5 of the largest
    |entry| (an fp32 accumulation over 256), mode 3 within 2e-3 (its
    intermediate rounded to bf16 where float64 rounds it, a flip moving an
    entry by one bf16 step)."""
    import ctypes
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import _build, wgmma_layout

    root = Path(__file__).resolve().parents[1]
    probe_tools = _load_script(root / "probe_tools.py")
    lib = probe_tools.build("wgmma_check", {
        "wgmma_check.cu": (root / "tests" / "wgmma_check.cu").read_text(),
        "wgmma.cuh": (_build.CSRC / "wgmma.cuh").read_text()})
    fn = lib.wgmma_check
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    g = torch.Generator().manual_seed(mode)
    a = torch.randn((64, 256), generator=g).to(torch.bfloat16).float().to(cuda_device)
    m = torch.randn((256, 256), generator=g).to(torch.bfloat16).float().to(cuda_device)
    img_m, img_a = wgmma_layout.sw128_image(m), wgmma_layout.sw128_image(a.T.contiguous())
    out = torch.empty((64, 256), dtype=torch.float32, device=cuda_device)
    err = fn(a.data_ptr(), img_m.data_ptr(), img_a.data_ptr(), out.data_ptr(), mode,
             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    a64, m64 = a.double(), m.double()
    ref = {0: a64 @ m64, 1: a64 @ m64.T, 2: a64 @ m64,
           3: (a64 @ m64).float().to(torch.bfloat16).double() @ m64.T}[mode]
    rel = ((out.double() - ref).abs().max() / ref.abs().max()).item()
    assert rel <= (2e-3 if mode == 3 else 1e-5), rel


@pytest.mark.cuda
def test_gl_kernel_probe_variants_build(cuda_device):
    """gl_kernel_probe.py's edited copies of csrc/gl_audio.cu compile with the
    package's nvcc flags (tests/test_torch_gl_split.py holds their anchors)."""
    root = Path(__file__).resolve().parents[1]
    probe = _load_script(root / "gl_kernel_probe.py")
    libs = probe.build_variants((root / probe.SRC).read_text())
    assert all(hasattr(libs[v], "gl_blocks") for v in ("grouped", "atan2f"))
    assert hasattr(libs["stamps"], "probe_stamps_read")


def _load_script(path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
def test_frontend_kernel_probe_variants_build(cuda_device):
    """frontend_kernel_probe.py's edited copies of csrc/frontend_decode.cu and
    tf32_mma.cuh compile with the package's nvcc flags
    (tests/test_torch_frontend_scan.py holds their anchors)."""
    root = Path(__file__).resolve().parents[1]
    probe = _load_script(root / "frontend_kernel_probe.py")
    libs = probe.build_variants((root / probe.SRC).read_text(), (root / probe.HEADER).read_text())
    assert all(hasattr(lib, "frontend_decode_mels") for lib in libs.values())
    assert hasattr(libs["stamped"], "probe_read")


@pytest.mark.cuda
def test_block_inits_bit_equal_on_cpu_and_cuda(cuda_device):
    """The block inits (threefry, counter-based) are integer arithmetic:
    ``default_rand_init`` on the card (the kernel) gives the CPU's bits, in
    float32 and float64."""
    for dt in (torch.float32, torch.float64):
        a = gl.default_rand_init(300, 12345, 7, dt, cuda_device).cpu()
        assert torch.equal(a, gl.default_rand_init(300, 12345, 7, dt))


# the replay's table (30 min at 100 frames a second), and ids over the whole
# range the online step and exp1's keys reach, negatives clamped to block 0
INIT_IDS = {"table": lambda dev: torch.arange(180_000, device=dev),
            "wide": lambda dev: torch.tensor([-2**40, -7, -1, 0, 1, 479, 181_000, 2**31 - 2,
                                              2**31 - 1, 2**32 + 5], device=dev)}


@pytest.mark.cuda
@pytest.mark.parametrize("ids", sorted(INIT_IDS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_block_inits_kernel_matches_plain(cuda_device, ids, dtype):
    """csrc/prng.cu against its plain version (drawn on the CPU), bit for
    bit: one launch for the whole table, keys from an int seed and from a
    key pair."""
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import cuda_prng, prng

    x = INIT_IDS[ids](cuda_device)
    for key in (0, 7, prng.fold_in(prng.PRNGKey(0), 3)):
        before = cuda_prng.block_inits.launches
        k = cuda_prng.block_inits(x, key, gl.BLOCK_SAMPLES, dtype)
        torch.cuda.synchronize()
        assert cuda_prng.block_inits.launches == before + 1
        p = cuda_prng.block_inits_plain(x, key, gl.BLOCK_SAMPLES, dtype)
        assert k.shape == (x.shape[0], gl.BLOCK_SAMPLES) and k.dtype == dtype
        assert torch.equal(k, p)


@pytest.mark.cuda
def test_block_inits_kernel_in_a_captured_graph(cuda_device):
    """The kernel recorded in a CUDA graph (as the online step records it):
    one node, which draws the rows of the ids the static tensor holds at
    each replay."""
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import cuda_prng

    ids = torch.arange(4, device=cuda_device)
    gl.block_rand(ids, 0, torch.float32)  # built and loaded before the recording
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = cuda_prng.block_inits.launches
    with torch.cuda.graph(graph):
        out = gl.block_rand(ids, 0, torch.float32)
    assert cuda_prng.block_inits.launches == before + 1
    for first in (0, 5, 179_996, -3):
        ids.copy_(torch.arange(first, first + 4, device=cuda_device))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, cuda_prng.block_inits_plain(ids, 0, gl.BLOCK_SAMPLES,
                                                            torch.float32))


@pytest.mark.cuda
def test_block_inits_wrapper_checks_its_inputs(cuda_device):
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import cuda_prng

    ids = torch.arange(8, device=cuda_device)
    for bad in (ids.int(), ids[::2], ids.reshape(2, 4)):
        with pytest.raises(ValueError, match="1-D int64"):
            cuda_prng.block_inits(bad, 0, 480, torch.float32)
    with pytest.raises(ValueError, match="float32 or float64"):
        cuda_prng.block_inits(ids, 0, 480, torch.float16)
    with pytest.raises(ValueError, match="multiple of 8"):
        cuda_prng.block_inits(ids, 0, 476, torch.float32)
    assert cuda_prng.block_inits(ids[:0], 0, 480, torch.float32).shape == (0, 480)


@pytest.mark.cuda
def test_online_step_launches_k4_and_tracks_offline(rs, cuda_device):
    """The online step on the card goes through K4 and the block inits'
    kernel once a packet (the offline decode draws its table with one
    launch) and stays inside the f32 label-flip budget of the split offline
    decode."""
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import cuda_prng

    C, sr = 8, 1024.0
    cfg, dec = _decoder(rs, cuda_device, sr, C, use_cuda_epilogue=False, use_cuda_gl_tail=False)
    n_pkts = 160
    eeg = torch.as_tensor(rs.randn(n_pkts * 32, C), dtype=torch.float32, device=cuda_device)
    inits = cuda_prng.block_inits.launches
    spec_off, audio_off = pipeline.offline_decode(dec, cfg, eeg)
    assert cuda_prng.block_inits.launches == inits + 1
    step = pipeline.make_online_step(dec, cfg)
    carry = pipeline.init_online_carry(dec, cfg)
    before, inits = cuda_gl.gl_blocks.launches, cuda_prng.block_inits.launches
    specs, audio = [], []
    for i in range(n_pkts):
        carry, out = step(carry, eeg[i * 32 : (i + 1) * 32])
        specs.append(out["spec"][out["spec_valid"]])
        audio.append(out["audio"][out["audio_valid"]])
    assert cuda_gl.gl_blocks.launches == before + n_pkts
    assert cuda_prng.block_inits.launches == inits + n_pkts
    spec_on, audio_on = torch.cat(specs), torch.cat(audio).reshape(-1)
    assert spec_on.shape == spec_off.shape and audio_on.shape == audio_off.shape
    flips = 1.0 - torch.isclose(spec_on, spec_off, rtol=1e-4, atol=1e-5).double().mean().item()
    assert flips < 0.02, flips


def _session(rs, seconds, C, sr=1024, audio_sr=48000):
    """Word-locked synthetic recording (examples/demo.py): each 3 s trial has
    2 s of a 120 Hz burst on half the channels and a voiced harmonic stack
    in the audio, then 1 s of rest."""
    eeg = rs.randn(seconds * sr, C)
    audio = 1e-4 * rs.randn(seconds * audio_sr)
    t_a = np.arange(2 * audio_sr) / audio_sr
    burst = np.sin(2 * np.pi * 120 * np.arange(2 * sr) / sr)
    for i in range(seconds // 3):
        wid = i % 5
        eeg[i * 3 * sr : i * 3 * sr + 2 * sr, : C // 2] += (1.0 + 0.4 * wid) * burst[:, None]
        voiced = sum((0.4 / h) * np.sin(2 * np.pi * h * (150 + 30 * wid) * t_a) for h in range(1, 26))
        audio[i * 3 * audio_sr : i * 3 * audio_sr + 2 * audio_sr] += 0.3 * voiced / np.abs(voiced).max()
    return eeg, audio


@pytest.mark.cuda
def test_training_on_the_card_tracks_the_cpu_path(rs, cuda_device):
    """trainer.train at 60 s x 32 ch on the card against the float64 CPU path
    (the one tests/test_torch_train.py holds to the JAX package): in float64
    the same features and coefficients within rtol 1e-6; in float32 (the
    card's default) >= 95% of the same features, >= 98% of the training-set
    labels predicted alike, the same missing intervals, the quantizer's
    medians and borders within 5e-3 log-mel (chip_smoke.py's limit)."""
    eeg, audio = _session(rs, 60, 32)
    host = trainer.train(eeg, audio, 1024, 48000, [2], device="cpu")
    f64 = trainer.train(eeg, audio, 1024, 48000, [2], dtype=torch.float64, device=cuda_device)
    assert f64.lda.coef.device.type == "cuda"
    np.testing.assert_array_equal(f64.select, host.select)
    c_host = host.lda.coef.numpy()
    np.testing.assert_allclose(f64.lda.coef.cpu().numpy(), c_host, rtol=1e-6,
                               atol=1e-6 * np.abs(c_host).max())
    f32 = trainer.train(eeg, audio, 1024, 48000, [2], device=cuda_device)
    assert f32.lda.coef.dtype == torch.float32
    assert len(set(f32.select.tolist()) & set(host.select.tolist())) >= 0.95 * len(host.select)
    p32 = lda.predict(f32.lda, torch.as_tensor(f32.x_train, device=cuda_device)).cpu()
    p64 = lda.predict(host.lda, torch.as_tensor(host.x_train))
    assert (p32 == p64).double().mean().item() >= 0.98
    assert f32.missing == host.missing
    for name in ("medians", "borders"):
        err = np.abs(getattr(f32, name) - getattr(host, name)).max()
        assert err < 5e-3, (name, err)


@pytest.mark.cuda
def test_exp1_fold_through_the_kernels_tracks_the_plain_path(cuda_device):
    """One exp1 fold (a 10-word word-locked session at 32 ch, fold 1 held out)
    retrained and decoded by eval.exp1_batched.FoldRunner in float32 on the
    card: K1 and K2 launch once each, and the spectrogram stays within the
    f32 label-flip budget (< 2%) of the same fold through the plain float32
    path (use_cuda_frontend=False, use_cuda_gl=False: the same LDA, no
    kernel launched), the audio's per-hop energy correlated > 0.9."""
    import configparser
    import dataclasses

    from closed_loop_seeg_speech_synthesis_tpu_torch.eval import exp1, exp1_batched
    from closed_loop_seeg_speech_synthesis_tpu_torch.io import session

    eeg, audio, words, _ = session.make_synthetic_session(10, 1024, 48000, 32, seed=1)
    rng = np.random.RandomState(0)
    sess = session.Session.from_arrays(eeg, 1024, audio, 48000, words, downsample_audio=False,
                                       rng=rng)
    config = configparser.ConfigParser()
    config["Experiment1"] = {"griffin_lim_norm": "10"}
    e = exp1.Experiment1(config, None, None, rng=rng, device=cuda_device, session=sess,
                         bad_channels=[])
    k, x_train, y_train, x_test, *_ = e._construct_datasets_for_run(10)[0]
    fr = exp1_batched.FoldRunner(len(x_train), len(x_test), 32, 1024, 10.0, device=cuda_device)
    q, medians, y_mean = exp1_batched.fold_targets(y_train)
    fold = (fr.put(x_train), fr.put(x_test), fr.put(q, torch.int64), fr.put(y_mean),
            fr.put(medians))
    params = fr.fit(fold[0], *fold[2:])
    before = (cuda_frontend.frontend_decode_mels.launches, cuda_gl.gl_audio.launches)
    spec_k, audio_k = pipeline.offline_decode(params, fr.cfg, fold[1], seed=k)
    torch.cuda.synchronize()
    assert (cuda_frontend.frontend_decode_mels.launches, cuda_gl.gl_audio.launches) == \
        (before[0] + 1, before[1] + 1)
    plain = dataclasses.replace(fr.cfg, use_cuda_frontend=False, use_cuda_gl=False)
    spec_p, audio_p = pipeline.offline_decode(params, plain, fold[1], seed=k)
    assert (cuda_frontend.frontend_decode_mels.launches, cuda_gl.gl_audio.launches) == \
        (before[0] + 1, before[1] + 1)
    assert spec_k.shape == spec_p.shape == (fr.n_frames, 40) and audio_k.shape == audio_p.shape
    flips = 1.0 - torch.isclose(spec_k, spec_p, rtol=1e-4, atol=1e-5).double().mean().item()
    assert flips < 0.02, flips
    hop = lambda a: a.double().reshape(-1, 160).pow(2).mean(1).sqrt()
    assert torch.corrcoef(torch.stack([hop(audio_k), hop(audio_p)]))[0, 1].item() > 0.9


@pytest.mark.cuda
def test_exp1_fold_runner_honours_gl_bf16(cuda_device):
    """exp1's proposed fold (``FoldRunner.run``, its vocoder through
    ``pipeline._vocode``) with ``gl_bf16=True`` in its config launches K2's
    bf16 variant once and no float32 K2; its audio attains the target
    within 1.1x of the float32 fold's."""
    import dataclasses

    import configparser

    from closed_loop_seeg_speech_synthesis_tpu_torch.eval import exp1, exp1_batched
    from closed_loop_seeg_speech_synthesis_tpu_torch.io import session

    eeg, audio, words, _ = session.make_synthetic_session(10, 1024, 48000, 32, seed=1)
    rng = np.random.RandomState(0)
    sess = session.Session.from_arrays(eeg, 1024, audio, 48000, words, downsample_audio=False,
                                       rng=rng)
    config = configparser.ConfigParser()
    config["Experiment1"] = {"griffin_lim_norm": "10"}
    e = exp1.Experiment1(config, None, None, rng=rng, device=cuda_device, session=sess,
                         bad_channels=[])
    _, x_train, y_train, x_test, *_ = e._construct_datasets_for_run(10)[0]
    fr = exp1_batched.FoldRunner(len(x_train), len(x_test), 32, 1024, 10.0, device=cuda_device)
    q, medians, y_mean = exp1_batched.fold_targets(y_train)
    fold = (fr.put(x_train), fr.put(x_test), fr.put(q, torch.int64), fr.put(y_mean),
            fr.put(medians))
    spec_32, audio_32 = fr.run(*fold)
    fr.cfg = dataclasses.replace(fr.cfg, gl_bf16=True)
    before = (cuda_gl.gl_audio.launches, cuda_gl.gl_audio.launches_bf16)
    spec_16, audio_16 = fr.run(*fold)
    torch.cuda.synchronize()
    assert (cuda_gl.gl_audio.launches, cuda_gl.gl_audio.launches_bf16) == (before[0],
                                                                         before[1] + 1)
    assert audio_16.shape == audio_32.shape and bool(torch.isfinite(spec_16).all())
    assert _audio_attainment(audio_16, spec_16, fr.template.gl_ops) <= 1.1 * _audio_attainment(
        audio_32, spec_32, fr.template.gl_ops)


@pytest.mark.cuda
@pytest.mark.parametrize("iterations,phase_bug", [(0, True), (8, False)])
def test_exp2_chance_segment_kernels_match_plain(rs, cuda_device, iterations, phase_bug):
    """One exp2 chance segment (2 s of 64-channel sEEG at 1024 Hz, 200
    frames): K1 with the plan built once (``pipeline.mel_plan``, the
    batched chance level's path) gives K1 without it bit for bit and the
    plain f32 version on >= 99.9% of entries within rtol 1e-5 / atol 1e-6;
    K2 on its frames runs B = 199 blocks in the FFT regime, within
    1 LSB of its plain version without iterations and on >= 99.9% of
    samples with the converging estimator."""
    cfg, dec = _decoder(rs, cuda_device, 1024.0, 64)
    x = torch.as_tensor(rs.randn(2048, 64), dtype=torch.float32, device=cuda_device)
    plan = pipeline.mel_plan(dec, cfg, x.shape[0])
    before = cuda_frontend.frontend_decode_mels.launches
    mel = pipeline._mel_frames(dec, cfg, x, plan)
    torch.cuda.synchronize()
    assert cuda_frontend.frontend_decode_mels.launches == before + 1 and mel.shape == (200, 40)
    assert torch.equal(pipeline._mel_frames(dec, cfg, x), mel)
    *consts, _ = plan.k1
    mel_p = cuda_frontend.frontend_decode_mels_plain(
        dec.frontend_ops, x, pipeline._initial_state(dec, x).contiguous(), *consts, 200)
    off = int((~torch.isclose(mel, mel_p, rtol=1e-5, atol=1e-6)).sum())
    assert off < 0.001 * mel.numel(), off

    B = mel.shape[0] - 1
    assert cuda_gl.regime(B) == "fft"
    rand = gl.default_rand_init(B, 0, 0, torch.float32, cuda_device)
    rand[0, 0] = 0.0  # see test_gl_audio_kernel_matches_plain
    before = cuda_gl.gl_audio.launches
    a_k = cuda_gl.gl_audio(mel.contiguous(), rand, dec.gl_audio_ops, 10.0, iterations, phase_bug)
    torch.cuda.synchronize()
    assert cuda_gl.gl_audio.launches == before + 1
    a_p = cuda_gl.gl_audio_plain(mel.contiguous(), rand, dec.gl_audio_ops, 10.0, iterations,
                                 phase_bug)
    assert a_k.shape == a_p.shape == (B * 160,)
    off = int(((a_k.long() - a_p.long()).abs() > 1).sum())
    assert off <= (0 if iterations == 0 else 0.001 * B * 160), off


@pytest.mark.cuda
def test_replay_builds_no_k1_constants_and_decodes_as_before(rs, cuda_device, monkeypatch):
    """``offline_decode`` of a 60-s, 128-channel session at 1024 Hz: the params
    carry K1's constants, so the replay's ``mel_plan`` calls neither
    ``epilogue_constants`` nor ``pack_lda_weights`` and searches no frame
    ends; the spectrogram and audio equal, bit for bit, those decoded with
    the plan built as before (the frame ends searched, the constants built
    per call)."""
    cfg, dec = _decoder(rs, cuda_device, 1024.0, 128)
    x = torch.as_tensor(rs.randn(60 * 1024, 128), dtype=torch.float32, device=cuda_device)
    assert dec.k1 is not None and dec.k1[0] == (128, cfg.model_order)
    ends = framing.streaming_frame_ends(50, 10, 1024.0, x.shape[0] + cfg.prefill)
    assert framing.periodic_window_matrix(ends, cfg.win) is not None
    consts = cuda_frontend.epilogue_constants(dec.lda_coef_full, dec.lda.intercept, dec.lda.valid,
                                              dec.lda.classes, dec.medians, dec.gauss_kernel,
                                              128, cfg.model_order)
    old = pipeline.MelPlan(n_samples=x.shape[0], n_frames=len(ends), ends=ends, window=None,
                           k1=consts + (cuda_frontend.pack_lda_weights(consts[0], 128,
                                                                       cfg.model_order + 1),))
    mel_old = pipeline._mel_frames(dec, cfg, x, old)
    audio_old = pipeline._vocode(dec, cfg, mel_old,
                                 gl.default_rand_init(len(ends) - 1, 0, 0, torch.float32,
                                                      cuda_device))
    calls = []
    for name in ("epilogue_constants", "pack_lda_weights"):
        real = getattr(pipeline, name)
        monkeypatch.setattr(pipeline, name,
                            lambda *a, _real=real, _name=name: calls.append(_name) or _real(*a))
    searched = pipeline.mel_plan.searched
    launches = cuda_frontend.frontend_decode_mels.launches
    spec, audio = pipeline.offline_decode(dec, cfg, x)
    torch.cuda.synchronize()
    assert calls == [] and pipeline.mel_plan.searched == searched
    assert cuda_frontend.frontend_decode_mels.launches == launches + 1
    assert torch.equal(spec, mel_old) and torch.equal(audio, audio_old)


def _persistent_session(dec, packets, timeout=120.0):
    """One session of the persistent loop over ``packets``; a watchdog sets
    the loop's abort word after ``timeout`` s, so a fault fails the test
    instead of leaving it waiting."""
    import threading

    for p in packets:
        dec.feed_packet(p)
    dec.feed_stop()
    timer = threading.Timer(timeout, lambda: dec._loop.abort())
    timer.start()
    try:
        return dec.run_until_stopped()
    finally:
        timer.cancel()


@pytest.mark.cuda
@pytest.mark.parametrize("C,dtype,use_cuda_gl", [(16, torch.float32, True),
                                                 (128, torch.float32, True),
                                                 (16, torch.float32, False),
                                                 (16, torch.float64, True)])
def test_persistent_loop_bit_identical_to_online_decoder(rs, cuda_device, C, dtype, use_cuda_gl):
    """200 packets through OnlineDecoder and through the persistent loop:
    every output bit-equal; the session is one graph launch of 201
    iterations (the STOP included).  In float32 K4 sits in the captured
    step; the plain Griffin-Lim and the float64 step (the plain path, with
    the exact smoothing table) are recorded as well."""
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import cuda_loop
    from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import online

    cfg, dec = _decoder(rs, cuda_device, 1024.0, C, dtype, use_cuda_gl=use_cuda_gl)
    k4_step = use_cuda_gl and dtype == torch.float32
    packets = [rs.randn(32, C).astype(np.float32) * 10 for _ in range(200)]
    ref = online.OnlineDecoder(cfg, dec)
    for p in packets:
        ref.process_packet(p)
    pers = online.PersistentOnlineDecoder(cfg, dec)
    pers.warmup()
    # K4's node in the recorded step, launched once in each iteration, and
    # the block inits' kernel (csrc/prng.cu) in every dtype
    assert pers._captured.k4_nodes == (1 if k4_step else 0)
    assert pers._captured.init_nodes == 1
    sessions, iterations = cuda_loop.sessions, cuda_loop.iterations
    out = _persistent_session(pers, packets)
    assert cuda_loop.sessions == sessions + 1 and cuda_loop.iterations == iterations + 201
    for a, b in zip(ref.results(), out):
        np.testing.assert_array_equal(a, b)
    assert len(out[0]) > 0 and len(out[1]) > 0


@pytest.mark.cuda
def test_persistent_loop_reset_between_sessions(rs, cuda_device):
    """reset() rewrites the static carry in place: the session after it
    decodes as the first one did."""
    from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import online

    cfg, dec = _decoder(rs, cuda_device, 1024.0, 16)
    packets = [rs.randn(32, 16).astype(np.float32) * 10 for _ in range(60)]
    pers = online.PersistentOnlineDecoder(cfg, dec)
    first = _persistent_session(pers, packets)
    pers.reset()
    second = _persistent_session(pers, packets)
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_persistent_loop_errors_return_and_the_card_stays_usable(rs, cuda_device):
    """A feeder that raises after 2 packets: run_stream returns its error
    within seconds.  A session aborted while its loop waits for a packet:
    a matmul on another stream completes while it waits and after the
    abort, and after reset() the next session decodes as an OnlineDecoder
    does."""
    import threading
    import time

    from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import online

    C = 16
    cfg, dec = _decoder(rs, cuda_device, 1024.0, C)
    pers = online.PersistentOnlineDecoder(cfg, dec)

    class Broken:
        channels, nominal_srate, calls = C, 1024, 0

        def pull_chunk(self, max_samples=64, timeout=0.25):
            self.calls += 1
            if self.calls > 2:
                raise OSError("amplifier link dropped")
            return rs.randn(32, C).astype(np.float32), 1.0

    t0 = time.time()
    with pytest.raises(OSError, match="amplifier link"):
        pers.run_stream(Broken(), max_packets=64)
    assert time.time() - t0 < 10 and len(pers.received) == 2

    # nothing may allocate device memory while a loop waits (an allocation
    # can wait for the device, which waits for the host): the matmul's
    # cuBLAS workspace on its stream and its output block come first
    side = torch.cuda.Stream(cuda_device)
    a = torch.randn(512, 512, device=cuda_device)
    expected = (a.double() @ a.double()).float()
    with torch.cuda.stream(side):
        a @ a
    torch.cuda.synchronize()
    errors = []
    runner = threading.Thread(target=lambda: errors.append(
        pytest.raises(RuntimeError, pers.run_until_stopped)))
    runner.start()
    time.sleep(0.5)  # the loop now spins in wait_packet_kernel
    for _ in range(2):
        with torch.cuda.stream(side):
            b = a @ a
            done = torch.cuda.Event()
            done.record(side)
        deadline = time.time() + 10
        while not done.query() and time.time() < deadline:
            time.sleep(0.001)
        completed = done.query()
        if runner.is_alive():
            pers._loop.abort()
            runner.join(timeout=10)
        assert completed and torch.allclose(b, expected, rtol=1e-3, atol=1e-3)
    assert not runner.is_alive() and len(errors) == 1
    ref = online.OnlineDecoder(cfg, dec)
    packets = [rs.randn(32, C).astype(np.float32) for _ in range(20)]
    for p in packets:
        ref.process_packet(p)
    pers.reset()
    for a_ref, a_pers in zip(ref.results(), _persistent_session(pers, packets)):
        np.testing.assert_array_equal(a_ref, a_pers)


@pytest.mark.cuda
def test_persistent_loop_emitter_error_leaves_it_stale_until_reset(rs, cuda_device):
    """The emitter raises on the first block past a short init table while
    the device has decoded packets ahead of it: the abort ends the session,
    the next session raises until reset(), and after it the loop (its abort
    word cleared) decodes as a fresh decoder with the same table."""
    from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import online

    rows, C = 20, 16
    table = pipeline.gl.default_rand_init(rows)
    cfg, dec = _decoder(rs, cuda_device, 1024.0, C)
    pers = online.PersistentOnlineDecoder(cfg, dec, rand_source=table)
    packets = [rs.randn(32, C).astype(np.float32) * 10 for _ in range(40)]
    with pytest.raises(ValueError, match=f"has {rows} rows"):
        _persistent_session(pers, packets)
    with pytest.raises(RuntimeError, match="call reset"):
        pers.run_until_stopped()
    pers.reset()
    fresh = online.PersistentOnlineDecoder(cfg, dec, rand_source=table)
    for a, b in zip(_persistent_session(pers, packets[:4]),
                    _persistent_session(fresh, packets[:4])):
        np.testing.assert_array_equal(a, b)


def _eager_loop(dec, cfg, rand_source, packets, bad):
    step = pipeline.make_online_step(dec, cfg, rand_source)
    carry = pipeline.init_online_carry(dec, cfg)
    specs, audio = [], []
    for p in packets:
        x = torch.as_tensor(np.delete(p, bad, axis=1)).to(device=dec.device, dtype=cfg.dtype)
        carry, out = step(carry, x)
        specs.append(out["spec"][out["spec_valid"]].cpu().numpy())
        audio.append(out["audio"][out["audio_valid"]].cpu().numpy())
    return np.concatenate(specs), np.concatenate(audio).reshape(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_steps,pipelined", [(1, False), (1, True), (4, False), (4, True)])
@pytest.mark.parametrize("rand", ["key", "table"])
@pytest.mark.parametrize("C", [4, 128])
def test_graph_decoder_bit_identical_to_eager_step(rs, cuda_device, C, rand, chunk_steps,
                                                   pipelined):
    """OnlineDecoder on the card replays the recorded step: 50 packets, a
    reset() (mid-chunk for K = 4), then 130 packets (a tail of 2 past the
    last 4-chunk), with two bad channels dropped.  After the reset the
    output is bit-identical to a plain loop of the eager
    ``make_online_step``; no kernel wrapper runs in ``process_packet`` (K4
    and the block inits run only as nodes of the recorded graphs), and the
    programs ran once per packet, or once per K-chunk plus one per tail
    packet."""
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import cuda_prng
    from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import online

    bad = [1, C + 1]
    cfg, dec = _decoder(rs, cuda_device, 1024.0, C)
    rand_source = 3 if rand == "key" else gl.default_rand_init(600, 0, 5, torch.float32)
    packets = [rs.randn(32, C + 2).astype(np.float32) * 10 for _ in range(180)]
    d = online.OnlineDecoder(cfg, dec, bad_channels=bad, rand_source=rand_source,
                             chunk_steps=chunk_steps, pipelined=pipelined)
    d.warmup()
    assert d.programs[chunk_steps].k4_nodes == chunk_steps
    # a table's rows are gathered by index; a key draws them with the kernel
    assert d.programs[chunk_steps].init_nodes == (chunk_steps if rand == "key" else 0)
    k4, inits = cuda_gl.gl_blocks.launches, cuda_prng.block_inits.launches
    for p in packets[:50]:
        d.process_packet(p)
    d.reset()
    for p in packets[50:]:
        d.process_packet(p)
    spec, audio, received = d.results()
    assert cuda_gl.gl_blocks.launches == k4 and cuda_prng.block_inits.launches == inits
    runs = {chunk_steps: 50 // chunk_steps + 130 // chunk_steps}
    if chunk_steps > 1:
        runs[1] = 130 % chunk_steps
    assert d.replays == runs
    spec_e, audio_e = _eager_loop(dec, cfg, rand_source, packets[50:], bad)
    assert len(spec) > 0 and len(audio) > 0
    np.testing.assert_array_equal(spec, spec_e)
    np.testing.assert_array_equal(audio, audio_e)
    np.testing.assert_array_equal(received, np.vstack(packets[50:]))


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_steps", [1, 4])
def test_graph_decoder_issues_one_graph_launch_per_dispatch(rs, cuda_device, chunk_steps):
    """Under the profiler, 40 packets after warmup are 40 / K
    cudaGraphLaunch calls and no kernel launched by the host."""
    from torch.profiler import ProfilerActivity, profile

    from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import online

    C = 16
    cfg, dec = _decoder(rs, cuda_device, 1024.0, C)
    packets = [rs.randn(32, C).astype(np.float32) for _ in range(40)]
    d = online.OnlineDecoder(cfg, dec, chunk_steps=chunk_steps)
    d.warmup()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for p in packets:
            d.process_packet(p)
        torch.cuda.synchronize()
    events = prof.key_averages()
    graph_launches = sum(e.count for e in events if e.key.startswith("cudaGraphLaunch"))
    kernels = sum(e.count for e in events
                  if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    assert graph_launches == 40 // chunk_steps and kernels == 0, (graph_launches, kernels)


@pytest.mark.cuda
def test_graph_decoder_raises_when_the_graph_fails(rs, cuda_device, monkeypatch):
    """A recording that fails raises out of process_packet, and so does
    the next packet: the decoder emits nothing and never decodes on the
    eager step.  A replay that fails raises the same way."""
    from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import online

    C = 16
    cfg, dec = _decoder(rs, cuda_device, 1024.0, C)
    packet = rs.randn(32, C).astype(np.float32)

    class FailingCapture:
        def __init__(self, *args, **kwargs):
            pass

        def __enter__(self):
            raise RuntimeError("forced capture failure")

        def __exit__(self, *exc):
            return False

    d = online.OnlineDecoder(cfg, dec)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "graph", FailingCapture)
        for _ in range(2):
            with pytest.raises(RuntimeError, match="forced capture failure"):
                d.process_packet(packet)
    assert d.spec_frames == [] and d.audio_chunks == [] and len(d.sink.audio()) == 0

    def failing_replay(self):
        raise RuntimeError("forced replay failure")

    d = online.OnlineDecoder(cfg, dec)
    d.warmup()
    monkeypatch.setattr(pipeline.CapturedStep, "run", failing_replay)
    with pytest.raises(RuntimeError, match="forced replay failure"):
        d.process_packet(packet)
    assert d.spec_frames == [] and d.audio_chunks == [] and d.replays == {1: 0}


@pytest.mark.cuda
def test_train_and_decode_clis_on_codec_files(cuda_device, tmp_path):
    """cli.train and cli.decode with --device cuda on files the port's own
    HDF5 codec writes (the card's machine has neither h5py nor sklearn): the
    train CLI's artifacts, and the decode CLI's spectrogram.npy and audio.wav
    equal to perform_offline_decoding of the loaded model on the same sEEG,
    with K1 and K2 launched under the CLI."""
    import configparser

    from scipy.io import wavfile

    from closed_loop_seeg_speech_synthesis_tpu_torch.cli import decode as cli
    from closed_loop_seeg_speech_synthesis_tpu_torch.cli import train as train_cli
    from closed_loop_seeg_speech_synthesis_tpu_torch.io import hdf5, loaders

    sr, audio_sr, C, seconds = 1024, 48000, 16, 30
    rs = np.random.RandomState(5)
    eeg = rs.randn(seconds * sr, C).astype(np.float32)
    audio = 0.01 * rs.randn(seconds * audio_sr)
    t_a = np.arange(2 * audio_sr) / audio_sr
    for i in range(seconds // 3):  # word-locked: a 120 Hz burst and a voiced stack
        eeg[i * 3 * sr : i * 3 * sr + 2 * sr, : C // 2] += np.float32(1 + 0.4 * (i % 5)) * np.sin(
            2 * np.pi * 120 * np.arange(2 * sr) / sr).astype(np.float32)[:, None]
        f0 = 150 + 30 * (i % 5)
        audio[i * 3 * audio_sr : i * 3 * audio_sr + 2 * audio_sr] += 0.3 * np.sin(
            2 * np.pi * f0 * t_a)
    rec = str(tmp_path / "speech.hdf")
    loaders.save_hdf5(rec, eeg, sr, audio, audio_sr)
    config = configparser.ConfigParser()
    config["General"] = {"storage_dir": str(tmp_path / "storage"), "session": "demo"}
    config["Training"] = {"file": rec, "overwrite_on_rerun": "True"}
    config["Decoding"] = {"stream_name": "x", "griffin_lim_norm": "10"}
    cfg = str(tmp_path / "experiment.ini")
    with open(cfg, "w") as f:
        config.write(f)

    path = train_cli.main([cfg, "--device", "cuda"], rng=np.random.RandomState(0))
    for name in ("params.h5", "LDAs.pkl", "training_features.npy", "train.ini", "train.log"):
        assert (tmp_path / "storage" / "demo" / name).exists(), name
    loaded = params.load_params(path, dtype=torch.float32, device=cuda_device)
    with open(tmp_path / "storage" / "demo" / "LDAs.pkl", "rb") as f:
        from_pickle = lda.from_sklearn_estimators(lda.load_estimators(f.read()))
    assert torch.equal(from_pickle.valid, loaded["lda"].valid.cpu())

    k1, k2 = cuda_frontend.frontend_decode_mels.launches, cuda_gl.gl_audio.launches
    run_dir = cli.main([cfg, "--seeg_file", rec, "--run", "replay", "--device", "cuda"])
    assert cuda_frontend.frontend_decode_mels.launches > k1 and cuda_gl.gl_audio.launches > k2
    spec = np.load(Path(run_dir) / "spectrogram.npy")
    _, audio_cli = wavfile.read(Path(run_dir) / "audio.wav")
    spec_a, audio_a, _, _ = cli.perform_offline_decoding(loaded, eeg, sr, 10.0, device=cuda_device)
    assert spec.shape[1] == 40 and np.isfinite(spec).all()
    assert np.array_equal(spec, spec_a.cpu().numpy())
    assert np.array_equal(audio_cli, audio_a.cpu().numpy().astype(np.int16))
    with hdf5.File(str(Path(run_dir) / "sEEG.hdf"), "r") as hf:
        assert np.array_equal(hf["sEEG"][()], eeg) and hf["sEEG_sr"][()] == sr
