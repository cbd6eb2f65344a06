"""The bf16 branch of kernels K2 and K4 (``DecoderConfig.gl_bf16``): the
port's plain versions (``cuda_gl.gl_blocks_plain`` / ``gl_audio_plain`` with
``bf16=True``, float32) against the JAX package's Pallas kernels in
interpret mode with ``bf16=True``, on the smooth log-mel walk of
tests/test_pallas_kernels.py::test_gl_bf16_quality.

Rounded to bf16 on both sides: the frames, zr (zi), the four DFT matrices;
the products of two bf16 values are exact in float32, so the two differ
only in the order of their sums, and over one iteration only where that
order moves a value across a bf16 rounding boundary.  The f32 plain version
fails the same one-iteration gates by two to five orders of magnitude, so
they tell a bf16 port from an f32 one.  Over 8 iterations the converging
estimator keeps almost every sample within 1e-3; the exp(angle) quirk is
chaotic in any precision and is quality-gated as the JAX test gates it.
Also: the bf16 operands and the wgmma kernel's shared-memory image of them,
the wrappers on CPU tensors, and ``DecoderConfig(gl_bf16=True)`` through
``offline_decode``.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from closed_loop_seeg_speech_synthesis_tpu.models import lda as j_lda
from closed_loop_seeg_speech_synthesis_tpu.ops import filter_design as j_fd
from closed_loop_seeg_speech_synthesis_tpu.ops import griffinlim as j_gl
from closed_loop_seeg_speech_synthesis_tpu.ops import iir as j_iir
from closed_loop_seeg_speech_synthesis_tpu.ops.pallas_gl import (_split_nyquist, gl_audio_pallas,
                                                                 gl_blocks_pallas)
from closed_loop_seeg_speech_synthesis_tpu.runtime import pipeline as j_pipe

from closed_loop_seeg_speech_synthesis_tpu_torch.ops import cuda_gl
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import filter_design as t_fd
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import griffinlim as t_gl
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import iir as t_iir
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import wgmma_layout
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params as t_params
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import pipeline as t_pipe

B = 48
ONE_ITER_ATOL = 2e-5        # K4, 1 iteration (measured 7.6e-6 converging, 2.4e-7 quirk)
CONVERGING_ATOL, CONVERGING_MIN = 1e-3, 0.995   # K4, 8 iterations (measured 0.99918)
QUIRK_ATTAINMENT, QUIRK_R, QUIRK_VS_JAX = 1.1, 0.9, 0.02   # test_gl_bf16_quality's gate


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Step-sized CPU work: one torch thread, restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ops():
    return cuda_gl.make_gl_audio_ops(t_gl.make_streaming_gl_ops(40, 16000.0, torch.float32),
                                     t_iir.sos_to_statespace(t_fd.gl_output_lowpass_sos()),
                                     torch.float32)


@pytest.fixture(scope="module")
def walk():
    """test_gl_bf16_quality's inputs: a smooth, speech-like log-mel walk
    (B + 1, 40) and uniform inits (B, 480), float32, from RandomState(0)."""
    rs = np.random.RandomState(0)
    w = np.cumsum(rs.randn(B + 1, 40) * 0.15, axis=0)
    return (w - w.mean() - 1.0).astype(np.float32), rs.rand(B, 480).astype(np.float32)


def _jax_blocks(lm, rand, iterations, phase_bug, bf16=True):
    return np.asarray(gl_blocks_pallas(jnp.asarray(lm), jnp.asarray(rand),
                                       j_gl.make_streaming_gl_ops(dtype=jnp.float32), iterations,
                                       phase_bug, tile=8, interpret=True, bf16=bf16))


def _jax_audio(lm, rand, iterations, phase_bug):
    lp_op = j_iir.make_blocked_iir(j_iir.sos_to_statespace(j_fd.gl_output_lowpass_sos()), 160,
                                   jnp.float32)
    return np.asarray(gl_audio_pallas(jnp.asarray(lm), jnp.asarray(rand),
                                      j_gl.make_streaming_gl_ops(dtype=jnp.float32), lp_op, 10.0,
                                      iterations, phase_bug, tile=8, interpret=True, bf16=True))


def _plain_blocks(lm, rand, ops, iterations, phase_bug, bf16=True):
    return cuda_gl.gl_blocks_plain(torch.as_tensor(lm), torch.as_tensor(rand), ops, iterations,
                                   phase_bug, bf16).numpy()


def _attainment(blocks, lm):
    """test_gl_bf16_quality's spectral-objective attainment of the blocks'
    first frames against exp(lm) @ Minv."""
    ops = j_gl.make_streaming_gl_ops(dtype=jnp.float64)
    target = np.exp(lm.astype(np.float64))[: blocks.shape[0]] @ np.asarray(ops.Minv)
    mag = np.abs(np.fft.rfft(blocks.astype(np.float64)[:, :256] * np.asarray(ops.window), axis=1))
    return np.linalg.norm(mag - target) / np.linalg.norm(target)


def _envelope_r(a, b):
    e = lambda x: np.sqrt((x.astype(np.float64) ** 2).mean(axis=1) + 1e-6)
    return np.corrcoef(e(a), e(b))[0, 1]


@pytest.mark.parametrize("phase_bug", [False, True])
def test_gl_blocks_bf16_one_iteration_matches_pallas(ops, walk, phase_bug):
    """One iteration: the plain bf16 version within atol 2e-5 of the JAX
    kernel's bf16 branch (blocks' max |value| 0.20 converging, 1.41 quirk)."""
    lm, rand = walk
    re_j = _jax_blocks(lm, rand, 1, phase_bug)
    re_t = _plain_blocks(lm, rand, ops, 1, phase_bug)
    assert re_t.shape == re_j.shape == (B, 480) and re_t.dtype == np.float32
    np.testing.assert_allclose(re_t, re_j, rtol=0, atol=ONE_ITER_ATOL)


@pytest.mark.parametrize("phase_bug", [False, True])
def test_f32_plain_fails_the_bf16_gates(ops, walk, phase_bug):
    """The gates tell bf16 from f32: the f32 plain version is 1.3e-3
    (converging) and 0.11 (quirk) from the JAX bf16 blocks after one
    iteration, and its audio 5-183 LSB from the JAX bf16 audio."""
    lm, rand = walk
    re_32 = _plain_blocks(lm, rand, ops, 1, phase_bug, bf16=False)
    assert np.abs(re_32 - _jax_blocks(lm, rand, 1, phase_bug)).max() > 20 * ONE_ITER_ATOL
    a_32 = cuda_gl.gl_audio_plain(torch.as_tensor(lm[:22]), torch.as_tensor(rand[:21]), ops, 10.0,
                                  1, phase_bug).numpy()
    assert np.abs(a_32.astype(int) - _jax_audio(lm[:22], rand[:21], 1, phase_bug).astype(int)).max() > 1


def test_gl_blocks_bf16_converging_eight_iterations(ops, walk):
    """8 iterations, converging estimator: >= 99.5% of the samples within
    1e-3 of the JAX kernel's bf16 blocks (measured 99.918%; the f32 plain
    version 95.8%)."""
    lm, rand = walk
    d = np.abs(_plain_blocks(lm, rand, ops, 8, False) - _jax_blocks(lm, rand, 8, False))
    assert (d <= CONVERGING_ATOL).mean() >= CONVERGING_MIN


def test_gl_blocks_bf16_quirk_quality(ops, walk):
    """8 iterations under the exp(angle) quirk (chaotic: 98.3% of samples
    within 2e-4 of JAX's bf16 blocks, max 0.70): test_gl_bf16_quality's gate
    against the f32 plain version (attainment <= 1.1x, per-block energy
    r > 0.9), and attainment within 2% of the JAX bf16 kernel's."""
    lm, rand = walk
    re_16 = _plain_blocks(lm, rand, ops, 8, True)
    re_32 = _plain_blocks(lm, rand, ops, 8, True, bf16=False)
    re_j = _jax_blocks(lm, rand, 8, True)
    assert np.all(np.isfinite(re_16))
    a16, a32, aj = _attainment(re_16, lm), _attainment(re_32, lm), _attainment(re_j, lm)
    assert a16 <= QUIRK_ATTAINMENT * a32, (a16, a32)
    assert _envelope_r(re_16, re_32) > QUIRK_R
    assert abs(a16 - aj) <= QUIRK_VS_JAX * aj, (a16, aj)


@pytest.mark.parametrize("phase_bug", [False, True])
def test_gl_audio_bf16_one_iteration_matches_pallas(ops, walk, phase_bug):
    """K2's plain bf16 version against the JAX fused kernel's bf16 branch,
    one iteration, B = 21 (not a multiple of the JAX tile): within 1 LSB."""
    lm, rand = walk
    audio_j = _jax_audio(lm[:22], rand[:21], 1, phase_bug)
    audio_t = cuda_gl.gl_audio_plain(torch.as_tensor(lm[:22]), torch.as_tensor(rand[:21]), ops,
                                     10.0, 1, phase_bug, bf16=True).numpy()
    assert audio_t.shape == audio_j.shape == (21 * 160,) and audio_t.dtype == np.int16
    assert np.abs(audio_t.astype(int) - audio_j.astype(int)).max() <= 1


@pytest.mark.parametrize("forward", [True, False])
def test_bf16_operands_are_the_jax_kernels(ops, forward):
    """``GLAudioOps.gl_bf16``: the forward [cos | sin] and inverse [cos; sin]
    operands rounded to bf16 are the bytes the JAX kernel casts
    (``_split_nyquist`` then ``astype(bfloat16)``), and the wgmma kernel's
    one shared-memory image unpacks to both: to the forward operand as it
    is, and read transposed, row k times the inverse's weight (1/256 at DC,
    else 2/256; negated for the sin rows), to the inverse.  The weights are
    powers of two, so they commute with the bf16 rounding."""
    _, _, fcos, fsin, _, icos, isin, _ = _split_nyquist(j_gl.make_streaming_gl_ops(
        dtype=jnp.float32))
    parts = (fcos, fsin) if forward else (icos, isin)
    ref = np.concatenate([np.asarray(p.astype(jnp.bfloat16), np.float32) for p in parts],
                         axis=1 if forward else 0)
    rounded = ops.gl_bf16[0 if forward else 1]
    assert rounded.dtype == torch.float32 and np.array_equal(rounded.numpy(), ref)
    image = ops.gl_bf16[2]
    assert image.dtype == torch.bfloat16 and tuple(image.shape) == (256 * 256,)
    fwd = wgmma_layout.unpack_image(image, 256, 256).float().numpy()
    if forward:
        got = fwd
    else:
        weights = np.full((128, 1), 2.0 / 256, np.float32)
        weights[0] = 1.0 / 256
        got = np.concatenate([weights * fwd[:, :128].T, -weights * fwd[:, 128:].T])
    assert got.dtype == np.float32 and np.array_equal(got, ref)


def test_wrappers_run_the_plain_bf16_version_on_cpu(ops, walk):
    """On CPU tensors ``gl_blocks`` / ``gl_audio`` with ``bf16=True`` run the
    plain bf16 version: equal to it, and no launch counted."""
    lm, rand = (torch.as_tensor(a) for a in walk)
    counts = lambda: (cuda_gl.gl_blocks.launches, cuda_gl.gl_blocks.launches_bf16,
                      cuda_gl.gl_audio.launches, cuda_gl.gl_audio.launches_bf16)
    before = counts()
    re = cuda_gl.gl_blocks(lm, rand, ops, 2, False, bf16=True)
    audio = cuda_gl.gl_audio(lm, rand, ops, 10.0, 2, True, bf16=True)
    assert counts() == before
    assert torch.equal(re, cuda_gl.gl_blocks_plain(lm, rand, ops, 2, False, bf16=True))
    assert torch.equal(audio, cuda_gl.gl_audio_plain(lm, rand, ops, 10.0, 2, True, bf16=True))
    assert not torch.equal(re, cuda_gl.gl_blocks(lm, rand, ops, 2, False))


def test_decoder_config_gl_bf16_on_the_cpu_matches_jax(rng):
    """``DecoderConfig(gl_bf16=True)`` on the CPU in float64, fused and split:
    the plain route ignores it, as the JAX package's non-Pallas route does.
    Spectrogram bit-equal and audio equal to gl_bf16=False; against the
    JAX package's offline_decode with gl_bf16=True, spectrogram bit-equal
    and audio within 1 LSB."""
    sr, C = 1024.0, 5
    arrs = dict(lda_coef=rng.randn(40, 9, 20) * 0.3, lda_intercept=rng.randn(40, 9),
                lda_classes=np.tile(np.arange(9, dtype=np.int32), (40, 1)),
                lda_valid=np.ones((40, 9), bool), medians=np.sort(rng.randn(40, 9), axis=1),
                select=rng.permutation(5 * C)[:20], bad_channels=np.zeros(0, int))
    eeg = rng.randn(int(sr * 2), C) * 10.0
    jcfg = j_pipe.DecoderConfig(sr=sr, n_channels=C, dtype=jnp.float64, gl_bf16=True)
    jlda = j_lda.LDAParams(coef=jnp.asarray(arrs["lda_coef"]),
                           intercept=jnp.asarray(arrs["lda_intercept"]),
                           classes=jnp.asarray(arrs["lda_classes"]),
                           valid=jnp.asarray(arrs["lda_valid"]))
    jdec = j_pipe.build_decoder_params(jcfg, jlda, arrs["medians"], arrs["select"])
    spec_j, audio_j = (np.asarray(a) for a in j_pipe.offline_decode(jdec, jcfg, eeg))

    loaded = t_params.from_arrays(**arrs)
    for split in ({}, dict(use_cuda_epilogue=False, use_cuda_gl_tail=False)):
        cfg = t_pipe.DecoderConfig(sr=sr, n_channels=C, dtype=torch.float64, **split)
        dec = t_pipe.build_decoder_params(cfg, loaded["lda"], loaded["medians"],
                                          loaded["select"], device="cpu")
        spec_f, audio_f = t_pipe.offline_decode(dec, cfg, eeg)
        spec_t, audio_t = t_pipe.offline_decode(dec, dataclasses.replace(cfg, gl_bf16=True), eeg)
        assert torch.equal(spec_t, spec_f) and torch.equal(audio_t, audio_f)
        assert spec_t.dtype == torch.float64 and np.array_equal(spec_t.numpy(), spec_j)
        assert audio_t.shape == audio_j.shape and audio_t.dtype == torch.int16
        assert np.abs(audio_t.numpy().astype(int) - audio_j.astype(int)).max() <= 1
