"""The two kernel modules (kernels K1-K4) against the JAX package.

On the CPU each wrapper runs its plain torch version, which is held here
against the JAX Pallas kernels run in interpret mode (as
tests/test_pallas_kernels.py runs them) and against the JAX package's plain
stages.  The kernels themselves are held against the plain versions on the
card in tests/test_torch_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from closed_loop_seeg_speech_synthesis_tpu.models import lda as j_lda
from closed_loop_seeg_speech_synthesis_tpu.ops import filter_design as j_fd
from closed_loop_seeg_speech_synthesis_tpu.ops import framing as j_fr
from closed_loop_seeg_speech_synthesis_tpu.ops import griffinlim as j_gl
from closed_loop_seeg_speech_synthesis_tpu.ops import iir as j_iir
from closed_loop_seeg_speech_synthesis_tpu.ops.pallas_frontend import (
    epilogue_constants as j_epilogue_constants, frontend_decode_mels as j_frontend_decode_mels,
    frontend_logpower as j_frontend_logpower)
from closed_loop_seeg_speech_synthesis_tpu.ops.pallas_gl import gl_audio_pallas, gl_blocks_pallas
from closed_loop_seeg_speech_synthesis_tpu.runtime import pipeline as j_pipe

from closed_loop_seeg_speech_synthesis_tpu_torch.ops import cuda_frontend, cuda_gl
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import filter_design as t_fd
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import griffinlim as t_gl
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import iir as t_iir
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params as t_params
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import pipeline as t_pipe


def _lda_arrays(rng, C, n_feats=20, invalid=((7, 1), (14, 8))):
    valid = np.ones((40, 9), bool)
    for b, k in invalid:
        valid[b, k] = False
    return dict(lda_coef=rng.randn(40, 9, n_feats) * 0.3, lda_intercept=rng.randn(40, 9),
                lda_classes=np.tile(np.arange(9, dtype=np.int32), (40, 1)), lda_valid=valid,
                medians=np.sort(rng.randn(40, 9), axis=1),
                select=rng.permutation(5 * C)[:n_feats], bad_channels=[])


def _frontend_both(arrs, eeg, sr, C):
    """(JAX fused kernel in interpret mode, port kernel module) mel frames, f32."""
    lda = j_lda.LDAParams(coef=jnp.asarray(arrs["lda_coef"], jnp.float32),
                          intercept=jnp.asarray(arrs["lda_intercept"], jnp.float32),
                          classes=jnp.asarray(arrs["lda_classes"]),
                          valid=jnp.asarray(arrs["lda_valid"]))
    cfg = j_pipe.DecoderConfig(sr=sr, n_channels=C, dtype=jnp.float32)
    dec = j_pipe.build_decoder_params(cfg, lda, arrs["medians"], arrs["select"])
    nf = len(j_fr.streaming_frame_ends(50, 10, sr, eeg.shape[0] + cfg.prefill))
    x = jnp.asarray(eeg, jnp.float32)
    s0 = dec.filt_zi_scale[:, None] * x[0][None, :] + dec.filt_s_const[:, None]
    consts = j_epilogue_constants(dec.lda_coef_full, dec.lda.intercept, dec.lda.valid,
                                  dec.lda.classes, dec.medians, dec.gauss_kernel, C)
    mel_j = np.asarray(j_frontend_decode_mels(dec.frontend_ops, x, s0, *consts, nf, interpret=True))

    loaded = t_params.from_arrays(**arrs, dtype=torch.float32)
    tcfg = t_pipe.DecoderConfig(sr=sr, n_channels=C, dtype=torch.float32)
    tdec = t_pipe.build_decoder_params(tcfg, loaded["lda"], loaded["medians"], loaded["select"],
                                       device="cpu")
    xt = torch.as_tensor(eeg, dtype=torch.float32)
    tconsts = cuda_frontend.epilogue_constants(tdec.lda_coef_full, tdec.lda.intercept,
                                               tdec.lda.valid, tdec.lda.classes, tdec.medians,
                                               tdec.gauss_kernel, C)
    before = cuda_frontend.frontend_decode_mels.launches
    mel_t = cuda_frontend.frontend_decode_mels(tdec.frontend_ops, xt,
                                               t_pipe._initial_state(tdec, xt), *tconsts, nf)
    assert cuda_frontend.frontend_decode_mels.launches == before  # CPU: plain version
    return mel_j, mel_t.numpy(), tconsts


@pytest.mark.parametrize("sr", [1024.0, 2048.0])
def test_frontend_plain_matches_pallas(rng, sr):
    """f32, the gate of test_pallas_kernels.py: >= 99.9% of entries within
    rtol 1e-5 / atol 1e-6 (different contraction orders flip rare near-ties)."""
    C = 8
    eeg = rng.randn(int(sr * 2), C).astype(np.float32)
    mel_j, mel_t, _ = _frontend_both(_lda_arrays(rng, C), eeg, sr, C)
    assert mel_t.shape == mel_j.shape and mel_t.dtype == np.float32
    agree = np.isclose(mel_t, mel_j, rtol=1e-5, atol=1e-6).mean()
    assert agree > 0.999, f"agreement {agree}"


def test_frontend_plain_invalid_slot_never_selected(rng):
    """Bin 3 has only class 5 valid: its dequantized value is always medians[3, 5]."""
    C, sr = 8, 1024.0
    arrs = _lda_arrays(rng, C, n_feats=10, invalid=[(3, k) for k in range(9) if k != 5])
    eeg = rng.randn(int(sr), C).astype(np.float32)
    mel_j, mel_t, consts = _frontend_both(arrs, eeg, sr, C)
    deq = mel_t.astype(np.float64) @ np.linalg.inv(consts[3].numpy().astype(np.float64))
    np.testing.assert_allclose(deq[:, 3], arrs["medians"][3, 5], atol=1e-4)
    assert np.isclose(mel_t, mel_j, rtol=1e-5, atol=1e-6).mean() > 0.999


def _gl_audio_ops(dtype):
    gl = t_gl.make_streaming_gl_ops(40, 16000.0, dtype)
    lp = t_iir.sos_to_statespace(t_fd.gl_output_lowpass_sos())
    return cuda_gl.make_gl_audio_ops(gl, lp, dtype)


@pytest.mark.parametrize("phase_bug", [True, False])
def test_gl_audio_plain_matches_jax_tail_f64(rng, phase_bug):
    """f64: the port's fused-vocoder plain version (power-sum low-pass states)
    == the JAX package's plain tail (streaming_gl_blocks -> overlap_add_stream
    -> iir_blocked -> to_int16) within 1 LSB; B = 21 is not a multiple of the
    kernel's 8 blocks per CUDA block."""
    B = 21
    lm = rng.randn(B + 1, 40) * 0.5 - 1.0
    rand = rng.rand(B, 480)
    ops_j = j_gl.make_streaming_gl_ops(dtype=jnp.float64)
    re = j_gl.streaming_gl_blocks(jnp.asarray(lm), jnp.asarray(rand), ops_j, 8, phase_bug)
    raw = j_gl.overlap_add_stream(re, ops_j)
    lp_op = j_iir.make_blocked_iir(j_iir.sos_to_statespace(j_fd.gl_output_lowpass_sos()), 4096,
                                   jnp.float64)
    lp, _ = j_iir.iir_blocked(lp_op, raw[:, None], jnp.zeros((lp_op.dim, 1)))
    audio_j = np.asarray(j_gl.to_int16(lp[:, 0], 10.0))
    audio_t = cuda_gl.gl_audio(torch.as_tensor(lm), torch.as_tensor(rand),
                               _gl_audio_ops(torch.float64), 10.0, 8, phase_bug).numpy()
    assert audio_t.shape == audio_j.shape == (B * 160,) and audio_t.dtype == np.int16
    assert np.abs(audio_t.astype(int) - audio_j.astype(int)).max() <= 1


def test_gl_audio_plain_matches_pallas_f32_no_iterations(rng):
    """f32 with iterations=0 (overlap-add, window sums, low-pass and int16
    only) against the JAX fused kernel in interpret mode: within 1 LSB.

    Sample 0 of block 0 is divided by the Blackman window's end value
    (-1.4e-17): with no iteration to window the block first, a nonzero init
    there is a 1e16 spike whose low-pass tail no float32 evaluation resolves
    to an LSB (the JAX package's own two f32 tails differ by 61 LSB on it),
    so that one init sample is 0."""
    B = 21
    lm = (rng.randn(B + 1, 40) * 0.5 - 1.0).astype(np.float32)
    rand = rng.rand(B, 480).astype(np.float32)
    rand[0, 0] = 0.0
    ops_j = j_gl.make_streaming_gl_ops(dtype=jnp.float32)
    lp_op = j_iir.make_blocked_iir(j_iir.sos_to_statespace(j_fd.gl_output_lowpass_sos()), 160,
                                   jnp.float32)
    audio_j = np.asarray(gl_audio_pallas(jnp.asarray(lm), jnp.asarray(rand), ops_j, lp_op, 10.0,
                                         0, True, tile=8, interpret=True))
    audio_t = cuda_gl.gl_audio(torch.as_tensor(lm), torch.as_tensor(rand),
                               _gl_audio_ops(torch.float32), 10.0, 0, True).numpy()
    assert audio_t.shape == audio_j.shape
    assert np.abs(audio_t.astype(int) - audio_j.astype(int)).max() <= 1


@pytest.mark.parametrize("sr", [1024.0, 2048.0])
def test_logpower_plain_matches_pallas(rng, sr):
    """K3's plain version (the wrapper on a CPU tensor) against the JAX
    kernel in interpret mode, f32: within atol 1e-4, the gate of
    tests/test_pallas_kernels.py:76."""
    C = 6
    eeg = rng.randn(int(sr * 2) + 33, C).astype(np.float32)
    cfg = j_pipe.DecoderConfig(sr=sr, n_channels=C, dtype=jnp.float32)
    dummy = j_lda.LDAParams(coef=jnp.zeros((40, 9, 20)), intercept=jnp.zeros((40, 9)),
                            classes=jnp.zeros((40, 9), jnp.int32), valid=jnp.ones((40, 9), bool))
    dec = j_pipe.build_decoder_params(cfg, dummy, np.zeros((40, 9)), np.arange(20))
    nf = len(j_fr.streaming_frame_ends(50, 10, sr, eeg.shape[0] + cfg.prefill))
    x = jnp.asarray(eeg)
    s0 = dec.filt_zi_scale[:, None] * x[0][None, :] + dec.filt_s_const[:, None]
    F_j = np.asarray(j_frontend_logpower(dec.frontend_ops, x, s0, nf, interpret=True))

    loaded = t_params.from_arrays(np.zeros((40, 9, 20)), np.zeros((40, 9)),
                                  np.zeros((40, 9), np.int32), np.ones((40, 9), bool),
                                  np.zeros((40, 9)), np.arange(20), [], dtype=torch.float32)
    tcfg = t_pipe.DecoderConfig(sr=sr, n_channels=C, dtype=torch.float32)
    tdec = t_pipe.build_decoder_params(tcfg, loaded["lda"], loaded["medians"], loaded["select"],
                                       device="cpu")
    xt = torch.as_tensor(eeg)
    before = cuda_frontend.frontend_logpower.launches
    F_t = cuda_frontend.frontend_logpower(tdec.frontend_ops, xt, t_pipe._initial_state(tdec, xt), nf)
    assert cuda_frontend.frontend_logpower.launches == before  # CPU: plain version
    assert F_t.shape == F_j.shape == (nf, C) and F_t.dtype == torch.float32
    np.testing.assert_allclose(F_t.numpy(), F_j, atol=1e-4)


@pytest.mark.parametrize("phase_bug", [True, False])
def test_gl_blocks_plain_matches_pallas(rng, phase_bug):
    """K4's plain version (the wrapper on a CPU tensor) against the JAX
    kernel in interpret mode, f32, as tests/test_pallas_kernels.py:15-24
    runs it: within atol 2e-4."""
    lm = (rng.randn(20, 40) * 0.5 - 1.0).astype(np.float32)
    rand = rng.rand(19, 480).astype(np.float32)
    re_j = np.asarray(gl_blocks_pallas(jnp.asarray(lm), jnp.asarray(rand),
                                       j_gl.make_streaming_gl_ops(dtype=jnp.float32), 8, phase_bug,
                                       tile=8, interpret=True))
    before = cuda_gl.gl_blocks.launches
    re_t = cuda_gl.gl_blocks(torch.as_tensor(lm), torch.as_tensor(rand),
                             _gl_audio_ops(torch.float32), 8, phase_bug)
    assert cuda_gl.gl_blocks.launches == before
    assert re_t.shape == re_j.shape == (19, 480) and re_t.dtype == torch.float32
    np.testing.assert_allclose(re_t.numpy(), re_j, atol=2e-4)


@pytest.mark.parametrize("phase_bug", [True, False])
def test_gl_blocks_plain_matches_jax_f64(rng, phase_bug):
    """float64, K4's plain version against the JAX package's
    streaming_gl_blocks.  The converging estimator: rtol 1e-9.  Under the
    exp(angle) quirk the angle of a near-zero bin is ill-conditioned, so
    another summation order moves a block by ~1e-8 from the first iteration
    on (NUMERICS.md deviation 3): within 1e-7 of the blocks' scale, as
    tests/test_torch_ops.py holds the stage."""
    lm = rng.randn(12, 40) * 0.5 - 1.0
    rand = rng.rand(11, 480)
    re_j = np.asarray(j_gl.streaming_gl_blocks(jnp.asarray(lm), jnp.asarray(rand),
                                               j_gl.make_streaming_gl_ops(dtype=jnp.float64), 8,
                                               phase_bug))
    re_t = cuda_gl.gl_blocks_plain(torch.as_tensor(lm), torch.as_tensor(rand),
                                   _gl_audio_ops(torch.float64), 8, phase_bug).numpy()
    assert re_t.dtype == np.float64
    scale = np.abs(re_j).max()
    if phase_bug:
        np.testing.assert_allclose(re_t, re_j, rtol=0, atol=1e-7 * scale)
    else:
        np.testing.assert_allclose(re_t, re_j, rtol=1e-9, atol=1e-12 * scale)


def test_wrappers_reject_other_devices(rng):
    """A wrapper takes the plain version only for a CPU tensor; a tensor on
    any other device launches its kernel or raises."""
    ops = _gl_audio_ops(torch.float32)
    lm = torch.zeros((3, 40), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_gl.gl_audio(lm, torch.zeros((2, 480), device="meta"), ops, 10.0)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_frontend.frontend_decode_mels(None, torch.zeros((10, 4), device="meta"), None, None,
                                           None, torch.zeros((9, 40)), None, 5)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_gl.gl_blocks(lm, torch.zeros((2, 480), device="meta"), ops)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_frontend.frontend_logpower(None, torch.zeros((10, 4), device="meta"), None, 5)
