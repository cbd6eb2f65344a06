"""The CUDA kernels against their plain torch versions, on the card.

Imports no jax, so that it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX).  Each test skips where
``torch.cuda.is_available()`` is false.
"""

import numpy as np
import pytest
import torch

from closed_loop_seeg_speech_synthesis_tpu_torch.ops import cuda_frontend, cuda_gl
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import filter_design as fd
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import framing
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import griffinlim as gl
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import iir
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import pipeline


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels build with nvcc for sm_90a)")
    return torch.device("cuda")


@pytest.fixture
def rs():
    return np.random.RandomState(1234)


@pytest.mark.cuda
@pytest.mark.parametrize("sr", [1024.0, 2048.0])
def test_frontend_kernel_matches_plain(rs, cuda_device, sr):
    """f32 kernel vs f32 plain version: >= 99.9% of entries within rtol 1e-5 /
    atol 1e-6 (other summation orders flip rare near-tie labels)."""
    C = 16
    valid = np.ones((40, 9), bool)
    valid[3, :5] = False
    loaded = params.from_arrays(rs.randn(40, 9, 20) * 0.3, rs.randn(40, 9),
                                np.tile(np.arange(9, dtype=np.int32), (40, 1)), valid,
                                np.sort(rs.randn(40, 9), axis=1), rs.permutation(5 * C)[:20], [],
                                dtype=torch.float32, device=cuda_device)
    cfg = pipeline.DecoderConfig(sr=sr, n_channels=C, dtype=torch.float32)
    dec = pipeline.build_decoder_params(cfg, loaded["lda"], loaded["medians"], loaded["select"],
                                        device=cuda_device)
    x = torch.as_tensor(rs.randn(int(sr * 4) + 77, C), dtype=torch.float32, device=cuda_device)
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
def test_gl_audio_kernel_matches_plain(rs, cuda_device, iterations, phase_bug):
    """Without iterations every sample within 1 LSB; with the converging
    (phase_bug=False) estimator >= 99.9% of samples within 1 LSB."""
    B = 203  # not a multiple of the kernel's 8 blocks per CUDA block
    walk = np.cumsum(rs.randn(B + 1, 40) * 0.15, axis=0)
    lm = torch.as_tensor(walk - walk.mean() - 1.0, dtype=torch.float32, device=cuda_device)
    rand = torch.as_tensor(rs.rand(B, 480), dtype=torch.float32, device=cuda_device)
    rand[0, 0] = 0.0  # see test_torch_kernels.test_gl_audio_plain_matches_pallas_f32_no_iterations
    ops = cuda_gl.make_gl_audio_ops(gl.make_streaming_gl_ops(40, 16000.0, torch.float32, cuda_device),
                                    iir.sos_to_statespace(fd.gl_output_lowpass_sos()),
                                    torch.float32, cuda_device)
    before = cuda_gl.gl_audio.launches
    a_k = cuda_gl.gl_audio(lm, rand, ops, 10.0, iterations, phase_bug)
    torch.cuda.synchronize()
    assert cuda_gl.gl_audio.launches == before + 1
    a_p = cuda_gl.gl_audio_plain(lm, rand, ops, 10.0, iterations, phase_bug)
    assert a_k.dtype == torch.int16 and a_k.shape == a_p.shape == (B * 160,)
    off = int(((a_k.long() - a_p.long()).abs() > 1).sum())
    assert off <= (0 if iterations == 0 else 0.001 * B * 160), off
