"""The plain reference against the port's plain route, float64 on the CPU.

The reference imports nothing of the port; here the two meet.  At a small
size the port's float64 decode equals the reference's spectrogram to
rounding and its audio to 1 LSB (int16 truncation of values a rounding
apart), at both rates; the pieces the reference rebuilds (filters, frame
grid, windows, mel bank, threefry inits) match the port's host builders.
"""

import numpy as np
import pytest
import torch

from closed_loop_seeg_speech_synthesis_tpu_torch.ops import framing, mel, stft
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import griffinlim as gl
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params, pipeline
from portbench import inputs, manifest, reference
from portbench.reference import Arith, filters, frontend, threefry, vocoder


def small(name, **over):
    return dict(manifest.config(name), n_channels=8, n_features=24, **over)


@pytest.mark.parametrize("name", ["seeg128_1024hz", "seeg128_2048hz"])
def test_reference_decodes_as_the_port(name):
    cfg = small(name)
    seed = 2**31 + 17
    w = inputs.weights(cfg, seed, "cpu")
    eeg = inputs.session(cfg, int(cfg["sr"]) * 4 + 7, seed, "cpu")
    key = inputs.gl_seed(seed)
    loaded = params.from_arrays(w["coef"], w["intercept"], w["classes"], w["valid"],
                                w["medians"], w["select"], [], dtype=torch.float64, device="cpu")
    pcfg = pipeline.DecoderConfig(sr=float(cfg["sr"]), n_channels=8,
                                  packet_size=int(cfg["packet_size"]), dtype=torch.float64)
    dec = pipeline.build_decoder_params(pcfg, loaded["lda"], loaded["medians"], loaded["select"],
                                        device="cpu")
    spec, audio = pipeline.offline_decode(dec, pcfg, eeg, seed=key)
    ref_mel, ref_audio, margin = reference.decode(eeg, cfg, w, key, torch.float64,
                                                  Arith(torch.float64))
    assert spec.shape == ref_mel.shape and audio.shape == ref_audio.shape
    assert (spec - ref_mel).abs().max() < 1e-12
    assert np.abs(audio.numpy().astype(int) - ref_audio.numpy().astype(int)).max() <= 1
    assert bool((margin > 0).all())


@pytest.mark.parametrize("edges,btype,sr,order", [((70.0, 170.0), "bandpass", 1024.0, 8),
                                                   ((98.0, 102.0), "bandstop", 2048.0, 8),
                                                   ((7900.0,), "lowpass", 16000.0, 5)])
def test_filters_are_scipys_butterworth(edges, btype, sr, order):
    sig = pytest.importorskip("scipy.signal")
    wn = [e / (sr / 2) for e in edges]
    zs, ps, ks = sig.iirfilter(order, wn if len(wn) > 1 else wn[0], btype=btype,
                               ftype="butter", output="zpk")
    z, p, k = filters.butter_zpk(order, edges, btype, sr)
    np.testing.assert_allclose(np.sort_complex(z), np.sort_complex(zs), atol=1e-12)
    np.testing.assert_allclose(np.sort_complex(p), np.sort_complex(ps), atol=1e-12)
    assert k == pytest.approx(ks, rel=1e-12)
    s = filters.butter(order, edges, btype, sr)
    imp = np.zeros(300)
    imp[0] = 1.0
    y = filters.Blocked(s, 64, 2, Arith(torch.float64), "cpu")(
        torch.as_tensor(imp)[:, None], torch.zeros((s.dim, 1), dtype=torch.float64))[:, 0]
    np.testing.assert_allclose(y.numpy(), sig.sosfilt(sig.zpk2sos(zs, ps, ks), imp), atol=1e-13)


def test_rebuilt_constants_match_the_ports():
    assert np.array_equal(vocoder.blackman(256), stft.blackman(256))
    assert np.array_equal(vocoder.blackman(480), stft.blackman(480))
    assert np.array_equal(vocoder.mel_inverse(40, 129, 16000.0), mel.mel_matrices(129, 40, 16000.0)[1])
    for sr in (1024, 2048):
        cfg = dict(sr=sr, frame_len_ms=50.0, frame_shift_ms=10.0)
        assert np.array_equal(frontend.frame_ends(cfg, 54321),
                              framing.streaming_frame_ends(50.0, 10.0, sr, 54321 + frontend.prefill(cfg)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_threefry_inits_are_the_ports(dtype):
    for seed in (0, 2**31 + 5, 2**40 + 3):
        assert torch.equal(threefry.block_inits(seed, 5, 6, 480, dtype, "cpu"),
                           gl.default_rand_init(6, 5, seed, dtype))


def test_tf32_rounding():
    from portbench.reference.arith import to_tf32

    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-10 - 2**-12, 3.0e-5])
    y = to_tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0 and y[2] == 1.0 + 2**-9 and y[3] == -1.0 - 2**-10
    assert abs(float(y[4]) / 3.0e-5 - 1) < 2**-11
