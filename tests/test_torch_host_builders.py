"""The port's numpy copies of the host-side builders produce arrays equal to
the JAX package's, element for element, at 1024 and 2048 Hz."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from closed_loop_seeg_speech_synthesis_tpu.eval import metrics as j_metrics
from closed_loop_seeg_speech_synthesis_tpu.models import lda as j_lda
from closed_loop_seeg_speech_synthesis_tpu.ops import filter_design as j_fd
from closed_loop_seeg_speech_synthesis_tpu.ops import framing as j_fr
from closed_loop_seeg_speech_synthesis_tpu.ops import griffinlim as j_gl
from closed_loop_seeg_speech_synthesis_tpu.ops import iir as j_iir
from closed_loop_seeg_speech_synthesis_tpu.ops import mel as j_mel
from closed_loop_seeg_speech_synthesis_tpu.ops import quantization as j_q
from closed_loop_seeg_speech_synthesis_tpu.ops import smoothing as j_sm
from closed_loop_seeg_speech_synthesis_tpu.ops import stft as j_stft
from closed_loop_seeg_speech_synthesis_tpu.ops.pallas_frontend import epilogue_constants as j_epi
from closed_loop_seeg_speech_synthesis_tpu.runtime import pipeline as j_pipe

from closed_loop_seeg_speech_synthesis_tpu_torch.eval import metrics as t_metrics
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import filter_design as t_fd
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import framing as t_fr
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import griffinlim as t_gl
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import iir as t_iir
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import mel as t_mel
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import quantization as t_q
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import smoothing as t_sm
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import stft as t_stft
from closed_loop_seeg_speech_synthesis_tpu_torch.ops.cuda_frontend import epilogue_constants as t_epi
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params as t_params
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import pipeline as t_pipe

RATES = [1024.0, 2048.0]


def _eq(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("sr", RATES)
def test_schedules_equal(sr):
    assert t_fr.frame_size(50, sr) == j_fr.frame_size(50, sr)
    assert t_fr.warm_start_prefill(50, 10, sr) == j_fr.warm_start_prefill(50, 10, sr)
    _eq(t_fr.exact_frame_ends(50, 10, sr, 777), j_fr.exact_frame_ends(50, 10, sr, 777))
    total = int(sr * 3) + 41
    ends = j_fr.streaming_frame_ends(50, 10, sr, total)
    _eq(t_fr.streaming_frame_ends(50, 10, sr, total), ends)
    _eq(t_fr.shift_table(50, 10, sr), j_fr.shift_table(50, 10, sr))
    win = j_fr.frame_size(50, sr)
    tp, jp = t_fr.periodic_window_matrix(ends, win), j_fr.periodic_window_matrix(ends, win)
    _eq(tp[0], jp[0])
    assert tp[1:] == jp[1:]


@pytest.mark.parametrize("sr", RATES)
def test_filter_chain_equal(sr):
    """SOS design, warm-start constants and the blocked operators at the
    schedule period (the front-end kernel's block)."""
    tc, jc = t_fd.high_gamma_bank(sr), j_fd.high_gamma_bank(sr)
    for a, b in zip(tc, jc):
        _eq(a, b)
    prefill = j_fr.warm_start_prefill(50, 10, sr)
    t_ss, t_warm = t_iir.make_warmstart_chain(tc, prefill)
    j_ss, j_warm = j_iir.make_warmstart_chain(jc, prefill)
    for name in ("A", "B", "C"):
        _eq(getattr(t_ss, name), getattr(j_ss, name))
    assert t_ss.D == j_ss.D
    for name in ("zi_scale", "s_const", "zf_prefix"):
        _eq(getattr(t_warm, name), getattr(j_warm, name))
    L = int(j_fr.shift_table(50, 10, sr).sum())
    t_op = t_iir.make_blocked_iir(t_ss, L, torch.float64)
    j_op = j_iir.make_blocked_iir(j_ss, L, jnp.float64)
    for name in ("Cpow", "Tmat", "Pmat", "A_L", "Apow", "B", "C", "D", "A"):
        _eq(getattr(t_op, name), getattr(j_op, name))


@pytest.mark.parametrize("sr", RATES)
def test_frontend_ops_equal(sr):
    """K1's constants (Tmat/Cpow/Pmat/A_L, S_win, prefix) as the JAX
    package builds them for its fused kernel."""
    C = 4
    lda = j_lda.LDAParams(coef=jnp.zeros((40, 9, 20)), intercept=jnp.zeros((40, 9)),
                          classes=jnp.zeros((40, 9), jnp.int32), valid=jnp.ones((40, 9), bool))
    j_dec = j_pipe.build_decoder_params(j_pipe.DecoderConfig(sr=sr, n_channels=C, dtype=jnp.float64),
                                        lda, np.zeros((40, 9)), np.arange(20))
    loaded = t_params.from_arrays(np.zeros((40, 9, 20)), np.zeros((40, 9)),
                                  np.zeros((40, 9), np.int32), np.ones((40, 9), bool),
                                  np.zeros((40, 9)), np.arange(20), [])
    t_dec = t_pipe.build_decoder_params(t_pipe.DecoderConfig(sr=sr, n_channels=C, dtype=torch.float64),
                                        loaded["lda"], loaded["medians"], loaded["select"],
                                        device="cpu")
    for name in ("Tmat", "Cpow", "Pmat", "A_L", "S_win", "prefix"):
        _eq(getattr(t_dec.frontend_ops, name), getattr(j_dec.frontend_ops, name))
    for name in ("filt_zi_scale", "filt_s_const", "zf_prefix", "gauss_kernel"):
        _eq(getattr(t_dec, name), getattr(j_dec, name))
    _eq(t_dec.shift_table, j_dec.shift_table)
    # every window of the schedule is one run of `win` ones starting at `starts`
    S = t_dec.frontend_ops.S_win.numpy()
    for i, p in enumerate(t_dec.frontend_ops.starts.numpy()):
        assert S[i, p : p + t_dec.frontend_ops.win].all() and S[i].sum() == t_dec.frontend_ops.win


def test_vocoder_constants_equal():
    """Minv, the RDFT matrices, both Blackman windows and the output
    low-pass blocked at 160 (K2) and 4096 (plain path)."""
    j_ops = j_gl.make_streaming_gl_ops(40, 16000.0, jnp.float64)
    t_ops = t_gl.make_streaming_gl_ops(40, 16000.0, torch.float64)
    for name in ("window", "ola_window", "Minv"):
        _eq(getattr(t_ops, name), getattr(j_ops, name))
    for name in ("F_cos", "F_sin", "I_cos", "I_sin"):
        _eq(getattr(t_ops.rdft, name), getattr(j_ops.rdft, name))
        _eq(getattr(t_stft.make_rdft(256, torch.float32), name),
            getattr(j_stft.make_rdft(256, jnp.float32), name))
    _eq(t_stft.blackman(480), j_stft.blackman(480))
    for a, b in zip(t_mel.mel_matrices(129, 40, 16000.0), j_mel.mel_matrices(129, 40, 16000.0)):
        _eq(a, b)
    sos = t_fd.gl_output_lowpass_sos()
    _eq(sos, j_fd.gl_output_lowpass_sos())
    for block in (160, 4096):
        t_op = t_iir.make_blocked_iir(t_iir.sos_to_statespace(sos), block, torch.float64)
        j_op = j_iir.make_blocked_iir(j_iir.sos_to_statespace(sos), block, jnp.float64)
        for name in ("Cpow", "Tmat", "Pmat", "A_L"):
            _eq(getattr(t_op, name), getattr(j_op, name))


def test_smoothing_tables_equal(rng):
    _eq(t_sm.gaussian_kernel1d(0.5), j_sm.gaussian_kernel1d(0.5))
    _eq(t_sm.reflect_positions(40, 2), j_sm.reflect_positions(40, 2))
    med = np.sort(rng.randn(40, 5), axis=1)
    for a, b in zip(t_sm.exact_smooth_table(med), j_sm.exact_smooth_table(med)):
        _eq(a, b)


def test_epilogue_constants_equal(rng):
    """W5 / bm / med_slot / smoothM for the fused front-end kernel."""
    C, M = 6, 5
    coef_full = rng.randn(40, 9, M * C)
    intercept = rng.randn(40, 9)
    valid = rng.rand(40, 9) > 0.1
    classes = np.tile(np.arange(9, dtype=np.int32), (40, 1))
    medians = np.sort(rng.randn(40, 9), axis=1)
    kern = j_sm.gaussian_kernel1d(0.5)
    j_out = j_epi(jnp.asarray(coef_full), jnp.asarray(intercept), jnp.asarray(valid),
                  jnp.asarray(classes), jnp.asarray(medians), jnp.asarray(kern), C)
    t_out = t_epi(torch.as_tensor(coef_full), torch.as_tensor(intercept), torch.as_tensor(valid),
                  torch.as_tensor(classes), torch.as_tensor(medians), torch.as_tensor(kern), C)
    for a, b in zip(t_out, j_out):
        _eq(a, b)


@pytest.mark.parametrize("sr", RATES)
def test_offline_window_grid_equal(sr):
    """The training grid: window starts and the constant window length."""
    total = int(sr * 7) + 13
    starts = t_fr.offline_window_starts(0.05, 0.01, sr, total)
    _eq(starts, j_fr.offline_window_starts(0.05, 0.01, sr, total))
    assert t_fr.offline_window_len(0.05, sr, starts) == j_fr.offline_window_len(0.05, sr, starts)
    assert t_fr.offline_window_len(0.05, sr) == j_fr.offline_window_len(0.05, sr)


def test_training_spectrogram_constants_equal():
    """The symmetric Hann window of the training spectrogram, its DFT and mel
    matrices at 256 points (16 ms at 16 kHz), and the quantizer's sigmoid
    grids.  XLA evaluates jnp.linspace's formula with a reciprocal multiply
    and fused multiply-adds, so a grid point may differ by up to two ulps
    from the same formula in numpy; the representatives' grid is equal."""
    _eq(t_stft.hann_sym(256), j_stft.hann_sym(256))
    for a, b in zip(t_mel.mel_matrices(129, 40, 16000), j_mel.mel_matrices(129, 40, 16000)):
        _eq(a, b)
    t_b, t_m = t_q.sigmoid_grids(9)
    for ours, theirs in ((t_b, jnp.linspace(-10.0, 10.0, 10)[1:-1]), (t_m, jnp.linspace(-9.5, 9.5, 9))):
        theirs = np.asarray(theirs)
        assert ours.dtype == theirs.dtype == np.float64 and ours.shape == theirs.shape
        assert (np.abs(ours - theirs) <= 2 * np.spacing(np.abs(theirs))).all()
    _eq(t_m, np.asarray(jnp.linspace(-9.5, 9.5, 9)))


def _eq_nan(a, b):
    """_eq with NaN equal to NaN."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    assert np.array_equal(a, b, equal_nan=True)


def test_eval_metrics_equal(rng):
    """eval/metrics: the per-bin Pearson r (NaN for a column that is exactly
    constant in either input, even where rounding leaves its centred
    denominator nonzero), the mean/std summaries, KFold's contiguous splits
    with the first n % k folds one longer, the distribution over 5 blocks
    and the Mann-Whitney U test, element for element."""
    a, b = rng.randn(203, 6), rng.randn(203, 6)
    a[:, 1] = 0.3                   # constant: nonzero centred sum of squares after rounding
    b[:, 4] = b[0, 4]
    b[:, 2] = a[:, 2] * 2.0 + 1.0   # r = 1 up to rounding
    r_t, r_j = t_metrics.pearson_per_bin(a, b), j_metrics.pearson_per_bin(a, b)
    _eq_nan(r_t, r_j)
    assert np.isnan(r_t[[1, 4]]).all() and np.isfinite(r_t[[0, 2, 3, 5]]).all()
    for means in (False, True):
        for x, y in zip(t_metrics.pearson_correlation(a, b, means),
                        j_metrics.pearson_correlation(a, b, means)):
            _eq_nan(np.asarray(x), np.asarray(y))
    for n, k in ((100, 10), (23, 5), (4, 10)):
        for (tr_t, te_t), (tr_j, te_j) in zip(t_metrics.kfold_indices(n, k),
                                              j_metrics.kfold_indices(n, k), strict=True):
            _eq_nan(tr_t, tr_j)
            _eq_nan(te_t, te_j)
    for x, y in zip(t_metrics.extract_corrs_for_distribution(a, b, 5),
                    j_metrics.extract_corrs_for_distribution(a, b, 5)):
        _eq_nan(x, y)
    u_t, u_j = t_metrics.mann_whitney_u(a[:, 0], b[:, 0]), j_metrics.mann_whitney_u(a[:, 0], b[:, 0])
    assert (u_t.statistic, u_t.pvalue) == (u_j.statistic, u_j.pvalue)


@pytest.mark.parametrize("sr", RATES)
def test_host_helpers_equal(sr):
    """hann_periodic (the offline vocoder's window) and sosfilt_zi of every
    section list of the filter chain and of the output low-pass."""
    for n in (256, 800, 801):
        _eq(t_stft.hann_periodic(n), j_stft.hann_periodic(n))
    for t_sos, j_sos in zip(t_fd.high_gamma_bank(sr) + [t_fd.gl_output_lowpass_sos()],
                            j_fd.high_gamma_bank(sr) + [j_fd.gl_output_lowpass_sos()]):
        _eq(t_fd.sosfilt_zi(t_sos), j_fd.sosfilt_zi(j_sos))


@pytest.mark.parametrize("ba", ["lowpass", "unnormalized", "short_b"])
def test_ba_to_statespace_equal(ba):
    """iir.ba_to_statespace ((b, a) -> the lfilter zi layout): the vocoder's
    order-5 low-pass as (b, a), a filter with a[0] != 1 and one with fewer
    b than a coefficients, element for element."""
    import scipy.signal as sig

    b, a = {"lowpass": sig.butter(5, 7900 / 8000),
            "unnormalized": ([0.5, -0.2, 0.1], [2.0, 0.3, -0.4]),
            "short_b": ([0.3], [1.0, -0.5, 0.25, -0.125])}[ba]
    t_ss, j_ss = t_iir.ba_to_statespace(b, a), j_iir.ba_to_statespace(b, a)
    for name in ("A", "B", "C"):
        _eq(getattr(t_ss, name), getattr(j_ss, name))
    assert t_ss.D == j_ss.D and type(t_ss.D) is type(j_ss.D)


def test_dtw_and_vad_equal(rng):
    """eval/dtw and eval/vad: the cost, the path and the warped reference;
    the VAD's MFCCs, mask and the .lab lines, element for element."""
    from closed_loop_seeg_speech_synthesis_tpu.eval import dtw as j_dtw
    from closed_loop_seeg_speech_synthesis_tpu.eval import vad as j_vad
    from closed_loop_seeg_speech_synthesis_tpu_torch.eval import dtw as t_dtw
    from closed_loop_seeg_speech_synthesis_tpu_torch.eval import vad as t_vad

    q, r = rng.randn(23, 40), rng.randn(31, 40)
    (dt, pt), (dj, pj) = t_dtw.dtw_path(q, r), j_dtw.dtw_path(q, r)
    assert dt == dj and pt == pj
    _eq(t_dtw.get_warping_path(*zip(*pt)), j_dtw.get_warping_path(*zip(*pj)))
    _eq(t_dtw.dtw_warping(q, r), j_dtw.dtw_warping(q, r))
    wav = rng.randn(16000) * 50
    wav[4000:9000] += rng.randn(5000) * 6000
    t, j = t_vad.EnergyBasedVad(0.5), j_vad.EnergyBasedVad(0.5)
    _eq(t.from_wav(wav), j.from_wav(wav))
    _eq(t.mfccs, j.mfccs)
