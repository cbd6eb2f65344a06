"""The port's torch stages and LDA/params loading against the JAX package's,
stage by stage, in float64 on the CPU."""

import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from closed_loop_seeg_speech_synthesis_tpu.models import lda as j_lda
from closed_loop_seeg_speech_synthesis_tpu.ops import filter_design as j_fd
from closed_loop_seeg_speech_synthesis_tpu.ops import framing as j_fr
from closed_loop_seeg_speech_synthesis_tpu.ops import griffinlim as j_gl
from closed_loop_seeg_speech_synthesis_tpu.ops import iir as j_iir
from closed_loop_seeg_speech_synthesis_tpu.ops import mel as j_mel
from closed_loop_seeg_speech_synthesis_tpu.ops import smoothing as j_sm
from closed_loop_seeg_speech_synthesis_tpu.runtime import params as j_params

from closed_loop_seeg_speech_synthesis_tpu_torch.models import lda as t_lda
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import framing as t_fr
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import griffinlim as t_gl
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import iir as t_iir
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import mel as t_mel
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import smoothing as t_sm
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params as t_params

T = torch.as_tensor


def _lda(rng, n_feats=12):
    valid = np.ones((40, 9), bool)
    valid[4, 2:] = False
    valid[9, 0] = False
    arrs = (rng.randn(40, 9, n_feats), rng.randn(40, 9),
            np.tile(np.arange(9, dtype=np.int32), (40, 1)) * 2 + 1, valid)
    j = j_lda.LDAParams(*(jnp.asarray(a) for a in arrs))
    t = t_lda.LDAParams(*(T(a) for a in arrs))
    return j, t


def test_lda_predict_and_scores_match_jax(rng):
    j, t = _lda(rng)
    X = rng.randn(200, 12)
    np.testing.assert_array_equal(t_lda.predict(t, T(X)).numpy(), np.asarray(j_lda.predict(j, jnp.asarray(X))))
    # another summation order: scores agree to f64 rounding, -inf where masked
    np.testing.assert_allclose(t_lda.decision_scores(t, T(X)).numpy(),
                               np.asarray(j_lda.decision_scores(j, jnp.asarray(X))),
                               rtol=1e-12, atol=1e-14)


def test_from_sklearn_estimators_matches_jax(rng):
    """Round trip through the JAX package's sklearn export, including a bin
    with two classes (sklearn's single-row binary convention)."""
    j, _ = _lda(rng)
    valid = np.asarray(j.valid).copy()
    valid[20, 2:] = False
    j = j_lda.LDAParams(j.coef, j.intercept, j.classes, jnp.asarray(valid))
    ests = j_lda.to_sklearn_estimators(j)
    jp = j_lda.from_sklearn_estimators(ests, dtype=jnp.float64)
    tp = t_lda.from_sklearn_estimators(ests, dtype=torch.float64)
    for name in ("coef", "intercept", "classes", "valid"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)))


@pytest.mark.parametrize("plain_arrays", [True, False])
def test_load_params_matches_jax(rng, tmp_path, plain_arrays):
    """params.h5 with the plain lda_* datasets, and with only the pickled
    estimator blob (the reference's layout)."""
    import h5py

    j, _ = _lda(rng)
    path = tmp_path / "params.h5"
    with h5py.File(path, "w") as hf:
        hf.create_dataset("bad_channels", data=np.asarray([1, 5], np.int64))
        hf.create_dataset("medians_array", data=rng.randn(40, 9))
        hf.create_dataset("select", data=np.arange(12, dtype=np.int64))
        hf.create_dataset("estimators", data=np.void(pickle.dumps(j_lda.to_sklearn_estimators(j))))
        if plain_arrays:
            for name in ("coef", "intercept", "classes", "valid"):
                hf.create_dataset(f"lda_{name}", data=np.asarray(getattr(j, name)))
    jl = j_params.load_params(str(path), dtype=jnp.float64)
    tl = t_params.load_params(str(path), dtype=torch.float64)
    for key in ("medians", "bad_channels", "select"):
        np.testing.assert_array_equal(tl[key], jl[key])
    for name in ("coef", "intercept", "classes", "valid"):
        np.testing.assert_array_equal(getattr(tl["lda"], name).numpy(),
                                      np.asarray(getattr(jl["lda"], name)))


def test_smoothing_matches_jax(rng):
    """gaussian_smooth in scipy's pair order, and the exact lattice gather."""
    x = rng.randn(30, 40)
    k = j_sm.gaussian_kernel1d(0.5)
    np.testing.assert_array_equal(t_sm.gaussian_smooth(T(x), T(k)).numpy(),
                                  np.asarray(j_sm.gaussian_smooth(jnp.asarray(x), jnp.asarray(k))))
    med = np.sort(rng.randn(40, 6), axis=1)
    pos, tbl = j_sm.exact_smooth_table(med)
    labels = rng.randint(0, 6, (25, 40)).astype(np.int32)
    np.testing.assert_array_equal(
        t_sm.smooth_by_table(T(labels), T(pos), T(tbl), 6).numpy(),
        np.asarray(j_sm.smooth_by_table(jnp.asarray(labels), jnp.asarray(pos), jnp.asarray(tbl), 6)))


def test_framing_ops_match_jax(rng):
    """Windowed log-power on the gather and the periodic-matmul forms, and
    the zero-padded context stack."""
    sr, win = 1024.0, 51
    x = rng.randn(3000, 3)
    ends = j_fr.streaming_frame_ends(50, 10, sr, len(x))
    F_j = np.asarray(j_fr.windowed_logpower(jnp.asarray(x), jnp.asarray(ends), win))
    F_t = t_fr.windowed_logpower(T(x), T(ends), win).numpy()
    np.testing.assert_allclose(F_t, F_j, rtol=1e-12)
    S, Ls, P, origin = j_fr.periodic_window_matrix(ends, win)
    Fp_t = t_fr.windowed_logpower_periodic(T(x), T(S), Ls, len(ends), origin).numpy()
    np.testing.assert_allclose(Fp_t, F_j, rtol=1e-12)
    np.testing.assert_array_equal(t_fr.stack_context(T(F_j), 4, 5).numpy(),
                                  np.asarray(j_fr.stack_context(jnp.asarray(F_j), 4, 5)))


@pytest.mark.parametrize("phase_bug", [True, False])
def test_griffin_lim_stages_match_jax(rng, phase_bug):
    """from_log_mels (with the NaN/Inf scrub), streaming_gl_blocks,
    overlap_add_stream and to_int16 (truncation toward zero)."""
    ops_j = j_gl.make_streaming_gl_ops(dtype=jnp.float64)
    ops_t = t_gl.make_streaming_gl_ops(dtype=torch.float64)
    lm = rng.randn(13, 40) * 0.5 - 1.0
    lm[3, 7] = 800.0  # exp overflows: the scrub zeroes the non-finite bins
    np.testing.assert_allclose(t_mel.from_log_mels(T(lm), ops_t.Minv).numpy(),
                               np.asarray(j_mel.from_log_mels(jnp.asarray(lm), ops_j.Minv)),
                               rtol=1e-12)
    lm[3, 7] = 0.0
    rand = rng.rand(12, 480)
    re_j = np.asarray(j_gl.streaming_gl_blocks(jnp.asarray(lm), jnp.asarray(rand), ops_j, 3, phase_bug))
    re_t = t_gl.streaming_gl_blocks(T(lm), T(rand), ops_t, 3, phase_bug)
    # exp(angle) amplifies f64 rounding of another summation order (NUMERICS.md
    # deviation 3): after 3 iterations the blocks agree to 1e-7 of their scale
    np.testing.assert_allclose(re_t.numpy(), re_j, rtol=0, atol=1e-7 * np.abs(re_j).max())
    raw_t = t_gl.overlap_add_stream(T(re_j), ops_t).numpy()
    np.testing.assert_allclose(raw_t, np.asarray(j_gl.overlap_add_stream(jnp.asarray(re_j), ops_j)),
                               rtol=1e-13)
    y = np.array([-20.0, -0.3e-4, 0.3e-4, 5.0, 0.0123, -0.0123, 30.0])
    np.testing.assert_array_equal(t_gl.to_int16(T(y), 10.0).numpy(),
                                  np.asarray(j_gl.to_int16(jnp.asarray(y), 10.0)))


def test_default_rand_init_is_seeded_and_uniform():
    """Block inits are the JAX package's threefry draws keyed by
    ``fold_in(PRNGKey(seed), global block index)``, seed 0 by default,
    uniform on [0, 1); the values are checked bit for bit against
    ``jax.random.uniform`` itself, negative ids clamped to block 0."""
    a = t_gl.default_rand_init(50)
    assert a.shape == (50, 480) and a.dtype == torch.float64
    assert torch.equal(a, t_gl.default_rand_init(50, 0, 0))
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0
    assert abs(float(a.mean()) - 0.5) < 0.01
    assert not torch.equal(a, t_gl.default_rand_init(50, 0, 1))

    for seed in (0, 7, 2**32 + 5, -3):
        ids = torch.tensor([0, 3, 181_000, -2])
        f64, f32 = t_gl.block_rand(ids, seed), t_gl.block_rand(ids, seed, torch.float32)
        for i, b in enumerate(ids.tolist()):
            key = jax.random.fold_in(jax.random.PRNGKey(seed), max(b, 0))
            for row, dt in ((f64[i], jnp.float64), (f32[i], jnp.float32)):
                want = np.asarray(jax.random.uniform(key, (480,), dt))
                assert np.array_equal(row.numpy().view(np.uint8), want.view(np.uint8)), (seed, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_default_rand_init_prefix_and_offset(dtype):
    """A block's inits depend on its global index only: any window of blocks
    equals the same rows of a longer draw, as an online decoder drawing a
    few blocks per packet needs."""
    full = t_gl.default_rand_init(400, 0, 3, dtype)
    assert full.dtype == dtype
    for first, n in ((0, 1), (17, 4), (399, 1), (100, 250)):
        assert torch.equal(t_gl.default_rand_init(n, first, 3, dtype), full[first : first + n])
    ids = torch.tensor([5, 5, 0, 399])
    assert torch.equal(t_gl.block_rand(ids, 3, dtype), full[ids])


def test_sliding_sumsq_and_from_mels_match_jax(rng):
    """framing.sliding_sumsq and mel.from_mels (with the NaN/Inf scrub)
    against the JAX ops in float64."""
    x = rng.randn(300, 5)
    np.testing.assert_allclose(t_fr.sliding_sumsq(T(x), 51).numpy(),
                               np.asarray(j_fr.sliding_sumsq(jnp.asarray(x), 51)),
                               rtol=1e-12, atol=0)
    _, Minv = j_mel.mel_matrices(129, 40, 16000.0)
    mels = np.abs(rng.randn(17, 40))
    mels[3, 5] = np.inf
    got = t_mel.from_mels(T(mels), T(Minv)).numpy()
    want = np.asarray(j_mel.from_mels(jnp.asarray(mels), jnp.asarray(Minv)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_offline_griffin_lim_matches_jax(rng, dtype):
    """ops/griffinlim.offline_griffin_lim (the offline evaluation vocoder:
    800-point periodic-Hann frames, the random tail kept, unnormalized ISTFT,
    max-abs scaling) with the same rand_init: int16 within 1 LSB in float64;
    in float32 (the JAX default) 99.9% of samples within 1 LSB."""
    spec = rng.randn(60, 40) - 3.0
    init = rng.rand(2 * 60 * 401)
    got = t_gl.offline_griffin_lim(spec, init, dtype=getattr(torch, dtype))
    want = np.asarray(j_gl.offline_griffin_lim(spec, init, dtype=getattr(jnp, dtype)))
    assert got.dtype == np.int16 and got.shape == want.shape == (60 * 160,)
    d = np.abs(got.astype(int) - want.astype(int))
    if dtype == "float64":
        assert d.max() <= 1
    else:
        assert (d <= 1).mean() >= 0.999, (d <= 1).mean()


def test_iir_scan_matches_jax(rng):
    """ops/iir.iir_scan, the per-sample sequential reference, against the
    JAX ``lax.scan`` in float64: the combined 1024 Hz filter chain on 3
    channels from a random state."""
    chain = j_fd.high_gamma_bank(1024.0)
    ss_j = j_iir.cascade_statespace([j_iir.sos_to_statespace(c) for c in chain])
    ss_t = t_iir.cascade_statespace([t_iir.sos_to_statespace(c) for c in chain])
    x, s0 = rng.randn(97, 3), rng.randn(ss_t.dim, 3)
    yj, sj = j_iir.iir_scan(*(jnp.asarray(m) for m in (ss_j.A, ss_j.B, ss_j.C, ss_j.D)),
                            jnp.asarray(x), jnp.asarray(s0))
    yt, st = t_iir.iir_scan(*(T(m) for m in (ss_t.A, ss_t.B, ss_t.C, ss_t.D)), T(x), T(s0))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", [0, 1, 31, 32, 100])
def test_zero_input_response_matches_jax(rng, n):
    """ops/iir.zero_input_response (n zeros from a state, over blocks of 32)
    against the JAX helper in float64 (the low-pass's poles lie near the
    unit circle: outputs reach ~10, so the tolerance is relative to them)."""
    sos = j_fd.gl_output_lowpass_sos()
    j_op = j_iir.make_blocked_iir(j_iir.sos_to_statespace(sos), 32, jnp.float64)
    t_op = t_iir.make_blocked_iir(t_iir.sos_to_statespace(sos), 32, torch.float64)
    s0 = rng.randn(t_op.dim, 2)
    yj, sj = j_iir.zero_input_response(j_op, jnp.asarray(s0), n)
    yt, st = t_iir.zero_input_response(t_op, T(s0), n)
    assert yt.shape == (n, 2)
    # float64 products in two summation orders: within 1e-12 of the scale
    for got, want in ((yt, yj), (st, sj)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-12 * max(1.0, float(np.abs(want).max(initial=0))))


def test_scale_zi_by_first_sample_matches_jax(rng):
    """ops/iir.scale_zi_by_first_sample (the reference's cold start) against
    the JAX helper in float64, element for element."""
    zi, x0 = rng.randn(16), rng.randn(5)
    np.testing.assert_array_equal(t_iir.scale_zi_by_first_sample(T(zi), T(x0)).numpy(),
                                  np.asarray(j_iir.scale_zi_by_first_sample(jnp.asarray(zi),
                                                                            jnp.asarray(x0))))
