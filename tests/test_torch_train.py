"""The training slice: the port against the JAX package, both in float64 on
the CPU, stage by stage and whole.

The same seeded numpy inputs go through both packages.  Matmuls, exp and
log differ between XLA's CPU and torch by ulps, so float stages are held to
a relative tolerance; integer outputs (labels, feature indices, class
tables) must be equal.  A spectrogram value within 1e-12 of a quantization
border may take the neighbouring label; none of the seeded cases here does.
"""

import configparser
import logging
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.stats import spearmanr
from sklearn.discriminant_analysis import LinearDiscriminantAnalysis

from closed_loop_seeg_speech_synthesis_tpu.cli import decode as j_decode
from closed_loop_seeg_speech_synthesis_tpu.cli import train as j_train_cli
from closed_loop_seeg_speech_synthesis_tpu.io import loaders as j_loaders
from closed_loop_seeg_speech_synthesis_tpu.io import utils as j_utils
from closed_loop_seeg_speech_synthesis_tpu.models import lda as j_lda
from closed_loop_seeg_speech_synthesis_tpu.models import selection as j_sel
from closed_loop_seeg_speech_synthesis_tpu.ops import framing as j_fr
from closed_loop_seeg_speech_synthesis_tpu.ops import griffinlim as j_gl
from closed_loop_seeg_speech_synthesis_tpu.ops import quantization as j_q
from closed_loop_seeg_speech_synthesis_tpu.runtime import params as j_params
from closed_loop_seeg_speech_synthesis_tpu.runtime import trainer as j_trainer

from closed_loop_seeg_speech_synthesis_tpu_torch.cli import decode as t_decode
from closed_loop_seeg_speech_synthesis_tpu_torch.cli import train as t_train_cli
from closed_loop_seeg_speech_synthesis_tpu_torch.io import utils as t_utils
from closed_loop_seeg_speech_synthesis_tpu_torch.models import lda as t_lda
from closed_loop_seeg_speech_synthesis_tpu_torch.models import selection as t_sel
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import quantization as t_q
from closed_loop_seeg_speech_synthesis_tpu_torch.ops.spectrogram import compute_spectrogram as t_spec
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params as t_params
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import trainer as t_trainer

from test_io import write_test_xdf

COEF_RTOL, COEF_ATOL = 1e-8, 1e-10


def _assert_quantizer_close(actual, desired):
    """rtol 1e-13, and atol 1e-13 of the largest magnitude: an entry near
    zero is the difference of two terms of the bin's scale."""
    desired = np.asarray(desired)
    np.testing.assert_allclose(actual, desired, rtol=1e-13, atol=1e-13 * np.abs(desired).max())


def _t(a):
    return torch.as_tensor(np.array(a))


def _session(rs, seconds, C, sr=1024, audio_sr=48000):
    """Word-locked synthetic recording (examples/demo.py): each 3 s trial has
    2 s of a 120 Hz burst on half the channels and a voiced harmonic stack
    in the audio, then 1 s of rest."""
    eeg = rs.randn(seconds * sr, C)
    audio = 0.01 * rs.randn(seconds * audio_sr)
    t_a = np.arange(2 * audio_sr) / audio_sr
    burst = np.sin(2 * np.pi * 120 * np.arange(2 * sr) / sr)
    for i in range(seconds // 3):
        wid = i % 5
        eeg[i * 3 * sr : i * 3 * sr + 2 * sr, : C // 2] += (1.0 + 0.4 * wid) * burst[:, None]
        voiced = sum((0.4 / h) * np.sin(2 * np.pi * h * (150 + 30 * wid) * t_a) for h in range(1, 26))
        audio[i * 3 * audio_sr : i * 3 * audio_sr + 2 * audio_sr] += 0.3 * voiced / np.abs(voiced).max()
    return eeg, audio


def _lda_dataset(rng, n=600, d=20, n_bins=5, k=9, missing_bin=2):
    """tests/test_models.py:12-23: labels correlated with the features, one
    bin with a missing class."""
    X = rng.randn(n, d)
    proj = rng.randn(d, n_bins)
    z = X @ proj + 0.5 * rng.randn(n, n_bins)
    Y = np.zeros((n, n_bins), int)
    for b in range(n_bins):
        qs = np.quantile(z[:, b], np.linspace(0, 1, k + 1)[1:-1])
        Y[:, b] = np.searchsorted(qs, z[:, b])
    Y[Y[:, missing_bin] == 1, missing_bin] = 2
    return X, Y


def _assert_lda_close(t_params_, j_params_):
    np.testing.assert_array_equal(t_params_.classes.numpy(), np.asarray(j_params_.classes))
    np.testing.assert_array_equal(t_params_.valid.numpy(), np.asarray(j_params_.valid))
    np.testing.assert_allclose(t_params_.coef.numpy(), np.asarray(j_params_.coef),
                               rtol=COEF_RTOL, atol=COEF_ATOL)
    np.testing.assert_allclose(t_params_.intercept.numpy(), np.asarray(j_params_.intercept),
                               rtol=COEF_RTOL, atol=COEF_ATOL)


_SPECTROGRAMS = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import torch
from closed_loop_seeg_speech_synthesis_tpu.ops.spectrogram import compute_spectrogram as j_spec
from closed_loop_seeg_speech_synthesis_tpu_torch.ops.spectrogram import compute_spectrogram as t_spec
d, wl = sys.argv[1], float(sys.argv[2])
audio = np.load(d + "/audio.npy")
np.save(d + "/jax.npy", np.asarray(j_spec(jnp.asarray(audio), 16000, wl, 0.01)))
np.save(d + "/torch.npy", t_spec(torch.as_tensor(audio), 16000, wl, 0.01).numpy())
print(torch.get_num_threads())
"""


@pytest.mark.parametrize("window_length", [0.016, 0.05])
def test_compute_spectrogram_matches_jax(rng, tmp_path, window_length):
    """16 kHz audio with a silent stretch (the 1e-7 fuzz before the log).

    rtol 1e-10 and atol 1e-12 on the log-mel values: some lie near 0 (the
    smallest ~4e-5 at the 16 ms window), where the ~1e-15 absolute
    difference between two matmul orders is a relative 3e-12 or more, so
    rtol alone would hold such entries to below f64 resolution.  The largest
    difference seen is 5.8e-15; a bound on any summation order's rounding
    stays within 0.3 of the tolerance.

    Both packages run in a fresh interpreter: in a test worker that had run
    other files first, the 16 ms case once came out up to 3.07e-11 apart on
    178 entries, which no summation order explains, and never did alone.
    A fresh process holds the comparison to the two functions and nothing
    left behind by other tests."""
    import subprocess
    import sys

    audio = rng.randn(16000 * 2) * 0.1
    audio[4000:9000] = 0.0
    np.save(tmp_path / "audio.npy", audio)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _SPECTROGRAMS, str(tmp_path), str(window_length)],
                          cwd=repo, env=dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu"),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    s_j, s_t = np.load(tmp_path / "jax.npy"), np.load(tmp_path / "torch.npy")
    assert s_t.shape == s_j.shape and s_t.dtype == s_j.dtype == np.float64
    # what a failure needs to be told apart from rounding: which frames, how
    # far off the entries the tolerance does not single out, torch's threads
    d = np.abs(s_t - s_j)
    state = (f"frames off: {sorted(set(np.nonzero(d > 1e-12 + 1e-10 * np.abs(s_j))[0].tolist()))}; "
             f"max |diff| where |s| > 1: {d[np.abs(s_j) > 1].max():.3e}; torch threads "
             f"{proc.stdout.strip()}")
    np.testing.assert_allclose(s_t, s_j, rtol=1e-10, atol=1e-12, err_msg=state)


@pytest.mark.parametrize("sr,seconds,C", [(1024, 30, 40), (2048, 5, 8)])
def test_offline_features_matches_jax(rng, sr, seconds, C):
    """The training features: warm-started high-gamma chain, the offline
    window grid, log power, context stacking without zero padding."""
    eeg, _ = _session(rng, seconds, C, sr=sr, audio_sr=16000)
    F_j = np.asarray(j_trainer.offline_features(eeg, sr))
    F_t = t_trainer.offline_features(_t(eeg), sr).numpy()
    assert F_t.shape == F_j.shape == (len(F_j), 5 * C)
    np.testing.assert_allclose(F_t, F_j, rtol=1e-10)


def test_quantization_matches_jax(rng):
    """Borders and medians to 1e-13; labels equal, apart from values
    within 1e-12 of a border; dequantization a lookup; the legacy host
    helpers equal."""
    spec = t_spec(_t(rng.randn(16000 * 3) * 0.1), 16000, 0.016, 0.01)
    spec_np = spec.numpy()
    med_j, bord_j = j_q.compute_borders_logistic(jnp.asarray(spec_np), 9)
    med_t, bord_t = t_q.compute_borders_logistic(spec, 9)
    _assert_quantizer_close(med_t.numpy(), med_j)
    _assert_quantizer_close(bord_t.numpy(), bord_j)
    q_j = np.asarray(j_q.quantize(jnp.asarray(spec_np), bord_j))
    q_t = t_q.quantize(spec, bord_t).numpy()
    assert q_t.dtype == np.float64 and q_t.shape == q_j.shape
    differ = q_t != q_j
    near = (np.abs(spec_np[:, :, None] - np.asarray(bord_j)[None]) <= 1e-12).any(axis=2)
    assert not (differ & ~near).any(), int(differ.sum())
    np.testing.assert_array_equal(t_q.dequantize(_t(q_j), _t(np.asarray(med_j))).numpy(),
                                  np.asarray(j_q.dequantize(jnp.asarray(q_j), med_j)))
    labels = rng.randint(0, 9, (7, 3))
    np.testing.assert_array_equal(t_q.to_categorical(labels, 9), j_q.to_categorical(labels, 9))
    for a, b in zip(t_q.compute_borders_median_cut(spec_np[:500], 9),
                    j_q.compute_borders_median_cut(spec_np[:500], 9)):
        np.testing.assert_array_equal(a, b)


def test_spearman_selection_matches_jax(rng):
    """The zero-column and tie cases of tests/test_models.py:70-86, plus a
    railed (constant, nonzero) column whose NaN rho sorts last, inside the
    selection."""
    n, F = 400, 30
    X = rng.randn(n, F)
    X[:, 7] = 0.0
    X[:, 11] = np.round(X[:, 11] * 2) / 2
    X[:, 19] = 3.0
    Y = rng.randn(n, 4)
    target = Y.mean(axis=1)
    cs_j = np.asarray(j_sel.spearman_vs_target(jnp.asarray(X), jnp.asarray(target)))
    cs_t = t_sel.spearman_vs_target(_t(X), _t(target)).numpy()
    assert np.isnan(cs_t[19]) and np.isnan(cs_j[19]) and cs_t[7] == 0.0
    np.testing.assert_allclose(cs_t, cs_j, rtol=1e-10)
    ok = ~np.isnan(cs_t) & (np.arange(F) != 7)
    ref = np.asarray([spearmanr(X[:, f], target)[0] for f in np.flatnonzero(ok)])
    np.testing.assert_allclose(cs_t[ok], ref, rtol=1e-10, atol=1e-12)
    for nb in (10, 150):
        sel_t = t_sel.select_features(_t(X), _t(Y), nb_feats=nb)
        np.testing.assert_array_equal(sel_t, j_sel.select_features(jnp.asarray(X), jnp.asarray(Y), nb))
    assert 19 in t_sel.select_features(_t(X), _t(Y), nb_feats=10)


def test_lda_fit_matches_jax(rng):
    X, Y = _lda_dataset(rng)
    p_j = j_lda.fit(jnp.asarray(X), Y)
    p_t = t_lda.fit(_t(X), Y)
    _assert_lda_close(p_t, p_j)
    np.testing.assert_array_equal(t_lda.predict(p_t, _t(X)).numpy(),
                                  np.asarray(j_lda.predict(p_j, jnp.asarray(X))))
    assert not p_t.valid[2, 8] and 1 not in t_lda.predict(p_t, _t(X))[:, 2].tolist()


def test_lda_fit_matches_sklearn(rng):
    """As tests/test_models.py::test_lda_matches_sklearn holds the JAX fit."""
    X, Y = _lda_dataset(rng)
    params = t_lda.fit(_t(X), Y)
    pred = t_lda.predict(params, _t(X)).numpy()
    for b in range(Y.shape[1]):
        est = LinearDiscriminantAnalysis().fit(X, Y[:, b])
        np.testing.assert_array_equal(pred[:, b], est.predict(X))
        m = params.valid[b].numpy()
        np.testing.assert_array_equal(params.classes[b].numpy()[m], est.classes_.astype(int))
        np.testing.assert_allclose(params.coef[b].numpy()[m], est.coef_, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(params.intercept[b].numpy()[m], est.intercept_, rtol=1e-5, atol=1e-7)


def test_sklearn_estimators_roundtrip(rng):
    """to_sklearn_estimators -> from_sklearn_estimators predicts the same, and
    so do the sklearn objects, two-class bins included."""
    X, Y = _lda_dataset(rng)
    Y[:, 4] = (Y[:, 4] > 4).astype(int)
    params = t_lda.fit(_t(X), Y)
    ests = t_lda.to_sklearn_estimators(params)
    back = t_lda.from_sklearn_estimators(ests)
    p1 = t_lda.predict(params, _t(X)).numpy()
    np.testing.assert_array_equal(t_lda.predict(back, _t(X)).numpy(), p1)
    for b, est in enumerate(ests):
        np.testing.assert_array_equal(est.predict(X).astype(int), p1[:, b])


@pytest.fixture(scope="module")
def trained():
    """One session (30 s x 40 ch at 1024 Hz, channel 3 bad: 195 stacked
    features, 150 selected) trained by both packages."""
    eeg, audio = _session(np.random.RandomState(7), 30, 40)
    timings = {}
    r_t = t_trainer.train(eeg, audio, 1024, 48000, [3], device="cpu", timings=timings)
    return eeg, j_trainer.train(eeg, audio, 1024, 48000, [3]), r_t, timings


def test_train_matches_jax(trained):
    """Every TrainResult field, and the stage clock's six stages."""
    _, r_j, r_t, timings = trained
    assert list(timings) == ["features", "decimate", "spectrogram", "quantization", "selection",
                             "lda_fit"] and min(timings.values()) >= 0.0
    assert r_t.x_train.shape == r_j.x_train.shape == (len(r_j.x_train), 150)
    np.testing.assert_array_equal(r_t.select, r_j.select)
    np.testing.assert_allclose(r_t.x_train, r_j.x_train, rtol=1e-10)
    np.testing.assert_array_equal(r_t.y_train, r_j.y_train)
    assert r_t.y_train.dtype == r_j.y_train.dtype
    _assert_quantizer_close(r_t.medians, r_j.medians)
    _assert_quantizer_close(r_t.borders, r_j.borders)
    assert r_t.missing == r_j.missing
    _assert_lda_close(r_t.lda, r_j.lda)
    assert r_t.lda.coef.dtype == torch.float64


def _jax_rand_init(n_samples, sr):
    prefill = j_fr.warm_start_prefill(50, 10, sr)
    n = len(j_fr.streaming_frame_ends(50, 10, sr, n_samples + prefill))
    return np.asarray(j_gl.default_rand_init(jax.random.PRNGKey(0), n - 1, 0, jnp.float64))


def test_store_training_loads_in_both_packages(trained, tmp_path):
    """The port's artifacts, read by the JAX package's and the port's
    load_params, decode the session's first 6 s identically (spectrogram
    equal, audio within 1 LSB, as tests/test_torch_pipeline.py holds the
    two decoders)."""
    eeg, _, r_t, _ = trained
    path = t_params.store_training(str(tmp_path), r_t, [3])
    assert all((tmp_path / f).exists() for f in ("params.h5", "LDAs.pkl", "training_features.npy"))
    head = eeg[: 6 * 1024]
    j_loaded = j_params.load_params(path, dtype=jnp.float64)
    spec_j, audio_j, _, _ = j_decode.perform_offline_decoding(j_loaded, head, 1024, 10.0,
                                                              dtype=jnp.float64)
    spec_t, audio_t, _, _ = t_decode.perform_offline_decoding(
        t_params.load_params(path), head, 1024, 10.0, device="cpu",
        rand_init=_jax_rand_init(len(head), 1024))
    assert np.array_equal(spec_t.numpy(), np.asarray(spec_j))
    assert np.abs(audio_t.numpy().astype(int) - np.asarray(audio_j).astype(int)).max() <= 1


@pytest.mark.parametrize("fmt", ["hdf5", "xdf"])
def test_train_cli_matches_jax(tmp_path, fmt):
    """Both CLIs train on the same recording with the same seeded dither and
    write the same params.h5 datasets."""
    import h5py

    sr, audio_sr = 1024, 48000
    eeg, audio = _session(np.random.RandomState(3), 9, 6, sr, audio_sr)
    names = ["LA1", "LA2", "LA3", "LB1", "LB2", "EKG"]
    if fmt == "hdf5":
        rec = str(tmp_path / "speech.hdf")
        j_loaders.save_hdf5(rec, eeg.astype(np.float32), sr, audio.astype(np.float32), audio_sr,
                            ch_names=names)
    else:
        rec = str(tmp_path / "speech.xdf")
        markers = [(100.2, "experimentStarted"), (100.5, "start;w"), (102.5, "end;w"),
                   (108.8, "experimentEnded")]
        write_test_xdf(rec, eeg.astype(np.float32), sr, audio.astype(np.float32), audio_sr,
                       markers, names)
    cfg = configparser.ConfigParser()
    cfg["General"] = {"storage_dir": str(tmp_path / "storage"), "session": "demo"}
    cfg["Training"] = {"file": rec, "power_line": "50", "channels": "L[AB][0-9]*",
                       "overwrite_on_rerun": "True", "draw_plots": str(fmt == "hdf5")}
    cfg_path = str(tmp_path / "experiment.ini")
    with open(cfg_path, "w") as f:
        cfg.write(f)

    np.random.seed(11)
    j_path = j_train_cli.main([cfg_path, "--session", "jax"])
    t_path = t_train_cli.main([cfg_path, "--session", "torch", "--device", "cpu"],
                              rng=np.random.RandomState(11))
    session = os.path.dirname(t_path)
    plots = ("trainset.png", "coeffs.png") if fmt == "hdf5" else ()
    for f in ("params.h5", "LDAs.pkl", "training_features.npy", "train.ini", "train.log") + plots:
        assert os.path.exists(os.path.join(session, f)), f
    with h5py.File(j_path, "r") as hj, h5py.File(t_path, "r") as ht:
        assert set(ht.keys()) == set(hj.keys())
        for name in ("bad_channels", "select", "lda_classes", "lda_valid"):
            np.testing.assert_array_equal(ht[name][()], hj[name][()])
        assert list(ht["bad_channels"][()]) == [5]  # EKG excluded by the regex
        for name in ("medians_array", "borders_array"):
            _assert_quantizer_close(ht[name][()], hj[name][()])
        for name in ("lda_coef", "lda_intercept"):
            np.testing.assert_allclose(ht[name][()], hj[name][()], rtol=COEF_RTOL, atol=COEF_ATOL)


def test_train_cli_dithers_from_numpys_global_seed(tmp_path):
    """With no ``rng=``, the port's train CLI draws its dither from numpy's
    global generator as the JAX CLI does (train.py:99): after the same
    ``np.random.seed`` both write the same params.h5 in float64, and both
    leave the global generator in the same state."""
    import h5py

    sr, audio_sr = 1024, 48000
    eeg, audio = _session(np.random.RandomState(5), 9, 5, sr, audio_sr)
    rec = str(tmp_path / "speech.hdf")
    j_loaders.save_hdf5(rec, eeg.astype(np.float32), sr, audio.astype(np.float32), audio_sr,
                        ch_names=["LA1", "LA2", "LA3", "LB1", "LB2"])
    cfg = configparser.ConfigParser()
    cfg["General"] = {"storage_dir": str(tmp_path / "storage"), "session": "demo"}
    cfg["Training"] = {"file": rec, "power_line": "50", "overwrite_on_rerun": "True",
                       "draw_plots": "False"}
    cfg_path = str(tmp_path / "experiment.ini")
    with open(cfg_path, "w") as f:
        cfg.write(f)

    np.random.seed(23)
    j_path = j_train_cli.main([cfg_path, "--session", "jax"])
    j_state = np.random.get_state()
    np.random.seed(23)
    t_path = t_train_cli.main([cfg_path, "--session", "torch", "--device", "cpu"])
    t_state = np.random.get_state()
    assert t_state[2] == j_state[2] and np.array_equal(t_state[1], j_state[1])
    with h5py.File(j_path, "r") as hj, h5py.File(t_path, "r") as ht:
        assert set(ht.keys()) == set(hj.keys())
        for name in ("bad_channels", "select", "lda_classes", "lda_valid"):
            np.testing.assert_array_equal(ht[name][()], hj[name][()])
        for name in ("medians_array", "borders_array"):
            assert ht[name].dtype == np.float64
            _assert_quantizer_close(ht[name][()], hj[name][()])
        for name in ("lda_coef", "lda_intercept"):
            assert ht[name].dtype == np.float64
            np.testing.assert_allclose(ht[name][()], hj[name][()], rtol=COEF_RTOL, atol=COEF_ATOL)


def test_io_utils_match_jax(rng, capsys, caplog):
    """The host helpers of io.utils: channel regexes, the audio squeeze, the
    wall-clock decorator (returns the value, logs one line) and the stdout
    silencer."""
    names = ["LFP1", "LFP2", "EKG", "M1", "M2"]
    assert t_utils.select_channels(names, ["LFP[0-9]*", "M1"]) == \
        j_utils.select_channels(names, ["LFP[0-9]*", "M1"]) == ["LFP1", "LFP2", "M1"]
    for audio in ((rng.randn(100) * 1000).astype(np.int16), rng.randn(100) * 4e4, rng.rand(100)):
        out = t_utils.squeeze_audio_to_float64(audio)
        assert out.dtype == np.float64
        np.testing.assert_array_equal(out, j_utils.squeeze_audio_to_float64(audio))

    def twice(x):
        return 2 * x

    with caplog.at_level(logging.INFO, logger="io.utils"):
        assert t_utils.benchmark(twice)(21) == 42
    assert t_utils.benchmark(twice).__name__ == "twice"
    assert [r.getMessage().startswith("Finished method [twice] in ") for r in caplog.records] == [True]
    with t_utils.suppress_stdout():
        print("silenced")
    print("shown")
    assert capsys.readouterr().out == "shown\n"
