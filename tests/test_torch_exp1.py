"""Experiment 1 (10-fold retrain+decode and the chance level): the port
against the JAX package, both in float64 on the CPU, on a 4-word, 4-channel
word-locked session at 1024 Hz with 48 kHz audio (examples/demo.py's maker)
and 2 folds.

Tolerances: float stages differ between XLA's CPU and torch by ulps in
their matmuls, exp and log (tests/test_torch_train.py), so spectrograms,
medians and correlations are held to relative tolerances; labels, shifts,
selected feature sets and staged arrays must be equal.  A decoded mel entry
is a median picked by an argmax over LDA scores: where two class scores tie
to within the ulps above, the two packages may pick different medians, so
per-entry agreement is counted (>= 99.9%) where a whole decode is compared
through the LDA.  Audio: within 1 int16 LSB (docs/NUMERICS.md).  The JAX
runners select features with ``jax.lax.top_k`` and the port with
``torch.topk``, whose order among exact ties may differ; the selected sets
are compared, and no selection here has a tie.
"""

import configparser
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.io import wavfile

from closed_loop_seeg_speech_synthesis_tpu.eval import exp1 as j_exp1
from closed_loop_seeg_speech_synthesis_tpu.eval import exp1_batched as j_batched
from closed_loop_seeg_speech_synthesis_tpu.io import session as j_session
from closed_loop_seeg_speech_synthesis_tpu.models import selection as j_sel
from closed_loop_seeg_speech_synthesis_tpu.ops import griffinlim as j_gl
from closed_loop_seeg_speech_synthesis_tpu.runtime import trainer as j_trainer

from closed_loop_seeg_speech_synthesis_tpu_torch.cli import evaluate as t_eval_cli
from closed_loop_seeg_speech_synthesis_tpu_torch.eval import exp1 as t_exp1
from closed_loop_seeg_speech_synthesis_tpu_torch.eval import exp1_batched as t_batched
from closed_loop_seeg_speech_synthesis_tpu_torch.io import loaders as t_loaders
from closed_loop_seeg_speech_synthesis_tpu_torch.io import session as t_session
from closed_loop_seeg_speech_synthesis_tpu_torch.models import selection as t_sel
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import trainer as t_trainer

EEG_SR, AUDIO_SR, N_WORDS, C, BAD = 1024, 48000, 4, 4, [2]
NB_FEATS = 10
SPEC_RTOL, SPEC_ATOL, AGREE_MIN = 1e-9, 1e-12, 0.999


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """Session directory with speech1.hdf and a params.h5 naming one bad
    channel, and its arrays."""
    root = tmp_path_factory.mktemp("exp1_sess")
    eeg, audio, words, markers = t_session.make_synthetic_session(N_WORDS, EEG_SR, AUDIO_SR, C,
                                                                  seed=3)
    t_loaders.save_hdf5(str(root / "speech1.hdf"), eeg, EEG_SR, audio, AUDIO_SR,
                        ch_names=[f"LA{i + 1}" for i in range(C)], markers=markers)
    import h5py

    with h5py.File(root / "params.h5", "w") as hf:
        hf.create_dataset("bad_channels", data=np.asarray(BAD, np.int64))
    return str(root), (eeg, audio, words)


def _config():
    cfg = configparser.ConfigParser()
    cfg["Experiment1"] = {"griffin_lim_norm": "10"}
    return cfg


def _pair(session, tmp_path, seed):
    """The JAX and the port's Experiment1 on the session, each with its own
    RandomState(seed), writing to separate directories."""
    sdir, _ = session
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    j = j_exp1.Experiment1(_config(), sdir, str(tmp_path / "j"), rng=np.random.RandomState(seed))
    t = t_exp1.Experiment1(_config(), sdir, str(tmp_path / "t"), rng=np.random.RandomState(seed),
                           device="cpu")
    return j, t


def test_synthetic_session_matches_demo(tmp_path):
    """make_synthetic_session's arrays are examples/demo.py's, bit for bit."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples"))
    import demo

    path = str(tmp_path / "demo.hdf")
    eeg_d, words_d = demo.make_synthetic_session(path, n_words=3, n_channels=6, seed=4)
    eeg, audio, words, markers = t_session.make_synthetic_session(3, 1024, 48000, 6, seed=4)
    _, _, audio_d, _, _, markers_d = t_loaders.load_hdf5(path, return_markers=True)
    np.testing.assert_array_equal(eeg, eeg_d)
    np.testing.assert_array_equal(audio, audio_d)
    assert words == words_d and [list(m) for m in markers_d] == markers


def test_session_from_hdf5_arrays_and_jax(session):
    """Session from the HDF5 file, from arrays, and the JAX Session, each
    with RandomState(11): the same words, trial indices and dithered audio,
    bit for bit; the trial accessors agree; with decimation too."""
    sdir, (eeg, audio, words) = session
    for down in (False, True):
        j = j_session.Session(sdir, downsample_audio=down, rng=np.random.RandomState(11))
        f = t_session.Session(sdir, downsample_audio=down, rng=np.random.RandomState(11))
        a = t_session.Session.from_arrays(eeg, EEG_SR, audio, AUDIO_SR, words,
                                          downsample_audio=down, rng=np.random.RandomState(11))
        for s in (f, a):
            assert s.words == j.words == words
            assert s.word_starts_indices_eeg == j.word_starts_indices_eeg
            assert s.word_starts_indices_audio == j.word_starts_indices_audio
            assert s.audio_sr == j.audio_sr and s.eeg_sr == j.eeg_sr
            np.testing.assert_array_equal(s.audio, j.audio)
            np.testing.assert_array_equal(s.eeg, j.eeg)
            for x, y in zip(s.get_trial_by_word(words[1], True), j.get_trial_by_word(words[1], True)):
                np.testing.assert_array_equal(x, y)


def test_fold_targets_match_jax(session, tmp_path):
    """The fold's labels are equal, medians and target mean within rtol
    1e-10 (the spectrogram's ulps through the quantizer's sigmoid fit)."""
    j, _ = _pair(session, tmp_path, 2)
    _, _, y_train, *_ = j._construct_datasets_for_run(nb_folds=2)[0]
    qj, mj, yj = j_batched.fold_targets(y_train)
    qt, mt, yt = t_batched.fold_targets(y_train)
    np.testing.assert_array_equal(qt, qj)
    assert qt.dtype == np.int32
    np.testing.assert_allclose(mt, mj, rtol=1e-10)
    np.testing.assert_allclose(yt, yj, rtol=1e-10)


def test_construct_datasets_match_jax(session, tmp_path):
    """Staging with randomize=True: the same shifts from the same
    RandomState stream (after the session's dither), so the same shifted
    training sEEG; the same held-out sEEG and audio; the held-out
    spectrogram within rtol 1e-10 / atol 1e-12 (ulps near 0, see
    test_torch_train.test_compute_spectrogram_matches_jax)."""
    j, t = _pair(session, tmp_path, 5)
    for aj, at in zip(j._construct_datasets_for_run(2, randomize=True),
                      t._construct_datasets_for_run(2, randomize=True)):
        assert aj[0] == at[0] and aj[5:7] == at[5:7] and aj[8] == at[8]
        for i in (1, 2, 3):
            np.testing.assert_array_equal(at[i], aj[i])
        np.testing.assert_array_equal(at[7], aj[7])
        np.testing.assert_allclose(at[4], aj[4], rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(j.rng.randint(0, 2**31), t.rng.randint(0, 2**31))


def test_one_chance_run_matches_jax(session, tmp_path):
    """Fold 1 shifted by 777 samples through the chance runners: the same
    selected feature set, the spectrogram within rtol 1e-9 / atol 1e-12 on
    >= 99.9% of entries."""
    j, _ = _pair(session, tmp_path, 2)
    k, x_train, y_train, x_test, _, eeg_sr, audio_sr, bad, norm = \
        j._construct_datasets_for_run(nb_folds=2)[0]
    shift = 777
    runner_j, n_frames = j_batched.make_fold_chance_runner(
        x_train, y_train, x_test, float(eeg_sr), float(audio_sr), np.asarray(bad, int),
        float(norm), nb_feats=NB_FEATS, dtype=jnp.float64)
    reco_j = np.asarray(runner_j(jnp.asarray([shift], jnp.int32), jax.random.PRNGKey(9)))[0]
    runner_t, n_t = t_batched.make_fold_chance_runner(
        x_train, y_train, x_test, eeg_sr, audio_sr, bad, norm, nb_feats=NB_FEATS, device="cpu")
    reco_t = runner_t([shift])[0].numpy()
    assert n_t == n_frames and reco_t.shape == reco_j.shape == (n_frames, 40)
    agree = np.isclose(reco_t, reco_j, rtol=SPEC_RTOL, atol=SPEC_ATOL).mean()
    assert agree >= AGREE_MIN, agree

    # the selection: both packages' features of the shifted signal, rho, top-k
    mask = np.ones(x_train.shape[1], bool)
    mask[bad] = False
    xs = np.roll(np.asarray(x_train, np.float64)[:, mask], -shift, axis=0)
    _, _, y_mean = t_batched.fold_targets(y_train)
    fr = t_batched.FoldRunner(len(xs), len(x_test), int(mask.sum()), eeg_sr, norm, NB_FEATS,
                              device="cpu")
    X_t = fr._train_features(torch.as_tensor(xs))
    n = min(len(X_t), len(y_mean))
    rho_t = t_sel.spearman_vs_target(X_t[:n], torch.as_tensor(y_mean[:n]))
    sel_t = torch.topk(rho_t.abs(), NB_FEATS).indices.numpy()
    X_j = j_trainer.offline_features(xs, eeg_sr)
    rho_j = j_sel.spearman_vs_target(X_j[:n], jnp.asarray(y_mean[:n]))
    sel_j = np.asarray(jax.lax.top_k(jnp.abs(rho_j), NB_FEATS)[1])
    assert set(sel_t.tolist()) == set(sel_j.tolist())
    kept = np.sort(np.abs(rho_t.numpy()))[::-1]
    assert kept[NB_FEATS - 1] > kept[NB_FEATS]  # no tie at the cut


def _jax_fold_inits(args):
    """The JAX batched proposed method's Griffin-Lim inits of each fold:
    fold_in(PRNGKey(0), k) drawn for n_frames - 1 blocks."""
    key = jax.random.PRNGKey(0)
    out = []
    for a in args:
        n_frames = len(j_exp1.pipeline.framing.streaming_frame_ends(
            50.0, 10.0, float(a[5]), a[3].shape[0] + j_exp1.pipeline.framing.warm_start_prefill(
                50.0, 10.0, float(a[5]))))
        out.append(np.asarray(j_gl.default_rand_init(jax.random.fold_in(key, a[0]), n_frames - 1,
                                                     0, jnp.float64)))
    return out


def test_proposed_method_batched_matches_jax(session, tmp_path):
    """proposed_method(batched=True) on 2 folds, the JAX inits passed in:
    pm_reco.npy on >= 99.9% of entries and orig.npy within rtol 1e-9 /
    atol 1e-12, the per-bin correlations within 1e-9, every word's wav
    within 1 LSB."""
    j, t = _pair(session, tmp_path, 6)
    args = j._construct_datasets_for_run(nb_folds=2)
    mean_j, std_j = j.proposed_method(nb_folds=2, args=args)
    mean_t, std_t = t.proposed_method(nb_folds=2, args=args, rand_inits=_jax_fold_inits(args))
    load = lambda d, f: np.load(os.path.join(d, f))
    reco_j, reco_t = load(j.dest_dir, "pm_reco.npy"), load(t.dest_dir, "pm_reco.npy")
    assert reco_t.shape == reco_j.shape
    assert np.isclose(reco_t, reco_j, rtol=SPEC_RTOL, atol=SPEC_ATOL).mean() >= AGREE_MIN
    np.testing.assert_allclose(load(t.dest_dir, "orig.npy"), load(j.dest_dir, "orig.npy"),
                               rtol=SPEC_RTOL, atol=SPEC_ATOL)
    np.testing.assert_allclose(mean_t, mean_j, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(std_t, std_j, rtol=1e-9, atol=1e-9)
    names = sorted(os.listdir(os.path.join(j.dest_dir, "reco_wavs")))
    assert names == sorted(os.listdir(os.path.join(t.dest_dir, "reco_wavs"))) and len(names) == N_WORDS
    for name in names:
        _, wj = wavfile.read(os.path.join(j.dest_dir, "reco_wavs", name))
        _, wt = wavfile.read(os.path.join(t.dest_dir, "reco_wavs", name))
        assert wt.dtype == np.int16 and wt.shape == wj.shape
        assert np.abs(wt.astype(int) - wj.astype(int)).max() <= 1, name


def test_chance_level_batched_matches_jax(session, tmp_path):
    """chance_level_batched, 3 runs x 2 folds from RandomState(3): the
    per-bin means and stds over runs within 1e-9, and the saved runs'
    spectrograms on >= 99.9% of entries."""
    j, t = _pair(session, tmp_path, 3)
    mj, sj = j.chance_level_batched(nb_runs=3, nb_folds=2, batch_size=2, dtype=jnp.float64,
                                    nb_feats=NB_FEATS)
    mt, st = t.chance_level_batched(nb_runs=3, nb_folds=2, batch_size=2, nb_feats=NB_FEATS)
    assert mt.shape == st.shape == (40,)
    np.testing.assert_allclose(mt, mj, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(st, sj, rtol=1e-9, atol=1e-9)
    for i in range(1, 4):
        name = "rc_reco_i={:03}.npy".format(i)
        rj, rt = np.load(os.path.join(j.dest_dir, name)), np.load(os.path.join(t.dest_dir, name))
        assert np.isclose(rt, rj, rtol=SPEC_RTOL, atol=SPEC_ATOL).mean() >= AGREE_MIN


def test_chance_level_checkpoint_resume(session, tmp_path, monkeypatch):
    """As the JAX package's test of the same name: a run that dies after
    its first chunk resumes from the chunk checkpoints and returns exactly
    the clean run's result; finished folds collapse to per-fold files; a
    third call restores everything."""
    def run(ck=None, fail_after=None):
        e = t_exp1.Experiment1(_config(), session[0], str(tmp_path), rng=np.random.RandomState(7),
                               device="cpu")
        if fail_after is not None:
            real_make = t_batched.make_chance_runner
            calls = {"n": 0}

            def flaky_make(*a, **kw):
                runner, n_frames = real_make(*a, **kw)

                def flaky_runner(*ra, **rkw):
                    calls["n"] += 1
                    if calls["n"] > fail_after:
                        raise RuntimeError("simulated worker crash")
                    return runner(*ra, **rkw)

                flaky_runner.fold_runner = runner.fold_runner
                return flaky_runner, n_frames

            monkeypatch.setattr(t_batched, "make_chance_runner", flaky_make)
            try:
                return e.chance_level_batched(nb_runs=4, nb_folds=2, batch_size=2, save=False,
                                              nb_feats=NB_FEATS, checkpoint_dir=ck)
            finally:
                monkeypatch.setattr(t_batched, "make_chance_runner", real_make)
        return e.chance_level_batched(nb_runs=4, nb_folds=2, batch_size=2, save=False,
                                      nb_feats=NB_FEATS, checkpoint_dir=ck)

    clean_means, clean_stds = run()
    ck = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="simulated worker crash"):
        run(ck=ck, fail_after=1)
    assert any(f.startswith("chance_fold_00_c") for f in os.listdir(ck))
    means, stds = run(ck=ck)
    np.testing.assert_array_equal(means, clean_means)
    np.testing.assert_array_equal(stds, clean_stds)
    names = os.listdir(ck)
    assert sorted(n for n in names if "_c" not in n) == ["chance_fold_00_r4.npy",
                                                         "chance_fold_01_r4.npy"]
    assert not any("_c0" in n for n in names)
    means3, _ = run(ck=ck)
    np.testing.assert_array_equal(means3, clean_means)


def test_train_nb_feats_matches_jax(session):
    """trainer.train(nb_feats=10): the same 10 features in the same order,
    the same labels, the LDA within rtol 1e-8."""
    _, (eeg, audio, _) = session
    r_j = j_trainer.train(eeg, audio, EEG_SR, AUDIO_SR, BAD, nb_feats=NB_FEATS)
    r_t = t_trainer.train(eeg, audio, EEG_SR, AUDIO_SR, BAD, nb_feats=NB_FEATS, device="cpu")
    assert r_t.select.shape == (NB_FEATS,) and r_t.x_train.shape[1] == NB_FEATS
    np.testing.assert_array_equal(r_t.select, np.asarray(r_j.select))
    np.testing.assert_array_equal(r_t.y_train, r_j.y_train)
    np.testing.assert_allclose(r_t.lda.coef.numpy(), np.asarray(r_j.lda.coef), rtol=1e-8, atol=1e-10)


def test_evaluate_cli_exp1_on_the_cpu(tmp_path, capsys):
    """cli.evaluate exp1 --device cpu on a 10-word session (exp1 takes 10
    folds) with one chance run: pm_reco.npy, orig.npy, the words' wavs and
    the chance run's spectrogram written, the proposed method above chance;
    a step the CLI does not have is rejected with a usage error naming the
    steps (every other step: tests/test_torch_eval.py)."""
    import h5py

    eeg, audio, _, markers = t_session.make_synthetic_session(10, EEG_SR, AUDIO_SR, C, seed=8)
    sdir = tmp_path / "storage" / "ten"
    sdir.mkdir(parents=True)
    t_loaders.save_hdf5(str(sdir / "speech1.hdf"), eeg, EEG_SR, audio, AUDIO_SR, markers=markers)
    with h5py.File(sdir / "params.h5", "w") as hf:
        hf.create_dataset("bad_channels", data=np.zeros(0, np.int64))
    cfg = configparser.ConfigParser()
    cfg["General"] = {"storage_dir": str(tmp_path / "storage"), "session": "ten",
                      "temp_dir": str(tmp_path / "out")}
    cfg["Experiment1"] = {"nb_randomization_runs": "1", "griffin_lim_norm": "10"}
    path = tmp_path / "evaluation.ini"
    with open(path, "w") as f:
        cfg.write(f)
    (pm_mean, _), (rc_mean, _) = t_eval_cli.main([str(path), "exp1", "--device", "cpu"])
    out = tmp_path / "out" / "ten" / "exp1"
    assert (out / "pm_reco.npy").exists() and (out / "orig.npy").exists()
    assert (out / "rc_reco_i=001.npy").exists() and len(os.listdir(out / "reco_wavs")) == 10
    assert pm_mean.shape == rc_mean.shape == (40,)
    assert np.nanmean(pm_mean) > np.nanmean(rc_mean)
    with pytest.raises(SystemExit) as exc:
        t_eval_cli.main([str(path), "exp5", "--device", "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "invalid choice: 'exp5'" in err and all(step in err for step in t_eval_cli.STEPS)
