"""Experiment 2 (DTW correlations of a decoding run against chance): the port
against the JAX package, both in float64 on the CPU, on a 4-word, 4-channel
word-locked session at 1024 Hz with 48 kHz audio (the model trained and
stored by the JAX package), a fabricated decoding run sharing two of its
words, and 30 s of other-task sEEG, as ``tests/test_exp2.py`` builds them;
the other-task sEEG is a second word-locked session (10 words), so that the
chance decodes vary in every bin and score finite.

Tolerance: correlations within atol 1e-9 (the spectrograms differ between
XLA's CPU and torch by ulps, tests/test_torch_train.py); the chance cuts
are the same indices.  When a comparison fails, its message gives the
largest |diff| between the two packages' 0.016 s spectrograms of the
compared audio before DTW and whether the two packages' DTW paths are
identical, which tells a spectrogram fault (ROADMAP Queue 3) from a DTW
fault.
"""

import configparser

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from closed_loop_seeg_speech_synthesis_tpu.eval import dtw as j_dtw
from closed_loop_seeg_speech_synthesis_tpu.eval import exp2 as j_exp2
from closed_loop_seeg_speech_synthesis_tpu.io import loaders as j_loaders
from closed_loop_seeg_speech_synthesis_tpu.ops.spectrogram import compute_spectrogram as j_spec
from closed_loop_seeg_speech_synthesis_tpu.runtime import params as j_params
from closed_loop_seeg_speech_synthesis_tpu.runtime import trainer as j_trainer

from closed_loop_seeg_speech_synthesis_tpu_torch.eval import dtw as t_dtw
from closed_loop_seeg_speech_synthesis_tpu_torch.eval import exp2 as t_exp2
from closed_loop_seeg_speech_synthesis_tpu_torch.io import session as t_session
from closed_loop_seeg_speech_synthesis_tpu_torch.ops.spectrogram import compute_spectrogram as t_spec
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params as t_params
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import pipeline as t_pipe

EEG_SR, AUDIO_SR, N_WORDS, C = 1024, 48000, 4, 4
ATOL = 1e-9
RUNS, BATCH = 3, 2


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """(session dir, run dir, other-task sEEG): speech1.hdf and the JAX
    package's params.h5 / training_features.npy; a decoding run whose trials
    are words w00, w01 (in the session) and zz (not)."""
    import h5py
    from scipy.io.wavfile import write as wavwrite

    rng = np.random.RandomState(13)
    root = tmp_path_factory.mktemp("exp2")
    eeg, audio, words, markers = t_session.make_synthetic_session(N_WORDS, EEG_SR, AUDIO_SR, C,
                                                                  seed=13)
    j_loaders.save_hdf5(str(root / "speech1.hdf"), eeg, EEG_SR, audio, AUDIO_SR, markers=markers)
    res = j_trainer.train(eeg, audio, EEG_SR, AUDIO_SR, [], nb_feats=12)
    j_params.store_training(str(root), res, bad_channels=[])

    run_dir = root / "whisper"
    run_dir.mkdir()
    dec_audio = (rng.randn(16000 * 12) * 2000).astype(np.int16)
    t = np.arange(2 * 16000) / 16000
    for i in range(3):  # a voiced stretch in each trial
        dec_audio[16000 * (3 * i) + 3200 : 16000 * (3 * i) + 3200 + len(t)] += (
            6000 * np.sin(2 * np.pi * (180 + 40 * i) * t)).astype(np.int16)
    wavwrite(str(run_dir / "audio.wav"), 16000, dec_audio)
    np.save(str(run_dir / "first_timestamp.npy"), np.array(50.0))
    with open(run_dir / "markers.csv", "w") as f:
        for i, w in enumerate(["w00", "w01", "zz"]):
            f.write(f"w,{50.0 + 3 * i + 0.2},start;{w}\n")
            f.write(f"w,{50.0 + 3 * i + 2.2},end;{w}\n")
    with h5py.File(run_dir / "sEEG.hdf", "w") as hf:
        hf.create_dataset("sEEG", data=rng.randn(EEG_SR * 12, C))
        hf.create_dataset("sEEG_sr", data=EEG_SR, dtype=np.int32)
    other = t_session.make_synthetic_session(10, EEG_SR, AUDIO_SR, C, seed=21)[0]
    return str(root), str(run_dir), other


def _config():
    cfg = configparser.ConfigParser()
    cfg["Experiment2"] = {"griffin_lim_norm": "10", "which": "both",
                          "nb_randomization_runs": str(RUNS), "decoding_runs": "whisper",
                          "other_xdf": ""}
    return cfg


class _Recording(np.random.RandomState):
    """A RandomState that keeps every ``randint`` it returns (the cuts)."""

    def __init__(self, seed):
        super().__init__(seed)
        self.cuts = []

    def randint(self, *args, **kwargs):
        v = super().randint(*args, **kwargs)
        self.cuts.append(int(v))
        return v


def _pair(workspace, tmp_path, seed):
    """The JAX and the port's Experiment2 on the workspace, each with its own
    recording RandomState(seed) (the session's dither, then the cuts)."""
    sdir, run_dir, other = workspace
    j = j_exp2.Experiment2(_config(), sdir, run_dir, [], str(tmp_path / "j"),
                           rng=_Recording(seed))
    j.other_tasks_eeg = other
    t = t_exp2.Experiment2(_config(), sdir, run_dir, [], str(tmp_path / "t"),
                           rng=_Recording(seed), device="cpu", other_tasks_eeg=other)
    return j, t


def _diagnosis(pairs):
    """The largest |diff| between the two packages' 0.016 s spectrograms of
    the compared audio, and whether each package's DTW of the same pairs
    takes the same path.  pairs: (query, its rate, reference audio, its
    rate); a query without a rate is a decoded spectrogram, used as is."""
    worst, same = 0.0, True

    def spec(a, sr):
        if sr is None:
            return a, a
        return (np.asarray(j_spec(jnp.asarray(a), sr, 0.016, 0.01)),
                t_spec(torch.as_tensor(np.ascontiguousarray(a)), sr, 0.016, 0.01).numpy())

    for qa, qsr, ra, rsr in pairs:
        (qj, qt), (rj, rt) = spec(qa, qsr), spec(ra, rsr)
        worst = max(worst, np.abs(qj - qt).max(), np.abs(rj - rt).max())
        same = same and j_dtw.dtw_path(qj, rj)[1] == t_dtw.dtw_path(qt, rt)[1]
    return (f"largest |diff| of the two packages' 0.016 s spectrograms before DTW "
            f"{worst:.3e}; DTW paths identical: {same}")


def _matched_pairs(t):
    words = sorted(set(t.sess.words) & set(t.dec_run.words))
    return [((t.dec_run.get_trial_by_word(w)[2] / 2**15).astype(float), t.dec_run.audio_sr,
             t.sess.get_trial_by_word(w)[2], t.sess.audio_sr) for w in words]


def _chance_pairs(workspace, tmp_path, seed):
    """The port's decoded logMels of each chance segment (the cuts of
    RandomState(seed)) against its training word's audio."""
    _, t = _pair(workspace, tmp_path / "diagnosis", seed)
    mask, cfg, dec = t._decoder()
    T = 2 * EEG_SR
    pairs = []
    for i in range(RUNS):
        c = t.rng.randint(0, len(t.other_tasks_eeg) - T)
        reco = t_pipe.offline_decode(dec, cfg, t.other_tasks_eeg[c : c + T][:, mask])[0].numpy()
        word_audio = t.sess.get_trial_by_index(i % len(t.sess.words))[2]
        pairs.append((reco, None, word_audio, t.sess.audio_sr))
    return pairs


def _assert_close(got, want, diagnose):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.allclose(got, want, rtol=0, atol=ATOL, equal_nan=True):
        diff = np.abs(got - want).max() if got.shape == want.shape else "shapes differ"
        pytest.fail(f"port {got} vs JAX {want}: max |diff| {diff}; {diagnose()}")


def test_matching_trials_match_jax(workspace, tmp_path):
    """The matched words' DTW correlations (w00 and w01) within atol 1e-9."""
    j, t = _pair(workspace, tmp_path, 1)
    cj, ct = j.matching_trials(), t.matching_trials()
    assert len(ct) == 2 and all(np.isfinite(ct))
    _assert_close(ct, cj, lambda: _diagnosis(_matched_pairs(t)))


@pytest.mark.parametrize("method", ["chance_level", "chance_level_batched"])
def test_chance_level_matches_jax(workspace, tmp_path, method):
    """The sequential twin and the batched chance level: the same cuts from
    the same RandomState stream, the scores within atol 1e-9."""
    j, t = _pair(workspace, tmp_path, 7)
    if method == "chance_level":
        cj, ct = j.chance_level(runs=RUNS), t.chance_level(runs=RUNS)
    else:
        cj = j.chance_level_batched(runs=RUNS, batch_size=BATCH, dtype=jnp.float64)
        ct = t.chance_level_batched(runs=RUNS, batch_size=BATCH)
    assert t.rng.cuts == j.rng.cuts and len(t.rng.cuts) == RUNS
    assert ct.shape == (RUNS,) and np.isfinite(ct).all()
    _assert_close(ct, cj, lambda: _diagnosis(_chance_pairs(workspace, tmp_path, 7)))


def test_batched_chance_level_equals_sequential(workspace, tmp_path):
    """The port's batched chance level (one front-end call per segment, the
    plan built once) gives its sequential twin's scores exactly: the same
    cuts, the same float64 spectrograms."""
    _, t1 = _pair(workspace, tmp_path, 5)
    _, t2 = _pair(workspace, tmp_path, 5)
    timings = {}
    seq = t1.chance_level(runs=RUNS)
    bat = t2.chance_level_batched(runs=RUNS, batch_size=BATCH, timings=timings)
    assert t1.rng.cuts == t2.rng.cuts
    np.testing.assert_array_equal(bat, seq)
    assert set(timings) == {"stage", "decode", "spectrogram", "dtw", "correlation"}


def test_from_arrays_equals_files(workspace, tmp_path):
    """Experiment2 given the session, the decoding run and the model as
    objects and arrays scores as the one that reads the files."""
    sdir, run_dir, other = workspace
    _, t = _pair(workspace, tmp_path, 3)
    rng = np.random.RandomState(3)
    dr = t.dec_run
    sess = t_session.Session(sdir, rng=rng)
    model = t_params.load_params(f"{sdir}/params.h5", dtype=torch.float64, device="cpu")
    a = t_exp2.Experiment2(
        _config(), None, "whisper", [], str(tmp_path / "a"), rng=rng, device="cpu",
        session=sess, other_tasks_eeg=other, model=model,
        dec_run=t_session.DecodingRun.from_arrays(dr.audio, dr.audio_sr, dr.eeg, dr.eeg_sr,
                                                  dr.trial_starts_in_sec, dr.words))
    np.testing.assert_array_equal(a.matching_trials(), t.matching_trials())
    np.testing.assert_array_equal(a.chance_level_batched(runs=2), t.chance_level_batched(runs=2))


def test_run_writes_jax_outputs(workspace, tmp_path):
    """run(): exp2_whisper_chance.npy and exp2_whisper_pm.npy as the JAX
    package writes them."""
    j, t = _pair(workspace, tmp_path, 11)
    j.run(runs=RUNS)
    t.run(runs=RUNS)
    for name in ("exp2_whisper_chance.npy", "exp2_whisper_pm.npy"):
        got, want = np.load(tmp_path / "t" / name), np.load(tmp_path / "j" / name)
        _assert_close(got, want, lambda: _diagnosis(_matched_pairs(t)))
