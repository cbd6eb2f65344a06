"""Evaluation beyond experiment 1 and the decode CLI's remaining modes: the
port against the JAX package, both in float64 on the CPU, at small sizes
(4 channels, 4-10 words), modelled on ``tests/test_eval.py`` and
``tests/test_evaluate_cli.py``.

* DTW and the energy VAD are numpy copies: the same paths (the backtrack's
  ``argmin`` tie order included), distances within 1e-12, the same masks
  and ``.lab`` text.
* exp3 is the VAD over a decoding run: the same speech amounts and ``.lab``
  files given the same dither stream.
* exp4 runs the JAX package's numpy Haufe transform on the same
  ``params.h5``: the activations and ``all_A`` within rtol 1e-10.
* The figures: ``figure_3``'s statistics equal, both ``figure_4``s write
  their PNG in one workspace, ``extract_trials`` writes byte-identical wavs
  and ``.lab`` files.
* ``cli.evaluate`` runs every step with ``--device cpu`` and its ``.npy``
  outputs match the JAX CLI's on the same session (the unseeded
  ``RandomState()`` streams of both CLIs seeded alike).
* The decode CLI: ``decode_audio_exact`` byte-equal to the JAX package's
  given the same inits; ``--vocoder exact-host`` and ``--profile DIR`` run.
"""

import configparser
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from closed_loop_seeg_speech_synthesis_tpu.cli import evaluate as j_eval_cli
from closed_loop_seeg_speech_synthesis_tpu.eval import dtw as j_dtw
from closed_loop_seeg_speech_synthesis_tpu.eval import exp3 as j_exp3
from closed_loop_seeg_speech_synthesis_tpu.eval import exp4 as j_exp4
from closed_loop_seeg_speech_synthesis_tpu.eval import figures as j_fig
from closed_loop_seeg_speech_synthesis_tpu.eval.vad import EnergyBasedVad as JVad
from closed_loop_seeg_speech_synthesis_tpu.io import loaders as j_loaders
from closed_loop_seeg_speech_synthesis_tpu.ops import host_vocoder as j_hv
from closed_loop_seeg_speech_synthesis_tpu.runtime import params as j_params
from closed_loop_seeg_speech_synthesis_tpu.runtime import trainer as j_trainer

from closed_loop_seeg_speech_synthesis_tpu_torch import utils as t_utils
from closed_loop_seeg_speech_synthesis_tpu_torch.cli import decode as t_decode
from closed_loop_seeg_speech_synthesis_tpu_torch.cli import evaluate as t_eval_cli
from closed_loop_seeg_speech_synthesis_tpu_torch.eval import dtw as t_dtw
from closed_loop_seeg_speech_synthesis_tpu_torch.eval import exp3 as t_exp3
from closed_loop_seeg_speech_synthesis_tpu_torch.eval import exp4 as t_exp4
from closed_loop_seeg_speech_synthesis_tpu_torch.eval import figures as t_fig
from closed_loop_seeg_speech_synthesis_tpu_torch.eval.vad import EnergyBasedVad as TVad
from closed_loop_seeg_speech_synthesis_tpu_torch.io import session as t_session
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import griffinlim as t_gl
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import host_vocoder as t_hv
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params as t_params

EEG_SR, AUDIO_SR, C = 1024, 48000, 4
CH_NAMES = ["LA1", "LA2", "RB1", "RB2"]
VAD = {"vad_energy_threshold": "0.5", "vad_energy_mean_scale": "1",
       "vad_frames_context": "5", "vad_proportion_threshold": "0.6"}


def _write_run(run_dir, rng, words, n_channels=C, start=50.0):
    """A decoding run's artifacts: 16 kHz int16 audio with a voiced stretch
    in each 3 s trial, markers.csv, first_timestamp.npy and sEEG.hdf."""
    import h5py
    from scipy.io.wavfile import write as wavwrite

    os.makedirs(run_dir, exist_ok=True)
    n = 3 * len(words) + 2
    audio = (rng.randn(16000 * n) * 300).astype(np.int16)
    t = np.arange(2 * 16000) / 16000
    for i in range(len(words)):
        s = 16000 * 3 * i + 1600
        audio[s : s + len(t)] += (8000 * np.sin(2 * np.pi * (170 + 20 * i) * t)).astype(np.int16)
    wavwrite(os.path.join(run_dir, "audio.wav"), 16000, audio)
    np.save(os.path.join(run_dir, "first_timestamp.npy"), np.array(start))
    with open(os.path.join(run_dir, "markers.csv"), "w") as f:
        for i, w in enumerate(words):
            f.write(f"w,{start + 3 * i + 0.1},start;{w}\n")
            f.write(f"w,{start + 3 * i + 2.1},end;{w}\n")
    with h5py.File(os.path.join(run_dir, "sEEG.hdf"), "w") as hf:
        hf.create_dataset("sEEG", data=rng.randn(EEG_SR * n, n_channels))
        hf.create_dataset("sEEG_sr", data=EEG_SR, dtype=np.int32)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """storage/tiny: a 10-word, 4-channel word-locked session (speech1.hdf
    with channel names on two shafts), the JAX package's params.h5 and
    training_features.npy, decoding runs ``whisper`` and ``imagine`` and a
    30 s other-task XDF; evaluation.ini runs every step on it."""
    from test_io import write_test_xdf

    rng = np.random.RandomState(9)
    root = tmp_path_factory.mktemp("eval_ws")
    sdir = root / "storage" / "tiny"
    sdir.mkdir(parents=True)
    eeg, audio, words, markers = t_session.make_synthetic_session(10, EEG_SR, AUDIO_SR, C, seed=9)
    j_loaders.save_hdf5(str(sdir / "speech1.hdf"), eeg, EEG_SR, audio, AUDIO_SR,
                        ch_names=CH_NAMES, markers=markers)
    res = j_trainer.train(eeg, audio, EEG_SR, AUDIO_SR, [], nb_feats=14)
    j_params.store_training(str(sdir), res, bad_channels=[])
    _write_run(str(sdir / "whisper"), rng, ["w00", "w01", "zz"])
    _write_run(str(sdir / "imagine"), rng, ["w02", "w01", "w03", "yy"], start=70.0)
    other = t_session.make_synthetic_session(10, EEG_SR, AUDIO_SR, C, seed=21)[0]
    write_test_xdf(str(sdir / "othertask.xdf"), other.astype(np.float32), EEG_SR,
                   (0.05 * rng.randn(30 * 8000)).astype(np.float32), 8000,
                   [(100.5, "experimentStarted"), (129.0, "experimentEnded")], CH_NAMES)

    def ini(name, temp):
        cfg = configparser.ConfigParser()
        cfg["General"] = {"storage_dir": str(root / "storage"), "session": "tiny",
                          "temp_dir": str(root / temp)}
        cfg["Experiment1"] = {"nb_randomization_runs": "1", "griffin_lim_norm": "10"}
        cfg["Experiment2"] = {"griffin_lim_norm": "10", "which": "both",
                              "nb_randomization_runs": "3", "decoding_runs": "whisper,imagine",
                              "other_xdf": "othertask.xdf"}
        cfg["Experiment3"] = {"decoding_runs": "whisper,imagine", **VAD}
        path = root / name
        with open(path, "w") as f:
            cfg.write(f)
        return str(path)

    return {"root": root, "session": str(sdir), "words": words,
            "jax_ini": ini("jax.ini", "jax_out"), "torch_ini": ini("torch.ini", "torch_out")}


def _config3():
    cfg = configparser.ConfigParser()
    cfg["Experiment3"] = {"decoding_runs": "whisper", **VAD}
    return cfg


# ---------------------------------------------------------------- DTW, VAD


@pytest.mark.parametrize("case", ["unequal", "integer ties", "all ties"])
def test_dtw_matches_jax(case):
    """dtw_path / dtw_warping: identical paths (ties broken in the same
    order), distances within 1e-12, identical warped spectrograms; through
    the utils re-export too."""
    rng = np.random.RandomState(4)
    if case == "unequal":
        q, r = rng.randn(37, 5), rng.randn(52, 5)
    elif case == "integer ties":
        q, r = rng.randint(0, 3, (21, 1)).astype(float), rng.randint(0, 3, (26, 1)).astype(float)
    else:
        q, r = np.zeros((10, 2)), np.zeros((13, 2))
    dj, pj = j_dtw.dtw_path(q, r)
    dt, pt = t_dtw.dtw_path(q, r)
    assert pt == pj and pt[0] == (0, 0) and pt[-1] == (len(q) - 1, len(r) - 1)
    assert abs(dt - dj) <= 1e-12
    np.testing.assert_array_equal(t_dtw.dtw_warping(q, r), j_dtw.dtw_warping(q, r))
    np.testing.assert_array_equal(t_utils.dtw_warping(q, r), j_dtw.dtw_warping(q, r))


def test_vad_matches_jax(tmp_path):
    """EnergyBasedVad: the same mask from a wav and from MFCCs, the same
    .lab text."""
    rng = np.random.RandomState(2)
    wav = rng.randn(16000 * 3) * 10
    wav[16000:30000] += rng.randn(14000) * 8000
    kw = dict(vad_energy_threshold=0.5, vad_energy_mean_scale=1)
    j, t = JVad(**kw), TVad(**kw)
    mj, mt = j.from_wav(wav), t.from_wav(wav)
    assert mt.dtype == bool and 0 < mt.sum() < len(mt)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(t.mfccs, j.mfccs)
    mfccs = rng.randn(120, 15) * 2
    np.testing.assert_array_equal(t.from_mfccs(mfccs), j.from_mfccs(mfccs))
    j.convert_vad_to_lab(str(tmp_path / "j.lab"), mj)
    t.convert_vad_to_lab(str(tmp_path / "t.lab"), mt)
    assert (tmp_path / "t.lab").read_text() == (tmp_path / "j.lab").read_text()


# ---------------------------------------------------------------- exp3, exp4


def test_exp3_matches_jax(workspace, tmp_path):
    """Experiment3 with the same dither stream: the same speech amounts and
    .lab; run_experiment3 on the directory and on a DecodingRun from arrays
    writes the same files."""
    run_dir = os.path.join(workspace["session"], "whisper")
    j = j_exp3.Experiment3(_config3(), run_dir, rng=np.random.RandomState(0))
    t = t_exp3.Experiment3(_config3(), run_dir, rng=np.random.RandomState(0))
    aj, at = j.run(), t.run()
    assert at == aj and at[0] > 0
    j.export_lab(str(tmp_path / "j.lab"))
    t.export_lab(str(tmp_path / "t.lab"))
    assert (tmp_path / "t.lab").read_text() == (tmp_path / "j.lab").read_text()

    dr = t.dec_run
    arrays = t_session.DecodingRun.from_arrays(dr.audio, dr.audio_sr, dr.eeg, dr.eeg_sr,
                                               dr.trial_starts_in_sec, dr.words)
    for name, runs in (("files", None), ("arrays", {"whisper": arrays})):
        res = t_exp3.run_experiment3(_config3(), workspace["session"], str(tmp_path / name),
                                     dec_runs=runs, rng=np.random.RandomState(0))
        assert res == {"whisper": aj}
        np.testing.assert_array_equal(np.load(tmp_path / name / "whisper_speech_amount.npy"),
                                      np.array(aj))
        assert (tmp_path / name / "whisper_run.lab").read_text() == (tmp_path / "j.lab").read_text()


def test_exp4_matches_jax(workspace, tmp_path):
    """Experiment4 on the JAX package's params.h5: the activation matrix,
    all_A and the feature activations within rtol 1e-10; the feature names,
    selection mask and shaft spans equal; the model and training features
    given as arrays give the same; both plots are written."""
    sdir = workspace["session"]
    j = j_exp4.Experiment4(sdir, CH_NAMES)
    t = t_exp4.Experiment4(sdir, CH_NAMES)
    assert t_exp4.feature_names(CH_NAMES) == j_exp4.feature_names(CH_NAMES)
    assert t.sel_features == j.sel_features
    mj, Aj, actj = j.compute_activations(return_all=True)
    mt, At, actt = t.compute_activations(return_all=True)
    assert mt.shape == (C, 5) and np.isfinite(mt).all() and (mt != 0).any()
    for got, want in ((mt, mj), (At, Aj), (actt, actj)):
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    np.testing.assert_array_equal(t.selection_mask(), j.selection_mask())
    assert t.shaft_spans() == j.shaft_spans() == [("LA", 0, 2), ("RB", 2, 4)]
    model = t_params.load_params(os.path.join(sdir, "params.h5"), dtype=torch.float64,
                                 device="cpu")
    a = t_exp4.Experiment4(None, CH_NAMES, model=model,
                           training_features=np.load(os.path.join(sdir, "training_features.npy")))
    np.testing.assert_array_equal(a.compute_activations(), mt)
    t.plot(mt, str(tmp_path / "activations.png"))
    t.plot_activation_map(mt, str(tmp_path / "map.png"), exclude_shafts=("RB",))
    assert all(os.path.getsize(tmp_path / f) > 0 for f in ("activations.png", "map.png"))


# ---------------------------------------------------------------- figures


def test_figures_match_jax(workspace, tmp_path):
    """figure_3 on one exp1 output directory: equal per-bin statistics;
    figure_4 of both packages in one workspace writes its PNG;
    extract_trials writes byte-identical wavs and .lab files (the session's
    dither drawn from the same global stream)."""
    rng = np.random.RandomState(6)
    exp1 = tmp_path / "exp1"
    exp1.mkdir()
    orig = rng.randn(900, 40)
    np.save(exp1 / "orig.npy", orig)
    np.save(exp1 / "pm_reco.npy", orig + 0.8 * rng.randn(900, 40))
    for i in (1, 2):
        np.save(exp1 / "rc_reco_i={:03}.npy".format(i), rng.randn(900, 40))
    sj = j_fig.figure_3(str(exp1), str(tmp_path / "j3.png"))
    st = t_fig.figure_3(str(exp1), str(tmp_path / "t3.png"))
    assert len(st) == 40 and [s[0] for s in st] == list(range(40))
    np.testing.assert_array_equal(np.array([s[1:] for s in st], float),
                                  np.array([s[1:] for s in sj], float))

    dest = tmp_path / "dest"
    (dest / "exp2").mkdir(parents=True)
    (dest / "exp3").mkdir()
    for run in ("whisper", "imagine"):
        np.save(dest / "exp2" / f"exp2_{run}_chance.npy", rng.randn(20) * 0.05)
        np.save(dest / "exp2" / f"exp2_{run}_pm.npy", rng.randn(3) * 0.05 + 0.3)
        np.save(dest / "exp3" / f"{run}_speech_amount.npy", np.array([5.0, 0.4]))
    for pkg, name in ((j_fig, "j4.png"), (t_fig, "t4.png")):
        pkg.figure_4(workspace["session"], str(dest), str(tmp_path / name))
        assert os.path.getsize(tmp_path / name) > 0

    out = {}
    for pkg, name in ((j_fig, "j"), (t_fig, "t")):
        temp = tmp_path / name
        np.random.seed(17)
        pkg.extract_wavs_from_session(workspace["session"], str(temp))
        for run in ("whisper", "imagine"):
            run_dir = os.path.join(workspace["session"], run)
            pkg.extract_wavs_from_decoding_trials(run_dir, str(temp))
            pkg.generate_trial_label_file(run_dir, str(temp))
        out[name] = {str(f.relative_to(temp)): f.read_bytes()
                     for f in temp.rglob("*") if f.is_file()}
    assert len(out["t"]) == 10 + 3 + 4 + 2 and out["t"] == out["j"]


# ---------------------------------------------------------------- the CLIs


def _seeded_random_state(monkeypatch):
    """Seed the unseeded ``np.random.RandomState()`` streams the two CLIs'
    experiments draw from (the session's dither, exp2's cuts, exp3's
    dither) alike, for one call."""
    real = np.random.RandomState

    class Seeded(real):
        def __init__(self, seed=None):
            super().__init__(0 if seed is None else seed)

    monkeypatch.setattr(np.random, "RandomState", Seeded)
    return real


def test_evaluate_cli_runs_every_step_like_jax(workspace, monkeypatch):
    """Every step of the port's cli.evaluate with --device cpu; exp2's,
    exp3's and exp4's .npy outputs equal the JAX CLI's on the same session
    (exp2 within atol 1e-9), figure3 returns the JAX function's statistics
    on the port's exp1 outputs, figure4 and extract_trials write what the
    JAX CLI writes."""
    root, ti, ji = workspace["root"], workspace["torch_ini"], workspace["jax_ini"]
    out_t, out_j = root / "torch_out" / "tiny", root / "jax_out" / "tiny"
    (pm_mean, _), (rc_mean, _) = t_eval_cli.main([ti, "exp1", "--device", "cpu"])
    assert np.nanmean(pm_mean) > np.nanmean(rc_mean)
    for step in ("exp2", "exp3"):
        real = _seeded_random_state(monkeypatch)
        t_eval_cli.main([ti, step, "--device", "cpu"])
        j_eval_cli.main([ji, step])
        monkeypatch.setattr(np.random, "RandomState", real)
    for run in ("whisper", "imagine"):
        for kind in ("chance", "pm"):
            got = np.load(out_t / "exp2" / f"exp2_{run}_{kind}.npy")
            want = np.load(out_j / "exp2" / f"exp2_{run}_{kind}.npy")
            assert got.shape == want.shape and len(got) and np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
        np.testing.assert_array_equal(np.load(out_t / "exp3" / f"{run}_speech_amount.npy"),
                                      np.load(out_j / "exp3" / f"{run}_speech_amount.npy"))
        assert ((out_t / "exp3" / f"{run}_run.lab").read_text()
                == (out_j / "exp3" / f"{run}_run.lab").read_text())
    names = root / "channels.txt"
    names.write_text("\n".join(CH_NAMES) + "\n")
    matrix = t_eval_cli.main([ti, "exp4", "--device", "cpu", "--channels_file", str(names)])
    j_eval_cli.main([ji, "exp4", "--channels_file", str(names)])
    np.testing.assert_allclose(np.load(out_t / "exp4" / "activations.npy"),
                               np.load(out_j / "exp4" / "activations.npy"), rtol=1e-10, atol=0)
    np.testing.assert_array_equal(matrix, np.load(out_t / "exp4" / "activations.npy"))
    assert (out_t / "exp4" / "activation_map.png").exists()

    stats = t_eval_cli.main([ti, "figure3", "--device", "cpu"])
    want = j_fig.figure_3(str(out_t / "exp1"), str(root / "j_figure_3.png"))
    np.testing.assert_array_equal(np.array(stats, float), np.array(want, float))
    t_eval_cli.main([ti, "figure4", "--device", "cpu"])
    j_eval_cli.main([ji, "figure4"])
    assert (out_t / "figure_4.png").exists() and (out_j / "figure_4.png").exists()
    for cli, argv in ((t_eval_cli, [ti, "extract_trials", "--device", "cpu"]),
                      (j_eval_cli, [ji, "extract_trials"])):
        np.random.seed(5)
        cli.main(argv)
    for sub in ("train_wavs", "whisper_wavs", "imagine_wavs"):
        names_t = sorted(os.listdir(out_t / sub))
        assert names_t == sorted(os.listdir(out_j / sub)) and names_t
        for n in names_t:
            assert (out_t / sub / n).read_bytes() == (out_j / sub / n).read_bytes(), (sub, n)
    for run in ("whisper", "imagine"):
        assert ((out_t / f"{run}_trials.lab").read_text()
                == (out_j / f"{run}_trials.lab").read_text())


def j_hv_rows(n_blocks):
    """The JAX CLI's exact-host inits: threefry draws of PRNGKey(0), float64."""
    from closed_loop_seeg_speech_synthesis_tpu.ops import griffinlim as j_gl

    return j_gl.default_rand_init(jax.random.PRNGKey(0), n_blocks, 0, jnp.float64)


@pytest.mark.parametrize("phase_bug", [True, False])
def test_decode_audio_exact_byte_equal(phase_bug):
    """decode_audio_exact of the same spectrogram and inits: the same int16
    bytes (the FP-jittered 159/160/161-sample emission grid included)."""
    rng = np.random.RandomState(8)
    spec = rng.randn(230, 40) - 2.0
    rows = rng.rand(229, 480)
    a_t = t_hv.decode_audio_exact(spec, rows, norm_factor=10.0, phase_bug=phase_bug)
    a_j = j_hv.decode_audio_exact(spec, rows, norm_factor=10.0, phase_bug=phase_bug)
    assert a_t.dtype == np.int16 and len(a_t) == 229 * 160
    assert a_t.tobytes() == a_j.tobytes()


@pytest.fixture
def decode_ws(tmp_path):
    """A params.h5, a 3 s replay file and an experiment.ini for the decode
    CLIs."""
    import h5py

    rng = np.random.RandomState(3)
    session = tmp_path / "storage" / "demo"
    session.mkdir(parents=True)
    with h5py.File(session / "params.h5", "w") as hf:
        hf.create_dataset("bad_channels", data=np.zeros(0, np.int64))
        hf.create_dataset("medians_array", data=np.sort(rng.randn(40, 9), axis=1))
        hf.create_dataset("select", data=rng.permutation(5 * C)[:12].astype(np.int64))
        hf.create_dataset("lda_coef", data=rng.randn(40, 9, 12) * 0.3)
        hf.create_dataset("lda_intercept", data=rng.randn(40, 9))
        hf.create_dataset("lda_classes", data=np.tile(np.arange(9, dtype=np.int32), (40, 1)))
        hf.create_dataset("lda_valid", data=np.ones((40, 9), bool))
    seeg_file = tmp_path / "replay.hdf"
    with h5py.File(seeg_file, "w") as hf:
        hf.create_dataset("sEEG", data=rng.randn(3 * EEG_SR, C) * 10.0)
        hf.create_dataset("sEEG_sr", data=EEG_SR, dtype=np.int32)
    cfg = configparser.ConfigParser()
    cfg["General"] = {"storage_dir": str(tmp_path / "storage"), "session": "demo"}
    cfg["Decoding"] = {"stream_name": "x", "griffin_lim_norm": "10", "run": "replay"}
    path = tmp_path / "experiment.ini"
    with open(path, "w") as f:
        cfg.write(f)
    return str(path), str(seeg_file), session


def test_decode_cli_exact_host_vocoder(decode_ws, tmp_path):
    """--vocoder exact-host --device cpu with the JAX CLI's threefry inits
    (--rand_init) writes the JAX CLI's exact-host audio byte for byte and
    the device vocoder's spectrogram; without --rand_init its audio is
    decode_audio_exact of the port's default inits, the same float64
    threefry rows of PRNGKey(0), so the JAX CLI's bytes again."""
    from scipy.io import wavfile

    from closed_loop_seeg_speech_synthesis_tpu.cli import decode as j_decode

    cfg, seeg, session = decode_ws
    run_dev = t_decode.main([cfg, "--seeg_file", seeg, "--run", "dev", "--device", "cpu"])
    spec = np.load(os.path.join(run_dev, "spectrogram.npy"))
    inits = tmp_path / "inits.npy"
    np.save(inits, np.asarray(j_hv_rows(len(spec) - 1)))
    j_run = j_decode.main([cfg, "--seeg_file", seeg, "--run", "jax", "--vocoder", "exact-host"])
    t_run = t_decode.main([cfg, "--seeg_file", seeg, "--run", "exact", "--device", "cpu",
                           "--vocoder", "exact-host", "--rand_init", str(inits)])
    np.testing.assert_array_equal(np.load(os.path.join(t_run, "spectrogram.npy")), spec)
    _, a_t = wavfile.read(os.path.join(t_run, "audio.wav"))
    _, a_j = wavfile.read(os.path.join(j_run, "audio.wav"))
    assert a_t.dtype == np.int16 and a_t.tobytes() == a_j.tobytes()
    t_default = t_decode.main([cfg, "--seeg_file", seeg, "--run", "exact0", "--device", "cpu",
                               "--vocoder", "exact-host"])
    _, a_0 = wavfile.read(os.path.join(t_default, "audio.wav"))
    rows = t_gl.default_rand_init(len(spec) - 1, 0, 0, torch.float64).numpy()
    assert a_0.tobytes() == t_hv.decode_audio_exact(spec, rows, norm_factor=10.0).tobytes()
    assert a_0.tobytes() == a_j.tobytes()


def test_decode_cli_profile_writes_a_trace(decode_ws, tmp_path):
    """--profile DIR --device cpu decodes as without it and writes a Chrome
    trace of the decode into DIR, with the replay's seeg.* spans in it."""
    import json

    cfg, seeg, _ = decode_ws
    prof = tmp_path / "prof"
    run = t_decode.main([cfg, "--seeg_file", seeg, "--run", "p", "--device", "cpu",
                         "--profile", str(prof)])
    plain = t_decode.main([cfg, "--seeg_file", seeg, "--run", "q", "--device", "cpu"])
    np.testing.assert_array_equal(np.load(os.path.join(run, "spectrogram.npy")),
                                  np.load(os.path.join(plain, "spectrogram.npy")))
    with open(prof / "trace.json") as f:
        trace = json.load(f)
    assert len(trace["traceEvents"]) > 0
    spans = {e["name"] for e in trace["traceEvents"] if e.get("cat") == "user_annotation"}
    assert {"seeg.frontend", "seeg.vocode"} <= spans
