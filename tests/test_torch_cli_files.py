"""The port's CLIs on files, with h5py, sklearn and jax unimportable, against
the JAX package's CLIs on the same files.

A subprocess whose meta-path finder refuses ``h5py``, ``sklearn``, ``jax``,
``matplotlib`` and the JAX package runs the port's chain on the CPU at a
small size (6 ch, 24 s): ``cli.train`` -> ``cli.decode`` offline (the device
vocoder and ``--vocoder exact-host``) -> ``cli.evaluate exp4``, as on a
machine without those packages (the plots are skipped).  The parent runs the JAX CLIs: training on the same
recording after the same ``np.random.seed`` (params.h5 equal in f64 to the
tolerances of ``test_torch_train.py``), decoding and exp4 on the port's
session (spectrogram bit-equal, device audio within 1 int16 LSB, exact-host
audio byte-equal, activations equal); the port's LDAs.pkl, unpickled under
sklearn, equals the JAX package's ``to_sklearn_estimators`` of the same
model.
"""

import configparser
import os
import pickle
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
from scipy.io import wavfile

from closed_loop_seeg_speech_synthesis_tpu.cli import decode as j_decode
from closed_loop_seeg_speech_synthesis_tpu.cli import evaluate as j_eval_cli
from closed_loop_seeg_speech_synthesis_tpu.cli import train as j_train_cli
from closed_loop_seeg_speech_synthesis_tpu.models import lda as j_lda
from closed_loop_seeg_speech_synthesis_tpu.runtime import params as j_params

from closed_loop_seeg_speech_synthesis_tpu_torch.io import hdf5
from closed_loop_seeg_speech_synthesis_tpu_torch.io import loaders as t_loaders

from test_torch_train import COEF_RTOL, COEF_ATOL, _assert_quantizer_close, _session

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 11

_CHAIN = r"""
import importlib.abc
import sys

BLOCKED = ("h5py", "sklearn", "jax", "jaxlib", "matplotlib",
           "closed_loop_seeg_speech_synthesis_tpu")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is not importable here")
        return None


sys.meta_path.insert(0, Refuse())
import numpy as np
import torch

torch.set_num_threads(2)
from closed_loop_seeg_speech_synthesis_tpu_torch.cli import decode, evaluate, train

cfg, eval_cfg, rec = sys.argv[1:4]
np.random.seed(int(sys.argv[4]))
train.main([cfg, "--session", "torch", "--device", "cpu"])
decode.main([cfg, "--session", "torch", "--seeg_file", rec, "--run", "device", "--device", "cpu"])
decode.main([cfg, "--session", "torch", "--seeg_file", rec, "--run", "host", "--device", "cpu",
             "--vocoder", "exact-host"])
evaluate.main([eval_cfg, "exp4", "--device", "cpu"])
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("CHAIN_OK")
"""


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_files")
    storage = tmp / "storage"
    os.makedirs(storage / "torch")
    rec = str(storage / "torch" / "speech1.hdf")
    eeg, audio = _session(np.random.RandomState(3), 24, 6)
    t_loaders.save_hdf5(rec, eeg.astype(np.float32), 1024, audio.astype(np.float32), 48000,
                        ch_names=["LA1", "LA2", "LA3", "LB1", "LB2", "LB3"])
    cfg = configparser.ConfigParser()
    cfg["General"] = {"storage_dir": str(storage), "session": "torch"}
    cfg["Training"] = {"file": rec, "power_line": "50", "overwrite_on_rerun": "True",
                       "draw_plots": "False"}
    cfg["Decoding"] = {"stream_name": "x", "griffin_lim_norm": "10"}
    cfg_path = str(tmp / "experiment.ini")
    with open(cfg_path, "w") as f:
        cfg.write(f)
    eval_paths = {}
    for who in ("torch", "jax"):
        ecfg = configparser.ConfigParser()
        ecfg["General"] = {"storage_dir": str(storage), "session": "torch",
                           "temp_dir": str(tmp / f"eval_{who}")}
        eval_paths[who] = str(tmp / f"evaluation_{who}.ini")
        with open(eval_paths[who], "w") as f:
            ecfg.write(f)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _CHAIN, cfg_path, eval_paths["torch"], rec,
                           str(SEED)], cwd=str(tmp), env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0 and "CHAIN_OK" in proc.stdout, \
        proc.stdout[-3000:] + proc.stderr[-6000:]

    np.random.seed(SEED)
    j_train_cli.main([cfg_path, "--session", "jax"])
    j_decode.main([cfg_path, "--seeg_file", rec, "--run", "jax_device"])
    j_decode.main([cfg_path, "--seeg_file", rec, "--run", "jax_host", "--vocoder", "exact-host"])
    j_eval_cli.main([eval_paths["jax"], "exp4"])
    return tmp, storage


def test_blocked_chain_trains_like_the_jax_cli(chain):
    """The port's params.h5 (written by the codec, no h5py) against the JAX
    CLI's after the same np.random.seed: equal in f64."""
    _, storage = chain
    with hdf5.File(str(storage / "torch" / "params.h5"), "r") as ht, \
            hdf5.File(str(storage / "jax" / "params.h5"), "r") as hj:
        assert ht.keys() == hj.keys()
        for name in ("bad_channels", "select", "lda_classes", "lda_valid"):
            assert ht[name].dtype == hj[name].dtype
            np.testing.assert_array_equal(ht[name][()], hj[name][()])
        for name in ("medians_array", "borders_array"):
            assert ht[name].dtype == np.float64
            _assert_quantizer_close(ht[name][()], hj[name][()])
        for name in ("lda_coef", "lda_intercept"):
            assert ht[name].dtype == np.float64
            np.testing.assert_allclose(ht[name][()], hj[name][()], rtol=COEF_RTOL, atol=COEF_ATOL)
    for f in ("LDAs.pkl", "training_features.npy", "train.ini", "train.log"):
        assert (storage / "torch" / f).exists(), f


@pytest.mark.parametrize("vocoder", ["device", "host"])
def test_blocked_chain_decodes_like_the_jax_cli(chain, vocoder):
    """Both decode CLIs on the port's session: spectrogram.npy bit-equal,
    audio.wav within 1 LSB (the device vocoder) or byte-equal (exact-host),
    sEEG.hdf equal."""
    _, storage = chain
    run_t, run_j = storage / "torch" / vocoder, storage / "torch" / f"jax_{vocoder}"
    spec_t, spec_j = np.load(run_t / "spectrogram.npy"), np.load(run_j / "spectrogram.npy")
    assert spec_t.dtype == spec_j.dtype == np.float64 and np.array_equal(spec_t, spec_j)
    sr_t, audio_t = wavfile.read(run_t / "audio.wav")
    sr_j, audio_j = wavfile.read(run_j / "audio.wav")
    assert sr_t == sr_j == 16000 and audio_t.shape == audio_j.shape
    diff = np.abs(audio_t.astype(int) - audio_j.astype(int)).max()
    assert diff == 0 if vocoder == "host" else diff <= 1
    with hdf5.File(str(run_t / "sEEG.hdf"), "r") as ht, hdf5.File(str(run_j / "sEEG.hdf")) as hj:
        assert np.array_equal(ht["sEEG"][()], hj["sEEG"][()]) and ht["sEEG_sr"][()] == 1024


def test_blocked_chain_evaluates_like_the_jax_cli(chain):
    """exp4 of both CLIs on the port's session: the same activations."""
    tmp, _ = chain
    act_t = np.load(tmp / "eval_torch" / "torch" / "exp4" / "activations.npy")
    act_j = np.load(tmp / "eval_jax" / "torch" / "exp4" / "activations.npy")
    assert act_t.shape == act_j.shape and np.isfinite(act_t).all()
    np.testing.assert_allclose(act_t, act_j, rtol=1e-10, atol=1e-12 * np.abs(act_j).max())


def test_blocked_chain_pickles_sklearns_estimators(chain):
    """The port's LDAs.pkl (written without sklearn) under sklearn: the
    JAX package's to_sklearn_estimators of the same model, attribute for
    attribute (but _sklearn_version, which unpickling pops), predicting
    alike."""
    _, storage = chain
    with open(storage / "torch" / "LDAs.pkl", "rb") as f:
        ests = pickle.load(f)
    loaded = j_params.load_params(str(storage / "torch" / "params.h5"), dtype=jnp.float64)
    refs = j_lda.to_sklearn_estimators(loaded["lda"])
    X = np.random.RandomState(12).randn(200, ests[0].coef_.shape[1])
    assert len(ests) == len(refs) == 40
    for est, ref in zip(ests, refs):
        assert type(est) is type(ref) and est.__dict__.keys() == ref.__dict__.keys()
        for key, value in ref.__dict__.items():
            if isinstance(value, np.ndarray):
                assert np.array_equal(est.__dict__[key], value) \
                    and est.__dict__[key].dtype == value.dtype, key
            else:
                assert est.__dict__[key] == value, key
        assert np.array_equal(est.predict(X), ref.predict(X))
