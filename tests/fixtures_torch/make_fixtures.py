"""Writes the HDF5 fixtures that the port's tests and ``chip_smoke.py`` read,
with h5py and the JAX package (a machine without either can still read them):

* ``params_jax.h5``: what the JAX package's ``store_training`` writes (the
  ``lda_*`` arrays and the pickled sklearn estimators), trained by the JAX
  package's ``trainer.train`` on a word-locked 4-channel session (channel 3
  bad) with 4 selected features;
* ``params_reference.h5``: the reference trainer's layout of the same model:
  bad_channels, medians_array, the estimators blob and select only;
* ``recording_gzip.hdf``: 2 s of 4-channel sEEG at 1024 Hz (values on a
  1/64 grid, so that they compress), gzip-compressed with the shuffle filter
  in chunks of 600 samples (a ragged last chunk), with ``sEEG_sr`` and
  ``ch_names``.

    python tests/fixtures_torch/make_fixtures.py [OUT_DIR]

(default: this directory).  ``tests/test_torch_hdf5.py`` runs ``make`` into a
temporary directory and holds the committed files' values to its output.
"""

import os
import shutil
import sys
import tempfile

import h5py
import numpy as np

SR, AUDIO_SR, CHANNELS, SECONDS, N_FEATS, BAD = 1024, 48000, 4, 9, 4, [3]
NAMES = ["LA1", "LA2", "LB1", "EKG"]


def _session():
    """Word-locked data: a 120 Hz burst on channels 0-1 and a voiced stack
    in the audio for 2 s of each 3 s trial."""
    rs = np.random.RandomState(0)
    eeg = rs.randn(SECONDS * SR, CHANNELS)
    audio = 0.01 * rs.randn(SECONDS * AUDIO_SR)
    t_a = np.arange(2 * AUDIO_SR) / AUDIO_SR
    burst = np.sin(2 * np.pi * 120 * np.arange(2 * SR) / SR)
    for i in range(SECONDS // 3):
        eeg[i * 3 * SR : i * 3 * SR + 2 * SR, :2] += (1.0 + 0.4 * i) * burst[:, None]
        voiced = sum((0.4 / h) * np.sin(2 * np.pi * h * (150 + 30 * i) * t_a) for h in range(1, 26))
        audio[i * 3 * AUDIO_SR : i * 3 * AUDIO_SR + 2 * AUDIO_SR] += 0.3 * voiced / np.abs(voiced).max()
    return eeg, audio


def make(out_dir):
    import jax

    jax.config.update("jax_enable_x64", True)
    from closed_loop_seeg_speech_synthesis_tpu.runtime import params as j_params
    from closed_loop_seeg_speech_synthesis_tpu.runtime import trainer as j_trainer

    os.makedirs(out_dir, exist_ok=True)
    eeg, audio = _session()
    result = j_trainer.train(eeg, audio, SR, AUDIO_SR, BAD, nb_feats=N_FEATS)
    with tempfile.TemporaryDirectory() as session:
        path = j_params.store_training(session, result, BAD)
        shutil.copyfile(path, os.path.join(out_dir, "params_jax.h5"))
    with h5py.File(os.path.join(out_dir, "params_jax.h5"), "r") as src, \
            h5py.File(os.path.join(out_dir, "params_reference.h5"), "w") as dst:
        for name in ("bad_channels", "medians_array", "estimators", "select"):
            dst.create_dataset(name, data=src[name][()])
    seeg = np.round(np.random.RandomState(1).randn(2 * SR, CHANNELS) * 64) / 64
    with h5py.File(os.path.join(out_dir, "recording_gzip.hdf"), "w") as hf:
        hf.create_dataset("sEEG", data=seeg, chunks=(600, CHANNELS), compression="gzip",
                          shuffle=True)
        hf.create_dataset("sEEG_sr", data=SR, dtype=np.int32)
        hf.create_dataset("ch_names", data=np.asarray([n.encode() for n in NAMES]))


if __name__ == "__main__":
    make(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(os.path.abspath(__file__)))
