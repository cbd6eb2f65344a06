"""Trained decoder parameters: store (``params.h5`` and friends) and load.

Port of ``store_training`` and ``load_params`` in
``closed_loop_seeg_speech_synthesis_tpu/runtime/params.py``.  The reference
persists (train.py:171-205):

* ``params.h5`` — bad_channels, medians_array, the pickled sklearn estimator
  list as an ``np.void`` blob, select indices; the JAX package adds
  plain-array ``lda_*`` twins of the blob and ``borders_array``;
* ``LDAs.pkl`` — the pickled estimator list again;
* ``training_features.npy`` — the selected feature matrix (for exp4);
* ``train.ini`` — the merged config used.

``store_training`` writes the same files, so the JAX package's
``load_params`` and this one both read them.  ``load_params`` reads the plain
arrays when present, the pickled blob only when they are absent.  Neither
needs h5py or sklearn: the files go through ``io.hdf5``, the estimator
pickles through ``models.lda.estimators_pickle`` / ``load_estimators`` (a
restricted unpickler).

``from_arrays`` is the converter from the JAX package's parameters (as
numpy arrays) to the port's.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..io import hdf5
from ..models import lda as lda_mod


def from_arrays(lda_coef, lda_intercept, lda_classes, lda_valid, medians, select,
                bad_channels, dtype=torch.float64, device=None) -> dict:
    """The ``load_params`` dict from plain arrays: medians, bad_channels and
    select as numpy arrays, ``lda`` as an LDAParams of tensors."""
    return {
        "medians": np.asarray(medians, np.float64),
        "bad_channels": np.asarray(bad_channels).astype(int),
        "select": np.asarray(select).astype(int),
        "lda": lda_mod.LDAParams(
            coef=torch.as_tensor(np.asarray(lda_coef), dtype=dtype, device=device),
            intercept=torch.as_tensor(np.asarray(lda_intercept), dtype=dtype, device=device),
            classes=torch.as_tensor(np.asarray(lda_classes).astype(np.int32), device=device),
            valid=torch.as_tensor(np.asarray(lda_valid).astype(bool), device=device)),
    }


def store_training(session_dir: str, result, bad_channels, config=None) -> str:
    """Persist a runtime.trainer.TrainResult to the reference layout; returns
    the path of ``params.h5``."""
    os.makedirs(session_dir, exist_ok=True)
    estimators = lda_mod.estimators_pickle(result.lda)

    with open(os.path.join(session_dir, "LDAs.pkl"), "wb") as f:
        f.write(estimators)

    np.save(os.path.join(session_dir, "training_features.npy"), result.x_train)

    lda = result.lda
    path = os.path.join(session_dir, "params.h5")
    with hdf5.File(path, "w") as hf:
        hf.create_dataset("bad_channels", data=np.asarray(bad_channels, np.int64))
        hf.create_dataset("medians_array", data=result.medians)
        hf.create_dataset("estimators", data=np.void(estimators))
        hf.create_dataset("select", data=np.asarray(result.select, np.int64))
        # plain-array twin of the pickled blob, as the JAX package writes it
        hf.create_dataset("lda_coef", data=lda.coef.cpu().numpy().astype(np.float64))
        hf.create_dataset("lda_intercept", data=lda.intercept.cpu().numpy().astype(np.float64))
        hf.create_dataset("lda_classes", data=lda.classes.cpu().numpy())
        hf.create_dataset("lda_valid", data=lda.valid.cpu().numpy())
        hf.create_dataset("borders_array", data=result.borders)

    if config is not None:
        with open(os.path.join(session_dir, "train.ini"), "w") as f:
            config.write(f)
    return path


def load_params(path: str, dtype=torch.float64, device=None) -> dict:
    """Load a ``params.h5`` (the JAX package's or the reference's)."""
    with hdf5.File(path, "r") as hf:
        medians = np.asarray(hf["medians_array"])
        bad = np.asarray(hf["bad_channels"])
        select = np.asarray(hf["select"])
        if "lda_coef" in hf:
            return from_arrays(np.asarray(hf["lda_coef"]), np.asarray(hf["lda_intercept"]),
                               np.asarray(hf["lda_classes"]), np.asarray(hf["lda_valid"]),
                               medians, select, bad, dtype, device)
        estimators = lda_mod.load_estimators(hf["estimators"][...].tobytes())
    return {"medians": medians, "bad_channels": bad.astype(int), "select": select.astype(int),
            "lda": lda_mod.from_sklearn_estimators(estimators, dtype=dtype, device=device)}
