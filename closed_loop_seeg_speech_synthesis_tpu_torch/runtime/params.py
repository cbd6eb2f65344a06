"""Load trained decoder parameters (``params.h5``) into the port's types.

Port of ``load_params`` in ``closed_loop_seeg_speech_synthesis_tpu/runtime/params.py``.
``params.h5`` holds bad_channels, medians_array, select, the pickled sklearn
estimator list and, when written by the JAX package, plain-array ``lda_*``
twins of it.  The plain arrays are read when present; the pickled blob only
when they are absent.  h5py is imported inside ``load_params``.

``from_arrays`` is the converter from the JAX package's parameters (as
numpy arrays) to the port's.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

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


def load_params(path: str, dtype=torch.float64, device=None) -> dict:
    """Load a ``params.h5`` (the JAX package's or the reference's)."""
    import h5py

    with h5py.File(path, "r") as hf:
        medians = np.asarray(hf["medians_array"])
        bad = np.asarray(hf["bad_channels"])
        select = np.asarray(hf["select"])
        if "lda_coef" in hf:
            return from_arrays(np.asarray(hf["lda_coef"]), np.asarray(hf["lda_intercept"]),
                               np.asarray(hf["lda_classes"]), np.asarray(hf["lda_valid"]),
                               medians, select, bad, dtype, device)
        # only files this program or the reference trainer wrote are loaded
        estimators = pickle.loads(hf["estimators"][...].tobytes())
    return {"medians": medians, "bad_channels": bad.astype(int), "select": select.astype(int),
            "lda": lda_mod.from_sklearn_estimators(estimators, dtype=dtype, device=device)}
