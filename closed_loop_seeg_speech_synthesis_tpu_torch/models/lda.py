"""Per-bin Linear Discriminant Analysis, predict half (torch).

Port of ``LDAParams``, ``predict``, ``decision_scores`` and
``from_sklearn_estimators`` of ``closed_loop_seeg_speech_synthesis_tpu/models/lda.py``.
The reference predicts one of 9 quantization classes per mel bin per frame
with 40 sklearn ``LinearDiscriminantAnalysis`` models
(``livenodes/LDASynthesis.py:19-28``); here all bins are one
``(T, d) @ (d, 40*9)`` product, with absent class slots masked to -inf.
Fitting waits for the training slice of the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class LDAParams:
    """Batched per-bin LDA decision functions.

    coef:       (n_bins, n_classes_max, n_features)
    intercept:  (n_bins, n_classes_max)
    classes:    (n_bins, n_classes_max) int32 — original label per slot
    valid:      (n_bins, n_classes_max) bool — slot holds a present class
    """

    coef: torch.Tensor
    intercept: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor

    @property
    def n_bins(self) -> int:
        return self.coef.shape[0]

    def to(self, dtype=None, device=None) -> "LDAParams":
        """Floating fields cast to ``dtype``; every field moved to ``device``."""
        return LDAParams(coef=self.coef.to(device=device, dtype=dtype),
                         intercept=self.intercept.to(device=device, dtype=dtype),
                         classes=self.classes.to(device=device),
                         valid=self.valid.to(device=device))


def decision_scores(params: LDAParams, X: torch.Tensor) -> torch.Tensor:
    """Raw decision-function scores (T, n_bins, n_classes_max), -inf masked."""
    scores = torch.einsum("td,bkd->tbk", X, params.coef) + params.intercept[None]
    return torch.where(params.valid[None], scores, torch.full_like(scores, -torch.inf))


def predict(params: LDAParams, X: torch.Tensor) -> torch.Tensor:
    """X: (T, d) -> predicted original class labels (T, n_bins) int32.
    Ties go to the first slot, as ``jnp.argmax``."""
    idx = torch.argmax(decision_scores(params, X), dim=-1)  # (T, n_bins)
    classes = params.classes.expand((X.shape[0],) + tuple(params.classes.shape))
    return torch.gather(classes, 2, idx[:, :, None])[:, :, 0].to(torch.int32)


def from_sklearn_estimators(estimators, n_classes_max: int = 9, dtype=torch.float64,
                            device=None) -> LDAParams:
    """Batched params from unpickled sklearn estimators (decode.py:298-306)."""
    n_bins = len(estimators)
    d = estimators[0].coef_.shape[-1]
    coef = np.zeros((n_bins, n_classes_max, d))
    intercept = np.zeros((n_bins, n_classes_max))
    classes = np.zeros((n_bins, n_classes_max), np.int32)
    valid = np.zeros((n_bins, n_classes_max), bool)
    for b, est in enumerate(estimators):
        cls = np.asarray(est.classes_).astype(np.int32)
        k = len(cls)
        classes[b, :k] = cls
        valid[b, :k] = True
        if k == 2 and est.coef_.shape[0] == 1:
            coef[b, 1] = est.coef_[0]
            intercept[b, 1] = est.intercept_[0]
        else:
            coef[b, :k] = est.coef_
            intercept[b, :k] = est.intercept_
    return LDAParams(coef=torch.as_tensor(coef, dtype=dtype, device=device),
                     intercept=torch.as_tensor(intercept, dtype=dtype, device=device),
                     classes=torch.as_tensor(classes, device=device),
                     valid=torch.as_tensor(valid, device=device))
