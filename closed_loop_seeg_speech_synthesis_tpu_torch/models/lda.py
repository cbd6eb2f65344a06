"""Per-bin Linear Discriminant Analysis, fit and predict (torch).

Port of ``closed_loop_seeg_speech_synthesis_tpu/models/lda.py``.  The
reference fits 40 independent sklearn ``LinearDiscriminantAnalysis()``
models (svd solver), one per mel bin, on the same 150-feature matrix with
different 9-class quantization labels (``train.py:156-166``), and predicts
one class per bin per frame (``livenodes/LDASynthesis.py:19-28``).

* fit: all bins in one batch.  Per-class sums and counts are one-hot
  products; the svd of the scaled within-class scatter comes from the
  (d, d) Gram matrix and a batched ``torch.linalg.eigh`` (eigenvalues
  flipped to descending).  The discriminant uses only
  ``scalings_ @ scalings_.T``, so it is invariant to the eigenvectors'
  signs and basis.  Bins that lose quantization intervals keep static
  9-class padding, with absent slots masked.
* predict: one ``(T, d) @ (d, 40*9)`` product, absent class slots masked to
  -inf, per-bin argmax mapped through each bin's present-class table.
* the reference's estimator pickles (``LDAs.pkl``, the ``estimators`` blob of
  ``params.h5``) without sklearn: ``estimators_pickle`` writes the list of
  ``LinearDiscriminantAnalysis`` objects that ``to_sklearn_estimators``
  builds, ``load_estimators`` reads such a pickle through a restricted
  unpickler into ``EstimatorState`` objects.
"""

from __future__ import annotations

import copyreg
import dataclasses
import io
import pickle

import numpy as np
import torch

# The class the reference pickles, and the scikit-learn release whose
# LinearDiscriminantAnalysis state ``estimators_pickle`` writes: the
# constructor's defaults, in its signature's order, then ``_sklearn_version``
# (BaseEstimator.__getstate__).
SKLEARN_LDA = ("sklearn.discriminant_analysis", "LinearDiscriminantAnalysis")
SKLEARN_VERSION = "1.9.0"
_SKLEARN_LDA_DEFAULTS = (("solver", "svd"), ("shrinkage", None), ("priors", None),
                         ("n_components", None), ("store_covariance", False), ("tol", 0.0001),
                         ("covariance_estimator", None))


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


def _fit_one_bin(X: torch.Tensor, y_onehot: torch.Tensor, counts: torch.Tensor, tol: float = 1e-4):
    """sklearn svd-solver LDA with padded classes, for a batch of bins that
    share their features.

    X: (n, d); y_onehot: (B, n, k) one-hot over padded class slots;
    counts: (B, k) samples per slot (0 => absent class).
    Returns (coef (B, k, d), intercept (B, k)) with absent slots zeroed.
    """
    n = X.shape[0]
    dt = X.dtype
    present = counts > 0
    n_classes = torch.sum(present, dim=-1)                          # (B,)
    safe_counts = torch.where(present, counts, 1.0)

    means = (y_onehot.transpose(1, 2) @ X) / safe_counts[:, :, None]  # (B, k, d)
    priors = torch.where(present, counts / n, 0.0).to(dt)
    xbar = (priors[:, None, :] @ means)[:, 0]                       # (B, d)

    # within-class centering: Xc = X - mean of own class, scaled in place
    Xc = X - y_onehot @ means                                       # (B, n, d)
    fac = 1.0 / (n - n_classes).to(dt)                              # (B,)
    std = torch.std(Xc, dim=1, correction=0)                        # population std, as jnp.std
    std = torch.where(std == 0, 1.0, std)
    Xs = Xc.mul_(torch.sqrt(fac)[:, None, None]).div_(std[:, None, :])

    # svd(Xs) via eigh of the Gram matrix (d x d): S = sqrt(eigvals), V = vecs
    G = Xs.transpose(1, 2) @ Xs
    del Xs, Xc
    evals, evecs = torch.linalg.eigh(G)
    evals, evecs = evals.flip(-1), evecs.flip(-1)
    S = torch.sqrt(torch.clamp(evals, min=0.0))
    rank_mask = S > tol
    inv_S = torch.where(rank_mask, 1.0 / torch.where(rank_mask, S, 1.0), 0.0)
    scalings = (evecs / std[:, :, None]) * inv_S[:, None, :]       # (B, d, d), masked cols

    # between-class projection
    factor = torch.sqrt(torch.where(present, (n * priors) * fac[:, None], 0.0))
    centred = means - xbar[:, None, :]                              # (B, k, d)
    X2 = factor[:, :, None] * (centred @ scalings)
    evals2, evecs2 = torch.linalg.eigh(X2.transpose(1, 2) @ X2)
    evals2, evecs2 = evals2.flip(-1), evecs2.flip(-1)
    S2 = torch.sqrt(torch.clamp(evals2, min=0.0))
    rank2_mask = S2 > tol * S2[:, :1]
    scalings2 = scalings @ (evecs2 * rank2_mask[:, None, :])        # dropped dims zeroed

    coef0 = centred @ scalings2                                     # (B, k, d)
    coef = coef0 @ scalings2.transpose(1, 2)
    log_priors = torch.where(present, torch.log(torch.where(present, priors, 1.0)), 0.0)
    intercept = -0.5 * torch.sum(coef0 * coef0, dim=2) + log_priors
    intercept = intercept - (coef @ xbar[:, :, None])[:, :, 0]
    coef = torch.where(present[:, :, None], coef, 0.0)
    intercept = torch.where(present, intercept, 0.0)
    return coef, intercept


def fit(X: torch.Tensor, Y, n_classes_max: int = 9) -> LDAParams:
    """Fit per-bin LDAs.  X: (n, d) features; Y: (n, n_bins) integer labels
    (array or tensor).  All bins are fitted in X's dtype on X's device.

    Class slots are each bin's sorted unique labels (sklearn's ``classes_``);
    missing intervals are padded and masked.
    """
    Y = torch.as_tensor(Y).cpu().numpy().astype(np.int64)
    n, n_bins = Y.shape
    classes = np.zeros((n_bins, n_classes_max), np.int32)
    valid = np.zeros((n_bins, n_classes_max), bool)
    compact = np.zeros((n_bins, n), np.int64)
    for b in range(n_bins):
        u = np.unique(Y[:, b])
        if len(u) > n_classes_max:
            raise ValueError(f"bin {b} has {len(u)} classes > {n_classes_max}")
        classes[b, : len(u)] = u
        valid[b, : len(u)] = True
        compact[b] = np.searchsorted(u, Y[:, b])  # slot of each label in the sorted uniques

    onehot = torch.nn.functional.one_hot(torch.as_tensor(compact, device=X.device),
                                         n_classes_max).to(X.dtype)  # (n_bins, n, k)
    coef, intercept = _fit_one_bin(X, onehot, torch.sum(onehot, dim=1))
    return LDAParams(coef=coef, intercept=intercept,
                     classes=torch.as_tensor(classes, device=X.device),
                     valid=torch.as_tensor(valid, device=X.device))


def fit_batched(X: torch.Tensor, labels: torch.Tensor, n_classes_max: int = 9):
    """All bins' LDAs with the labels as slot ids (JAX ``_fit_batched``,
    ``models/lda.py:124-135``): X (n, d); labels (n_bins, n) integers in
    [0, n_classes_max) on X's device.  Returns (coef (n_bins, k, d),
    intercept (n_bins, k), present (n_bins, k) = the slot has a sample).
    Unlike ``fit`` the slots are not compacted to each bin's sorted labels,
    so nothing is read back to the host."""
    onehot = torch.nn.functional.one_hot(labels.long(), n_classes_max).to(X.dtype)  # (B, n, k)
    counts = torch.sum(onehot, dim=1)
    coef, intercept = _fit_one_bin(X, onehot, counts)
    return coef, intercept, counts > 0


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


def _estimator_attributes(params: LDAParams):
    """Per bin the fitted attributes of a sklearn estimator: classes_ (float),
    coef_ and intercept_ (a single row, class1 - class0, for two classes:
    sklearn's binary convention)."""
    coef = params.coef.cpu().numpy().astype(np.float64)
    intercept = params.intercept.cpu().numpy().astype(np.float64)
    classes = params.classes.cpu().numpy()
    valid = params.valid.cpu().numpy()
    out = []
    for b in range(params.n_bins):
        m = valid[b]
        attrs = {"classes_": classes[b][m].astype(np.float64)}
        if m.sum() == 2:
            attrs["coef_"] = (coef[b][m][1] - coef[b][m][0])[None, :]
            attrs["intercept_"] = np.atleast_1d(intercept[b][m][1] - intercept[b][m][0])
        else:
            attrs["coef_"] = coef[b][m]
            attrs["intercept_"] = intercept[b][m]
        out.append(attrs)
    return out


def to_sklearn_estimators(params: LDAParams):
    """sklearn LinearDiscriminantAnalysis objects carrying the fitted
    coef_/intercept_/classes_ (train.py:180-196), for callers that want the
    objects; the artifacts are written by ``estimators_pickle``.  sklearn is
    imported here."""
    from sklearn.discriminant_analysis import LinearDiscriminantAnalysis

    ests = []
    for attrs in _estimator_attributes(params):
        est = LinearDiscriminantAnalysis()
        est.__dict__.update(attrs)
        ests.append(est)
    return ests


class EstimatorState:
    """A pickled sklearn LinearDiscriminantAnalysis read without sklearn:
    its state as attributes (``coef_``, ``intercept_``, ``classes_``, the
    constructor's parameters, ``_sklearn_version``)."""


class _EstimatorPickler(pickle._Pickler):
    """The standard library's pickler, naming ``EstimatorState`` by
    sklearn's module and qualified name, as the pickler names the class of
    a real estimator (without importing sklearn to check that it exists)."""

    def save_global(self, obj, name=None):
        if obj is not EstimatorState:
            return super().save_global(obj, name)
        module, qualname = SKLEARN_LDA
        if self.proto >= 4:
            self.save(module)
            self.save(qualname)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{module}\n{qualname}\n".encode("ascii"))
        self.memoize(obj)


def estimators_pickle(params: LDAParams) -> bytes:
    """The pickle of ``to_sklearn_estimators(params)`` (a list of one
    LinearDiscriminantAnalysis a bin) as ``pickle.dumps`` writes it, without
    sklearn: each object's state is the default constructor's parameters,
    ``classes_``, ``coef_``, ``intercept_`` and ``_sklearn_version``
    (``SKLEARN_VERSION``); numpy pickles the arrays."""
    states = []
    for attrs in _estimator_attributes(params):
        est = EstimatorState()
        est.__dict__.update(_SKLEARN_LDA_DEFAULTS)
        est.__dict__.update(attrs, _sklearn_version=SKLEARN_VERSION)
        states.append(est)
    buf = io.BytesIO()
    _EstimatorPickler(buf, pickle.DEFAULT_PROTOCOL).dump(states)
    return buf.getvalue()


def _admitted_globals():
    """The globals an estimator pickle may name: numpy's array, scalar and
    dtype reconstructors (under numpy 1's and 2's module names) and
    copyreg's object reconstructor."""
    try:
        from numpy._core import multiarray, numeric
    except ImportError:  # numpy 1
        from numpy.core import multiarray, numeric
    table = {("numpy", "ndarray"): np.ndarray, ("numpy", "dtype"): np.dtype,
             ("copyreg", "_reconstructor"): copyreg._reconstructor}
    for core in ("numpy.core", "numpy._core"):
        table[(f"{core}.multiarray", "_reconstruct")] = multiarray._reconstruct
        table[(f"{core}.multiarray", "scalar")] = multiarray.scalar
        table[(f"{core}.numeric", "_frombuffer")] = numeric._frombuffer
    return table


class _EstimatorUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == SKLEARN_LDA:
            return EstimatorState
        obj = _admitted_globals().get((module, name))
        if obj is None:
            raise pickle.UnpicklingError(f"{module}.{name} is not admitted in an estimator pickle "
                                         f"(only {'.'.join(SKLEARN_LDA)} and numpy's arrays)")
        return obj


def load_estimators(data: bytes) -> list:
    """The estimators of a pickle that ``estimators_pickle``, the JAX
    package or the reference trainer wrote, as ``EstimatorState`` objects
    (``from_sklearn_estimators`` reads them), without sklearn.  Any global
    but sklearn's LinearDiscriminantAnalysis and numpy's reconstructors
    raises ``pickle.UnpicklingError``."""
    return _EstimatorUnpickler(io.BytesIO(data)).load()
