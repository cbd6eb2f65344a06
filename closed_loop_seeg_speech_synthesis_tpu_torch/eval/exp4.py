"""Experiment 4: LDA activation maps via the Haufe transform
(twin of reference ``eval_steps/exp4.py``).

Numpy copy of ``closed_loop_seeg_speech_synthesis_tpu/eval/exp4.py``
(``feature_names``, ``Experiment4``).  It runs on the host in float64 with
the JAX package's numpy calls, in its order: the class covariance below is
singular up to rounding, so the activations depend on the rounding of the
products, and only the same operations give the same matrix (a torch
float64 evaluation of the same formula does not reproduce it).  The
model and the training features come from ``params.h5`` /
``training_features.npy`` or as arrays.

A = cov(X) @ W @ inv(cov(Wᵀ X)) per mel bin; |A| averaged over classes and
bins, scattered onto a (channel, context-lag) grid through the selected
feature names.  Where the reference hardcodes the study patient's shaft
names and the two bins with a missing quantization interval
(exp4.py:33-43,70-83), we take channel names as input and read missing
classes from the model's validity mask.

Known reference quirk (exp4.py:95-100): for its missing-class bins the
reference builds the padded inverse via ``tmp[mask, :][:, mask] = inv`` —
a numpy chained fancy-index that assigns into a COPY, so those bins'
activation slices are silently all-zero in the reference output.  We
compute the proper masked inverse; the verbatim-execution oracle
(tests/test_reference_eval_exp4_oracle.py) proves float-tolerance equality
on the well-posed bins by emulating the quirk (the reference computes the
class scores with a per-row matvec loop, so bit equality is not defined).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..runtime import params as params_io

logger = logging.getLogger("eval.exp4")


def feature_names(channel_names, n_taps: int = 5):
    """Stacked-feature names, channel-major with lag taps newest-first
    (exp4.py:50: '{ch}-{tap}' for taps reversed(range(5)))."""
    return ["{}-{}".format(c, t) for c in channel_names for t in reversed(range(n_taps))]


class Experiment4:
    """``model`` (the ``params.load_params`` dict: lda, select) and
    ``training_features`` (the selected training feature matrix) stand in
    for ``session_dir``'s ``params.h5`` and ``training_features.npy``."""

    def __init__(self, session_dir, channel_names, n_taps: int = 5, model=None,
                 training_features=None):
        self.session_dir = session_dir
        self.channel_names = list(channel_names)
        self.n_taps = n_taps

        # float64: this is host-side analysis, and sigma_s below is singular
        # by construction (sklearn LDA coef_ spans <= k-1 dims), so its
        # inverse amplifies precision noise by ~eps/lambda_min — f32 params
        # would inflate the activation values by orders of magnitude
        loaded = model or params_io.load_params(os.path.join(session_dir, "params.h5"),
                                                dtype=torch.float64, device="cpu")
        self.lda = loaded["lda"]
        self.select = np.asarray(loaded["select"])
        names = feature_names(self.channel_names, n_taps)
        self.sel_features = [f for i, f in enumerate(names) if i in set(self.select.tolist())]
        self.obs_data = (np.load(os.path.join(session_dir, "training_features.npy"))
                         if training_features is None else np.asarray(training_features))

    def compute_activations(self, return_all=False):
        """Activation grid; ``return_all`` also returns the per-bin
        activation tensor ``all_A (d, k, n_bins)`` and the averaged
        per-feature vector (for analyses and the reference oracle)."""
        coef = self.lda.coef.detach().cpu().numpy().astype(np.float64)  # (n_bins, k, d)
        valid = self.lda.valid.cpu().numpy()                # (n_bins, k)
        n_bins, k, d = coef.shape
        X = np.asarray(self.obs_data, np.float64)
        sigma_x = np.cov(X.T)                               # (d, d)

        all_A = np.zeros((d, k, n_bins))
        for b in range(n_bins):
            m = valid[b]
            W = coef[b].T                                   # (d, k) with absent-class cols zero
            s = X @ W                                       # (n, k)
            sigma_s = np.cov(s.T)
            try:
                inv = np.zeros((k, k))
                sub = np.linalg.inv(sigma_s[np.ix_(m, m)])
                inv[np.ix_(m, m)] = sub
                all_A[:, :, b] = sigma_x @ W @ inv
            except np.linalg.LinAlgError:
                logger.warning("Singular class covariance in bin %d", b)

        activations = np.mean(np.abs(all_A), axis=(1, 2))   # (d,)

        matrix = self._scatter(activations)
        if return_all:
            return matrix, all_A, activations
        return matrix

    def _scatter(self, activations):
        """Per-feature vector -> (channel, tap) grid (exp4.py:113-118)."""
        matrix = np.zeros((len(self.channel_names), self.n_taps))
        for f in self.sel_features:
            ch, tap = f.rsplit("-", 1)
            matrix[self.channel_names.index(ch), int(tap)] = activations[self.sel_features.index(f)]
        return matrix

    def selection_mask(self):
        """(n_channels, n_taps) bool: which grid cells hold a selected feature."""
        mask = np.zeros((len(self.channel_names), self.n_taps), bool)
        for f in self.sel_features:
            ch, tap = f.rsplit("-", 1)
            mask[self.channel_names.index(ch), int(tap)] = True
        return mask

    def shaft_spans(self):
        """Contiguous channel runs sharing an alphabetic prefix (electrode
        shafts).  Returns [(name, start, end_exclusive), ...] in grid order —
        computed from the channel names instead of the reference's hardcoded
        study-patient spans (exp4.py:188-189)."""
        import re

        spans = []
        for i, ch in enumerate(self.channel_names):
            m = re.match(r"([A-Za-z]+)", ch)
            name = m.group(1) if m else ch
            if spans and spans[-1][0] == name:
                spans[-1][2] = i + 1
            else:
                spans.append([name, i, i + 1])
        return [tuple(s) for s in spans]

    def plot(self, matrix, filename):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        vmax = np.abs(matrix).max()
        fig, ax = plt.subplots(figsize=(12, 3))
        im = ax.imshow(matrix.T, aspect="auto", origin="lower", cmap="RdBu_r", vmin=-vmax, vmax=vmax)
        ax.set_xticks(range(len(self.channel_names)))
        ax.set_xticklabels(self.channel_names, rotation=90, fontsize=4)
        ax.set_ylabel("context lag (x50 ms)")
        fig.colorbar(im, ax=ax)
        fig.tight_layout()
        fig.savefig(filename, dpi=300)
        plt.close(fig)

    def plot_activation_map(self, matrix, filename, exclude_shafts=()):
        """Paper-style activation map (reference exp4.py:119-211): Reds
        heatmap over (channel, context-lag), dotted feature-selection
        boundary, per-shaft color patches above the axis.

        The reference hardcodes the boundary polygon and shaft spans for the
        study patient; here both are computed — the boundary is the outline
        of the selected-feature cells, shafts come from the channel-name
        prefixes.  ``exclude_shafts`` drops trailing noise electrodes (the
        reference cuts its last 5 'E' channels, exp4.py:172)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib import patches
        from matplotlib.collections import LineCollection

        spans = [s for s in self.shaft_spans() if s[0] not in set(exclude_shafts)]
        keep = [i for (name, s, e) in spans for i in range(s, e)]
        mat = matrix[keep]
        mask = self.selection_mask()[keep]
        n_ch, n_taps = mat.shape
        vmax = np.abs(mat).max() or 1.0

        fig = plt.figure(figsize=(14, 6))
        ax = plt.subplot2grid((1, 3), (0, 0), colspan=3)
        im = ax.imshow(mat.T, aspect="auto", origin="lower", cmap="Reds",
                       interpolation="None", vmin=0, vmax=vmax)

        # dotted boundary around every selected cell edge facing a
        # non-selected cell (generalizes the reference's manual polygon)
        segs = []
        for c in range(n_ch):
            for t in range(n_taps):
                if not mask[c, t]:
                    continue
                if c == 0 or not mask[c - 1, t]:
                    segs.append([(c - 0.5, t - 0.5), (c - 0.5, t + 0.5)])
                if c == n_ch - 1 or not mask[c + 1, t]:
                    segs.append([(c + 0.5, t - 0.5), (c + 0.5, t + 0.5)])
                if t == 0 or not mask[c, t - 1]:
                    segs.append([(c - 0.5, t - 0.5), (c + 0.5, t - 0.5)])
                if t == n_taps - 1 or not mask[c, t + 1]:
                    segs.append([(c - 0.5, t + 0.5), (c + 0.5, t + 0.5)])
        ax.add_collection(LineCollection(segs, colors="black", linestyles=":",
                                         linewidths=1))

        # shaft color patches above the axis (tab10 cycle) + labels
        cmap10 = plt.get_cmap("tab10")
        x0 = 0
        ttl = ax.set_title("Electrode Shaft",
                           fontdict={"fontsize": 12, "fontweight": "bold"})
        ttl.set_position([0.5, 1.06])
        h = n_taps - 0.49
        for ci, (name, s, e) in enumerate(spans):
            w = e - s
            color = cmap10(ci % 10)
            xy = np.array([[x0 - 0.5, x0 - 0.5 + w, x0 - 0.5 + w],
                           [h, h, h + 0.3]]).T
            ax.add_patch(patches.Polygon(xy, linewidth=1, clip_on=False,
                                         fill=True, edgecolor=color,
                                         facecolor=color))
            ax.annotate(name, (x0 - 0.5 + w / 2, h + 0.45), clip_on=False,
                        ha="center", fontsize=8, annotation_clip=False)
            x0 += w

        ax.set_yticks(np.arange(n_taps))
        # bottom row t=0 is 'now', top row is -(n_taps-1)*50 ms back
        # (exp4.py:183 label order)
        ax.set_yticklabels([str(-50 * t) if t else "0" for t in range(n_taps)])
        ax.set_ylabel("Temporal Context [in ms]")
        ax.set_xticks([])
        ax.set_xlim(-0.5, n_ch - 0.5)
        ax.grid(False)
        ax.spines["top"].set_visible(False)
        ax.spines["bottom"].set_visible(False)

        cbaxes = fig.add_axes([0.94, 0.03, 0.025, 0.85])
        cb = plt.colorbar(im, cax=cbaxes, ticks=[0, vmax])
        cbaxes.yaxis.set_ticks_position("right")
        cb.set_label("Average Model Weights", rotation=270, labelpad=-5)
        plt.subplots_adjust(left=0.06, bottom=0.03, top=0.88, right=0.93)
        fig.savefig(filename, dpi=300)
        plt.close(fig)
