"""Headless bad-channel inspection (substitute for the reference's
interactive MNE raw-data view, ``train.py:328-334``).

Copy of ``closed_loop_seeg_speech_synthesis_tpu/io/inspection.py``.  The
reference optionally blocks training on an interactive GUI where the
experimenter marks bad channels.  On a headless host that becomes a
report: per-channel PSD + variance statistics over the first minute of the
recording, written as a PNG + CSV next to the training artifacts, with
suspect channels flagged (railed/dead/extreme-variance/line-dominated) so
the experimenter can extend the ``channels`` exclusion regex and re-run.
"""

from __future__ import annotations

import logging

import numpy as np
import scipy.signal as _sig

logger = logging.getLogger("io.inspection")


def channel_stats(eeg: np.ndarray, sr: float, seconds: float = 60.0,
                  line_noise: int = 50):
    """Per-channel QC metrics over the first ``seconds`` of (T, C) data.

    Returns a dict of (C,) arrays: std, ptp, flat_frac (fraction of
    zero first-differences — railed/clipped electrodes), line_ratio
    (power within ±2 Hz of the line-noise fundamental / total power),
    plus the Welch PSD (C, n_freqs) and its frequency grid.
    """
    x = np.asarray(eeg[: int(seconds * sr)], np.float64)
    std = x.std(axis=0)
    ptp = np.ptp(x, axis=0)
    d = np.diff(x, axis=0)
    flat_frac = (d == 0).mean(axis=0)
    nperseg = min(len(x), 1024)
    freqs, psd = _sig.welch(x, fs=sr, nperseg=nperseg, axis=0)
    psd = psd.T  # (C, F)
    total = psd.sum(axis=1) + np.finfo(float).eps
    line_band = (np.abs(freqs - line_noise) <= 2.0)
    line_ratio = psd[:, line_band].sum(axis=1) / total
    return {"std": std, "ptp": ptp, "flat_frac": flat_frac,
            "line_ratio": line_ratio, "freqs": freqs, "psd": psd}


def flag_suspects(stats, flat_thresh=0.2, dead_rel=0.01, extreme_rel=10.0,
                  line_thresh=0.5):
    """Indices of channels an experimenter should look at, with reasons."""
    std = stats["std"]
    med = np.median(std[std > 0]) if (std > 0).any() else 1.0
    reasons = {}

    def add(idx_mask, reason):
        for i in np.where(idx_mask)[0]:
            reasons.setdefault(int(i), []).append(reason)

    add(stats["flat_frac"] > flat_thresh, "railed")
    add(std < dead_rel * med, "dead")
    add(std > extreme_rel * med, "extreme-variance")
    add(stats["line_ratio"] > line_thresh, "line-dominated")
    return reasons


def inspect_channels(eeg: np.ndarray, sr: float, ch_names, bad_idx,
                     out_png: str, out_csv: str | None = None,
                     seconds: float = 60.0, line_noise: int = 50):
    """Write the channel-QC figure (+ optional CSV); returns the suspect map
    {channel_index: [reasons...]} (already-excluded channels are annotated
    but not re-flagged)."""
    stats = channel_stats(eeg, sr, seconds, line_noise)
    suspects = flag_suspects(stats)
    excluded = set(int(i) for i in bad_idx)
    names = list(ch_names) if ch_names is not None else [str(i) for i in range(eeg.shape[1])]

    if out_csv:
        with open(out_csv, "w") as f:
            f.write("index,name,std,ptp,flat_frac,line_ratio,excluded,flags\n")
            for i, n in enumerate(names):
                f.write("{},{},{:.6g},{:.6g},{:.4f},{:.4f},{},{}\n".format(
                    i, n, stats["std"][i], stats["ptp"][i], stats["flat_frac"][i],
                    stats["line_ratio"][i], int(i in excluded),
                    "|".join(suspects.get(i, []))))

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    C = eeg.shape[1]
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(max(8, C * 0.12), 7),
                                   gridspec_kw={"height_ratios": [2, 1]})
    logpsd = 10 * np.log10(stats["psd"] + np.finfo(float).tiny)
    im = ax1.imshow(logpsd, aspect="auto", origin="lower", cmap="viridis",
                    extent=[stats["freqs"][0], stats["freqs"][-1], -0.5, C - 0.5])
    ax1.set_xlabel("frequency [Hz]")
    ax1.set_ylabel("channel")
    ax1.set_title("Welch PSD [dB] — first %.0f s" % seconds)
    fig.colorbar(im, ax=ax1)

    colors = ["tab:red" if i in suspects else
              ("tab:gray" if i in excluded else "tab:blue") for i in range(C)]
    ax2.bar(np.arange(C), stats["std"], color=colors)
    ax2.set_yscale("log")
    ax2.set_ylabel("std")
    ax2.set_xticks(np.arange(C))
    ax2.set_xticklabels(names, rotation=90, fontsize=4)
    ax2.set_title("per-channel std (red = flagged, gray = excluded)")
    fig.tight_layout()
    fig.savefig(out_png, dpi=200)
    plt.close(fig)

    for i, rs in sorted(suspects.items()):
        mark = " (already excluded)" if i in excluded else ""
        logger.warning("channel %d (%s): %s%s", i, names[i], ", ".join(rs), mark)
    return suspects
