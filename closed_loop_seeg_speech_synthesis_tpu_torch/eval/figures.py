"""Paper figures 3 & 4 (twins of ``eval_steps/figure_3.py`` / ``figure_4.py``)
plus trial extraction (``eval_steps/extract_trials.py``).

Copy of ``closed_loop_seeg_speech_synthesis_tpu/eval/figures.py`` (numpy on
the host, with the port's session, decoding-run and metric modules);
matplotlib is imported where a figure is drawn."""

from __future__ import annotations

import logging
import os

import numpy as np

from ..io.session import DecodingRun, Session
from .metrics import kfold_indices, mann_whitney_u, pearson_per_bin

logger = logging.getLogger("eval.figures")


def _fold_corrs(orig, reco, n_folds=10):
    rs = np.zeros((n_folds, orig.shape[1]))
    for k, (_, test) in enumerate(kfold_indices(len(orig), n_folds)):
        rs[k] = pearson_per_bin(orig[test], reco[test])
    return rs


def figure_3(exp_dir, out_path, n_chance_runs=100, n_top_examples=5):
    """Top reconstruction examples + per-bin correlation curves vs chance with
    Mann-Whitney/Bonferroni stats (figure_3.py:38-143)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    orig = np.load(os.path.join(exp_dir, "orig.npy"))
    reco = np.load(os.path.join(exp_dir, "pm_reco.npy"))

    # top trials by mean Pearson over 200-frame (2 s) trial spans; the
    # stride-300 iteration INCLUDES a trailing partial trial exactly like
    # figure_3.py:41 (range(0, len(orig), 300))
    starts = list(range(0, len(orig), 300))
    scores = []
    for s in starts:
        a, b = orig[s : s + 200], reco[s : s + 200]
        n = min(len(a), len(b))
        scores.append(np.nanmean(pearson_per_bin(a[:n], b[:n])))
    top = np.argsort(scores)[-n_top_examples:][::-1]

    rs_pm = _fold_corrs(orig, reco)
    rc_all = []
    for i in range(1, n_chance_runs + 1):
        path = os.path.join(exp_dir, "rc_reco_i={:03}.npy".format(i))
        if not os.path.exists(path):
            break
        rc_all.append(_fold_corrs(orig, np.load(path)))
    rc_all = np.vstack(rc_all) if rc_all else np.zeros((1, orig.shape[1]))

    stats = []
    for b in range(orig.shape[1]):
        stat, p = mann_whitney_u(rs_pm[:, b], rc_all[:, b])
        stats.append((b, stat, p, p * orig.shape[1]))
        logger.info("Spec Bin: %d, Stat: %s, p: %s, p (Bonferroni): %s", b, stat, p, p * orig.shape[1])

    fig = plt.figure(figsize=(12, 7))
    ax_o = plt.subplot2grid((3, 1), (0, 0))
    ax_r = plt.subplot2grid((3, 1), (1, 0))
    ax_c = plt.subplot2grid((3, 1), (2, 0))
    seg = np.concatenate([orig[i * 300 : i * 300 + 200] for i in top])
    segr = np.concatenate([reco[i * 300 : i * 300 + 200] for i in top])
    ax_o.imshow(seg.T, aspect="auto", origin="lower")
    ax_o.set_ylabel("orig logMels")
    ax_r.imshow(segr.T, aspect="auto", origin="lower")
    ax_r.set_ylabel("reco logMels")
    for i in range(1, n_top_examples):
        for ax in (ax_o, ax_r):
            ax.axvline(i * 200, color="white", linestyle="--", linewidth=2)
    bins = np.arange(orig.shape[1])
    ax_c.plot(bins, rs_pm.mean(0), label="proposed")
    ax_c.fill_between(bins, rs_pm.mean(0) - rs_pm.std(0), rs_pm.mean(0) + rs_pm.std(0), alpha=0.3)
    ax_c.plot(bins, rc_all.mean(0), label="chance")
    ax_c.fill_between(bins, rc_all.mean(0) - rc_all.std(0), rc_all.mean(0) + rc_all.std(0), alpha=0.3)
    ax_c.set_xlabel("mel bin")
    ax_c.set_ylabel("Pearson r")
    ax_c.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=300)
    plt.close(fig)
    return stats


def figure_4(session_dir, dest_dir, out_path, example_words=None):
    """Whisper/imagine waveform examples, DTW-correlation boxplots vs chance,
    speech-proportion bars; logs medians + Mann-Whitney stats
    (figure_4.py:30-80,184-203)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    exp2_dir = os.path.join(dest_dir, "exp2")
    exp3_dir = os.path.join(dest_dir, "exp3")
    data = {}
    for run in ("whisper", "imagine"):
        chance = np.load(os.path.join(exp2_dir, f"exp2_{run}_chance.npy"))
        chance = chance[~np.isnan(chance)]
        pm = np.load(os.path.join(exp2_dir, f"exp2_{run}_pm.npy"))
        data[run] = (pm, chance)
        logger.info("Median DTW scores (%s) %s + %s", run, np.median(pm), np.std(pm))
        logger.info("Chance DTW scores (%s) %s + %s", run, np.median(chance), np.std(chance))
        logger.info("Mann-Whitney U Test %s: %s", run, mann_whitney_u(pm, chance))
    logger.info("Mann-Whitney U whisper vs. imagine: %s",
                mann_whitney_u(data["whisper"][0], data["imagine"][0]))

    fig = plt.figure(figsize=(12, 6.5))
    ax_w = plt.subplot2grid((2, 3), (0, 0), colspan=2)
    ax_i = plt.subplot2grid((2, 3), (1, 0), colspan=2)
    ax_b = plt.subplot2grid((2, 3), (0, 2))
    ax_a = plt.subplot2grid((2, 3), (1, 2))

    for ax, run in ((ax_w, "whisper"), (ax_i, "imagine")):
        run_dir = os.path.join(session_dir, run)
        if os.path.isdir(run_dir):
            dr = DecodingRun(run_dir)
            words = (example_words or {}).get(run, dr.words[:5])
            audios = [dr.get_trial_by_word(w)[2] for w in words if w in dr.words]
            if audios:
                cat = np.concatenate([a / max(1, np.abs(a).max()) for a in audios])
                ax.plot(cat, linewidth=0.4)
        ax.set_ylabel(run)

    ax_b.boxplot([data["whisper"][0], data["whisper"][1], data["imagine"][0], data["imagine"][1]],
                 tick_labels=["wh", "wh-ch", "im", "im-ch"])
    ax_b.set_ylabel("DTW Pearson r")

    bars, labels = [], []
    for run in ("whisper", "imagine"):
        path = os.path.join(exp3_dir, f"{run}_speech_amount.npy")
        if os.path.exists(path):
            amounts = np.load(path)
            bars += list(amounts)
            labels += [f"{run}-trial", f"{run}-rest"]
    if bars:
        ax_a.bar(range(len(bars)), bars)
        ax_a.set_xticks(range(len(bars)))
        ax_a.set_xticklabels(labels, rotation=45)
        ax_a.set_ylabel("speech (s)")
    fig.tight_layout()
    fig.savefig(out_path, dpi=300)
    plt.close(fig)


# ----------------------------- trial extraction ----------------------------


def extract_wavs_from_session(session_dir, temp_dir):
    from scipy.io.wavfile import write as wavwrite

    sess = Session(session_dir)
    out = os.path.join(temp_dir, "train_wavs")
    os.makedirs(out, exist_ok=True)
    for i, word in enumerate(sess.words):
        audio = sess.get_trial_by_word(word)[2]
        wavwrite(os.path.join(out, "{:03}-{}.wav".format(i + 1, word)), 16000, audio)


def extract_wavs_from_decoding_trials(run_dir, temp_dir):
    from scipy.io.wavfile import write as wavwrite

    run = DecodingRun(run_dir)
    name = os.path.basename(run_dir)
    out = os.path.join(temp_dir, f"{name}_wavs")
    os.makedirs(out, exist_ok=True)
    for i, word in enumerate(run.words):
        audio = run.get_trial_by_word(word)[2]
        wavwrite(os.path.join(out, "{:03}-{}.wav".format(i + 1, word)), 16000, audio)


def generate_trial_label_file(run_dir, temp_dir):
    run = DecodingRun(run_dir)
    name = os.path.basename(run_dir)
    lines = ["{}\t{}\t{}".format(s, s + 2, w) for s, w in zip(run.trial_starts_in_sec, run.words)]
    with open(os.path.join(temp_dir, f"{name}_trials.lab"), "w") as f:
        f.write("\n".join(lines) + "\n")
