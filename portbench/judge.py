"""Whether what the timed path produced is correct: the numbers compared and their limits.

The program's log-mel frames and int16 audio are held against the plain
reference (``portbench.reference``, float64) on the same sEEG, weights and
Griffin-Lim key:

* ``missing``: frames and audio hops too few or too many against the
  reference's, plus answers that never came (packets without outputs).
  Exact: limit 0.
* ``mel_off_share``: the share of (frame, bin) values more than
  ``MEL_TOL`` from the reference's.  A float32 decode computes each bin's
  LDA scores with rounding error, and where two classes' scores lie closer
  than that error the other class wins: the dequantized median, and the
  smoothed bins around it, move by a step.  These flips are the only
  differences float32 leaves; the values themselves are smoothed medians,
  within 1e-6 of the reference's.
* ``mel_unexplained``: the number of those values whose smoothing window
  holds no bin whose two highest reference scores lie within ``NEAR_TIE``:
  a difference that no flip of a near-tie explains.
* ``audio_off_share``: the share of audio samples more than 1 LSB from the
  reference vocoder's audio of the program's own frames with the same
  inits, and ``audio_off_run``: the longest run of 160-sample hops that
  hold such a sample.  Griffin-Lim under the upstream decoder's exp(angle)
  phase term is chaotic: a rounding difference at a bin near zero turns
  its angle and decoheres that 480-sample block (three hops), so float32
  audio cannot match float64 bit for bit; a sound decode leaves a small
  share of samples off, in short runs.

The reference's vocoder reads the program's frames so that a flip in the
front half, judged above, does not decohere the blocks that follow it.
Each limit sits between what sound runs of the program read over a dozen
seeds and what the control (the reference in TF32, ``control.py``) reads.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from . import reference
from .reference import Arith, frontend, vocoder

MEL_TOL = 1e-5      # log-mel: a smoothed median in float32 is within ~1e-6 of float64's
NEAR_TIE = 1e-3     # LDA score units: float32 score errors stay below ~1e-5
LSB = 1
HOP = vocoder.HOP
NAMES = ("missing", "mel_off_share", "mel_unexplained", "audio_off_share", "audio_off_run")

HERE = os.path.dirname(os.path.abspath(__file__))


def limits(cell: str, root: str = HERE) -> dict:
    with open(os.path.join(root, "limits", f"{cell}.json")) as f:
        return json.load(f)["limits"]


def longest_run(flags: np.ndarray) -> int:
    best = run = 0
    for f in flags:
        run = run + 1 if f else 0
        best = max(best, run)
    return best


def compare(spec, audio, eeg: torch.Tensor, cfg: dict, weights: dict, seed: int,
            init_dtype: torch.dtype, never_came: int = 0) -> dict:
    """The numbers of one answer (frames (N, n_mel), audio int16) against the
    reference on the sEEG it decoded."""
    dev = eeg.device
    exact = Arith(torch.float64)
    ref_mel, margin = frontend.mels(eeg, cfg, weights, exact)
    spec = torch.as_tensor(np.asarray(spec)).to(dev, torch.float64)
    audio = np.asarray(audio).astype(np.int64).reshape(-1)
    n = min(len(spec), len(ref_mel))
    missing = abs(len(spec) - len(ref_mel)) + abs(len(audio) // HOP - (len(ref_mel) - 1)) \
        + int(len(audio) % HOP != 0) + int(never_came)
    off = ~((spec[:n] - ref_mel[:n]).abs() <= MEL_TOL)
    near = margin[:n] < NEAR_TIE
    near_window = near[:, torch.as_tensor(frontend.reflect_sources(near.shape[1]), device=dev)].any(-1)
    numbers = {"missing": missing,
               "mel_off_share": float(off.double().mean()) if n else 1.0,
               "mel_unexplained": int((off & ~near_window).sum())}
    if len(spec) >= 2:
        ref_audio = vocoder.Vocoder(cfg, exact, dev).audio(spec, seed, init_dtype).cpu().numpy()
    else:
        ref_audio = np.zeros(0, np.int16)
    m = min(len(audio), len(ref_audio)) // HOP * HOP
    bad = np.abs(audio[:m] - ref_audio[:m].astype(np.int64)) > LSB
    numbers["audio_off_share"] = float(bad.mean()) if m else 1.0
    numbers["audio_off_run"] = longest_run(bad.reshape(-1, HOP).any(1)) if m else 0
    return numbers


def worst(all_numbers) -> dict:
    """The worst of several answers' numbers, name by name."""
    return {k: max(n[k] for n in all_numbers) for k in NAMES}


def verdict(numbers: dict, lim: dict):
    """(correct, {name: {"value", "limit"}}): correct when every number is
    at most its limit (a NaN never is)."""
    checks = {k: {"value": numbers[k], "limit": lim[k]} for k in NAMES}
    ok = all(bool(numbers[k] <= lim[k]) for k in NAMES)
    return ok, checks


def control(eeg: torch.Tensor, cfg: dict, weights: dict, seed: int, init_dtype: torch.dtype):
    """The control's answer: the reference one precision below the
    configuration's float32, TF32 products, in the program's place."""
    mel, audio, _ = reference.decode(eeg, cfg, weights, seed, init_dtype,
                                     Arith(torch.float32, tf32=True))
    return mel.cpu().numpy(), audio.cpu().numpy()
