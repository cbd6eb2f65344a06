"""Offline training pipeline (twin of reference ``train.py`` + ``local/offline.py``).

Port of ``closed_loop_seeg_speech_synthesis_tpu/runtime/trainer.py``.  The
offline feature path differs from the streaming one at the boundary
(reference design): filters warm-start the same way, but the framing grid
starts at sample 0 of the *filtered data* (no zero-fill prefix kept,
``offline.py:99-109``) and context stacking drops the first
``model_order*step_size`` rows instead of zero-padding
(``offline.py:111-116``).  The ``y_train[20:-4]`` alignment crop
(train.py:144-147) then lines the audio spectrogram up with the stacked
features.  Models trained here drop into the streaming decoder unchanged —
the reference's core online/offline contract.

Every stage runs in torch on the chosen device and dtype (float64 on the
CPU, float32 on CUDA by default, as the JAX package runs float32 on its
accelerator), the LDA fit included.  The audio's decimation to 16 kHz
(scipy), the label bookkeeping and the final feature order stay on the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import scipy.signal as _sig
import torch

from ..models import lda as lda_mod
from ..models import selection
from ..ops import filter_design as fd
from ..ops import framing, iir, quantization
from ..ops.spectrogram import compute_spectrogram

IIR_BLOCK = 256  # samples per block of the high-gamma chain (the JAX trainer's default)
N_MEL_BINS, N_INTERVALS, N_FEATS = 40, 9, 150  # the model's widths (reference train.py)


def offline_high_gamma(eeg: torch.Tensor, sr: float, line_noise: int = 50,
                       window_length: float = 0.05, window_shift: float = 0.01,
                       dtype=torch.float64) -> torch.Tensor:
    """Filtered broadband signal matching ``offline.py:31-97``, on eeg's device.

    hg/fh(first harmonic for EU) cold-start with zi scaled by their first
    input sample; the last filter's state is advanced over
    ``win - shift`` zeros first (warm start), outputs discarded.
    """
    chain = fd.high_gamma_bank(sr, line_noise)
    prefill = int(window_length * sr) - int(window_shift * sr)
    combined, warm = iir.make_warmstart_chain(chain, prefill)
    op = iir.make_blocked_iir(combined, IIR_BLOCK, dtype, eeg.device)
    x = eeg.to(dtype)
    s0 = (torch.as_tensor(warm.zi_scale, dtype=dtype, device=x.device)[:, None] * x[0][None, :]
          + torch.as_tensor(warm.s_const, dtype=dtype, device=x.device)[:, None])
    y, _ = iir.iir_blocked(op, x, s0)
    return y


def offline_features(eeg: torch.Tensor, sr: float, window_length: float = 0.05,
                     window_shift: float = 0.01, line_noise: int = 50,
                     model_order: int = 4, step_size: int = 5,
                     dtype=torch.float64) -> torch.Tensor:
    """Twin of ``offline.py:12-128`` (herff2016_b): (T, C) -> (N, (mo+1)*C)."""
    y = offline_high_gamma(eeg, sr, line_noise, window_length, window_shift, dtype=dtype)
    starts = framing.offline_window_starts(window_length, window_shift, sr, eeg.shape[0])
    wlen = framing.offline_window_len(window_length, sr, starts)
    ends = torch.as_tensor(starts + wlen, device=y.device)
    F = framing.windowed_logpower(y, ends, wlen)
    return framing.stack_context(F, model_order, step_size, zero_pad=False)


@dataclasses.dataclass
class TrainResult:
    x_train: np.ndarray          # (n, nb_feats) selected features actually fitted
    y_train: np.ndarray          # (n, n_mel) quantized labels
    medians: np.ndarray          # (n_mel, n_intervals)
    borders: np.ndarray
    lda: lda_mod.LDAParams       # tensors on the training device, in its dtype
    select: np.ndarray           # (nb_feats,) feature indices
    missing: dict                # bin -> missing interval indices (train.py:86-91)


class StageClock:
    """Milliseconds per stage, summed into ``out`` (nothing when ``out`` is
    None): CUDA events around device stages on a CUDA device, the host clock
    otherwise and around host stages.  Each timed stage starts and ends with
    a synchronize."""

    def __init__(self, out, device):
        self.out = out
        self.cuda = device.type == "cuda"

    @contextlib.contextmanager
    def __call__(self, name: str, host: bool = False):
        if self.out is None:
            yield
            return
        events = self.cuda and not host
        if self.cuda:
            torch.cuda.synchronize()
        if events:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        yield
        if events:
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        self.out[name] = self.out.get(name, 0.0) + ms


def train(eeg, audio: np.ndarray, eeg_sr: float, audio_sr: float,
          bad_channels, nb_feats: int = N_FEATS, line_noise: int = 50, dtype=None, device=None,
          timings: dict | None = None) -> TrainResult:
    """Full training (reference train.py:132-168).

    eeg: (T, C_all) raw array or tensor; audio: (T_a,) in [-1, 1] float;
    bad_channels: indices to exclude; ``nb_feats`` features are selected
    (exp1 passes fewer for small sessions).  ``device`` defaults to the card
    whatever eeg's device (pass ``"cpu"`` to train on the CPU), ``dtype`` to
    float64 on the CPU and float32 on CUDA.
    Audio is decimated by 3 to 16 kHz exactly as the reference does
    (train.py:125, scipy.signal.decimate defaults).  ``timings``, when
    given, receives the milliseconds of each stage: features, decimate,
    spectrogram, quantization, selection, lda_fit.
    """
    from .pipeline import default_compute_dtype, resolve_device

    device = resolve_device(device)
    eeg = torch.as_tensor(eeg)
    dtype = dtype or default_compute_dtype(device)
    clock = StageClock(timings, device)
    bad_channels = np.asarray(bad_channels, int)
    if len(bad_channels) > 0:
        mask = np.ones(eeg.shape[1], bool)
        mask[bad_channels] = False
        eeg = eeg[:, torch.as_tensor(mask, device=eeg.device)]

    with clock("features"):
        x_train = offline_features(eeg.to(device), eeg_sr, 0.05, 0.01, line_noise, dtype=dtype)

    with clock("decimate", host=True):
        audio16 = np.ascontiguousarray(_sig.decimate(np.asarray(audio, np.float64), 3))
    with clock("spectrogram"):
        y_spec = compute_spectrogram(torch.as_tensor(audio16, dtype=dtype, device=device),
                                     16000, 0.016, 0.01, N_MEL_BINS)
        y_spec = y_spec[20:-4]  # context + window-length alignment crop (train.py:144-147)

    with clock("quantization"):
        medians, borders = quantization.compute_borders_logistic(y_spec, N_INTERVALS)
        q_spec = quantization.quantize(y_spec, borders).cpu().numpy().astype(int)

    missing = {}
    for b in range(N_MEL_BINS):
        diff = np.setdiff1d(np.arange(N_INTERVALS), q_spec[:, b])
        if diff.size:
            missing[b] = diff.tolist()

    # features and audio spectrogram can differ by a frame at the recording
    # tail; clamp BEFORE the Spearman selection (train.py clamps at 144-147)
    n = min(len(x_train), len(y_spec))
    x_train, y_spec, q_spec = x_train[:n], y_spec[:n], q_spec[:n]

    with clock("selection"):
        select = selection.select_features(x_train, y_spec, nb_feats)
    with clock("lda_fit"):
        x_sel = x_train[:, torch.as_tensor(select, device=device)]
        lda_params = lda_mod.fit(x_sel, q_spec, N_INTERVALS)
    return TrainResult(
        x_train=x_sel.cpu().numpy(), y_train=q_spec,
        medians=medians.cpu().numpy(), borders=borders.cpu().numpy(),
        lda=lda_params, select=select, missing=missing,
    )
