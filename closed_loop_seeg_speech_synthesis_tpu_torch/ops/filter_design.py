"""Host-side IIR filter design (numpy/scipy, runs once at setup time).

Numpy copy of ``closed_loop_seeg_speech_synthesis_tpu/ops/filter_design.py``
(``high_gamma_bank``, ``gl_output_lowpass_sos``, ``sosfilt_zi`` and their helpers); the
arrays are bit-identical (tests/test_torch_host_builders.py).

The reference designs its filters through ``mne.filter.create_filter`` with
``iir_params={'order': 8, 'ftype': 'butter'}``, which delegates to
``scipy.signal.iirfilter(order, Wp, btype=..., ftype='butter', output='sos')``.
``l_freq > h_freq`` selects a band-stop over the swapped edges.
"""

from __future__ import annotations

import numpy as np
import scipy.signal as _sig

DEFAULT_IIR_ORDER = 8


def butter_bandpass_sos(sr: float, lo: float, hi: float, order: int = DEFAULT_IIR_ORDER) -> np.ndarray:
    """Butterworth band-pass as second-order sections, float64, shape (order, 6)."""
    nyq = sr / 2.0
    return _sig.iirfilter(order, [lo / nyq, hi / nyq], btype="bandpass", ftype="butter", output="sos")


def butter_bandstop_sos(sr: float, lo: float, hi: float, order: int = DEFAULT_IIR_ORDER) -> np.ndarray:
    """Butterworth band-stop as second-order sections, float64, shape (order, 6)."""
    nyq = sr / 2.0
    lo, hi = min(lo, hi), max(lo, hi)
    return _sig.iirfilter(order, [lo / nyq, hi / nyq], btype="bandstop", ftype="butter", output="sos")


def sosfilt_zi(sos: np.ndarray) -> np.ndarray:
    """Steady-state step-response initial conditions, shape (n_sections, 2).

    Matches ``scipy.signal.sosfilt_zi`` which the reference uses to warm-start
    its streaming filters (``livenodes/FrameBuffer.py:87``).
    """
    return _sig.sosfilt_zi(sos)


def high_gamma_bank(sr: float, line_noise: int = 50, order: int = DEFAULT_IIR_ORDER):
    """The reference's per-region filter chain (ECogFeatCalc.py:40-59).

    EU (line_noise=50): [bandpass 70-170, bandstop 98-102, bandstop 148-152]
    US (line_noise=60): [bandpass 70-170, bandstop 118-122]
    """
    chain = [butter_bandpass_sos(sr, 70.0, 170.0, order)]
    if line_noise == 50:
        chain.append(butter_bandstop_sos(sr, 98.0, 102.0, order))
        chain.append(butter_bandstop_sos(sr, 148.0, 152.0, order))
    elif line_noise == 60:
        chain.append(butter_bandstop_sos(sr, 118.0, 122.0, order))
    else:
        raise ValueError(f"line_noise must be 50 or 60, got {line_noise}")
    return chain


def gl_output_lowpass_ba(sample_rate: float = 16000.0, frame_shift_ms: float = 10.0, cutoff: float = 7900.0):
    """(b, a) of the vocoder output low-pass (reference GriffinLim.py:53-58)."""
    order = int((sample_rate / 1000.0) * frame_shift_ms / 32.0)
    b, a = _sig.iirfilter(order, float(cutoff) / (sample_rate / 2.0), btype="lowpass")
    return np.asarray(b, np.float64), np.asarray(a, np.float64)


def gl_output_lowpass_sos(sample_rate: float = 16000.0, frame_shift_ms: float = 10.0, cutoff: float = 7900.0) -> np.ndarray:
    """The same low-pass as cascaded biquads: the monolithic order-5 DF2T
    diverges in float32, the SOS cascade stays below one int16 LSB."""
    b, a = gl_output_lowpass_ba(sample_rate, frame_shift_ms, cutoff)
    return _sig.tf2sos(b, a)
