"""The least time one H100 could take for each stage of a decode, from shapes.

Functions of the configuration and the shapes only; nothing of the program.
The work is the mathematics as the decoder's definition writes it, counted
at its least, so that no correct implementation, in any precision, can
beat the bound:

* bytes: every input read once, every output written once;
* operations: products (the high-gamma chain's state updates, one per
  sample, channel and second-order section; the LDA; the mel-to-linear
  map; Griffin-Lim's DFTs as dense real products) at the card's highest
  dense rate, everything else (squares and sums of the log-power, logs,
  the smoothing, the phase step, the windows, the overlap-add, the output
  low-pass, the integer work of the threefry inits) at the float32 rate.

The tensor cores, the float32 pipes and the memory run at once, so a
stage's bound is the largest of the three times, never their sum.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_DENSE_FLOPS = 989e12   # bf16 / fp16 tensor cores, the highest dense rate
PEAK_FP32_FLOPS = 67e12     # float32 outside the tensor cores
PEAK_BYTES_S = 3.35e12      # HBM3

N_FFT, HOP, BLOCK = 256, 160, 480
SECTION_FLOPS = 10          # a second-order section: 5 multiply-adds a sample
THREEFRY_OPS, UNIFORM_OPS = 72, 4


@dataclasses.dataclass(frozen=True)
class Bound:
    ops_s: float
    bytes_s: float

    @property
    def seconds(self) -> float:
        return max(self.ops_s, self.bytes_s)

    @property
    def binds(self) -> str:
        return "operations" if self.ops_s >= self.bytes_s else "bytes"


def _time(products: float, other: float) -> float:
    """The least time of the operations: the products and the rest overlap."""
    return max(products / PEAK_DENSE_FLOPS, other / PEAK_FP32_FLOPS)


def chain_sections(cfg: dict) -> int:
    """Second-order sections of the high-gamma chain: the band-pass and one
    band-stop per line-noise harmonic below 170 Hz, each of order ``filter_order``."""
    ln = int(cfg["line_noise"])
    stops = sum(1 for h in (2 * ln, 3 * ln) if h < 170)
    return int(cfg["filter_order"]) * (1 + stops)


def frontend(cfg: dict, n_samples: int, n_frames: int) -> Bound:
    """Raw sEEG (T, C) to smoothed log-mel frames (N, n_mel)."""
    C, bins = int(cfg["n_channels"]), int(cfg["n_mel"])
    k, feats = int(cfg["n_classes"]), int(cfg["n_features"])
    item = 8 if cfg["dtype"] == "float64" else 4
    products = (SECTION_FLOPS * chain_sections(cfg) * n_samples * C
                + 2.0 * n_frames * bins * k * feats)
    other = (2.0 * n_samples * C + 3.0 * n_frames * C          # squares, sums; window, +0.01, log
             + n_frames * bins * (k + 1 + 2 * 5))              # argmax, dequantization, smoothing
    nbytes = (n_samples * C + n_frames * bins) * item + (bins * k * (feats + 2)) * item + feats * 8
    return Bound(_time(products, other), nbytes / PEAK_BYTES_S)


def vocoder(cfg: dict, n_frames: int) -> Bound:
    """Log-mel frames (N, n_mel) to int16 audio ((N - 1) * 160,), the inits included."""
    bins, its = int(cfg["n_mel"]), int(cfg["gl_iterations"])
    item = 8 if cfg["dtype"] == "float64" else 4
    B, kb = n_frames - 1, N_FFT // 2 + 1
    inverse_rows = kb if cfg["phase_bug"] else N_FFT      # a real spectrum needs only the cosines
    dft = 2.0 * N_FFT * (N_FFT + inverse_rows)             # one frame, forward and inverse
    products = 2.0 * B * its * dft + 2.0 * n_frames * bins * kb
    phase = 3 * kb if cfg["phase_bug"] else 6 * kb         # atan2, exp, scale / the unit phasor
    per_frame = 2 * N_FFT + phase + N_FFT                  # the two windows, the phase, overlap
    order = int((float(cfg["audio_sr"]) / 1000.0) * float(cfg["frame_shift_ms"]) / 32.0)
    other = (2.0 * B * its * per_frame + n_frames * bins
             + B * HOP * (3 + 2 * (2 * order + 1) + 3)     # overlap-add, low-pass, int16
             + B * THREEFRY_OPS + B * BLOCK * (THREEFRY_OPS + UNIFORM_OPS))
    nbytes = n_frames * bins * item + B * HOP * 2
    return Bound(_time(products, other), nbytes / PEAK_BYTES_S)
