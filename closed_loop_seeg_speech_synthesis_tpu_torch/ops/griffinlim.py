"""Streaming Griffin-Lim vocoder, batched over blocks, and the offline
evaluation vocoder (torch).

Port of ``closed_loop_seeg_speech_synthesis_tpu/ops/griffinlim.py``.  The
streaming half (reference ``livenodes/GriffinLim.py:64-174``): per 10 ms logMel frame, an
8-iteration Griffin-Lim on a 480-sample block built from the last two mel
frames (two 256-point Blackman frames, hop 160), then overlap-add with
window-sum normalization, 160 samples per frame.  The reference's phase term
is ``exp(angle(x))`` without the ``1j`` (GriffinLim.py:93), kept behind
``phase_bug=True``.

The block inits are the JAX package's: block b's 480 values are
``jax.random.uniform(jax.random.fold_in(key, b), (480,), dtype)``, keyed by
the global block index alone, so an online decoder that draws a few blocks
per packet and an offline decode of the same session agree, on the CPU and
on the card, bit for bit (``block_rand``: threefry from ``ops/prng.py``,
the kernel ``csrc/prng.cu`` on a CUDA tensor).  Every entry point also
takes ``rand_init`` as an array.

``offline_griffin_lim`` is the batch vocoder of the reference's offline
evaluation (local/offline.py:131-192), with its quirks.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import cuda_prng
from . import mel as mel_ops
from .stft import RDFT, blackman, hann_periodic, make_rdft
from ..runtime.tracing import span

FFT_SIZE = 256
HOP = 160
BLOCK_SAMPLES = 3 * HOP  # 480: blockLen = 2*contextWidth + 1 frames of 160


@dataclasses.dataclass
class StreamingGLOps:
    """Constants of the streaming vocoder."""

    rdft: RDFT
    window: torch.Tensor      # (FFT_SIZE,) blackman
    ola_window: torch.Tensor  # (BLOCK_SAMPLES,) blackman over the block
    Minv: torch.Tensor        # (n_mel, FFT_SIZE // 2 + 1)


def make_streaming_gl_ops(n_mel: int = 40, sample_rate: float = 16000.0,
                          dtype=torch.float64, device=None) -> StreamingGLOps:
    _, Minv = mel_ops.mel_matrices(FFT_SIZE // 2 + 1, n_mel, sample_rate)
    to = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return StreamingGLOps(rdft=make_rdft(FFT_SIZE, dtype, device),
                          window=to(blackman(FFT_SIZE)),
                          ola_window=to(blackman(BLOCK_SAMPLES)), Minv=to(Minv))


def _gl_iteration(wav: torch.Tensor, spec: torch.Tensor, ops: StreamingGLOps,
                  phase_bug: bool) -> torch.Tensor:
    """One Griffin-Lim iteration on (B, 480) given target |spec| (B, 2, 129)."""
    f0 = wav[:, 0:FFT_SIZE] * ops.window
    f1 = wav[:, HOP : HOP + FFT_SIZE] * ops.window
    frames = torch.stack([f0, f1], dim=1)  # (B, 2, N)
    xr, xi = ops.rdft.rfft(frames)         # (B, 2, K)
    if phase_bug:
        ang = torch.atan2(xi, xr)
        # bins 0 and N/2 are exactly real: np.angle gives 0 or +pi there; an
        # atan2 of a -0.0 imag would give -pi and blow exp(angle) up by e^2pi
        # (a strided slice, not a list index: a CUDA graph cannot record the
        # list's copy to the card)
        edge = torch.where(xr[..., :: xr.shape[-1] - 1] < 0, math.pi, 0.0).to(ang.dtype)
        ang = torch.cat([edge[..., :1], ang[..., 1:-1], edge[..., 1:]], dim=-1)
        zr = spec * torch.exp(ang)
        zi = torch.zeros_like(zr)
    else:
        r = torch.sqrt(xr * xr + xi * xi)
        safe = r > 0
        inv = torch.where(safe, 1.0 / torch.where(safe, r, torch.ones_like(r)), torch.zeros_like(r))
        zr = spec * torch.where(safe, xr * inv, torch.ones_like(r))
        zi = spec * (xi * inv)
    t = ops.rdft.irfft(zr, zi) * ops.window  # (B, 2, N)
    # in-block overlap-add; samples [416:480) stay zero (GriffinLim.py:69-74)
    pad = torch.nn.functional.pad
    return (pad(t[:, 0, :], (0, BLOCK_SAMPLES - FFT_SIZE))
            + pad(t[:, 1, :], (HOP, BLOCK_SAMPLES - HOP - FFT_SIZE)))


def streaming_gl_blocks(log_mels: torch.Tensor, rand_init: torch.Tensor, ops: StreamingGLOps,
                        num_iterations: int = 8, phase_bug: bool = True) -> torch.Tensor:
    """log_mels (N, n_mel); block b uses frames [b, b+1]; rand_init (N-1, 480).
    Returns the reconstructed block waveforms (N-1, 480), pre-OLA."""
    spec_frames = mel_ops.from_log_mels(log_mels, ops.Minv)          # (N, K)
    spec = torch.stack([spec_frames[:-1], spec_frames[1:]], dim=1)   # (B, 2, K)
    wav = rand_init.to(spec.dtype)
    for _ in range(num_iterations):
        wav = _gl_iteration(wav, spec, ops, phase_bug)
    return wav


def overlap_add_stream(re: torch.Tensor, ops: StreamingGLOps) -> torch.Tensor:
    """Chunk b = re[b][0:160] + re[b-1][160:320] + re[b-2][320:480], divided
    by the matching Blackman segment sums where nonzero (GriffinLim.py:144-166).
    re: (B, 480) -> audio (B*160,)."""
    B = re.shape[0]
    w = ops.ola_window
    s0, s1, s2 = re[:, :HOP], re[:, HOP : 2 * HOP], re[:, 2 * HOP :]
    z = re.new_zeros((1, HOP))
    acc = s0 + torch.cat([z, s1[:-1]], 0) + torch.cat([z, z, s2[:-2]], 0)
    rows = torch.arange(B, device=re.device)[:, None]
    wsum = (w[None, :HOP] + (rows >= 1).to(re.dtype) * w[None, HOP : 2 * HOP]
            + (rows >= 2).to(re.dtype) * w[None, 2 * HOP :])
    out = torch.where(wsum != 0, acc / torch.where(wsum != 0, wsum, torch.ones_like(wsum)), acc)
    return out.reshape(-1)


def to_int16(audio: torch.Tensor, norm_factor: float) -> torch.Tensor:
    """int16(clip(x / (norm*1.01), -0.99, 0.99) * 32767), truncating toward
    zero as C does — GriffinLim.py:174."""
    x = torch.clamp(audio / (norm_factor * 1.01), -0.99, 0.99) * (2**15 - 1)
    return x.to(torch.int16)


def block_rand(block_ids: torch.Tensor, seed=0, dtype=torch.float64) -> torch.Tensor:
    """Uniform [0, 1) inits (len(block_ids), 480) of the given global block
    indices: row r is ``jax.random.uniform(jax.random.fold_in(key,
    max(block_ids[r], 0)), (480,), dtype)`` with ``key`` = ``seed`` (an int
    seed, meaning ``PRNGKey(seed)``, or a key pair from ``ops/prng.py``),
    bit for bit.  The clamp is the online step's ``jnp.maximum(i, 0)``.  On
    a CUDA tensor one launch of ``csrc/prng.cu``, which reads nothing back
    to the host, so a captured step records it as one node."""
    return cuda_prng.block_inits(block_ids.long().contiguous(), seed, BLOCK_SAMPLES, dtype)


def default_rand_init(num_blocks: int, first_block_index: int = 0, seed=0,
                      dtype=torch.float64, device=None) -> torch.Tensor:
    """The JAX package's ``default_rand_init(key, num_blocks,
    first_block_index, dtype)``: the inits (num_blocks, 480) of blocks
    first_block_index .. first_block_index + num_blocks - 1 (see
    ``block_rand``), so ``default_rand_init(k, i)`` equals
    ``default_rand_init(i + k)[i:]``.  Traced as ``seeg.inits``."""
    with span("seeg.inits"):
        ids = torch.arange(first_block_index, first_block_index + num_blocks, device=device)
        return block_rand(ids, seed, dtype)


def offline_griffin_lim(spectrogram, rand_init=None, win_length: float = 0.05,
                        hop_size: float = 0.01, num_iterations: int = 8,
                        sample_rate: int = 16000, dtype=torch.float32, device=None) -> np.ndarray:
    """Batch Griffin-Lim over a full logMel spectrogram (N, n_mel); returns
    int16 audio (numpy).  ``rand_init``: the working buffer's initial values
    (2 * N * (win // 2 + 1),), drawn with ``np.random.rand`` as the
    reference draws them when None.

    Faithful to the reference quirks: ``lenWaveFile = frames * bins``; the
    working buffer is twice that and its random tail beyond the ISTFT output
    persists across iterations; ISTFT is unnormalized; final scaling to full
    int16 range by the max absolute value.
    """
    spectrogram = np.asarray(spectrogram)
    win = int(win_length * sample_rate)
    hop = int(win / (win_length / hop_size))
    n_bins = win // 2 + 1
    _, Minv = mel_ops.mel_matrices(n_bins, spectrogram.shape[1], sample_rate)
    to = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    spec = mel_ops.from_log_mels(to(spectrogram), to(Minv))

    n_spec = spec.shape[0]
    total = 2 * n_spec * spec.shape[1]
    if rand_init is None:
        rand_init = np.random.rand(total)
    wav = to(rand_init).clone()

    rdft = make_rdft(win, dtype, device)
    w = to(hann_periodic(win))
    frame_idx = torch.as_tensor(np.arange(n_spec)[:, None] * hop + np.arange(win)[None, :],
                                device=device)
    re_len = n_spec * hop
    # ISTFT only adds frames whose window fits strictly before re_len - win
    # (``range(0, len(x) - fftsize, hop)``, offline.py:158): trailing spec
    # rows are silently unused, a reference quirk kept here
    n_add = len(range(0, re_len - win, hop))
    add_idx = frame_idx[:n_add].reshape(-1)
    for _ in range(num_iterations):
        frames = wav[frame_idx] * w                     # (n_spec, win)
        xr, xi = rdft.rfft(frames)
        r = torch.sqrt(xr * xr + xi * xi)
        safe = r > 0
        inv = torch.where(safe, 1.0 / torch.where(safe, r, torch.ones_like(r)),
                          torch.zeros_like(r))
        zr = spec * torch.where(safe, xr * inv, torch.ones_like(xr))
        zi = spec * (xi * inv)
        t = rdft.irfft(zr, zi) * w                      # (n_spec, win)
        re = wav.new_zeros(re_len).index_add_(0, add_idx, t[:n_add].reshape(-1))
        wav[:re_len] = re
    rec = wav[:re_len].cpu().numpy()
    return np.int16(rec / np.max(np.abs(rec)) * 32767)
