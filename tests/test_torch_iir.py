"""Port ``iir_blocked`` against the JAX package's ``iir_blocked`` in float64:
the multichannel high-gamma chain, the single-channel vocoder low-pass, and
partial last blocks.  Both walk the same block operators; the JAX package's
boundary states come from an associative scan and the port's from a
sequential loop, so they agree to rounding (tolerance 1e-12 of the signal
scale)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from closed_loop_seeg_speech_synthesis_tpu.ops import filter_design as j_fd
from closed_loop_seeg_speech_synthesis_tpu.ops import iir as j_iir
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import iir as t_iir


def _both(ss_j, ss_t, block, x, s0):
    j_op = j_iir.make_blocked_iir(ss_j, block, jnp.float64)
    t_op = t_iir.make_blocked_iir(ss_t, block, torch.float64)
    yj, sj = j_iir.iir_blocked(j_op, jnp.asarray(x), jnp.asarray(s0))
    yt, st = t_iir.iir_blocked(t_op, torch.as_tensor(x), torch.as_tensor(s0))
    return (np.asarray(yj), np.asarray(sj)), (yt.numpy(), st.numpy())


def _close(a, b):
    scale = max(np.abs(b).max(), 1.0)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("sr,T", [(1024.0, 3 * 256), (1024.0, 3 * 256 + 77), (2048.0, 2 * 512 + 5)])
def test_iir_blocked_multichannel_matches_jax(rng, sr, T):
    chain = j_fd.high_gamma_bank(sr)
    ss = j_iir.cascade_statespace([j_iir.sos_to_statespace(s) for s in chain])
    ss_t = t_iir.cascade_statespace([t_iir.sos_to_statespace(s) for s in chain])
    block = 256 if sr == 1024.0 else 512
    x = rng.randn(T, 5) * 20.0
    s0 = rng.randn(ss.dim, 5)
    (yj, sj), (yt, st) = _both(ss, ss_t, block, x, s0)
    assert yt.shape == yj.shape == (T, 5)
    _close(yt, yj)
    _close(st, sj)


@pytest.mark.parametrize("block,T", [(160, 160 * 7), (160, 160 * 7 + 33), (4096, 5000)])
def test_iir_blocked_single_channel_lowpass_matches_jax(rng, block, T):
    """The C == 1 branch: the vocoder's 7.9 kHz output low-pass."""
    sos = j_fd.gl_output_lowpass_sos()
    x = rng.randn(T, 1)
    s0 = np.zeros((6, 1))
    (yj, sj), (yt, st) = _both(j_iir.sos_to_statespace(sos), t_iir.sos_to_statespace(sos),
                               block, x, s0)
    _close(yt, yj)
    _close(st, sj)
