"""The FFT plan of the large-B Griffin-Lim kernel (``gl_fft_kernel``,
csrc/gl_audio.cu), emulated step for step by ``gl_fft_plan.py``, against the
dense make_rdft products: the two frames' forward DFTs from one complex FFT,
the inverse of two packed spectra under both phase estimators, and whole
Griffin-Lim iterations against ``cuda_gl._gl_loop_plain`` (float64 to
1e-12; float32 against the float64 result).  Also the twiddle table's bytes,
the exchange slots (a permutation, no bank conflict), the pairing of every
bin with its partner, and the kernel source's use of the same plan.
"""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import gl_fft_plan as plan

from closed_loop_seeg_speech_synthesis_tpu.ops import griffinlim as j_gl
from closed_loop_seeg_speech_synthesis_tpu.ops.pallas_gl import _split_nyquist

from closed_loop_seeg_speech_synthesis_tpu_torch.ops import cuda_gl
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import filter_design as t_fd
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import griffinlim as t_gl
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import iir as t_iir
from closed_loop_seeg_speech_synthesis_tpu_torch.ops.stft import make_rdft

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"float64": (torch.float64, torch.complex128), "float32": (torch.float32, torch.complex64)}
# float32 against float64, relative to the largest |value|: a 256-point FFT
# rounds in 8 stages of about 2^-24 each (on this test's inputs, seeds 0-2:
# 0.9e-7 to 1.7e-7 a transform, 2.2e-7 to 7.9e-7 a Griffin-Lim iteration,
# where the dense float32 products give 2.8e-7 to 1.4e-6)
F32_REL = 2e-6


@pytest.fixture(scope="module")
def ops():
    return cuda_gl.make_gl_audio_ops(t_gl.make_streaming_gl_ops(40, 16000.0, torch.float32),
                                     t_iir.sos_to_statespace(t_fd.gl_output_lowpass_sos()),
                                     torch.float32)


def _rdft(dtype):
    return make_rdft(256, dtype)


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def test_twiddle_table_is_float64_rounded_once():
    """cos and sin of the exact angles rounded once, then what the rounding
    left (the exact recompute's second part): hi + lo is the float64 value
    to float32's resolution squared."""
    ang = 2.0 * np.pi * np.arange(256) / 256
    cs = np.stack([np.cos(ang), np.sin(ang)], 1)
    tw = cuda_gl.twiddle_table()
    assert tw.dtype == torch.float32 and tw.shape == (256, 4) and tw.is_contiguous()
    assert tw[:, :2].numpy().tobytes() == cs.astype(np.float32).tobytes()
    lo = cs - cs.astype(np.float32).astype(np.float64)
    assert tw[:, 2:].numpy().tobytes() == lo.astype(np.float32).tobytes()
    assert np.abs(tw[:, :2].double().numpy() + tw[:, 2:].double().numpy() - cs).max() < 2.0**-48
    t64 = cuda_gl.twiddle_table(torch.float64)
    assert t64[:, :2].numpy().tobytes() == cs.tobytes() and not t64[:, 2:].any()
    # the 8-point DFT's cos(pi / 4) is entry 32's
    assert np.float32(0.70710678118654752) == tw[32, 0].item() == tw[32, 1].item()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_forward_fft_gives_both_frames_dfts(rng, dtype):
    """z = f0 + i f1 through the plan; X0 = (Z[k] + conj Z[256-k]) / 2 and
    X1 = (Z[k] - conj Z[256-k]) / 2i against make_rdft's forward products of
    each frame, bins 0..128."""
    rdt, cdt = DTYPES[dtype]
    f = torch.as_tensor(rng.randn(6, 2, 256) * np.hanning(256))
    rd = _rdft(torch.float64)
    ref = torch.complex(*rd.rfft(f))                                     # (6, 2, 129)
    Z = plan.natural(plan.forward(plan.to_lanes(torch.complex(f[:, 0], f[:, 1]).to(cdt)),
                                      cuda_gl.twiddle_table(rdt)))
    Zr = Z[:, (-torch.arange(129)) % 256].conj()
    X = torch.stack([(Z[:, :129] + Zr) / 2, (Z[:, :129] - Zr) / 2j], 1).to(torch.complex128)
    assert _rel(X, ref) < (1e-12 if rdt == torch.float64 else F32_REL)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("phase_bug", [True, False])
def test_inverse_fft_gives_both_frames(rng, dtype, phase_bug):
    """W = Y0 + i Y1, each spectrum extended Hermitian, through the plan's
    inverse over 256: frame 0 the real part and frame 1 the imaginary part
    of make_rdft's inverse products, under exp(angle) from real spectra (the
    imaginary part is 0), else from complex ones."""
    rdt, cdt = DTYPES[dtype]
    Y = torch.complex(torch.as_tensor(rng.randn(6, 2, 129)),
                      torch.as_tensor(rng.randn(6, 2, 129) * (0.0 if phase_bug else 1.0)))
    rd = _rdft(torch.float64)
    ref = rd.irfft(Y.real, Y.imag)                                      # (6, 2, 256)
    k = torch.arange(1, 128)
    W = torch.zeros(6, 256, dtype=torch.complex128)
    W[:, 0] = Y[:, 0, 0].real + 1j * Y[:, 1, 0].real
    W[:, 128] = Y[:, 0, 128].real + 1j * Y[:, 1, 128].real
    W[:, k] = Y[:, 0, k] + 1j * Y[:, 1, k]
    W[:, 256 - k] = Y[:, 0, k].conj() + 1j * Y[:, 1, k].conj()
    lanes = W[:, torch.as_tensor(plan.bins().reshape(32, 8))].to(cdt)
    y = plan.from_lanes(plan.inverse(lanes, cuda_gl.twiddle_table(rdt))) / 256
    out = torch.stack([y.real, y.imag], 1).double()
    assert _rel(out, ref) < (1e-12 if rdt == torch.float64 else F32_REL)


def _gl_inputs(rng, B):
    x = np.zeros((B + 1, 40))
    e = rng.randn(B + 1, 40) * 0.15
    for i in range(1, B + 1):
        x[i] = 0.95 * x[i - 1] + e[i]
    return (torch.as_tensor(x - 1.0, dtype=torch.float32),
            torch.as_tensor(rng.rand(B, 480), dtype=torch.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("phase_bug", [True, False])
def test_gl_iteration_matches_dense(ops, rng, dtype, phase_bug):
    """One Griffin-Lim iteration of 5 blocks as the kernel computes it (the
    lanes' slots, the phase step, the overlap-add), on the float32 Minv and
    window, against the dense products of ``_gl_loop_plain`` in float64
    (exact DFT): the float64 emulation within 1e-12 of the largest |sample|,
    the float32 one within F32_REL (and no further off than twice the plain
    float32 version)."""
    rdt, _ = DTYPES[dtype]
    lm, rand = _gl_inputs(rng, 5)
    minv, _, _, _, _, win = ops.gl_f32
    ref = cuda_gl._gl_loop_plain(lm, rand, ops, 1, phase_bug, torch.float64, bf16=False)
    out = plan.gl_blocks(lm, rand, minv, win.to(rdt), cuda_gl.twiddle_table(rdt), 1, phase_bug)
    assert out.dtype == rdt and out.shape == (5, 480)
    if rdt == torch.float64:
        assert _rel(out, ref) < 1e-12
    else:
        plain = cuda_gl._gl_loop_plain(lm, rand, ops, 1, phase_bug, torch.float32, bf16=False)
        assert _rel(out.double(), ref) < min(F32_REL, 2 * _rel(plain.double(), ref))


def test_gl_iterations_converging_match_dense(ops, rng):
    """8 iterations of the converging estimator in float64: within 1e-12 of
    the dense products (the iteration contracts, nothing amplifies)."""
    lm, rand = _gl_inputs(rng, 4)
    minv, _, _, _, _, win = ops.gl_f32
    ref = cuda_gl._gl_loop_plain(lm, rand, ops, 8, False, torch.float64, bf16=False)
    out = plan.gl_blocks(lm, rand, minv, win.double(), cuda_gl.twiddle_table(torch.float64), 8,
                           False)
    assert _rel(out, ref) < 1e-12
    zero = plan.gl_blocks(lm, rand, minv, win, cuda_gl.twiddle_table(), 0, True)
    assert torch.equal(zero, rand)


@pytest.mark.parametrize("phase_bug", [True, False])
def test_ill_conditioned_bins_are_summed_again(rng, phase_bug, monkeypatch):
    """Bin 37 of frame 0 made small (|X| ~ 1e-8 of the block's norm, the
    rounding of the float32 frame) and, under exp(angle), bin 100 of frame 1
    real and negative within 1e-8 of the branch cut: the phase step's
    inputs there are the frames' exact bins (float64 of the same float32
    frames) to float32's resolution; with the recompute turned off
    (TQ1 = TQ2 = 0) the FFT's rounding is 1e-3 or more of them (of the
    imaginary part at the cut, whose sign picks +-pi)."""
    n = torch.arange(256, dtype=torch.float64)
    w = torch.as_tensor(np.blackman(256))
    f = torch.as_tensor(rng.rand(5, 2, 256)) * w
    for h, kbin in ((0, 37), (1, 100)):  # f -= a cos + b sin (times w) so that bin kbin is ~0
        cn, sn = torch.cos(2 * np.pi * kbin * n / 256), torch.sin(2 * np.pi * kbin * n / 256)
        c, s = w * cn, w * sn
        m = torch.tensor([[(c * cn).sum(), (s * cn).sum()], [(c * sn).sum(), (s * sn).sum()]])
        ab = torch.linalg.solve(m, torch.stack([(f[:, h] * cn).sum(1), (f[:, h] * sn).sum(1)]))
        f[:, h] -= ab[0, :, None] * c + ab[1, :, None] * s
        if h == 1:  # then just below the cut: real and negative
            f[:, h] -= 0.3 * c
    f = f.float()
    z = plan.to_lanes(torch.complex(f[:, 0], f[:, 1]))
    exact = [plan.exact_bins(f[:, h].double(), torch.complex128) for h in (0, 1)]
    _, _, k = plan.slots()
    lane37, lane100 = (np.argwhere(k == kb)[0] for kb in (37, 100))

    def errors():
        _, x0, x1, _, _ = plan.phase_inputs(z, cuda_gl.twiddle_table(), phase_bug, f.double())
        e0 = ((x0[:, lane37[0], lane37[1]] / 2 - exact[0][:, 37]).abs() / exact[0][:, 37].abs())
        e1 = ((x1[:, lane100[0], lane100[1]].imag / 2 - exact[1][:, 100].imag).abs()
              / exact[1][:, 100].imag.abs())
        return e0.max().item(), e1.max().item()

    norm = f.double().norm(dim=(1, 2))
    assert (exact[0][:, 37].abs() < 1e-6 * norm).all()
    assert (exact[1][:, 100].real < 0).all() and (exact[1][:, 100].imag.abs() < 1e-6 * norm).all()
    e0, e1 = errors()
    assert e0 < 1e-6 and (e1 < 1e-6 or not phase_bug)
    monkeypatch.setattr(plan, "TQ1", 0.0)
    monkeypatch.setattr(plan, "TQ2", 0.0)
    e0, e1 = errors()
    assert e0 > 1e-3 and (e1 > 1e-3 or not phase_bug)


def test_cut_rule_keeps_the_error_budget_inputs_bin_at_the_cut(ops, monkeypatch):
    """The bin at the branch cut in the card's error-budget inputs
    (plan.CUT_SEED, CUT_B, CUT_BLOCK; |Im X| 2^-27 of the block's norm): one
    iteration under exp(angle) of the 32 blocks around it within F32_REL of
    float64; with the cut rule off (TQ2 = 0) block CUT_BLOCK is 1e-2 or more
    off at its first frame's centre, sample 128 (the flip)."""
    lo = plan.CUT_BLOCK - 16
    lm, rand = plan.walk_inputs(plan.CUT_SEED, plan.CUT_B, lo, 32)
    minv, _, _, _, _, win = ops.gl_f32
    ref = cuda_gl._gl_loop_plain(lm, rand, ops, 1, True, torch.float64, bf16=False)
    out = plan.gl_blocks(lm, rand, minv, win, cuda_gl.twiddle_table(), 1, True)
    assert _rel(out.double(), ref) < F32_REL
    monkeypatch.setattr(plan, "TQ2", 0.0)
    err = (plan.gl_blocks(lm, rand, minv, win, cuda_gl.twiddle_table(), 1, True).double()
           - ref).abs()
    assert err[plan.CUT_BLOCK - lo, 128] > 1e-2 and err[plan.CUT_BLOCK - lo, 128] == err.max()


def test_exchange_slots_are_a_permutation_without_bank_conflicts():
    """Both exchanges put every value of the warp in its own slot of the
    buffer, and each half-warp's 16 lanes on 16 bank pairs in every access."""
    lane, k = np.arange(32)[:, None], np.arange(8)
    a_b = plan.slot_a_to_b(lane, k)
    assert len(np.unique(a_b)) == 256 and a_b.max() < plan.SLOTS
    kb, kc, ap = np.meshgrid(np.arange(8), np.arange(8), np.arange(4), indexing="ij")
    b_c = plan.slot_b_to_c(kb, kc, ap)
    assert len(np.unique(b_c)) == 256 and b_c.max() < plan.SLOTS
    assert plan.bank_ways() == 1
    # exp(logmel) of two rows of 256 mel bins fits the buffer
    assert 2 * 256 <= 2 * plan.SLOTS


def test_every_bin_is_paired_with_its_partner_in_one_lane():
    """State C holds every bin once; each lane's 4 slots pair a bin k < 128
    with 256 - k, lane 0's slot 0 being DC and its position 2 Nyquist, so
    the slots cover bins 0..127 once."""
    b = plan.bins().reshape(32, 8)
    assert sorted(b.ravel().tolist()) == list(range(256))
    lo, hi, k = plan.slots()
    assert sorted(k.ravel().tolist()) == list(range(128))
    rows = np.arange(32)[:, None]
    assert ((b[rows, lo] + b[rows, hi]) % 256 == 0).all()
    assert (b[rows, lo] == k).all() and (k < 128).all()
    assert b[0, plan.NYQUIST] == 128 and k[0, 0] == 0 and hi[0, 0] == lo[0, 0]
    g = plan.groups()
    for lane in range(32):
        assert tuple(g[lane, 1]) == plan.partner(*g[lane, 0])


@pytest.mark.parametrize("forward", [True, False])
def test_cluster_operands_are_make_rdft_f32_bytes(ops, forward):
    """The cluster kernel and the plain version take make_rdft's float32
    matrices as the JAX package's Pallas kernels do
    (pallas_gl._split_nyquist), byte for byte."""
    _, _, fcos, fsin, _, icos, isin, _ = _split_nyquist(j_gl.make_streaming_gl_ops(
        dtype=jnp.float64))
    parts = (fcos, fsin) if forward else (icos, isin)
    m = np.concatenate([np.asarray(p) for p in parts], axis=1 if forward else 0)
    f32 = ops.gl_f32[1 if forward else 2].numpy()
    assert f32.dtype == m.dtype == np.float32 and f32.tobytes() == m.tobytes()


def test_kernel_source_runs_the_plan():
    """gl_fft_kernel's text uses the emulated plan: the exchange slots, the
    state C groups and positions (plan.LO, HI, HI_LANE0, NYQUIST) and the
    buffer's size."""
    src = (ROOT / "closed_loop_seeg_speech_synthesis_tpu_torch" / "csrc" / "gl_audio.cu").read_text()
    for text in ("buf[lane + 36 * k] = v[k];", "v[b] = buf[f.ab + 4 * b];", "f.ab = 36 * kb + ap;",
                 "buf[f.bc + 33 * k] = v[k];", "f.bc = 4 * kb + ap;", "f.c0 = 4 * kb0 + 33 * kc0;",
                 "f.c1 = 4 * kb1 + 33 * kc1;", "kc0 = (lane & 3) + 4 * (lane >> 4);",
                 "int kb0 = (lane >> 2) & 3", "if (lane >= 16 && kb0 == 0) kb0 = 4;",
                 "const float2 lo[4] = {v[0], v[1], v[5], v[4]};",
                 "const float2 hi[4] = {l0 ? v[0] : v[7], l0 ? v[3] : v[6], l0 ? v[6] : v[2],",
                 "l0 ? v[7] : v[3]};", "v[2] = l0 ? wnyq : wh[2];",
                 "constexpr int XSLOTS = 36 * 7 + 31 + 1;",
                 "constexpr float TQ1 = 0x1p-22f, TQ2 = 0x1p-34f;"):
        assert src.count(text) == 1, text
    assert plan.LO == (0, 1, 5, 4) and plan.HI == (7, 6, 2, 3)
    assert plan.HI_LANE0 == (0, 3, 6, 7) and plan.NYQUIST == 2
    assert plan.SLOTS == 36 * 7 + 31 + 1
    assert (plan.TQ1, plan.TQ2) == (2.0**-22, 2.0**-34)
    assert "gl_mma_kernel" not in src
