"""The 3xTF32 operands of the tensor-core Griffin-Lim kernel (K2/K4 at large
B) and the choice of regime.

``make_gl_audio_ops`` splits the forward and inverse DFT operands once into
hi + lo TF32 parts, packed in mma fragment order (``GLAudioOps.gl_tf32``).
Held here: the f32 operands are still make_rdft's float32 bytes (the JAX
package's ``pallas_gl._split_nyquist``); unpacked, hi has at most 10
explicit mantissa bits and hi + lo is the f32 operand within 2^-22
relative; a 3xTF32 product of frames with the packed parts (the frames split
in the same way, a_lo*b_lo dropped) is the float64 product to the f32 level.
Also the text anchors by which gl_kernel_probe.py builds its variants of the
kernel source (the float32 tensor-core kernel with one accumulator, the bf16
wgmma kernel with a fresh accumulator every 4 k-steps, the clock64 stamps).
"""

import importlib.util
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from closed_loop_seeg_speech_synthesis_tpu.ops import griffinlim as j_gl
from closed_loop_seeg_speech_synthesis_tpu.ops.pallas_gl import _split_nyquist

from closed_loop_seeg_speech_synthesis_tpu_torch.ops import cuda_gl
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import filter_design as t_fd
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import griffinlim as t_gl
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import iir as t_iir
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import tf32


@pytest.fixture(scope="module")
def ops():
    return cuda_gl.make_gl_audio_ops(t_gl.make_streaming_gl_ops(40, 16000.0, torch.float64),
                                     t_iir.sos_to_statespace(t_fd.gl_output_lowpass_sos()),
                                     torch.float64)


def _unpack(packed: torch.Tensor, forward: bool):
    """Inverse of the fragment packing: (hi, lo) as (256, 256) matrices."""
    pk = packed.numpy()
    hi, lo = np.full((256, 256), np.nan, np.float32), np.full((256, 256), np.nan, np.float32)
    lane = np.arange(32)
    for w, cols in enumerate(cuda_gl.fragment_columns(forward)):
        for s in range(pk.shape[1]):
            for nt, c0 in enumerate(cols):
                k, n = 8 * s + lane % 4, c0 + lane // 4
                hi[k, n], hi[k + 4, n], lo[k, n], lo[k + 4, n] = pk[w, s, nt].T
    return hi, lo


def _operand(forward: bool) -> np.ndarray:
    """make_rdft's f32 operand as the JAX package's Pallas kernels take it."""
    _, _, fcos, fsin, _, icos, isin, _ = _split_nyquist(j_gl.make_streaming_gl_ops(
        dtype=jnp.float64))
    parts = (fcos, fsin) if forward else (icos, isin)
    return np.concatenate([np.asarray(p) for p in parts], axis=1 if forward else 0)


@pytest.mark.parametrize("forward", [True, False])
def test_tf32_split_of_the_dft_operands(ops, forward):
    m = _operand(forward)
    f32 = ops.gl_f32[1 if forward else 2].numpy()
    assert f32.dtype == m.dtype == np.float32 and f32.tobytes() == m.tobytes()
    packed = ops.gl_tf32[0 if forward else 1]
    assert packed.dtype == torch.float32 and packed.shape == (8, 32, 4, 32, 4)
    assert packed.is_contiguous()
    hi, lo = _unpack(packed, forward)
    assert np.isfinite(hi).all() and np.isfinite(lo).all()  # every element placed
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()  # <= 10 mantissa bits
    err = np.abs(hi.astype(np.float64) + lo - m)
    assert (err <= 2.0**-22 * np.abs(m.astype(np.float64))).all()


@pytest.mark.parametrize("forward", [True, False])
def test_3xtf32_product_keeps_f32_accuracy(ops, rng, forward):
    """Frames (64, 256) times the packed operand as the kernel forms it:
    a_lo b_hi + a_hi b_lo + a_hi b_hi; within 2e-6 of the float64 product
    relative to the largest |entry| (measured ~7e-8; an f32 product ~6e-7),
    where single-pass TF32 misses by ~2.5e-4."""
    m = ops.gl_f32[1 if forward else 2].numpy().astype(np.float64)
    hi, lo = (p.astype(np.float64) for p in _unpack(ops.gl_tf32[0 if forward else 1], forward))
    a = (rng.randn(64, 256) * np.hanning(256)).astype(np.float32)
    a_hi, a_lo = (p.numpy().astype(np.float64) for p in tf32.tf32_split(torch.as_tensor(a)))
    ref = a.astype(np.float64) @ m
    three = a_lo @ hi + a_hi @ lo + a_hi @ hi
    one = a_hi @ hi
    scale = np.abs(ref).max()
    assert np.abs(three - ref).max() < 2e-6 * scale
    assert np.abs(one - ref).max() > 1e-4 * scale


def test_dft_operands_are_not_symmetric_in_f32(ops):
    """Why the kernels take all 256 rows of the forward operand: make_rdft's
    f32 cos and sin columns are not (anti)symmetric in n -> 256 - n (the f64
    angles round differently before the cos), so folding x[n] + x[256 - n]
    would change the result on hundreds of elements."""
    fm = ops.gl_f32[1].numpy()
    n = np.arange(1, 256)
    cos, sin = fm[:, :128], fm[:, 128:]
    assert (cos[n] != cos[256 - n]).sum() > 100 and (sin[n] != -sin[256 - n]).sum() > 100
    np.testing.assert_allclose(cos[n], cos[256 - n], atol=1e-6)


def test_tf32_round_is_nearest_ties_away():
    x = np.array([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-11 + 2.0**-20, -(1.0 + 2.0**-11),
                  1.0 + 2.0**-12, 0.0], np.float32)
    expected = np.array([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0, 0.0],
                        np.float32)
    np.testing.assert_array_equal(tf32.tf32_round(torch.as_tensor(x)).numpy(), expected)
    hi, lo = (p.numpy() for p in tf32.tf32_split(torch.as_tensor(x)))
    np.testing.assert_array_equal(hi.astype(np.float64) + lo, x.astype(np.float64))


@pytest.mark.parametrize("B,expected", [(1, "cluster"), (4, "cluster"),
                                        (cuda_gl.CLUSTER_MAX_B, "cluster"),
                                        (cuda_gl.CLUSTER_MAX_B + 1, "mma"), (180_000, "mma")])
def test_regime_by_number_of_blocks(B, expected):
    assert cuda_gl.regime(B) == expected


@pytest.mark.parametrize("B,expected", [(1, "cluster"), (cuda_gl.CLUSTER_MAX_B_BF16, "cluster"),
                                        (cuda_gl.CLUSTER_MAX_B_BF16 + 1, "mma"),
                                        (cuda_gl.CLUSTER_MAX_B, "mma"), (180_000, "mma")])
def test_bf16_regime_by_number_of_blocks(B, expected):
    """The bf16 variants cross lower (the wgmma kernel takes about as long at
    any B up to a wave); the float32 threshold does not apply to them."""
    assert cuda_gl.CLUSTER_MAX_B_BF16 < cuda_gl.CLUSTER_MAX_B
    assert cuda_gl.regime(B, bf16=True) == expected


def test_bf16_regime_threshold_is_read_at_each_call(monkeypatch):
    monkeypatch.setattr(cuda_gl, "CLUSTER_MAX_B_BF16", 0)
    assert cuda_gl.regime(1, bf16=True) == "mma" and cuda_gl.regime(1) == "cluster"
    monkeypatch.setattr(cuda_gl, "CLUSTER_MAX_B_BF16", 10**9)
    assert cuda_gl.regime(180_000, bf16=True) == "cluster" and cuda_gl.regime(180_000) == "mma"


def test_regime_threshold_is_read_at_each_call(monkeypatch):
    monkeypatch.setattr(cuda_gl, "CLUSTER_MAX_B", 0)
    assert cuda_gl.regime(1) == "mma"
    monkeypatch.setattr(cuda_gl, "CLUSTER_MAX_B", 10**9)
    assert cuda_gl.regime(180_000) == "cluster"


ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location("gl_kernel_probe", ROOT / "gl_kernel_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_probe_one_accumulator_variant_matches_the_source(probe):
    """The variant differs from csrc/gl_audio.cu only in gl_mma_kernel's
    per-k-step accumulator."""
    src = (ROOT / probe.SRC).read_text()
    one_acc = probe.variants(src)["one_acc"]
    assert one_acc != src and one_acc.replace(probe.ONE_ACC[1], probe.ONE_ACC[0]) == src


def test_probe_grouped_variant_matches_the_source(probe):
    """The variant differs from csrc/gl_audio.cu only in the wgmma kernel's
    products: a fresh accumulator every 4 k-steps, added in fp32."""
    src = (ROOT / probe.SRC).read_text()
    grouped = probe.variants(src)["grouped"]
    assert grouped != src and grouped.replace(probe.GROUPED[1], probe.GROUPED[0]) == src
    assert "wg::mma_rs<TRANS_B>(\n          part, a[s]," in grouped


def test_probe_atan2f_variant_matches_the_source(probe):
    """The variant differs from csrc/gl_audio.cu only in the wgmma kernel's
    exp(angle) phase step: libdevice's atan2f for the Cephes atan2."""
    src = (ROOT / probe.SRC).read_text()
    libdevice = probe.variants(src)["atan2f"]
    assert libdevice != src and libdevice.replace(probe.ATAN2F[1], probe.ATAN2F[0]) == src
    assert src.count("atan2_cephes(xi, xr)") == 1


@pytest.mark.parametrize("kernel", ["gl_mma_kernel", "gl_cluster_kernel", "gl_wgmma_kernel"])
def test_probe_stamps_every_phase_of_the_kernel(probe, kernel):
    """Each Griffin-Lim kernel of csrc/gl_audio.cu gets its launch stamp and
    one stamp after each of its phase anchors, inside its own body."""
    timed = probe.variants((ROOT / probe.SRC).read_text())["stamps"]
    start = timed.index(f" {kernel}(")
    body = timed[start : timed.index("\n}\n", start)]
    stamps = {"gl_mma_kernel": probe.MMA_STAMPS, "gl_cluster_kernel": probe.CLUSTER_STAMPS,
              "gl_wgmma_kernel": probe.WGMMA_STAMPS}[kernel]
    assert body.count("STAMP(127);") == 1
    for _, k in stamps:
        assert body.count(f"STAMP(8 * it + {k});") == 1
    assert 'extern "C" int probe_stamps_read(' in timed


def test_probe_refuses_a_source_without_its_anchors(probe):
    src = (ROOT / probe.SRC).read_text()
    with pytest.raises(ValueError, match="anchor"):
        probe.variants(src.replace(probe.ONE_ACC[0], ""))
    with pytest.raises(ValueError, match="anchor"):
        probe.variants(src.replace(probe.CLUSTER_STAMPS[0][0], "  {\n"))
    with pytest.raises(ValueError, match="anchor"):
        probe.variants(src.replace(probe.GROUPED[0], ""))
