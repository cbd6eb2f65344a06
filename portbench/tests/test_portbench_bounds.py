"""The stage bounds come from the configuration and shapes alone."""

import inspect

import pytest

from portbench import bounds, manifest


@pytest.fixture
def cfg():
    return manifest.config("seeg128_1024hz")


def test_bounds_take_only_shapes():
    assert list(inspect.signature(bounds.frontend).parameters) == ["cfg", "n_samples", "n_frames"]
    assert list(inspect.signature(bounds.vocoder).parameters) == ["cfg", "n_frames"]
    assert "closed_loop" not in inspect.getsource(bounds)


def test_the_30min_replay(cfg):
    T, N = 1_843_200, 180_000
    f = bounds.frontend(cfg, T, N)
    v = bounds.vocoder(cfg, N)
    # the front end streams 944 MB of sEEG: bytes bind, ~0.29 ms
    assert f.binds == "bytes" and f.seconds == pytest.approx(0.29e-3, rel=0.03)
    # Griffin-Lim's dense DFTs, 5.7e11 FLOP at 989 TFLOP/s, bind the vocoder
    dft = 2 * 179_999 * 8 * 2 * 256 * (256 + 129)
    assert dft == pytest.approx(5.68e11, rel=0.01)
    assert v.binds == "operations" and dft / bounds.PEAK_DENSE_FLOPS < v.seconds < 0.8e-3
    assert bounds.chain_sections(cfg) == 24


def test_the_pipes_overlap(cfg):
    # products, the float32 rest and the bytes run at once: the bound is
    # their largest time, so the vocoder's is its products' alone
    v = bounds.vocoder(cfg, 180_000)
    products = 2 * 179_999 * 8 * 2 * 256 * (256 + 129) + 2 * 180_000 * 40 * 129
    assert v.seconds == pytest.approx(products / bounds.PEAK_DENSE_FLOPS, rel=1e-12)
    assert bounds._time(1e12, 1e9) == pytest.approx(1e12 / bounds.PEAK_DENSE_FLOPS)
    assert bounds._time(1e9, 1e12) == pytest.approx(1e12 / bounds.PEAK_FP32_FLOPS)


def test_the_bounds_scale_with_the_work(cfg):
    cfg2 = dict(cfg, sr=2048, line_noise=60)
    assert bounds.chain_sections(cfg2) == 16
    assert bounds.frontend(cfg, 2_000_000, 200_000).seconds * 2 == pytest.approx(
        bounds.frontend(cfg, 4_000_000, 400_000).seconds, rel=0.01)
    converging = dict(cfg, phase_bug=False)
    assert bounds.vocoder(converging, 1000).ops_s > bounds.vocoder(cfg, 1000).ops_s
