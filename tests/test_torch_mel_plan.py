"""``pipeline.mel_plan`` against the plan built from the whole array of
frame ends (``framing.streaming_frame_ends`` searched by
``framing.periodic_window_matrix``, K1's constants built per call), on the
CPU.  The plan counts the frames from the few around the input's end and
takes the window plan from the params' shift table; below two table
periods of frames it still searches the short array.  Rates: 512, 1024 and
2048 Hz (period 25), 1025 Hz (its x.5 ties give period 8) and 1000 Hz
(period 1 of 10 samples, shorter than a 50-sample window: no periodic plan).
K1's route is chosen on the CPU by standing in for the device check; there
``frontend_decode_mels`` runs its plain version."""

import dataclasses

import numpy as np
import pytest
import torch

from closed_loop_seeg_speech_synthesis_tpu_torch.ops import cuda_frontend, framing
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params as t_params
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import pipeline

RATES = [512.0, 1024.0, 2048.0, 1025.0, 1000.0]
ROUTES = ["plain", "k1", "k3"]


def _k1_anywhere(params, cfg):
    """``pipeline._runs_k1`` without its device check."""
    return (cfg.use_cuda_frontend and cfg.dtype == torch.float32
            and params.frontend_ops is not None)


def _decoder(sr, dtype=torch.float64, C=4, seed=0, **options):
    rs = np.random.RandomState(seed)
    valid = np.ones((40, 9), bool)
    valid[3, :5] = False
    loaded = t_params.from_arrays(rs.randn(40, 9, 12) * 0.3, rs.randn(40, 9),
                                  np.tile(np.arange(9, dtype=np.int32), (40, 1)), valid,
                                  np.sort(rs.randn(40, 9), axis=1), rs.permutation(5 * C)[:12],
                                  [], dtype=dtype)
    cfg = pipeline.DecoderConfig(sr=sr, n_channels=C, dtype=dtype, **options)
    return cfg, pipeline.build_decoder_params(cfg, loaded["lda"], loaded["medians"],
                                              loaded["select"], device="cpu")


def _per_call_constants(dec, cfg):
    consts = cuda_frontend.epilogue_constants(dec.lda_coef_full, dec.lda.intercept,
                                              dec.lda.valid, dec.lda.classes, dec.medians,
                                              dec.gauss_kernel, cfg.n_channels, cfg.model_order)
    return consts + (cuda_frontend.pack_lda_weights(consts[0], cfg.n_channels,
                                                    cfg.model_order + 1),)


def _oracle(dec, cfg, n_samples, k1_runs, constants=_per_call_constants):
    """The plan as it was built from the whole array of frame ends."""
    ends = framing.streaming_frame_ends(cfg.frame_len_ms, cfg.frame_shift_ms, cfg.sr,
                                        n_samples + cfg.prefill)
    pw = framing.periodic_window_matrix(ends, cfg.win)
    use_k1 = k1_runs and pw is not None
    plan = pipeline.MelPlan(n_samples=n_samples, n_frames=len(ends), ends=ends, window=None)
    if use_k1 and cfg.use_cuda_epilogue:
        plan.k1 = constants(dec, cfg)
    elif use_k1:
        plan.k3 = True
    elif pw is not None:
        S, Ls, P, origin = pw
        plan.window = (torch.as_tensor(S, dtype=cfg.dtype), Ls, P, origin)
    return plan


def _route(sr, route, monkeypatch):
    if route == "plain":
        return _decoder(sr)
    monkeypatch.setattr(pipeline, "_runs_k1", _k1_anywhere)
    return _decoder(sr, torch.float32, use_cuda_epilogue=route == "k1")


def _assert_same_plan(new, old):
    assert (new.n_samples, new.n_frames, new.k3) == (old.n_samples, old.n_frames, old.k3)
    assert (new.k1 is None) == (old.k1 is None)
    if new.k1 is not None:
        assert all(torch.equal(a, b) for a, b in zip(new.k1, old.k1))
    assert (new.window is None) == (old.window is None)
    if new.window is not None:
        assert torch.equal(new.window[0], old.window[0]) and new.window[1:] == old.window[1:]
    # the frame ends are built only where the plain aperiodic path reads them
    if new.k1 is None and not new.k3 and new.window is None:
        np.testing.assert_array_equal(new.ends, old.ends)
    else:
        assert new.ends is None


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("sr", RATES)
def test_plan_equals_the_array_search_at_every_short_length(sr, route, monkeypatch):
    """Every input length whose grid reaches three schedule periods of
    samples past the first frame: no frame, one, below and above two table
    periods of frames."""
    cfg, dec = _route(sr, route, monkeypatch)
    k1_runs = route != "plain"
    built = dec.k1[1] if dec.k1 is not None else None
    Ls = int(dec.shift_table_host.sum())
    for T in range(0, cfg.win + 3 * Ls - cfg.prefill + 1):
        plan = pipeline.mel_plan(dec, cfg, T)
        _assert_same_plan(plan, _oracle(dec, cfg, T, k1_runs, lambda d, c: built))
        if plan.k1 is not None:
            assert plan.k1 is built


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("sr", RATES)
def test_plan_equals_the_array_search_at_long_lengths(sr, route, monkeypatch):
    """Seeded random lengths up to 30 min, and 30 min itself (the replay
    cell's), without a search of the frame ends."""
    cfg, dec = _route(sr, route, monkeypatch)
    lengths = [int(1800 * sr)] + list(np.random.RandomState(int(sr)).randint(0, int(1800 * sr),
                                                                              4))
    before = pipeline.mel_plan.searched
    for T in lengths:
        _assert_same_plan(pipeline.mel_plan(dec, cfg, int(T)),
                          _oracle(dec, cfg, int(T), route != "plain"))
    assert pipeline.mel_plan.searched == before


@pytest.mark.parametrize("sr", RATES)
def test_frame_count_is_the_length_of_the_frame_ends(sr):
    """``framing.frame_count`` equals ``len(streaming_frame_ends)`` at every
    grid length to three table periods past the first frame and at seeded
    lengths up to 30 min."""
    fsize = framing.frame_size(50, sr)
    Ls = int(framing.shift_table(50, 10, sr).sum())
    lengths = list(range(0, fsize + 3 * Ls + 1)) + list(
        np.random.RandomState(1 + int(sr)).randint(0, int(1800 * sr), 8))
    for L in lengths:
        assert framing.frame_count(50, 10, sr, int(L)) == len(
            framing.streaming_frame_ends(50, 10, sr, int(L))), L


def test_only_short_inputs_search_the_frame_ends():
    """The 30-min plan at 1024 Hz searches nothing; a 3-frame input searches
    its 3 frame ends."""
    cfg, dec = _decoder(1024.0)
    before = pipeline.mel_plan.searched
    assert pipeline.mel_plan(dec, cfg, 1_843_200).n_frames == 180_000
    assert pipeline.mel_plan.searched == before
    T = 72 - cfg.prefill  # a grid of 72 samples: frames end at 51, 61 and 71
    assert pipeline.mel_plan(dec, cfg, T).n_frames == 3
    assert pipeline.mel_plan.searched == before + 1


@pytest.mark.parametrize("sr,seconds", [(1024.0, 3.0), (1024.0, 0.02), (1025.0, 2.0),
                                        (1000.0, 2.0)])
def test_mel_frames_are_identical_under_both_plans(sr, seconds):
    """``_mel_frames`` on the CPU gives the same frames, bit for bit, with the
    plan built from the frame ends and with the new one."""
    cfg, dec = _decoder(sr)
    x = torch.as_tensor(np.random.RandomState(5).randn(int(sr * seconds), cfg.n_channels))
    old = _oracle(dec, cfg, x.shape[0], False)
    new = pipeline.mel_plan(dec, cfg, x.shape[0])
    assert torch.equal(pipeline._mel_frames(dec, cfg, x, new),
                       pipeline._mel_frames(dec, cfg, x, old))


@pytest.mark.parametrize("use_cuda_epilogue", [True, False])
def test_kernel_route_frames_are_identical_under_both_plans(monkeypatch, use_cuda_epilogue):
    """K1's and K3's routes (their plain versions on the CPU, float32) give
    the same frames with the plan built per call and with the new one."""
    monkeypatch.setattr(pipeline, "_runs_k1", _k1_anywhere)
    cfg, dec = _decoder(1024.0, torch.float32, use_cuda_epilogue=use_cuda_epilogue)
    x = torch.as_tensor(np.random.RandomState(6).randn(3 * 1024 + 7, cfg.n_channels),
                        dtype=torch.float32)
    old = _oracle(dec, cfg, x.shape[0], True)
    new = pipeline.mel_plan(dec, cfg, x.shape[0])
    assert (new.k1 is not None) == use_cuda_epilogue and new.k3 != use_cuda_epilogue
    assert torch.equal(pipeline._mel_frames(dec, cfg, x, new),
                       pipeline._mel_frames(dec, cfg, x, old))


def test_k1_constants_are_built_once_per_model(monkeypatch):
    """Where K1 runs, ``build_decoder_params`` builds its epilogue constants
    and packed LDA fragments once, equal to the per-call ones; ``mel_plan``
    reuses them and builds nothing.  A config of other channels, and params
    with another LDA (``dataclasses.replace``, exp1's folds), get their own
    per call.  On the CPU, where K1 cannot run, nothing is built."""
    cfg, dec = _decoder(1024.0, torch.float32)
    assert dec.k1 is None
    monkeypatch.setattr(pipeline, "_runs_k1", _k1_anywhere)
    cfg, dec = _decoder(1024.0, torch.float32)
    assert dec.k1[0] == (cfg.n_channels, cfg.model_order)
    per_call = _per_call_constants(dec, cfg)
    assert len(dec.k1[1]) == len(per_call) == 5
    assert all(torch.equal(a, b) for a, b in zip(dec.k1[1], per_call))

    calls = []
    for name in ("epilogue_constants", "pack_lda_weights"):
        real = getattr(pipeline, name)
        monkeypatch.setattr(pipeline, name,
                            lambda *a, _real=real, _name=name: calls.append(_name) or _real(*a))
    assert pipeline.mel_plan(dec, cfg, 60 * 1024).k1 is dec.k1[1] and calls == []

    cfg2 = dataclasses.replace(cfg, n_channels=2)
    dec2 = dataclasses.replace(dec, lda_coef_full=dec.lda_coef_full[:, :, : 5 * 2].clone())
    assert dec2.k1 is None
    plan = pipeline.mel_plan(dec2, cfg2, 60 * 1024)
    assert calls == ["epilogue_constants", "pack_lda_weights"]
    assert all(torch.equal(a, b) for a, b in zip(plan.k1, _per_call_constants(dec2, cfg2)))
    calls.clear()
    dec.k1 = ((cfg2.n_channels, cfg2.model_order), dec.k1[1])
    pipeline.mel_plan(dec, cfg, 60 * 1024)
    assert calls == ["epilogue_constants", "pack_lda_weights"]
