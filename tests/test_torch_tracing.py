"""The port's tracing (``runtime/tracing.py``) on the CPU: ``span`` enters
``record_function`` only while a profiler records, the replay's and the
online loop's spans land in the profiler's trace in the order the decode
makes them, and the online decoder's stage marks split a packet's latency."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import online as t_online
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params as t_params
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import pipeline as t_pipe
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import tracing as t_tracing

C, P, SR = 4, 32, 1024.0
STAGES = ("packet_in", "launched", "step_done", "audio_out")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _decoder(dtype, device):
    rng = np.random.RandomState(7)
    loaded = t_params.from_arrays(
        lda_coef=rng.randn(40, 9, 12) * 0.3, lda_intercept=rng.randn(40, 9),
        lda_classes=np.tile(np.arange(9, dtype=np.int32), (40, 1)),
        lda_valid=np.ones((40, 9), bool), medians=np.sort(rng.randn(40, 9), axis=1),
        select=rng.permutation(5 * C)[:12], bad_channels=np.zeros(0, int), dtype=dtype,
        device=device)
    cfg = t_pipe.DecoderConfig(sr=SR, n_channels=C, packet_size=P, dtype=dtype)
    dec = t_pipe.build_decoder_params(cfg, loaded["lda"], loaded["medians"], loaded["select"],
                                      device=device)
    return cfg, dec


@pytest.fixture(scope="module")
def decoder():
    return _decoder(torch.float64, "cpu")


def _packets(n, seed=3):
    return list(np.random.RandomState(seed).randn(n, P, C) * 10.0)


def _seeg_spans(prof, tmp_path):
    """The ``seeg.*`` ranges of a finished profile, (name, start, end) in
    order of their start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("seeg.")]
    return sorted(spans, key=lambda s: s[1])


def test_span_is_a_no_op_without_a_profiler(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert t_tracing.span("seeg.x") is t_tracing.span("seeg.y")
    with t_tracing.span("seeg.x"):
        pass


def test_no_record_function_while_no_profiler_records(decoder, monkeypatch):
    """offline_decode and 8 packets of OnlineDecoder, with record_function
    made to raise: nothing enters it."""
    cfg, dec = decoder

    def refused(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)
    spec, audio = t_pipe.offline_decode(dec, cfg, np.vstack(_packets(40)))
    assert spec.shape[0] > 1 and audio.dtype == torch.int16
    d = t_online.OnlineDecoder(cfg, dec)
    for packet in _packets(8):
        d.process_packet(packet)
    assert len(d.results()[1]) > 0


def test_span_records_under_the_profiler(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t_tracing.span("seeg.x"):
            torch.ones(3).sum()
    assert [s[0] for s in _seeg_spans(prof, tmp_path)] == ["seeg.x"]


def test_offline_decode_spans(decoder, tmp_path):
    """One offline_decode: seeg.frontend enclosing seeg.frontend.plan, then
    seeg.inits and seeg.vocode, once each."""
    cfg, dec = decoder
    eeg = np.vstack(_packets(40))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t_pipe.offline_decode(dec, cfg, eeg)
    spans = _seeg_spans(prof, tmp_path)
    assert [s[0] for s in spans] == ["seeg.frontend", "seeg.frontend.plan", "seeg.inits",
                                     "seeg.vocode"]
    (_, f0, f1), (_, p0, p1), (_, i0, i1), (_, v0, v1) = spans
    assert f0 <= p0 and p1 <= f1
    assert f1 <= i0 and i1 <= v0


@pytest.mark.parametrize("chunk_steps,pipelined", [(1, False), (1, True), (4, True)])
def test_online_spans_one_dispatch_and_one_emit_each(decoder, tmp_path, chunk_steps, pipelined):
    """Every run of the online decoder's program is one seeg.online.dispatch
    and its outputs one seeg.online.emit, after it; no wait on the CPU,
    which has no event.  10 packets: with K = 4 two chunks and a tail of two
    single steps."""
    cfg, dec = decoder
    d = t_online.OnlineDecoder(cfg, dec, chunk_steps=chunk_steps, pipelined=pipelined)
    d.warmup()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for packet in _packets(10):
            d.process_packet(packet)
        d.results()
    names = [s[0] for s in _seeg_spans(prof, tmp_path)]
    runs = sum(d.replays.values())
    assert runs == (10 if chunk_steps == 1 else 4)
    assert set(names) == {"seeg.online.dispatch", "seeg.online.emit"}
    assert names.count("seeg.online.dispatch") == names.count("seeg.online.emit") == runs
    sent = 0
    for name in names:
        sent += 1 if name == "seeg.online.dispatch" else -1
        assert sent in ((0, 1, 2) if pipelined else (0, 1))


@pytest.mark.parametrize("chunk_steps,pipelined", [(1, False), (1, True), (4, True)])
def test_online_marks_split_each_dispatch(decoder, chunk_steps, pipelined):
    """packet_in <= launched <= step_done <= audio_out for every dispatch,
    and latency_report returns each interval and the whole."""
    cfg, dec = decoder
    d = t_online.OnlineDecoder(cfg, dec, chunk_steps=chunk_steps, pipelined=pipelined)
    for packet in _packets(10):
        d.process_packet(packet)
    d.results()
    marks = np.array([d.tracer.events[s] for s in STAGES])
    assert marks.shape == (4, sum(d.replays.values()))
    assert (np.diff(marks, axis=0) >= 0).all()
    report = d.latency_report()
    assert list(report) == ["packet_in->launched", "launched->step_done",
                            "step_done->audio_out", "packet_in->audio_out"]
    for p in report.values():
        assert 0 <= p[50] <= p[95] <= p[99]
    whole = report["packet_in->audio_out"]
    assert all(p[q] <= whole[q] for p in report.values() for q in p)


def test_persistent_decoder_reports_the_intervals_it_marks(decoder, tmp_path):
    """The persistent decoder has no launched mark: its report gives
    packet_in -> step_done -> audio_out; each output is one seeg.online.emit."""
    cfg, dec = decoder
    d = t_online.PersistentOnlineDecoder(cfg, dec)
    d.warmup()
    for packet in _packets(6):
        d.feed_packet(packet)
    d.feed_stop()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        d.run_until_stopped()
    assert [s[0] for s in _seeg_spans(prof, tmp_path)] == ["seeg.online.emit"] * 6
    assert list(d.latency_report()) == ["packet_in->step_done", "step_done->audio_out",
                                        "packet_in->audio_out"]


@pytest.mark.cuda
@pytest.mark.parametrize("pipelined", [False, True])
def test_online_spans_on_the_card(tmp_path, pipelined):
    """On the card each graph replay is one seeg.online.dispatch, and its
    outputs one seeg.online.wait on the slot's event followed by one
    seeg.online.emit; the marks keep their order."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels build with nvcc for sm_90a)")
    cfg, dec = _decoder(torch.float32, torch.device("cuda"))
    d = t_online.OnlineDecoder(cfg, dec, pipelined=pipelined)
    d.warmup()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for packet in _packets(10):
            d.process_packet(packet.astype(np.float32))
        d.results()
    names = [s[0] for s in _seeg_spans(prof, tmp_path)]
    assert d.replays == {1: 10}
    waits = [i for i, n in enumerate(names) if n == "seeg.online.wait"]
    assert names.count("seeg.online.dispatch") == len(waits) == 10
    assert all(names[i + 1] == "seeg.online.emit" for i in waits)
    assert names.count("seeg.online.emit") == 10
    marks = np.array([d.tracer.events[s] for s in STAGES])
    assert marks.shape == (4, 10) and (np.diff(marks, axis=0) >= 0).all()
