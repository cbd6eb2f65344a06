"""The online closed-loop slice: the port's packet-by-packet step and host
loop against the JAX package, in float64 on the CPU.

The step is held against the JAX ``make_online_step`` packet by packet with
the same Griffin-Lim inits (drawn by JAX and passed in as a table indexed by
global block index): the spectrogram to rtol 1e-9 / atol 1e-11 and the audio
within 1 int16 LSB, as tests/test_pipeline.py holds the JAX step against the
JAX offline decode.  With its own default inits the port's online step
reproduces the port's offline decode, which is what the block-indexed
inits are for.
"""

import configparser
import dataclasses
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from closed_loop_seeg_speech_synthesis_tpu.cli import decode as j_decode
from closed_loop_seeg_speech_synthesis_tpu.cli import dev_streamer as j_streamer
from closed_loop_seeg_speech_synthesis_tpu.models import lda as j_lda
from closed_loop_seeg_speech_synthesis_tpu.ops import griffinlim as j_gl
from closed_loop_seeg_speech_synthesis_tpu.runtime import audio as j_audio
from closed_loop_seeg_speech_synthesis_tpu.runtime import pipeline as j_pipe

from closed_loop_seeg_speech_synthesis_tpu_torch.cli import decode as t_decode
from closed_loop_seeg_speech_synthesis_tpu_torch.cli import dev_streamer as t_streamer
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import audio as t_audio
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import online as t_online
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params as t_params
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import pipeline as t_pipe
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import streams as t_streams
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import tracing as t_tracing

RATES = [(1024.0, 32), (2048.0, 64)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The step's ops are tiny: on one thread each runs inline, where under
    a loaded test machine (several test processes on a few cores) every
    parallel region waits for threads that are not scheduled and a test of
    a second takes minutes.  The thread count is restored after the file."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(rng, C, n_feats=16, bad=()):
    return dict(lda_coef=rng.randn(40, 9, n_feats) * 0.3, lda_intercept=rng.randn(40, 9),
                lda_classes=np.tile(np.arange(9, dtype=np.int32), (40, 1)),
                lda_valid=np.ones((40, 9), bool), medians=np.sort(rng.randn(40, 9), axis=1),
                select=rng.permutation(5 * C)[:n_feats], bad_channels=np.asarray(bad, int))


def _jax_lda(arrs):
    return j_lda.LDAParams(coef=jnp.asarray(arrs["lda_coef"]),
                           intercept=jnp.asarray(arrs["lda_intercept"]),
                           classes=jnp.asarray(arrs["lda_classes"]),
                           valid=jnp.asarray(arrs["lda_valid"]))


def _port_decoder(arrs, sr, P, C):
    loaded = t_params.from_arrays(**arrs)
    cfg = t_pipe.DecoderConfig(sr=sr, n_channels=C, packet_size=P, dtype=torch.float64)
    return cfg, t_pipe.build_decoder_params(cfg, loaded["lda"], loaded["medians"], loaded["select"],
                                            device="cpu")


def _run_port_step(step, carry, eeg, P):
    specs, chunks = [], []
    for i in range(0, len(eeg), P):
        carry, out = step(carry, torch.as_tensor(eeg[i : i + P]))
        specs.append(out["spec"][out["spec_valid"]].numpy())
        chunks.append(out["audio"][out["audio_valid"]].numpy())
    return np.concatenate(specs), np.concatenate(chunks).reshape(-1)


@pytest.mark.parametrize("sr,P", RATES)
def test_online_step_matches_jax_step(rng, sr, P):
    """f64, packet by packet: the port's step == the JAX step fed the same
    block inits (JAX default_rand_init rows, which are what its step draws)."""
    C = 5
    arrs = _arrays(rng, C)
    T = int(sr * 2) // P * P
    eeg = rng.randn(T, C) * 10.0
    jcfg = j_pipe.DecoderConfig(sr=sr, n_channels=C, packet_size=P, dtype=jnp.float64)
    jdec = j_pipe.build_decoder_params(jcfg, _jax_lda(arrs), arrs["medians"], arrs["select"])
    key = jax.random.PRNGKey(3)
    jstep = j_pipe.make_online_step(jdec, jcfg, key)
    jcarry = j_pipe.init_online_carry(jdec, jcfg)
    cfg, dec = _port_decoder(arrs, sr, P, C)
    table = np.asarray(j_gl.default_rand_init(key, int(T / sr * 100) + 2, 0, jnp.float64))
    step = t_pipe.make_online_step(dec, cfg, table)
    carry = t_pipe.init_online_carry(dec, cfg)
    n_spec = 0
    for i in range(0, T, P):
        jcarry, jout = jstep(jcarry, jnp.asarray(eeg[i : i + P]))
        carry, out = step(carry, torch.as_tensor(eeg[i : i + P]))
        for name in ("spec_valid", "audio_valid"):
            np.testing.assert_array_equal(out[name].numpy(), np.asarray(jout[name]))
        sv, av = np.asarray(jout["spec_valid"]), np.asarray(jout["audio_valid"])
        np.testing.assert_allclose(out["spec"].numpy()[sv], np.asarray(jout["spec"])[sv],
                                   rtol=1e-9, atol=1e-11)
        da = out["audio"].numpy()[av].astype(int) - np.asarray(jout["audio"])[av].astype(int)
        assert np.abs(da).max(initial=0) <= 1
        assert out["audio"].dtype == torch.int16 and out["spec"].dtype == torch.float64
        n_spec += int(sv.sum())
    assert int(carry.frame_k) == int(jcarry.frame_k) == n_spec > 0
    assert int(carry.next_e) == int(jcarry.next_e)
    np.testing.assert_allclose(carry.filt_state.numpy(), np.asarray(jcarry.filt_state), rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("sr,P", RATES)
def test_online_step_matches_port_offline_with_default_inits(rng, sr, P):
    """The repaired block inits: with no rand_init anywhere, the online step
    draws a block's inits from its global index and so reproduces the
    offline decode of the same samples (spectrogram bit-equal, audio within
    1 LSB), and an injected table gives the same as the seed it came from."""
    C = 4
    arrs = _arrays(rng, C)
    T = int(sr * 2) // P * P
    eeg = rng.randn(T, C) * 10.0
    cfg, dec = _port_decoder(arrs, sr, P, C)
    spec_off, audio_off = t_pipe.offline_decode(dec, cfg, eeg)
    spec_on, audio_on = _run_port_step(t_pipe.make_online_step(dec, cfg), t_pipe.init_online_carry(dec, cfg),
                                       eeg, P)
    assert spec_on.shape == tuple(spec_off.shape) and audio_on.shape == tuple(audio_off.shape)
    assert np.array_equal(spec_on, spec_off.numpy())
    assert np.abs(audio_on.astype(int) - audio_off.numpy().astype(int)).max() <= 1
    table = t_pipe.gl.default_rand_init(len(spec_on), 0, 0)
    spec_t, audio_t = _run_port_step(t_pipe.make_online_step(dec, cfg, table),
                                     t_pipe.init_online_carry(dec, cfg), eeg, P)
    assert np.array_equal(spec_t, spec_on) and np.array_equal(audio_t, audio_on)


@pytest.mark.parametrize("chunk_steps,pipelined", [(1, True), (4, False), (4, True)])
def test_dispatch_modes_bit_identical(rng, chunk_steps, pipelined):
    """OnlineDecoder with K-packet chunks and/or pipelined read-back decodes
    101 packets (a tail that is not a multiple of 4) bit-identically to
    single steps (tests/test_pipeline.py:113-133)."""
    C, P = 4, 32
    arrs = _arrays(rng, C)
    cfg, dec = _port_decoder(arrs, 1024.0, P, C)
    packets = [rng.randn(P, C) * 10.0 for _ in range(101)]
    outs = []
    for k, pl in ((1, False), (chunk_steps, pipelined)):
        d = t_online.OnlineDecoder(cfg, dec, chunk_steps=k, pipelined=pl)
        for p in packets:
            d.process_packet(p)
        outs.append(d.results())
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert outs[0][0].shape[1] == 40 and len(outs[0][1]) == (len(outs[0][0]) - 1) * 160


@pytest.mark.parametrize("chunk_steps,pipelined", [(1, False), (4, True)])
def test_short_init_table_raises_before_its_end(rng, chunk_steps, pipelined):
    """A table of Griffin-Lim inits shorter than the stream: the decoder
    emits the blocks the table covers and raises before the first block past
    its end reaches the sink."""
    C, P, rows = 4, 32, 20
    cfg, dec = _port_decoder(_arrays(rng, C), 1024.0, P, C)
    d = t_online.OnlineDecoder(cfg, dec, rand_source=t_pipe.gl.default_rand_init(rows),
                               chunk_steps=chunk_steps, pipelined=pipelined)
    with pytest.raises(ValueError, match=f"has {rows} rows"):
        for _ in range(40):
            d.process_packet(rng.randn(P, C))
        d.flush()
    assert 0 < len(d.audio_chunks) <= rows and len(d.sink.audio()) == 160 * len(d.audio_chunks)


def test_decoder_warmup_and_reset_keep_state(rng):
    """warmup() runs the step on zeros without advancing the carry; reset()
    returns to the state before the first packet; bad channels are dropped
    before the step and kept in the received record."""
    C, P = 4, 32
    arrs = _arrays(rng, C - 1, n_feats=12, bad=[2])
    cfg, dec = _port_decoder(arrs, 1024.0, P, C - 1)
    packets = [rng.randn(P, C) for _ in range(40)]
    d = t_online.OnlineDecoder(cfg, dec, bad_channels=[2])
    d.warmup()
    assert int(d.carry.sample_count) == cfg.prefill and int(d.carry.frame_k) == 0
    for p in packets:
        d.process_packet(p)
    first = d.results()
    d.reset()
    assert int(d.carry.frame_k) == 0 and d.spec_frames == []
    for p in packets:
        d.process_packet(p)
    second = d.results()
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    assert second[2].shape == (40 * P, C)
    spec_off, _ = t_pipe.offline_decode(dec, cfg, np.delete(np.vstack(packets), 2, axis=1))
    assert np.array_equal(first[0], spec_off.numpy())
    p = d.latency_report()
    assert set(p) == {"packet_in->launched", "launched->step_done", "step_done->audio_out",
                      "packet_in->audio_out"}
    assert all(set(q) == {50, 95, 99} and all(v >= 0 for v in q.values()) for q in p.values())


def _carry_tensors(carry):
    return [getattr(carry, f.name) for f in dataclasses.fields(t_pipe.OnlineCarry)]


@pytest.mark.parametrize("chunk_steps,pipelined", [(1, False), (1, True), (4, True)])
def test_reset_mid_stream_restores_the_static_carry(rng, chunk_steps, pipelined):
    """The carry is static: warmup and a reset() mid-stream (mid-chunk for
    K = 4, with outputs pending when pipelined) rewrite the decoder's own
    tensors, which its programs hold, with the initial values; the stream
    after the reset decodes as a fresh decoder decodes it."""
    C, P = 4, 32
    cfg, dec = _port_decoder(_arrays(rng, C), 1024.0, P, C)
    packets = [rng.randn(P, C) * 10.0 for _ in range(41)]
    d = t_online.OnlineDecoder(cfg, dec, chunk_steps=chunk_steps, pipelined=pipelined)
    tensors = _carry_tensors(d.carry)
    d.warmup()
    fresh = _carry_tensors(t_pipe.init_online_carry(dec, cfg))
    assert all(prog.carry is d.carry for prog in d.programs.values())
    assert sorted(d.programs) == sorted({1, chunk_steps}) and set(d.replays.values()) == {0}
    for p in packets[:25]:
        d.process_packet(p)
    assert int(d.carry.frame_k) > 0 and int(d.carry.sample_count) > cfg.prefill
    d.reset()
    assert all(a is b for a, b in zip(_carry_tensors(d.carry), tensors))
    assert all(torch.equal(a, b) for a, b in zip(tensors, fresh))
    assert d.spec_frames == [] and d.audio_chunks == [] and d.received == []
    for p in packets:
        d.process_packet(p)
    after = d.results()
    ref = t_online.OnlineDecoder(cfg, dec)
    for p in packets:
        ref.process_packet(p)
    for a, b in zip(after, ref.results()):
        np.testing.assert_array_equal(a, b)
    assert all(a is b for a, b in zip(_carry_tensors(d.carry), tensors))


@pytest.mark.parametrize("chunk_steps", [1, 4])
def test_pipelined_slots_are_not_overwritten_before_they_are_emitted(rng, chunk_steps):
    """With ``pipelined`` a run's outputs wait in a host slot while the next
    packet's run fills the other one: every emitted slot still holds the
    whole outputs (filler rows too) of the run it belongs to, as an eager
    loop of ``make_online_step`` (K = 1) or ``make_online_multi_step``
    (K = 4) gives them, the slots alternate, and the pending slot is never
    the one being emitted."""
    C, P, n = 4, 32, 40
    cfg, dec = _port_decoder(_arrays(rng, C), 1024.0, P, C)
    packets = [rng.randn(P, C) * 10.0 for _ in range(n)]
    step = t_pipe.make_online_step(dec, cfg)
    run = step if chunk_steps == 1 else t_pipe.make_online_multi_step(dec, cfg, step=step)
    carry, runs = t_pipe.init_online_carry(dec, cfg), []
    for i in range(0, n, chunk_steps):
        chunk = np.stack(packets[i : i + chunk_steps]) if chunk_steps > 1 else packets[i]
        carry, out = run(carry, torch.as_tensor(chunk))
        runs.append(out)
    d = t_online.OnlineDecoder(cfg, dec, chunk_steps=chunk_steps, pipelined=True)
    emitted, emit = [], d._emit

    def checked_emit(out, event=None):
        run = runs[len(emitted)]
        for k, v in out.items():
            assert torch.equal(v, run[k]), (len(emitted), k)
        if d._pending is not None:
            assert d._pending[0]["spec"].data_ptr() != out["spec"].data_ptr()
        emitted.append(out["spec"].data_ptr())
        emit(out, event)

    d._emit = checked_emit
    for i, p in enumerate(packets):
        d.process_packet(p)
        assert len(emitted) == max((i + 1) // chunk_steps - 1, 0)
    spec, audio, _ = d.results()
    assert len(emitted) == n // chunk_steps == d.replays[chunk_steps]
    assert len(set(emitted)) == 2 and all(a != b for a, b in zip(emitted, emitted[1:]))
    np.testing.assert_array_equal(spec, np.concatenate([o["spec"][o["spec_valid"]].numpy()
                                                        for o in runs]))
    np.testing.assert_array_equal(audio, np.concatenate([o["audio"][o["audio_valid"]].numpy()
                                                         for o in runs]).reshape(-1))


def test_online_matches_offline_512():
    """512 Hz (tests/test_pipeline_512.py): a 32-sample packet holds up to 7
    frame ends.  A model trained by the JAX package on 8 s of 3 channels;
    the port's online step and its OnlineDecoder, both with the key pair
    of ``PRNGKey(2)``, against the port's offline decode and the JAX
    offline decode with that key: spectrogram to rtol 1e-9 / atol 1e-10,
    audio within 1 LSB, float64 on the CPU."""
    from closed_loop_seeg_speech_synthesis_tpu.runtime import trainer as j_trainer

    sr, C, T, P = 512.0, 3, 4096, 32
    rs = np.random.RandomState(31)
    eeg = rs.randn(T, C)
    t = np.arange(int(T / sr * 48000)) / 48000.0
    res = j_trainer.train(eeg, 0.3 * np.sin(2 * np.pi * 200 * t), sr, 48000.0, bad_channels=[],
                          nb_feats=10)
    jcfg = j_pipe.DecoderConfig(sr=sr, n_channels=C, packet_size=P, dtype=jnp.float64)
    jdec = j_pipe.build_decoder_params(jcfg, res.lda, res.medians, res.select)
    key = jax.random.PRNGKey(2)
    spec_j, audio_j = j_pipe.offline_decode(jdec, jcfg, eeg, key=key)
    arrs = dict(lda_coef=np.array(res.lda.coef), lda_intercept=np.array(res.lda.intercept),
                lda_classes=np.array(res.lda.classes), lda_valid=np.array(res.lda.valid),
                medians=np.array(res.medians), select=np.array(res.select), bad_channels=[])
    cfg, dec = _port_decoder(arrs, sr, P, C)
    assert t_pipe.max_frames_per_packet(P, dec.shift_table.numpy()) > 4
    pair = tuple(int(k) for k in np.asarray(key))
    spec_t, audio_t = t_pipe.offline_decode(dec, cfg, eeg, seed=pair)
    step = t_pipe.make_online_step(dec, cfg, pair)
    carry, most = t_pipe.init_online_carry(dec, cfg), 0
    for i in range(0, T, P):
        carry, out = step(carry, torch.as_tensor(eeg[i : i + P]))
        most = max(most, int(out["spec_valid"].sum()))
    assert most > 4
    online = [_run_port_step(step, t_pipe.init_online_carry(dec, cfg), eeg, P)]
    d = t_online.OnlineDecoder(cfg, dec, rand_source=pair)
    for i in range(0, T, P):
        d.process_packet(eeg[i : i + P])
    online.append(d.results()[:2])
    for spec_on, audio_on in online:
        for spec_ref, audio_ref in ((spec_t.numpy(), audio_t.numpy()),
                                    (np.asarray(spec_j), np.asarray(audio_j))):
            assert spec_on.shape == spec_ref.shape and audio_on.shape == audio_ref.shape
            np.testing.assert_allclose(spec_on, spec_ref, rtol=1e-9, atol=1e-10)
            assert np.abs(audio_on.astype(int) - audio_ref.astype(int)).max() <= 1


@pytest.mark.parametrize("sizes", [[32] * 5, [7, 50, 3, 64, 36], [160], [1] * 70, [0, 31, 1, 97]])
def test_packet_rebuffer_split_and_merged_chunks(rng, sizes):
    """Arbitrary inlet chunks (split, merged, empty, oversized) come out as
    exact 32-sample packets in order, the remainder carried over."""
    C = 3
    data = rng.randn(sum(sizes), C).astype(np.float32)
    rb = t_online.PacketRebuffer(32, C)
    out, pos = [], 0
    for n in sizes:
        out += rb.push(data[pos : pos + n])
        pos += n
    full = len(data) // 32
    assert len(out) == full and all(p.shape == (32, C) for p in out)
    if full:
        np.testing.assert_array_equal(np.vstack(out), data[: full * 32])


def test_tracer_percentiles():
    tr = t_tracing.StageTracer()
    for _ in range(20):
        tr.mark("packet_in")
        tr.mark("step_done")
    assert all(type(t) is float for t in tr.events["packet_in"] + tr.events["step_done"])
    lat = tr.latencies("packet_in", "step_done")
    assert lat.shape == (20,) and (lat >= 0).all()
    p = tr.percentiles("packet_in", "step_done")
    assert p[50] <= p[95] <= p[99]
    assert np.isnan(t_tracing.StageTracer().percentiles("a", "b")[50])


def test_audio_sinks_match_jax(rng):
    """The sinks are the JAX package's: the bounded-drop queue policy, the
    streaming resampler (chunk-size invariant, same output), and make_sink's
    fallback to NullSink where no audio library imports."""
    x = rng.randn(3000).astype(np.float32)
    for ratio in (3.0, 44100 / 16000, 0.5):
        ours, theirs = t_audio.StreamingResampler(ratio), j_audio.StreamingResampler(ratio)
        a = np.concatenate([ours.process(x[i : i + 160]) for i in range(0, 3000, 160)])
        b = np.concatenate([theirs.process(x[i : i + 377]) for i in range(0, 3000, 377)])
        n = min(len(a), len(b))
        np.testing.assert_allclose(a[:n], b[:n], rtol=1e-6, atol=1e-6)
    q = t_audio.BoundedBlockQueue(block_size=4, max_blocks=2)
    q.push(np.arange(13))
    assert len(q) == 2 and q.dropped_blocks == 1
    assert list(q.pop()) == [0, 1, 2, 3] and q.pop() is not None and q.pop() is None
    assert q.xruns == 1
    sink = t_audio.make_sink("buffer")
    sink.write(np.ones(5, np.int16))
    assert isinstance(sink, t_audio.BufferSink) and len(sink.audio()) == 5
    assert isinstance(t_audio.make_sink("null"), t_audio.NullSink)


def test_streams_pick_a_backend_and_recordings_must_be_hdf5(tmp_path):
    """The dev streamer reads recordings through io.loaders as the JAX
    streamer does: HDF5 or XDF by extension, any other file refused."""
    assert t_streams.backend_name("nsx") == "nsx" and t_streams.backend_name("lsl") == "lsl"
    assert t_streams.backend_name() in ("lsl", "nsx")
    assert t_streamer.load_speech_file.__module__.endswith("_torch.io.loaders")
    with pytest.raises(ValueError, match="unknown recording format"):
        t_streamer.load_speech_file(str(tmp_path / "rec.wav"))


def test_jax_streamer_feeds_port_decoder_over_nsx(rng, tmp_path, monkeypatch):
    """The closed loop across the two packages over the NSX transport: the
    JAX dev streamer replays a recording, the port's online CLI path decodes
    it packet by packet (float64, the JAX inits injected), and the output
    equals the JAX offline decode of the same samples, as
    tests/test_online_loopback.py:57-105 holds the JAX decoder."""
    monkeypatch.setenv("NSX_REGISTRY_DIR", str(tmp_path / "nsx"))
    (tmp_path / "nsx").mkdir()
    sr, C, bad, n_packets = 1024, 4, [1], 96
    arrs = _arrays(rng, C - 1, n_feats=12, bad=bad)
    streamed = (rng.randn(n_packets * 32, C) * 10.0).astype(np.float32)
    j_loaded = {"medians": arrs["medians"], "bad_channels": arrs["bad_channels"],
                "select": arrs["select"], "lda": _jax_lda(arrs)}
    spec_ref, audio_ref, _, _ = j_decode.perform_offline_decoding(
        j_loaded, streamed.astype(np.float64), sr, 10, dtype=jnp.float64)
    table = np.asarray(j_gl.default_rand_init(jax.random.PRNGKey(0), len(spec_ref), 0,
                                              jnp.float64))
    config = configparser.ConfigParser()
    config["Decoding"] = {"stream_name": "port_sEEG", "marker_stream_name": "port_Mk",
                          "griffin_lim_norm": "10"}
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    results, errors = {}, []

    def decode():
        try:
            results["out"] = t_decode.perform_online_decoding(
                config, t_params.from_arrays(**arrs), 10, str(run_dir), max_packets=n_packets,
                backend="nsx", dtype=torch.float64, device="cpu", rand_init=table)
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)

    marker_stop = threading.Event()
    markers = threading.Thread(target=j_streamer.stream_fake_markers,
                               kwargs={"interval": 0.3, "stream_name": "port_Mk",
                                       "stop_event": marker_stop, "backend": "nsx"})
    t = threading.Thread(target=decode)
    t.start()
    markers.start()
    j_streamer.stream_eeg(streamed, sr, "port_sEEG", asap=True, backend="nsx",
                          wait_for_consumers=60.0)
    t.join(timeout=240)
    marker_stop.set()
    markers.join(timeout=10)
    assert not t.is_alive() and not errors, errors
    spec_on, audio_on, received, sfreq = results["out"]
    assert sfreq == sr
    np.testing.assert_array_equal(received, streamed)
    assert spec_on.shape == np.asarray(spec_ref).shape
    np.testing.assert_allclose(spec_on, np.asarray(spec_ref), rtol=1e-9, atol=1e-10)
    assert np.abs(audio_on.astype(int) - np.asarray(audio_ref).astype(int)).max() <= 1
    assert (run_dir / "first_timestamp.npy").exists()
    assert "start;" in (run_dir / "markers.csv").read_text()


def test_asap_streamer_feeds_online_decode_every_packet(rng, tmp_path, monkeypatch):
    """``dev_streamer --asap`` -> ``perform_online_decoding`` over NSX on the
    CPU.  The decoder reads the stream's rate and channel count without
    subscribing, builds and warms up (slowed here by 1.5 s, longer than the
    1 s an NSX outlet waits on a subscriber that does not read, as building
    the kernels on the card can take), and only then subscribes; so every
    packet the unpaced sender sends is received, and decoded as a direct
    OnlineDecoder run of the same packets decodes it."""
    import time

    monkeypatch.setenv("NSX_REGISTRY_DIR", str(tmp_path / "nsx"))
    (tmp_path / "nsx").mkdir()
    sr, C, n_packets = 1024, 4, 96
    arrs = _arrays(rng, C, n_feats=12)
    streamed = (rng.randn(n_packets * 32, C) * 10.0).astype(np.float32)
    events = []
    build, inlet, warmup = t_decode._build_decoder, t_streams.StreamInlet, t_online.OnlineDecoder.warmup

    def slow_build(*args, **kwargs):
        time.sleep(1.5)
        events.append("built")
        return build(*args, **kwargs)

    def recorded_inlet(name, *args, **kwargs):
        events.append(f"subscribed {name}")
        return inlet(name, *args, **kwargs)

    def recorded_warmup(self):
        warmup(self)
        events.append("warm")

    monkeypatch.setattr(t_decode, "_build_decoder", slow_build)
    monkeypatch.setattr(t_streams, "StreamInlet", recorded_inlet)
    monkeypatch.setattr(t_online.OnlineDecoder, "warmup", recorded_warmup)
    config = configparser.ConfigParser()
    config["Decoding"] = {"stream_name": "asap_sEEG", "marker_stream_name": "asap_Mk",
                          "griffin_lim_norm": "10"}
    results, errors = {}, []

    def decode():
        try:
            results["out"] = t_decode.perform_online_decoding(
                config, t_params.from_arrays(**arrs), 10, str(tmp_path), max_packets=n_packets,
                backend="nsx", device="cpu")
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)

    t = threading.Thread(target=decode)
    t.start()
    t_streamer.stream_eeg(streamed, sr, "asap_sEEG", asap=True, backend="nsx",
                          wait_for_consumers=60.0)
    t.join(timeout=240)
    assert not t.is_alive() and not errors, errors
    assert events[:3] == ["built", "warm", "subscribed asap_sEEG"], events
    spec_on, audio_on, received, sfreq = results["out"]
    assert sfreq == sr
    np.testing.assert_array_equal(received, streamed)
    cfg, dec = _port_decoder(arrs, float(sr), 32, C)
    direct = t_online.OnlineDecoder(cfg, dec)
    for i in range(n_packets):
        direct.process_packet(streamed[32 * i : 32 * (i + 1)])
    spec_d, audio_d, _ = direct.results()
    np.testing.assert_array_equal(spec_on, spec_d)
    np.testing.assert_array_equal(audio_on, audio_d)


class _CutStream:
    """An inlet whose sender stops after ``n_chunks`` chunks of 64 samples."""

    name, channels = "cut", 4

    def __init__(self, rng, n_chunks):
        self.chunks = [rng.randn(64, self.channels).astype(np.float32) for _ in range(n_chunks)]

    def pull_chunk(self, max_samples=1024, timeout=1.0):
        if not self.chunks:
            raise ConnectionError("stream closed")
        return self.chunks.pop(0), 1.0


def test_run_stream_raises_on_a_stream_cut_short(rng):
    """A stream that closes before ``max_packets`` arrived is an error, never
    a short success; without ``max_packets`` (a live run stopped by the
    operator or the amplifier) the same stream ends cleanly with what came."""
    arrs = _arrays(rng, 4, n_feats=12)
    cfg, dec = _port_decoder(arrs, 1024.0, 32, 4)
    with pytest.raises(RuntimeError, match="'cut' ended after 6 of 10 packets"):
        t_online.OnlineDecoder(cfg, dec).run_stream(_CutStream(rng, 3), max_packets=10)
    _, _, received = t_online.OnlineDecoder(cfg, dec).run_stream(_CutStream(rng, 3))
    assert received.shape == (6 * 32, 4)
