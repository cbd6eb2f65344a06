"""The persistent online loop: the port's ``PersistentOnlineDecoder`` against
the JAX package's, and its own contract, in float64 on the CPU.

On the CPU the port runs the loop body as a host loop (queue -> step ->
masked commit -> emit), the plain version of the graph's device-side while
loop.  The JAX class runs its ``lax.while_loop`` with ``io_callback`` edges
on the CPU backend.  Both get the same Griffin-Lim inits (JAX's
``default_rand_init`` rows of ``PRNGKey(3)``, passed to the port as a table
indexed by global block index); the spectrogram is held to rtol 1e-9 /
atol 1e-11 and the audio within 1 int16 LSB, as tests/test_torch_online.py
holds the per-packet step.  Against the port's own ``OnlineDecoder`` the
output is bit-identical.
"""

import dataclasses
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from closed_loop_seeg_speech_synthesis_tpu.models import lda as j_lda
from closed_loop_seeg_speech_synthesis_tpu.ops import griffinlim as j_gl
from closed_loop_seeg_speech_synthesis_tpu.runtime import online as j_online
from closed_loop_seeg_speech_synthesis_tpu.runtime import pipeline as j_pipe

from closed_loop_seeg_speech_synthesis_tpu_torch.cli import dev_streamer as t_streamer
from closed_loop_seeg_speech_synthesis_tpu_torch.ops import cuda_loop
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import online as t_online
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params as t_params
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import pipeline as t_pipe

C = 5


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


def _arrays(rng, C, n_feats=16):
    return dict(lda_coef=rng.randn(40, 9, n_feats) * 0.3, lda_intercept=rng.randn(40, 9),
                lda_classes=np.tile(np.arange(9, dtype=np.int32), (40, 1)),
                lda_valid=np.ones((40, 9), bool), medians=np.sort(rng.randn(40, 9), axis=1),
                select=rng.permutation(5 * C)[:n_feats], bad_channels=np.zeros(0, int))


def _port_decoder(arrs, sr, P, C, dtype=torch.float64):
    loaded = t_params.from_arrays(**arrs)
    cfg = t_pipe.DecoderConfig(sr=sr, n_channels=C, packet_size=P, dtype=dtype)
    return cfg, t_pipe.build_decoder_params(cfg, loaded["lda"], loaded["medians"], loaded["select"],
                                            device="cpu")


def _carry_equal(a, b):
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(t_pipe.OnlineCarry))


def _session(dec, packets):
    for p in packets:
        dec.feed_packet(p)
    dec.feed_stop()
    return dec.run_until_stopped()


def _close(port, jax_out):
    spec_t, audio_t, recv_t = port
    spec_j, audio_j, recv_j = (np.asarray(a) for a in jax_out)
    assert spec_t.shape == spec_j.shape and len(spec_t) > 0
    np.testing.assert_allclose(spec_t, spec_j, rtol=1e-9, atol=1e-11)
    assert audio_t.shape == audio_j.shape and audio_t.dtype == np.int16
    assert np.abs(audio_t.astype(int) - audio_j.astype(int)).max() <= 1
    np.testing.assert_array_equal(recv_t, recv_j)


@pytest.mark.parametrize("sr,P", [(1024.0, 32), (2048.0, 64)])
def test_persistent_decoder_matches_jax(rng, sr, P):
    """8 packets queued, warmup (nothing emitted, the carry unchanged), the
    rest queued, STOP, one session; then a resumed session of 8 more."""
    arrs = _arrays(rng, C)
    n = int(sr * 1.5) // P
    packets = [rng.randn(P, C) * 10.0 for _ in range(n + 8)]
    first, more = packets[:n], packets[n:]
    key = jax.random.PRNGKey(3)
    jcfg = j_pipe.DecoderConfig(sr=sr, n_channels=C, packet_size=P, gl_norm=10.0,
                                dtype=jnp.float64)
    jdec = j_pipe.build_decoder_params(jcfg, j_lda.LDAParams(
        coef=jnp.asarray(arrs["lda_coef"]), intercept=jnp.asarray(arrs["lda_intercept"]),
        classes=jnp.asarray(arrs["lda_classes"]), valid=jnp.asarray(arrs["lda_valid"])),
        arrs["medians"], arrs["select"])
    cfg, dec = _port_decoder(arrs, sr, P, C)
    table = np.asarray(j_gl.default_rand_init(key, int(len(packets) * P / sr * 100) + 2, 0,
                                              jnp.float64))
    outs = {}
    for name, d in (("jax", j_online.PersistentOnlineDecoder(jcfg, jdec, key=key)),
                    ("port", t_online.PersistentOnlineDecoder(cfg, dec, rand_source=table))):
        for p in first[:8]:
            d.feed_packet(p)
        d.warmup()
        assert d.spec_frames == [] and d.audio_chunks == [] and len(d.received) == 8
        if name == "port":
            assert _carry_equal(d.carry, t_pipe.init_online_carry(dec, cfg))
        outs[name] = [_session(d, first[8:]), _session(d, more)]
    for port, jax_out in zip(outs["port"], outs["jax"]):
        _close(port, jax_out)
    assert len(outs["port"][1][0]) > len(outs["port"][0][0])  # the second session appends


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_persistent_decoder_bit_identical_to_online_decoder(rng, dtype):
    """The same packets through the port's OnlineDecoder and through the
    persistent loop, in two sessions: every output bit-equal."""
    arrs = _arrays(rng, C)
    cfg, dec = _port_decoder(arrs, 1024.0, 32, C, dtype)
    packets = [rng.randn(32, C) * 10.0 for _ in range(72)]
    ref = t_online.OnlineDecoder(cfg, dec)
    for p in packets:
        ref.process_packet(p)
    pers = t_online.PersistentOnlineDecoder(cfg, dec)
    _session(pers, packets[:40])
    out = _session(pers, packets[40:])
    for a, b in zip(ref.results(), out):
        np.testing.assert_array_equal(a, b)
    assert out[0].dtype == np.dtype(str(dtype).split(".")[1])
    assert len(pers.tracer.latencies("packet_in", "step_done")) == 72


class _BrokenInlet:
    """Two 32-sample chunks, then the amplifier link drops."""

    channels, nominal_srate = C, 1024

    def __init__(self, rng):
        self.rng, self.calls = rng, 0

    def pull_chunk(self, max_samples=64, timeout=0.25):
        self.calls += 1
        if self.calls > 2:
            raise OSError("amplifier link dropped mid-read")
        return self.rng.randn(32, self.channels).astype(np.float32), 1.0


def test_feeder_error_propagates_through_run_stream(rng):
    """A feeder crash releases the loop (its finally feeds STOP) and is raised
    in the caller, with the two packets that came before it decoded."""
    cfg, dec = _port_decoder(_arrays(rng, C), 1024.0, 32, C)
    d = t_online.PersistentOnlineDecoder(cfg, dec)
    t0 = time.time()
    with pytest.raises(OSError, match="amplifier link"):
        d.run_stream(_BrokenInlet(rng), max_packets=64)
    assert time.time() - t0 < 120
    assert len(d.received) == 2 and len(d.tracer.latencies("packet_in", "step_done")) == 2


def test_reset_drops_queued_packets_and_restores_the_carry(rng):
    """reset() rewrites the carry's own tensors with the initial state and
    drops what was queued; the next session decodes as a fresh decoder."""
    cfg, dec = _port_decoder(_arrays(rng, C), 1024.0, 32, C)
    packets = [rng.randn(32, C) * 10.0 for _ in range(40)]
    d = t_online.PersistentOnlineDecoder(cfg, dec)
    first = _session(d, packets)
    carry_tensors = [getattr(d.carry, f.name) for f in dataclasses.fields(t_pipe.OnlineCarry)]
    for p in packets[:5]:
        d.feed_packet(p)
    d.reset()
    assert d._queue.empty() and d.spec_frames == [] and d.received == []
    assert _carry_equal(d.carry, t_pipe.init_online_carry(dec, cfg))
    assert all(getattr(d.carry, f.name) is t for f, t in
               zip(dataclasses.fields(t_pipe.OnlineCarry), carry_tensors))
    second = _session(d, packets)
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)


def test_short_init_table_raises_and_stops_the_loop(rng):
    """A Griffin-Lim init table shorter than the session: the blocks it
    covers are emitted, the loop raises before the first block past its end
    reaches the sink, and no packet after that one is decoded."""
    rows = 20
    cfg, dec = _port_decoder(_arrays(rng, C), 1024.0, 32, C)
    d = t_online.PersistentOnlineDecoder(cfg, dec, rand_source=t_pipe.gl.default_rand_init(rows))
    with pytest.raises(ValueError, match=f"has {rows} rows"):
        _session(d, [rng.randn(32, C) for _ in range(40)])
    assert 0 < len(d.audio_chunks) <= rows and len(d.sink.audio()) == 160 * len(d.audio_chunks)
    assert not d._queue.empty()  # the packets after the raise stay undecoded


def test_process_packet_raises(rng):
    cfg, dec = _port_decoder(_arrays(rng, C), 1024.0, 32, C)
    with pytest.raises(NotImplementedError, match="feed_packet"):
        t_online.PersistentOnlineDecoder(cfg, dec).process_packet(np.zeros((32, C)))


def test_run_stream_over_nsx_from_the_asap_streamer(rng, tmp_path, monkeypatch):
    """The port's dev streamer, unpaced (--asap), feeds the persistent
    decoder over NSX: every packet is received, and decoded as the port's
    OnlineDecoder decodes the same packets."""
    monkeypatch.setenv("NSX_REGISTRY_DIR", str(tmp_path))
    sr, n_packets = 1024, 64
    arrs = _arrays(rng, C)
    streamed = (rng.randn(n_packets * 32, C) * 10.0).astype(np.float32)
    cfg, dec = _port_decoder(arrs, float(sr), 32, C)
    d = t_online.PersistentOnlineDecoder(cfg, dec)
    results, errors = {}, []

    def run():
        try:
            results["out"] = d.run_stream("pers_sEEG", max_packets=n_packets, backend="nsx")
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t_streamer.stream_eeg(streamed, sr, "pers_sEEG", asap=True, backend="nsx",
                          wait_for_consumers=60.0)
    t.join(timeout=240)
    assert not t.is_alive() and not errors, errors
    spec, audio, received = results["out"]
    np.testing.assert_array_equal(received, streamed)
    ref = t_online.OnlineDecoder(cfg, dec)
    for i in range(n_packets):
        ref.process_packet(streamed[32 * i : 32 * (i + 1)])
    spec_r, audio_r, _ = ref.results()
    np.testing.assert_array_equal(spec, spec_r)
    np.testing.assert_array_equal(audio, audio_r)


def test_card_only_pieces_refuse_cpu_tensors(rng):
    """The graph capture and the loop take CUDA buffers only; on the CPU
    they raise before anything is built (the decoder runs its host loop)."""
    cfg, dec = _port_decoder(_arrays(rng, C), 1024.0, 32, C)
    with pytest.raises(ValueError, match="records a CUDA graph"):
        t_pipe.capture_online_step(dec, cfg)
    packet = torch.zeros((32, C))
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_loop.PersistentLoop(0, packet, torch.zeros((), dtype=torch.int32), [packet])


def test_loop_bindings_match_the_c_entries(tmp_path):
    """ops/cuda_loop.py declares exactly the extern "C" entries of
    csrc/persistent_loop.cu, each with its number of parameters, and the
    source is hashed into the library's name (an edit rebuilds it)."""
    import re
    import shutil

    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import _build

    src = (_build.CSRC / "persistent_loop.cu").read_text()
    entries = {name: [p for p in params.split(",") if p.strip()]
               for name, params in re.findall(r'extern "C" [^(]*?\b(\w+)\(([^)]*)\)', src)}
    assert set(entries) == set(cuda_loop._SIGNATURES)
    for name, (argtypes, _) in cuda_loop._SIGNATURES.items():
        assert len(argtypes) == len(entries[name]), name
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    assert _build.digest("persistent_loop", copy) == _build.digest("persistent_loop")
    (copy / "persistent_loop.cu").write_text(src + "// edited\n")
    assert _build.digest("persistent_loop", copy) != _build.digest("persistent_loop")


def test_a_stale_carry_refuses_the_next_session_until_reset(rng):
    """A session that ends after the carry took a packet whose outputs were
    not emitted (here: the short init table raises on it) leaves the
    decoder stale: the next session and run_stream raise until reset(),
    after which it decodes as a fresh decoder with the same table."""
    rows = 20
    table = t_pipe.gl.default_rand_init(rows)
    cfg, dec = _port_decoder(_arrays(rng, C), 1024.0, 32, C)
    d = t_online.PersistentOnlineDecoder(cfg, dec, rand_source=table)
    packets = [rng.randn(32, C) for _ in range(40)]
    with pytest.raises(ValueError, match=f"has {rows} rows"):
        _session(d, packets)
    with pytest.raises(RuntimeError, match="call reset"):
        d.run_until_stopped()
    with pytest.raises(RuntimeError, match="call reset"):
        d.run_stream(_BrokenInlet(rng), max_packets=8)
    d.reset()
    fresh = t_online.PersistentOnlineDecoder(cfg, dec, rand_source=table)
    for a, b in zip(_session(d, packets[:4]), _session(fresh, packets[:4])):
        np.testing.assert_array_equal(a, b)
