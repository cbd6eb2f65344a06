"""The replay slice end to end: the port against the JAX package, both in
float64 on the CPU with the same Griffin-Lim inits (drawn by JAX and passed
in).  The spectrogram is gathered from the same exactly-rounded smoothing
lattice by the same labels, so it is bit-equal; the audio passes through the
chaotic exp(angle) Griffin-Lim iteration evaluated in another summation
order, so it is held within 1 int16 LSB."""

import configparser
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from closed_loop_seeg_speech_synthesis_tpu.cli import decode as j_decode
from closed_loop_seeg_speech_synthesis_tpu.models import lda as j_lda
from closed_loop_seeg_speech_synthesis_tpu.ops import framing as j_fr
from closed_loop_seeg_speech_synthesis_tpu.ops import griffinlim as j_gl

from closed_loop_seeg_speech_synthesis_tpu_torch.cli import decode as t_decode
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params as t_params
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import pipeline as t_pipe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The decoders' ops are small here: on one thread each runs inline,
    where under a loaded test machine (several test processes on a few
    cores) every parallel region waits for threads that are not scheduled.
    The thread count is restored after the file."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _session_arrays(rng, C_total, bad, n_feats=20):
    C = C_total - len(bad)
    valid = np.ones((40, 9), bool)
    valid[5, 3] = False
    valid[22, 0] = False
    return dict(lda_coef=rng.randn(40, 9, n_feats) * 0.3, lda_intercept=rng.randn(40, 9),
                lda_classes=np.tile(np.arange(9, dtype=np.int32), (40, 1)), lda_valid=valid,
                medians=np.sort(rng.randn(40, 9), axis=1),
                select=rng.permutation(5 * C)[:n_feats], bad_channels=np.asarray(bad))


def _jax_rand_init(n_samples, sr):
    prefill = j_fr.warm_start_prefill(50, 10, sr)
    n = len(j_fr.streaming_frame_ends(50, 10, sr, n_samples + prefill))
    return np.asarray(j_gl.default_rand_init(jax.random.PRNGKey(0), n - 1, 0, jnp.float64))


@pytest.mark.parametrize("sr", [1024.0, 2048.0, 4096.0])
def test_offline_decoding_matches_jax(rng, sr):
    """perform_offline_decoding in both packages: bad channels excluded, the
    same LDA / medians / select (converted by from_arrays).  4096 Hz has a
    period of 1,024 samples, over the 512 up to which the front-end kernels
    keep one slab."""
    C_total, bad = 10, [2, 7]
    arrs = _session_arrays(rng, C_total, bad)
    eeg = rng.randn(int(sr * 3), C_total) * 10.0
    j_loaded = {"medians": arrs["medians"], "bad_channels": arrs["bad_channels"],
                "select": arrs["select"],
                "lda": j_lda.LDAParams(coef=jnp.asarray(arrs["lda_coef"]),
                                       intercept=jnp.asarray(arrs["lda_intercept"]),
                                       classes=jnp.asarray(arrs["lda_classes"]),
                                       valid=jnp.asarray(arrs["lda_valid"]))}
    spec_j, audio_j, _, _ = j_decode.perform_offline_decoding(
        j_loaded, eeg, sr, 10.0, dtype=jnp.float64)  # key None: PRNGKey(0)
    spec_t, audio_t, _, _ = t_decode.perform_offline_decoding(
        t_params.from_arrays(**arrs), eeg, sr, 10.0, device="cpu",
        rand_init=_jax_rand_init(len(eeg), sr))
    spec_t, audio_t = spec_t.numpy(), audio_t.numpy()
    assert spec_t.shape == spec_j.shape == (len(spec_j), 40) and spec_t.dtype == np.float64
    assert np.array_equal(spec_t, np.asarray(spec_j))
    assert audio_t.shape == audio_j.shape == ((len(spec_j) - 1) * 160,)
    assert audio_t.dtype == np.int16
    assert np.abs(audio_t.astype(int) - np.asarray(audio_j).astype(int)).max() <= 1


def test_decode_cli_matches_jax_cli(rng, tmp_path):
    """Both CLIs replay the same file with the same params.h5 and write
    spectrogram.npy / audio.wav within the slice's tolerances."""
    import h5py
    from scipy.io import wavfile

    sr, C_total, bad = 1024, 6, [4]
    arrs = _session_arrays(rng, C_total, bad)
    session = tmp_path / "storage" / "demo"
    session.mkdir(parents=True)
    with h5py.File(session / "params.h5", "w") as hf:
        hf.create_dataset("bad_channels", data=np.asarray(bad, np.int64))
        hf.create_dataset("medians_array", data=arrs["medians"])
        hf.create_dataset("select", data=np.asarray(arrs["select"], np.int64))
        for name in ("lda_coef", "lda_intercept", "lda_classes", "lda_valid"):
            hf.create_dataset(name, data=arrs[name])
    eeg = (rng.randn(4 * sr, C_total) * 10.0).astype(np.float32)
    seeg_file = tmp_path / "replay.hdf"
    with h5py.File(seeg_file, "w") as hf:
        hf.create_dataset("sEEG", data=eeg)
        hf.create_dataset("sEEG_sr", data=sr, dtype=np.int32)
    cfg = configparser.ConfigParser()
    cfg["General"] = {"storage_dir": str(tmp_path / "storage"), "session": "demo"}
    cfg["Decoding"] = {"stream_name": "dev_sEEG", "griffin_lim_norm": "10", "run": "replay",
                       "overwrite_on_rerun": "True"}
    cfg_path = tmp_path / "experiment.ini"
    with open(cfg_path, "w") as f:
        cfg.write(f)
    inits = tmp_path / "inits.npy"
    np.save(inits, _jax_rand_init(len(eeg), float(sr)))

    j_dir = j_decode.main([str(cfg_path), "--seeg_file", str(seeg_file), "--run", "jax"])
    t_dir = t_decode.main([str(cfg_path), "--seeg_file", str(seeg_file), "--run", "torch",
                           "--device", "cpu", "--rand_init", str(inits)])
    for f in ["audio.wav", "sEEG.hdf", "spectrogram.npy", "decode.ini", "decode.log"]:
        assert os.path.exists(os.path.join(t_dir, f)), f
    spec_j = np.load(os.path.join(j_dir, "spectrogram.npy"))
    spec_t = np.load(os.path.join(t_dir, "spectrogram.npy"))
    assert np.array_equal(spec_t, spec_j)
    rate_j, audio_j = wavfile.read(os.path.join(j_dir, "audio.wav"))
    rate_t, audio_t = wavfile.read(os.path.join(t_dir, "audio.wav"))
    assert rate_t == rate_j == 16000 and audio_t.dtype == audio_j.dtype == np.int16
    assert audio_t.shape == audio_j.shape
    assert np.abs(audio_t.astype(int) - audio_j.astype(int)).max() <= 1


def _cli_config(tmp_path):
    cfg = configparser.ConfigParser()
    cfg["General"] = {"storage_dir": str(tmp_path), "session": "demo"}
    cfg["Decoding"] = {"stream_name": "dev_sEEG", "griffin_lim_norm": "10", "run": "r"}
    cfg_path = tmp_path / "experiment.ini"
    with open(cfg_path, "w") as f:
        cfg.write(f)
    return cfg_path


@pytest.mark.parametrize("argv", [["--vocoder", "exact-host"],
                                  ["--profile", "{config}"], ["--dispatch-chunk", "0"]])
def test_decode_cli_rejects_unported_modes(tmp_path, argv):
    """The exact-host vocoder re-synthesizes an offline decode only (this
    config decodes a live stream), --profile takes a directory (here an
    existing file), and a dispatch chunk must hold a packet: the CLI says so
    and stops."""
    config = str(_cli_config(tmp_path))
    with pytest.raises(SystemExit) as exc:
        t_decode.main([config, "--device", "cpu", *(a.format(config=config) for a in argv)])
    assert exc.value.code == 2


@pytest.mark.parametrize("extra", [[], ["--dispatch-chunk", "4"]])
def test_decode_cli_persistent_decodes_a_streamed_session(rng, tmp_path, monkeypatch, extra):
    """``--persistent`` online: the port's dev streamer sends a session over
    NSX, the CLI decodes it with the persistent loop (its host loop on the
    CPU) and writes its artifacts; the received sEEG is what was sent and
    the spectrogram and audio are a direct OnlineDecoder run's.  With
    ``--dispatch-chunk 4`` the CLI warns that K is a per-packet knob and
    ignores it."""
    import threading

    import h5py
    import torch
    from scipy.io import wavfile

    from closed_loop_seeg_speech_synthesis_tpu_torch.cli import dev_streamer as t_streamer
    from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import online as t_online

    monkeypatch.setenv("NSX_REGISTRY_DIR", str(tmp_path / "nsx"))
    (tmp_path / "nsx").mkdir()
    sr, C, n_packets = 1024, 5, 48
    arrs = _session_arrays(rng, C, [])
    (tmp_path / "demo").mkdir()
    with h5py.File(tmp_path / "demo" / "params.h5", "w") as hf:
        hf.create_dataset("bad_channels", data=np.zeros(0, np.int64))
        hf.create_dataset("medians_array", data=arrs["medians"])
        hf.create_dataset("select", data=np.asarray(arrs["select"], np.int64))
        for name in ("lda_coef", "lda_intercept", "lda_classes", "lda_valid"):
            hf.create_dataset(name, data=arrs[name])
    streamed = (rng.randn(n_packets * 32, C) * 10.0).astype(np.float32)
    result, errors = {}, []

    def decode():
        try:
            result["run_dir"] = t_decode.main(
                [str(_cli_config(tmp_path)), "--persistent", "--device", "cpu", "--backend", "nsx",
                 "--max_packets", str(n_packets), *extra])
        except BaseException as e:  # surfaced by the assertion below
            errors.append(e)

    t = threading.Thread(target=decode)
    t.start()
    t_streamer.stream_eeg(streamed, sr, "dev_sEEG", asap=True, backend="nsx",
                          wait_for_consumers=60.0)
    t.join(timeout=240)
    assert not t.is_alive() and not errors, errors
    run_dir = result["run_dir"]
    for f in ["audio.wav", "sEEG.hdf", "spectrogram.npy", "decode.ini", "decode.log"]:
        assert os.path.exists(os.path.join(run_dir, f)), f
    with h5py.File(os.path.join(run_dir, "sEEG.hdf"), "r") as hf:
        np.testing.assert_array_equal(hf["sEEG"][:], streamed)
    loaded = t_params.from_arrays(**arrs)
    cfg = t_pipe.DecoderConfig(sr=float(sr), n_channels=C, gl_norm=10.0, dtype=torch.float64)
    dec = t_pipe.build_decoder_params(cfg, loaded["lda"], loaded["medians"], loaded["select"],
                                      device="cpu")
    ref = t_online.OnlineDecoder(cfg, dec)
    for i in range(n_packets):
        ref.process_packet(streamed[32 * i : 32 * (i + 1)])
    spec_r, audio_r, _ = ref.results()
    np.testing.assert_array_equal(np.load(os.path.join(run_dir, "spectrogram.npy")), spec_r)
    rate, audio = wavfile.read(os.path.join(run_dir, "audio.wav"))
    assert rate == 16000
    np.testing.assert_array_equal(audio, audio_r)
    with open(os.path.join(run_dir, "decode.log")) as f:
        warned = "per-packet-mode knob" in f.read()
    assert warned == bool(extra)


def test_decode_cli_device_cuda_needs_a_gpu(tmp_path, monkeypatch):
    """--device cuda where no GPU is visible stops the CLI; nothing carries
    on on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        t_decode.main([str(_cli_config(tmp_path)), "--device", "cuda"])
    assert exc.value.code == 2


@pytest.mark.parametrize("sr", [1024.0, 2048.0])
def test_split_offline_decode_equals_fused_on_cpu(rng, sr):
    """On the CPU both the fused and the split configuration run the plain
    stages (the kernels K1-K4 are chosen for float32 CUDA tensors only), so
    the split flags must not change the output: this pins the branch logic
    of offline_decode."""
    C_total, bad = 6, [1]
    arrs = _session_arrays(rng, C_total, bad)
    eeg = rng.randn(int(sr * 2), C_total) * 10.0
    loaded = t_params.from_arrays(**arrs)
    fused = t_decode.perform_offline_decoding(loaded, eeg, sr, 10.0, device="cpu")
    split = t_decode.perform_offline_decoding(loaded, eeg, sr, 10.0, device="cpu",
                                              use_cuda_epilogue=False, use_cuda_gl_tail=False)
    assert fused[0].shape == split[0].shape and fused[1].shape == split[1].shape
    assert all(bool((a == b).all()) for a, b in zip(fused[:2], split[:2]))
    cfg = t_pipe.DecoderConfig(sr=sr, n_channels=C_total - 1, use_cuda_epilogue=False,
                               use_cuda_gl_tail=False, dtype=loaded["lda"].coef.dtype)
    assert not cfg.use_cuda_epilogue and not cfg.use_cuda_gl_tail and cfg.packet_size == 32


def test_port_imports_no_jax():
    """The port, its CLIs, its online runtime, its trainer, its loaders, its
    evaluation (exp1-exp4, DTW, VAD, figures), its utilities, its host
    vocoder, its threefry keys and their kernel's wrapper, its parallel
    modules and its lab tools import neither jax nor
    the JAX package (nor pylsl, h5py, sklearn, matplotlib or tkinter at
    import time)."""
    code = ("import sys; import closed_loop_seeg_speech_synthesis_tpu_torch.cli.decode, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.cli.dev_streamer, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.cli.train, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.runtime.trainer, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.io.loaders, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.io.xdf, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.io.inspection, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.runtime.online, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.runtime.nsx, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.ops.cuda_frontend, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.ops.cuda_gl, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.ops.cuda_loop, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.ops.prng, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.ops.cuda_prng, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.ops.host_vocoder, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.cli.evaluate, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.eval.exp1, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.eval.exp2, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.eval.exp3, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.eval.exp4, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.eval.figures, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.eval.dtw, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.eval.vad, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.utils, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.parallel.mesh, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.parallel.sharded, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.parallel.distributed, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.cli.receive_markers, "
            "closed_loop_seeg_speech_synthesis_tpu_torch.cli.experiment_gui; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.split('.')[0] in ('closed_loop_seeg_speech_synthesis_tpu', 'pylsl', 'h5py', "
            "'matplotlib', 'sklearn', 'tkinter', '_tkinter')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
