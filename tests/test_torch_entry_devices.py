"""The port's entry points run on the card unless the caller asks for the CPU.

No GPU is visible in these tests (``torch.cuda.is_available`` is patched to
return False, so they mean the same on a machine with a card).  Each entry
point then stops before it computes anything: the CLIs with a usage error
that names ``--device cpu``, the functions with a RuntimeError.  Asked for
the CPU, each goes on to its first computing call, which a stand-in records
and stops (the whole CPU runs are tests/test_torch_{pipeline,online,train}.py).
"""

import configparser

import numpy as np
import pytest
import torch

from closed_loop_seeg_speech_synthesis_tpu_torch.cli import decode as t_decode
from closed_loop_seeg_speech_synthesis_tpu_torch.cli import evaluate as t_eval_cli
from closed_loop_seeg_speech_synthesis_tpu_torch.cli import train as t_train_cli
from closed_loop_seeg_speech_synthesis_tpu_torch.eval import exp1 as t_exp1
from closed_loop_seeg_speech_synthesis_tpu_torch.eval import exp1_batched as t_batched
from closed_loop_seeg_speech_synthesis_tpu_torch.eval import exp2 as t_exp2
from closed_loop_seeg_speech_synthesis_tpu_torch.io import session as t_session
from closed_loop_seeg_speech_synthesis_tpu_torch.parallel import distributed as t_dist
from closed_loop_seeg_speech_synthesis_tpu_torch.parallel import sharded as t_sharded
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import online as t_online
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import params as t_params
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import pipeline as t_pipe
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import streams as t_streams
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import trainer as t_trainer


class _Reached(Exception):
    """Raised by the stand-in for an entry point's first computing call."""


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _loaded(C):
    rs = np.random.RandomState(0)
    return t_params.from_arrays(rs.randn(40, 9, 10), rs.randn(40, 9),
                                np.tile(np.arange(9, dtype=np.int32), (40, 1)),
                                np.ones((40, 9), bool), np.sort(rs.randn(40, 9), axis=1),
                                rs.permutation(5 * C)[:10], [])


class _Inlet:
    nominal_srate, channels = 1024, 4

    def __init__(self, *args, **kwargs):
        pass


def _decoder_stand_in(seen):
    def build(loaded, sr, n_channels_total, gl_norm, dtype, device, *args, **kwargs):
        seen.append(torch.device(device))
        raise _Reached
    return build


def _decoder_stand_in_params(seen):
    def build(cfg, lda, medians, select, device=None, **kwargs):
        seen.append(torch.device(device))
        raise _Reached
    return build


def _case(name, monkeypatch, tmp_path, seen):
    """(call(cpu: bool), the error a default call raises) of one entry point;
    the stand-in appends the device the call reached its computation with."""
    if name in ("decode CLI", "train CLI", "evaluate CLI", "evaluate CLI exp2"):
        cli = {"decode CLI": t_decode, "train CLI": t_train_cli}.get(name, t_eval_cli)

        def load_config(path):
            seen.append(torch.device("cpu"))  # past the device check: --device cpu
            raise _Reached
        monkeypatch.setattr(cli.config_mod, "load_config", load_config)
        cfg = tmp_path / "experiment.ini"
        step = {"evaluate CLI": ["exp1"], "evaluate CLI exp2": ["exp2"]}.get(name, [])
        return (lambda cpu: cli.main([str(cfg)] + step + (["--device", "cpu"] if cpu else []))), SystemExit
    if name == "perform_offline_decoding":
        monkeypatch.setattr(t_decode, "_build_decoder", _decoder_stand_in(seen))
        eeg = np.zeros((2048, 4))
        return (lambda cpu: t_decode.perform_offline_decoding(
            _loaded(4), eeg, 1024, 10.0, **({"device": "cpu"} if cpu else {}))), RuntimeError
    if name in ("perform_online_decoding", "perform_online_decoding persistent"):
        monkeypatch.setattr(t_decode, "_build_decoder", _decoder_stand_in(seen))
        monkeypatch.setattr(t_streams, "stream_info", lambda *a, **k: (4, 1024.0))
        monkeypatch.setattr(t_streams, "StreamInlet", _Inlet)
        config = configparser.ConfigParser()
        config["Decoding"] = {"stream_name": "x"}
        return (lambda cpu: t_decode.perform_online_decoding(
            config, _loaded(4), 10, str(tmp_path), max_packets=1,
            persistent=name.endswith("persistent"),
            **({"device": "cpu"} if cpu else {}))), RuntimeError
    if name == "PersistentOnlineDecoder":
        def make_step(params, cfg, rand_source=0):
            seen.append(params.device)
            raise _Reached
        monkeypatch.setattr(t_pipe, "make_online_step", make_step)
        loaded = _loaded(4)
        cfg = t_pipe.DecoderConfig(sr=1024.0, n_channels=4, dtype=torch.float64)

        def call(cpu):
            dec = t_pipe.build_decoder_params(cfg, loaded["lda"], loaded["medians"],
                                              loaded["select"], **({"device": "cpu"} if cpu else {}))
            t_online.PersistentOnlineDecoder(cfg, dec).warmup()
        return call, RuntimeError
    if name == "Experiment1":
        def runner(*args, device=None, **kwargs):
            seen.append(torch.device(device))
            raise _Reached
        monkeypatch.setattr(t_batched, "FoldRunner", runner)
        eeg, audio, words, _ = t_session.make_synthetic_session(2, 1024, 48000, 4)
        config = configparser.ConfigParser()
        config["Experiment1"] = {"griffin_lim_norm": "10"}

        def call(cpu):
            session = t_session.Session.from_arrays(eeg, 1024, audio, 48000, words,
                                                    downsample_audio=False)
            e = t_exp1.Experiment1(config, None, str(tmp_path), session=session, bad_channels=[],
                                   **({"device": "cpu"} if cpu else {}))
            e.proposed_method(nb_folds=2)
        return call, RuntimeError
    if name == "Experiment2":
        monkeypatch.setattr(t_pipe, "build_decoder_params", _decoder_stand_in_params(seen))
        eeg, audio, words, _ = t_session.make_synthetic_session(2, 1024, 48000, 4)
        config = configparser.ConfigParser()
        config["Experiment2"] = {"griffin_lim_norm": "10"}

        def call(cpu):
            session = t_session.Session.from_arrays(eeg, 1024, audio, 48000, words)
            run = t_session.DecodingRun.from_arrays(np.zeros(16000 * 6, np.int16), 16000, eeg,
                                                    1024, [0.0, 3.0], words)
            e = t_exp2.Experiment2(config, None, "whisper", [], str(tmp_path), session=session,
                                   dec_run=run, other_tasks_eeg=eeg, model=_loaded(4),
                                   **({"device": "cpu"} if cpu else {}))
            e.chance_level_batched(runs=1)
        return call, RuntimeError
    if name in ("dryrun_dcn", "dryrun_dcn_train"):
        def spawn(kind, n_processes, backend, device, *args):
            seen.append(torch.device(device))
            raise _Reached
        monkeypatch.setattr(t_dist, "_spawn", spawn)
        dryrun = getattr(t_dist, name)
        return (lambda cpu: dryrun(2, backend="gloo", **({"device": "cpu"} if cpu else {}))), \
            RuntimeError
    if name in ("make_sharded_train_step", "distributed_train"):
        def blocked_iir(ss, block, dtype, device):
            seen.append(torch.device(device))
            raise _Reached
        monkeypatch.setattr(t_sharded.iir, "make_blocked_iir", blocked_iir)
        cfg = t_sharded.ShardedTrainConfig()
        if name == "distributed_train":
            return (lambda cpu: t_dist.distributed_train(
                None, cfg, np.zeros((1, 2048, 4)), np.zeros((1, 32000)),
                **({"device": "cpu"} if cpu else {}))), RuntimeError
        return (lambda cpu: t_sharded.make_sharded_train_step(
            None, cfg, 2048, 32000, 4, **({"device": "cpu"} if cpu else {}))), RuntimeError
    assert name in ("trainer.train", "train_decode_fold")

    def features(eeg, *args, **kwargs):
        seen.append(eeg.device)
        raise _Reached
    monkeypatch.setattr(t_trainer, "offline_features", features)
    eeg, audio = np.zeros((2048, 4)), np.zeros(96000)
    if name == "train_decode_fold":
        return (lambda cpu: t_exp1.train_decode_fold(
            1, eeg, audio, eeg, None, 1024, 48000, [], 10,
            **({"device": "cpu"} if cpu else {}))), RuntimeError
    return (lambda cpu: t_trainer.train(eeg, audio, 1024, 48000, [],
                                        **({"device": "cpu"} if cpu else {}))), RuntimeError


@pytest.mark.parametrize("name", ["decode CLI", "train CLI", "evaluate CLI",
                                  "perform_offline_decoding", "perform_online_decoding",
                                  "perform_online_decoding persistent", "PersistentOnlineDecoder",
                                  "trainer.train", "train_decode_fold", "Experiment1",
                                  "evaluate CLI exp2", "Experiment2", "make_sharded_train_step",
                                  "distributed_train", "dryrun_dcn", "dryrun_dcn_train"])
def test_entry_point_needs_the_card_unless_asked_for_the_cpu(no_gpu, monkeypatch, tmp_path,
                                                             capsys, name):
    seen = []
    call, error = _case(name, monkeypatch, tmp_path, seen)
    with pytest.raises(error) as exc:
        call(False)
    assert seen == []  # stopped before its first computing call
    if error is SystemExit:
        assert exc.value.code == 2 and "--device cpu" in capsys.readouterr().err
    else:
        assert "no CUDA device" in str(exc.value) and "device='cpu'" in str(exc.value)
    with pytest.raises(_Reached):
        call(True)
    assert seen == [torch.device("cpu")]


@pytest.mark.parametrize("device,expected", [(None, None), ("cuda", None), ("cuda:0", None),
                                             ("cpu", "cpu"), (torch.device("cpu"), "cpu")])
def test_resolve_device_defaults_to_the_card(no_gpu, device, expected):
    """None means the card; a CUDA device without a card raises; the CPU only
    when asked for."""
    if expected is None:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_pipe.resolve_device(device)
    else:
        assert t_pipe.resolve_device(device) == torch.device(expected)


def test_build_decoder_params_defaults_to_the_card(no_gpu):
    """The decoder's parameters are built on the card unless the CPU is asked
    for."""
    loaded = _loaded(4)
    cfg = t_pipe.DecoderConfig(sr=1024.0, n_channels=4, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_pipe.build_decoder_params(cfg, loaded["lda"], loaded["medians"], loaded["select"])
    dec = t_pipe.build_decoder_params(cfg, loaded["lda"], loaded["medians"], loaded["select"],
                                      device="cpu")
    assert dec.device == torch.device("cpu") and dec.gl_audio_ops.winv.device.type == "cpu"
