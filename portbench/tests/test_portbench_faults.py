"""The harness's check catches a broken timed path.

Each case drives a whole run on the CPU at a small size (the chip's look
skipped: ``harness.execute`` on a ``Run`` of the CPU), with the program
broken underneath the driver, and sees ``correct`` come out false under
the cell's own limits; the same run unbroken comes out true.  The faults
a cell of one chip can have: a step that returns its state unchanged,
half of the batch left out, an answer altered where it is produced.
"""

import time

import numpy as np
import pytest
import torch

from closed_loop_seeg_speech_synthesis_tpu_torch.ops import iir
from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import online, pipeline
from portbench import harness

SMALL_SEED = 2**31 + 4321


def run_cell(bench, here, cell, seconds):
    run = harness.Run(bench, cell, SMALL_SEED, seconds, False, "cpu", time.perf_counter(), here=here)
    return harness.execute(run)


def state_unchanged_replay(mp):
    # the filter's block recursion hands every block the first block's state
    walk = iir._boundary_states
    mp.setattr(iir, "_boundary_states",
               lambda A_L, q, s0: (s0.expand_as(q).clone(), walk(A_L, q, s0)[1]))


def half_blocks_replay(mp):
    vocode = pipeline._vocode

    def half(params, cfg, mel, inits):
        audio = vocode(params, cfg, mel, inits).clone()
        audio[len(audio) // 2 :] = 0
        return audio
    mp.setattr(pipeline, "_vocode", half)


def altered_frame_replay(mp):
    frames = pipeline._mel_frames

    def altered(params, cfg, eeg, plan=None):
        mel = frames(params, cfg, eeg, plan).clone()
        mel[len(mel) // 3] += 0.5
        return mel
    mp.setattr(pipeline, "_mel_frames", altered)


def state_unchanged_online(mp):
    mp.setattr(pipeline, "commit_carry", lambda carry, new, is_data: None)


def half_channels_online(mp):
    select = online.OnlineDecoder._select

    def half(self, packet):
        packet = select(self, packet).copy()
        packet[:, packet.shape[1] // 2 :] = 0
        return packet
    mp.setattr(online.OnlineDecoder, "_select", half)


def altered_answer_online(mp):
    emit = online.OnlineDecoder._emit_rows
    calls = [0]

    def altered(self, spec, sv, audio, av):
        calls[0] += 1
        if calls[0] == 5:
            spec = spec + 0.5
        return emit(self, spec, sv, audio, av)
    mp.setattr(online.OnlineDecoder, "_emit_rows", altered)


CASES = [("replay.seeg128_1024hz", 2.0, state_unchanged_replay),
         ("replay.seeg128_1024hz", 2.0, half_blocks_replay),
         ("replay.seeg128_1024hz", 2.0, altered_frame_replay),
         ("online.seeg128_1024hz", 0.5, state_unchanged_online),
         ("online.seeg128_1024hz", 0.5, half_channels_online),
         ("online.seeg128_2048hz", 0.5, altered_answer_online)]


@pytest.mark.parametrize("cell,seconds,fault", CASES, ids=lambda v: getattr(v, "__name__", str(v)))
def test_a_broken_timed_path_is_not_correct(bench, small_here, monkeypatch, cell, seconds, fault):
    fault(monkeypatch)
    result = run_cell(bench, small_here, cell, seconds)
    assert result["correct"] is False
    failed = [k for k, c in result["checks"].items() if not c["value"] <= c["limit"]]
    assert failed


@pytest.mark.parametrize("cell,seconds", [("replay.seeg128_1024hz", 2.0),
                                          ("online.seeg128_2048hz", 0.5)])
def test_a_sound_run_is_correct(bench, small_here, cell, seconds):
    result = run_cell(bench, small_here, cell, seconds)
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) >= {"setup_s"}
    assert all(np.isfinite(m["value"]) for m in result["metrics"].values())
