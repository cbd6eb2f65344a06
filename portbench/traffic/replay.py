"""Driver ``replay``: back-to-back replays of one recorded session, one caller.

Set-up makes the session on the card from the seed (``session_s`` seconds
at the configuration's rate and channels), replays it once to warm up, and
allocates the host buffers that the outputs are copied into: pinned, one
pair for every replay and one for the replay kept for the check, reused
from replay to replay as a replay service reuses them.  The window replays
the session again and again, each replay ``pipeline.offline_decode``
followed by the copy of its spectrogram and int16 audio into host memory,
as the decode CLI needs them, until ``--seconds`` have passed; the replay
running then finishes inside the window.  ``replay_xrt`` is the session
seconds decoded over the window's wall seconds.

A traced run (``--trace 1``) composes each replay from the three calls
``offline_decode`` makes (``_mel_frames``, ``gl.default_rand_init``,
``_vocode``), each in a range of its own so that the device's kernels fall
to their stage by their launch, and profiles the first ``trace_s`` seconds.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import bounds, inputs, program, profiling, schedule
from portbench.reference import frontend

KEEP_AMONG = 16  # the replay kept for the check is drawn from the seed among the first 16


def setup(run):
    with program.timed(run, "kernels_s"):
        program.load_kernels(run, ("frontend_decode", "gl_audio", "prng"))
    run.pcfg, run.params = program.decoder(run)
    T = int(round(float(run.traffic["session_s"]) * float(run.cfg["sr"])))
    with program.timed(run, "inputs_s"):
        run.eeg = inputs.session(run.cfg, T, run.seed, run.device)
    run.gl_seed = inputs.gl_seed(run.seed)
    n_frames = len(frontend.frame_ends(run.cfg, T))
    run.stage_bounds = {"frontend": bounds.frontend(run.cfg, T, n_frames),
                        "vocoder": bounds.vocoder(run.cfg, n_frames)}
    with program.timed(run, "warmup_s"):
        spec, audio = _decode(run)
        pinned = run.device.type == "cuda"
        run.host = [tuple(torch.empty(x.shape, dtype=x.dtype, pin_memory=pinned).fill_(0)
                          for x in (spec, audio)) for _ in range(2)]
        del spec, audio
        _replay(run, run.host[0])
        if run.trace:
            _replay_by_stage(run, run.host[0])


def _decode(run):
    from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import pipeline

    return pipeline.offline_decode(run.params, run.pcfg, run.eeg, seed=run.gl_seed)


def _copy_out(outs, host):
    """The outputs into the host buffers; returns them once the copy is done."""
    for x, h in zip(outs, host):
        h.copy_(x)
    return host


def _replay(run, host):
    return _copy_out(_decode(run), host)


def _replay_by_stage(run, host):
    from closed_loop_seeg_speech_synthesis_tpu_torch.ops import griffinlim as gl
    from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import pipeline

    p, c = run.params, run.pcfg
    with record_function("portbench.frontend"):
        mel = pipeline._mel_frames(p, c, run.eeg)
    with record_function("portbench.inits"):
        inits = gl.default_rand_init(mel.shape[0] - 1, 0, run.gl_seed, c.dtype, p.device)
    with record_function("portbench.vocode"):
        audio = pipeline._vocode(p, c, mel, inits)
    with record_function("portbench.copy_out"):
        return _copy_out((mel, audio), host)


def window(run):
    keep = int(np.random.default_rng(inputs.stream_seed(run.seed, 4)).integers(KEEP_AMONG))
    replay = _replay_by_stage if run.trace else _replay
    prof = profiling.Profile(run.device) if run.trace else None
    trace_s = float(run.traffic["trace_s"])
    kept, n = None, 0
    if prof:
        prof.start()
        span = record_function(profiling.WINDOW)
        span.__enter__()
    t0 = time.perf_counter()
    while True:
        out = replay(run, run.host[1] if n == keep else run.host[0])
        n += 1
        if n - 1 == keep:
            kept = out
        now = time.perf_counter()
        if prof and prof.host_s is None and (now - t0 >= trace_s or now - t0 >= run.seconds):
            span.__exit__(None, None, None)
            prof.stop()
            run.trace_units = n
        if now - t0 >= run.seconds:
            break
    t1 = time.perf_counter()
    run.profile = prof
    run.kept = [kept, out] if kept is not None else [out]
    run.attempted, run.failed = n, 0
    run.never_came = int(kept is None)
    run.info["replays finished"] = n
    run.info["window s"] = t1 - t0
    return {"replay_xrt": schedule.rate(n * float(run.traffic["session_s"]), t1 - t0)}


def answers(run):
    """The kept replays' outputs, and the program's state freed."""
    del run.params
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    out = []
    for i, (spec, audio) in enumerate(run.kept):
        if i and torch.equal(spec, run.kept[0][0]) and torch.equal(audio, run.kept[0][1]):
            continue  # the same answer again: judged once
        out.append({"spec": spec.numpy(), "audio": audio.numpy(), "eeg": run.eeg,
                    "never_came": run.never_came})
    return out
