"""Driver ``online_packets``: the amplifier's packets, one ``process_packet`` each.

Set-up makes a session on the card from the seed, as long as the window
holds packets (one due every packet_size / sr seconds: 31.25 ms in both
deployments), copies it to the host as the amplifier's packets, builds
``OnlineDecoder`` (one graph replay a packet, ``pipelined=False``,
``chunk_steps=1``) and warms it up.  The window is an open loop: packet i
falls due at start + i * period and is handed to the decoder then, or at
once if the decoder is still busy.  Without pipelining ``process_packet``
returns once the packet's audio is in the sink, so the harness's own clock
read on its return is the packet's arrival; latency runs from the due time
to the arrival: ``online_p50_ms`` and ``online_p99_ms`` over every packet.

A traced run profiles the first ``trace_packets`` packets.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import inputs, program, profiling, schedule

LEAD_S = 0.02  # the first packet falls due this long after the window opens


def period(run) -> float:
    return int(run.cfg["packet_size"]) / float(run.cfg["sr"])


def make_packets(run):
    """The window's packets (n, packet_size, C) on the host; the session on the device."""
    P, C = int(run.cfg["packet_size"]), int(run.cfg["n_channels"])
    n = schedule.packet_count(run.seconds, period(run))
    run.eeg = inputs.session(run.cfg, n * P, run.seed, run.device)
    run.packets = run.eeg.cpu().numpy().reshape(n, P, C)
    run.gl_seed = inputs.gl_seed(run.seed)


def setup(run):
    from closed_loop_seeg_speech_synthesis_tpu_torch.runtime import online

    with program.timed(run, "kernels_s"):
        program.load_kernels(run, ("gl_audio", "prng"))
    run.pcfg, run.params = program.decoder(run)
    with program.timed(run, "inputs_s"):
        make_packets(run)
    run.decoder = online.OnlineDecoder(run.pcfg, run.params, rand_source=run.gl_seed)
    with program.timed(run, "warmup_s"):
        run.decoder.warmup()


def window(run):
    dec, packets, T = run.decoder, run.packets, period(run)
    n_trace = min(int(run.traffic["trace_packets"]), len(packets)) if run.trace else 0
    prof = profiling.Profile(run.device) if n_trace else None
    handed, arrived = [], []
    if prof:
        prof.start()
        span = record_function(profiling.WINDOW)
        span.__enter__()
    due = schedule.due_times(time.perf_counter() + LEAD_S, T, len(packets))
    for i, packet in enumerate(packets):
        waiting = record_function("portbench.wait_due") if i < n_trace else contextlib.nullcontext()
        with waiting:
            handed.append(schedule.wait_until(due[i]))
        dec.process_packet(packet)
        arrived.append(time.perf_counter())
        if i + 1 == n_trace:
            span.__exit__(None, None, None)
            prof.stop()
    run.profile, run.trace_units = prof, n_trace
    return finish(run, due, handed, arrived)


def finish(run, due, handed, arrived):
    """The end-to-end numbers of an online window, and its counts."""
    lat = schedule.latencies(due, arrived)
    n = len(due)
    run.attempted, run.failed = n, n - len(arrived)
    run.never_came = n - len(arrived)
    late = np.asarray(handed) - due[: len(handed)]
    run.info["packets sent"] = len(handed)
    run.info["packets received"] = len(arrived)
    run.info["generator lateness p99 ms"] = schedule.percentile_ms(late, 99) if len(late) else None
    if not len(lat):
        return {}
    run.info["latency max ms"] = float(lat.max() * 1e3)
    return {"online_p50_ms": schedule.percentile_ms(lat, 50),
            "online_p99_ms": schedule.percentile_ms(lat, 99)}


def answers(run):
    spec, audio, _ = run.decoder.results()
    del run.decoder, run.params
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return [{"spec": spec, "audio": audio, "eeg": run.eeg, "never_came": run.never_came}]
