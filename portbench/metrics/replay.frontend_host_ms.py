"""replay.frontend_host_ms: host milliseconds a replay inside the program's
``seeg.frontend`` span (``pipeline._mel_frames``: the ``MelPlan``, K1's
constants and packed weights, the frame grid, the launches), summed over
the traced window and divided by the replays traced."""

from portbench import spans


def read(run):
    d = spans.durations(run, "seeg.frontend")
    if not d or not run.trace_units:
        return None
    return 1e3 * sum(d) / run.trace_units
