"""frontend_roofline: the front end's share of its roofline (%): the least
time of the traced replays' front ends on one H100 (``bounds.frontend``),
over the device time of the kernels launched in the ``portbench.frontend``
range (``_mel_frames``)."""

from portbench.profiling import stage_seconds


def read(run):
    busy = stage_seconds(run.summary, ("frontend",)) if run.summary else 0.0
    if busy <= 0 or not run.trace_units:
        return None
    return 100.0 * run.stage_bounds["frontend"].seconds * run.trace_units / busy
