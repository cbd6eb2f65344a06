"""vocoder_roofline: the vocoder's share of its roofline (%): the least time
of the traced replays' inits and Griffin-Lim to int16 audio on one H100
(``bounds.vocoder``), over the device time of the kernels launched in the
``portbench.inits`` and ``portbench.vocode`` ranges."""

from portbench.profiling import stage_seconds


def read(run):
    busy = stage_seconds(run.summary, ("inits", "vocode")) if run.summary else 0.0
    if busy <= 0 or not run.trace_units:
        return None
    return 100.0 * run.stage_bounds["vocoder"].seconds * run.trace_units / busy
