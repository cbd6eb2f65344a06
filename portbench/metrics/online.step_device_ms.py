"""online.step_device_ms: device busy time a packet (ms), the union of the
traced window's device operations over the packets traced."""

from portbench.profiling import busy_seconds


def read(run):
    s = run.summary
    if not s or not s["device_ops"] or not run.trace_units:
        return None
    return 1e3 * busy_seconds(s["device_ops"]) / run.trace_units
