"""online.api_calls_per_packet: the CUDA runtime and driver calls the host
made in the traced window (graph launches, copies, event records and
syncs, kernel launches), over the packets traced."""


def read(run):
    s = run.summary
    if not s or not run.trace_units or not s["runtime_by_name"]:
        return None
    return s["runtime_calls"] / run.trace_units
