"""The program's own spans in a traced run.

The port opens ``seeg.*`` ranges (``runtime/tracing.span``) at its replay's
stage boundaries and around its online host loop's parts while a profiler
records.  ``program_spans`` pulls those that lie inside the run's
``portbench.window`` range out of ``run.profile``'s host events, once a run
(the Chrome trace the summary reads can be written only once), as
(name, start s, end s) on the profiler's clock in order of start.  A
program that opens no such span (an older commit) gives none, and every
reader of them returns None.
"""

from __future__ import annotations

import statistics

from portbench import profiling

PREFIX = "seeg."


def select(events) -> list:
    """(name, start s, end s) of the ``seeg.*`` ranges among ``(name, start
    us, end us)`` host events that lie inside the window range."""
    windows = [(a, b) for name, a, b in events if name == profiling.WINDOW]
    if not windows:
        return []
    w0, w1 = min(a for a, _ in windows), max(b for _, b in windows)
    return sorted(((name, a * 1e-6, b * 1e-6) for name, a, b in events
                   if name.startswith(PREFIX) and w0 <= a and b <= w1), key=lambda s: s[1])


def program_spans(run) -> list:
    if getattr(run, "program_spans", None) is None:
        run.program_spans = [] if run.profile is None else select(_host_events(run.profile))
    return run.program_spans


def _host_events(profile):
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end) for e in profile.prof.events()
            if e.device_type == DeviceType.CPU
            and (e.name == profiling.WINDOW or e.name.startswith(PREFIX))]


def durations(run, name: str) -> list:
    """Seconds of each ``name`` span inside the traced window."""
    return [b - a for n, a, b in program_spans(run) if n == name]


def median_ms(run, name: str):
    """The median ``name`` span in milliseconds; None without one."""
    d = durations(run, name)
    return 1e3 * statistics.median(d) if d else None
