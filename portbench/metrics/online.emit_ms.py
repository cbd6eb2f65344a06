"""online.emit_ms: the median host milliseconds of the program's
``seeg.online.emit`` span over the traced packets: the outputs copied out
of the pinned slot, the valid rows kept, the audio written to the sink."""

from portbench import spans


def read(run):
    return spans.median_ms(run, "seeg.online.emit")
