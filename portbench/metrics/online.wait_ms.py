"""online.wait_ms: the median host milliseconds of the program's
``seeg.online.wait`` span over the traced packets: the host blocked on the
event after the slot's copy (None where the decoder has no event, as on
the CPU)."""

from portbench import spans


def read(run):
    return spans.median_ms(run, "seeg.online.wait")
