"""online.dispatch_ms: the median host milliseconds of the program's
``seeg.online.dispatch`` span over the traced packets (``_Lane.launch``:
the H2D copy, the graph replay, the D2H copy into the pinned slot, the
event record)."""

from portbench import spans


def read(run):
    return spans.median_ms(run, "seeg.online.dispatch")
