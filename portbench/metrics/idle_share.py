"""Device layer: the share of the traced span in which no operation ran on
the device (one minus the union of the profiler's device intervals over
the span)."""
from portbench import reading


def read(run):
    return reading.idle_share(run)
