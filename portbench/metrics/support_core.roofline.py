"""kernels/support_core: the traced bursts' least time (the metadata bytes
of every class read and written once, and the queue) over the profiler's
device time of the burst kernel, in percent."""
from portbench import reading


def read(run):
    return reading.roofline(run, "support_core")
