"""kernels/paged_attention: the traced launches' least time (live keys read
once, from their shapes) over the profiler's device time of the paged
kernels, in percent."""
from portbench import reading


def read(run):
    return reading.roofline(run, "paged_attention")
