"""kernels/flash_attention: the traced prefills' least time (the larger of
the causal attention's FLOP bound and its bytes read once, from the
admitted prompts' lengths) over the profiler's device time of the flash
kernels, in percent."""
from portbench import reading


def read(run):
    return reading.roofline(run, "flash_attention")
