"""Device layer, open loop: model FLOPs of the decode steps over the decode
steps' wall time at the chip's bf16 peak, in percent."""
from portbench import reading


def read(run):
    return reading.step_mfu(run)
