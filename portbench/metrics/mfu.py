"""Device layer: model FLOPs of every prefill and decode token of the
window over the window's seconds at the chip's bf16 peak, in percent."""
from portbench import reading


def read(run):
    return reading.mfu(run)
