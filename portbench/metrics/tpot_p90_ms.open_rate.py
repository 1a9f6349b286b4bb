"""Decode step layer: the 90th percentile time per output token over every
request due in the window, as tpot_p90_ms defines it. For an open-loop
cell that reports the tail per layer (it spreads over seeds past any
bound, or the card idles over half the window), moving the output rate."""
from portbench import reading


def read(run):
    return reading.tail_ms(run, "tpot_p90_ms")
