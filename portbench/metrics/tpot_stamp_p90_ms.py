"""Decode step layer: the 90th percentile over every request due in the
window of its time per output token between the program's own stamps,
(Request.t_done - Request.t_first) / (tokens - 1), where the end-to-end
TPOT reads the ends of the calls; a request never finished counts to the
drain's end."""
from portbench import spans


def read(run):
    return spans.stamp_tpot_ms(run)
