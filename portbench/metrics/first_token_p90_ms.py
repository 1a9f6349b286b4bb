"""Window loop layer (admission, prefill): the 90th percentile over every
request due in the window of the time from its due to its first output
token on the host, stamped by the program (Request.t_first) where the
token is produced, not at the end of the call; a request never served
counts to the drain's end."""
from portbench import spans


def read(run):
    return spans.stamp_tail_ms(run, "due", "t_first")
