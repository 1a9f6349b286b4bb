"""Window loop layer (serve/scheduler.py): the 90th percentile over every
request due in the window of the time it waited in the scheduler's queue,
from the program's own stamps (Request.t_admit - Request.t_submit); a
request never admitted counts to the drain's end."""
from portbench import spans


def read(run):
    return spans.stamp_tail_ms(run, "t_submit", "t_admit")
