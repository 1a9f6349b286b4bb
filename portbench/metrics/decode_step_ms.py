"""Decode step layer (serve/serve_step.py, models): the mean wall time of a
decode step, as step_window's own step_times_us record it."""
from portbench import reading


def read(run):
    return reading.decode_step_ms(run)
