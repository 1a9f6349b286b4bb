"""Window loop layer (serve/multi_engine.py, engine.py, scheduler.py): the
mean wall time of a step_window call outside its decode steps
(admission, prefill, release, the merged commit), timed around the call
by the benchmark."""
from portbench import reading


def read(run):
    return reading.window_rest_ms(run)
