"""Device layer, open loop: model FLOPs of the admitted prompts over the
windows' wall time outside their decode steps (where admission prefills)
at the chip's bf16 peak, in percent."""
from portbench import reading


def read(run):
    return reading.prefill_mfu(run)
