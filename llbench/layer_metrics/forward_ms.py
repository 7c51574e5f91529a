"""Device milliseconds a traced step of ``llicti.forward``: the model's
forward and its rate, summed over the microbatches, timed by the
program's CUDA events at the span's two ends (rank 0's, in a cell of
several cards)."""
from llbench import spans


def read(o):
    return spans.device_ms(o, "llicti.forward")
