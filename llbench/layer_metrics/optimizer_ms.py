"""Device milliseconds a traced step of ``llicti.optimizer``: the clip and
Adam's step (and, on one card, the division of the gradients by the
microbatches), timed by the program's CUDA events at the span's two ends
(rank 0's, in a cell of several cards)."""
from llbench import spans


def read(o):
    return spans.device_ms(o, "llicti.optimizer")
