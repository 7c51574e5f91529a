"""Device milliseconds of NCCL's kernels a step on rank 0 in the traced
steps: the gradients' and metrics' all-reduce."""
from llbench import readers


def read(o):
    return readers.per_unit_ms(o.trace, readers.NCCL)
