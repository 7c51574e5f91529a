"""Device milliseconds of cuDNN's convolution kernels (forward and
gradients) a unit of work (an image, or a step) in the traced units."""
from llbench import readers


def read(o):
    return readers.per_unit_ms(o.trace, readers.CONV, readers.NOT_CONV)
