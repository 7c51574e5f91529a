"""Device milliseconds of cuDNN's NCHW <-> NHWC transposes a unit of work
(an image, or a step) in the traced units."""
from llbench import readers


def read(o):
    return readers.per_unit_ms(o.trace, readers.TRANSPOSE)
