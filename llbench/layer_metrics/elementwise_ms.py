"""Device milliseconds a unit of work (an image) of PyTorch's elementwise
kernels (``elementwise_kernel``, ``vectorized_elementwise_kernel``,
``unrolled_elementwise_kernel``: bias adds, sums, clamps, copies) and of
the band epilogue, which does the interpolator's share of that work in
one pass, in the traced units.  The PyTorch kernels are all of the
codec's, not the interpolator's alone: GDN1's abs and division, the
sequential-colour path's adds, cat and clamps are read here too, so a
gain of those layers shows in this metric as well."""
from llbench import readers

# kernel name fragments (lower case) of the group: PyTorch's elementwise
# kernels and the band epilogue that finishes the interpolator's convs in
# their place; no fragment of the conv, transpose, hand-kernel or NCCL
# groups of ``llbench/readers.py`` matches either
ELEMENTWISE = ("band_epilogue", "elementwise_kernel")


def read(o):
    return readers.per_unit_ms(o.trace, ELEMENTWISE)
