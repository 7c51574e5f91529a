"""Kernel 1's share (%) of its roofline in the traced round trips: the
least time of their work (``llbench/work.py`` on the reference's counts
for the same images) over the kernel's device time."""
from llbench import readers


def read(o):
    return readers.roofline(o, "kernel1", readers.KERNEL1)
