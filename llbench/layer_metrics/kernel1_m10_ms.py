"""Device milliseconds an image of Kernel 1's launches of ten mixture
terms (clr_joint_mode 1's Y, a 2M-term mixture at M = 5: the kernel's
``cdf_pmap_kernel<..., 10>`` instance) in the traced round trips; None
where the trace holds no such launch."""
from llbench import readers

# the 10-term instance of each branch, by the name the compiler gives it
KERNEL1_M10 = ("cdf_pmap_kernel<false, 10>", "cdf_pmap_kernel<true, 10>")


def read(o):
    return readers.per_unit_ms(o.trace, KERNEL1_M10)
