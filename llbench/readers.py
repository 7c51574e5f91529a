"""Arithmetic the metric readers share: kernel name fragments (lower
case) of the groups they read from the trace, and reductions."""

# cuDNN's convolutions and their gradients, by cuDNN's own names (its
# implicit-GEMM engines, its kernels' "_cudnn" suffix and namespaces): a
# GEMM of cuBLAS is no convolution
CONV = ("convol", "conv2d", "implicit", "wgrad", "dgrad", "fprop",
        "winograd", "cudnn")
# cuDNN's layout changes around a convolution: NCHW <-> NHWC, its generic
# tensor transform, the padding of an NCHW tensor
TRANSPOSE = ("generictranspose", "nchwtonhwc", "nhwctonchw",
             "tensortransform", "addpadding")
KERNEL1 = ("cdf_pmap",)
KERNEL2 = ("rans_decode",)
KERNEL3 = ("rans_encode",)
NCCL = ("nccl",)
NOT_CONV = TRANSPOSE + KERNEL1 + KERNEL2 + KERNEL3 + NCCL


def per_unit_ms(trace, patterns, exclude=()):
    """Device milliseconds of a group a unit of work (an image or a step),
    or None when the group launched nothing."""
    if trace is None:
        return None
    s, n = trace.group_s(patterns, exclude)
    return 1e3 * s / trace.units if n else None


def roofline(o, kernel, patterns):
    """The least time of the traced units' work on ``kernel``, from the
    reference's counts, as a share (%) of the kernel's device time."""
    t = o.trace
    work = o.extra.get("work")
    if t is None or not work:
        return None
    s, n = t.group_s(patterns)
    if not n:
        return None
    return 100 * sum(w[kernel] for w in work) / s
