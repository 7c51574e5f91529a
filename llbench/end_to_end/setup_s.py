"""Seconds from the process's start to the window's start: imports,
kernels built or loaded, weights and inputs made, shapes warmed up, and
in a training cell the checked steps."""


def read(o):
    return o.setup_s
