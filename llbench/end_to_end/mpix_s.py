"""Megapixels of input images encoded and then decoded, over the window's
seconds."""


def read(o):
    if "pixels" not in o.window:
        return None
    return o.window["pixels"] / 1e6 / o.window["seconds"]
