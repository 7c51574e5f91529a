"""Container bytes x 8 / (H W 3), the mean over the pool's images (a
batch container over its K images); every pool image is coded in each
window."""


def read(o):
    return o.window.get("bpsp")
