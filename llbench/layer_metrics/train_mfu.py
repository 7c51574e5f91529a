"""The whole training step's share (%) of the cards' TF32 peak: 3 x the
reference model's forward FLOPs of the step's patches (forward and
backward) x steps, over the window's seconds, the cards and 495 TFLOP/s
(PyTorch's default flags let cuDNN use TF32)."""
from llbench import work


def read(o):
    flops = o.extra.get("flops_per_step")
    if flops is None:
        return None
    return (100 * 3 * flops * o.window["steps"] / o.window["seconds"]
            / (o.extra["chips"] * work.TF32_FLOP_PER_S))
