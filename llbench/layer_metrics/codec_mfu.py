"""The whole codec pass's share (%) of the card's float32 peak: 2 x the
reference model's forward FLOPs at the cell's image size (one encode, one
decode) x images coded, over the window's seconds and 67 TFLOP/s (the
codec runs float32 with TF32 off)."""
from llbench import work


def read(o):
    flops = o.extra.get("flops_per_image")
    if flops is None:
        return None
    return (100 * 2 * flops * o.window["images"] / o.window["seconds"]
            / work.F32_FLOP_PER_S)
