"""Forward FLOPs of the traced window's cost maps (counts/fcn.py, from the
network's shapes at its input size) over the window, against the card's
float32 peak."""

from ..lib.readers import mfu_pct


def read(data: dict):
    return mfu_pct(data["frames"] * data["forward_flops"], data)
