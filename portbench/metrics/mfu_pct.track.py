"""The tracking loop's share of the card's float32 peak: the FCN forward's
FLOPs a frame by count (counts/fcn.py, from the network's shapes at its
input size) times the window's frames, over the window. The rest of a
frame's floating-point work (pyramid, tracking step, local mapping) is not
counted, so this reads low; the frontend kernels' integer operations are
not FLOPs and are left to their roofline."""

from ..lib.readers import mfu_pct


def read(data: dict):
    return mfu_pct(data["frames"] * data["forward_flops"], data)
