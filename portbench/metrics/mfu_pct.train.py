"""Training FLOPs of the samples of the traced window's completed steps
(counts/fcn.py: 3 forwards of the training network a sample, from its
shapes) over the window, against the card's float32 peak."""

from ..lib.readers import mfu_pct


def read(data: dict):
    return mfu_pct(data["samples"] * data["sample_flops"], data)
