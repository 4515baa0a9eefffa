"""The device's idle share of the traced window: 1 minus the union of every
process's kernel, copy and set intervals on the card (torch.profiler),
over the window."""

from ..lib.readers import idle_pct


def read(data: dict):
    return idle_pct(data)
