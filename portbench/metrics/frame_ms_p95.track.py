"""95th percentile over every session's frames in the window of the time
from a frame's cost-map call to its ``track_stereo`` return (the
benchmark's spans)."""

from ..lib.readers import ms


def read(data: dict):
    return ms(data["frame_s"], 95)
