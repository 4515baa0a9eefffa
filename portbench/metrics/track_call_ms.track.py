"""Median host time of a ``System.track_stereo`` call in the window (the
benchmark's spans): the fused tracking step, the keyframe decision and,
every few frames, the inline keyframe event."""

from ..lib.readers import ms


def read(data: dict):
    return ms(data["track_s"], 50)
