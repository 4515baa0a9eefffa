"""Median over the window's keyframe events of the program's StageTimer
``keyframe_event`` stage (LocalMapping run inline: cull, triangulate,
fuse, local BA, keyframe cull); None where no event fell in the window."""

from ..lib.readers import ms


def read(data: dict):
    return ms(data["keyframe_event_s"], 50)
