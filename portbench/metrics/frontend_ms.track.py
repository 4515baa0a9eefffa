"""Median host time of a ``System.submit_frontend`` call in the window (the
benchmark's spans): the pair's upload and the frontend's queued device
work."""

from ..lib.readers import ms


def read(data: dict):
    return ms(data["frontend_s"], 50)
