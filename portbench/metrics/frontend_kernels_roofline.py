"""The frontend kernels' share of their roofline over the traced window
(csrc/fast_score.cu, orient_brief.cu, sad_windows.cu): the three kernels'
launches times their least time a launch from counts/kernels.py, summed,
over their summed profiler device time."""

from ..lib.readers import roofline_pct

KERNELS = {"fast_score": "fast_score_levels_kernel", "orient_brief": "orient_brief_kernel",
           "sad_windows": "sad_windows_kernel"}


def read(data: dict):
    return roofline_pct(data, KERNELS)
