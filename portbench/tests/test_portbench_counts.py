"""The counts the rooflines and FLOP shares read: the FCN's FLOPs from its
shapes equal what FlopCounterMode sees the plain reference run, and the
frontend kernels' counts give PERF.md's kernel-table bounds at KITTI
shapes."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts import fcn as fc
from portbench.counts import kernels as kc
from portbench.counts.peaks import bound_s
from portbench.reference import fcn as ref
from portbench.traffic import weights

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = json.load(open(os.path.join(HERE, "configs", "kitti_iv_stereo.json")))["fcn"]


@pytest.mark.parametrize("hw", [(64, 64), (512, 512)])
@pytest.mark.parametrize("train", [False, True])
def test_fcn_flops_equal_the_flop_counter(hw, train):
    w = weights.fcn_weights(ref.param_shapes(ARCH), 1, torch.device("cpu"))
    p = {k: v for k, v in w.items() if not ref.is_buffer(k)}
    stats = {k: v for k, v in w.items() if ref.is_buffer(k)}
    x = torch.zeros(1, 3, *hw)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref.forward(ARCH, p, x, train, stats)
    assert fc.forward_flops(ARCH, hw, train) == counter.get_total_flops()


def test_fcn_flops_at_the_cells_sizes():
    # 17.23 GFLOP a 512x512 forward; the training network adds the deep
    # supervision branch, and a sample costs three of its forwards
    assert round(fc.forward_flops(ARCH, (512, 512), False) / 1e9, 2) == 17.23
    assert fc.train_sample_flops(ARCH, (512, 512)) == 3 * fc.forward_flops(ARCH, (512, 512),
                                                                           True)


def test_kernel_bounds_equal_the_kernel_table_at_kitti_shapes():
    from portbench.reference.orb import pyramid

    shapes = pyramid.pyramid_shapes(376, 1241, 1.2, 8)
    assert round(bound_s(*kc.fast_counts(shapes)) * 1e3, 4) == 0.0052
    assert bound_s(*kc.fast_counts(shapes)) == kc.fast_counts(shapes)[1] / 67e12
    # K2 and K3 as the table measured them: 2.38 MB and 0.55 MB in all for
    # two images of 2000 keypoints (the left one for K3), of which 2.2 MB
    # and 0.44 MB are distinct canvas bytes
    k2 = kc.orient_brief_counts(4000, 1_500_000, 700_000)
    assert round(k2[0] / 1e6, 2) == 2.38 and round(bound_s(*k2) * 1e3, 5) == 0.00071
    k3 = kc.sad_counts(2000, 170_000, 268_000)
    assert round(k3[0] / 1e6, 2) == 0.55 and round(bound_s(*k3) * 1e3, 5) == 0.00016


def test_touched_counts_distinct_bytes():
    idx = kc.window_indices((10, 10), torch.tensor([5, 5]), torch.tensor([5, 6]), 1, 1)
    assert kc.touched((10, 10), idx) == 12          # two 3x3 windows sharing 6 pixels
    edge = kc.window_indices((10, 10), torch.tensor([0]), torch.tensor([0]), 1, 1)
    assert kc.touched((10, 10), edge) == 4          # clamped at the corner
