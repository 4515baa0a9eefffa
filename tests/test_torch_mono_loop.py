"""Port parity: a monocular map's loop correction (slam/loop_closing.py
with ``fix_scale=False``, what Tracking passes when cfg.system.sensor is
"mono") against the JAX package's, on tests/test_loop_closing.py's
manufactured revisit (two keyframes over the same landmarks as disjoint
point sets; their frames carry no depth, as a mono System's do): the Sim3
with a free scale solved on JAX's hypothesis indices, the correction
propagated, fused, graph-optimized and the deferred global BA merged. The
same loop keyframe, loop edges, live points and observations; the solved
scale within 1e-4, poses within 1e-4 and points within 1e-3
(tests/test_torch_loop_closing.py's tolerances for the same path with the
scale fixed, for the same reasons).
"""

import pytest

from test_torch_loop_closing import (PKG, assert_same_map, ensure_bow, make_lc,  # noqa: F401
                                     revisit_scenario, small_gba_rungs)
from torch_parity import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")


def test_correct_loop_mono_matches_jax(small_gba_rungs):
    out = {}
    for name, P in PKG.items():
        cfg, m, voc, kf0, kf1 = revisit_scenario(P)
        lc = make_lc(P, cfg, m, voc)
        ensure_bow(lc, kf0)
        ensure_bow(lc, kf1)
        loop_kf, S_corr, matched = lc._compute_sim3(kf1, [kf0], fix_scale=False)
        lc._correct_loop(kf1, loop_kf, S_corr, matched, fix_scale=False)
        merged = lc.collect_gba()
        out[name] = (m, loop_kf, float(S_corr[1]), merged, lc.loop_edges)
    (mt, lt, st, gt, et), (mj, lj, sj, gj, ej) = out["torch"], out["jax"]
    assert lt == lj and gt == gj and et == ej
    assert abs(st - sj) < 1e-4 and abs(st - 1.0) > 1e-6   # a scale was solved
    assert_same_map(mt, mj, 1e-4, 1e-3)
    assert mt.pt_alive[:mt.n_points].sum() < 200       # the duplicates fused
