"""The port's span recorder (iv_slam_tpu_torch/utils/profiling.py) and what
reads it (portbench/lib/program_trace.py, portbench/trace_program.py).

Spans nest with parents, per thread; a frame's ``system.submit`` and
``system.track`` share its ``frame=`` id, LocalMapping's stages carry the
keyframe's ``kf=``, the train step's spans its ``step=``; an object's own
``stage_timer`` takes its stages in place of the installed recorder, and a
recorder of another kind gets names only (tools/lc_divergence.py's tracer
and its two-System lockstep); with no recorder installed a span reads no
clock and records nothing; a profiler event
recorded inside a span lies inside it (one clock); the trace's records are
credited to the innermost span; the benchmark's readers read the same with
the program's spans beside its own; ``run_stereo --profile_stages``
reports LocalMapping's stages. On a card (marked ``cuda``), the fused step
with the recorder installed makes no host sync. This file imports no JAX:

    python -m pytest -o addopts="" --noconftest tests/test_torch_tracing.py
"""

import contextlib
import io
import json
import os
import threading
import time
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import synth_world
from iv_slam_tpu_torch import config as tconfig
from iv_slam_tpu_torch.slam.system import System
from iv_slam_tpu_torch.utils import profiling
from portbench.lib import program_trace as pt

NAME, START, END, SERIAL, PARENT, THREAD, ID_KIND, ID = range(8)


@pytest.fixture
def recorder():
    """A recorder installed for the test, none after it."""
    timer = profiling.StageTimer()
    prev = profiling.install(timer)
    try:
        yield timer
    finally:
        profiling.install(prev)


@pytest.fixture(scope="module")
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _by_serial(timer):
    return {s[SERIAL]: s for s in timer.spans}


def test_spans_nest_and_carry_parents(recorder):
    with profiling.span("a", frame=3):
        with profiling.span("b"):
            with profiling.span("c", kf=7):
                pass
        with profiling.span("d", step=2):
            pass
    by = {s[NAME]: s for s in recorder.spans}
    assert [s[NAME] for s in recorder.spans] == ["c", "b", "d", "a"]
    assert by["a"][PARENT] == -1
    assert by["b"][PARENT] == by["a"][SERIAL] == by["d"][PARENT]
    assert by["c"][PARENT] == by["b"][SERIAL]
    assert (by["a"][ID_KIND], by["a"][ID]) == ("frame", 3)
    assert (by["c"][ID_KIND], by["c"][ID]) == ("kf", 7)
    assert (by["d"][ID_KIND], by["d"][ID]) == ("step", 2)
    assert (by["b"][ID_KIND], by["b"][ID]) == (None, None)
    for child, parent in (("b", "a"), ("c", "b"), ("d", "a")):
        assert by[parent][START] <= by[child][START] <= by[child][END] <= by[parent][END]
    assert set(recorder.samples) == {"a", "b", "c", "d"}
    # samples keep perf_counter durations, read inside the span's time_ns bracket
    assert 0 < recorder.samples["a"][0] <= (by["a"][END] - by["a"][START]) * 1e-9
    assert len(recorder.spans[0]) == len(profiling.SPAN_FIELDS)


def test_per_thread_stacks(recorder):
    """Two threads record at once: each span's parent is its own thread's."""
    go = threading.Barrier(2)

    def work(tag):
        with profiling.span("outer." + tag):
            go.wait()
            for _ in range(50):
                with profiling.span("inner." + tag):
                    time.sleep(0)

    ts = [threading.Thread(target=work, args=(t,)) for t in ("x", "y")]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    by = _by_serial(recorder)
    outer = {s[NAME]: s for s in recorder.spans if s[NAME].startswith("outer")}
    assert outer["outer.x"][THREAD] != outer["outer.y"][THREAD]
    inner = [s for s in recorder.spans if s[NAME].startswith("inner")]
    assert len(inner) == 100
    for s in inner:
        parent = by[s[PARENT]]
        assert parent[NAME] == "outer." + s[NAME].split(".")[1]
        assert parent[THREAD] == s[THREAD]


def test_off_path_records_nothing_and_reads_no_clock(monkeypatch):
    prev = profiling.install(None)
    try:
        def no_clock():
            raise AssertionError("a span read the clock with no recorder installed")

        monkeypatch.setattr(time, "time_ns", no_clock)
        monkeypatch.setattr(time, "perf_counter", no_clock)
        monkeypatch.setattr(time, "perf_counter_ns", no_clock)
        ctx = profiling.span("x", frame=1)
        assert ctx is profiling.span("y") is profiling.span("z", kf=2, step=3)
        with ctx:
            with profiling.span("w"):
                pass
        assert profiling.active() is None
    finally:
        profiling.install(prev)


def _stub_local_mapping():
    """A LocalMapping whose keyframe event's steps do nothing."""
    from iv_slam_tpu_torch.slam.local_mapping import LocalMapping

    lm = object.__new__(LocalMapping)
    lm.stage_timer = None
    lm.map = SimpleNamespace(lock=threading.Lock(), n_keyframes=1)
    for step in ("apply_pending_ba", "_cull_map_points", "_create_new_map_points",
                 "_search_in_neighbors", "_cull_keyframes"):
        setattr(lm, step, lambda *a: None)
    return lm


LM_STAGES = ["lm_join_prev_ba", "lm_cull_points", "lm_triangulate", "lm_fuse",
             "lm_cull_keyframes"]


def test_stage_timer_attribute_records_its_object_only():
    """An object's ``stage_timer`` takes its stages in place of the
    installed recorder, and only that object's; None leaves them to the
    installed one."""
    own, installed = profiling.StageTimer(), profiling.StageTimer()
    a, b = _stub_local_mapping(), _stub_local_mapping()
    a.stage_timer = own
    prev = profiling.install(installed)
    try:
        a._process_one(5)
        b._process_one(6)
    finally:
        profiling.install(prev)
    assert [s[NAME] for s in own.spans] == LM_STAGES
    assert {(s[ID_KIND], s[ID]) for s in own.spans} == {("kf", 5)}
    assert [s[NAME] for s in installed.spans] == LM_STAGES
    assert {(s[ID_KIND], s[ID]) for s in installed.spans} == {("kf", 6)}


def test_a_recorder_of_another_kind_gets_the_name_only():
    """An object whose ``time(name)`` is a context (tools/lc_divergence.py's
    probes) is called with the name alone, ids or not."""
    class Names:
        def __init__(self):
            self.names = []

        @contextlib.contextmanager
        def time(self, name):
            yield
            self.names.append(name)

    lm = _stub_local_mapping()
    lm.stage_timer = Names()
    lm._process_one(3)
    assert lm.stage_timer.names == LM_STAGES
    prev = profiling.install(Names())
    try:
        with profiling.span("x", frame=1):
            pass
        assert profiling.active().names == ["x"]
    finally:
        profiling.install(prev)


def _lc_divergence():
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "lc_divergence", os.path.join(root, "tools", "lc_divergence.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lc_divergence_trace_run(tmp_path, torch_threads):
    """tools/lc_divergence.py's tracer, set as ``stage_timer`` on Tracking
    and LocalMapping, records their stages, and only theirs, each frame."""
    lcd = _lc_divergence()
    meta = lcd.trace_run(3, "cpu", str(tmp_path / "t.npz"))
    assert meta["frames"] == 3
    rows = json.loads(str(np.load(str(tmp_path / "t.npz"))["rows"]))
    assert [(r["frame"], r["stage"]) for r in rows] == (
        [(0, "frontend")] + [(0, n) for n in LM_STAGES] + [(0, "track")]
        + [(f, n) for f in (1, 2) for n in ("frontend", "track")])


def test_lc_divergence_lockstep_keeps_two_recorders(tmp_path, monkeypatch, torch_threads):
    """The lockstep run's two Systems each record into their own probe: the
    two stage sequences agree (both on the CPU here)."""
    lcd = _lc_divergence()
    out = tmp_path / "lockstep.json"
    monkeypatch.setattr("sys.argv", ["lc_divergence.py", "--frames", "3", "--card", "cpu",
                                     "--out", str(out)])
    with contextlib.redirect_stdout(io.StringIO()):
        assert lcd.main() == 0
    res = json.loads(out.read_text())["lc_divergence"]
    assert res["first_discrete_difference"] is None
    assert res["first_float_difference"] is None
    assert res["per_frame"][0]["keyframes"] == [1, 1]


def _config():
    cfg = tconfig.Config()
    cfg.camera = tconfig.CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=120.0, bf=200.0,
                                      width=320, height=240, th_depth=35.0, fps=10.0)
    cfg.orb = tconfig.ORBConfig(n_features=800, n_levels=4, ini_th_fast=12, min_th_fast=7)
    cfg.system.fused_tracking = True
    return cfg


@pytest.fixture(scope="module")
def system_run(torch_threads):
    """Six frames of a synthetic sequence through System on the CPU path,
    submitted one ahead as run_stereo does, a keyframe event forced at the
    fifth; the recorder's spans."""
    _, frames, _ = synth_world.make_sequence(np.random.default_rng(5), n_frames=6, step=0.08)
    s = System(_config(), 240, 320, device="cpu")
    timer = profiling.StageTimer()
    prev = profiling.install(timer)
    try:
        nxt = s.submit_frontend(*frames[0])
        for i in range(len(frames)):
            cur = nxt
            if i + 1 < len(frames):
                nxt = s.submit_frontend(*frames[i + 1])
            if i == 4:
                s.tracking._need_new_keyframe = lambda: True
            s.track_stereo(None, None, 0.1 * i, frontend_handle=cur)
            s.tracking.__dict__.pop("_need_new_keyframe", None)
        s.shutdown()
    finally:
        profiling.install(prev)
    return timer


def test_frame_id_shared_by_submit_and_track(system_run):
    spans = system_run.spans
    by = _by_serial(system_run)
    sub = {s[ID]: s for s in spans if s[NAME] == "system.submit"}
    trk = {s[ID]: s for s in spans if s[NAME] == "system.track"}
    assert sorted(sub) == list(range(6)) and sorted(trk) == list(range(6))
    assert all(s[ID_KIND] == "frame" for s in list(sub.values()) + list(trk.values()))
    for f in range(6):
        assert sub[f][END] <= trk[f][END]

    def top(s):
        while s[PARENT] >= 0:
            s = by[s[PARENT]]
        return s

    fused = [s for s in spans if s[NAME] in ("fused_dispatch", "fused_readback")]
    assert fused, "the fused step never ran"
    for s in fused:
        root = top(s)
        assert root[NAME] == "system.track" and s[ID] == root[ID] and s[ID_KIND] == "frame"
    front = [s for s in spans if s[NAME].startswith("frontend.")]
    assert {"frontend.upload", "frontend.extract", "frontend.stereo"} <= {s[NAME] for s in front}
    for s in front:
        if s[NAME] != "frontend.collect":
            assert top(s)[NAME] == "system.submit" and top(s)[ID] == s[ID]
    phases = [s[NAME] for s in spans if s[NAME].startswith("fused.")]
    n_steps = sum(1 for s in spans if s[NAME] == "fused_dispatch")
    assert phases.count("fused.motion_search") == 2 * n_steps
    assert phases.count("fused.pose_opt") == 2 * n_steps
    assert phases.count("fused.local_search") == n_steps
    for s in spans:
        if s[NAME].startswith("fused."):
            assert by[s[PARENT]][NAME] == "fused_dispatch"


def test_kf_id_on_local_mapping_stages(system_run):
    spans = system_run.spans
    by = _by_serial(system_run)
    events = [s for s in spans if s[NAME] == "keyframe_event"]
    assert len(events) == 1 and events[0][ID_KIND] == "kf"
    lm = [s for s in spans if s[NAME].startswith("lm_")]
    # the stereo initialisation's keyframe (0), then the forced event's
    assert sorted({s[ID] for s in lm}) == [0, events[0][ID]]
    assert all(s[ID_KIND] == "kf" for s in lm)
    inside = [s for s in lm if s[ID] == events[0][ID]]
    assert {s[NAME] for s in inside} >= {"lm_cull_points", "lm_triangulate", "lm_fuse",
                                         "lm_cull_keyframes"}
    for s in inside:
        p = s
        while p[PARENT] >= 0 and p[NAME] != "keyframe_event":
            p = by[p[PARENT]]
        assert p is events[0]


def test_step_id_on_train_spans(recorder, torch_threads):
    from iv_slam_tpu_torch.train.trainer import TrainConfig, Trainer

    tr = Trainer(TrainConfig(input_hw=(32, 32), batch_size=2), device="cpu")
    rng = np.random.default_rng(0)
    batch = dict(image=rng.standard_normal((2, 32, 32, 3)).astype(np.float32),
                 target=rng.random((2, 4, 4, 1)).astype(np.float32),
                 mask=np.ones((2, 4, 4, 1), np.float32))
    for _ in range(2):
        tr.step(batch)
    by = _by_serial(recorder)
    names = ("train.step", "train.upload", "train.forward", "train.backward",
             "train.optimizer")
    for step in (0, 1):
        got = [s for s in recorder.spans if s[ID] == step and s[ID_KIND] == "step"]
        assert sorted(s[NAME] for s in got) == sorted(names)
        root = next(s for s in got if s[NAME] == "train.step")
        assert all(by[s[PARENT]] is root for s in got if s is not root)


def test_profiler_event_inside_span(recorder):
    """torch.profiler's events and the spans share one clock."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("mm"):
            a @ a
    (s,) = [s for s in recorder.spans if s[NAME] == "mm"]
    ev = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert ev
    for e in ev:
        assert s[START] <= e.start_ns() <= e.end_ns() <= s[END]


def _span(name, a, b, serial, parent):
    return (name, a, b, serial, parent, 1, None, None)


def test_credit_innermost_by_correlation():
    spans = [_span("inner", 120, 150, 1, 0), _span("outer", 100, 200, 0, -1),
             _span("later", 300, 310, 2, -1)]
    records = dict(
        # device events: kernels (corr 1, 2, 3), a copy (corr 5), an event
        # whose launch record is missing (corr 9)
        start_ns=np.array([1000, 1100, 1200, 1300, 1400], np.int64),
        end_ns=np.array([1010, 1105, 1207, 1350, 1490], np.int64),
        corr=np.array([1, 2, 3, 5, 9], np.int64),
        kernel=np.array([True, True, True, False, True]),
        runtime=dict(ns=np.array([130, 110, 400, 135, 140, 305], np.int64),
                     corr=np.array([1, 2, 3, 5, 4, 6], np.int64),
                     sync=np.array([False, False, False, False, True, True])))
    rows = {r[0]: r for r in pt.credit(spans, records)}
    # (launches, syncs, device ns)
    assert rows["inner"][7:] == (1, 1, 10)
    assert rows["outer"][7:] == (1, 0, 5)
    assert rows["later"][7:] == (0, 1, 0)     # the launch at 400 lies in no span
    tot = pt.subtree_totals(list(rows.values()))
    assert tot[0] == (2, 1, 15) and tot[1] == (1, 1, 10)
    procs = [list(rows.values())]
    assert pt.per_span(procs, "outer", 0, 0, 1000) == 2.0
    assert pt.per_span(procs, "outer", 2, 0, 1000, 1e-6) == pytest.approx(15e-6)
    assert pt.per_span(procs, "outer", 0, 150, 1000) is None   # begun before the window
    assert pt.host_ms(procs, "inner", 0, 1000) == pytest.approx(30e-6)


def test_innermost_of_overlapping_spans():
    """Spans of two threads that overlap without nesting: the later start
    wins; ends are inclusive; outside every span, none."""
    spans = [_span("x", 0, 100, 0, -1), _span("y", 50, 150, 1, -1),
             _span("z", 60, 70, 2, 1)]
    t = np.array([-1, 0, 25, 50, 65, 75, 100, 120, 150, 151], np.int64)
    assert pt.innermost(spans, t).tolist() == [-1, 0, 0, 1, 2, 1, 1, 1, 1, -1]
    assert pt.innermost([], t).tolist() == [-1] * len(t)


@pytest.mark.parametrize("cell", ["track.kitti_iv_x8", "train.fcn_b8", "costmap.kitti"])
def test_readers_same_with_program_spans(tmp_path, cell, torch_threads):
    """A traced CPU rehearsal of the cell with the program's spans: every
    per-layer reader of BENCHMARK.json reads the same with the program's
    spans and credits beside the benchmark's as without them; the idle
    gaps are labelled by program spans; the cell's per-span readings are
    there (the counts None: the CPU trace has no runtime records)."""
    from portbench import trace_program
    from portbench.lib import result, spec
    from portbench.tests.conftest import make_tiny

    root = make_tiny(str(tmp_path / "checkout"))
    sp = spec.cell_spec(cell, root, os.path.join(root, "portbench"))
    ctx = SimpleNamespace(name=cell, seed=2147483701, trace=True, device=torch.device("cpu"),
                          root=root, seconds=2.0 if cell.startswith("track") else 0.5, **sp)
    out, procs, has_runtime = trace_program.run_cell(ctx)
    assert has_runtime is False
    dev_info = dict(platform="cpu", kind="cpu", count=1)
    plain = result.build(sp, out, True, 1.0, dev_info)
    assert plain["correct"] and plain["metrics"]
    spans = [(r[0], r[1], r[2]) for rows in procs for r in rows]
    assert spans
    joined = dict(out, spans=list(out["spans"]) + spans,
                  data=dict(out["data"], program_rows=procs))
    both = result.build(sp, joined, True, 1.0, dev_info)
    assert both["metrics"] == plain["metrics"]
    assert both["device"] == plain["device"] and both["checks"] == plain["checks"]

    prog = trace_program.program_section(cell, out, procs, has_runtime)
    want = pt.METRICS[cell.split(".")[0]]
    assert set(prog["metrics"]) == set(want)
    for name, v in prog["metrics"].items():
        assert (v is None) == (want[name][0] == "count"), name
    assert any(n in prog["spans"] for n, _ in prog["idle_gaps"])
    assert prog["spans_per_unit"] > 0 and prog["span_ns"]["on"] > 0


def test_trace_program_prints_the_program_section(tmp_path, torch_threads):
    from portbench import trace_program
    from portbench.tests.conftest import make_tiny

    root = make_tiny(str(tmp_path / "checkout"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = trace_program.main(["--workload", "train.fcn_b8", "--seed", "5", "--seconds",
                                 "0.3"], root=root, device="cpu")
    assert rc == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] and list(line)[-1] == "program"
    assert line["program"]["metrics"]["upload_ms.train"] > 0
    assert {"train.step", "train.upload", "train.forward", "train.backward",
            "train.optimizer"} <= set(line["program"]["spans"])
    assert profiling.active() is None


SETTINGS = """%YAML:1.0
Camera.fx: 400.0
Camera.fy: 400.0
Camera.cx: 160.0
Camera.cy: 120.0
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 320
Camera.height: 240
Camera.fps: 10.0
Camera.bf: 200.0
ThDepth: 35.0
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 800
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def test_run_stereo_profile_stages_reports_local_mapping(tmp_path, torch_threads):
    """One recorder covers Tracking, LocalMapping and LoopClosing: the
    report has the keyframe's lm_* stages, in the report's format, and no
    recorder is left installed."""
    from iv_slam_tpu_torch.examples import run_stereo
    from iv_slam_tpu_torch.io.png import write_png

    seq = tmp_path / "00"
    for d in ("image_0", "image_1"):
        (seq / d).mkdir(parents=True)
    _, frames, _ = synth_world.make_sequence(np.random.default_rng(7), n_frames=4)
    for i, (left, right) in enumerate(frames):
        write_png(str(seq / "image_0" / f"{i:06d}.png"), left)
        write_png(str(seq / "image_1" / f"{i:06d}.png"), right)
    (seq / "times.txt").write_text("".join(f"{0.1 * i!r}\n" for i in range(len(frames))))
    (tmp_path / "settings.yaml").write_text(SETTINGS)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run_stereo.main(["--data_path", str(seq), "--settings_path",
                         str(tmp_path / "settings.yaml"), "--out_visualization_path",
                         str(tmp_path / "out"), "--profile_stages", "--device", "cpu"])
    lines = out.getvalue().splitlines()
    head = [i for i, ln in enumerate(lines) if ln.startswith("stage ")]
    assert len(head) == 1
    report = lines[head[0]:-1]
    assert report[0] == f"{'stage':<28}{'n':>6}{'median':>10}{'mean':>10}{'p90':>10}"
    stages = {ln[:28].strip() for ln in report[1:]}
    assert {"frontend", "track", "lm_triangulate", "lm_fuse", "lm_cull_points"} <= stages
    assert profiling.active() is None


@pytest.mark.cuda
def test_fused_step_makes_no_host_sync_with_recorder(torch_threads):
    """The fused step's inputs recorded on the CPU path, then the step on the
    card with a recorder installed, under CUDA's sync debug mode: no host
    sync, and the step's phase spans recorded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sync debug mode is the card's)")
    from iv_slam_tpu_torch.slam.fused_track import FusedTracker

    cfg = _config()
    _, frames, _ = synth_world.make_sequence(np.random.default_rng(5), n_frames=4, step=0.08)
    s = System(cfg, 240, 320, device="cpu")
    rec = []
    s.tracking._ensure_fused()
    real = s.tracking._fused._step
    s.tracking._fused._step = lambda *a: (rec.append([x.clone() for x in a]), real(*a))[1]
    for i, (left, right) in enumerate(frames):
        s.track_stereo(left, right, 0.1 * i)
    s.shutdown()
    assert rec, "the fused step never ran"
    dev = torch.device("cuda", 0)
    step = FusedTracker(cfg, 240, 320, device=dev)._step
    args = [x.to(dev) for x in rec[-1]]
    timer = profiling.StageTimer()
    prev = profiling.install(timer)
    try:
        step(*args)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                step(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    finally:
        profiling.install(prev)
    syncs = [f"{w.filename}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert not syncs, sorted(set(syncs))
    names = [sp[NAME] for sp in timer.spans]
    assert names.count("fused.pose_opt") == 4 and names.count("fused.local_search") == 2
