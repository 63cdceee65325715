"""The port's spans and counters (moonrtx_tpu_torch/utils/profiling.py) on
the CPU, and the span arithmetic of tools/torch_frame_profile.py.

A Session on a 180x360 map at 128x96, shadows on, steps W W W Q W, jumps
a day and drags, each event followed by ``Session.frame(1)``, under
torch.profiler on the CPU: the program's ranges are there, nested as the
calls are, and are operator ranges (no user annotation, so the profiler
gives them no device-side copy). The counters follow the scene's own
state event by event. With no profiler active nothing is emitted and the
counters still count; the cost of a span then is reported.
"""

import importlib.util
import time
from collections import Counter
from datetime import datetime, timedelta, timezone
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_parity  # noqa: F401  (one CPU thread, as the other port tests)
from moonrtx_tpu_torch import kernels
from moonrtx_tpu_torch.app.session import Session
from moonrtx_tpu_torch.config import RenderConfig
from moonrtx_tpu_torch.data.features import load_moon_features
from moonrtx_tpu_torch.data.synth import synthesize_moon
from moonrtx_tpu_torch.engine.scene import MoonScene
from moonrtx_tpu_torch.types import Observer
from moonrtx_tpu_torch.utils import profiling

DT0 = datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc)
TOOL = Path(__file__).resolve().parents[1] / "tools" / "torch_frame_profile.py"


@pytest.fixture(scope="module")
def moon():
    elev, albedo = synthesize_moon(180, 360, seed=5, n_craters=60)
    rs = float(elev.max())
    return (elev / rs).astype(np.float32), rs, albedo


@pytest.fixture(scope="module")
def features():
    return load_moon_features(None)


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("torch_frame_profile", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_session(moon, features, backend):
    elev, rs, albedo = moon
    cfg = RenderConfig(observer=Observer(50.06, 19.94, 219), dt_local=DT0,
                       width=128, height=96, backend=backend,
                       shadow_accuracy=4).validate()
    s = Session(MoonScene(cfg, elev, rs, albedo, None, device="cpu"),
                features)
    s.frame(1)
    return s


# W W W Q W (the Q and the W after it flip back), a day's jump (new sun:
# scan, bounce pyramid and pose windows rebuilt), then three 2-px drags
SCRIPT = [("key", "w"), ("key", "w"), ("key", "w"), ("key", "q"),
          ("key", "w"), ("day", None), ("drag", None), ("drag", None),
          ("drag", None)]


def do(session, what, arg):
    if what == "key":
        session.handle_key(arg)
    elif what == "day":
        session.set_time(session.scene.dt_local + timedelta(days=1))
    else:
        session.orbit_drag(2.0, 0.0)


def program_ranges(prof):
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(profiling.PREFIX):
            assert not ev.is_user_annotation(), ev.name()
            s = ev.start_ns()
            out.append((s, s + ev.duration_ns(),
                        ev.name()[len(profiling.PREFIX):]))
    return out


def inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def parent_names(ranges, name):
    """For every range called ``name``, the names of the ranges around
    it."""
    return [{o[2] for o in ranges if o is not r and inside(r, o)}
            for r in ranges if r[2] == name]


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_session_records_the_spans_nested(moon, features, backend):
    s = make_session(moon, features, backend)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for what, arg in SCRIPT:
            do(s, what, arg)
            s.frame(1)
    ranges = program_ranges(prof)
    n = Counter(name for *_, name in ranges)
    # one event range per event: handle_key -> change_time is one event
    assert n["session.event"] == len(SCRIPT)
    assert n["session.frame"] == len(SCRIPT)
    assert n["scene.display"] == len(SCRIPT)
    assert n["scene.update_view"] == 6
    assert n["scene.set_camera"] == 3
    assert n["scene.scan"] >= 1 and n["scene.bounce"] >= 1
    assert n["scene.pose"] >= 1
    if backend == "pallas":
        assert n["scene.burst"] >= 1 and n["scene.prefetch"] >= 1
        assert n["scene.sample"] == 0
        # a ray setup opens every pose and time-step program
        assert n["scene.rays"] >= n["scene.pose"] >= 1
        for outer in parent_names(ranges, "scene.rays"):
            assert outer & {"scene.pose", "scene.timestep", "scene.burst"}
    else:
        # a flip hit renders no sample: the restored frame is shown
        assert n["scene.sample"] == len(SCRIPT) - 2
        assert n["scene.burst"] == 0
        # one ray setup a sample, in the frame's own code
        assert n["scene.rays"] == n["scene.sample"]
        for outer in parent_names(ranges, "scene.rays"):
            assert "session.frame" in outer and "scene.sample" not in outer
    for outer in parent_names(ranges, "scene.update_view"):
        assert "session.event" in outer
    for outer in parent_names(ranges, "scene.set_camera"):
        assert "session.event" in outer
    for name in ("scene.display", "scene.sample", "scene.burst",
                 "scene.pose", "scene.prefetch"):
        for outer in parent_names(ranges, name):
            assert "session.frame" in outer, name
    for outer in parent_names(ranges, "scene.bounce"):
        assert "scene.scan" in outer or "scene.prefetch" in outer
    # the session's ranges are the outermost: one of them a request
    for name in ("session.event", "session.frame"):
        for outer in parent_names(ranges, name):
            assert not outer & {"session.event", "session.frame"}


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_counters_follow_the_scene(moon, features, backend):
    s = make_session(moon, features, backend)
    sc = s.scene
    start = profiling.counters()
    changes = 0
    for what, arg in SCRIPT:
        before = profiling.counters()
        had_windows = sc._origins is not None
        do(s, what, arg)
        c = profiling.counters()
        d = {k: c.get(k, 0) - before.get(k, 0) for k in c}
        assert d.get("flip.hit", 0) == int(sc.last_flip_hit)
        assert d.get("flip.hit", 0) + d.get("flip.miss", 0) == int(
            what != "drag")
        kept = d.get("windows.kept", 0)
        dropped = (d.get("windows.rebuilt.time", 0)
                   + d.get("windows.rebuilt.camera", 0))
        if sc.last_flip_hit or not had_windows:
            assert kept == dropped == 0
        else:
            changes += 1
            assert kept + dropped == 1
            assert kept == int(sc._origins is not None)
        s.frame(1)
    c = profiling.counters()
    d = {k: c.get(k, 0) - start.get(k, 0) for k in c}
    assert d["flip.hit"] == 2 and d["flip.miss"] == 4
    assert (d.get("windows.kept", 0) + d.get("windows.rebuilt.time", 0)
            + d.get("windows.rebuilt.camera", 0)) == changes == 7
    # the day's jump drops the windows and moves the sun past the bounce
    # map's reuse angle
    assert d.get("windows.rebuilt.time", 0) >= 1
    assert d.get("bounce.rebuilt", 0) >= 1
    assert d.get("windows.rebuilt.other", 0) == 0
    spec = d.get("prefetch.dispatched.pose", 0) + d.get(
        "prefetch.dispatched.timestep", 0)
    pending = int(sc._prefetch is not None)
    assert spec == (d.get("prefetch.consumed", 0)
                    + d.get("prefetch.discarded", 0) + pending)
    if backend == "pallas":
        assert d["prefetch.consumed"] >= 1 and spec >= 3
    else:
        assert spec == 0                   # the blocked path speculates not


def test_first_pose_and_orientation_count_as_other(moon, features):
    elev, rs, albedo = moon
    cfg = RenderConfig(observer=Observer(50.06, 19.94, 219), dt_local=DT0,
                       width=128, height=96).validate()
    scene = MoonScene(cfg, elev, rs, albedo, None, device="cpu")
    before = profiling.counters()
    scene.render(1)
    scene.set_view_orientation(scene.view_orientation)
    scene.render(1)
    after = profiling.counters()
    assert (after.get("windows.rebuilt.other", 0)
            - before.get("windows.rebuilt.other", 0)) == 2


def test_counters_report_the_kernel_launches():
    c = profiling.counters()
    for wrapper, n in kernels.launch_counts().items():
        assert c["launch." + wrapper] == n
    profiling.count("test.counted", 3)
    assert profiling.counters()["test.counted"] - c.get("test.counted", 0) == 3


def test_no_profiler_no_range_and_counters_count(moon, features,
                                                 monkeypatch):
    s = make_session(moon, features, "pallas")

    def refuse(name):
        raise AssertionError(f"range {name} opened with no profiler")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    assert not torch._C._autograd._profiler_enabled()
    before = profiling.counters()
    for what, arg in SCRIPT[:5]:
        do(s, what, arg)
        s.frame(1)
    after = profiling.counters()
    assert after["flip.hit"] - before.get("flip.hit", 0) == 2
    assert after["windows.kept"] > before.get("windows.kept", 0)


def test_span_cost_when_off():
    @profiling.span("test.decorated")
    def decorated():
        return None

    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        with profiling.span("test.block"):
            pass
    block_us = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for _ in range(n):
        decorated()
    deco_us = (time.perf_counter() - t0) / n * 1e6
    print(f"span off: {block_us:.3f} us a with-block, {deco_us:.3f} us a "
          "decorated call")
    # a frame opens a few dozen spans; well under a microsecond each here
    assert block_us < 5.0 and deco_us < 5.0


def test_once_span_opens_one_range_when_nested():
    outer = profiling.span("test.event", once=True)

    @outer
    def inner():
        return 1

    @outer
    def wrapper():
        return inner() + inner()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert wrapper() == 2
        assert inner() == 1
    n = Counter(r[2] for r in program_ranges(prof))
    assert n["test.event"] == 2


# ---- the span arithmetic of tools/torch_frame_profile.py ----

def test_innermost_cuts_nested_spans(tool):
    spans = [(0, 10, "a"), (2, 5, "b"), (3, 4, "c"), (6, 8, "d"),
             (12, 14, "e")]
    assert tool.innermost(spans) == [
        (0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 5, "b"), (5, 6, "a"),
        (6, 8, "d"), (8, 10, "a"), (12, 14, "e")]


def test_idle_split_is_time_weighted_innermost_first(tool):
    spans = [(0, 10, "frame"), (2, 6, "sample"), (12, 20, "event")]
    # idle 1-3 (frame 1, sample 1), 5-7 (sample 1, frame 1), 9-13
    # (frame 1, outside 2, event 1), 19-25 (event 1, outside 5)
    idle = [(1, 3), (5, 7), (9, 13), (19, 25)]
    got = tool.idle_by_span(idle, spans)
    assert got == pytest.approx({"frame": 3, "sample": 2, "event": 2,
                                 "outside": 7})
    assert sum(got.values()) == pytest.approx(sum(e - s for s, e in idle))


def test_gaps_and_union(tool):
    busy = [(1, 3), (2, 4), (6, 7), (9, 12)]
    assert tool.union(busy) == [(1, 4), (6, 7), (9, 12)]
    assert tool.gaps(busy, 0, 10) == [(0, 1), (4, 6), (7, 9)]


def test_span_table_counts_device_work_by_launch(tool):
    spans = [(0, 10, "frame"), (1, 4, "pose"), (4, 9, "burst"),
             (12, 13, "event")]
    # device ops (start, end, name, host launch time): two launched in
    # the pose, one in the burst, one with no launch found
    device = [(2, 5, "k1", 1.5), (5, 6, "k1", 3.0), (6, 11, "k2", 5.0),
              (11.5, 12, "copy", None)]
    t = tool.span_table(spans, device, (0, 14))
    rows = t["rows"]
    assert rows["pose"]["device_us"] == 4
    assert rows["burst"]["device_us"] == 5
    assert rows["frame"]["device_us"] == 9           # both, each once
    assert rows["event"]["device_us"] == 0
    assert rows["frame"]["host_us"] == 10 and rows["pose"]["ranges"] == 1
    assert t["busy_us"] == 9.5 and t["window_us"] == 14
    # idle 0-2 (frame 1, pose 1), 11-11.5 (outside), 12-14 (event 1,
    # outside 1)
    assert t["idle_split"] == pytest.approx(
        {"frame": 1, "pose": 1, "outside": 1.5, "event": 1})
    assert rows["event"]["idle_us"] == pytest.approx(1)
    assert t["launched_us"] == 9 and t["device_us"] == 9.5
