"""The port's interactive Session (app/session.py) on the CPU.

The reference's tests/test_session.py, test for test, on the port: the
full key map and runtime behaviors, display-free, on a 180x360 map at
128x96 (the default windowed backend, shadows off as there). Mouse motion
over an unchanged frame must call no torch function at all.

Then one key and mouse script through both packages' Sessions, each on
its own scene built from the same map, shadows on: after every event the
camera, the datetime, the status panels (the frame-rate panel aside) and
the overlay state must be equal; picked latitude and longitude within
1e-4 deg; the measured distance and height difference within 1e-3
relative; and the frames, overlays composited, within the slice's frame
tolerance (tests/test_torch_scene.py: p99 |d| <= 2 levels, mean < 0.2).
"""

from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from moonrtx_tpu_torch.app.session import Session
from moonrtx_tpu_torch.config import RenderConfig
from moonrtx_tpu_torch.data.features import load_moon_features
from moonrtx_tpu_torch.data.synth import synthesize_moon
from moonrtx_tpu_torch.engine.scene import MoonScene
from moonrtx_tpu_torch.types import Observer

DT0 = datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc)


class _TorchCalls(torch.overrides.TorchFunctionMode):
    """Records the name of every torch function called inside the block."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def moon():
    elev, albedo = synthesize_moon(180, 360, seed=5, n_craters=60)
    rs = float(elev.max())
    return (elev / rs).astype(np.float32), rs, albedo


@pytest.fixture(scope="module")
def features():
    return load_moon_features(None)


@pytest.fixture()
def session(moon, features):
    elev, rs, albedo = moon
    cfg = RenderConfig(observer=Observer(50.06, 19.94, 219), dt_local=DT0,
                       width=128, height=96).validate()
    scene = MoonScene(cfg, elev, rs, albedo, None, device="cpu")
    scene.shadows_on = False
    return Session(scene, features)


def test_time_keys(session):
    session.handle_key("w")
    assert session.scene.dt_local == DT0 + timedelta(minutes=15)
    session.handle_key("q")
    assert session.scene.dt_local == DT0
    session.handle_key("m")
    assert session.time_step_minutes == 16
    session.handle_key("m", shift=True)
    assert session.time_step_minutes == 76
    session.handle_key("n", shift=True)
    session.handle_key("n")
    assert session.time_step_minutes == 15


def test_brightness_gamma_keys(session):
    b0 = session.scene.brightness
    session.handle_key("a")
    assert session.scene.brightness == b0 + 10
    session.handle_key("z")
    assert session.scene.brightness == b0
    g0 = session.scene.gamma
    session.handle_key("e")
    assert session.scene.gamma == pytest.approx(g0 + 0.1)
    for _ in range(60):
        session.handle_key("d")
    assert session.scene.gamma == pytest.approx(0.5)  # clamp


def test_overlay_toggles(session):
    assert not session.grid_visible
    session.handle_key("g")
    assert session.grid_visible and session._grid_graphs is not None
    session.handle_key("l")
    assert session.standard_labels_visible
    session.handle_key("s")
    assert session.spot_labels_visible
    assert len(session.active_overlays()) >= 4
    session.handle_key("g")
    assert not session.grid_visible


def test_orientation_keys_and_reset(session):
    session.handle_key("F7")
    assert session.scene.view_orientation == "SNEW"
    session.handle_key("w")
    session.handle_key("Left")
    eye_moved = session.scene.camera.eye
    session.handle_key("r")  # reset: time, camera, orientation restored
    assert session.scene.view_orientation == "NSWE"
    assert session.scene.dt_local == DT0
    assert np.allclose(session.scene.camera.eye, session.initial_camera.eye)
    assert not np.allclose(eye_moved, session.scene.camera.eye)


def test_shadow_toggle(session):
    assert not session.scene.shadows_on
    session.handle_key("x")
    assert session.scene.shadows_on
    session.handle_key("x")
    assert not session.scene.shadows_on


def test_parallactic_toggle(session):
    session.handle_key("F4")
    assert session.scene.parallactic_mode
    session.handle_key("F4")
    assert not session.scene.parallactic_mode


def test_pick_and_pin_at_center(session):
    session.scene.render_accumulation_frame()
    lat, lon = session.pick(64, 48)
    assert lat is not None and abs(lat) < 30
    session.handle_key("5", cursor=(64, 48))
    assert 5 in session.pins
    session.handle_key("5", cursor=(64, 48))
    assert 5 not in session.pins


def test_measurement_flow(session):
    session.scene.render_accumulation_frame()
    assert session.start_measurement(60, 48)
    session.finish_measurement(70, 48)
    assert session.measured_distance is not None
    assert session.measured_distance > 10.0
    assert session.measured_height_diff is not None


def test_mouse_motion_is_device_dispatch_free(session):
    """Picking and measurement drags run from host caches: no torch call
    at all per mouse event after the once-per-frame copy (the reference
    treats this path as latency-critical, renderer_navigation.py:189-192)."""
    session.scene.render_accumulation_frame()
    session.pick(64, 48)                       # populates the host caches
    assert session.start_measurement(60, 48)
    session.update_measurement(65, 48)

    with _TorchCalls() as mode:
        for x in range(60, 70):
            session.pick(x, 48)
            session.update_measurement(x, 48)
        session.finish_measurement(69, 48)
    assert mode.calls == []
    assert session.measured_distance is not None
    # host caches are stable objects (no re-copy per event)
    assert session.scene.hit_buffer_host() is session.scene.hit_buffer_host()
    assert session.scene.elevation_host() is session.scene.elevation_host()


def test_hit_buffer_host_refreshes_after_new_frame(session):
    session.scene.render_accumulation_frame()
    buf1 = session.scene.hit_buffer_host()
    session.scene.reset_accumulation()
    session.scene.render_accumulation_frame()
    buf2 = session.scene.hit_buffer_host()
    assert buf1 is not buf2


def test_frame_and_hdr_composites_overlays_into_both(session):
    """F12 saves the same content at 8 and 16 bits: re-tonemapping the HDR
    must reproduce the overlay pixels (round-1 regression: 16-bit TIFFs
    omitted overlays; reference renderer_dialogs.py:144-171)."""
    session.toggle_grid()
    session.toggle_pins()  # off -> no pins; grid alone is deterministic
    img, hdr = session.frame_and_hdr(1)
    base = session.scene.render(1)
    changed = np.any(img != base, axis=-1)
    assert changed.any(), "grid overlay did not draw"
    from moonrtx_tpu_torch import constants as C
    x = np.clip(hdr * C.TONEMAP_EXPOSURE, 0.0, 1.0) ** (
        1.0 / session.scene.gamma)
    re8 = (x * 255.0 + 0.5).astype(np.uint8)
    diff = np.abs(re8[changed].astype(int) - img[changed].astype(int))
    assert diff.max() <= 1


def test_orbit_drag_is_continuous(session):
    cam0 = session.scene.camera
    d0 = np.linalg.norm(np.asarray(cam0.eye) - np.asarray(cam0.target))
    session.orbit_drag(3.0, 0.0)
    cam1 = session.scene.camera
    d1 = np.linalg.norm(np.asarray(cam1.eye) - np.asarray(cam1.target))
    assert d1 == pytest.approx(d0)                     # orbit keeps distance
    moved = np.linalg.norm(np.asarray(cam1.eye) - np.asarray(cam0.eye))
    # 3 px at fov over height=96 -> small smooth step, far below the old
    # 5%-of-FOV quantum
    import math
    expected = d0 * math.radians(cam0.fov) * 3.0 / session.scene.height
    assert moved == pytest.approx(expected, rel=0.05)
    # vertical drag also rotates up
    session.orbit_drag(0.0, 5.0)
    assert not np.allclose(session.scene.camera.up, cam1.up)


def test_dialog_actions_are_delegated(session):
    assert session.handle_key("F12") == "save_dialog"
    assert session.handle_key("f") == "search_dialog"
    assert session.handle_key("F1") == "help_dialog"
    assert session.handle_key("t") == "datetime_dialog"


def test_status_panels_complete(session):
    session.scene.render_accumulation_frame()
    panels = session.status_panels()
    assert set(panels) == {"pins", "shadows", "brightness", "gamma", "feature",
                           "coords", "measured", "time", "view", "parallactic",
                           "fps", "memory"}
    assert panels["memory"] == ""  # warning panel: empty when within budget
    rows = session.info_panel()
    assert len(rows) == 14
    names = [r[0] for r in rows]
    assert "Illumination" in names and "Colongitude" in names


def test_frame_with_overlays(session):
    bare = session.frame(n_accum=1).copy()
    session.handle_key("g")           # grid
    session.handle_key("l")           # standard labels
    session.toggle_pin_at(1, 64, 48)  # pin at frame center
    img = session.frame(n_accum=1)
    assert img.shape == (96, 128, 3)
    assert img.sum() > 0
    # the composited overlays must actually change pixels
    assert (np.abs(img.astype(int) - bare.astype(int)) > 0).any()
    # and toggling everything back off restores the bare frame
    session.handle_key("g")
    session.handle_key("l")
    session.toggle_pin_at(1, 64, 48)
    again = session.frame(n_accum=1)
    assert np.array_equal(again, bare)


def test_screenshot_name_round_trips(session):
    from moonrtx_tpu_torch.app.codec import parse_init_view
    iv = parse_init_view(session.screenshot_name())
    assert iv is not None
    assert iv.lat == pytest.approx(50.06)
    assert iv.view_orientation == session.scene.view_orientation


def test_zoom_and_navigation_keys(session):
    fov0 = session.scene.camera.fov
    session.zoom(+240)
    assert session.scene.camera.fov < fov0
    session.handle_key("h")
    session.handle_key("Left", ctrl=True)
    session.handle_key("Up")
    assert session.scene.camera is not None


def test_feature_search(session):
    matches = session.lookup.search("tycho")
    # reference ordering: catalog order (smallest angular radius first,
    # moon_renderer.py:162 + renderer_dialogs.py:281-284), so satellite
    # craters like "Tycho S" precede "Tycho" in the full catalog
    names = [m.name for m in matches]
    assert "Tycho" in names and "Tycho S" in names
    tycho = matches[names.index("Tycho")]
    session.center_on_feature(tycho)
    assert not np.allclose(session.scene.camera.target, [0, 0, 0])


def test_held_key_prefetch_armed_once_per_step(session, monkeypatch):
    """change_time arms one speculative prefetch of the next step in the
    same direction; frame() dispatches it exactly once, after the first
    accumulated sample (engine/scene.py prefetch_time)."""
    from datetime import timedelta

    calls = []
    monkeypatch.setattr(session.scene, "prefetch_time",
                        lambda dt: calls.append(dt) or True)

    session.handle_key("w")  # +step
    expected = session.scene.dt_local + timedelta(
        minutes=session.time_step_minutes)
    session.frame(1)
    assert calls == [expected]
    session.frame(2)  # further accumulation: no re-speculation
    assert calls == [expected]

    # direction FLIP: the adaptive gate skips one speculation — a
    # mis-speculated step's device work would queue ahead of the real
    # step (bench.py time_step_miss_ms), so flips degrade to plain
    # merged steps instead
    session.handle_key("q")
    session.frame(1)
    assert calls == [expected]

    session.handle_key("q")  # second backward step: speculate again
    expected2 = session.scene.dt_local - timedelta(
        minutes=session.time_step_minutes)
    session.frame(1)
    assert calls == [expected, expected2]


def test_pick_window_matches_full_buffer(session):
    """get_hit_at on a fresh frame transfers a small cursor window, not
    the 33 MB hit buffer (round-3 weak item 5); values must match the
    full host copy exactly, and nearby picks reuse the window."""
    import numpy as np

    s = session.scene
    s.render(1)
    # fresh frame: no full host copy resident
    assert s._hitbuf_host is None or s._hitbuf_src is not s._hitbuf
    v1 = s.get_hit_at(64, 64)
    win1 = s._pickwin
    assert win1 is not None
    W = min(s.PICK_WIN, s.height, s.width)
    assert win1.shape == (W, W, 4)
    v2 = s.get_hit_at(66, 63)          # nearby: same window object
    assert s._pickwin is win1
    # far along x (the axis where the frame exceeds the window, so a
    # re-center is actually possible): the window refetches
    s.get_hit_at(s.width - 2, 64)
    assert s._pickwin is not win1

    buf = s.hit_buffer_host()
    assert v1 == tuple(float(c) for c in buf[64, 64])
    assert v2 == tuple(float(c) for c in buf[63, 66])
    # with the full copy resident, picks read it directly
    v3 = s.get_hit_at(10, 10)
    assert v3 == tuple(float(c) for c in buf[10, 10])


def test_pick_window_edge_band_reuses(session):
    """A window pinned at the image border satisfies its edge-side margin
    implicitly: repeated picks along the border must NOT re-transfer the
    window per event."""
    s = session.scene
    s.render(1)
    s.get_hit_at(5, 3)                 # top-left corner: window at (0, 0)
    win = s._pickwin
    assert s._pickwin_origin == (0, 0)
    for x, y in ((1, 1), (0, 8), (12, 0), (20, 15)):
        s.get_hit_at(x, y)
        assert s._pickwin is win, (x, y)


# ---- one key and mouse script through both packages' Sessions ---------------

EVENTS = (
    ("frame",), ("pick", 64, 48), ("key", "w"), ("frame",), ("key", "w"),
    ("frame",), ("orbit", 2.0, 0.0), ("frame",), ("key", "g"), ("key", "l"),
    ("pin", 3, 64, 48), ("frame",), ("measure", 60, 48, 66, 50, 72, 47),
    ("key", "q"), ("frame",), ("key", "a"), ("key", "F7"), ("frame",),
    ("pick", 70, 40), ("key", "s"), ("key", "x"), ("frame",),
)


def _drive(sess, event):
    kind, *args = event
    if kind == "frame":
        return sess.frame(1)
    if kind == "pick":
        return sess.pick(*args)
    if kind == "key":
        return sess.handle_key(args[0])
    if kind == "orbit":
        return sess.orbit_drag(*args)
    if kind == "pin":
        return sess.toggle_pin_at(*args)
    assert sess.start_measurement(*args[:2])
    sess.update_measurement(*args[2:4])
    sess.finish_measurement(*args[4:])
    return (sess.measured_distance, sess.measured_height_diff)


def _state(sess):
    s = sess.scene
    cam = s.camera
    panels = dict(sess.status_panels())
    panels.pop("fps")
    return dict(
        camera=(tuple(np.asarray(cam.eye, float)),
                tuple(np.asarray(cam.target, float)),
                tuple(np.asarray(cam.up, float)), float(cam.fov)),
        dt=s.dt_local, orientation=s.view_orientation,
        shadows=s.shadows_on, panels=panels,
        overlays=(sess.grid_visible, sess.standard_labels_visible,
                  sess.spot_labels_visible, sess.pins_visible,
                  sorted(sess.pins), len(sess.active_overlays())))


def _run_events(sess):
    out = []
    for event in EVENTS:
        r = _drive(sess, event)
        out.append((event, _state(sess),
                    r.copy() if isinstance(r, np.ndarray) else r,
                    {k: g.pos.copy() for k, g in sess.pins.items()}))
    return out


@pytest.fixture(scope="module")
def both_sessions(moon):
    import moonrtx_tpu.app.session as jsession
    import moonrtx_tpu.config as jconfig
    import moonrtx_tpu.data.features as jfeatures
    import moonrtx_tpu.engine.scene as jscene
    import moonrtx_tpu.types as jtypes

    elev, rs, albedo = moon
    runs = {}
    for name, cfg_mod, types_mod, scene_mod, sess_mod, feat_mod, kw in (
            ("ref", jconfig, jtypes, jscene, jsession, jfeatures, {}),
            ("port", __import__("moonrtx_tpu_torch.config").config,
             __import__("moonrtx_tpu_torch.types").types,
             __import__("moonrtx_tpu_torch.engine.scene").engine.scene,
             __import__("moonrtx_tpu_torch.app.session").app.session,
             __import__("moonrtx_tpu_torch.data.features").data.features,
             dict(device="cpu"))):
        cfg = cfg_mod.RenderConfig(
            observer=types_mod.Observer(50.06, 19.94, 219), dt_local=DT0,
            width=128, height=96, shadow_accuracy=2).validate()
        scene = scene_mod.MoonScene(cfg, elev, rs, albedo, None, **kw)
        scene.shadows_on = True
        sess = sess_mod.Session(scene, feat_mod.load_moon_features(None))
        runs[name] = _run_events(sess)
    return runs


def test_session_script_matches_reference(both_sessions):
    ref, port = both_sessions["ref"], both_sessions["port"]
    n_frames = n_picks = 0
    for (event, st_j, r_j, pins_j), (_, st_t, r_t, pins_t) in zip(ref, port):
        cam_j, cam_t = st_j.pop("camera"), st_t.pop("camera")
        for a, b in zip(cam_t[:3], cam_j[:3]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        assert cam_t[3] == cam_j[3]
        assert st_t == st_j, event
        assert pins_t.keys() == pins_j.keys()
        for k in pins_j:
            # a pin sits at its picked point: 1e-4 deg at the pin's radius
            atol = np.deg2rad(1e-4) * np.linalg.norm(pins_j[k], axis=1).max()
            np.testing.assert_allclose(pins_t[k], pins_j[k], rtol=0,
                                       atol=atol)
        if event[0] == "frame":
            n_frames += 1
            assert r_t.shape == r_j.shape == (96, 128, 3)
            d = np.abs(r_t.astype(int) - r_j.astype(int)).max(axis=-1)
            assert np.percentile(d, 99) <= 2.0, (event, np.percentile(d, 99))
            assert d.mean() < 0.2, (event, d.mean())
        elif event[0] == "pick":
            n_picks += 1
            assert r_j[0] is not None and r_t[0] is not None
            np.testing.assert_allclose(r_t, r_j, rtol=0, atol=1e-4)
        elif event[0] == "measure":
            assert r_j[0] > 10.0 and abs(r_j[1]) > 1.0
            np.testing.assert_allclose(r_t, r_j, rtol=1e-3, atol=0)
    assert n_frames == 8 and n_picks == 2
