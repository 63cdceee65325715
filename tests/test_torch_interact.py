"""The port's host-side interaction modules against the reference's.

``interact/``, ``overlays/``, ``data/features.py`` and ``app/status.py``
are copies of the reference's numpy modules with their imports renamed;
``overlays/compose.py`` also reads a camera basis of torch tensors. On
the same seeded inputs both packages must give the same numbers: equal
where the code is the same numpy code (navigation, picking, measurement,
graph vertices and edges, the feature catalog), and equal pixels for the
projection and the drawn overlays, whose basis both packages hold as
float32 values.
"""

import math
from datetime import datetime, timezone

import numpy as np
import pytest
import torch


def _cams(types_mod, n=8, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        eye = rng.normal(size=3)
        eye = eye / np.linalg.norm(eye) * rng.uniform(1.5, 30.0)
        out.append(types_mod.Camera(
            eye=[float(v) for v in eye],
            target=[float(v) for v in rng.normal(size=3) * 0.3],
            up=[float(v) for v in rng.normal(size=3)],
            fov=float(rng.uniform(1.0, 40.0))))
    return out


def _cam_tuple(c):
    return (tuple(np.asarray(c.eye, float)), tuple(np.asarray(c.target, float)),
            tuple(np.asarray(c.up, float)), float(c.fov))


def test_feature_catalog_equal():
    """All 4,488 built-in features parse to the same records, from the
    port's own copy of the catalog."""
    import os

    from moonrtx_tpu.data import features as jf
    from moonrtx_tpu_torch.data import features as tf

    assert os.path.dirname(tf.BUILTIN_FEATURES_PATH).endswith(
        os.path.join("moonrtx_tpu_torch", "data"))
    fj, ft = jf.load_moon_features(None), tf.load_moon_features(None)
    assert len(fj) == len(ft) == 4488
    assert [tuple(a) for a in ft] == [tuple(b) for b in fj]
    line = "Tycho:−43.31:−11.36:85.29:1:0:1:6163:https://example.org"
    assert tuple(tf.parse_feature_line(line)) == \
        tuple(jf.parse_feature_line(line))


@pytest.mark.parametrize("fn", ["navigate_view", "orbit_drag",
                                "pan_tilt_view", "rotate_around_moon_axis",
                                "roll_view", "zoom_fov", "zoom_drag",
                                "dolly_view", "center_on_point",
                                "center_on_feature"])
def test_navigation_equal(fn):
    import moonrtx_tpu.types as jt
    import moonrtx_tpu_torch.types as tt
    from moonrtx_tpu.interact import navigation as jn
    from moonrtx_tpu_torch.interact import navigation as tn

    rng = np.random.default_rng(11)
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    for cj, ct in zip(_cams(jt), _cams(tt)):
        args = {
            "navigate_view": lambda m: (m.navigate_view, ("Left",)),
            "orbit_drag": lambda m: (m.orbit_drag, (3.0, -2.0, 96)),
            "pan_tilt_view": lambda m: (m.pan_tilt_view, (5.0, 7.0, 1080)),
            "rotate_around_moon_axis": lambda m: (
                m.rotate_around_moon_axis, (rot, "Up")),
            "roll_view": lambda m: (m.roll_view, ("cw",)),
            "zoom_fov": lambda m: (m.zoom_fov, (240.0,)),
            "zoom_drag": lambda m: (m.zoom_drag, (12.0, 1080)),
            "dolly_view": lambda m: (m.dolly_view, (-9.0, 1080)),
            "center_on_point": lambda m: (
                m.center_on_point, (np.array([0.3, -0.8, 0.5]),)),
            "center_on_feature": lambda m: (m.center_on_feature, (
                (jt if m is jn else tt).MoonFeature(
                    name="X", lat=12.5, lon=-33.0, angular_radius=0.5,
                    diameter_km=30.0, standard_label=False,
                    spot_label=False, status_bar=True, feature_id=None,
                    www_address=None), rot)),
        }[fn]
        f_j, a_j = args(jn)
        f_t, a_t = args(tn)
        assert _cam_tuple(f_t(ct, *a_t)) == _cam_tuple(f_j(cj, *a_j))


def test_picking_and_measurement_equal():
    from moonrtx_tpu.data.features import load_moon_features as jload
    from moonrtx_tpu.interact import measure as jm
    from moonrtx_tpu.interact import picking as jp
    from moonrtx_tpu_torch.data.features import load_moon_features as tload
    from moonrtx_tpu_torch.interact import measure as tm
    from moonrtx_tpu_torch.interact import picking as tp

    rng = np.random.default_rng(5)
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    elev = rng.normal(size=(90, 180)).astype(np.float32) * 0.001 + 1.0
    fj = sorted(jload(None), key=lambda f: f.angular_radius)
    ft = sorted(tload(None), key=lambda f: f.angular_radius)
    lj = jp.FeatureLookup(fj, all_features=fj)
    lt = tp.FeatureLookup(ft, all_features=ft)
    for _ in range(40):
        h = rng.normal(size=3)
        h = h / np.linalg.norm(h) * rng.uniform(0.9, 1.3)
        pj = jp.hit_to_selenographic(rot, *h)
        pt = tp.hit_to_selenographic(rot, *h)
        assert pt == pj
        if pj[0] is None:
            continue
        a, b = lt.find(*pt), lj.find(*pj)
        assert (a is None and b is None) or a.name == b.name
        lat2, lon2 = rng.uniform(-80, 80), rng.uniform(-180, 180)
        assert tm.great_circle_distance_km(*pt, lat2, lon2) == \
            jm.great_circle_distance_km(*pj, lat2, lon2)
        for scale, offset in ((1.0, 0.0), (2e-5, 0.5)):
            assert tm.elevation_m(elev, 1737.4, *pt, scale=scale,
                                  offset=offset) == jm.elevation_m(
                elev, 1737.4, *pj, scale=scale, offset=offset)
    assert [f.name for f in lt.search("tycho")] == \
        [f.name for f in lj.search("tycho")]


def _graphs(overlays, features, fh, fv):
    return ([*overlays.build_grid_graphs(fh, fv),
             overlays.build_standard_labels(
                 [f for f in features if f.standard_label], fh, fv),
             overlays.build_spot_labels(
                 [f for f in features if f.spot_label], fh, fv),
             overlays.build_pin(7, -20.5, 33.25, fh, fv)])


@pytest.mark.parametrize("flips", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_overlay_graphs_equal(flips):
    import moonrtx_tpu.overlays as jo
    import moonrtx_tpu_torch.overlays as to
    from moonrtx_tpu.data.features import load_moon_features as jload
    from moonrtx_tpu_torch.data.features import load_moon_features as tload

    gj = _graphs(jo, jload(None), *flips)
    gt = _graphs(to, tload(None), *flips)
    assert len(gj) == len(gt)
    for a, b in zip(gt, gj):
        np.testing.assert_array_equal(a.pos, b.pos)
        np.testing.assert_array_equal(a.edges, b.edges)
        assert (a.color, a.radius, a.visible) == (b.color, b.radius,
                                                  b.visible)
        light = np.array([0.6, -0.3, 0.74])
        np.testing.assert_array_equal(a.vertex_visible_mask(light),
                                      b.vertex_visible_mask(light))


def _bases(seed=2):
    """The reference's and the port's camera basis of the same cameras."""
    import moonrtx_tpu.types as jt
    import moonrtx_tpu_torch.types as tt
    from moonrtx_tpu.engine.camera import camera_basis as jbasis
    from moonrtx_tpu_torch.engine.camera import camera_basis as tbasis

    return [(jbasis(cj, o), tbasis(ct, o, "cpu"))
            for cj, ct, o in zip(_cams(jt, 4, seed), _cams(tt, 4, seed),
                                 ("NSWE", "NSEW", "SNEW", "SNWE"))]


def test_project_to_screen_equal():
    from moonrtx_tpu.overlays import project_to_screen as jproj
    from moonrtx_tpu_torch.overlays import project_to_screen as tproj

    rng = np.random.default_rng(9)
    pts = rng.normal(size=(500, 3))
    pts = pts / np.linalg.norm(pts, axis=1, keepdims=True) * 1.01
    for bj, bt in _bases():
        assert isinstance(bt.eye, torch.Tensor)
        pj, okj = jproj(pts, bj, 96, 128)
        pt, okt = tproj(pts, bt, 96, 128)
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(okt, okj)


def test_draw_overlays_equal():
    import moonrtx_tpu.overlays as jo
    import moonrtx_tpu_torch.overlays as to
    from moonrtx_tpu.data.features import load_moon_features as jload
    from moonrtx_tpu.engine.scene import default_camera as jdefault
    from moonrtx_tpu_torch.data.features import load_moon_features as tload
    from moonrtx_tpu_torch.engine.camera import camera_basis as tbasis
    from moonrtx_tpu.engine.camera import camera_basis as jbasis
    from moonrtx_tpu_torch.engine.scene import default_camera as tdefault

    rot = np.linalg.qr(np.random.default_rng(4).normal(size=(3, 3)))[0]
    light = np.array([100.0, -40.0, 20.0])
    gj = _graphs(jo, jload(None), False, False)
    gt = _graphs(to, tload(None), False, False)
    base = np.random.default_rng(1).integers(0, 60, (96, 128, 3), np.uint8)
    img_j = jo.draw_overlays(base.copy(), gj, rot, jbasis(jdefault()), light)
    img_t = to.draw_overlays(base.copy(), gt, rot,
                             tbasis(tdefault(), "NSWE", "cpu"), light)
    assert (img_j != base).any()
    np.testing.assert_array_equal(img_t, img_j)


def test_status_text_equal():
    import moonrtx_tpu.app.status as js
    import moonrtx_tpu_torch.app.status as ts
    from moonrtx_tpu.astro import calculate_ephemeris as jeph
    from moonrtx_tpu.types import Observer as JObs
    from moonrtx_tpu_torch.astro import calculate_ephemeris as teph
    from moonrtx_tpu_torch.types import Observer as TObs

    dt = datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc)
    rows_j = js.info_panel_rows(jeph(dt, JObs(50.06, 19.94, 219), False))
    rows_t = ts.info_panel_rows(teph(dt, TObs(50.06, 19.94, 219), False))
    assert rows_t == rows_j and len(rows_t) == 14
    for lat, lon in ((None, None), (-12.345, 170.5), (45.0, -0.001)):
        assert ts.coords_text(lat, lon) == js.coords_text(lat, lon)
    assert ts.measured_text(123.456, -789.0) == js.measured_text(123.456,
                                                                 -789.0)
    over = {"projected_bytes": 3 << 30, "budget_bytes": 2 << 30}
    assert ts.memory_warning_text(over) == js.memory_warning_text(over)
    assert math.isclose(len(ts.memory_warning_text(None)), 0)
