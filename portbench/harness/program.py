"""The system under test: the port's scene and session, driven request by
request with the benchmark's own spans around each call into a layer.

The maps are the deployment's dataset. They come from the port's loader
(procedural synthesis at the configuration's map size, cached in the
checkout) or, for the small configurations of the tests, from its
synthesizer directly; the same arrays go to the program and to the
reference, and the configuration's fingerprint of them holds them fixed.
Spans are host intervals kept in memory and, in a traced run, also
``torch.profiler.record_function`` ranges named ``pb.<span>``.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from datetime import datetime, timedelta
from typing import NamedTuple

import numpy as np

from harness.traffic import parse_dt


class Spans:
    """Host intervals by span name (perf_counter seconds); with
    ``profiled`` each span is also a profiler range ``pb.<name>``."""

    def __init__(self, profiled: bool = False):
        self.profiled = profiled
        self.by_name: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = contextlib.nullcontext()
        if self.profiled:
            from torch.profiler import record_function
            rf = record_function("pb." + name)
        with rf:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.by_name.setdefault(name, []).append(
                    (t0, time.perf_counter()))

    def clear(self) -> None:
        self.by_name = {}


def load_maps(cfg: dict) -> dict:
    """The deployment's maps (read_maps), held to the configuration's
    fingerprint of them: a configuration from the loader holds one, and
    maps that do not match it (a later change of the port's loader or
    synthesizer) end the run."""
    want = cfg.get("map_fingerprint")
    if want is None and cfg["map_source"] != "synth":
        raise ValueError(f"configuration {cfg['name']!r} has no "
                         "map_fingerprint")
    maps = read_maps(cfg)
    got = fingerprint(maps)
    print("# map fingerprint: " + json.dumps(got), file=sys.stderr,
          flush=True)
    if want is not None and not fingerprints_match(got, want):
        raise ValueError(f"the maps of {cfg['name']!r} are not the "
                         f"configuration's: fingerprint {got}, want {want}")
    return maps


def read_maps(cfg: dict) -> dict:
    """Elevation (peak 1), radius scale, linear albedo and star map, host
    arrays."""
    rows, cols = int(cfg["map_rows"]), int(cfg["map_cols"])
    if cfg["map_source"] == "synth":
        from moonrtx_tpu_torch.data.synth import synthesize_moon

        elev, albedo = synthesize_moon(rows, cols, seed=int(cfg["map_seed"]),
                                       n_craters=int(cfg["map_craters"]))
        rs = float(elev.max())
        maps = dict(elevation=(elev / rs).astype(np.float32),
                    radius_scale=rs, albedo=albedo, starmap=None)
    else:
        from moonrtx_tpu_torch.data import loader

        elev, rs = loader.load_elevation_data(None, 1,
                                              synth_shape=(rows, cols))
        bh, bw = loader.SYNTH_ELEVATION_SHAPE
        # the procedural colour map rides 4x coarser than the heights, as
        # app/headless.py::build_scene loads it
        albedo = loader.load_color_data(
            None, 1, synth_shape=(max(rows // 4, bh), max(cols // 4, bw)))
        starmap = loader.load_starmap(None, int(cfg["render"]["width"]) * 2)
        maps = dict(elevation=elev, radius_scale=rs, albedo=albedo,
                    starmap=starmap)
    return maps


FINGERPRINT_RTOL = 1e-6


def fingerprint(maps: dict, stride: int = 8, band: int = 128) -> dict:
    """Per map, over every ``stride``-th row: the sum of |x|, of x**2 and of
    |x| weighted by a positive pattern over rows and columns (so a moved
    feature shows), in float64; and the radius scale."""
    out = {"radius_scale": float(maps["radius_scale"])}
    for name in ("elevation", "albedo", "starmap"):
        a = maps[name]
        if a is None:
            continue
        rows = np.arange(0, a.shape[0], stride)
        sums = np.zeros(3)
        for r0 in range(0, len(rows), band):
            r = rows[r0:r0 + band]
            x = np.abs(np.asarray(a[r], np.float64).reshape(len(r), -1))
            wc = 1.0 + 0.5 * np.cos(0.7 * np.arange(x.shape[1]))
            wr = 1.0 + 0.5 * np.sin(1.3 * r)
            sums += (x.sum(), (x * x).sum(), (wr[:, None] * x * wc).sum())
        out[name] = [float(v) for v in sums]
    return out


def fingerprints_match(got: dict, want: dict) -> bool:
    if set(got) != set(want):
        return False
    return all(np.allclose(got[k], want[k], rtol=FINGERPRINT_RTOL, atol=0)
               for k in want)


def render_config(cfg: dict, mix: dict):
    from moonrtx_tpu_torch.config import RenderConfig
    from moonrtx_tpu_torch.types import Observer

    r = dict(cfg["render"])
    if "step_minutes" in mix:
        r["time_step_minutes"] = int(mix["step_minutes"])
    return RenderConfig(observer=Observer(*cfg["observer"]),
                        dt_local=parse_dt(cfg["start"]), **r).validate()


class ViewUser:
    """``view`` requests: the call on the scene (span ``view.event``), then
    the shadow scan and bounce map (``scan``), the pose program and the
    burst (``render``) and the uint8 frame on the host (``display``,
    synchronised by the copy)."""

    def __init__(self, scene, samples: int, spans: Spans):
        self.scene = scene
        self.samples = samples
        self.spans = spans
        self.image = None

    def do(self, req: dict) -> None:
        s = self.scene
        with self.spans("view.event"):
            _call(s, req)
        with self.spans("scan"):
            s.shadow_args()
        with self.spans("render"):
            s.ensure_accumulated(self.samples)
        with self.spans("display"):
            self.image = s.display()

    def rng_state(self) -> dict:
        return self.scene._rng.bit_generator.state

    def capture(self) -> tuple:
        h, w = self.image.shape[:2]
        return (self.image.copy(),
                np.array(self.scene.hit_buffer_host()[:h, :w]))

    def close(self) -> None:
        self.scene = self.image = None


class SessionUser:
    """``session`` requests: the call on app/session.py::Session (span
    ``session.event``), then ``Session.frame(samples)`` (``session.frame``;
    speculation as the session does it)."""

    def __init__(self, scene, features, samples: int, spans: Spans):
        from moonrtx_tpu_torch.app.session import Session

        self.session = Session(scene, features)
        self.samples = samples
        self.spans = spans
        self.image = None

    def do(self, req: dict) -> None:
        s = self.session
        with self.spans("session.event"):
            _call(s, req)
        with self.spans("session.frame"):
            self.image = s.frame(self.samples)

    def rng_state(self) -> dict:
        return self.session.scene._rng.bit_generator.state

    def capture(self) -> tuple:
        h, w = self.image.shape[:2]
        return (self.image.copy(),
                np.array(self.session.scene.hit_buffer_host()[:h, :w]))

    def close(self) -> None:
        self.session = self.image = None


def _call(obj, req: dict) -> None:
    if req["call"].startswith("_"):
        raise ValueError(f"{req['call']!r} is not a public call")
    getattr(obj, req["call"])(*req["args"])


def build(cfg: dict, mix: dict, maps: dict, spans: Spans, device=None):
    """The scene for ``cfg`` on ``device`` (None: the card) and the user
    that ``mix`` names."""
    from moonrtx_tpu_torch.engine.scene import MoonScene

    scene = MoonScene(render_config(cfg, mix), maps["elevation"],
                      maps["radius_scale"], maps["albedo"], maps["starmap"],
                      device=device)
    samples = int(mix["samples"])
    if mix["user"] == "view":
        return ViewUser(scene, samples, spans)
    from moonrtx_tpu_torch.data.features import load_moon_features

    return SessionUser(scene, load_moon_features(None), samples, spans)


class View(NamedTuple):
    """What a user sees a frame of: the date, the camera and the two
    display settings a session can change."""
    dt: datetime
    camera: object
    brightness: int
    gamma: float


def view_states(cfg: dict, mix: dict, events: list) -> list:
    """The first View, then the View after each request of ``events``
    (warm-up first), worked
    out from the requests alone by following each call as the port's
    scene and session do (the navigation is a frozen copy in
    reference/moonref). Used by the check, so it imports nothing of the
    port; a call it cannot follow is an error."""
    from reference.frame import default_camera
    from reference.moonref import constants as C
    from reference.moonref.interact import navigation as nav

    height = int(cfg["render"]["height"])
    step = int(mix.get("step_minutes", C.DEFAULT_TIME_STEP_MINUTES))
    v = View(parse_dt(cfg["start"]), default_camera(),
             int(cfg["render"]["brightness"]), float(cfg["render"]["gamma"]))

    def brightness(b):
        return int(np.clip(b, *C.BRIGHTNESS_RANGE))

    follow = {
        "update_view": lambda v, dt: v._replace(dt=dt),
        "set_time": lambda v, dt: v._replace(dt=dt),
        "change_time": lambda v, m: v._replace(
            dt=v.dt + timedelta(minutes=m)),
        "handle_key": lambda v, k: v._replace(
            dt=v.dt + timedelta(minutes={"w": step, "q": -step}[k])),
        "orbit_drag": lambda v, dx, dy: v._replace(
            camera=nav.orbit_drag(v.camera, dx, dy, height)),
        "pan_tilt": lambda v, dx, dy: v._replace(
            camera=nav.pan_tilt_view(v.camera, dx, dy, height)),
        "zoom": lambda v, d: v._replace(camera=nav.zoom_fov(v.camera, d)),
        "set_brightness": lambda v, b: v._replace(brightness=brightness(b)),
        "change_brightness": lambda v, d: v._replace(
            brightness=brightness(v.brightness + d)),
        "change_gamma": lambda v, d: v._replace(gamma=float(np.clip(
            round(v.gamma + d, 1), *C.GAMMA_RANGE))),
    }
    out = [v]
    for r in events:
        if r["call"] not in follow:
            raise ValueError(f"the check cannot follow {r['call']!r}")
        v = follow[r["call"]](v, *r["args"])
        out.append(v)
    return out
