"""Interactive session controller.

Port of moonrtx_tpu/app/session.py. Display-free owner of all runtime
behavior: the full key map, navigation, time control, overlay toggles,
pins, measurement and status state (the reference's MoonRenderer + mixins
event layer, moon_renderer.py:778-937 key map and the five mixins), so
every behavior is testable without a display. Headless on the host:
``Session(MoonScene(config, elev, rs, albedo, None, device="cpu"),
load_moon_features(None))``, then ``handle_key`` / ``frame``.
"""

from __future__ import annotations

from datetime import datetime, timedelta
from typing import Optional

import numpy as np

from moonrtx_tpu_torch import constants as C
from moonrtx_tpu_torch.app import status as status_mod
from moonrtx_tpu_torch.app.codec import format_view_state
from moonrtx_tpu_torch.engine.scene import MoonScene, default_camera
from moonrtx_tpu_torch.interact import navigation as nav
from moonrtx_tpu_torch.interact.measure import great_circle_distance_km
from moonrtx_tpu_torch.interact.picking import FeatureLookup, hit_to_selenographic
from moonrtx_tpu_torch.orientation import NSEW, NSWE, SNEW, SNWE, VIEW_ORIENTATIONS, flips
from moonrtx_tpu_torch.overlays import (
    build_grid_graphs,
    build_pin,
    build_spot_labels,
    build_standard_labels,
    draw_overlays,
)
from moonrtx_tpu_torch.types import MoonFeature
from moonrtx_tpu_torch.utils.profiling import FrameStats, span

# the span of a state-changing call; a call made inside another is part of it
_event = span("session.event", once=True)


class Session:
    """Scene + interaction state machine."""

    def __init__(self, scene: MoonScene, features: list[MoonFeature]):
        self.scene = scene
        cfg = scene.config
        self.features = sorted(features, key=lambda f: f.angular_radius)
        self.lookup = FeatureLookup(self.features,
                                    all_features=self.features)

        self.time_step_minutes = cfg.time_step_minutes
        self.initial_dt_local = scene.dt_local
        self.initial_camera = cfg.initial_camera or default_camera()
        self.initial_view_orientation = cfg.view_orientation

        # overlay state
        self.grid_visible = False
        self.standard_labels_visible = False
        self.spot_labels_visible = False
        self.pins_visible = True
        self.show_info_panel = True
        self._grid_graphs = None
        self._standard_graph = None
        self._spot_graph = None
        self.pins: dict[int, object] = {}

        # held-key speculation: direction of the last time step, armed by
        # change_time, consumed (one prefetch dispatch) by frame()
        self._prefetch_step_minutes: Optional[int] = None
        self._last_step_minutes: Optional[int] = None
        # bumped by every manual time/step change; the window's
        # auto-advance restarts its interval when it observes a new epoch
        # (reference resets _auto_advance_elapsed inside
        # change_time/change_time_step/set_time_to_now,
        # moon_renderer.py:350-354, 384-421)
        self.time_epoch = 0

        # measurement state
        self.measuring = False
        self.measure_start: Optional[tuple[float, float]] = None
        self.measured_distance: Optional[float] = None
        self.measured_height_diff: Optional[float] = None

        # status
        self.stats = FrameStats()
        self.status_feature: Optional[MoonFeature] = None
        self.cursor_lat: Optional[float] = None
        self.cursor_lon: Optional[float] = None

        scene.update_view()

    # ---- time control ----------------------------------------------------

    @_event
    def change_time(self, delta_minutes: int) -> None:
        if delta_minutes == 0:
            return
        self.scene.update_view(self.scene.dt_local
                               + timedelta(minutes=delta_minutes))
        # arm a speculative prefetch of the NEXT step in this direction:
        # frame() dispatches it behind the first rendered sample, so a
        # held key (or auto-advance) finds step t+1 already computed on
        # device (reference design point: held-key steps must be cheap,
        # moon_renderer.py:648-663).
        #
        # ADAPTIVE gate: a mis-speculated step is worse than an unassisted
        # one — the wrong-direction programs are already queued on the
        # device and the real step waits behind them (bench.py
        # time_step_miss_ms). So speculate only when the last two steps
        # agree in direction: a held key speculates from its second step
        # on (hit rate unchanged), while direction-flappy scrubbing
        # degrades to plain merged steps instead of paying miss + stale
        # device work on every flip.
        #
        # FLIP-AWARE exception: when the step
        # just landed as a flip-cache hit, the device did ZERO work this
        # step — it is idle, and the natural next target (one more step
        # in the NEW direction, t-2 of a backward scrub) is known. So a
        # flip hit arms speculation immediately instead of waiting for a
        # second same-direction step: a backward run after a direction
        # flip (Q Q Q...) is covered from its second step, and W<->Q
        # toggling stays safe — the toggle's own next target is the step
        # just snapshotted, so it hits the flip cache regardless of the
        # (then-discarded) speculation.
        self.time_epoch += 1
        prev = self._last_step_minutes
        self._last_step_minutes = delta_minutes
        if (prev is None or (prev > 0) == (delta_minutes > 0)
                or self.scene.last_flip_hit):
            self._prefetch_step_minutes = delta_minutes
        else:
            self._prefetch_step_minutes = None

    @_event
    def set_time_to_now(self) -> None:
        self.time_epoch += 1
        self.scene.update_view(datetime.now().astimezone())

    @_event
    def set_time(self, dt_local: datetime) -> None:
        self.time_epoch += 1
        self.scene.update_view(dt_local)

    @_event
    def change_time_step(self, delta: int) -> None:
        self.time_epoch += 1
        self.time_step_minutes = int(np.clip(
            self.time_step_minutes + delta, *C.TIME_STEP_RANGE))

    # ---- display controls --------------------------------------------------

    @_event
    def change_brightness(self, delta: int) -> None:
        self.scene.set_brightness(self.scene.brightness + delta)

    @_event
    def change_gamma(self, delta: float) -> None:
        new_gamma = round(self.scene.gamma + delta, 1)
        self.scene.gamma = float(np.clip(new_gamma, *C.GAMMA_RANGE))

    @_event
    def toggle_shadow_accuracy(self) -> None:
        """X key: fast <-> accurate terminator shadows
        (reference moon_renderer.py:320-334)."""
        self.scene.set_shadows(not self.scene.shadows_on)

    # ---- view -----------------------------------------------------------

    @_event
    def set_view_orientation(self, orientation: str) -> None:
        if orientation not in VIEW_ORIENTATIONS:
            return
        self.scene.set_view_orientation(orientation)
        self._rebuild_orientation_dependent_overlays()

    @_event
    def reset_camera(self) -> None:
        """R: restore initial camera, time and orientation
        (reference renderer_navigation.py:124-150)."""
        if self.scene.view_orientation != self.initial_view_orientation:
            self.set_view_orientation(self.initial_view_orientation)
        if self.scene.dt_local != self.initial_dt_local:
            self.scene.update_view(self.initial_dt_local)
        self.scene.set_camera(self.initial_camera)

    @_event
    def reset_default_view(self) -> None:
        """V: ephemeris default view (renderer_navigation.py:152-170)."""
        if self.scene.view_orientation != self.initial_view_orientation:
            self.set_view_orientation(self.initial_view_orientation)
        self.scene.set_camera(default_camera())

    @_event
    def navigate(self, direction: str) -> None:
        self.scene.set_camera(nav.navigate_view(self.scene.camera, direction))

    @_event
    def rotate_moon_axis(self, direction: str) -> None:
        self.scene.set_camera(nav.rotate_around_moon_axis(
            self.scene.camera, np.asarray(self.scene.ephem.rotation_matrix),
            direction))

    @_event
    def roll(self, direction: str) -> None:
        self.scene.set_camera(nav.roll_view(self.scene.camera, direction))

    @_event
    def pan_tilt(self, dx_px: float, dy_px: float) -> None:
        self.scene.set_camera(nav.pan_tilt_view(
            self.scene.camera, dx_px, dy_px, self.scene.out_height))

    @_event
    def zoom_drag(self, dy_px: float) -> None:
        """Shift + left-drag: continuous zoom (reference README)."""
        self.scene.set_camera(nav.zoom_drag(
            self.scene.camera, dy_px, self.scene.out_height))

    @_event
    def dolly(self, dy_px: float) -> None:
        """Shift + right-drag: move the eye backward/forward."""
        self.scene.set_camera(nav.dolly_view(
            self.scene.camera, dy_px, self.scene.out_height))

    @_event
    def orbit_drag(self, dx_px: float, dy_px: float) -> None:
        """Per-pixel left-drag orbit (reference
        renderer_navigation.py:223-294)."""
        self.scene.set_camera(nav.orbit_drag(
            self.scene.camera, dx_px, dy_px, self.scene.out_height))

    @_event
    def zoom(self, wheel_delta: float) -> None:
        self.scene.set_camera(nav.zoom_fov(self.scene.camera, wheel_delta))

    @_event
    def center_on_cursor(self, x: int, y: int) -> None:
        hx, hy, hz, hd = self.scene.get_hit_at(x, y)
        if hd <= 0:
            return
        if np.linalg.norm([hx, hy, hz]) > C.MOON_RADIUS * 1.15:
            return
        self.scene.set_camera(nav.center_on_point(
            self.scene.camera, np.array([hx, hy, hz])))

    @_event
    def center_on_feature(self, feature: MoonFeature) -> None:
        self.scene.set_camera(nav.center_on_feature(
            self.scene.camera, feature,
            np.asarray(self.scene.ephem.rotation_matrix)))

    # ---- picking ----------------------------------------------------------

    @_event
    def pick(self, x: int, y: int) -> tuple[Optional[float], Optional[float]]:
        """Cursor -> selenographic coords + status feature update
        (reference moon_renderer.py:873-888)."""
        hx, hy, hz, hd = self.scene.get_hit_at(x, y)
        lat = lon = None
        feature = None
        if hd > 0:
            lat, lon = hit_to_selenographic(
                np.asarray(self.scene.ephem.rotation_matrix).T, hx, hy, hz)
            if lat is not None:
                feature = self.lookup.find(lat, lon)
        self.cursor_lat, self.cursor_lon = lat, lon
        self.status_feature = feature
        return lat, lon

    # ---- measurement --------------------------------------------------------

    @_event
    def start_measurement(self, x: int, y: int) -> bool:
        lat, lon = self.pick(x, y)
        if lat is None:
            self.measuring = False
            return False
        self.measuring = True
        self.measure_start = (lat, lon)
        return True

    @_event
    def update_measurement(self, x: int, y: int) -> None:
        if not self.measuring:
            return
        lat2, lon2 = self.pick(x, y)
        if lat2 is None:
            return
        lat1, lon1 = self.measure_start
        self.measured_distance = great_circle_distance_km(lat1, lon1, lat2, lon2)
        # full-resolution endpoint samples off the retained host pyramid:
        # no device->host transfer per drag event, no downscaled Δh
        self.measured_height_diff = (
            self.scene.elevation_m_at(lat2, lon2)
            - self.scene.elevation_m_at(lat1, lon1))

    @_event
    def finish_measurement(self, x: int, y: int) -> None:
        if not self.measuring:
            return
        self.update_measurement(x, y)
        self.measuring = False

    # ---- overlays -------------------------------------------------------------

    def _flips(self):
        return flips(self.scene.view_orientation)

    def _rebuild_orientation_dependent_overlays(self) -> None:
        fh, fv = self._flips()
        if self._grid_graphs is not None:
            self._grid_graphs = build_grid_graphs(fh, fv)
        if self._standard_graph is not None:
            self._standard_graph = build_standard_labels(
                [f for f in self.features if f.standard_label], fh, fv)
        if self._spot_graph is not None:
            self._spot_graph = build_spot_labels(
                [f for f in self.features if f.spot_label], fh, fv)

    @_event
    def toggle_grid(self) -> None:
        self.grid_visible = not self.grid_visible
        if self.grid_visible and self._grid_graphs is None:
            self._grid_graphs = build_grid_graphs(*self._flips())

    @_event
    def toggle_standard_labels(self) -> None:
        self.standard_labels_visible = not self.standard_labels_visible
        if self.standard_labels_visible and self._standard_graph is None:
            self._standard_graph = build_standard_labels(
                [f for f in self.features if f.standard_label], *self._flips())

    @_event
    def toggle_spot_labels(self) -> None:
        self.spot_labels_visible = not self.spot_labels_visible
        if self.spot_labels_visible and self._spot_graph is None:
            self._spot_graph = build_spot_labels(
                [f for f in self.features if f.spot_label], *self._flips())

    @_event
    def toggle_pins(self) -> None:
        self.pins_visible = not self.pins_visible

    @_event
    def toggle_pin_at(self, digit: int, x: int, y: int) -> None:
        if not self.pins_visible:
            return
        if digit in self.pins:
            del self.pins[digit]
            return
        lat, lon = self.pick(x, y)
        if lat is None:
            return
        self.pins[digit] = build_pin(digit, lat, lon, *self._flips())

    @_event
    def toggle_parallactic(self) -> None:
        self.scene.parallactic_mode = not self.scene.parallactic_mode
        self.scene.update_view()

    @_event
    def toggle_info_panel(self) -> None:
        self.show_info_panel = not self.show_info_panel

    # ---- frame --------------------------------------------------------------

    def active_overlays(self) -> list:
        graphs = []
        if self.grid_visible and self._grid_graphs is not None:
            graphs += list(self._grid_graphs)
        if self.standard_labels_visible and self._standard_graph is not None:
            graphs.append(self._standard_graph)
        if self.spot_labels_visible and self._spot_graph is not None:
            graphs.append(self._spot_graph)
        if self.pins_visible:
            graphs += list(self.pins.values())
        return graphs

    @span("session.frame")
    def frame(self, n_accum: Optional[int] = None) -> np.ndarray:
        """Accumulated frame + composited overlays (uint8 RGB)."""
        # copy: cv2 draws in place, and the display array may share memory
        # with a host tensor
        self.scene.ensure_accumulated(n_accum if n_accum is not None else 1)
        step = getattr(self, "_prefetch_step_minutes", None)
        prefetch_after = None
        if step is not None and self.scene._accum_n >= 1:
            # one speculation per time step, dispatched BEFORE the display
            # transfer below: the device renders step t+1 while this frame
            # streams to the host and Tk presents it
            self._prefetch_step_minutes = None
            target = self.scene.dt_local + timedelta(minutes=step)
            if self.scene.last_flip_hit:
                # flip-hit frames are already resident — their only device
                # work is the readback. A W<->Q toggle's flip-armed
                # speculation is always doomed (the toggle's next target
                # is the just-snapshotted step, served by the flip cache),
                # so dispatching it FIRST would queue the readback behind
                # a wasted program; dispatch it after the transfer instead
                # (it still overlaps the Tk present + user think time, so
                # backward runs keep their from-step-two coverage).
                prefetch_after = target
            else:
                self.scene.prefetch_time(target)
        img = self.scene.display().copy()
        if prefetch_after is not None:
            self.scene.prefetch_time(prefetch_after)
        self.stats.tick()
        graphs = self.active_overlays()
        if graphs:
            from moonrtx_tpu_torch.engine.light import calculate_light_pos
            draw_overlays(img, graphs,
                          np.asarray(self.scene.ephem.rotation_matrix),
                          self.scene.basis(),
                          calculate_light_pos(self.scene.ephem))
        return img

    def frame_and_hdr(self, n_accum: Optional[int] = None
                      ) -> tuple[np.ndarray, np.ndarray]:
        """(uint8 frame, linear HDR) with overlays composited into BOTH,
        so an F12 save produces the same content at 8 and 16 bits/sample
        (the reference draws overlays in-scene, so both depths include
        them — renderer_dialogs.py:144-171)."""
        pre = self.scene.render(n_accum if n_accum is not None else 1)
        img = self.frame(n_accum)  # accumulation cached: re-render is free
        hdr = np.array(self.scene._accum.cpu())[: self.scene.out_height,
                                                : self.scene.out_width]
        changed = np.any(img != pre, axis=-1)
        if changed.any():
            # invert the tone map on overlay pixels: display = clip(hdr *
            # exposure)^(1/gamma), so hdr = (display/255)^gamma / exposure
            c = img[changed].astype(np.float32) / 255.0
            hdr[changed] = (c ** self.scene.gamma) / C.TONEMAP_EXPOSURE
        return img, hdr

    # ---- status -----------------------------------------------------------

    def status_panels(self) -> dict:
        """The 10-panel status bar contents (renderer_status.py:235-246)."""
        s = self.scene
        return {
            "pins": f"Pins: {'ON' if self.pins_visible else 'OFF'}",
            "shadows": ("Exact shadows: ON" if s.shadows_on
                        else "Exact shadows: OFF"),
            "brightness": f"Brightness: {s.brightness}",
            "gamma": f"Gamma: {s.gamma:.1f}",
            "feature": status_mod.feature_text(self.status_feature),
            "coords": status_mod.coords_text(self.cursor_lat, self.cursor_lon),
            "measured": status_mod.measured_text(self.measured_distance,
                                                 self.measured_height_diff),
            "time": (f"{s.dt_local:%Y-%m-%d %H:%M} "
                     f"(step {self.time_step_minutes} min)"),
            "view": f"View: {s.view_orientation}",
            "parallactic": ("Parallactic: ON" if s.parallactic_mode
                            else "Parallactic: OFF"),
            "fps": self.stats.status_text(s.width * s.height),
            "memory": status_mod.memory_warning_text(
                getattr(s, "hbm_over_budget", None)),
        }

    def info_panel(self) -> list:
        return status_mod.info_panel_rows(self.scene.ephem)

    def screenshot_name(self) -> str:
        return format_view_state(
            self.scene.dt_local, self.scene.config.observer.lat,
            self.scene.config.observer.lon, self.scene.view_orientation,
            self.scene.parallactic_mode, self.scene.camera)

    # ---- key dispatch ----------------------------------------------------------

    @_event
    def handle_key(self, keysym: str, shift: bool = False, ctrl: bool = False,
                   cursor: tuple = (0, 0)) -> Optional[str]:
        """Full reference key map (moon_renderer.py:780-866). Returns an
        action tag for keys the shell must handle (dialogs, saving)."""
        x, y = cursor
        k = keysym.lower() if len(keysym) == 1 else keysym
        if k == "g":
            self.toggle_grid()
        elif k == "l":
            self.toggle_standard_labels()
        elif k == "s":
            self.toggle_spot_labels()
        elif k == "F4":
            self.toggle_parallactic()
        elif k == "F5":
            self.set_view_orientation(NSWE)
        elif k == "F6":
            self.set_view_orientation(NSEW)
        elif k == "F7":
            self.set_view_orientation(SNEW)
        elif k == "F8":
            self.set_view_orientation(SNWE)
        elif k == "r":
            self.reset_camera()
        elif k == "c":
            self.center_on_cursor(x, y)
        elif k == "F12":
            return "save_dialog"
        elif k == "f":
            return "search_dialog"
        elif k == "i":
            return "open_usgs"
        elif k == "o":
            return "open_www"
        elif k == "h":
            self.roll("ccw")
        elif k == "j":
            self.roll("cw")
        elif k in ("Left", "Right", "Up", "Down"):
            if ctrl:
                self.rotate_moon_axis(k)
            else:
                self.navigate(k)
        elif k == "v":
            self.reset_default_view()
        elif k == "a":
            self.change_brightness(10)
        elif k == "z":
            self.change_brightness(-10)
        elif k == "e":
            self.change_gamma(0.1)
        elif k == "d":
            self.change_gamma(-0.1)
        elif k == "x":
            self.toggle_shadow_accuracy()
        elif k == "m":
            self.change_time_step(60 if shift else 1)
        elif k == "n":
            self.change_time_step(-(60 if shift else 1))
        elif k == "F2":
            self.toggle_info_panel()
        elif k == "p":
            self.toggle_pins()
        elif k == "q":
            self.change_time(-self.time_step_minutes)
        elif k == "w":
            self.change_time(self.time_step_minutes)
        elif k == "t":
            return "datetime_dialog"
        elif k == "F1":
            return "help_dialog"
        elif k == "F9":
            self.set_time_to_now()
        elif k == "F10":
            self.set_time_to_now()
            return "start_auto_advance"
        elif k in "123456789":
            self.toggle_pin_at(int(k), x, y)
        return None
