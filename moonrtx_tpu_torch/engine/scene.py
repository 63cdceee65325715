"""MoonScene: scene state + device resources, single device (torch).

Port of moonrtx_tpu/engine/scene.py: device-resident mip pyramids, the
ephemeris-driven FrameParams, camera state, the shadow/bounce maps, and
progressive accumulation through three backends:

* "blocked" (what "auto" and "mxu" resolve to, and "reference" on a
  quantized scene): per-block windows cut by K5, march and shading in
  plain torch ops, one sample per render_accumulation_frame;
* "pallas": windows cut by K1 and every sample of a burst through the
  march kernel K2 (render_accumulation_burst), later samples one at a
  time through the same kernel;
* "reference": plain gathers on the full maps (engine/render.py), the
  check of the other two.

On the card each kernel is the hand-written one, on the CPU its plain
version. One rule of the reference's backend resolution does not come
across: off a TPU the reference turns "pallas" into "blocked", because
its fused kernel needs the TPU compiler; here "pallas" stays the march
path on the card and on the CPU alike.

A time change or a camera change drops the pose caches, so the next
render rebuilds them. The reference's drift reuse of the windows, its
time-step programs, flip cache, speculative prefetch, device mesh and
banded uploads come in later slices.
"""

from __future__ import annotations

import math
import time as _time
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from moonrtx_tpu_torch import constants as C
from moonrtx_tpu_torch.astro import calculate_ephemeris
from moonrtx_tpu_torch.config import RenderConfig
from moonrtx_tpu_torch.data.mips import pad_lon_wrap, select_level
from moonrtx_tpu_torch.data.pyramids import PAD_COLS, QUANTIZE_TEXELS, load_or_build
from moonrtx_tpu_torch.device import resolve_device
from moonrtx_tpu_torch.engine import blocked
from moonrtx_tpu_torch.engine import geometry
from moonrtx_tpu_torch.engine import light as light_mod
from moonrtx_tpu_torch.engine import render as render_mod
from moonrtx_tpu_torch.engine.camera import CameraBasis, camera_basis
from moonrtx_tpu_torch.engine.render import FrameParams
from moonrtx_tpu_torch.ops import sampler
from moonrtx_tpu_torch.ops import shadow_scan
from moonrtx_tpu_torch.types import Camera, MoonEphemeris

# Shadow scans sample the heightfield at the scan grid's own resolution
# (<= 2304x4096 cells); building from a much finer mip wastes bandwidth.
SHADOW_MAX_TEXELS = 20 * 1024 * 1024

# One-bounce irradiance maps are reused while the sun-frame rotation since
# their build stays under this angle (the field is blurred over >= 2 scan
# cells, ~0.1-0.2 deg of arc).
BOUNCE_REUSE_DEG = 0.5


def _earth_params(e, eclipse: bool, earthshine: bool) -> np.ndarray:
    """(6,) Earth-light params for FrameParams.earth: Earth direction in
    the body frame, Earth distance in scene units, the refraction-enlarged
    Earth angular radius (0 disables eclipse shading), and the earthshine
    irradiance relative to direct sunlight (0 disables)."""
    lat = math.radians(e.libr_lat_geo)
    lon = math.radians(e.libr_long_geo)
    cl = math.cos(lat)
    d_units = e.distance / C.MOON_RADIUS_KM * C.MOON_RADIUS
    if eclipse:
        # Chauvenet's ~2% rule enlarges the UMBRA (aE - aS), not the disk
        e_geo = math.asin(C.EARTH_RADIUS_KM / e.distance)
        s_ang = math.asin(C.SUN_RADIUS_KM / e.sun_distance)
        e_ang = e_geo + ((C.UMBRA_ENLARGEMENT - 1.0)
                         * max(e_geo - s_ang, 0.0))
    else:
        e_ang = 0.0
    es = (C.EARTHSHINE_RELATIVE
          * light_mod.earthshine_fraction(e.phase_angle)
          if earthshine else 0.0)
    return np.array([cl * math.sin(lon), -cl * math.cos(lon),
                     math.sin(lat), d_units, e_ang, es], np.float32)


def _sun_frame_basis_np(sun_unit: np.ndarray) -> np.ndarray:
    """Host mirror of ops.shadow_scan.sun_frame_basis (rows = x, y, z)."""
    z = sun_unit / np.linalg.norm(sun_unit)
    helper = (np.array([0.0, 0.0, 1.0]) if abs(z[2]) < 0.9
              else np.array([1.0, 0.0, 0.0]))
    x = np.cross(helper, z)
    x = x / np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])


def _rotation_angle_deg(a: np.ndarray, b: np.ndarray) -> float:
    """Angle of the relative rotation between two orthonormal bases."""
    cosang = (np.trace(a @ b.T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0))))


def default_camera() -> Camera:
    """Ephemeris-independent default view (reference moon_renderer.py:190-198)."""
    visible_height = 2 * C.MOON_RADIUS / C.MOON_FILL_FRACTION
    fov = math.degrees(2 * math.atan(visible_height / (2 * C.CAMERA_DISTANCE)))
    return Camera(eye=[0.0, -C.CAMERA_DISTANCE, 0.0], target=[0.0, 0.0, 0.0],
                  up=[0.0, 0.0, 1.0], fov=max(1.0, min(90.0, fov)))


def _render_background(starmap, basis: CameraBasis, height: int, width: int):
    """Star background for one camera pose (rebuilt on camera change); the
    star map is fixed to scene coordinates."""
    dev = starmap.device
    ys = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    v = 1.0 - 2.0 * (ys + 0.5) / height
    u = (2.0 * (xs + 0.5) / width - 1.0) * (width / height)
    d = (basis.forward[None, None, :]
         + basis.tan_half_fov * (u[..., None] * basis.right[None, None, :]
                                 + v[..., None] * basis.up[None, None, :]))
    lat, lon = geometry.unit_to_latlon(d)
    h, w = starmap.shape[0], starmap.shape[1] - PAD_COLS
    row, col = sampler.latlon_to_rowcol(lat, lon, h, w)
    return sampler.gather_bilinear(starmap, row, col)


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


class MoonScene:
    """Owns device textures + scene state; renders progressive frames.

    ``device`` None means the CUDA card (moonrtx_tpu_torch.device); pass
    ``device="cpu"`` to run the plain PyTorch path on the host."""

    def __init__(self, config: RenderConfig, elevation: np.ndarray,
                 radius_scale: float, albedo: np.ndarray,
                 starmap: Optional[np.ndarray], device=None):
        self.device = resolve_device(device)
        self.config = config
        self.radius_scale = float(radius_scale)
        if int(getattr(config, "devices", 1)) != 1:
            raise NotImplementedError(
                "multi-device rendering is not ported yet")
        quant = config.quantize
        if quant == "auto":
            quant = ("i16" if elevation.shape[0] * elevation.shape[1]
                     > QUANTIZE_TEXELS else "off")
        self.quantized = quant == "i16"

        self.backend = config.backend
        if self.backend in ("auto", "mxu"):
            self.backend = "blocked"
        if self.quantized and self.backend == "reference":
            # the gather path has no decode plumbing; quantized (large-map)
            # scenes always render through the windowed paths
            self.backend = "blocked"

        # Mips, quantization, max map, slope stats: built by data.pyramids
        # (numpy) behind a device-ready disk cache for quantized maps.
        ps = load_or_build(elevation, albedo, self.quantized,
                           use_cache=self.quantized)
        t_upload = _time.time()
        host_alb = [ps.albedo_kept[0]] * ps.alb_min_level + list(
            ps.albedo_kept)
        self._install(
            mips=[_to_device(m, self.device) for m in ps.mips],
            albedo_mips=self._upload_aliased(host_alb),
            maxmap=_to_device(ps.maxmap, self.device),
            slope_maps=_to_device(ps.slope_maps, self.device),
            starmap=(_to_device(pad_lon_wrap(starmap, PAD_COLS), self.device)
                     if starmap is not None else None),
            h_min=ps.h_min, h_scale=ps.h_scale, h_offset=ps.h_offset,
            a_scale=ps.a_scale, alb_min_level=ps.alb_min_level)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.upload_wall_s = _time.time() - t_upload

        # internal render size padded to the block grid (display crops back)
        self.out_width = config.width
        self.out_height = config.height
        w_mult = blocked.BLOCK_W * blocked.GROUP  # 8-block strips
        self.width = -(-config.width // w_mult) * w_mult
        self.height = -(-config.height // blocked.BLOCK_H) * blocked.BLOCK_H
        self.dt_local: Optional[datetime] = config.dt_local
        self.brightness = config.brightness
        self.gamma = config.gamma
        self.view_orientation = config.view_orientation
        self.parallactic_mode = config.parallactic_mode
        self.shadow_accuracy = config.shadow_accuracy
        self.shadows_on = config.shadow_accuracy > 1
        self.camera: Camera = config.initial_camera or default_camera()
        self.displaced = True
        self.indirect_light = bool(getattr(config, "indirect_light", True))
        self.indirect_bounces = int(getattr(config, "indirect_bounces", 1))

        self.ephem: Optional[MoonEphemeris] = None
        self._fp: Optional[FrameParams] = None
        self._basis: Optional[CameraBasis] = None
        self._background = None
        self._shadow = None          # (shadow_map, params) or None
        self._bounce = None          # one-bounce irradiance map or None
        self._bounce_basis = None    # sun-frame basis the bounce was built in
        self._bounce_key = None      # (level, accuracy) of the cached bounce
        self._shadow_dirty = True
        self._alb_lum = {}           # level -> albedo-luminance map (cached)
        self._clear_pose()
        self._accum = None
        self._accum_n = 0
        self._hitbuf = None
        self._rng = np.random.default_rng(42)

    def _upload_aliased(self, host_alb):
        uploaded = {}
        out = []
        for a in host_alb:  # aliased head slots upload once
            if id(a) not in uploaded:
                uploaded[id(a)] = _to_device(a, self.device)
            out.append(uploaded[id(a)])
        return out

    def _install(self, mips, albedo_mips, maxmap, slope_maps, starmap,
                 h_min, h_scale, h_offset, a_scale, alb_min_level) -> None:
        self.mips = list(mips)
        self.albedo_mips = list(albedo_mips)
        self.maxmap = maxmap
        self.slope_maps = slope_maps
        self.starmap = starmap
        self.h_min = float(h_min)
        self.h_scale = float(h_scale)
        self.h_offset = float(h_offset)
        self.a_scale = float(a_scale)
        self.alb_min_level = int(alb_min_level)
        self.mip_shapes = [(m.shape[0], m.shape[1] - PAD_COLS)
                           for m in self.mips]

    def load_state(self, state: dict) -> None:
        """Install device state from a flat tensor dict
        (moonrtx_tpu_torch.weights.scene_state_from_numpy) in place of
        the pyramids built at construction; drops every derived cache."""
        def levels(name):
            n = sum(1 for k in state if k.startswith(name + "."))
            return [state[f"{name}.{i}"].to(self.device) for i in range(n)]

        starmap = state.get("starmap")
        self._install(
            mips=levels("mips"), albedo_mips=levels("albedo_mips"),
            maxmap=state["maxmap"].to(self.device),
            slope_maps=state["slope_maps"].to(self.device),
            starmap=None if starmap is None else starmap.to(self.device),
            h_min=state["h_min"].item(), h_scale=state["h_scale"].item(),
            h_offset=state["h_offset"].item(),
            a_scale=state["a_scale"].item(),
            alb_min_level=state["alb_min_level"].item())
        self._alb_lum = {}
        self._background = None
        self._shadow = self._bounce = None
        self._bounce_basis = self._bounce_key = None
        self._shadow_dirty = True
        self._clear_pose()
        self.reset_accumulation()

    def _clear_pose(self) -> None:
        self._origins = None         # WindowOrigins (per pose+level+rotation)
        self._hbound = None          # per-block chord bound (pose-local)
        self._wincache = None        # WindowCache
        self._shadowwin = None       # ShadowWindows, or FUSED_SHADOW_STATE
        self._packed = None          # PackedWindows (march-kernel layout)
        self._cache_level = None

    # ---- state updates -------------------------------------------------

    def update_view(self, dt_local: Optional[datetime] = None) -> MoonEphemeris:
        """Recompute ephemeris-driven state (reference moon_renderer.py:638-664).

        Any time change drops the pose caches: the next render rebuilds
        window origins, windows and shadow windows. The reference's drift
        reuse with its time-step programs comes in a later slice."""
        if dt_local is not None:
            self.dt_local = dt_local
        self.ephem = calculate_ephemeris(
            self.dt_local, self.config.observer, self.parallactic_mode)
        self._fp = self._frame_params(self.ephem)
        self._shadow_dirty = True
        self._clear_pose()
        self.reset_accumulation()
        return self.ephem

    def _frame_params(self, e: MoonEphemeris) -> FrameParams:
        """Device per-frame light/photometric parameters for an ephemeris."""
        dev = self.device

        def t(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=dev)

        light_pos = light_mod.calculate_light_pos(e)
        disk_c, disk_r = light_mod.calculate_sun_disk(e)
        return FrameParams(
            rotation=t(e.rotation_matrix),
            light_pos=t(light_pos),
            sun_disk_center=t(disk_c),
            sun_disk_radius=t(disk_r),
            irradiance=t(light_mod.sun_irradiance_factor(self.brightness, e)),
            sun_ang_radius=t(math.asin(C.SUN_RADIUS_KM / e.sun_distance)),
            lunar_blend=(t(light_mod.lunar_lambert_blend(e.phase_angle))
                         if self.config.photometric == "lunar" else None),
            earth=(t(_earth_params(e, self.config.eclipse_shading,
                                   self.config.earthshine))
                   if (self.config.eclipse_shading
                       or self.config.earthshine) else None),
        )

    def set_brightness(self, brightness: int) -> None:
        self.brightness = int(np.clip(brightness, *C.BRIGHTNESS_RANGE))
        if self.ephem is not None:
            self._fp = self._fp._replace(irradiance=torch.as_tensor(
                np.float32(light_mod.sun_irradiance_factor(
                    self.brightness, self.ephem)), device=self.device))
        self.reset_accumulation()

    def set_camera(self, camera: Camera) -> None:
        """Install a new camera pose. Every camera change drops the pose
        caches (the reference reuses the windows across small moves; that
        drift budget comes with the time-step slice)."""
        self.camera = camera
        self._camera_changed()

    def set_view_orientation(self, orientation: str) -> None:
        self.view_orientation = orientation
        self._camera_changed()

    def _camera_changed(self) -> None:
        self._basis = None
        self._background = None
        self._origins = None
        self._hbound = None
        self.reset_accumulation()

    def set_shadows(self, on: bool) -> None:
        """Toggle cast shadows. Shadow state is always stale across a
        toggle: the map, windows and packed state rebuild lazily with the
        next frame."""
        self.shadows_on = bool(on)
        self._shadow_dirty = True
        self._shadowwin = None
        self.reset_accumulation()

    def reset_accumulation(self) -> None:
        self._accum_n = 0

    # ---- derived device state -------------------------------------------

    def basis(self) -> CameraBasis:
        if self._basis is None:
            self._basis = camera_basis(self.camera, self.view_orientation,
                                       self.device)
        return self._basis

    def render_basis(self) -> CameraBasis:
        """Camera basis compensated for the block-grid frame padding: the
        padded frame's ray generation emits exactly the requested-frame
        rays on the visible top-left (out_height, out_width) crop (see the
        reference's docstring for the derivation)."""
        b = self.basis()
        pw, ph = self.width, self.height
        ow, oh = self.out_width, self.out_height
        if pw == ow and ph == oh:
            return b
        du = (pw - ow) / oh
        dv = (ph - oh) / oh
        fwd = (b.forward + b.tan_half_fov
               * (du * b.right - dv * b.up))
        return CameraBasis(eye=b.eye, forward=fwd, right=b.right, up=b.up,
                           tan_half_fov=b.tan_half_fov * (ph / oh))

    def mip_level(self) -> int:
        """Footprint-matched mip level for the current view."""
        eye = np.asarray(self.camera.eye)
        dist = max(float(np.linalg.norm(eye)) - C.MOON_RADIUS, 1.0)
        px_ang = math.radians(self.camera.fov) / self.out_height
        ground_per_px = dist * px_ang
        h0, w0 = self.mip_shapes[0]
        texel_ground = 2 * math.pi * C.MOON_RADIUS / w0
        return select_level(self.mip_shapes, ground_per_px / texel_ground)

    def albedo_level(self, level: int) -> int:
        """Albedo mip for a height render level; floored at alb_min_level."""
        return min(max(level + blocked.ALB_DOWN, self.alb_min_level),
                   len(self.albedo_mips) - 1)

    def _capped_level(self, lvl: int) -> int:
        """Walk down the pyramid until a level fits SHADOW_MAX_TEXELS."""
        while (lvl + 1 < len(self.mips)
               and self.mip_shapes[lvl][0] * self.mip_shapes[lvl][1]
               > SHADOW_MAX_TEXELS):
            lvl += 1
        return lvl

    def shadow_level(self) -> int:
        """Mip level the shadow scan (and bounce alb_lum) builds from."""
        lvl = self._capped_level(max(self.mip_level(), 0))
        if self.indirect_light:
            # the bounce scan samples alb_lum on the same grid as tex
            lvl = max(lvl, self.alb_min_level)
        return lvl

    def background(self):
        if self.starmap is None:
            return None
        if self._background is None:
            self._background = _render_background(
                self.starmap, self.render_basis(), self.height, self.width)
        return self._background

    def alb_lum(self, level: int):
        """Albedo-luminance map for a mip level (bounce emitter strength),
        computed lazily on device and cached; decodes uint8 albedo."""
        level = max(level, self.alb_min_level)
        if level not in self._alb_lum:
            m = torch.mean(self.albedo_mips[level].to(torch.float32), dim=2)
            if self.a_scale != 1.0:
                m = m * self.a_scale
            self._alb_lum[level] = m
        return self._alb_lum[level]

    def _sun_state(self) -> tuple[np.ndarray, float]:
        """(unit sun direction in the body frame, solar angular radius),
        computed on the host."""
        e = self.ephem
        sun_body = np.asarray(e.rotation_matrix).T @ np.asarray(
            light_mod.calculate_light_pos(e))
        ang = math.asin(C.SUN_RADIUS_KM / e.sun_distance)
        return sun_body / np.linalg.norm(sun_body), ang

    def shadow_args(self):
        """Current (shadow_map, params), rebuilt lazily on time change
        (with the one-bounce irradiance map into self._bounce)."""
        if not self.shadows_on or not self.displaced:
            return None
        if self._shadow is None or self._shadow_dirty:
            sun_unit, ang = self._sun_state()
            sm = self._dispatch_shadow_maps(sun_unit, ang)
            self._shadow = sm["shadow"]
            if self.indirect_light:
                if sm["bounce"] is not None:
                    self._bounce = sm["bounce"]
                    self._bounce_basis = sm["bounce_basis"]
                    self._bounce_key = sm["bounce_key"]
            else:
                self._bounce = None
                self._bounce_basis = None
                self._bounce_key = None
            self._shadow_dirty = False
        return self._shadow

    def _dispatch_shadow_maps(self, sun_unit: np.ndarray, ang: float) -> dict:
        """Build the shadow (and, as needed, bounce) maps for a sun state
        without mutating scene state. Returns shadow=(smap, params) and
        bounce/bounce_basis/bounce_key, set only when a fresh pyramid was
        built."""
        slevel = self.shadow_level()
        stex = self.mips[slevel]
        sh_, sw_ = self.mip_shapes[slevel]
        acc = self.shadow_accuracy if self.shadows_on else 1
        sun = torch.as_tensor(np.asarray(sun_unit, np.float32),
                              device=self.device)
        bounce = bounce_basis = bounce_key = None
        if self.indirect_light:
            basis_np = _sun_frame_basis_np(sun_unit)
            reuse = (
                self._bounce is not None
                and self._bounce_basis is not None
                and self._bounce_key == (slevel, acc)
                and _rotation_angle_deg(basis_np, self._bounce_basis)
                <= BOUNCE_REUSE_DEG)
            if reuse:
                shadow = shadow_scan.build_shadow_map(
                    stex, sh_, sw_, sun, ang, accuracy=acc,
                    h_scale=self.h_scale, h_offset=self.h_offset)
            else:
                smap, params, bmap = shadow_scan.build_shadow_and_bounce(
                    stex, self.alb_lum(slevel), sh_, sw_, sun, ang,
                    accuracy=acc, h_scale=self.h_scale,
                    h_offset=self.h_offset,
                    n_bounces=self.indirect_bounces)
                shadow = (smap, params)
                bounce = bmap
                bounce_basis = basis_np
                bounce_key = (slevel, acc)
        else:
            shadow = shadow_scan.build_shadow_map(
                stex, sh_, sw_, sun, ang, accuracy=acc,
                h_scale=self.h_scale, h_offset=self.h_offset)
        return dict(shadow=shadow, bounce=bounce, bounce_basis=bounce_basis,
                    bounce_key=bounce_key)

    # ---- rendering -------------------------------------------------------

    def _ensure_blocked_caches(self, level: int, geom) -> int:
        """(Re)build the window caches of the windowed backends when
        invalid; returns the albedo level. The blocked backend's windows
        are cut one per block by K5 (f32 shadow windows), the march
        path's by K1 into its packed layout."""
        h, w = self.mip_shapes[level]
        alevel = self.albedo_level(level)
        ah, aw = self.mip_shapes[alevel]
        grouped = self.backend == "pallas"
        if self._origins is None or self._cache_level != level:
            # stride levels available above the render level (q up to 4)
            max_qexp = min(2, len(self.mips) - 1 - level,
                           len(self.albedo_mips) - 1 - alevel)
            self._origins = blocked.window_origins(
                geom, h, w, self.mips[level].shape[1], ah, aw,
                self.albedo_mips[alevel].shape[1], max_qexp=max_qexp,
                slope_maps=self.slope_maps[level:level + max_qexp + 1])
            self._wincache = blocked.extract_window_cache(
                tuple(self.mips[level:level + max_qexp + 1]),
                tuple(self.albedo_mips[alevel:alevel + max_qexp + 1]),
                self._origins, h_scale=self.h_scale, h_offset=self.h_offset,
                a_scale=self.a_scale, grouped=grouped)
            self._cache_level = level
            self._shadowwin = None
            self._packed = None
        if geom.h_bound is not None:
            # pose-local chord bound, reused by every burst until the
            # origins are dropped
            self._hbound = geom.h_bound
        if (self._shadowwin is blocked.FUSED_SHADOW_STATE
                and self.backend != "pallas"):
            self._shadowwin = None  # the sentinel means nothing off the march path
        if self.shadows_on and self._shadowwin is None:
            # the maps depend only on the sun and stay cached across pose
            # changes; the windows are the geometry-dependent half
            smap, sparams = self.shadow_args()
            self._shadowwin = blocked.build_shadow_windows(
                smap, sparams, geom, bounce_map=self._bounce,
                grouped=grouped)
            if grouped and self._packed is not None:
                swin_p, scal = blocked._pack_sun_parts(
                    self._wincache, self._origins, self._shadowwin)
                self._packed = self._packed._replace(swin=swin_p, scal=scal)
            else:
                self._packed = None
        if grouped and self._packed is None:
            self._packed = blocked.pack_windows(
                self._wincache, self._origins,
                self._shadowwin if self.shadows_on else None)
        return alevel

    def render_accumulation_frame(self):
        """Render one accumulation sample and fold it into the running
        mean. The random draws (jitter, then the march phase) follow the
        reference call for call."""
        if self.ephem is None:
            self.update_view(self.dt_local)
        level = self.mip_level()
        h, w = self.mip_shapes[level]
        if self._accum_n == 0:
            jitter = torch.zeros(2, dtype=torch.float32, device=self.device)
        else:
            jitter = torch.as_tensor(
                np.asarray(self._rng.random(2) - 0.5, np.float32),
                device=self.device)

        if self.backend in ("blocked", "pallas") and self.displaced:
            geom = blocked.block_rays(
                self.render_basis(), self._fp.rotation, jitter, self.height,
                self.width, self.h_min, maxmap=self.maxmap)
            alevel = self._ensure_blocked_caches(level, geom)
            ah, aw = self.mip_shapes[alevel]
            if self.shadows_on:
                smap, sparams = self.shadow_args()
                n_phi = smap.shape[1] - shadow_scan.PHI_PAD
                shadow_windows = self._shadowwin
            else:
                sparams, n_phi, shadow_windows = None, 0, None
            jitter_t = (0.5 if self._accum_n == 0
                        else np.float32(self._rng.random()))
            if self.backend == "pallas":
                # one jittered sample through the march kernel, from the
                # packed windows
                rgb, hitbuf = blocked.render_accumulate_pallas(
                    self._packed, sparams, self.background(), self.maxmap,
                    self.render_basis(), self._fp, self._jitter_rows(jitter),
                    self.height, self.width, h, w, self.h_min, ah=ah, aw=aw,
                    n_samples=1, use_shadow=self.shadows_on,
                    hbound=self._hbound)
                out = render_mod.RenderOutput(rgb=rgb, hitbuf=hitbuf)
            else:
                out = blocked.render_frame_blocked(
                    self._wincache, self._origins, geom, shadow_windows,
                    sparams, self.background(), self.render_basis(),
                    self._fp, float(jitter_t), self.height, self.width, h, w,
                    ah, aw, n_phi=n_phi)
        else:
            shadow_fn_args = self.shadow_args()
            out = render_mod.render_frame(
                self.mips[level], self.albedo_mips[level], self.background(),
                shadow_fn_args, self.render_basis(), self._fp, jitter,
                self.height, self.width, h, w, self.h_min,
                h_mean=1.0 / self.radius_scale, displaced=self.displaced,
                bounce_map=(self._bounce if shadow_fn_args is not None
                            else None))

        if self._accum_n == 0 or self._accum is None:
            self._accum = out.rgb
            self._hitbuf = out.hitbuf
        else:
            self._accum = render_mod.accumulate(self._accum, out.rgb,
                                                float(self._accum_n))
        self._accum_n += 1
        return self._accum

    def ensure_accumulated(self, n_frames: Optional[int] = None) -> None:
        """Accumulate up to n_frames samples: the march path's first
        samples in one burst, everything else sample by sample."""
        n = n_frames if n_frames is not None else self.config.accumulation_frames
        if (self.backend == "pallas" and self.displaced
                and self._accum_n == 0 and n > 0):
            self.render_accumulation_burst(n)
            return
        while self._accum_n < n:
            self.render_accumulation_frame()

    def render(self, n_frames: Optional[int] = None) -> np.ndarray:
        """Accumulate up to n_frames samples and return the display image
        (uint8 RGB)."""
        self.ensure_accumulated(n_frames)
        return self.display()

    def _padded_jitters(self, n_samples: int) -> torch.Tensor:
        """Accumulation jitters padded to a fixed row count (sample 0 is
        always the deterministic center); the same draws as the
        reference's numpy generator."""
        rows = max(C.MAX_ACCUMULATION_FRAMES, n_samples)
        j = np.zeros((rows, 2), np.float32)
        if n_samples > 1:
            j[1:n_samples] = self._rng.random((n_samples - 1, 2)) - 0.5
        return torch.as_tensor(j, device=self.device)

    def _jitter_rows(self, jitter) -> torch.Tensor:
        """One per-frame jitter as row 0 of the fixed-shape jitter block."""
        rows = torch.zeros((C.MAX_ACCUMULATION_FRAMES, 2),
                           dtype=torch.float32, device=self.device)
        rows[0] = jitter
        return rows

    def render_accumulation_burst(self, n_samples: int) -> None:
        """All accumulation samples in one burst through the march kernel."""
        if self.ephem is None:
            self.update_view(self.dt_local)
        level = self.mip_level()
        h, w = self.mip_shapes[level]
        jitters = self._padded_jitters(n_samples)
        alevel = self.albedo_level(level)
        ah, aw = self.mip_shapes[alevel]
        pose_valid = (self._origins is not None
                      and self._cache_level == level
                      and self._packed is not None)
        sun_valid = (not self.shadows_on) or (self._shadowwin is not None)

        if pose_valid and sun_valid:
            # nothing structural changed: just the burst
            sparams = self.shadow_args()[1] if self.shadows_on else None
            accum, hitbuf = blocked.render_accumulate_pallas(
                self._packed, sparams, self.background(), self.maxmap,
                self.render_basis(), self._fp, jitters, self.height,
                self.width, h, w, self.h_min, ah=ah, aw=aw,
                n_samples=n_samples, use_shadow=self.shadows_on,
                hbound=self._hbound)
        else:
            # pose (or level, or time) changed: origins + extraction +
            # packing + shadow windows + burst
            max_qexp = min(2, len(self.mips) - 1 - level,
                           len(self.albedo_mips) - 1 - alevel)
            if self.shadows_on:
                smap, sparams = self.shadow_args()
            else:
                smap, sparams = None, None
            (accum, hitbuf, org, cache, hwin_p, awin_p, swin_p,
             scal, hbound) = blocked.render_pose_pallas(
                tuple(self.mips[level:level + max_qexp + 1]),
                tuple(self.albedo_mips[alevel:alevel + max_qexp + 1]),
                self.slope_maps[level:level + max_qexp + 1],
                smap, sparams, self._bounce, self.background(),
                self.maxmap, self.render_basis(), self._fp, jitters,
                self.height, self.width, h, w, ah, aw, self.h_min,
                max_qexp=max_qexp, n_samples=n_samples,
                use_shadow=self.shadows_on, h_scale=self.h_scale,
                h_offset=self.h_offset, a_scale=self.a_scale)
            self._origins = org
            self._wincache = cache
            self._cache_level = level
            self._hbound = hbound
            self._packed = blocked.PackedWindows(
                hwin=hwin_p, awin=awin_p, swin=swin_p, scal=scal)
            self._shadowwin = (blocked.FUSED_SHADOW_STATE
                               if self.shadows_on else None)
        self._accum = accum
        self._hitbuf = hitbuf
        self._accum_n = n_samples

    def display(self) -> np.ndarray:
        if self._accum_n == 0:
            self.ensure_accumulated(1)
        img = render_mod.tonemap(self._accum, C.TONEMAP_EXPOSURE, self.gamma)
        return img.cpu().numpy()[: self.out_height, : self.out_width]
