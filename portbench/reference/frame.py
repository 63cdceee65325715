"""The benchmark's plain reference: one view of the Moon, from the map.

Given the deployment's render settings, the raw maps (float heights
normalized to a peak of 1, float linear albedo, float star map) and a view
(datetime, camera), this renders the frame a user should see and its hit
buffer, in plain PyTorch through the gather path: the height pyramid by
2x2 block means, the ephemeris, the exact-shadow scan with the gather
resample and the plain running max, the one-bounce irradiance pyramid,
bracket-and-bisect intersection on the render level, Lambert shading with
eclipse and earthshine terms, the star background, accumulation and the
tone map. It follows the port's own gather backend (engine/render.py)
through frozen copies under ``moonref/``, and imports nothing of the
port: what the port derives (pyramids, quantization, ephemeris, shadow
and bounce maps, windows) is worked out again here from the raw maps.

The parts of the port's engine/scene.py that glue these together
(_earth_params, default_camera, _render_background, mip_level,
shadow_level, alb_lum, _frame_params, _sun_state_of) and
data/mips.py::select_level, at commit 41cfce49f52c, are copied below with
their arithmetic unchanged; render_view is engine/render.py::render_frame
on the displaced path, with one departure: the albedo is sampled on its
own level's grid, so a render level finer than the albedo map samples it
right (the benchmark's views render at the albedo's own resolution, where
both agree).

``dtype`` holds every floating input of the scan and the render (height
and albedo levels, star map, camera basis, frame parameters, jitter) at
another precision: each is rounded to it, and the arithmetic then runs in
float32 on the rounded values, as a program that stores its maps and
per-frame state in that type would. bfloat16 is the benchmark's control
(portbench/control.py).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from reference.moonref import constants as C
from reference.moonref.astro import calculate_ephemeris
from reference.moonref.engine import geometry
from reference.moonref.engine import light as light_mod
from reference.moonref.engine import render as render_mod
from reference.moonref.engine.camera import (CameraBasis, camera_basis,
                                             ray_directions)
from reference.moonref.engine.render import FrameParams
from reference.moonref.ops import sampler, shadow_scan
from reference.moonref.types import Camera, Observer

MIP_MIN_SIZE = 64                       # data/pyramids.py
PAD_COLS = 192                          # data/pyramids.py
SHADOW_MAX_TEXELS = 20 * 1024 * 1024    # engine/scene.py


def select_level(shapes: list, texels_per_pixel: float,
                 threshold: float = 1.4) -> int:
    """data/mips.py::select_level: the last level with at least about one
    texel per screen pixel (each level halves the footprint)."""
    level = 0
    t = texels_per_pixel
    while t >= threshold and level + 1 < len(shapes):
        t /= 2.0
        level += 1
    return level


def default_camera() -> Camera:
    """engine/scene.py::default_camera."""
    visible_height = 2 * C.MOON_RADIUS / C.MOON_FILL_FRACTION
    fov = math.degrees(2 * math.atan(visible_height / (2 * C.CAMERA_DISTANCE)))
    return Camera(eye=[0.0, -C.CAMERA_DISTANCE, 0.0], target=[0.0, 0.0, 0.0],
                  up=[0.0, 0.0, 1.0], fov=max(1.0, min(90.0, fov)))


def earth_params(e, eclipse: bool, earthshine: bool) -> np.ndarray:
    """engine/scene.py::_earth_params."""
    lat = math.radians(e.libr_lat_geo)
    lon = math.radians(e.libr_long_geo)
    cl = math.cos(lat)
    d_units = e.distance / C.MOON_RADIUS_KM * C.MOON_RADIUS
    if eclipse:
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


def block_mean2(m: torch.Tensor) -> torch.Tensor:
    """2x2 block mean (trailing remainder cropped), (H, W) or (H, W, C)."""
    h, w = m.shape[0] // 2, m.shape[1] // 2
    m = m[: 2 * h, : 2 * w]
    return m.reshape(h, 2, w, 2, *m.shape[2:]).mean(dim=(1, 3))


def pad_wrap(m: torch.Tensor) -> torch.Tensor:
    """PAD_COLS wrapped longitude columns on the right (data/mips.py)."""
    return torch.cat([m, m[:, :PAD_COLS]], dim=1)


def upload(a: np.ndarray, device, rows: int = 2048) -> torch.Tensor:
    """A host float array on ``device`` as float32, in row bands."""
    out = torch.empty(a.shape, dtype=torch.float32, device=device)
    for r0 in range(0, a.shape[0], rows):
        out[r0:r0 + rows] = torch.from_numpy(
            np.ascontiguousarray(a[r0:r0 + rows], dtype=np.float32))
    return out


class ReferenceScene:
    """The deployment's maps as a plain float pyramid, and views of it.

    settings: the configuration's ``render`` settings (width, height,
    shadow_accuracy, indirect_light, indirect_bounces, eclipse_shading,
    earthshine, photometric, brightness, gamma, view_orientation,
    parallactic_mode); observer: (lat, lon, elevation_m)."""

    def __init__(self, settings: dict, observer, elevation: np.ndarray,
                 radius_scale: float, albedo: np.ndarray,
                 starmap: Optional[np.ndarray], device,
                 dtype: torch.dtype = torch.float32):
        self.s = dict(settings)
        self.observer = Observer(*observer)
        self.device = torch.device(device)
        self.dtype = dtype
        self.radius_scale = float(radius_scale)
        self.width = int(self.s["width"])
        self.height = int(self.s["height"])
        # height chain: level 0 is the map, each level the 2x2 block mean of
        # the one before, down to MIP_MIN_SIZE (data/mips.py::build_mips)
        cur = upload(elevation, self.device)
        self.h_min = float(cur.min())
        self.shapes = [tuple(cur.shape)]
        self._levels = {}
        levels = [cur]
        while min(cur.shape[0], cur.shape[1]) // 2 >= MIP_MIN_SIZE:
            cur = block_mean2(cur)
            levels.append(cur)
            self.shapes.append(tuple(cur.shape))
        self._height_levels = levels
        self._albedo_base = upload(albedo, self.device)
        self._albedo = {}
        self._alb_lum = {}
        self.starmap = (None if starmap is None
                        else pad_wrap(upload(starmap, self.device)))

    def close(self) -> None:
        self._height_levels = self._albedo_base = None
        self._levels, self._albedo, self._alb_lum = {}, {}, {}
        self.starmap = None

    # ---- levels ------------------------------------------------------------

    def level(self, k: int) -> torch.Tensor:
        """Height level k, padded with wrapped columns."""
        if k not in self._levels:
            self._levels[k] = pad_wrap(self._height_levels[k])
        return self._levels[k]

    def albedo(self, k: int) -> torch.Tensor:
        """Albedo at height level k's grid when the albedo map is at least
        that fine (block means of it), else the albedo map itself; padded."""
        if k not in self._albedo:
            a = self._albedo_base
            while a.shape[0] // 2 >= self.shapes[k][0] \
                    and min(a.shape[0], a.shape[1]) // 2 >= MIP_MIN_SIZE:
                a = block_mean2(a)
            self._albedo[k] = pad_wrap(a)
        return self._albedo[k]

    def alb_lum(self, k: int) -> torch.Tensor:
        """Albedo luminance on height level k's grid (engine/scene.py::alb_lum
        samples the albedo pyramid entry aligned with level k)."""
        if k not in self._alb_lum:
            a = self.albedo(k)
            h, w = self.shapes[k]
            if a.shape[0] != h:
                raise ValueError(f"no albedo level on the {h}-row grid")
            self._alb_lum[k] = torch.mean(a, dim=2)
        return self._alb_lum[k]

    def mip_level(self, camera: Camera) -> int:
        """engine/scene.py::mip_level."""
        eye = np.asarray(camera.eye)
        dist = max(float(np.linalg.norm(eye)) - C.MOON_RADIUS, 1.0)
        px_ang = math.radians(camera.fov) / self.height
        ground_per_px = dist * px_ang
        w0 = self.shapes[0][1]
        texel_ground = 2 * math.pi * C.MOON_RADIUS / w0
        return select_level(self.shapes, ground_per_px / texel_ground)

    def shadow_level(self, level: int) -> int:
        """engine/scene.py::shadow_level (and _capped_level); the albedo
        floor is the coarsest level the albedo map still reaches."""
        lvl = max(level, 0)
        while (lvl + 1 < len(self.shapes)
               and self.shapes[lvl][0] * self.shapes[lvl][1]
               > SHADOW_MAX_TEXELS):
            lvl += 1
        if self.s["indirect_light"]:
            while self.albedo(lvl).shape[0] != self.shapes[lvl][0]:
                lvl += 1
        return lvl

    # ---- one view ------------------------------------------------------------

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        """x rounded to the reference's storage precision, as float32."""
        return x if self.dtype == torch.float32 else x.to(self.dtype).float()

    def _t(self, v) -> torch.Tensor:
        return self._q(torch.as_tensor(np.asarray(v, np.float32),
                                       device=self.device))

    def frame_params(self, e, brightness: int) -> FrameParams:
        """engine/scene.py::_frame_params."""
        t = self._t
        light_pos = light_mod.calculate_light_pos(e)
        disk_c, disk_r = light_mod.calculate_sun_disk(e)
        s = self.s
        return FrameParams(
            rotation=t(e.rotation_matrix),
            light_pos=t(light_pos),
            sun_disk_center=t(disk_c),
            sun_disk_radius=t(disk_r),
            irradiance=t(light_mod.sun_irradiance_factor(brightness, e)),
            sun_ang_radius=t(math.asin(C.SUN_RADIUS_KM / e.sun_distance)),
            lunar_blend=(t(light_mod.lunar_lambert_blend(e.phase_angle))
                         if s["photometric"] == "lunar" else None),
            earth=(t(earth_params(e, s["eclipse_shading"], s["earthshine"]))
                   if (s["eclipse_shading"] or s["earthshine"]) else None))

    def background(self, basis: CameraBasis):
        """engine/scene.py::_render_background."""
        if self.starmap is None:
            return None
        sm = self._q(self.starmap)
        dev = sm.device
        height, width = self.height, self.width
        ys = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
        xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
        v = 1.0 - 2.0 * (ys + 0.5) / height
        u = (2.0 * (xs + 0.5) / width - 1.0) * (width / height)
        d = (basis.forward[None, None, :]
             + basis.tan_half_fov * (u[..., None] * basis.right[None, None, :]
                                     + v[..., None] * basis.up[None, None, :]))
        lat, lon = geometry.unit_to_latlon(d)
        h, w = sm.shape[0], sm.shape[1] - PAD_COLS
        row, col = sampler.latlon_to_rowcol(lat, lon, h, w)
        return sampler.gather_bilinear(sm, row, col)

    def shadow_maps(self, e, level: int):
        """(shadow_map, params, bounce_map or None) for the sun of ``e``
        (engine/scene.py::_sun_state_of and _dispatch_shadow_maps, with a
        fresh bounce map)."""
        if int(self.s["shadow_accuracy"]) <= 1:
            return None, None, None
        sun_body = np.asarray(e.rotation_matrix).T @ np.asarray(
            light_mod.calculate_light_pos(e))
        sun_unit = sun_body / np.linalg.norm(sun_body)
        ang = math.asin(C.SUN_RADIUS_KM / e.sun_distance)
        slevel = self.shadow_level(level)
        tex = self._q(self.level(slevel))
        sh, sw = self.shapes[slevel]
        sun = self._t(sun_unit)
        acc = int(self.s["shadow_accuracy"])
        if self.s["indirect_light"]:
            smap, params, bmap = shadow_scan.build_shadow_and_bounce(
                tex, self._q(self.alb_lum(slevel)), sh, sw, sun, ang,
                accuracy=acc,
                n_bounces=int(self.s["indirect_bounces"]))
            return smap, params, bmap
        smap, params = shadow_scan.build_shadow_map(tex, sh, sw, sun, ang,
                                                    accuracy=acc)
        return smap, params, None

    def render(self, view, jitters) -> tuple:
        """(uint8 frame (H, W, 3), hit buffer (H, W, 4) float32), both on the
        host, of ``view`` (dt, camera, brightness, gamma): the mean of one
        gather-path sample per row of ``jitters`` ((n, 2) sub-pixel offsets,
        row 0 the pixel centres), tone-mapped."""
        dt, camera, brightness, gamma = view
        e = calculate_ephemeris(dt, self.observer,
                                bool(self.s["parallactic_mode"]))
        fp = self.frame_params(e, int(brightness))
        level = self.mip_level(camera)
        h, w = self.shapes[level]
        tex = self._q(self.level(level))
        alb = self._q(self.albedo(level))
        ah, aw = alb.shape[0], alb.shape[1] - PAD_COLS
        smap, params, bmap = self.shadow_maps(e, level)
        b = camera_basis(camera, self.s["view_orientation"], self.device)
        basis = CameraBasis(*(self._q(x) for x in b))
        background = self.background(basis)
        accum = hitbuf = None
        for i, j in enumerate(np.asarray(jitters, np.float32)):
            rgb, hb = render_view(
                tex, alb, background,
                None if smap is None else (smap, params), basis, fp,
                self._t(j), self.height, self.width, h, w, ah, aw,
                self.h_min, bounce_map=bmap)
            if accum is None:
                accum, hitbuf = rgb, hb
            else:
                accum = render_mod.accumulate(accum, rgb, float(i))
        img = render_mod.tonemap(accum, C.TONEMAP_EXPOSURE, float(gamma))
        return img.cpu().numpy(), hitbuf.cpu().numpy()


def render_view(tex, albedo_tex, background, shadow_fn_args,
                basis: CameraBasis, fp: FrameParams, jitter, height: int,
                width: int, h: int, w: int, ah: int, aw: int, h_min: float,
                n_coarse: int = 48, bounce_map=None):
    """engine/render.py::render_frame (displaced), with the albedo sampled
    on its own (ah, aw) grid. Returns (rgb, hitbuf)."""
    dirs_scene = ray_directions(basis, height, width, jitter)
    ob = geometry.mat3t_apply(fp.rotation, basis.eye)
    db = geometry.mat3t_apply(fp.rotation, dirs_scene)
    hit, t_hit, lat, lon, p = render_mod.intersect_heightfield(
        tex, h, w, h_min, ob, db, n_coarse=n_coarse)
    hs = sampler.sample_latlon(tex, lat, lon, h, w)
    n_body = render_mod.surface_normal(tex, h, w, lat, lon, hs)
    albedo = sampler.sample_latlon(albedo_tex, lat, lon, ah, aw)
    bounce = None
    if shadow_fn_args is not None:
        shadow_map, smap_params = shadow_fn_args
        shadow = shadow_scan.shadow_lookup(shadow_map, smap_params, p)
        if bounce_map is not None:
            bounce = shadow_scan.shadow_lookup(bounce_map, smap_params, p)
    else:
        shadow = torch.ones_like(t_hit)
    rgb = render_mod.shade_lambert(albedo, n_body, p, fp, shadow,
                                   bounce=bounce, view_db=db)
    disk = render_mod.sun_disk_hit(basis.eye, dirs_scene, fp)
    miss_rgb = (torch.zeros((height, width, 3), dtype=torch.float32,
                            device=rgb.device)
                if background is None else background)
    miss_rgb = torch.where(disk[..., None], C.SUN_DISK_COLOR, miss_rgb)
    rgb = torch.where(hit[..., None], rgb, miss_rgb)
    p_scene = geometry.mat3_apply(fp.rotation, p)
    hitbuf = torch.cat(
        [torch.where(hit[..., None], p_scene, 0.0),
         torch.where(hit, t_hit, 0.0)[..., None]], dim=-1)
    return rgb, hitbuf
