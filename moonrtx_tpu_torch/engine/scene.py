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

Between frames the scene keeps what a small change leaves valid, as the
reference does: a time step or a camera drag whose accumulated drift stays
inside the windows' margin keeps the pose windows (update_view,
set_camera); on the march path such a time step runs one scan + shadow
windows + burst step and reuses the bounce map, refreshing it behind the
frame past BOUNCE_REUSE_DEG (render_accumulation_burst); the step just
left is kept for a Q/W direction flip (the flip cache); and the next
held-key step can be dispatched ahead (prefetch_time), in stream order
behind the frame. Picking and measurement read small host copies
(get_hit_at, elevation_m_at). The maps go up in row bands
(_upload_rows_banded).

With a device mesh (config.devices > 1, or ``mesh=``), every displaced
frame renders through the strip programs of parallel/tiles.py and the
shadow maps through its phi-wedge scan (_mesh_step); the pose, window
and sun caches live per device as NamedTuples of per-device lists in the
same scene fields, so the drift policy, the flip cache and the
speculation apply unchanged. Levels too big for the per-device memory
budget are band-sharded across the mesh (_plan_bands,
parallel/hfshard.py) and never materialised whole on one device.
"""

from __future__ import annotations

import math
import sys
import time as _time
import warnings
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from moonrtx_tpu_torch import constants as C
from moonrtx_tpu_torch.astro import calculate_ephemeris
from moonrtx_tpu_torch.config import RenderConfig
from moonrtx_tpu_torch.data.mips import pad_lon_wrap, select_level
from moonrtx_tpu_torch.data.pyramids import (
    PAD_COLS, QUANTIZE_TEXELS, _drop_mmap_pages, load_or_build)
from moonrtx_tpu_torch.device import resolve_device
from moonrtx_tpu_torch.engine import blocked
from moonrtx_tpu_torch.engine import camera as camera_mod
from moonrtx_tpu_torch.engine import geometry
from moonrtx_tpu_torch.engine import light as light_mod
from moonrtx_tpu_torch.engine import render as render_mod
from moonrtx_tpu_torch.engine.camera import CameraBasis, camera_basis
from moonrtx_tpu_torch.engine.render import FrameParams
from moonrtx_tpu_torch.ops import sampler
from moonrtx_tpu_torch.ops import shadow_scan
from moonrtx_tpu_torch.types import Camera, MoonEphemeris
from moonrtx_tpu_torch.utils.log import log_event
from moonrtx_tpu_torch.utils.profiling import count, span

# Shadow scans sample the heightfield at the scan grid's own resolution
# (<= 2304x4096 cells); building from a much finer mip wastes bandwidth.
SHADOW_MAX_TEXELS = 20 * 1024 * 1024

# One-bounce irradiance maps are reused across time steps while the
# sun-frame rotation since their build stays under this angle. The field's
# own blur scale is >= 2 scan cells (~0.1-0.2 deg of arc), so drifts below
# the threshold are inside its intrinsic resolution; a 15-min Q/W step
# moves the sun ~0.13 deg, so held-key animation rebuilds the bounce about
# every 4th step and the shadow factor map every step.
BOUNCE_REUSE_DEG = 0.5

# Crossing BOUNCE_REUSE_DEG during held-key animation does NOT stall the
# frame on a bounce rebuild: the step renders with the cached map and a
# shadow_scan.bounce_refresh is queued BEHIND it (reusing the frame's own
# scan), so the next step picks up the fresh map. The stale map is used up
# to threshold + one step (~0.63 deg); beyond this cap (a time JUMP: date
# dialog, "now") the rebuild is synchronous for correctness.
BOUNCE_ASYNC_MAX_DEG = 4 * BOUNCE_REUSE_DEG


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


# Host->device transfers go in row bands of this many bytes: a whole-level
# copy stages a full-size host array beside its memory-mapped source, about
# 2 GB more host peak RSS at the 23040x46080 working set
# (tools/torch_upload_rss.py).
UPLOAD_BAND_BYTES = 256 << 20


def _upload_rows_banded(m: np.ndarray, device,
                        band_bytes: int = UPLOAD_BAND_BYTES) -> torch.Tensor:
    """Upload a host array in row bands into one tensor allocated up
    front, so the host stages at most one band, and drop the source's
    mmap pages as the bands go.

    The reference syncs every fourth band because JAX dispatch is
    asynchronous and keeps each in-flight band's host copy alive. Here a
    copy from pageable host memory returns only once the band is staged
    (PyTorch synchronises the stream after a blocking host-to-device
    copy), so no band is in flight and the pages are dropped after every
    band. On the CPU the result owns its memory: it never aliases a
    read-only mmap."""
    rows = int(m.shape[0])
    row_bytes = max(m.nbytes // max(rows, 1), 1)
    rb = max(int(band_bytes // row_bytes), 1)
    dtype = torch.from_numpy(np.empty(0, m.dtype)).dtype
    out = torch.empty(m.shape, dtype=dtype, device=device)
    for r0 in range(0, rows, rb):
        with warnings.catch_warnings():
            # a band of a read-only mmap: copy_ only reads it
            warnings.simplefilter("ignore", UserWarning)
            band = torch.from_numpy(np.ascontiguousarray(m[r0:r0 + rb]))
        out[r0:r0 + rb].copy_(band)
        _drop_mmap_pages(m)
    return out


def resolve_mesh(config: RenderConfig, device: torch.device, mesh=None):
    """The scene's device mesh, or None for one device.

    ``mesh`` (a parallel.Mesh) is taken as given. Otherwise
    config.devices keeps the reference's meaning: 0 is every local device
    (every card; one CPU device), N > 1 a mesh of exactly N devices, which
    make_mesh refuses to build on a host with fewer cards."""
    n_req = int(getattr(config, "devices", 1))
    if mesh is not None:
        if n_req > 1 and n_req != mesh.size:
            raise ValueError(f"devices={n_req} but the mesh has "
                             f"{mesh.size} devices")
        return mesh if mesh.size > 1 else None
    if n_req == 0:
        n_req = torch.cuda.device_count() if device.type == "cuda" else 1
    if n_req <= 1:
        return None
    from moonrtx_tpu_torch.parallel import make_mesh
    return make_mesh(n_req, device=device)


class MoonScene:
    """Owns device textures + scene state; renders progressive frames.

    ``device`` None means the CUDA card (moonrtx_tpu_torch.device); pass
    ``device="cpu"`` to run the plain PyTorch path on the host. ``mesh``
    (parallel.make_mesh) renders over several devices, as config.devices
    > 1 does; the scene's own device is then the mesh's first, where the
    frames are gathered."""

    def __init__(self, config: RenderConfig, elevation: np.ndarray,
                 radius_scale: float, albedo: np.ndarray,
                 starmap: Optional[np.ndarray], device=None, mesh=None):
        if device is None and mesh is not None:
            device = mesh.devices[0]
        self.device = resolve_device(device)
        self.config = config
        self.radius_scale = float(radius_scale)
        # image rows and shadow-scan phi wedges split over the mesh; a
        # devices=N request is a hard one (make_mesh raises on fewer)
        self.mesh = resolve_mesh(config, self.device, mesh)
        if self.mesh is not None:
            self.device = self.mesh.devices[0]
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
        host_alb = [ps.albedo_kept[0]] * ps.alb_min_level + list(
            ps.albedo_kept)
        # Host pyramids stay referenced on a mesh: band sharding builds the
        # per-device bands from them lazily. Without a mesh only level 0 is
        # kept (below).
        self._host_mips = list(ps.mips)
        self._host_albedo = host_alb
        self.alb_min_level = int(ps.alb_min_level)
        # Placement (mesh mode): levels too big for the per-device memory
        # budget are band-sharded across the mesh instead of replicated;
        # their self.mips/albedo_mips slots hold None and every render of
        # them goes through the banded burst.
        self.hbm_over_budget: Optional[dict] = None
        self._band_levels, self._band_alb_levels = self._plan_bands()
        if self.alb_min_level in self._band_alb_levels:
            # head slots alias the alb_min_level array: keep them banded
            # too, or the aliased upload would materialise it whole
            self._band_alb_levels.update(range(self.alb_min_level))
        self._banded_mips = {}
        self._banded_albedo = {}
        t_upload = _time.time()
        self._install(
            mips=[None if k in self._band_levels
                  else _upload_rows_banded(m, self.device)
                  for k, m in enumerate(ps.mips)],
            albedo_mips=self._upload_aliased(host_alb,
                                             self._band_alb_levels),
            maxmap=_upload_rows_banded(ps.maxmap, self.device),
            slope_maps=_upload_rows_banded(ps.slope_maps, self.device),
            starmap=(_upload_rows_banded(pad_lon_wrap(starmap, PAD_COLS),
                                         self.device)
                     if starmap is not None else None),
            h_min=ps.h_min, h_scale=ps.h_scale, h_offset=ps.h_offset,
            a_scale=ps.a_scale, alb_min_level=ps.alb_min_level,
            mip_shapes=[(m.shape[0], m.shape[1] - PAD_COLS)
                        for m in ps.mips])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.upload_wall_s = _time.time() - t_upload
        if self.mesh is None:
            # Host level 0 stays referenced (mmap-backed when it came from
            # the pyramid cache, never copied): full-resolution measurement
            # samples it without device transfers. The other levels are
            # dropped after upload.
            self._host_mips = [ps.mips[0]] + [None] * (len(ps.mips) - 1)
            self._host_albedo = None

        # internal render size padded to the block grid (display crops
        # back); on a mesh the height pads to equal strips per device
        self.out_width = config.width
        self.out_height = config.height
        w_mult = blocked.BLOCK_W * blocked.GROUP  # 8-block strips
        self.width = -(-config.width // w_mult) * w_mult
        h_mult = blocked.BLOCK_H * (self.mesh.size if self.mesh else 1)
        self.height = -(-config.height // h_mult) * h_mult
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
        self._hitbuf_host = None     # once-per-frame host pick cache
        self._hitbuf_src = None
        self._pickwin = None         # host copy of a PICK_WIN^2 hit window
        self._pickwin_src = None
        self._pickwin_origin = (0, 0)
        self._elev_host = None       # host elevation cache for measurement
        self._elev_host_src = None
        self._prefetch = None        # speculative next-time-step results
        # one-deep flip cache: the previous time step's fully-rendered
        # state, restorable when a Q/W direction flip targets it (t-1 is
        # a state the device just computed)
        self._flip_cache = None
        self._flip_ready = False     # consumable: next burst may no-op
        self.last_flip_hit = False   # observability (bench/tests)
        self._rng = np.random.default_rng(42)

    def _upload_aliased(self, host_alb, skip=()):
        uploaded = {}
        out = []
        for k, a in enumerate(host_alb):  # aliased head slots upload once
            if k in skip:
                out.append(None)
                continue
            if id(a) not in uploaded:
                uploaded[id(a)] = _upload_rows_banded(a, self.device)
            out.append(uploaded[id(a)])
        return out

    def _install(self, mips, albedo_mips, maxmap, slope_maps, starmap,
                 h_min, h_scale, h_offset, a_scale, alb_min_level,
                 mip_shapes=None) -> None:
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
        self.mip_shapes = mip_shapes or [(m.shape[0], m.shape[1] - PAD_COLS)
                                         for m in self.mips]
        self._replicas = {}          # id(map) -> (map, per-device copies)

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
        # every level arrives whole: nothing stays band-sharded
        self._band_levels, self._band_alb_levels = set(), set()
        self._banded_mips, self._banded_albedo = {}, {}
        self.hbm_over_budget = None
        self._host_mips = [self.mips[0].cpu().numpy()] + [None] * (
            len(self.mips) - 1)
        self._alb_lum = {}
        self._background = None
        self._shadow = self._bounce = None
        self._bounce_basis = self._bounce_key = None
        self._shadow_dirty = True
        self._clear_pose()
        self._prefetch = None
        self._flip_cache = None
        self._flip_ready = False
        self.reset_accumulation()

    def _clear_pose(self) -> None:
        self._window_drift = 0.0     # rotation/camera drift since extraction
        self._origins = None         # WindowOrigins (per pose+level+rotation)
        self._hbound = None          # per-block chord bound (pose-local)
        self._wincache = None        # WindowCache
        self._shadowwin = None       # ShadowWindows, or FUSED_SHADOW_STATE
        self._packed = None          # PackedWindows (march-kernel layout)
        self._cache_level = None
        # a date or camera change dropped the windows and counted it, so
        # their rebuild is not counted again as windows.rebuilt.other
        self._pose_dropped = False

    # ---- heightfield band sharding (per-device memory placement) --------

    def _hbm_budget_bytes(self) -> Optional[int]:
        """Per-device memory budget: the config knob, or three quarters of
        the card's memory (headroom for frames, windows and scratch)
        divided among the logical devices that share it, or None when
        neither is known (the CPU: replicate)."""
        gb = float(getattr(self.config, "hbm_budget_gb", 0.0))
        if gb > 0:
            return int(gb * 2**30)
        dev = self.mesh.devices[0] if self.mesh is not None else self.device
        if dev.type != "cuda":
            return None
        total = torch.cuda.get_device_properties(dev).total_memory
        share = self.mesh.sharing(dev) if self.mesh is not None else 1
        return int(0.75 * total) // share

    def _plan_bands(self) -> tuple[set, set]:
        """(mip levels, albedo levels) to band-shard across the mesh.

        Bands engage only when a mesh exists and the device-ready pyramid
        bytes exceed the per-device budget. Only levels above the
        shadow-scan working-set cap are candidates (the scan, the bounce
        alb_lum and the host measurement copy read the <= SHADOW_MAX_TEXELS
        levels and need them replicated), and a mip level k is banded only
        when the row counts of k, k+1 and its albedo levels all divide the
        mesh: the banded burst samples (level, level+1) pairs, so partial
        banding of a pair is unrenderable. Biggest first until the
        projected per-device footprint fits the budget."""
        if self.mesh is None:
            return set(), set()
        from moonrtx_tpu_torch.parallel import BAND_HALO

        n_dev = self.mesh.size
        mips, albs = self._host_mips, self._host_albedo
        total = (sum(m.nbytes for m in mips)
                 + sum(a.nbytes for a in albs[self.alb_min_level:]))
        budget = self._hbm_budget_bytes()
        if budget is None or total <= budget:
            if budget is None and total > 8 * 2**30:
                log_event("hfshard_skipped", reason="unknown HBM budget",
                          pyramid_bytes=total)
            return set(), set()

        def divides(arr):
            return arr.shape[0] % n_dev == 0

        def big(arr):
            return (arr.shape[0] * (arr.shape[1] - PAD_COLS)
                    > SHADOW_MAX_TEXELS)

        def band_bytes(arr):
            band_h = arr.shape[0] // n_dev
            return arr.nbytes * (band_h + BAND_HALO) // arr.shape[0]

        def alb_index(k):
            return min(max(k + blocked.ALB_DOWN, self.alb_min_level),
                       len(albs) - 1)

        def level_set(r):
            """The (mip, mip+1, albedo, albedo+1) indices the banded burst
            samples for render level r; MUST mirror _pose_program_sharded
            and hf_sharded (nalevel is albedo_level(r)+1, not
            albedo_level(r+1))."""
            nr = min(r + 1, len(mips) - 1)
            ar = alb_index(r)
            nar = min(ar + 1, len(albs) - 1)
            return r, nr, ar, nar

        def hf_routed(r, band_mips, band_albs):
            rr, nr, ar, nar = level_set(r)
            return (rr in band_mips or nr in band_mips
                    or ar in band_albs or nar in band_albs)

        # Candidates are render levels: banding level k bands mips[k] and
        # its albedo together, and requires (k, k+1, albedo(k),
        # albedo(k)+1) all divisible so the (level, level+1) pair the
        # banded burst reads is always bandable.
        cand = []
        for k, m in enumerate(mips):
            _, nk, ak, nak = level_set(k)
            if not (big(m) and divides(m) and divides(mips[nk])
                    and divides(albs[ak]) and divides(albs[nak])):
                continue
            cand.append((k, ak if big(albs[ak]) else None,
                         m.nbytes + (albs[ak].nbytes if big(albs[ak])
                                     else 0)))
        cand.sort(key=lambda c: -c[2])

        def projected_bytes(band_mips, band_albs):
            """Worst-case per-device footprint of a placement: replicated
            levels in full, banded levels as band+halo, including every
            lazily-banded copy the banded burst can create at render time
            (any render level whose (level, level+1, albedo, albedo+1)
            set touches a banded entry renders banded and bands its whole
            set; those copies coexist with their replicated originals)."""
            lazy_m, lazy_a = set(), set()
            for r in range(len(mips)):
                if not hf_routed(r, band_mips, band_albs):
                    continue
                rr, nr, ar, nar = level_set(r)
                for k in (rr, nr):
                    if k not in band_mips:
                        lazy_m.add(k)
                for a in (ar, nar):
                    if a not in band_albs:
                        lazy_a.add(a)
            tot = 0
            for k, m in enumerate(mips):
                tot += band_bytes(m) if k in band_mips else m.nbytes
                if k in lazy_m:
                    tot += band_bytes(m)
            seen = set()
            for k, a in enumerate(albs):
                if k < self.alb_min_level or id(a) in seen:
                    continue
                seen.add(id(a))
                tot += band_bytes(a) if k in band_albs else a.nbytes
                if k in lazy_a:
                    tot += band_bytes(a)
            return tot

        def closure_bandable(band_mips, band_albs):
            """Every level the banded route would lazily band under this
            plan must divide the mesh, or rendering would raise."""
            for r in range(len(mips)):
                if not hf_routed(r, band_mips, band_albs):
                    continue
                rr, nr, ar, nar = level_set(r)
                if not (divides(mips[rr]) and divides(mips[nr])
                        and divides(albs[ar]) and divides(albs[nar])):
                    return False
            return True

        band_mips, band_albs = set(), set()
        projected = total
        for k, ak, _ in cand:
            if projected <= budget:
                break
            trial_m = band_mips | {k}
            trial_a = band_albs | ({ak} if ak is not None else set())
            if not closure_bandable(trial_m, trial_a):
                continue
            band_mips, band_albs = trial_m, trial_a
            projected = projected_bytes(band_mips, band_albs)
        if band_mips or band_albs:
            log_event("hfshard_engaged", devices=n_dev,
                      pyramid_bytes=total, budget_bytes=budget,
                      projected_bytes=projected,
                      banded_mip_levels=sorted(band_mips),
                      banded_albedo_levels=sorted(band_albs))
        if projected > budget:
            # not nested under the bands-chosen branch: a scene where no
            # level is bandable at all is over budget with empty band sets
            # and must warn the same way; the status bar's "memory" panel
            # mirrors it (app/session.py)
            log_event("hfshard_over_budget",
                      projected_bytes=projected, budget_bytes=budget)
            self.hbm_over_budget = {"projected_bytes": projected,
                                    "budget_bytes": budget}
            banded = "fully-banded" if (band_mips or band_albs) \
                else "(unbandable) replicated"
            print(f"WARNING: even the {banded} heightfield plan "
                  f"needs {projected / 2**30:.2f} GiB/device against a "
                  f"{budget / 2**30:.2f} GiB memory budget "
                  f"({n_dev} devices). Expect allocator pressure; "
                  "add devices, raise --hbm-budget-gb, or downscale.",
                  file=sys.stderr)
        return band_mips, band_albs

    def _banded_mip(self, k: int) -> list:
        """Per-device bands of mip level k (built lazily, cached)."""
        if k not in self._banded_mips:
            from moonrtx_tpu_torch.parallel import shard_bands
            self._banded_mips[k] = shard_bands(self.mesh, self._host_mips[k])
        return self._banded_mips[k]

    def _banded_alb(self, k: int) -> list:
        if k not in self._banded_albedo:
            from moonrtx_tpu_torch.parallel import shard_bands
            self._banded_albedo[k] = shard_bands(self.mesh,
                                                 self._host_albedo[k])
        return self._banded_albedo[k]

    def hf_sharded(self) -> bool:
        """True when the current render level renders through the banded
        heightfield path."""
        if self.mesh is None:
            return False
        level = self.mip_level()
        nlevel = min(level + 1, len(self.mips) - 1)
        alevel = self.albedo_level(level)
        nalevel = min(alevel + 1, len(self.albedo_mips) - 1)
        return any(k in self._band_levels for k in (level, nlevel)) or any(
            k in self._band_alb_levels for k in (alevel, nalevel))

    def _rep(self, t):
        """A replicated map as the strip programs take it: the tensor
        itself when every device of the mesh is the scene's device (CPU
        or one card), else its copies on every device, made once."""
        if t is None or all(d == self.device for d in self.mesh.devices):
            return t
        hit = self._replicas.get(id(t))
        if hit is None or hit[0] is not t:
            from moonrtx_tpu_torch.parallel import replicated
            hit = self._replicas[id(t)] = (t, replicated(self.mesh, t))
        return hit[1]

    def _rep_levels(self, stack, level: int, n: int):
        """Levels [level, level + n) of a replicated (levels, h, w) stack,
        each device's from its copy made once by _rep."""
        rep = self._rep(stack)
        if isinstance(rep, torch.Tensor):
            return rep[level:level + n]
        return [s[level:level + n] for s in rep]

    # ---- state updates -------------------------------------------------

    def _flip_token(self):
        """Everything a flip-cache entry's validity depends on besides its
        datetime: any of these changing means the snapshot's frame/caches
        no longer describe the scene the user sees. The camera is carried
        by identity and pinned inside the entry (same aliasing discipline
        as the prefetch token pins)."""
        return (self.brightness, self.shadows_on, self.shadow_accuracy,
                self.indirect_light, self.view_orientation,
                id(self.camera), self.parallactic_mode, self.backend,
                self.displaced)

    def _snapshot_step(self) -> Optional[dict]:
        """Capture the CURRENT fully-rendered time step as a flip-cache
        entry (references only: every field is a tensor no later step
        writes in place, or a host value, so a snapshot copies nothing; the
        device memory it keeps is one accum + hit buffer + the
        sun-dependent packed windows)."""
        if (self.ephem is None or self._accum is None or self._accum_n < 1
                or not self.displaced
                # _shadow_dirty is only meaningful while shadows render;
                # with them off nothing ever clears it after a step
                or (self._shadow_dirty and self.shadows_on)):
            return None
        return dict(
            dt=self.dt_local, token=self._flip_token(), ephem=self.ephem,
            shadow_dirty=self._shadow_dirty,
            fp=self._fp, shadow=self._shadow, bounce=self._bounce,
            bounce_basis=self._bounce_basis, bounce_key=self._bounce_key,
            origins=self._origins, wincache=self._wincache,
            cache_level=self._cache_level,
            window_drift=self._window_drift,
            hbound=self._hbound, packed=self._packed,
            shadowwin=self._shadowwin, accum=self._accum,
            hitbuf=self._hitbuf, accum_n=self._accum_n,
            pins=(self.camera,))

    def _restore_step(self, fc: dict) -> None:
        """Install a flip-cache entry as the current scene state, the
        exact inverse of _snapshot_step. The restored accumulation is
        already on the device, so the following render_accumulation_burst
        is a no-op (_flip_ready) and the step costs only the display
        readback."""
        self.dt_local = fc["dt"]
        self.ephem = fc["ephem"]
        self._fp = fc["fp"]
        self._shadow = fc["shadow"]
        self._shadow_dirty = fc["shadow_dirty"]
        self._bounce = fc["bounce"]
        self._bounce_basis = fc["bounce_basis"]
        self._bounce_key = fc["bounce_key"]
        self._origins = fc["origins"]
        self._wincache = fc["wincache"]
        self._cache_level = fc["cache_level"]
        self._window_drift = fc["window_drift"]
        self._hbound = fc["hbound"]
        self._packed = fc["packed"]
        self._shadowwin = fc["shadowwin"]
        self._accum = fc["accum"]
        self._hitbuf = fc["hitbuf"]
        self._accum_n = fc["accum_n"]
        self._flip_ready = True
        self._pose_dropped = False
        if self._prefetch is not None \
                and self._prefetch["dt"] != self.dt_local:
            self._discard_prefetch()  # speculation missed: free its buffers

    @span("scene.update_view")
    def update_view(self, dt_local: Optional[datetime] = None) -> MoonEphemeris:
        """Recompute ephemeris-driven state (reference moon_renderer.py:638-664)."""
        self.last_flip_hit = False
        if (dt_local is not None and self.dt_local is not None
                and dt_local != self.dt_local):
            # Direction flips target a datetime the device may have JUST
            # rendered (t-1). Snapshot the outgoing step and, when the
            # cache holds the target, swap: the flip costs zero device
            # work and W<->Q toggling ping-pongs between two resident
            # steps.
            snap = self._snapshot_step()
            fc = self._flip_cache
            if fc is not None and fc["token"] != self._flip_token():
                fc = self._flip_cache = None  # stale entry: free its memory
            if fc is not None and fc["dt"] == dt_local:
                self._flip_cache = snap
                self._restore_step(fc)
                self.last_flip_hit = True
                count("flip.hit")
                return self.ephem
            count("flip.miss")
            if snap is not None:
                self._flip_cache = snap
        if dt_local is not None:
            self.dt_local = dt_local
        prev_rotation = (None if self.ephem is None
                         else np.asarray(self.ephem.rotation_matrix))
        self.ephem = calculate_ephemeris(
            self.dt_local, self.config.observer, self.parallactic_mode)
        e = self.ephem
        self._fp = self._frame_params(e)
        self._shadow_dirty = True
        if (self._prefetch is not None
                and self._prefetch["dt"] != self.dt_local):
            self._discard_prefetch()  # speculation missed: free its buffers
        # Body-frame footprints move with the rotation; sampling windows
        # carry a margin of several texels, so small drifts (successive
        # time steps rotate the Moon ~0.14 deg / 15 min) reuse the cached
        # windows and only the shadow map/windows rebuild. The drift is
        # host float64 math, as in the reference, so both packages make
        # the same decision.
        if prev_rotation is None or self._origins is None:
            self._origins = None
        else:
            drift = _rotation_angle_deg(np.asarray(e.rotation_matrix),
                                        prev_rotation)
            hold = self._windows_hold(drift)
            self._windows_decided(hold, "time")
            if not hold:
                self._origins = None
            self._window_drift = self._window_drift + drift
        if self._origins is None:
            self._window_drift = 0.0
            self._hbound = None  # chord bound drifts with the rotation too
        self._shadowwin = None  # sun-frame coordinates always move
        self.reset_accumulation()
        return e

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

    @span("scene.set_camera")
    def set_camera(self, camera: Camera) -> None:
        """Install a new camera pose. Small moves (per-pixel orbit/roll
        drag steps) REUSE the cached sampling windows: body-frame ray
        footprints shift by at most the probe-measured drift angle, and
        the windows carry the same several-texel margin that absorbs
        small time-step rotations (update_view's drift policy), so a drag
        step renders with one burst instead of the window re-extraction
        and repack of a pose rebuild."""
        drift = self._camera_drift_deg(self.camera, camera)
        self.camera = camera
        self._basis = None
        self._background = None
        self.reset_accumulation()
        if self._origins is not None:
            hold = drift is not None and self._windows_hold(drift)
            self._windows_decided(hold, "camera")
            if drift is not None:
                self._window_drift = self._window_drift + drift
            if hold:
                return
        self._origins = None
        self._hbound = None

    def _windows_decided(self, kept: bool, cause: str) -> None:
        """Count a date or camera change's decision on the cached windows:
        kept, or dropped for a rebuild (``cause``: "time" or "camera")."""
        if kept:
            count("windows.kept")
        else:
            count("windows.rebuilt." + cause)
            self._pose_dropped = True

    def _windows_built(self) -> None:
        """Count a build of the pose windows that no counted date or camera
        change asked for (first pose, level or orientation change)."""
        if not self._pose_dropped:
            count("windows.rebuilt.other")
        self._pose_dropped = False

    def _windows_hold(self, drift: float) -> bool:
        """Whether the cached windows absorb ``drift`` more degrees of
        footprint drift on top of what they have taken since extraction:
        their margin covers four texels of arc at the cache's level."""
        h_lvl = self.mip_shapes[self._cache_level or 0][0]
        return self._window_drift + drift <= 4.0 * (180.0 / h_lvl)

    def _camera_drift_deg(self, old: Optional[Camera],
                          new: Camera) -> Optional[float]:
        """Worst-case body-frame footprint drift (degrees) of a camera
        change, from a 3x3 probe-ray grid hitting the bounding sphere, on
        the host in float64; None when unmeasurable (no old camera, fov
        change: a zoom also rescales per-block footprint SPANS, which
        window sizes cannot absorb)."""
        if old is new:
            return 0.0
        if old is None:
            return None
        # tolerance, not exact equality: an fov that round-trips through
        # float32 (codec, presets) must not silently kill the drag fast
        # path; a real zoom changes fov by far more than 1e-6 relative
        if abs(old.fov - new.fov) > 1e-5 * max(abs(new.fov), 1.0):
            return None
        r_old = float(np.linalg.norm(np.asarray(old.eye, np.float64)))
        r_new = float(np.linalg.norm(np.asarray(new.eye, np.float64)))
        if abs(r_old - r_new) > 1e-9 * max(r_old, 1.0):
            return None  # dolly rescales footprint spans, like a zoom
        d0 = camera_mod.probe_hit_dirs(old, self.view_orientation,
                                       self.height, self.width,
                                       C.MOON_RADIUS)
        d1 = camera_mod.probe_hit_dirs(new, self.view_orientation,
                                       self.height, self.width,
                                       C.MOON_RADIUS)
        cos = np.clip(np.sum(d0 * d1, axis=-1), -1.0, 1.0)
        return float(np.degrees(np.arccos(cos).max()))

    def set_view_orientation(self, orientation: str) -> None:
        self.view_orientation = orientation
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
        computed on the host: reading _fp back from the device would stall
        the queue mid-step."""
        return self._sun_state_of(self.ephem)

    @staticmethod
    def _sun_state_of(e: MoonEphemeris) -> tuple[np.ndarray, float]:
        sun_body = np.asarray(e.rotation_matrix).T @ np.asarray(
            light_mod.calculate_light_pos(e))
        ang = math.asin(C.SUN_RADIUS_KM / e.sun_distance)
        return sun_body / np.linalg.norm(sun_body), ang

    def _dispatch_shadow_maps_mesh(self, sun_unit, ang: float, acc: int):
        """Dispatch the phi-wedge-sharded scan (parallel/tiles.py) for a
        sun state with no scene mutation (the speculation shares it with
        shadow_args). The bounce map is reused exactly as on one device:
        inside BOUNCE_REUSE_DEG of its build frame the scan runs factor
        only. Returns None without a mesh, or when the phi grid does not
        divide the mesh (logged: the caller runs the unsharded scan)."""
        if self.mesh is None:
            return None
        from moonrtx_tpu_torch.parallel import build_shadow_map_sharded

        ncs, nf, nph = shadow_scan._resolution(acc)
        if nph % self.mesh.size:
            log_event("mesh_shadow_scan_fallback_single_device",
                      n_phi=nph, devices=self.mesh.size,
                      reason="phi grid does not divide the mesh")
            return None
        slevel = self.shadow_level()
        h, w = self.mip_shapes[slevel]
        basis_np = _sun_frame_basis_np(np.asarray(sun_unit))
        reuse = (
            self.indirect_light
            and self._bounce is not None
            and self._bounce_basis is not None
            and self._bounce_key == (slevel, acc)
            and _rotation_angle_deg(basis_np, self._bounce_basis)
            <= BOUNCE_REUSE_DEG)
        if self.indirect_light:
            count("bounce.reused" if reuse else "bounce.rebuilt")
        sun_basis = torch.as_tensor(np.asarray(basis_np, np.float32),
                                    device=self.device)
        with span("scene.scan"):
            smap, bmap = build_shadow_map_sharded(
                self.mesh, self._rep(self.mips[slevel]), sun_basis, ang, h,
                w, ncs, nf, nph,
                alb_lum=(self._rep(self.alb_lum(slevel))
                         if self.indirect_light and not reuse else None),
                h_scale=self.h_scale, h_offset=self.h_offset,
                n_bounces=self.indirect_bounces)
        params = shadow_scan._params(sun_basis, ncs, nf, nph, ang)
        if reuse:
            return dict(shadow=(smap, params), bounce_render=self._bounce,
                        bounce=None, bounce_basis=None, bounce_key=None)
        return dict(shadow=(smap, params), bounce_render=bmap, bounce=bmap,
                    bounce_basis=basis_np, bounce_key=(slevel, acc))

    def _shadow_args_mesh(self, sun_unit, ang: float, acc: int):
        """Mesh-mode shadow rebuild: dispatch + install. Returns True when
        handled, None to fall through to the single-device scan."""
        r = self._dispatch_shadow_maps_mesh(sun_unit, ang, acc)
        if r is None:
            return None
        self._shadow = r["shadow"]
        if r["bounce"] is not None:
            self._bounce = r["bounce"]
            self._bounce_basis = r["bounce_basis"]
            self._bounce_key = r["bounce_key"]
        return True

    def shadow_args(self):
        """Current (shadow_map, params), rebuilt lazily on time change
        (with the one-bounce irradiance map into self._bounce)."""
        if not self.shadows_on or not self.displaced:
            return None
        if self._shadow is None or self._shadow_dirty:
            sun_unit, ang = self._sun_state()
            acc = self.shadow_accuracy if self.shadows_on else 1
            if self._shadow_args_mesh(sun_unit, ang, acc) is not None:
                self._shadow_dirty = False
                return self._shadow
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

    @span("scene.scan")
    def _dispatch_shadow_maps(self, sun_unit: np.ndarray, ang: float) -> dict:
        """Build the shadow (and, as needed, bounce) maps for a sun state
        without mutating scene state: the shared scan half of shadow_args
        and the speculative pose step. Returns shadow=(smap, params);
        bounce_render (the map the frame should shade with: cached when
        reused, fresh otherwise, None with indirect light off); and
        bounce/bounce_basis/bounce_key, set only when a fresh pyramid was
        built (the caller installs them)."""
        slevel = self.shadow_level()
        stex = self.mips[slevel]
        sh_, sw_ = self.mip_shapes[slevel]
        acc = self.shadow_accuracy if self.shadows_on else 1
        sun = torch.as_tensor(np.asarray(sun_unit, np.float32),
                              device=self.device)
        bounce_render = bounce = bounce_basis = bounce_key = None
        if self.indirect_light:
            # the bounce field is blurred over >= 2 scan cells, so sun
            # drifts inside that scale cannot change it perceptibly: reuse
            # the cached map across small time steps; the shadow factor
            # map always rebuilds (the terminator's motion IS the feature)
            basis_np = _sun_frame_basis_np(sun_unit)
            reuse = (
                self._bounce is not None
                and self._bounce_basis is not None
                and self._bounce_key == (slevel, acc)
                and _rotation_angle_deg(basis_np, self._bounce_basis)
                <= BOUNCE_REUSE_DEG)
            count("bounce.reused" if reuse else "bounce.rebuilt")
            if reuse:
                shadow = shadow_scan.build_shadow_map(
                    stex, sh_, sw_, sun, ang, accuracy=acc,
                    h_scale=self.h_scale, h_offset=self.h_offset)
                bounce_render = self._bounce
            else:
                smap, params, bmap = shadow_scan.build_shadow_and_bounce(
                    stex, self.alb_lum(slevel), sh_, sw_, sun, ang,
                    accuracy=acc, h_scale=self.h_scale,
                    h_offset=self.h_offset,
                    n_bounces=self.indirect_bounces)
                shadow = (smap, params)
                bounce_render = bounce = bmap
                bounce_basis = basis_np
                bounce_key = (slevel, acc)
        else:
            shadow = shadow_scan.build_shadow_map(
                stex, sh_, sw_, sun, ang, accuracy=acc,
                h_scale=self.h_scale, h_offset=self.h_offset)
        return dict(shadow=shadow, bounce_render=bounce_render,
                    bounce=bounce, bounce_basis=bounce_basis,
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
            # fresh windows: restart the drift budget, like the pose
            # rebuild of the burst does; otherwise one over-budget camera
            # move leaves the accumulated drift poisoned and every later
            # small drag re-extracts the cache
            self._window_drift = 0.0
            # stride levels available above the render level (q up to 4)
            max_qexp = min(2, len(self.mips) - 1 - level,
                           len(self.albedo_mips) - 1 - alevel)
            with span("scene.pose"):
                self._origins = blocked.window_origins(
                    geom, h, w, self.mips[level].shape[1], ah, aw,
                    self.albedo_mips[alevel].shape[1], max_qexp=max_qexp,
                    slope_maps=self.slope_maps[level:level + max_qexp + 1])
                self._wincache = blocked.extract_window_cache(
                    tuple(self.mips[level:level + max_qexp + 1]),
                    tuple(self.albedo_mips[alevel:alevel + max_qexp + 1]),
                    self._origins, h_scale=self.h_scale,
                    h_offset=self.h_offset, a_scale=self.a_scale,
                    grouped=grouped)
            self._windows_built()
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
            # changes (shadow_args rebuilds them on time change only); the
            # windows are the geometry-dependent half
            smap, sparams = self.shadow_args()
            with span("scene.timestep"):
                if grouped:
                    sw, swin_p, scal = blocked.build_shadow_state_from_maps(
                        smap, sparams, geom, self._wincache, self._origins,
                        bmap=self._bounce)
                    self._shadowwin = sw
                    if self._packed is None:
                        # pose changed too: repack the heavy pose tensors
                        hwin_p, awin_p = blocked.pack_pose_windows(
                            self._wincache)
                    else:
                        hwin_p, awin_p = self._packed.hwin, self._packed.awin
                    self._packed = blocked.PackedWindows(
                        hwin=hwin_p, awin=awin_p, swin=swin_p, scal=scal)
                else:
                    self._shadowwin = blocked.build_shadow_windows(
                        smap, sparams, geom, bounce_map=self._bounce,
                        grouped=False)
                    self._packed = None
        if grouped and self._packed is None:
            assert self._shadowwin is not blocked.FUSED_SHADOW_STATE, (
                "fused shadow state requires the packed windows it lives in")
            self._packed = blocked.pack_windows(
                self._wincache, self._origins,
                self._shadowwin if self.shadows_on else None)
        return alevel

    def _dispatch_timestep_scan(self, fp, sun_unit, ang, jitters,
                                n_samples: int, h: int, w: int,
                                ah: int, aw: int):
        """Dispatch the drift-reuse time step for an arbitrary frame-params
        and sun state, with NO scene mutation: eligibility is indirect
        light on and the cached bounce map within BOUNCE_ASYNC_MAX_DEG of
        the given sun frame. Past BOUNCE_REUSE_DEG a bounce_refresh is
        queued BEHIND the frame (reusing its scan). Returns None when
        ineligible, else a dict of results + the cache metadata the caller
        installs via _install_timestep."""
        if not (self.shadows_on and self.displaced
                and self.indirect_light and self._bounce is not None
                and self._bounce_basis is not None):
            return None
        slevel = self.shadow_level()
        acc = self.shadow_accuracy
        if self._bounce_key != (slevel, acc):
            return None
        basis_np = _sun_frame_basis_np(sun_unit)
        drift = _rotation_angle_deg(basis_np, self._bounce_basis)
        if drift > BOUNCE_ASYNC_MAX_DEG:
            return None
        ncs, nf, nph = shadow_scan._resolution(acc)
        if drift > BOUNCE_REUSE_DEG \
                and not shadow_scan.half_grid_ok(ncs, nf, nph):
            return None  # the refresh needs the half-resolution albedo grid
        sh_, sw_ = self.mip_shapes[slevel]
        sun_basis = torch.as_tensor(np.asarray(basis_np, np.float32),
                                    device=self.device)
        (accum, hitbuf, swin_p, scal, smap,
         hs) = blocked.render_timestep_scan_pallas(
            self.mips[slevel], self._bounce, sun_basis, ang,
            self._wincache, self._origins, self._packed.hwin,
            self._packed.awin, self.background(), self.maxmap,
            self.render_basis(), fp, jitters, self.height, self.width,
            h, w, self.h_min, ah, aw, sh_, sw_, ncs, nf, nph,
            n_samples=n_samples, h_scale=self.h_scale,
            h_offset=self.h_offset, hbound=self._hbound)
        params = shadow_scan._params(sun_basis, ncs, nf, nph, ang)
        bounce = bounce_basis = None
        count("bounce.rebuilt" if drift > BOUNCE_REUSE_DEG
              else "bounce.reused")
        if drift > BOUNCE_REUSE_DEG:
            # refresh the bounce map behind the frame: the device renders
            # the frame first (stream order), the rebuild fills the gap
            # before the next step, and the scene swaps to the new map on
            # install so the next merged step reads it
            bounce = shadow_scan.bounce_refresh(
                smap, hs, self.alb_lum(slevel), sun_basis,
                sh_, sw_, ncs, nf, nph, n_bounces=self.indirect_bounces)
            bounce_basis = basis_np
        return dict(kind="timestep", accum=accum, hitbuf=hitbuf,
                    swin=swin_p, scal=scal,
                    shadow=(smap, params), bounce=bounce,
                    bounce_basis=bounce_basis, bounce_key=(slevel, acc))

    def _install_timestep(self, r: dict) -> None:
        """Install a _dispatch_timestep_scan result as the scene's shadow/
        bounce cache state (the mutation half, split out so a speculative
        prefetch can defer it to consume time)."""
        self._shadow = r["shadow"]
        self._shadow_dirty = False
        if r["bounce"] is not None:
            self._bounce = r["bounce"]
            self._bounce_basis = r["bounce_basis"]
            self._bounce_key = r["bounce_key"]

    def _dispatch_pose_scan(self, fp, sun_unit, ang, jitters,
                            n_samples: int, level: int):
        """Dispatch the full pose-rebuild step (shadow scan + window
        origins/extraction/repack + burst) for an arbitrary frame state,
        with NO scene mutation: the speculation used when the predicted
        window drift says the pose caches will NOT survive the next time
        step."""
        h, w = self.mip_shapes[level]
        alevel = self.albedo_level(level)
        ah, aw = self.mip_shapes[alevel]
        if self.shadows_on:
            sm = self._dispatch_shadow_maps(sun_unit, ang)
            smap, sparams = sm["shadow"]
            bounce_render = sm["bounce_render"]
            bounce, bounce_basis, bounce_key = (
                sm["bounce"], sm["bounce_basis"], sm["bounce_key"])
        else:
            smap = sparams = None
            bounce_render = bounce = bounce_basis = bounce_key = None
        max_qexp = min(2, len(self.mips) - 1 - level,
                       len(self.albedo_mips) - 1 - alevel)
        (accum, hitbuf, org, cache, hwin_p, awin_p, swin_p,
         scal, hbound) = blocked.render_pose_pallas(
            tuple(self.mips[level:level + max_qexp + 1]),
            tuple(self.albedo_mips[alevel:alevel + max_qexp + 1]),
            self.slope_maps[level:level + max_qexp + 1],
            smap, sparams, bounce_render, self.background(),
            self.maxmap, self.render_basis(), fp, jitters,
            self.height, self.width, h, w, ah, aw, self.h_min,
            max_qexp=max_qexp, n_samples=n_samples,
            use_shadow=self.shadows_on,
            h_scale=self.h_scale, h_offset=self.h_offset,
            a_scale=self.a_scale)
        return dict(kind="pose", accum=accum, hitbuf=hitbuf,
                    origins=org, wincache=cache, cache_level=level,
                    hbound=hbound,
                    packed=blocked.PackedWindows(hwin=hwin_p, awin=awin_p,
                                                 swin=swin_p, scal=scal),
                    shadow=(smap, sparams) if self.shadows_on else None,
                    bounce=bounce, bounce_basis=bounce_basis,
                    bounce_key=bounce_key)

    def _install_pose_step(self, r: dict) -> None:
        """Install a _dispatch_pose_scan result (mirrors the mutations of
        the non-speculative pose branch in render_accumulation_burst +
        shadow_args)."""
        if r["shadow"] is not None:
            self._shadow = r["shadow"]
        self._shadow_dirty = False
        if r["bounce"] is not None:
            self._bounce = r["bounce"]
            self._bounce_basis = r["bounce_basis"]
            self._bounce_key = r["bounce_key"]
        self._origins = r["origins"]
        self._wincache = r["wincache"]
        self._windows_built()
        self._cache_level = r["cache_level"]
        self._window_drift = 0.0
        self._hbound = r["hbound"]
        self._packed = r["packed"]
        self._shadowwin = (blocked.FUSED_SHADOW_STATE
                           if self.shadows_on else None)

    def _merged_timestep(self, jitters, n_samples: int, h: int, w: int,
                         ah: int, aw: int):
        """Run the drift-reuse time step if eligible (shadows dirty +
        _dispatch_timestep_scan's conditions), so held-key animation never
        waits on the bounce pyramid. Returns (accum, hitbuf, swin_p, scal)
        or None (the caller falls back to the split path: shadow maps,
        then render_timestep_pallas)."""
        if not self._shadow_dirty:
            return None
        sun_unit, ang = self._sun_state()
        r = self._dispatch_timestep_scan(self._fp, sun_unit, ang, jitters,
                                         n_samples, h, w, ah, aw)
        if r is None:
            return None
        self._install_timestep(r)
        return r["accum"], r["hitbuf"], r["swin"], r["scal"]

    # ---- speculative held-key prefetch ------------------------------------

    def _prefetch_token(self, kind: str):
        """Everything a prefetched time step's validity depends on besides
        the datetime. A "timestep" speculation additionally depends on the
        pose/window cache identities it renders through; a "pose"
        speculation rebuilds those from scratch, so it survives
        update_view invalidating them (that is its purpose) and depends
        only on the camera/settings baked into it."""
        base = (self.brightness, self.shadows_on, self.shadow_accuracy,
                self.indirect_light, self.view_orientation,
                id(self.camera), self.parallactic_mode, self.backend,
                id(self._bounce))
        if kind in ("pose", "mesh_pose"):
            return base
        packed = self._packed
        return base + (id(self._origins), id(self._wincache),
                       None if packed is None else id(packed.hwin),
                       self._cache_level)

    def _discard_prefetch(self) -> None:
        """Drop a speculation that will not be consumed."""
        if self._prefetch is not None:
            count("prefetch.discarded")
            self._prefetch = None

    @span("scene.prefetch")
    def prefetch_time(self, dt_next: datetime) -> bool:
        """Speculatively dispatch the NEXT time step's scan+render behind
        the current frame: when the held key delivers update_view(dt_next),
        the frame is already computed on the device and the step costs
        only the readback. Returns True when a speculation was dispatched.
        Mis-speculation is safe: results install only if the next
        update_view matches the datetime and _prefetch_token."""
        self._discard_prefetch()
        if self.ephem is None or not self.displaced:
            return False
        if self.mesh is None and self.backend != "pallas":
            return False
        level = self.mip_level()
        e = calculate_ephemeris(dt_next, self.config.observer,
                                self.parallactic_mode)
        h, w = self.mip_shapes[level]
        alevel = self.albedo_level(level)
        ah, aw = self.mip_shapes[alevel]
        sun_unit, ang = self._sun_state_of(e)
        if self.mesh is not None:
            r = self._dispatch_mesh_step(self._frame_params(e), sun_unit,
                                         ang, self._padded_jitters(1), 1,
                                         level)
            r["dt"] = dt_next
            r["token"] = self._prefetch_token(r["kind"])
            r["pins"] = (self.camera, self._bounce, self._origins,
                         self._wincache, self._packed)
            self._prefetch = r
            count("prefetch.dispatched."
                  + ("pose" if r["kind"] == "mesh_pose" else "timestep"))
            return True
        # would update_view(dt_next) keep the pose windows? (the window
        # drift policy of update_view, predicted on the host; a mispredict
        # is only wasted work, never wrong output)
        timestep = False
        if (self._origins is not None and self._packed is not None
                and self._wincache is not None
                and self._cache_level == level):
            timestep = self._windows_hold(_rotation_angle_deg(
                np.asarray(e.rotation_matrix),
                np.asarray(self.ephem.rotation_matrix)))

        def dispatch():
            fp = self._frame_params(e)
            # n_samples=1 (what the app renders first after a step); its
            # jitter is deterministically zero, so a consumed prefetch is
            # bit-exact with the non-speculative burst and consumes no RNG
            # state
            jit1 = self._padded_jitters(1)
            r = None
            if timestep:
                r = self._dispatch_timestep_scan(fp, sun_unit, ang, jit1,
                                                 1, h, w, ah, aw)
            if r is None:
                # windows will not survive the step (or no merged-step
                # eligibility): speculate the FULL pose rebuild
                r = self._dispatch_pose_scan(fp, sun_unit, ang, jit1, 1,
                                             level)
            return r

        r = dispatch()
        r["dt"] = dt_next
        r["token"] = self._prefetch_token(r["kind"])
        # pin the objects whose id()s the token carries: CPython reuses
        # freed addresses eagerly, so without a live reference a cache
        # replaced between dispatch and consume could alias a stale token
        # and install a speculation computed from the old caches
        r["pins"] = (self.camera, self._bounce, self._origins,
                     self._wincache, self._packed)
        self._prefetch = r
        count("prefetch.dispatched." + r["kind"])
        return True

    def _consume_prefetch(self, n_samples: int):
        """Install the speculative step's results if they match the
        scene's current datetime + state token and return (accum, hitbuf);
        None otherwise."""
        pf, self._prefetch = self._prefetch, None
        if pf is None:
            return None
        if (n_samples != 1 or not self._shadow_dirty
                or pf["dt"] != self.dt_local
                or pf["token"] != self._prefetch_token(pf["kind"])):
            count("prefetch.discarded")
            return None
        count("prefetch.consumed")
        if pf["kind"] in ("pose", "mesh_pose"):
            self._install_pose_step(pf)
        elif pf["kind"] == "mesh_timestep":
            if pf["shadow"] is not None:
                self._shadow = pf["shadow"]
            self._shadow_dirty = False
            if pf["bounce"] is not None:
                self._bounce = pf["bounce"]
                self._bounce_basis = pf["bounce_basis"]
                self._bounce_key = pf["bounce_key"]
            self._packed = self._packed._replace(swin=pf["swin"],
                                                 scal=pf["scal"])
            self._shadowwin = blocked.FUSED_SHADOW_STATE
        else:
            self._install_timestep(pf)
            self._packed = self._packed._replace(swin=pf["swin"],
                                                 scal=pf["scal"])
            self._shadowwin = blocked.FUSED_SHADOW_STATE
        return pf["accum"], pf["hitbuf"]

    def render_accumulation_frame(self):
        """Render one accumulation sample and fold it into the running
        mean. The random draws (jitter, then the march phase) follow the
        reference call for call."""
        if self.ephem is None:
            self.update_view(self.dt_local)
        level = self.mip_level()
        if not (self.mesh is not None and self.displaced):
            # a banded level reached off the mesh path (the smooth-sphere
            # preview): the finest coarser replicated level. The mesh path
            # renders banded levels itself; bumping there would mix two
            # levels in one accumulation
            while (self.mips[level] is None
                   or self.albedo_mips[level] is None):
                level += 1
        h, w = self.mip_shapes[level]
        if self._accum_n == 0:
            jitter = torch.zeros(2, dtype=torch.float32, device=self.device)
        else:
            jitter = torch.as_tensor(
                np.asarray(self._rng.random(2) - 0.5, np.float32),
                device=self.device)

        if self.mesh is not None and self.displaced:
            rgb, hitbuf = self._mesh_step(self._jitter_rows(jitter), 1, level)
            out = render_mod.RenderOutput(rgb=rgb, hitbuf=hitbuf)
        elif self.backend in ("blocked", "pallas") and self.displaced:
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
            with span("scene.sample"):
                out = render_mod.render_frame(
                    self.mips[level], self.albedo_mips[level],
                    self.background(), shadow_fn_args, self.render_basis(),
                    self._fp, jitter, self.height, self.width, h, w,
                    self.h_min, h_mean=1.0 / self.radius_scale,
                    displaced=self.displaced,
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
        if ((self.backend == "pallas" or self.mesh is not None)
                and self.displaced and self._accum_n == 0 and n > 0):
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

    # ---- the mesh: image strips over several devices ----------------------

    def _mesh_step(self, jitters, n_samples: int, level: int):
        """A mesh-mode render with the cached-pose split of the
        single-device paths: a pose-stable re-accumulation is one burst
        from the resident per-strip windows, a Q/W time step the
        phi-wedge scan plus one strip program on those windows, and only a
        pose or level change extracts. The caches live per device in the
        scene's usual fields, so update_view's drift policy applies
        unchanged. Returns (rgb, hitbuf) on the scene's device."""
        from moonrtx_tpu_torch.parallel import (
            render_accumulate_sharded,
            render_timestep_sharded,
        )

        h, w = self.mip_shapes[level]
        alevel = self.albedo_level(level)
        ah, aw = self.mip_shapes[alevel]
        use_bg = self.starmap is not None
        bg = self.background()
        pose_valid = (self._origins is not None
                      and self._cache_level == level
                      and self._packed is not None)
        sun_valid = (not self.shadows_on) or (
            self._shadowwin is not None and not self._shadow_dirty)

        if pose_valid and sun_valid:
            sparams = self.shadow_args()[1] if self.shadows_on else None
            return render_accumulate_sharded(
                self.mesh, self._packed, sparams, bg, self._rep(self.maxmap),
                self.render_basis(), self._fp, jitters, self.height,
                self.width, h, w, ah, aw, self.h_min, n_samples=n_samples,
                use_shadow=self.shadows_on, use_bg=use_bg)
        if pose_valid:
            smap, sparams = self.shadow_args()
            rgb, hitbuf, swin_p, scal = render_timestep_sharded(
                self.mesh, smap, sparams, self._bounce, self._wincache,
                self._origins, self._packed.hwin, self._packed.awin, bg,
                self._rep(self.maxmap), self.render_basis(), self._fp,
                jitters, self.height, self.width, h, w, ah, aw, self.h_min,
                n_samples=n_samples, use_shadow=True, use_bg=use_bg)
            self._packed = self._packed._replace(swin=swin_p, scal=scal)
            self._shadowwin = blocked.FUSED_SHADOW_STATE
            return rgb, hitbuf

        smap = sparams = None
        if self.shadows_on:
            smap, sparams = self.shadow_args()
        rgb, hitbuf, org, cache, packed = self._pose_program_sharded(
            jitters, n_samples, level, smap, sparams, bg, use_bg, self._fp,
            bounce=self._bounce)
        self._origins = org
        self._wincache = cache
        self._windows_built()
        self._cache_level = level
        self._window_drift = 0.0
        self._hbound = None  # the strips derive their chord bounds per call
        self._packed = packed
        self._shadowwin = (blocked.FUSED_SHADOW_STATE
                           if self.shadows_on else None)
        return rgb, hitbuf

    def _pose_program_sharded(self, jitters, n_samples: int, level: int,
                              smap, sparams, bg, use_bg: bool, fp,
                              bounce=None):
        """The mesh pose program, routed by map placement: replicated maps
        go through render_pose_sharded, a banded render level through the
        banded burst with its caches returned (once assembled they no
        longer depend on the map layout, so time steps and
        re-accumulations of banded scenes use the same cached programs)."""
        from moonrtx_tpu_torch.parallel import (
            render_burst_pallas_hfshard,
            render_pose_sharded,
        )

        h, w = self.mip_shapes[level]
        alevel = self.albedo_level(level)
        ah, aw = self.mip_shapes[alevel]
        nlevel = min(level + 1, len(self.mips) - 1)
        nalevel = min(alevel + 1, len(self.albedo_mips) - 1)
        # at the coarsest level the "next" map aliases the render map, so
        # striding is off there, like the single-device max_qexp guard
        max_qexp = max(0, min(1, len(self.mips) - 1 - level,
                              len(self.albedo_mips) - 1 - alevel))
        slopes = self._rep_levels(self.slope_maps, level, 2)
        if self.hf_sharded():
            bmips = (self._banded_mip(level), self._banded_mip(nlevel))
            balb = (self._banded_alb(alevel), self._banded_alb(nalevel))
            return render_burst_pallas_hfshard(
                self.mesh, bmips, balb, self._rep(self.maxmap),
                self.render_basis(), fp, jitters, self.height, self.width,
                h, w, ah, aw, self.h_min, shadow_map=smap, smap_params=sparams,
                bounce_map=bounce, n_samples=n_samples,
                use_shadow=self.shadows_on, h_scale=self.h_scale,
                h_offset=self.h_offset, a_scale=self.a_scale,
                slope_maps=slopes, return_caches=True, background=bg,
                use_bg=use_bg, max_qexp=max_qexp)
        return render_pose_sharded(
            self.mesh, self._rep(self.mips[level]),
            self._rep(self.mips[nlevel]),
            self._rep(self.albedo_mips[alevel]),
            self._rep(self.albedo_mips[nalevel]), slopes, smap, sparams,
            bounce, bg, self._rep(self.maxmap), self.render_basis(), fp,
            jitters, self.height, self.width, h, w, ah, aw, self.h_min,
            n_samples=n_samples, use_shadow=self.shadows_on, use_bg=use_bg,
            h_scale=self.h_scale, h_offset=self.h_offset,
            a_scale=self.a_scale, max_qexp=max_qexp)

    def _dispatch_mesh_step(self, fp, sun_unit, ang: float, jitters,
                            n_samples: int, level: int) -> dict:
        """Dispatch the next mesh step for a frame state with no scene
        mutation (the speculative half of _mesh_step): a "mesh_timestep"
        on the resident windows when they are valid, else a "mesh_pose"."""
        from moonrtx_tpu_torch.parallel import render_timestep_sharded

        h, w = self.mip_shapes[level]
        alevel = self.albedo_level(level)
        ah, aw = self.mip_shapes[alevel]
        use_bg = self.starmap is not None
        bg = self.background()
        acc = self.shadow_accuracy if self.shadows_on else 1
        sm = None
        if self.shadows_on:
            sm = self._dispatch_shadow_maps_mesh(sun_unit, ang, acc)
            if sm is None:  # the phi grid does not divide: unsharded scan
                sm = self._dispatch_shadow_maps(np.asarray(sun_unit), ang)
            smap, sparams = sm["shadow"]
            bounce_render = sm["bounce_render"]
        else:
            smap = sparams = bounce_render = None
        fresh = dict(
            shadow=(smap, sparams) if self.shadows_on else None,
            bounce=None if sm is None else sm["bounce"],
            bounce_basis=None if sm is None else sm["bounce_basis"],
            bounce_key=None if sm is None else sm["bounce_key"])

        pose_valid = (self._origins is not None
                      and self._cache_level == level
                      and self._packed is not None)
        if pose_valid:
            rgb, hitbuf, swin_p, scal = render_timestep_sharded(
                self.mesh, smap, sparams, bounce_render, self._wincache,
                self._origins, self._packed.hwin, self._packed.awin, bg,
                self._rep(self.maxmap), self.render_basis(), fp, jitters,
                self.height, self.width, h, w, ah, aw, self.h_min,
                n_samples=n_samples, use_shadow=self.shadows_on,
                use_bg=use_bg)
            return dict(kind="mesh_timestep", accum=rgb, hitbuf=hitbuf,
                        swin=swin_p, scal=scal, **fresh)
        rgb, hitbuf, org, cache, packed = self._pose_program_sharded(
            jitters, n_samples, level, smap, sparams, bg, use_bg, fp,
            bounce=bounce_render)
        return dict(kind="mesh_pose", accum=rgb, hitbuf=hitbuf,
                    origins=org, wincache=cache, cache_level=level,
                    hbound=None, packed=packed, **fresh)

    def render_accumulation_burst(self, n_samples: int) -> None:
        """All accumulation samples in one burst through the march kernel."""
        if self.ephem is None:
            self.update_view(self.dt_local)
        if self._flip_ready:
            # a flip-cache restore just installed a fully-rendered step:
            # its accumulation is already on the device, so the burst is a
            # no-op. Consumable flag: explicit re-render requests against
            # unchanged state (timing loops) still dispatch.
            self._flip_ready = False
            if self._accum is not None and self._accum_n >= n_samples:
                return
        level = self.mip_level()
        h, w = self.mip_shapes[level]
        jitters = self._padded_jitters(n_samples)
        if self.mesh is not None and self.displaced:
            pf = self._consume_prefetch(n_samples)
            if pf is None:
                pf = self._mesh_step(jitters, n_samples, level)
            self._accum, self._hitbuf = pf
            self._accum_n = n_samples
            return

        # speculative held-key hit: the step was dispatched behind the
        # previous frame (prefetch_time); install + take the results. A
        # pose-kind hit covers the cache-invalid branch too.
        pf = self._consume_prefetch(n_samples)
        if pf is not None:
            self._accum, self._hitbuf = pf
            self._accum_n = n_samples
            return

        alevel = self.albedo_level(level)
        ah, aw = self.mip_shapes[alevel]
        pose_valid = (self._origins is not None
                      and self._cache_level == level
                      and self._packed is not None)
        sun_valid = (not self.shadows_on) or (self._shadowwin is not None)

        if pose_valid and sun_valid:
            # nothing structural changed (e.g. brightness/gamma reset):
            # just the burst
            sparams = self.shadow_args()[1] if self.shadows_on else None
            accum, hitbuf = blocked.render_accumulate_pallas(
                self._packed, sparams, self.background(), self.maxmap,
                self.render_basis(), self._fp, jitters, self.height,
                self.width, h, w, self.h_min, ah=ah, aw=aw,
                n_samples=n_samples, use_shadow=self.shadows_on,
                hbound=self._hbound)
        elif pose_valid:
            # time-step (Q/W) hot path: pose caches valid, only the sun
            # moved. Drift-reuse steps (bounce map still fresh enough, the
            # common held-key case) run scan + windows + repack + burst in
            # one step; bounce-rebuild steps run the shadow map programs,
            # then windows + repack + burst
            merged = self._merged_timestep(jitters, n_samples, h, w, ah, aw)
            if merged is not None:
                accum, hitbuf, swin_p, scal = merged
            else:
                smap, sparams = self.shadow_args()
                accum, hitbuf, swin_p, scal = blocked.render_timestep_pallas(
                    smap, sparams, self._bounce, self._wincache,
                    self._origins, self._packed.hwin, self._packed.awin,
                    self.background(), self.maxmap, self.render_basis(),
                    self._fp, jitters, self.height, self.width, h, w,
                    self.h_min, ah, aw, n_samples=n_samples,
                    hbound=self._hbound)
            self._packed = self._packed._replace(swin=swin_p, scal=scal)
            self._shadowwin = blocked.FUSED_SHADOW_STATE
        else:
            # pose (or level) changed: origins + extraction + packing +
            # shadow windows + burst
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
            self._windows_built()
            self._cache_level = level
            self._window_drift = 0.0
            self._hbound = hbound
            self._packed = blocked.PackedWindows(
                hwin=hwin_p, awin=awin_p, swin=swin_p, scal=scal)
            self._shadowwin = (blocked.FUSED_SHADOW_STATE
                               if self.shadows_on else None)
        self._accum = accum
        self._hitbuf = hitbuf
        self._accum_n = n_samples

    @span("scene.display")
    def display(self) -> np.ndarray:
        if self._accum_n == 0:
            self.ensure_accumulated(1)
        img = render_mod.tonemap(self._accum, C.TONEMAP_EXPOSURE, self.gamma)
        return img.cpu().numpy()[: self.out_height, : self.out_width]

    # ---- picking ----------------------------------------------------------

    def hit_buffer_host(self) -> np.ndarray:
        """Host copy of the per-frame hit buffer, transferred ONCE per
        rendered frame: mouse-motion picking then runs in numpy with no
        device work (the reference treats picking as latency-critical,
        renderer_navigation.py:189-192)."""
        if self._hitbuf is None:
            self.render_accumulation_frame()
        if self._hitbuf_host is None or self._hitbuf_src is not self._hitbuf:
            self._hitbuf_host = self._hitbuf.cpu().numpy()
            self._hitbuf_src = self._hitbuf
        return self._hitbuf_host

    # cursor pick window: copied instead of the whole hit buffer (33 MB at
    # 1080p). 128 px covers mouse motion between frames; re-centers when
    # the cursor leaves the inner half.
    PICK_WIN = 128

    def get_hit_at(self, x: int, y: int) -> tuple[float, float, float, float]:
        """Scene-frame hit position + distance at an image pixel (0
        distance = miss). Reads the full host copy when one is already
        resident (tests, parity tools); mouse picking on a fresh frame
        copies only a PICK_WIN^2 window around the cursor (256 KB, reused
        while the cursor stays near its center) instead of the whole
        buffer."""
        if self._hitbuf is None:
            self.render_accumulation_frame()
        y = int(np.clip(y, 0, self.height - 1))
        x = int(np.clip(x, 0, self.width - 1))
        if self._hitbuf_host is not None and \
                self._hitbuf_src is self._hitbuf:
            v = self._hitbuf_host[y, x]
            return float(v[0]), float(v[1]), float(v[2]), float(v[3])
        W = min(self.PICK_WIN, self.height, self.width)
        win = self._pickwin
        if win is not None and self._pickwin_src is self._hitbuf:
            r0, c0 = self._pickwin_origin
            ry, cx = y - r0, x - c0
            q = W // 4
            # inner-half reuse; a margin that is flush against the image
            # edge counts as satisfied (a window pinned at the border
            # cannot re-center any further: without this, every pick in a
            # 32 px edge band re-copied the window per event)
            row_ok = ((ry >= q or r0 == 0)
                      and (ry < W - q or r0 == self.height - W)
                      and 0 <= ry < W)
            col_ok = ((cx >= q or c0 == 0)
                      and (cx < W - q or c0 == self.width - W)
                      and 0 <= cx < W)
            if row_ok and col_ok:
                v = win[ry, cx]
                return float(v[0]), float(v[1]), float(v[2]), float(v[3])
        r0 = int(np.clip(y - W // 2, 0, self.height - W))
        c0 = int(np.clip(x - W // 2, 0, self.width - W))
        self._pickwin = self._hitbuf[r0:r0 + W, c0:c0 + W].cpu().numpy()
        self._pickwin_origin = (r0, c0)
        self._pickwin_src = self._hitbuf
        v = self._pickwin[y - r0, x - c0]
        return float(v[0]), float(v[1]), float(v[2]), float(v[3])

    def elevation_host(self) -> np.ndarray:
        """Host copy of an elevation level (unpadded columns, decoded f32),
        cached once: measurement drags must not copy device mips per mouse
        event. Uses the shadow-capped level for quantized (multi-gigatexel)
        maps so the host copy stays small."""
        lvl = self._capped_level(0) if self.quantized else 0
        src = self.mips[lvl] if self.mips[lvl] is not None \
            else self._host_mips[lvl]
        if self._elev_host is None or self._elev_host_src is not src:
            m = (src.cpu().numpy() if isinstance(src, torch.Tensor)
                 else np.asarray(src))[:, : self.mip_shapes[lvl][1]]
            if self.quantized:
                m = m.astype(np.float32) * self.h_scale + self.h_offset
            self._elev_host = m
            self._elev_host_src = src
        return self._elev_host

    def elevation_m_at(self, lat: float, lon: float) -> float:
        """FULL-RESOLUTION elevation (meters vs the reference radius) at a
        selenographic point: bilinear on the kept host level 0, a pure host
        read (no device work) at the source data's full resolution.
        Shares the bilinear/wrap math with interact.measure.elevation_m;
        only the storage decode differs."""
        from moonrtx_tpu_torch.interact.measure import elevation_m

        w = self.mip_shapes[0][1]
        return elevation_m(
            self._host_mips[0][:, :w], self.radius_scale, lat, lon,
            scale=self.h_scale if self.quantized else 1.0,
            offset=self.h_offset if self.quantized else 0.0)
