"""Blocked render pipeline: block layout, per-block windows, the windowed
"blocked" backend, and packing plus the accumulation burst of the march
kernel (torch).

Port of moonrtx_tpu/engine/blocked.py. The image is tiled into
8x16-pixel blocks of 128 rays; each block samples the heightfield, albedo
and shadow|bounce maps through small private windows. The layout is the
reference's, so every intermediate compares tensor for tensor with it.
Two backends share the windows:

* "blocked": march, shadow lookup and shading on f32 windows, one
  accumulation sample per call (render_frame_blocked): one kernel launch
  on the card (ops.blocked_sample), the plain torch functions below on
  the CPU. Its windows are cut one per block by K5
  (ops.extract.extract_level_windows) in three launches: heights, albedo
  (whole texels), shadow|bounce.
* "pallas": GROUP=8 horizontally adjacent blocks (an 8x128-pixel strip)
  make one strip of the march kernel (K2), fed from windows cut by K1
  straight into its packed layout, all samples in one burst.

Cache structure (what changes when):
* WindowOrigins + WindowCache — camera pose, Moon orientation, mip level.
* ShadowWindows — additionally the sun direction.
* Per sample: jittered rays, then march and shading.

A time step that keeps the pose windows runs render_timestep_scan_pallas
(scan, shadow windows, sun-side repack, burst) or, after a bounce
rebuild, render_timestep_pallas; a pose change runs render_pose_pallas.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from moonrtx_tpu_torch import constants as C
from moonrtx_tpu_torch.engine.camera import CameraBasis
from moonrtx_tpu_torch.engine.geometry import (
    latlon_to_unit,
    mat3_apply,
    mat3t_apply,
    normalize,
    unit_to_latlon,
)
from moonrtx_tpu_torch.engine.render import (
    FrameParams,
    RenderOutput,
    shade_lambert,
    sun_disk_hit,
)
from moonrtx_tpu_torch.ops import blocked_sample as bs
from moonrtx_tpu_torch.ops import extract as extract_ops
from moonrtx_tpu_torch.ops import march_shade as mk
from moonrtx_tpu_torch.ops import ray_setup
from moonrtx_tpu_torch.ops import sampler
from moonrtx_tpu_torch.ops import shadow_scan
from moonrtx_tpu_torch.ops.sampler import latlon_to_rowcol, window_bilinear
from moonrtx_tpu_torch.utils.profiling import span

# Block layout: 8x16 pixels = 128 rays per block, row-major; GROUP
# horizontally adjacent blocks make one strip of the march kernel.
BLOCK_H = 8
BLOCK_W = 16
BLOCK = BLOCK_H * BLOCK_W
GROUP = 8             # blocks per march-kernel strip

# Window geometry (texels). Width pad on mips must be >= WIN_W + slack.
WIN_H = 40
WIN_W = 64
ALB_DOWN = 0          # albedo windows sample the same mip level as heights
AWIN_H = 40
AWIN_W = 64
SWIN_H = 32           # shadow-map window (scan-grid texels)
SWIN_W = 48


def to_blocks(img):
    """(H, W, ...) -> (NBLK, 128, ...) in block-row-major order."""
    h, w = img.shape[0], img.shape[1]
    rest = img.shape[2:]
    x = img.reshape(h // BLOCK_H, BLOCK_H, w // BLOCK_W, BLOCK_W, *rest)
    x = torch.movedim(x, 2, 1)
    return x.reshape(-1, BLOCK, *rest)


def from_blocks(blocks, height: int, width: int):
    """Inverse of to_blocks ((NBLK, 128, ...) -> (H, W, ...))."""
    rest = blocks.shape[2:]
    x = blocks.reshape(height // BLOCK_H, width // BLOCK_W, BLOCK_H, BLOCK_W,
                       *rest)
    x = torch.movedim(x, 1, 2)
    return x.reshape(height, width, *rest)


def composite_blocks(rgb_b, hit_b, t_b, p_b, height, width, dirs_scene,
                     eye, fp, background=None):
    """Blocks -> (rgb image, hitbuf). Misses take the sun disk over the
    background (black when None); hitbuf packs scene-frame hit position
    + distance."""
    rgb = from_blocks(rgb_b, height, width)
    hit_img = from_blocks(hit_b, height, width)
    disk = sun_disk_hit(eye, dirs_scene, fp)
    miss_rgb = (torch.zeros((height, width, 3), dtype=torch.float32,
                            device=rgb.device)
                if background is None else background)
    miss_rgb = torch.where(disk[..., None], C.SUN_DISK_COLOR, miss_rgb)
    rgb = torch.where(hit_img[..., None], rgb, miss_rgb)
    p_scene = mat3_apply(fp.rotation, from_blocks(p_b, height, width))
    t_img = from_blocks(t_b, height, width)
    hitbuf = torch.cat(
        [torch.where(hit_img[..., None], p_scene, 0.0),
         torch.where(hit_img, t_img, 0.0)[..., None]], dim=-1)
    return rgb, hitbuf


def composite_kernel_outputs(r, g, b, hitf, t_hit, px, py, pz, height,
                             width, dirs_scene, eye, fp, background=None):
    """composite_blocks over raw (ns, G, B) march-kernel planes."""
    nblk = (height // BLOCK_H) * (width // BLOCK_W)
    rgb_b = torch.stack([r, g, b], dim=-1).reshape(nblk, BLOCK, 3)
    hit_b = hitf.reshape(nblk, BLOCK) > 0.5
    t_b = t_hit.reshape(nblk, BLOCK)
    p_b = torch.stack([px, py, pz], dim=-1).reshape(nblk, BLOCK, 3)
    return composite_blocks(rgb_b, hit_b, t_b, p_b, height, width,
                            dirs_scene, eye, fp, background=background)


class RayGeom(NamedTuple):
    """Per-sample (jittered) ray state."""

    db: torch.Tensor        # (NBLK, B, 3) body-frame ray dirs
    ob: torch.Tensor        # (3,) body-frame eye
    t_enter: torch.Tensor   # (NBLK, B)
    t_end: torch.Tensor     # (NBLK, B)
    hit_outer: torch.Tensor # (NBLK, B) bool
    dirs_scene: Optional[torch.Tensor]  # (H, W, 3) for the sun-disk pass
    # per-block local max-height bound the chords were clipped against
    h_bound: Optional[torch.Tensor] = None


class WindowOrigins(NamedTuple):
    r0: torch.Tensor   # (NBLK,) int32 height-window row origin (strided coords)
    c0: torch.Tensor
    ar0: torch.Tensor  # albedo-window origins (strided coords)
    ac0: torch.Tensor
    q: torch.Tensor    # (NBLK,) f32 per-block stride (1/2/4)
    sigma: torch.Tensor  # (NBLK,) f32 normal-tilt stddev lost at the stride


class WindowCache(NamedTuple):
    hwin: torch.Tensor      # (NBLK, WIN_H, WIN_W) mean-centered heights
    hmean: torch.Tensor     # (NBLK, 1) per-window mean height
    awin: torch.Tensor      # grouped (K1): (NS, GROUP*AWIN_H, 3*AWIN_W)
                            # channel-major; ungrouped (K5):
                            # (NBLK, AWIN_H, AWIN_W, 3)


# Sentinel: the sun-side shadow state lives only inside PackedWindows
# (produced by the pose program's burst) and no standalone ShadowWindows
# exists for the current sun direction.
FUSED_SHADOW_STATE = object()


class ShadowWindows(NamedTuple):
    swin: torch.Tensor      # (NBLK, SWIN_H, n_maps*SWIN_W) shadow
                            # [| bounce] halves; bf16 grouped, f32 ungrouped
    sr0: torch.Tensor
    sc0: torch.Tensor
    sq: torch.Tensor        # per-block stride into the shadow grid (1/2/4)


@span("scene.rays")
def block_rays(basis: CameraBasis, rotation, jitter, height: int, width: int,
               h_min: float, maxmap=None, h_bound=None, row_offset=0,
               full_height: int = None, image_dirs: bool = True) -> RayGeom:
    """Jittered rays + shell-chord ranges tightened against the per-block
    local max height (from the dilated coarse max map, or a cached bound):
    one launch of the ray-setup kernel on the card (ops.ray_setup), its
    plain torch version on the CPU.

    row_offset/full_height select a horizontal strip of a larger frame
    (image strips over a device mesh, parallel/tiles.py)."""
    return ray_setup.block_rays(basis, rotation, jitter, height, width,
                                h_min, maxmap=maxmap, h_bound=h_bound,
                                row_offset=row_offset,
                                full_height=full_height,
                                image_dirs=image_dirs)


def _chord_points(geom: RayGeom):
    """Body-frame points at chord entry, midpoint and end (the footprint
    of a grazing limb ray is an arc whose midpoint swings outside the
    endpoints' bounding box)."""
    t_mid = 0.5 * (geom.t_enter + geom.t_end)
    return [geom.ob + t[..., None] * geom.db
            for t in (geom.t_enter, t_mid, geom.t_end)]


def window_origins(geom: RayGeom, h: int, w: int, mip_pad_w: int,
                   ah: int, aw: int, a_pad_w: int, max_qexp: int = 2,
                   slope_maps=None) -> WindowOrigins:
    """Per-block window origins and stride levels (see the reference for
    the polar-block limitation)."""
    rcs = [latlon_to_rowcol(*unit_to_latlon(p), h, w)
           for p in _chord_points(geom)]
    rows = torch.cat([rc[0] for rc in rcs], dim=1)
    cols = torch.cat([rc[1] for rc in rcs], dim=1)

    # per-block stride: footprints wider than the window drop to the
    # 2^k-coarser mip through the same window machinery
    _, _, r_span, c_span = sampler.block_footprint(rows, cols, w)
    ratio = torch.clamp(torch.maximum(r_span / (WIN_H - 6.0),
                                      c_span / (WIN_W - 6.0)), min=1.0)
    q = torch.exp2(torch.clamp(torch.ceil(torch.log2(ratio)), 0.0,
                               float(max_qexp)))
    rq = (rows + 0.5) / q[:, None] - 0.5
    cq = (cols + 0.5) / q[:, None] - 0.5
    r0, c0 = sampler.window_origin_from_footprint(
        rq, cq, w / q, WIN_H, WIN_W, h / q, mip_pad_w / q)
    scale = (h / ah) * q
    ar0, ac0 = sampler.window_origin_from_footprint(
        (rows + 0.5) / scale[:, None] - 0.5,
        (cols + 0.5) / scale[:, None] - 0.5,
        aw / q, AWIN_H, AWIN_W, ah / q, a_pad_w / q)

    if slope_maps is not None:
        # roughness lost by sampling level+qexp instead of the render level
        r_mid, c_mid, _, _ = sampler.block_footprint(rows, cols, w)
        ch, cw = slope_maps.shape[1], slope_maps.shape[2]
        cr = torch.clamp((r_mid / h * ch).to(torch.int32), 0, ch - 1).long()
        cc = torch.clamp((torch.remainder(c_mid, w) / w * cw)
                         .to(torch.int32), 0, cw - 1).long()
        qexp = torch.round(torch.log2(q)).long()
        lost = slope_maps[0, cr, cc] - slope_maps[qexp, cr, cc]
        sigma = torch.sqrt(torch.clamp(lost, min=0.0))
    else:
        sigma = torch.zeros_like(q)
    return WindowOrigins(r0=r0, c0=c0, ar0=ar0, ac0=ac0, q=q, sigma=sigma)


def _clamped(levels, r0, c0, wh: int, ww: int, qi):
    """Origins clamped into each block's own level (non-negative)."""
    dev = r0.device
    hs_ = torch.tensor([l.shape[0] for l in levels], dtype=torch.int32,
                       device=dev)
    ws_ = torch.tensor([l.shape[1] for l in levels], dtype=torch.int32,
                       device=dev)
    qi = qi.long()
    return (torch.clamp(torch.minimum(r0, hs_[qi] - wh), min=0),
            torch.clamp(torch.minimum(c0, ws_[qi] - ww), min=0))


def _pick_level_windows(levels, qexp, r0, c0, wh: int, ww: int,
                        scale: float = 1.0, offset: float = 0.0):
    """A window per block from levels[qexp[blk]] (q = 2^qexp), cut by K5
    in one launch; origins are in the block's own stride-level
    coordinates. Levels may be stored quantized (int16/uint8, value =
    raw*scale+offset); windows come back decoded f32. A 3-D map comes
    back (nblk, wh, ww, C), its texels read whole; ``levels`` may also be
    a sequence of pyramids with equal level shapes (shadow and bounce),
    cut side by side into (nblk, wh, n_maps*ww)."""
    first = levels if isinstance(levels[0], torch.Tensor) else levels[0]
    qi = torch.clamp(qexp, 0, len(first) - 1)
    rk, ck = _clamped(first, r0, c0, wh, ww, qi)
    return extract_ops.extract_level_windows(
        levels, qi, rk, ck, wh, ww, scale=scale, offset=offset)


def extract_window_cache(mips, albedo_mips, org: WindowOrigins,
                         h_scale: float = 1.0, h_offset: float = 0.0,
                         a_scale: float = 1.0,
                         grouped: bool = True) -> WindowCache:
    """Per-block windows from the block's stride level.

    mips/albedo_mips: tuples of successively-coarser pyramid levels
    starting at the render level; a block with stride q = 2^k reads level
    index k. Quantized pyramids (int16 heights, uint8 albedo) decode
    through h_scale/h_offset and a_scale.

    grouped (the march-kernel path): K1 cuts both, the albedo windows
    straight into the march kernel's packed channel-blocked layout. Not
    grouped (the blocked backend): K5 cuts one window per block, the
    albedo as whole texels into (nblk, AWIN_H, AWIN_W, 3)."""
    qexp = torch.round(torch.log2(org.q)).to(torch.int32)
    if not grouped:
        hwin = _pick_level_windows(mips, qexp, org.r0, org.c0, WIN_H, WIN_W,
                                   scale=h_scale, offset=h_offset)
        awin = _pick_level_windows(albedo_mips, qexp, org.ar0, org.ac0,
                                   AWIN_H, AWIN_W, scale=a_scale)
        hmean = torch.mean(hwin, dim=(1, 2))[:, None]
        return WindowCache(hwin=hwin - hmean[..., None], hmean=hmean,
                           awin=awin)
    qi = torch.clamp(qexp, 0, len(mips) - 1)
    rk, ck = _clamped(mips, org.r0, org.c0, WIN_H, WIN_W, qi)
    hwin = extract_ops.extract_group_windows(
        (tuple(mips),), qi, rk, ck, WIN_H, WIN_W,
        scales=(h_scale,), offsets=(h_offset,), group=GROUP)
    hwin = hwin.reshape(-1, WIN_H, WIN_W)
    aqi = torch.clamp(qexp, 0, len(albedo_mips) - 1)
    ark, ack = _clamped(albedo_mips, org.ar0, org.ac0, AWIN_H, AWIN_W, aqi)
    awin = extract_ops.extract_group_windows(
        (tuple(albedo_mips),), aqi, ark, ack, AWIN_H, AWIN_W,
        scales=(a_scale,), group=GROUP)
    # Mean-center each height window: bilinear weights sum to 1, so
    # sample(win) == sample(win - mean) + mean, and the centered residuals
    # survive the march's bf16 window rounding.
    hmean = torch.mean(hwin, dim=(1, 2))[:, None]
    return WindowCache(hwin=hwin - hmean[..., None], hmean=hmean, awin=awin)


def _decimate(m):
    m = m[: m.shape[0] // 2 * 2, : m.shape[1] // 2 * 2]
    return m.reshape(m.shape[0] // 2, 2, m.shape[1] // 2, 2).mean(dim=(1, 3))


def build_shadow_windows(shadow_map, smap_params, geom: RayGeom,
                         bounce_map=None, group: int = GROUP,
                         grouped: bool = True) -> ShadowWindows:
    """Per-block windows into the sun-frame shadow map. Footprints from
    the chord endpoints + midpoint; blocks spanning more than a window
    sample a 2x- or 4x-decimated copy of the map. bounce_map (same grid)
    shares the origins and stride; its windows sit in columns
    [SWIN_W, 2*SWIN_W).

    grouped (the march-kernel path): K1 cuts both maps into the march
    kernel's bf16 shadow|bounce layout. Not grouped (the blocked
    backend): K5 cuts both into f32 shadow|bounce windows in one launch,
    SWIN_W columns without a bounce map."""
    n_phi = shadow_map.shape[1] - shadow_scan.PHI_PAD
    rcs = [shadow_scan.rowcol_of_points(smap_params, n_phi, p)
           for p in _chord_points(geom)]
    rows = torch.cat([rc[0] for rc in rcs], dim=1)
    cols = torch.cat([rc[1] for rc in rcs], dim=1)

    _, _, r_span, c_span = sampler.block_footprint(rows, cols, n_phi)
    ratio = torch.clamp(torch.maximum(r_span / (SWIN_H - 4.0),
                                      c_span / (SWIN_W - 4.0)), min=1.0)
    sq = torch.exp2(torch.clamp(torch.ceil(torch.log2(ratio)), 0.0, 2.0))
    rq = (rows + 0.5) / sq[:, None] - 0.5
    cq = (cols + 0.5) / sq[:, None] - 0.5

    # The scan pads only PHI_PAD wrap columns; a seam-straddling block at
    # stride up to 4 needs up to (SWIN_W-4)*4 columns past phi=0, so the
    # wrap is extended to 4*SWIN_W base columns before cutting windows.
    ext = min(4 * SWIN_W, n_phi)

    def _extend(m):
        return torch.cat([m, m[:, shadow_scan.PHI_PAD:ext]], dim=1)

    shadow_map = _extend(shadow_map)
    sr0, sc0 = sampler.window_origin_from_footprint(
        rq, cq, n_phi / sq, SWIN_H, SWIN_W,
        shadow_map.shape[0] / sq, (n_phi + ext) / sq)
    sqexp = torch.round(torch.log2(sq)).to(torch.int32)

    if not grouped:
        half = _decimate(shadow_map)
        maps = [(shadow_map, half, _decimate(half))]
        if bounce_map is not None:
            bmap = _extend(bounce_map)
            bhalf = _decimate(bmap)
            maps.append((bmap, bhalf, _decimate(bhalf)))
        swin = _pick_level_windows(maps, sqexp, sr0, sc0, SWIN_H, SWIN_W)
        return ShadowWindows(swin=swin, sr0=sr0, sc0=sc0, sq=sq)

    # grouped paired extraction straight to the bf16 shadow|bounce layout
    smap16 = shadow_map.to(torch.bfloat16)
    shalf = _decimate(smap16)
    slv = (smap16, shalf, _decimate(shalf))
    qi = torch.clamp(sqexp, 0, 2)
    rk, ck = _clamped(slv, sr0, sc0, SWIN_H, SWIN_W, qi)
    maps = (slv,)
    if bounce_map is not None:
        bmap16 = _extend(bounce_map).to(torch.bfloat16)
        bhalf = _decimate(bmap16)
        maps = (slv, (bmap16, bhalf, _decimate(bhalf)))
    packed = extract_ops.extract_group_windows(
        maps, qi, rk, ck, SWIN_H, SWIN_W, group=group,
        out_dtype=torch.bfloat16)
    swin = packed.reshape(-1, SWIN_H, len(maps) * SWIN_W)
    return ShadowWindows(swin=swin, sr0=sr0, sc0=sc0, sq=sq)


# ---- the blocked backend: march, shadow lookup and shading on windows ------

def _local_coords(lat, lon, h: int, w: int, r0, c0, q):
    """Window-local fractional coords in the block's stride level;
    seam-aware via padded columns."""
    row, col = latlon_to_rowcol(lat, lon, h, w)
    qb = q[:, None]
    row = (row + 0.5) / qb - 0.5
    col = (col + 0.5) / qb - 0.5
    col = torch.where(col < c0[:, None].to(col.dtype) - 0.5,
                      col + w / qb, col)
    return row - r0[:, None], col - c0[:, None]


def _sample_height(cache: WindowCache, lat, lon, h, w, org):
    wy, wx = _local_coords(lat, lon, h, w, org.r0, org.c0, org.q)
    return window_bilinear(cache.hwin, wy, wx) + cache.hmean


def march_blocks(cache: WindowCache, org: WindowOrigins, geom: RayGeom,
                 h: int, w: int, jitter_t, n_coarse: int = 24,
                 n_bisect: int = 8):
    """Bracket+bisect against cached windows; jitter_t dithers the coarse
    sample phase per accumulation frame. Returns (hit, t_hit, lat, lon,
    p)."""
    ob = geom.ob
    db = geom.db
    span = geom.t_end - geom.t_enter
    jitter_t = torch.as_tensor(jitter_t, dtype=torch.float32,
                               device=db.device)

    def field(t):
        p = ob + t[..., None] * db
        lat, lon = unit_to_latlon(p)
        hs = _sample_height(cache, lat, lon, h, w, org)
        return torch.linalg.norm(p, dim=-1) - C.MOON_RADIUS * hs

    found = torch.zeros(db.shape[:2], dtype=torch.bool, device=db.device)
    t_lo, t_hi = geom.t_enter, geom.t_end
    for k in range(n_coarse + 1):
        frac = (k + jitter_t) / n_coarse
        t_k = geom.t_enter + span * frac
        newly = (~found) & (field(t_k) < 0.0) & geom.hit_outer
        t_prev = geom.t_enter + span * torch.clamp(frac - 1.0 / n_coarse,
                                                   min=0.0)
        t_lo = torch.where(newly, t_prev, t_lo)
        t_hi = torch.where(newly, t_k, t_hi)
        found = found | newly

    for _ in range(n_bisect):
        t_mid = 0.5 * (t_lo + t_hi)
        outside = field(t_mid) > 0.0
        t_lo, t_hi = (torch.where(outside, t_mid, t_lo),
                      torch.where(outside, t_hi, t_mid))
    t_hit = 0.5 * (t_lo + t_hi)
    p = ob + t_hit[..., None] * db
    lat, lon = unit_to_latlon(p)
    return found, t_hit, lat, lon, p


def normal_step_texels(p, db, t_hit, pix_ang, q, h: int):
    """Per-ray central-difference step in the block's stride-level texels:
    half the arc one pixel spans on the surface, so the stencil width is
    continuous across per-block stride (q) boundaries."""
    p_unit = normalize(p)
    cosv = torch.clamp(torch.abs(torch.sum(p_unit * db, dim=-1)), min=0.05)
    arc = t_hit * pix_ang / (C.MOON_RADIUS * cosv)   # radians per pixel
    ft = arc * (h / torch.pi)                        # level-0 lat texels
    return torch.clamp(0.5 * ft / q, 0.5, 3.0)


def shade_blocks(cache: WindowCache, org: WindowOrigins, h: int, w: int,
                 ah: int, aw: int, lat, lon, p, fp: FrameParams, shadow,
                 geom: Optional[RayGeom] = None, t_hit=None, pix_ang=None,
                 bounce=None):
    """Normals from height windows, albedo from its windows (either
    WindowCache.awin layout), Lambert."""
    hs = _sample_height(cache, lat, lon, h, w, org)
    if pix_ang is not None and geom is not None and t_hit is not None:
        step = normal_step_texels(p, geom.db, t_hit, pix_ang,
                                  org.q[:, None], h)
    else:
        step = 0.5
    dlat = (180.0 / h) * org.q[:, None] * step
    coslat = torch.clamp(torch.cos(torch.deg2rad(lat)), min=0.05)
    dlon = dlat / coslat

    def spoint(la, lo):
        hv = _sample_height(cache, la, lo, h, w, org)
        return C.MOON_RADIUS * hv[..., None] * latlon_to_unit(la, lo)

    p_c = C.MOON_RADIUS * hs[..., None] * latlon_to_unit(lat, lon)
    n = torch.linalg.cross(spoint(lat, lon + dlon) - spoint(lat, lon - dlon),
                           spoint(lat + dlat, lon) - spoint(lat - dlat, lon))
    n = normalize(n)
    n = torch.where(torch.sum(n * p_c, dim=-1, keepdim=True) < 0.0, -n, n)

    awy, awx = _local_coords(lat, lon, ah, aw, org.ar0, org.ac0, org.q)
    if cache.awin.ndim == 3:
        # packed channel-blocked layout (ns, GROUP*AWIN_H, 3*AWIN_W)
        aw3 = cache.awin.reshape(-1, AWIN_H, 3 * AWIN_W)
        albedo = torch.stack(
            [window_bilinear(aw3[:, :, m * AWIN_W:(m + 1) * AWIN_W],
                             awy, awx) for m in range(3)], dim=-1)
    else:
        albedo = window_bilinear(cache.awin, awy, awx)
    return shade_lambert(albedo, n, p, fp, shadow,
                         sigma=org.sigma[:, None], bounce=bounce,
                         view_db=None if geom is None else geom.db)


def shadow_scan_total_rows(smap_params):
    return smap_params.n_coarse + smap_params.n_fine


def lookup_shadow_windows(sw: ShadowWindows, smap_params, n_phi: int, p):
    """Sample (shadow, bounce) at body-frame points through the per-block
    windows (bounce is zeros when disabled)."""
    rows, cols = shadow_scan.rowcol_of_points(smap_params, n_phi, p)
    qb = sw.sq[:, None]
    rows = (rows + 0.5) / qb - 0.5
    cols = (cols + 0.5) / qb - 0.5
    cols = torch.where(cols < sw.sc0[:, None].to(cols.dtype) - 0.5,
                       cols + n_phi / qb, cols)
    # rows are stride coords: true row = (rows + 0.5) * qb - 0.5, so the
    # night gate fires at every stride (rowcol_of_points pre-clamps to
    # total - 1.001)
    true_rows = (rows + 0.5) * qb - 0.5
    theta_ok = true_rows < shadow_scan_total_rows(smap_params) - 1.001
    wy = rows - sw.sr0[:, None]
    wx = cols - sw.sc0[:, None]
    swin = sw.swin.to(torch.float32)
    val = window_bilinear(swin[:, :, :SWIN_W], wy, wx)
    if swin.shape[2] > SWIN_W:
        bval = torch.where(theta_ok,
                           window_bilinear(swin[:, :, SWIN_W:], wy, wx), 0.0)
    else:
        bval = torch.zeros_like(val)
    return torch.where(theta_ok, val, 0.0), bval


@span("scene.sample")
def render_frame_blocked(cache: WindowCache, org: WindowOrigins,
                         geom: RayGeom,
                         shadow_windows: Optional[ShadowWindows],
                         smap_params, background, basis: CameraBasis,
                         fp: FrameParams, jitter_t, height: int, width: int,
                         h: int, w: int, ah: int, aw: int, n_phi: int = 0,
                         n_coarse: int = 24) -> RenderOutput:
    """One accumulation sample from cached windows (the blocked backend's
    per-frame path): march_blocks, lookup_shadow_windows, shade_blocks and
    composite_blocks, in one kernel launch on the card
    (ops.blocked_sample)."""
    return bs.blocked_sample(cache, org, geom, shadow_windows, smap_params,
                             background, basis, fp, jitter_t, height, width,
                             h, w, ah, aw, n_phi=n_phi, n_coarse=n_coarse)


# ---- the march-kernel path ---------------------------------------------------

class PackedWindows(NamedTuple):
    """March-kernel-layout window tensors (cached per pose)."""

    hwin: torch.Tensor     # (NS, G*WIN_H, WIN_W)
    awin: torch.Tensor     # (NS, G*AWIN_H, 3*AWIN_W) channel-major
    swin: torch.Tensor     # (NS, G*SWIN_H, 2*SWIN_W) bf16 shadow | bounce
    scal: torch.Tensor     # (NS, N_SCAL, G, B) lane-broadcast per-block scalars


def _pack_sun_parts(cache: WindowCache, org: WindowOrigins,
                    shadow_windows: Optional[ShadowWindows]):
    """(swin_packed, scal) — the sun-dependent kernel tensors."""
    nblk = cache.hwin.shape[0]
    ns = nblk // GROUP
    dev = cache.hwin.device
    if shadow_windows is not None:
        sr0, sc0 = shadow_windows.sr0, shadow_windows.sc0
        sq, swin = shadow_windows.sq, shadow_windows.swin
    else:
        sr0 = torch.zeros((nblk,), dtype=torch.int32, device=dev)
        sc0 = torch.zeros((nblk,), dtype=torch.int32, device=dev)
        sq = torch.ones((nblk,), dtype=torch.float32, device=dev)
        swin = torch.zeros((nblk, SWIN_H, 2 * SWIN_W), dtype=torch.float32,
                           device=dev)
    if swin.shape[2] < 2 * SWIN_W:
        # bounce disabled: restore the kernel's uniform shadow|bounce layout
        swin = torch.nn.functional.pad(swin.to(torch.float32),
                                       (0, 2 * SWIN_W - swin.shape[2]))
    swin = swin.to(torch.bfloat16)
    scal = torch.stack([
        org.r0.to(torch.float32), org.c0.to(torch.float32),
        cache.hmean[:, 0], org.q,
        org.ar0.to(torch.float32), org.ac0.to(torch.float32),
        sr0.to(torch.float32), sc0.to(torch.float32),
        sq.to(torch.float32), org.sigma,
    ])
    n_scal = scal.shape[0]
    scal = scal.reshape(n_scal, ns, GROUP).permute(1, 0, 2)
    scal = scal[..., None].expand(ns, n_scal, GROUP, BLOCK).contiguous()
    swin = swin.reshape(ns, GROUP * SWIN_H, 2 * SWIN_W)
    return swin, scal


def pack_pose_windows(cache: WindowCache):
    """(hwin_packed, awin_packed) — the pose-dependent kernel tensors,
    from either WindowCache.awin layout."""
    nblk = cache.hwin.shape[0]
    ns = nblk // GROUP
    hwin = cache.hwin.reshape(ns, GROUP * WIN_H, WIN_W)
    if cache.awin.ndim == 3:
        return hwin, cache.awin       # K1 emitted the packed layout
    awin = torch.movedim(cache.awin, 3, 2).reshape(nblk, AWIN_H, 3 * AWIN_W)
    return hwin, awin.reshape(ns, GROUP * AWIN_H, 3 * AWIN_W)


def pack_windows(cache: WindowCache, org: WindowOrigins,
                 shadow_windows: Optional[ShadowWindows]) -> PackedWindows:
    """Repack the blocked backend's caches into the march kernel's layout
    (a scene switched to the march path with caches already built)."""
    hwin, awin = pack_pose_windows(cache)
    swin, scal = _pack_sun_parts(cache, org, shadow_windows)
    return PackedWindows(hwin=hwin, awin=awin, swin=swin, scal=scal)


def _kernel_params(ob, fp: FrameParams, smap_params, use_shadow: bool,
                   pix_ang, ah: int, aw: int):
    """The (27, G, B) broadcast params planes of the march kernel."""
    dev = ob.device
    f32 = torch.float32

    def s(v):
        return torch.as_tensor(v, dtype=f32, device=dev).reshape(())

    light_body = mat3t_apply(fp.rotation, fp.light_pos)
    lblend = s(0.0) if fp.lunar_blend is None else s(fp.lunar_blend)
    if fp.earth is not None:
        ecl = [fp.earth[0], fp.earth[1], fp.earth[2], fp.earth[3],
               fp.earth[4], fp.sun_ang_radius, fp.earth[5]]
    else:
        ecl = [s(0.0), s(0.0), s(1.0), s(1.0), s(0.0), fp.sun_ang_radius,
               s(0.0)]
    if use_shadow and smap_params is not None:
        sp = smap_params
        params_list = [ob[0], ob[1], ob[2],
                       light_body[0], light_body[1], light_body[2],
                       fp.irradiance, sp.n_coarse, sp.n_fine, sp.n_phi,
                       sp.axis_z[0], sp.axis_z[1], sp.axis_z[2],
                       sp.axis_x[0], sp.axis_x[1], sp.axis_x[2], pix_ang,
                       s(ah), s(aw), lblend] + ecl
    else:
        z = s(0.0)
        params_list = [ob[0], ob[1], ob[2],
                       light_body[0], light_body[1], light_body[2],
                       fp.irradiance, z, z, s(1.0), z, z, s(1.0), s(1.0),
                       z, z, pix_ang, s(ah), s(aw), lblend] + ecl
    vec = torch.stack([s(v) for v in params_list])
    return vec[:, None, None].expand(mk.N_PARAMS, GROUP, BLOCK).contiguous()


def render_frame_pallas(cache: WindowCache, org: WindowOrigins,
                        geom: RayGeom,
                        shadow_windows: Optional[ShadowWindows],
                        smap_params, background, basis: CameraBasis,
                        fp: FrameParams, height: int, width: int, h: int,
                        w: int, ah: Optional[int] = None,
                        aw: Optional[int] = None, n_coarse: int = 16,
                        use_shadow: bool = True) -> RenderOutput:
    """One frame through the march kernel (K2) from window caches: packs
    the windows and runs one sample on ``geom``'s rays (for repeated
    samples render_accumulate_pallas packs once). ah/aw: the albedo
    level's shape when coarser than the height level."""
    packed = pack_windows(cache, org,
                          shadow_windows if use_shadow else None)
    params = _kernel_params(geom.ob, fp, smap_params, use_shadow,
                            2.0 * basis.tan_half_fov / height,
                            ah if ah is not None else h,
                            aw if aw is not None else w)
    ns = geom.db.shape[0] // GROUP
    dbx, dby, dbz = (geom.db[..., i].reshape(ns, GROUP, BLOCK)
                     for i in range(3))
    r, g, b, hitf, t_hit, px, py, pz = mk.march_shade(
        params, dbx, dby, dbz, geom.t_enter.reshape(ns, GROUP, BLOCK),
        geom.t_end.reshape(ns, GROUP, BLOCK),
        geom.hit_outer.to(torch.float32).reshape(ns, GROUP, BLOCK),
        packed.scal, packed.hwin, packed.awin, packed.swin, h=h, w=w,
        n_coarse=n_coarse, use_shadow=use_shadow,
        use_earth=fp.earth is not None)
    rgb, hitbuf = composite_kernel_outputs(
        r, g, b, hitf, t_hit, px, py, pz, height, width, geom.dirs_scene,
        basis.eye, fp, background=background)
    return RenderOutput(rgb=rgb, hitbuf=hitbuf)


@span("scene.burst")
def _burst_core(packed: PackedWindows, smap_params, background, maxmap,
                basis: CameraBasis, fp: FrameParams, jitters, height: int,
                width: int, h: int, w: int, h_min: float, ah: int, aw: int,
                n_samples: int, n_coarse: int, use_shadow: bool,
                hbound=None, geom0: Optional[RayGeom] = None):
    """N jittered accumulation samples: sample 0's rays (with the image-
    order directions the sun-disk pass needs) through the march kernel,
    then samples 1..N-1, warm-started from the previous sample's hits,
    with their rays and the running mean in one burst kernel
    (ops.march_shade.march_burst). geom0: sample 0's rays where the
    caller has built them (jitters[0], the chord bound hbound), else built
    here. Returns (rgb_mean, hitbuf of sample 0)."""
    ob = mat3t_apply(fp.rotation, basis.eye)
    params = _kernel_params(ob, fp, smap_params, use_shadow,
                            2.0 * basis.tan_half_fov / height, ah, aw)
    if geom0 is None:
        geom0 = block_rays(basis, fp.rotation, jitters[0], height, width,
                           h_min, maxmap=maxmap, h_bound=hbound)
    ns = geom0.db.shape[0] // GROUP
    dbx, dby, dbz = (geom0.db[..., i].reshape(ns, GROUP, BLOCK)
                     for i in range(3))
    use_earth = fp.earth is not None
    r0, g0, b0, hit0, t0_, px0, py0, pz0 = mk.march_shade(
        params, dbx, dby, dbz, geom0.t_enter.reshape(ns, GROUP, BLOCK),
        geom0.t_end.reshape(ns, GROUP, BLOCK),
        geom0.hit_outer.to(torch.float32).reshape(ns, GROUP, BLOCK),
        packed.scal, packed.hwin, packed.awin, packed.swin, h=h, w=w,
        n_coarse=n_coarse, use_shadow=use_shadow, use_earth=use_earth)
    ar, ag, ab = r0, g0, b0
    if n_samples > 1:
        ar, ag, ab = mk.march_burst(
            params, basis, fp.rotation, jitters, geom0.h_bound, r0, g0, b0,
            t0_, hit0, packed.scal, packed.hwin, packed.awin, packed.swin,
            h=h, w=w, height=height, width=width, h_min=h_min,
            n_samples=n_samples, n_coarse=n_coarse, use_shadow=use_shadow,
            use_earth=use_earth)

    return composite_kernel_outputs(
        ar, ag, ab, hit0, t0_, px0, py0, pz0, height, width,
        geom0.dirs_scene, basis.eye, fp, background=background)


def render_accumulate_pallas(packed: PackedWindows, smap_params, background,
                             maxmap, basis: CameraBasis, fp: FrameParams,
                             jitters, height: int, width: int, h: int, w: int,
                             h_min: float, ah: Optional[int] = None,
                             aw: Optional[int] = None, n_samples: int = 8,
                             n_coarse: int = 12, use_shadow: bool = True,
                             hbound=None):
    """The accumulation burst from cached packed windows (the reference's
    name is kept so the two packages' entry points line up)."""
    return _burst_core(packed, smap_params, background, maxmap, basis, fp,
                       jitters, height, width, h, w, h_min,
                       ah if ah is not None else h,
                       aw if aw is not None else w,
                       n_samples, n_coarse, use_shadow, hbound=hbound)


def render_pose_pallas(mips, albedo_mips, slope_maps, smap, smap_params,
                       bmap, background, maxmap, basis: CameraBasis,
                       fp: FrameParams, jitters, height: int, width: int,
                       h: int, w: int, ah: int, aw: int, h_min: float,
                       max_qexp: int = 2, n_samples: int = 8,
                       n_coarse: int = 12, use_shadow: bool = True,
                       h_scale: float = 1.0, h_offset: float = 0.0,
                       a_scale: float = 1.0):
    """The pose-change path: window origins + cache extraction + pose/sun
    packing + shadow windows + the full accumulation burst.

    Returns (rgb, hitbuf, org, cache, hwin_p, awin_p, swin_p, scal,
    h_bound) so the caller can keep the caches for later bursts."""
    with span("scene.pose"):
        geom0 = block_rays(basis, fp.rotation, jitters[0], height, width,
                           h_min, maxmap=maxmap)
        org = window_origins(geom0, h, w, mips[0].shape[1], ah, aw,
                             albedo_mips[0].shape[1], max_qexp=max_qexp,
                             slope_maps=slope_maps)
        cache = extract_window_cache(mips, albedo_mips, org,
                                     h_scale=h_scale, h_offset=h_offset,
                                     a_scale=a_scale)
        sw = (build_shadow_windows(smap, smap_params, geom0, bounce_map=bmap)
              if use_shadow else None)
        hwin_p, awin_p = pack_pose_windows(cache)
        swin_p, scal = _pack_sun_parts(cache, org, sw)
        packed = PackedWindows(hwin=hwin_p, awin=awin_p, swin=swin_p,
                               scal=scal)
    rgb, hitbuf = _burst_core(packed, smap_params, background, maxmap,
                              basis, fp, jitters, height, width, h, w,
                              h_min, ah, aw, n_samples, n_coarse,
                              use_shadow, geom0=geom0)
    return (rgb, hitbuf, org, cache, hwin_p, awin_p, swin_p, scal,
            geom0.h_bound)


def build_shadow_state_from_maps(smap, smap_params, geom: RayGeom,
                                 cache: WindowCache, org: WindowOrigins,
                                 bmap=None):
    """Shadow/bounce windows + the sun-part repack from already-built
    maps: the geometry-dependent half of the shadow state. The maps depend
    only on the sun, so a camera pose change at a fixed time rebuilds only
    this half and reuses them.

    Returns (ShadowWindows, swin_packed, scal); the caller combines
    swin/scal with its cached pose-packed hwin/awin (pack_pose_windows),
    so a time step never moves those again."""
    sw = build_shadow_windows(smap, smap_params, geom, bounce_map=bmap)
    swin_packed, scal = _pack_sun_parts(cache, org, sw)
    return sw, swin_packed, scal


def render_timestep_pallas(smap, smap_params, bmap, cache: WindowCache,
                           org: WindowOrigins, hwin_p, awin_p, background,
                           maxmap, basis: CameraBasis, fp: FrameParams,
                           jitters, height: int, width: int, h: int, w: int,
                           h_min: float, ah: int, aw: int,
                           n_samples: int = 8, n_coarse: int = 12,
                           hbound=None):
    """The time-step (Q/W) path with the pose windows kept: shadow/bounce
    windows from the freshly scanned maps (K1), the sun-side repack and
    the accumulation burst (K2).

    Returns (rgb_mean, hitbuf, swin_packed, scal) so the caller can keep
    the sun-side pack for later pose-stable frames. hbound: the cached
    pose-local per-block chord bound (RayGeom.h_bound), which skips the
    maxmap gather in the ray setup."""
    with span("scene.timestep"):
        geom0 = block_rays(basis, fp.rotation, jitters[0], height, width,
                           h_min, maxmap=maxmap, h_bound=hbound)
        sw = build_shadow_windows(smap, smap_params, geom0, bounce_map=bmap)
        swin_p, scal = _pack_sun_parts(cache, org, sw)
        packed = PackedWindows(hwin=hwin_p, awin=awin_p, swin=swin_p,
                               scal=scal)
    rgb, hitbuf = _burst_core(packed, smap_params, background, maxmap,
                              basis, fp, jitters, height, width, h, w,
                              h_min, ah, aw, n_samples, n_coarse, True,
                              geom0=geom0)
    return rgb, hitbuf, swin_p, scal


def render_timestep_scan_pallas(stex, bmap, sun_basis, sun_ang_radius,
                                cache: WindowCache, org: WindowOrigins,
                                hwin_p, awin_p, background, maxmap,
                                basis: CameraBasis, fp: FrameParams, jitters,
                                height: int, width: int, h: int, w: int,
                                h_min: float, ah: int, aw: int,
                                sh: int, sw: int, n_coarse_scan: int,
                                n_fine: int, n_phi: int, n_samples: int = 1,
                                n_coarse: int = 12, h_scale: float = 1.0,
                                h_offset: float = 0.0, hbound=None):
    """The drift-reuse time step (the common held-key Q/W step): the
    sun-frame shadow scan, factor only (K4 resample, K3 prefix max; the
    bounce map is the drift-reused cache, engine/scene.py
    BOUNCE_REUSE_DEG), then render_timestep_pallas.

    stex: the shadow-level heightfield mip; (sh, sw) its unpadded shape;
    sun_basis: (3, 3) rows x, y, z of the sun frame; sun_ang_radius: a
    float. Returns (rgb_mean, hitbuf, swin_packed, scal, smap, hs): smap so
    the caller can keep it for pose changes, hs (scan-grid heights) so a
    threshold crossing can queue shadow_scan.bounce_refresh without a
    second scan."""
    with span("scene.timestep"):
        factor, hs = shadow_scan.scan_wedge(
            stex, sun_basis, sun_ang_radius, sh, sw, n_coarse_scan, n_fine,
            n_phi, 0, n_phi, blocked_resample=True, h_scale=h_scale,
            h_offset=h_offset, return_heights=True)
        smap = torch.cat([factor, factor[:, :shadow_scan.PHI_PAD]], dim=1)
    smap_params = shadow_scan._params(sun_basis, n_coarse_scan, n_fine,
                                      n_phi, sun_ang_radius)
    rgb, hitbuf, swin_p, scal = render_timestep_pallas(
        smap, smap_params, bmap, cache, org, hwin_p, awin_p, background,
        maxmap, basis, fp, jitters, height, width, h, w, h_min, ah, aw,
        n_samples=n_samples, n_coarse=n_coarse, hbound=hbound)
    return rgb, hitbuf, swin_p, scal, smap, hs
