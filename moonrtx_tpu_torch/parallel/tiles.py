"""Image-strip rendering over a device list (torch).

Port of moonrtx_tpu/parallel/tiles.py. Each device renders a horizontal
strip of the frame: ray generation, window extraction, marching and
shading are local to the strip; the maps and frame parameters are
replicated (moved to each device where they are used); the strips are
gathered into the frame on the mesh's first device. The host issues the
strips in turn with no synchronisation between them.

The shadow scan is sharded too: its azimuth (phi) axis is embarrassingly
parallel, so each device scans a phi wedge of the sun-frame grid and the
wedges are gathered into the map used by shading; the one-bounce
irradiance map is computed on the gathered grid (its blurs cross wedge
seams).

The interactive programs (render_pose_sharded, render_timestep_sharded,
render_accumulate_sharded) keep every per-block cache on the device of
the strip it renders: blocks are row-major, so a strip is a contiguous
block range, and the caches come back as NamedTuples of per-device lists
(parallel/mesh.py) that the time-step and accumulate programs reuse.
"""

from __future__ import annotations

import torch

from moonrtx_tpu_torch.engine import blocked
from moonrtx_tpu_torch.ops import march_shade as mk
from moonrtx_tpu_torch.ops import shadow_scan
from moonrtx_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    shard,
    stack_shards,
    to_device,
)


def _strip_height(mesh: Mesh, height: int) -> int:
    strip_h = height // mesh.size
    if strip_h * mesh.size != height or strip_h % blocked.BLOCK_H:
        raise ValueError(f"frame height {height} does not split into "
                         f"{mesh.size} strips of whole {blocked.BLOCK_H}-row "
                         "blocks")
    return strip_h


def _on(mesh: Mesh, d: int):
    """Device d's view of an argument: its shard, moved to its device."""
    dev = mesh.devices[d]
    return lambda x: to_device(shard(x, d), dev)


def _bg_strip(background, use_bg: bool, d: int, strip_h: int, dev):
    if not use_bg or background is None:
        return None
    return background[d * strip_h:(d + 1) * strip_h].to(dev)


def _gather_frame(mesh: Mesh, outs: list):
    """(rgb, hitbuf) of the whole frame on the first device from the
    strips' (rgb, hitbuf)."""
    to = mesh.devices[0]
    return (all_gather([o[0] for o in outs], 0, to),
            all_gather([o[1] for o in outs], 0, to))


def render_frame_sharded(mesh: Mesh, mip, mip_next, albedo_mip, albedo_next,
                         maxmap, basis, fp, jitter, height: int, width: int,
                         h: int, w: int, ah: int, aw: int, h_min: float,
                         shadow_map=None, smap_params=None, bounce_map=None,
                         n_coarse: int = 24, h_scale: float = 1.0,
                         h_offset: float = 0.0, a_scale: float = 1.0,
                         max_qexp: int = 1):
    """One frame of the windowed pipeline (march and shading in plain
    torch ops) with rows split over the mesh. Returns (rgb, hitbuf) of the
    whole frame on the first device."""
    strip_h = _strip_height(mesh, height)
    outs = []
    for d in range(mesh.size):
        on = _on(mesh, d)
        bas, fpd, mx = on(basis), on(fp), on(maxmap)
        geom = blocked.block_rays(bas, fpd.rotation, on(jitter), strip_h,
                                  width, h_min, maxmap=mx,
                                  row_offset=d * strip_h, full_height=height)
        mips = (on(mip), on(mip_next))
        albs = (on(albedo_mip), on(albedo_next))
        org = blocked.window_origins(geom, h, w, mips[0].shape[1], ah, aw,
                                     albs[0].shape[1], max_qexp=max_qexp)
        cache = blocked.extract_window_cache(
            mips, albs, org, h_scale=h_scale, h_offset=h_offset,
            a_scale=a_scale)
        hit, t_hit, lat, lon, p = blocked.march_blocks(
            cache, org, geom, h, w, 0.5, n_coarse=n_coarse)
        if shadow_map is not None:
            sm, sp = on(shadow_map), on(smap_params)
            sw = blocked.build_shadow_windows(sm, sp, geom,
                                              bounce_map=on(bounce_map))
            shadow, bounce = blocked.lookup_shadow_windows(
                sw, sp, sm.shape[1] - shadow_scan.PHI_PAD, p)
        else:
            shadow, bounce = torch.ones_like(t_hit), None
        rgb_b = blocked.shade_blocks(
            cache, org, h, w, ah, aw, lat, lon, p, fpd, shadow, geom=geom,
            t_hit=t_hit, pix_ang=2.0 * bas.tan_half_fov / height,
            bounce=bounce)
        outs.append(blocked.composite_blocks(
            rgb_b, hit, t_hit, p, strip_h, width, geom.dirs_scene, bas.eye,
            fpd))
    return _gather_frame(mesh, outs)


def _strip_burst(packed, smap_params, background, maxmap, basis, fp,
                 jitters, strip_h: int, width: int, height: int,
                 row_offset: int, h: int, w: int, ah: int, aw: int,
                 h_min: float, n_samples: int, n_coarse: int, use_sh: bool,
                 geom0=None, warm: bool = True):
    """The accumulation burst of one strip from kernel-packed windows
    (every argument already on the strip's device). Samples >= 2
    warm-start from the previous sample's hits unless ``warm`` is False.
    Returns (rgb, hitbuf) of the strip."""
    def rays(jitter):
        return blocked.block_rays(basis, fp.rotation, jitter, strip_h, width,
                                  h_min, maxmap=maxmap,
                                  row_offset=row_offset, full_height=height)

    if geom0 is None:
        geom0 = rays(jitters[0])
    params = blocked._kernel_params(geom0.ob, fp, smap_params, use_sh,
                                    2.0 * basis.tan_half_fov / height, ah, aw)
    G, B = blocked.GROUP, blocked.BLOCK
    ns = geom0.db.shape[0] // G

    def run_kernel(geom, t_prev=None, f_prev=None):
        dbx, dby, dbz = (geom.db[..., i].reshape(ns, G, B) for i in range(3))
        return mk.march_shade(
            params, dbx, dby, dbz, geom.t_enter.reshape(ns, G, B),
            geom.t_end.reshape(ns, G, B),
            geom.hit_outer.to(torch.float32).reshape(ns, G, B),
            packed.scal, packed.hwin, packed.awin, packed.swin, h=h, w=w,
            n_coarse=n_coarse, use_shadow=use_sh,
            use_earth=fp.earth is not None, t_prev=t_prev, f_prev=f_prev)

    r0, g0, b0, hit0, t0, px0, py0, pz0 = run_kernel(geom0)
    ar, ag, ab, tp, fpv = r0, g0, b0, t0, hit0
    for i in range(1, n_samples):
        r, g, b, hitf, t_hit, *_ = run_kernel(
            rays(jitters[i]), t_prev=tp if warm else None,
            f_prev=fpv if warm else None)
        k = i + 1.0
        ar, ag, ab = ar + (r - ar) / k, ag + (g - ag) / k, ab + (b - ab) / k
        tp, fpv = t_hit, hitf
    return blocked.composite_kernel_outputs(
        ar, ag, ab, hit0, t0, px0, py0, pz0, strip_h, width,
        geom0.dirs_scene, basis.eye, fp, background=background)


def render_burst_pallas_sharded(mesh: Mesh, mip, mip_next, albedo_mip,
                                albedo_next, maxmap, basis, fp, jitters,
                                height: int, width: int, h: int, w: int,
                                ah: int, aw: int, h_min: float,
                                shadow_map=None, smap_params=None,
                                bounce_map=None, n_samples: int = 8,
                                n_coarse: int = 12, use_shadow: bool = True,
                                h_scale: float = 1.0, h_offset: float = 0.0,
                                a_scale: float = 1.0, slope_maps=None,
                                max_qexp: int = 1):
    """The march-kernel path with rows split over the mesh: per strip,
    window extraction (K1), pack and every sample through the march
    kernel (K2), no warm start, as the reference's burst. Returns
    (rgb_mean, hitbuf) of the whole frame on the first device.

    slope_maps: (>= 2, ch, cw) per-level slope maps for the render level
    and level+1, so per-block LOD drops keep the roughness compensation;
    without them sigma is 0."""
    strip_h = _strip_height(mesh, height)
    nblk_s = (strip_h // blocked.BLOCK_H) * (width // blocked.BLOCK_W)
    if nblk_s % blocked.GROUP:
        raise ValueError("strip block count must fill march-kernel groups")
    return render_pose_sharded(
        mesh, mip, mip_next, albedo_mip, albedo_next, slope_maps, shadow_map,
        smap_params, bounce_map, None, maxmap, basis, fp, jitters, height,
        width, h, w, ah, aw, h_min, n_samples=n_samples, n_coarse=n_coarse,
        use_shadow=use_shadow, h_scale=h_scale, h_offset=h_offset,
        a_scale=a_scale, max_qexp=max_qexp, warm=False)[:2]


def build_shadow_map_sharded(mesh: Mesh, tex, sun_basis, sun_ang_radius,
                             h: int, w: int, n_coarse_rows: int, n_fine: int,
                             n_phi: int, alb_lum=None, h_scale: float = 1.0,
                             h_offset: float = 0.0, n_bounces: int = 1):
    """Sun-frame shadow scan with the phi axis split over the mesh.

    Each device scans its azimuth wedge [d * n_phi / n, (d + 1) * n_phi /
    n) (the running max along theta is local to a meridian: K4 resample,
    K3 prefix max); the wedges are gathered on the first device. With
    alb_lum the wedges' heights and albedo are gathered too and the
    one-bounce irradiance map is computed on the gathered grid.

    Returns (shadow_map, bounce_map or None) on the first device, both
    with the PHI_PAD azimuth wrap columns of the single-device maps."""
    n = mesh.size
    if n_phi % n:
        raise ValueError(f"n_phi {n_phi} does not divide over {n} devices")
    wedge = n_phi // n
    ang = float(sun_ang_radius)
    parts = []
    for d in range(n):
        on = _on(mesh, d)
        out = shadow_scan.scan_wedge(
            on(tex), on(sun_basis), ang, h, w, n_coarse_rows, n_fine, n_phi,
            d * wedge, wedge, blocked_resample=True, alb_lum=on(alb_lum),
            h_scale=h_scale, h_offset=h_offset)
        parts.append(out if alb_lum is not None else (out,))
    to = mesh.devices[0]
    gathered = [all_gather([p[i] for p in parts], 1, to)
                for i in range(len(parts[0]))]

    def wrap(m):
        return torch.cat([m, m[:, :shadow_scan.PHI_PAD]], dim=1)

    factor = gathered[0]
    if alb_lum is None:
        return wrap(factor), None
    hs, alb_s = gathered[1], gathered[2]
    bounce = shadow_scan.bounce_from_parts(hs, factor, alb_s, n_coarse_rows,
                                           n_fine, n_phi, n_bounces=n_bounces)
    return wrap(factor), wrap(bounce)


# ---- interactive mesh mode: cached pose/window state ----------------------
#
# These three programs mirror the single-device split (engine/blocked.py
# render_pose_pallas / render_timestep_pallas / render_accumulate_pallas)
# with every per-block tensor kept on its strip's device: a Q/W time step
# runs the phi-wedge scan plus render_timestep_sharded on the resident
# windows, a re-accumulation runs render_accumulate_sharded only.


def render_pose_sharded(mesh: Mesh, mip, mip_next, albedo_mip, albedo_next,
                        slope_maps, smap, smap_params, bmap, background,
                        maxmap, basis, fp, jitters, height: int, width: int,
                        h: int, w: int, ah: int, aw: int, h_min: float,
                        n_samples: int = 1, n_coarse: int = 12,
                        use_shadow: bool = True, use_bg: bool = False,
                        h_scale: float = 1.0, h_offset: float = 0.0,
                        a_scale: float = 1.0, max_qexp: int = 1,
                        warm: bool = True):
    """The mesh pose-change path: per strip, rays + window origins +
    extraction (K1) + pack + shadow windows (K1) + the burst (K2), its
    samples warm-started unless ``warm`` is False. Returns (rgb, hitbuf,
    org, cache, packed): the frame on the first device and the caches as
    NamedTuples of per-device lists, left on the strips' devices for the
    time-step and accumulate programs."""
    strip_h = _strip_height(mesh, height)
    use_sh = use_shadow and smap is not None
    outs, orgs, caches, packs = [], [], [], []
    for d in range(mesh.size):
        on = _on(mesh, d)
        dev = mesh.devices[d]
        bas, fpd, mx, jit = on(basis), on(fp), on(maxmap), on(jitters)
        geom0 = blocked.block_rays(bas, fpd.rotation, jit[0], strip_h, width,
                                   h_min, maxmap=mx, row_offset=d * strip_h,
                                   full_height=height)
        mips = (on(mip), on(mip_next))
        albs = (on(albedo_mip), on(albedo_next))
        org = blocked.window_origins(geom0, h, w, mips[0].shape[1], ah, aw,
                                     albs[0].shape[1], max_qexp=max_qexp,
                                     slope_maps=on(slope_maps))
        cache = blocked.extract_window_cache(
            mips, albs, org, h_scale=h_scale, h_offset=h_offset,
            a_scale=a_scale)
        sp = on(smap_params)
        sw = (blocked.build_shadow_windows(on(smap), sp, geom0,
                                           bounce_map=on(bmap))
              if use_sh else None)
        packed = blocked.pack_windows(cache, org, sw)
        outs.append(_strip_burst(
            packed, sp, _bg_strip(background, use_bg, d, strip_h, dev), mx,
            bas, fpd, jit, strip_h, width, height, d * strip_h, h, w, ah, aw,
            h_min, n_samples, n_coarse, use_sh, geom0=geom0, warm=warm))
        orgs.append(org)
        caches.append(cache)
        packs.append(packed)
    rgb, hitbuf = _gather_frame(mesh, outs)
    return (rgb, hitbuf, stack_shards(orgs), stack_shards(caches),
            stack_shards(packs))


def render_timestep_sharded(mesh: Mesh, smap, smap_params, bmap, cache, org,
                            hwin_p, awin_p, background, maxmap, basis, fp,
                            jitters, height: int, width: int, h: int, w: int,
                            ah: int, aw: int, h_min: float,
                            n_samples: int = 1, n_coarse: int = 12,
                            use_shadow: bool = True, use_bg: bool = False):
    """The mesh time-step (Q/W) path: shadow windows from the freshly
    scanned maps (K1) + sun-side repack + the burst (K2), on the
    pose-cached per-device windows (a time step never moves them).
    Returns (rgb, hitbuf, swin_p, scal), the sun pack as per-device lists
    for the accumulate program to reuse."""
    strip_h = _strip_height(mesh, height)
    use_sh = use_shadow and smap is not None
    outs, swins, scals = [], [], []
    for d in range(mesh.size):
        on = _on(mesh, d)
        dev = mesh.devices[d]
        bas, fpd, mx, jit = on(basis), on(fp), on(maxmap), on(jitters)
        geom0 = blocked.block_rays(bas, fpd.rotation, jit[0], strip_h, width,
                                   h_min, maxmap=mx, row_offset=d * strip_h,
                                   full_height=height)
        sp = on(smap_params)
        sw = (blocked.build_shadow_windows(on(smap), sp, geom0,
                                           bounce_map=on(bmap))
              if use_sh else None)
        swin_p, scal = blocked._pack_sun_parts(shard(cache, d),
                                               shard(org, d), sw)
        packed = blocked.PackedWindows(hwin=shard(hwin_p, d),
                                       awin=shard(awin_p, d), swin=swin_p,
                                       scal=scal)
        outs.append(_strip_burst(
            packed, sp, _bg_strip(background, use_bg, d, strip_h, dev), mx,
            bas, fpd, jit, strip_h, width, height, d * strip_h, h, w, ah, aw,
            h_min, n_samples, n_coarse, use_sh, geom0=geom0))
        swins.append(swin_p)
        scals.append(scal)
    rgb, hitbuf = _gather_frame(mesh, outs)
    return rgb, hitbuf, swins, scals


def render_accumulate_sharded(mesh: Mesh, packed, smap_params, background,
                              maxmap, basis, fp, jitters, height: int,
                              width: int, h: int, w: int, ah: int, aw: int,
                              h_min: float, n_samples: int = 1,
                              n_coarse: int = 12, use_shadow: bool = True,
                              use_bg: bool = False):
    """The mesh steady-state burst: pose and sun packs valid (brightness
    reset, more accumulation), only jittered samples through the march
    kernel (K2) from the cached per-device windows."""
    strip_h = _strip_height(mesh, height)
    outs = []
    for d in range(mesh.size):
        on = _on(mesh, d)
        dev = mesh.devices[d]
        outs.append(_strip_burst(
            shard(packed, d), on(smap_params),
            _bg_strip(background, use_bg, d, strip_h, dev), on(maxmap),
            on(basis), on(fp), on(jitters), strip_h, width, height,
            d * strip_h, h, w, ah, aw, h_min, n_samples, n_coarse,
            use_shadow))
    return _gather_frame(mesh, outs)
