"""Heightfield band sharding with halo overlap over a device list (torch).

Port of moonrtx_tpu/parallel/hfshard.py. Each device stores a latitude
band of the big pyramid levels, rows [d*H/N, (d+1)*H/N + BAND_HALO), so
per-device memory falls about N-fold. Rays never read the map directly:
the march and shading read per-block windows at most 40 rows tall, so
with a halo of BAND_HALO >= the window height every window whose origin
row lies in band d is covered by d's band and halo, and each window has
exactly one owner. Each device extracts its owned windows for every image
block (non-owned windows zeroed), and one reduce-scatter along the block
axis both sums the disjoint contributions and leaves device d holding its
image strip's windows.

The shadow scan stays on its coarse level (replicated; phi-wedge-sharded
separately in parallel/tiles.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from moonrtx_tpu_torch.engine import blocked
from moonrtx_tpu_torch.parallel.mesh import Mesh, reduce_scatter, stack_shards

# Halo rows appended below each band. Must cover the tallest window
# (WIN_H == AWIN_H == 40).
BAND_HALO = 48


def band_heights(h: int, n_dev: int) -> tuple[int, int]:
    """(rows owned per device, rows stored per device) for an h-row level."""
    if h % n_dev:
        raise ValueError(f"level height {h} not divisible by {n_dev} devices")
    band_h = h // n_dev
    # band_h < BAND_HALO is allowed (bands overlap heavily, no memory
    # saved, but correct; the parity tests band small maps this way)
    return band_h, band_h + BAND_HALO


def shard_bands(mesh: Mesh, level: np.ndarray) -> list:
    """A level as per-device bands: device d gets rows [d*band_h,
    d*band_h + band_h + BAND_HALO) of the host level, (band_h+HALO, W[,
    ch]), built on its own device from the host rows, so the whole level
    never has to fit one device. The last band's halo rows (past the
    south edge) are zero-filled; window origins never exceed H - WIN_H,
    so they are never read."""
    n_dev = mesh.size
    h = level.shape[0]
    band_h, bh = band_heights(h, n_dev)
    dtype = torch.from_numpy(np.empty(0, level.dtype)).dtype
    out = []
    for d, dev in enumerate(mesh.devices):
        r0 = d * band_h
        rows = min(r0 + bh, h) - r0
        band = torch.empty((bh,) + level.shape[1:], dtype=dtype, device=dev)
        band[:rows].copy_(torch.from_numpy(
            np.ascontiguousarray(level[r0:r0 + rows])))
        band[rows:].zero_()
        out.append(band)
    return out


def _mask_blocks(x, own, packed_group: Optional[int]):
    """Zero non-owned windows. x is either (nblk, ...) per-block layout or
    the kernel-packed (ns, GROUP*rows, cols) layout (packed_group)."""
    if packed_group is None:
        return x * own.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)
    ns, gr, cols = x.shape
    rows = gr // packed_group
    xg = x.reshape(ns, packed_group, rows, cols)
    m = own.reshape(ns, packed_group, 1, 1).to(x.dtype)
    return (xg * m).reshape(ns, gr, cols)


def _band_local(org, d: int, band_hs, a_band_hs, n_mips: int, n_alb: int):
    """(band-local origins, height ownership, albedo ownership) of the
    full-frame window origins on device d: the device owns a window when
    its origin row falls in its band."""
    dev = org.r0.device
    qexp = torch.round(torch.log2(org.q)).to(torch.int32)
    qi = torch.clamp(qexp, 0, n_mips - 1).long()
    aqi = torch.clamp(qexp, 0, n_alb - 1).long()
    bh = torch.tensor(band_hs, dtype=torch.int32, device=dev)[qi]
    abh = torch.tensor(a_band_hs, dtype=torch.int32, device=dev)[aqi]
    r_loc = org.r0 - d * bh
    ar_loc = org.ar0 - d * abh
    own_h = (r_loc >= 0) & (r_loc < bh)
    own_a = (ar_loc >= 0) & (ar_loc < abh)
    org_loc = org._replace(r0=torch.minimum(torch.clamp(r_loc, min=0), bh),
                           ar0=torch.minimum(torch.clamp(ar_loc, min=0),
                                             abh))
    return org_loc, own_h, own_a


def render_burst_pallas_hfshard(mesh: Mesh, banded_mips, banded_albedo,
                                maxmap, basis, fp, jitters, height: int,
                                width: int, h: int, w: int, ah: int, aw: int,
                                h_min: float, shadow_map=None,
                                smap_params=None, bounce_map=None,
                                n_samples: int = 8, n_coarse: int = 12,
                                use_shadow: bool = True, h_scale: float = 1.0,
                                h_offset: float = 0.0, a_scale: float = 1.0,
                                slope_maps=None, return_caches: bool = False,
                                background=None, use_bg: bool = False,
                                max_qexp: int = 1):
    """The march-kernel burst with the heightfield banded, not just the
    image: banded_mips/banded_albedo are tuples (render level, next
    coarser level) of per-device band lists (shard_bands).

    Per device: full-frame ray geometry (the same cheap math on every
    device), window origins made band-local with their ownership, masked
    extraction of the owned windows for every block (K1); then one
    reduce-scatter along the block axis assembles each strip's window
    caches; then, per strip, shadow windows (K1), pack and the strip
    burst (K2, warm-started). Returns (rgb_mean, hitbuf) of the whole
    frame on the first device, plus with return_caches the strips'
    (origins, cache, packed) as NamedTuples of per-device lists: once
    assembled the strip caches no longer depend on the map layout, so the
    cached time-step and accumulate programs (parallel/tiles.py) drive
    banded scenes too."""
    from moonrtx_tpu_torch.parallel.tiles import (
        _bg_strip,
        _gather_frame,
        _on,
        _strip_burst,
        _strip_height,
    )

    n_dev = mesh.size
    strip_h = _strip_height(mesh, height)
    nblk_full = (height // blocked.BLOCK_H) * (width // blocked.BLOCK_W)
    nblk_s = nblk_full // n_dev
    if nblk_s % blocked.GROUP:
        raise ValueError("strip block count must fill march-kernel groups")
    band_hs = tuple(int(bm[0].shape[0]) - BAND_HALO for bm in banded_mips)
    a_band_hs = tuple(int(bm[0].shape[0]) - BAND_HALO
                      for bm in banded_albedo)
    mip_pad_w = banded_mips[0][0].shape[1]
    a_pad_w = banded_albedo[0][0].shape[1]
    use_sh = use_shadow and shadow_map is not None

    # every device: full-frame origins and its owned windows
    geoms, orgs, hwins, hmeans, awins = [], [], [], [], []
    for d in range(n_dev):
        on = _on(mesh, d)
        geom = blocked.block_rays(on(basis), on(fp).rotation, on(jitters)[0],
                                  height, width, h_min, maxmap=on(maxmap),
                                  image_dirs=False)
        org = blocked.window_origins(geom, h, w, mip_pad_w, ah, aw, a_pad_w,
                                     max_qexp=max_qexp,
                                     slope_maps=on(slope_maps))
        org_loc, own_h, own_a = _band_local(org, d, band_hs, a_band_hs,
                                            len(banded_mips),
                                            len(banded_albedo))
        cache = blocked.extract_window_cache(
            tuple(bm[d] for bm in banded_mips),
            tuple(ba[d] for ba in banded_albedo), org_loc,
            h_scale=h_scale, h_offset=h_offset, a_scale=a_scale)
        hwins.append(_mask_blocks(cache.hwin, own_h, None))
        hmeans.append(cache.hmean * own_h[:, None].to(cache.hmean.dtype))
        awins.append(_mask_blocks(
            cache.awin, own_a,
            blocked.GROUP if cache.awin.ndim == 3 else None))
        geoms.append(geom)
        orgs.append(org)

    # one reduce-scatter per cache tensor: contributions are disjoint (sum
    # == select) and device d receives its image strip's blocks (blocks
    # are row-major, so strips are contiguous block ranges)
    caches = [blocked.WindowCache(hwin=hw, hmean=hm, awin=aw_)
              for hw, hm, aw_ in zip(reduce_scatter(hwins, 0),
                                     reduce_scatter(hmeans, 0),
                                     reduce_scatter(awins, 0))]
    del hwins, hmeans, awins

    outs, org_s_all, packs = [], [], []
    for d, dev in enumerate(mesh.devices):
        on = _on(mesh, d)
        s0 = d * nblk_s

        def blk(x):
            return None if x is None else x[s0:s0 + nblk_s]

        # strip-local slices of the full-frame geometry and origins
        org_s = blocked.WindowOrigins(*[blk(x) for x in orgs[d]])
        g = geoms[d]
        geom_s = blocked.RayGeom(
            db=blk(g.db), ob=g.ob, t_enter=blk(g.t_enter),
            t_end=blk(g.t_end), hit_outer=blk(g.hit_outer),
            dirs_scene=None, h_bound=blk(g.h_bound))
        bas, fpd, mx, jit = on(basis), on(fp), on(maxmap), on(jitters)
        sp = on(smap_params)
        sw = (blocked.build_shadow_windows(on(shadow_map), sp, geom_s,
                                           bounce_map=on(bounce_map))
              if use_sh else None)
        packed = blocked.pack_windows(caches[d], org_s, sw)
        outs.append(_strip_burst(
            packed, sp, _bg_strip(background, use_bg, d, strip_h, dev), mx,
            bas, fpd, jit, strip_h, width, height, d * strip_h, h, w, ah, aw,
            h_min, n_samples, n_coarse, use_sh))
        org_s_all.append(org_s)
        packs.append(packed)
    rgb, hitbuf = _gather_frame(mesh, outs)
    if return_caches:
        return (rgb, hitbuf, stack_shards(org_s_all), stack_shards(caches),
                stack_shards(packs))
    return rgb, hitbuf
