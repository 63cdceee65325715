"""Exact terminator shadows via a sun-aligned cylindrical-radius scan,
plus the one-bounce irradiance pyramid (torch).

Port of moonrtx_tpu/ops/shadow_scan.py. For a distant sun along +z of a
sun-aligned frame, a surface point is sunlit iff no point on its sun
meridian with smaller colatitude sticks out further from the sun axis:

    lit(theta, phi)  <=>  m(theta, phi) > max_{theta' < theta} m(theta', phi)
    where m = r(theta, phi) * sin(theta)

computed as one exclusive running max per meridian (K3,
ops/shadow_prefix.py) over heights resampled onto the scan grid through
per-block windows (K4, ops/extract.py::resample_group_windows; when the
block count does not divide by the resample group, windows cut by K5,
ops/extract.py::extract_windows, and sampled in plain torch). With
``blocked_resample=False`` the scan is the reference's gather resample
and running-max formulation in plain torch ops, the check of the kernel
path. The bounce pyramid runs as hand-written kernels on the card
(csrc/bounce.cu: one pyramid launch and one collapse launch a level, per
bounce) and as plain torch ops on the CPU (bounce_from_parts_plain, the
kernels' yardstick), which the reference computes in XLA.

The scan grid is banded: coarse from the subsolar pole to 75 deg, fine
across the terminator band 75..105 deg; the shadow-accuracy factor
scales the fine band's resolution.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from moonrtx_tpu_torch import constants as C
from moonrtx_tpu_torch import kernels
from moonrtx_tpu_torch.engine.geometry import unit_to_latlon
from moonrtx_tpu_torch.ops import extract as extract_ops
from moonrtx_tpu_torch.ops import sampler
from moonrtx_tpu_torch.ops import shadow_prefix
from moonrtx_tpu_torch.utils.profiling import span

BAND_SPLIT_DEG = 75.0
THETA_MAX_DEG = 105.0
PHI_PAD = 2  # wrapped azimuth columns


class ShadowMapParams(NamedTuple):
    axis_x: torch.Tensor   # (3,) sun-frame x basis (body frame)
    axis_y: torch.Tensor   # (3,)
    axis_z: torch.Tensor   # (3,) unit sun direction (body frame)
    n_coarse: torch.Tensor  # rows in [0, 75) deg
    n_fine: torch.Tensor    # rows in [75, 105] deg
    n_phi: torch.Tensor     # azimuth columns (unpadded)
    sun_ang_radius: torch.Tensor  # radians


def _resolution(accuracy: int) -> tuple[int, int, int]:
    """(n_coarse, n_fine, n_phi) for a shadow-accuracy factor."""
    a = int(np.clip(accuracy, 1, 20))
    n_coarse = 256
    n_fine = int(np.clip(128 * a, 256, 2048))
    n_phi = 2048 if a < 5 else 4096
    return n_coarse, n_fine, n_phi


def _theta_grid(n_coarse: int, n_fine: int) -> np.ndarray:
    """Banded colatitude grid (degrees), coarse then fine, monotone."""
    coarse = np.linspace(0.0, BAND_SPLIT_DEG, n_coarse, endpoint=False)
    fine = np.linspace(BAND_SPLIT_DEG, THETA_MAX_DEG, n_fine)
    return np.concatenate([coarse, fine]).astype(np.float32)


def _theta_to_row(theta_deg, n_coarse, n_fine):
    """Fractional row index of a colatitude on the banded grid."""
    in_coarse = theta_deg < BAND_SPLIT_DEG
    row_c = theta_deg / BAND_SPLIT_DEG * n_coarse
    row_f = (n_coarse
             + (theta_deg - BAND_SPLIT_DEG)
             / (THETA_MAX_DEG - BAND_SPLIT_DEG) * (n_fine - 1.0))
    return torch.where(in_coarse, row_c, row_f)


def _decimate_tex(m):
    """Dtype-preserving 2x2 block mean. Quantized levels keep their affine
    encoding (the mean commutes with value = raw*scale+offset)."""
    m2 = m[: m.shape[0] // 2 * 2, : m.shape[1] // 2 * 2]
    r, c = m2.shape[0] // 2, m2.shape[1] // 2
    if m2.dtype in (torch.int16, torch.uint8):
        acc = m2.to(torch.int32).reshape(r, 2, c, 2).sum(dim=(1, 3))
        return torch.div(acc + 2, 4, rounding_mode="floor").to(m2.dtype)
    return m2.reshape(r, 2, c, 2).mean(dim=(1, 3))


def _resample_heights_blocked(tex, h: int, w: int, row, col,
                              scale: float = 1.0, offset: float = 0.0,
                              group: int = 8):
    """Resample a map at the scan-grid positions through per-block windows.
    Blocks of 8x64 scan cells share one (40, 184) window; a block whose
    texture footprint outgrows the window samples a 2x/4x-decimated
    level. tex may be quantized (int16/uint8, value = raw*scale+offset);
    output is decoded f32.

    When the block count divides by ``group`` the extraction and the
    bilinear are one kernel (K4). Otherwise every level's windows are cut
    by K5, blended by the block's level, mean-centered and sampled with a
    bf16 row mix (the reference's ungrouped branch).

    row/col: (n_theta, n_phi) fractional source coordinates."""
    BH, BW, WH_, WW_ = 8, 64, 40, 184
    n_theta, n_phi = row.shape
    nb = (n_theta // BH) * (n_phi // BW)
    dev = row.device

    def to_b(x):
        v = x.reshape(n_theta // BH, BH, n_phi // BW, BW)
        return torch.movedim(v, 2, 1).reshape(nb, BH * BW)

    rb = to_b(row)
    cb = to_b(col)

    # decimated levels are built from the unpadded circle, then given
    # fresh wrap columns (periodic, so decimate-then-wrap is exact);
    # levels smaller than the window are unusable (small test maps)
    def _wrapped(m):
        return torch.cat([m, m[:, : min(WW_ + 8, m.shape[1])]], dim=1)

    half = _decimate_tex(tex[:, :w])
    levels = [tex, _wrapped(half), _wrapped(_decimate_tex(half))]
    while len(levels) > 1 and (levels[-1].shape[0] < WH_
                               or levels[-1].shape[1] < WW_):
        levels.pop()
    max_qexp = len(levels) - 1.0

    _, _, r_span, c_span = sampler.block_footprint(rb, cb, w)
    ratio = torch.clamp(torch.maximum(r_span / (WH_ - 4.0),
                                      c_span / (WW_ - 4.0)), min=1.0)
    qexp = torch.clamp(torch.ceil(torch.log2(ratio)),
                       0.0, max_qexp).to(torch.int32)
    q = torch.exp2(qexp.to(torch.float32))
    rq = (rb + 0.5) / q[:, None] - 0.5
    cq = (cb + 0.5) / q[:, None] - 0.5
    hs_ = torch.tensor([l.shape[0] for l in levels], dtype=torch.int32,
                       device=dev)
    ws_ = torch.tensor([l.shape[1] for l in levels], dtype=torch.int32,
                       device=dev)
    r0, c0 = sampler.window_origin_from_footprint(
        rq, cq, w / q, WH_, WW_, hs_[qexp.long()], ws_[qexp.long()])
    # seam blocks: unwrap points left of the window origin
    cq = torch.where(cq < c0[:, None].to(cq.dtype) - 0.5,
                     cq + (w / q)[:, None], cq)
    wy = rq - r0[:, None].to(rq.dtype)
    wx = cq - c0[:, None].to(cq.dtype)
    if nb % group == 0:
        vals = extract_ops.resample_group_windows(
            levels, qexp, r0, c0, wy, wx, WH_, WW_, scale=scale,
            offset=offset, group=group)
    else:
        per = [extract_ops.extract_windows(
            lvl, torch.clamp(r0, max=lvl.shape[0] - WH_),
            torch.clamp(c0, max=lvl.shape[1] - WW_), WH_, WW_,
            scale=scale, offset=offset) for lvl in levels]
        wins = per[-1]
        for li in range(len(per) - 2, -1, -1):
            wins = torch.where((qexp == li)[:, None, None], per[li], wins)
        mean = torch.mean(wins, dim=(1, 2))[:, None]
        # mean-centered residuals survive the bf16 row mix
        vals = sampler.window_bilinear(wins - mean[..., None], wy, wx,
                                       mix_dtype=torch.bfloat16) + mean
    v = vals.reshape(n_theta // BH, n_phi // BW, BH, BW)
    return torch.movedim(v, 1, 2).reshape(n_theta, n_phi)


def _scan_dirs(sun_basis, theta, phi):
    st, ct = torch.sin(theta), torch.cos(theta)
    return (sun_basis[2][None, None, :] * ct[..., None]
            + sun_basis[0][None, None, :] * (st * torch.cos(phi))[..., None]
            + sun_basis[1][None, None, :] * (st * torch.sin(phi))[..., None])


def half_grid_ok(n_coarse: int, n_fine: int, n_phi: int) -> bool:
    """True when the half-resolution albedo-resample grid exists for this
    scan resolution (scan_wedge's fast albedo path and bounce_refresh)."""
    return (n_coarse + n_fine) % 16 == 0 and n_phi % 128 == 0


def resample_alb_half(alb_lum, sun_basis, h: int, w: int, n_coarse: int,
                      n_fine: int, n_phi_total: int, phi0, n_phi: int):
    """Albedo-luminance on the scan grid via a half-resolution resample +
    nearest upsample (the bounce emitter field is blurred over >= 2-cell
    scales, so half resolution costs no accuracy)."""
    dev = alb_lum.device
    theta = torch.as_tensor(np.deg2rad(_theta_grid(n_coarse, n_fine)),
                            device=dev)[:, None]
    th_h = 0.5 * (theta[0::2, 0] + theta[1::2, 0])[:, None]
    ph_h = ((2 * np.pi) * (2.0 * torch.arange(n_phi // 2, dtype=torch.float32,
                                              device=dev)[None, :]
                           + phi0 + 1.0) / n_phi_total)
    lat_h, lon_h = unit_to_latlon(_scan_dirs(sun_basis, th_h, ph_h))
    row_h, col_h = sampler.latlon_to_rowcol(lat_h, lon_h, h, w)
    alb_h = _resample_heights_blocked(alb_lum, h, w, row_h, col_h)
    # nearest upsample (no blur): keeps wedge-sharded scans seam-free
    return torch.repeat_interleave(torch.repeat_interleave(alb_h, 2, dim=0),
                                   2, dim=1)


def _running_max_factor(hs, st, ct, sun_ang_radius: float):
    """Penumbra factor from an exclusive running max of (m, z) along theta
    in plain torch ops (the reference's associative scan): the blocker is
    the earliest row that reaches the running maximum of m (a later equal
    key does not replace it, the reference's tie rule)."""
    n_theta, n_phi = hs.shape
    r = C.MOON_RADIUS * hs
    m = r * st
    z = r * ct
    neg = torch.full((1, n_phi), -1.0, dtype=m.dtype, device=m.device)
    m_pad = torch.cat([neg, m[:-1]], dim=0)
    z_pad = torch.cat([torch.zeros_like(neg), z[:-1]], dim=0)
    m_max = torch.cummax(m_pad, dim=0)[0]
    # first row whose key equals the running max: a strict new maximum
    rows = torch.arange(n_theta, device=m.device)[:, None].expand_as(m_pad)
    prev = torch.cat([torch.full_like(neg, -float("inf")), m_max[:-1]],
                     dim=0)
    at = torch.cummax(torch.where(m_pad > prev, rows, 0), dim=0)[0]
    z_at = torch.gather(z_pad, 0, at)
    dz = torch.clamp(z_at - z, min=1e-6)
    alpha = torch.atan2(m_max - m, dz)
    factor = torch.clamp(0.5 - alpha / (2.0 * sun_ang_radius), 0.0, 1.0)
    # subsolar cap: no blockers possible at theta ~ 0
    return torch.where(m_max < 0.0, 1.0, factor)


def scan_wedge(tex, sun_basis, sun_ang_radius: float, h: int, w: int,
               n_coarse: int, n_fine: int, n_phi_total: int, phi0,
               n_phi: int, blocked_resample: bool = False, alb_lum=None,
               h_scale: float = 1.0, h_offset: float = 0.0,
               return_heights: bool = False, resample_group: int = 8):
    """Scan an azimuth wedge [phi0, phi0 + n_phi) of the sun-frame grid.

    blocked_resample=True (what build_shadow_map and
    build_shadow_and_bounce pass) resamples through per-block windows and
    takes the prefix-max kernel (K3), raising for a grid it does not take;
    False is the gather resample with the running max in plain torch ops.

    Returns the factor map; (factor, heights) with return_heights; or
    (factor, heights, albedo_lum) with alb_lum (an albedo-luminance map at
    the same (h, w) level) for the one-bounce irradiance map
    (bounce_from_parts)."""
    dev = tex.device
    theta = torch.as_tensor(np.deg2rad(_theta_grid(n_coarse, n_fine)),
                            device=dev)[:, None]
    phi = ((2 * np.pi) * (torch.arange(n_phi, dtype=torch.float32,
                                       device=dev)[None, :]
                          + phi0 + 0.5) / n_phi_total)
    st, ct = torch.sin(theta), torch.cos(theta)
    lat, lon = unit_to_latlon(_scan_dirs(sun_basis, theta, phi))
    row, col = sampler.latlon_to_rowcol(lat, lon, h, w)
    n_theta = int(theta.shape[0])
    if blocked_resample:
        hs = _resample_heights_blocked(tex, h, w, row, col, scale=h_scale,
                                       offset=h_offset, group=resample_group)
    else:
        # the gather promotes raw int values per fetch; the decode commutes
        # with the bilinear because its weights sum to 1
        hs = extract_ops.decode_affine(
            sampler.gather_bilinear(tex, row, col), h_scale, h_offset)
    if blocked_resample:
        # the kernel path never drops to the plain running max by itself
        if not shadow_prefix.prefix_ok(n_theta, n_phi):
            raise ValueError(f"unsupported scan grid ({n_theta}, {n_phi})")
        factor = shadow_prefix.shadow_factor(hs, st, ct, sun_ang_radius,
                                             C.MOON_RADIUS)
    else:
        factor = _running_max_factor(hs, st, ct, sun_ang_radius)
    if alb_lum is None:
        return (factor, hs) if return_heights else factor
    if blocked_resample and half_grid_ok(n_coarse, n_fine, n_phi):
        alb_s = resample_alb_half(alb_lum, sun_basis, h, w, n_coarse,
                                  n_fine, n_phi_total, phi0, n_phi)
    elif blocked_resample:
        alb_s = _resample_heights_blocked(alb_lum, h, w, row, col)
    else:
        alb_s = sampler.gather_bilinear(alb_lum, row, col)
    return factor, hs, alb_s


def _box_blur(x, s: int):
    """(2s+1)-cell separable box mean over the last two dims; columns
    (phi) wrap, rows clamp."""
    inv = 1.0 / (2 * s + 1)
    acc = x
    for d in range(1, s + 1):
        acc = acc + torch.roll(x, d, dims=-1) + torch.roll(x, -d, dims=-1)
    x1 = acc * inv
    acc = x1
    for d in range(1, s + 1):
        up = torch.cat([x1[..., d:, :],
                        x1[..., -1:, :].expand(*x1.shape[:-2], d,
                                               x1.shape[-1])], dim=-2)
        dn = torch.cat([x1[..., :1, :].expand(*x1.shape[:-2], d,
                                              x1.shape[-1]),
                        x1[..., :-d, :]], dim=-2)
        acc = acc + up + dn
    return acc * inv


# one-bounce pyramid: per-level blur radius (cells), level count bound,
# smallest level size, and irradiance cap
BOUNCE_BLUR = 2
BOUNCE_MAX_LEVELS = 7
BOUNCE_MIN_SIZE = 16
BOUNCE_MAX = 0.5

# Mean radiosity of the sub-horizon band relative to the horizon
# blocker's (calibrated against converged Monte Carlo in the reference,
# docs/GI.md).
BOUNCE_WALL_LIT_FRACTION = 0.5


def _decimate2(x):
    r, c = x.shape
    return x.reshape(r // 2, 2, c // 2, 2).mean(dim=(1, 3))


def _decimate2_max(x):
    r, c = x.shape
    return x.reshape(r // 2, 2, c // 2, 2).amax(dim=(1, 3))


def _shift_rows(x, d: int):
    """x shifted so cell i sees x[i - d] (edge rows clamp)."""
    if d == 0:
        return x
    if d > 0:
        return torch.cat([x[:1].expand(d, *x.shape[1:]), x[:-d]], dim=0)
    return torch.cat([x[-d:], x[-1:].expand(-d, *x.shape[1:])], dim=0)


def _sector_collapse(hs, rad, theta0, dphi, n_levels: int):
    """Directional-sector horizon machinery of the bounce pass: for each
    of eight 45-deg azimuthal sectors, estimate the horizon angle on a
    dyadic pyramid and carry the radiosity of the blocker that sets it;
    collapse coarse -> fine per sector by the largest horizon angle
    (sin^2 alpha). Returns (s2_acc (8, nt, np), j_acc (8, nt, np))."""
    dev = hs.device
    s = BOUNCE_BLUR
    theta_k, h_k, hx_k, rad_k = theta0, hs, hs, rad
    contributions = []
    for k in range(n_levels):
        dth_k = torch.as_tensor(np.maximum(np.gradient(theta_k), 1e-6)
                                .astype(np.float32), device=dev)[:, None]
        st_k = torch.as_tensor(np.sin(theta_k).astype(np.float32),
                               device=dev)[:, None]
        dl_phi = torch.minimum(torch.maximum(dphi * (2 ** k) * st_k,
                                             dth_k * 0.25), dth_k * 4.0)
        rad_b = _box_blur(rad_k, s)
        h_blk = 0.5 * (hx_k + h_k)
        run_diag = torch.sqrt(dth_k * dth_k + dl_phi * dl_phi)
        sector_s2, sector_j = [], []
        for dth, dph, run in ((s, 0, dth_k), (-s, 0, dth_k),
                              (0, s, dl_phi), (0, -s, dl_phi),
                              (s, s, run_diag), (s, -s, run_diag),
                              (-s, s, run_diag), (-s, -s, run_diag)):
            def shift(x, mul, _dt=dth, _dp=dph):
                if _dp:
                    x = torch.roll(x, mul * _dp, dims=1)
                return _shift_rows(x, mul * _dt) if _dt else x
            t1 = torch.clamp(shift(h_blk, 1) - h_k, min=0.0) / (s * run)
            t2 = torch.clamp(shift(h_blk, 2) - h_k, min=0.0) / (2 * s * run)
            s2_1 = t1 * t1 / (1.0 + t1 * t1)
            s2_2 = t2 * t2 / (1.0 + t2 * t2)
            far = s2_2 > s2_1
            sector_s2.append(torch.where(far, s2_2, s2_1))
            sector_j.append(torch.where(far, shift(rad_b, 2),
                                        shift(rad_b, 1)))
        contributions.append((torch.stack(sector_s2), torch.stack(sector_j)))
        if k + 1 < n_levels:
            theta_k = 0.5 * (theta_k[::2] + theta_k[1::2])
            h_k = _decimate2(h_k)
            hx_k = _decimate2_max(hx_k)
            rad_k = _decimate2(rad_k)

    s2_acc, j_acc = contributions[-1]
    for k in range(n_levels - 2, -1, -1):
        def up(a):
            a = torch.repeat_interleave(torch.repeat_interleave(a, 2, dim=1),
                                        2, dim=2)
            return _box_blur(a, 1)
        s2_acc, j_acc = up(s2_acc), up(j_acc)
        s2_f, j_f = contributions[k]
        take_f = s2_f > s2_acc
        s2_acc = torch.where(take_f, s2_f, s2_acc)
        j_acc = torch.where(take_f, j_f, j_acc)
    return s2_acc, j_acc


def bounce_levels(n_theta: int, n_phi: int) -> int:
    """Levels of the bounce pyramid on an (n_theta, n_phi) scan grid:
    halve while both sides divide and the smaller stays >= 16 cells."""
    n_levels = 1
    while (n_levels < BOUNCE_MAX_LEVELS
           and n_theta % (2 ** n_levels) == 0
           and n_phi % (2 ** n_levels) == 0
           and min(n_theta, n_phi) // (2 ** n_levels) >= BOUNCE_MIN_SIZE):
        n_levels += 1
    return n_levels


def bounce_from_parts_plain(hs, factor, alb_s, n_coarse: int, n_fine: int,
                            n_phi: int, n_bounces: int = 1):
    """Plain PyTorch version of bounce_from_parts (the CPU path, and the
    kernels' yardstick on the card)."""
    dev = hs.device
    theta0 = np.deg2rad(_theta_grid(n_coarse, n_fine)).astype(np.float32)
    dphi = 2.0 * np.pi / n_phi
    st0 = np.sin(theta0).astype(np.float32)
    ct0 = torch.as_tensor(np.cos(theta0), device=dev)[:, None]
    dth0 = np.gradient(theta0).astype(np.float32)

    # terrain n.l toward the sun (+z of the sun frame) from grid slopes
    s_th = torch.gradient(hs, dim=0)[0] / (
        torch.as_tensor(dth0, device=dev)[:, None] * hs)
    # phi is periodic: wrapped central differences
    dh_ph = 0.5 * (torch.roll(hs, -1, dims=1) - torch.roll(hs, 1, dims=1))
    s_ph = dh_ph / (dphi * torch.as_tensor(np.maximum(st0, 0.05),
                                           device=dev)[:, None] * hs)
    ndl = (ct0 + s_th * torch.as_tensor(st0, device=dev)[:, None]) \
        * torch.rsqrt(1.0 + s_th * s_th + s_ph * s_ph)
    rad = alb_s * torch.clamp(ndl, 0.0, 1.0) * factor

    n_levels = bounce_levels(n_coarse + n_fine, n_phi)
    scale = BOUNCE_WALL_LIT_FRACTION / 8.0
    s2_acc, j_acc = _sector_collapse(hs, rad, theta0, dphi, n_levels)
    e1 = scale * torch.sum(s2_acc * j_acc, dim=0)
    if n_bounces < 2:
        return torch.clamp(e1, 0.0, BOUNCE_MAX)
    s2_acc2, j2_acc = _sector_collapse(hs, alb_s * e1, theta0, dphi,
                                       n_levels)
    e2 = scale * torch.sum(s2_acc2 * j2_acc, dim=0)
    return torch.clamp(e1 + e2, 0.0, BOUNCE_MAX)


BOUNCE_TILE = 64   # the pyramid kernel's level-0 tile (csrc/bounce.cu PT)


def bounce_ok(n_theta: int, n_phi: int) -> bool:
    """True for the scan grids the bounce kernels tile: both sides
    multiples of 64, so a 64x64 level-0 tile holds every level of a
    7-level pyramid (every grid of _resolution, wedges gathered)."""
    return (n_theta > 0 and n_phi > 0 and n_theta % BOUNCE_TILE == 0
            and n_phi % BOUNCE_TILE == 0)


def bounce_rows(n_coarse: int, n_fine: int, n_phi: int) -> np.ndarray:
    """The bounce kernels' per-row arrays, float32, as the plain version
    forms them: level 0's dth0, st0, dphi * max(st0, 0.05) and ct0, then
    per level k its dth_k, dl_phi_k and diagonal run (csrc/bounce.cu
    layout_of). Host arithmetic: numpy on the plain version's float32
    arrays, each product and sum of a float32 pair rounded once as torch
    rounds it."""
    f = np.float32
    theta0 = np.deg2rad(_theta_grid(n_coarse, n_fine)).astype(f)
    dphi = 2.0 * np.pi / n_phi
    st0 = np.sin(theta0).astype(f)
    parts = [np.gradient(theta0).astype(f), st0,
             f(dphi) * np.maximum(st0, f(0.05)), np.cos(theta0).astype(f)]
    theta_k = theta0
    for k in range(bounce_levels(n_coarse + n_fine, n_phi)):
        if k:
            theta_k = f(0.5) * (theta_k[::2] + theta_k[1::2])
        dth_k = np.maximum(np.gradient(theta_k), 1e-6).astype(f)
        st_k = np.sin(theta_k).astype(f)
        dl_phi = np.minimum(np.maximum(f(dphi * (2 ** k)) * st_k,
                                       dth_k * f(0.25)), dth_k * f(4.0))
        parts += [dth_k, dl_phi, np.sqrt(dth_k * dth_k + dl_phi * dl_phi)]
    return np.concatenate(parts).astype(f)


class _BounceArgs(ctypes.Structure):
    _fields_ = [("hs", ctypes.c_void_p), ("factor", ctypes.c_void_p),
                ("alb", ctypes.c_void_p), ("rows", ctypes.c_void_p),
                ("scratch", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("nt", ctypes.c_int), ("np", ctypes.c_int),
                ("n_levels", ctypes.c_int), ("n_bounces", ctypes.c_int),
                ("scale", ctypes.c_float), ("e_max", ctypes.c_float)]


_rows_on_device: dict = {}   # (n_coarse, n_fine, n_phi, device) -> rows


# no pallas_call: the JAX package's pyramid is jnp code XLA fuses
@kernels.register("bounce", "mrtx_bounce", _BounceArgs,
                  passes=("bounce_pyramid_kernel", "bounce_collapse_kernel"),
                  plain=bounce_from_parts_plain,
                  replaces="moonrtx_tpu/ops/shadow_scan.py:447")
@span("scene.bounce")
def bounce_from_parts(hs, factor, alb_s, n_coarse: int, n_fine: int,
                      n_phi: int, n_bounces: int = 1):
    """Terrain interreflection map on the scan grid (1 or 2 bounces): a
    dense radiosity estimate E = (1/8) sum_d J_d sin^2(alpha_d) over eight
    directional sectors, with J = albedo * n.l * lit from scan-grid height
    slopes (see the reference's docstring for the physics).

    hs, factor, alb_s: (n_coarse + n_fine, n_phi) f32. On the card, one
    pyramid launch and one collapse launch a level per bounce
    (csrc/bounce.cu), raising for a grid bounce_ok refuses; on the CPU
    the plain version. Returns (n_theta, n_phi) f32 in [0, BOUNCE_MAX]."""
    call = dict(locals())
    if hs.device.type == "cpu":
        return bounce_from_parts_plain(hs, factor, alb_s, n_coarse, n_fine,
                                       n_phi, n_bounces)
    n_theta = n_coarse + n_fine
    if not bounce_ok(n_theta, n_phi):
        raise ValueError(f"unsupported bounce grid ({n_theta}, {n_phi}): "
                         f"both sides must be multiples of {BOUNCE_TILE}")
    for t in (hs, factor, alb_s):
        if t.shape != (n_theta, n_phi) or t.dtype != torch.float32:
            raise ValueError(f"bounce inputs must be ({n_theta}, {n_phi}) "
                             "f32")
        if t.device != hs.device:
            raise ValueError("bounce inputs must share a device")
    key = (n_coarse, n_fine, n_phi, hs.device)
    rows = _rows_on_device.get(key)
    if rows is None:
        rows = torch.as_tensor(bounce_rows(n_coarse, n_fine, n_phi),
                               device=hs.device)
        _rows_on_device[key] = rows
    n_levels = bounce_levels(n_theta, n_phi)
    passes = 2 if n_bounces >= 2 else 1
    scratch_size = kernels.entry("bounce", "mrtx_bounce_scratch",
                                 (ctypes.c_int,) * 4, ctypes.c_longlong)
    hs, factor, alb_s = (t.contiguous() for t in (hs, factor, alb_s))
    scratch = torch.empty(scratch_size(n_theta, n_phi, n_levels, passes),
                          dtype=torch.float32, device=hs.device)
    out = torch.empty_like(hs)
    a = _BounceArgs(hs.data_ptr(), factor.data_ptr(), alb_s.data_ptr(),
                    rows.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                    n_theta, n_phi, n_levels, passes,
                    BOUNCE_WALL_LIT_FRACTION / 8.0, BOUNCE_MAX)
    kernels.launch(bounce_from_parts, a, out, call)
    return out


def sun_frame_basis(sun_dir_body):
    """Orthonormal (x, y, z) with z = unit sun direction (body frame)."""
    z = sun_dir_body / torch.sqrt(torch.sum(sun_dir_body * sun_dir_body))
    helper = (torch.tensor([0.0, 0.0, 1.0]) if abs(float(z[2])) < 0.9
              else torch.tensor([1.0, 0.0, 0.0])).to(z)
    x = torch.linalg.cross(helper, z)
    x = x / torch.sqrt(torch.sum(x * x))
    y = torch.linalg.cross(z, x)
    return x, y, z


def _params(basis, n_coarse, n_fine, n_phi, sun_ang_radius):
    f = torch.float32
    dev = basis.device
    return ShadowMapParams(
        axis_x=basis[0], axis_y=basis[1], axis_z=basis[2],
        n_coarse=torch.tensor(n_coarse, dtype=f, device=dev),
        n_fine=torch.tensor(n_fine, dtype=f, device=dev),
        n_phi=torch.tensor(n_phi, dtype=f, device=dev),
        sun_ang_radius=torch.tensor(sun_ang_radius, dtype=f, device=dev))


def build_shadow_map(tex, h: int, w: int, sun_dir_body, sun_ang_radius: float,
                     accuracy: int = 10, h_scale: float = 1.0,
                     h_offset: float = 0.0):
    """(shadow_map, ShadowMapParams) for the current sun direction.

    tex: padded heightfield mip (f32 or quantized int16 with affine
    h_scale/h_offset); sun_dir_body: (3,) unit, body frame."""
    n_coarse, n_fine, n_phi = _resolution(accuracy)
    basis = torch.stack(sun_frame_basis(sun_dir_body))
    factor = scan_wedge(tex, basis, sun_ang_radius, h, w, n_coarse, n_fine,
                        n_phi, 0, n_phi, blocked_resample=True,
                        h_scale=h_scale, h_offset=h_offset)
    smap = torch.cat([factor, factor[:, :PHI_PAD]], dim=1)
    return smap, _params(basis, n_coarse, n_fine, n_phi, sun_ang_radius)


def build_shadow_and_bounce(tex, alb_lum, h: int, w: int, sun_dir_body,
                            sun_ang_radius: float, accuracy: int = 10,
                            h_scale: float = 1.0, h_offset: float = 0.0,
                            n_bounces: int = 1):
    """build_shadow_map plus the indirect-light irradiance map on the same
    grid: returns (shadow_map, ShadowMapParams, bounce_map)."""
    n_coarse, n_fine, n_phi = _resolution(accuracy)
    basis = torch.stack(sun_frame_basis(sun_dir_body))
    factor, hs, alb_s = scan_wedge(tex, basis, sun_ang_radius, h, w,
                                   n_coarse, n_fine, n_phi, 0, n_phi,
                                   blocked_resample=True, alb_lum=alb_lum,
                                   h_scale=h_scale, h_offset=h_offset)
    smap = torch.cat([factor, factor[:, :PHI_PAD]], dim=1)
    bounce = bounce_from_parts(hs, factor, alb_s, n_coarse, n_fine, n_phi,
                               n_bounces=n_bounces)
    bmap = torch.cat([bounce, bounce[:, :PHI_PAD]], dim=1)
    return smap, _params(basis, n_coarse, n_fine, n_phi, sun_ang_radius), bmap


def rowcol_of_points(params: ShadowMapParams, n_phi: int, p_body):
    """Fractional (row, col) scan-grid coordinates of body-frame points.
    Rows clamp to the grid; points past THETA_MAX land on the last row."""
    zc = torch.sum(p_body * params.axis_z, dim=-1)
    xc = torch.sum(p_body * params.axis_x, dim=-1)
    yc = torch.sum(p_body * params.axis_y, dim=-1)
    rho = torch.sqrt(xc * xc + yc * yc)
    theta = torch.rad2deg(torch.atan2(rho, zc))
    phi = torch.remainder(torch.atan2(yc, xc), 2 * np.pi)
    row = _theta_to_row(theta, params.n_coarse, params.n_fine)
    row = torch.minimum(torch.clamp(row, min=0.0),
                        params.n_coarse + params.n_fine - 1.001)
    col = phi / (2 * np.pi) * n_phi - 0.5
    col = torch.where(col < 0.0, col + n_phi, col)
    return row, col


def shadow_lookup(shadow_map, params: ShadowMapParams, p_body):
    """Sample the shadow factor at body-frame surface points (..., 3)
    (gather path; the blocked backend uses per-block shadow windows)."""
    n_phi = shadow_map.shape[1] - PHI_PAD
    row, col = rowcol_of_points(params, n_phi, p_body)
    zc = torch.sum(p_body * params.axis_z, dim=-1)
    rho = torch.sqrt(torch.sum(p_body * p_body, dim=-1) - zc * zc)
    theta = torch.rad2deg(torch.atan2(rho, zc))
    val = sampler.gather_bilinear(shadow_map, row, col)
    # beyond the scanned band it is deep night side
    return torch.where(theta >= THETA_MAX_DEG, 0.0, val)


def bounce_refresh(smap, hs, alb_lum, sun_basis, h: int, w: int,
                   n_coarse: int, n_fine: int, n_phi: int,
                   n_bounces: int = 1):
    """Rebuild the one-bounce irradiance map from an already-scanned
    (smap, hs) pair: the half-resolution albedo resample (K4 on the f32
    luminance) and the bounce pyramid. Queued behind a rendered frame when
    the sun drifts past the reuse threshold (engine/scene.py
    BOUNCE_REUSE_DEG), it reuses that frame's scan instead of a second one.

    Requires half_grid_ok(n_coarse, n_fine, n_phi)."""
    alb_s = resample_alb_half(alb_lum, sun_basis, h, w, n_coarse, n_fine,
                              n_phi, 0, n_phi)
    factor = smap[:, :n_phi]
    bounce = bounce_from_parts(hs, factor, alb_s, n_coarse, n_fine, n_phi,
                               n_bounces=n_bounces)
    return torch.cat([bounce, bounce[:, :PHI_PAD]], dim=1)
