"""Fused per-ray march + shade (K2) — the production render kernel.

Port of moonrtx_tpu/ops/pallas_march.py (``march_shade_pallas``), under a
name that says what it does. One launch renders one accumulation sample:
per 8x128-ray strip (GROUP=8 blocks of 8x16 pixels), a 12-point coarse
march (cold) or a re-bracket at t_prev +- span/12 with a per-strip vote
(warm), Illinois false-position refinement, the footprint-matched normal,
albedo, shadow and bounce from the strip's windows, lunar-Lambert with
the LOD roughness term, eclipse coverage and earthshine.

The kernel (csrc/march_shade.cu) samples the windows directly: a 4-tap
bilinear with the TPU kernel's rounding points is the same function as
its one-hot MXU contraction (window values and one axis of hat weights in
bf16, the other axis in f32, sums in f32). The warm vote is taken over
the whole 1024-ray strip, as on the TPU, so warm samples choose the same
brackets. ``march_shade_plain`` repeats the arithmetic in PyTorch.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from moonrtx_tpu_torch import constants as C
from moonrtx_tpu_torch import kernels
from moonrtx_tpu_torch.ops.ray_setup import block_rays_plain
from moonrtx_tpu_torch.utils import profiling

G = 8                # blocks per strip (engine.blocked.GROUP)
B = 128              # rays per block (engine.blocked.BLOCK)
WH, WW = 40, 64      # height window
AH, AW = 40, 64      # albedo window (channel-major R|G|B columns)
SH, SW = 32, 48      # shadow|bounce window
N_SCAL = 10
MAX_COARSE = 32

RAD2DEG = 180.0 / math.pi

# params vector layout (27, G, B) broadcast rows:
#  0-2 ob xyz | 3-5 light xyz (body) | 6 irradiance | 7 n_smap_coarse
#  8 n_smap_fine | 9 n_phi | 10-12 sun axis z | 13-15 sun axis x
#  16 pixel angular size | 17-18 albedo level rows/cols | 19 lunar-Lambert
#  blend | 20-22 earth dir (body) | 23 earth distance | 24 earth angular
#  radius (0 = eclipse shading off) | 25 sun angular radius | 26
#  earthshine irradiance relative to direct sunlight (0 = off)
N_PARAMS = 27


def atan2_poly(y, x):
    """Vector atan2 of the reference kernels: octant reduction plus a
    degree-11 odd minimax polynomial, ~1e-6 rad max error."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    a = lo / torch.clamp(hi, min=1e-30)
    s = a * a
    r = a * (0.99997726 + s * (-0.33262347 + s * (0.19354346 + s * (
        -0.11643287 + s * (0.05265332 + s * (-0.01172120))))))
    r = torch.where(ay > ax, 0.5 * math.pi - r, r)
    r = torch.where(x < 0.0, math.pi - r, r)
    return torch.where(y < 0.0, -r, r)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _taps(x):
    """Left tap index and the two nonzero hat weights max(0, 1-|j-x|)."""
    x0 = torch.floor(x)
    w0 = torch.clamp(1.0 - torch.abs(x0 - x), min=0.0)
    w1 = torch.clamp(1.0 - torch.abs((x0 + 1.0) - x), min=0.0)
    return x0.long(), w0, w1


class _Windows:
    """Per-block windows flattened for 4-tap sampling; values are rounded
    to bf16 as the kernel samples them."""

    def __init__(self, win, nh: int, stride: int, nblk: int):
        self.flat = _bf16(win.to(torch.float32)).reshape(-1)
        self.nh = nh
        self.stride = stride
        self.blk = torch.arange(nblk, device=win.device).reshape(-1, G, 1)

    def _corners(self, iy, ix, col_off):
        p = self.blk * (self.nh * self.stride) + iy * self.stride + ix \
            + col_off
        f = self.flat
        return f[p], f[p + 1], f[p + self.stride], f[p + self.stride + 1]

    def sample_colbf(self, wy, wx, nw: int, col_off: int = 0):
        """bf16 column weights, f32 row weights (pallas_march._bsample)."""
        wy = torch.clamp(wy, 0.0, self.nh - 1.001)
        wx = torch.clamp(wx, 0.0, nw - 1.001)
        iy, r0, r1 = _taps(wy)
        ix, c0, c1 = _taps(wx)
        c0, c1 = _bf16(c0), _bf16(c1)
        v00, v01, v10, v11 = self._corners(iy, ix, col_off)
        return (v00 * c0 + v01 * c1) * r0 + (v10 * c0 + v11 * c1) * r1

    def sample_rowbf(self, wy, wx, nw: int, col_off: int = 0):
        """bf16 row weights, f32 column weights (the kernel's row-first
        contractions: east/west stencil, albedo, shadow|bounce)."""
        wy = torch.clamp(wy, 0.0, self.nh - 1.001)
        wx = torch.clamp(wx, 0.0, nw - 1.001)
        iy, r0, r1 = _taps(wy)
        ix, c0, c1 = _taps(wx)
        r0, r1 = _bf16(r0), _bf16(r1)
        v00, v01, v10, v11 = self._corners(iy, ix, col_off)
        return (v00 * r0 + v10 * r1) * c0 + (v01 * r0 + v11 * r1) * c1


def march_shade_plain(params, dbx, dby, dbz, t_enter, t_end, active, scal,
                      hwin, awin, swin, h: int, w: int, n_coarse: int = 12,
                      n_bisect: int = 3, use_shadow: bool = True,
                      use_earth: bool = True, t_prev=None, f_prev=None):
    """Plain PyTorch version of march_shade (same contract and rounding
    points). Every ray takes both the warm bracket and the cold march;
    the per-strip vote selects between them."""
    ns = dbx.shape[0]
    nblk = ns * G
    warm = t_prev is not None

    def P(i):
        return params[i]

    obx, oby, obz = P(0), P(1), P(2)
    lxp, lyp, lzp = P(3), P(4), P(5)
    irradiance = P(6)
    r0, c0, hmean, q = scal[:, 0], scal[:, 1], scal[:, 2], scal[:, 3]
    ar0, ac0, sr0, sc0 = scal[:, 4], scal[:, 5], scal[:, 6], scal[:, 7]
    sq, sigma = scal[:, 8], scal[:, 9]
    activef = torch.where(active > 0.5, 1.0, 0.0)
    span = t_end - t_enter
    hw = _Windows(hwin, WH, WW, nblk)

    def latlon(px, py, pz):
        lat = atan2_poly(pz, torch.sqrt(torch.clamp(px * px + py * py,
                                                    min=1e-20)))
        lon = atan2_poly(px, -py)
        return lat, lon

    def hcoords(lat, lon):
        row = (90.0 - lat * RAD2DEG) * (h / 180.0) - 0.5
        lon_w = lon * RAD2DEG + 180.0
        lon_w = lon_w - 360.0 * torch.floor(lon_w / 360.0)
        col = lon_w * (w / 360.0) - 0.5
        col = torch.where(col < 0.0, col + w, col)
        row = (row + 0.5) / q - 0.5
        col = (col + 0.5) / q - 0.5
        col = torch.where(col < c0 - 0.5, col + w / q, col)
        return row - r0, col - c0

    def field(t):
        px = obx + t * dbx
        py = oby + t * dby
        pz = obz + t * dbz
        wy, wx = hcoords(*latlon(px, py, pz))
        r = torch.sqrt(px * px + py * py + pz * pz)
        return r - C.MOON_RADIUS * (hw.sample_colbf(wy, wx, WW) + hmean)

    def coarse_march():
        found = torch.zeros_like(t_enter)
        t_lo, t_hi = t_enter, t_end
        f_lo = torch.ones_like(t_enter)
        f_hi = -torch.ones_like(t_enter)
        f_back = field(t_enter)
        for k in range(n_coarse + 1):
            frac = (k + 0.5) / n_coarse
            t_k = t_enter + span * frac
            f_k = field(t_k)
            newly = (1.0 - found) * torch.where(f_k < 0.0, 1.0, 0.0) * activef
            t_pk = t_enter + span * max(frac - 1.0 / n_coarse, 0.0)
            new = newly > 0.5
            found = torch.maximum(found, newly)
            t_lo = torch.where(new, t_pk, t_lo)
            t_hi = torch.where(new, t_k, t_hi)
            f_lo = torch.where(new, f_back, f_lo)
            f_hi = torch.where(new, f_k, f_hi)
            f_back = f_k
        return found, t_lo, t_hi, f_lo, f_hi

    foundf, t_lo, t_hi, f_lo, f_hi = coarse_march()
    if warm:
        delta = span * (1.0 / n_coarse)
        t_a = torch.maximum(t_prev - delta, t_enter)
        t_b = torch.minimum(t_prev + delta, t_end)
        f_a = field(t_a)
        f_b = field(t_b)
        good = (torch.where(f_a > 0.0, 1.0, 0.0)
                * torch.where(f_b < 0.0, 1.0, 0.0) * f_prev)
        n_bad = torch.sum((activef * (1.0 - good)).reshape(ns, -1), dim=1)
        ok = (n_bad < 0.5).reshape(ns, 1, 1)
        foundf = torch.where(ok, activef, foundf)
        t_lo = torch.where(ok, t_a, t_lo)
        t_hi = torch.where(ok, t_b, t_hi)
        f_lo = torch.where(ok, f_a, f_lo)
        f_hi = torch.where(ok, f_b, f_hi)
    found = foundf > 0.5

    # Illinois false position (secant with unconditional endpoint halving)
    for _ in range(n_bisect + (1 if warm else 0)):
        denom = torch.clamp(f_hi - f_lo, max=-1e-30)
        t_m = torch.minimum(torch.maximum(
            t_lo - f_lo * (t_hi - t_lo) / denom, t_lo), t_hi)
        f_m = field(t_m)
        out = f_m > 0.0
        t_lo, t_hi, f_lo, f_hi = (
            torch.where(out, t_m, t_lo), torch.where(out, t_hi, t_m),
            torch.where(out, f_m, 0.5 * f_lo),
            torch.where(out, 0.5 * f_hi, f_m))
    den2 = torch.clamp(f_hi - f_lo, max=-1e-30)
    t_hit = torch.minimum(torch.maximum(
        t_lo - f_lo * (t_hi - t_lo) / den2, t_lo), t_hi)

    px = obx + t_hit * dbx
    py = oby + t_hit * dby
    pz = obz + t_hit * dbz
    lat, lon = latlon(px, py, pz)

    # normal: central differences with a footprint-matched per-ray step
    pix_ang = P(16)
    inv_p = torch.rsqrt(torch.clamp(px * px + py * py + pz * pz, min=1e-20))
    cosv = torch.clamp(torch.abs((px * dbx + py * dby + pz * dbz) * inv_p),
                       min=0.05)
    arc = t_hit * pix_ang / (C.MOON_RADIUS * cosv)
    step = torch.clamp(0.5 * arc * (h / math.pi) / q, 0.5, 3.0)
    dlat = (math.pi / h) * q * step
    coslat = torch.clamp(torch.cos(lat), min=0.05)
    dlon = dlat / coslat

    def sxyz(la, lo, hv):
        rr = C.MOON_RADIUS * hv
        cl = torch.cos(la)
        return (rr * cl * torch.sin(lo), -rr * cl * torch.cos(lo),
                rr * torch.sin(la))

    wy_c, wx_e = hcoords(lat, lon + dlon)
    _, wx_w = hcoords(lat, lon - dlon)
    wy_n, wx_c = hcoords(lat + dlat, lon)
    wy_s, _ = hcoords(lat - dlat, lon)
    h_e = hw.sample_rowbf(wy_c, wx_e, WW) + hmean
    h_w = hw.sample_rowbf(wy_c, wx_w, WW) + hmean
    h_n = hw.sample_colbf(wy_n, wx_c, WW) + hmean
    h_s = hw.sample_colbf(wy_s, wx_c, WW) + hmean
    e = sxyz(lat, lon + dlon, h_e)
    w_ = sxyz(lat, lon - dlon, h_w)
    n_ = sxyz(lat + dlat, lon, h_n)
    s_ = sxyz(lat - dlat, lon, h_s)
    ax, ay, az = e[0] - w_[0], e[1] - w_[1], e[2] - w_[2]
    bx, by, bz = n_[0] - s_[0], n_[1] - s_[1], n_[2] - s_[2]
    nX = ay * bz - az * by
    nY = az * bx - ax * bz
    nZ = ax * by - ay * bx
    inv = torch.rsqrt(torch.clamp(nX * nX + nY * nY + nZ * nZ, min=1e-20))
    nX, nY, nZ = nX * inv, nY * inv, nZ * inv
    sgn = torch.where(nX * px + nY * py + nZ * pz < 0.0, -1.0, 1.0)
    nX, nY, nZ = nX * sgn, nY * sgn, nZ * sgn

    # albedo (channel-major window columns R|G|B); the albedo level may be
    # coarser than the height level (params 17/18)
    ah2 = P(17)
    aw2 = P(18)
    arow = (90.0 - lat * RAD2DEG) * (ah2 / 180.0) - 0.5
    lon_w = lon * RAD2DEG + 180.0
    lon_w = lon_w - 360.0 * torch.floor(lon_w / 360.0)
    acol = lon_w * (aw2 / 360.0) - 0.5
    acol = torch.where(acol < 0.0, acol + aw2, acol)
    arow = (arow + 0.5) / q - 0.5
    acol = (acol + 0.5) / q - 0.5
    acol = torch.where(acol < ac0 - 0.5, acol + aw2 / q, acol)
    awy = arow - ar0
    awx = acol - ac0
    aw_ = _Windows(awin, AH, 3 * AW, nblk)
    alb_r = aw_.sample_rowbf(awy, awx, AW, 0 * AW)
    alb_g = aw_.sample_rowbf(awy, awx, AW, 1 * AW)
    alb_b = aw_.sample_rowbf(awy, awx, AW, 2 * AW)

    if use_shadow:
        rows_c, rows_f, n_phi = P(7), P(8), P(9)
        szx, szy, szz = P(10), P(11), P(12)
        sxx, sxy, sxz = P(13), P(14), P(15)
        syx = szy * sxz - szz * sxy
        syy = szz * sxx - szx * sxz
        syz = szx * sxy - szy * sxx
        zc = px * szx + py * szy + pz * szz
        xc = px * sxx + py * sxy + pz * sxz
        yc = px * syx + py * syy + pz * syz
        rho = torch.sqrt(torch.clamp(xc * xc + yc * yc, min=1e-20))
        theta = atan2_poly(rho, zc) * RAD2DEG
        phi = atan2_poly(yc, xc)
        phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
        srow = torch.where(theta < 75.0, theta * (rows_c / 75.0),
                           rows_c + (theta - 75.0) * ((rows_f - 1.0) / 30.0))
        srow = torch.minimum(srow, rows_c + rows_f - 1.001)
        scol = phi * (n_phi / (2.0 * math.pi)) - 0.5
        scol = torch.where(scol < 0.0, scol + n_phi, scol)
        srow = (srow + 0.5) / sq - 0.5
        scol = (scol + 0.5) / sq - 0.5
        scol = torch.where(scol < sc0 - 0.5, scol + n_phi / sq, scol)
        sw_ = _Windows(swin, SH, 2 * SW, nblk)
        shadow = sw_.sample_rowbf(srow - sr0, scol - sc0, SW, 0)
        bounce = sw_.sample_rowbf(srow - sr0, scol - sc0, SW, SW)
        night = theta * 1.0 >= 105.0
        shadow = torch.where(night, 0.0, torch.clamp(shadow, 0.0, 1.0))
        bounce = torch.where(night, 0.0, torch.clamp(bounce, min=0.0))
    else:
        shadow = torch.ones_like(px)
        bounce = torch.zeros_like(px)

    # Lambert with the area-light irradiance calibration, softened by the
    # block's lost-roughness sigma (engine.render.soft_ndotl)
    tlx = lxp - px
    tly = lyp - py
    tlz = lzp - pz
    inv_l = torch.rsqrt(torch.clamp(tlx * tlx + tly * tly + tlz * tlz,
                                    min=1e-20))
    mu = (nX * tlx + nY * tly + nZ * tlz) * inv_l
    s_eff = sigma * torch.sqrt(torch.clamp(1.0 - mu * mu, min=0.0)) + 1e-6
    xs = mu / s_eff
    cdf = 1.0 / (1.0 + torch.exp(torch.clamp(-1.702 * xs, -60.0, 60.0)))
    pdf = 0.39894228 * torch.exp(-0.5 * torch.clamp(xs * xs, max=120.0))
    soft = torch.clamp(mu * cdf + s_eff * pdf, min=0.0)
    ndotl = torch.where(sigma > 1e-6, soft, torch.clamp(mu, min=0.0))
    lblend = P(19)
    mu_e = torch.clamp(-(nX * dbx + nY * dby + nZ * dbz), min=0.02)
    ls = 2.0 * ndotl / (ndotl + mu_e + 1e-6)
    ndotl = lblend * ls + (1.0 - lblend) * ndotl
    hitf = found & (active > 0.5)
    lum = torch.where(hitf, irradiance * (ndotl * shadow + bounce), 0.0)

    if use_earth:
        eux, euy, euz = P(20), P(21), P(22)
        edist, e_ang, s_ang = P(23), P(24), P(25)
        evx = eux * edist - px
        evy = euy * edist - py
        evz = euz * edist - pz
        inv_e = torch.rsqrt(torch.clamp(evx * evx + evy * evy + evz * evz,
                                        min=1e-20))
        ex_, ey_, ez_ = evx * inv_e, evy * inv_e, evz * inv_e
        inv_lc = torch.rsqrt(torch.clamp(lxp * lxp + lyp * lyp + lzp * lzp,
                                         min=1e-20))
        lx_, ly_, lz_ = lxp * inv_lc, lyp * inv_lc, lzp * inv_lc
        cosd = ex_ * lx_ + ey_ * ly_ + ez_ * lz_
        crx = ey_ * lz_ - ez_ * ly_
        cry = ez_ * lx_ - ex_ * lz_
        crz = ex_ * ly_ - ey_ * lx_
        sind = torch.sqrt(torch.clamp(crx * crx + cry * cry + crz * crz,
                                      min=0.0))
        sep = atan2_poly(sind, cosd)

        def acos_(x):
            return atan2_poly(torch.sqrt(torch.clamp(1.0 - x * x, min=0.0)), x)

        d = torch.minimum(torch.maximum(sep, torch.abs(e_ang - s_ang) + 1e-7),
                          s_ang + e_ang - 1e-7)
        c1 = torch.clamp((d * d + s_ang * s_ang - e_ang * e_ang)
                         / (2.0 * d * s_ang), -1.0, 1.0)
        c2 = torch.clamp((d * d + e_ang * e_ang - s_ang * s_ang)
                         / (2.0 * d * e_ang), -1.0, 1.0)
        tri = ((-d + s_ang + e_ang) * (d + s_ang - e_ang)
               * (d - s_ang + e_ang) * (d + s_ang + e_ang))
        lens = (s_ang * s_ang * acos_(c1) + e_ang * e_ang * acos_(c2)
                - 0.5 * torch.sqrt(torch.clamp(tri, min=0.0)))
        cov = lens / (math.pi * s_ang * s_ang)
        cov = torch.where(sep >= s_ang + e_ang, 0.0, cov)
        cov = torch.where(sep <= e_ang - s_ang, 1.0, cov)
        cov = torch.clamp(cov, 0.0, 1.0)
        fvis = 1.0 - cov
        mu_e_dir = torch.clamp(nX * ex_ + nY * ey_ + nZ * ez_, min=0.0)
        lum_es = torch.where(hitf, irradiance * P(26) * mu_e_dir, 0.0)
        tint = [fvis + cov * C.UMBRA_TINT[i] for i in range(3)]
    else:
        tint = [1.0, 1.0, 1.0]
        lum_es = 0.0

    zero = torch.zeros_like(px)
    return (alb_r * (lum * tint[0] + lum_es),
            alb_g * (lum * tint[1] + lum_es),
            alb_b * (lum * tint[2] + lum_es),
            hitf.to(torch.float32),
            torch.where(hitf, t_hit, zero),
            torch.where(hitf, px, zero),
            torch.where(hitf, py, zero),
            torch.where(hitf, pz, zero))


class _MarchArgs(ctypes.Structure):
    _fields_ = [
        ("params", ctypes.c_void_p), ("dbx", ctypes.c_void_p),
        ("dby", ctypes.c_void_p), ("dbz", ctypes.c_void_p),
        ("t0", ctypes.c_void_p), ("t1", ctypes.c_void_p),
        ("act", ctypes.c_void_p), ("tprev", ctypes.c_void_p),
        ("fprev", ctypes.c_void_p), ("scal", ctypes.c_void_p),
        ("hwin", ctypes.c_void_p), ("awin", ctypes.c_void_p),
        ("swin", ctypes.c_void_p), ("out", ctypes.c_void_p * 8),
        ("frac", ctypes.c_float * MAX_COARSE),
        ("frac_prev", ctypes.c_float * MAX_COARSE),
        ("h_f", ctypes.c_float), ("w_f", ctypes.c_float),
        ("h_over_180", ctypes.c_float), ("w_over_360", ctypes.c_float),
        ("h_over_pi", ctypes.c_float), ("pi_over_h", ctypes.c_float),
        ("inv_n_coarse", ctypes.c_float),
        ("ns", ctypes.c_int), ("n_coarse", ctypes.c_int),
        ("n_bisect", ctypes.c_int), ("use_shadow", ctypes.c_int),
        ("use_earth", ctypes.c_int), ("warm", ctypes.c_int),
    ]


def _check(name: str, shapes, dev) -> None:
    for t, shape, dtype in shapes:
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev:
            raise ValueError(f"{name}: expected {shape} {dtype} on {dev}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def _strip_inputs(params, scal, hwin, awin, swin, ns: int):
    """(tensor, shape, dtype) of the inputs K2 and the burst share."""
    return [(params, (N_PARAMS, G, B), torch.float32),
            (scal, (ns, N_SCAL, G, B), torch.float32),
            (hwin, (ns, G * WH, WW), torch.float32),
            (awin, (ns, G * AH, 3 * AW), torch.float32),
            (swin, (ns, G * SH, 2 * SW), torch.bfloat16)]


def _march_args(strip, h: int, w: int, ns: int, n_coarse: int,
                n_bisect: int, use_shadow: bool, use_earth: bool,
                warm: bool) -> _MarchArgs:
    """K2's argument struct without its ray planes; ``strip``: the
    contiguous (params, scal, hwin, awin, swin)."""
    params, scal, hwin, awin, swin = strip
    a = _MarchArgs()
    a.params, a.scal = params.data_ptr(), scal.data_ptr()
    a.hwin, a.awin, a.swin = hwin.data_ptr(), awin.data_ptr(), swin.data_ptr()
    for k in range(n_coarse + 1):
        frac = (k + 0.5) / n_coarse
        a.frac[k] = frac
        a.frac_prev[k] = max(frac - 1.0 / n_coarse, 0.0)
    a.h_f, a.w_f = float(h), float(w)
    a.h_over_180, a.w_over_360 = h / 180.0, w / 360.0
    a.h_over_pi, a.pi_over_h = h / math.pi, math.pi / h
    a.inv_n_coarse = 1.0 / n_coarse
    a.ns, a.n_coarse, a.n_bisect = ns, n_coarse, n_bisect
    a.use_shadow, a.use_earth, a.warm = int(use_shadow), int(use_earth), \
        int(warm)
    return a


@kernels.register("march_shade", "mrtx_march_shade", _MarchArgs,
                  passes=("march_kernel",), plain=march_shade_plain,
                  replaces="moonrtx_tpu/ops/pallas_march.py:633")
def march_shade(params, dbx, dby, dbz, t_enter, t_end, active, scal, hwin,
                awin, swin, h: int, w: int, n_coarse: int = 12,
                n_bisect: int = 3, use_shadow: bool = True,
                use_earth: bool = True, t_prev=None, f_prev=None):
    """Fused march+shade over all strips (K2).

    Replaces moonrtx_tpu/ops/pallas_march.py::march_shade_pallas.
    params: (N_PARAMS, G, B) f32 broadcast planes (layout above);
    dbx/dby/dbz, t_enter, t_end, active: (NS, G, B) f32;
    scal: (NS, N_SCAL, G, B) lane-broadcast per-block scalars
    (r0 | c0 | hmean | q | ar0 | ac0 | sr0 | sc0 | sq | sigma);
    hwin: (NS, G*WH, WW) f32; awin: (NS, G*AH, 3*AW) f32 channel-major;
    swin: (NS, G*SH, 2*SW) bf16 shadow | bounce halves;
    t_prev/f_prev (both or neither): the previous sample's hit distance
    and hit mask, (NS, G, B) — the warm-start variant (one extra
    refinement iteration).
    Returns (r, g, b, hit, t_hit, px, py, pz), each (NS, G, B) f32.
    """
    call = dict(locals())
    ns = dbx.shape[0]
    if (t_prev is None) != (f_prev is None):
        raise ValueError("t_prev and f_prev go together")
    if not 1 <= n_coarse < MAX_COARSE:
        raise ValueError(f"n_coarse must be in [1, {MAX_COARSE})")
    warm = t_prev is not None
    dev = dbx.device
    shapes = _strip_inputs(params, scal, hwin, awin, swin, ns)
    rays = [dbx, dby, dbz, t_enter, t_end, active] + (
        [t_prev, f_prev] if warm else [])
    shapes += [(t, (ns, G, B), torch.float32) for t in rays]
    _check("march_shade", shapes, dev)
    if dev.type != "cuda":
        return march_shade_plain(
            params, dbx, dby, dbz, t_enter, t_end, active, scal, hwin, awin,
            swin, h, w, n_coarse=n_coarse, n_bisect=n_bisect,
            use_shadow=use_shadow, use_earth=use_earth, t_prev=t_prev,
            f_prev=f_prev)
    ins = [t.contiguous() for t, _, _ in shapes]
    rays = ins[5:]
    outs = [torch.empty((ns, G, B), dtype=torch.float32, device=dev)
            for _ in range(8)]
    a = _march_args(ins[:5], h, w, ns, n_coarse, n_bisect, use_shadow,
                    use_earth, warm)
    (a.dbx, a.dby, a.dbz, a.t0, a.t1, a.act) = [t.data_ptr()
                                                for t in rays[:6]]
    if warm:
        a.tprev, a.fprev = rays[6].data_ptr(), rays[7].data_ptr()
    for i, o in enumerate(outs):
        a.out[i] = o.data_ptr()
    kernels.launch(march_shade, a, outs[0], call)
    return tuple(outs)


# ---- the burst: warm samples 1..n-1 in one launch ---------------------------

N_CAM = 19    # forward | right | up | tan_half_fov | rotation (row-major)


def march_burst_plain(params, basis, rotation, jitters, h_bound, r, g, b,
                      t_prev, f_prev, scal, hwin, awin, swin, h: int, w: int,
                      height: int, width: int, h_min: float, n_samples: int,
                      n_coarse: int = 12, n_bisect: int = 3,
                      use_shadow: bool = True, use_earth: bool = True):
    """Plain version of march_burst: per warm sample the jittered rays
    (ops.ray_setup.block_rays_plain in block layout), march_shade_plain
    warm from the previous sample's hits, and the running mean."""
    ns = t_prev.shape[0]
    ar, ag, ab, tp, fpv = r, g, b, t_prev, f_prev
    for i in range(1, n_samples):
        geom = block_rays_plain(basis, rotation, jitters[i], height, width,
                                h_min, h_bound=h_bound, image_dirs=False)
        dbx, dby, dbz = (geom.db[..., k].reshape(ns, G, B) for k in range(3))
        r_i, g_i, b_i, hitf, t_hit, *_ = march_shade_plain(
            params, dbx, dby, dbz, geom.t_enter.reshape(ns, G, B),
            geom.t_end.reshape(ns, G, B),
            geom.hit_outer.to(torch.float32).reshape(ns, G, B), scal, hwin,
            awin, swin, h, w, n_coarse=n_coarse, n_bisect=n_bisect,
            use_shadow=use_shadow, use_earth=use_earth, t_prev=tp,
            f_prev=fpv)
        k = i + 1.0
        ar, ag, ab = ar + (r_i - ar) / k, ag + (g_i - ag) / k, \
            ab + (b_i - ab) / k
        tp, fpv = t_hit, hitf
    return ar, ag, ab


class _BurstArgs(ctypes.Structure):
    _fields_ = [
        ("m", _MarchArgs), ("jit", ctypes.c_void_p),
        ("hbound", ctypes.c_void_p), ("cam", ctypes.c_void_p),
        ("rgb0", ctypes.c_void_p * 3), ("mean", ctypes.c_void_p * 3),
        ("inv_fh", ctypes.c_float), ("inv_width", ctypes.c_float),
        ("w_over_fh", ctypes.c_float), ("r2_outer", ctypes.c_float),
        ("r2_inner", ctypes.c_float),
        ("wbk", ctypes.c_int), ("n_samples", ctypes.c_int),
    ]


# no pallas_call: the JAX package's burst is a jitted fori_loop
@kernels.register("march_shade", "mrtx_march_burst", _BurstArgs,
                  passes=("burst_kernel",), plain=march_burst_plain,
                  replaces="moonrtx_tpu/engine/blocked.py:940")
def march_burst(params, basis, rotation, jitters, h_bound, r, g, b, t_prev,
                f_prev, scal, hwin, awin, swin, h: int, w: int, height: int,
                width: int, h_min: float, n_samples: int, n_coarse: int = 12,
                n_bisect: int = 3, use_shadow: bool = True,
                use_earth: bool = True):
    """Samples 1..n_samples-1 of an accumulation burst in one launch (the
    burst kernel, csrc/march_shade.cu): each warm sample's jittered rays,
    K2's warm march and shade, and the running mean, never leaving the
    card's registers between samples.

    params, scal, hwin, awin, swin, h, w, n_coarse, n_bisect, use_shadow,
    use_earth: as march_shade. basis (engine.camera.CameraBasis) and
    rotation (3, 3): the camera and body-to-scene rotation; jitters:
    (>= n_samples, 2) f32, sample i's at row i; h_bound: (NS*G,) f32 chord
    bound of each block, or None; height, width: the frame; h_min: the
    inner sphere's radius in Moon radii. r, g, b, t_prev, f_prev: sample
    0's colour, hit distance and hit mask from march_shade, (NS, G, B).
    Returns the mean (r, g, b) over all n_samples, each (NS, G, B) f32.
    Adds n_samples - 1 to the counter ``burst.fused_samples``.
    """
    call = dict(locals())
    ns = t_prev.shape[0]
    if not 2 <= n_samples <= jitters.shape[0]:
        raise ValueError(f"march_burst: n_samples {n_samples} must be in "
                         f"[2, {jitters.shape[0]}] (the jitter rows)")
    if not 1 <= n_coarse < MAX_COARSE:
        raise ValueError(f"n_coarse must be in [1, {MAX_COARSE})")
    dev = t_prev.device
    shapes = _strip_inputs(params, scal, hwin, awin, swin, ns)
    shapes += [(t, (ns, G, B), torch.float32)
               for t in (r, g, b, t_prev, f_prev)]
    shapes.append((jitters, (jitters.shape[0], 2), torch.float32))
    if h_bound is not None:
        shapes.append((h_bound, (ns * G,), torch.float32))
    _check("march_burst", shapes, dev)
    if height % 8 or width % 16 or height * width != ns * G * B:
        raise ValueError(f"march_burst: a {height}x{width} frame is not "
                         f"{ns} strips of 8x16-pixel blocks")
    profiling.count("burst.fused_samples", n_samples - 1)
    if dev.type != "cuda":
        return march_burst_plain(
            params, basis, rotation, jitters, h_bound, r, g, b, t_prev,
            f_prev, scal, hwin, awin, swin, h, w, height, width, h_min,
            n_samples, n_coarse=n_coarse, n_bisect=n_bisect,
            use_shadow=use_shadow, use_earth=use_earth)
    ins = [t.contiguous() for t, _, _ in shapes]
    cam = torch.cat([basis.forward, basis.right, basis.up,
                     torch.as_tensor(basis.tan_half_fov, dtype=torch.float32,
                                     device=dev).reshape(1),
                     rotation.reshape(9)]).to(torch.float32).contiguous()
    if cam.numel() != N_CAM:
        raise ValueError(f"march_burst: the camera basis and rotation give "
                         f"{cam.numel()} numbers, expected {N_CAM}")
    outs = [torch.empty((ns, G, B), dtype=torch.float32, device=dev)
            for _ in range(3)]
    a = _BurstArgs()
    a.m = _march_args(ins[:5], h, w, ns, n_coarse, n_bisect, use_shadow,
                      use_earth, True)
    rgb0, (tp, fpv) = ins[5:8], ins[8:10]
    a.m.tprev, a.m.fprev = tp.data_ptr(), fpv.data_ptr()
    a.jit = ins[10].data_ptr()
    a.hbound = ins[11].data_ptr() if h_bound is not None else None
    a.cam = cam.data_ptr()
    for i in range(3):
        a.rgb0[i] = rgb0[i].data_ptr()
        a.mean[i] = outs[i].data_ptr()
    # torch on the card divides by a host number as a product with the
    # number's float32 reciprocal; the kernel does the same
    a.inv_fh = np.float32(1.0) / np.float32(height)
    a.inv_width = np.float32(1.0) / np.float32(width)
    a.w_over_fh = width / height
    r_in = C.MOON_RADIUS * h_min * 0.999      # block_rays' inner sphere
    a.r2_outer, a.r2_inner = C.MOON_RADIUS * C.MOON_RADIUS, r_in * r_in
    a.wbk, a.n_samples = width // 16, n_samples
    kernels.launch(march_burst, a, outs[0], call)
    return tuple(outs)
