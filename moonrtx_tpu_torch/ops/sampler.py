"""Bilinear texture sampling and per-block window geometry (torch).

Port of moonrtx_tpu/ops/sampler.py. Textures are equirectangular with the
texel-center convention row = (90-lat)/180*H - 0.5,
col = (lon+180)/360*W - 0.5, longitude wrapping via padded columns
(data.mips.pad_lon_wrap), latitude rows clamped at the poles.

On the card the gathers below are plain indexed loads: the one-hot
matrix formulation of the TPU sampler exists only because the TPU has no
gather hardware.
"""

from __future__ import annotations

import torch

BLOCK = 128  # rays per window block (one 8x16 pixel tile)


def latlon_to_rowcol(lat_deg, lon_deg, h: int, w: int):
    """Fractional texel coordinates (row, col) on an (h, w) equirect map.

    ``w`` is the UNPADDED width; callers sample a map padded with wrapped
    columns so col may validly reach w + pad - 1.
    """
    row = (90.0 - lat_deg) / 180.0 * h - 0.5
    col = torch.remainder(lon_deg + 180.0, 360.0) / 360.0 * w - 0.5
    # col in [-0.5, w-0.5); shift the seam texel into the padded region
    col = torch.where(col < 0.0, col + w, col)
    return row, col


def gather_bilinear(tex, row, col):
    """Gather bilinear sampling.

    tex: (H, Wp) or (H, Wp, C) (Wp = padded width); row/col: any shape.
    Rows clamp at the poles; columns assume the padded layout (no wrap).
    """
    h = tex.shape[0]
    wp = tex.shape[1]
    r0 = torch.clamp(torch.floor(row).to(torch.int64), 0, h - 2)
    c0 = torch.clamp(torch.floor(col).to(torch.int64), 0, wp - 2)
    fr = torch.clamp(row - r0, 0.0, 1.0)
    fc = torch.clamp(col - c0, 0.0, 1.0)
    if tex.ndim == 2:
        flat = tex.reshape(-1)

        def g(r, c):
            return flat[r * wp + c]
        fr_, fc_ = fr, fc
    else:
        flat = tex.reshape(-1, tex.shape[2])

        def g(r, c):
            return flat[r * wp + c]
        fr_, fc_ = fr[..., None], fc[..., None]
    return (g(r0, c0) * (1 - fr_) * (1 - fc_)
            + g(r0 + 1, c0) * fr_ * (1 - fc_)
            + g(r0, c0 + 1) * (1 - fr_) * fc_
            + g(r0 + 1, c0 + 1) * fr_ * fc_)


def extract_windows(tex, r0, c0, wh: int, ww: int):
    """Per-block windows tex[r0[b]:r0[b]+wh, c0[b]:c0[b]+ww], raw dtype.

    tex: (H, W) or (H, W, C); r0/c0: (NBLK,) int32, pre-clamped to the
    valid range. The plain per-block slice (the reference's vmapped
    dynamic_slice); the decoded kernel form is ops.extract.extract_windows,
    and this one is its independent check."""
    rows = r0.long()[:, None] + torch.arange(wh, device=r0.device)
    cols = c0.long()[:, None] + torch.arange(ww, device=r0.device)
    return tex[rows[:, :, None], cols[:, None, :]]


def window_bilinear(windows, wy, wx, mix_dtype=None):
    """Bilinear sampling from per-block windows.

    windows: (NBLK, WH, WW) or (NBLK, WH, WW, C)
    wy, wx:  (NBLK, B) window-local fractional coords (clamped to the window)
    returns  (NBLK, B) or (NBLK, B, C)

    mix_dtype (3-D windows only): the row-mixed intermediate is rounded to
    this dtype before the column mix, as the reference's bf16 row-mix of
    mean-centered residuals rounds it.
    """
    nblk, wh, ww = windows.shape[:3]
    wy = torch.clamp(wy, 0.0, wh - 1.001)
    wx = torch.clamp(wx, 0.0, ww - 1.001)
    y0 = torch.floor(wy)
    x0 = torch.floor(wx)
    fy = wy - y0
    fx = wx - x0
    base = (torch.arange(nblk, device=wy.device)[:, None] * (wh * ww)
            + y0.to(torch.int64) * ww + x0.to(torch.int64))
    flat = windows.reshape(nblk * wh * ww, -1)

    def g(off):
        v = flat[base + off]
        return v[..., 0] if windows.ndim == 3 else v

    if windows.ndim == 4:
        fy, fx = fy[..., None], fx[..., None]
    # rows first, then columns (the reference's contraction order)
    left = g(0) * (1.0 - fy) + g(ww) * fy
    right = g(1) * (1.0 - fy) + g(ww + 1) * fy
    if mix_dtype is not None and windows.ndim == 3:
        left = left.to(mix_dtype).to(torch.float32)
        right = right.to(mix_dtype).to(torch.float32)
    return left * (1.0 - fx) + right * fx


def sample_latlon(tex, lat_deg, lon_deg, h: int, w: int):
    """Gather-backend sample at lat/lon on a padded map."""
    row, col = latlon_to_rowcol(lat_deg, lon_deg, h, w)
    return gather_bilinear(tex, row, col)


def block_footprint(rows, cols, wrap_w):
    """(r_mid, c_mid, r_span, c_span) of per-block footprints; seam-aware.

    wrap_w may be a scalar or a per-block (NBLK,) tensor (strided blocks).
    Blocks whose column range exceeds half the wrap width are treated as
    straddling the longitude (or scan phi=0) seam: their low columns are
    unwrapped by +wrap_w before the midpoint/span are taken."""
    ax = tuple(range(1, rows.ndim))
    wrap_w = torch.as_tensor(wrap_w, dtype=cols.dtype, device=cols.device)
    wrap_b = (wrap_w.reshape(wrap_w.shape + (1,) * (cols.ndim - 1))
              if wrap_w.ndim else wrap_w)
    c_min = torch.amin(cols, dim=ax)
    c_max = torch.amax(cols, dim=ax)
    spans_seam = (c_max - c_min) > (torch.min(wrap_w) * 0.5)
    exp = spans_seam.reshape(spans_seam.shape + (1,) * (cols.ndim - 1))
    cols_adj = torch.where(exp & (cols < wrap_b * 0.5), cols + wrap_b, cols)
    c_min = torch.amin(cols_adj, dim=ax)
    c_max = torch.amax(cols_adj, dim=ax)
    r_min = torch.amin(rows, dim=ax)
    r_max = torch.amax(rows, dim=ax)
    return (0.5 * (r_min + r_max), 0.5 * (c_min + c_max),
            r_max - r_min, c_max - c_min)


def window_origin_from_footprint(rows, cols, wrap_w, win_h: int, win_w: int,
                                 map_h, map_pad_w):
    """Window origins covering per-ray (row, col) footprints; seam-aware.
    rows/cols: (NBLK, ...) any trailing shape; map_h/map_pad_w may be
    per-block tensors (strided blocks clamp against the coarser level).
    Returns int32 (r0, c0)."""
    r_mid, c_mid, _, _ = block_footprint(rows, cols, wrap_w)

    def hi(m, win):
        if torch.is_tensor(m):
            return (m - win).to(torch.int32)
        return torch.tensor(int(m - win), dtype=torch.int32,
                            device=rows.device)

    r0 = torch.minimum(torch.clamp((r_mid - win_h * 0.5).to(torch.int32),
                                   min=0), hi(map_h, win_h))
    c0 = torch.minimum(torch.clamp((c_mid - win_w * 0.5).to(torch.int32),
                                   min=0), hi(map_pad_w, win_w))
    return r0, c0
