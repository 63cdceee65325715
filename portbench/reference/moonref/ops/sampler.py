# Frozen copy of moonrtx_tpu_torch/ops/sampler.py at commit 41cfce49f52c, for the benchmark's
# plain reference, trimmed to what the reference reaches; imports renamed.
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


def sample_latlon(tex, lat_deg, lon_deg, h: int, w: int):
    """Gather-backend sample at lat/lon on a padded map."""
    row, col = latlon_to_rowcol(lat_deg, lon_deg, h, w)
    return gather_bilinear(tex, row, col)
