# Frozen copy of moonrtx_tpu_torch/engine/geometry.py at commit 41cfce49f52c, for the benchmark's
# plain reference, trimmed to what the reference reaches; imports renamed.
"""Body-frame spherical geometry (torch).

Port of moonrtx_tpu/engine/geometry.py. Conventions match the reference
scene: body frame has +Z at the north pole, longitude 0 on the -Y axis,
+X at longitude 90E:

    x = cos(lat) sin(lon),  y = -cos(lat) cos(lon),  z = sin(lat)

Scene coordinates: ``scene = M @ body`` with M the ephemeris rotation
matrix.
"""

from __future__ import annotations

import torch


def latlon_to_unit(lat_deg, lon_deg):
    """Unit vectors (..., 3) from degrees."""
    lat = torch.deg2rad(lat_deg)
    lon = torch.deg2rad(lon_deg)
    cl = torch.cos(lat)
    return torch.stack([cl * torch.sin(lon), -cl * torch.cos(lon),
                        torch.sin(lat)], dim=-1)


def unit_to_latlon(v):
    """(lat_deg, lon_deg) from unit (or any) vectors (..., 3)."""
    r = torch.sqrt(torch.sum(v * v, dim=-1))
    lat = torch.rad2deg(torch.asin(torch.clamp(v[..., 2] / r, -1.0, 1.0)))
    lon = torch.rad2deg(torch.atan2(v[..., 0], -v[..., 1]))
    return lat, lon


def ray_sphere(o, d, radius):
    """Intersect rays (o + t d) with a centered sphere.

    o: (..., 3) origins, d: (..., 3) unit directions.
    Returns (hit, t_near, t_far); t values valid only where hit.
    """
    b = torch.sum(o * d, dim=-1)
    c = torch.sum(o * o, dim=-1) - radius * radius
    disc = b * b - c
    hit = disc > 0.0
    s = torch.sqrt(torch.clamp(disc, min=0.0))
    return hit, -b - s, -b + s


def mat3_apply(M, v):
    """(3,3) matrix times vectors (..., 3), written out elementwise like
    the reference (no matmul, so no reduced-precision product path)."""
    return torch.stack([
        v[..., 0] * M[0, 0] + v[..., 1] * M[0, 1] + v[..., 2] * M[0, 2],
        v[..., 0] * M[1, 0] + v[..., 1] * M[1, 1] + v[..., 2] * M[1, 2],
        v[..., 0] * M[2, 0] + v[..., 1] * M[2, 1] + v[..., 2] * M[2, 2],
    ], dim=-1)


def mat3t_apply(M, v):
    """Transpose(M) times vectors (..., 3), elementwise (see mat3_apply)."""
    return torch.stack([
        v[..., 0] * M[0, 0] + v[..., 1] * M[1, 0] + v[..., 2] * M[2, 0],
        v[..., 0] * M[0, 1] + v[..., 1] * M[1, 1] + v[..., 2] * M[2, 1],
        v[..., 0] * M[0, 2] + v[..., 1] * M[1, 2] + v[..., 2] * M[2, 2],
    ], dim=-1)


def normalize(v, dim=-1, eps=1e-20):
    return v / torch.sqrt(torch.clamp(torch.sum(v * v, dim=dim, keepdim=True),
                                      min=eps))
