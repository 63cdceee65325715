"""Surface measurement: great-circle distance and elevation difference
(reference renderer_navigation.py:522-596)."""

from __future__ import annotations

import math

import numpy as np

from moonrtx_tpu_torch import constants as C


def great_circle_distance_km(lat1: float, lon1: float,
                             lat2: float, lon2: float) -> float:
    """Haversine central angle times the Moon radius."""
    la1, la2 = math.radians(lat1), math.radians(lat2)
    dlat = la2 - la1
    dlon = math.radians(lon2 - lon1)
    a = (math.sin(dlat / 2) ** 2
         + math.cos(la1) * math.cos(la2) * math.sin(dlon / 2) ** 2)
    c = 2 * math.atan2(math.sqrt(a), math.sqrt(1 - a))
    return c * C.MOON_RADIUS_KM


def elevation_m(elevation: np.ndarray, radius_scale: float,
                lat: float, lon: float,
                scale: float = 1.0, offset: float = 0.0) -> float:
    """Bilinear elevation sample in meters relative to the reference radius.

    Texel-center convention with longitude wrap at the +/-180 seam
    (reference renderer_navigation.py:555-596); the stored values are
    peak-normalized displacement factors, rescaled by radius_scale.
    scale/offset decode quantized (int16) storage per sampled texel —
    the shared math for both the host-level copy and the full-resolution
    pyramid reader (MoonScene.elevation_m_at).
    """
    h, w = elevation.shape[0], elevation.shape[1]
    row = (90.0 - lat) / 180.0 * h - 0.5
    col = ((lon + 180.0) / 360.0 * w - 0.5) % w

    r0 = int(np.clip(math.floor(row), 0, h - 2))
    fr = min(max(row - r0, 0.0), 1.0)
    c0 = int(math.floor(col))
    c1 = (c0 + 1) % w
    fc = col - c0

    val = (float(elevation[r0, c0]) * (1 - fr) * (1 - fc)
           + float(elevation[r0 + 1, c0]) * fr * (1 - fc)
           + float(elevation[r0, c1]) * (1 - fr) * fc
           + float(elevation[r0 + 1, c1]) * fr * fc)
    displacement = (val * scale + offset) * radius_scale
    return (displacement - 1.0) * C.MOON_RADIUS_KM * 1000.0


def elevation_difference_m(elevation: np.ndarray, radius_scale: float,
                           lat1: float, lon1: float,
                           lat2: float, lon2: float) -> float:
    return (elevation_m(elevation, radius_scale, lat2, lon2)
            - elevation_m(elevation, radius_scale, lat1, lon1))
