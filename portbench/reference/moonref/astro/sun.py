# Frozen copy of moonrtx_tpu_torch/astro/sun.py at commit 41cfce49f52c, for the benchmark's
# plain reference, trimmed to what the reference reaches; imports renamed.
"""Solar position: geometric and apparent ecliptic coordinates.

Low-precision solar theory (Meeus ch. 25), accurate to ~0.01 degrees —
far below the 0.5-degree phase-name bins and the sub-arcminute needs of
lighting geometry. Replaces the DE421 'sun' segment (reference astro.py:34).
"""

from __future__ import annotations

import math

from reference.moonref import constants as C

DEG = math.pi / 180.0


def sun_geometric(T: float) -> tuple[float, float]:
    """(true geometric ecliptic longitude deg, distance km) of the Sun."""
    L0 = 280.46646 + 36000.76983 * T + 0.0003032 * T * T
    M = 357.52911 + 35999.05029 * T - 0.0001537 * T * T
    e = 0.016708634 - 0.000042037 * T - 0.0000001267 * T * T
    Mr = M * DEG
    Cc = ((1.914602 - 0.004817 * T - 0.000014 * T * T) * math.sin(Mr)
          + (0.019993 - 0.000101 * T) * math.sin(2 * Mr)
          + 0.000289 * math.sin(3 * Mr))
    true_lon = L0 + Cc
    nu = (M + Cc) * DEG
    R_au = 1.000001018 * (1 - e * e) / (1 + e * math.cos(nu))
    return true_lon % 360.0, R_au * C.AU_KM


def sun_apparent_lon(T: float, dpsi_deg: float) -> tuple[float, float, float]:
    """(apparent ecliptic longitude deg, distance km, GEOMETRIC longitude
    deg): apparent = geometric + nutation + annual aberration. The
    geometric longitude is returned too because the phase-name binning
    compares geometric moon vs geometric sun (reference astro.py:171-173
    uses non-aberrated longitudes for both bodies — mixing an aberrated
    sun with a geometric moon shifts the 0.5-deg bin edges by ~20.5
    arcsec, flipping phase names ~40 s early)."""
    lon, dist = sun_geometric(T)
    R_au = dist / C.AU_KM
    lon_app = lon + dpsi_deg - (20.4898 / 3600.0) / R_au
    return lon_app % 360.0, dist, lon % 360.0
