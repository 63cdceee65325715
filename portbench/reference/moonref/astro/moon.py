# Frozen copy of moonrtx_tpu_torch/astro/moon.py at commit 41cfce49f52c, for the benchmark's
# plain reference, trimmed to what the reference reaches; imports renamed.
"""Geocentric lunar position: truncated ELP-2000/82 series.

The 60-term longitude/distance and 60-term latitude series (the classical
abridgement published in Meeus ch. 47), accurate to ~10 arcsec in longitude,
~4 arcsec in latitude and ~0.02% in distance over 1900-2051 — a few hundred
meters of lighting geometry on the lunar surface, far below the renderer's
texel size. Replaces the DE421 'moon' segment (reference astro.py:33).
"""

from __future__ import annotations

import math
from typing import NamedTuple

DEG = math.pi / 180.0


class MoonArguments(NamedTuple):
    """Fundamental lunar arguments, degrees."""

    Lp: float   # mean longitude
    D: float    # mean elongation
    M: float    # Sun mean anomaly
    Mp: float   # Moon mean anomaly
    F: float    # argument of latitude
    Om: float   # longitude of ascending node
    E: float    # eccentricity damping factor
    A1: float
    A2: float
    A3: float


def moon_arguments(T: float) -> MoonArguments:
    Lp = (218.3164477 + 481267.88123421 * T - 0.0015786 * T * T
          + T**3 / 538841.0 - T**4 / 65194000.0)
    D = (297.8501921 + 445267.1114034 * T - 0.0018819 * T * T
         + T**3 / 545868.0 - T**4 / 113065000.0)
    M = 357.5291092 + 35999.0502909 * T - 0.0001536 * T * T + T**3 / 24490000.0
    Mp = (134.9633964 + 477198.8675055 * T + 0.0087414 * T * T
          + T**3 / 69699.0 - T**4 / 14712000.0)
    F = (93.2720950 + 483202.0175233 * T - 0.0036539 * T * T
         - T**3 / 3526000.0 + T**4 / 863310000.0)
    Om = (125.0445479 - 1934.1362891 * T + 0.0020754 * T * T
          + T**3 / 467441.0 - T**4 / 60616000.0)
    E = 1.0 - 0.002516 * T - 0.0000074 * T * T
    A1 = 119.75 + 131.849 * T
    A2 = 53.09 + 479264.290 * T
    A3 = 313.45 + 481266.484 * T
    return MoonArguments(Lp % 360.0, D % 360.0, M % 360.0, Mp % 360.0,
                         F % 360.0, Om % 360.0, E, A1 % 360.0, A2 % 360.0,
                         A3 % 360.0)


# (D, M, M', F, sigma_l [1e-6 deg], sigma_r [1e-3 km])
_LR_TERMS = [
    (0, 0, 1, 0, 6288774, -20905355),
    (2, 0, -1, 0, 1274027, -3699111),
    (2, 0, 0, 0, 658314, -2955968),
    (0, 0, 2, 0, 213618, -569925),
    (0, 1, 0, 0, -185116, 48888),
    (0, 0, 0, 2, -114332, -3149),
    (2, 0, -2, 0, 58793, 246158),
    (2, -1, -1, 0, 57066, -152138),
    (2, 0, 1, 0, 53322, -170733),
    (2, -1, 0, 0, 45758, -204586),
    (0, 1, -1, 0, -40923, -129620),
    (1, 0, 0, 0, -34720, 108743),
    (0, 1, 1, 0, -30383, 104755),
    (2, 0, 0, -2, 15327, 10321),
    (0, 0, 1, 2, -12528, 0),
    (0, 0, 1, -2, 10980, 79661),
    (4, 0, -1, 0, 10675, -34782),
    (0, 0, 3, 0, 10034, -23210),
    (4, 0, -2, 0, 8548, -21636),
    (2, 1, -1, 0, -7888, 24208),
    (2, 1, 0, 0, -6766, 30824),
    (1, 0, -1, 0, -5163, -8379),
    (1, 1, 0, 0, 4987, -16675),
    (2, -1, 1, 0, 4036, -12831),
    (2, 0, 2, 0, 3994, -10445),
    (4, 0, 0, 0, 3861, -11650),
    (2, 0, -3, 0, 3665, 14403),
    (0, 1, -2, 0, -2689, -7003),
    (2, 0, -1, 2, -2602, 0),
    (2, -1, -2, 0, 2390, 10056),
    (1, 0, 1, 0, -2348, 6322),
    (2, -2, 0, 0, 2236, -9884),
    (0, 1, 2, 0, -2120, 5751),
    (0, 2, 0, 0, -2069, 0),
    (2, -2, -1, 0, 2048, -4950),
    (2, 0, 1, -2, -1773, 4130),
    (2, 0, 0, 2, -1595, 0),
    (4, -1, -1, 0, 1215, -3958),
    (0, 0, 2, 2, -1110, 0),
    (3, 0, -1, 0, -892, 3258),
    (2, 1, 1, 0, -810, 2616),
    (4, -1, -2, 0, 759, -1897),
    (0, 2, -1, 0, -713, -2117),
    (2, 2, -1, 0, -700, 2354),
    (2, 1, -2, 0, 691, 0),
    (2, -1, 0, -2, 596, 0),
    (4, 0, 1, 0, 549, -1423),
    (0, 0, 4, 0, 537, -1117),
    (4, -1, 0, 0, 520, -1571),
    (1, 0, -2, 0, -487, -1739),
    (2, 1, 0, -2, -399, 0),
    (0, 0, 2, -2, -381, -4421),
    (1, 1, 1, 0, 351, 0),
    (3, 0, -2, 0, -340, 0),
    (4, 0, -3, 0, 330, 0),
    (2, -1, 2, 0, 327, 0),
    (0, 2, 1, 0, -323, 1165),
    (1, 1, -1, 0, 299, 0),
    (2, 0, 3, 0, 294, 0),
    (2, 0, -1, -2, 0, 8752),
]

# (D, M, M', F, sigma_b [1e-6 deg])
_B_TERMS = [
    (0, 0, 0, 1, 5128122),
    (0, 0, 1, 1, 280602),
    (0, 0, 1, -1, 277693),
    (2, 0, 0, -1, 173237),
    (2, 0, -1, 1, 55413),
    (2, 0, -1, -1, 46271),
    (2, 0, 0, 1, 32573),
    (0, 0, 2, 1, 17198),
    (2, 0, 1, -1, 9266),
    (0, 0, 2, -1, 8822),
    (2, -1, 0, -1, 8216),
    (2, 0, -2, -1, 4324),
    (2, 0, 1, 1, 4200),
    (2, 1, 0, -1, -3359),
    (2, -1, -1, 1, 2463),
    (2, -1, 0, 1, 2211),
    (2, -1, -1, -1, 2065),
    (0, 1, -1, -1, -1870),
    (4, 0, -1, -1, 1828),
    (0, 1, 0, 1, -1794),
    (0, 0, 0, 3, -1749),
    (0, 1, -1, 1, -1565),
    (1, 0, 0, 1, -1491),
    (0, 1, 1, 1, -1475),
    (0, 1, 1, -1, -1410),
    (0, 1, 0, -1, -1344),
    (1, 0, 0, -1, -1335),
    (0, 0, 3, 1, 1107),
    (4, 0, 0, -1, 1021),
    (4, 0, -1, 1, 833),
    (0, 0, 1, -3, 777),
    (4, 0, -2, 1, 671),
    (2, 0, 0, -3, 607),
    (2, 0, 2, -1, 596),
    (2, -1, 1, -1, 491),
    (2, 0, -2, 1, -451),
    (0, 0, 3, -1, 439),
    (2, 0, 2, 1, 422),
    (2, 0, -3, -1, 421),
    (2, 1, -1, 1, -366),
    (2, 1, 0, 1, -351),
    (4, 0, 0, 1, 331),
    (2, -1, 1, 1, 315),
    (2, -2, 0, -1, 383),
    (0, 0, 1, 3, -283),
    (2, 1, 1, -1, -229),
    (1, 1, 0, -1, 223),
    (1, 1, 0, 1, 223),
    (0, 1, -2, -1, -220),
    (2, 1, -1, -1, -220),
    (1, 0, 1, 1, -185),
    (2, -1, -2, -1, 181),
    (0, 1, 2, 1, -177),
    (4, 0, -2, -1, 176),
    (4, -1, -1, -1, 166),
    (1, 0, 1, -1, -164),
    (4, 0, 1, -1, 132),
    (1, 0, -1, -1, -119),
    (4, -1, 0, -1, 115),
    (2, -2, 0, 1, 107),
]


def moon_geometric(T: float, args=None) -> tuple[float, float, float]:
    """(geometric ecliptic longitude deg, latitude deg, distance km),
    mean equinox of date. args: optional precomputed moon_arguments(T) —
    the per-time-step ephemeris call computes them once and shares them
    with the libration chain."""
    a = args if args is not None else moon_arguments(T)
    Dr, Mr, Mpr, Fr = a.D * DEG, a.M * DEG, a.Mp * DEG, a.F * DEG

    sl = 0.0
    sr = 0.0
    for d, m, mp, f, cl, cr in _LR_TERMS:
        e = a.E ** abs(m)
        arg = d * Dr + m * Mr + mp * Mpr + f * Fr
        sl += cl * e * math.sin(arg)
        sr += cr * e * math.cos(arg)
    sl += (3958.0 * math.sin(a.A1 * DEG)
           + 1962.0 * math.sin((a.Lp - a.F) * DEG)
           + 318.0 * math.sin(a.A2 * DEG))

    sb = 0.0
    for d, m, mp, f, cb in _B_TERMS:
        e = a.E ** abs(m)
        sb += cb * e * math.sin(d * Dr + m * Mr + mp * Mpr + f * Fr)
    sb += (-2235.0 * math.sin(a.Lp * DEG)
           + 382.0 * math.sin(a.A3 * DEG)
           + 175.0 * math.sin((a.A1 - a.F) * DEG)
           + 175.0 * math.sin((a.A1 + a.F) * DEG)
           + 127.0 * math.sin((a.Lp - a.Mp) * DEG)
           - 115.0 * math.sin((a.Lp + a.Mp) * DEG))

    lam = (a.Lp + sl * 1e-6) % 360.0
    beta = sb * 1e-6
    dist = 385000.56 + sr * 1e-3
    return lam, beta, dist
