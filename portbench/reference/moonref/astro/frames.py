# Frozen copy of moonrtx_tpu_torch/astro/frames.py at commit 41cfce49f52c, for the benchmark's
# plain reference, trimmed to what the reference reaches; imports renamed.
"""Reference frames: obliquity, nutation, ecliptic/equatorial transforms,
rotation helpers, angle utilities.

Replaces Skyfield's framelib (reference astro.py:7,176-177) with the IAU 1980
nutation series (largest terms) and standard rotation compositions. All
frames here are "of date"; the renderer never needs ICRF/J2000 because every
vector it consumes is produced in the same true-equator-of-date frame.
"""

from __future__ import annotations

import math

import numpy as np

DEG = math.pi / 180.0
ARCSEC = DEG / 3600.0


def wrap180(a: float) -> float:
    """Wrap to (-180, 180] (reference astro.py:55-56)."""
    return (a + 180.0) % 360.0 - 180.0


def rot_x(angle_rad: float) -> np.ndarray:
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def rot_z(angle_rad: float) -> np.ndarray:
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def mean_obliquity_deg(T: float) -> float:
    """Mean obliquity of the ecliptic (IAU 1980 expression, Meeus 22.2)."""
    return (23.0 + 26.0 / 60.0 + 21.448 / 3600.0
            - (46.8150 * T + 0.00059 * T * T - 0.001813 * T**3) / 3600.0)


# IAU 1980 nutation: the 16 largest terms. Columns: multipliers of
# (D, M, M', F, Omega), then psi coefficients (0.0001" units: const, T) and
# eps coefficients (const, T). Good to ~0.003" over the supported range.
_NUTATION_TERMS = [
    (0, 0, 0, 0, 1, -171996.0, -174.2, 92025.0, 8.9),
    (-2, 0, 0, 2, 2, -13187.0, -1.6, 5736.0, -3.1),
    (0, 0, 0, 2, 2, -2274.0, -0.2, 977.0, -0.5),
    (0, 0, 0, 0, 2, 2062.0, 0.2, -895.0, 0.5),
    (0, 1, 0, 0, 0, 1426.0, -3.4, 54.0, -0.1),
    (0, 0, 1, 0, 0, 712.0, 0.1, -7.0, 0.0),
    (-2, 1, 0, 2, 2, -517.0, 1.2, 224.0, -0.6),
    (0, 0, 0, 2, 1, -386.0, -0.4, 200.0, 0.0),
    (0, 0, 1, 2, 2, -301.0, 0.0, 129.0, -0.1),
    (-2, -1, 0, 2, 2, 217.0, -0.5, -95.0, 0.3),
    (-2, 0, 1, 0, 0, -158.0, 0.0, 0.0, 0.0),
    (-2, 0, 0, 2, 1, 129.0, 0.1, -70.0, 0.0),
    (0, 0, -1, 2, 2, 123.0, 0.0, -53.0, 0.0),
    (2, 0, 0, 0, 0, 63.0, 0.0, 0.0, 0.0),
    (0, 0, 1, 0, 1, 63.0, 0.1, -33.0, 0.0),
    (2, 0, -1, 2, 2, -59.0, 0.0, 26.0, 0.0),
    (0, 0, -1, 0, 1, -58.0, -0.1, 32.0, 0.0),
    (0, 0, 1, 2, 1, -51.0, 0.0, 27.0, 0.0),
]


def nutation_deg(T: float) -> tuple[float, float]:
    """(Delta-psi, Delta-epsilon) in degrees (Meeus ch. 22 arguments)."""
    D = 297.85036 + 445267.111480 * T - 0.0019142 * T * T + T**3 / 189474.0
    M = 357.52772 + 35999.050340 * T - 0.0001603 * T * T - T**3 / 300000.0
    Mp = 134.96298 + 477198.867398 * T + 0.0086972 * T * T + T**3 / 56250.0
    F = 93.27191 + 483202.017538 * T - 0.0036825 * T * T + T**3 / 327270.0
    Om = 125.04452 - 1934.136261 * T + 0.0020708 * T * T + T**3 / 450000.0
    dpsi = 0.0
    deps = 0.0
    for d, m, mp, f, om, ps0, ps1, ep0, ep1 in _NUTATION_TERMS:
        arg = (d * D + m * M + mp * Mp + f * F + om * Om) * DEG
        dpsi += (ps0 + ps1 * T) * math.sin(arg)
        deps += (ep0 + ep1 * T) * math.cos(arg)
    return dpsi * 1e-4 / 3600.0, deps * 1e-4 / 3600.0


def ecliptic_to_equatorial(lam_deg: float, beta_deg: float, eps_deg: float) -> np.ndarray:
    """Unit vector in the equatorial frame from ecliptic lon/lat."""
    lam, beta, eps = lam_deg * DEG, beta_deg * DEG, eps_deg * DEG
    xe = math.cos(beta) * math.cos(lam)
    ye = math.cos(beta) * math.sin(lam)
    ze = math.sin(beta)
    return np.array([
        xe,
        ye * math.cos(eps) - ze * math.sin(eps),
        ye * math.sin(eps) + ze * math.cos(eps),
    ])


def equatorial_to_ecliptic_matrix(eps_deg: float) -> np.ndarray:
    """Matrix taking equatorial-of-date vectors to ecliptic-of-date."""
    return rot_x(eps_deg * DEG).T  # inverse of the rotation in ecliptic_to_equatorial


def radec_from_vector(v: np.ndarray) -> tuple[float, float]:
    """(RA, Dec) in degrees from an equatorial vector."""
    r = np.linalg.norm(v)
    dec = math.degrees(math.asin(v[2] / r))
    ra = math.degrees(math.atan2(v[1], v[0])) % 360.0
    return ra, dec


def spherical_from_vector(v: np.ndarray) -> tuple[float, float]:
    """(lat, lon) degrees from a frame vector (lon from +X toward +Y),
    matching the reference body-frame convention (astro.py:77-84)."""
    r = np.linalg.norm(v)
    lat = math.degrees(math.asin(v[2] / r))
    lon = math.degrees(math.atan2(v[1], v[0]))
    return lat, lon


def angular_separation_deg(v1: np.ndarray, v2: np.ndarray) -> float:
    """Robust angle between vectors (atan2 form, reference astro.py:192-195)."""
    return math.degrees(math.atan2(
        np.linalg.norm(np.cross(v1, v2)), float(np.dot(v1, v2))
    ))


def position_angle_deg(ra1_deg: float, dec1_deg: float,
                       ra2_deg: float, dec2_deg: float) -> float:
    """Position angle of point 2 about point 1, from celestial North toward
    East (Meeus 48.5). Used for the bright-limb angle (reference astro.py:170)."""
    ra1, dec1 = ra1_deg * DEG, dec1_deg * DEG
    ra2, dec2 = ra2_deg * DEG, dec2_deg * DEG
    dra = ra2 - ra1
    num = math.cos(dec2) * math.sin(dra)
    den = (math.sin(dec2) * math.cos(dec1)
           - math.cos(dec2) * math.sin(dec1) * math.cos(dra))
    return math.degrees(math.atan2(num, den)) % 360.0


def refraction_deg(alt_deg: float) -> float:
    """Atmospheric refraction at standard conditions (Bennett 1982), degrees.

    Matches Skyfield's altaz(temperature_C='standard') model class
    (reference astro.py:167) to within a few arcseconds.
    """
    if alt_deg < -1.0:
        return 0.0
    r_arcmin = 1.0 / math.tan((alt_deg + 7.31 / (alt_deg + 4.4)) * DEG)
    return max(r_arcmin, 0.0) / 60.0
