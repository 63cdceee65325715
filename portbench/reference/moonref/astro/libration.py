# Frozen copy of moonrtx_tpu_torch/astro/libration.py at commit 41cfce49f52c, for the benchmark's
# plain reference, trimmed to what the reference reaches; imports renamed.
"""Lunar orientation: physical libration and the body-frame rotation matrix.

Replaces the MOON_ME_DE421 binary-PCK frame (reference skyfield_utils.py:92-113)
with the classical analytic theory (mean lunar equator I=1.54242 deg to the
ecliptic + Eckhardt physical-libration series as tabulated by Meeus ch. 53),
accurate to ~0.01 deg of surface orientation (~300 m), below a full-resolution
LDEM texel's shading significance for this application.

Frame convention matches the Skyfield/NAIF mean-Earth frame consumed by the
reference (astro.py:77-84): +X prime meridian (mean Earth direction),
+Z north pole; latitude = asin(z), longitude = atan2(y, x).
"""

from __future__ import annotations

import math

import numpy as np

from reference.moonref.astro.moon import MoonArguments

DEG = math.pi / 180.0

# Inclination of the mean lunar equator to the ecliptic.
MEAN_INCLINATION_DEG = 1.54242


def physical_libration(a: MoonArguments, T: float) -> tuple[float, float, float]:
    """(rho, sigma, tau) in degrees (Eckhardt series, Meeus ch. 53)."""
    Mr, Mpr, Fr, Dr = a.M * DEG, a.Mp * DEG, a.F * DEG, a.D * DEG
    Om = a.Om * DEG
    K1 = (119.75 + 131.849 * T) * DEG
    K2 = (72.56 + 20.186 * T) * DEG
    E = a.E

    rho = (-0.02752 * math.cos(Mpr)
           - 0.02245 * math.sin(Fr)
           + 0.00684 * math.cos(Mpr - 2 * Fr)
           - 0.00293 * math.cos(2 * Fr)
           - 0.00085 * math.cos(2 * Fr - 2 * Dr)
           - 0.00054 * math.cos(Mpr - 2 * Dr)
           - 0.00020 * math.sin(Mpr + Fr)
           - 0.00020 * math.cos(Mpr + 2 * Fr)
           - 0.00020 * math.cos(Mpr - Fr)
           + 0.00014 * math.cos(Mpr + 2 * Fr - 2 * Dr))

    sigma = (-0.02816 * math.sin(Mpr)
             + 0.02244 * math.cos(Fr)
             - 0.00682 * math.sin(Mpr - 2 * Fr)
             - 0.00279 * math.sin(2 * Fr)
             - 0.00083 * math.sin(2 * Fr - 2 * Dr)
             + 0.00069 * math.sin(Mpr - 2 * Dr)
             + 0.00040 * math.cos(Mpr + Fr)
             - 0.00025 * math.sin(2 * Mpr)
             - 0.00023 * math.sin(Mpr + 2 * Fr)
             + 0.00020 * math.cos(Mpr - Fr)
             + 0.00019 * math.sin(Mpr - Fr)
             + 0.00013 * math.sin(Mpr + 2 * Fr - 2 * Dr)
             - 0.00010 * math.cos(Mpr - 3 * Fr))

    tau = (0.02520 * E * math.sin(Mr)
           + 0.00473 * math.sin(2 * Mpr - 2 * Fr)
           - 0.00467 * math.sin(Mpr)
           + 0.00396 * math.sin(K1)
           + 0.00276 * math.sin(2 * Mpr - 2 * Dr)
           + 0.00196 * math.sin(Om)
           - 0.00183 * math.cos(Mpr - Fr)
           + 0.00115 * math.sin(Mpr - 2 * Dr)
           - 0.00096 * math.sin(Mpr - Dr)
           + 0.00046 * math.sin(2 * Fr - 2 * Dr)
           - 0.00039 * math.sin(Mpr - Fr)
           - 0.00032 * math.sin(Mpr - Mr - Dr)
           + 0.00027 * math.sin(2 * Mpr - Mr - 2 * Dr)
           + 0.00023 * math.sin(K2)
           - 0.00014 * math.sin(2 * Dr)
           + 0.00014 * math.cos(2 * Mpr - 2 * Fr)
           - 0.00012 * math.sin(Mpr - 2 * Fr)
           - 0.00012 * math.sin(2 * Mpr)
           + 0.00011 * math.sin(2 * Mpr - 2 * Mr - 2 * Dr))

    return rho, sigma, tau


def body_from_ecliptic_matrix(a: MoonArguments, T: float,
                              dpsi_deg: float) -> np.ndarray:
    """Rotation matrix taking true-ecliptic-of-date vectors to the lunar
    mean-Earth body frame.

    The true lunar equator has its node on the ecliptic at longitude
    N = Omega + Delta-psi + sigma/sin(I) and inclination I + rho; the prime
    meridian (mean Earth direction) sits at angle F + 180 deg + tau from
    that node, corrected by the equator-projected node displacement
    -sigma*cot(I) (this chain reproduces Meeus's optical formulas 53.1 and
    the physical corrections l''/b'' exactly; verified in tests).
    """
    rho, sigma, tau = physical_libration(a, T)
    I0 = MEAN_INCLINATION_DEG * DEG
    inc = I0 + rho * DEG
    N = (a.Om + dpsi_deg) * DEG + sigma * DEG / math.sin(I0)
    theta = (a.F + 180.0 + tau) * DEG - sigma * DEG / math.tan(I0)

    from reference.moonref.astro.frames import rot_x, rot_z
    return rot_z(-theta) @ rot_x(inc) @ rot_z(-N)
