# Frozen copy of moonrtx_tpu_torch/astro/timebase.py at commit 41cfce49f52c, for the benchmark's
# plain reference, trimmed to what the reference reaches; imports renamed.
"""Time scales: UTC -> TT Julian centuries, Delta-T, sidereal time.

Replaces the reference's Skyfield timescale (reference astro.py:140,
skyfield_utils.py:77-78) with standard analytic expressions
(Meeus, *Astronomical Algorithms*; Espenak & Meeus Delta-T polynomials).
"""

from __future__ import annotations

import math
from datetime import datetime, timezone

from reference.moonref import constants as C

J2000_JD = 2451545.0

EPHEMERIS_START_UTC = datetime(C.EPHEMERIS_START_YEAR, 1, 1, tzinfo=timezone.utc)
EPHEMERIS_END_UTC = datetime(C.EPHEMERIS_END_YEAR, 1, 1, tzinfo=timezone.utc)


def validate_supported_datetime(dt_local: datetime) -> datetime:
    """Clamp-check the supported 1900-2051 range (reference astro.py:43-52)."""
    if dt_local.tzinfo is None:
        raise ValueError("Time without timezone information.")
    dt_utc = dt_local.astimezone(timezone.utc)
    if dt_utc < EPHEMERIS_START_UTC or dt_utc > EPHEMERIS_END_UTC:
        raise ValueError(
            "Moon ephemeris supports dates from "
            f"{EPHEMERIS_START_UTC.isoformat()} through "
            f"{EPHEMERIS_END_UTC.isoformat()}; received {dt_utc.isoformat()}."
        )
    return dt_utc


def julian_day_utc(dt_utc: datetime) -> float:
    """Julian day number of a UTC datetime."""
    y, m = dt_utc.year, dt_utc.month
    d = (
        dt_utc.day
        + (dt_utc.hour + (dt_utc.minute + (dt_utc.second + dt_utc.microsecond / 1e6) / 60.0) / 60.0) / 24.0
    )
    if m <= 2:
        y -= 1
        m += 12
    a = y // 100
    b = 2 - a + a // 4
    return math.floor(365.25 * (y + 4716)) + math.floor(30.6001 * (m + 1)) + d + b - 1524.5


def delta_t_seconds(year_frac: float) -> float:
    """TT - UT1 in seconds (Espenak & Meeus polynomial fits, adjusted to the
    observed flattening of Delta-T after 2016; accuracy of a few seconds is
    ample for sub-arcsecond lunar work: the Moon moves ~0.55 arcsec/s)."""
    y = year_frac
    if y < 1920:
        t = y - 1900
        return -2.79 + 1.494119 * t - 0.0598939 * t**2 + 0.0061966 * t**3 - 0.000197 * t**4
    if y < 1941:
        t = y - 1920
        return 21.20 + 0.84493 * t - 0.076100 * t**2 + 0.0020936 * t**3
    if y < 1961:
        t = y - 1950
        return 29.07 + 0.407 * t - t**2 / 233.0 + t**3 / 2547.0
    if y < 1986:
        t = y - 1975
        return 45.45 + 1.067 * t - t**2 / 260.0 - t**3 / 718.0
    if y < 2005:
        t = y - 2000
        return (63.86 + 0.3345 * t - 0.060374 * t**2 + 0.0017275 * t**3
                + 0.000651814 * t**4 + 0.00002373599 * t**5)
    if y < 2017:
        t = y - 2005
        return 64.69 + 0.393 * t
    # Delta-T plateaued near 69.3 s after the mid-2010s (no leap second since
    # 2017); use a gentle projected rise for the 2030s-2050s.
    t = y - 2017
    return 69.0 + 0.05 * t + 0.003 * t**2


def year_fraction(dt_utc: datetime) -> float:
    start = datetime(dt_utc.year, 1, 1, tzinfo=timezone.utc)
    end = datetime(dt_utc.year + 1, 1, 1, tzinfo=timezone.utc)
    return dt_utc.year + (dt_utc - start).total_seconds() / (end - start).total_seconds()


class TimeScales:
    """All derived time quantities for one instant."""

    def __init__(self, dt_utc: datetime):
        self.dt_utc = dt_utc
        self.jd_utc = julian_day_utc(dt_utc)
        self.delta_t = delta_t_seconds(year_fraction(dt_utc))
        # UT1 ~ UTC within 0.9 s; below every error term we carry.
        self.jd_ut1 = self.jd_utc
        self.jd_tt = self.jd_utc + self.delta_t / 86400.0
        self.T = (self.jd_tt - J2000_JD) / 36525.0  # TT Julian centuries

    def gmst_deg(self) -> float:
        """Greenwich mean sidereal time, degrees (Meeus ch. 12)."""
        d = self.jd_ut1 - J2000_JD
        t = d / 36525.0
        theta = (280.46061837 + 360.98564736629 * d
                 + 0.000387933 * t * t - t**3 / 38710000.0)
        return theta % 360.0


def timescales(dt_local: datetime) -> TimeScales:
    return TimeScales(validate_supported_datetime(dt_local))
