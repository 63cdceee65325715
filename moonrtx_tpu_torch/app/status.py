"""Status-bar and info-panel text formatting
(reference renderer_status.py:41-102 conventions)."""

from __future__ import annotations

import math
from typing import Optional

from moonrtx_tpu_torch.types import MoonEphemeris, MoonFeature


def fmt_dms(value_deg: float, signed: bool = True) -> str:
    """Degrees -> D°MM'SS" string."""
    sign = "-" if value_deg < 0 else ("+" if signed else "")
    v = abs(value_deg)
    d = int(v)
    m = int((v - d) * 60)
    s = (v - d - m / 60.0) * 3600.0
    return f"{sign}{d}°{m:02d}'{s:04.1f}\""


def fmt_hms(ra_deg: float) -> str:
    """Right ascension degrees -> HhMMmSSs."""
    hours = (ra_deg % 360.0) / 15.0
    h = int(hours)
    m = int((hours - h) * 60)
    s = (hours - h - m / 60.0) * 3600.0
    return f"{h}h{m:02d}m{s:04.1f}s"


def illumination_percent(phase_angle_deg: float) -> float:
    """Illuminated disk fraction from the phase angle
    (reference renderer_status.py:97)."""
    return (1.0 + math.cos(math.radians(phase_angle_deg))) / 2.0 * 100.0


def info_panel_rows(e: MoonEphemeris) -> list[tuple[str, str]]:
    """The 14-row ephemeris panel (reference renderer_status.py:294-340)."""
    return [
        ("Azimuth", fmt_dms(e.az, signed=False)),
        ("Altitude", fmt_dms(e.alt)),
        ("RA", fmt_hms(e.ra)),
        ("Dec", fmt_dms(e.dec)),
        ("Distance", f"{e.distance:,.0f} km"),
        ("Sun distance", f"{e.sun_distance / 1e6:,.2f} Mkm"),
        ("Phase", e.phase_name),
        ("Illumination", f"{illumination_percent(e.phase_angle):.1f}%"),
        ("Phase angle", f"{e.phase_angle:.2f}°"),
        ("Elongation", f"{e.elongation:.2f}°"),
        ("Libration lon", f"{e.libr_long_topo:+.2f}°"),
        ("Libration lat", f"{e.libr_lat_topo:+.2f}°"),
        ("Colongitude", f"{e.colongitude:.2f}°"),
        ("Bright limb", f"{e.bright_limb_angle:+.1f}°"),
    ]


def coords_text(lat: Optional[float], lon: Optional[float]) -> str:
    if lat is None or lon is None:
        return ""
    ns = "N" if lat >= 0 else "S"
    ew = "E" if lon >= 0 else "W"
    return f"{abs(lat):.2f}°{ns} {abs(lon):.2f}°{ew}"


def feature_text(feature: Optional[MoonFeature]) -> str:
    if feature is None:
        return ""
    return f"{feature.name} ({feature.diameter_km:.1f} km)"


def memory_warning_text(over_budget: Optional[dict]) -> str:
    """Status-bar warning when even the fully-banded heightfield plan
    exceeds the per-device memory budget (the reference's
    scene._plan_bands hfshard_over_budget): empty when fine."""
    if not over_budget:
        return ""
    return ("HBM over budget: "
            f"{over_budget['projected_bytes'] / 2**30:.1f}"
            f"/{over_budget['budget_bytes'] / 2**30:.1f} GiB per chip")


def measured_text(distance_km: Optional[float],
                  height_diff_m: Optional[float]) -> str:
    if distance_km is None:
        return ""
    txt = f"Measured: {distance_km:.1f} km"
    if height_diff_m is not None:
        txt += f", Δh {height_diff_m:+.0f} m"
    return txt
