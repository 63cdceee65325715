# Frozen copy of moonrtx_tpu_torch/astro/ephemeris.py at commit 41cfce49f52c, for the benchmark's
# plain reference, trimmed to what the reference reaches; imports renamed.
"""Full topocentric Moon ephemeris.

Produces the same quantities, conventions and rotation-matrix chain as the
reference (astro.py:137-217) from the analytic theories in this package
instead of Skyfield + JPL kernels. Everything is computed in the true
equator & equinox of date frame; the body->scene ``rotation_matrix`` chain
mirrors reference astro.py:87-110.
"""

from __future__ import annotations

import math
from datetime import datetime

import numpy as np

from reference.moonref.astro import frames, libration
from reference.moonref.astro.moon import moon_arguments, moon_geometric
from reference.moonref.astro.sun import sun_apparent_lon
from reference.moonref.astro.timebase import timescales
from reference.moonref.types import MoonEphemeris, Observer

DEG = math.pi / 180.0

EARTH_EQ_RADIUS_KM = 6378.137
EARTH_FLATTENING = 1.0 / 298.257223563

# Renderer body frame -> selenographic (mean-Earth) frame axis swap
# (reference astro.py:19-24): renderer has lon 0 at -Y, +X at lon 90E.
RENDERER_TO_SELENO = np.array(
    [[0.0, -1.0, 0.0],
     [1.0, 0.0, 0.0],
     [0.0, 0.0, 1.0]]
)


def _observer_position_eq(observer: Observer, gast_deg: float) -> np.ndarray:
    """Geocentric observer position (km) in the true equatorial-of-date frame."""
    lat = observer.lat * DEG
    u = math.atan((1.0 - EARTH_FLATTENING) * math.tan(lat))
    h_km = observer.elevation_m / 1000.0
    rho_sin = (1.0 - EARTH_FLATTENING) * math.sin(u) + h_km / EARTH_EQ_RADIUS_KM * math.sin(lat)
    rho_cos = math.cos(u) + h_km / EARTH_EQ_RADIUS_KM * math.cos(lat)
    lst = (gast_deg + observer.lon) * DEG  # local apparent sidereal time
    return EARTH_EQ_RADIUS_KM * np.array([
        rho_cos * math.cos(lst),
        rho_cos * math.sin(lst),
        rho_sin,
    ])


def _altaz(v_eq: np.ndarray, observer: Observer, gast_deg: float) -> tuple[float, float]:
    """(alt, az) degrees incl. standard refraction, from a topocentric
    equatorial-of-date vector. Az from North through East."""
    lat = observer.lat * DEG
    lst = (gast_deg + observer.lon) * DEG
    zenith = np.array([math.cos(lat) * math.cos(lst),
                       math.cos(lat) * math.sin(lst),
                       math.sin(lat)])
    east = frames.normalize(np.cross(np.array([0.0, 0.0, 1.0]), zenith))
    north = np.cross(zenith, east)
    u = frames.normalize(v_eq)
    alt = math.degrees(math.asin(float(np.clip(np.dot(u, zenith), -1.0, 1.0))))
    az = math.degrees(math.atan2(float(np.dot(u, east)), float(np.dot(u, north)))) % 360.0
    return alt + frames.refraction_deg(alt), az


def _parallactic_angle_deg(hour_angle_deg: float, dec_deg: float, lat_deg: float) -> float:
    """Field-rotation angle q (reference astro.py:67-74)."""
    H = hour_angle_deg * DEG
    dec = dec_deg * DEG
    lat = lat_deg * DEG
    return math.degrees(math.atan2(
        math.sin(H),
        math.tan(lat) * math.cos(dec) - math.sin(dec) * math.cos(H),
    ))


def _phase_name(moon_ecl_lon: float, sun_ecl_lon: float) -> str:
    """0.5-degree bins on the geocentric ecliptic-longitude difference
    (reference astro.py:113-134)."""
    delta = (moon_ecl_lon - sun_ecl_lon) % 360.0
    if delta < 0.5 or delta > 359.5:
        return "New Moon"
    if delta < 89.5:
        return "Waxing Crescent"
    if delta < 90.5:
        return "First Quarter"
    if delta < 179.5:
        return "Waxing Gibbous"
    if delta < 180.5:
        return "Full Moon"
    if delta < 269.5:
        return "Waning Gibbous"
    if delta < 270.5:
        return "Last Quarter"
    return "Waning Crescent"


def _view_rotation_matrix(body_from_eq: np.ndarray, moon_ra_deg: float,
                          moon_dec_deg: float, q_deg: float) -> np.ndarray:
    """Body->scene matrix (reference astro.py:87-110): view basis rows are
    (right, sight, up) built from the Moon's RA/Dec with the view up-vector
    rotated by the parallactic angle q from celestial north."""
    ra, dec = moon_ra_deg * DEG, moon_dec_deg * DEG
    sight = np.array([math.cos(dec) * math.cos(ra),
                      math.cos(dec) * math.sin(ra),
                      math.sin(dec)])
    east = np.array([-math.sin(ra), math.cos(ra), 0.0])
    north = np.array([-math.sin(dec) * math.cos(ra),
                      -math.sin(dec) * math.sin(ra),
                      math.cos(dec)])
    q = q_deg * DEG
    up = frames.normalize(math.sin(q) * east + math.cos(q) * north)
    right = frames.normalize(np.cross(sight, up))
    view_basis = np.vstack([right, sight, up])
    body_to_eq = body_from_eq.T
    return view_basis @ body_to_eq @ RENDERER_TO_SELENO


def calculate_moon_ephemeris(dt_local: datetime, observer: Observer,
                             parallactic_mode: bool = False) -> MoonEphemeris:
    """Compute the complete topocentric Moon ephemeris.

    Mirrors reference astro.py:137-217 field-for-field.
    """
    ts = timescales(dt_local)
    T = ts.T

    dpsi, deps = frames.nutation_deg(T)
    eps = frames.mean_obliquity_deg(T) + deps
    gast = (ts.gmst_deg() + dpsi * math.cos(eps * DEG)) % 360.0

    # Geocentric positions (true equator & equinox of date), km.
    args = moon_arguments(T)
    lam_m, beta_m, dist_m = moon_geometric(T, args)
    lam_m_app = (lam_m + dpsi) % 360.0
    moon_geo = frames.ecliptic_to_equatorial(lam_m_app, beta_m, eps) * dist_m

    lam_s_app, dist_s, lam_s_geo = sun_apparent_lon(T, dpsi)
    sun_geo = frames.ecliptic_to_equatorial(lam_s_app, 0.0, eps) * dist_s

    obs_geo = _observer_position_eq(observer, gast)

    moon_topo = moon_geo - obs_geo
    sun_topo = sun_geo - obs_geo

    moon_ra, moon_dec = frames.radec_from_vector(moon_topo)
    sun_ra, sun_dec = frames.radec_from_vector(sun_topo)

    # Parallactic angle (0 in parallactic-mount mode, reference astro.py:156-165).
    if parallactic_mode:
        q_deg = 0.0
    else:
        lst = (gast + observer.lon) % 360.0
        hour_angle = (lst - moon_ra) % 360.0
        q_deg = _parallactic_angle_deg(hour_angle, moon_dec, observer.lat)

    alt, az = _altaz(moon_topo, observer, gast)

    elongation = frames.angular_separation_deg(moon_topo, sun_topo)
    bright_limb = frames.position_angle_deg(moon_ra, moon_dec, sun_ra, sun_dec) - q_deg
    # geometric vs geometric (reference astro.py:171-173): nutation and
    # aberration must not enter the 0.5-deg phase bins
    phase_name = _phase_name(lam_m, lam_s_geo)

    # Lunar body frame (true equatorial of date -> mean-Earth body frame).
    body_from_ecl = libration.body_from_ecliptic_matrix(args, T, dpsi)
    eq_to_ecl = frames.equatorial_to_ecliptic_matrix(eps)
    body_from_eq = body_from_ecl @ eq_to_ecl

    earth_from_moon = -moon_geo
    observer_from_moon = obs_geo - moon_geo
    libr_lat_geo, libr_lon_geo = frames.spherical_from_vector(body_from_eq @ earth_from_moon)
    libr_lat_topo, libr_lon_topo = frames.spherical_from_vector(body_from_eq @ observer_from_moon)

    sun_from_moon = sun_geo - moon_geo
    _, sun_lon_moon = frames.spherical_from_vector(body_from_eq @ sun_from_moon)
    colongitude = (90.0 - frames.wrap180(sun_lon_moon)) % 360.0

    phase_angle = frames.angular_separation_deg(sun_from_moon, observer_from_moon)
    moon_distance_km = float(np.linalg.norm(observer_from_moon))
    sun_distance_km = float(np.linalg.norm(sun_topo))

    rotation_matrix = _view_rotation_matrix(body_from_eq, moon_ra, moon_dec, q_deg)

    return MoonEphemeris(
        az=az,
        alt=alt,
        ra=moon_ra,
        dec=moon_dec,
        distance=moon_distance_km,
        sun_distance=sun_distance_km,
        phase_angle=phase_angle,
        bright_limb_angle=frames.wrap180(bright_limb),
        libr_long_geo=frames.wrap180(libr_lon_geo),
        libr_lat_geo=libr_lat_geo,
        libr_long_topo=frames.wrap180(libr_lon_topo),
        libr_lat_topo=libr_lat_topo,
        elongation=elongation,
        phase_name=phase_name,
        colongitude=colongitude,
        rotation_matrix=rotation_matrix,
    )
