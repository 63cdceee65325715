# Frozen copy of moonrtx_tpu_torch/types.py at commit 41cfce49f52c, for the benchmark's
# plain reference, trimmed to what the reference reaches; imports renamed.
"""Shared value types.

Functional counterparts of the reference's NamedTuples
(reference shared_types.py) plus engine-side pytrees.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class MoonEphemeris(NamedTuple):
    """Full topocentric Moon ephemeris (reference shared_types.py:5-21).

    Angles in degrees, distances in km. ``rotation_matrix`` maps body-frame
    (renderer selenographic) vectors to scene coordinates:
    ``scene = R @ body`` (reference astro.py:87-110).
    """

    az: float
    alt: float
    ra: float
    dec: float
    distance: float
    sun_distance: float
    phase_angle: float
    bright_limb_angle: float
    libr_long_geo: float
    libr_lat_geo: float
    libr_long_topo: float
    libr_lat_topo: float
    elongation: float
    phase_name: str
    colongitude: float
    rotation_matrix: np.ndarray


class Camera(NamedTuple):
    """Pinhole camera (reference shared_types.py:35-43)."""

    eye: list
    target: list
    up: list
    fov: float
    type: str = "Pinhole"
    aperture_radius: float = 0.01
    aperture_fract: float = 0.2
    focal_scale: float = 0.7


class Observer(NamedTuple):
    """Earth-surface observer (reference shared_types.py:45-48)."""

    lat: float
    lon: float
    elevation_m: int
