# Frozen copy of moonrtx_tpu_torch/engine/light.py at commit 41cfce49f52c, for the benchmark's
# plain reference, trimmed to what the reference reaches; imports renamed.
"""Ephemeris-driven light and Sun-disk geometry (host, numpy).

Reproduces the reference's spherical light placement from the bright-limb
and phase angles (moon_renderer.py:505-579) and the magnification-scaled
visible Sun disk including eclipse-consistent sizing and the >90 deg
parking rule (moon_renderer.py:582-624).
"""

from __future__ import annotations

import math

import numpy as np

from reference.moonref import constants as C
from reference.moonref.types import MoonEphemeris


def calculate_light_pos(ephem: MoonEphemeris) -> np.ndarray:
    """Sun light position in scene coordinates.

    Scene frame: camera on -Y looking +Y, +X right, +Z up. Using spherical
    coordinates about the -Y axis: theta = phase angle (0 = behind camera),
    phi = bright-limb angle from +Z toward -X (0 deg = bright limb up,
    +90 deg = bright limb left/east).
    """
    bla = math.radians(ephem.bright_limb_angle)
    phase = math.radians(ephem.phase_angle)
    d = C.SUN_LIGHT_DISTANCE
    return np.array([
        -math.sin(bla) * math.sin(phase) * d,
        -math.cos(phase) * d,
        math.cos(bla) * math.sin(phase) * d,
    ])


def sun_light_radius(ephem: MoonEphemeris) -> float:
    """Light-sphere radius following the true solar angular size of the date
    (annual +/-1.7% variation; reference moon_renderer.py:659-663)."""
    return float(C.SUN_LIGHT_DISTANCE * C.SUN_RADIUS_KM / ephem.sun_distance)


def calculate_sun_disk(ephem: MoonEphemeris) -> tuple[np.ndarray, float]:
    """(center, radius) of the visible Sun disk in scene coordinates.

    Decoupled from the light source: the rendered Moon is magnified relative
    to its real ~0.5 deg apparent size, so the disk's apparent size and
    separation are scaled by the same magnification (telescope view), keeping
    eclipse geometry consistent. Beyond 90 deg separation the disk is parked
    behind the camera with negligible size.
    """
    magnification = (math.asin(C.MOON_RADIUS / C.CAMERA_DISTANCE)
                     / math.asin(C.MOON_RADIUS_KM / ephem.distance))
    sun_ang_radius = magnification * math.asin(C.SUN_RADIUS_KM / ephem.sun_distance)
    separation = magnification * math.radians(ephem.elongation)

    in_view = separation <= math.pi / 2
    if not in_view:
        separation = math.radians(175.0)

    bla = math.radians(ephem.bright_limb_angle)
    sin_sep = math.sin(separation)
    direction = np.array([
        -math.sin(bla) * sin_sep,
        math.cos(separation),
        math.cos(bla) * sin_sep,
    ])
    center = np.array([0.0, -C.CAMERA_DISTANCE, 0.0]) + C.SUN_DISK_DISTANCE * direction
    radius = C.SUN_DISK_DISTANCE * math.tan(sun_ang_radius) if in_view else 0.01
    return center, float(radius)


def sun_irradiance_factor(brightness: int, ephem: MoonEphemeris) -> float:
    """Linear surface irradiance scale.

    The reference calibrates the emitting sphere's radiance so illumination =
    radiance x solid angle, independent of light distance
    (moon_renderer.py:54-60). Equivalent closed form used here:
    E = brightness * SUN_BRIGHTNESS_SCALE * sin^2(light angular radius),
    which reproduces both the brightness control and the real annual 1/d^2
    solar variation.
    """
    sin_ang = sun_light_radius(ephem) / C.SUN_LIGHT_DISTANCE
    return float(brightness * C.SUN_BRIGHTNESS_SCALE * sin_ang * sin_ang)


def lunar_lambert_blend(phase_angle_deg: float) -> float:
    """Lunar-Lambert limb-darkening parameter L(alpha).

    The lunar regolith is not Lambertian: near full Moon the disk looks
    almost uniformly bright (Lommel-Seeliger back-scattering), while a
    Lambert sphere would darken strongly toward the limb. McEwen's (1991,
    "Photometric functions for photoclinometry") lunar-Lambert model
    blends the two, I = A * (2L*mu0/(mu0+mu_e) + (1-L)*mu0), with L a
    function of phase angle alone — and the phase angle is constant
    across the lunar disk to <0.5 deg, so L is one host scalar per frame.
    Cubic fit to McEwen's tabulated Moon values, clamped to [0, 1]:
    L(0)=1 (pure Lommel-Seeliger at opposition), decreasing toward pure
    Lambert at large phase. The reference's OptiX engine shades pure
    diffuse (Lambert); --photometric lunar is this framework's
    physically-better option, --photometric lambert (default) matches
    the reference.
    """
    a = float(phase_angle_deg)
    lval = 1.0 - 0.019 * a + 2.42e-4 * a * a - 1.46e-6 * a * a * a
    return float(min(1.0, max(0.0, lval)))


def earthshine_fraction(phase_angle_deg: float) -> float:
    """Illuminated fraction of the Earth as seen from the Moon.

    The Earth's phase seen from the Moon is the supplement of the Moon's
    phase seen from Earth: full Earth over the new Moon (strongest
    earthshine, the "da Vinci glow"), new Earth over the full Moon (none).
    fraction = (1 - cos(moon phase angle)) / 2.
    """
    return 0.5 * (1.0 - math.cos(math.radians(float(phase_angle_deg))))
