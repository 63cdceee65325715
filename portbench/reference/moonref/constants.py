# Frozen copy of moonrtx_tpu_torch/constants.py at commit 41cfce49f52c, for the benchmark's
# plain reference, trimmed to what the reference reaches; imports renamed.
"""Scene and physical constants.

Values and their derivations mirror the reference scene setup
(reference moon_renderer.py:34-90) so that saved views, light geometry and
shadow behavior are interchangeable with the reference application, while
the renderer itself is a different (TPU-native) implementation.
"""

# --- Physical constants -----------------------------------------------------

MOON_RADIUS_KM = 1737.4           # reference renderer_navigation.py:16
MOON_REFERENCE_RADIUS_M = 1_737_400.0
SUN_RADIUS_KM = 695_700.0         # reference moon_renderer.py:81
LDEM_METERS_PER_UNIT = 0.5        # LOLA LDEM int16 scale (data_loader.py:116)
AU_KM = 149_597_870.7

# --- Scene geometry (scene units) -------------------------------------------

MOON_RADIUS = 10.0                # bounding-sphere radius of the displaced Moon
MOON_FILL_FRACTION = 0.9          # Moon fills 90% of window height
# 30 radii: limb cap 88.1 deg vs 89.7 real; larger distances degrade float32
# ray precision (reference moon_renderer.py:36-41).
CAMERA_DISTANCE = MOON_RADIUS * 30.0

# Sun light distance/radius preserving the 0.267 deg solar angular size as
# seen from the Moon: arcsin(100/21460); terminator parallax error 0.027 deg
# of selenographic longitude (reference moon_renderer.py:43-53).
SUN_LIGHT_DISTANCE = 21460.0
SUN_RADIUS = 100.0
# Radiance calibration: illumination = radiance x solid angle, independent of
# light distance; kept from the original tuning (reference moon_renderer.py:54-60).
SUN_BRIGHTNESS_SCALE = (2146.0 / 100.0) ** 2

# Visible Sun disk, decoupled from the light source (moon_renderer.py:78-86).
SUN_DISK_DISTANCE = 3100.0
SUN_DISK_COLOR = 2.0

# Default shadow behavior. In the reference these control an OptiX ray-march
# epsilon (moon_renderer.py:62-76); in this engine the "fast" mode uses the
# analytic smooth-sphere terminator only, and "accurate" mode enables the
# exact heightfield shadow scan (see reference.moonref.ops.shadow_scan). The factor
# maps to the shadow-scan resolution multiplier.
DEFAULT_SCENE_EPSILON = 1.5e-3
ACCURATE_SHADOW_FACTOR = 10

# --- Render parameters -------------------------------------------------------

MAX_ACCUMULATION_FRAMES = 32      # reference moon_renderer.py:440
MIN_ACCUMULATION_STEP = 1
PATH_SEG_RANGE = (2, 4)           # reference moon_renderer.py:445
TONEMAP_EXPOSURE = 0.9            # reference moon_renderer.py:452

DEFAULT_BRIGHTNESS = 80
DEFAULT_GAMMA = 2.2
DEFAULT_DOWNSCALE = 3
DEFAULT_TIME_STEP_MINUTES = 15
DEFAULT_SHADOW_ACCURACY = 1

BRIGHTNESS_RANGE = (0, 500)
GAMMA_RANGE = (0.5, 5.0)
FOV_RANGE = (0.3, 90.0)           # zoom clamp (renderer_navigation.py:513-516)
TIME_STEP_RANGE = (1, 1440)
SHADOW_ACCURACY_RANGE = (1, 20)
ELEVATION_RANGE_M = (0, 100000)

# Supported ephemeris date range (reference skyfield_utils.py:20-21 bounds the
# bundled JPL kernels; our analytic series are validated on the same span).
EPHEMERIS_START_YEAR = 1900
EPHEMERIS_END_YEAR = 2051

# Feature angular radius conversion: diameter_km -> degrees of arc on the
# lunar surface. 2*pi*1737.4/360 = 30.323 km/deg of arc; the reference uses
# diameter/60.647 (= radius in degrees), data_loader.py:97.
FEATURE_KM_PER_DEG = 60.647

# ---- lunar eclipse shading ---------------------------------------------------
# The reference has no Earth in its scene, so it renders an ordinary full
# Moon during a lunar eclipse. Here each shaded point attenuates the solar
# irradiance by the visible-sun fraction against the Earth's disk (umbra/
# penumbra emerge from the circle-overlap geometry; the Earth direction's
# ~0.25 deg parallax across the lunar surface is what moves the shadow edge
# over the disk). Coverage is exactly zero more than aE+aS from the
# anti-umbral axis, so the term is always-on and free outside eclipses.
EARTH_RADIUS_KM = 6371.0
# Umbral shadows observed during eclipses are ~2% larger than the
# GEOMETRIC UMBRA (atmospheric refraction; classical Chauvenet rule) —
# note the rule enlarges the shadow radius (aE - aS), not the Earth
# disk: engine.scene._earth_params adds 2% of the umbral radius to the
# Earth's angular radius so the disk-occlusion model reproduces it.
UMBRA_ENLARGEMENT = 1.02
# Sunlight refracted through the Earth's atmosphere into the umbra is deep
# red ("blood moon"). Physically it is 1e-3..1e-4 of direct sunlight —
# invisible at normal exposure — so, like every planetarium renderer, the
# tint is display-calibrated: fully eclipsed light = UMBRA_TINT x direct.
UMBRA_TINT = (0.045, 0.009, 0.003)
# Earthshine (the "da Vinci glow" lighting the crescent Moon's night
# side). Physically the full Earth illuminates the Moon at ~1e-4 of
# direct sunlight — invisible at normal Moon exposure — so, like the
# umbral tint, the scale is display-calibrated: irradiance relative to
# direct sunlight at FULL Earth; scaled by the Earth's illuminated
# fraction (1 - cos(moon phase angle))/2 per frame (engine/light.py
# earthshine_fraction). The reference renders the night side pure black.
EARTHSHINE_RELATIVE = 0.012
