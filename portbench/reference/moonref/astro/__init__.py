# Frozen copy of moonrtx_tpu_torch/astro/__init__.py at commit 41cfce49f52c, for the benchmark's
# plain reference, trimmed to what the reference reaches; imports renamed.
"""Ephemeris engine (host, numpy): the explicit-observer form of the
analytic replacement for the reference's Skyfield + JPL-kernel stack."""

from reference.moonref.astro.ephemeris import (
    calculate_moon_ephemeris as calculate_ephemeris,
)

__all__ = ["calculate_ephemeris"]
