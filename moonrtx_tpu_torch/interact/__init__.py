"""Interaction: navigation, picking, measurement."""

from moonrtx_tpu_torch.interact.measure import (
    elevation_difference_m,
    elevation_m,
    great_circle_distance_km,
)
from moonrtx_tpu_torch.interact.navigation import (
    center_on_feature,
    center_on_point,
    navigate_view,
    pan_tilt_view,
    roll_view,
    rotate_around_moon_axis,
    zoom_fov,
)
from moonrtx_tpu_torch.interact.picking import FeatureLookup, hit_to_selenographic

__all__ = [
    "great_circle_distance_km", "elevation_m", "elevation_difference_m",
    "navigate_view", "pan_tilt_view", "roll_view", "rotate_around_moon_axis",
    "zoom_fov", "center_on_point", "center_on_feature",
    "FeatureLookup", "hit_to_selenographic",
]
