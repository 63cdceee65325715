# Frozen copy of moonrtx_tpu_torch/interact/navigation.py at commit 41cfce49f52c, for the benchmark's
# plain reference, trimmed to what the reference reaches; imports renamed.
"""Camera navigation: pure functions Camera -> Camera.

Functional port of the reference's NavigationMixin semantics
(renderer_navigation.py): Rodrigues rotations about view/moon axes,
FOV-proportional pan/tilt, roll, FOV zoom with clamps, centering.
"""

from __future__ import annotations

import math
import numpy as np

from reference.moonref import constants as C
from reference.moonref.types import Camera


def _rodrigues(v: np.ndarray, axis: np.ndarray, angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    return v * c + np.cross(axis, v) * s + axis * np.dot(axis, v) * (1 - c)


def _basis(cam: Camera):
    eye = np.asarray(cam.eye, float)
    target = np.asarray(cam.target, float)
    up = np.asarray(cam.up, float)
    view = target - eye
    dist = np.linalg.norm(view)
    view_dir = view / dist
    right = np.cross(view_dir, up)
    right /= np.linalg.norm(right)
    actual_up = np.cross(right, view_dir)
    actual_up /= np.linalg.norm(actual_up)
    return eye, target, up, view_dir, right, actual_up, dist


def orbit_drag(cam: Camera, dx_px: float, dy_px: float,
               height_px: int) -> Camera:
    """Left-drag: continuous per-pixel orbit of the eye about the target —
    both axes in one motion event, angle proportional to cursor travel
    (reference renderer_navigation.py:223-294 drives its Rodrigues orbit
    per mouse event; quantized 5%-FOV steps look visibly chunky)."""
    eye, target, up, view_dir, right, actual_up, _ = _basis(cam)
    angle_per_px = math.radians(cam.fov) / height_px
    v = eye - target
    new_up = up
    if dx_px:
        v = _rodrigues(v, actual_up, dx_px * angle_per_px)
    if dy_px:
        v = _rodrigues(v, right, dy_px * angle_per_px)
        new_up = _rodrigues(up, right, dy_px * angle_per_px)
    return cam._replace(eye=list(target + v), up=list(new_up))


def pan_tilt_view(cam: Camera, dx_px: float, dy_px: float,
                  height_px: int) -> Camera:
    """Right-drag: rotate the view direction about the eye, scaled so image
    content follows the cursor 1:1 at any FOV
    (reference renderer_navigation.py:296-351)."""
    eye, target, up, view_dir, right, actual_up, dist = _basis(cam)
    angle_per_px = math.radians(cam.fov) / height_px
    yaw = -dx_px * angle_per_px
    pitch = -dy_px * angle_per_px
    view_dir = _rodrigues(view_dir, actual_up, yaw)
    new_up = _rodrigues(up, right, pitch)
    view_dir = _rodrigues(view_dir, right, pitch)
    new_target = eye + view_dir * dist
    return cam._replace(target=list(new_target), up=list(new_up))


def zoom_fov(cam: Camera, wheel_delta: float) -> Camera:
    """Wheel zoom: 5% FOV per notch, clamped to [0.3, 90] deg
    (reference renderer_navigation.py:491-518)."""
    factor = 1.0 - (wheel_delta / 120.0) * 0.05
    new_fov = float(np.clip(cam.fov * factor, *C.FOV_RANGE))
    return cam._replace(fov=new_fov)
