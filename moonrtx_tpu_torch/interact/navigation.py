"""Camera navigation: pure functions Camera -> Camera.

Functional port of the reference's NavigationMixin semantics
(renderer_navigation.py): Rodrigues rotations about view/moon axes,
FOV-proportional pan/tilt, roll, FOV zoom with clamps, centering.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from moonrtx_tpu_torch import constants as C
from moonrtx_tpu_torch.types import Camera, MoonFeature


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


def navigate_view(cam: Camera, direction: str,
                  step_factor: float = 0.05) -> Camera:
    """Arrow keys: orbit the eye around the target by a fraction of the FOV
    (reference renderer_navigation.py:223-294)."""
    eye, target, up, view_dir, right, actual_up, _ = _basis(cam)
    angle = math.radians(cam.fov * step_factor)
    if direction == "Left":
        axis, a = actual_up, angle
    elif direction == "Right":
        axis, a = actual_up, -angle
    elif direction == "Up":
        axis, a = right, angle
    elif direction == "Down":
        axis, a = right, -angle
    else:
        return cam
    new_eye = target + _rodrigues(eye - target, axis, a)
    new_up = _rodrigues(up, axis, a) if direction in ("Up", "Down") else up
    return cam._replace(eye=list(new_eye), up=list(new_up))


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


def rotate_around_moon_axis(cam: Camera, rotation: np.ndarray, direction: str,
                            step_deg: float = 1.0) -> Camera:
    """Ctrl+arrows: orbit about the Moon's polar/equatorial axis
    (reference renderer_navigation.py:353-410)."""
    eye, target, up, *_ = _basis(cam)
    polar = rotation @ np.array([0.0, 0.0, 1.0])
    equatorial = rotation @ np.array([1.0, 0.0, 0.0])
    if direction == "Left":
        axis, a = polar, math.radians(step_deg)
    elif direction == "Right":
        axis, a = polar, math.radians(-step_deg)
    elif direction == "Up":
        axis, a = equatorial, math.radians(step_deg)
    elif direction == "Down":
        axis, a = equatorial, math.radians(-step_deg)
    else:
        return cam
    new_eye = target + _rodrigues(eye - target, axis, a)
    new_up = _rodrigues(up, axis, a)
    return cam._replace(eye=list(new_eye), up=list(new_up))


def roll_view(cam: Camera, direction: str, step_deg: float = 1.0) -> Camera:
    """H/J keys: roll about the view direction
    (reference renderer_navigation.py:412-447)."""
    eye, target, up, view_dir, *_ = _basis(cam)
    a = math.radians(-step_deg if direction == "cw" else step_deg)
    return cam._replace(up=list(_rodrigues(up, view_dir, a)))


def zoom_fov(cam: Camera, wheel_delta: float) -> Camera:
    """Wheel zoom: 5% FOV per notch, clamped to [0.3, 90] deg
    (reference renderer_navigation.py:491-518)."""
    factor = 1.0 - (wheel_delta / 120.0) * 0.05
    new_fov = float(np.clip(cam.fov * factor, *C.FOV_RANGE))
    return cam._replace(fov=new_fov)


def zoom_drag(cam: Camera, dy_px: float, height_px: int) -> Camera:
    """Shift + left-drag up/down: zoom out/in (reference README — a
    PlotOptiX built-in camera control). A full-frame drag spans ~8
    wheel notches worth of FOV change, continuous per event."""
    factor = 1.0 + (dy_px / height_px) * 0.4
    new_fov = float(np.clip(cam.fov * factor, *C.FOV_RANGE))
    return cam._replace(fov=new_fov)


def dolly_view(cam: Camera, dy_px: float, height_px: int) -> Camera:
    """Shift + right-drag up/down: move the eye backward/forward along
    the view direction (reference README — a PlotOptiX built-in). The
    eye never crosses the target or recedes past the documented
    precision-safe distance (~220 radii, moon_renderer.py:38-41)."""
    eye, target, up, view_dir, *_ = _basis(cam)
    dist = float(np.linalg.norm(eye - target))
    new_dist = float(np.clip(dist * (1.0 + (dy_px / height_px) * 0.8),
                             C.MOON_RADIUS * 1.2, C.MOON_RADIUS * 220.0))
    new_eye = target - view_dir * new_dist
    return cam._replace(eye=list(new_eye))


def center_on_point(cam: Camera, point: np.ndarray) -> Camera:
    """C key: retarget to a scene point keeping distance and direction
    (reference renderer_navigation.py:172-221)."""
    eye, target, *_ = _basis(cam)
    direction = eye - target
    direction /= np.linalg.norm(direction)
    dist = np.linalg.norm(eye - target)
    new_target = np.asarray(point, float)
    new_eye = new_target + direction * dist
    return cam._replace(eye=list(new_eye), target=list(new_target))


def center_on_feature(cam: Camera, feature: MoonFeature,
                      rotation: np.ndarray) -> Camera:
    """Feature search: center and frame at ~30% of the FOV
    (reference renderer_navigation.py:18-74)."""
    lat, lon = math.radians(feature.lat), math.radians(feature.lon)
    r = C.MOON_RADIUS
    body = np.array([r * math.cos(lat) * math.sin(lon),
                     -r * math.cos(lat) * math.cos(lon),
                     r * math.sin(lat)])
    scene_pos = rotation @ body

    eye, target, *_ = _basis(cam)
    feature_radius_scene = feature.angular_radius * (C.MOON_RADIUS / 90.0)
    desired_ang = cam.fov * 0.3
    new_distance = feature_radius_scene / math.tan(math.radians(desired_ang / 2))
    new_distance = float(np.clip(new_distance, C.MOON_RADIUS * 1.1,
                                 C.MOON_RADIUS * 15.0))
    direction = eye - target
    direction /= np.linalg.norm(direction)
    new_eye = scene_pos + direction * new_distance
    return cam._replace(eye=list(new_eye), target=list(scene_pos))
