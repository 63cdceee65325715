"""Pinhole camera ray generation (torch).

Port of moonrtx_tpu/engine/camera.py: the reference camera semantics
(pinhole with vertical FOV) and the four telescope view orientations as
image-space mirrors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from moonrtx_tpu_torch.engine.geometry import normalize
from moonrtx_tpu_torch.orientation import flips
from moonrtx_tpu_torch.types import Camera


class CameraBasis(NamedTuple):
    """Device camera state (all float32)."""

    eye: torch.Tensor       # (3,)
    forward: torch.Tensor   # (3,) unit
    right: torch.Tensor     # (3,) unit
    up: torch.Tensor        # (3,) unit
    tan_half_fov: torch.Tensor  # scalar


def camera_basis_np(cam: Camera, orientation: str = "NSWE"):
    """(eye, forward, right, up, tan_half_fov) as host numpy float64."""
    eye = np.asarray(cam.eye, np.float64)
    target = np.asarray(cam.target, np.float64)
    up_hint = np.asarray(cam.up, np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up_hint)
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    flip_h, flip_v = flips(orientation)
    if flip_h:
        right = -right
    if flip_v:
        up = -up
    return eye, fwd, right, up, float(np.tan(np.radians(cam.fov) / 2.0))


def camera_basis(cam: Camera, orientation: str, device) -> CameraBasis:
    """Orthonormal view basis from eye/target/up + fov, on ``device``.

    View-orientation flips mirror the image by negating the right/up
    basis vectors (mirrors, not rotations)."""
    eye, fwd, right, up, _ = camera_basis_np(cam, orientation)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return CameraBasis(eye=t(eye), forward=t(fwd), right=t(right), up=t(up),
                       tan_half_fov=t(np.tan(np.radians(cam.fov) / 2.0)))


def ray_directions(basis: CameraBasis, height: int, width: int,
                   jitter=None, row_offset=0,
                   full_height: int = None) -> torch.Tensor:
    """Unit ray directions (H, W, 3) in scene coordinates.

    Vertical FOV; square pixels; pixel centers at +0.5. ``jitter`` is an
    optional (2,) sub-pixel offset in [-0.5, 0.5) (row, column) used by
    progressive accumulation for antialiasing. ``row_offset`` and
    ``full_height`` render the horizontal strip of rows
    [row_offset, row_offset + height) of a full_height-row image (image
    strips over a device mesh)."""
    dev = basis.eye.device
    fh = height if full_height is None else full_height
    ys = torch.arange(height, dtype=torch.float32,
                      device=dev)[:, None] + row_offset
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    jy = 0.0 if jitter is None else jitter[..., 0]
    jx = 0.0 if jitter is None else jitter[..., 1]
    # NDC in [-1, 1], y up
    v = 1.0 - 2.0 * (ys + 0.5 + jy) / fh
    u = (2.0 * (xs + 0.5 + jx) / width - 1.0) * (width / fh)
    u = u.expand(height, width)
    v = v.expand(height, width)
    d = (basis.forward[None, None, :]
         + basis.tan_half_fov * (u[..., None] * basis.right[None, None, :]
                                 + v[..., None] * basis.up[None, None, :]))
    return normalize(d)


def probe_hit_dirs(cam: Camera, orientation: str, height: int, width: int,
                   radius: float) -> np.ndarray:
    """Unit directions (from the body center) of where a 3x3 grid of probe
    pixels lands on the sphere of the given radius, on the host in float64.
    Rays that miss use the closest-approach point, so limb and background
    probes still track how the view sweeps past the body. Bounds how far
    body-frame ray footprints move under a camera change."""
    eye, fwd, right, up, thf = camera_basis_np(cam, orientation)
    ys = np.array([0.0, (height - 1) / 2.0, height - 1.0])
    xs = np.array([0.0, (width - 1) / 2.0, width - 1.0])
    v = 1.0 - 2.0 * (ys[:, None] + 0.5) / height
    u = (2.0 * (xs[None, :] + 0.5) / width - 1.0) * (width / height)
    d = (fwd[None, None] + thf * (u[..., None] * right[None, None]
                                  + v[..., None] * up[None, None]))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # |eye + t d|^2 = r^2; fall back to closest approach (t = -eye.d)
    b = d @ eye
    disc = b * b - (eye @ eye - radius * radius)
    t = np.where(disc > 0.0, -b - np.sqrt(np.maximum(disc, 0.0)), -b)
    p = eye[None, None] + t[..., None] * d
    return p / np.linalg.norm(p, axis=-1, keepdims=True)


def pixel_ray(basis: CameraBasis, y: float, x: float,
              height: int, width: int) -> torch.Tensor:
    """Single ray direction for picking (image pixel coords, y down)."""
    v = 1.0 - 2.0 * (y + 0.5) / height
    u = (2.0 * (x + 0.5) / width - 1.0) * (width / height)
    d = (basis.forward + basis.tan_half_fov
         * (u * basis.right + v * basis.up))
    return normalize(d)
