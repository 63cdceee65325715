# Frozen copy of moonrtx_tpu_torch/engine/camera.py at commit 41cfce49f52c, for the benchmark's
# plain reference, trimmed to what the reference reaches; imports renamed.
"""Pinhole camera ray generation (torch).

Port of moonrtx_tpu/engine/camera.py: the reference camera semantics
(pinhole with vertical FOV) and the four telescope view orientations as
image-space mirrors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reference.moonref.engine.geometry import normalize
from reference.moonref.orientation import flips
from reference.moonref.types import Camera


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
