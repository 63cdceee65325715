"""Overlay geometry containers: merged polyline graphs on the sphere.

Each overlay group (grid lines, grid labels, standard labels, spot labels,
each pin) is merged into ONE vertex/edge graph so a time-change update is a
single rotate of one array (reference renderer_labels.py:1-8 design,
moon_grid.py:13-32 merge).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


def merge_segments(polylines: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Polylines -> (vertices (n,3), edge index pairs (m,2))."""
    if not polylines:
        return np.zeros((0, 3)), np.zeros((0, 2), np.int32)
    pos = np.concatenate(polylines, axis=0)
    edges = []
    offset = 0
    for line in polylines:
        idx = np.arange(offset, offset + line.shape[0], dtype=np.int32)
        edges.append(np.column_stack((idx[:-1], idx[1:])))
        offset += line.shape[0]
    return pos, np.concatenate(edges, axis=0)


def place_on_sphere(segments2d: list[np.ndarray], lat: float, lon: float,
                    radius: float, offset: float = 0.0) -> list[np.ndarray]:
    """Lift 2D strokes onto the sphere at (lat, lon) via the local tangent
    parametrization: +x east along the parallel, +y north along the meridian
    (reference moon_grid.py:142-221 placement semantics).

    Near the poles the east direction degenerates; longitude offsets are
    suppressed there exactly like the reference's lon_scale guard."""
    r = radius * (1.0 + offset + 0.005)
    lon_scale = (r * math.cos(math.radians(lat))) if abs(lat) < 89.0 else None
    out = []
    for seg in segments2d:
        la = lat + np.degrees(seg[:, 1] / r)
        lo = lon + (np.degrees(seg[:, 0] / lon_scale)
                    if lon_scale is not None else 0.0)
        la_r = np.radians(la)
        lo_r = np.radians(lo)
        cl = np.cos(la_r)
        out.append(np.column_stack([
            r * cl * np.sin(lo_r),
            -r * cl * np.cos(lo_r),
            r * np.sin(la_r),
        ]))
    return out


@dataclass
class OverlayGraph:
    """One merged overlay graph in body-frame coordinates."""

    pos: np.ndarray                 # (n, 3) body frame
    edges: np.ndarray               # (m, 2) int32
    color: tuple                    # RGB 0..1
    radius: float                   # line radius in scene units
    # optional per-label structure for night-side hiding:
    counts: Optional[np.ndarray] = None   # vertices per label
    units: Optional[np.ndarray] = None    # (n_labels, 3) feature unit vectors
    visible: bool = True

    def vertex_visible_mask(self, light_dir_body: Optional[np.ndarray]) -> np.ndarray:
        """Per-vertex visibility from the per-label lit mask (night-side
        labels hidden; reference renderer_labels.py:77-94)."""
        n = self.pos.shape[0]
        if self.counts is None or self.units is None or light_dir_body is None:
            return np.ones(n, bool)
        lit = self.units @ light_dir_body > 0.0
        return np.repeat(lit, self.counts)


def feature_unit_vectors(lats, lons) -> np.ndarray:
    lat = np.radians(np.asarray(lats, float))
    lon = np.radians(np.asarray(lons, float))
    cl = np.cos(lat)
    return np.column_stack((cl * np.sin(lon), -cl * np.cos(lon), np.sin(lat)))
