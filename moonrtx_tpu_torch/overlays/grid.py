"""Selenographic grid: graticule lines, numeric labels, north marker.

Same surface as the reference grid (moon_grid.py:603-773): latitude circles
every 15 deg between +/-60, longitude great circles every 15 deg, numeric
labels at longitudes {0, 90, 180, -90}, an 'N' above the north pole;
labels regenerate flipped for the telescope view orientations.
"""

from __future__ import annotations

import math

import numpy as np

from moonrtx_tpu_torch import constants as C
from moonrtx_tpu_torch.overlays.font import glyph_segments, text_segments
from moonrtx_tpu_torch.overlays.graph import OverlayGraph, merge_segments, place_on_sphere

GRID_COLOR = (0.50, 0.50, 0.50)
GRID_LINE_RADIUS = 0.006
GRID_LABEL_RADIUS = 0.012
LABEL_SCALE = 0.30


def graticule_lines(radius: float = C.MOON_RADIUS, lat_step: float = 15.0,
                    lon_step: float = 15.0, points_per_line: int = 100,
                    offset: float = 0.02) -> list[np.ndarray]:
    """Latitude circles (+/-60 max) and longitude great circles."""
    r = radius * (1.0 + offset)
    lines = []
    for lat in np.arange(-60.0, 61.0, lat_step):
        la = math.radians(lat)
        z = r * math.sin(la)
        rc = r * math.cos(la)
        lons = np.radians(np.linspace(0.0, 360.0, points_per_line))
        lines.append(np.column_stack([
            rc * np.sin(lons), -rc * np.cos(lons), np.full(points_per_line, z)]))
    for lon in np.arange(0.0, 360.0, lon_step):
        lo = math.radians(lon)
        lats = np.radians(np.linspace(-90.0, 90.0, points_per_line))
        cl = np.cos(lats)
        lines.append(np.column_stack([
            r * cl * math.sin(lo), -r * cl * math.cos(lo), r * np.sin(lats)]))
    return lines


def grid_number_labels(radius: float = C.MOON_RADIUS, lat_step: float = 15.0,
                       lon_step: float = 15.0, offset: float = 0.02,
                       flip_horizontal: bool = False,
                       flip_vertical: bool = False) -> list[np.ndarray]:
    """Latitude numbers at lons {0, 90, 180, -90}; longitude numbers along
    the equator band; regenerated per view orientation so they read
    upright (reference moon_grid.py:603-668)."""
    segments = []
    for label_lon in (0.0, 90.0, 180.0, -90.0):
        for lat in np.arange(-60.0, 61.0, lat_step):
            segs2d = text_segments(str(int(lat)), scale=LABEL_SCALE,
                                   centered=False,
                                   flip_horizontal=flip_horizontal,
                                   flip_vertical=flip_vertical)
            segments += place_on_sphere(segs2d, lat + 1.0,
                                        label_lon + lat_step / 2 - 1.0,
                                        radius, offset)
    for lon in np.arange(0.0, 360.0, lon_step):
        display = lon if lon <= 180.0 else lon - 360.0
        segs2d = text_segments(str(int(display)), scale=LABEL_SCALE,
                               centered=False,
                               flip_horizontal=flip_horizontal,
                               flip_vertical=flip_vertical)
        segments += place_on_sphere(segs2d, lat_step / 2 - 1.0,
                                    display + (2.0 if display < 0 else 1.0),
                                    radius, offset)
    # north marker: an upright N floating above the pole, facing the camera
    n_scale = 0.5 * radius / 10.0
    z_base = radius * (1.0 + offset + 0.005) + n_scale * 0.6
    for seg in glyph_segments("N", n_scale):
        segments.append(np.column_stack([
            seg[:, 0], np.full(seg.shape[0], -0.01), z_base + seg[:, 1]]))
    return segments


def build_grid_graphs(flip_horizontal: bool = False,
                      flip_vertical: bool = False
                      ) -> tuple[OverlayGraph, OverlayGraph]:
    """(lines graph, labels graph) for the current orientation."""
    lines_pos, lines_edges = merge_segments(graticule_lines())
    labels_pos, labels_edges = merge_segments(
        grid_number_labels(flip_horizontal=flip_horizontal,
                           flip_vertical=flip_vertical))
    return (
        OverlayGraph(pos=lines_pos, edges=lines_edges, color=GRID_COLOR,
                     radius=GRID_LINE_RADIUS),
        OverlayGraph(pos=labels_pos, edges=labels_edges, color=GRID_COLOR,
                     radius=GRID_LABEL_RADIUS),
    )
