"""Numbered pins (1-9) placed at cursor positions
(reference renderer_pins.py semantics: one merged graph per digit,
flip-aware, hidden/shown by visibility, rotated per time change)."""

from __future__ import annotations

import numpy as np

from moonrtx_tpu_torch import constants as C
from moonrtx_tpu_torch.overlays.font import glyph_segments
from moonrtx_tpu_torch.overlays.graph import OverlayGraph, merge_segments, place_on_sphere

PIN_COLOR = (1.0, 0.0, 0.0)
PIN_RADIUS = 0.012
PIN_SCALE = 0.4


def build_pin(digit: int, lat: float, lon: float,
              flip_horizontal: bool = False,
              flip_vertical: bool = False) -> OverlayGraph:
    """One digit glyph anchored with its lower-left corner at (lat, lon)."""
    segs2d = glyph_segments(str(digit), PIN_SCALE, flip_horizontal,
                            flip_vertical)
    shifted = []
    for seg in segs2d:
        seg = seg.copy()
        seg[:, 0] += 0.3 * PIN_SCALE
        seg[:, 1] += 0.5 * PIN_SCALE
        shifted.append(seg)
    pos, edges = merge_segments(
        place_on_sphere(shifted, lat, lon, C.MOON_RADIUS))
    return OverlayGraph(pos=pos, edges=edges, color=PIN_COLOR,
                        radius=PIN_RADIUS)
