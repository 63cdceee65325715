"""Feature labels: standard (centered at feature) and spot (arrow + name
beside small features), with night-side hiding via the lit mask
(reference renderer_labels.py, moon_grid.py:500-601 semantics)."""

from __future__ import annotations

import numpy as np

from moonrtx_tpu_torch import constants as C
from moonrtx_tpu_torch.overlays.font import text_segments
from moonrtx_tpu_torch.overlays.graph import (
    OverlayGraph,
    feature_unit_vectors,
    merge_segments,
    place_on_sphere,
)
from moonrtx_tpu_torch.types import MoonFeature

STANDARD_LABEL_COLOR = (0.85, 0.85, 0.85)
SPOT_LABEL_COLOR = (1.0, 0.9, 0.3)
STANDARD_LABEL_RADIUS = 0.008
SPOT_LABEL_RADIUS = 0.008
LABEL_CHAR_SCALE = 0.28


def build_standard_labels(features: list[MoonFeature],
                          flip_horizontal: bool = False,
                          flip_vertical: bool = False) -> OverlayGraph:
    """Names centered at their features (standard_label == True)."""
    segments = []
    counts = []
    for f in features:
        segs2d = text_segments(f.name, scale=LABEL_CHAR_SCALE, spacing=0.1,
                               centered=True, flip_horizontal=flip_horizontal,
                               flip_vertical=flip_vertical)
        segs3d = place_on_sphere(segs2d, f.lat, f.lon, C.MOON_RADIUS)
        segments += segs3d
        counts.append(sum(s.shape[0] for s in segs3d))
    pos, edges = merge_segments(segments)
    return OverlayGraph(
        pos=pos, edges=edges, color=STANDARD_LABEL_COLOR,
        radius=STANDARD_LABEL_RADIUS, counts=np.asarray(counts, np.int64),
        units=feature_unit_vectors([f.lat for f in features],
                                   [f.lon for f in features]))


def build_spot_labels(features: list[MoonFeature],
                      flip_horizontal: bool = False,
                      flip_vertical: bool = False) -> OverlayGraph:
    """'< Name' beside small features, arrow pointing at the feature; with a
    horizontal flip the arrow moves to the other side ('Name >')."""
    segments = []
    counts = []
    for f in features:
        if flip_horizontal:
            label_text = f.name + " >"
            label_lon = f.lon - f.angular_radius * 2.0
        else:
            label_text = "< " + f.name
            label_lon = f.lon + f.angular_radius * 2.0
        segs2d = text_segments(label_text, scale=LABEL_CHAR_SCALE, spacing=0.1,
                               centered=False,
                               flip_horizontal=flip_horizontal,
                               flip_vertical=flip_vertical)
        segs3d = place_on_sphere(segs2d, f.lat, label_lon, C.MOON_RADIUS)
        segments += segs3d
        counts.append(sum(s.shape[0] for s in segs3d))
    pos, edges = merge_segments(segments)
    return OverlayGraph(
        pos=pos, edges=edges, color=SPOT_LABEL_COLOR,
        radius=SPOT_LABEL_RADIUS, counts=np.asarray(counts, np.int64),
        units=feature_unit_vectors([f.lat for f in features],
                                   [f.lon for f in features]))
