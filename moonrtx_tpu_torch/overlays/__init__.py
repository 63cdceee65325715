"""Vector overlays: selenographic grid, feature labels, pins, compositing."""

from moonrtx_tpu_torch.overlays.compose import draw_overlays, project_to_screen
from moonrtx_tpu_torch.overlays.graph import OverlayGraph, merge_segments
from moonrtx_tpu_torch.overlays.grid import build_grid_graphs
from moonrtx_tpu_torch.overlays.labels import build_spot_labels, build_standard_labels
from moonrtx_tpu_torch.overlays.pins import build_pin

__all__ = [
    "OverlayGraph", "merge_segments", "build_grid_graphs",
    "build_standard_labels", "build_spot_labels", "build_pin",
    "draw_overlays", "project_to_screen",
]
