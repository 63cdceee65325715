"""Render engine: geometry, camera, lighting, shading, the blocked kernel
pipeline and the scene state."""

from moonrtx_tpu_torch.engine.camera import (
    CameraBasis, camera_basis, pixel_ray, probe_hit_dirs, ray_directions)
from moonrtx_tpu_torch.engine.render import (
    FrameParams, RenderOutput, render_frame, tonemap)
from moonrtx_tpu_torch.engine.scene import MoonScene, default_camera

__all__ = [
    "CameraBasis", "camera_basis", "pixel_ray", "probe_hit_dirs",
    "ray_directions", "FrameParams", "RenderOutput", "render_frame",
    "tonemap", "MoonScene", "default_camera",
]
