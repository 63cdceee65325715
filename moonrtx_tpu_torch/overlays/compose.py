"""Overlay compositing: project graphs to the frame and draw them.

Copy of moonrtx_tpu/overlays/compose.py; the camera basis may hold torch
tensors (a scene's basis() on the card), which are read back as float32
values, as the reference reads its device basis.

The reference renders overlays as no-shadow flat line geometry inside the
ray tracer (renderer_labels.py:96-103). Here overlays never touch the
device: graphs are projected on the host and rasterized with cv2.polylines
over the rendered frame — they cast no shadows by construction, never
pollute the hit buffer, and cost microseconds. Occlusion by the Moon and
the frustum is handled analytically per vertex.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from moonrtx_tpu_torch import constants as C
from moonrtx_tpu_torch.engine.camera import CameraBasis
from moonrtx_tpu_torch.overlays.graph import OverlayGraph


def _host(v) -> np.ndarray:
    """A basis field as host float64 (torch tensors read back first)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, float)


def project_to_screen(pos_scene: np.ndarray, basis: CameraBasis,
                      height: int, width: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Scene points -> pixel coords (n, 2 float) + validity mask.

    A vertex is valid when in front of the camera and not occluded by the
    Moon sphere (ray eye->vertex intersects the sphere strictly before the
    vertex)."""
    eye = _host(basis.eye)
    fwd = _host(basis.forward)
    right = _host(basis.right)
    up = _host(basis.up)
    thf = float(_host(basis.tan_half_fov))

    v = pos_scene - eye
    z = v @ fwd
    in_front = z > 1e-6
    zs = np.where(in_front, z, 1.0)
    # Inverse of the ray-gen NDC mapping (engine/camera.py:110,123):
    #   u = (2(x+0.5)/W - 1) * (W/H),  v = 1 - 2(y+0.5)/H
    # so x = (u*(H/W) + 1) * 0.5 * W - 0.5. The H/W factor must survive —
    # u spans [-W/H, W/H] across the frame, not [-1, 1].
    u = (v @ right) / (zs * thf)
    y_ndc = (v @ up) / (zs * thf)
    px = (u * (height / width) + 1.0) * 0.5 * width - 0.5
    py = (1.0 - y_ndc) * 0.5 * height - 0.5

    # occlusion: sphere of the mean Moon radius, slightly shrunk so overlay
    # geometry riding just above the surface stays visible
    r_occl = C.MOON_RADIUS * 0.985
    d = v / np.linalg.norm(v, axis=-1, keepdims=True)
    b = d @ (-eye)
    c = eye @ eye - r_occl * r_occl
    disc = b * b - c
    t_sphere = np.where(disc > 0, b - np.sqrt(np.maximum(disc, 0.0)), np.inf)
    dist = np.linalg.norm(v, axis=-1)
    occluded = t_sphere < dist - 1e-3
    return np.column_stack([px, py]), in_front & ~occluded


def line_width_px(radius_scene: float, basis: CameraBasis, height: int) -> int:
    """Scene-unit line radius -> pixel stroke width at the Moon's distance."""
    eye = _host(basis.eye)
    dist = max(np.linalg.norm(eye) - C.MOON_RADIUS, 1.0)
    scene_per_px = 2.0 * dist * float(_host(basis.tan_half_fov)) / height
    return max(1, int(round(2.0 * radius_scene / scene_per_px)))


def draw_graph(frame: np.ndarray, graph: OverlayGraph, rotation: np.ndarray,
               basis: CameraBasis,
               light_dir_body: Optional[np.ndarray] = None) -> None:
    """Rasterize one overlay graph onto the uint8 RGB frame in place."""
    import cv2

    if not graph.visible or graph.pos.shape[0] == 0:
        return
    height, width = frame.shape[0], frame.shape[1]
    pos_scene = graph.pos @ rotation.T
    pts, ok = project_to_screen(pos_scene, basis, height, width)
    ok = ok & graph.vertex_visible_mask(light_dir_body)

    e = graph.edges
    valid = ok[e[:, 0]] & ok[e[:, 1]]
    if not np.any(valid):
        return
    a = pts[e[valid, 0]]
    b = pts[e[valid, 1]]
    color = tuple(int(c * 255) for c in graph.color)
    w_px = line_width_px(graph.radius, basis, height)
    segs = np.stack([a, b], axis=1).astype(np.int32).reshape(-1, 2, 1, 2)
    cv2.polylines(frame, list(segs), False, color, w_px, cv2.LINE_AA)


def draw_overlays(frame: np.ndarray, graphs: list[OverlayGraph],
                  rotation: np.ndarray, basis: CameraBasis,
                  light_pos_scene: Optional[np.ndarray] = None) -> np.ndarray:
    """Composite all visible overlay graphs; returns the frame."""
    light_dir_body = None
    if light_pos_scene is not None:
        lp = np.asarray(light_pos_scene, float)
        n = np.linalg.norm(lp)
        if n > 0:
            light_dir_body = rotation.T @ (lp / n)
    for g in graphs:
        draw_graph(frame, g, rotation, basis, light_dir_body)
    return frame
