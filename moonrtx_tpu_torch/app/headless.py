"""Headless rendering: config -> frame(s) -> image file (torch port).

Port of moonrtx_tpu/app/headless.py: build_scene, render_headless,
render_timelapse, save_image, default_screenshot_name.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from moonrtx_tpu_torch.app import codec
from moonrtx_tpu_torch.config import RenderConfig
from moonrtx_tpu_torch.data import loader as _loader
from moonrtx_tpu_torch.data.features import load_moon_features
from moonrtx_tpu_torch.data.loader import load_color_data, load_elevation_data, load_starmap
from moonrtx_tpu_torch.engine.scene import MoonScene


def build_scene(config: RenderConfig, with_starmap: bool = True,
                device=None, mesh=None) -> MoonScene:
    """Load data (real files or procedural fallback) and build the scene
    on ``device`` (None = the CUDA card), or on ``mesh``
    (parallel.make_mesh; by default the mesh config.devices asks for)."""
    ss = config.synth_shape
    elevation, radius_scale = load_elevation_data(
        config.elevation_file, config.downscale,
        synth_shape=tuple(ss) if ss else None)
    # the procedural color map rides 4x coarser than the heightfield,
    # like the real LROC mosaic vs the LDEM, but never coarser than its
    # own base synthesis grid
    bh, bw = _loader.SYNTH_ELEVATION_SHAPE
    alb_ss = (max(ss[0] // 4, bh), max(ss[1] // 4, bw)) if ss else None
    albedo = load_color_data(config.color_file, config.downscale,
                             synth_shape=alb_ss)
    starmap = (load_starmap(config.starmap_file, config.width * 2)
               if with_starmap else None)
    scene = MoonScene(config, elevation, radius_scale, albedo, starmap,
                      device=device, mesh=mesh)
    scene.features = sorted(load_moon_features(config.features_file),
                            key=lambda f: f.angular_radius)
    return scene


def default_screenshot_name(scene: MoonScene) -> str:
    """Filename encoding the full view state, restorable via --init-view."""
    return codec.format_view_state(
        scene.dt_local, scene.config.observer.lat, scene.config.observer.lon,
        scene.view_orientation, scene.parallactic_mode, scene.camera)


def save_image(img: np.ndarray, path: str,
               linear_hdr: Optional[np.ndarray] = None,
               exposure: float = 0.9, gamma: float = 2.2) -> None:
    """Save a frame: 8 bits/sample for .jpg/.png/.tif, 16 bits/sample for
    .tiff, re-tonemapped from the linear accumulation when available."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".tiff" and linear_hdr is not None:
        import cv2

        x = np.clip(linear_hdr * exposure, 0.0, 1.0) ** (1.0 / gamma)
        img16 = (x * 65535.0 + 0.5).astype(np.uint16)
        cv2.imwrite(path, img16[..., ::-1])  # BGR order for cv2
    else:
        from PIL import Image

        Image.fromarray(img).save(path)
    print(f"Saved: {path}")


def render_headless(config: RenderConfig, save_path: Optional[str] = None,
                    n_frames: Optional[int] = None, device=None) -> str:
    """Render one accumulated view and save it. Returns the saved path."""
    scene = build_scene(config, with_starmap=True, device=device)
    scene.update_view()
    img = scene.render(n_frames)
    if save_path is None:
        save_path = default_screenshot_name(scene) + ".png"
    save_image(img, save_path,
               linear_hdr=scene._accum.cpu().numpy()[: scene.out_height,
                                                     : scene.out_width],
               gamma=scene.gamma)
    return save_path


def render_timelapse(config: RenderConfig, save_path: Optional[str],
                     timelapse_frames: int, n_frames: Optional[int] = None,
                     device=None) -> list[str]:
    """Render a frame sequence stepping time by config.time_step_minutes
    between frames (the Q/W time step, driven headless) and save
    <stem>_NNNN<ext>. Returns the paths.

    Frame i is saved while frame i+1 renders. The reference gets that
    overlap from JAX's asynchronous dispatch. Here the host issues every
    launch of a frame, and a device-to-host copy issued after frame i+1's
    launches would wait, in stream order, for all of frame i+1. So frame
    i's tonemap and its copy into pinned host memory are enqueued before
    frame i+1 is dispatched, behind an event, and a saver thread waits on
    that event alone and encodes the file while the main thread
    dispatches frame i+1."""
    from concurrent.futures import ThreadPoolExecutor
    from datetime import timedelta

    import torch

    from moonrtx_tpu_torch import constants as C
    from moonrtx_tpu_torch.engine import render as render_mod

    scene = build_scene(config, with_starmap=True, device=device)
    scene.update_view()
    if save_path is None:
        save_path = default_screenshot_name(scene) + ".png"
    stem, ext = os.path.splitext(save_path)
    ext = ext or ".png"
    oh, ow = scene.out_height, scene.out_width
    on_card = scene.device.type == "cuda"
    # two buffer pairs, alternating: frame i is copied into one while frame
    # i-1 is encoded from the other. save_image reads the linear
    # accumulation only for a 16-bit TIFF.
    bufs = [(torch.empty((oh, ow, 3), dtype=torch.uint8, pin_memory=on_card),
             torch.empty((oh, ow, 3), dtype=torch.float32,
                         pin_memory=on_card)
             if ext.lower() == ".tiff" else None) for _ in range(2)]

    def stage(i):
        img_buf, hdr_buf = bufs[i % 2]
        accum = scene._accum[:oh, :ow]
        img_buf.copy_(render_mod.tonemap(accum, C.TONEMAP_EXPOSURE,
                                         scene.gamma), non_blocking=True)
        if hdr_buf is not None:
            hdr_buf.copy_(accum, non_blocking=True)
        done = None
        if on_card:
            done = torch.cuda.Event()
            done.record()
        return done, i, img_buf, hdr_buf

    def save(staged) -> str:
        done, i, img_buf, hdr_buf = staged
        if done is not None:
            done.synchronize()
        path = f"{stem}_{i:04d}{ext}"
        save_image(img_buf.numpy(), path,
                   linear_hdr=None if hdr_buf is None else hdr_buf.numpy(),
                   gamma=scene.gamma)
        return path

    paths = []
    with ThreadPoolExecutor(max_workers=1) as saver:
        saving = None
        for i in range(timelapse_frames):
            if i:
                scene.update_view(scene.dt_local + timedelta(
                    minutes=config.time_step_minutes))
            scene.ensure_accumulated(n_frames)
            staged = stage(i)
            if saving is not None:
                # frame i-1 is saved: its buffers are free for frame i+1
                paths.append(saving.result())
            saving = saver.submit(save, staged)
        paths.append(saving.result())
    return paths
