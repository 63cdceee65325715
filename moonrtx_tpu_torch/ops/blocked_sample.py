"""One accumulation sample of the windowed "blocked" backend (KS): the
march, the shadow|bounce lookup, the shading and the composite of
engine/blocked.py::render_frame_blocked in one launch.

Replaces no TPU kernel: the JAX package's render_frame_blocked is jnp
code that XLA fuses. ``blocked_sample_plain`` is the plain PyTorch
version, the four functions the backend composes (march_blocks,
lookup_shadow_windows, shade_blocks, composite_blocks): the CPU path and
the kernel's yardstick. On the card ``blocked_sample`` launches the kernel
(csrc/blocked_sample.cu), which repeats the plain version's float32
arithmetic as torch computes it there.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from moonrtx_tpu_torch import kernels

BLOCK_H, BLOCK_W = 8, 16     # engine.blocked.BLOCK_H, BLOCK_W
BLOCK = BLOCK_H * BLOCK_W
GROUP = 8                    # engine.blocked.GROUP
WIN_H, WIN_W = 40, 64        # height and albedo windows
SWIN_H, SWIN_W = 32, 48      # a shadow|bounce window half
N_BISECT = 8                 # march_blocks' bisections


def blocked_sample_plain(cache, org, geom, shadow_windows, smap_params,
                         background, basis, fp, jitter_t, height: int,
                         width: int, h: int, w: int, ah: int, aw: int,
                         n_phi: int = 0, n_coarse: int = 24):
    """The plain version: march, shadow lookup, shading and composite as
    four plain-torch functions of engine.blocked."""
    # engine.blocked imports this module
    from moonrtx_tpu_torch.engine import blocked
    from moonrtx_tpu_torch.engine.render import RenderOutput

    hit, t_hit, lat, lon, p = blocked.march_blocks(
        cache, org, geom, h, w, jitter_t, n_coarse=n_coarse)

    if shadow_windows is not None:
        shadow, bounce = blocked.lookup_shadow_windows(
            shadow_windows, smap_params, n_phi, p)
    else:
        shadow = torch.ones_like(t_hit)
        bounce = None

    pix_ang = 2.0 * basis.tan_half_fov / height
    rgb_b = blocked.shade_blocks(cache, org, h, w, ah, aw, lat, lon, p, fp,
                                 shadow, geom=geom, t_hit=t_hit,
                                 pix_ang=pix_ang, bounce=bounce)
    rgb, hitbuf = blocked.composite_blocks(rgb_b, hit, t_hit, p, height,
                                           width, geom.dirs_scene, basis.eye,
                                           fp, background=background)
    return RenderOutput(rgb=rgb, hitbuf=hitbuf)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class _SampleArgs(ctypes.Structure):
    _fields_ = (
        [(n, _P) for n in ("hwin", "hmean", "r0", "c0", "ar0", "ac0", "q",
                           "sigma", "awin")]
        + [(n, _I) for n in ("a_row", "a_col", "a_chan")]
        + [("swin", _P), ("swin_bf16", _I), ("swin_w", _I)]
        + [(n, _P) for n in ("sr0", "sc0", "sq", "axis_x", "axis_y",
                             "axis_z", "smap_nc", "smap_nf", "db", "ob",
                             "t_enter", "t_end", "hit_outer", "dirs",
                             "background", "eye", "tan_half_fov",
                             "rotation", "light_pos", "disk_center",
                             "disk_radius", "irradiance", "sun_ang_radius",
                             "lunar_blend", "earth", "rgb", "hitbuf")]
        + [(n, _F) for n in ("jitter_t", "inv_n_coarse", "n_coarse_step",
                             "h_f", "w_f", "ah_f", "aw_f", "n_phi_f",
                             "inv_height", "deg_per_texel", "h_over_pi")]
        + [(n, _I) for n in ("n_coarse", "n_bisect", "height", "width",
                             "nblk")])


def _inputs(cache, org, geom, shadow_windows, smap_params, background, basis,
            fp, height: int, width: int):
    """{argument field: (tensor, shape or None for one number, dtypes)}
    of the kernel's tensor inputs; an input the sample goes without (no
    background, shadow windows, lunar blend or Earth terms) is left out,
    and its pointer stays null."""
    f32, i32 = (torch.float32,), (torch.int32,)
    nblk = (height // BLOCK_H) * (width // BLOCK_W)
    if cache.awin.ndim == 3:     # K1's packed channel-major layout
        awin_shape = (nblk // GROUP, GROUP * WIN_H, 3 * WIN_W)
    else:                        # K5's whole texels
        awin_shape = (nblk, WIN_H, WIN_W, 3)
    ins = {
        "hwin": (cache.hwin, (nblk, WIN_H, WIN_W), f32),
        "hmean": (cache.hmean, (nblk, 1), f32),
        "r0": (org.r0, (nblk,), i32), "c0": (org.c0, (nblk,), i32),
        "ar0": (org.ar0, (nblk,), i32), "ac0": (org.ac0, (nblk,), i32),
        "q": (org.q, (nblk,), f32), "sigma": (org.sigma, (nblk,), f32),
        "awin": (cache.awin, awin_shape, f32),
        "db": (geom.db, (nblk, BLOCK, 3), f32), "ob": (geom.ob, (3,), f32),
        "t_enter": (geom.t_enter, (nblk, BLOCK), f32),
        "t_end": (geom.t_end, (nblk, BLOCK), f32),
        "hit_outer": (geom.hit_outer, (nblk, BLOCK), (torch.bool,)),
        "dirs": (geom.dirs_scene, (height, width, 3), f32),
        "eye": (basis.eye, (3,), f32),
        "tan_half_fov": (basis.tan_half_fov, None, f32),
        "rotation": (fp.rotation, (3, 3), f32),
        "light_pos": (fp.light_pos, (3,), f32),
        "disk_center": (fp.sun_disk_center, (3,), f32),
        "disk_radius": (fp.sun_disk_radius, None, f32),
        "irradiance": (fp.irradiance, None, f32),
        "sun_ang_radius": (fp.sun_ang_radius, None, f32),
    }
    if background is not None:
        ins["background"] = (background, (height, width, 3), f32)
    if fp.lunar_blend is not None:
        ins["lunar_blend"] = (fp.lunar_blend, None, f32)
    if fp.earth is not None:
        ins["earth"] = (fp.earth, (6,), f32)
    if shadow_windows is not None:
        sw = shadow_windows
        n_maps = 2 if sw.swin.shape[-1] == 2 * SWIN_W else 1
        ins.update({
            "swin": (sw.swin, (nblk, SWIN_H, n_maps * SWIN_W),
                     (torch.float32, torch.bfloat16)),
            "sr0": (sw.sr0, (nblk,), i32), "sc0": (sw.sc0, (nblk,), i32),
            "sq": (sw.sq, (nblk,), f32),
            "axis_x": (smap_params.axis_x, (3,), f32),
            "axis_y": (smap_params.axis_y, (3,), f32),
            "axis_z": (smap_params.axis_z, (3,), f32),
            "smap_nc": (smap_params.n_coarse, None, f32),
            "smap_nf": (smap_params.n_fine, None, f32),
        })
    return ins


def _check(ins: dict, dev, contiguous: bool) -> None:
    for name, (t, shape, dtypes) in ins.items():
        ok_shape = t.numel() == 1 if shape is None else tuple(t.shape) == shape
        if not (ok_shape and t.dtype in dtypes and t.device == dev
                and (t.is_contiguous() or not contiguous)):
            want = "one number" if shape is None else str(shape)
            raise ValueError(
                f"blocked_sample: {name} must be {want} "
                f"{' or '.join(map(str, dtypes))}"
                f"{', contiguous,' if contiguous else ''} on {dev}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")


# no pallas_call: the JAX package's blocked sample is jnp code XLA fuses
@kernels.register("blocked_sample", "mrtx_blocked_sample", _SampleArgs,
                  passes=("blocked_sample_kernel",),
                  plain=blocked_sample_plain,
                  replaces="moonrtx_tpu/engine/blocked.py:706")
def blocked_sample(cache, org, geom, shadow_windows, smap_params, background,
                   basis, fp, jitter_t, height: int, width: int, h: int,
                   w: int, ah: int, aw: int, n_phi: int = 0,
                   n_coarse: int = 24):
    """One accumulation sample of the blocked backend from its cached
    windows: engine.render.RenderOutput(rgb (height, width, 3), hitbuf
    (height, width, 4)).

    cache, org (engine.blocked.WindowCache, WindowOrigins; awin in either
    layout), geom (RayGeom, with dirs_scene), shadow_windows (ShadowWindows
    with or without the bounce half, or None for no shadows) and
    smap_params, background ((height, width, 3) or None for black), basis,
    fp, jitter_t (the coarse march's phase), the frame's height and width,
    the height level's (h, w), the albedo level's (ah, aw), the scan grid's
    n_phi and the coarse steps: as render_frame_blocked. On the CPU the
    plain version; on the card one kernel launch."""
    call = dict(locals())
    dev = cache.hwin.device
    if height % BLOCK_H or width % BLOCK_W:
        raise ValueError(f"blocked_sample: a {height}x{width} frame is not "
                         f"a grid of {BLOCK_H}x{BLOCK_W}-pixel blocks")
    if shadow_windows is not None and smap_params is None:
        raise ValueError("blocked_sample: shadow windows need their "
                         "ShadowMapParams")
    ins = _inputs(cache, org, geom, shadow_windows, smap_params, background,
                  basis, fp, height, width)
    on_card = dev.type == "cuda"
    _check(ins, dev, contiguous=on_card)
    if not on_card:
        return blocked_sample_plain(
            cache, org, geom, shadow_windows, smap_params, background, basis,
            fp, jitter_t, height, width, h, w, ah, aw, n_phi=n_phi,
            n_coarse=n_coarse)
    from moonrtx_tpu_torch.engine.render import RenderOutput

    rgb = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    hitbuf = torch.empty((height, width, 4), dtype=torch.float32, device=dev)
    a = _SampleArgs()
    for name, (t, _, _) in ins.items():
        setattr(a, name, t.data_ptr())
    a.rgb, a.hitbuf = rgb.data_ptr(), hitbuf.data_ptr()
    # a texel's (row, column, channel) strides in a block's albedo window
    a.a_row, a.a_col, a.a_chan = ((3 * WIN_W, 1, WIN_W)
                                  if cache.awin.ndim == 3
                                  else (3 * WIN_W, 3, 1))
    if shadow_windows is not None:
        a.swin_bf16 = int(shadow_windows.swin.dtype == torch.bfloat16)
        a.swin_w = shadow_windows.swin.shape[-1]
    # the host numbers as torch makes them float32 on the card: a division
    # by a host number is a product with its float32 reciprocal
    f32 = np.float32
    a.jitter_t = f32(float(jitter_t))
    a.inv_n_coarse = f32(1.0) / f32(n_coarse)
    a.n_coarse_step = f32(1.0 / n_coarse)
    a.h_f, a.w_f, a.ah_f, a.aw_f = float(h), float(w), float(ah), float(aw)
    a.n_phi_f = float(n_phi)
    a.inv_height = f32(1.0) / f32(height)
    a.deg_per_texel = f32(180.0 / h)
    a.h_over_pi = f32(h / math.pi)
    a.n_coarse, a.n_bisect = n_coarse, N_BISECT
    a.height, a.width = height, width
    a.nblk = (height // BLOCK_H) * (width // BLOCK_W)
    kernels.launch(blocked_sample, a, rgb, call)
    return RenderOutput(rgb=rgb, hitbuf=hitbuf)


def occupancy() -> int:
    """Blocks of the kernel that one SM holds at once (on the card)."""
    return kernels.entry("blocked_sample", "mrtx_blocked_sample_occupancy",
                         ())()
