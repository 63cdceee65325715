"""The ray setup of an accumulation sample (KR): jittered rays in block
layout, their shell chords tightened against each block's local height
bound, and the collapse of the rays without a chord, in one launch.

Replaces no TPU kernel: the JAX package's block_rays is jnp code that XLA
fuses. ``block_rays_plain`` is the plain PyTorch version, about a hundred
elementwise operations on the frame's ray planes: the CPU path and the
kernel's yardstick. On the card ``block_rays`` launches the kernel
(csrc/ray_setup.cu), which repeats the plain version's float32 arithmetic
as torch computes it there.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from moonrtx_tpu_torch import constants as C
from moonrtx_tpu_torch import kernels

BLOCK_H, BLOCK_W = 8, 16     # engine.blocked.BLOCK_H, BLOCK_W
BLOCK = BLOCK_H * BLOCK_W
N_FRAC = 6                   # chord fractions of a sampled ray
HB_MARGIN = 2e-4             # added to the sampled local max height
RAD2DEG = 57.29577951308232  # torch.rad2deg's factor (its M_180_PI)


def _block_ray_dirs(basis, height: int, width: int, jitter, row_offset=0,
                    full_height: int = None):
    """Ray directions generated directly in block layout (NBLK, B, 3);
    row_offset/full_height as in camera.ray_directions."""
    from moonrtx_tpu_torch.engine.geometry import normalize

    dev = basis.eye.device
    fh = height if full_height is None else full_height
    nblk = (height // BLOCK_H) * (width // BLOCK_W)
    wbk = width // BLOCK_W
    blk = torch.arange(nblk, dtype=torch.int32, device=dev)[:, None]
    ray = torch.arange(BLOCK, dtype=torch.int32, device=dev)[None, :]
    ys = ((blk // wbk) * BLOCK_H + ray // BLOCK_W).to(torch.float32)
    xs = ((blk % wbk) * BLOCK_W + ray % BLOCK_W).to(torch.float32)
    v = 1.0 - 2.0 * (ys + row_offset + 0.5 + jitter[0]) / fh
    u = (2.0 * (xs + 0.5 + jitter[1]) / width - 1.0) * (width / fh)
    d = (basis.forward[None, None, :]
         + basis.tan_half_fov * (u[..., None] * basis.right[None, None, :]
                                 + v[..., None] * basis.up[None, None, :]))
    return normalize(d)


def shell_chords(basis, rotation, jitter, height: int, width: int,
                 h_min: float, row_offset=0, full_height: int = None,
                 image_dirs: bool = True):
    """The plain version's first half: (dirs_scene or None, db, ob,
    hit_outer, t_enter, t_end), the jittered rays and their chords through
    the outer shell, ended at the inner sphere, before any height bound."""
    # engine.blocked imports this module
    from moonrtx_tpu_torch.engine.blocked import to_blocks
    from moonrtx_tpu_torch.engine.camera import ray_directions
    from moonrtx_tpu_torch.engine.geometry import mat3t_apply, ray_sphere

    if image_dirs:
        dirs_scene = ray_directions(basis, height, width, jitter,
                                    row_offset=row_offset,
                                    full_height=full_height)
        db = mat3t_apply(rotation, to_blocks(dirs_scene))
    else:
        dirs_scene = None
        db = mat3t_apply(rotation, _block_ray_dirs(
            basis, height, width, jitter, row_offset, full_height))
    ob = mat3t_apply(rotation, basis.eye)

    hit_out, t_enter, t_exit_out = ray_sphere(ob, db, C.MOON_RADIUS)
    hit_in, t_in, _ = ray_sphere(ob, db, C.MOON_RADIUS * h_min * 0.999)
    t_enter = torch.clamp(t_enter, min=0.0)
    t_end = torch.where(hit_in & (t_in > 0), t_in, t_exit_out)
    return dirs_scene, db, ob, hit_out, t_enter, t_end


def sampled_texels(ob, db, t_enter, t_end, mh: int, mw: int):
    """(NBLK, 16, N_FRAC) flat indices into an (mh, mw) max map of the
    chord samples that bound each block's height: 16 rays (every 8th) x 6
    fractions of their chords."""
    from moonrtx_tpu_torch.engine.geometry import unit_to_latlon

    step = max(db.shape[1] // 16, 1)
    db_s = db[:, ::step]
    te_s = t_enter[:, ::step]
    tn_s = t_end[:, ::step]
    fr = torch.linspace(0.0, 1.0, N_FRAC, dtype=torch.float32,
                        device=db.device)
    t_s = te_s[..., None] + (tn_s - te_s)[..., None] * fr
    p_s = ob + t_s[..., None] * db_s[..., None, :]
    lat_s, lon_s = unit_to_latlon(p_s)
    rows = torch.clamp(((90.0 - lat_s) / 180.0 * mh).to(torch.int32),
                       0, mh - 1)
    cols = torch.clamp((torch.remainder(lon_s + 180.0, 360.0) / 360.0
                        * mw).to(torch.int32), 0, mw - 1)
    return (rows * mw + cols).long()


def block_rays_plain(basis, rotation, jitter, height: int, width: int,
                     h_min: float, maxmap=None, h_bound=None, row_offset=0,
                     full_height: int = None, image_dirs: bool = True):
    """The plain version: jittered rays + shell-chord ranges tightened
    against the per-block local max height (from the dilated coarse max
    map, or a cached bound)."""
    from moonrtx_tpu_torch.engine.blocked import RayGeom

    dirs_scene, db, ob, hit_out, t_enter, t_end = shell_chords(
        basis, rotation, jitter, height, width, h_min, row_offset,
        full_height, image_dirs)
    if maxmap is not None and h_bound is None:
        # per-block local height bound from a sparse chord sampling (16 rays
        # x 6 chord fractions per block on the dilated coarse map)
        hs = maxmap.reshape(-1)[sampled_texels(ob, db, t_enter, t_end,
                                               *maxmap.shape)]
        h_bound = torch.amax(hs.reshape(hs.shape[0], -1), dim=-1) + HB_MARGIN
    if h_bound is not None:
        r_bound = C.MOON_RADIUS * torch.clamp(h_bound, max=1.0)[:, None]
        # clip the chord to the segment inside the local-max sphere
        b = torch.sum(ob * db, dim=-1)
        cc = torch.sum(ob * ob) - r_bound * r_bound
        disc = b * b - cc
        crosses = disc > 0.0
        s = torch.sqrt(torch.clamp(disc, min=0.0))
        t_enter = torch.maximum(t_enter, torch.where(crosses, -b - s,
                                                     t_enter))
        t_end = torch.minimum(t_end, torch.where(crosses, -b + s, t_end))
        hit_out = hit_out & crosses & (t_end > t_enter)

    # inactive rays collapse to the block's mean chord so windows stay tight
    t_enter_m = torch.where(hit_out, t_enter, torch.nan)
    mean_enter = torch.nan_to_num(
        torch.nanmean(t_enter_m, dim=1, keepdim=True), nan=0.0)
    t_enter = torch.where(hit_out, t_enter, mean_enter)
    t_end = torch.where(hit_out, t_end, mean_enter)
    return RayGeom(db=db, ob=ob, t_enter=t_enter, t_end=t_end,
                   hit_outer=hit_out, dirs_scene=dirs_scene,
                   h_bound=h_bound)


def _fractions() -> list:
    """torch.linspace(0, 1, N_FRAC)'s float32 values as torch's kernel
    makes them: start + step * i for the first half, end - step * (n - 1 -
    i) for the rest, step = (end - start) / (n - 1) in float32."""
    f32 = np.float32
    step = (f32(1.0) - f32(0.0)) / f32(N_FRAC - 1)
    half = N_FRAC // 2
    return [float(f32(0.0) + step * f32(i)) if i < half
            else float(f32(1.0) - step * f32(N_FRAC - 1 - i))
            for i in range(N_FRAC)]


FRACTIONS = _fractions()


_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int


class _RaySetupArgs(ctypes.Structure):
    _fields_ = (
        [(n, _P) for n in ("eye", "forward", "right", "up", "tan_half_fov",
                           "rotation", "jitter", "maxmap", "hbound_in",
                           "dirs", "db", "ob", "t_enter", "t_end",
                           "hit_outer", "hbound_out")]
        + [("frac", _F * N_FRAC)]
        + [(n, _F) for n in ("row_offset", "inv_fh", "inv_width",
                             "w_over_fh", "moon_r", "r2_outer", "r2_inner",
                             "rad2deg", "inv_180", "inv_360", "mh_f", "mw_f",
                             "margin")]
        + [(n, _I) for n in ("mh", "mw", "width", "wbk", "nblk")])


def _input(name: str, t, shape, dev):
    """``t`` as the kernel reads it: float32, contiguous, on ``dev``, of
    ``shape`` (None: one number); raises on another device or shape."""
    t = torch.as_tensor(t, dtype=torch.float32)
    ok_shape = t.numel() == 1 if shape is None else tuple(t.shape) == shape
    if t.device != dev or not ok_shape:
        want = "one number" if shape is None else str(shape)
        raise ValueError(f"block_rays: {name} must be {want} on {dev}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.contiguous()


# no pallas_call: the JAX package's ray setup is jnp code XLA fuses
@kernels.register("ray_setup", "mrtx_ray_setup", _RaySetupArgs,
                  passes=("ray_setup_kernel",), plain=block_rays_plain,
                  replaces="none: jnp code XLA fuses "
                           "(moonrtx_tpu/engine/blocked.py:199 block_rays)")
def block_rays(basis, rotation, jitter, height: int, width: int,
               h_min: float, maxmap=None, h_bound=None, row_offset=0,
               full_height: int = None, image_dirs: bool = True):
    """Jittered rays + shell-chord ranges tightened against the per-block
    local max height: engine.blocked.RayGeom in block layout (8x16-pixel
    blocks of 128 rays, block-row-major).

    basis (engine.camera.CameraBasis) and rotation (3, 3): the camera and
    the body-to-scene rotation; jitter: (2,) (row, column) sub-pixel
    offset, or None; height, width: the frame (or strip); h_min: the inner
    sphere's radius in Moon radii; maxmap: the dilated coarse max map
    (mh, mw), read where h_bound (NBLK,), a cached bound, is None; neither:
    the chords are not clipped. row_offset/full_height select a horizontal
    strip of a full_height-row frame (parallel/tiles.py); image_dirs: also
    return the (height, width, 3) scene-frame directions. On the CPU the
    plain version; on the card one kernel launch."""
    call = dict(locals())
    dev = basis.eye.device
    if height % BLOCK_H or width % BLOCK_W:
        raise ValueError(f"block_rays: a {height}x{width} frame is not a "
                         f"grid of {BLOCK_H}x{BLOCK_W}-pixel blocks")
    if dev.type != "cuda":
        return block_rays_plain(basis, rotation, jitter, height, width,
                                h_min, maxmap=maxmap, h_bound=h_bound,
                                row_offset=row_offset,
                                full_height=full_height,
                                image_dirs=image_dirs)
    from moonrtx_tpu_torch.engine.blocked import RayGeom

    nblk = (height // BLOCK_H) * (width // BLOCK_W)
    ins = {name: _input(name, t, shape, dev) for name, t, shape in (
        ("eye", basis.eye, (3,)), ("forward", basis.forward, (3,)),
        ("right", basis.right, (3,)), ("up", basis.up, (3,)),
        ("tan_half_fov", basis.tan_half_fov, None),
        ("rotation", rotation, (3, 3)))}
    if jitter is not None:
        ins["jitter"] = _input("jitter", jitter, (2,), dev)
    if h_bound is not None:
        ins["hbound_in"] = _input("h_bound", h_bound, (nblk,), dev)
    elif maxmap is not None:
        if maxmap.ndim != 2:
            raise ValueError(f"block_rays: maxmap must be 2-D, got "
                             f"{tuple(maxmap.shape)}")
        ins["maxmap"] = _input("maxmap", maxmap, tuple(maxmap.shape), dev)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = dict(db=empty(nblk, BLOCK, 3), ob=empty(3),
               t_enter=empty(nblk, BLOCK), t_end=empty(nblk, BLOCK),
               hit_outer=empty(nblk, BLOCK, dtype=torch.bool))
    if image_dirs:
        out["dirs"] = empty(height, width, 3)
    a = _RaySetupArgs()
    if "maxmap" in ins:
        out["hbound_out"] = empty(nblk)
        a.mh, a.mw = maxmap.shape
        a.mh_f, a.mw_f = float(a.mh), float(a.mw)
    for name, t in {**ins, **out}.items():
        setattr(a, name, t.data_ptr())
    a.frac[:] = FRACTIONS
    # the host numbers as torch makes them float32 on the card: a division
    # by a host number is a product with its float32 reciprocal
    f32 = np.float32
    fh = height if full_height is None else full_height
    a.row_offset = float(row_offset)
    a.inv_fh = f32(1.0) / f32(fh)
    a.inv_width = f32(1.0) / f32(width)
    a.w_over_fh = width / fh
    r_in = C.MOON_RADIUS * h_min * 0.999
    a.moon_r = C.MOON_RADIUS
    a.r2_outer, a.r2_inner = C.MOON_RADIUS * C.MOON_RADIUS, r_in * r_in
    a.rad2deg = RAD2DEG
    a.inv_180 = f32(1.0) / f32(180.0)
    a.inv_360 = f32(1.0) / f32(360.0)
    a.margin = HB_MARGIN
    a.width, a.wbk, a.nblk = width, width // BLOCK_W, nblk
    kernels.launch(block_rays, a, out["db"], call)
    return RayGeom(db=out["db"], ob=out["ob"], t_enter=out["t_enter"],
                   t_end=out["t_end"], hit_outer=out["hit_outer"],
                   dirs_scene=out.get("dirs"),
                   h_bound=out.get("hbound_out", h_bound))
