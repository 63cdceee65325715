"""Per-block window extraction and the fused window resample.

Port of moonrtx_tpu/ops/extract.py. The blocked pipeline's caches are
thousands of small windows ``tex[r0[b]:r0[b]+wh, c0[b]:c0[b]+ww]`` cut from
device-resident pyramid levels, each block from its own level. The TPU
kernels fetch tile-aligned superwindows by DMA and recompact them with
one-hot MXU contractions (the TPU has no gather hardware). On Hopper each
kernel reads its texels directly (csrc/extract.cu; csrc/resample.cu
streams a window's rows in aligned 16-byte chunks).

Three kernels, each beside its plain PyTorch version:

* ``extract_group_windows`` (K1) — grouped multi-map extraction with the
  affine decode ``value = raw * scale + offset``, bit-exact, into the
  march kernel's packed layout;
* ``extract_level_windows`` / ``extract_windows`` (K5) — one decoded f32
  window per block, any block count, levels read through their strides
  (a channel plane of an (H, W, 3) level is not copied), bit-exact;
* ``resample_group_windows`` (K4) — extraction fused with a bilinear
  resample on bf16 mean-centered residuals.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from moonrtx_tpu_torch import kernels

COL_TILE = 128
MAX_MAPS = 4
MAX_LEVELS = 4
_DTYPE_CODE = {torch.float32: 0, torch.int16: 1, torch.uint8: 2,
               torch.bfloat16: 3}


def _row_tile(dtype) -> int:
    """TPU sublane tile of a dtype ((8,128) f32, (16,128) 16-bit, (32,128)
    8-bit). The resample's fractional coordinates are formed relative to
    the tile-aligned window origin, as the TPU kernel forms them, so both
    round alike."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 8 * (4 // itemsize)


def decode_affine(raw, scale: float, offset: float):
    """value = raw * scale + offset in f32 (identity steps skipped)."""
    out = raw if raw.dtype == torch.float32 else raw.to(torch.float32)
    if scale != 1.0:
        out = out * scale
    if offset != 0.0:
        out = out + offset
    return out


def _cut_windows(levels, lvl_idx, r0, c0, wh: int, ww: int,
                 zero_outside: bool = False):
    """(nblk, wh, ww) raw windows, block b from levels[lvl_idx[b]] at its
    (r0, c0). Indices clamp into the level like K1's and K4's guard; with
    zero_outside, texels outside the level are raw 0 instead (K5)."""
    nblk = r0.shape[0]
    dev = r0.device
    out = torch.zeros((nblk, wh, ww), dtype=levels[0].dtype, device=dev)
    ar = torch.arange(wh, device=dev)
    ac = torch.arange(ww, device=dev)
    for k, lvl in enumerate(levels):
        sel = torch.nonzero(lvl_idx == k)[:, 0]
        if sel.numel() == 0:
            continue
        rows = r0[sel, None].long() + ar
        cols = c0[sel, None].long() + ac
        rc = torch.clamp(rows, 0, lvl.shape[0] - 1)
        cc = torch.clamp(cols, 0, lvl.shape[1] - 1)
        win = lvl[rc[:, :, None], cc[:, None, :]]
        if zero_outside:
            inside = ((rows == rc)[:, :, None] & (cols == cc)[:, None, :])
            win = torch.where(inside, win, torch.zeros_like(win))
        out[sel] = win
    return out


def _check_common(levels_flat, lvl_idx, r0, c0):
    dev = lvl_idx.device
    dtype = levels_flat[0].dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported map dtype {dtype}")
    for lvl in levels_flat:
        if lvl.ndim != 2 or lvl.dtype != dtype or lvl.device != dev:
            raise ValueError("levels must be 2-D, one dtype, one device")
    nblk = r0.shape[0]
    for t in (lvl_idx, r0, c0):
        if (t.dtype != torch.int32 or t.shape != (nblk,) or t.device != dev):
            raise ValueError("lvl_idx/r0/c0 must be (nblk,) int32 on the "
                             "levels' device")
    return nblk


class _ExtractArgs(ctypes.Structure):
    _fields_ = [
        ("tex", ctypes.c_void_p * (MAX_MAPS * MAX_LEVELS)),
        ("rows", ctypes.c_longlong * (MAX_MAPS * MAX_LEVELS)),
        ("cols", ctypes.c_longlong * (MAX_MAPS * MAX_LEVELS)),
        ("scale", ctypes.c_float * MAX_MAPS),
        ("offset", ctypes.c_float * MAX_MAPS),
        ("lvl", ctypes.c_void_p), ("r0", ctypes.c_void_p),
        ("c0", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("nblk", ctypes.c_int), ("n_maps", ctypes.c_int),
        ("n_levels", ctypes.c_int), ("wh", ctypes.c_int),
        ("ww", ctypes.c_int), ("group", ctypes.c_int),
        ("src_dtype", ctypes.c_int), ("out_bf16", ctypes.c_int),
    ]


def extract_group_windows_plain(map_levels, lvl_idx, r0, c0, wh: int,
                                ww: int, scales=None, offsets=None,
                                group: int = 8, out_dtype=torch.float32):
    """Plain PyTorch version of extract_group_windows (same contract)."""
    nblk = r0.shape[0]
    scales = scales or (1.0,) * len(map_levels)
    offsets = offsets or (0.0,) * len(map_levels)
    outs = []
    for m, levels in enumerate(map_levels):
        win = _cut_windows(levels, lvl_idx, r0, c0, wh, ww)
        outs.append(decode_affine(win, scales[m], offsets[m]).to(out_dtype))
    row = torch.cat(outs, dim=2)
    return row.reshape(nblk // group, group * wh, len(map_levels) * ww)


def extract_group_windows(map_levels, lvl_idx, r0, c0, wh: int, ww: int,
                          scales=None, offsets=None, group: int = 8,
                          out_dtype=torch.float32):
    """Grouped multi-map per-block window extraction (K1).

    Replaces moonrtx_tpu/ops/extract.py::extract_group_windows_tpu.
    map_levels: tuple of maps, each a tuple of n_levels same-dtype 2-D
    pyramid levels (f32, int16, uint8 or bf16); all maps share
    lvl_idx/r0/c0 ((nblk,) int32 block origins in the block's own level
    coordinates, pre-clamped to [0, H_k-wh] x [0, W_k-ww]).

    Returns (nblk // group, group*wh, n_maps*ww): ``group`` consecutive
    blocks stacked along rows (the march kernel's packed layout), map m in
    columns [m*ww, (m+1)*ww), each decoded ``raw*scale + offset`` in f32
    (multiply and add separately rounded) and cast to out_dtype (f32 or
    bf16, round to nearest even). Bit-exact against the plain version.
    """
    call = dict(locals())
    n_maps = len(map_levels)
    n_levels = len(map_levels[0])
    scales = tuple(float(s) for s in (scales or (1.0,) * n_maps))
    offsets = tuple(float(o) for o in (offsets or (0.0,) * n_maps))
    flat = [lvl for levels in map_levels for lvl in levels]
    nblk = _check_common(flat, lvl_idx, r0, c0)
    if nblk % group:
        raise ValueError(f"nblk {nblk} not divisible by group {group}")
    if any(len(levels) != n_levels for levels in map_levels):
        raise ValueError("every map needs the same number of levels")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    if lvl_idx.device.type != "cuda":
        return extract_group_windows_plain(
            map_levels, lvl_idx, r0, c0, wh, ww, scales, offsets, group,
            out_dtype)
    if n_maps > MAX_MAPS or n_levels > MAX_LEVELS:
        raise ValueError("too many maps or levels for the kernel")
    flat = [lvl.contiguous() for lvl in flat]
    out = torch.empty((nblk // group, group * wh, n_maps * ww),
                      dtype=out_dtype, device=lvl_idx.device)
    a = _ExtractArgs()
    for i, lvl in enumerate(flat):
        a.tex[i] = lvl.data_ptr()
        a.rows[i] = lvl.shape[0]
        a.cols[i] = lvl.shape[1]
    for m in range(n_maps):
        a.scale[m] = scales[m]
        a.offset[m] = offsets[m]
    a.lvl, a.r0, a.c0 = (lvl_idx.data_ptr(), r0.data_ptr(), c0.data_ptr())
    a.out = out.data_ptr()
    a.nblk, a.n_maps, a.n_levels = nblk, n_maps, n_levels
    a.wh, a.ww, a.group = wh, ww, group
    a.src_dtype = _DTYPE_CODE[flat[0].dtype]
    a.out_bf16 = int(out_dtype == torch.bfloat16)
    with torch.cuda.device(lvl_idx.device):
        rc = kernels.entry("extract", "mrtx_extract_group_windows",
                           _ExtractArgs)(ctypes.byref(a),
                                         kernels.stream_of(out))
    kernels.check("extract", rc)
    kernels.launched(extract_group_windows, call)
    return out


extract_group_windows.launches = 0


# ---- one window per block from the block's own level (K5) ------------------

_LEVEL_DTYPES = (torch.float32, torch.int16, torch.uint8)


class _LevelArgs(ctypes.Structure):
    _fields_ = [
        ("tex", ctypes.c_void_p * MAX_LEVELS),
        ("rows", ctypes.c_longlong * MAX_LEVELS),
        ("cols", ctypes.c_longlong * MAX_LEVELS),
        ("row_stride", ctypes.c_longlong * MAX_LEVELS),
        ("elem_stride", ctypes.c_longlong * MAX_LEVELS),
        ("lvl", ctypes.c_void_p), ("r0", ctypes.c_void_p),
        ("c0", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("scale", ctypes.c_float), ("offset", ctypes.c_float),
        ("nblk", ctypes.c_int), ("n_levels", ctypes.c_int),
        ("wh", ctypes.c_int), ("ww", ctypes.c_int),
        ("src_dtype", ctypes.c_int),
    ]


def extract_level_windows_plain(levels, lvl_idx, r0, c0, wh: int, ww: int,
                                scale: float = 1.0, offset: float = 0.0):
    """Plain PyTorch version of extract_level_windows (same contract)."""
    return decode_affine(
        _cut_windows(levels, lvl_idx, r0, c0, wh, ww, zero_outside=True),
        float(scale), float(offset))


def extract_level_windows(levels, lvl_idx, r0, c0, wh: int, ww: int,
                          scale: float = 1.0, offset: float = 0.0):
    """Per-block windows from levels[lvl_idx[b]] in one pass (K5).

    Replaces moonrtx_tpu/ops/extract.py::extract_level_windows_tpu.
    levels: 1..4 same-dtype 2-D pyramid levels (f32, int16 or uint8), of
    any strides: a channel plane ``lvl[:, :, ch]`` of an (H, W, 3) level is
    read in place. lvl_idx/r0/c0: (nblk,) int32, the origins in each
    block's own level coordinates, pre-clamped to [0, H_k-wh] x
    [0, W_k-ww]; nblk is arbitrary. Texels outside the level (a level
    smaller than the window) come back as raw 0, as from the reference
    kernel's zero-padded levels.

    Returns (nblk, wh, ww) f32, decoded ``raw*scale + offset`` with the
    multiply and the add separately rounded. Bit-exact against the plain
    version.
    """
    call = dict(locals())
    levels = list(levels)
    nblk = _check_common(levels, lvl_idx, r0, c0)
    if levels[0].dtype not in _LEVEL_DTYPES:
        raise TypeError(f"unsupported map dtype {levels[0].dtype}")
    if lvl_idx.device.type != "cuda":
        return extract_level_windows_plain(levels, lvl_idx, r0, c0, wh, ww,
                                           scale, offset)
    if len(levels) > MAX_LEVELS:
        raise ValueError("too many levels for the kernel")
    if any(st < 0 for lvl in levels for st in lvl.stride()):
        raise ValueError("levels must have non-negative strides")
    out = torch.empty((nblk, wh, ww), dtype=torch.float32,
                      device=lvl_idx.device)
    a = _LevelArgs()
    for i, lvl in enumerate(levels):
        a.tex[i] = lvl.data_ptr()
        a.rows[i], a.cols[i] = lvl.shape
        a.row_stride[i], a.elem_stride[i] = lvl.stride()
    a.lvl, a.r0, a.c0 = (lvl_idx.data_ptr(), r0.data_ptr(), c0.data_ptr())
    a.out = out.data_ptr()
    a.scale, a.offset = float(scale), float(offset)
    a.nblk, a.n_levels, a.wh, a.ww = nblk, len(levels), wh, ww
    a.src_dtype = _DTYPE_CODE[levels[0].dtype]
    with torch.cuda.device(lvl_idx.device):
        rc = kernels.entry("extract", "mrtx_extract_level_windows",
                           _LevelArgs)(ctypes.byref(a),
                                       kernels.stream_of(out))
    kernels.check("extract", rc)
    kernels.launched(extract_level_windows, call)
    return out


extract_level_windows.launches = 0


def extract_windows(tex, r0, c0, wh: int, ww: int, scale: float = 1.0,
                    offset: float = 0.0):
    """Per-block windows of one 2-D map, decoded f32 (K5 with one level).

    Replaces moonrtx_tpu/ops/extract.py::extract_windows_tpu (and its
    dispatcher extract_windows). r0/c0: (nblk,) int32 pre-clamped to
    [0, H-wh] x [0, W-ww]."""
    return extract_level_windows((tex,), torch.zeros_like(r0), r0, c0, wh,
                                 ww, scale=scale, offset=offset)


# ---- fused window resample (extraction + bilinear in one kernel) -----------

class _ResampleArgs(ctypes.Structure):
    _fields_ = [
        ("tex", ctypes.c_void_p * MAX_LEVELS),
        ("rows", ctypes.c_longlong * MAX_LEVELS),
        ("cols", ctypes.c_longlong * MAX_LEVELS),
        ("lvl", ctypes.c_void_p), ("r0", ctypes.c_void_p),
        ("c0", ctypes.c_void_p), ("wy", ctypes.c_void_p),
        ("wx", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("scale", ctypes.c_float), ("offset", ctypes.c_float),
        ("nblk", ctypes.c_int), ("b", ctypes.c_int),
        ("n_levels", ctypes.c_int), ("wh", ctypes.c_int),
        ("ww", ctypes.c_int), ("src_dtype", ctypes.c_int),
    ]


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def resample_group_windows_plain(levels, lvl_idx, r0, c0, wy, wx, wh: int,
                                 ww: int, scale: float = 1.0,
                                 offset: float = 0.0, group: int = 8):
    """Plain PyTorch version of resample_group_windows (same contract and
    rounding points: bf16 residuals, bf16 column weights, f32 row
    weights; the window mean is summed in another order)."""
    nblk, b = wy.shape
    dev = wy.device
    win = decode_affine(_cut_windows(levels, lvl_idx, r0, c0, wh, ww),
                        scale, offset)
    mean = win.sum(dim=(1, 2)) / float(wh * ww)
    res = _bf16(win - mean[:, None, None]).reshape(-1)
    row_tile = _row_tile(levels[0].dtype)
    offr = r0 - torch.div(r0, row_tile, rounding_mode="floor") * row_tile
    offc = c0 - torch.div(c0, COL_TILE, rounding_mode="floor") * COL_TILE
    # clamp in window coordinates, then shift into the tile-aligned frame
    wyc = torch.clamp(wy, 0.0, wh - 1.001) + offr.to(torch.float32)[:, None]
    wxc = torch.clamp(wx, 0.0, ww - 1.001) + offc.to(torch.float32)[:, None]
    y0 = torch.floor(wyc)
    x0 = torch.floor(wxc)
    fy = wyc - y0
    fx = wxc - x0
    ly = y0.long() - offr.long()[:, None]
    lx = x0.long() - offc.long()[:, None]
    base = torch.arange(nblk, device=dev)[:, None] * (wh * ww) + ly * ww + lx
    wc0 = _bf16(1.0 - fx)
    wc1 = _bf16(fx)
    m0 = res[base] * wc0 + res[base + 1] * wc1
    m1 = res[base + ww] * wc0 + res[base + ww + 1] * wc1
    return m0 * (1.0 - fy) + m1 * fy + mean[:, None]


def resample_group_windows(levels, lvl_idx, r0, c0, wy, wx, wh: int,
                           ww: int, scale: float = 1.0, offset: float = 0.0,
                           group: int = 8):
    """Fused per-block window extraction + bilinear resample (K4).

    Replaces moonrtx_tpu/ops/extract.py::resample_group_windows_tpu.
    levels: same-dtype pyramid (f32, int16 or uint8); lvl_idx/r0/c0 as in
    extract_group_windows. wy/wx: (nblk, b) f32 window-relative sample
    coordinates, clamped to [0, wh-1.001] x [0, ww-1.001]. Per block the
    decoded window is mean-centered (mean over the exact window, f32),
    the residuals rounded to bf16 and sampled bilinearly with bf16 column
    weights and f32 row weights; the mean is added back. Returns
    (nblk, b) f32. On the card the mean of int16 and uint8 windows is the
    exact integer mean of the raw texels, decoded once, and a window may
    hold at most 65,535 texels and must fit the block's shared memory
    (the scan's (40, 184) takes 15 to 30 KB of the 227).
    """
    call = dict(locals())
    nblk = _check_common(list(levels), lvl_idx, r0, c0)
    if nblk % group:
        raise ValueError(f"nblk {nblk} not divisible by group {group}")
    if levels[0].dtype == torch.bfloat16:
        raise TypeError("resample takes f32, int16 or uint8 levels")
    for t in (wy, wx):
        if (t.dtype != torch.float32 or t.ndim != 2 or t.shape[0] != nblk
                or t.device != lvl_idx.device):
            raise ValueError("wy/wx must be (nblk, b) f32 on the levels' "
                             "device")
    if wy.shape != wx.shape:
        raise ValueError("wy/wx shapes differ")
    if lvl_idx.device.type != "cuda":
        return resample_group_windows_plain(levels, lvl_idx, r0, c0, wy, wx,
                                            wh, ww, scale, offset, group)
    if len(levels) > MAX_LEVELS:
        raise ValueError("too many levels for the kernel")
    levels = [lvl.contiguous() for lvl in levels]
    wy = wy.contiguous()
    wx = wx.contiguous()
    out = torch.empty(wy.shape, dtype=torch.float32, device=wy.device)
    a = _ResampleArgs()
    for i, lvl in enumerate(levels):
        a.tex[i] = lvl.data_ptr()
        a.rows[i] = lvl.shape[0]
        a.cols[i] = lvl.shape[1]
    a.lvl, a.r0, a.c0 = (lvl_idx.data_ptr(), r0.data_ptr(), c0.data_ptr())
    a.wy, a.wx, a.out = wy.data_ptr(), wx.data_ptr(), out.data_ptr()
    a.scale, a.offset = float(scale), float(offset)
    a.nblk, a.b, a.n_levels = nblk, wy.shape[1], len(levels)
    a.wh, a.ww = wh, ww
    a.src_dtype = _DTYPE_CODE[levels[0].dtype]
    with torch.cuda.device(wy.device):
        rc = kernels.entry("resample", "mrtx_resample_group_windows",
                           _ResampleArgs)(ctypes.byref(a),
                                          kernels.stream_of(out))
    kernels.check("resample", rc)
    kernels.launched(resample_group_windows, call)
    return out


resample_group_windows.launches = 0
