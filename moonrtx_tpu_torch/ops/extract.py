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
  march kernel's packed layout, an (H, W, 3) level's channels into
  column blocks of their own;
* ``extract_level_windows`` / ``extract_windows`` (K5) — one decoded f32
  window per block, any block count, an (H, W, 3) level's texels whole
  in their own order, several maps side by side, bit-exact;
* ``resample_group_windows`` (K4) — extraction fused with a bilinear
  resample on bf16 mean-centered residuals.

K1 and K5 read their levels in place through their strides: no level is
copied.

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
    """(nblk, wh, ww[, C]) raw windows, block b from levels[lvl_idx[b]] at
    its (r0, c0); 3-D (H, W, C) levels give whole texels. The level index
    clamps into the pyramid, as in every kernel. Indices clamp into the
    level like K1's and K4's guard; with zero_outside, texels outside the
    level are raw 0 instead (K5)."""
    nblk = r0.shape[0]
    dev = r0.device
    out = torch.zeros((nblk, wh, ww) + tuple(levels[0].shape[2:]),
                      dtype=levels[0].dtype, device=dev)
    ar = torch.arange(wh, device=dev)
    ac = torch.arange(ww, device=dev)
    lvl_idx = torch.clamp(lvl_idx, 0, len(levels) - 1)
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
            inside = inside.reshape(inside.shape + (1,) * (win.ndim - 3))
            win = torch.where(inside, win, torch.zeros_like(win))
        out[sel] = win
    return out


def _check_common(levels_flat, lvl_idx, r0, c0):
    """Block count of a call; every level one dtype and one device, all
    2-D or all (H, W, C) with one C."""
    dev = lvl_idx.device
    dtype = levels_flat[0].dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported map dtype {dtype}")
    texel = tuple(levels_flat[0].shape[2:])
    for lvl in levels_flat:
        if (lvl.ndim not in (2, 3) or tuple(lvl.shape[2:]) != texel
                or lvl.dtype != dtype or lvl.device != dev):
            raise ValueError("levels must be 2-D or (H, W, C) with one C, "
                             "one dtype, one device")
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
        ("row_stride", ctypes.c_longlong * (MAX_MAPS * MAX_LEVELS)),
        ("col_stride", ctypes.c_longlong * (MAX_MAPS * MAX_LEVELS)),
        ("chan_stride", ctypes.c_longlong * (MAX_MAPS * MAX_LEVELS)),
        ("scale", ctypes.c_float * MAX_MAPS),
        ("offset", ctypes.c_float * MAX_MAPS),
        ("lvl", ctypes.c_void_p), ("r0", ctypes.c_void_p),
        ("c0", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("nblk", ctypes.c_int), ("n_maps", ctypes.c_int),
        ("n_chan", ctypes.c_int), ("n_levels", ctypes.c_int),
        ("wh", ctypes.c_int), ("ww", ctypes.c_int), ("cmul", ctypes.c_int),
        ("src_dtype", ctypes.c_int), ("out_bf16", ctypes.c_int),
        ("rows_per_thread", ctypes.c_int),
    ]


# window rows each thread of K1/K5 walks (a thread block holds whole rows
# of 16-byte chunks); tools/torch_kernel_tune.py --variants times others
ROWS_PER_THREAD = 4


def _extract_args(maps, lvl_idx, r0, c0, out, wh, ww, scales, offsets,
                  fold_channels) -> _ExtractArgs:
    """K1's or K5's arguments, from levels read in place through their
    strides. fold_channels (K5): an (H, W, C) level goes over as rows of
    W*C elements, the window as ww*C columns from c0*C (its channels must
    be contiguous); otherwise (K1) each channel is an output segment of
    its own."""
    n_levels = len(maps[0])
    if len(maps) > MAX_MAPS or n_levels > MAX_LEVELS:
        raise ValueError("too many maps or levels for the kernel")
    if any(len(levels) != n_levels for levels in maps):
        raise ValueError("every map needs the same number of levels")
    nch = maps[0][0].shape[2] if maps[0][0].ndim == 3 else 1
    a = _ExtractArgs()
    for m, levels in enumerate(maps):
        for k, lvl in enumerate(levels):
            i = m * n_levels + k
            h, w = lvl.shape[0], lvl.shape[1]
            rs, cs = lvl.stride(0), lvl.stride(1)
            chs = lvl.stride(2) if lvl.ndim == 3 else 0
            if min(rs, cs, chs) < 0:
                raise ValueError("levels must have non-negative strides")
            if fold_channels and nch > 1:
                if chs != 1 or cs != nch:
                    raise ValueError("an (H, W, C) level must hold its "
                                     "channels contiguously")
                w, cs, chs = w * nch, 1, 0
            if (w - 1) * cs + (nch - 1) * chs >= 2 ** 31:
                raise ValueError("a level row is too long for the kernel")
            a.tex[i] = lvl.data_ptr()
            a.rows[i], a.cols[i] = h, w
            a.row_stride[i], a.col_stride[i], a.chan_stride[i] = rs, cs, chs
        a.scale[m] = scales[m]
        a.offset[m] = offsets[m]
    cmul = nch if fold_channels else 1
    a.n_chan = 1 if fold_channels else nch
    chunk = 16 // out.element_size()
    a.ww = ww * cmul
    if (a.ww // chunk if a.ww % chunk == 0 else a.ww) * len(maps) \
            * a.n_chan > 1024:
        raise ValueError("a window row is too wide for one thread block")
    a.lvl, a.r0, a.c0 = (lvl_idx.data_ptr(), r0.data_ptr(), c0.data_ptr())
    a.out = out.data_ptr()
    a.nblk, a.n_maps, a.n_levels = r0.shape[0], len(maps), n_levels
    a.wh, a.cmul, a.rows_per_thread = wh, cmul, ROWS_PER_THREAD
    a.src_dtype = _DTYPE_CODE[maps[0][0].dtype]
    a.out_bf16 = int(out.dtype == torch.bfloat16)
    return a


def _planar(win):
    """(n, wh, ww, C) -> (n, wh, C*ww), channel c in columns
    [c*ww, (c+1)*ww); 2-D windows stay."""
    if win.ndim == 3:
        return win
    return win.permute(0, 1, 3, 2).reshape(win.shape[0], win.shape[1], -1)


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
        outs.append(_planar(
            decode_affine(win, scales[m], offsets[m]).to(out_dtype)))
    row = torch.cat(outs, dim=2)
    return row.reshape(nblk // group, group * wh, row.shape[2])


@kernels.register("extract", "mrtx_extract_group_windows", _ExtractArgs,
                  passes=("extract_group_kernel",),
                  plain=extract_group_windows_plain,
                  replaces="moonrtx_tpu/ops/extract.py:372")
def extract_group_windows(map_levels, lvl_idx, r0, c0, wh: int, ww: int,
                          scales=None, offsets=None, group: int = 8,
                          out_dtype=torch.float32):
    """Grouped multi-map per-block window extraction (K1).

    Replaces moonrtx_tpu/ops/extract.py::extract_group_windows_tpu.
    map_levels: tuple of maps, each a tuple of n_levels pyramid levels of
    one dtype (f32, int16, uint8 or bf16), read in place through their
    strides; a map of (H, W, C) levels (an interleaved albedo) counts as
    C maps, one per channel, each texel read whole. All maps share
    lvl_idx/r0/c0 ((nblk,) int32 block origins in the block's own level
    coordinates, pre-clamped to [0, H_k-wh] x [0, W_k-ww]) and the number
    of channels; scales/offsets are per entry of map_levels.

    Returns (nblk // group, group*wh, n_out*ww), n_out the maps counted
    by channel: ``group`` consecutive blocks stacked along rows (the march
    kernel's packed layout), map (or channel) j in columns
    [j*ww, (j+1)*ww), each decoded ``raw*scale + offset`` in f32
    (multiply and add separately rounded) and cast to out_dtype (f32 or
    bf16, round to nearest even). Bit-exact against the plain version.
    """
    call = dict(locals())
    n_maps = len(map_levels)
    scales = tuple(float(s) for s in (scales or (1.0,) * n_maps))
    offsets = tuple(float(o) for o in (offsets or (0.0,) * n_maps))
    maps = [list(levels) for levels in map_levels]
    nblk = _check_common([lvl for m in maps for lvl in m], lvl_idx, r0, c0)
    if nblk % group:
        raise ValueError(f"nblk {nblk} not divisible by group {group}")
    if any(len(levels) != len(maps[0]) for levels in maps):
        raise ValueError("every map needs the same number of levels")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"unsupported out_dtype {out_dtype}")
    if lvl_idx.device.type != "cuda":
        return extract_group_windows_plain(
            map_levels, lvl_idx, r0, c0, wh, ww, scales, offsets, group,
            out_dtype)
    nch = maps[0][0].shape[2] if maps[0][0].ndim == 3 else 1
    out = torch.empty((nblk // group, group * wh, n_maps * nch * ww),
                      dtype=out_dtype, device=lvl_idx.device)
    kernels.launch(extract_group_windows,
                   _extract_args(maps, lvl_idx, r0, c0, out, wh, ww, scales,
                                 offsets, fold_channels=False), out, call)
    return out


# ---- one window per block from the block's own level (K5) ------------------

_LEVEL_DTYPES = (torch.float32, torch.int16, torch.uint8)


def _level_maps(levels):
    """A pyramid, or a sequence of pyramids (maps side by side), as a list
    of maps."""
    if isinstance(levels[0], torch.Tensor):
        return [list(levels)]
    return [list(m) for m in levels]


def extract_level_windows_plain(levels, lvl_idx, r0, c0, wh: int, ww: int,
                                scale: float = 1.0, offset: float = 0.0):
    """Plain PyTorch version of extract_level_windows (same contract)."""
    outs = [decode_affine(
        _cut_windows(m, lvl_idx, r0, c0, wh, ww, zero_outside=True),
        float(scale), float(offset)) for m in _level_maps(levels)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


@kernels.register("extract", "mrtx_extract_level_windows", _ExtractArgs,
                  passes=("extract_level_kernel",),
                  plain=extract_level_windows_plain,
                  replaces="moonrtx_tpu/ops/extract.py:239")
def extract_level_windows(levels, lvl_idx, r0, c0, wh: int, ww: int,
                          scale: float = 1.0, offset: float = 0.0):
    """Per-block windows from levels[lvl_idx[b]] in one pass (K5).

    Replaces moonrtx_tpu/ops/extract.py::extract_level_windows_tpu.
    levels: 1..4 same-dtype pyramid levels (f32, int16 or uint8), 2-D of
    any strides (a channel plane ``lvl[:, :, ch]`` is read in place), or
    (H, W, C) with contiguous channels (read as whole texels); or a
    sequence of up to 4 such pyramids (maps) that share the origins.
    lvl_idx/r0/c0: (nblk,) int32, the origins in each block's own level
    coordinates, pre-clamped to [0, H_k-wh] x [0, W_k-ww]; nblk is
    arbitrary. Texels outside the level (a level smaller than the window)
    come back as raw 0, as from the reference kernel's zero-padded levels.

    Returns (nblk, wh, ww) f32, (nblk, wh, ww, C) for (H, W, C) levels,
    and for several maps their windows side by side, map m in columns
    [m*ww, (m+1)*ww): (nblk, wh, n_maps*ww[, C]). Decoded ``raw*scale +
    offset`` with the multiply and the add separately rounded. Bit-exact
    against the plain version.
    """
    call = dict(locals())
    maps = _level_maps(levels)
    nblk = _check_common([lvl for m in maps for lvl in m], lvl_idx, r0, c0)
    if maps[0][0].dtype not in _LEVEL_DTYPES:
        raise TypeError(f"unsupported map dtype {maps[0][0].dtype}")
    if lvl_idx.device.type != "cuda":
        return extract_level_windows_plain(levels, lvl_idx, r0, c0, wh, ww,
                                           scale, offset)
    texel = tuple(maps[0][0].shape[2:])
    out = torch.empty((nblk, wh, len(maps) * ww) + texel,
                      dtype=torch.float32, device=lvl_idx.device)
    kernels.launch(extract_level_windows,
                   _extract_args(maps, lvl_idx, r0, c0, out, wh, ww,
                                 (float(scale),) * len(maps),
                                 (float(offset),) * len(maps),
                                 fold_channels=True), out, call)
    return out


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


@kernels.register("resample", "mrtx_resample_group_windows", _ResampleArgs,
                  passes=("resample_kernel",),
                  plain=resample_group_windows_plain,
                  replaces="moonrtx_tpu/ops/extract.py:516")
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
    if levels[0].ndim != 2:
        raise ValueError("resample takes 2-D levels")
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
    kernels.launch(resample_group_windows, a, out, call)
    return out
