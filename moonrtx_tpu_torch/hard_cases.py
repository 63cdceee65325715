"""Inputs that a wrong kernel design gets wrong, made with numpy from a seed.

For the kernels whose work is split across threads in ways the
reference's sequential form never meets: the shadow prefix-max (K3, theta
split into chunks whose aggregates are folded in a second pass), the
fused window resample (K4, rows streamed in aligned 16-byte chunks with
ragged ends, an edge path for clamped windows) and the window extraction
(K1, K5: 16-byte output chunks of V texels each, interleaved channels,
several maps in one launch, edges clamped or read as zeros).
``chip_smoke.py`` and the tests replay every family through the kernel
(on the card) or its plain version (on the CPU, against the reference
kernel in interpret mode).

numpy only: the callers turn the arrays into tensors of their framework.
"""

from __future__ import annotations

import numpy as np

SHADOW_FAMILIES = ("plateaus", "row0_max", "rising", "falling")
SHADOW_SAR = 0.02   # sun angular radius that keeps these factors off 0 and 1

# K4 families whose origins keep the wrapper's contract (pre-clamped into
# the level), and the one that leaves it (the kernel's clamp guard)
RESAMPLE_FAMILIES = ("edges", "odd_c0", "last_taps")
RESAMPLE_GUARD_FAMILIES = ("outside",)
RESAMPLE_DTYPES = ("float32", "int16", "uint8")

# K1/K5 families, the first ones inside the wrappers' contract (origins
# pre-clamped into the block's level), then the ones that leave it (the
# kernels' guards: K5 reads zeros, K1 clamps)
EXTRACT_FAMILIES = ("phases", "edges", "small_levels", "one_block",
                    "prime_blocks", "pair", "odd_window")
EXTRACT_GUARD_FAMILIES = ("outside", "lvl_range")
# "uint8x3": (H, W, 3) levels, as the albedo is stored; "bfloat16" levels
# are float32 arrays whose values a bf16 holds exactly (K1 only)
EXTRACT_DTYPES = ("float32", "int16", "uint8", "bfloat16", "uint8x3")


def shadow_hard_case(family: str, n_theta: int, n_phi: int, seed: int = 0):
    """(hs, st, ct) float32 for shadow_factor, rounding-free: every height
    is 1 + k 2^-17, sin(theta) is 0.5 on every row, so keys tie exactly
    where heights do, and cos(theta) falls strictly from 0.5 to -0.5, so
    the carried z tells which row won. With ``SHADOW_SAR`` the factors of
    shadowed rows lie inside (0, 1) and move with both m_max and z_at.

    * ``plateaus``: in half of the columns, four rows of equal key, a new
      strict maximum, straddle every multiple of 16 rows (every chunk
      boundary of a split into 16, 32 or 64 rows): the first row of the
      plateau must win, in its own chunk and across the boundary;
    * ``row0_max``: the maximum of every column is its row 0, so the carry
      of the first chunk has to reach every later one;
    * ``rising``: every row is a new strict maximum (the blocker is always
      the row just above, also across a chunk boundary);
    * ``falling``: strictly falling columns, row 0 blocks all.
    """
    rng = np.random.default_rng(seed)
    u = 2.0 ** -17
    rows = np.arange(n_theta)[:, None]
    if family == "plateaus":
        # noise rides on a staircase of one unit per 16 rows, so a plateau
        # (8 above its step) tops everything before it by a few units only
        k = rows // 16 + rng.integers(0, 8, (n_theta, n_phi))
        cols = rng.random((1, n_phi)) < 0.5
        for b in range(16, n_theta, 16):
            on = cols & (rng.random((1, n_phi)) < 0.8)
            k[b - 2:b + 2] = np.where(on, b // 16 + 8, k[b - 2:b + 2])
    elif family == "row0_max":
        k = 128 * rng.integers(0, 16, (n_theta, n_phi))
        k[0] = 128 * 20
    elif family == "rising":
        k = rng.integers(1, 4, (1, n_phi)) * rows
    elif family == "falling":
        k = rng.integers(1, 4, (1, n_phi)) * (n_theta - rows)
    else:
        raise ValueError(f"unknown shadow family {family!r}")
    hs = (1.0 + u * k).astype(np.float32)
    st = np.full((n_theta, 1), 0.5, np.float32)
    q = 2.0 ** -13
    ct = (np.round(np.linspace(0.5, -0.5, n_theta) / q) * q)[:, None]
    assert (np.diff(ct[:, 0]) < 0).all()
    return hs, st, ct.astype(np.float32)


def _level(rng, dtype: str, h: int, w: int):
    if dtype == "float32":
        return (1.0 + 0.01 * rng.standard_normal((h, w))).astype(np.float32)
    if dtype == "int16":
        return rng.integers(-32768, 32767, (h, w)).astype(np.int16)
    if dtype == "uint8":
        return rng.integers(0, 256, (h, w)).astype(np.uint8)
    if dtype == "uint8x3":
        return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    if dtype == "bfloat16":
        a = rng.standard_normal((h, w)).astype(np.float32)
        return (a.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    raise ValueError(f"unknown dtype {dtype!r}")


def resample_hard_case(family: str, dtype: str, b: int = 512, seed: int = 0):
    """Keyword arguments of resample_group_windows as numpy arrays: two
    levels whose widths are no multiple of 8 (every row of a window starts
    at another alignment), (40, 184) windows, 16 blocks of ``b`` samples.

    * ``edges``: windows that touch each of the four edges of their level,
      the four corners included (origins at 0 and at H - wh, W - ww);
    * ``odd_c0``: first columns of every residue modulo 16, odd and even;
    * ``last_taps``: samples on the last row and column the clamp allows
      (wy = wh - 1.001, wx = ww - 1.001), on the first, and beyond both;
    * ``outside`` (outside the wrapper's contract; the kernel's guard):
      origins past each edge, whose texels clamp into the level.
    """
    rng = np.random.default_rng(seed)
    wh, ww, nblk = 40, 184, 16
    shapes = [(101, 523), (57, 263)]
    levels = [_level(rng, dtype, h, w) for h, w in shapes]
    lvl = (np.arange(nblk) % 2).astype(np.int32)
    hmax = np.array([shapes[k][0] - wh for k in lvl])
    wmax = np.array([shapes[k][1] - ww for k in lvl])
    r0 = (rng.random(nblk) * (hmax + 1)).astype(np.int64)
    c0 = (rng.random(nblk) * (wmax + 1)).astype(np.int64)
    wy = rng.uniform(-1.0, wh, (nblk, b))
    wx = rng.uniform(-1.0, ww, (nblk, b))
    if family == "edges":
        top = np.arange(nblk) % 4 < 2          # two blocks per level each
        left = np.arange(nblk) % 8 < 4
        mid = np.arange(nblk) >= 8             # second half: one edge only
        r0 = np.where(top, 0, hmax)
        c0 = np.where(left, 0, wmax)
        r0 = np.where(mid & (np.arange(nblk) % 4 >= 2), r0 // 2 + 1, r0)
        c0 = np.where(mid & (np.arange(nblk) % 4 < 2), c0 // 2 + 1, c0)
    elif family == "odd_c0":
        c0 = np.arange(nblk) % 16 + 16 * (np.arange(nblk) % 3)
    elif family == "last_taps":
        wy[:, 0::4] = wh - 1.001
        wx[:, 1::4] = ww - 1.001
        wy[:, 2::8] = 0.0
        wx[:, 3::8] = 0.0
        wy[:, 4::16] = wh + 3.0
        wx[:, 5::16] = ww + 3.0
    elif family == "outside":
        r0 = np.where(np.arange(nblk) % 4 == 0, -7, r0)
        r0 = np.where(np.arange(nblk) % 4 == 1, hmax + 9, r0)
        c0 = np.where(np.arange(nblk) % 4 == 2, -13, c0)
        c0 = np.where(np.arange(nblk) % 4 == 3, wmax + 21, c0)
        r0[8], c0[8] = -3, -5
        r0[9], c0[9] = hmax[9] + 4, wmax[9] + 6
    else:
        raise ValueError(f"unknown resample family {family!r}")
    scale, offset = (1.0, 0.0) if dtype == "float32" else (2.5e-5, 0.9)
    return dict(levels=levels, lvl_idx=lvl, r0=r0.astype(np.int32),
                c0=c0.astype(np.int32), wy=wy.astype(np.float32),
                wx=wx.astype(np.float32), wh=wh, ww=ww, scale=scale,
                offset=offset)


def resample_case_with(case: dict, convert) -> dict:
    """A ``resample_hard_case`` with every array, and every level, passed
    through ``convert`` (torch.from_numpy, a move to the card, the
    reference's asarray); the integers and floats stay."""
    out = {k: convert(v) if isinstance(v, np.ndarray) else v
           for k, v in case.items()}
    out["levels"] = [convert(a) for a in case["levels"]]
    return out


def extract_hard_case(family: str, dtype: str, seed: int = 0):
    """One K1/K5 input as numpy arrays: ``maps`` (a list of pyramids of
    three levels, all widths odd), ``lvl_idx``, ``r0``, ``c0`` ((nblk,)
    int32), ``wh``, ``ww``, ``scale``, ``offset`` and ``dtype``. Windows
    are the main path's (40, 64), or (32, 48) for the shadow|bounce pair
    (``odd_window`` excepted); float32 levels hold -0.0 in one texel of twenty, which a decode that
    adds a zero offset would turn into +0.0.

    * ``phases``: first columns of every residue modulo 16, so every
      16-byte phase of a window row, for every texel size;
    * ``edges``: windows touching each edge and corner of their level;
    * ``small_levels``: levels smaller than the window (zeros for K5,
      clamped texels for K1), origins at 0;
    * ``one_block``, ``prime_blocks``: 1 and 37 blocks (K5 only: K1 takes
      whole groups of 8);
    * ``pair``: two maps in one launch, side by side (shadow|bounce);
    * ``odd_window``: a (37, 61) window, whose rows are no whole number
      of 16-byte output chunks (the kernels' one-texel-a-thread form);
    * ``outside`` (the guards): origins past each edge and corner, some
      windows wholly outside;
    * ``lvl_range`` (the guards): level indices below 0 and past the last
      level, which clamp.
    """
    rng = np.random.default_rng(seed)
    wh, ww = {"pair": (32, 48), "odd_window": (37, 61)}.get(family,
                                                           (40, 64))
    shapes = [(101, 523), (57, 263), (45, 131)]
    if family == "small_levels":
        shapes = [(101, 523), (31, 51), (17, 33)]
    n_maps = 2 if family == "pair" else 1
    nblk = {"one_block": 1, "prime_blocks": 37}.get(family, 32)
    maps = [[_level(rng, dtype, h, w) for h, w in shapes]
            for _ in range(n_maps)]
    if dtype == "float32":
        for levels in maps:
            for a in levels:
                a[rng.random(a.shape) < 0.05] = -0.0
    idx = np.arange(nblk)
    lvl = (idx % 3).astype(np.int64)
    hmax = np.array([max(shapes[k][0] - wh, 0) for k in lvl])
    wmax = np.array([max(shapes[k][1] - ww, 0) for k in lvl])
    r0 = (rng.random(nblk) * (hmax + 1)).astype(np.int64)
    c0 = (rng.random(nblk) * (wmax + 1)).astype(np.int64)
    if family == "phases":
        c0 = np.minimum(idx % 16 + 16 * (idx // 16 % 3), wmax)
    elif family == "edges":
        r0 = np.where(idx % 4 < 2, 0, hmax)
        c0 = np.where(idx % 8 < 4, 0, wmax)
        mid = idx >= 16                        # second half: one edge only
        r0 = np.where(mid & (idx % 4 >= 2), r0 // 2 + 1, r0)
        c0 = np.where(mid & (idx % 4 < 2), c0 // 2 + 1, c0)
    elif family == "small_levels":
        lvl = np.where(idx % 4 == 0, 0, 1 + idx % 2)
        r0 = np.where(lvl == 0, r0, 0)
        c0 = np.where(lvl == 0, c0, 0)
    elif family == "outside":
        h = np.array([shapes[k][0] for k in lvl])
        w = np.array([shapes[k][1] for k in lvl])
        r0 = np.select([idx % 6 == 0, idx % 6 == 1], [-7, hmax + 9], r0)
        c0 = np.select([idx % 6 == 2, idx % 6 == 3], [-13, wmax + 21], c0)
        corner = idx % 6 == 4
        r0 = np.where(corner, -3, r0)
        c0 = np.where(corner, wmax + 6, c0)
        gone = idx % 6 == 5                    # wholly outside the level
        r0 = np.where(gone & (idx % 4 == 1), h + 2, r0)
        r0 = np.where(gone & (idx % 4 == 3), -wh - 5, r0)
        c0 = np.where(gone & (idx % 4 == 1), -ww - 1, c0)
        c0 = np.where(gone & (idx % 4 == 3), w + 3, c0)
    elif family == "lvl_range":
        lvl = np.select([idx % 4 == 0, idx % 4 == 1], [-1 - idx % 3, 3 + idx],
                        lvl)
        k = np.clip(lvl, 0, 2)
        hk = np.array([max(shapes[j][0] - wh, 0) for j in k])
        wk = np.array([max(shapes[j][1] - ww, 0) for j in k])
        r0 = (rng.random(nblk) * (hk + 1)).astype(np.int64)
        c0 = (rng.random(nblk) * (wk + 1)).astype(np.int64)
    elif family not in ("one_block", "prime_blocks", "pair", "odd_window"):
        raise ValueError(f"unknown extraction family {family!r}")
    scale, offset = {"float32": (-2.0, 0.25) if family in ("edges", "outside")
                     else (1.0, 0.0),
                     "int16": (2.5e-5, 0.9), "uint8": (1 / 255.0, 0.0),
                     "uint8x3": (1 / 255.0, 0.0),
                     "bfloat16": (1.0, 0.0)}[dtype]
    return dict(maps=maps, lvl_idx=lvl.astype(np.int32),
                r0=r0.astype(np.int32), c0=c0.astype(np.int32), wh=wh,
                ww=ww, scale=scale, offset=offset, dtype=dtype)


def extract_case_calls(case: dict, convert, to_bf16):
    """(K1 keyword arguments or None, K5 keyword arguments or None) of an
    ``extract_hard_case``, every array passed through ``convert`` and the
    levels of a "bfloat16" case also through ``to_bf16``. K1's call lacks
    ``out_dtype`` (the caller's framework names it: bf16 for a bf16 case,
    else f32); K1 needs whole groups of 8 blocks, K5 takes no bf16."""
    bf16 = case["dtype"] == "bfloat16"
    maps = [[to_bf16(convert(a)) if bf16 else convert(a) for a in levels]
            for levels in case["maps"]]
    idx = {k: convert(case[k]) for k in ("lvl_idx", "r0", "c0")}
    n = len(maps)
    k1 = None if case["r0"].shape[0] % 8 else dict(
        map_levels=maps, **idx, wh=case["wh"], ww=case["ww"],
        scales=(case["scale"],) * n, offsets=(case["offset"],) * n, group=8)
    k5 = None if bf16 else dict(
        levels=maps[0] if n == 1 else maps, **idx, wh=case["wh"],
        ww=case["ww"], scale=case["scale"], offset=case["offset"])
    return k1, k5
