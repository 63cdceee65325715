"""The port's window extraction (K1, K5) and fused resample (K4) against
the reference Pallas kernels run in interpret mode on the CPU.

Same inputs, made with numpy, go through moonrtx_tpu.ops.extract (Pallas,
interpret=True) and moonrtx_tpu_torch.ops.extract (on CPU tensors the
wrappers run their plain versions). Tolerances: K1 bit-exact for f32,
int16, uint8 and bf16 sources; K5 bit-exact in its selection for f32,
int16 and uint8 and within 1e-6 after the decode (the reference's XLA
fuses the multiply and the add into one rounding, the port rounds twice);
K4 within 4e-3 of the residual scale (the bf16 residual budget of
tests/test_extract.py). On the inputs of moonrtx_tpu_torch/hard_cases.py
the one-launch contracts of K1 and K5 ((H, W, 3) levels whole, several
maps side by side) give bit for bit what the per-plane calls with
``torch.stack`` / ``torch.cat`` gave.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonrtx_tpu.ops import extract as jx
from moonrtx_tpu_torch import kernels
from moonrtx_tpu_torch.ops import extract as tx
from moonrtx_tpu_torch.ops import sampler as tsampler
from torch_parity import (EXTRACT_DTYPES, EXTRACT_FAMILIES,
                          EXTRACT_GUARD_FAMILIES, RESAMPLE_DTYPES,
                          RESAMPLE_FAMILIES, extract_case_calls,
                          extract_hard_case, resample_case_with,
                          resample_hard_case)


def _maps(rng, dtype, shapes, n_maps):
    out = []
    for _ in range(n_maps):
        levels = []
        for h, w in shapes:
            if dtype == "float32":
                a = (1.0 + 0.01 * rng.standard_normal((h, w))).astype(
                    np.float32)
            elif dtype == "int16":
                a = rng.integers(-32768, 32767, (h, w)).astype(np.int16)
            elif dtype == "uint8":
                a = rng.integers(0, 256, (h, w)).astype(np.uint8)
            else:
                a = rng.standard_normal((h, w)).astype(np.float32)
            levels.append(a)
        out.append(levels)
    return out


def _origins(rng, shapes, nblk, wh, ww):
    lvl = rng.integers(0, len(shapes), nblk).astype(np.int32)
    r0 = np.array([rng.integers(0, shapes[k][0] - wh + 1) for k in lvl],
                  np.int32)
    c0 = np.array([rng.integers(0, shapes[k][1] - ww + 1) for k in lvl],
                  np.int32)
    return lvl, r0, c0


def _extract_both(maps, dtype, lvl, r0, c0, wh, ww, scales, offsets):
    if dtype == "bfloat16":
        j_maps = tuple(tuple(jnp.asarray(a, jnp.bfloat16) for a in m)
                       for m in maps)
        t_maps = [[torch.from_numpy(a).to(torch.bfloat16) for a in m]
                  for m in maps]
        j_out, t_out = jnp.bfloat16, torch.bfloat16
    else:
        j_maps = tuple(tuple(jnp.asarray(a) for a in m) for m in maps)
        t_maps = [[torch.from_numpy(a) for a in m] for m in maps]
        j_out, t_out = jnp.float32, torch.float32
    ref = jx.extract_group_windows_tpu(
        j_maps, jnp.asarray(lvl), jnp.asarray(r0), jnp.asarray(c0), wh, ww,
        scales=scales, offsets=offsets, group=8, out_dtype=j_out,
        interpret=True)
    n0 = kernels.launch_counts()["extract_group_windows"]
    got = tx.extract_group_windows(
        t_maps, torch.from_numpy(lvl), torch.from_numpy(r0),
        torch.from_numpy(c0), wh, ww, scales=scales, offsets=offsets,
        group=8, out_dtype=t_out)
    # CPU: plain version
    assert kernels.launch_counts()["extract_group_windows"] == n0
    assert got.dtype == t_out and tuple(got.shape) == tuple(ref.shape)
    return (got.to(torch.float32).numpy(),
            np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "int16", "uint8", "bfloat16"])
def test_extract_group_windows_bitexact(dtype):
    """Selection (per-block level, origins, packed layout) is bit-exact;
    the affine decode is within 1e-6 (the reference's XLA fuses the
    multiply and add into one rounding where the port rounds twice)."""
    rng = np.random.default_rng(11)
    shapes = [(96, 300), (48, 150), (24, 75)]
    maps = _maps(rng, dtype, shapes, 2)
    nblk, wh, ww = 16, 16, 40
    lvl, r0, c0 = _origins(rng, shapes, nblk, wh, ww)
    got, ref = _extract_both(maps, dtype, lvl, r0, c0, wh, ww,
                             (1.0, 1.0), (0.0, 0.0))
    np.testing.assert_array_equal(got, ref)
    if dtype == "bfloat16":
        return
    quant = dtype in ("int16", "uint8")
    scales = (2.5e-5, 1 / 255.0) if quant else (1.0, 2.0)
    offsets = (0.9, 0.0) if quant else (0.0, -0.5)
    got, ref = _extract_both(maps, dtype, lvl, r0, c0, wh, ww, scales,
                             offsets)
    assert np.abs(got - ref).max() <= 1e-6


def _level_both(levels, lvl, r0, c0, wh, ww, scale, offset):
    ref = np.asarray(jx.extract_level_windows_tpu(
        tuple(jnp.asarray(a) for a in levels), jnp.asarray(lvl),
        jnp.asarray(r0), jnp.asarray(c0), wh, ww, scale=scale,
        offset=offset, interpret=True))
    n0 = kernels.launch_counts()["extract_level_windows"]
    got = tx.extract_level_windows(
        [torch.from_numpy(a) for a in levels], torch.from_numpy(lvl),
        torch.from_numpy(r0), torch.from_numpy(c0), wh, ww, scale=scale,
        offset=offset)
    # CPU: plain version
    assert kernels.launch_counts()["extract_level_windows"] == n0
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    return got.numpy(), ref


@pytest.mark.parametrize("dtype", ["float32", "int16", "uint8"])
def test_extract_level_windows_matches_kernel(dtype):
    """K5: three levels, a block count that is no multiple of 8, and a
    last level smaller than the window (its missing texels are raw 0, as
    from the reference kernel's zero-padded levels)."""
    rng = np.random.default_rng(21)
    shapes = [(96, 300), (48, 150), (12, 30)]
    levels = _maps(rng, dtype, shapes, 1)[0]
    nblk, wh, ww = 13, 16, 40
    lvl = rng.integers(0, 3, nblk).astype(np.int32)
    lvl[:3] = [0, 1, 2]
    r0 = np.array([rng.integers(0, max(shapes[k][0] - wh, 0) + 1)
                   for k in lvl], np.int32)
    c0 = np.array([rng.integers(0, max(shapes[k][1] - ww, 0) + 1)
                   for k in lvl], np.int32)
    got, ref = _level_both(levels, lvl, r0, c0, wh, ww, 1.0, 0.0)
    np.testing.assert_array_equal(got, ref)
    assert (got[lvl == 2][:, 12:, :] == 0).all()
    assert (got[lvl == 2][:, :, 30:] == 0).all()
    scale, offset = ((2.5e-5, 0.9) if dtype != "float32" else (2.0, -0.5))
    got, ref = _level_both(levels, lvl, r0, c0, wh, ww, scale, offset)
    assert np.abs(got - ref).max() <= 1e-6
    # the per-block slice of the sampler is the independent check where
    # the window fits its level
    for k in (0, 1):
        sel = lvl == k
        win = tsampler.extract_windows(
            torch.from_numpy(levels[k]), torch.from_numpy(r0[sel]),
            torch.from_numpy(c0[sel]), wh, ww)
        assert win.dtype == torch.from_numpy(levels[k]).dtype
        np.testing.assert_array_equal(
            tx.decode_affine(win, scale, offset).numpy(), got[sel])


@pytest.mark.parametrize("dtype", ["float32", "int16", "uint8"])
def test_extract_windows_matches_kernel(dtype):
    """K5 with one level (extract_windows) against extract_windows_tpu."""
    rng = np.random.default_rng(22)
    tex = _maps(rng, dtype, [(96, 300)], 1)[0][0]
    nblk, wh, ww = 11, 40, 184
    r0 = rng.integers(0, 96 - wh + 1, nblk).astype(np.int32)
    c0 = rng.integers(0, 300 - ww + 1, nblk).astype(np.int32)
    scale, offset = ((2.5e-5, 0.9) if dtype != "float32" else (1.0, 0.0))
    ref = np.asarray(jx.extract_windows_tpu(
        jnp.asarray(tex), jnp.asarray(r0), jnp.asarray(c0), wh, ww,
        scale=scale, offset=offset, interpret=True))
    got = tx.extract_windows(torch.from_numpy(tex), torch.from_numpy(r0),
                             torch.from_numpy(c0), wh, ww, scale=scale,
                             offset=offset).numpy()
    assert got.shape == (nblk, wh, ww)
    assert np.abs(got - ref).max() <= (0 if dtype == "float32" else 1e-6)


def test_extract_level_windows_reads_strided_planes():
    """A channel plane of an (H, W, 3) uint8 level goes in as a strided
    view; the plain version gives what the contiguous copy gives, and 3-D
    windows come from the sampler's slice."""
    rng = np.random.default_rng(23)
    full = torch.from_numpy(rng.integers(0, 256, (64, 200, 3))
                            .astype(np.uint8))
    r0 = torch.from_numpy(rng.integers(0, 64 - 40 + 1, 9).astype(np.int32))
    c0 = torch.from_numpy(rng.integers(0, 200 - 64 + 1, 9).astype(np.int32))
    z = torch.zeros_like(r0)
    planes = [tx.extract_level_windows((full[:, :, ch],), z, r0, c0, 40, 64,
                                       scale=1 / 255.0) for ch in range(3)]
    assert not full[:, :, 1].is_contiguous()
    for ch in range(3):
        copy = tx.extract_level_windows(
            (full[:, :, ch].contiguous(),), z, r0, c0, 40, 64,
            scale=1 / 255.0)
        assert torch.equal(planes[ch], copy)
    win3 = tsampler.extract_windows(full, r0, c0, 40, 64)
    assert win3.shape == (9, 40, 64, 3)
    assert torch.equal(torch.stack(planes, dim=-1),
                       tx.decode_affine(win3, 1 / 255.0, 0.0))


def test_extract_level_windows_rejects_bad_inputs():
    z = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(TypeError):
        tx.extract_level_windows((torch.zeros(64, 64, dtype=torch.bfloat16),),
                                 z, z, z, 8, 8)
    with pytest.raises(ValueError):
        tx.extract_level_windows((torch.zeros(64, 64),), z.long(), z, z, 8, 8)
    # (H, W, C) levels are taken whole; a 4-D level or levels of mixed
    # texel shapes are not
    with pytest.raises(ValueError):
        tx.extract_level_windows((torch.zeros(64, 64, 3, 2),), z, z, z, 8, 8)
    with pytest.raises(ValueError):
        tx.extract_level_windows(
            (torch.zeros(64, 64, 3), torch.zeros(32, 32)), z, z, z, 8, 8)


def test_extract_rejects_ragged_groups():
    z = torch.zeros(12, dtype=torch.int32)
    with pytest.raises(ValueError):
        tx.extract_group_windows(((torch.zeros(64, 64),),), z, z, z, 8, 8,
                                 group=8)


def test_decode_affine_matches_reference():
    rng = np.random.default_rng(5)
    raw = rng.integers(-32768, 32767, (64, 64)).astype(np.int16)
    ref = np.asarray(jx.decode_affine(jnp.asarray(raw), 2.5e-5, 0.93))
    got = tx.decode_affine(torch.from_numpy(raw), 2.5e-5, 0.93).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "int16", "uint8"])
def test_resample_group_windows_matches_kernel(dtype):
    rng = np.random.default_rng(12)
    shapes = [(96, 520), (48, 260)]
    levels = _maps(rng, dtype, shapes, 1)[0]
    nblk, b, wh, ww = 16, 128, 40, 184
    lvl, r0, c0 = _origins(rng, shapes, nblk, wh, ww)
    wy = rng.uniform(-1.0, wh, (nblk, b)).astype(np.float32)
    wx = rng.uniform(-1.0, ww, (nblk, b)).astype(np.float32)
    scale, offset = ((1.0, 0.0) if dtype == "float32"
                     else (2.5e-5, 0.9))
    ref = np.asarray(jx.resample_group_windows_tpu(
        tuple(jnp.asarray(a) for a in levels), jnp.asarray(lvl),
        jnp.asarray(r0), jnp.asarray(c0), jnp.asarray(wy), jnp.asarray(wx),
        wh, ww, scale=scale, offset=offset, group=8, interpret=True))
    got = tx.resample_group_windows(
        [torch.from_numpy(a) for a in levels], torch.from_numpy(lvl),
        torch.from_numpy(r0), torch.from_numpy(c0), torch.from_numpy(wy),
        torch.from_numpy(wx), wh, ww, scale=scale, offset=offset).numpy()
    dec = [a.astype(np.float32) * scale + offset for a in levels]
    span = max(float(d.max() - d.min()) for d in dec)
    assert np.abs(got - ref).max() <= 4e-3 * span


@pytest.mark.parametrize("dtype", RESAMPLE_DTYPES)
@pytest.mark.parametrize("family", RESAMPLE_FAMILIES)
def test_resample_group_windows_hard_cases(family, dtype):
    """K4's plain version against the reference kernel on the inputs a
    row-streaming kernel gets wrong: windows on each edge and corner of
    their level, first columns of every alignment in levels whose width
    is no multiple of 8, samples on the last row and column the clamp
    allows. Within 4e-3 of the decoded levels' span (the bf16 residual
    budget of tests/test_extract.py)."""
    case = resample_hard_case(family, dtype, b=128, seed=4)
    ref = np.asarray(jx.resample_group_windows_tpu(
        **{k: tuple(v) if k == "levels" else v for k, v in
           resample_case_with(case, jnp.asarray).items()},
        group=8, interpret=True))
    got = tx.resample_group_windows_plain(
        **resample_case_with(case, torch.from_numpy)).numpy()
    dec = [a.astype(np.float32) * case["scale"] + case["offset"]
           for a in case["levels"]]
    span = max(float(d.max() - d.min()) for d in dec)
    assert got.shape == ref.shape == case["wy"].shape
    assert np.abs(got - ref).max() <= 4e-3 * span


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _plane_maps(levels):
    """An (H, W, C) pyramid as C pyramids of 2-D planes (strided views);
    a 2-D pyramid as itself."""
    if levels[0].ndim == 2:
        return [list(levels)]
    return [[lvl[:, :, ch] for lvl in levels]
            for ch in range(levels[0].shape[2])]


def _old_level_windows(maps, call):
    """K5 as the blocked backend composed it before one launch did it
    all: one call per map and channel plane, torch.stack over the
    channels, torch.cat over the maps."""
    idx = {k: call[k] for k in ("lvl_idx", "r0", "c0", "wh", "ww",
                                "scale", "offset")}
    per_map = []
    for levels in maps:
        planes = [tx.extract_level_windows(p, **idx)
                  for p in _plane_maps(levels)]
        per_map.append(planes[0] if levels[0].ndim == 2
                       else torch.stack(planes, dim=-1))
    return torch.cat(per_map, dim=2)


@pytest.mark.parametrize("dtype", EXTRACT_DTYPES)
@pytest.mark.parametrize("family",
                         EXTRACT_FAMILIES + EXTRACT_GUARD_FAMILIES)
def test_extract_one_launch_contracts_match_old_compositions(family, dtype):
    """K1 with an (H, W, 3) map gives what three plane maps gave; K5 with
    (H, W, 3) levels and with a shadow|bounce pair gives what per-plane
    calls with stack and cat gave, bit for bit (-0.0 kept), on every
    extraction hard case."""
    case = extract_hard_case(family, dtype, seed=8)
    k1, k5 = extract_case_calls(case, torch.from_numpy,
                                lambda t: t.to(torch.bfloat16))
    if k1 is not None:
        out_dtype = (torch.bfloat16 if dtype == "bfloat16"
                     else torch.float32)
        got = tx.extract_group_windows(**k1, out_dtype=out_dtype)
        planes = [p for levels in k1["map_levels"]
                  for p in _plane_maps(levels)]
        n = len(planes)
        old = tx.extract_group_windows(
            planes, k1["lvl_idx"], k1["r0"], k1["c0"], k1["wh"], k1["ww"],
            scales=(case["scale"],) * n, offsets=(case["offset"],) * n,
            out_dtype=out_dtype)
        assert got.shape == old.shape == (
            k1["r0"].shape[0] // 8, 8 * k1["wh"], n * k1["ww"])
        assert torch.equal(_bits(got), _bits(old))
    if k5 is not None:
        maps = ([k5["levels"]] if isinstance(k5["levels"][0], torch.Tensor)
                else k5["levels"])
        got = tx.extract_level_windows(**k5)
        old = _old_level_windows(maps, k5)
        assert got.shape == old.shape
        assert torch.equal(_bits(got), _bits(old))
        if dtype == "float32" and case["scale"] == 1.0:
            assert bool((torch.signbit(got) & (got == 0)).any())


@pytest.mark.parametrize("family,dtype", [
    ("phases", d) for d in EXTRACT_DTYPES] + [
    ("edges", "uint8x3"), ("small_levels", "int16"), ("pair", "float32"),
    ("prime_blocks", "uint8")])
def test_extract_hard_cases_match_reference(family, dtype):
    """The port's plain K1 and K5 against extract_group_windows_tpu and
    extract_level_windows_tpu in interpret mode, the reference fed plane
    by plane and map by map as its blocked pipeline feeds it; selection
    bit-exact, the decode within 1e-6 (the reference's XLA fuses it). K1
    is not held on levels smaller than its window: there the reference
    reads its zero padding and the port clamps (both outside the
    contract)."""
    case = extract_hard_case(family, dtype, seed=9)
    bf16 = dtype == "bfloat16"
    k1, k5 = extract_case_calls(case, torch.from_numpy,
                                lambda t: t.to(torch.bfloat16))
    j_planes = [[jnp.asarray(a[:, :, ch] if a.ndim == 3 else a,
                             jnp.bfloat16 if bf16 else None)
                 for a in levels]
                for levels in case["maps"]
                for ch in range(case["maps"][0][0].shape[2]
                                if case["maps"][0][0].ndim == 3 else 1)]
    idx = [jnp.asarray(case[k]) for k in ("lvl_idx", "r0", "c0")]
    tol = 0.0 if case["scale"] == 1.0 and case["offset"] == 0.0 else 1e-6
    if k1 is not None and family != "small_levels":
        n = len(j_planes)
        ref = jx.extract_group_windows_tpu(
            tuple(tuple(p) for p in j_planes), *idx, case["wh"], case["ww"],
            scales=(case["scale"],) * n, offsets=(case["offset"],) * n,
            group=8, out_dtype=jnp.bfloat16 if bf16 else jnp.float32,
            interpret=True)
        got = tx.extract_group_windows(
            **k1, out_dtype=torch.bfloat16 if bf16 else torch.float32)
        ref = np.asarray(ref.astype(jnp.float32))
        assert got.shape == ref.shape
        assert np.abs(got.float().numpy() - ref).max() <= tol
    if k5 is not None:
        per = [np.asarray(jx.extract_level_windows_tpu(
            tuple(p), *idx, case["wh"], case["ww"], scale=case["scale"],
            offset=case["offset"], interpret=True)) for p in j_planes]
        nch = len(j_planes) // len(case["maps"])
        ref = np.concatenate(
            [per[m * nch] if nch == 1
             else np.stack(per[m * nch:(m + 1) * nch], axis=-1)
             for m in range(len(case["maps"]))], axis=2)
        got = tx.extract_level_windows(**k5).numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= tol
