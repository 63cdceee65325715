"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test decides inside a fixture whether a card is
present and skips without one. Run them on a machine with an H100:

    python -m pytest tests/test_torch_gpu.py -q -m gpu

Tolerances: window extraction (K1, K5) is bit-exact; the resample (K4) is
within the bf16 residual budget (its window mean is summed in another
order, which can move one bf16 rounding); the prefix scan (K3) equals
its plain version bit for bit on the card (folding chunk aggregates in
row order gives the sequential walk's carry at every row) and is within
the atan2 polynomial's 1e-4 of the plain version on the CPU; both also on
the inputs of moonrtx_tpu_torch/hard_cases.py (extraction bit for bit,
-0.0 included); the march (K2) agrees
on >= 99.9% of hit flags, within 2e-2 on rgb and within 5e-2 on the hit
distance and point where both hit (its transcendental functions are the
card's own); the burst kernel (samples 1..N-1 of an accumulation in one
launch) gives the per-sample K2 loop's mean bit for bit and is within
1e-4 of its plain version on a 1080p view of chip_smoke.py's map; the
bounce kernels are within 1e-5 of their plain version except where the
plain version's own ties flip (BOUNCE_TOL).
"""

from datetime import datetime, timezone

import numpy as np
import pytest
import torch

from moonrtx_tpu_torch import constants as C
from moonrtx_tpu_torch import hard_cases, kernels
from moonrtx_tpu_torch.ops import extract, march_shade, shadow_prefix

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.build_all()
    return torch.device("cuda")


def _levels(dtype, rng, shapes):
    out = []
    for h, w in shapes:
        if dtype == "float32":
            a = (1.0 + 0.01 * rng.standard_normal((h, w))).astype(np.float32)
            out.append(torch.from_numpy(a))
        elif dtype == "int16":
            out.append(torch.from_numpy(
                rng.integers(-32768, 32767, (h, w)).astype(np.int16)))
        elif dtype == "uint8":
            out.append(torch.from_numpy(
                rng.integers(0, 255, (h, w)).astype(np.uint8)))
        else:
            a = rng.standard_normal((h, w)).astype(np.float32)
            out.append(torch.from_numpy(a).to(torch.bfloat16))
    return out


def _origins(rng, shapes, nblk, wh, ww):
    lvl = rng.integers(0, len(shapes), nblk)
    r0 = np.array([rng.integers(0, shapes[k][0] - wh + 1) for k in lvl])
    c0 = np.array([rng.integers(0, shapes[k][1] - ww + 1) for k in lvl])
    return [torch.from_numpy(a.astype(np.int32)) for a in (lvl, r0, c0)]


@pytest.mark.parametrize("dtype", ["float32", "int16", "uint8", "bfloat16"])
def test_extract_group_windows_matches_plain(cuda, dtype):
    rng = np.random.default_rng(1)
    shapes = [(300, 700), (150, 350), (75, 175)]
    maps = [_levels(dtype, rng, shapes) for _ in range(2)]
    lvl, r0, c0 = _origins(rng, shapes, 64, 40, 64)
    scales, offsets = ((2.5e-5, 1.0), (0.9, 0.0)) if dtype in (
        "int16", "uint8") else ((1.0, 1.0), (0.0, 0.0))
    out_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = extract.extract_group_windows(maps, lvl, r0, c0, 40, 64,
                                        scales=scales, offsets=offsets,
                                        out_dtype=out_dtype)
    n0 = extract.extract_group_windows.launches
    got = extract.extract_group_windows(
        [[l.to(cuda) for l in m] for m in maps], lvl.to(cuda), r0.to(cuda),
        c0.to(cuda), 40, 64, scales=scales, offsets=offsets,
        out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert extract.extract_group_windows.launches == n0 + 1
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("dtype", ["float32", "int16", "uint8"])
def test_extract_level_windows_matches_plain(cuda, dtype):
    """K5 at the blocked backend's widths: a block count that does not
    divide by 8, three levels of which the last is smaller than the
    window, and for uint8 a channel plane of an (H, W, 3) level read in
    place through its strides."""
    rng = np.random.default_rng(3)
    shapes = [(300, 700), (150, 350), (30, 50)]
    wh, ww, nblk = 40, 64, 1021
    if dtype == "uint8":
        full = [torch.from_numpy(rng.integers(0, 255, (h, w, 3))
                                 .astype(np.uint8)) for h, w in shapes]
        levels = [f[:, :, 1] for f in full]
        on_card = [f.to(cuda)[:, :, 1] for f in full]
        assert not on_card[0].is_contiguous()
    else:
        levels = _levels(dtype, rng, shapes)
        on_card = [l.to(cuda) for l in levels]
    lvl = torch.from_numpy(rng.integers(0, 3, nblk).astype(np.int32))
    hs = np.array([s_[0] for s_ in shapes])[lvl.numpy()]
    ws = np.array([s_[1] for s_ in shapes])[lvl.numpy()]
    r0 = torch.from_numpy((rng.random(nblk) * np.maximum(hs - wh, 0))
                          .astype(np.int32))
    c0 = torch.from_numpy((rng.random(nblk) * np.maximum(ws - ww, 0))
                          .astype(np.int32))
    scale, offset = (2.5e-5, 0.9) if dtype != "float32" else (1.0, 0.0)
    ref = extract.extract_level_windows_plain(levels, lvl, r0, c0, wh, ww,
                                              scale, offset)
    n0 = extract.extract_level_windows.launches
    ptrs = [l.data_ptr() for l in on_card]
    got = extract.extract_level_windows(on_card, lvl.to(cuda), r0.to(cuda),
                                        c0.to(cuda), wh, ww, scale=scale,
                                        offset=offset)
    torch.cuda.synchronize()
    assert extract.extract_level_windows.launches == n0 + 1
    assert [l.data_ptr() for l in on_card] == ptrs      # no level copied
    assert got.shape == (nblk, wh, ww) and got.dtype == torch.float32
    assert torch.equal(got.cpu(), ref)
    # a level smaller than the window reads as raw 0 past its edge
    small = lvl == 2
    assert bool(small.any())
    assert torch.all(got.cpu()[small][:, 30:, :] == offset)
    one = extract.extract_windows(on_card[0], r0.to(cuda) % 260,
                                  c0.to(cuda) % 636, wh, ww, scale=scale,
                                  offset=offset)
    ref_one = extract.extract_level_windows_plain(
        levels[:1], torch.zeros_like(lvl), r0 % 260, c0 % 636, wh, ww,
        scale, offset)
    assert torch.equal(one.cpu(), ref_one)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("rows_per_thread", [1, 4])
@pytest.mark.parametrize("dtype", hard_cases.EXTRACT_DTYPES)
@pytest.mark.parametrize("family", hard_cases.EXTRACT_FAMILIES
                         + hard_cases.EXTRACT_GUARD_FAMILIES)
def test_extract_hard_cases_match_plain(cuda, family, dtype,
                                        rows_per_thread, monkeypatch):
    """K1 and K5 on every 16-byte phase of c0 for every texel size and
    (H, W, 3) levels, on and past every level edge (K5's zeros, K1's
    clamp), on levels smaller than the window, with level indices out of
    range, 1 and 37 blocks, and the shadow|bounce pair in one launch,
    with each thread walking one row (as far as a block holds them) and
    at the default: bit-equal to the plain versions."""
    monkeypatch.setattr(extract, "ROWS_PER_THREAD", rows_per_thread)
    case = hard_cases.extract_hard_case(family, dtype, seed=13)
    k1, k5 = hard_cases.extract_case_calls(
        case, lambda a: torch.from_numpy(a).to(cuda),
        lambda t: t.to(torch.bfloat16))
    if k1 is not None:
        out_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        n0 = extract.extract_group_windows.launches
        got = extract.extract_group_windows(**k1, out_dtype=out_dtype)
        ref = extract.extract_group_windows_plain(**k1, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert extract.extract_group_windows.launches == n0 + 1
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert torch.equal(_bits(got), _bits(ref))
    if k5 is not None:
        n0 = extract.extract_level_windows.launches
        got = extract.extract_level_windows(**k5)
        ref = extract.extract_level_windows_plain(**k5)
        torch.cuda.synchronize()
        assert extract.extract_level_windows.launches == n0 + 1
        assert got.shape == ref.shape
        assert torch.equal(_bits(got), _bits(ref))


def test_extraction_allocates_its_output_alone(cuda):
    """K1 and K5 read strided and interleaved levels in place: the device
    memory a call allocates is its output and nothing more (a copy of the
    (H, W, 3) level or of its planes would show)."""
    rng = np.random.default_rng(17)
    full = [torch.from_numpy(rng.integers(0, 256, (h, w, 3))
                             .astype(np.uint8)).to(cuda)
            for h, w in ((1441, 3073), (721, 1537))]
    nblk = 512
    lvl = torch.from_numpy((np.arange(nblk) % 2).astype(np.int32)).to(cuda)
    r0 = torch.from_numpy(rng.integers(0, 600, nblk).astype(np.int32)) \
        .to(cuda)
    c0 = torch.from_numpy(rng.integers(0, 1400, nblk).astype(np.int32)) \
        .to(cuda)
    calls = (
        lambda: extract.extract_group_windows(
            (tuple(full),), lvl, r0, c0, 40, 64, scales=(1 / 255.0,)),
        lambda: extract.extract_group_windows(
            tuple(tuple(f[:, :, ch] for f in full) for ch in range(3)), lvl,
            r0, c0, 40, 64, scales=(1 / 255.0,) * 3),
        lambda: extract.extract_level_windows(tuple(full), lvl, r0, c0, 40,
                                              64, scale=1 / 255.0),
        lambda: extract.extract_level_windows(
            (tuple(f[:, :, 1] for f in full),) * 2, lvl, r0, c0, 40, 64,
            scale=1 / 255.0))
    def grown(make):
        """(device memory a call of make allocates at its peak, result)"""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        made = make()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - before, made

    outs = []
    for fn in calls:
        shape = fn().shape
        grew_out, empty = grown(lambda: torch.empty(
            shape, dtype=torch.float32, device=cuda))
        del empty
        grew, out = grown(fn)
        assert out.shape == shape and grew == grew_out, (grew, grew_out)
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[2][..., 1], outs[3][:, :, :64])


@pytest.mark.parametrize("dtype", ["float32", "int16", "uint8"])
def test_resample_group_windows_matches_plain(cuda, dtype):
    rng = np.random.default_rng(2)
    shapes = [(300, 900), (150, 450)]
    levels = _levels(dtype, rng, shapes)
    lvl, r0, c0 = _origins(rng, shapes, 64, 40, 184)
    wy = torch.from_numpy(rng.uniform(-1, 40, (64, 512)).astype(np.float32))
    wx = torch.from_numpy(rng.uniform(-1, 184, (64, 512)).astype(np.float32))
    scale, offset = (2.5e-5, 0.9) if dtype != "float32" else (1.0, 0.0)
    ref = extract.resample_group_windows_plain(
        [l.to(cuda) for l in levels], lvl.to(cuda), r0.to(cuda),
        c0.to(cuda), wy.to(cuda), wx.to(cuda), 40, 184, scale, offset)
    got = extract.resample_group_windows(
        [l.to(cuda) for l in levels], lvl.to(cuda), r0.to(cuda),
        c0.to(cuda), wy.to(cuda), wx.to(cuda), 40, 184, scale=scale,
        offset=offset)
    torch.cuda.synchronize()
    span = float(max((l.float() * scale + offset).max()
                     - (l.float() * scale + offset).min() for l in levels))
    assert (got - ref).abs().max().item() <= 4e-3 * span


def _exact_prefix_inputs(n_theta, n_phi, seed=7):
    rng = np.random.default_rng(seed)
    q = 2.0 ** -8
    hs = np.round((1.0 + 0.004 * rng.standard_normal((n_theta, n_phi))
                   + 0.01 * (rng.random((n_theta, n_phi)) < 0.002)) / q) * q
    tgrid = np.linspace(0.05, 0.95, n_theta)
    st = np.round(np.sin(np.pi * tgrid)[:, None] / q) * q
    ct = np.round(np.cos(np.pi * tgrid)[:, None] / q) * q
    return [torch.from_numpy(a.astype(np.float32)) for a in (hs, st, ct)]


@pytest.mark.parametrize("n_phi", [512, 4096])
def test_shadow_factor_matches_plain(cuda, n_phi):
    hs, st, ct = _exact_prefix_inputs(1536, n_phi)
    ref = shadow_prefix.shadow_factor_plain(hs, st, ct, 0.0046,
                                            C.MOON_RADIUS)
    on_card = [a.to(cuda) for a in (hs, st, ct)]
    n0 = shadow_prefix.shadow_factor.launches
    got = shadow_prefix.shadow_factor(*on_card, 0.0046, C.MOON_RADIUS)
    torch.cuda.synchronize()
    assert shadow_prefix.shadow_factor.launches == n0 + 1
    assert (got.cpu() - ref).abs().max().item() <= 1e-4
    assert torch.equal(got, shadow_prefix.shadow_factor_plain(
        *on_card, 0.0046, C.MOON_RADIUS))


@pytest.mark.parametrize("grid", [(1536, 4096), (2304, 4096), (384, 2048)])
@pytest.mark.parametrize("family", hard_cases.SHADOW_FAMILIES)
def test_shadow_factor_hard_cases(cuda, family, grid):
    """Tied keys across every chunk boundary, the maximum in row 0, rising
    and falling columns: bit-equal to the plain version on the card."""
    on_card = [torch.from_numpy(a).to(cuda) for a in
               hard_cases.shadow_hard_case(family, *grid, seed=5)]
    got = shadow_prefix.shadow_factor(*on_card, hard_cases.SHADOW_SAR,
                                      C.MOON_RADIUS)
    ref = shadow_prefix.shadow_factor_plain(*on_card, hard_cases.SHADOW_SAR,
                                            C.MOON_RADIUS)
    torch.cuda.synchronize()
    assert ((ref > 0) & (ref < 1)).float().mean().item() > 0.25
    assert torch.equal(got, ref)


@pytest.mark.parametrize("chunk_rows", [16, 64])
def test_shadow_factor_other_chunks_and_ragged_grids(cuda, chunk_rows,
                                                     monkeypatch):
    """The other chunk heights the kernel takes, on a grid that neither
    divides by the chunk nor by the 128 columns of a thread block."""
    monkeypatch.setattr(shadow_prefix, "CHUNK_ROWS", chunk_rows)
    hs, st, ct = (torch.from_numpy(a).to(cuda) for a in
                  hard_cases.shadow_hard_case("plateaus", 384, 2048, seed=6))
    hs, st, ct = hs[:371, :1990].contiguous(), st[:371], ct[:371]
    got = shadow_prefix.shadow_factor(hs, st, ct, hard_cases.SHADOW_SAR,
                                      C.MOON_RADIUS)
    ref = shadow_prefix.shadow_factor_plain(hs, st, ct,
                                            hard_cases.SHADOW_SAR,
                                            C.MOON_RADIUS)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", hard_cases.RESAMPLE_DTYPES)
@pytest.mark.parametrize("family", hard_cases.RESAMPLE_FAMILIES
                         + hard_cases.RESAMPLE_GUARD_FAMILIES)
def test_resample_group_windows_hard_cases(cuda, family, dtype):
    """Windows on and past each level edge, every alignment of the first
    column in levels whose width is no multiple of 8, samples on the last
    row and column: within the bf16 residual budget of the plain version."""
    case = hard_cases.resample_hard_case(family, dtype, seed=7)
    call = hard_cases.resample_case_with(
        case, lambda a: torch.from_numpy(a).to(cuda))
    n0 = extract.resample_group_windows.launches
    got = extract.resample_group_windows(**call)
    ref = extract.resample_group_windows_plain(**call)
    torch.cuda.synchronize()
    assert extract.resample_group_windows.launches == n0 + 1
    span = float(max((l.float() * case["scale"] + case["offset"]).max()
                     - (l.float() * case["scale"] + case["offset"]).min()
                     for l in call["levels"]))
    assert (got - ref).abs().max().item() <= 4e-3 * span


def test_scene_renders_through_the_kernels(cuda):
    from moonrtx_tpu_torch.config import RenderConfig
    from moonrtx_tpu_torch.data.synth import synthesize_moon
    from moonrtx_tpu_torch.engine.scene import MoonScene
    from moonrtx_tpu_torch.types import Observer

    elev, albedo = synthesize_moon(360, 720, seed=5, n_craters=150)
    rs = float(elev.max())
    cfg = RenderConfig(
        observer=Observer(50.06, 19.94, 219),
        dt_local=datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc),
        width=256, height=144, shadow_accuracy=4, backend="pallas",
    ).validate()
    s = MoonScene(cfg, (elev / rs).astype(np.float32), rs, albedo, None)
    s.update_view()
    kernels.reset_launch_counts()
    img = s.render(4)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    k5 = counts.pop("extract_level_windows")
    assert k5 == 0 and all(v > 0 for v in counts.values()), counts
    # sample 0 through K2, samples 1-3 in one burst kernel
    assert counts["march_shade"] == 1 and counts["march_burst"] == 1
    assert img.shape == (144, 256, 3) and img.max() > 0
    assert torch.isfinite(s._accum).all()

    # the same scene through the blocked backend: K5 cuts its three window
    # sets (heights, albedo as whole texels, shadow|bounce) once for the
    # pose
    import dataclasses
    sb = MoonScene(dataclasses.replace(cfg, backend="blocked"),
                   (elev / rs).astype(np.float32), rs, albedo, None)
    sb.update_view()
    kernels.reset_launch_counts()
    img_b = sb.render(4)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["extract_level_windows"] == 3, counts
    assert counts["march_shade"] == 0 and counts["extract_group_windows"] == 0
    assert counts["march_burst"] == 0
    assert torch.isfinite(sb._accum).all()
    d = np.abs(img_b.astype(int) - img.astype(int)).max(axis=-1)
    assert d.mean() < 3.0

    # the march kernel against its plain version on the scene's own windows
    p = s._packed
    ns = p.hwin.shape[0]
    from moonrtx_tpu_torch.engine import blocked
    level = s.mip_level()
    h, w = s.mip_shapes[level]
    geom = blocked.block_rays(s.render_basis(), s._fp.rotation,
                              torch.zeros(2, device=cuda), s.height,
                              s.width, s.h_min, maxmap=s.maxmap)
    ob = blocked.mat3t_apply(s._fp.rotation, s.render_basis().eye)
    alevel = s.albedo_level(level)
    params = blocked._kernel_params(
        ob, s._fp, s.shadow_args()[1], True,
        2.0 * s.render_basis().tan_half_fov / s.height,
        *s.mip_shapes[alevel])
    rays = [geom.db[..., i].reshape(ns, 8, 128) for i in range(3)] + [
        geom.t_enter.reshape(ns, 8, 128), geom.t_end.reshape(ns, 8, 128),
        geom.hit_outer.float().reshape(ns, 8, 128)]
    args = [params, *rays, p.scal, p.hwin, p.awin, p.swin, h, w]
    cold_k = march_shade.march_shade(*args)
    cold_p = march_shade.march_shade_plain(*args)
    warm = dict(t_prev=cold_k[4], f_prev=cold_k[3])
    warm_k = march_shade.march_shade(*args, **warm)
    warm_p = march_shade.march_shade_plain(*args, **warm)
    torch.cuda.synchronize()
    for k_out, p_out in ((cold_k, cold_p), (warm_k, warm_p)):
        assert (k_out[3] == p_out[3]).float().mean().item() >= 0.999
        for i in range(3):
            assert (k_out[i] - p_out[i]).abs().max().item() < 2e-2
        # hit distance and hit point where both hit
        both = (k_out[3] > 0.5) & (p_out[3] > 0.5)
        for i in range(4, 8):
            assert (k_out[i] - p_out[i]).abs()[both].max().item() < 5e-2


@pytest.fixture(scope="module")
def burst_1080p(tmp_path_factory):
    """The burst call of a cold 32-sample 1920x1080 view (16200 blocks of
    128 rays) of the march path, recorded on the card, on chip_smoke.py's
    synthetic 11520x23040 map (cached in a temporary directory)."""
    import os

    from moonrtx_tpu_torch.app import headless
    from moonrtx_tpu_torch.config import RenderConfig
    from moonrtx_tpu_torch.data import loader
    from moonrtx_tpu_torch.types import Observer

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.build_all()
    cache = str(tmp_path_factory.mktemp("cache"))
    mp = pytest.MonkeyPatch()
    mp.setenv("MOONRTX_TPU_CACHE", cache)
    mp.setattr(loader, "SYNTH_CACHE_DIR", cache)
    try:
        cfg = RenderConfig(
            observer=Observer(50.06, 19.94, 219),
            dt_local=datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc),
            width=1920, height=1080, shadow_accuracy=10, backend="pallas",
            synth_shape=(11520, 23040), downscale=1).validate()
        s = headless.build_scene(cfg, with_starmap=False)
        s.update_view()
        with kernels.recording() as calls:
            s.render(32)
        torch.cuda.synchronize()
    finally:
        mp.undo()
    assert os.path.isdir(cache)
    bursts = [c for name, c in calls if name == "march_burst"]
    # K1 x3, K4 x2, K3, the bounce pyramid, K2
    assert len(bursts) == 1 and len(calls) == 9
    return bursts[0]


def _k2_loop(call):
    """The burst as the march path ran it before the burst kernel: per
    sample block_rays, one K2 launch and the running mean in torch."""
    from moonrtx_tpu_torch.engine import blocked

    ns = call["t_prev"].shape[0]
    ar, ag, ab = call["r"], call["g"], call["b"]
    tp, fpv = call["t_prev"], call["f_prev"]
    for i in range(1, call["n_samples"]):
        geom = blocked.block_rays(call["basis"], call["rotation"],
                                  call["jitters"][i], call["height"],
                                  call["width"], call["h_min"],
                                  h_bound=call["h_bound"], image_dirs=False)
        rays = [geom.db[..., k].reshape(ns, 8, 128) for k in range(3)] + [
            geom.t_enter.reshape(ns, 8, 128), geom.t_end.reshape(ns, 8, 128),
            geom.hit_outer.float().reshape(ns, 8, 128)]
        r, g, b, hitf, t_hit, *_ = march_shade.march_shade(
            call["params"], *rays, call["scal"], call["hwin"], call["awin"],
            call["swin"], call["h"], call["w"], n_coarse=call["n_coarse"],
            n_bisect=call["n_bisect"], use_shadow=call["use_shadow"],
            use_earth=call["use_earth"], t_prev=tp, f_prev=fpv)
        k = i + 1.0
        ar, ag, ab = ar + (r - ar) / k, ag + (g - ag) / k, ab + (b - ab) / k
        tp, fpv = t_hit, hitf
    return ar, ag, ab


@pytest.mark.parametrize("n_samples", [2, 8, 32])
def test_march_burst_matches_plain(burst_1080p, n_samples):
    """The burst kernel gives the mean planes of the per-sample K2 loop it
    replaced bit for bit, and is within 1e-4 of march_burst_plain (on
    this map K2's own rgb error against its plain version is 2.6e-5; on
    the 360x720 test map it reaches 1.05e-4 in a 2-sample mean); a burst
    of N samples is not one of N/2 (the samples are all computed)."""
    call = burst_1080p
    assert call["t_prev"].shape == (2025, 8, 128)
    assert call["n_samples"] == 32
    call = dict(call, n_samples=n_samples)
    got = march_shade.march_burst(**call)
    loop = _k2_loop(call)
    ref = march_shade.march_burst_plain(**call)
    half = (march_shade.march_burst(**dict(call, n_samples=n_samples // 2))
            if n_samples > 2 else (call["r"], call["g"], call["b"]))
    torch.cuda.synchronize()
    for i in range(3):
        assert torch.equal(got[i], loop[i])
    err = max(float((got[i] - ref[i]).abs().max()) for i in range(3))
    moved = max(float((got[i] - half[i]).abs().max()) for i in range(3))
    assert err <= 1e-4, err
    assert moved > 1e-4, moved


# The bounce kernels against the plain version on the card: max |d| <=
# BOUNCE_TOL on a map whose values are at most 0.5. The kernels now sum
# as torch's reductions on the card do and give the plain map bit for
# bit, but torch does not promise those orders; and where an order moves
# one rounding, the plain version's own choices (far against near
# blocker, s2_2 > s2_1; fine against coarse level, s2_f > s2_acc) flip
# where two sin^2 tie to within it. So on a share of cells no larger than
# the share that 1-ulp noise on hs moves the plain version itself beyond
# BOUNCE_TOL (the self-noise rule of
# tests/torch_parity.py::scan_self_noise), the limit is what that noise
# moves it.
BOUNCE_TOL = 1e-5


def _assert_bounce_close(got, call, plain):
    from torch_parity import ulp_noise

    ref = plain(**call)
    noisy_hs = torch.from_numpy(ulp_noise(call["hs"].cpu().numpy(), 11))
    noisy = plain(**dict(call, hs=noisy_hs.to(call["hs"].device)))
    torch.cuda.synchronize()
    d = (got - ref).abs()
    moved = (noisy - ref).abs()
    noise_share = (moved > BOUNCE_TOL).float().mean().item()
    over = (d > BOUNCE_TOL).float().mean().item()
    assert float(ref.max()) > 1e-3           # the map has light to carry
    assert over <= noise_share, (over, noise_share, float(d.max()))
    assert float(d.max()) <= max(BOUNCE_TOL, float(moved.max()))


@pytest.fixture(scope="module")
def bounce_1080p():
    """The bounce call of a real scan at shadow accuracy 10 (the 1080p
    views' 1536x4096 scan grid, 7 pyramid levels) of a synthetic map,
    recorded on the card, and its scene."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.build_all()
    from moonrtx_tpu_torch.config import RenderConfig
    from moonrtx_tpu_torch.data.synth import synthesize_moon
    from moonrtx_tpu_torch.engine.scene import MoonScene
    from moonrtx_tpu_torch.ops import shadow_scan
    from moonrtx_tpu_torch.types import Observer

    elev, albedo = synthesize_moon(720, 1440, seed=5, n_craters=300)
    rs = float(elev.max())
    cfg = RenderConfig(
        observer=Observer(50.06, 19.94, 219),
        dt_local=datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc),
        width=256, height=144, shadow_accuracy=10, backend="pallas",
    ).validate()
    s = MoonScene(cfg, (elev / rs).astype(np.float32), rs, albedo, None)
    s.update_view()
    with kernels.recording() as calls:
        s.render(1)
    torch.cuda.synchronize()
    got = [c for name, c in calls if name == "bounce_from_parts"]
    assert len(got) == 1
    call = got[0]
    assert call["hs"].shape == (1536, 4096)
    assert shadow_scan.bounce_levels(1536, 4096) == 7
    return s, call


@pytest.mark.parametrize("n_bounces", [1, 2])
def test_bounce_kernel_matches_plain_on_the_1080p_grid(bounce_1080p,
                                                       n_bounces):
    from moonrtx_tpu_torch.ops import shadow_scan

    _, call = bounce_1080p
    call = dict(call, n_bounces=n_bounces)
    n0 = shadow_scan.bounce_from_parts.launches
    got = shadow_scan.bounce_from_parts(**call)
    torch.cuda.synchronize()
    assert shadow_scan.bounce_from_parts.launches == n0 + 1
    _assert_bounce_close(got, call, shadow_scan.bounce_from_parts_plain)


@pytest.mark.parametrize("grid", [(128, 256, 512), (32, 32, 128)],
                         ids=["5-levels", "3-levels"])
@pytest.mark.parametrize("n_bounces", [1, 2])
def test_bounce_kernel_matches_plain_on_small_grids(cuda, grid, n_bounces):
    """Fewer levels, and (3 levels) a coarsest level of 16x32 cells,
    smaller than a collapse tile."""
    from moonrtx_tpu_torch.ops import shadow_scan

    nc, nf, nphi = grid
    rng = np.random.default_rng(3)
    shape = (nc + nf, nphi)
    hs = 1.0 + 0.002 * rng.standard_normal(shape)
    factor = (rng.random(shape) > 0.3).astype(np.float32)
    alb = 0.1 + 0.1 * rng.random(shape)
    call = dict(hs=hs, factor=factor, alb_s=alb)
    call = {k: torch.from_numpy(v.astype(np.float32)).to(cuda)
            for k, v in call.items()}
    call.update(n_coarse=nc, n_fine=nf, n_phi=nphi, n_bounces=n_bounces)
    got = shadow_scan.bounce_from_parts(**call)
    _assert_bounce_close(got, call, shadow_scan.bounce_from_parts_plain)


@pytest.mark.parametrize("n_bounces", [1, 2])
def test_bounce_refresh_on_card_matches_plain(bounce_1080p, n_bounces):
    """bounce_refresh (the held-key path's rebuild behind a frame) goes
    through the kernels too."""
    from moonrtx_tpu_torch.ops import shadow_scan

    s, call = bounce_1080p
    slevel = s.shadow_level()
    h, w = s.mip_shapes[slevel]
    nc, nf, nphi = shadow_scan._resolution(s.shadow_accuracy)
    smap = s._shadow[0]
    basis = torch.as_tensor(np.asarray(s._bounce_basis, np.float32),
                            device=smap.device)
    n0 = shadow_scan.bounce_from_parts.launches
    got = shadow_scan.bounce_refresh(smap, call["hs"], s.alb_lum(slevel),
                                     basis, h, w, nc, nf, nphi,
                                     n_bounces=n_bounces)
    torch.cuda.synchronize()
    assert shadow_scan.bounce_from_parts.launches == n0 + 1
    assert got.shape == (nc + nf, nphi + shadow_scan.PHI_PAD)
    assert torch.equal(got[:, nphi:], got[:, :shadow_scan.PHI_PAD])
    alb_s = shadow_scan.resample_alb_half(s.alb_lum(slevel), basis, h, w, nc,
                                          nf, nphi, 0, nphi)
    plain_call = dict(hs=call["hs"], factor=smap[:, :nphi], alb_s=alb_s,
                      n_coarse=nc, n_fine=nf, n_phi=nphi,
                      n_bounces=n_bounces)
    _assert_bounce_close(got[:, :nphi], plain_call,
                         shadow_scan.bounce_from_parts_plain)


def test_bounce_kernel_refuses_other_grids(cuda):
    from moonrtx_tpu_torch.ops import shadow_scan

    hs = torch.ones((96, 512), device=cuda)
    n0 = shadow_scan.bounce_from_parts.launches
    with pytest.raises(ValueError, match="unsupported bounce grid"):
        shadow_scan.bounce_from_parts(hs, hs, hs, 32, 64, 512)
    assert shadow_scan.bounce_from_parts.launches == n0


def _session_scene(seed=5):
    """A small march-path scene on the card, shadows and bounce light on."""
    from moonrtx_tpu_torch.config import RenderConfig
    from moonrtx_tpu_torch.data.synth import synthesize_moon
    from moonrtx_tpu_torch.engine.scene import MoonScene
    from moonrtx_tpu_torch.types import Observer

    elev, albedo = synthesize_moon(360, 720, seed=seed, n_craters=150)
    rs = float(elev.max())
    cfg = RenderConfig(
        observer=Observer(50.06, 19.94, 219),
        dt_local=datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc),
        width=256, height=144, shadow_accuracy=4, backend="pallas",
    ).validate()
    s = MoonScene(cfg, (elev / rs).astype(np.float32), rs, albedo, None)
    s.update_view()
    s.render(1)
    return s


@pytest.mark.parametrize("minutes", [15, 360], ids=["timestep", "pose"])
def test_prefetch_on_card_is_bit_exact(cuda, minutes):
    """A consumed speculation gives the frame and hit buffer of the same
    step rendered without it."""
    from datetime import timedelta

    spec, plain = _session_scene(), _session_scene()
    t1 = spec.dt_local + timedelta(minutes=minutes)
    assert spec.prefetch_time(t1)
    pf = spec._prefetch
    for s in (spec, plain):
        s.update_view(t1)
    img_s, img_p = spec.render(1), plain.render(1)
    assert spec._accum is pf["accum"]
    assert np.array_equal(img_s, img_p)
    assert torch.equal(spec._hitbuf, plain._hitbuf)


def test_flip_hit_launches_no_kernel(cuda):
    from datetime import timedelta

    s = _session_scene()
    t0 = s.dt_local
    img0 = s.display()
    s.update_view(t0 + timedelta(minutes=15))
    s.render(1)
    torch.cuda.synchronize()
    before = kernels.launch_counts()
    with kernels.recording() as calls:
        s.update_view(t0)
        assert s.last_flip_hit
        img = s.render(1)
    assert calls == [] and kernels.launch_counts() == before
    assert np.array_equal(img, img0)


def test_missed_speculation_leaves_the_step_unchanged(cuda):
    """A speculation for another datetime is dropped by the step and
    leaves nothing behind: the frame equals the unspeculated step's."""
    from datetime import timedelta

    spec, plain = _session_scene(), _session_scene()
    t1 = spec.dt_local + timedelta(minutes=15)
    assert spec.prefetch_time(t1 + timedelta(minutes=15))
    for s in (spec, plain):
        s.update_view(t1)
    assert spec._prefetch is None
    img_s, img_p = spec.render(1), plain.render(1)
    assert np.array_equal(img_s, img_p)
    assert torch.equal(spec._hitbuf, plain._hitbuf)


def _mesh_scene(monkeypatch=None, banded=False):
    """The small march-path scene over a mesh of 4 logical devices on the
    card (virtual: one card is enough); ``banded`` band-shards its render
    level, the scan's working-set cap shrunk as tests/test_hfshard.py
    shrinks it."""
    from moonrtx_tpu_torch.config import RenderConfig
    from moonrtx_tpu_torch.data.synth import synthesize_moon
    from moonrtx_tpu_torch.engine.scene import MoonScene
    from moonrtx_tpu_torch.parallel import make_mesh
    from moonrtx_tpu_torch.types import Observer

    if banded:
        monkeypatch.setattr(
            "moonrtx_tpu_torch.engine.scene.SHADOW_MAX_TEXELS", 65536)
    elev, albedo = synthesize_moon(512, 1024, seed=7, n_craters=120)
    rs = float(elev.max())
    cfg = RenderConfig(
        observer=Observer(50.06, 19.94, 219),
        dt_local=datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc),
        width=256, height=144, shadow_accuracy=4, backend="pallas",
        devices=4, hbm_budget_gb=1e-6 if banded else 0.0,
    ).validate()
    s = MoonScene(cfg, (elev / rs).astype(np.float32), rs, albedo, None,
                  mesh=make_mesh(4, virtual=True))
    assert s.hf_sharded() == banded
    s.update_view()
    return s


def test_mesh_scene_on_card_matches_single_device(cuda):
    """4 strips and 4 phi wedges on the card: the launch counts the
    strips, wedges and groups imply, and the frame of one device."""
    import dataclasses

    from moonrtx_tpu_torch.engine.scene import MoonScene

    s = _mesh_scene()
    assert s.height == 160                  # 144 padded to 4 strips of 40
    kernels.reset_launch_counts()
    img = s.render(4)
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {
        "extract_group_windows": 12, "extract_level_windows": 0,
        "resample_group_windows": 8, "shadow_factor": 4, "march_shade": 16,
        "march_burst": 0, "bounce_from_parts": 1}
    from moonrtx_tpu_torch.data.synth import synthesize_moon

    elev, albedo = synthesize_moon(512, 1024, seed=7, n_craters=120)
    rs = float(elev.max())
    single = MoonScene(dataclasses.replace(s.config, devices=1),
                       (elev / rs).astype(np.float32), rs, albedo, None)
    single.update_view()
    img1 = single.render(4)
    d = np.abs(img.astype(int) - img1.astype(int)).max(axis=-1)
    assert np.percentile(d, 99) <= 2 and d.mean() < 0.2
    hit = s._hitbuf[:144, :256, 3] > 0
    hit1 = single._hitbuf[:144, :256, 3] > 0
    assert (hit == hit1).float().mean().item() >= 0.999


@pytest.mark.parametrize("where", ["wedge", "strip", "band"])
def test_mesh_kernel_shapes_match_plain(cuda, monkeypatch, where):
    """Each kernel at the shapes the mesh gives it, against its plain
    version: K3 and K4 on phi wedge 1, K2 on strip 1, K1 on device 1's
    band-local extraction of the whole frame."""
    s = _mesh_scene(monkeypatch, banded=where == "band")
    with kernels.recording() as calls:
        s.render(2)
    torch.cuda.synchronize()
    by = {}
    for name, call in calls:
        by.setdefault(name, []).append(call)
    if where == "wedge":
        picks = [("shadow_factor", by["shadow_factor"][1]),
                 ("resample_group_windows", by["resample_group_windows"][2]),
                 ("resample_group_windows", by["resample_group_windows"][3])]
    elif where == "strip":
        picks = [("march_shade", by["march_shade"][2]),
                 ("march_shade", by["march_shade"][3])]
    else:
        picks = [("extract_group_windows", by["extract_group_windows"][2]),
                 ("extract_group_windows", by["extract_group_windows"][3])]
        assert picks[0][1]["r0"].shape[0] == (160 // 8) * (256 // 16)
    plain = {"extract_group_windows": extract.extract_group_windows_plain,
             "resample_group_windows": extract.resample_group_windows_plain,
             "shadow_factor": shadow_prefix.shadow_factor_plain,
             "march_shade": march_shade.march_shade_plain}
    wrapper = kernels.wrappers()
    for name, call in picks:
        got, ref = wrapper[name](**call), plain[name](**call)
        torch.cuda.synchronize()
        if name == "extract_group_windows":
            assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
        elif name == "shadow_factor":
            assert (got - ref).abs().max().item() <= 1e-4
        elif name == "resample_group_windows":
            win = extract.decode_affine(extract._cut_windows(
                call["levels"], call["lvl_idx"], call["r0"], call["c0"],
                call["wh"], call["ww"]), call["scale"], call["offset"])
            spread = (win.amax(dim=(1, 2)) - win.amin(dim=(1, 2))).max()
            assert (got - ref).abs().max().item() <= 4e-3 * spread.item()
        else:
            assert (got[3] == ref[3]).float().mean().item() >= 0.999
            for i in range(3):
                assert (got[i] - ref[i]).abs().max().item() < 2e-2
            both = (got[3] > 0.5) & (ref[3] > 0.5)
            for i in range(4, 8):
                assert (got[i] - ref[i]).abs()[both].max().item() < 5e-2


def test_program_spans_have_no_device_copy(cuda):
    """A program span (utils/profiling.py) is an operator range on the
    card too: the profiler makes no device-side event of it, so a harness
    that counts every device-side event as work counts none of it; and
    the device work launched inside it, a plain op or a kernel of csrc/,
    is found by its launch (tools/torch_frame_profile.py)."""
    import importlib.util
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    from moonrtx_tpu_torch.utils import profiling

    path = Path(__file__).resolve().parents[1] / "tools" / \
        "torch_frame_profile.py"
    spec = importlib.util.spec_from_file_location("torch_frame_profile", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    hs = 1.0 + 0.01 * torch.rand(384, 2048, device=cuda)
    st = torch.rand(384, 1, device=cuda)
    ct = torch.rand(384, 1, device=cuda)
    shadow_prefix.shadow_factor(hs, st, ct, 0.0046, C.MOON_RADIUS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with profiling.span("test.outer"):
            y = hs @ hs.T
            with profiling.span("test.inner"):
                shadow_prefix.shadow_factor(hs, st, ct, 0.0046,
                                            C.MOON_RADIUS)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    on_card = [e for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert on_card and y.shape == (384, 384)
    assert not any(e.name().startswith(profiling.PREFIX) for e in on_card)
    assert not any(e.is_user_annotation() for e in events
                   if e.name().startswith(profiling.PREFIX))
    spans, device, window = tool.read_events(prof)
    assert sorted(n for *_, n in spans) == ["test.inner", "test.outer"]
    assert all(t is not None for *_, t in device), [
        n for *_, n, t in device if t is None]
    rows = tool.span_table(spans, device, window)["rows"]
    inner = sum(e - s for s, e, n, _ in device if "shadow" in n)
    assert inner > 0
    assert rows["test.inner"]["device_us"] == pytest.approx(inner)
    assert rows["test.outer"]["device_us"] > rows["test.inner"]["device_us"]
