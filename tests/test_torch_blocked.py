"""The port's windowed "blocked" backend and its gather reference backend
against the reference package, on the CPU.

Both packages build a MoonScene on the same synthetic map (360x720, f32,
as the golden scenes), both with ``backend="blocked"``; the port installs
the reference's device arrays (weights.scene_state_from_numpy) and, for
the function-level tests, the reference's own pose caches and rays
(weights.tuple_from_numpy), so each function sees identical inputs.

Tolerances, each with its reason:

* ``_pick_level_windows`` (K5's caller): bit-exact for f32 levels (a
  pure selection), within 1e-6 for quantized levels (the reference's XLA
  fuses the decode's multiply-add into one rounding); the same against
  the reference's K5 kernel in interpret mode. ``build_shadow_windows``
  on the reference's own maps: within 1e-6 where the origins agree.
* the scenes' own caches: an origin truncates a footprint midpoint and
  follows a chord bound read from a coarse max-height cell chosen by
  truncation, so asin/atan2 ulps apart move a few origins (2% of the
  blocks here); windows are compared where the origins agree, at least
  95% of the blocks.
* ``march_blocks``: hit flags agree on >= 99.9% of rays; where both hit,
  the hit distance agrees within 2e-3 scene units on >= 99.9% of rays: a
  bracket can flip where the field crosses zero within an ulp of a
  coarse step, which moves that ray's hit by up to a step.
* ``lookup_shadow_windows``: within 1e-4 on >= 99.9% of points (same
  windows, same points; the scan-grid coordinates come from the
  frameworks' atan2, ulps apart, and a shadow edge amplifies that).
* ``shade_blocks`` and ``render_frame_blocked``: linear rgb within 2e-3
  on >= 99.9% of rays or pixels (the normal is a difference of four
  nearby height samples).
* the scenes' display frames: p99 |d| <= 2 levels, mean < 0.2; the four
  golden images under tests/test_goldens.py's own tolerance.
"""

import os
from datetime import datetime, timezone

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moonrtx_tpu.engine import blocked as jb
from moonrtx_tpu_torch.engine import blocked as tb
from moonrtx_tpu_torch.engine import render as trender
from moonrtx_tpu_torch.engine.camera import CameraBasis
from moonrtx_tpu_torch.ops import shadow_scan as tscan
from moonrtx_tpu_torch.weights import scene_state_from_numpy, tuple_from_numpy
from torch_parity import jax_kernel_path

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
QUARTER = datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc)


def _np_fields(t):
    return {k: (None if v is None else np.asarray(v))
            for k, v in t._asdict().items()}


def _carry(cls, ref_tuple):
    return tuple_from_numpy(cls, _np_fields(ref_tuple))


def _cfg(mod_config, mod_types, dt=QUARTER, backend="blocked", height=108,
         **kw):
    return mod_config.RenderConfig(
        observer=mod_types.Observer(50.06, 19.94, 219), dt_local=dt,
        width=192, height=height, shadow_accuracy=4, backend=backend,
        **kw).validate()


def _port_scene(elev, rs, albedo, **kw):
    import moonrtx_tpu_torch.config as tconfig
    import moonrtx_tpu_torch.types as ttypes
    from moonrtx_tpu_torch.engine.scene import MoonScene

    s = MoonScene(_cfg(tconfig, ttypes, **kw), elev, rs, albedo, None,
                  device="cpu")
    s.shadows_on = True
    return s


@pytest.fixture(scope="module")
def moon():
    from moonrtx_tpu.data.synth import synthesize_moon

    elev, albedo = synthesize_moon(360, 720, seed=5, n_craters=150)
    rs = float(elev.max())
    return (elev / rs).astype(np.float32), rs, albedo


@pytest.fixture(scope="module")
def scenes(moon):
    """(reference scene, port scene, reference frame, port frame), both
    blocked, two accumulation samples, the port on the reference's arrays."""
    import moonrtx_tpu.config as jconfig
    import moonrtx_tpu.types as jtypes
    from moonrtx_tpu.engine.scene import MoonScene as JScene

    elev, rs, albedo = moon
    js = JScene(_cfg(jconfig, jtypes), elev, rs, albedo, None)
    js.backend = "blocked"
    js.shadows_on = True
    js.update_view()
    img_j = np.asarray(js.render(2))
    ts = _port_scene(elev, rs, albedo)
    ts.load_state(scene_state_from_numpy(dict(
        mips=[np.asarray(m) for m in js.mips],
        albedo_mips=[np.asarray(a) for a in js.albedo_mips],
        maxmap=np.asarray(js.maxmap), slope_maps=np.asarray(js.slope_maps),
        starmap=None, h_min=js.h_min, h_scale=js.h_scale,
        h_offset=js.h_offset, a_scale=js.a_scale,
        alb_min_level=js.alb_min_level)))
    ts.update_view()
    img_t = ts.render(2)
    return js, ts, img_j, img_t


@pytest.fixture(scope="module")
def carried(scenes):
    """The reference's pose caches, rays and per-frame tuples for sample 0,
    as the reference's own arrays and as the port's tensors."""
    js = scenes[0]
    level = js.mip_level()
    geom_j = jb.block_rays(js.render_basis(), js._fp.rotation,
                           jnp.zeros(2, jnp.float32), js.height, js.width,
                           js.h_min, maxmap=js.maxmap)
    smap, sparams = js.shadow_args()
    ref = dict(cache=js._wincache, org=js._origins, geom=geom_j,
               sw=js._shadowwin, sparams=sparams, fp=js._fp,
               basis=js.render_basis())
    port = dict(cache=_carry(tb.WindowCache, js._wincache),
                org=_carry(tb.WindowOrigins, js._origins),
                geom=_carry(tb.RayGeom, geom_j),
                sw=_carry(tb.ShadowWindows, js._shadowwin),
                sparams=_carry(tscan.ShadowMapParams, sparams),
                fp=_carry(trender.FrameParams, js._fp),
                basis=_carry(CameraBasis, js.render_basis()))
    h, w = js.mip_shapes[level]
    ah, aw = js.mip_shapes[js.albedo_level(level)]
    dims = dict(h=h, w=w, ah=ah, aw=aw, n_phi=smap.shape[1] - 2,
                height=js.height, width=js.width)
    return ref, port, dims


def _levels(rng, dtype, shapes, channels=None):
    out = []
    for h, w in shapes:
        shape = (h, w) if channels is None else (h, w, channels)
        if dtype == "float32":
            out.append(rng.random(shape).astype(np.float32))
        elif dtype == "int16":
            out.append(rng.integers(-32768, 32767, shape).astype(np.int16))
        else:
            out.append(rng.integers(0, 256, shape).astype(np.uint8))
    return out


@pytest.mark.parametrize("dtype,channels,kernel_path", [
    ("float32", None, False), ("float32", 3, False), ("int16", None, False),
    ("uint8", 3, False), ("int16", None, True), ("uint8", 3, True)])
def test_pick_level_windows_matches_reference(dtype, channels, kernel_path):
    rng = np.random.default_rng(31)
    shapes = [(120, 400), (60, 200), (44, 100)]
    levels = _levels(rng, dtype, shapes, channels)
    nblk, wh, ww = 21, 40, 64
    qexp = rng.integers(0, 4, nblk).astype(np.int32)   # 3 clips to level 2
    # origins past the level's edge: the function clamps them itself
    r0 = rng.integers(0, 130, nblk).astype(np.int32)
    c0 = rng.integers(0, 420, nblk).astype(np.int32)
    scale, offset = {"float32": (1.0, 0.0), "int16": (2.5e-5, 0.9),
                     "uint8": (1 / 255.0, 0.0)}[dtype]
    args_j = (tuple(jnp.asarray(a) for a in levels), jnp.asarray(qexp),
              jnp.asarray(r0), jnp.asarray(c0), wh, ww)
    if kernel_path:
        with jax_kernel_path():
            ref = np.asarray(jb._pick_level_windows(*args_j, scale=scale,
                                                    offset=offset))
    else:
        ref = np.asarray(jb._pick_level_windows(*args_j, scale=scale,
                                                offset=offset))
    got = tb._pick_level_windows(
        [torch.from_numpy(a) for a in levels], torch.from_numpy(qexp),
        torch.from_numpy(r0), torch.from_numpy(c0), wh, ww, scale=scale,
        offset=offset).numpy()
    assert got.shape == ref.shape == ((nblk, wh, ww) if channels is None
                                      else (nblk, wh, ww, channels))
    assert np.abs(got - ref).max() <= (0 if dtype == "float32" else 1e-6)


def test_window_cache_and_shadow_windows_match(scenes):
    """The caches the two scenes built for the same pose: unpacked albedo
    (nblk, AWIN_H, AWIN_W, 3), f32 shadow|bounce windows."""
    js, ts, _, _ = scenes
    assert ts.backend == "blocked"
    cj, ct = js._wincache, ts._wincache
    assert tuple(ct.awin.shape) == tuple(cj.awin.shape)
    assert ct.awin.ndim == 4 and ct.awin.shape[1:] == (40, 64, 3)
    same = np.ones(ct.hwin.shape[0], bool)
    for f in ("r0", "c0", "ar0", "ac0"):
        same &= (getattr(ts._origins, f).numpy()
                 == np.asarray(getattr(js._origins, f)))
    assert same.mean() >= 0.95
    np.testing.assert_allclose(ct.hwin.numpy()[same],
                               np.asarray(cj.hwin)[same], atol=1e-6)
    np.testing.assert_allclose(ct.hmean.numpy()[same],
                               np.asarray(cj.hmean)[same], atol=1e-6)
    np.testing.assert_array_equal(ct.awin.numpy()[same],
                                  np.asarray(cj.awin)[same])
    sj, st = js._shadowwin, ts._shadowwin
    assert st.swin.dtype == torch.float32
    assert tuple(st.swin.shape) == tuple(sj.swin.shape)
    assert st.swin.shape[2] == 2 * tb.SWIN_W
    ssame = ((st.sr0.numpy() == np.asarray(sj.sr0))
             & (st.sc0.numpy() == np.asarray(sj.sc0))
             & (st.sq.numpy() == np.asarray(sj.sq)))
    assert ssame.mean() >= 0.95
    d = np.abs(st.swin.numpy()[ssame] - np.asarray(sj.swin)[ssame])
    assert d[..., tb.SWIN_W:].max() <= 2e-3     # bounce half: smooth
    # shadow half: the two scans resample their heights differently (the
    # port through K4's bf16 residuals, the reference here through f32
    # windows with a bf16 row mix), and the penumbra factor behind a
    # blocker amplifies that; the maps agree in the mean
    assert d[..., :tb.SWIN_W].mean() < 0.02
    assert (d[..., :tb.SWIN_W] > 0.2).mean() < 0.005


def test_build_shadow_windows_matches_reference(scenes, carried):
    """The reference's own shadow and bounce maps through both packages'
    ungrouped build_shadow_windows (K5 on three decimation levels)."""
    js = scenes[0]
    ref, port, _ = carried
    smap, _ = js.shadow_args()
    sw_j = jb.build_shadow_windows(smap, ref["sparams"], ref["geom"],
                                   bounce_map=js._bounce)
    sw_t = tb.build_shadow_windows(
        torch.from_numpy(np.array(smap)), port["sparams"], port["geom"],
        bounce_map=torch.from_numpy(np.array(js._bounce)), grouped=False)
    for f in ("sr0", "sc0", "sq"):
        same = getattr(sw_t, f).numpy() == np.asarray(getattr(sw_j, f))
        assert same.mean() >= 0.99, f     # a truncated midpoint, ulps apart
    same = ((sw_t.sr0.numpy() == np.asarray(sw_j.sr0))
            & (sw_t.sc0.numpy() == np.asarray(sw_j.sc0))
            & (sw_t.sq.numpy() == np.asarray(sw_j.sq)))
    # a selection of map texels and of their 2x2 means
    np.testing.assert_allclose(sw_t.swin.numpy()[same],
                               np.asarray(sw_j.swin)[same], atol=1e-6)
    half = tb.build_shadow_windows(
        torch.from_numpy(np.array(smap)), port["sparams"], port["geom"],
        grouped=False)
    assert half.swin.shape[2] == tb.SWIN_W
    assert torch.equal(half.swin, sw_t.swin[:, :, :tb.SWIN_W])


@pytest.fixture(scope="module")
def marched(carried):
    ref, port, dims = carried
    out_j = jb.march_blocks(ref["cache"], ref["org"], ref["geom"],
                            dims["h"], dims["w"], jnp.float32(0.5))
    out_t = tb.march_blocks(port["cache"], port["org"], port["geom"],
                            dims["h"], dims["w"], 0.5)
    return [np.array(a) for a in out_j], out_t


def test_march_blocks_matches_reference(marched):
    (hit_j, t_j, lat_j, lon_j, p_j), (hit_t, t_t, lat_t, lon_t, p_t) = marched
    hit_t = hit_t.numpy()
    assert hit_j.mean() > 0.2
    assert (hit_t == hit_j).mean() >= 0.999
    both = hit_t & hit_j
    assert (np.abs(t_t.numpy() - t_j)[both] <= 2e-3).mean() >= 0.999
    assert (np.abs(p_t.numpy() - p_j)[both] <= 2e-3).mean() >= 0.999
    assert (np.abs(lat_t.numpy() - lat_j)[both] <= 1e-2).mean() >= 0.999


def test_lookup_shadow_windows_matches_reference(carried, marched):
    ref, port, dims = carried
    p_j = marched[0][4]
    s_j, b_j = jb.lookup_shadow_windows(ref["sw"], ref["sparams"],
                                        dims["n_phi"], jnp.asarray(p_j))
    s_t, b_t = tb.lookup_shadow_windows(port["sw"], port["sparams"],
                                        dims["n_phi"], torch.from_numpy(p_j))
    s_j, b_j = np.asarray(s_j), np.asarray(b_j)
    assert (s_j > 0.99).mean() > 0.1 and (s_j < 0.01).mean() > 0.1
    assert b_j.max() > 0
    assert (np.abs(s_t.numpy() - s_j) <= 1e-4).mean() >= 0.999
    assert (np.abs(b_t.numpy() - b_j) <= 1e-4).mean() >= 0.999
    # without a bounce half the windows are SWIN_W wide and bounce is 0
    half_j = ref["sw"]._replace(swin=ref["sw"].swin[:, :, :jb.SWIN_W])
    half_t = port["sw"]._replace(swin=port["sw"].swin[:, :, :tb.SWIN_W])
    s2_t, b2_t = tb.lookup_shadow_windows(half_t, port["sparams"],
                                          dims["n_phi"],
                                          torch.from_numpy(p_j))
    s2_j, _ = jb.lookup_shadow_windows(half_j, ref["sparams"],
                                       dims["n_phi"], jnp.asarray(p_j))
    assert float(b2_t.abs().max()) == 0.0
    assert torch.equal(s2_t, s_t)
    assert (np.abs(s2_t.numpy() - np.asarray(s2_j)) <= 1e-4).mean() >= 0.999


@pytest.mark.parametrize("packed_albedo", [False, True])
def test_shade_blocks_matches_reference(carried, marched, packed_albedo):
    ref, port, dims = carried
    hit_j, t_j, lat_j, lon_j, p_j = marched[0]
    rng = np.random.default_rng(4)
    shadow = rng.random(t_j.shape).astype(np.float32)
    bounce = (0.05 * rng.random(t_j.shape)).astype(np.float32)
    pix_ang = 2.0 * float(ref["basis"].tan_half_fov) / dims["height"]
    rgb_j = np.asarray(jb.shade_blocks(
        ref["cache"], ref["org"], dims["h"], dims["w"], dims["ah"],
        dims["aw"], jnp.asarray(lat_j), jnp.asarray(lon_j), jnp.asarray(p_j),
        ref["fp"], jnp.asarray(shadow), geom=ref["geom"],
        t_hit=jnp.asarray(t_j), pix_ang=pix_ang, bounce=jnp.asarray(bounce)))
    cache = port["cache"]
    if packed_albedo:
        # the march path's channel-blocked layout samples the same albedo
        _, awin_p = tb.pack_pose_windows(cache)
        assert awin_p.shape == (cache.hwin.shape[0] // tb.GROUP,
                                tb.GROUP * tb.AWIN_H, 3 * tb.AWIN_W)
        cache = cache._replace(awin=awin_p)
    rgb_t = tb.shade_blocks(
        cache, port["org"], dims["h"], dims["w"], dims["ah"], dims["aw"],
        torch.from_numpy(lat_j), torch.from_numpy(lon_j),
        torch.from_numpy(p_j), port["fp"], torch.from_numpy(shadow),
        geom=port["geom"], t_hit=torch.from_numpy(t_j), pix_ang=pix_ang,
        bounce=torch.from_numpy(bounce)).numpy()
    assert rgb_j[hit_j].max() > 0.05
    assert (np.abs(rgb_t - rgb_j)[hit_j] <= 2e-3).mean() >= 0.999


def test_pack_windows_matches_reference(carried):
    """The blocked caches repacked for the march kernel."""
    ref, port, _ = carried
    pj = jb.pack_windows(ref["cache"], ref["org"], ref["sw"])
    pt = tb.pack_windows(port["cache"], port["org"], port["sw"])
    for f in ("hwin", "awin", "scal"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                      np.asarray(getattr(pj, f)))
    assert pt.swin.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        pt.swin.to(torch.float32).numpy(),
        np.asarray(pj.swin.astype(jnp.float32)))


def test_render_frame_blocked_matches_reference(carried):
    ref, port, dims = carried
    args = (dims["height"], dims["width"], dims["h"], dims["w"], dims["ah"],
            dims["aw"])
    out_j = jb.render_frame_blocked(
        ref["cache"], ref["org"], ref["geom"], ref["sw"], ref["sparams"],
        None, ref["basis"], ref["fp"], jnp.float32(0.5), *args,
        n_phi=dims["n_phi"])
    out_t = tb.render_frame_blocked(
        port["cache"], port["org"], port["geom"], port["sw"],
        port["sparams"], None, port["basis"], port["fp"], 0.5, *args,
        n_phi=dims["n_phi"])
    rgb_j, hb_j = np.asarray(out_j.rgb), np.asarray(out_j.hitbuf)
    hit_j, hit_t = hb_j[..., 3] > 0, out_t.hitbuf.numpy()[..., 3] > 0
    assert (hit_t == hit_j).mean() >= 0.999
    assert (np.abs(out_t.rgb.numpy() - rgb_j).max(axis=-1) <= 2e-3
            ).mean() >= 0.999
    both = hit_t & hit_j
    assert (np.abs(out_t.hitbuf.numpy() - hb_j)[both] <= 2e-3).mean() >= 0.999


@pytest.mark.parametrize("displaced", [True, False])
def test_render_frame_matches_reference(scenes, carried, displaced):
    """The gather pipeline (intersect_heightfield or the smooth sphere,
    surface_normal, shadow_lookup, shade_lambert) on the reference's own
    maps: hit flags >= 99.9%, linear rgb and hit buffer within 2e-3 on
    >= 99.9% of pixels (a bracket can flip within an ulp of a coarse
    step, as in march_blocks)."""
    from moonrtx_tpu.engine import render as jrender

    js = scenes[0]
    ref, port, dims = carried
    level = js.mip_level()
    smap, _ = js.shadow_args()
    jitter = np.array([0.25, -0.125], np.float32)
    args = (dims["height"], dims["width"], dims["h"], dims["w"], js.h_min)
    kw = dict(h_mean=1.0 / js.radius_scale, displaced=displaced)
    out_j = jrender.render_frame(
        js.mips[level], js.albedo_mips[level], None, (smap, ref["sparams"]),
        ref["basis"], ref["fp"], jnp.asarray(jitter), *args,
        bounce_map=js._bounce, **kw)
    out_t = trender.render_frame(
        torch.from_numpy(np.array(js.mips[level])),
        torch.from_numpy(np.array(js.albedo_mips[level])), None,
        (torch.from_numpy(np.array(smap)), port["sparams"]), port["basis"],
        port["fp"], torch.from_numpy(jitter), *args,
        bounce_map=torch.from_numpy(np.array(js._bounce)), **kw)
    rgb_j, hb_j = np.asarray(out_j.rgb), np.asarray(out_j.hitbuf)
    hit_j, hit_t = hb_j[..., 3] > 0, out_t.hitbuf.numpy()[..., 3] > 0
    assert hit_j.mean() > 0.2 and rgb_j.max() > 0.05
    assert (hit_t == hit_j).mean() >= 0.999
    assert (np.abs(out_t.rgb.numpy() - rgb_j).max(axis=-1) <= 2e-3
            ).mean() >= 0.999
    both = hit_t & hit_j
    # the smooth sphere's analytic root -b - sqrt(disc) cancels towards the
    # limb (t ~ 290 in float32), where the frameworks' sums differ by ulps
    tol = 2e-3 if displaced else 5e-2
    assert (np.abs(out_t.hitbuf.numpy() - hb_j)[both] <= tol).mean() >= 0.999


def test_blocked_scene_matches_reference_scene(scenes):
    js, ts, img_j, img_t = scenes
    assert img_t.shape == img_j.shape == (108, 192, 3)
    assert img_j.max() > 0 and ts._accum_n == js._accum_n == 2
    d = np.abs(img_t.astype(int) - img_j.astype(int)).max(axis=-1)
    assert np.percentile(d, 99) <= 2.0
    assert d.mean() < 0.2
    hit_t = ts._hitbuf.numpy()[..., 3] > 0
    hit_j = np.asarray(js._hitbuf)[..., 3] > 0
    assert hit_j.mean() > 0.2 and (hit_t == hit_j).mean() >= 0.999


GOLDENS = {
    "quarter_shadows": (QUARTER, {}),
    "full_lunar_photometric": (
        datetime(2024, 4, 23, 23, 49, tzinfo=timezone.utc),
        dict(photometric="lunar")),
    "crescent_no_bounce": (
        datetime(2024, 4, 11, 19, 30, tzinfo=timezone.utc),
        dict(indirect_light=False)),
    "eclipse_totality": (
        datetime(2025, 3, 14, 6, 59, tzinfo=timezone.utc), {}),
}


@pytest.mark.parametrize("name", list(GOLDENS))
def test_golden(name):
    """The committed golden images (tools/make_goldens.py's scenes),
    rendered by the port's blocked backend."""
    from PIL import Image

    from moonrtx_tpu_torch.data.synth import synthesize_moon

    elev, albedo = synthesize_moon(360, 720, seed=11, n_craters=250)
    rs = float(elev.max())
    dt, kw = GOLDENS[name]
    s = _port_scene((elev / rs).astype(np.float32), rs, albedo, dt=dt, **kw)
    s.update_view()
    golden = np.asarray(Image.open(
        os.path.join(GOLDEN_DIR, f"{name}.png"))).astype(np.int16)
    img = s.render(2).astype(np.int16)
    assert img.shape == golden.shape
    d = np.abs(img - golden)
    assert float(d.mean()) < 0.5, f"{name}: mean |diff| {d.mean():.3f}"
    assert float((d > 8).mean()) < 0.001, (
        f"{name}: {(d > 8).mean():.4%} of pixels off by >8 levels")


@pytest.fixture(scope="module")
def port_pair(moon):
    """The port's blocked and reference backends on one 192x144 scene."""
    elev, rs, albedo = moon
    out = {}
    for backend in ("blocked", "reference"):
        s = _port_scene(elev, rs, albedo, backend=backend, height=144)
        assert s.backend == backend
        s.update_view()
        out[backend] = s
    return out


def test_blocked_matches_reference_backend(port_pair):
    """tests/test_blocked.py::test_blocked_matches_reference, in the port."""
    img_b = port_pair["blocked"].render(1).astype(int)
    img_r = port_pair["reference"].render(1).astype(int)
    diff = np.abs(img_b - img_r).max(axis=-1)
    s = port_pair["blocked"]
    q = s._origins.q.numpy()
    qmask_blocks = torch.from_numpy(
        (q < 1.5).astype(np.float32)[:, None]
        * np.ones((1, tb.BLOCK), np.float32))
    qmask = tb.from_blocks(qmask_blocks, s.height, s.width).numpy() > 0.5
    qmask = qmask[: img_b.shape[0], : img_b.shape[1]]
    hit_b = s._hitbuf.numpy()[..., 3] > 0
    hit_r = port_pair["reference"]._hitbuf.numpy()[..., 3] > 0
    interior = hit_b & hit_r
    for sh in (1, -1):
        interior &= (np.roll(interior, sh, axis=0)
                     & np.roll(interior, sh, axis=1))
        interior &= (np.roll(interior, 2 * sh, axis=0)
                     & np.roll(interior, 2 * sh, axis=1))
    interior = interior[: img_b.shape[0], : img_b.shape[1]]
    m = qmask & interior
    assert np.percentile(diff[m], 98.0) <= 2.0
    assert diff[m].mean() < 0.5
    assert (diff[m] > 8).mean() < 0.02
    assert diff.mean() < 3.0


def test_hitbuffers_match_between_backends(port_pair):
    """tests/test_blocked.py::test_hitbuffers_match: the hit under pixel
    (96, 72), scene-frame position and distance."""
    for s in port_pair.values():
        s.ensure_accumulated(1)
    hb = port_pair["blocked"]._hitbuf.numpy()[72, 96]
    hr = port_pair["reference"]._hitbuf.numpy()[72, 96]
    assert hb[3] > 0 and hr[3] > 0
    np.testing.assert_allclose(hb, hr, atol=2e-3)


def test_scene_state_changes(moon):
    """A second accumulation frame, set_shadows, set_camera and
    set_brightness change what they should and nothing else."""
    from moonrtx_tpu_torch.types import Camera

    elev, rs, albedo = moon
    s = _port_scene(elev, rs, albedo)
    s.update_view()
    a1 = s.render_accumulation_frame().clone()
    assert s._accum_n == 1
    org, cache, sw = s._origins, s._wincache, s._shadowwin
    a2 = s.render_accumulation_frame()
    assert s._accum_n == 2 and not torch.equal(a1, a2)   # jittered mean
    assert s._origins is org and s._wincache is cache and s._shadowwin is sw
    lit = s.display().astype(int)

    s.set_shadows(False)
    assert s._accum_n == 0 and s._shadowwin is None and not s.shadows_on
    unshadowed = s.render(2).astype(int)
    assert s._wincache is cache            # pose windows survive the toggle
    assert s._shadowwin is None and s.shadow_args() is None
    assert unshadowed.sum() > lit.sum()    # no cast shadows: brighter
    s.set_shadows(True)
    again = s.render(2).astype(int)
    assert s._shadowwin is not None and s._shadowwin is not sw
    # same pose, same sun: the shadowed frame comes back (new jitters)
    assert np.abs(again - lit).mean() < 0.5

    s.set_brightness(s.brightness + 40)
    assert s._accum_n == 0 and s._wincache is cache
    assert s.render(1).astype(int).sum() > again.sum()

    cam = s.camera
    s.set_camera(Camera(eye=[cam.eye[0] + 40.0, cam.eye[1], cam.eye[2]],
                        target=cam.target, up=cam.up, fov=cam.fov))
    assert s._origins is None and s._accum_n == 0
    moved = s.render(1).astype(int)
    assert s._wincache is not cache and s._origins is not None
    assert np.abs(moved - again).mean() > 0.5
    s.set_view_orientation("SNEW")
    assert s._origins is None and s._basis is None
    flipped = s.render(1)
    assert flipped.shape == moved.shape


def test_smooth_sphere_preview(moon):
    """displaced=False renders the mean sphere through the gather path on
    any backend, sample by sample, without cast shadows."""
    elev, rs, albedo = moon
    s = _port_scene(elev, rs, albedo)
    s.update_view()
    rough = s.render(1).astype(int)
    s.displaced = False
    s.reset_accumulation()
    assert s.shadow_args() is None
    smooth = s.render(2).astype(int)
    assert s._accum_n == 2 and smooth.shape == rough.shape
    hit_s = s._hitbuf.numpy()[..., 3] > 0
    assert 0.2 < hit_s.mean() < 0.9
    # same disc, same sun, no relief: close in the mean, not equal
    assert 0.0 < np.abs(smooth - rough).mean() < 8.0
    r = np.linalg.norm(s._hitbuf.numpy()[..., :3][hit_s], axis=-1)
    from moonrtx_tpu_torch import constants as C
    np.testing.assert_allclose(r, C.MOON_RADIUS / rs, rtol=1e-3)


def test_pallas_backend_accumulates_sample_by_sample(moon):
    """The march path: a burst, then further samples one at a time through
    the same kernel from the packed windows; and a scene switched from
    blocked to the march path repacks its caches."""
    elev, rs, albedo = moon
    s = _port_scene(elev, rs, albedo, backend="pallas")
    assert s.backend == "pallas"
    s.update_view()
    s.render(2)
    assert s._accum_n == 2 and s._shadowwin is tb.FUSED_SHADOW_STATE
    packed = s._packed
    burst = s._accum.clone()
    s.ensure_accumulated(3)
    assert s._accum_n == 3 and s._packed is packed
    assert not torch.equal(s._accum, burst)
    d = (s._accum - burst).abs().mean()
    assert float(d) < 0.01
    b = _port_scene(elev, rs, albedo)
    b.update_view()
    img_b = b.render(1).astype(int)
    b.backend = "pallas"
    b.reset_accumulation()
    b.render_accumulation_frame()
    assert b._packed is not None and b._packed.swin.dtype == torch.bfloat16
    d = np.abs(b.display().astype(int) - img_b).max(axis=-1)
    assert np.percentile(d, 98) <= 3 and d.mean() < 0.5
