"""The port's interactive time steps against the reference's, on the CPU.

Both packages build a MoonScene on one synthetic map (360x720, f32) at
128x128, shadow accuracy 2, ``backend="pallas"``: the reference takes its
TPU kernel path (kernels in interpret mode, tests/torch_parity.py), the
port its plain versions. Their pyramids come from the same numpy code
and are asserted equal.

Module by module, on the reference's own inputs (a pose rendered at T0,
then the sun of T0 + 15 min): ``half_grid_ok`` and ``probe_hit_dirs``
(host float64, equal); ``bounce_refresh`` (within 2e-3, the bounce map's
budget in tests/test_torch_scene.py); ``build_shadow_state_from_maps`` and
``render_timestep_pallas`` on the reference's scanned map (scal within
1e-5 and windows equal where the origins agree; origins one texel apart
on no more than 5% of the blocks, as in tests/test_torch_blocked.py: a
footprint truncates a midpoint that the frameworks' atan2 puts ulps
apart; the bf16 shadow|bounce windows within one bf16 step of a value
<= 1, 2**-7); ``render_timestep_scan_pallas``,
which scans too: its shadow map is chaotic at the ulp level, so, as in
tests/test_torch_scene.py, it may miss 5e-3 on no larger a share of
texels than 1-ulp noise on the reference's scan inputs moves the
reference itself (``scan_self_noise``), with a mean within 2e-3.
Frames: p99 |d| <= 2 levels, mean |d| < 0.2, hit flags agreeing on
>= 99.9% of pixels (tests/test_torch_scene.py).

The scene: one Q/W script on both packages (W x6, Q, W, W, a two-day
jump, shadows off), speculating the next step as app/session.py does.
Every step must make the same decisions in both (pose windows kept,
bounce map reused / refreshed behind the frame / rebuilt, flip-cache hit,
prefetch consumed) and give frames within the frame tolerance.

Then the port's own counterparts of tests/test_flip_cache.py's
single-device tests and of tests/test_blocked.py's drift-reuse tests.
"""

from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from moonrtx_tpu_torch import constants as C
from moonrtx_tpu_torch.engine import blocked as tb
from moonrtx_tpu_torch.engine import render as trender
from moonrtx_tpu_torch.engine.camera import CameraBasis
from moonrtx_tpu_torch.ops import shadow_scan as tscan
from moonrtx_tpu_torch.weights import tuple_from_numpy
from torch_parity import jax_kernel_path, scan_self_noise

T0 = datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc)
STEP = timedelta(minutes=15)
JUMP = timedelta(days=2)
# the Q/W script: (key, time delta); "x" toggles the shadows off
SCRIPT = ([("w", STEP)] * 6 + [("q", -STEP), ("w", STEP), ("w", STEP),
                               ("j", JUMP), ("x", None)])
BF16_STEP = 2.0 ** -7   # bf16 spacing of values in [0.5, 1]


def _cfg(mod_config, mod_types, **kw):
    base = dict(observer=mod_types.Observer(50.06, 19.94, 219), dt_local=T0,
                width=128, height=128, shadow_accuracy=2, backend="pallas")
    base.update(kw)
    return mod_config.RenderConfig(**base).validate()


@pytest.fixture(scope="module")
def maps():
    from moonrtx_tpu_torch.data.synth import synthesize_moon

    elev, albedo = synthesize_moon(360, 720, seed=11, n_craters=100)
    rs = float(elev.max())
    return (elev / rs).astype(np.float32), rs, albedo


def _port_scene(maps, **kw):
    import moonrtx_tpu_torch.config as tconfig
    import moonrtx_tpu_torch.types as ttypes
    from moonrtx_tpu_torch.engine.scene import MoonScene

    elev, rs, albedo = maps
    s = MoonScene(_cfg(tconfig, ttypes, **kw), elev, rs, albedo, None,
                  device="cpu")
    s.shadows_on = True
    s.update_view()
    return s


def _np(v):
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def _fields(t):
    return {k: _np(v) for k, v in t._asdict().items()}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _run_script(s, shadow_scan_mod):
    """Drive ``s`` through SCRIPT; returns the frames and, per step, the
    decisions the scene made. A step's speculation follows
    app/session.py's gate (the last two steps agree in direction, or the
    step was a flip-cache hit) and is dispatched after the frame."""
    made = {"refreshed": [], "rebuilt": []}   # the bounce maps each made

    def counted(attr, key):
        real = getattr(shadow_scan_mod, attr)

        def w(*a, **k):
            out = real(*a, **k)
            made[key].append(out if key == "refreshed" else out[2])
            return out
        return w

    frames, decisions = [], []
    prev_delta = None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(shadow_scan_mod, "bounce_refresh",
                   counted("bounce_refresh", "refreshed"))
        mp.setattr(shadow_scan_mod, "build_shadow_and_bounce",
                   counted("build_shadow_and_bounce", "rebuilt"))
        for key, delta in SCRIPT:
            origins, bounce, pf = s._origins, s._bounce, s._prefetch
            if delta is None:
                s.set_shadows(False)
            else:
                s.update_view(s.dt_local + delta)
            img = np.asarray(s.render(1)).copy()
            consumed = pf is not None and s._accum is pf["accum"]
            flip = s.last_flip_hit
            if delta is not None and (prev_delta is None or flip or (
                    (prev_delta > timedelta(0)) == (delta > timedelta(0)))):
                s.prefetch_time(s.dt_local + delta)
            prev_delta = delta if delta is not None else prev_delta
            bounce_state = "reused" if s._bounce is bounce else next(
                (k for k, v in made.items()
                 if any(m is s._bounce for m in v)), "other")
            decisions.append(dict(
                key=key, kept=s._origins is origins, bounce=bounce_state,
                flip=flip, prefetch_consumed=consumed,
                hit=np.asarray(s._hitbuf)[..., 3] > 0))
            frames.append(img)
    return frames, decisions


@pytest.fixture(scope="module")
def ref(maps):
    """Everything the reference computes, in one interpret-mode session:
    the module-level calls on a pose rendered at T0, then the Q/W script."""
    import jax.numpy as jnp

    import moonrtx_tpu.config as jconfig
    import moonrtx_tpu.types as jtypes
    from moonrtx_tpu.astro import calculate_ephemeris
    from moonrtx_tpu.engine import blocked as jb
    from moonrtx_tpu.engine import scene as jscene
    from moonrtx_tpu.engine.scene import MoonScene
    from moonrtx_tpu.ops import shadow_scan as jscan

    elev, rs, albedo = maps
    out = {}
    with jax_kernel_path():
        js = MoonScene(_cfg(jconfig, jtypes), elev, rs, albedo, None)
        js.backend = "pallas"
        js.shadows_on = True
        js.update_view()
        out["frame0"] = np.asarray(js.render(1)).copy()
        out["mips"] = [np.asarray(m) for m in js.mips]

        # the next step's sun, on the pose of T0
        e1 = calculate_ephemeris(T0 + STEP, js.config.observer,
                                 js.parallactic_mode)
        fp1 = js._frame_params(e1)
        sun1, ang1 = js._sun_state_of(e1)
        basis_np = jscene._sun_frame_basis_np(sun1)
        sun_basis = jnp.asarray(basis_np, jnp.float32)
        slevel = js.shadow_level()
        sh, sw = js.mip_shapes[slevel]
        ncs, nf, nph = jscan._resolution(js.shadow_accuracy)
        level = js.mip_level()
        h, w = js.mip_shapes[level]
        ah, aw = js.mip_shapes[js.albedo_level(level)]
        jit1 = js._padded_jitters(1)
        basis = js.render_basis()
        dims = dict(height=js.height, width=js.width, h=h, w=w,
                    h_min=js.h_min, ah=ah, aw=aw)
        scan = jb.render_timestep_scan_pallas(
            js.mips[slevel], js._bounce, sun_basis, jnp.float32(ang1),
            js._wincache, js._origins, js._packed.hwin, js._packed.awin,
            None, js.maxmap, basis, fp1, jit1, js.height, js.width, h, w,
            js.h_min, ah, aw, sh, sw, ncs, nf, nph, n_samples=1,
            hbound=js._hbound, interpret=True)
        smap, hs = scan[4], scan[5]
        sparams = jscan.ShadowMapParams(
            axis_x=sun_basis[0], axis_y=sun_basis[1], axis_z=sun_basis[2],
            n_coarse=jnp.float32(ncs), n_fine=jnp.float32(nf),
            n_phi=jnp.float32(nph), sun_ang_radius=jnp.float32(ang1))
        bounce = jscan.bounce_refresh(smap, hs, js.alb_lum(slevel),
                                      sun_basis, sh, sw, ncs, nf, nph)
        geom = jb.block_rays(basis, fp1.rotation, jit1[0], js.height,
                             js.width, js.h_min, maxmap=js.maxmap,
                             h_bound=js._hbound)
        state = jb.build_shadow_state_from_maps(
            smap, sparams, geom, js._wincache, js._origins, bmap=js._bounce)
        step = jb.render_timestep_pallas(
            smap, sparams, js._bounce, js._wincache, js._origins,
            js._packed.hwin, js._packed.awin, None, js.maxmap, basis, fp1,
            jit1, js.height, js.width, h, w, js.h_min, ah, aw, n_samples=1,
            hbound=js._hbound, interpret=True)
        _, noisy = scan_self_noise(js.mips[slevel], js.alb_lum(slevel),
                                   sun1, ang1, sh, sw, js.shadow_accuracy)
        out.update(
            dims=dims, sun_basis=basis_np.astype(np.float32), ang=ang1,
            scan_dims=(sh, sw, ncs, nf, nph), slevel=slevel,
            stex=np.asarray(js.mips[slevel]),
            alb_lum=np.asarray(js.alb_lum(slevel)),
            bounce0=np.asarray(js._bounce), jit1=np.asarray(jit1),
            wincache=_fields(js._wincache), origins=_fields(js._origins),
            hwin=np.asarray(js._packed.hwin),
            awin=np.asarray(js._packed.awin),
            hbound=np.asarray(js._hbound), maxmap=np.asarray(js.maxmap),
            basis=_fields(basis), fp1=_fields(fp1), geom=_fields(geom),
            scan=[np.asarray(v) for v in scan],
            smap=np.asarray(smap), hs=np.asarray(hs),
            sparams=_fields(sparams), bounce=np.asarray(bounce),
            state=(_fields(state[0]), np.asarray(state[1]),
                   np.asarray(state[2])),
            step=[np.asarray(v) for v in step],
            smap_noise=float((np.abs(noisy - np.asarray(smap))
                              > 5e-3).mean()))
        out["script"] = _run_script(js, jscan)
    return out


@pytest.fixture(scope="module")
def port(maps, ref):
    """The port's scene and its run of the Q/W script."""
    s = _port_scene(maps)
    for a, b in zip(s.mips, ref["mips"]):
        np.testing.assert_array_equal(a.numpy(), b)
    frame0 = s.render(1).copy()
    return s, frame0, _run_script(s, tscan)


def _frames_agree(img_t, img_j, hit_t, hit_j):
    d = np.abs(img_t.astype(int) - img_j.astype(int)).max(axis=-1)
    assert np.percentile(d, 99) <= 2.0, np.percentile(d, 99)
    assert d.mean() < 0.2, d.mean()
    assert (hit_t == hit_j).mean() >= 0.999
    assert hit_j.mean() > 0.2


def _display(rgb):
    return trender.tonemap(_t(rgb), C.TONEMAP_EXPOSURE, 2.2).numpy()


def _carried_inputs(ref):
    return dict(
        cache=tuple_from_numpy(tb.WindowCache, ref["wincache"]),
        org=tuple_from_numpy(tb.WindowOrigins, ref["origins"]),
        basis=tuple_from_numpy(CameraBasis, ref["basis"]),
        fp=tuple_from_numpy(trender.FrameParams, ref["fp1"]),
        sparams=tuple_from_numpy(tscan.ShadowMapParams, ref["sparams"]))


# ---- modules ---------------------------------------------------------------

@pytest.mark.parametrize("grid", [(256, 256, 2048), (256, 1280, 4096),
                                  (256, 8, 2048), (256, 256, 2000),
                                  (100, 100, 128)])
def test_half_grid_ok(grid):
    from moonrtx_tpu.ops import shadow_scan as jscan

    assert tscan.half_grid_ok(*grid) == jscan.half_grid_ok(*grid)


def test_probe_hit_dirs_equal_reference():
    """Host float64 in both packages: the same numbers, bit for bit, for
    cameras near, far, rolled and past the limb, in all orientations."""
    from moonrtx_tpu.engine import camera as jcam
    from moonrtx_tpu.types import Camera as JCamera
    from moonrtx_tpu_torch.engine import camera as tcam
    from moonrtx_tpu_torch.types import Camera as TCamera

    rng = np.random.default_rng(3)
    for k in range(12):
        eye = rng.normal(size=3)
        eye = eye / np.linalg.norm(eye) * rng.uniform(1.2, 40.0)
        target = rng.normal(size=3) * (0.0 if k < 4 else 0.8)
        up = rng.normal(size=3)
        fov = float(rng.uniform(0.5, 40.0))
        orient = ("NSWE", "NSEW", "SNEW", "SNWE")[k % 4]
        args = (orient, int(rng.integers(8, 1100)),
                int(rng.integers(8, 2000)), 1.0)
        dj = jcam.probe_hit_dirs(JCamera(eye=list(eye), target=list(target),
                                         up=list(up), fov=fov), *args)
        dt = tcam.probe_hit_dirs(TCamera(eye=list(eye), target=list(target),
                                         up=list(up), fov=fov), *args)
        assert dt.dtype == np.float64 and dt.shape == (3, 3, 3)
        np.testing.assert_array_equal(dt, dj)


def _host_scene(scene_mod, cfg, shapes):
    """A MoonScene with the host state update_view decides from (ephemeris,
    drift, pyramid shapes, camera) and no textures or device work."""
    s = object.__new__(scene_mod.MoonScene)
    s.config, s.parallactic_mode = cfg, cfg.parallactic_mode
    s.dt_local, s.ephem = cfg.dt_local, None
    s.camera = scene_mod.default_camera()
    s.out_height, s.mip_shapes = cfg.height, shapes
    s._flip_cache = s._prefetch = s._origins = s._cache_level = None
    s._window_drift = 0.0
    s._snapshot_step = lambda: None
    s._frame_params = lambda e: None
    s.reset_accumulation = lambda: None
    return s


def test_session_window_decisions_at_1080p():
    """chip_smoke.py phase 6's 15-minute steps (2 warm-up, 8 latency, 3
    bounce rebuilds, 1 warm-up, 8 held) on its 11520x23040 map at
    1920x1080, through each package's own update_view on host state alone:
    the same rotation per step and the same keep/rebuild decision at every
    step. Keeping the windows on 2 of the 8 latency steps and none of the
    held ones is the reference's policy here: the alt-azimuth view
    (parallactic_mode off) turns with the parallactic angle, 0.03 deg in
    the second step and more in each later one, 1.87 deg in the 22nd (5.5 hours on), while the budget
    at the render level (1440 rows) is 0.5 deg."""
    from moonrtx_tpu import config as jconfig
    from moonrtx_tpu import types as jtypes
    from moonrtx_tpu.engine import scene as jscene
    from moonrtx_tpu_torch import config as tconfig
    from moonrtx_tpu_torch import types as ttypes
    from moonrtx_tpu_torch.engine import scene as tscene

    shapes = [(11520, 23040)]
    while min(shapes[-1]) // 2 >= 64:
        shapes.append((shapes[-1][0] // 2, shapes[-1][1] // 2))
    runs = []
    for scene_mod, cfg_mod, types_mod in ((jscene, jconfig, jtypes),
                                          (tscene, tconfig, ttypes)):
        s = _host_scene(scene_mod, _cfg(cfg_mod, types_mod, width=1920,
                                        height=1080, shadow_accuracy=10),
                        shapes)
        level = scene_mod.MoonScene.mip_level(s)
        s.update_view()
        kept, rot = [], []
        for _ in range(22):
            if s._origins is None:       # the frame rebuilds the windows
                s._origins, s._cache_level = object(), level
            org, prev = s._origins, np.asarray(s.ephem.rotation_matrix)
            s.update_view(s.dt_local + STEP)
            kept.append(s._origins is org)
            rot.append(scene_mod._rotation_angle_deg(
                np.asarray(s.ephem.rotation_matrix), prev))
        runs.append((level, kept, rot))
    (lj, kj, rj), (lt, kt, rt) = runs
    assert lj == lt == 3 and shapes[3][0] == 1440
    assert kt == kj
    np.testing.assert_allclose(rt, rj, rtol=1e-12, atol=0)
    assert sum(kt[2:10]) == 2 and sum(kt[14:22]) == 0
    assert min(rt[14:22]) > 0.5


def test_bounce_refresh_matches_reference(ref):
    sh, sw, ncs, nf, nph = ref["scan_dims"]
    out = tscan.bounce_refresh(_t(ref["smap"]), _t(ref["hs"]),
                               _t(ref["alb_lum"]), _t(ref["sun_basis"]),
                               sh, sw, ncs, nf, nph)
    assert out.shape == ref["bounce"].shape == (ncs + nf, nph + 2)
    assert ref["bounce"].max() > 1e-3
    assert np.abs(out.numpy() - ref["bounce"]).max() <= 2e-3


def _origins_apart(sw_t, sw_j):
    return ((sw_t.sr0.numpy() != sw_j["sr0"])
            | (sw_t.sc0.numpy() != sw_j["sc0"]))


def _swin_agree(swin_t, swin_j, same):
    st = swin_t.to(torch.float32).numpy().reshape(len(same), -1)
    sj = np.asarray(swin_j, np.float32).reshape(len(same), -1)
    assert np.abs(st[same] - sj[same]).max() <= BF16_STEP


def _scal_agree(scal_t, scal_j):
    """Origin fields one texel apart on <= 5% of the blocks, the other
    fields within 1e-5; returns the blocks whose origins agree."""
    d = np.abs(scal_t - scal_j).max(axis=3)          # (strips, fields, G)
    origin = [0, 1, 4, 5, 6, 7]
    other = [2, 3, 8, 9]
    assert d[:, other].max() <= 1e-5
    off = (d[:, origin] > 1e-5).any(axis=1)          # (strips, G)
    assert off.mean() <= 0.05
    assert (d[:, origin][np.repeat(off[:, None], 6, axis=1)] <= 1.0).all()
    return ~off.reshape(-1)


def test_build_shadow_state_from_maps_matches_reference(ref):
    c = _carried_inputs(ref)
    geom = tuple_from_numpy(tb.RayGeom, ref["geom"])
    sw, swin_p, scal = tb.build_shadow_state_from_maps(
        _t(ref["smap"]), c["sparams"], geom, c["cache"], c["org"],
        bmap=_t(ref["bounce0"]))
    sw_j, swin_j, scal_j = ref["state"]
    assert swin_p.dtype == torch.bfloat16 and swin_p.shape == swin_j.shape
    assert _origins_apart(sw, sw_j).mean() <= 0.05
    np.testing.assert_array_equal(sw.sq.numpy(), sw_j["sq"])
    same = _scal_agree(scal.numpy(), scal_j)
    _swin_agree(swin_p, swin_j, same)


def test_render_timestep_pallas_matches_reference(ref):
    c = _carried_inputs(ref)
    d = ref["dims"]
    rgb, hitbuf, swin_p, scal = tb.render_timestep_pallas(
        _t(ref["smap"]), c["sparams"], _t(ref["bounce0"]), c["cache"],
        c["org"], _t(ref["hwin"]), _t(ref["awin"]), None, _t(ref["maxmap"]),
        c["basis"], c["fp"], _t(ref["jit1"]), d["height"], d["width"],
        d["h"], d["w"], d["h_min"], d["ah"], d["aw"], n_samples=1,
        hbound=_t(ref["hbound"]))
    rgb_j, hit_j, swin_j, scal_j = ref["step"]
    same = _scal_agree(scal.numpy(), scal_j)
    _swin_agree(swin_p, swin_j, same)
    _frames_agree(_display(rgb.numpy()), _display(rgb_j),
                  hitbuf.numpy()[..., 3] > 0, hit_j[..., 3] > 0)


def test_render_timestep_scan_pallas_matches_reference(ref):
    c = _carried_inputs(ref)
    d = ref["dims"]
    sh, sw, ncs, nf, nph = ref["scan_dims"]
    out = tb.render_timestep_scan_pallas(
        _t(ref["stex"]), _t(ref["bounce0"]), _t(ref["sun_basis"]),
        ref["ang"], c["cache"], c["org"], _t(ref["hwin"]), _t(ref["awin"]),
        None, _t(ref["maxmap"]), c["basis"], c["fp"], _t(ref["jit1"]),
        d["height"], d["width"], d["h"], d["w"], d["h_min"], d["ah"],
        d["aw"], sh, sw, ncs, nf, nph, n_samples=1,
        hbound=_t(ref["hbound"]))
    rgb, hitbuf, swin_p, scal, smap, hs = out
    rgb_j, hit_j, swin_j, scal_j, smap_j, hs_j = ref["scan"]
    assert smap.shape == smap_j.shape == (ncs + nf, nph + 2)
    np.testing.assert_allclose(hs.numpy(), hs_j, rtol=0, atol=1e-5)
    d_smap = np.abs(smap.numpy() - smap_j)
    assert (d_smap > 5e-3).mean() <= max(ref["smap_noise"], 0.0)
    assert d_smap.mean() < 2e-3
    _scal_agree(scal.numpy(), scal_j)
    _frames_agree(_display(rgb.numpy()), _display(rgb_j),
                  hitbuf.numpy()[..., 3] > 0, hit_j[..., 3] > 0)


# ---- the scene: one Q/W script on both packages -----------------------------

def test_first_frame_matches(ref, port):
    _, frame0, _ = port
    assert frame0.shape == ref["frame0"].shape == (128, 128, 3)
    d = np.abs(frame0.astype(int) - ref["frame0"].astype(int)).max(axis=-1)
    assert np.percentile(d, 99) <= 2.0 and d.mean() < 0.2


def test_script_decisions_match(ref, port):
    """Same decision at every step: windows kept, bounce map reused /
    refreshed / rebuilt, flip-cache hit, prefetch consumed."""
    keys = ("key", "kept", "bounce", "flip", "prefetch_consumed")
    got = [{k: d[k] for k in keys} for d in port[2][1]]
    want = [{k: d[k] for k in keys} for d in ref["script"][1]]
    assert got == want
    # the script covers every branch it is meant to
    assert {d["bounce"] for d in want} >= {"reused", "refreshed", "rebuilt"}
    assert any(d["flip"] for d in want)
    assert any(d["prefetch_consumed"] for d in want)
    assert not all(d["kept"] for d in want) and any(d["kept"] for d in want)


@pytest.mark.parametrize("k", range(len(SCRIPT)))
def test_script_frames_match(ref, port, k):
    img_t, img_j = port[2][0][k], ref["script"][0][k]
    assert img_t.shape == img_j.shape == (128, 128, 3)
    _frames_agree(img_t, img_j, port[2][1][k]["hit"],
                  ref["script"][1][k]["hit"])


# ---- the port's flip cache, prefetch and drift reuse ------------------------
# (tests/test_flip_cache.py's single-device tests and tests/test_blocked.py's
# drift-reuse tests, on the port; the scene tests on both windowed backends)

BACKENDS = ("blocked", "pallas")


class _TorchCalls(torch.overrides.TorchFunctionMode):
    """Records the name of every torch function called inside the block."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


def _counted(monkeypatch):
    """Count every entry point of the single-device render steps."""
    counts = {"rays": 0, "scan": 0, "scan_bounce": 0, "timestep": 0}

    def wrap(mod, attr, key):
        real = getattr(mod, attr)

        def w(*a, **k):
            counts[key] += 1
            return real(*a, **k)
        monkeypatch.setattr(mod, attr, w)

    wrap(tb, "block_rays", "rays")
    wrap(tscan, "build_shadow_map", "scan")
    wrap(tscan, "build_shadow_and_bounce", "scan_bounce")
    wrap(tb, "render_timestep_scan_pallas", "timestep")
    return counts


def _max_diff(a, b):
    return np.abs(a.astype(np.float32) - b.astype(np.float32)).max()


@pytest.mark.parametrize("backend", BACKENDS)
def test_flip_restores_previous_step_bit_exact(maps, backend):
    s = _port_scene(maps, backend=backend)
    img_t0 = s.render(1).copy()
    s.update_view(T0 + STEP)
    img_t1 = s.render(1).copy()
    assert not s.last_flip_hit

    # flip back: a cache hit that reproduces the t0 frame bit-exact
    s.update_view(T0)
    assert s.last_flip_hit
    assert s.dt_local == T0
    np.testing.assert_array_equal(s.render(1), img_t0)

    # and forward again: ping-pong, the outgoing step was re-cached
    s.update_view(T0 + STEP)
    assert s.last_flip_hit
    np.testing.assert_array_equal(s.render(1), img_t1)


@pytest.mark.parametrize("backend", BACKENDS)
def test_flip_step_dispatches_nothing(maps, monkeypatch, backend):
    s = _port_scene(maps, backend=backend)
    s.render(1)
    s.update_view(T0 + STEP)
    s.render(1)

    counts = _counted(monkeypatch)
    with _TorchCalls() as mode:
        s.update_view(T0)
        assert s.last_flip_hit
        s.ensure_accumulated(1)
    assert mode.calls == []
    s.display()
    assert counts == {"rays": 0, "scan": 0, "scan_bounce": 0,
                      "timestep": 0}, counts


@pytest.mark.parametrize("backend", BACKENDS)
def test_flip_miss_beyond_depth_renders_correctly(maps, backend):
    """The cache is one deep: Q Q (two steps back) misses on the second
    step, which must render the correct frame from scratch."""
    s = _port_scene(maps, backend=backend)
    s.render(1)
    for k in (1, 2, 3):
        s.update_view(T0 + k * STEP)
        s.render(1)
    s.update_view(T0 + 2 * STEP)           # flip: hit (t2 resident)
    assert s.last_flip_hit
    s.render(1)
    s.update_view(T0 + 1 * STEP)           # second step back: miss
    assert not s.last_flip_hit
    img = s.render(1)

    fresh = _port_scene(maps, backend=backend)
    fresh.update_view(T0 + 1 * STEP)
    assert _max_diff(img, fresh.render(1)) <= 1.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_flip_cache_invalidated_by_state_change(maps, backend):
    """Brightness (or any _flip_token field) changing between the
    snapshot and the flip must MISS, and the miss must render the new
    state correctly."""
    s = _port_scene(maps, backend=backend)
    s.render(1)
    s.update_view(T0 + STEP)
    s.render(1)
    s.set_brightness(s.brightness + 20)
    s.render(1)
    s.update_view(T0)                       # flip target resident but stale
    assert not s.last_flip_hit
    img = s.render(1)

    fresh = _port_scene(maps, backend=backend)
    fresh.set_brightness(s.brightness)
    fresh.update_view(T0)
    assert _max_diff(img, fresh.render(1)) <= 1.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_flip_hit_then_continue_same_direction(maps, backend):
    """After a flip hit the scene keeps stepping correctly in the new
    direction (the restored caches drive the next real step)."""
    s = _port_scene(maps, backend=backend)
    s.render(1)
    s.update_view(T0 + STEP)
    s.render(1)
    s.update_view(T0)                       # hit
    assert s.last_flip_hit
    s.render(1)
    s.update_view(T0 - STEP)                # continue backward: real step
    assert not s.last_flip_hit
    img = s.render(1)

    fresh = _port_scene(maps, backend=backend)
    fresh.update_view(T0 - STEP)
    assert _max_diff(img, fresh.render(1)) <= 1.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_flip_cache_with_shadows_off(maps, backend):
    """Shadows-off scenes never clear _shadow_dirty; the snapshot
    eligibility must not require it."""
    s = _port_scene(maps, backend=backend)
    s.set_shadows(False)
    img_t0 = s.render(1).copy()
    s.update_view(T0 + STEP)
    s.render(1)
    s.update_view(T0)
    assert s.last_flip_hit
    np.testing.assert_array_equal(s.render(1), img_t0)


def _session_scene(maps):
    from moonrtx_tpu_torch.app.session import Session

    s = _port_scene(maps)
    return s, Session(s, [])


def test_session_mixed_pattern_hits(maps):
    """The W W W Q W Q Q W scrub through the Session key path: flip cache
    + adaptive speculation cover >= 75% of the steps (one device, the
    march path)."""
    s, sess = _session_scene(maps)
    sess.frame()
    hits = 0
    pattern = "WWWQWQQW"
    for key in pattern:
        sess.handle_key(key.lower())
        hits += s.last_flip_hit or s._prefetch is not None
        sess.frame()
    assert hits >= 6, (hits, len(pattern))


def test_session_backward_scrub_covered(maps):
    """A direction flip lands as a flip-cache hit, which arms speculation
    in the NEW direction at once: Q Q W Q Q after forward steps is fully
    covered."""
    s, sess = _session_scene(maps)
    sess.frame()
    for key in "WWW":                     # warm forward; arms speculation
        sess.handle_key(key.lower())
        sess.frame()
    hits = []
    for key in "QQWQQ":
        sess.handle_key(key.lower())
        hits.append(bool(s.last_flip_hit or s._prefetch is not None))
        sess.frame()
    assert all(hits), hits


def test_session_mixed_pattern_full_coverage(maps):
    """With the flip cache AND flip-aware speculation, the dense
    W W W Q W Q Q W scrub has no uncovered steps at all."""
    s, sess = _session_scene(maps)
    sess.frame()
    for key in "WW":                # warm-up: arms + dispatches speculation
        sess.handle_key(key.lower())
        sess.frame()
    hits = 0
    pattern = "WWWQWQQW"
    for key in pattern:
        sess.handle_key(key.lower())
        hits += s.last_flip_hit or s._prefetch is not None
        sess.frame()
    assert hits == len(pattern), (hits, len(pattern))


@pytest.mark.parametrize("delta", [STEP, timedelta(hours=6)],
                         ids=["timestep", "pose"])
def test_consumed_prefetch_is_bit_equal(maps, delta):
    """A consumed speculation (n_samples 1, zero jitter, no random draw)
    gives the frame, hit buffer and caches the unspeculated step gives:
    a 15-minute step keeps the windows (a "timestep" speculation), a
    6-hour one does not (a "pose" speculation)."""
    spec, plain = _port_scene(maps), _port_scene(maps)
    spec.render(1)
    plain.render(1)
    assert spec.prefetch_time(T0 + delta)
    kind = spec._prefetch["kind"]
    assert kind == ("timestep" if delta == STEP else "pose")
    pf = spec._prefetch
    for s in (spec, plain):
        s.update_view(T0 + delta)
    img_s, img_p = spec.render(1), plain.render(1)
    assert spec._accum is pf["accum"]            # the speculation was used
    np.testing.assert_array_equal(img_s, img_p)
    assert torch.equal(spec._hitbuf, plain._hitbuf)
    assert torch.equal(spec._packed.scal, plain._packed.scal)
    assert spec._rng.random() == plain._rng.random()
    # and the next step runs from the installed caches as it would have
    for s in (spec, plain):
        s.update_view(T0 + delta + STEP)
    np.testing.assert_array_equal(spec.render(1), plain.render(1))


def test_prefetch_mispredict_is_not_consumed(maps):
    """A speculation of the other direction is dropped and the step
    renders as it would have without it."""
    s, plain = _port_scene(maps), _port_scene(maps)
    s.render(1)
    plain.render(1)
    assert s.prefetch_time(T0 + STEP)
    s.update_view(T0 - STEP)             # the other direction
    plain.update_view(T0 - STEP)
    assert s._prefetch is None
    np.testing.assert_array_equal(s.render(1), plain.render(1))


def test_bounce_map_drift_reuse():
    """The bounce map is reused across small time steps and rebuilt once
    the accumulated sun drift exceeds BOUNCE_REUSE_DEG (the shadow factor
    map rebuilds every step regardless)."""
    import moonrtx_tpu_torch.config as tconfig
    import moonrtx_tpu_torch.types as ttypes
    from moonrtx_tpu_torch.data.synth import synthesize_moon
    from moonrtx_tpu_torch.engine.scene import MoonScene

    elev, albedo = synthesize_moon(180, 360, seed=3, n_craters=40)
    rs = float(elev.max())
    cfg = tconfig.RenderConfig(
        observer=ttypes.Observer(50.06, 19.94, 219), dt_local=T0,
        width=96, height=72, shadow_accuracy=2).validate()
    s = MoonScene(cfg, (elev / rs).astype(np.float32), rs, albedo, None,
                  device="cpu")
    assert s.indirect_light
    s.shadows_on = True
    s.update_view()
    smap0, _ = s.shadow_args()
    b0 = s._bounce
    assert b0 is not None

    # one 15-min step: sun drifts ~0.13 deg: bounce reused, shadow fresh
    s.update_view(s.dt_local + STEP)
    smap1, _ = s.shadow_args()
    assert s._bounce is b0
    assert smap1 is not smap0

    # keep stepping: accumulated drift passes the threshold within ~5 steps
    steps = 0
    while s._bounce is b0 and steps < 10:
        s.update_view(s.dt_local + STEP)
        s.shadow_args()
        steps += 1
    assert 1 <= steps <= 6, steps

    # a jump far exceeding the threshold rebuilds immediately
    b1 = s._bounce
    s.update_view(s.dt_local + JUMP)
    s.shadow_args()
    assert s._bounce is not b1

    # disabling indirect light drops the cache
    s.indirect_light = False
    s._shadow_dirty = True
    s.shadow_args()
    assert s._bounce is None


def test_camera_drift_fast_path_survives_float32_fov(maps):
    """A camera whose fov round-tripped through float32 keeps the drag
    fast path (_camera_drift_deg uses a tolerance, not exact equality);
    a real zoom or a dolly still invalidates, and a 2-px orbit drag keeps
    the windows."""
    from moonrtx_tpu_torch.interact.navigation import orbit_drag
    from moonrtx_tpu_torch.types import Camera

    s = _port_scene(maps, backend="blocked")
    s.render(1)
    cam = s.camera
    f32_cam = Camera(eye=cam.eye, target=cam.target, up=cam.up,
                     fov=float(np.float32(cam.fov)))
    d = s._camera_drift_deg(cam, f32_cam)
    assert d is not None and d < 1e-6, d
    zoomed = Camera(eye=cam.eye, target=cam.target, up=cam.up,
                    fov=cam.fov * 1.1)
    assert s._camera_drift_deg(cam, zoomed) is None
    dolly = Camera(eye=[v * 1.01 for v in cam.eye], target=cam.target,
                   up=cam.up, fov=cam.fov)
    assert s._camera_drift_deg(cam, dolly) is None
    origins = s._origins
    s.set_camera(orbit_drag(cam, 2.0, 0.0, s.out_height))
    assert s._origins is origins and s._window_drift > 0.0
    s.render(1)
    assert s._origins is origins
