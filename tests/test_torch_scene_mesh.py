"""The port's scene on a device mesh (config.devices > 1) against the
reference's, on the CPU.

The scene of tests/test_scene_mesh.py: a 360x720 map (seed 11), 128x128,
shadow accuracy 2, shadows on. The reference's MoonScene(devices=8) runs
on conftest's 8 virtual CPU devices (its strip programs and phi-wedge
scan, the march kernel in interpret mode); the port's MoonScene runs on
make_mesh(8, device="cpu") (its strips, its kernels' plain versions).

One script drives both scenes: a cold 2-sample frame, a Q/W step that
keeps the pose windows, a brightness reset (the cached burst), a step
whose speculation is consumed, a direction flip (a flip-cache hit), a
step the other way from a speculation (a miss), idle accumulation to 3
samples, and shadows off. Every step must make the same decisions in
both (windows kept, flip hit, speculation consumed) and give frames
within tests/test_torch_scene.py's frame tolerance (p99 |d| <= 2 levels,
mean < 0.2, hit flags agreeing on >= 99.9% of pixels); the cached
per-device window origins compare device by device through
weights.per_device_from_shards, each device's blocks in its strip: over
the frame's blocks, strides and origins equal on >= 95% and within one
texel on all, as tests/test_torch_blocked.py allows (a footprint
truncates a midpoint the frameworks' atan2 puts ulps apart).

Then the port's own counterparts of the reference's mesh-scene tests
(each program counted, the randomized event storm against a cold scene,
stars, indirect light off, the coarsest level), its Session on the mesh,
and the unsharded scan's logged fallback.
"""

from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

import moonrtx_tpu_torch.parallel as tpar
from moonrtx_tpu_torch.parallel import make_mesh
from moonrtx_tpu_torch.weights import per_device_from_shards
import torch_parity  # noqa: F401  (one torch thread per test process)

T0 = datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc)
STEP = timedelta(minutes=15)
# (event, argument): the script both packages run
SCRIPT = [("render", 2), ("step", STEP), ("bright", 20),
          ("prefetch_step", STEP), ("step", -STEP),
          ("prefetch_miss", STEP), ("accum", 3), ("shadows_off", None)]


def _cfg(mod_config, mod_types, **kw):
    base = dict(observer=mod_types.Observer(50.06, 19.94, 219), dt_local=T0,
                width=128, height=128, shadow_accuracy=2)
    base.update(kw)
    return mod_config.RenderConfig(**base).validate()


@pytest.fixture(scope="module")
def maps():
    from moonrtx_tpu_torch.data.synth import synthesize_moon

    elev, albedo = synthesize_moon(360, 720, seed=11, n_craters=100)
    rs = float(elev.max())
    return (elev / rs).astype(np.float32), rs, albedo


def _port(maps, n=8, starmap=None, **kw):
    import moonrtx_tpu_torch.config as tconfig
    import moonrtx_tpu_torch.types as ttypes
    from moonrtx_tpu_torch.engine.scene import MoonScene

    elev, rs, albedo = maps
    s = MoonScene(_cfg(tconfig, ttypes, devices=n, **kw), elev, rs, albedo,
                  starmap, mesh=make_mesh(n, device="cpu"))
    s.shadows_on = True
    return s


def _run_script(s):
    """Drive ``s`` through SCRIPT; returns per event the frame, the hit
    flags, the decisions made and the cached origins."""
    out = []
    for ev, arg in SCRIPT:
        origins, pf = s._origins, s._prefetch
        if ev == "render":
            s.update_view()
            img = s.render(arg)
        elif ev == "step":
            s.update_view(s.dt_local + arg)
            img = s.render(1)
        elif ev == "bright":
            s.set_brightness(s.brightness + arg)
            img = s.render(1)
        elif ev == "prefetch_step":
            assert s.prefetch_time(s.dt_local + arg)
            pf = s._prefetch
            s.update_view(s.dt_local + arg)
            img = s.render(1)
        elif ev == "prefetch_miss":
            assert s.prefetch_time(s.dt_local + arg)
            pf = s._prefetch
            s.update_view(s.dt_local - arg)
            img = s.render(1)
        elif ev == "accum":
            s.ensure_accumulated(arg)
            img = s.display()
        else:
            s.set_shadows(False)
            img = s.render(1)
        out.append(dict(
            event=ev, img=np.asarray(img).copy(),
            hit=np.asarray(s._hitbuf)[: s.out_height, : s.out_width, 3] > 0,
            kept=s._origins is origins, flip=s.last_flip_hit,
            consumed=pf is not None and s._accum is pf["accum"],
            accum_n=s._accum_n, origins=s._origins))
    return out


@pytest.fixture(scope="module")
def ref(maps):
    import jax

    import moonrtx_tpu.config as jconfig
    import moonrtx_tpu.types as jtypes
    from moonrtx_tpu.engine.scene import MoonScene

    assert len(jax.devices()) >= 8
    elev, rs, albedo = maps
    js = MoonScene(_cfg(jconfig, jtypes, devices=8), elev, rs, albedo, None)
    assert js.mesh is not None
    js.shadows_on = True
    steps = _run_script(js)
    for st in steps:
        st["origins"] = per_device_from_shards(st["origins"])
    return dict(steps=steps, height=js.height)


@pytest.fixture(scope="module")
def port_steps(maps):
    s = _port(maps)
    return _run_script(s)


def _display_close(img_a, img_b, hit_a, hit_b):
    d = np.abs(img_a.astype(int) - img_b.astype(int)).max(axis=-1)
    assert np.percentile(d, 99) <= 2 and d.mean() < 0.2, (
        np.percentile(d, 99), d.mean())
    assert (hit_a == hit_b).mean() >= 0.999, (hit_a == hit_b).mean()


@pytest.mark.parametrize("k", range(len(SCRIPT)),
                         ids=[f"{i}-{e}" for i, (e, _) in enumerate(SCRIPT)])
def test_mesh_script_matches_reference(port_steps, ref, k):
    mine, theirs = port_steps[k], ref["steps"][k]
    for key in ("kept", "flip", "consumed", "accum_n"):
        assert mine[key] == theirs[key], (key, mine[key], theirs[key])
    _display_close(mine["img"], theirs["img"], mine["hit"], theirs["hit"])
    assert len(mine["origins"].q) == 8
    for field in ("q", "r0", "c0"):
        a, b = getattr(mine["origins"], field), getattr(theirs["origins"],
                                                        field)
        assert [x.shape for x in a] == [x.shape for x in b]
        a, b = torch.cat(a).float(), torch.cat(b).float()
        assert (a == b).float().mean() >= 0.95, field
        assert (a - b).abs().max() <= 1, field


def test_mesh_script_decisions(port_steps):
    by = {st["event"]: st for st in port_steps}
    assert port_steps[1]["kept"]                 # Q/W step keeps windows
    assert by["prefetch_step"]["consumed"]       # speculation consumed
    assert port_steps[4]["flip"]                 # direction flip: cache hit
    assert not by["prefetch_miss"]["consumed"]   # wrong way: not installed
    assert by["accum"]["accum_n"] == 3


def test_mesh_scene_matches_single_device(maps):
    import moonrtx_tpu_torch.config as tconfig
    import moonrtx_tpu_torch.types as ttypes
    from moonrtx_tpu_torch.engine.scene import MoonScene

    elev, rs, albedo = maps
    single = MoonScene(_cfg(tconfig, ttypes, backend="pallas"), elev, rs,
                       albedo, None, device="cpu")
    single.shadows_on = True
    single.update_view()
    meshed = _port(maps)
    assert meshed.mesh.size == 8 and meshed.device.type == "cpu"
    meshed.update_view()
    d = np.abs(meshed.render(2).astype(np.float32)
               - single.render(2).astype(np.float32))
    assert np.percentile(d, 99) < 6.0 and d.mean() < 1.0
    meshed.update_view(meshed.dt_local + STEP)
    assert meshed.render(1).max() > 0 and meshed._bounce is not None
    assert meshed.get_hit_at(64, 64) is not None


def test_mesh_scene_quantized_shadow_decode(maps):
    f32 = _port(maps)
    f32.update_view()
    smap_f32, _ = f32.shadow_args()
    quant = _port(maps, quantize="i16")
    assert quant.quantized
    quant.update_view()
    smap_q, _ = quant.shadow_args()
    assert (smap_q - smap_f32).abs().mean() < 0.01
    assert (quant._bounce - f32._bounce).abs().mean() < 0.01


def _counted(monkeypatch):
    counts = {"pose": 0, "timestep": 0, "accum": 0, "scan": 0, "burst": 0}
    for key, name in (("pose", "render_pose_sharded"),
                      ("timestep", "render_timestep_sharded"),
                      ("accum", "render_accumulate_sharded"),
                      ("scan", "build_shadow_map_sharded"),
                      ("burst", "render_burst_pallas_sharded")):
        real = getattr(tpar, name)

        def w(*a, _real=real, _key=key, **k):
            counts[_key] += 1
            return _real(*a, **k)
        monkeypatch.setattr(tpar, name, w)
    return counts


def _zero(counts):
    for c in counts:
        counts[c] = 0


def test_programs_per_step(maps, monkeypatch):
    """A cold frame extracts once; a Q/W step is the scan and one cached
    strip program; a brightness reset one cached burst; a consumed
    speculation no program at all."""
    counts = _counted(monkeypatch)
    s = _port(maps)
    s.update_view()
    s.render(1)
    assert counts["pose"] == 1 and counts["burst"] == 0
    _zero(counts)
    s.update_view(s.dt_local + STEP)
    s.render(1)
    assert counts == {"pose": 0, "timestep": 1, "accum": 0, "scan": 1,
                      "burst": 0}, counts
    _zero(counts)
    s.set_brightness(s.brightness + 20)
    s.render(1)
    assert counts == {"pose": 0, "timestep": 0, "accum": 1, "scan": 0,
                      "burst": 0}, counts
    assert s.prefetch_time(s.dt_local + STEP)
    _zero(counts)
    s.update_view(s.dt_local + STEP)
    s.render(1)
    assert counts == dict.fromkeys(counts, 0), counts


def test_mesh_interactive_randomized_stress(maps):
    """After a random mix of steps both ways, speculations (some the wrong
    way), small drags, brightness and shadow toggles, the frame equals a
    cold scene's in the same final state."""
    from moonrtx_tpu_torch.interact.navigation import orbit_drag

    s = _port(maps)
    s.update_view()
    s.render(1)
    rng = np.random.default_rng(1234)
    for i in range(24):
        ev = rng.integers(0, 5)
        if ev == 0:
            sgn = int(rng.choice([-1, 1]))
            s.update_view(s.dt_local + sgn * STEP)
        elif ev == 1:
            sgn = int(rng.choice([-1, 1]))
            s.prefetch_time(s.dt_local + STEP)
            s.update_view(s.dt_local + sgn * STEP)
        elif ev == 2:
            s.set_camera(orbit_drag(s.camera, float(rng.normal(0, 3)),
                                    float(rng.normal(0, 3)), s.out_height))
        elif ev == 3:
            s.set_brightness(int(rng.integers(60, 100)))
        else:
            s.set_shadows(not s.shadows_on)
        if i % 6 == 5:
            s.render(1)
    s.set_shadows(True)
    img = s.render(1)
    cold = _port(maps)
    cold.brightness = s.brightness
    cold.camera = s.camera
    cold.update_view(s.dt_local)
    cold.set_brightness(s.brightness)
    d = np.abs(img.astype(np.float32) - cold.render(1).astype(np.float32))
    assert d.max() <= 1.0, (d.max(), (d > 1).mean())


def test_mesh_mode_composites_star_background(maps):
    star = np.zeros((128, 256, 3), np.float32)
    star[::4, ::4] = 1.0
    s = _port(maps, starmap=star)
    s.update_view()
    img = s.render(1)
    sky = img[~(s.hit_buffer_host()[:128, :128, 3] > 0)]
    assert sky.max() > 60
    s.update_view(s.dt_local + STEP)
    img2 = s.render(1)
    sky2 = img2[~(s.hit_buffer_host()[:128, :128, 3] > 0)]
    assert sky2.max() > 60


def test_mesh_mode_no_indirect_light(maps):
    s = _port(maps, indirect_light=False)
    s.update_view()
    assert s.render(1).max() > 0 and s._bounce is None
    s.update_view(s.dt_local + STEP)
    assert s.render(1).max() > 0
    assert s.prefetch_time(s.dt_local + STEP)
    s.update_view(s.dt_local + STEP)
    assert s.render(1).max() > 0


def test_mesh_coarsest_level_matches_single_device(maps):
    import moonrtx_tpu_torch.config as tconfig
    import moonrtx_tpu_torch.types as ttypes
    from moonrtx_tpu_torch.engine.scene import MoonScene
    from moonrtx_tpu_torch.types import Camera

    elev, rs, albedo = maps
    single = MoonScene(_cfg(tconfig, ttypes, backend="pallas"), elev, rs,
                       albedo, None, device="cpu")
    single.update_view()
    meshed = _port(maps)
    meshed.shadows_on = False
    meshed.update_view()
    cam = single.camera
    zoom = 1.0
    while single.mip_level() < len(single.mips) - 1 and zoom < 64:
        zoom *= 2
        far = Camera(eye=[c * zoom for c in cam.eye], target=cam.target,
                     up=cam.up, fov=cam.fov)
        single.set_camera(far)
        meshed.set_camera(far)
    assert single.mip_level() == len(single.mips) - 1
    single.shadows_on = False
    d = np.abs(meshed.render(1).astype(np.float32)
               - single.render(1).astype(np.float32))
    assert np.percentile(d, 99) < 6.0 and d.mean() < 1.0


def test_mesh_session_prefetch_and_flip(maps):
    """Session on the mesh: held W steps consume their speculation, a Q
    flips back through the flip cache, and each frame equals a cold mesh
    scene at that time."""
    from moonrtx_tpu_torch.app.session import Session
    from moonrtx_tpu_torch.data.features import load_moon_features

    s = _port(maps)
    sess = Session(s, load_moon_features(None))
    sess.frame()
    sess.handle_key("w")
    sess.frame()
    pf = s._prefetch
    assert pf is not None and pf["dt"] == T0 + 2 * STEP
    sess.handle_key("w")
    sess.frame()
    assert s._accum is pf["accum"]          # the speculation was consumed
    sess.handle_key("q")
    sess.frame()
    assert s.last_flip_hit and s.dt_local == T0 + STEP
    cold = _port(maps)
    cold.update_view(s.dt_local)
    d = np.abs(s.display().astype(np.float32)
               - cold.render(1).astype(np.float32))
    assert d.max() <= 1.0


def test_phi_grid_not_dividing_the_mesh_is_logged(maps, monkeypatch):
    import moonrtx_tpu_torch.engine.scene as scene_mod

    events = []
    monkeypatch.setattr(scene_mod, "log_event",
                        lambda name, **kw: events.append((name, kw)))
    s = _port(maps, n=3)
    assert s.height % (8 * 3) == 0
    s.update_view()
    assert s.render(1).max() > 0
    names = [e for e, _ in events]
    assert "mesh_shadow_scan_fallback_single_device" in names
    kw = dict(events)["mesh_shadow_scan_fallback_single_device"]
    assert kw["devices"] == 3 and kw["n_phi"] == 2048


def test_replicated_level_stacks_slice_per_device(maps, monkeypatch):
    """The strip programs take levels [level, level + n) of a replicated
    stack (the slope maps): the stack itself where every device is the
    scene's, else each device's slice of its own copy, made once."""
    s = _port(maps, n=2)
    stack = s.slope_maps
    assert torch.equal(s._rep_levels(stack, 1, 2), stack[1:3])
    copies = [stack, stack.clone()]
    monkeypatch.setattr(s, "_rep", lambda t: copies if t is stack else t)
    parts = s._rep_levels(stack, 1, 2)
    assert len(parts) == 2
    for part, copy in zip(parts, copies):
        assert torch.equal(part, stack[1:3])
        assert part.data_ptr() == copy[1:3].data_ptr()
