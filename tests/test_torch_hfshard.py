"""The port's heightfield band sharding (moonrtx_tpu_torch.parallel.hfshard)
and the scene's band plan against the reference's, on the CPU.

The scene of tests/test_hfshard.py: a 512x1024 map (seed 7; every level's
height divides 8 devices), 128x128, shadow accuracy 2, shadows on. The
reference runs on conftest's 8 virtual CPU devices (the march kernel in
interpret mode), the port on make_mesh(8, device="cpu") with its kernels'
plain versions. Tolerances:

* shard_bands: the bands equal the reference's shards bit for bit, and
  owned rows tile the level;
* the banded burst against the port's replicated strips: within 1e-5
  (the same windows after the reduce-scatter of disjoint owners; float
  noise only), as the reference holds its own two;
* the banded burst and banded scene frames against the reference's: the
  frame bounds of tests/test_torch_parallel.py for float frames (mean |d|
  < 1e-3, p99 < 0.02, hits >= 99.9%) and of tests/test_torch_scene.py for
  displayed frames (p99 |d| <= 2 levels, mean < 0.2, hits >= 99.9%);
* the band plan: the same banded mip and albedo levels, the same
  projected and budget bytes, the same over-budget verdict as the
  reference's MoonScene at the same hbm_budget_gb (exact).

One module fixture computes everything the reference renders, once: the
band plans, the banded scene's script (whose hf burst with shadows, and
its inputs, are recorded on the way) and the same burst without shadows.
"""

from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

import moonrtx_tpu_torch.parallel as tpar
from moonrtx_tpu_torch.engine.camera import CameraBasis
from moonrtx_tpu_torch.engine.render import FrameParams
from moonrtx_tpu_torch.ops.shadow_scan import ShadowMapParams
from moonrtx_tpu_torch.parallel import (
    BAND_HALO,
    band_heights,
    make_mesh,
    render_burst_pallas_hfshard,
    render_burst_pallas_sharded,
    shard_bands,
)
from moonrtx_tpu_torch.weights import per_device_from_shards, tuple_from_numpy
import torch_parity  # noqa: F401  (one torch thread per test process)

T0 = datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc)
STEP = timedelta(minutes=15)
TINY, BIG = 1e-6, 1024.0      # hbm_budget_gb: forces banding / replicates


def _cfg(mod_config, mod_types, **kw):
    base = dict(observer=mod_types.Observer(50.06, 19.94, 219), dt_local=T0,
                width=128, height=128, shadow_accuracy=2)
    base.update(kw)
    return mod_config.RenderConfig(**base).validate()


@pytest.fixture(scope="module")
def maps():
    from moonrtx_tpu_torch.data.synth import synthesize_moon

    elev, albedo = synthesize_moon(512, 1024, seed=7, n_craters=120)
    rs = float(elev.max())
    return (elev / rs).astype(np.float32), rs, albedo


@pytest.fixture(scope="module")
def few_craters():
    from moonrtx_tpu_torch.data.synth import synthesize_moon

    elev, albedo = synthesize_moon(512, 1024, seed=7, n_craters=40)
    rs = float(elev.max())
    return (elev / rs).astype(np.float32), rs, albedo


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _fields(t):
    return {k: (None if v is None else _np(v))
            for k, v in t._asdict().items()}


def _plan(s):
    return (sorted(s._band_levels), sorted(s._band_alb_levels),
            s.hbm_over_budget)


def _jax_scene(maps, budget, patch=True, **kw):
    import moonrtx_tpu.config as jconfig
    import moonrtx_tpu.types as jtypes
    from moonrtx_tpu.engine.scene import MoonScene

    elev, rs, albedo = maps
    with pytest.MonkeyPatch.context() as mp:
        if patch:
            mp.setattr("moonrtx_tpu.engine.scene.SHADOW_MAX_TEXELS", 65536)
        return MoonScene(_cfg(jconfig, jtypes, devices=8,
                              hbm_budget_gb=budget, **kw),
                         elev, rs, albedo, None)


def _port_scene(maps, budget=None, mp=None, **kw):
    """The port's scene, on a CPU mesh of 8 with a budget; with ``mp``
    (the test's monkeypatch) the scan working-set cap shrinks for the
    rest of the test, as in the reference's tests, so the small map's
    fine levels count as too big for the budget."""
    import moonrtx_tpu_torch.config as tconfig
    import moonrtx_tpu_torch.types as ttypes
    from moonrtx_tpu_torch.engine.scene import MoonScene

    elev, rs, albedo = maps
    extra = dict(kw)
    if budget is not None:
        extra.update(devices=8, hbm_budget_gb=budget)
    if mp is not None:
        mp.setattr("moonrtx_tpu_torch.engine.scene.SHADOW_MAX_TEXELS", 65536)
    return MoonScene(_cfg(tconfig, ttypes, **extra), elev, rs, albedo, None,
                     device="cpu",
                     mesh=make_mesh(8, device="cpu") if budget else None)


def _bands_per_device(x):
    """The reference's (n_dev, rows, ...) band stack as the port's list of
    per-device bands."""
    return [t[0] for t in per_device_from_shards(x)]


@pytest.fixture(scope="module")
def ref(maps, few_craters):
    """Everything the reference computes, on its 8 virtual devices. The
    banded burst's inputs and frame with shadows are the ones the banded
    scene's cold frame passes to and gets from render_burst_pallas_hfshard
    (recorded on the way), so the burst is held to the same reference
    program the scene runs; the shadowless burst reruns it on those
    inputs."""
    import jax

    import moonrtx_tpu.config as jconfig
    import moonrtx_tpu.parallel as jpar
    import moonrtx_tpu.types as jtypes
    from moonrtx_tpu.engine.scene import MoonScene

    assert len(jax.devices()) >= 8
    out = {}
    # the band plans (construction only)
    out["plan"] = {b: _plan(_jax_scene(maps, b)) for b in (TINY, BIG)}
    out["plan_unbandable"] = _plan(_jax_scene(few_craters, TINY,
                                              patch=False))
    elev, rs, albedo = maps
    out["mips"] = [np.asarray(m) for m in
                   MoonScene(_cfg(jconfig, jtypes), elev, rs, albedo,
                             None).mips]

    # the banded scene: a cold frame (its hf burst recorded), then a
    # kept-window time step
    calls = []
    real_hf = jpar.render_burst_pallas_hfshard

    def recorded_hf(*a, **k):
        res = real_hf(*a, **k)
        calls.append((a, k, res))
        return res

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("moonrtx_tpu.engine.scene.SHADOW_MAX_TEXELS", 65536)
        mp.setattr(jpar, "render_burst_pallas_hfshard", recorded_hf)
        bs = MoonScene(_cfg(jconfig, jtypes, devices=8, hbm_budget_gb=TINY),
                       elev, rs, albedo, None)
        assert bs.hf_sharded()
        bs.shadows_on = True
        bs.update_view()
        out["scene_cold"] = (np.asarray(bs.render(1)).copy(),
                             np.asarray(bs._hitbuf)[..., 3] > 0)
        out["scene_origins"] = bs._origins
        origins = bs._origins
        bs.update_view(bs.dt_local + STEP)
        out["scene_step"] = (np.asarray(bs.render(1)).copy(),
                             np.asarray(bs._hitbuf)[..., 3] > 0)
        out["scene_step_kept"] = bs._origins is origins
    assert len(calls) == 1
    a, k, res = calls[0]
    level = bs.mip_level()
    alevel = bs.albedo_level(level)
    out["level"] = level
    out["levels"] = (level, min(level + 1, len(bs.mips) - 1), alevel,
                     min(alevel + 1, len(bs.albedo_mips) - 1))
    out["hf_in"] = dict(
        bmips=[_bands_per_device(x) for x in a[1]],
        balb=[_bands_per_device(x) for x in a[2]],
        maxmap=np.asarray(a[3]), basis=_fields(a[4]), fp=_fields(a[5]),
        jitters=np.asarray(a[6]), dims=tuple(a[7:13]) + (float(a[13]),),
        smap=np.asarray(k["shadow_map"]),
        sparams=_fields(k["smap_params"]),
        bounce=np.asarray(k["bounce_map"]),
        slopes=np.asarray(k["slope_maps"]),
        kw={n: k[n] for n in ("n_samples", "h_scale", "h_offset",
                              "a_scale", "max_qexp")})
    assert k["use_shadow"] and not k["use_bg"] and k["background"] is None
    out[("hf", True)] = (np.asarray(res[0]), np.asarray(res[1]))
    rgb, hitbuf = real_hf(*a, **dict(k, use_shadow=False,
                                     return_caches=False))
    out[("hf", False)] = (np.asarray(rgb), np.asarray(hitbuf))
    return out


@pytest.fixture(scope="module")
def port(maps, ref):
    s = _port_scene(maps, backend="pallas")
    s.shadows_on = True
    s.update_view()
    for a, b in zip(s.mips, ref["mips"]):
        assert np.array_equal(a.numpy(), b)
    assert s.mip_level() == ref["level"]
    return s


def _float_close(a, b, hit_a, hit_b):
    d = np.abs(_np(a) - _np(b))
    assert d.mean() < 1e-3, d.mean()
    assert np.percentile(d, 99) < 0.02, np.percentile(d, 99)
    agree = (_np(hit_a)[..., 3] > 0) == (_np(hit_b)[..., 3] > 0)
    assert agree.mean() >= 0.999, agree.mean()


def _display_close(img_a, img_b, hit_a, hit_b):
    d = np.abs(img_a.astype(int) - img_b.astype(int)).max(axis=-1)
    assert np.percentile(d, 99) <= 2 and d.mean() < 0.2, (
        np.percentile(d, 99), d.mean())
    assert (np.asarray(hit_a) == np.asarray(hit_b)).mean() >= 0.999


def test_shard_bands_roundtrip(port, ref):
    mesh = make_mesh(8, device="cpu")
    level = port.mips[ref["level"]].numpy()
    band_h, bh = band_heights(level.shape[0], 8)
    banded = shard_bands(mesh, level)
    assert len(banded) == 8
    assert all(b.shape == (bh,) + level.shape[1:] for b in banded)
    rebuilt = np.concatenate([b[:band_h].numpy() for b in banded], axis=0)
    assert np.array_equal(rebuilt, level)
    for d in range(7):  # halo of band d == head of band d+1
        assert torch.equal(banded[d][band_h:], banded[d + 1][:BAND_HALO])
    assert not banded[7][band_h:].any()
    # the bands the reference's banded scene built, device by device
    for mine, theirs in zip(banded, ref["hf_in"]["bmips"][0]):
        assert torch.equal(mine, theirs)
    with pytest.raises(ValueError):
        band_heights(100, 8)


@pytest.mark.parametrize("shadows", [False, True])
def test_hfshard_matches_replicated_and_reference(port, ref, shadows):
    s = port
    hf = ref["hf_in"]
    mesh = make_mesh(8, device="cpu")
    level, nlevel, alevel, nalevel = ref["levels"]
    bmips = tuple(shard_bands(mesh, s.mips[k].numpy())
                  for k in (level, nlevel))
    balb = tuple(shard_bands(mesh, s.albedo_mips[k].numpy())
                 for k in (alevel, nalevel))
    for mine, theirs in zip(bmips + balb, hf["bmips"] + hf["balb"]):
        assert all(torch.equal(a, b) for a, b in zip(mine, theirs))
    basis = tuple_from_numpy(CameraBasis, hf["basis"])
    fp = tuple_from_numpy(FrameParams, hf["fp"])
    args = (torch.from_numpy(hf["maxmap"].copy()), basis, fp,
            torch.from_numpy(hf["jitters"].copy()), *hf["dims"])
    kw = dict(hf["kw"], use_shadow=shadows,
              slope_maps=torch.from_numpy(hf["slopes"].copy()))
    if shadows:
        kw.update(shadow_map=torch.from_numpy(hf["smap"].copy()),
                  smap_params=tuple_from_numpy(ShadowMapParams,
                                               hf["sparams"]),
                  bounce_map=torch.from_numpy(hf["bounce"].copy()))
    rgb_hf, hit_hf = render_burst_pallas_hfshard(mesh, bmips, balb, *args,
                                                 **kw)
    rgb_rep, hit_rep = render_burst_pallas_sharded(
        mesh, s.mips[level], s.mips[nlevel], s.albedo_mips[alevel],
        s.albedo_mips[nalevel], *args, **kw)
    assert torch.allclose(rgb_hf, rgb_rep, atol=1e-5)
    assert torch.allclose(hit_hf, hit_rep, atol=1e-4)
    _float_close(rgb_hf, ref[("hf", shadows)][0], hit_hf,
                 ref[("hf", shadows)][1])


@pytest.mark.parametrize("budget", [TINY, BIG])
def test_band_plan_matches_reference(maps, ref, budget, capsys,
                                     monkeypatch):
    s = _port_scene(maps, budget, monkeypatch)
    assert _plan(s) == ref["plan"][budget]
    err = capsys.readouterr().err
    if budget == TINY:
        assert s._band_levels and s.hf_sharded()
        assert s.mips[s.mip_level()] is None  # never whole on one device
        assert "WARNING" in err
    else:
        assert not s._band_levels and not s.hf_sharded()
        assert s.hbm_over_budget is None and "WARNING" not in err


def test_over_budget_is_surfaced_to_the_user(maps, monkeypatch):
    from moonrtx_tpu_torch.app.session import Session

    tiny = _port_scene(maps, TINY, monkeypatch)
    ob = tiny.hbm_over_budget
    assert ob["projected_bytes"] > ob["budget_bytes"]
    txt = Session(tiny, []).status_panels()["memory"]
    assert "over budget" in txt
    assert f"{ob['projected_bytes'] / 2**30:.1f}" in txt
    big = _port_scene(maps, BIG, monkeypatch)
    assert Session(big, []).status_panels()["memory"] == ""


def test_over_budget_warns_even_when_nothing_is_bandable(few_craters, ref,
                                                         capsys):
    s = _port_scene(few_craters, TINY)
    assert not s._band_levels and not s._band_alb_levels
    assert s.hbm_over_budget is not None
    assert _plan(s) == ref["plan_unbandable"]
    assert "unbandable" in capsys.readouterr().err


def test_policy_stays_replicated_single_device(maps):
    import moonrtx_tpu_torch.config as tconfig
    import moonrtx_tpu_torch.types as ttypes
    from moonrtx_tpu_torch.engine.scene import MoonScene

    elev, rs, albedo = maps
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("moonrtx_tpu_torch.engine.scene.SHADOW_MAX_TEXELS", 65536)
        s = MoonScene(_cfg(tconfig, ttypes, devices=1, hbm_budget_gb=TINY),
                      elev, rs, albedo, None, device="cpu")
    assert s.mesh is None and not s._band_levels
    assert all(m is not None for m in s.mips)


def _counted(monkeypatch):
    counts = {"hf": 0, "pose_rep": 0, "timestep": 0, "accum": 0}
    for key, name in (("hf", "render_burst_pallas_hfshard"),
                      ("pose_rep", "render_pose_sharded"),
                      ("timestep", "render_timestep_sharded"),
                      ("accum", "render_accumulate_sharded")):
        real = getattr(tpar, name)

        def w(*a, _real=real, _key=key, **k):
            counts[_key] += 1
            return _real(*a, **k)
        monkeypatch.setattr(tpar, name, w)
    return counts


def test_banded_scene_matches_replicated_and_reference(maps, ref,
                                                       monkeypatch):
    """The banded scene's cold frame equals the replicated mesh scene's
    (float noise) and the reference's banded frame; a Q/W step runs the
    cached time-step program on the assembled strip caches, matching the
    reference's step; a speculation is consumed with no new program."""
    tiny = _port_scene(maps, TINY, monkeypatch)
    tiny.shadows_on = True
    tiny.update_view()
    counts = _counted(monkeypatch)
    img = tiny.render(1)
    assert counts == {"hf": 1, "pose_rep": 0, "timestep": 0, "accum": 0}
    banded = tiny._banded_mips[tiny.mip_level()]
    assert len(banded) == 8 and banded[0].shape[0] < tiny.mip_shapes[
        tiny.mip_level()][0]
    _display_close(img, ref["scene_cold"][0],
                   tiny.hit_buffer_host()[:128, :128, 3] > 0,
                   ref["scene_cold"][1])
    # the strip caches, device by device, against the reference's shards
    theirs = per_device_from_shards(ref["scene_origins"])
    for mine, other in zip(tiny._origins.q, theirs.q):
        assert (mine == other).float().mean() >= 0.95
    for mine, other in zip(tiny._origins.r0, theirs.r0):
        assert (mine - other).abs().max() <= 1
        assert (mine == other).float().mean() >= 0.95

    big = _port_scene(maps, BIG, monkeypatch)
    big.shadows_on = True
    big.update_view()
    big.render(1)
    assert counts["pose_rep"] == 1
    assert torch.allclose(tiny._accum, big._accum, atol=1e-5)

    origins = tiny._origins
    tiny.update_view(tiny.dt_local + STEP)
    img_step = tiny.render(1)
    assert (tiny._origins is origins) == ref["scene_step_kept"]
    assert counts["timestep"] == 1 and counts["hf"] == 1
    _display_close(img_step, ref["scene_step"][0],
                   tiny.hit_buffer_host()[:128, :128, 3] > 0,
                   ref["scene_step"][1])
    # the speculation covers banded scenes: consumed, no new program
    assert tiny.prefetch_time(tiny.dt_local + STEP)
    before = dict(counts)
    tiny.update_view(tiny.dt_local + STEP)
    tiny.render(1)
    assert counts == before


def test_banded_progressive_accumulation_stays_on_one_level(maps,
                                                            monkeypatch):
    s = _port_scene(maps, TINY, monkeypatch)
    s.shadows_on = True
    s.update_view()
    s.render(1)
    lvl = s._cache_level
    assert s.hf_sharded() and s.mips[lvl] is None
    s.ensure_accumulated(2)
    s.ensure_accumulated(3)
    assert s._cache_level == lvl and s._accum_n == 3
    assert all(k <= lvl + 1 or k in s._band_levels for k in s._banded_mips)


def test_banded_scene_zoom_across_placement_boundary(maps, monkeypatch):
    from moonrtx_tpu_torch.types import Camera

    s = _port_scene(maps, TINY, monkeypatch, shadow_accuracy=1)
    s.update_view()
    lvl_near = s.mip_level()
    assert s.hf_sharded()
    assert s.render(1).max() > 0
    cam = s.camera
    for zoom in (3.0, 6.0, 12.0):
        far = Camera(eye=[c * zoom for c in cam.eye], target=cam.target,
                     up=cam.up, fov=cam.fov)
        s.set_camera(far)
        if s.mip_level() != lvl_near:
            break
    assert s.mip_level() != lvl_near
    assert s.render(1).max() > 0 and s._cache_level == s.mip_level()
    s.set_camera(cam)
    img_back = s.render(1)
    cold = _port_scene(maps, TINY, monkeypatch, shadow_accuracy=1)
    cold.update_view(s.dt_local)
    d = np.abs(img_back.astype(np.float32)
               - cold.render(1).astype(np.float32))
    assert d.max() <= 1.0, d.max()
