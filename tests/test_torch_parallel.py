"""The port's image strips and phi-wedge scan (moonrtx_tpu_torch.parallel)
against the reference's on the CPU.

Both packages build the scene of tests/test_parallel.py (360x720 map, seed
5, 128x128 frame, shadows off) from the same numpy pyramids. The reference
runs its shard_map programs on conftest's 8 virtual CPU devices (the march
kernel in interpret mode); the port runs its strip programs on a CPU mesh
of 8 logical devices (make_mesh(8, device="cpu")), its kernels through
their plain versions. Tolerances:

* frames (float rgb, the windowed march and the march-kernel burst):
  mean |d| < 1e-3, p99 |d| < 0.02, hit flags agreeing on >= 99.9% of
  pixels (the reference's own bounds for its strips against one device);
  the port's strips against the port's one-device frame: the same;
* shadow and bounce maps: the factor map is chaotic at the ulp level
  (tests/test_torch_shadow.py), so mean |d| < 2e-3 with at most 1% of
  texels beyond 5e-3; the bounce map mean |d| < 2e-3 (its budget in
  tests/test_torch_scene.py); the port's wedges against the port's
  one-device scan: the reference's own bounds (mean < 1e-4, p99.5 <
  1e-5; bounce mean < 1e-5);
* render_frame_pallas on the reference's own window caches: the frame
  bounds above;
* rays of a strip (row_offset != 0): directions within 1e-6 and equal
  to the rows of the full frame they cover; chord ends within 1e-4
  relative (the ray-sphere root's cancellation at ~300 scene units).

One module fixture computes everything the reference renders, once.
"""

from datetime import datetime, timezone

import numpy as np
import pytest
import torch

from moonrtx_tpu_torch.engine import blocked as tb
from moonrtx_tpu_torch.engine.camera import CameraBasis
from moonrtx_tpu_torch.engine.render import FrameParams
from moonrtx_tpu_torch.parallel import (
    TILE_AXIS,
    all_gather,
    broadcast,
    build_shadow_map_sharded,
    make_mesh,
    reduce_scatter,
    render_burst_pallas_sharded,
    render_frame_sharded,
    replicated,
    row_sharded,
)
from moonrtx_tpu_torch.weights import tuple_from_numpy
import torch_parity  # noqa: F401  (one torch thread per test process)

SUN_LATLON = (5.0, -60.0)
SUN_ANG = 0.00465


def _cfg(mod_config, mod_types, **kw):
    base = dict(observer=mod_types.Observer(50.06, 19.94, 219),
                dt_local=datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc),
                width=128, height=128)
    base.update(kw)
    return mod_config.RenderConfig(**base).validate()


@pytest.fixture(scope="module")
def maps():
    from moonrtx_tpu_torch.data.synth import synthesize_moon

    elev, albedo = synthesize_moon(360, 720, seed=5, n_craters=150)
    rs = float(elev.max())
    return (elev / rs).astype(np.float32), rs, albedo


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _fields(t):
    return {k: (None if v is None else _np(v))
            for k, v in t._asdict().items()}


@pytest.fixture(scope="module")
def ref(maps):
    """Everything the reference computes, on its 8 virtual devices."""
    import jax
    import jax.numpy as jnp

    import moonrtx_tpu.config as jconfig
    import moonrtx_tpu.types as jtypes
    from moonrtx_tpu.engine import blocked as jb
    from moonrtx_tpu.engine import camera as jcam
    from moonrtx_tpu.engine.geometry import latlon_to_unit
    from moonrtx_tpu.engine.scene import MoonScene
    from moonrtx_tpu.ops import shadow_scan as jscan
    from moonrtx_tpu.parallel import (
        build_shadow_map_sharded as j_scan,
        make_mesh as j_make_mesh,
        render_burst_pallas_sharded as j_burst,
        render_frame_sharded as j_frame,
    )

    assert len(jax.devices()) >= 8
    elev, rs, albedo = maps
    js = MoonScene(_cfg(jconfig, jtypes), elev, rs, albedo, None)
    js.shadows_on = False
    js.update_view()
    mesh = j_make_mesh(8)
    level = js.mip_level()
    h, w = js.mip_shapes[level]
    alevel = js.albedo_level(level)
    ah, aw = js.mip_shapes[alevel]
    nlevel = min(level + 1, len(js.mips) - 1)
    nalevel = min(alevel + 1, len(js.albedo_mips) - 1)
    maps_args = (js.mips[level], js.mips[nlevel], js.albedo_mips[alevel],
                 js.albedo_mips[nalevel], js.maxmap)
    dims = (js.height, js.width, h, w, ah, aw, js.h_min)
    out = dict(level=level, nlevel=nlevel, alevel=alevel, nalevel=nalevel,
               dims=dims, mips=[np.asarray(m) for m in js.mips],
               basis=_fields(js.basis()), fp=_fields(js._fp))

    rgb, hitbuf = j_frame(mesh, *maps_args, js.basis(), js._fp,
                          jnp.zeros(2, jnp.float32), *dims)
    out["frame"] = (np.asarray(rgb), np.asarray(hitbuf))
    rgb, hitbuf = j_burst(mesh, *maps_args, js.basis(), js._fp,
                          jnp.zeros((1, 2), jnp.float32), *dims,
                          n_samples=1, use_shadow=False, interpret=True)
    out["burst"] = (np.asarray(rgb), np.asarray(hitbuf))

    # the phi-wedge scan, factor only and with the bounce map
    tex = js.mips[level]
    sun = jnp.asarray(latlon_to_unit(*SUN_LATLON), jnp.float32)
    _, params = jscan.build_shadow_map(tex, h, w, sun, SUN_ANG, accuracy=2)
    basis = jnp.stack([params.axis_x, params.axis_y, params.axis_z])
    ncs, nf, nph = jscan._resolution(2)
    smap, _ = j_scan(mesh, tex, basis, jnp.float32(SUN_ANG), h, w, ncs, nf,
                     nph)
    alb_lum = jnp.mean(js.albedo_mips[level], axis=2)
    factor, bounce = j_scan(mesh, tex, basis, jnp.float32(SUN_ANG), h, w,
                            ncs, nf, nph, alb_lum=alb_lum)
    out["scan"] = dict(basis=np.asarray(basis), smap=np.asarray(smap),
                       factor=np.asarray(factor), bounce=np.asarray(bounce),
                       res=(ncs, nf, nph))

    # render_frame_pallas on the reference's own caches
    geom = jb.block_rays(js.basis(), js._fp.rotation,
                         jnp.zeros(2, jnp.float32), js.height, js.width,
                         js.h_min, maxmap=js.maxmap)
    js._ensure_blocked_caches(level, geom)
    fr = jb.render_frame_pallas(
        js._wincache, js._origins, geom, None, None, None, js.basis(),
        js._fp, js.height, js.width, h, w, ah=ah, aw=aw, n_coarse=12,
        use_shadow=False, interpret=True)
    out["pallas_frame"] = dict(
        rgb=np.asarray(fr.rgb), hitbuf=np.asarray(fr.hitbuf),
        geom=_fields(geom), origins=_fields(js._origins),
        cache=_fields(js._wincache))

    # rays of a strip: rows [16, 40) of a 64-row frame
    jit = jnp.asarray([0.21, -0.33], jnp.float32)
    out["rays"] = dict(
        jit=np.asarray(jit),
        dirs=np.asarray(jcam.ray_directions(js.basis(), 24, 40, jit,
                                            row_offset=16, full_height=64)),
        geom=_fields(jb.block_rays(js.basis(), js._fp.rotation, jit, 16, 128,
                                   js.h_min, maxmap=js.maxmap,
                                   row_offset=32, full_height=64)),
        geom_blk=_fields(jb.block_rays(js.basis(), js._fp.rotation, jit, 16,
                                       128, js.h_min, maxmap=js.maxmap,
                                       row_offset=32, full_height=64,
                                       image_dirs=False)))
    return out


@pytest.fixture(scope="module")
def port(maps, ref):
    import moonrtx_tpu_torch.config as tconfig
    import moonrtx_tpu_torch.types as ttypes
    from moonrtx_tpu_torch.engine.scene import MoonScene

    elev, rs, albedo = maps
    s = MoonScene(_cfg(tconfig, ttypes, backend="pallas"), elev, rs, albedo,
                  None, device="cpu")
    s.shadows_on = False
    s.update_view()
    for a, b in zip(s.mips, ref["mips"]):
        assert np.array_equal(a.numpy(), b)
    assert s.mip_level() == ref["level"]
    return s


def _maps_args(s, ref):
    return (s.mips[ref["level"]], s.mips[ref["nlevel"]],
            s.albedo_mips[ref["alevel"]], s.albedo_mips[ref["nalevel"]],
            s.maxmap)


def _frame_close(a, b, hit_a, hit_b):
    d = np.abs(np.asarray(a) - np.asarray(b))
    assert d.mean() < 1e-3, d.mean()
    assert np.percentile(d, 99) < 0.02, np.percentile(d, 99)
    agree = (np.asarray(hit_a)[..., 3] > 0) == (np.asarray(hit_b)[..., 3] > 0)
    assert agree.mean() >= 0.999, agree.mean()


@pytest.mark.parametrize("n", [1, 2, 8])
def test_make_mesh_on_the_cpu(n):
    mesh = make_mesh(n, device="cpu")
    assert mesh.size == n and mesh.shape == {TILE_AXIS: n}
    assert all(d.type == "cpu" for d in mesh.devices) and not mesh.virtual


def test_make_mesh_refuses_missing_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="only 1 CUDA device"):
        make_mesh(4)
    virt = make_mesh(4, virtual=True)
    assert virt.virtual and virt.size == 4
    assert virt.devices == (torch.device("cuda", 0),) * 4
    assert virt.sharing("cuda:0") == 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    real = make_mesh(4)
    assert not real.virtual
    assert real.devices == tuple(torch.device("cuda", i) for i in range(4))


def test_collectives():
    mesh = make_mesh(4, device="cpu")
    t = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    parts = row_sharded(mesh, t)
    assert [p.shape[0] for p in parts] == [2] * 4
    assert torch.equal(all_gather(parts, 0, "cpu"), t)
    assert all(torch.equal(p, t) for p in broadcast(t, mesh))
    assert all(torch.equal(p, t) for p in replicated(mesh, t))
    # device s contributes s + 1 everywhere: slice d sums to 1+2+3+4
    contrib = [torch.full((8, 3), s + 1.0) for s in range(4)]
    out = reduce_scatter(contrib, 0)
    assert [o.shape for o in out] == [(2, 3)] * 4
    assert all(torch.equal(o, torch.full((2, 3), 10.0)) for o in out)
    # disjoint owners: the sum is a select
    owned = [torch.where(torch.arange(8)[:, None] // 2 == s, t, 0.0)
             for s in range(4)]
    assert torch.equal(torch.cat(reduce_scatter(owned, 0)), t)
    with pytest.raises(ValueError):
        reduce_scatter([torch.zeros(6)] * 4, 0)


def test_sharded_frame_matches_reference_and_one_device(port, ref):
    s = port
    mesh = make_mesh(8, device="cpu")
    basis = tuple_from_numpy(CameraBasis, ref["basis"])
    fp = tuple_from_numpy(FrameParams, ref["fp"])
    rgb, hitbuf = render_frame_sharded(
        mesh, *_maps_args(s, ref), basis, fp, torch.zeros(2), *ref["dims"])
    assert rgb.shape == (128, 128, 3)
    _frame_close(rgb, ref["frame"][0], hitbuf, ref["frame"][1])
    # one device: the same rows of the same function
    one, hit1 = render_frame_sharded(
        make_mesh(1, device="cpu"), *_maps_args(s, ref), basis, fp,
        torch.zeros(2), *ref["dims"])
    _frame_close(rgb, one, hitbuf, hit1)
    assert np.allclose(hitbuf[64, 64].numpy(), hit1[64, 64].numpy(),
                       atol=1e-3)


def test_sharded_burst_matches_reference_and_one_device(port, ref):
    s = port
    mesh = make_mesh(8, device="cpu")
    basis = tuple_from_numpy(CameraBasis, ref["basis"])
    fp = tuple_from_numpy(FrameParams, ref["fp"])
    rgb, hitbuf = render_burst_pallas_sharded(
        mesh, *_maps_args(s, ref), basis, fp, torch.zeros((1, 2)),
        *ref["dims"], n_samples=1, use_shadow=False)
    _frame_close(rgb, ref["burst"][0], hitbuf, ref["burst"][1])
    # the port's own single-device march frame (scene caches, one sample)
    s.reset_accumulation()
    s._clear_pose()
    s.render_accumulation_burst(1)
    _frame_close(rgb, s._accum, hitbuf, s._hitbuf)


@pytest.mark.parametrize("with_bounce", [False, True])
def test_sharded_shadow_scan(port, ref, with_bounce):
    s = port
    sc = ref["scan"]
    mesh = make_mesh(8, device="cpu")
    level = ref["level"]
    h, w = s.mip_shapes[level]
    tex = s.mips[level]
    basis = torch.from_numpy(sc["basis"].copy())
    ncs, nf, nph = sc["res"]
    alb_lum = torch.mean(s.albedo_mips[level], dim=2) if with_bounce \
        else None
    smap, bmap = build_shadow_map_sharded(mesh, tex, basis, SUN_ANG, h, w,
                                          ncs, nf, nph, alb_lum=alb_lum)
    want = sc["factor"] if with_bounce else sc["smap"]
    assert smap.shape == want.shape
    d = np.abs(smap.numpy() - want)
    assert d.mean() < 2e-3 and (d > 5e-3).mean() <= 0.01, (
        d.mean(), (d > 5e-3).mean())
    # against the port's own one-device scan
    one = make_mesh(1, device="cpu")
    smap1, bmap1 = build_shadow_map_sharded(one, tex, basis, SUN_ANG, h, w,
                                            ncs, nf, nph, alb_lum=alb_lum)
    d1 = np.abs(smap.numpy() - smap1.numpy())
    assert d1.mean() < 1e-4 and np.percentile(d1, 99.5) < 1e-5
    if not with_bounce:
        assert bmap is None and bmap1 is None
        return
    assert bmap.shape == sc["bounce"].shape
    assert np.abs(bmap.numpy() - sc["bounce"]).mean() < 2e-3
    assert np.abs(bmap.numpy() - bmap1.numpy()).mean() < 1e-5


def test_render_frame_pallas_on_reference_caches(port, ref):
    pf = ref["pallas_frame"]
    geom = tuple_from_numpy(tb.RayGeom, pf["geom"])
    org = tuple_from_numpy(tb.WindowOrigins, pf["origins"])
    cache = tuple_from_numpy(tb.WindowCache, pf["cache"])
    basis = tuple_from_numpy(CameraBasis, ref["basis"])
    fp = tuple_from_numpy(FrameParams, ref["fp"])
    height, width, h, w, ah, aw, _ = ref["dims"]
    out = tb.render_frame_pallas(cache, org, geom, None, None, None, basis,
                                 fp, height, width, h, w, ah=ah, aw=aw,
                                 n_coarse=12, use_shadow=False)
    _frame_close(out.rgb, pf["rgb"], out.hitbuf, pf["hitbuf"])


def test_strip_rays_match_reference(port, ref):
    from moonrtx_tpu_torch.engine.camera import ray_directions

    s = port
    r = ref["rays"]
    basis = tuple_from_numpy(CameraBasis, ref["basis"])
    jit = torch.from_numpy(r["jit"])
    dirs = ray_directions(basis, 24, 40, jit, row_offset=16, full_height=64)
    assert np.allclose(dirs.numpy(), r["dirs"], atol=1e-6)
    full = ray_directions(basis, 64, 40, jit)
    assert torch.allclose(dirs, full[16:40], atol=1e-7)
    rot = torch.from_numpy(ref["fp"]["rotation"])
    for image_dirs, key in ((True, "geom"), (False, "geom_blk")):
        g = tb.block_rays(basis, rot, jit, 16, 128, s.h_min,
                          maxmap=s.maxmap, row_offset=32, full_height=64,
                          image_dirs=image_dirs)
        want = r[key]
        assert np.allclose(g.db.numpy(), want["db"], atol=1e-6)
        # chord ends (~300 scene units) lose digits to the ray-sphere
        # root's cancellation: 1e-4 relative
        assert np.allclose(g.t_enter.numpy(), want["t_enter"], rtol=1e-4,
                           atol=0.0)
        assert np.allclose(g.t_end.numpy(), want["t_end"], rtol=1e-4,
                           atol=0.0)
        assert np.array_equal(g.h_bound.numpy(), want["h_bound"])
        assert (g.hit_outer.numpy() == want["hit_outer"]).mean() > 0.999
