"""The port's package boundary, its host copies and its small torch
modules against the reference.

* isolation: no module of moonrtx_tpu_torch, nor chip_smoke.py, imports
  jax or anything of moonrtx_tpu;
* no fallback: without a card, an entry point that was not asked for the
  CPU raises;
* every CUDA function of csrc/ is one that chip_smoke.py times and checks;
* the copied numpy modules give bit-identical pyramids and ephemerides;
* geometry, camera, sampler and shading terms against the jnp versions on
  random inputs (float32; tolerances of a few ulps, as the two frameworks'
  transcendental functions round differently).
"""

import ast
import re
import subprocess
import sys
from datetime import datetime, timezone
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_no_reference():
    files = sorted((ROOT / "moonrtx_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += sorted((ROOT / "tools").glob("torch_*.py"))
    assert len(files) > 30
    # the entry points and host modules a user starts the port through
    for module in ("__main__.py", "app/cli.py", "app/window.py",
                   "app/launcher.py", "app/presets.py", "app/headless.py",
                   "utils/log.py", "native/bindings.py"):
        assert ROOT / "moonrtx_tpu_torch" / module in files, module
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "moonrtx_tpu"), (path, name)


def test_every_global_function_is_named_in_chip_smoke():
    """Each __global__ function in csrc/*.cu is a pass of one kernel
    wrapper's declaration (kernels.register), the table chip_smoke.py's
    phase 4 times and checks every pass of, so no pass of a kernel goes
    untimed or unchecked; and no declaration names a function that does
    not exist in its source."""
    from moonrtx_tpu_torch import kernels

    assert "kernels.registered()" in (ROOT / "chip_smoke.py").read_text()
    declared = kernels.registered()
    found_all = set()
    sources = sorted((ROOT / "moonrtx_tpu_torch" / "csrc").glob("*.cu"))
    assert len(sources) >= 4
    assert kernels.SOURCES == tuple(path.stem for path in sources)
    for path in sources:
        found = re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
            path.read_text())
        assert len(found) == path.read_text().count("__global__"), path
        found_all.update(found)
        for k in declared.values():
            if k.source == path.stem:
                assert set(k.passes) <= set(found), (path, k)
    named = [kernel for k in declared.values() for kernel in k.passes]
    assert len(named) == len(set(named))
    assert found_all == set(named)
    assert {k.source for k in declared.values()} == set(kernels.SOURCES)


def test_profiling_is_the_bottom_and_kernels_names_no_wrapper():
    """utils/profiling.py imports no module of the package (the launch
    counters live there, and kernels.py and the wrappers import it), and
    kernels.py names no wrapper: each declares itself."""
    from moonrtx_tpu_torch import kernels

    pkg = ROOT / "moonrtx_tpu_torch"
    assert not [name for name in _imports(pkg / "utils" / "profiling.py")
                if name.split(".")[0] == "moonrtx_tpu_torch"]
    path = pkg / "kernels.py"
    assert not [name for name in _imports(path)
                if name.startswith("moonrtx_tpu_torch.ops")]
    words = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Name):
            words.add(node.id)
        elif isinstance(node, ast.Attribute):
            words.add(node.attr)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            words.update(re.findall(r"\w+", node.value))
    names = set(kernels.registered())
    assert len(names) >= 8
    assert not names & words


def test_launch_counts_keep_their_keys_through_cpu_calls(monkeypatch):
    """launch_counts() names every declared wrapper, each at 0 in a fresh
    process, and keeps its keys and counts through a CPU call of each
    wrapper (the plain versions launch nothing): a benchmark harness
    subtracts two of them key by key."""
    from moonrtx_tpu_torch import kernels
    from moonrtx_tpu_torch.config import RenderConfig
    from moonrtx_tpu_torch.data.synth import synthesize_moon
    from moonrtx_tpu_torch.engine.scene import MoonScene
    from moonrtx_tpu_torch.types import Observer

    fresh = subprocess.run(
        [sys.executable, "-c", "from moonrtx_tpu_torch import kernels; "
         "print(sorted(kernels.launch_counts().items()))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    declared = kernels.registered()
    assert fresh.stdout.strip() == str(sorted(dict.fromkeys(declared,
                                                            0).items()))
    called = dict.fromkeys(declared, 0)
    for name, k in declared.items():
        def spy(*a, _name=name, _fn=k.wrapper, **kw):
            called[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(sys.modules[k.wrapper.__module__], name, spy)
    before = kernels.launch_counts()
    assert set(before) == set(declared)
    elev, albedo = synthesize_moon(180, 360, seed=5, n_craters=60)
    rs = float(elev.max())
    cfg = RenderConfig(
        observer=Observer(50.06, 19.94, 219),
        dt_local=datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc),
        width=128, height=96, backend="pallas",
        shadow_accuracy=4).validate()
    scene = MoonScene(cfg, (elev / rs).astype(np.float32), rs, albedo, None,
                      device="cpu")
    scene.update_view()
    scene.render(2)                       # the march path and its burst
    scene.backend = "blocked"             # the default path, cold windows
    scene.set_view_orientation(scene.view_orientation)
    scene.render(1)
    assert all(called.values()), called
    assert kernels.launch_counts() == before


def test_scene_without_device_raises_when_no_card(monkeypatch):
    from moonrtx_tpu_torch.config import RenderConfig
    from moonrtx_tpu_torch.device import resolve_device
    from moonrtx_tpu_torch.engine.scene import MoonScene

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    elev = np.ones((90, 180), np.float32)
    alb = np.full((90, 180, 3), 0.5, np.float32)
    with pytest.raises(RuntimeError):
        MoonScene(RenderConfig(width=128, height=64).validate(), elev, 1.0,
                  alb, None)
    assert resolve_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("quantize", ["off", "i16"])
def test_backend_resolution_table(quantize, tmp_path, monkeypatch):
    """Every backend name the configuration accepts, on an f32 and on a
    quantized scene, resolves as the reference resolves it, with one
    stated exception: "pallas" stays the march path in the port (on the
    card its kernel, on the CPU the kernel's plain version), where the
    reference off a TPU falls back to "blocked"."""
    import moonrtx_tpu.config as jconfig
    import moonrtx_tpu_torch.config as tconfig
    from moonrtx_tpu.engine.scene import MoonScene as JScene
    from moonrtx_tpu_torch.engine.scene import MoonScene as TScene

    monkeypatch.setenv("MOONRTX_TPU_CACHE", str(tmp_path))
    rng = np.random.default_rng(0)
    elev = (1.0 - 0.01 * rng.random((90, 180))).astype(np.float32)
    alb = rng.random((90, 180, 3)).astype(np.float32)
    expected = {"auto": "blocked", "mxu": "blocked", "blocked": "blocked",
                "reference": "blocked" if quantize == "i16" else "reference",
                "pallas": "pallas"}
    for name, want in expected.items():
        kw = dict(width=128, height=64, backend=name, quantize=quantize)
        ts = TScene(tconfig.RenderConfig(**kw).validate(), elev, 1.0, alb,
                    None, device="cpu")
        js = JScene(jconfig.RenderConfig(**kw).validate(), elev, 1.0, alb,
                    None)
        assert ts.quantized == js.quantized == (quantize == "i16")
        assert ts.backend == want, name
        if name == "pallas":
            assert js.backend == "blocked"      # the reference off a TPU
        else:
            assert js.backend == ts.backend, name
    # devices=2 on the CPU: a mesh of two logical devices, and the
    # height padded to whole strips, as the reference pads for its mesh
    ts = TScene(tconfig.RenderConfig(width=128, height=64,
                                     devices=2).validate(),
                elev, 1.0, alb, None, device="cpu")
    assert ts.mesh is not None and ts.mesh.size == 2
    assert ts.height == 64 and ts.height % (8 * 2) == 0


@pytest.mark.parametrize("quantized", [False, True])
def test_load_or_build_bit_identical(quantized):
    from moonrtx_tpu.data import pyramids as jp
    from moonrtx_tpu.data.synth import synthesize_moon
    from moonrtx_tpu_torch.data import pyramids as tp

    elev, albedo = synthesize_moon(180, 360, seed=3, n_craters=40)
    elev = (elev / elev.max()).astype(np.float32)
    a = jp.load_or_build(elev, albedo, quantized, use_cache=False)
    b = tp.load_or_build(elev, albedo, quantized, use_cache=False)
    for name in ("mips", "albedo_kept"):
        la, lb = getattr(a, name), getattr(b, name)
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for name in ("maxmap", "slope_maps"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    for name in ("alb_min_level", "quantized", "h_scale", "h_offset",
                 "h_min", "a_scale"):
        assert getattr(a, name) == getattr(b, name)


def test_ephemeris_copy_identical():
    from moonrtx_tpu.astro import calculate_ephemeris as je
    from moonrtx_tpu.types import Observer as JO
    from moonrtx_tpu_torch.astro import calculate_ephemeris as te
    from moonrtx_tpu_torch.types import Observer as TO

    dt = datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc)
    a = je(dt, JO(50.06, 19.94, 219), False)
    b = te(dt, TO(50.06, 19.94, 219), False)
    np.testing.assert_array_equal(np.asarray(a.rotation_matrix),
                                  np.asarray(b.rotation_matrix))
    assert a.phase_angle == b.phase_angle and a.distance == b.distance


def _rand(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def test_geometry_and_camera_match():
    from moonrtx_tpu.engine import camera as jc
    from moonrtx_tpu.engine import geometry as jg
    from moonrtx_tpu_torch.engine import camera as tc
    from moonrtx_tpu_torch.engine import geometry as tg
    from moonrtx_tpu_torch.types import Camera

    rng = np.random.default_rng(0)
    v = _rand(rng, 512, 3)
    for fj, ft in ((jg.unit_to_latlon, tg.unit_to_latlon),):
        for a, b in zip(fj(jnp.asarray(v)), ft(torch.from_numpy(v))):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=4e-6,
                                       atol=1e-5)
    lat, lon = _rand(rng, 512, lo=-89, hi=89), _rand(rng, 512, lo=-180,
                                                     hi=180)
    np.testing.assert_allclose(
        tg.latlon_to_unit(torch.from_numpy(lat), torch.from_numpy(lon)),
        np.asarray(jg.latlon_to_unit(jnp.asarray(lat), jnp.asarray(lon))),
        atol=1e-6)
    o = np.array([0.0, -300.0, 1.0], np.float32)
    d = v / np.linalg.norm(v, axis=1, keepdims=True)
    for a, b in zip(jg.ray_sphere(jnp.asarray(o), jnp.asarray(d), 10.0),
                    tg.ray_sphere(torch.from_numpy(o), torch.from_numpy(d),
                                  10.0)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    m = _rand(rng, 3, 3)
    np.testing.assert_allclose(
        tg.mat3t_apply(torch.from_numpy(m), torch.from_numpy(v)),
        np.asarray(jg.mat3t_apply(jnp.asarray(m), jnp.asarray(v))),
        rtol=1e-6)
    cam = Camera(eye=[3.0, -300.0, 20.0], target=[0.0, 0.0, 0.0],
                 up=[0.0, 0.0, 1.0], fov=4.0)
    jb = jc.camera_basis(cam, "NSEW")
    tb = tc.camera_basis(cam, "NSEW", "cpu")
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jit = np.array([0.25, -0.125], np.float32)
    np.testing.assert_allclose(
        tc.ray_directions(tb, 24, 40, torch.from_numpy(jit)).numpy(),
        np.asarray(jc.ray_directions(jb, 24, 40, jnp.asarray(jit))),
        atol=1e-7)


def test_sampler_matches():
    from moonrtx_tpu.ops import sampler as js
    from moonrtx_tpu_torch.ops import sampler as ts

    rng = np.random.default_rng(1)
    lat, lon = _rand(rng, 64, 32, lo=-90, hi=90), _rand(rng, 64, 32,
                                                        lo=-180, hi=180)
    r_j, c_j = js.latlon_to_rowcol(jnp.asarray(lat), jnp.asarray(lon),
                                   180, 360)
    r_t, c_t = ts.latlon_to_rowcol(torch.from_numpy(lat),
                                   torch.from_numpy(lon), 180, 360)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-6)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-6)
    tex = _rand(rng, 180, 552, 3)
    np.testing.assert_allclose(
        ts.gather_bilinear(torch.from_numpy(tex), r_t, c_t).numpy(),
        np.asarray(js.gather_bilinear(jnp.asarray(tex), r_j, c_j)),
        atol=1e-6)
    wins = _rand(rng, 16, 40, 64)
    wy, wx = _rand(rng, 16, 128, lo=-1, hi=41), _rand(rng, 16, 128, lo=-1,
                                                       hi=65)
    np.testing.assert_allclose(
        ts.window_bilinear(torch.from_numpy(wins), torch.from_numpy(wy),
                           torch.from_numpy(wx)).numpy(),
        np.asarray(js.window_bilinear(jnp.asarray(wins), jnp.asarray(wy),
                                      jnp.asarray(wx))), atol=1e-6)
    rows = _rand(rng, 16, 384, lo=0, hi=170)
    cols = np.concatenate([_rand(rng, 8, 384, lo=0, hi=40),
                           _rand(rng, 8, 384, lo=300, hi=360)])
    cols[:4, :10] = 355.0   # seam-straddling blocks
    a = js.window_origin_from_footprint(jnp.asarray(rows), jnp.asarray(cols),
                                        360, 40, 64, jnp.int32(180),
                                        jnp.int32(552))
    b = ts.window_origin_from_footprint(
        torch.from_numpy(rows), torch.from_numpy(cols), 360, 40, 64,
        torch.tensor(180, dtype=torch.int32),
        torch.tensor(552, dtype=torch.int32))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))


def test_shading_terms_match():
    from moonrtx_tpu.engine import render as jr
    from moonrtx_tpu_torch.engine import render as tr

    rng = np.random.default_rng(2)
    mu, sigma = _rand(rng, 1000), _rand(rng, 1000, lo=0, hi=0.3)
    np.testing.assert_allclose(
        tr.soft_ndotl(torch.from_numpy(mu), torch.from_numpy(sigma)).numpy(),
        np.asarray(jr.soft_ndotl(jnp.asarray(mu), jnp.asarray(sigma))),
        atol=2e-6)
    sep = _rand(rng, 1000, lo=0, hi=0.04)
    np.testing.assert_allclose(
        tr.sun_coverage(torch.from_numpy(sep), torch.tensor(0.0046),
                        torch.tensor(0.0125)).numpy(),
        np.asarray(jr.sun_coverage(jnp.asarray(sep), jnp.float32(0.0046),
                                   jnp.float32(0.0125))), atol=2e-5)
    rot = np.eye(3, dtype=np.float32)
    fields = dict(light_pos=np.array([2000.0, 300.0, 50.0], np.float32),
                  sun_disk_center=np.array([300.0, 20.0, 5.0], np.float32),
                  sun_disk_radius=np.float32(3.0),
                  irradiance=np.float32(1.2),
                  sun_ang_radius=np.float32(0.0046),
                  earth=np.array([0.1, -0.99, 0.05, 2200.0, 0.0125, 0.02],
                                 np.float32))
    fp_j = jr.FrameParams(rotation=jnp.asarray(rot),
                          **{k: jnp.asarray(v) for k, v in fields.items()})
    fp_t = tr.FrameParams(rotation=torch.from_numpy(rot),
                          **{k: torch.as_tensor(v) for k, v in
                             fields.items()})
    p = 10.0 * _rand(rng, 200, 3)
    n = _rand(rng, 200, 3)
    for a, b in zip(jr.earth_light_terms(fp_j, jnp.asarray(p), jnp.asarray(n)),
                    tr.earth_light_terms(fp_t, torch.from_numpy(p),
                                         torch.from_numpy(n))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-5)
    dirs = _rand(rng, 8, 8, 3)
    eye = np.array([0.0, -300.0, 0.0], np.float32)
    np.testing.assert_array_equal(
        tr.sun_disk_hit(torch.from_numpy(eye), torch.from_numpy(dirs),
                        fp_t).numpy(),
        np.asarray(jr.sun_disk_hit(jnp.asarray(eye), jnp.asarray(dirs),
                                   fp_j)))
    rgb = _rand(rng, 16, 16, 3, lo=0.0, hi=1.5)
    acc = _rand(rng, 16, 16, 3, lo=0.0, hi=1.5)
    np.testing.assert_allclose(
        tr.accumulate(torch.from_numpy(acc), torch.from_numpy(rgb),
                      torch.tensor(3.0)).numpy(),
        np.asarray(jr.accumulate(jnp.asarray(acc), jnp.asarray(rgb),
                                 jnp.float32(3.0))), rtol=1e-6)
    d = np.abs(tr.tonemap(torch.from_numpy(rgb), 0.9, 2.2).numpy().astype(int)
               - np.asarray(jr.tonemap(jnp.asarray(rgb), jnp.float32(0.9),
                                       jnp.float32(2.2))).astype(int))
    assert d.max() <= 1 and d.mean() < 0.01


def test_scene_state_round_trip():
    from moonrtx_tpu_torch.weights import scene_state_from_numpy

    arrays = dict(mips=[np.zeros((4, 8), np.int16), np.ones((2, 4),
                                                          np.int16)],
                  albedo_mips=[np.zeros((4, 8, 3), np.uint8)],
                  maxmap=np.ones((3, 3), np.float32),
                  slope_maps=np.zeros((2, 3, 3), np.float32), starmap=None,
                  h_min=0.1 + 1e-12, h_scale=2.5e-5, h_offset=0.9,
                  a_scale=1 / 255.0, alb_min_level=1)
    st = scene_state_from_numpy(arrays)
    assert sorted(st) == sorted(["mips.0", "mips.1", "albedo_mips.0",
                                 "maxmap", "slope_maps", "h_min", "h_scale",
                                 "h_offset", "a_scale", "alb_min_level"])
    assert st["mips.1"].dtype == torch.int16
    assert st["h_min"].item() == arrays["h_min"]   # no float32 rounding
    assert st["alb_min_level"].item() == 1
