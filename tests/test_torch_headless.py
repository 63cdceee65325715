"""The port's headless entry points and scene set-up against the reference.

* render_timelapse: both packages' time-lapse at tests/test_headless.py's
  size (128x96, accuracy 2, 3 frames, 1 sample, 12-hour steps) give the
  same file names and frames within the golden tolerance
  (tests/test_goldens.py: mean |d| < 0.5, < 0.1% beyond 8 levels); the
  accumulation a frame leaves is not written by the next frame, which is
  what lets the time-lapse copy it out behind that frame;
* build_scene attaches the reference's feature catalog, in its order;
* the banded upload equals a whole upload, drops the mmap pages as it
  goes and owns its memory;
* devices: 0 resolves to the local device count, more than one raises;
* two bounces: the bounce map within the one-bounce tolerance of 2e-3,
  and the second bounce's own term within a tenth of its size.
"""

import os
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (pins torch to one CPU thread)

TIMELAPSE_ARGS = [
    "--lat", "50.0614", "--lon", "19.9365",
    "--time", "2024-04-15T21:00:00Z", "--no-download",
    "--width", "128", "--height", "96", "--shadow-accuracy", "2",
    "--time-step-minutes", "720"]


def _small_synth(mp, pkg, cache):
    mp.setattr(f"{pkg}.data.loader.SYNTH_ELEVATION_SHAPE", (180, 360))
    mp.setattr(f"{pkg}.data.loader.SYNTH_CACHE_DIR", cache)


@pytest.fixture(scope="module")
def timelapses(tmp_path_factory):
    """Both packages' render_timelapse on the same arguments."""
    from moonrtx_tpu.app import cli as jcli
    from moonrtx_tpu.app import headless as jheadless
    from moonrtx_tpu_torch.app import cli as tcli
    from moonrtx_tpu_torch.app import headless as theadless

    out = {}
    for pkg, cli, headless, kw in (
            ("moonrtx_tpu", jcli, jheadless, {}),
            ("moonrtx_tpu_torch", tcli, theadless, {"device": "cpu"})):
        d = tmp_path_factory.mktemp(pkg)
        with pytest.MonkeyPatch.context() as mp:
            _small_synth(mp, pkg, str(d / "cache"))
            mp.setenv("MOONRTX_TPU_CACHE", str(d / "cache"))
            cfg = cli.config_from_args(cli.parse_args(TIMELAPSE_ARGS))
            out[pkg] = headless.render_timelapse(
                cfg, str(d / "moon.png"), timelapse_frames=3, n_frames=1,
                **kw)
    return out["moonrtx_tpu"], out["moonrtx_tpu_torch"]


def test_timelapse_file_names_match_reference(timelapses):
    ref, port = timelapses
    names = [os.path.basename(p) for p in port]
    assert names == [os.path.basename(p) for p in ref] == [
        "moon_0000.png", "moon_0001.png", "moon_0002.png"]
    assert all(os.path.isfile(p) for p in port)


def test_timelapse_frames_match_reference(timelapses):
    from PIL import Image

    ref, port = timelapses
    frames = []
    for pr, pt in zip(ref, port):
        fr = np.asarray(Image.open(pr)).astype(np.int16)
        ft = np.asarray(Image.open(pt)).astype(np.int16)
        assert ft.shape == fr.shape == (96, 128, 3)
        d = np.abs(ft - fr)
        assert float(d.mean()) < 0.5 and float((d > 8).mean()) < 0.001
        frames.append(ft)
    # 12 h of sun motion: successive frames differ substantially
    assert np.abs(frames[1] - frames[0]).mean() > 0.5
    assert np.abs(frames[2] - frames[1]).mean() > 0.5


def test_timelapse_tiff_frames_carry_the_accumulation(tmp_path, monkeypatch):
    """A .tiff time-lapse saves 16 bits a sample from the linear
    accumulation (save_image), copied out beside the 8-bit frame."""
    import cv2

    from moonrtx_tpu_torch.app import cli, headless

    _small_synth(monkeypatch, "moonrtx_tpu_torch", str(tmp_path / "cache"))
    cfg = cli.config_from_args(cli.parse_args(TIMELAPSE_ARGS))
    paths = headless.render_timelapse(cfg, str(tmp_path / "moon.tiff"), 2,
                                      n_frames=1, device="cpu")
    assert [os.path.basename(p) for p in paths] == ["moon_0000.tiff",
                                                    "moon_0001.tiff"]
    t16 = [cv2.imread(p, cv2.IMREAD_UNCHANGED) for p in paths]
    assert all(t.dtype == np.uint16 and t.shape == (96, 128, 3)
               for t in t16)
    assert np.abs(t16[1].astype(int) - t16[0]).mean() > 100


def _scene_cfg(mod, types, **kw):
    kw = {"width": 128, "height": 64, "shadow_accuracy": 2, **kw}
    return mod.RenderConfig(
        observer=types.Observer(50.06, 19.94, 219),
        dt_local=datetime(2024, 4, 15, 21, 0, tzinfo=timezone.utc),
        **kw).validate()


@pytest.mark.parametrize("backend", ["blocked", "pallas"])
def test_next_frame_leaves_the_accumulation_alone(backend):
    """The accumulation of frame i is a tensor that frame i+1 replaces and
    never writes in place, on both paths the time-lapse drives (one
    sample at a time; a burst, then the time-step program)."""
    import moonrtx_tpu_torch.config as tconfig
    import moonrtx_tpu_torch.types as ttypes
    from moonrtx_tpu_torch.data.synth import synthesize_moon
    from moonrtx_tpu_torch.engine.scene import MoonScene

    elev, albedo = synthesize_moon(90, 180, seed=5, n_craters=20)
    rs = float(elev.max())
    scene = MoonScene(_scene_cfg(tconfig, ttypes, backend=backend),
                      (elev / rs).astype(np.float32), rs, albedo, None,
                      device="cpu")
    scene.update_view()
    scene.ensure_accumulated(2)
    for _ in range(2):
        held = scene._accum
        kept = held.clone()
        scene.update_view(scene.dt_local + timedelta(minutes=15))
        scene.ensure_accumulated(2)
        assert scene._accum is not held
        assert torch.equal(held, kept)


@pytest.fixture(scope="module")
def two_bounce_scenes(tmp_path_factory):
    """Both packages' build_scene at a small size with two bounces, after
    one rendered sample."""
    import moonrtx_tpu.config as jconfig
    import moonrtx_tpu.types as jtypes
    import moonrtx_tpu_torch.config as tconfig
    import moonrtx_tpu_torch.types as ttypes
    from moonrtx_tpu.app import headless as jheadless
    from moonrtx_tpu_torch.app import headless as theadless

    cache = str(tmp_path_factory.mktemp("cache"))
    out = []
    for pkg, config, types, headless, kw in (
            ("moonrtx_tpu", jconfig, jtypes, jheadless, {}),
            ("moonrtx_tpu_torch", tconfig, ttypes, theadless,
             {"device": "cpu"})):
        with pytest.MonkeyPatch.context() as mp:
            _small_synth(mp, pkg, cache)
            mp.setenv("MOONRTX_TPU_CACHE", cache)
            s = headless.build_scene(
                _scene_cfg(config, types, indirect_bounces=2,
                           shadow_accuracy=4),
                with_starmap=False, **kw)
            s.update_view()
            s.render(1)
            out.append(s)
    return tuple(out)


def test_build_scene_attaches_reference_features(two_bounce_scenes):
    js, ts = two_bounce_scenes
    assert len(ts.features) == len(js.features) > 100
    assert [f.name for f in ts.features] == [f.name for f in js.features]
    assert [f.angular_radius for f in ts.features] == [
        f.angular_radius for f in js.features]


def test_two_bounce_map_matches_reference(two_bounce_scenes):
    js, ts = two_bounce_scenes
    assert ts.indirect_bounces == js.indirect_bounces == 2
    two_t, two_j = ts._bounce.numpy(), np.asarray(js._bounce)
    assert two_t.shape == two_j.shape and two_j.max() > 1e-3
    assert np.abs(two_t - two_j).max() <= 2e-3
    # the second bounce's own term, the two-bounce map less the one-bounce
    # map of the same sun, within a tenth of its largest value (it is ~5%
    # of the indirect light, below the 2e-3 that the whole map is held to)
    one = []
    for s in (ts, js):
        s.indirect_bounces = 1
        s._bounce = None
        s._shadow_dirty = True
        s.shadow_args()
        one.append(np.asarray(s._bounce))
    second_t, second_j = two_t - one[0], two_j - one[1]
    assert np.abs(second_j).max() > 1e-5
    assert (np.abs(second_t - second_j).max()
            <= 0.1 * np.abs(second_j).max())


def test_banded_upload_equals_whole_upload(tmp_path, monkeypatch):
    import moonrtx_tpu_torch.engine.scene as scene_mod

    drops = []
    monkeypatch.setattr(scene_mod, "_drop_mmap_pages",
                        lambda m: drops.append(m))
    rng = np.random.default_rng(3)
    for name, a in (("h", rng.integers(-9000, 9000, (203, 70), np.int16)),
                    ("a", rng.integers(0, 256, (101, 40, 3), np.uint8)),
                    ("f", rng.random((57, 33)).astype(np.float32))):
        np.save(tmp_path / f"{name}.npy", a)
        m = np.load(tmp_path / f"{name}.npy", mmap_mode="r")
        row = m.nbytes // m.shape[0]
        drops.clear()
        out = scene_mod._upload_rows_banded(m, torch.device("cpu"),
                                            band_bytes=row * 11 + 5)
        assert len(drops) == -(-m.shape[0] // 11) >= 5
        assert all(d is m for d in drops)
        np.testing.assert_array_equal(out.numpy(), a)
        assert out.dtype == torch.from_numpy(a).dtype
        # the tensor owns its memory: writing it leaves the mmap alone
        out.view(-1)[0] += 1
        np.testing.assert_array_equal(np.asarray(m), a)
        one = scene_mod._upload_rows_banded(m, torch.device("cpu"))
        np.testing.assert_array_equal(one.numpy(), a)


def test_scene_uploads_cached_levels_in_bands(tmp_path, monkeypatch):
    """A quantized scene's levels come from the memory-mapped pyramid
    cache; the scene uploads every level through the banded path, which
    drops their pages."""
    import moonrtx_tpu_torch.config as tconfig
    import moonrtx_tpu_torch.engine.scene as scene_mod
    import moonrtx_tpu_torch.types as ttypes
    from moonrtx_tpu_torch.data.mips import mmap_of
    from moonrtx_tpu_torch.data.synth import synthesize_moon

    monkeypatch.setenv("MOONRTX_TPU_CACHE", str(tmp_path))
    elev, albedo = synthesize_moon(90, 180, seed=5, n_craters=20)
    rs = float(elev.max())
    elev = (elev / rs).astype(np.float32)
    cfg = _scene_cfg(tconfig, ttypes, quantize="i16")
    scene_mod.MoonScene(cfg, elev, rs, albedo, None, device="cpu")  # cache
    drops = []
    monkeypatch.setattr(scene_mod, "_drop_mmap_pages",
                        lambda m: drops.append(m))
    s = scene_mod.MoonScene(cfg, elev, rs, albedo, None, device="cpu")
    mapped = [m for m in drops if mmap_of(m)[0] is not None]
    assert len(mapped) >= len(s.mips)
    assert s.mips[0].dtype == torch.int16 and s.upload_wall_s >= 0


def test_devices_zero_is_every_local_device(monkeypatch):
    import moonrtx_tpu_torch.config as tconfig
    import moonrtx_tpu_torch.types as ttypes
    from moonrtx_tpu_torch.engine.scene import MoonScene

    elev = np.ones((90, 180), np.float32)
    alb = np.full((90, 180, 3), 0.5, np.float32)
    from moonrtx_tpu_torch.engine.scene import resolve_mesh

    s = MoonScene(_scene_cfg(tconfig, ttypes, devices=0), elev, 1.0, alb,
                  None, device="cpu")
    assert s.device.type == "cpu" and s.mips[0].shape[0] == 90
    assert s.mesh is None                   # one CPU device: no mesh
    # devices=2 on the CPU: a mesh of two logical CPU devices
    s2 = MoonScene(_scene_cfg(tconfig, ttypes, devices=2), elev, 1.0, alb,
                   None, device="cpu")
    assert s2.mesh is not None and s2.mesh.size == 2
    assert s2.height % (8 * 2) == 0
    # on the card, 0 means every card: two cards make a mesh of two
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = resolve_mesh(_scene_cfg(tconfig, ttypes, devices=0),
                        torch.device("cuda"))
    assert mesh.size == 2 and not mesh.virtual
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    # more devices than cards: make_mesh's error, before any upload
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match=r"make_mesh\(4\)"):
        MoonScene(_scene_cfg(tconfig, ttypes, devices=4), elev, 1.0, alb,
                  None)
